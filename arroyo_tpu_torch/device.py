"""Which torch device the port runs on.

The port's entry points run on the GPU unless the caller names the CPU:
``resolve_device()`` with no argument (and no ``device.torch-device`` in the
config) gives ``cuda`` and raises when CUDA is absent. There is no silent
fall back to the host; tests ask for ``device="cpu"`` by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a caller asked for, else the config's, else ``cuda``.

    Raises RuntimeError when the result is a CUDA device and this build of
    torch (or this machine) has no CUDA."""
    if device is None:
        from .config import config

        device = config().get("device.torch-device") or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            f"(torch {torch.__version__}, cuda {torch.version.cuda}); "
            f"pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: the port runs on cuda or cpu")
    return dev
