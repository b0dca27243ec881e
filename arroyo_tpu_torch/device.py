"""Which torch device the port runs on, and where a mesh's shards live.

The port's entry points run on the GPU unless the caller names the CPU:
``resolve_device()`` with no argument (and no ``device.torch-device`` in the
config) gives ``cuda`` and raises when CUDA is absent. There is no silent
fall back to the host; tests ask for ``device="cpu"`` by name.

A mesh of key shards spreads over device slots (``mesh_slot_devices``):
the counterpart of the JAX package's ``jax.devices()[:n]``. Each slot is a
torch device holding a contiguous run of the shards (``split_shards``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
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


def split_shards(n: int, k: int) -> list[tuple[int, int]]:
    """``n`` shards over ``k`` slots: contiguous ``[lo, hi)`` runs whose
    sizes differ by at most one, the larger first (8 over 3: 3, 3, 2)."""
    if k < 1 or k > n:
        raise ValueError(f"{n} shards cannot fill {k} slots (each slot holds at least one)")
    q, r = divmod(n, k)
    out, lo = [], 0
    for j in range(k):
        hi = lo + q + (j < r)
        out.append((lo, hi))
        lo = hi
    return out


def placement_devices(n: int, device: torch.device, placement, card_count: int,
                      current: int = 0) -> list[torch.device]:
    """The slots' devices for a mesh of ``n`` shards, as a pure function of
    the resolved ``device``, the ``placement`` asked for and the cards the
    machine has (``card_count``; ``current`` stands for an index-less
    ``cuda`` in a placement).

    ``placement`` None: on ``cuda`` with no index, the first ``min(n,
    card_count)`` cards; on a named card or on the CPU, one slot. Else a
    sequence of device names (or one comma-separated string, as the
    environment layer gives it), one slot each. A slot naming a card the
    machine lacks raises; nothing falls back."""
    if placement is None:
        if device.type == "cuda" and device.index is None:
            k = min(n, card_count)
            if k < 1:
                raise RuntimeError("no CUDA card for the mesh's slots")
            return [torch.device("cuda", i) for i in range(k)]
        return [device]
    names = placement.split(",") if isinstance(placement, str) else list(placement)
    out = []
    for name in names:
        dev = torch.device(name.strip() if isinstance(name, str) else name)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh slot {dev}: the port runs on cuda or cpu")
        if dev.type == "cuda":
            idx = current if dev.index is None else dev.index
            if not 0 <= idx < card_count:
                raise ValueError(f"mesh slot {dev}: this machine has {card_count} CUDA card(s)")
            dev = torch.device("cuda", idx)
        out.append(dev)
    if not out:
        raise ValueError("device.mesh-placement names no slot")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"mesh slots {[str(d) for d in out]} mix the CPU and CUDA")
    if len(out) > n:
        raise ValueError(f"{len(out)} mesh slots for {n} shards")
    return out


def mesh_slot_devices(n: int, device: Optional[DeviceLike] = None,
                      placement: Optional[Union[str, Sequence[DeviceLike]]] = None
                      ) -> list[torch.device]:
    """``placement_devices`` on this machine: ``device`` through
    ``resolve_device``, ``placement`` None read from the config's
    ``device.mesh-placement``."""
    if placement is None:
        from .config import config

        placement = config().get("device.mesh-placement")
    dev = resolve_device(device)
    cuda = dev.type == "cuda" or (placement is not None and "cuda" in str(placement))
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"mesh placement {placement!r} names CUDA, which is not available")
    count = torch.cuda.device_count() if cuda else 0
    current = torch.cuda.current_device() if cuda else 0
    return placement_devices(int(n), dev, placement, count, current)
