"""A mesh of key shards (the port's copy of arroyo_tpu/parallel/mesh.py).

The JAX package shards the key space over a 1-D mesh of devices (the
"data" axis) and exchanges rows between them with ``lax.all_to_all`` inside
one shard_map'd program. The port holds the n shards of such a mesh on ONE
torch device: every sharded array keeps the JAX layout's leading
``[n_shards, ...]`` dimension, each kernel takes the shard as a grid
dimension, and the exchange is the explicit ``all_to_all`` below, a
transposition of the send buffers on that device. Spreading the shards
over several cards (peer copies or NCCL) is later work; the layout and the
exchange's contract stay as they are.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device

KEY_AXIS = "data"


class Mesh:
    """``n`` key shards on one torch device."""

    def __init__(self, n: int, device: torch.device, axis: str = KEY_AXIS):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        self.n = int(n)
        self.device = device
        self.axis = axis

    def __repr__(self) -> str:
        return f"Mesh({self.n} shards on {self.device}, axis {self.axis!r})"


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None,
              axis: str = KEY_AXIS) -> Mesh:
    """A mesh of ``n_devices`` shards (default 1) on ``device`` (None: the
    config's device, else cuda; see device.resolve_device)."""
    return Mesh(1 if n_devices is None else int(n_devices), resolve_device(device), axis)


def can_make(n_devices: int) -> bool:
    """True for any width of at least one: the shards share one device."""
    return int(n_devices) >= 1


def all_to_all(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mesh exchange: ``x`` holds each source shard's send buffers
    ``[src, dst * dest_cap + j]``; the result holds each destination's
    received rows ``[dst, src * dest_cap + j]`` (``lax.all_to_all`` with
    split and concat axis 0, per shard). ``out`` may be a view with the
    result's shape, such as the head of the merged rows."""
    S = x.shape[0]
    if x.dim() != 2 or x.shape[1] % S:
        raise ValueError(f"send buffers of shape {tuple(x.shape)} do not split over {S} shards")
    dc = x.shape[1] // S
    if out is None:
        out = torch.empty_like(x)
    elif tuple(out.shape) != tuple(x.shape) or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match {tuple(x.shape)} {x.dtype}")
    out.view(S, S, dc).copy_(x.view(S, S, dc).transpose(0, 1))
    return out
