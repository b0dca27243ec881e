"""A mesh of key shards (the port's copy of arroyo_tpu/parallel/mesh.py).

The JAX package shards the key space over a 1-D mesh of devices (the
"data" axis), shard i on ``jax.devices()[i]``, and exchanges rows between
them with ``lax.all_to_all`` inside one shard_map'd program. The port runs
one process over the mesh's device slots: a slot is one torch device with
its own CUDA stream, holding a contiguous run of the shards (device.py
``split_shards``: sizes that differ by at most one). Every sharded array of
a slot keeps the JAX layout's leading ``[n_local, ...]`` dimension, each
kernel takes the slot's shards as a grid dimension, and the exchange
(``exchange``) copies each source slot's blocks into the destination
slots' receive buffers, each copy behind an event of the source's stream.
With one slot (a named card, the CPU, a machine of one card) the shards
share that device and the caller's stream, and the exchange comes down to
the transposing copy ``all_to_all`` (kept as its reference). Slots on one
card are device-to-device copies; on distinct cards, peer copies.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..device import mesh_slot_devices, split_shards

KEY_AXIS = "data"


class Slot(NamedTuple):
    """One device slot: its device, its stream (None: the caller's current
    stream, as with one slot or on the CPU) and its shards ``[lo, hi)``."""

    device: torch.device
    stream: Optional[object]
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def ctx(self):
        """A context in which work lands on this slot: its card current and
        its stream the card's current stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class Mesh:
    """``n`` key shards over device slots (one by default: ``device``)."""

    def __init__(self, n: int, device: torch.device, axis: str = KEY_AXIS,
                 slot_devices: Optional[Sequence[torch.device]] = None):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        self.n = int(n)
        self.axis = axis
        devs = list(slot_devices) if slot_devices else [device]
        ranges = split_shards(self.n, len(devs))
        many = len(devs) > 1
        self.slots = tuple(
            Slot(d, torch.cuda.Stream(device=d) if many and d.type == "cuda" else None, lo, hi)
            for d, (lo, hi) in zip(devs, ranges))
        self.device = self.slots[0].device

    def __repr__(self) -> str:
        where = (str(self.device) if len(self.slots) == 1 else
                 ", ".join(f"{s.device}[{s.lo}:{s.hi}]" for s in self.slots))
        return f"Mesh({self.n} shards on {where}, axis {self.axis!r})"


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None,
              axis: str = KEY_AXIS, placement=None) -> Mesh:
    """A mesh of ``n_devices`` shards (default 1) over the slots
    ``device.mesh_slot_devices`` gives for ``device`` (None: the config's
    device, else cuda; see device.resolve_device) and ``placement`` (None:
    the config's ``device.mesh-placement``)."""
    n = 1 if n_devices is None else int(n_devices)
    devs = mesh_slot_devices(n, device, placement)
    return Mesh(n, devs[0], axis, devs)


def can_make(n_devices: int) -> bool:
    """True when a mesh of ``n_devices`` shards can be made: at least one
    shard, and every slot the config's placement names exists (the JAX
    package's gate for enough devices)."""
    if int(n_devices) < 1:
        return False
    try:
        mesh_slot_devices(int(n_devices))
    except (RuntimeError, ValueError):
        return False
    return True


def all_to_all(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exchange's reference on one device: ``x`` holds each source
    shard's send buffers ``[src, dst * dest_cap + j]``; the result holds
    each destination's received rows ``[dst, src * dest_cap + j]``
    (``lax.all_to_all`` with split and concat axis 0, per shard). ``out``
    may be a view with the result's shape, such as the head of the merged
    rows."""
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


def exchange(mesh: Mesh, sends: Sequence[Sequence[torch.Tensor]],
             recvs: Sequence[Sequence[torch.Tensor]], ready: Optional[Sequence] = None) -> None:
    """The exchange over the mesh's slots, every field of a step at once:
    ``sends[a]`` holds slot a's send buffers, one ``[n_a, n * dest_cap]``
    tensor a field (row: a source shard of a; columns: destination-major),
    ``recvs[b]`` slot b's receive rows ``[n_b, n * dest_cap]`` a field
    (views, the heads of its merged rows). Source slot a's block for slot
    b's shards lands in b's rows at a's shard positions: the contract of
    ``all_to_all``, ``[src, dst * dc + j] -> [dst, src * dc + j]``, across
    slots (with one slot it is that transposing copy). ``ready[a]``: an
    event recorded on slot a's stream after it wrote ``sends[a]``; slot b's
    stream waits once for each source's event and marks each send buffer
    used there, so the caching allocator keeps it until b's copies are done.
    Where the two slots sit on distinct cards, torch's peer copy orders
    itself against both cards' current streams (the slots' own here)."""
    slots, n = mesh.slots, mesh.n
    width = sends[0][0].shape[1]
    if width % n:
        raise ValueError(f"send buffers of width {width} do not split over {n} shards")
    dc = width // n
    for b, sb in enumerate(slots):
        for dst in recvs[b]:
            if tuple(dst.shape) != (sb.n, width):
                raise ValueError(f"slot {b} receives into {tuple(dst.shape)}, "
                                 f"expected {(sb.n, width)}")
        with sb.ctx():
            if sb.stream is not None:
                for a in range(len(slots)):
                    if ready is not None:
                        sb.stream.wait_event(ready[a])
                    for src in sends[a]:
                        src.record_stream(sb.stream)
            for a, sa in enumerate(slots):
                for src, dst in zip(sends[a], recvs[b]):
                    block = src.view(sa.n, n, dc)[:, sb.lo:sb.hi].transpose(0, 1)
                    d3 = dst.view(sb.n, n, dc)[:, sa.lo:sa.hi]
                    if sa.device != sb.device:
                        # the peer copy: its source's card runs it on that
                        # card's current stream, which must be slot a's
                        with sa.ctx():
                            d3.copy_(block, non_blocking=True)
                    else:
                        d3.copy_(block)
