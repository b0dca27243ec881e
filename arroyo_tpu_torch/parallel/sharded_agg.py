"""Key-space-sharded keyed window aggregation (the port's copy of
arroyo_tpu/parallel/sharded_agg.py).

The n shards of the mesh live in its device slots (parallel/mesh.py), each
slot a contiguous run of shards on one torch device with its own stream;
every table array of a slot has the JAX layout's leading ``[n_local, ...]``
dimension. One step, each stage one kernel launch per slot on the slot's
card and stream (ops/sharded_kernels.py):

  1. K8 sort_reduce of each shard's local rows -> unique (bin, key) partials
  2-3. K10 shard_exchange: each partial's owner among the mesh's n shards
     (contiguous u64 key ranges, as the host's server_for_hash), the send
     buffers [n_local, n_dev * dest_cap]; partials past a destination's cap
     stay on the producing shard (skew degrades to local residency; the
     close combines across shards)
  4. the exchange (mesh.exchange): each source slot's send block for a
     destination slot's shards is copied into that slot's receive rows, on
     the destination's stream behind an event of the source's (one slot:
     the transposing copy)
  5. K8 over the received rows followed by the kept-local ones
  6. K9 probe_merge into each shard's open-addressing table
  7. K10 shard_spill: rows the table cannot place append to the per-shard
     spill buffer; only its exhaustion counts as overflow (one launch; its
     state buffer, never cleared, is the aggregator's: one per slot,
     merged-row count and stream)

A close (``extract_all``) is K11 per slot and emit_cap chunk, one packed
copy to pinned host memory behind an event per slot and round, the slots'
rows gathered in shard order, plus the spill rows combined on the host. The
host-row surface (update / extract / extract_start / scan_range /
free_bins_below / snapshot / restore) matches SlotAggregator, so the window
operators build either (windows/tumbling.py make_window_aggregator). What a
step computes does not depend on the placement: the state, the rows of a
close and a snapshot are those of one slot.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops import sharded_kernels as sk
from ..ops.aggregate import _drain_extract_rounds, _identity, combine_by_key_bin
from ..ops.prefetch import HostFetch
from .mesh import Mesh, exchange

_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.uint64): torch.uint64, np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}

# process-wide step counters, split by entry path: a fused step runs the
# segment prefix and the exchange + merge for one micro-batch, a host step
# the exchange + merge of rows the host distributed (bench.py --mesh-ab's
# ledger: one fused step per fused micro-batch)
_DISPATCH = {"host_steps": 0, "fused_steps": 0}

_EXCHANGED = ("s_key", "s_bin", "s_valid")  # Exchange's send fields before the lanes


def dispatch_counts() -> dict:
    return dict(_DISPATCH)


def reset_dispatch_counts() -> None:
    for k in _DISPATCH:
        _DISPATCH[k] = 0


class _ReadyHandle:
    """Already-materialized close: the sharded close drains on the spot, so
    the window operators' pipelined emission sees an always-ready handle."""

    def __init__(self, value):
        self._value = value

    def is_ready(self) -> bool:
        return True

    def result(self):
        return self._value




class ShardedAggregator:
    """Key-space-sharded (bin, key) -> accumulators store over a mesh of
    shards in device slots.

    ``state`` reads as the JAX package's nine arrays as torch tensors, in
    shard order whatever the placement: keys int64, bins int32, occ bool and
    one lane per accumulator ``[n_dev, cap]``, overflow int32 ``[n_dev]``,
    then the spill buffer's keys, bins ``[n_dev, spill_cap]``, fill
    ``[n_dev]`` and lanes. It is a copy, gathered on the first slot's
    device once each slot's stream is done, at every placement: writing
    into it changes nothing (``slot_states`` holds each slot's own)."""

    def __init__(
        self,
        mesh: Mesh,
        acc_kinds: Sequence[str],
        acc_dtypes: Sequence[np.dtype],
        cap: int = 65536,
        batch_cap: int = 8192,
        per_dest_cap: Optional[int] = None,
        max_probes: int = 64,
        emit_cap: int = 8192,
        spill_cap: int = 2048,
    ):
        self.mesh = mesh
        self.n_dev = mesh.n
        self.slots = mesh.slots
        self.device = mesh.device
        self.acc_kinds = tuple(acc_kinds)
        self.acc_dtypes = tuple(np.dtype(d) for d in acc_dtypes)
        for k, d in zip(self.acc_kinds, self.acc_dtypes):
            if k not in ("sum", "count", "min", "max"):
                raise NotImplementedError(f"accumulator kind {k!r} has no device path")
            if d not in _TORCH:
                raise TypeError(f"accumulator dtype {d} not one of int32/int64/uint64/float32/float64")
        if cap < 1 or cap & (cap - 1):
            raise ValueError(f"table capacity {cap} is not a power of two")
        self.cap = cap
        self.batch_cap = batch_cap
        # room for skew: by default each destination can receive up to half
        # the local batch from every source shard
        self.per_dest_cap = per_dest_cap or max(batch_cap // max(self.n_dev // 2, 1), 64)
        self.max_probes = max_probes
        self.emit_cap = emit_cap
        self.spill_cap = spill_cap
        # mesh_stats: rows fed through the exchange, and the spill buffer's
        # residency (refreshed wherever sp_fill is read on the host anyway)
        self.exchange_rows = 0
        self.overflow_rows = 0
        self.slot_states = self._init_state()
        # K10's spill state by (slot, merged rows a shard, stream), made with
        # the table for the host step's rows; a fused step's padded batch
        # adds its own at its first step
        self._spill_states: dict = {}
        for j in range(len(self.slots)):
            self._spill_state(j, self.n_dev * self.per_dest_cap + batch_cap)

    # ------------------------------------------------------- state

    def _init_state(self) -> list:
        return [self._init_slot(sl) for sl in self.slots]

    def _init_slot(self, sl):
        n, cap, sc, dev = sl.n, self.cap, self.spill_cap, sl.device

        def lanes(width):
            return tuple(torch.full((n, width), _identity(k, d).item(), dtype=_TORCH[d], device=dev)
                         for k, d in zip(self.acc_kinds, self.acc_dtypes))

        with sl.ctx():
            return (
                torch.zeros((n, cap), dtype=torch.int64, device=dev),
                torch.zeros((n, cap), dtype=torch.int32, device=dev),
                torch.zeros((n, cap), dtype=torch.bool, device=dev),
                lanes(cap),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros((n, sc), dtype=torch.int64, device=dev),
                torch.zeros((n, sc), dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                lanes(sc),
            )

    def _sync_slots(self) -> None:
        for sl in self.slots:
            if sl.stream is not None:
                sl.stream.synchronize()

    @property
    def state(self):
        self._sync_slots()
        dev = self.device

        def cat(parts):
            return torch.cat([t.to(dev) for t in parts])

        return tuple(
            tuple(cat(lane) for lane in zip(*parts)) if isinstance(parts[0], tuple) else cat(parts)
            for parts in zip(*self.slot_states))

    def _host(self, i: int, lane: Optional[int] = None) -> np.ndarray:
        """State array ``i`` (lane ``lane`` of a lanes entry) read to the
        host, the slots' rows in shard order; each read waits for its
        slot's stream."""
        parts = []
        for sl, st in zip(self.slots, self.slot_states):
            t = st[i] if lane is None else st[i][lane]
            with sl.ctx():
                parts.append(t.cpu().numpy())
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _spill_state(self, j: int, M: int) -> Optional[torch.Tensor]:
        """Slot ``j``'s spill kernel state buffer for ``[n_local, M]`` merged
        partials on its stream (None on the CPU, whose plain version needs
        none)."""
        sl = self.slots[j]
        if sl.device.type != "cuda":
            return None
        with sl.ctx():
            key = (j, M, torch.cuda.current_stream(sl.device).cuda_stream)
            buf = self._spill_states.get(key)
            if buf is None:
                buf = self._spill_states[key] = sk.spill_scratch(sl.n, M, sl.device)
        return buf

    @staticmethod
    def _to_slot(sl, a) -> torch.Tensor:
        """Host rows ``a`` (numpy, or a CPU tensor, pinned or not) on slot
        ``sl``'s card, copied on its stream (call inside ``sl.ctx()``)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if sl.device.type != "cuda":
            return t
        return (t if t.is_pinned() else t.pin_memory()).to(sl.device, non_blocking=True)

    def _host_rows(self, a, dtype=None):
        """``[n_dev, L]`` host rows (numpy) as a CPU tensor, pinned once
        where a slot is on a card (each slot then copies its own rows from
        it)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
        if any(sl.device.type == "cuda" for sl in self.slots):
            t = t.pin_memory()
        return t

    # ------------------------------------------------------- the step

    def _exchange_merge(self, rows: Callable, bin_offset: int = 0,
                        n_valid: Optional[int] = None) -> None:
        """Steps 1-7, state updated in place. ``rows(j)`` gives slot j's
        ``(key, bins, valid, vals)`` ``[n_local, L]`` on its card (called
        inside the slot's context); ``n_valid`` counts valid rows over the
        whole mesh's flat ``[n_dev, L]`` order."""
        kinds = self.acc_kinds
        exs, ready = [], []
        for j, sl in enumerate(self.slots):
            with sl.ctx():
                key, bins, valid, vals = rows(j)
                L = key.shape[1]
                nv = None if n_valid is None else min(max(int(n_valid) - sl.lo * L, 0), sl.n * L)
                u_key, u_bin, active, u_accs = sk.agg_sort_reduce(
                    kinds, key, bins, valid, vals, bin_offset=bin_offset, n_valid=nv)
                exs.append(sk.shard_exchange(kinds, u_key, u_bin, active, u_accs,
                                             self.per_dest_cap, n_dest=self.n_dev))
                if sl.stream is not None:
                    ready.append(sl.stream.record_event())
        recv = self.n_dev * self.per_dest_cap
        exchange(self.mesh, [[getattr(ex, f) for f in _EXCHANGED] + list(ex.s_accs) for ex in exs],
                 [[m[:, :recv] for m in [ex.m_key, ex.m_bin, ex.m_valid] + list(ex.m_accs)]
                  for ex in exs], ready or None)
        for j, (sl, ex) in enumerate(zip(self.slots, exs)):
            with sl.ctx():
                c_key, c_bin, c_active, c_accs = sk.agg_sort_reduce(
                    kinds, ex.m_key, ex.m_bin, ex.m_valid, ex.m_accs)
                (keys_t, bins_t, occ_t, accs_t, oflow_t,
                 sp_key, sp_bin, sp_fill, sp_accs) = self.slot_states[j]
                still = sk.agg_probe_merge(kinds, (keys_t, bins_t, occ_t, accs_t), c_key,
                                           c_bin, c_active, c_accs, self.max_probes)
                sk.shard_spill(kinds, c_key, c_bin, c_accs, still,
                               (sp_key, sp_bin, sp_fill, sp_accs, oflow_t),
                               self._spill_state(j, c_key.shape[1]))

    def update_sharded(self, key_i64, bins, valid, vals) -> None:
        """key_i64 / bins / valid: ``[n_dev, batch_cap]`` shard-local host
        rows (numpy); vals: one ``[n_dev, batch_cap]`` array per
        accumulator. They are pinned once; each slot copies its own."""
        _DISPATCH["host_steps"] += 1
        host = [self._host_rows(key_i64, np.int64), self._host_rows(bins, np.int32),
                self._host_rows(valid, np.bool_)]
        hvals = [self._host_rows(v, d) for v, d in zip(vals, self.acc_dtypes)]

        def rows(j):
            sl = self.slots[j]
            key, b, ok = (self._to_slot(sl, a[sl.lo:sl.hi]) for a in host)
            return key, b, ok, [self._to_slot(sl, v[sl.lo:sl.hi]) for v in hvals]

        self._exchange_merge(rows)

    # ------------------------------------------------------- fused segments

    def fused_step(self, prefix_fn: Callable, n_inputs: int, n_aux: int) -> Callable:
        """The fused segment step (engine/segment.py mesh path): the segment
        kernel's outputs feed the exchange + merge on the device, with no
        host round trip between projection and state update.

        ``prefix_fn(n, arrays) -> (key_i64, bins_abs, vals, aux)`` runs the
        segment over one padded batch of ``p`` rows (``n_inputs`` numpy
        arrays) on the caller's device and stream: device tensors ``[p]``
        (``vals`` one per accumulator, None for a count lane of ones) and
        ``n_aux`` host scalars (watermark max and count pairs over the
        batch's valid rows). Rows split into contiguous shards, shard d
        owning rows [d * p / n_dev, (d + 1) * p / n_dev), as the JAX step's
        ``row0 = d * pd``; each slot takes its shards' rows (a view on the
        segment's card, a copy to another card) once the segment is done;
        rows at or past n are padding, and K8's input read drops them, the
        late rows (``ontime`` False) and subtracts ``base_bin``.

        Returns ``step(n, base_bin, ontime, arrays) -> aux``; run it through
        ``update_fused`` so the counters stay right."""
        S = self.n_dev

        def step(n: int, base_bin: int, ontime: Optional[np.ndarray], arrays):
            p = len(arrays[0])
            key, bins_abs, vals, aux = prefix_fn(n, arrays)
            if len(aux) != n_aux:
                raise ValueError(f"segment prefix gave {len(aux)} aux values, expected {n_aux}")
            pd = p // S
            ot = None
            if ontime is not None:
                ot = np.zeros(p, dtype=bool)
                ot[:n] = ontime
                ot = self._host_rows(ot.reshape(S, pd))
            done = (torch.cuda.current_stream(key.device).record_event()
                    if key.device.type == "cuda" and len(self.slots) > 1 else None)

            def rows(j):
                sl = self.slots[j]
                if done is not None:
                    sl.stream.wait_event(done)

                def take(t):
                    v = t[sl.lo * pd: sl.hi * pd].view(sl.n, pd)
                    if v.device != sl.device:
                        return v.to(sl.device, non_blocking=True)
                    if sl.stream is not None:
                        v.record_stream(sl.stream)
                    return v

                valid = None if ot is None else self._to_slot(sl, ot[sl.lo:sl.hi])
                return (take(key), take(bins_abs), valid,
                        [None if v is None else take(v) for v in vals])

            self._exchange_merge(rows, bin_offset=base_bin, n_valid=n)
            return aux

        return step

    def update_fused(self, step, n: int, base_bin: int, ontime, arrays):
        """Run one fused step built by ``fused_step`` over a padded batch
        whose length divides into the shards; returns its aux values."""
        _DISPATCH["fused_steps"] += 1
        self.exchange_rows += int(n)
        return step(int(n), int(base_bin), ontime, arrays)

    def mesh_stats(self) -> dict:
        """Rows fed through the exchange and rows resident in the spill
        buffer (the operators' mesh_stats hook)."""
        return {"exchange_rows": self.exchange_rows,
                "overflow_rows": self.overflow_rows}

    # ------------------------------------------------------- closes

    def _spill_rows(self):
        """The spill buffers on the host, shard order: fill ``[n_dev]``,
        then (only where a row is held) keys, bins and lanes ``[n_dev,
        spill_cap]``."""
        fill = self._host(7)
        if int(fill.sum()) == 0:
            return fill, None
        return fill, (self._host(5), self._host(6),
                      [self._host(8, j) for j in range(len(self.acc_kinds))])

    def _drain_spill(self, emit_lo: int, emit_hi: int, free_below: int):
        """Host-side spill-buffer drain: read the (small) per-shard spill
        arrays, emit rows in range, drop rows below free_below, write the
        compacted remainder back to each slot."""
        fill, held = self._spill_rows()
        if held is None:
            self.overflow_rows = 0
            return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                    [np.empty(0, dtype=d) for d in self.acc_dtypes])
        k, b, accs = held
        n, sc = self.n_dev, self.spill_cap
        in_fill = np.arange(sc)[None, :] < fill[:, None]
        emit = in_fill & (b >= emit_lo) & (b < emit_hi)
        keep = in_fill & ~(b < free_below)
        out = (k[emit].view(np.uint64), b[emit].astype(np.int32), [a[emit] for a in accs])
        new_k = np.zeros((n, sc), dtype=np.int64)
        new_b = np.zeros((n, sc), dtype=np.int32)
        new_accs = [np.full((n, sc), _identity(kk, d), dtype=d)
                    for kk, d in zip(self.acc_kinds, self.acc_dtypes)]
        new_fill = np.zeros(n, dtype=np.int32)
        for d_i in range(n):
            sel = np.flatnonzero(keep[d_i])
            m = len(sel)
            new_fill[d_i] = m
            new_k[d_i, :m] = k[d_i, sel]
            new_b[d_i, :m] = b[d_i, sel]
            for j in range(len(accs)):
                new_accs[j][d_i, :m] = accs[j][d_i, sel]
        self.overflow_rows = int(new_fill.sum())
        for j, sl in enumerate(self.slots):
            r = slice(sl.lo, sl.hi)
            with sl.ctx():
                self.slot_states[j] = self.slot_states[j][:5] + (
                    self._to_slot(sl, new_k[r]), self._to_slot(sl, new_b[r]),
                    self._to_slot(sl, new_fill[r]),
                    tuple(self._to_slot(sl, a[r]) for a in new_accs))
        return out

    def extract_all(self, emit_lo: int, emit_hi: int, free_below: int):
        """Close bins across all shards; returns host (key_u64, bin, accs).
        K11 per slot and emit_cap chunk until every shard is drained; each
        slot's round comes to the host as one packed copy into pinned
        memory behind an event on its stream, the slots' rows in shard
        order. Spill-buffer rows for the range combine in on the host."""
        E = min(self.emit_cap, self.cap)

        def extract_once():
            fetches = []
            for sl, st in zip(self.slots, self.slot_states):
                with sl.ctx():
                    res = sk.shard_extract(st[:4], emit_lo, emit_hi, free_below, self.emit_cap)
                    fetches.append(HostFetch(res.packed))
            ks, bs, accs, total = [], [], [[] for _ in self.acc_dtypes], 0
            for sl, f in zip(self.slots, fetches):
                k, b, v, a, t = sk.unpack_extracted(f.result(), sl.n, E, self.acc_dtypes)
                v = v.reshape(-1)
                ks.append(k.reshape(-1)[v].view(np.uint64))
                bs.append(b.reshape(-1)[v])
                for out, x in zip(accs, a):
                    out.append(x.reshape(-1)[v])
                total = max(total, int(t.max()))
            return (np.concatenate(ks), np.concatenate(bs), [np.concatenate(x) for x in accs],
                    total)

        out = _drain_extract_rounds(self.acc_kinds, self.acc_dtypes, self.emit_cap,
                                    extract_once(), extract_once, emit_lo, free_below)
        sk_, sb, saccs = self._drain_spill(emit_lo, emit_hi, free_below)
        if len(sk_):
            out = combine_by_key_bin(
                self.acc_kinds,
                np.concatenate([out[0], sk_]),
                np.concatenate([out[1], sb]),
                [np.concatenate([a, s]) for a, s in zip(out[2], saccs)],
            )
        overflow = int(self._host(4).sum())
        if overflow > 0:
            raise RuntimeError(
                f"sharded aggregate overflow ({overflow} entries lost: table and "
                f"spill buffer both full) — raise table capacity or spill_cap")
        return out

    # ---------------------------------------------------- SlotAggregator API

    def _distribute(self, key_i64, bins, vals):
        """Round-robin host rows into [n_dev, batch_cap] chunks (initial
        placement is arbitrary: the exchange re-routes by key ownership)."""
        n = len(key_i64)
        n_dev, B = self.n_dev, self.batch_cap
        per_step = n_dev * B
        for lo in range(0, n, per_step):
            hi = min(lo + per_step, n)
            k = np.zeros((n_dev, B), dtype=np.int64)
            b = np.zeros((n_dev, B), dtype=np.int32)
            valid = np.zeros((n_dev, B), dtype=bool)
            vs = [np.full((n_dev, B), _identity(kk, d), dtype=d)
                  for kk, d in zip(self.acc_kinds, self.acc_dtypes)]
            rows = np.arange(lo, hi)
            dev = (rows - lo) % n_dev
            pos = (rows - lo) // n_dev
            k[dev, pos] = key_i64[lo:hi]
            b[dev, pos] = bins[lo:hi]
            valid[dev, pos] = True
            for j, v in enumerate(vals):
                vs[j][dev, pos] = v[lo:hi]
            yield k, b, valid, vs

    def update(self, key_u64, bins, vals) -> None:
        self.exchange_rows += len(key_u64)
        key_i64 = np.ascontiguousarray(key_u64, dtype=np.uint64).view(np.int64)
        bins = np.asarray(bins, dtype=np.int32)
        vals = [np.asarray(v, dtype=d) for v, d in zip(vals, self.acc_dtypes)]
        for k, b, valid, vs in self._distribute(key_i64, bins, vals):
            self.update_sharded(k, b, valid, vs)

    def extract(self, emit_lo: int, emit_hi: int, free_below: int):
        return self.extract_all(emit_lo, emit_hi, free_below)

    def extract_start(self, emit_lo: int, emit_hi: int, free_below: int):
        return _ReadyHandle(self.extract_all(emit_lo, emit_hi, free_below))

    def free_bins_below(self, below: int) -> None:
        # empty emit range: frees every table and spill row with bin < below
        self.extract_all(below, below, below)

    def scan_range(self, emit_lo: int, emit_hi: int):
        k, b, accs = self.snapshot()
        sel = (b >= emit_lo) & (b < emit_hi)
        return k[sel], b[sel], [a[sel] for a in accs]

    def snapshot(self):
        """Exact non-destructive state readout: the sharded table and spill
        buffers read to the host in shard order and combined (off the hot
        loop). The rows do not depend on the placement, so a snapshot taken
        over k slots restores over any other."""
        occ = self._host(2)
        keys = self._host(0)[occ].view(np.uint64)
        bins = self._host(1)[occ].astype(np.int32)
        accs = [self._host(3, j)[occ] for j in range(len(self.acc_kinds))]
        fill, held = self._spill_rows()
        self.overflow_rows = int(fill.sum())
        if held is not None:
            in_fill = np.arange(self.spill_cap)[None, :] < fill[:, None]
            sp_k, sp_b, sp_accs = held
            keys = np.concatenate([keys, sp_k[in_fill].view(np.uint64)])
            bins = np.concatenate([bins, sp_b[in_fill].astype(np.int32)])
            accs = [np.concatenate([a, s[in_fill]]) for a, s in zip(accs, sp_accs)]
        if not len(keys):
            return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                    [np.empty(0, dtype=d) for d in self.acc_dtypes])
        return combine_by_key_bin(self.acc_kinds, keys, bins, accs)

    def restore(self, key_u64, bins, accs) -> None:
        """Merge snapshotted partials back in: the step combines count like
        sum (partials arrive as values), so update() is the merge path."""
        self.slot_states = self._init_state()
        self.update(np.asarray(key_u64, dtype=np.uint64),
                    np.asarray(bins, dtype=np.int32), accs)
