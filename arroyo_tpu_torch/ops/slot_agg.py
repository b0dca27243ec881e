"""Slot-directory windowed aggregation with torch device state (the port's
copy of arroyo_tpu/ops/slot_agg.py).

The work splits by what each side is good at:

  host (numpy): the BinSlotDirectory maps each (bin, key) group to a
      device slot. Slots live in fixed-size REGIONS; each window bin owns a
      chain of regions, so a window close maps to whole regions of the
      state, never a compaction. The directory is open addressing over
      64-bit mixed codes with a monotone bin boundary (a close is always
      "bin < boundary", so dead entries need no tombstones).

  device (torch tensors, hand-written CUDA kernels in ops/kernels.py):
      state = one [cap] tensor per accumulator, nothing else. An update is
      one scatter-combine launch over all lanes (K1). A window close reads
      the closing bins' regions packed into one int64 and one float64
      buffer and clears them in the same launch (K2; K3 clears expired
      bins it does not read), and copies the buffers to pinned host memory
      behind an event, fetched on the prefetch threads.

  spill tier: when every region is in use, new (bin, key) groups aggregate
      into a host dict store instead of failing.

The state is updated in place: the torch counterpart of the JAX step's
donated buffers. ``backend="numpy"`` is DeviceHashAggregator's dict store,
inherited unchanged, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..hashing import splitmix64
from . import kernels, staging
from .aggregate import AGG_KINDS, DeviceHashAggregator, _identity, combine_by_key_bin
from .prefetch import HostFetch

_BIN_MIX = np.uint64(0x9E3779B97F4A7C15)
_DEAD_BIN = -(2**62)
_I32_MAX = np.iinfo(np.int32).max
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
                 np.dtype(np.uint64): torch.uint64}

# the directory's state, as to_state() gives it and from_state() takes it
_DIR_ARRAYS = ("region_fill", "slot_keys", "slot_bins", "hcode", "hbin", "hslot")


class BinSlotDirectory:
    """Host-side (bin, key) -> device-slot map with region-chained bins.

    Probing is vectorized numpy over the batch's unique codes: each round
    gathers one candidate directory row per pending code and resolves
    match / claim / advance."""

    def __init__(self, cap: int, region_size: int):
        if cap % region_size:
            raise ValueError(f"table capacity {cap} is not a multiple of region size {region_size}")
        self.cap = cap
        self.R = region_size
        self.n_regions = cap // region_size
        self.free_regions = list(range(self.n_regions - 1, -1, -1))
        self.bin_regions: dict[int, list[int]] = {}
        self.region_fill = np.zeros(self.n_regions, dtype=np.int64)
        # per-slot identity (for emission: the device stores only accumulators)
        self.slot_keys = np.zeros(cap, dtype=np.int64)
        self.slot_bins = np.full(cap, _DEAD_BIN, dtype=np.int64)
        # open-addressing directory: mixed code -> slot
        self.hcap = 1 << (cap.bit_length() + 1)  # ~4x cap
        self.hmask = np.uint64(self.hcap - 1)
        self.hcode = np.zeros(self.hcap, dtype=np.uint64)
        self.hbin = np.full(self.hcap, _DEAD_BIN, dtype=np.int64)
        self.hslot = np.full(self.hcap, -1, dtype=np.int64)
        self.boundary = _DEAD_BIN  # bins below this are closed (monotone)

    def to_state(self) -> dict:
        """Copies of everything that defines the directory."""
        st = {a: getattr(self, a).copy() for a in _DIR_ARRAYS}
        st.update(cap=self.cap, R=self.R, boundary=int(self.boundary),
                  free_regions=list(self.free_regions),
                  bin_regions={int(b): list(r) for b, r in self.bin_regions.items()})
        return st

    @classmethod
    def from_state(cls, st) -> "BinSlotDirectory":
        """A directory from ``to_state()``'s dict or from any object with
        the same attributes (arroyo_tpu's BinSlotDirectory has them)."""
        get = st.get if isinstance(st, dict) else (lambda a: getattr(st, a))
        d = cls(int(get("cap")), int(get("R")))
        for a in _DIR_ARRAYS:
            arr = np.asarray(get(a))
            cur = getattr(d, a)
            if arr.shape != cur.shape:
                raise ValueError(f"directory {a} has shape {arr.shape}, expected {cur.shape}")
            setattr(d, a, arr.astype(cur.dtype, copy=True))
        d.boundary = int(get("boundary"))
        d.free_regions = [int(r) for r in get("free_regions")]
        d.bin_regions = {int(b): [int(r) for r in rs] for b, rs in get("bin_regions").items()}
        return d

    # ------------------------------------------------------------- alloc

    def _alloc(self, b: int, n: int) -> np.ndarray:
        """Up to n device slots for bin b, chaining regions; may return fewer
        than n when capacity runs out (caller spills the remainder)."""
        regs = self.bin_regions.get(b)
        if regs is None:
            regs = self.bin_regions[b] = []
        chunks = []
        while n > 0:
            if regs and self.region_fill[regs[-1]] < self.R:
                r = regs[-1]
                fill = int(self.region_fill[r])
                take = min(n, self.R - fill)
                chunks.append(r * self.R + np.arange(fill, fill + take, dtype=np.int64))
                self.region_fill[r] = fill + take
                n -= take
            elif self.free_regions:
                r = self.free_regions.pop()
                self.region_fill[r] = 0
                regs.append(r)
            else:
                break
        if not regs:
            del self.bin_regions[b]
        if not chunks:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]

    def live_bins(self) -> list[int]:
        return sorted(self.bin_regions)

    def close_bin(self, b: int) -> list[int]:
        """Release bin b's regions for reuse; returns the region ids (the
        caller must have dispatched the device-side clear first)."""
        regs = self.bin_regions.pop(b, [])
        for r in regs:
            self.free_regions.append(r)
        return regs

    # ------------------------------------------------------------- lookup

    def lookup_or_assign(
        self, codes: np.ndarray, keys: np.ndarray, bins: np.ndarray
    ) -> np.ndarray:
        """codes: unique uint64 mixed (bin,key) codes; keys/bins: the exact
        identities behind each code. Returns int64 slots; -1 = spill."""
        m = len(codes)
        out = np.full(m, -1, dtype=np.int64)
        if m == 0:
            return out
        h = (codes & self.hmask).astype(np.int64)
        pending = np.arange(m)
        spill_blocked = False
        for _ in range(self.hcap):
            if len(pending) == 0:
                break
            hp = h[pending]
            cp = codes[pending]
            hc = self.hcode[hp]
            live = (self.hslot[hp] >= 0) & (self.hbin[hp] >= self.boundary)
            match = live & (hc == cp)
            if match.any():
                mi = pending[match]
                s = self.hslot[h[mi]]
                bad = (self.slot_keys[s] != keys[mi]) | (self.slot_bins[s] != bins[mi])
                if bad.any():
                    raise RuntimeError("64-bit (bin,key) code collision in slot directory")
                out[mi] = s
            empty = ~live
            claim = pending[empty]
            if len(claim):
                # claim conflicts within the batch: first code per position
                # wins, the rest advance and keep probing
                hcl = h[claim]
                _uniq, first = np.unique(hcl, return_index=True)
                winners = claim[first]
                if not spill_blocked:
                    order = np.argsort(bins[winners], kind="stable")
                    winners_sorted = winners[order]
                    wb = bins[winners_sorted]
                    seg = np.ones(len(wb), dtype=bool)
                    seg[1:] = wb[1:] != wb[:-1]
                    starts = np.flatnonzero(seg)
                    ends = np.append(starts[1:], len(wb))
                    for s0, s1 in zip(starts, ends):
                        grp = winners_sorted[s0:s1]
                        slots = self._alloc(int(wb[s0]), len(grp))
                        if len(slots) < len(grp):
                            spill_blocked = True  # unallocated stay -1
                            grp = grp[: len(slots)]
                        if len(grp) == 0:
                            continue
                        self.slot_keys[slots] = keys[grp]
                        self.slot_bins[slots] = bins[grp]
                        pos = h[grp]
                        self.hcode[pos] = codes[grp]
                        self.hbin[pos] = bins[grp]
                        self.hslot[pos] = slots
                        out[grp] = slots
            # still pending: not matched and not successfully claimed
            resolved = out[pending] >= 0
            give_up = np.zeros(len(pending), dtype=bool)
            if spill_blocked:
                give_up = ~resolved & empty  # nothing left to allocate
            keep = ~resolved & ~give_up
            nxt = pending[keep]
            h[nxt] = (h[nxt] + 1) & int(self.hmask)
            pending = nxt
        return out


class SlotExtractHandle:
    """In-flight window close: the packed buffers are streaming to the
    host; identities (key hash, bin) were snapshotted host-side at dispatch,
    so region reuse cannot race the fetch."""

    def __init__(self, agg: "SlotAggregator", groups, spill):
        self._agg = agg
        # groups: [(regs, HostFetch|None, HostFetch|None)], regs is
        # [(bin, keys_i64_copy, fill), ...] in buffer order
        self._groups = groups
        self._spill = spill  # (keys_u64, bins_i32, [acc arrays])

    def is_ready(self) -> bool:
        return all((ib is None or ib.is_ready()) and (fb is None or fb.is_ready())
                   for (_regs, ib, fb) in self._groups)

    def result(self) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        agg = self._agg
        R = agg.region_size
        int_idx = [i for i, d in enumerate(agg.acc_dtypes) if not np.issubdtype(d, np.floating)]
        flt_idx = [i for i, d in enumerate(agg.acc_dtypes) if np.issubdtype(d, np.floating)]
        keys_out, bins_out = [], []
        accs_out: list[list[np.ndarray]] = [[] for _ in agg.acc_dtypes]
        for regs, ibuf, fbuf in self._groups:
            # padded tail bases (duplicates of the first) are not in regs
            ilanes = ibuf.result().reshape(-1, len(int_idx), R) if ibuf is not None else None
            flanes = fbuf.result().reshape(-1, len(flt_idx), R) if fbuf is not None else None
            for pos, (b, keys_i64, fill) in enumerate(regs):
                if fill == 0:
                    continue
                keys_out.append(keys_i64.view(np.uint64))
                bins_out.append(np.full(fill, b, dtype=np.int32))
                for j, i in enumerate(int_idx):
                    accs_out[i].append(ilanes[pos, j, :fill].astype(agg.acc_dtypes[i]))
                for j, i in enumerate(flt_idx):
                    accs_out[i].append(flanes[pos, j, :fill].astype(agg.acc_dtypes[i]))
        if len(self._spill[0]):
            sk, sb, sa = self._spill
            keys_out.append(sk)
            bins_out.append(sb)
            for i, a in enumerate(sa):
                accs_out[i].append(a)
        if not keys_out:
            return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                    [np.empty(0, dtype=d) for d in agg.acc_dtypes])
        return combine_by_key_bin(
            agg.acc_kinds, np.concatenate(keys_out), np.concatenate(bins_out),
            [np.concatenate(a) for a in accs_out])


class SlotAggregator(DeviceHashAggregator):
    """Streaming (bin, key) -> accumulators store, DeviceHashAggregator's
    interface: host slot directory plus torch device state, on one explicit
    device (``device`` None = cuda, which raises without CUDA; tests pass
    "cpu", where the kernels' plain versions run). ``backend="numpy"``
    inherits the dict store, on no device."""

    def __init__(
        self,
        acc_kinds: Sequence[str],
        acc_dtypes: Sequence[np.dtype],
        cap: int = 65536,
        batch_cap: int = 8192,
        max_probes: int = 64,  # unused; the constructor matches DeviceHashAggregator's
        emit_cap: int = 8192,  # unused; region_size bounds each transfer
        backend: str = "jax",
        region_size: int = 2048,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.region_size = region_size
        if backend != "jax":
            super().__init__(acc_kinds, acc_dtypes, cap=cap, batch_cap=batch_cap,
                             max_probes=max_probes, emit_cap=emit_cap, backend=backend)
            return
        self.acc_kinds = tuple(acc_kinds)
        self.acc_dtypes = tuple(np.dtype(d) for d in acc_dtypes)
        if len(self.acc_kinds) != len(self.acc_dtypes):
            raise ValueError("one dtype per accumulator kind")
        for k, d in zip(self.acc_kinds, self.acc_dtypes):
            if k not in AGG_KINDS:
                raise NotImplementedError(
                    f"accumulator kind {k!r} has no device path (collected aggregates "
                    f"run on the host store, backend 'numpy')")
            if d not in _TORCH_DTYPES:
                raise TypeError(f"accumulator dtype {d} not one of "
                                f"int32/int64/float32/float64/uint64")
        self.device = resolve_device(device)
        self.cap = cap
        self.batch_cap = batch_cap
        self.max_probes = max_probes
        self.emit_cap = emit_cap
        self.backend = backend
        self._merge_mode = False
        self._n_flt_lanes = sum(1 for d in self.acc_dtypes if np.issubdtype(d, np.floating))
        self._n_int_lanes = len(self.acc_dtypes) - self._n_flt_lanes
        self._reset()

    def _reset(self) -> None:
        self.directory = BinSlotDirectory(self.cap, self.region_size)
        # host spill store (bin, key) -> [acc parts]; fed when regions run out
        self.spill: dict[tuple[int, int], list] = {}
        self.state = [
            torch.from_numpy(np.full(self.cap, _identity(k, d), dtype=d)).to(self.device)
            for k, d in zip(self.acc_kinds, self.acc_dtypes)
        ]

    # ------------------------------------------------------------- update

    def _update_chunk(self, key_u64, bins, vals) -> None:
        ku = np.ascontiguousarray(key_u64, dtype=np.uint64)
        ks = ku.view(np.int64)
        b64 = np.ascontiguousarray(bins, dtype=np.int64)
        codes = splitmix64(ku ^ (b64.astype(np.uint64) * _BIN_MIX))
        uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
        row_slots = self.directory.lookup_or_assign(uniq, ks[first], b64[first])[inv]
        vals = [np.asarray(v) for v in vals]
        spill_rows = row_slots < 0
        if spill_rows.any():
            sel = np.flatnonzero(spill_rows)
            self._spill_update(ks[sel], b64[sel], [v[sel] for v in vals])
            keep = np.flatnonzero(~spill_rows)
            row_slots = row_slots[keep]
            vals = [v[keep] for v in vals]
        if len(row_slots) == 0:
            return
        # int32 slot indices halve the per-batch index transfer; the slots
        # and every shipped value lane cross in one pinned copy
        idx_dt = np.int32 if self.cap < _I32_MAX else np.int64
        ship = [not (k == "count" and not self._merge_mode) for k in self.acc_kinds]
        staged, _host = staging.stage(
            [row_slots.astype(idx_dt)] + [np.asarray(v, dtype=dt)
                                          for v, dt, s in zip(vals, self.acc_dtypes, ship) if s],
            self.device)
        it = iter(staged[1:])
        vs = [next(it) if s else None for s in ship]
        kernels.slot_scatter_combine(self.state, self.acc_kinds, staged[0], vs)

    def _spill_update(self, keys_i64, bins_i64, vals) -> None:
        order = np.lexsort((keys_i64, bins_i64))
        k_s, b_s = keys_i64[order], bins_i64[order]
        vs = [np.asarray(v)[order] for v in vals]
        newseg = np.ones(len(k_s), dtype=bool)
        newseg[1:] = (k_s[1:] != k_s[:-1]) | (b_s[1:] != b_s[:-1])
        starts = np.flatnonzero(newseg)
        ends = np.append(starts[1:], len(k_s))
        store = self.spill
        for s, e in zip(starts, ends):
            kk = (int(b_s[s]), int(k_s[s]))
            cur = store.get(kk)
            parts = []
            for i, kind in enumerate(self.acc_kinds):
                seg = vs[i][s:e]
                red = (seg.sum() if kind in ("sum", "count")
                       else (seg.min() if kind == "min" else seg.max()))
                if cur is not None:
                    red = (cur[i] + red if kind in ("sum", "count")
                           else (min(cur[i], red) if kind == "min" else max(cur[i], red)))
                parts.append(self.acc_dtypes[i].type(red))
            store[kk] = parts

    def _take_spill(self, emit_lo: int, emit_hi: int, free_below: int):
        hit = [kk for kk in self.spill if emit_lo <= kk[0] < emit_hi]
        if not hit:
            return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                    [np.empty(0, dtype=d) for d in self.acc_dtypes])
        ks = np.array([k for (_b, k) in hit], dtype=np.int64).view(np.uint64)
        bs = np.array([b for (b, _k) in hit], dtype=np.int32)
        accs = [np.array([self.spill[kk][i] for kk in hit], dtype=d)
                for i, d in enumerate(self.acc_dtypes)]
        for kk in hit:
            if kk[0] < free_below:
                del self.spill[kk]
        return ks, bs, accs

    # ------------------------------------------------------------- extract

    def _collect_regions(self, emit_lo: int, emit_hi: int):
        """[(bin, base, fill, keys_copy)] for every region of bins in range."""
        d = self.directory
        out = []
        for b in d.live_bins():
            if not (emit_lo <= b < emit_hi):
                continue
            for r in d.bin_regions.get(b, ()):
                base = r * self.region_size
                fill = int(d.region_fill[r])
                out.append((b, base, fill, d.slot_keys[base: base + fill].copy()))
        return out

    def _read_regions(self, regs, do_clear: bool):
        """Region reads, <= 16 per launch, k padded to a power of two by
        duplicating the first base (the JAX package's bucketing, kept so
        both read the same shapes); with do_clear the same launch clears
        them (K2's read-and-clear mode). Each group's buffers start their
        copy to the host at once."""
        groups = []
        for i in range(0, len(regs), kernels.MAX_BASES):
            chunk = regs[i: i + kernels.MAX_BASES]
            k = 1
            while k < len(chunk):
                k *= 2
            bases = [c[1] for c in chunk] + [chunk[0][1]] * (k - len(chunk))
            ibuf, fbuf = kernels.slot_region_read_pack(
                self.state, bases, self.region_size,
                clear_kinds=self.acc_kinds if do_clear else None)
            groups.append(([(b, keys, fill) for (b, _base, fill, keys) in chunk],
                           HostFetch(ibuf) if self._n_int_lanes else None,
                           HostFetch(fbuf) if self._n_flt_lanes else None))
        return groups

    def _clear_bins(self, bins) -> None:
        """Clear, without reading, every region of the given bins."""
        d = self.directory
        bases = [r * self.region_size for b in bins for r in d.bin_regions.get(b, ())]
        for i in range(0, len(bases), kernels.MAX_BASES):
            kernels.slot_region_clear(self.state, self.acc_kinds,
                                      bases[i: i + kernels.MAX_BASES], self.region_size)

    def extract_start(self, emit_lo: int, emit_hi: int, free_below: int) -> SlotExtractHandle:
        """Dispatch the close of bins [emit_lo, emit_hi): reads (and, below
        free_below, clears) their regions and starts the host copies.
        Bins below free_below are released."""
        d = self.directory
        regs_destr = self._collect_regions(emit_lo, min(emit_hi, free_below))
        regs_keep = self._collect_regions(max(emit_lo, free_below), emit_hi)
        groups = self._read_regions(regs_destr, do_clear=True)
        groups += self._read_regions(regs_keep, do_clear=False)
        expired = [b for b in d.live_bins() if b < free_below]
        self._clear_bins([b for b in expired if not (emit_lo <= b < emit_hi)])
        for b in expired:
            d.close_bin(b)
        spill = self._take_spill(emit_lo, emit_hi, free_below)
        for kk in [kk for kk in self.spill if kk[0] < free_below]:
            del self.spill[kk]
        if free_below > d.boundary:
            d.boundary = free_below
        return SlotExtractHandle(self, groups, spill)

    def extract(self, emit_lo: int, emit_hi: int, free_below: int):
        if self.backend == "numpy":
            return self._extract_numpy(emit_lo, emit_hi, free_below)
        return self.extract_start(emit_lo, emit_hi, free_below).result()

    def scan_range(self, emit_lo: int, emit_hi: int):
        """Non-destructive read of every group with bin in [emit_lo, emit_hi)."""
        if self.backend == "numpy":
            return super().scan_range(emit_lo, emit_hi)
        groups = self._read_regions(self._collect_regions(emit_lo, emit_hi), do_clear=False)
        spill = self._take_spill(emit_lo, emit_hi, free_below=_DEAD_BIN)
        return SlotExtractHandle(self, groups, spill).result()

    def free_bins_below(self, below: int) -> None:
        if self.backend == "numpy":
            return super().free_bins_below(below)
        d = self.directory
        expired = [b for b in d.live_bins() if b < below]
        self._clear_bins(expired)
        for b in expired:
            d.close_bin(b)
        for kk in [kk for kk in self.spill if kk[0] < below]:
            del self.spill[kk]
        if below > d.boundary:
            d.boundary = below

    # ------------------------------------------------------------- point reads

    def read_slots(self, slots: np.ndarray) -> list[np.ndarray]:
        """Current accumulator values at the given device slots, one array
        per lane in the lane's own dtype: one copy each way around one K7
        gather of every lane. The slots cross in one pinned copy on the
        current stream, the stream of every K1 this aggregator launched,
        so K7 reads their sums; its one packed output comes back in one
        copy to pinned memory behind an event that the host waits on
        before reading (the JAX package's ``wait_buffers_ready``). A lane
        whose widened dtype is its own (int64, float64) is a view of that
        host buffer; the others are converted. Used by the updating-
        aggregate flush; window paths never gather."""
        n = len(slots)
        if n == 0:
            return [np.empty(0, dtype=d) for d in self.acc_dtypes]
        idx_dt = np.int32 if self.cap < _I32_MAX else np.int64
        (st,), slots_host = staging.stage([np.asarray(slots, dtype=idx_dt)], self.device)
        ibuf, fbuf, packed = kernels.slot_gather(self.state, st, packed=True)
        host = HostFetch(packed).result()
        # the slots' pinned buffer is held until here, past the event the
        # fetch waited on, which their copy and K7's launch precede
        del slots_host
        f0 = fbuf.data_ptr() - packed.data_ptr()  # the float part's byte offset
        ib = host[:ibuf.nbytes].view(np.int64).reshape(self._n_int_lanes, n)
        fb = host[f0: f0 + fbuf.nbytes].view(np.float64).reshape(self._n_flt_lanes, n)
        out, ii, fi = [], 0, 0
        for d in self.acc_dtypes:
            if np.issubdtype(d, np.floating):
                out.append(fb[fi].astype(d, copy=False))
                fi += 1
            else:
                out.append(ib[ii].astype(d, copy=False))
                ii += 1
        return out

    def slots_of(self, key_u64: np.ndarray) -> np.ndarray:
        """Device slots currently assigned to these (bin 0) keys; -1 for
        keys that own no slot (unallocated, or living in the host spill
        tier). Read-only: never allocates. One probe round over every
        pending key at a time, as lookup_or_assign probes: a dead or empty
        directory position ends a key's probe with a miss."""
        d = self.directory
        ku = np.ascontiguousarray(key_u64, dtype=np.uint64)
        ks = ku.view(np.int64)
        codes = splitmix64(ku)  # the bin-0 code: key ^ (0 * _BIN_MIX) = key
        out = np.full(len(ks), -1, dtype=np.int64)
        h = (codes & d.hmask).astype(np.int64)
        pending = np.arange(len(ks))
        for _ in range(d.hcap):
            if len(pending) == 0:
                break
            hp = h[pending]
            hs = d.hslot[hp]
            live = (hs >= 0) & (d.hbin[hp] >= d.boundary)
            match = live & (d.hcode[hp] == codes[pending]) & (d.slot_keys[hs] == ks[pending])
            out[pending[match]] = hs[match]
            nxt = pending[live & ~match]
            h[nxt] = (h[nxt] + 1) & int(d.hmask)
            pending = nxt
        return out

    # ------------------------------------------------------------- state

    def snapshot(self):
        """Every live group: (keys_u64, bins_i32, accs)."""
        if self.backend == "numpy":
            return super().snapshot()
        d = self.directory
        live = d.live_bins() + [b for (b, _k) in self.spill]
        if not live:
            return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                    [np.empty(0, dtype=dt) for dt in self.acc_dtypes])
        return self.scan_range(min(live), max(live) + 1)

    def restore(self, key_u64, bins, accs) -> None:
        """Reset, then merge partial accumulators in (count lanes add the
        given counts instead of 1)."""
        if self.backend == "numpy":
            return super().restore(key_u64, bins, accs)
        self._reset()
        self._merge_mode = True
        try:
            self.update(key_u64, bins.astype(np.int32), accs)
        finally:
            self._merge_mode = False

    def to_numpy_state(self) -> tuple[list[np.ndarray], dict, dict]:
        """(lanes, directory, spill): the [cap] lanes as numpy, the
        directory as BinSlotDirectory.to_state() gives it, and a copy of
        the spill store. The same triple arroyo_tpu's SlotAggregator holds
        (its ``state`` lanes, ``directory`` and ``spill``)."""
        lanes = [a.cpu().numpy().copy() for a in self.state]
        spill = {kk: list(parts) for kk, parts in self.spill.items()}
        return lanes, self.directory.to_state(), spill

    def from_numpy_state(self, lanes: Sequence[np.ndarray], directory, spill: dict) -> None:
        """Load state from numpy: ``lanes`` one [cap] array per accumulator,
        ``directory`` a to_state() dict or a BinSlotDirectory (this port's
        or arroyo_tpu's), ``spill`` the (bin, key) -> parts store."""
        if len(lanes) != len(self.acc_dtypes):
            raise ValueError(f"{len(lanes)} lanes for {len(self.acc_dtypes)} accumulators")
        new_dir = BinSlotDirectory.from_state(directory)
        if new_dir.cap != self.cap or new_dir.R != self.region_size:
            raise ValueError(f"directory of cap {new_dir.cap} / region {new_dir.R} loaded into "
                             f"an aggregator of cap {self.cap} / region {self.region_size}")
        state = []
        for a, d in zip(lanes, self.acc_dtypes):
            a = np.asarray(a)
            if a.shape != (self.cap,) or a.dtype != d:
                raise ValueError(f"lane of shape {a.shape} / {a.dtype}, expected ({self.cap},) / {d}")
            state.append(torch.from_numpy(a.copy()).to(self.device))
        self.state = state
        self.directory = new_dir
        self.spill = {(int(b), int(k)): [d.type(p) for d, p in zip(self.acc_dtypes, parts)]
                      for (b, k), parts in spill.items()}
