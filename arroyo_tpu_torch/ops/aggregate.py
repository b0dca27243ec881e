"""The keyed window aggregate's store and helpers (the port's copy of
arroyo_tpu/ops/aggregate.py): the host helpers, the plain PyTorch versions
of the hash table's steps ``sort_reduce`` (B7) and ``probe_merge`` (B8),
and ``DeviceHashAggregator`` with both backends: the single-device table
(B9, its programs in ops/hash_kernels.py) and the dict-based host store."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

AGG_KINDS = ("sum", "count", "min", "max")


def acc_kinds_for(kind: str) -> tuple[str, ...]:
    """Accumulators backing one SQL aggregate (avg -> sum+count)."""
    if kind == "avg":
        return ("sum", "count")
    if kind in AGG_KINDS:
        return (kind,)
    raise ValueError(f"unsupported aggregate {kind}")


def finalize_aggs(kinds: Sequence[str], acc_arrays: list[np.ndarray]) -> list[np.ndarray]:
    """acc arrays (in acc_kinds_for order, flattened) -> one array per SQL
    aggregate. count_distinct counts the distinct values its collected
    state holds (a list, or the updating aggregate's value -> multiplicity
    map). UDAFs need a UDF registry, which the port does not have: they are
    refused before any state is built (windows/tumbling.py acc_plan)."""
    out = []
    i = 0
    for kind in kinds:
        if kind == "avg":
            s, c = acc_arrays[i], acc_arrays[i + 1]
            i += 2
            out.append(np.divide(s, np.maximum(c, 1)).astype(np.float64))
        elif kind == "count_distinct":
            out.append(np.array([len(set(lst)) for lst in acc_arrays[i]], dtype=np.int64))
            i += 1
        else:
            out.append(acc_arrays[i])
            i += 1
    return out


def combine_by_key(
    acc_kinds: Sequence[str], keys: np.ndarray, accs: list[np.ndarray]
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Combine per-bin partials that share a key into one accumulator row per
    key (the sliding window's finish step: the width/slide partial bins of a
    window collapse to one output row). Host numpy: the input is already
    reduced to distinct (bin, key) pairs."""
    if len(keys) == 0:
        return keys, accs
    signed = keys.view(np.int64)
    order = np.argsort(signed, kind="stable")
    k_s = signed[order]
    newseg = np.ones(len(k_s), dtype=bool)
    newseg[1:] = k_s[1:] != k_s[:-1]
    starts = np.flatnonzero(newseg)
    out_accs = []
    for kind, a in zip(acc_kinds, accs):
        a_s = a[order]
        if kind in ("sum", "count"):
            red = np.add.reduceat(a_s, starts)
        elif kind == "min":
            red = np.minimum.reduceat(a_s, starts)
        else:
            red = np.maximum.reduceat(a_s, starts)
        out_accs.append(red.astype(a.dtype))
    return k_s[starts].view(np.uint64), out_accs


def combine_by_key_bin(
    acc_kinds: Sequence[str],
    keys: np.ndarray,
    bins: np.ndarray,
    accs: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Merge duplicate (key, bin) entries: a group that spilled to the host
    store while it also owns a device slot is emitted from both, and its
    parts combine here."""
    if len(keys) <= 1:
        return keys, bins, accs
    signed = keys.view(np.int64)
    order = np.lexsort((signed, bins))
    k_s, b_s = signed[order], bins[order]
    newseg = np.ones(len(k_s), dtype=bool)
    newseg[1:] = (k_s[1:] != k_s[:-1]) | (b_s[1:] != b_s[:-1])
    if newseg.all():
        return keys, bins, accs
    starts = np.flatnonzero(newseg)
    out_accs = []
    for kind, a in zip(acc_kinds, accs):
        a_s = a[order]
        if kind in ("sum", "count"):
            red = np.add.reduceat(a_s, starts)
        elif kind == "min":
            red = np.minimum.reduceat(a_s, starts)
        else:
            red = np.maximum.reduceat(a_s, starts)
        out_accs.append(red.astype(a.dtype))
    return k_s[starts].view(np.uint64), b_s[starts], out_accs


def _identity(kind: str, dtype):
    """The value an empty accumulator holds: 0 for sums and counts, the
    dtype's top for min and its bottom for max (+-inf for floats)."""
    if kind in ("sum", "count"):
        return np.array(0, dtype=dtype)
    if kind == "min":
        return np.array(np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else np.inf, dtype=dtype)
    if kind == "max":
        return np.array(np.iinfo(dtype).min if np.issubdtype(dtype, np.integer) else -np.inf, dtype=dtype)
    raise ValueError(kind)


def _drain_extract_rounds(acc_kinds: Sequence[str], acc_dtypes: Sequence[np.dtype],
                          emit_cap: int, first, next_round, emit_lo: int, free_below: int):
    """The host's drain loop of a destructive extract that returns at most
    ``emit_cap`` rows per round (per shard, for the sharded store).
    ``first`` is the round already fetched, (keys_u64, bins, accs, total)
    with ``total`` the (largest per-shard) count of entries in the range;
    ``next_round()`` dispatches and decodes one more. Termination: a round
    that covered everything (total <= emit_cap), emitted nothing (no
    progress possible: every leftover lies outside the emit range), or a
    non-destructive call (free_below <= emit_lo: a re-read would duplicate,
    not drain). The result is merged with combine_by_key_bin: freed slots
    punch holes in probe chains, so the table may hold duplicate (key, bin)
    entries whose accumulators each carry part of the total."""
    keys_out, bins_out = [], []
    accs_out: list[list[np.ndarray]] = [[] for _ in acc_dtypes]
    k, b, accs, total = first
    while True:
        if len(k):
            keys_out.append(k)
            bins_out.append(b)
            for i, a in enumerate(accs):
                accs_out[i].append(a)
        if total <= emit_cap or len(k) == 0 or free_below <= emit_lo:
            break
        k, b, accs, total = next_round()
    if not keys_out:
        return (
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int32),
            [np.empty(0, dtype=d) for d in acc_dtypes],
        )
    return combine_by_key_bin(
        acc_kinds,
        np.concatenate(keys_out),
        np.concatenate(bins_out),
        [np.concatenate(a).astype(d) for a, d in zip(accs_out, acc_dtypes)],
    )


# =========================================================================
# plain PyTorch versions of the keyed hash table's device steps (B7, B8):
# the kernels K8 and K9 (csrc/sharded_agg.cu, ops/sharded_kernels.py) are
# held against these, and these against the JAX package's jitted twins
# =========================================================================

_I64_MIN = np.iinfo(np.int64).min
_I64_MAX = np.iinfo(np.int64).max
_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    """Float bits (viewed as signed integers) mapped so that integer order
    is float order with -0.0 below +0.0; the map is its own inverse."""
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def _to_signed(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A uint64 lane as int64 in which the kind's operation is the signed
    one: the bits as they are for sums (wrapping adds agree), the sign bit
    flipped for min/max (unsigned order becomes signed order, and the
    identities 0 and U64_MAX become INT64_MIN and INT64_MAX)."""
    t = t.view(torch.int64)
    return t if kind in ("sum", "count") else t ^ _I64_MIN


def _from_signed(kind: str, t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_to_signed``: a uint64 lane again."""
    t = t if kind in ("sum", "count") else t ^ _I64_MIN
    return t.contiguous().view(torch.uint64)


def _combine(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two accumulators of one lane combined (``_combine_jnp``): add, or
    min/max that propagate NaN and order -0.0 below +0.0."""
    if kind in ("sum", "count"):
        return a + b
    if not a.dtype.is_floating_point:
        return torch.minimum(a, b) if kind == "min" else torch.maximum(a, b)
    ity = torch.int64 if a.dtype == torch.float64 else torch.int32
    ka, kb = _ordered(a.view(ity)), _ordered(b.view(ity))
    pick = torch.minimum(ka, kb) if kind == "min" else torch.maximum(ka, kb)
    out = _ordered(pick).view(a.dtype)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(out, float("nan")), out)


def _seg_reduce(kind: str, v: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Reduce ``v`` (rows in sorted order, ``seg`` their flat segment id)
    into ``num`` segments, empty ones
    holding the kind's identity (``_seg_reduce_jnp``). Float sums add each
    segment's rows one after another in sorted order from +0.0, as XLA's
    segment_sum does: the CPU's ``index_add_`` adds row after row in order
    (a CUDA ``index_add_`` adds with atomics in no fixed order, so on the
    card the plain version sums on the host). Every other reduction is
    independent of order."""
    ident = _identity(kind, np.dtype(str(v.dtype).replace("torch.", ""))).item()
    out = torch.full((num,), ident, dtype=v.dtype, device=v.device)
    if kind in ("sum", "count"):
        if not v.dtype.is_floating_point:
            return out.index_add_(0, seg, v)
        return out.copy_(out.cpu().index_add_(0, seg.cpu(), v.cpu()))
    if not v.dtype.is_floating_point:
        return out.scatter_reduce_(0, seg, v, "amin" if kind == "min" else "amax")
    ity = torch.int64 if v.dtype == torch.float64 else torch.int32
    nan_v = torch.isnan(v)
    key = _ordered(out.view(ity))
    key.scatter_reduce_(0, seg[~nan_v], _ordered(v[~nan_v].view(ity)),
                        "amin" if kind == "min" else "amax")
    out = _ordered(key).view(v.dtype).clone()
    out[seg[nan_v]] = float("nan")
    return out


def sort_reduce(acc_kinds: Sequence[str], key: torch.Tensor, bins: torch.Tensor,
                valid: torch.Tensor, vals: Sequence[Optional[torch.Tensor]]):
    """Plain PyTorch version of B7 (arroyo_tpu/ops/aggregate.py sort_reduce)
    over ``[..., L]`` tensors, each leading index (a shard) on its own:
    collapse a padded batch to unique (key, bin) partials. Invalid rows
    sort as (INT64_MAX, INT32_MAX); a stable lexsort by (key, bin) makes
    duplicates adjacent; each segment reduces every lane. Returns (u_key,
    u_bin, active, u_accs), all ``[..., L]``: segment s of a row holds its
    representative key and bin, ``active`` says it counted a valid row, and
    past the last segment key and bin hold INT64_MIN / INT32_MIN and each
    lane its identity. A lane of None is a count lane of ones."""
    shape = key.shape
    L = shape[-1]
    key, bins, valid = key.reshape(-1, L), bins.reshape(-1, L), valid.reshape(-1, L)
    S = key.shape[0]
    dev = key.device
    skey = torch.where(valid, key, torch.full_like(key, _I64_MAX))
    sbin = torch.where(valid, bins.to(torch.int32), torch.full_like(bins, _I32_MAX, dtype=torch.int32))
    o1 = torch.sort(sbin, dim=1, stable=True)[1]
    o2 = torch.sort(torch.gather(skey, 1, o1), dim=1, stable=True)[1]
    order = torch.gather(o1, 1, o2)
    k_s = torch.gather(skey, 1, order)
    b_s = torch.gather(sbin, 1, order)
    valid_s = torch.gather(valid, 1, order)
    newseg = torch.ones_like(valid_s)
    newseg[:, 1:] = (k_s[:, 1:] != k_s[:, :-1]) | (b_s[:, 1:] != b_s[:, :-1])
    seg = torch.cumsum(newseg, dim=1) - 1
    flat = (seg + torch.arange(S, device=dev)[:, None] * L).reshape(-1)
    vs = valid_s.reshape(-1)
    # the lanes reduce over the valid rows alone: an invalid row adds its
    # lane's identity (0, or the min/max identity), which changes no
    # accumulator (a float sum that starts at +0.0 is never -0.0), and
    # only the padding run mixes them in. Valid rows keep their sorted
    # order, which is the order of float adds.
    sel = torch.nonzero(vs).squeeze(1)
    seg_v = flat[sel]
    u_accs = []
    for kind, v in zip(acc_kinds, vals):
        if v is None:
            v = torch.ones_like(key)
        unsigned = v.dtype == torch.uint64
        if unsigned:
            v = _to_signed(kind, v)
        v = torch.gather(v.reshape(-1, L), 1, order).reshape(-1)[sel]
        r = _seg_reduce(kind, v, seg_v, S * L).reshape(shape)
        u_accs.append(_from_signed(kind, r) if unsigned else r)
    rows = torch.zeros(S * L, dtype=torch.int32, device=dev).index_add_(0, flat, vs.to(torch.int32))
    u_key = torch.full((S * L,), _I64_MIN, dtype=torch.int64, device=dev)
    u_key.scatter_reduce_(0, flat, k_s.reshape(-1), "amax")
    u_bin = torch.full((S * L,), _I32_MIN, dtype=torch.int32, device=dev)
    u_bin.scatter_reduce_(0, flat, b_s.reshape(-1), "amax")
    return u_key.reshape(shape), u_bin.reshape(shape), (rows > 0).reshape(shape), u_accs


_MIX_BIN = -((1 << 64) - 0xFF51AFD7ED558CCD)  # 0xFF51AFD7ED558CCD as int64
_MIX_MUL = -((1 << 64) - 0xC4CEB9FE1A85EC53)  # 0xC4CEB9FE1A85EC53 as int64


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def probe_hash(u_key: torch.Tensor, u_bin: torch.Tensor) -> torch.Tensor:
    """B8's slot hash before masking: mix(key ^ bin * 0xFF51AFD7ED558CCD)
    in uint64 arithmetic (int64 bits wrap the same way)."""
    z = u_key ^ (u_bin.to(torch.int64) * _MIX_BIN)
    z = (z ^ _shr(z, 33)) * _MIX_MUL
    return z ^ _shr(z, 33)


def probe_merge(acc_kinds: Sequence[str], table, u_key: torch.Tensor, u_bin: torch.Tensor,
                active0: torch.Tensor, u_accs: Sequence[torch.Tensor], max_probes: int):
    """Plain PyTorch version of B8 (arroyo_tpu/ops/aggregate.py probe_merge)
    over ``[..., cap]`` tables and ``[..., B]`` partials, each leading index
    (a shard) on its own: merge unique partials into the open-addressing
    (keys, bins, occ, accs) table in place, by ``max_probes`` synchronous
    rounds of linear probing from ``mix(key ^ bin * C) & (cap - 1)``. Each
    round reads the table as it was at the round's start: a partial matches
    an occupied slot of equal key and bin, or contends for an empty one,
    which the highest contending index wins; matches and winners write,
    losers go on at the next slot. Returns the still-active mask. Rounds
    after the one that leaves no partial active are skipped: they write
    nothing."""
    keys_t, bins_t, occ_t, accs_t = table
    cap = keys_t.shape[-1]
    mask_cap = cap - 1
    B = u_key.shape[-1]
    S = u_key.reshape(-1, B).shape[0]
    dev = u_key.device
    k2, b2, o2 = keys_t.view(S, cap), bins_t.view(S, cap), occ_t.view(S, cap)
    a2 = [a.view(S, cap) for a in accs_t]
    uk, ub = u_key.reshape(S, B), u_bin.reshape(S, B)
    # uint64 lanes work on int64 views (the table's views write through)
    unsigned = [a.dtype == torch.uint64 for a in a2]
    a2 = [a.view(torch.int64) if u else a for a, u in zip(a2, unsigned)]
    ua = [_to_signed(k, a.reshape(S, B)) if u else a.reshape(S, B)
          for k, a, u in zip(acc_kinds, u_accs, unsigned)]
    h0 = probe_hash(uk, ub) & mask_cap
    seg_pos = torch.arange(B, dtype=torch.int32, device=dev).expand(S, B)
    active = active0.reshape(S, B).clone()
    for i in range(max_probes):
        if not bool(active.any()):
            break
        cand = (h0 + i) & mask_cap
        cur_key = torch.gather(k2, 1, cand)
        cur_bin = torch.gather(b2, 1, cand)
        cur_occ = torch.gather(o2, 1, cand)
        match = active & cur_occ & (cur_key == uk) & (cur_bin == ub)
        empty_here = active & ~cur_occ
        claim_idx = torch.where(empty_here, cand, torch.full_like(cand, cap))
        claims = torch.full((S, cap + 1), -1, dtype=torch.int32, device=dev)
        claims.scatter_reduce_(1, claim_idx, seg_pos, "amax")
        won = empty_here & (torch.gather(claims, 1, cand) == seg_pos)
        write = match | won
        rows, cols = torch.nonzero(write, as_tuple=True)
        slots = cand[rows, cols]
        for j, kind in enumerate(acc_kinds):
            cur = a2[j][rows, slots]
            new = ua[j][rows, cols]
            if unsigned[j] and kind not in ("sum", "count"):
                cur = cur ^ _I64_MIN  # ua's lane is flipped already
                merged = _combine(kind, cur, new) ^ _I64_MIN
                new = new ^ _I64_MIN
            else:
                merged = _combine(kind, cur, new)
            a2[j][rows, slots] = torch.where(match[rows, cols], merged, new)
        k2[rows, slots] = uk[rows, cols]
        b2[rows, slots] = ub[rows, cols]
        o2[rows, slots] = True
        active &= ~write
    return active.reshape(u_key.shape)


# =========================================================================
# the single-device (bin, key) -> accumulators store (B9 and its host
# mirror): arroyo_tpu/ops/aggregate.py DeviceHashAggregator
# =========================================================================


def _overflow_error(overflow: int, max_probes: int, cap: int) -> RuntimeError:
    return RuntimeError(
        f"device aggregate table overflow ({overflow} entries dropped after "
        f"{max_probes} probes; cap={cap}) — raise device.table-capacity")


class ExtractHandle:
    """A window close in flight: the device compaction has been launched
    and its packed buffer is on its way to pinned host memory. ``result()``
    decodes it (and runs the rare follow-up rounds synchronously);
    ``is_ready()`` polls without blocking."""

    def __init__(self, agg: "DeviceHashAggregator", fetch, emit_lo: int, emit_hi: int,
                 free_below: int):
        self._agg = agg
        self._fetch = fetch
        self._emit_lo = emit_lo
        self._emit_hi = emit_hi
        self._free_below = free_below

    def is_ready(self) -> bool:
        return self._fetch.is_ready()

    def result(self) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        agg = self._agg

        def next_round():
            return agg._unpack(agg._fetch_extract(self._emit_lo, self._emit_hi,
                                                  self._free_below).result())

        return _drain_extract_rounds(
            agg.acc_kinds, agg.acc_dtypes, agg.emit_cap, agg._unpack(self._fetch.result()),
            next_round, self._emit_lo, self._free_below)


class ReadyHandle:
    """ExtractHandle's interface over a result already on the host (the
    numpy backend's synchronous close)."""

    def __init__(self, result):
        self._result = result

    def is_ready(self) -> bool:
        return True

    def result(self):
        return self._result


class DeviceHashAggregator:
    """Streaming (bin, key) -> accumulators store.

    backend="jax": the open-addressing table lives on a torch device
    (``device``; None = cuda, which raises without CUDA), updated and read
    by B9's programs (ops/hash_kernels.py: K8 + K9 per batch, K11 per close
    round, K12 and K13). The name is the JAX package's config value.
    backend="numpy": the dict-based host mirror, on no device (the store of
    the windows' host backend, and the differential tests' oracle).
    """

    def __init__(
        self,
        acc_kinds: Sequence[str],
        acc_dtypes: Sequence[np.dtype],
        cap: int = 65536,
        batch_cap: int = 8192,
        max_probes: int = 64,
        emit_cap: int = 8192,
        backend: str = "jax",
        device=None,
    ):
        self.acc_kinds = tuple(acc_kinds)
        self.acc_dtypes = tuple(np.dtype(d) for d in acc_dtypes)
        self.cap = cap
        self.batch_cap = batch_cap
        self.max_probes = max_probes
        self.emit_cap = emit_cap
        self.backend = backend
        if backend == "jax":
            from ..device import resolve_device
            from . import hash_kernels

            if cap < 1 or cap & (cap - 1):
                raise ValueError("table capacity must be a power of two")
            self.device = resolve_device(device)
            self._ops = hash_kernels.KERNELS  # a seam: chip_smoke.py substitutes checked kernels
            self.state = self._init_jax_state()
        else:
            self.store: dict[tuple[int, int], list] = {}

    def _init_jax_state(self):
        dev = self.device
        accs = [torch.from_numpy(np.full(self.cap, _identity(k, d), dtype=d)).to(dev)
                for k, d in zip(self.acc_kinds, self.acc_dtypes)]
        return (torch.zeros(self.cap, dtype=torch.int64, device=dev),
                torch.zeros(self.cap, dtype=torch.int32, device=dev),
                torch.zeros(self.cap, dtype=torch.bool, device=dev),
                accs,
                torch.zeros(1, dtype=torch.int32, device=dev))

    def _unpack(self, host: np.ndarray) -> tuple[np.ndarray, np.ndarray, list[np.ndarray], int]:
        """Decode one packed extract / scan buffer -> (keys_u64, bins, accs,
        total); raises if the table has overflowed."""
        from .sharded_kernels import unpack_extracted

        k, b, _v, accs, total, oflow = unpack_extracted(host, 1, self.emit_cap, self.acc_dtypes,
                                                        oflow=True)
        if int(oflow[0]) > 0:
            raise _overflow_error(int(oflow[0]), self.max_probes, self.cap)
        total = int(total[0])
        cnt = min(total, self.emit_cap)
        return (k[0, :cnt].copy().view(np.uint64), b[0, :cnt].copy(),
                [a[0, :cnt].copy() for a in accs], total)

    def _fetch_extract(self, emit_lo: int, emit_hi: int, free_below: int):
        from . import hash_kernels
        from .prefetch import HostFetch

        out = hash_kernels.extract(self._ops, self.state, emit_lo, emit_hi, free_below,
                                   self.emit_cap)
        return HostFetch(out.packed)

    # ------------------------------------------------------------- update

    def update(self, key_u64: np.ndarray, bins: np.ndarray, vals: Sequence[np.ndarray]) -> None:
        n = len(key_u64)
        if n == 0:
            return
        if self.backend == "numpy":
            self._update_numpy(key_u64, bins, vals)
            return
        for lo in range(0, n, self.batch_cap):
            hi = min(lo + self.batch_cap, n)
            self._update_chunk(key_u64[lo:hi], bins[lo:hi], [v[lo:hi] for v in vals])

    def _update_chunk(self, key_u64, bins, vals) -> None:
        from . import hash_kernels

        m = len(key_u64)
        B = self.batch_cap
        key = np.zeros(B, dtype=np.int64)
        key[:m] = np.asarray(key_u64).astype(np.uint64).view(np.int64)
        b = np.zeros(B, dtype=np.int32)
        b[:m] = bins
        vs = []
        for v, dt in zip(vals, self.acc_dtypes):
            arr = np.zeros(B, dtype=dt)
            arr[:m] = v
            vs.append(torch.from_numpy(arr).to(self.device))
        dev = self.device
        hash_kernels.step(self._ops, self.acc_kinds, self.state, torch.from_numpy(key).to(dev),
                          torch.from_numpy(b).to(dev), m, vs, self.max_probes)

    def _check_overflow(self) -> None:
        overflow = int(self.state[4][0])
        if overflow > 0:
            raise _overflow_error(overflow, self.max_probes, self.cap)

    def _update_numpy(self, key_u64, bins, vals) -> None:
        signed = key_u64.astype(np.uint64).view(np.int64)
        order = np.lexsort((signed, bins))
        k_s, b_s = signed[order], np.asarray(bins)[order]
        vs = [np.asarray(v)[order] for v in vals]
        newseg = np.ones(len(k_s), dtype=bool)
        newseg[1:] = (k_s[1:] != k_s[:-1]) | (b_s[1:] != b_s[:-1])
        starts = np.flatnonzero(newseg)
        ends = np.append(starts[1:], len(k_s))
        for s, e in zip(starts, ends):
            kk = (int(b_s[s]), int(k_s[s]))
            cur = self.store.get(kk)
            parts = []
            for i, kind in enumerate(self.acc_kinds):
                seg = vs[i][s:e]
                red = seg.sum() if kind in ("sum", "count") else (seg.min() if kind == "min" else seg.max())
                if cur is not None:
                    red = (
                        cur[i] + red
                        if kind in ("sum", "count")
                        else (min(cur[i], red) if kind == "min" else max(cur[i], red))
                    )
                parts.append(self.acc_dtypes[i].type(red))
            self.store[kk] = parts

    # ------------------------------------------------------------- extract

    def extract(
        self, emit_lo: int, emit_hi: int, free_below: int
    ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        """Returns (key_u64, bin, acc_arrays) for bins in [emit_lo, emit_hi);
        frees all entries with bin < free_below. Host loops until drained."""
        if self.backend == "numpy":
            return self._extract_numpy(emit_lo, emit_hi, free_below)
        return self.extract_start(emit_lo, emit_hi, free_below).result()

    def extract_start(self, emit_lo: int, emit_hi: int, free_below: int) -> ExtractHandle:
        """Launch a window close without blocking: the device compacts and
        frees at once, the packed result copies to the host behind an
        event; the caller emits later through handle.result()."""
        return ExtractHandle(self, self._fetch_extract(emit_lo, emit_hi, free_below),
                             emit_lo, emit_hi, free_below)

    def scan_range(self, emit_lo: int, emit_hi: int) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        """Non-destructive read of every entry with bin in [emit_lo, emit_hi)
        (the sliding window's combine: a bin serves width / slide windows,
        so reads must not free)."""
        if self.backend == "numpy":
            ks, bs, accs = [], [], [[] for _ in self.acc_kinds]
            for (b, k), parts in self.store.items():
                if emit_lo <= b < emit_hi:
                    ks.append(k)
                    bs.append(b)
                    for i, p in enumerate(parts):
                        accs[i].append(p)
            return (
                np.array(ks, dtype=np.int64).view(np.uint64) if ks else np.empty(0, dtype=np.uint64),
                np.array(bs, dtype=np.int32),
                [np.array(a, dtype=d) for a, d in zip(accs, self.acc_dtypes)],
            )
        from . import hash_kernels
        from .prefetch import HostFetch

        # one packed transfer covers the range when it fits in emit_cap rows
        packed = hash_kernels.scan_packed(self._ops, self.state, emit_lo, emit_hi, self.emit_cap)
        k, b, accs, total = self._unpack(HostFetch(packed.packed).result())
        if total > self.emit_cap:
            # else K12 walks the whole table once, sized by the scan's total
            out = self._ops.scan_walk(self.state[:4], emit_lo, emit_hi, total)
            k, b, accs = hash_kernels.unpack_walk(HostFetch(out.packed).result(), total,
                                                  self.acc_dtypes)
            k = k.view(np.uint64)
        return combine_by_key_bin(self.acc_kinds, k, b, accs)

    def free_bins_below(self, below: int) -> None:
        """Drop all entries with bin < below."""
        if self.backend == "numpy":
            for kk in [kk for kk in self.store if kk[0] < below]:
                del self.store[kk]
            return
        self._ops.free(self.state[:4], below)

    def _extract_numpy(self, emit_lo, emit_hi, free_below):
        ks, bs, accs = [], [], [[] for _ in self.acc_kinds]
        for (b, k), parts in self.store.items():
            if emit_lo <= b < emit_hi:
                ks.append(k)
                bs.append(b)
                for i, p in enumerate(parts):
                    accs[i].append(p)
        for kk in [kk for kk in self.store if kk[0] < free_below]:
            del self.store[kk]
        return (
            np.array(ks, dtype=np.int64).view(np.uint64) if ks else np.empty(0, dtype=np.uint64),
            np.array(bs, dtype=np.int32),
            [np.array(a, dtype=d) for a, d in zip(accs, self.acc_dtypes)],
        )

    # ------------------------------------------------------------- state sync

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
        """Full host copy of the live entries (the checkpoint's view)."""
        if self.backend == "numpy":
            if not self.store:
                return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32),
                        [np.empty(0, dtype=d) for d in self.acc_dtypes])
            items = list(self.store.items())
            ks = np.array([k for (_, k), _ in items], dtype=np.int64).view(np.uint64)
            bs = np.array([b for (b, _), _ in items], dtype=np.int32)
            accs = [np.array([p[i] for _, p in items], dtype=d)
                    for i, d in enumerate(self.acc_dtypes)]
            return ks, bs, accs
        keys_t, bins_t, occ_t, accs_t, _oflow = self.state
        self._check_overflow()
        occ = occ_t.cpu().numpy()
        return combine_by_key_bin(
            self.acc_kinds,
            keys_t.cpu().numpy()[occ].view(np.uint64),
            bins_t.cpu().numpy()[occ],
            [a.cpu().numpy()[occ] for a in accs_t],
        )

    def restore(self, key_u64: np.ndarray, bins: np.ndarray, accs: list[np.ndarray]) -> None:
        if self.backend == "numpy":
            signed = key_u64.astype(np.uint64).view(np.int64)
            self.store = {
                (int(bins[j]), int(signed[j])): [
                    self.acc_dtypes[i].type(accs[i][j]) for i in range(len(self.acc_kinds))
                ]
                for j in range(len(signed))
            }
            return
        self.state = self._init_jax_state()
        self.update(key_u64, bins.astype(np.int32), accs)
