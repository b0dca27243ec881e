"""Host helpers of the keyed window aggregate and the plain PyTorch versions
of its hash-table steps (the port's copy of arroyo_tpu/ops/aggregate.py:
the numpy parts, ``sort_reduce`` (B7) and ``probe_merge`` (B8))."""

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


def drain_extract(extract_once, emit_cap: int, acc_kinds: Sequence[str],
                  acc_dtypes: Sequence[np.dtype], emit_lo: int, free_below: int):
    """Host-side drain loop of the sharded aggregator's close.
    ``extract_once()`` performs one device extraction and returns (key_i64,
    bin, valid, accs, max_total) as numpy arrays and an int.

    Entries in the emit range are freed only when below ``free_below``, so a
    destructive close shrinks each round; a pure range scan (free_below <=
    emit_lo) stops after one round, or it would re-emit the same entries
    forever. The result is merged with combine_by_key_bin: freed slots punch
    holes in probe chains, so the table may hold duplicate (key, bin)
    entries whose accumulators each carry part of the total."""
    keys_out, bins_out = [], []
    accs_out: list[list[np.ndarray]] = [[] for _ in acc_dtypes]
    while True:
        k, b, valid, accs, max_total = extract_once()
        cnt = int(valid.sum())
        if cnt:
            keys_out.append(k[valid])
            bins_out.append(b[valid])
            for i, a in enumerate(accs):
                accs_out[i].append(a[valid])
        if max_total <= emit_cap or cnt == 0 or free_below <= emit_lo:
            break
    if not keys_out:
        return (
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=np.int32),
            [np.empty(0, dtype=d) for d in acc_dtypes],
        )
    return combine_by_key_bin(
        acc_kinds,
        np.concatenate(keys_out).view(np.uint64),
        np.concatenate(bins_out),
        [np.concatenate(a) for a in accs_out],
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


def _seg_reduce(kind: str, v: torch.Tensor, seg: torch.Tensor, rank: torch.Tensor,
                num: int) -> torch.Tensor:
    """Reduce ``v`` (rows in sorted order, ``seg`` their flat segment id,
    ``rank`` their position inside it) into ``num`` segments, empty ones
    holding the kind's identity (``_seg_reduce_jnp``). Float sums add each
    segment's rows one after another in sorted order from +0.0, as XLA's
    segment_sum does; every other reduction is independent of order."""
    ident = _identity(kind, np.dtype(str(v.dtype).replace("torch.", ""))).item()
    out = torch.full((num,), ident, dtype=v.dtype, device=v.device)
    if kind in ("sum", "count"):
        if not v.dtype.is_floating_point:
            return out.index_add_(0, seg, v)
        # one row per segment per round: each round's index_add_ touches
        # distinct segments, so the rounds fix the order of the adds
        by_rank, idx = torch.sort(rank, stable=True)
        counts = torch.bincount(by_rank).tolist() if len(by_rank) else []
        lo = 0
        for c in counts:
            sel = idx[lo:lo + c]
            out.index_add_(0, seg[sel], v[sel])
            lo += c
        return out
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
    # order, so each run's rank among them fixes the order of float adds.
    sel = torch.nonzero(vs).squeeze(1)
    seg_v = flat[sel]
    pos_v = torch.arange(len(sel), device=dev)
    start_v = torch.zeros(S * L, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg_v, pos_v, "amin", include_self=False)
    rank_v = pos_v - start_v[seg_v]
    u_accs = []
    for kind, v in zip(acc_kinds, vals):
        if v is None:
            v = torch.ones_like(key)
        unsigned = v.dtype == torch.uint64
        if unsigned:
            v = _to_signed(kind, v)
        v = torch.gather(v.reshape(-1, L), 1, order).reshape(-1)[sel]
        r = _seg_reduce(kind, v, seg_v, rank_v, S * L).reshape(shape)
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
