"""Host helpers of the keyed window aggregate (the port's copy of the numpy
parts of arroyo_tpu/ops/aggregate.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
