"""Deterministic 64-bit key hashing (the port's copy of
arroyo_tpu/hashing.py).

splitmix64 over uint64 lanes, in the native host library (native/) where
the JAX package uses it, else in numpy: the same bits either way
(tests/test_torch_native.py). Hashes stay on the host because torch's CPU
build has no ``>>`` or ``+`` for ``torch.uint64``. The hash decides shuffle
ownership and window-state identity, so it must equal the JAX package's
bit for bit (tests/test_torch_q7.py holds it to that).
"""

from __future__ import annotations

import hashlib

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)
_NULL_HASH = np.uint64(0x6E756C6C6E756C6C)  # fixed hash for None entries


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays."""
    z = x + _C1
    z = (z ^ (z >> np.uint64(30))) * _C2
    z = (z ^ (z >> np.uint64(27))) * _C3
    return z ^ (z >> np.uint64(31))


def _hash_string_array(col: np.ndarray) -> np.ndarray:
    """blake2b-64 of each distinct string (None -> a fixed hash)."""
    memo: dict = {}
    out = np.empty(len(col), dtype=np.uint64)
    for i, s in enumerate(col):
        h = memo.get(s)
        if h is None:
            if s is None:
                h = _NULL_HASH
            else:
                b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
                h = np.uint64(int.from_bytes(
                    hashlib.blake2b(b, digest_size=8).digest(), "little"))
            memo[s] = h
        out[i] = h
    return out


def hash_column(col: np.ndarray) -> np.ndarray:
    """64-bit hash of one column."""
    from . import native

    if col.dtype == object or col.dtype.kind in "US":
        return splitmix64(_hash_string_array(col))
    if col.dtype.kind == "f":
        out = native.hash_f64(col.astype(np.float64))
        if out is not None:
            return out
        # canonicalize -0.0 and hash the bit pattern
        col = np.where(col == 0.0, 0.0, col)
        return splitmix64(col.astype(np.float64).view(np.uint64))
    if col.dtype == np.bool_:
        col = col.astype(np.uint64)
    else:
        col = col.astype(np.int64).view(np.uint64)
    out = native.hash_u64(col)
    return out if out is not None else splitmix64(col)


def hash_columns(cols: list[np.ndarray]) -> np.ndarray:
    """Combined 64-bit hash of several columns (row-wise)."""
    from . import native

    if not cols:
        raise ValueError("need at least one key column")
    h = hash_column(cols[0])
    for c in cols[1:]:
        h2 = hash_column(c)
        combined = native.hash_combine(h, h2)
        h = combined if combined is not None else splitmix64(h ^ (h2 + _C1))
    return h


def servers_for_hashes(hashes: np.ndarray, n: int) -> np.ndarray:
    """Owning subtask of each hash: contiguous u64 ranges, n of them."""
    if n == 1:
        return np.zeros(len(hashes), dtype=np.int64)
    size = np.uint64(((1 << 64) - 1) // n + 1)
    return np.minimum(hashes // size, np.uint64(n - 1)).astype(np.int64)
