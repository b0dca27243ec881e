"""B7 and B8, the keyed hash table's device steps, through the port's plain
versions (ops/aggregate.py sort_reduce / probe_merge, and the K8/K9
wrappers of ops/sharded_kernels.py on CPU tensors) against the JAX
package's under jax.jit on the CPU: every output byte for byte, the
inactive fillers included. The kernels are held against these plain
versions on the card by chip_smoke.py's sharded phase."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arroyo_tpu.ops.aggregate import probe_merge as jax_probe_merge
from arroyo_tpu.ops.aggregate import sort_reduce as jax_sort_reduce
from arroyo_tpu_torch.ops import sharded_kernels as sk
from arroyo_tpu_torch.ops.aggregate import probe_merge, sort_reduce

I64_MAX = np.iinfo(np.int64).max
I32_MAX = np.iinfo(np.int32).max
KINDS = ("sum", "sum", "sum", "sum", "min", "max", "min", "max", "count", "max", "min")
DTYPES = (np.float64, np.float32, np.int64, np.int32, np.float64, np.float32, np.int64,
          np.int32, np.int64, np.uint64, np.uint64)


def _vals(rng, n, dtypes=DTYPES):
    out = []
    for d in dtypes:
        if np.issubdtype(d, np.floating):
            v = (rng.standard_normal(n) * 1e3).astype(d)
            pick = rng.random(n)
            v[pick < 0.05] = -0.0
            v[(pick >= 0.05) & (pick < 0.08)] = 0.0
            v[(pick >= 0.08) & (pick < 0.1)] = np.inf
            v[(pick >= 0.1) & (pick < 0.12)] = -np.inf
        elif d == np.uint64:
            v = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
        else:
            info = np.iinfo(d)
            v = rng.integers(info.min // 4, info.max // 4, n).astype(d)
        out.append(v)
    return out


def _batch(rng, n, n_keys=20, max_key_rows=0, valid_frac=0.8):
    key = (rng.integers(0, n_keys, n).astype(np.int64) * 0x1E3779B97F4A7C15) ^ (1 << 62)
    bins = rng.integers(-3, 3, n).astype(np.int32)
    if max_key_rows:
        key[:max_key_rows] = I64_MAX
        bins[:max_key_rows] = I32_MAX
    valid = rng.random(n) < valid_frac
    return key, bins, valid


def _jax_sort_reduce(kinds, key, bins, valid, vals):
    f = jax.jit(lambda k, b, v, vs: jax_sort_reduce(kinds, k, b, v, vs, len(k)))
    u_key, u_bin, active, u_accs = f(key, bins, valid, tuple(vals))
    return [np.asarray(u_key), np.asarray(u_bin), np.asarray(active)] + [
        np.asarray(a) for a in u_accs]


def _assert_bytes(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), f"output {i} differs"


@pytest.mark.parametrize("n,max_key_rows,valid_frac", [
    (512, 0, 0.8), (512, 5, 0.8), (64, 3, 1.0), (300, 0, 0.0), (1000, 0, 0.3)])
def test_sort_reduce_bytes_equal_jax(n, max_key_rows, valid_frac):
    rng = np.random.default_rng(n + max_key_rows)
    key, bins, valid = _batch(rng, n, max_key_rows=max_key_rows, valid_frac=valid_frac)
    vals = _vals(rng, n)
    want = _jax_sort_reduce(KINDS, key, bins, valid, vals)
    u_key, u_bin, active, u_accs = sort_reduce(
        KINDS, torch.from_numpy(key), torch.from_numpy(bins), torch.from_numpy(valid),
        [torch.from_numpy(v) for v in vals])
    _assert_bytes([u_key, u_bin, active] + list(u_accs), want)


def test_sort_reduce_one_hot_key_float_sums_in_order():
    """A run of 2000 rows of one key: the float sums add in sorted order,
    bit for bit as XLA's CPU segment_sum."""
    rng = np.random.default_rng(1)
    n = 2000
    key = np.where(rng.random(n) < 0.9, 17, rng.integers(0, 5, n)).astype(np.int64)
    bins = np.zeros(n, dtype=np.int32)
    valid = np.ones(n, dtype=bool)
    vals = [rng.standard_normal(n) * 1e6, (rng.standard_normal(n) * 1e3).astype(np.float32)]
    kinds = ("sum", "sum")
    want = _jax_sort_reduce(kinds, key, bins, valid, vals)
    got = sort_reduce(kinds, torch.from_numpy(key), torch.from_numpy(bins),
                      torch.from_numpy(valid), [torch.from_numpy(v) for v in vals])
    _assert_bytes([got[0], got[1], got[2]] + list(got[3]), want)


def test_sort_reduce_nan_propagates():
    """NaN in a min/max or sum lane propagates to its run (NaN payload bytes
    aside: the plain version writes the default NaN)."""
    key = np.array([1, 1, 2, 2, 3], dtype=np.int64)
    bins = np.zeros(5, dtype=np.int32)
    valid = np.ones(5, dtype=bool)
    v = np.array([1.0, np.nan, 2.0, 3.0, np.nan])
    kinds = ("min", "max", "sum")
    want = _jax_sort_reduce(kinds, key, bins, valid, [v, v, v])
    got = sort_reduce(kinds, torch.from_numpy(key), torch.from_numpy(bins),
                      torch.from_numpy(valid), [torch.from_numpy(v)] * 3)
    for g, w in zip(got[3], want[3:]):
        np.testing.assert_array_equal(g.numpy(), w)  # NaN == NaN here


@pytest.mark.parametrize("S", [1, 4, 8])
def test_k8_wrapper_shards_offset_and_ontime(S):
    """The K8 wrapper on CPU tensors: [S, L] shards, each its own
    sort_reduce; int64 bins with the fused step's base-bin offset, an
    on-time mask and a global valid-row count, count lanes of ones."""
    rng = np.random.default_rng(S)
    L = 256
    kinds = ("max", "count", "sum")
    dts = (np.int64, np.int64, np.float64)
    key = rng.integers(0, 40, (S, L)).astype(np.int64) * 1_000_003
    bins_abs = rng.integers(1000, 1004, (S, L)).astype(np.int64)
    ontime = rng.random((S, L)) < 0.9
    n = S * L - 37
    vals = _vals(rng, S * L, dts)
    got = sk.agg_sort_reduce(kinds, torch.from_numpy(key), torch.from_numpy(bins_abs),
                             torch.from_numpy(ontime),
                             [torch.from_numpy(vals[0].reshape(S, L)), None,
                              torch.from_numpy(vals[2].reshape(S, L))],
                             bin_offset=1000, n_valid=n)
    rows = np.arange(S * L).reshape(S, L)
    for d in range(S):
        valid = ontime[d] & (rows[d] < n)
        ones = np.ones(L, dtype=np.int64)
        want = _jax_sort_reduce(kinds, key[d], (bins_abs[d] - 1000).astype(np.int32), valid,
                                [vals[0].reshape(S, L)[d], ones, vals[2].reshape(S, L)[d]])
        _assert_bytes([got[0][d], got[1][d], got[2][d]] + [a[d] for a in got[3]], want)


def _tables(cap, kinds, dtypes):
    from arroyo_tpu_torch.ops.aggregate import _identity

    keys = np.zeros(cap, np.int64)
    bins = np.zeros(cap, np.int32)
    occ = np.zeros(cap, bool)
    accs = [np.full(cap, _identity(k, d), dtype=d) for k, d in zip(kinds, dtypes)]
    jt = (jnp.asarray(keys), jnp.asarray(bins), jnp.asarray(occ),
          tuple(jnp.asarray(a) for a in accs))
    tt = (torch.from_numpy(keys.copy()), torch.from_numpy(bins.copy()),
          torch.from_numpy(occ.copy()), [torch.from_numpy(a.copy()) for a in accs])
    return jt, tt


def _assert_table(jt, tt, still_j=None, still_t=None):
    flat_j = list(jt[:3]) + list(jt[3])
    flat_t = list(tt[:3]) + list(tt[3])
    if still_j is not None:
        flat_j.append(still_j)
        flat_t.append(still_t)
    _assert_bytes(flat_t, [np.asarray(x) for x in flat_j])


@pytest.mark.parametrize("cap,max_probes,n_keys", [
    (64, 4, 30),    # races for empty slots, probe exhaustion
    (256, 32, 60),  # every partial placed
    (16, 2, 40),    # a full table: most partials come back still active
])
def test_probe_merge_state_bytes_equal_jax(cap, max_probes, n_keys):
    rng = np.random.default_rng(cap + max_probes)
    kinds = ("sum", "max", "count", "min", "sum", "max")
    dtypes = (np.float64, np.int64, np.int64, np.float32, np.int32, np.uint64)
    jt, tt = _tables(cap, kinds, dtypes)
    f = jax.jit(lambda t, k, b, a, u: jax_probe_merge(kinds, t, k, b, a, u, cap, max_probes))
    for step in range(6):
        n = 48
        key = rng.integers(0, n_keys, n).astype(np.int64) * 12345
        bins = rng.integers(0, 3, n).astype(np.int32)
        active = rng.random(n) < 0.9
        _, first = np.unique(np.stack([key, bins]), axis=1, return_index=True)
        uniq = np.zeros(n, bool)
        uniq[first] = True
        active &= uniq  # B8 takes unique partials (B7's output)
        ua = _vals(rng, n, dtypes)
        jt, still_j = f(jt, key, bins, active, tuple(ua))
        still_t = probe_merge(kinds, tt, torch.from_numpy(key), torch.from_numpy(bins),
                              torch.from_numpy(active), [torch.from_numpy(a) for a in ua],
                              max_probes)
        _assert_table(jt, tt, np.asarray(still_j), still_t)
        # free a few slots: holes in the probe chains, so later merges of
        # live (key, bin) groups can claim a hole before their entry
        fr = rng.random(cap) < 0.25
        jt = (jt[0], jt[1], jnp.asarray(np.asarray(jt[2]) & ~fr), jt[3])
        tt[2][torch.from_numpy(fr)] = False
        _assert_table(jt, tt)


def test_k9_wrapper_shards_equal_jax():
    """The K9 wrapper on CPU tensors: [S, cap] tables and [S, B] partials,
    each shard merged on its own."""
    rng = np.random.default_rng(3)
    S, cap, B = 4, 64, 40
    kinds = ("sum", "count")
    dtypes = (np.int64, np.int64)
    tabs = [_tables(cap, kinds, dtypes) for _ in range(S)]
    f = jax.jit(lambda t, k, b, a, u: jax_probe_merge(kinds, t, k, b, a, u, cap, 8))
    table = tuple(torch.stack([t[1][i] for t in tabs]) for i in range(3)) + (
        [torch.stack([t[1][3][j] for t in tabs]) for j in range(2)],)
    key = rng.integers(0, 50, (S, B)).astype(np.int64) * 7919
    bins = np.zeros((S, B), np.int32)
    active = np.zeros((S, B), bool)
    for d in range(S):
        _, first = np.unique(key[d], return_index=True)
        active[d, first] = True
    ua = [rng.integers(0, 100, (S, B)).astype(np.int64), np.ones((S, B), np.int64)]
    still = sk.agg_probe_merge(kinds, table, torch.from_numpy(key), torch.from_numpy(bins),
                               torch.from_numpy(active), [torch.from_numpy(a) for a in ua], 8)
    for d in range(S):
        jt, still_j = f(tabs[d][0], key[d], bins[d], active[d], tuple(a[d] for a in ua))
        td = (table[0][d], table[1][d], table[2][d], [a[d] for a in table[3]])
        _assert_table(jt, td, np.asarray(still_j), still[d])
