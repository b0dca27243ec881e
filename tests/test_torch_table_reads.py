"""The table reads on the CPU: the plain versions of K12's walk
(``hash_scan_walk``) and of K11 (``shard_extract``) in each of its modes,
against the JAX package's programs on the same tables, made from a seed
with numpy (chip_smoke.py's ``walk_cases`` and ``table_read_cases``, whose
tables the card's kernels are held to as well). Exact throughout: every
output array byte for byte, float lanes as bits (NaN payloads, -0.0), and
the occupancy after the frees.

- the walk against the reference's loop over ``scan`` (``_build_jax``),
  one chunk of emit_cap slots at a time, its valid rows concatenated;
- ``DeviceHashAggregator.scan_range`` (whose fallback is now the walk)
  against the JAX aggregator, with emit_cap small enough to fall back;
- K11's default mode against ``ShardedAggregator``'s ``local_extract`` at
  1, 4 and 8 shards; with ``zero_tail`` against ``extract``,
  ``extract_packed`` and ``scan_packed`` of the single-device table.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from arroyo_tpu.ops.aggregate import DeviceHashAggregator as JaxAgg
from arroyo_tpu.ops.aggregate import _build_jax
from arroyo_tpu_torch.ops import hash_kernels as hk
from arroyo_tpu_torch.ops import sharded_kernels as sk
from arroyo_tpu_torch.ops.aggregate import DeviceHashAggregator

KINDS = tuple(k for k, _ in cs.TABLE_READ_LANES)
DTYPES = tuple(np.dtype(d) for _, d in cs.TABLE_READ_LANES)
WALKS = cs.walk_cases(np.random.default_rng(20261017))
N_READS = len(cs.table_read_cases(np.random.default_rng(0), 1))


def _jax_state(arrays, shard=0):
    """The reference's state from copies: its programs donate the state,
    and a buffer JAX made without copying would be the numpy array's."""
    import jax.numpy as jnp

    keys, bins, occ, lanes = arrays
    c = lambda a: jnp.array(np.array(a[shard]))  # noqa: E731
    return (c(keys), c(bins), c(occ), tuple(c(a) for a in lanes), jnp.asarray(np.int32(3)))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("case", range(len(WALKS)), ids=[c["label"] for c in WALKS])
def test_walk_matches_reference_chunk_loop(case):
    """K12's walk: the valid rows of every chunk the reference's loop reads
    (``scan`` at 0, emit_cap, ... < cap; positions past cap clamp and are
    never valid), concatenated, and their count."""
    c = WALKS[case]
    cap, E, lo, hi = c["table"][0].shape[1], c["emit_cap"], c["lo"], c["hi"]
    scan = _build_jax(KINDS, DTYPES, cap, 128, 64, E)[2]
    js = _jax_state(c["table"])
    parts = []
    for chunk in range(0, cap, E):
        k, b, v, accs = scan(js, np.int32(lo), np.int32(hi), np.int32(chunk))
        v = np.asarray(v)
        parts.append([np.asarray(k)[v], np.asarray(b)[v]] + [np.asarray(a)[v] for a in accs])
    want = [np.concatenate(p) for p in zip(*parts)]
    n = len(want[0])
    assert (n == 0) == (lo == hi)
    out = hk.hash_scan_walk(cs.torch_table(c["table"], "cpu", one_shard=True), lo, hi, n)
    assert int(out.count[0]) == n
    for got, w in zip([out.key, out.bin] + out.accs, want):
        _same(got, w)
    k, b, accs = hk.unpack_walk(out.packed.numpy(), n, list(DTYPES))
    assert k.tobytes() == want[0].tobytes() and b.tobytes() == want[1].tobytes()
    assert all(a.tobytes() == w.tobytes() for a, w in zip(accs, want[2:]))


@pytest.mark.parametrize("lanes", ["int", "float"])
def test_scan_range_walks_as_the_reference_loops(lanes):
    """scan_range with emit_cap 16: ranges over 16 entries go through one
    packed scan and one walk (the reference: its chunk loop), exactly the
    JAX aggregator's rows; smaller ranges stay on the packed scan."""
    kinds, dts = (("sum", "count", "max"), (np.int64, np.int64, np.uint64)) if lanes == "int" \
        else (("sum", "min", "max"), (np.float64, np.float32, np.float64))
    sizes = dict(cap=1024, batch_cap=256, max_probes=64, emit_cap=16)
    j = JaxAgg(kinds, dts, backend="jax", **sizes)
    t = DeviceHashAggregator(kinds, dts, backend="jax", device="cpu", **sizes)
    walked = []

    def walk(*a):
        walked.append(a[1:])
        return hk.hash_scan_walk(*a)

    t._ops = t._ops._replace(scan_walk=walk)
    rng = np.random.default_rng(4)
    for step in range(3):
        n = 200
        keys = (rng.integers(0, 150, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        bins = rng.integers(step, step + 4, n).astype(np.int32)
        # no NaN here: which NaN payload a min or sum keeps is the update's
        # business (K8, K9), not the read's; the walk cases carry payloads
        vals = [np.where(rng.random(n) < 0.1, -0.0, np.round(rng.normal(0, 50, n), 2)).astype(d)
                if lanes == "float" else rng.integers(-1000, 1000, n).astype(d) for d in dts]
        for agg in (j, t):
            agg.update(keys, bins, vals)
    for lo, hi in [(0, 2), (1, 4), (4, 4), (0, 7), (5, 6), (2, 3)]:
        gk, gb, ga = t.scan_range(lo, hi)
        wk, wb, wa = j.scan_range(lo, hi)
        assert gk.dtype == wk.dtype and gk.tobytes() == wk.tobytes()
        assert gb.tobytes() == np.asarray(wb).tobytes()
        for g, w in zip(ga, wa):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert (0, 7, int(t.state[2].sum())) in walked and (4, 4) not in [w[:2] for w in walked]


def _jax_sharded(S, cap, emit_cap):
    import jax

    from arroyo_tpu.parallel import ShardedAggregator as JAgg
    from arroyo_tpu.parallel import make_mesh as jmesh

    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} virtual devices (conftest sets XLA_FLAGS)")
    return JAgg(jmesh(S), KINDS, DTYPES, cap=cap, batch_cap=64, max_probes=16,
                emit_cap=emit_cap, spill_cap=64)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_extract_matches_reference_local_extract(S):
    """K11's default mode at S shards: the first min(emit_cap, cap) slots of
    the order that puts emitting slots first, their flags, the totals, and
    the occupancy after the frees, as the mesh's local_extract has them."""
    import jax

    aggs = {}
    for c in cs.table_read_cases(np.random.default_rng(100 + S), S):
        keys, bins, occ, lanes = c["table"]
        cap = keys.shape[1]
        lo, hi, below, emit_cap = c["read"]
        if (cap, emit_cap) not in aggs:
            aggs[cap, emit_cap] = _jax_sharded(S, cap, emit_cap)
        jagg = aggs[cap, emit_cap]
        put = lambda a, like: jax.device_put(np.array(a), like.sharding)  # noqa: E731
        st = jagg.state
        state = (put(keys, st[0]), put(bins, st[1]), put(occ, st[2]),
                 tuple(put(a, x) for a, x in zip(lanes, st[3])), *st[4:])
        state, (k, b, v, accs, total) = jagg._extract(state, np.int32(lo), np.int32(hi),
                                                      np.int32(below))
        jagg.state = state  # the call donated the one it was given
        table = cs.torch_table(c["table"], "cpu")
        out = sk.shard_extract(table, lo, hi, below, emit_cap)
        label = c["label"]
        for got, want in [(out.key, k), (out.bin, b), (out.valid, v), (out.total, total)] + \
                list(zip(out.accs, accs)):
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), label
        assert table[2].numpy().tobytes() == np.asarray(state[2]).tobytes(), label


def _as_ref_buffer(out):
    """The port's packed buffer as the reference's one int64 buffer [total,
    overflow, keys, bins, lanes...]: int lanes widened, float lanes as the
    bits of their float64 value."""
    lanes = [a[0].numpy().astype(np.float64).view(np.int64) if a.dtype.is_floating_point
             else a[0].numpy().astype(np.int64) for a in out.accs]
    return np.concatenate([[int(out.total[0]), int(out.oflow[0])], out.key[0].numpy(),
                           out.bin[0].numpy().astype(np.int64), *lanes])


@pytest.mark.parametrize("case", range(N_READS))
def test_zero_tail_matches_reference_extract_and_packed(case):
    """K11 with zero_tail at one shard (the single-device table): extract's
    arrays (zeros past the emitted rows, emit_cap above cap allowed) and
    occupancy, and the one buffer of extract_packed and scan_packed (which
    frees nothing)."""
    c = cs.table_read_cases(np.random.default_rng(7 + case), 1)[case]
    keys, bins, occ, lanes = c["table"]
    cap = keys.shape[1]
    lo, hi, below, emit_cap = c["read"]
    progs = _build_jax(KINDS, DTYPES, cap, 128, 64, emit_cap)

    def port_state():
        t = cs.torch_table(c["table"], "cpu", one_shard=True)
        return (*t, torch.tensor([3], dtype=torch.int32))

    js, (k, b, v, accs, total) = progs[1](_jax_state(c["table"]), np.int32(lo), np.int32(hi),
                                          np.int32(below))
    ts = port_state()
    out = hk.extract(hk.KERNELS, ts, lo, hi, below, emit_cap)
    for got, want in [(out.key, k), (out.bin, b), (out.valid, v)] + list(zip(out.accs, accs)):
        assert got[0].numpy().tobytes() == np.asarray(want).tobytes()
    assert int(out.total[0]) == int(total) and int(out.oflow[0]) == 3
    assert ts[2].numpy().tobytes() == np.asarray(js[2]).tobytes()

    js, packed = progs[4](_jax_state(c["table"]), np.int32(lo), np.int32(hi), np.int32(below))
    ts = port_state()
    assert np.array_equal(_as_ref_buffer(hk.extract(hk.KERNELS, ts, lo, hi, below, emit_cap)),
                          np.asarray(packed))
    assert ts[2].numpy().tobytes() == np.asarray(js[2]).tobytes()
    packed = progs[5](_jax_state(c["table"]), np.int32(lo), np.int32(hi))
    ts = port_state()
    assert np.array_equal(_as_ref_buffer(hk.scan_packed(hk.KERNELS, ts, lo, hi, emit_cap)),
                          np.asarray(packed))
    assert ts[2].numpy().tobytes() == occ[0].tobytes()


def test_walk_wrapper_contract():
    """The walk refuses a negative total, tables that are not contiguous or
    whose capacity is not a power of two; its count tells a stale total
    apart; the launch counters exist and stay 0 on the CPU."""
    cap = 16
    table = (torch.zeros(cap, dtype=torch.int64), torch.arange(cap, dtype=torch.int32),
             torch.ones(cap, dtype=torch.bool), [torch.zeros(cap, dtype=torch.float32)])
    with pytest.raises(ValueError, match="total"):
        hk.hash_scan_walk(table, 0, 4, -1)
    strided = (torch.zeros(2 * cap, dtype=torch.int64)[::2], *table[1:])
    with pytest.raises(ValueError, match="contiguous"):
        hk.hash_scan_walk(strided, 0, 4, 4)
    with pytest.raises(ValueError, match="power of two"):
        hk.hash_scan_walk(tuple(t[:12] if i < 3 else [t[0][:12]] for i, t in enumerate(table)),
                          0, 4, 4)
    out = hk.hash_scan_walk(table, 0, 4, 4)
    assert int(out.count[0]) == 4 and out.bin.tolist() == [0, 1, 2, 3]
    assert hk.unpack_walk(out.packed.numpy(), 4, [torch.float32])[1].tolist() == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="found 4 valid slots"):
        hk.unpack_walk(hk.hash_scan_walk(table, 0, 4, 3).packed.numpy(), 3, [torch.float32])
    empty = hk.hash_scan_walk(table, 5, 5, 0)
    assert int(empty.count[0]) == 0 and empty.key.shape == (0,)
    assert hk.launch_counts() == {"hash_scan_chunk": 0, "hash_scan_walk": 0, "hash_free": 0}
    assert sk.launch_counts()["shard_extract"] == 0
    assert callable(sk.extract_kernel_launches) and callable(sk.probe_merge_rounds)
