"""The port's DeviceHashAggregator (arroyo_tpu_torch/ops/aggregate.py), both
backends, against the JAX package's: the counterparts of the seven tests
of tests/test_aggregate_device.py, and differential runs of seeded numpy
streams through both packages.

Backend "jax" runs B9's programs through the plain PyTorch versions of
K8, K9, K11-K13 on the CPU (chip_smoke.py holds the kernels to them on the
card). Port against JAX is exact: the table state slot for slot, every
snapshot, extract and scan in order, float lanes bit for bit (a NaN equals
a NaN). The port's two backends against each other compare floats with
the reference test's own rtol=1e-12 (the host store sums in another
order)."""

import numpy as np
import pytest

from arroyo_tpu.ops.aggregate import DeviceHashAggregator as JaxAgg
from arroyo_tpu_torch.ops import hash_kernels, sharded_kernels
from arroyo_tpu_torch.ops.aggregate import DeviceHashAggregator, ExtractHandle


def _agg(kinds, dtypes, backend="jax", **kw):
    extra = {"device": "cpu"} if backend == "jax" else {}
    return DeviceHashAggregator(kinds, dtypes, backend=backend, **extra, **kw)


def _random_stream(rng, n, n_keys, n_bins):
    keys = rng.integers(0, n_keys, size=n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    bins = rng.integers(0, n_bins, size=n).astype(np.int32)
    vals = rng.integers(1, 1000, size=n).astype(np.int64)
    return keys, bins, vals


def _as_dict(keys, bins, accs):
    return {
        (int(b), int(k)): tuple(int(a[i]) if np.issubdtype(a.dtype, np.integer) else float(a[i])
                                for a in accs)
        for i, (k, b) in enumerate(zip(keys.tolist(), bins.tolist()))
    }


def _same(a, b) -> bool:
    """Equal dtype, shape and bytes; floats as bits, a NaN equal to a NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if np.issubdtype(a.dtype, np.floating):
        nan = np.isnan(a)
        return bool(np.array_equal(nan, np.isnan(b)) and a[~nan].tobytes() == b[~nan].tobytes())
    return a.tobytes() == b.tobytes()


def assert_rows_same(got, want):
    (kg, bg, ag), (kw, bw, aw) = got, want
    assert _same(kg, kw) and _same(bg, bw), "keys or bins differ"
    assert len(ag) == len(aw)
    for g, w in zip(ag, aw):
        assert _same(g, w), "an accumulator lane differs"


def assert_state_same(tagg, jagg):
    """The port's table (keys, bins, occ, lanes, overflow) slot for slot."""
    keys_t, bins_t, occ_t, accs_t, oflow = tagg.state
    jk, jb, jo, ja, jof = jagg.state
    assert _same(keys_t.numpy(), np.asarray(jk))
    assert _same(bins_t.numpy(), np.asarray(jb))
    assert _same(occ_t.numpy(), np.asarray(jo))
    for t, j in zip(accs_t, ja):
        assert _same(t.numpy(), np.asarray(j))
    assert int(oflow[0]) == int(jof)


# ------------------------------------------- tests/test_aggregate_device.py


@pytest.mark.parametrize("acc_kinds,acc_dtypes", [
    (("sum", "count"), (np.int64, np.int64)),
    (("min", "max"), (np.int64, np.int64)),
    (("sum",), (np.float64,)),
])
def test_jax_matches_numpy(acc_kinds, acc_dtypes):
    rng = np.random.default_rng(42)
    jx = _agg(acc_kinds, acc_dtypes, cap=1024, batch_cap=256, max_probes=64, emit_cap=128)
    ora = _agg(acc_kinds, acc_dtypes, backend="numpy")
    for _ in range(5):
        keys, bins, vals = _random_stream(rng, 700, n_keys=50, n_bins=4)
        ins = [np.ones(len(keys), dtype=np.int64) if k == "count" else vals for k in acc_kinds]
        jx.update(keys, bins, ins)
        ora.update(keys, bins, ins)
    assert _as_dict(*jx.extract(0, 10, 10)) == _as_dict(*ora.extract(0, 10, 10))


def test_extract_respects_ranges_and_freeing():
    agg = _agg(("count",), (np.int64,), cap=256, batch_cap=64, max_probes=32, emit_cap=64)
    keys = np.arange(10, dtype=np.uint64)
    ones = np.ones(10, dtype=np.int64)
    for b in range(4):
        agg.update(keys, np.full(10, b, dtype=np.int32), [ones])
    # non-destructive range scan of bins [1,3), nothing freed
    k, b, a = agg.extract(1, 3, 0)
    assert len(k) == 20 and set(b.tolist()) == {1, 2}
    k2, b2, _ = agg.extract(1, 3, 0)
    assert len(k2) == 20
    # destructive close of bins < 2
    k3, b3, _ = agg.extract(0, 2, 2)
    assert len(k3) == 20 and set(b3.tolist()) == {0, 1}
    k4, _, _ = agg.extract(0, 10, 0)
    assert len(k4) == 20  # only bins 2, 3 remain


def test_emit_cap_chunking():
    agg = _agg(("count",), (np.int64,), cap=2048, batch_cap=512, max_probes=64, emit_cap=64)
    keys = np.arange(500, dtype=np.uint64)
    agg.update(keys, np.zeros(500, dtype=np.int32), [np.ones(500, dtype=np.int64)])
    k, b, a = agg.extract(0, 1, 1)
    assert len(k) == 500  # drained across several extract rounds
    assert sorted(np.asarray(k).tolist()) == list(range(500))


def test_overflow_raises_at_extract():
    """Overflow accumulates on the device and surfaces at the next extract
    (no host sync per batch)."""
    agg = _agg(("count",), (np.int64,), cap=64, batch_cap=256, max_probes=8, emit_cap=64)
    keys = np.arange(200, dtype=np.uint64)
    agg.update(keys, np.zeros(200, dtype=np.int32), [np.ones(200, dtype=np.int64)])
    assert int(agg.state[4][0]) > 0
    with pytest.raises(RuntimeError, match="overflow"):
        agg.extract(0, 1, 1)


def test_null_string_keys_hash():
    from arroyo_tpu_torch.hashing import hash_column

    col = np.array(["a", None, "b", None, "a"], dtype=object)
    h = hash_column(col)
    assert h[0] == h[4] and h[1] == h[3] and h[0] != h[1] != h[2]


def test_scan_range_nondivisible_emit_cap():
    """emit_cap not dividing cap must not duplicate the last slot (K12
    reads slot cap - 1 for every position past cap, never valid)."""
    agg = _agg(("count",), (np.int64,), cap=64, batch_cap=64, max_probes=64, emit_cap=48)
    keys = np.arange(40, dtype=np.uint64)
    agg.update(keys, np.zeros(40, dtype=np.int32), [np.ones(40, dtype=np.int64)])
    k, b, a = agg.scan_range(0, 1)
    assert len(k) == 40
    assert sorted(np.asarray(k).tolist()) == list(range(40))
    assert a[0].sum() == 40
    k2, _, _ = agg.scan_range(0, 1)
    assert len(k2) == 40
    agg.free_bins_below(1)
    k3, _, _ = agg.scan_range(0, 1)
    assert len(k3) == 0


def test_probe_hole_no_duplicate_entries():
    """Freeing closed bins punches holes in linear-probe chains; a later
    update of a live (key, bin) must not surface as two emitted rows.
    Interleaved updates and incremental closes: the table against the host
    store, and against the JAX table slot for slot and close for close."""
    rng = np.random.default_rng(7)
    kwargs = dict(cap=256, batch_cap=128, max_probes=256, emit_cap=64)
    jx = _agg(("count",), (np.int64,), **kwargs)
    orc = _agg(("count",), (np.int64,), backend="numpy", **kwargs)
    ref = JaxAgg(("count",), (np.int64,), backend="jax", **kwargs)
    got, want = {}, {}

    def close(lo, hi, below):
        k, b, a = jx.extract(lo, hi, below)
        assert_rows_same((k, b, a), ref.extract(lo, hi, below))
        assert_state_same(jx, ref)
        for agg_out, (kk_, bb_, aa_) in ((got, (k, b, a)), (want, orc.extract(lo, hi, below))):
            for kk, bb, aa in zip(kk_.tolist(), bb_.tolist(), aa_[0].tolist()):
                assert (kk, bb) not in agg_out, f"duplicate entry {(kk, bb)}"
                agg_out[(kk, bb)] = aa

    for step in range(30):
        n = 100
        keys = rng.integers(0, 40, n).astype(np.uint64)
        bins = rng.integers(step // 3, step // 3 + 3, n).astype(np.int32)
        ones = np.ones(n, dtype=np.int64)
        for agg in (jx, orc, ref):
            agg.update(keys, bins, [ones])
        assert_state_same(jx, ref)
        if step % 3 == 2:
            c = step // 3 + 1
            close(0, c, c)
    close(0, 1 << 30, 1 << 30)
    assert got == want


def test_float_accumulators_take_the_packed_transport():
    """The reference routes float lane sets through its unpacked extract
    and scan (its packed buffer bitcasts float64 to int64, which TPU x64
    emulation cannot compile) and returns a ReadyHandle. The port's one
    packed buffer is a byte layout that holds float lanes as they are, so
    every lane set takes it and extract_start returns an ExtractHandle.
    The results are the reference's: equal to the numpy store within
    rtol=1e-12, and to the JAX table exactly."""
    rng = np.random.default_rng(7)
    n = 5000
    keys = rng.integers(0, 50, n).astype(np.uint64)
    bins = rng.integers(0, 4, n).astype(np.int32)
    vals = rng.normal(size=n)

    kw = dict(cap=4096, batch_cap=1024, emit_cap=512)
    dev = _agg(("sum", "min"), (np.float64, np.float64), **kw)
    ora = _agg(("sum", "min"), (np.float64, np.float64), backend="numpy", **kw)
    ref = JaxAgg(("sum", "min"), (np.float64, np.float64), backend="jax", **kw)
    for a in (dev, ora, ref):
        a.update(keys, bins, [vals, vals])

    h = dev.extract_start(0, 2, 2)
    assert isinstance(h, ExtractHandle)
    dk, db, daccs = h.result()
    ok, ob, oaccs = ora.extract(0, 2, 2)
    assert_rows_same((dk, db, daccs), ref.extract(0, 2, 2))

    def table(k, b, accs):
        return {(int(kk), int(bb)): (float(a0), float(a1))
                for kk, bb, a0, a1 in zip(k, b, accs[0], accs[1])}

    dt, ot = table(dk, db, daccs), table(ok, ob, oaccs)
    assert set(dt) == set(ot)
    for kk in dt:
        np.testing.assert_allclose(dt[kk], ot[kk], rtol=1e-12)
    # the non-destructive scan of the remaining bins takes it too
    got = dev.scan_range(2, 4)
    assert_rows_same(got, ref.scan_range(2, 4))
    dt2, ot2 = table(*got), table(*ora.scan_range(2, 4))
    assert set(dt2) == set(ot2)
    for kk in dt2:
        np.testing.assert_allclose(dt2[kk], ot2[kk], rtol=1e-12)


# ------------------------------------------------- differential runs

LANE_SETS = {
    "int": (("sum", "count", "min", "max"), (np.int64, np.int64, np.int32, np.int64)),
    "uint64 key lane": (("count", "max", "min"), (np.int64, np.uint64, np.uint64)),
    "float": (("sum", "min", "max", "sum"), (np.float64, np.float32, np.float64, np.float32)),
}


def _lane_values(rng, kind, dt, n):
    dt = np.dtype(dt)
    if kind == "count":
        return np.ones(n, dtype=dt)
    if dt == np.uint64:
        return rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    if np.issubdtype(dt, np.integer):
        return rng.integers(-1000, 1000, n).astype(dt)
    v = np.round(rng.normal(0, 100, n), 3).astype(dt)
    if kind in ("min", "max"):
        pick = rng.random(n)
        v[pick < 0.05] = -0.0
        v[(pick >= 0.05) & (pick < 0.1)] = 0.0
        v[(pick >= 0.1) & (pick < 0.102)] = np.nan
    return v


@pytest.mark.parametrize("lanes", list(LANE_SETS), ids=list(LANE_SETS))
@pytest.mark.parametrize("emit_cap", [64, 1024], ids=["emit64", "emit1024"])
def test_table_matches_jax_table_step_by_step(lanes, emit_cap):
    """A seeded stream through the port's table and the JAX table: the
    state slot for slot and snapshot() after every update, and every
    extract, scan_range and free in order; emit_cap 64 forces drain rounds
    and chunked scans (K12), 1024 one packed round each."""
    kinds, dtypes = LANE_SETS[lanes]
    rng = np.random.default_rng(list(LANE_SETS).index(lanes) * 1000 + emit_cap)
    kw = dict(cap=1024, batch_cap=128, max_probes=64, emit_cap=emit_cap)
    tx = _agg(kinds, dtypes, **kw)
    jx = JaxAgg(kinds, dtypes, backend="jax", **kw)
    for step in range(12):
        n = int(rng.integers(1, 300))
        keys = rng.integers(0, 90, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        bins = rng.integers(step // 2, step // 2 + 4, n).astype(np.int32)
        vals = [_lane_values(rng, k, d, n) for k, d in zip(kinds, dtypes)]
        tx.update(keys, bins, vals)
        jx.update(keys, bins, vals)
        assert_state_same(tx, jx)
        assert_rows_same(tx.snapshot(), jx.snapshot())
        lo = step // 2
        if step % 3 == 0:
            assert_rows_same(tx.scan_range(lo, lo + 3), jx.scan_range(lo, lo + 3))
        if step % 4 == 1:
            tx.free_bins_below(lo)
            jx.free_bins_below(lo)
        if step % 3 == 1:  # a read that frees only the bins below the range
            assert_rows_same(tx.extract(lo + 1, lo + 3, lo), jx.extract(lo + 1, lo + 3, lo))
        if step % 3 == 2:  # a destructive close
            assert_rows_same(tx.extract(lo, lo + 1, lo + 1), jx.extract(lo, lo + 1, lo + 1))
        assert_state_same(tx, jx)
    assert_rows_same(tx.extract(0, 1 << 20, 1 << 20), jx.extract(0, 1 << 20, 1 << 20))
    assert_state_same(tx, jx)


@pytest.mark.parametrize("lanes", list(LANE_SETS), ids=list(LANE_SETS))
def test_host_store_matches_jax_host_store_in_order(lanes):
    """backend "numpy": the dict store, its emission order and every value
    equal the JAX package's; restore() then snapshot() round-trips."""
    kinds, dtypes = LANE_SETS[lanes]
    rng = np.random.default_rng(11)
    tx = _agg(kinds, dtypes, backend="numpy")
    jx = JaxAgg(kinds, dtypes, backend="numpy")
    for step in range(8):
        n = int(rng.integers(1, 400))
        keys = rng.integers(0, 60, n).astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
        bins = rng.integers(step, step + 3, n).astype(np.int32)
        vals = [_lane_values(rng, k, d, n) for k, d in zip(kinds, dtypes)]
        tx.update(keys, bins, vals)
        jx.update(keys, bins, vals)
        assert_rows_same(tx.snapshot(), jx.snapshot())
        assert_rows_same(tx.scan_range(step, step + 2), jx.scan_range(step, step + 2))
        if step % 2:
            tx.free_bins_below(step - 1)
            jx.free_bins_below(step - 1)
        assert_rows_same(tx.extract(step, step + 1, step), jx.extract(step, step + 1, step))
    snap = tx.snapshot()
    back = _agg(kinds, dtypes, backend="numpy")
    back.restore(*snap)
    assert_rows_same(back.snapshot(), snap)
    assert list(back.store) == list(tx.store)


def test_table_restore_replays_through_update():
    """restore() on the table re-initialises it and merges the rows back
    (count lanes add the given counts), as the JAX table's does."""
    kinds, dtypes = ("sum", "count", "max"), (np.float64, np.int64, np.uint64)
    rng = np.random.default_rng(5)
    kw = dict(cap=256, batch_cap=64, max_probes=64, emit_cap=32)
    src = _agg(kinds, dtypes, **kw)
    n = 400
    keys = rng.integers(0, 50, n).astype(np.uint64)
    bins = rng.integers(0, 3, n).astype(np.int32)
    src.update(keys, bins, [_lane_values(rng, k, d, n) for k, d in zip(kinds, dtypes)])
    snap = src.snapshot()
    tx, jx = _agg(kinds, dtypes, **kw), JaxAgg(kinds, dtypes, backend="jax", **kw)
    tx.restore(*snap)
    jx.restore(*snap)
    assert_state_same(tx, jx)
    assert_rows_same(tx.snapshot(), jx.snapshot())
    assert _as_dict(*tx.snapshot()) == _as_dict(*snap)


def test_table_takes_only_power_of_two_capacity_and_cuda_by_default():
    with pytest.raises(ValueError, match="power of two"):
        _agg(("count",), (np.int64,), cap=100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceHashAggregator(("count",), (np.int64,), cap=64)
    DeviceHashAggregator(("count",), (np.int64,), backend="numpy")  # no device needed
    assert hash_kernels.launch_counts() == {"hash_scan_chunk": 0, "hash_scan_walk": 0,
                                            "hash_free": 0}
    assert sharded_kernels.launch_counts()["agg_probe_merge"] == 0


def test_no_probe_round_overflows_as_the_reference():
    """max_probes -1 runs no probe round on the single-device table, as the
    reference's fori_loop(0, -1) runs none: every partial counts as
    overflow, the table stays empty, and the next extract raises the
    reference's error, word for word."""
    kw = dict(cap=64, batch_cap=128, max_probes=-1, emit_cap=64)
    tx = _agg(("sum", "count"), (np.int64, np.int64), **kw)
    jx = JaxAgg(("sum", "count"), (np.int64, np.int64), backend="jax", **kw)
    rng = np.random.default_rng(23)
    keys, bins, vals = _random_stream(rng, 100, 40, 2)
    for agg in (tx, jx):
        agg.update(keys, bins, [vals, np.ones(100, dtype=np.int64)])
    assert_state_same(tx, jx)
    assert not tx.state[2].any() and int(tx.state[4][0]) > 0
    with pytest.raises(RuntimeError, match="overflow") as got:
        tx.extract(0, 2, 2)
    with pytest.raises(RuntimeError, match="overflow") as want:
        jx.extract(0, 2, 2)
    assert str(got.value) == str(want.value)
