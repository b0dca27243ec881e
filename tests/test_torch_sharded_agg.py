"""The port's ShardedAggregator (arroyo_tpu_torch/parallel/sharded_agg.py)
against the JAX package's on its 8 emulated CPU devices: the same rows, made
from a seed, go through both; after every step the nine state arrays (table
keys, bins, occupancy and lanes, overflow, spill keys, bins, fill and lanes)
are byte-equal, and every close emits the same rows in the same order.

The port holds the mesh's shards on one device and runs the plain PyTorch
versions of K8-K11 on the CPU (the kernels are held against those on the
card by chip_smoke.py). Exact throughout: float lanes included, since K8's
plain version adds each run's rows in sorted order as XLA's CPU
segment_sum does.
"""

from __future__ import annotations

import numpy as np
import pytest

from arroyo_tpu.hashing import hash_column, servers_for_hashes

KINDS = ("sum", "count", "min", "max", "sum")
DTYPES = (np.int64, np.int64, np.float64, np.int32, np.float64)


def _pair(n_dev, kinds=KINDS, dtypes=DTYPES, **kw):
    import jax

    from arroyo_tpu.parallel import ShardedAggregator as JAgg
    from arroyo_tpu.parallel import make_mesh as jmesh
    from arroyo_tpu_torch.parallel import ShardedAggregator as TAgg
    from arroyo_tpu_torch.parallel import make_mesh as tmesh

    if len(jax.devices()) < n_dev:
        pytest.skip(f"needs {n_dev} virtual devices (conftest sets XLA_FLAGS)")
    return (JAgg(jmesh(n_dev), kinds, dtypes, **kw),
            TAgg(tmesh(n_dev, "cpu"), kinds, dtypes, **kw))


def _flat_state(state):
    out = []
    for x in state:
        if isinstance(x, tuple):
            out += list(x)
        else:
            out.append(x)
    return [np.asarray(x) if not hasattr(x, "numpy") else x.numpy() for x in out]


def assert_state_equal(jagg, tagg):
    js, ts = _flat_state(jagg.state), _flat_state(tagg.state)
    assert len(js) == len(ts)
    for i, (a, b) in enumerate(zip(js, ts)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f"state array {i} differs"


def assert_rows_equal(got_j, got_t):
    kj, bj, aj = got_j
    kt, bt, at = got_t
    assert kj.dtype == kt.dtype and kj.tobytes() == kt.tobytes()
    assert bj.dtype == bt.dtype and bj.tobytes() == bt.tobytes()
    assert len(aj) == len(at)
    for x, y in zip(aj, at):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _rows(rng, n, n_keys, n_bins=3, hot=None):
    raw = rng.integers(0, n_keys, size=n)
    if hot is not None:
        raw = np.where(rng.random(n) < hot, 17, raw)
    keys = hash_column(raw.astype(np.int64))
    bins = rng.integers(0, n_bins, size=n).astype(np.int32)
    vals = [rng.integers(-50, 50, size=n).astype(np.int64),
            np.ones(n, dtype=np.int64),
            np.round(rng.standard_normal(n) * 100, 3),
            rng.integers(-1000, 1000, size=n).astype(np.int32),
            rng.standard_normal(n) * 1e3]
    return keys, bins, vals


def _sharded(n_dev, B, keys, bins, vals):
    """Round-robin rows over the shards, padded to B (the tests' layout)."""
    k = np.zeros((n_dev, B), dtype=np.int64)
    b = np.zeros((n_dev, B), dtype=np.int32)
    valid = np.zeros((n_dev, B), dtype=bool)
    vs = [np.zeros((n_dev, B), dtype=v.dtype) for v in vals]
    for d in range(n_dev):
        rows = slice(d, len(keys), n_dev)
        m = len(keys[rows])
        k[d, :m] = keys[rows].view(np.int64)
        b[d, :m] = bins[rows]
        valid[d, :m] = True
        for i, v in enumerate(vals):
            vs[i][d, :m] = v[rows]
    return k, b, valid, vs


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_update_sharded_state_and_extract_equal(n_dev):
    jagg, tagg = _pair(n_dev, cap=256, batch_cap=64, max_probes=16, emit_cap=64,
                       spill_cap=64)
    rng = np.random.default_rng(11 + n_dev)
    for _ in range(4):
        keys, bins, vals = _rows(rng, n_dev * 50, 90)
        k, b, valid, vs = _sharded(n_dev, 64, keys, bins, vals)
        jagg.update_sharded(k, b, valid, vs)
        tagg.update_sharded(k, b, valid, vs)
        assert_state_equal(jagg, tagg)
    # a close in emit_cap chunks: bin 0 destructively, then a pure scan
    assert_rows_equal(jagg.extract_all(0, 1, 1), tagg.extract_all(0, 1, 1))
    assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.extract_all(1, 3, 1), tagg.extract_all(1, 3, 1))
    assert_state_equal(jagg, tagg)
    # updates after a free reuse the punched holes: duplicates (key, bin)
    # entries arise the same way on both
    keys, bins, vals = _rows(rng, n_dev * 50, 90)
    bins = bins + 1
    jagg.update(keys, bins, vals)
    tagg.update(keys, bins, vals)
    assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.extract_all(0, 10, 10), tagg.extract_all(0, 10, 10))
    assert_state_equal(jagg, tagg)


def test_entries_live_on_owner_shard():
    jagg, tagg = _pair(4, ("count",), (np.int64,), cap=256, batch_cap=64,
                       per_dest_cap=64, max_probes=16, emit_cap=64)
    keys = hash_column(np.arange(100, dtype=np.int64))
    k, b, valid, vs = _sharded(4, 64, keys, np.zeros(100, dtype=np.int32),
                               [np.ones(100, dtype=np.int64)])
    tagg.update_sharded(k, b, valid, vs)
    jagg.update_sharded(k, b, valid, vs)
    assert_state_equal(jagg, tagg)
    keys_t, occ_t = tagg.state[0].numpy(), tagg.state[2].numpy()
    for d in range(4):
        present = keys_t[d][occ_t[d]].view(np.uint64)
        assert len(present) and (servers_for_hashes(present, 4) == d).all()


@pytest.mark.parametrize("n_dev", [4, 8])
def test_hot_key_past_dest_cap_stays_local(n_dev):
    """One key takes 90% of the rows: past per_dest_cap partials stay on the
    producing shard (keep-local), the close combines them exactly."""
    kinds, dts = ("sum", "count"), (np.int64, np.int64)
    jagg, tagg = _pair(n_dev, kinds, dts, cap=512, batch_cap=64, per_dest_cap=4,
                       max_probes=16, emit_cap=128, spill_cap=64)
    rng = np.random.default_rng(3)
    for _ in range(6):
        n = n_dev * 64
        keys, bins, vals = _rows(rng, n, 40, n_bins=2, hot=0.9)
        jagg.update(keys, bins, vals[:2])
        tagg.update(keys, bins, vals[:2])
        assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.extract_all(0, 10, 10), tagg.extract_all(0, 10, 10))
    assert tagg.mesh_stats() == jagg.mesh_stats()


def test_table_pressure_spills_then_overflow_raises():
    """More groups than the table places in two probes: the spill buffer
    takes them (equal state and rows); then a tiny spill buffer overflows
    and both raise."""
    kinds, dts = ("count",), (np.int64,)
    jagg, tagg = _pair(4, kinds, dts, cap=64, batch_cap=128, per_dest_cap=128,
                       max_probes=2, emit_cap=64, spill_cap=512)
    rng = np.random.default_rng(5)
    for _ in range(3):
        keys = hash_column(rng.integers(0, 400, size=512).astype(np.int64))
        bins = np.zeros(512, dtype=np.int32)
        ones = [np.ones(512, dtype=np.int64)]
        jagg.update(keys, bins, ones)
        tagg.update(keys, bins, ones)
        assert_state_equal(jagg, tagg)
    assert int(tagg.state[7].sum()) > 0  # the spill buffer holds rows
    assert_rows_equal(jagg.snapshot(), tagg.snapshot())
    assert tagg.mesh_stats() == jagg.mesh_stats()
    assert_rows_equal(jagg.extract_all(0, 10, 10), tagg.extract_all(0, 10, 10))
    assert_state_equal(jagg, tagg)

    jagg, tagg = _pair(4, kinds, dts, cap=64, batch_cap=128, per_dest_cap=128,
                       max_probes=2, emit_cap=64, spill_cap=8)
    keys = hash_column(np.arange(600, dtype=np.int64))
    for agg in (jagg, tagg):
        agg.update(keys, np.zeros(600, dtype=np.int32), [np.ones(600, dtype=np.int64)])
    assert_state_equal(jagg, tagg)
    assert int(tagg.state[4].sum()) > 0
    for agg in (jagg, tagg):
        with pytest.raises(RuntimeError, match="sharded aggregate overflow"):
            agg.extract_all(0, 10, 10)


def test_probe_exhaustion_and_max_key():
    """Probe rounds run out (max_probes 1), and a valid row with key
    INT64_MAX in bin INT32_MAX joins the padding run."""
    jagg, tagg = _pair(4, cap=64, batch_cap=32, max_probes=1, emit_cap=32, spill_cap=256)
    rng = np.random.default_rng(9)
    for step in range(3):
        keys, bins, vals = _rows(rng, 4 * 30, 70)
        keys[:3] = np.uint64(np.iinfo(np.int64).max)
        bins[:3] = np.iinfo(np.int32).max
        k, b, valid, vs = _sharded(4, 32, keys, bins, vals)
        jagg.update_sharded(k, b, valid, vs)
        tagg.update_sharded(k, b, valid, vs)
        assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.extract_all(0, np.iinfo(np.int32).max, 5),
                      tagg.extract_all(0, np.iinfo(np.int32).max, 5))
    assert_state_equal(jagg, tagg)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_snapshot_restore_scan_free(n_dev):
    jagg, tagg = _pair(n_dev, cap=256, batch_cap=64, max_probes=16, emit_cap=32,
                       spill_cap=64)
    rng = np.random.default_rng(21)
    for _ in range(3):
        keys, bins, vals = _rows(rng, n_dev * 40, 60, n_bins=5)
        jagg.update(keys, bins, vals)
        tagg.update(keys, bins, vals)
    assert_state_equal(jagg, tagg)
    snap_j, snap_t = jagg.snapshot(), tagg.snapshot()
    assert_rows_equal(snap_j, snap_t)
    assert_rows_equal(jagg.scan_range(1, 3), tagg.scan_range(1, 3))
    jagg.free_bins_below(2)
    tagg.free_bins_below(2)
    assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.snapshot(), tagg.snapshot())
    jagg.restore(*snap_j)
    tagg.restore(*snap_t)
    assert_state_equal(jagg, tagg)
    h_j = jagg.extract_start(0, 5, 5)
    h_t = tagg.extract_start(0, 5, 5)
    assert h_t.is_ready()
    assert_rows_equal(h_j.result(), h_t.result())
    assert_state_equal(jagg, tagg)


def _by_key_bin(rows):
    """Rows in (bin, key) order: a snapshot's rows come in slot order."""
    k, b, accs = rows
    order = np.lexsort((k, b))
    return k[order], b[order], [a[order] for a in accs]


@pytest.mark.parametrize("key_range", ["whole uint64 range", "below 2^63"])
def test_half_full_store_restores_as_the_reference(key_range):
    """A store half full (its snapshot sorted by key, restored through
    update() in batch_cap chunks) against the JAX one, state for state. With
    keys over the whole uint64 range, as key hashes are, nothing is lost and
    the restored snapshot is the first. Keys below 2^63 are owned by half
    the shards, which the half-full store fills past what probing and the
    spill buffers hold: both packages lose the same partials and both raise
    at the next extract, never silently."""
    n_dev, cap = 8, 4096
    jagg, tagg = _pair(n_dev, cap=cap, batch_cap=1024, max_probes=32, emit_cap=1024,
                       spill_cap=64)
    jnew, tnew = _pair(n_dev, cap=cap, batch_cap=1024, max_probes=32, emit_cap=1024,
                       spill_cap=64)
    rng = np.random.default_rng(20261017)
    m = n_dev * cap // 2
    hi = 2**64 - 1 if key_range == "whole uint64 range" else 2**63 - 1
    keys = rng.permutation(np.unique(rng.integers(0, hi, m + m // 8, dtype=np.uint64,
                                                  endpoint=True)))[:m]
    bins = rng.integers(0, 4, m).astype(np.int32)
    vals = [rng.integers(-10**9, 10**9, m).astype(np.int64), np.ones(m, dtype=np.int64),
            rng.standard_normal(m) * 1e6, rng.integers(-1000, 1000, m).astype(np.int32),
            rng.standard_normal(m) * 1e3]
    jagg.update(keys, bins, vals)
    tagg.update(keys, bins, vals)
    assert_state_equal(jagg, tagg)
    snap = tagg.snapshot()
    assert_rows_equal(jagg.snapshot(), snap)
    jnew.restore(*snap)
    tnew.restore(*snap)
    assert_state_equal(jnew, tnew)
    lost = int(tnew.state[4].sum())
    if key_range == "whole uint64 range":
        assert int(tagg.state[4].sum()) == lost == 0
        assert_rows_equal(_by_key_bin(tnew.snapshot()), _by_key_bin(snap))
        assert_rows_equal(jnew.extract(0, 4, 0), tnew.extract(0, 4, 0))
        return
    assert lost > 0 and int(np.asarray(jnew.state[4]).sum()) == lost
    for agg in (jnew, tnew):
        with pytest.raises(RuntimeError, match=f"sharded aggregate overflow \\({lost} entries lost"):
            agg.extract(0, 4, 0)


@pytest.mark.parametrize("max_probes", [-1, 0])
@pytest.mark.parametrize("n_dev", [4, 8])
def test_no_probe_round_spills_every_partial(n_dev, max_probes):
    """max_probes <= 0 runs no probe round, as the reference's
    fori_loop(0, max_probes) runs none: every merged partial goes to the
    spill buffer (large enough that none is lost), and the state, the mesh
    ledger and the rows a close emits equal the JAX package's."""
    jagg, tagg = _pair(n_dev, cap=256, batch_cap=64, max_probes=max_probes, emit_cap=64,
                       spill_cap=1024)
    rng = np.random.default_rng(40 + n_dev - max_probes)
    for _ in range(3):
        keys, bins, vals = _rows(rng, n_dev * 40, 60)
        k, b, valid, vs = _sharded(n_dev, 64, keys, bins, vals)
        jagg.update_sharded(k, b, valid, vs)
        tagg.update_sharded(k, b, valid, vs)
        assert_state_equal(jagg, tagg)
        assert tagg.mesh_stats() == jagg.mesh_stats()
    assert not tagg.state[2].any()  # no partial took a table slot
    assert int(tagg.state[7].sum()) > 0 and int(tagg.state[4].sum()) == 0
    assert_rows_equal(jagg.snapshot(), tagg.snapshot())
    assert_rows_equal(jagg.extract_all(0, 2, 2), tagg.extract_all(0, 2, 2))
    assert_state_equal(jagg, tagg)
    assert_rows_equal(jagg.extract_all(0, 10, 10), tagg.extract_all(0, 10, 10))
    assert_state_equal(jagg, tagg)
