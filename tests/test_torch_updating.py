"""The port's updating aggregate (arroyo_tpu_torch/operators/
updating_aggregate.py) on the CPU against arroyo_tpu's, in host mode
(backend "numpy") and device mode (backend "jax": the reference's jitted
slot aggregator, the port's plain K1/K2/K7 on the CPU): the same calls in
the same order, and every emitted batch equal column for column, dtypes
included, in order. The scenarios mirror tests/test_updating.py, plus
compaction, spill and the state carried across packages (the reference's
"s" checkpoint rows load into the port and the other way round)."""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import config as jcfg
from arroyo_tpu.batch import Batch as JBatch
from arroyo_tpu.expr import Col as JCol
from arroyo_tpu.hashing import hash_columns as jhash
from arroyo_tpu.operators.base import OperatorContext as JContext
from arroyo_tpu.operators.base import persist_mark
from arroyo_tpu.operators.updating_aggregate import UpdatingAggregate as JUpdating
from arroyo_tpu.state.tables import TableManager
from arroyo_tpu.types import TaskInfo as JTaskInfo
from arroyo_tpu.types import Watermark as JWatermark
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD
from arroyo_tpu_torch.batch import Batch as TBatch
from arroyo_tpu_torch.expr import Col as TCol
from arroyo_tpu_torch.hashing import hash_columns as thash
from arroyo_tpu_torch.operators.base import OperatorContext as TContext
from arroyo_tpu_torch.operators.updating_aggregate import (
    IS_RETRACT_FIELD,
    UpdatingAggregate,
    merge_updating_rows,
)
from arroyo_tpu_torch.types import TaskInfo as TTaskInfo
from arroyo_tpu_torch.types import Watermark as TWatermark

COUNT_SUM = [("cnt", "count", "-"), ("total", "sum", "v")]
COUNT_SUM_AVG = [("n", "count", "-"), ("total", "sum", "v"), ("mean", "avg", "v")]
MODES = ["numpy", "jax"]


@pytest.fixture(autouse=True)
def _configs():
    tcfg.reset()
    yield
    tcfg.reset()


def _aggs(spec, col):
    return [(name, kind, None if e == "-" else col(e)) for name, kind, e in spec]


def _device_config(cap=256, region=64, batch=256):
    over = {"device.table-capacity": cap, "device.region-size": region,
            "device.batch-capacity": batch}
    jcfg.update(over)
    tcfg.update(over)


class Collector:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)

    def broadcast(self, s):
        pass


class Pair:
    """One reference operator and one port operator fed the same calls."""

    def __init__(self, tmp_path, spec, backend, key_fields=("u",), **cfg):
        base = {"key_fields": list(key_fields), "backend": backend,
                "input_dtype_of": lambda e: np.dtype(np.int64), **cfg}
        self.j = JUpdating({**base, "aggregates": _aggs(spec, JCol)})
        self.t = UpdatingAggregate({**base, "aggregates": _aggs(spec, TCol)})
        assert self.j.device_mode == self.t.device_mode
        ti = JTaskInfo("upd", "agg", "updating_aggregate", 0, 1)
        self.jctx = JContext(ti, None, TableManager(ti, str(tmp_path / "ckpt")))
        self.tctx = TContext(TTaskInfo("upd", "agg", "updating_aggregate", 0, 1),
                             torch.device("cpu"))
        self.jcol, self.tcol = Collector(), Collector()

    def batch(self, ts, keys, vals, retracts=None, strings=True):
        k = np.array(keys, dtype=object) if strings else np.array(keys, dtype=np.int64)
        cols = {TIMESTAMP_FIELD: np.array(ts, dtype=np.int64), "u": k,
                "v": np.array(vals, dtype=np.int64)}
        if retracts is not None:
            cols[IS_RETRACT_FIELD] = np.array(retracts, dtype=bool)
        jk, tk = jhash([k]), thash([k])
        assert np.array_equal(jk, tk)
        self.j.process_batch(JBatch({**cols, "_key": jk}), self.jctx, self.jcol)
        self.t.process_batch(TBatch({**cols, "_key": tk}), self.tctx, self.tcol)

    def watermark(self, w):
        self.j.handle_watermark(JWatermark.event_time(w), self.jctx, self.jcol)
        self.t.handle_watermark(TWatermark.event_time(w), self.tctx, self.tcol)

    def tick(self):
        self.j.handle_tick(self.jctx, self.jcol)
        self.t.handle_tick(self.tctx, self.tcol)

    def close(self):
        self.j.on_close(self.jctx, self.jcol)
        self.t.on_close(self.tctx, self.tcol)

    def check(self):
        """Every emitted batch so far equal, in order; returns the port's rows."""
        assert_same_batches(self.tcol.batches, self.jcol.batches)
        return [r for b in self.tcol.batches for r in b.to_pylist()]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for name in w.columns:
            gc, wc = np.asarray(g[name]), np.asarray(w[name])
            assert gc.dtype == wc.dtype, name
            if wc.dtype == object:
                assert gc.tolist() == wc.tolist(), name
            else:
                assert np.array_equal(gc, wc), name


@pytest.mark.parametrize("backend", MODES)
def test_retract_append_stream(tmp_path, backend):
    p = Pair(tmp_path, COUNT_SUM, backend)
    p.batch([0, 1], ["a", "a"], [1, 2])
    p.watermark(1)
    rows = p.check()
    assert [(r["u"], r["cnt"], r["total"], r[IS_RETRACT_FIELD]) for r in rows] == [
        ("a", 2, 3, False)]
    p.batch([2], ["a"], [10])
    p.watermark(2)
    rows = p.check()
    assert [(r["cnt"], r["total"], r[IS_RETRACT_FIELD]) for r in rows[1:]] == [
        (2, 3, True), (3, 13, False)]
    assert merge_updating_rows(rows) == [{"u": "a", "cnt": 3, "total": 13}]


@pytest.mark.parametrize("backend", MODES)
def test_noop_update_suppressed(tmp_path, backend):
    # max is host-only in both packages, whatever the backend
    p = Pair(tmp_path, [("mx", "max", "v")], backend)
    assert not p.t.device_mode
    p.batch([0], ["a"], [5])
    p.watermark(1)
    p.batch([2], ["a"], [3])  # max unchanged
    p.watermark(3)
    assert len(p.check()) == 1
    # device mode: an append and a retract of the same value leave the
    # key's values unchanged, so its flush emits nothing
    q = Pair(tmp_path, COUNT_SUM, backend)
    q.batch([0], ["a"], [5])
    q.watermark(1)
    q.batch([2, 2], ["a", "a"], [4, 4], retracts=[False, True])
    q.watermark(3)
    assert len(q.check()) == 1


@pytest.mark.parametrize("backend", MODES)
def test_updating_input_retraction(tmp_path, backend):
    p = Pair(tmp_path, COUNT_SUM, backend)
    p.batch([0, 0], ["a", "a"], [1, 2])
    p.watermark(0)
    p.batch([1], ["a"], [2], retracts=[True])
    p.watermark(1)
    assert merge_updating_rows(p.check()) == [{"u": "a", "cnt": 1, "total": 1}]


@pytest.mark.parametrize("backend", MODES)
def test_retract_to_zero_deletes_key(tmp_path, backend):
    p = Pair(tmp_path, COUNT_SUM, backend)
    p.batch([0], ["a"], [7])
    p.watermark(0)
    p.batch([1], ["a"], [7], retracts=[True])
    p.watermark(1)
    assert merge_updating_rows(p.check()) == []
    assert p.t.state == {} and p.t.key_values == {} and p.t._emitted == {}
    # the key comes back from zero
    p.batch([2], ["a"], [4])
    p.watermark(2)
    assert merge_updating_rows(p.check()) == [{"u": "a", "cnt": 1, "total": 4}]


def test_retract_without_append_raises(tmp_path):
    for backend in MODES:
        p = Pair(tmp_path, COUNT_SUM, backend)
        with pytest.raises(RuntimeError, match="retract without matching append"):
            p.t.process_batch(TBatch({TIMESTAMP_FIELD: np.array([0]), "u": np.array(["a"], object),
                                      "v": np.array([1]), "_key": thash([np.array(["a"], object)]),
                                      IS_RETRACT_FIELD: np.array([True])}), p.tctx, p.tcol)
            p.t.handle_watermark(TWatermark.event_time(0), p.tctx, p.tcol)


def test_min_over_updating_input_rejected(tmp_path):
    p = Pair(tmp_path, [("mn", "min", "v")], "numpy")
    with pytest.raises(ValueError, match="invertible"):
        p.t.process_batch(TBatch({TIMESTAMP_FIELD: np.array([0]), "u": np.array(["a"], object),
                                  "v": np.array([1]), "_key": thash([np.array(["a"], object)]),
                                  IS_RETRACT_FIELD: np.array([True])}), p.tctx, p.tcol)


@pytest.mark.parametrize("backend", MODES)
def test_ttl_eviction_emits_retraction(tmp_path, backend):
    p = Pair(tmp_path, COUNT_SUM, backend, ttl_micros=1000)
    p.batch([0], ["a"], [1])
    p.watermark(0)
    p.batch([10_000], ["b"], [2])
    p.watermark(10_000)
    assert merge_updating_rows(p.check()) == [{"u": "b", "cnt": 1, "total": 2}]
    assert p.t.evicted_keys == 1


def _random_stream(p, seed=31, steps=8, n=200, hi_keys=12, strings=False, drive="tick"):
    """test_updating.py's device-equals-host stream: keys 6-11 go idle after
    step 3 so TTL eviction fires; optional retractions of earlier rows."""
    rng = np.random.default_rng(seed)
    sent = []
    for step in range(steps):
        hi = hi_keys if step < 4 else hi_keys // 2
        ks = rng.integers(0, hi, size=n)
        vs = rng.integers(1, 100, size=n)
        ts = np.full(n, step * 10_000_000)
        retract = np.zeros(n, dtype=bool)
        live = [i for i, (k, _v) in enumerate(sent) if k < hi]
        if live and step % 2:
            # retract a few rows appended earlier to still-active keys (an
            # updating input)
            take = rng.choice(live, size=min(10, len(live)), replace=False)
            back = [sent[i] for i in sorted(take, reverse=True)]
            for i in sorted(take, reverse=True):
                sent.pop(i)
            ks = np.concatenate([ks, [k for k, _v in back]])
            vs = np.concatenate([vs, [v for _k, v in back]])
            ts = np.concatenate([ts, np.full(len(back), step * 10_000_000)])
            retract = np.concatenate([retract, np.ones(len(back), dtype=bool)])
        sent.extend((k, v) for k, v, r in zip(ks.tolist(), vs.tolist(), retract) if not r)
        keys = [f"k{k}" for k in ks] if strings else ks
        p.batch(ts, keys, vs, retracts=retract, strings=strings)
        if drive == "tick":
            p.tick()
        else:
            p.watermark(step * 10_000_000)
    p.close()
    return p.check()


def test_device_mode_matches_host_mode(tmp_path):
    """Four runs of one stream (both packages x both modes) emit the same
    batches in the same order, and keys 6-11 are evicted in every mode."""
    _device_config()
    runs = {}
    for backend in MODES:
        p = Pair(tmp_path / backend, COUNT_SUM_AVG, backend, key_fields=("u",),
                 ttl_micros=30_000_000)
        runs[backend] = (_random_stream(p), p.tcol.batches)
    assert_same_batches(runs["jax"][1], runs["numpy"][1])
    final = merge_updating_rows(runs["jax"][0])
    assert {r["u"] for r in final} == set(range(6))


@pytest.mark.parametrize("backend", MODES)
def test_count_distinct(tmp_path, backend):
    spec = [("d", "count_distinct", "v"), ("cnt", "count", "-")]
    p = Pair(tmp_path, spec, backend)
    assert not p.t.device_mode  # collected state lives on the host
    p.batch([0, 1, 2, 3], ["a"] * 4, [1, 1, 2, 1], retracts=[False, False, False, True])
    p.watermark(3)
    p.batch([4], ["a"], [1], retracts=[True])
    p.watermark(4)
    p.batch([5, 6, 7], ["a", "b", "b"], [7, 8, 8])
    p.close()
    rows = p.check()
    assert merge_updating_rows(rows) == [{"u": "a", "d": 2, "cnt": 2},
                                         {"u": "b", "d": 1, "cnt": 2}]


def test_udaf_refused_when_built():
    with pytest.raises(NotImplementedError, match="UDF registry"):
        UpdatingAggregate({"key_fields": [], "aggregates": [("x", "udaf:median", TCol("v"))]})


def test_spill_config_refused():
    tcfg.update({"state.spill.enabled": True})
    with pytest.raises(NotImplementedError, match="spill annex"):
        UpdatingAggregate({"key_fields": [], "aggregates": [("n", "count", None)]})


def test_device_compaction(tmp_path):
    """A 64-slot table with a short TTL: keys die by eviction and by
    retraction to zero until a quarter of the table has died, and the store
    is rebuilt from its live snapshot, several times; the output equals the
    reference's and the host mode's."""
    _device_config(cap=64, region=16, batch=64)
    out = {}
    for backend in MODES:
        p = Pair(tmp_path / backend, COUNT_SUM_AVG, backend, ttl_micros=15_000_000)
        rng = np.random.default_rng(5)
        for step in range(16):
            ks = rng.integers(step * 6, step * 6 + 20, 80)  # the key range drifts
            p.batch(np.full(80, step * 5_000_000), ks, rng.integers(1, 50, 80), strings=False)
            p.watermark(step * 5_000_000)
        p.close()
        out[backend] = (p.check(), p.tcol.batches, p.t, p.j)
    assert_same_batches(out["jax"][1], out["numpy"][1])
    t, j = out["jax"][2], out["jax"][3]
    assert t.compactions >= 2 and t.evicted_keys > 16
    assert t._dead_since_compact == j._dead_since_compact


def test_device_spill(tmp_path):
    """More live keys than the 64 slots: the surplus aggregates in the host
    spill tier (slots_of gives -1, the flush reads the spill store) and the
    output equals the reference's and the host mode's."""
    _device_config(cap=64, region=16, batch=64)
    out = {}
    for backend in MODES:
        p = Pair(tmp_path / backend, COUNT_SUM_AVG, backend)
        rng = np.random.default_rng(9)
        for step in range(6):
            ks = rng.integers(0, 200, 300)
            rt = np.zeros(300, dtype=bool)
            p.batch(np.full(300, step * 1000), ks, ks % 17 + step, strings=False, retracts=rt)
            p.watermark(step * 1000)
        p.close()
        out[backend] = (p.check(), p.tcol.batches, p.t)
    assert_same_batches(out["jax"][1], out["numpy"][1])
    t = out["jax"][2]
    assert len(t._dev.spill) > 100 and t.spill_reads > 0
    assert (t._dev.slots_of(np.array(list(t._emitted), dtype=np.int64).view(np.uint64)) < 0).sum() \
        == len(t._dev.spill)


def _jax_s_rows(op, ctx, col):
    """The reference's checkpoint: flush, then the "s" table's rows."""
    op.handle_checkpoint(None, ctx, col)
    got = ctx.table_manager.expiring_time_key("s", op.ttl).all_batches()
    return JBatch.concat(got) if got else None


def _to(batch_cls, b):
    return batch_cls({k: np.asarray(v).copy() for k, v in b.columns.items()})


@pytest.mark.parametrize("src_mode", MODES)
@pytest.mark.parametrize("dst_mode", MODES)
def test_state_carried_across(tmp_path, src_mode, dst_mode):
    """Part 1 runs in one package and mode; its "s" rows load into the
    other package in either mode, and part 2 emits the same batches as the
    reference restored from the same rows (JAX -> port). The port's
    state_batch equals the reference's rows, and loads into the reference
    (port -> JAX) with the same continuation."""
    _device_config()
    spec = COUNT_SUM_AVG
    src = Pair(tmp_path / "src", spec, src_mode, ttl_micros=35_000_000)
    rng = np.random.default_rng(17)

    def feed(p, step):
        ks = rng.integers(0, 10, 50)
        p.batch(np.full(50, step * 10_000_000), [f"k{k}" for k in ks], rng.integers(1, 90, 50))
        p.watermark(step * 10_000_000)

    for step in range(3):
        feed(src, step)
    src.check()
    # checkpoint = flush + snapshot, in both packages
    src.t._flush(src.tcol)
    rows_j = _jax_s_rows(src.j, src.jctx, src.jcol)
    rows_t = src.t.state_batch()
    src.check()
    assert_same_batches([rows_t], [rows_j])
    # JAX -> port: the port loads the reference's rows; the reference
    # restores them through its own on_start
    dst = Pair(tmp_path / "dst", spec, dst_mode, ttl_micros=35_000_000)
    dst.jctx.table_manager.expiring_time_key("s", dst.j.ttl).replace_all([rows_j])
    persist_mark(dst.jctx, "m", src.j.max_event_time)
    dst.j.on_start(dst.jctx)
    dst.t.on_start(dst.tctx)
    dst.t.load_state_batch(_to(TBatch, rows_j))
    dst.t.max_event_time = src.t.max_event_time
    # port -> JAX: a fresh reference operator restores the port's rows
    back = Pair(tmp_path / "back", spec, dst_mode, ttl_micros=35_000_000)
    back.jctx.table_manager.expiring_time_key("s", back.j.ttl).replace_all(
        [_to(JBatch, rows_t)])
    persist_mark(back.jctx, "m", src.t.max_event_time)
    back.j.on_start(back.jctx)
    back.t.on_start(back.tctx)
    back.t.load_state_batch(rows_t)
    back.t.max_event_time = src.t.max_event_time
    state = rng.bit_generator.state
    for p in (dst, back):
        rng.bit_generator.state = state
        for step in range(3, 7):
            feed(p, step)
        p.close()
        p.check()
    assert_same_batches(back.tcol.batches, dst.tcol.batches)
    assert dst.tcol.batches  # keys were retracted and re-appended, some evicted
