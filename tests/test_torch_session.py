"""The port's session window (arroyo_tpu_torch/windows/session.py) against
arroyo_tpu's: operator level (the same calls, every emitted batch equal
column for column in order: gap merges, runs split inside a batch, sessions
bridged out of order, late rows, min/max/avg, COUNT(DISTINCT), a final
projection, many keys, the state carried across packages) and through
run_graph on a small qs (bench.py's session windows per bidder) against
chip_smoke's copy of bench.py's oracle_qs, with chaining off and on."""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu.hashing import hash_columns as jhash
from arroyo_tpu.operators.base import OperatorContext as JContext
from arroyo_tpu.state.tables import TableManager
from arroyo_tpu.types import TaskInfo as JTaskInfo
from arroyo_tpu.types import Watermark as JWatermark
from arroyo_tpu.windows.session import SessionAggregate as JSession
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD
from arroyo_tpu_torch.engine import run_graph as torch_run_graph
from arroyo_tpu_torch.hashing import hash_columns as thash
from arroyo_tpu_torch.obs.events import recorder as trecorder
from arroyo_tpu_torch.operators.base import OperatorContext as TContext
from arroyo_tpu_torch.types import TaskInfo as TTaskInfo
from arroyo_tpu_torch.types import Watermark as TWatermark
from arroyo_tpu_torch.windows.session import SessionAggregate

COUNT_SUM = [("cnt", "count", "-"), ("total", "sum", "v")]


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


class Collector:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)


def _aggs(spec, E):
    return [(name, kind, None if e == "-" else E.Col(e)) for name, kind, e in spec]


class Pair:
    def __init__(self, tmp_path, gap=1000, spec=COUNT_SUM, key_fields=("u",), projection=None):
        def cfg(E):
            c = {"gap_micros": gap, "key_fields": list(key_fields), "aggregates": _aggs(spec, E),
                 "input_dtype_of": lambda e: np.dtype(np.int64)}
            if projection is not None:
                c["final_projection"] = projection(E)
            return c

        self.j, self.t = JSession(cfg(jexpr)), SessionAggregate(cfg(texpr))
        ti = JTaskInfo("s", "sess", "session_aggregate", 0, 1)
        self.jctx = JContext(ti, None, TableManager(ti, str(tmp_path / "ckpt")))
        self.tctx = TContext(TTaskInfo("s", "sess", "session_aggregate", 0, 1), torch.device("cpu"))
        self.jcol, self.tcol = Collector(), Collector()

    def batch(self, ts, keys, vals, strings=True):
        k = np.array(keys, dtype=object) if strings else np.asarray(keys, dtype=np.int64)
        cols = {TIMESTAMP_FIELD: np.asarray(ts, dtype=np.int64), "u": k,
                "v": np.asarray(vals, dtype=np.int64)}
        self.j.process_batch(jbatch.Batch({**cols, "_key": jhash([k])}), self.jctx, self.jcol)
        self.t.process_batch(tbatch.Batch({**cols, "_key": thash([k])}), self.tctx, self.tcol)

    def watermark(self, w):
        fwd_j = self.j.handle_watermark(JWatermark.event_time(w), self.jctx, self.jcol)
        fwd_t = self.t.handle_watermark(TWatermark.event_time(w), self.tctx, self.tcol)
        assert fwd_t.value == fwd_j.value

    def close(self):
        self.j.on_close(self.jctx, self.jcol)
        self.t.on_close(self.tctx, self.tcol)

    def check(self):
        assert len(self.tcol.batches) == len(self.jcol.batches)
        for g, w in zip(self.tcol.batches, self.jcol.batches):
            assert list(g.columns) == list(w.columns)
            for n in w.columns:
                gc, wc = np.asarray(g[n]), np.asarray(w[n])
                assert gc.dtype == wc.dtype, n
                assert gc.tolist() == wc.tolist(), n
        assert self.t.late_rows == self.j.late_rows
        return [r for b in self.tcol.batches for r in b.to_pylist()]


def test_basic_session_merge_and_emit(tmp_path):
    p = Pair(tmp_path)
    p.batch([0, 500, 900, 3000, 100], ["a", "a", "a", "a", "b"], [1, 2, 3, 4, 10])
    p.watermark(1100)
    p.watermark(1900)
    p.close()
    rows = p.check()
    assert [(r["u"], r["cnt"], r["total"], r["window_start"], r["window_end"]) for r in rows] == [
        ("b", 1, 10, 100, 1100), ("a", 3, 6, 0, 1900), ("a", 1, 4, 3000, 4000)]


def test_out_of_order_merges_and_run_splitting(tmp_path):
    p = Pair(tmp_path)
    p.batch([0, 2500], ["a", "a"], [1, 2])
    p.batch([900, 1800], ["a", "a"], [10, 20])  # bridges both sessions
    p.batch([0, 50, 4000, 4050, 9000], ["b"] * 5, [1] * 5)  # one batch, three sessions
    p.close()
    rows = p.check()
    assert [(r["u"], r["cnt"], r["window_start"]) for r in rows] == [
        ("a", 4, 0), ("b", 2, 0), ("b", 2, 4000), ("b", 1, 9000)]


def test_late_rows_dropped(tmp_path):
    p = Pair(tmp_path)
    p.batch([0, 100], ["a", "b"], [1, 2])
    p.watermark(5000)
    p.batch([3000, 4500, 6000], ["a", "a", "b"], [5, 6, 7])  # 3000 <= 5000 - 1000: late
    p.close()
    p.check()
    assert p.t.late_rows == 1


def test_min_max_avg_and_count_distinct(tmp_path):
    spec = [("mn", "min", "v"), ("mx", "max", "v"), ("av", "avg", "v"),
            ("d", "count_distinct", "v")]
    p = Pair(tmp_path, spec=spec)
    p.batch([0, 100, 200, 5000], ["a", "a", "a", "a"], [5, 1, 5, 9])
    p.batch([250, 5100], ["a", "a"], [1, 2])
    p.close()
    rows = p.check()
    assert [(r["mn"], r["mx"], r["av"], r["d"]) for r in rows] == [(1, 5, 3.0, 2), (2, 9, 5.5, 2)]


def test_final_projection(tmp_path):
    p = Pair(tmp_path, projection=lambda E: [
        ("u", E.Col("u")), ("span", E.BinOp("-", E.Col("window_end"), E.Col("window_start"))),
        ("twice", E.BinOp("*", E.Col("total"), E.Lit(2)))])
    p.batch([0, 400, 2000], ["a", "a", "b"], [3, 4, 5])
    p.close()
    assert [(r["u"], r["span"], r["twice"]) for r in p.check()] == [("a", 1400, 14), ("b", 1000, 10)]


def test_many_keys_random_stream(tmp_path):
    """20,000 integer keys, bursty times, watermarks between batches: the
    same sessions, closed at the same watermarks, in the same order."""
    rng = np.random.default_rng(7)
    p = Pair(tmp_path, gap=1000)
    for step in range(12):
        k = rng.integers(0, 20_000, 20_000)
        ts = step * 3000 + rng.integers(0, 2, 20_000) * 2500 + rng.integers(0, 300, 20_000)
        p.batch(ts, k, rng.integers(1, 100, 20_000), strings=False)
        p.watermark(step * 3000)
    p.close()
    assert len(p.check()) > 30_000


def test_state_carried_across(tmp_path):
    """Open sessions written as the reference's "s" checkpoint rows load
    into the port, and the port's state_batch loads into the reference:
    both continue with the same emissions."""
    rng = np.random.default_rng(3)
    src = Pair(tmp_path / "src")
    src.batch(rng.integers(0, 5000, 400), [f"k{i}" for i in rng.integers(0, 30, 400)],
              rng.integers(1, 9, 400))
    src.watermark(2000)
    src.check()
    src.j.handle_checkpoint(None, src.jctx, src.jcol)
    rows_j = tbatch.Batch.concat(src.jctx.table_manager.expiring_time_key("s", 1000).all_batches())
    rows_t = src.t.state_batch()
    for n in rows_j.columns:
        assert np.asarray(rows_t[n]).tolist() == np.asarray(rows_j[n]).tolist(), n
    fwd, back = Pair(tmp_path / "fwd"), Pair(tmp_path / "back")
    # JAX -> port (the reference restores its own rows through on_start)
    fwd.jctx.table_manager.expiring_time_key("s", 1000).replace_all([rows_j])
    fwd.j.on_start(fwd.jctx)
    fwd.t.load_state_batch(tbatch.Batch(dict(rows_j.columns)))
    # port -> JAX
    back.jctx.table_manager.expiring_time_key("s", 1000).replace_all(
        [jbatch.Batch(dict(rows_t.columns))])
    back.j.on_start(back.jctx)
    back.t.load_state_batch(rows_t)
    state = rng.bit_generator.state
    for p in (fwd, back):
        rng.bit_generator.state = state
        p.batch(3000 + rng.integers(0, 5000, 300), [f"k{i}" for i in rng.integers(0, 30, 300)],
                rng.integers(1, 9, 300))
        p.watermark(6000)
        p.close()
    assert fwd.check() == back.check() and len(fwd.check()) > 30


QS_EVENTS = 60_000


@pytest.mark.parametrize("chaining", [False, True], ids=["chaining off", "chaining on"])
def test_qs_matches_jax_and_oracle(chaining):
    over = {"pipeline.source-batch-size": 8192, "worker.queue-size": 16384,
            "pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 0}
    tcfg.update(over)
    jcfg.update(over)
    job = f"qs-{chaining}"
    trows, jrows = [], []
    eng = torch_run_graph(chip_smoke.qs_graph(tbatch, texpr, tgraph, trows, QS_EVENTS),
                          job_id=job + "-torch", device="cpu")
    jax_run_graph(chip_smoke.qs_graph(jbatch, jexpr, jgraph, jrows, QS_EVENTS),
                  job_id=job + "-jax")
    names = ["bidder", "window_start", "window_end", "bids", "spend"]
    got = {n: np.concatenate([np.asarray(b[n]) for b in trows]) for n in names}
    want = {n: np.concatenate([np.asarray(b[n]) for b in jrows]) for n in names}
    for n in names:
        assert got[n].dtype == want[n].dtype and np.array_equal(got[n], want[n]), n
    sessions = chip_smoke.check_qs(trows, chip_smoke.oracle_qs(QS_EVENTS))
    assert len(sessions) > 1000
    if chaining:
        assert "bids+wm+key" in eng.graph.nodes
        assert not trecorder.events(job + "-torch", "SEGMENT_FALLBACK")
