"""UNNEST, the async UDF operator and the lookup join of the port against
the JAX package's: the same batches through both. UNNEST's NULL and empty
lists give no rows. The async UDF emits in input order under random call
delays (ordered), each result once (unordered), and drains its calls in
flight at a watermark and at a barrier. The lookup join holds
tests/test_joins.py's lookup cases (a connector object with
``lookup(keys)``), and its cache crosses the packages in table ``c``."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from arroyo_tpu import expr
        from arroyo_tpu.batch import Batch
        from arroyo_tpu.operators.async_udf import AsyncUdfOperator
        from arroyo_tpu.operators.base import OperatorContext
        from arroyo_tpu.operators.builtin import UnnestOperator
        from arroyo_tpu.operators.joins import LookupJoin
        from arroyo_tpu.state.tables import TableManager
        from arroyo_tpu.types import SignalKind, TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, tm)
    else:
        from arroyo_tpu_torch import expr
        from arroyo_tpu_torch.batch import Batch
        from arroyo_tpu_torch.operators.async_udf import AsyncUdfOperator
        from arroyo_tpu_torch.operators.base import OperatorContext
        from arroyo_tpu_torch.operators.builtin import UnnestOperator
        from arroyo_tpu_torch.operators.joins import LookupJoin
        from arroyo_tpu_torch.state.tables import TableManager
        from arroyo_tpu_torch.types import SignalKind, TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, table_manager=tm)
    return SimpleNamespace(name=name, expr=expr, Batch=Batch, Async=AsyncUdfOperator,
                           Unnest=UnnestOperator, Lookup=LookupJoin, TableManager=TableManager,
                           TaskInfo=TaskInfo, Watermark=Watermark, SignalKind=SignalKind, ctx=ctx)


JAX, PORT = _pkg("jax"), _pkg("port")


@pytest.fixture(autouse=True)
def _npz():
    import arroyo_tpu.config as jcfg

    jcfg.update({"checkpoint.file-format": "npz"})
    yield
    jcfg.reset()


class Collector:
    def __init__(self, P):
        self.P = P
        self.batches = []
        self.events = []

    def collect(self, b):
        self.batches.append(b)
        self.events.append("batch")

    def broadcast(self, s):
        if s.kind == self.P.SignalKind.WATERMARK:
            self.events.append("wm")


def form(batches) -> list:
    return [[(k, str(np.asarray(a).dtype),
              [(type(v).__name__, repr(v)) for v in np.asarray(a).tolist()])
             for k, a in b.columns.items()] for b in batches]


def rows(batches) -> list:
    out = []
    for b in batches:
        out.extend(b.to_pylist())
    return out


def context(P, storage="/tmp/unused-a5", node="op", restore=None, op=None):
    ti = P.TaskInfo("j", node, node, 0, 1)
    tm = P.TableManager(ti, storage)
    if restore is not None:
        tm.restore(restore, op.tables())
    return P.ctx(ti, tm), tm


# ------------------------------------------------------------------ UNNEST

def _lists(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=object)
    for i in range(n):
        r = rng.random()
        out[i] = (None if r < 0.15 else [] if r < 0.3
                  else [int(x) for x in rng.integers(-5, 5, int(rng.integers(1, 5)))])
    return out


@pytest.mark.parametrize("out_dtype", ["int64", "string", None])
@pytest.mark.parametrize("seed", [1, 2])
def test_unnest_matches_the_jax_package(out_dtype, seed):
    outs = {}
    for P in (JAX, PORT):
        op = P.Unnest({"column": "xs", "out_name": "x", "out_dtype": out_dtype})
        ctx, _ = context(P)
        col = Collector(P)
        n = 40
        lists = _lists(n, seed)
        if out_dtype == "string":
            lists = np.array([None if v is None else [str(x) for x in v] for v in lists],
                             dtype=object)
        op.process_batch(P.Batch({"_timestamp": np.arange(n, dtype=np.int64) * 10,
                                  "k": np.arange(n), "xs": lists}), ctx, col)
        op.process_batch(P.Batch({"_timestamp": np.zeros(2, np.int64), "k": np.arange(2),
                                  "xs": np.array([None, []], dtype=object)}), ctx, col)
        outs[P.name] = form(col.batches)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 1  # the all-NULL / empty batch gives no rows


# -------------------------------------------------------------- async UDF

def _slow_double(seed: int):
    rng = np.random.default_rng(seed)
    delays = rng.uniform(0, 0.004, 1000)

    def fn(x):
        time.sleep(float(delays[int(x) % 1000]))
        return -2 * int(x)
    return fn


def _async_run(P, ordered: bool, seed: int):
    op = P.Async({"name": "dbl", "fn": _slow_double(seed), "arg_exprs": [P.expr.Col("c")],
                  "out_name": "y", "return_dtype": "int64", "ordered": ordered,
                  "max_concurrency": 8})
    ctx, _ = context(P)
    op.on_start(ctx)
    col = Collector(P)
    rng = np.random.default_rng(seed)
    c = 0
    for i in range(6):
        k = int(rng.integers(1, 15))
        op.process_batch(P.Batch({"_timestamp": np.full(k, i, dtype=np.int64),
                                  "c": np.arange(c, c + k, dtype=np.int64),
                                  "s": np.array([f"r{x}" for x in range(c, c + k)], dtype=object)}),
                         ctx, col)
        c += k
        if i == 2:
            op.handle_watermark(P.Watermark.event_time(2), ctx, col)
            assert not op._in_flight  # a watermark drains the calls in flight
            col.events.append("wm-passed")
    op.handle_checkpoint(None, ctx, col)
    assert not op._in_flight
    op.on_close(ctx, col)
    return col, c


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_async_udf_ordered_emission_under_delays(seed):
    outs = {}
    for P in (JAX, PORT):
        col, n = _async_run(P, True, seed)
        got = rows(col.batches)
        assert [r["c"] for r in got] == list(range(n))  # input order
        assert all(r["y"] == -2 * r["c"] and r["s"] == f"r{r['c']}" for r in got)
        k = col.events.index("wm-passed")
        assert sum(1 for e in col.events[:k] if e == "batch") >= 1
        outs[P.name] = [(r["c"], r["y"], r["s"], r["_timestamp"]) for r in got]
        dts = {k: str(np.asarray(a).dtype) for k, a in col.batches[0].columns.items()}
        outs[P.name + "-dtypes"] = dts
    assert outs["port"] == outs["jax"] and outs["port-dtypes"] == outs["jax-dtypes"]


def test_async_udf_unordered_emits_each_result_once():
    outs = {}
    for P in (JAX, PORT):
        col, n = _async_run(P, False, 5)
        got = sorted((r["c"], r["y"]) for r in rows(col.batches))
        assert got == [(c, -2 * c) for c in range(n)]
        outs[P.name] = got
    assert outs["port"] == outs["jax"]


# ------------------------------------------------------------- lookup join

class DictLookup:
    def __init__(self, table, delay=0.0):
        self.table = table
        self.calls = 0
        self.delay = delay

    def lookup(self, keys):
        self.calls += 1
        time.sleep(self.delay)
        return {k: self.table.get(k) for k in keys}


def kb(P, ts, keys, vals):
    return P.Batch({"_timestamp": np.array(ts, dtype=np.int64),
                    "id": np.array(keys, dtype=np.int64), "v": np.array(vals, dtype=object)})


def lookup_op(P, conn, jt="left", **kw):
    return P.Lookup({"connector": conn, "key_exprs": [P.expr.Col("id")],
                     "right_names": [("name", "name"), ("score", "score")], "join_type": jt,
                     **kw})


TABLE = {1: {"name": "one", "score": 1.5}, 2: {"name": "two", "score": 2.5},
         3: {"name": None, "score": 3.0}}


@pytest.mark.parametrize("jt", ["left", "inner"])
def test_lookup_join_matches_the_jax_package(jt):
    outs = {}
    for P in (JAX, PORT):
        conn = DictLookup(TABLE)
        op = lookup_op(P, conn, jt)
        ctx, _ = context(P, node="lookup")
        op.on_start(ctx)
        col = Collector(P)
        op.process_batch(kb(P, [0, 1, 2, 3], [1, 2, 9, 3], ["a", "b", "c", "d"]), ctx, col)
        op.handle_checkpoint(None, ctx, col)
        op.process_batch(kb(P, [4, 5], [1, 1], ["e", "f"]), ctx, col)
        op.handle_checkpoint(None, ctx, col)
        op.process_batch(kb(P, [6], [9], ["g"]), ctx, col)
        op.on_close(ctx, col)
        assert conn.calls == 1  # the cache answers the later batches
        outs[P.name] = form(col.batches)
    assert outs["port"] == outs["jax"]


def test_lookup_join_watermark_rides_the_pending_queue():
    for P in (JAX, PORT):
        op = lookup_op(P, DictLookup(TABLE, delay=0.05))
        ctx, _ = context(P, node="lookup")
        op.on_start(ctx)
        col = Collector(P)
        t0 = time.perf_counter()
        op.process_batch(kb(P, [0], [1], ["a"]), ctx, col)
        out = op.handle_watermark(P.Watermark.event_time(10), ctx, col)
        assert out is None and time.perf_counter() - t0 < 0.04
        op.process_batch(kb(P, [1], [2], ["b"]), ctx, col)
        op.handle_checkpoint(None, ctx, col)
        assert col.events == ["batch", "wm", "batch"]
        op.on_close(ctx, col)


def test_lookup_join_overlaps_a_slow_source():
    for P in (JAX, PORT):
        conn = DictLookup({k: {"name": f"n{k}", "score": float(k)} for k in range(48)},
                          delay=0.05)
        op = lookup_op(P, conn, max_concurrency=16)
        ctx, _ = context(P, node="lookup")
        op.on_start(ctx)
        col = Collector(P)
        t0 = time.perf_counter()
        for b in range(12):
            ids = [b * 4 + j for j in range(4)]
            op.process_batch(kb(P, ids, ids, [f"v{c}" for c in ids]), ctx, col)
        op.handle_checkpoint(None, ctx, col)
        assert time.perf_counter() - t0 < 0.3
        got = rows(col.batches)
        assert [r["id"] for r in got] == list(range(48)) and conn.calls == 12
        op.on_close(ctx, col)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lookup_cache_crosses_the_packages(writer, tmp_path):
    """The cache checkpointed in table ``c`` by one package answers the
    other's lookups after a restore: no call reaches the connector."""
    W = JAX if writer == "jax" else PORT
    storage = str(tmp_path / "lk")
    op = lookup_op(W, DictLookup(TABLE), cache_ttl_micros=3_600_000_000)
    ctx, tm = context(W, storage, node="lookup")
    op.on_start(ctx)
    col = Collector(W)
    op.process_batch(kb(W, [0, 1, 2], [1, 2, 9], ["a", "b", "c"]), ctx, col)
    op.handle_checkpoint(None, ctx, col)
    tm.checkpoint(1, None)
    op.on_close(ctx, col)
    outs = {}
    for P in (JAX, PORT):
        conn = DictLookup({})
        op2 = lookup_op(P, conn, cache_ttl_micros=3_600_000_000)
        ctx2, _ = context(P, storage, node="lookup", restore=1, op=op2)
        op2.on_start(ctx2)
        col2 = Collector(P)
        op2.process_batch(kb(P, [5, 6, 7], [2, 9, 1], ["x", "y", "z"]), ctx2, col2)
        op2.handle_checkpoint(None, ctx2, col2)
        op2.on_close(ctx2, col2)
        assert conn.calls == 0
        outs[P.name] = form(col2.batches)
    assert outs["port"] == outs["jax"]


def test_every_operator_of_the_jax_package_is_registered(monkeypatch):
    """Every OpName of the JAX package constructs in the port; one whose
    constructor is missing is refused naming ROADMAP.md's queue A."""
    from arroyo_tpu.graph import OpName as JOp
    from arroyo_tpu_torch.engine import engine
    from arroyo_tpu_torch.graph import OpName

    engine.load_operators()
    assert [o.value for o in OpName] == [o.value for o in JOp]
    assert set(engine._CONSTRUCTORS) == set(OpName)
    monkeypatch.delitem(engine._CONSTRUCTORS, OpName.UNNEST)
    monkeypatch.setattr(engine, "load_operators", lambda: None)
    with pytest.raises(NotImplementedError, match="unnest is not ported yet.*ROADMAP.md queue A"):
        engine.construct_operator(OpName.UNNEST, {})
