"""The port's window-function operator (WINDOW_FUNCTION) against the JAX
package's, batch for batch: tests/test_window_fn.py's cases, object order
columns holding None and NaN (the port ranks them without pandas, as
``pandas.factorize`` ranks them in the JAX package: a null sorts first),
descending unsigned and bool keys, seeded random buckets, and a checkpoint
written by either package restored by the other."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from arroyo_tpu.operators import window_fn as jwf
from arroyo_tpu_torch.operators import window_fn as twf


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from arroyo_tpu import expr
        from arroyo_tpu.batch import Batch
        from arroyo_tpu.operators.base import OperatorContext
        from arroyo_tpu.state.tables import TableManager
        from arroyo_tpu.types import TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, tm)
        op = jwf.WindowFunctionOperator
    else:
        from arroyo_tpu_torch import expr
        from arroyo_tpu_torch.batch import Batch
        from arroyo_tpu_torch.operators.base import OperatorContext
        from arroyo_tpu_torch.state.tables import TableManager
        from arroyo_tpu_torch.types import TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, table_manager=tm)
        op = twf.WindowFunctionOperator
    return SimpleNamespace(name=name, expr=expr, Batch=Batch, ctx=ctx, Op=op,
                           TableManager=TableManager, TaskInfo=TaskInfo, Watermark=Watermark)


JAX, PORT = _pkg("jax"), _pkg("port")


@pytest.fixture(autouse=True)
def _npz():
    """Checkpoints as npz in both packages (the port reads no parquet)."""
    import arroyo_tpu.config as jcfg

    jcfg.update({"checkpoint.file-format": "npz"})
    yield
    jcfg.reset()


FUNCS = [("rn", "row_number", None), ("rk", "rank", None), ("dr", "dense_rank", None),
         ("total", "sum", "v"), ("n", "count", None), ("lo", "min", "v"), ("hi", "max", "v"),
         ("avg_v", "avg", "v")]


class Collector:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)

    def broadcast(self, s):
        pass


def form(col: Collector) -> list:
    out = []
    for b in col.batches:
        out.append([(k, str(np.asarray(a).dtype),
                     [(type(v).__name__, repr(v)) for v in np.asarray(a).tolist()])
                    for k, a in b.columns.items()])
    return out


def make(P, storage, order=(("v", False),), partition=("g",), funcs=FUNCS, restore=None):
    E = P.expr
    op = P.Op({"partition_fields": list(partition),
               "order_by": [(E.Col(c), asc) for c, asc in order],
               "functions": [(n, k, None if e is None else E.Col(e)) for n, k, e in funcs]})
    ti = P.TaskInfo("j", "wf", "window_function", 0, 1)
    tm = P.TableManager(ti, storage)
    if restore is not None:
        tm.restore(restore, op.tables())
    ctx = P.ctx(ti, tm)
    op.on_start(ctx)
    return SimpleNamespace(op=op, ctx=ctx, tm=tm, col=Collector(), P=P)


def feed(s, steps) -> None:
    for st in steps:
        if st[0] == "b":
            s.op.process_batch(s.P.Batch(dict(st[1])), s.ctx, s.col)
        elif st[0] == "wm":
            s.op.handle_watermark(s.P.Watermark.event_time(st[1]), s.ctx, s.col)
        else:
            s.op.on_close(s.ctx, s.col)


def run_both(steps, tmp_path, **kw) -> list:
    outs = {}
    for P in (JAX, PORT):
        s = make(P, str(tmp_path / P.name), **kw)
        feed(s, steps)
        outs[P.name] = form(s.col)
    assert outs["port"] == outs["jax"]
    return outs["port"]


def cols(ts, gs, vs, **extra):
    return {"_timestamp": np.array(ts, dtype=np.int64), "g": np.array(gs, dtype=object),
            "v": np.array(vs, dtype=np.int64), **extra}


def test_row_number_desc_per_partition(tmp_path):
    out = run_both([("b", cols([100] * 6, list("aaabbb"), [5, 9, 1, 4, 8, 6])),
                    ("wm", 101)], tmp_path)
    named = {c[0]: c[2] for c in out[0]}
    got = {(g[1], v[1]): rn[1] for g, v, rn in zip(named["g"], named["v"], named["rn"])}
    assert got == {("'a'", "9"): "1", ("'a'", "5"): "2", ("'a'", "1"): "3",
                   ("'b'", "8"): "1", ("'b'", "6"): "2", ("'b'", "4"): "3"}


def test_ties_aggregates_and_buckets(tmp_path):
    run_both([("b", cols([100] * 5 + [200] * 3, ["a"] * 5 + ["b"] * 3,
                         [9, 9, 5, 5, 1, 7, 7, 2])), ("close",)], tmp_path)


OBJ_CASES = {
    "strings with None and NaN": ["b", None, "a", np.nan, "c", "a", None, float("nan"), "b"],
    "numbers with None and NaN": [3.5, None, 1, np.nan, 2, 1.0, None, -4, float("nan")],
    "all null": [None, np.nan, None],
}


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
@pytest.mark.parametrize("asc", [True, False])
def test_object_order_column_with_nulls(case, asc, tmp_path):
    vals = OBJ_CASES[case]
    n = len(vals)
    o = np.empty(n, dtype=object)
    o[:] = vals
    run_both([("b", cols([100] * n, ["g"] * n, np.arange(n), o=o)), ("close",)], tmp_path,
             order=(("o", asc), ("v", True)))


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_sortable_ranks_as_pandas_factorize(case):
    o = np.empty(len(OBJ_CASES[case]), dtype=object)
    o[:] = OBJ_CASES[case]
    for desc in (False, True):
        assert twf._sortable(o, desc).tolist() == jwf._sortable(o, desc).tolist()


def test_unsigned_and_bool_keys_descending(tmp_path):
    n = 8
    u = np.array([0, 2 ** 64 - 1, 5, 5, 0, 7, 2 ** 63, 1], dtype=np.uint64)
    b = np.array([True, False, True, True, False, False, True, False])
    run_both([("b", cols([100] * n, ["a", "b"] * 4, np.arange(n), u=u, bb=b)), ("close",)],
             tmp_path, order=(("u", False), ("bb", False), ("v", True)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_buckets(seed, tmp_path):
    rng = np.random.default_rng(seed)
    steps = []
    t = 0
    for _ in range(12):
        k = int(rng.integers(1, 30))
        ts = (t + rng.integers(0, 3, k) * 100).tolist()
        gs = [f"g{x}" for x in rng.integers(0, 4, k)]
        o = np.empty(k, dtype=object)
        o[:] = [None if r < 0.1 else (np.nan if r < 0.2 else f"s{int(r * 20)}")
                for r in rng.random(k)]
        steps.append(("b", cols(ts, gs, rng.integers(-50, 50, k), o=o)))
        if rng.random() < 0.4:
            t += 300
            steps.append(("wm", t))
    steps.append(("close",))
    run_both(steps, tmp_path, order=(("o", bool(seed % 2)), ("v", False)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_the_packages(writer, tmp_path):
    W = JAX if writer == "jax" else PORT
    storage = str(tmp_path / "shared")
    w = make(W, storage)
    feed(w, [("b", cols([100, 200], ["a", "a"], [5, 3]))])
    w.op.handle_checkpoint(None, w.ctx, w.col)
    w.tm.checkpoint(1, None)
    outs = {}
    for P in (JAX, PORT):
        r = make(P, storage, restore=1)
        feed(r, [("b", cols([100, 200], ["a", "b"], [9, 1])), ("wm", 150), ("close",)])
        outs[P.name] = form(r.col)
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2
