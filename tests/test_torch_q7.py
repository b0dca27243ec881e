"""Nexmark q7 through the port (arroyo_tpu_torch.engine.run_graph on the
CPU) against arroyo_tpu.engine.run_graph on the same graph and against the
closed-form q7 oracle, exactly; plus the pieces the two packages must agree
on bit for bit: the nexmark generator and the key hash."""

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu import hashing as jhashing
from arroyo_tpu.connectors.nexmark import NexmarkSource as JaxNexmark
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch import hashing as thashing
from arroyo_tpu_torch.connectors.nexmark import NexmarkSource as TorchNexmark
from arroyo_tpu_torch.engine import run_graph as torch_run_graph

WIDTH = 10_000_000
EVENTS = 20_000


@pytest.fixture(autouse=True)
def _port_config():
    """The port's config is its own object; tests/conftest.py resets only
    arroyo_tpu's."""
    tcfg.reset()
    tcfg.update({"pipeline.source-batch-size": 1024, "device.batch-capacity": 1024,
                 "device.table-capacity": 8192, "worker.queue-size": 2048})
    yield
    tcfg.reset()


def build_q7(g, rows, event_count, agg_parallelism=1):
    """bench.py's q7 graph over either package's modules (g: a namespace of
    batch, expr, graph)."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    gr.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("auction", E.Col("bid.auction")), ("price", E.Col("bid.price"))],
        "filter": E.Col("bid")}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": E.Col(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {"keys": [("auction", E.Col("auction"))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
        "width_micros": WIDTH, "key_fields": ["auction"],
        "aggregates": [("max_price", "max", E.Col("price")), ("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, agg_parallelism))
    gr.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": True}, 1))
    for a, b, t in [("src", "bids", "f"), ("bids", "wm", "f"), ("wm", "key", "f"),
                    ("key", "agg", "s"), ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def windows(rows):
    got = {}
    for b in rows:
        for ws, a, m, c in zip(b["window_start"].tolist(), b["auction"].tolist(),
                               b["max_price"].tolist(), b["bids"].tolist()):
            assert (ws, a) not in got, "a window was emitted twice"
            got[(ws, a)] = (m, c)
    return got


def oracle_q7(event_count):
    """(window_start, auction) -> (max_price, count), from arroyo_tpu's
    generator with numpy alone."""
    b = JaxNexmark({"event_count": event_count, "inter_event_micros": 1000,
                    "first_event_micros": 0, "include_strings": False,
                    "columns": ["bid.auction", "bid.price"]})._generate(
        np.arange(event_count, dtype=np.int64))
    bid = b["bid"]
    w = (b[jbatch.TIMESTAMP_FIELD][bid] // WIDTH) * WIDTH
    uniq, inv = np.unique(np.stack([w, b["bid.auction"][bid]], axis=1), axis=0,
                          return_inverse=True)
    mx = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv.ravel(), b["bid.price"][bid])
    cnt = np.bincount(inv.ravel(), minlength=len(uniq))
    return {(int(u[0]), int(u[1])): (int(m), int(c)) for u, m, c in zip(uniq, mx, cnt)}


def test_q7_matches_jax_engine_and_oracle():
    want = oracle_q7(EVENTS)
    jrows, trows = [], []
    jax_run_graph(build_q7((jbatch, jexpr, jgraph), jrows, EVENTS), job_id="q7-jax")
    torch_run_graph(build_q7((tbatch, texpr, tgraph), trows, EVENTS), job_id="q7-torch",
                    device="cpu")
    got = windows(trows)
    assert got == windows(jrows)
    assert got == want
    assert sum(c for _m, c in got.values()) == EVENTS * 46 // 50


def test_q7_parallel_window_operator_matches_oracle():
    """Two window subtasks: the keyed shuffle splits auctions by hash range
    and each subtask's watermark arrives through the merge."""
    rows = []
    torch_run_graph(build_q7((tbatch, texpr, tgraph), rows, EVENTS, agg_parallelism=2),
                    job_id="q7-p2", device="cpu")
    assert windows(rows) == oracle_q7(EVENTS)


def test_q7_with_spill_and_small_regions_matches_oracle():
    """A table far smaller than one window's groups: most groups live in
    the host spill store, regions are reused window after window."""
    tcfg.update({"device.table-capacity": 256, "device.region-size": 64})
    rows = []
    torch_run_graph(build_q7((tbatch, texpr, tgraph), rows, EVENTS), job_id="q7-spill",
                    device="cpu")
    assert windows(rows) == oracle_q7(EVENTS)


@pytest.mark.parametrize("p", [1, 3])
def test_nexmark_generator_matches_jax(p):
    """Every column, strings included, for subtask event numbers of a
    parallelism-p split."""
    cfg = {"event_count": 5000, "first_event_micros": 1_600_000_000_000_000}
    n = np.arange(0, 5000 // p, dtype=np.uint64) * np.uint64(p) + np.uint64(p - 1)
    want = JaxNexmark(dict(cfg))._generate(n)
    got = TorchNexmark(dict(cfg))._generate(n)
    assert set(got.columns) == set(want.columns)
    for c in want.columns:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_hashing_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.normal(size=300)
    f[:20] = -0.0
    f[20:40] = 0.0
    f[40:45] = np.nan
    f[45:50] = np.inf
    cols = [
        rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64),
        rng.integers(-1000, 1000, 300).astype(np.int32),
        rng.integers(0, 2**63, 300, dtype=np.uint64),
        f,
        f.astype(np.float32),
        rng.random(300) < 0.5,
        np.array([None if i % 7 == 0 else f"k{i % 13}" for i in range(300)], dtype=object),
    ]
    for c in cols:
        np.testing.assert_array_equal(thashing.hash_column(c), jhashing.hash_column(c))
    np.testing.assert_array_equal(thashing.hash_columns(cols), jhashing.hash_columns(cols))
    h = thashing.hash_columns(cols[:2])
    for n in (1, 2, 5):
        np.testing.assert_array_equal(thashing.servers_for_hashes(h, n),
                                      jhashing.servers_for_hashes(h, n))


def _exprs(E):
    c, lit = E.Col, E.Lit
    return [
        E.BinOp("+", c("a"), E.BinOp("*", c("b"), lit(3))),
        E.BinOp("/", c("a"), lit(-7)),
        E.BinOp("%", c("f"), lit(2.5)),
        E.BinOp("and", E.BinOp(">", c("a"), lit(0)), E.Not(c("t"))),
        E.Neg(c("f")),
        E.Cast(c("a"), "float32"),
        E.Cast(c("b"), "bool"),
        E.Case(((E.BinOp("<", c("a"), lit(0)), lit(-1)), (E.BinOp("==", c("a"), lit(0)), lit(0))),
               lit(1)),
        E.Func("abs", (c("b"),)),
        E.Func("date_trunc_micros", (lit(1000), c("a"))),
        E.Func("coalesce", (c("f"), lit(0.0))),
        E.Func("hash", (c("a"), c("t"))),
    ]


def test_expressions_match_jax():
    rng = np.random.default_rng(2)
    n = 200
    cols = {"a": rng.integers(-10_000, 10_000, n), "b": rng.integers(-50, 50, n),
            "f": rng.normal(0, 10, n), "t": rng.random(n) < 0.5}
    cols["f"][:5] = np.nan
    for je, te in zip(_exprs(jexpr), _exprs(texpr)):
        want = jexpr.eval_expr(je, cols, n)
        got = texpr.eval_expr(te, cols, n)
        assert got.dtype == want.dtype, je
        np.testing.assert_array_equal(got, want, err_msg=repr(je))


def build_channel_agg(g, rows):
    """A string group-by key (bid.channel, through the window operator's
    host KeyDictionary) with avg (sum + count lanes), min and count."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": 6000, "inter_event_micros": 5000,
        "first_event_micros": 0, "columns": ["bid.channel", "bid.price"]}, 1))
    gr.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("channel", E.Col("bid.channel")), ("price", E.Col("bid.price"))],
        "filter": E.Col("bid")}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(B.TIMESTAMP_FIELD)}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {"keys": [("channel", E.Col("channel"))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
        "width_micros": WIDTH, "key_fields": ["channel"],
        "aggregates": [("n", "count", None), ("avg_price", "avg", E.Col("price")),
                       ("min_price", "min", E.Col("price"))],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "bids", "f"), ("bids", "wm", "f"), ("wm", "key", "f"),
                    ("key", "agg", "s"), ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def test_string_keyed_window_matches_jax():
    jrows, trows = [], []
    jax_run_graph(build_channel_agg((jbatch, jexpr, jgraph), jrows), job_id="ch-jax")
    torch_run_graph(build_channel_agg((tbatch, texpr, tgraph), trows), job_id="ch-torch",
                    device="cpu")

    def canon(rows):
        return sorted((r["window_start"], r["channel"], r["n"], r["avg_price"], r["min_price"])
                      for r in rows)

    assert canon(trows) == canon(jrows)
    assert len(trows) > 8


def test_q7_chained_matches_jax_engine_and_oracle():
    """bench.py's setting: operator chaining on (here with every batch
    compiled, segment.compile.min-rows 0), in both packages. The port's
    bids+wm+key+agg+sink chain runs its prefix through the compiled segment
    and still gives the JAX engine's windows and the oracle's."""
    from arroyo_tpu import config as jcfg
    from arroyo_tpu.obs.events import recorder as jrecorder
    from arroyo_tpu_torch.obs.events import recorder as trecorder

    chained = {"pipeline.chaining.enabled": True, "segment.compile.min-rows": 0}
    tcfg.update(chained)
    jcfg.update(chained)
    jrows, trows = [], []
    jax_run_graph(build_q7((jbatch, jexpr, jgraph), jrows, EVENTS), job_id="q7c-jax")
    eng = torch_run_graph(build_q7((tbatch, texpr, tgraph), trows, EVENTS), job_id="q7c-torch",
                          device="cpu")
    assert list(eng.graph.nodes) == ["src", "bids+wm+key+agg+sink"]
    got = windows(trows)
    assert got == windows(jrows) == oracle_q7(EVENTS)
    assert [e["code"] for e in trecorder.events("q7c-torch")] == ["SEGMENT_COMPILED"]
    assert "SEGMENT_FALLBACK" not in [e["code"] for e in jrecorder.events("q7c-jax")]
