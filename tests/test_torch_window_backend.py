"""The window operators' backend choice through the port against the JAX
package: ``"backend": "numpy"`` (or ``device.enabled = False``) keeps the
tumbling and sliding windows' state in the host dict store and closes
synchronously, in the reference's emission order; collected aggregates
(array_agg, COUNT(DISTINCT)) run there; a numeric uint64 group-by key rides
the single-device store as a max lane. Rows are compared in emission order,
exactly, unless a test says otherwise."""

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import Engine
from arroyo_tpu_torch.engine import run_graph as torch_run_graph
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator
from test_torch_q7 import build_q7, oracle_q7
from test_tumbling import expected_counts

JAX = (jbatch, jexpr, jgraph)
TORCH = (tbatch, texpr, tgraph)
# the same batching in both packages: the host store's emission order is
# its dict's insertion order, which follows the batches (so no coalescing,
# whose time-based flushes would make the batches depend on the machine)
SETTINGS = {"pipeline.source-batch-size": 1024, "device.batch-capacity": 1024,
            "device.table-capacity": 8192, "worker.queue-size": 2048,
            "engine.coalesce.enabled": False}


@pytest.fixture(autouse=True)
def _configs():
    tcfg.reset()
    tcfg.update(SETTINGS)
    jcfg.update(SETTINGS)
    yield
    tcfg.reset()


def with_backend(gr, backend):
    """The graph with ``backend`` set on its window node."""
    gr.nodes["agg"].config["backend"] = backend
    return gr


def _py(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_py(x) for x in v)
    return v.item() if hasattr(v, "item") else v


def rows_of(rows, names):
    """Every emitted row as a tuple of the named columns, in emission order
    (collected lists as tuples): ``rows`` holds batches (a columnar sink) or
    row dicts."""
    out = []
    for b in rows:
        if isinstance(b, dict):
            out.append(tuple(_py(b[n]) for n in names))
            continue
        cols = [b[n] for n in names]
        out.extend(tuple(_py(c[i]) for c in cols) for i in range(len(cols[0])))
    return out


Q7_COLS = ["window_start", "auction", "max_price", "bids"]


def run_both(build, job, **kw):
    jrows, trows = [], []
    jax_run_graph(build(JAX, jrows), job_id=f"{job}-jax", **kw)
    eng = Engine(build(TORCH, trows), job_id=f"{job}-torch", device="cpu")
    eng.run_to_completion()
    return jrows, trows, eng


def test_q7_numpy_backend_emits_the_reference_rows_in_its_order():
    """ROADMAP C1's reproduction: q7 at 30,000 events, table 8192, batch
    1024, the window on the host store. (ROADMAP quotes the first rows of
    a run with coalescing on, whose time-based flushes make the order
    depend on the machine; with it off the order is the data's.)"""
    events = 30_000
    jrows, trows, eng = run_both(
        lambda g, rows: with_backend(build_q7(g, rows, events), "numpy"), "q7-numpy")
    got, want = rows_of(trows, Q7_COLS), rows_of(jrows, Q7_COLS)
    assert len(want) == 2767
    assert got == want
    assert {(w, a): (m, c) for w, a, m, c in got} == oracle_q7(events)
    agg = eng.tasks[("agg", 0)].operator._agg
    assert isinstance(agg, SlotAggregator) and agg.backend == "numpy"


def test_device_disabled_takes_the_host_store():
    tcfg.update({"device.enabled": False})
    jcfg.update({"device.enabled": False})
    events = 12_000
    jrows, trows, eng = run_both(lambda g, rows: build_q7(g, rows, events), "q7-nodev")
    assert rows_of(trows, Q7_COLS) == rows_of(jrows, Q7_COLS)
    assert eng.tasks[("agg", 0)].operator.backend == "numpy"


def test_mesh_devices_with_numpy_backend_stays_on_the_host():
    """device.mesh-devices > 1 shards only the "jax" backend (reference
    windows/tumbling.py:195)."""
    tcfg.update({"device.mesh-devices": 8})
    jcfg.update({"device.mesh-devices": 8})
    events = 12_000
    jrows, trows, eng = run_both(
        lambda g, rows: with_backend(build_q7(g, rows, events), "numpy"), "q7-mesh-numpy")
    assert rows_of(trows, Q7_COLS) == rows_of(jrows, Q7_COLS)
    agg = eng.tasks[("agg", 0)].operator._agg
    assert isinstance(agg, SlotAggregator) and agg.backend == "numpy"


def sliding_graph(g, rows, events, backend):
    """bench.py's q5 (bids -> sliding 10 s / 2 s COUNT per auction)."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": events, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    gr.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("auction", E.Col("bid.auction")), ("price", E.Col("bid.price"))],
        "filter": E.Col("bid")}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": E.Col(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {"keys": [("auction", E.Col("auction"))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.SLIDING_AGGREGATE, {
        "width_micros": 10_000_000, "slide_micros": 2_000_000, "key_fields": ["auction"],
        "aggregates": [("bids", "count", None), ("top", "max", E.Col("price"))],
        "input_dtype_of": lambda e: np.dtype(np.int64), "backend": backend}, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": True}, 1))
    for a, b, t in [("src", "bids", "f"), ("bids", "wm", "f"), ("wm", "key", "f"),
                    ("key", "agg", "s"), ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def test_sliding_numpy_backend_emits_the_reference_rows_in_its_order():
    events = 30_000
    jrows, trows, eng = run_both(lambda g, rows: sliding_graph(g, rows, events, "numpy"),
                                 "q5-numpy")
    cols = ["window_start", "auction", "bids", "top"]
    got = rows_of(trows, cols)
    assert got == rows_of(jrows, cols)
    assert sum(c for _w, _a, c, _t in got) == 5 * events * 46 // 50
    assert eng.tasks[("agg", 0)].operator._agg.backend == "numpy"


def count_graph(g, rows, backend, count=1000, width=1_000_000, aggregates=None, modulus=7):
    """tests/test_tumbling.py's windowed_count_graph: impulse (1 ms apart)
    -> watermark -> key(counter % modulus) -> tumbling -> vec."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "impulse", "message_count": count, "interval_micros": 1000,
        "start_time_micros": 0}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(B.TIMESTAMP_FIELD)}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {
        "keys": [("k", E.BinOp("%", E.Col("counter"), E.Lit(modulus)))]}, 1))
    cfg = {"width_micros": width, "key_fields": ["k"],
           "aggregates": aggregates or [("cnt", "count", None),
                                        ("total", "sum", E.Col("counter"))],
           "input_dtype_of": lambda e: np.dtype(np.int64)}
    if backend is not None:
        cfg["backend"] = backend
    gr.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, cfg, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def counts_of(rows, width=1_000_000):
    out = {}
    for r in rows:
        key = (int(r["window_start"]) // width, int(r["k"]))
        assert key not in out, "a window was emitted twice"
        out[key] = (int(r["cnt"]), int(r["total"]))
    return out


@pytest.mark.parametrize("backend", ["jax", "numpy"])
def test_uint64_key_lane_on_the_single_device_store(backend):
    """ROADMAP C2: the key counter % 7 is uint64 and rides the store as a
    max lane; with device.mesh-devices 0 the store is the SlotAggregator
    (K1-K3's plain versions here). The JAX package emits expected_counts."""
    rows = []
    eng = Engine(count_graph(TORCH, rows, backend), job_id=f"c2-{backend}", device="cpu")
    eng.run_to_completion()
    assert counts_of(rows) == expected_counts()
    op = eng.tasks[("agg", 0)].operator
    assert op.acc_dtypes[-1] == np.dtype(np.uint64)
    assert isinstance(op._agg, SlotAggregator) and op._agg.backend == backend


COLLECT = [("vals", "collect", "counter"), ("n_distinct", "count_distinct", "bucket"),
           ("cnt", "count", None)]


def collect_aggregates(E, only_collect=False):
    aggs = [(n, k, None if c is None else (E.BinOp("%", E.Col("counter"), E.Lit(5))
                                           if c == "bucket" else E.Col(c)))
            for n, k, c in COLLECT]
    return [a for a in aggs if a[1] != "count"] if only_collect else aggs


@pytest.mark.parametrize("only_collect", [False, True], ids=["with_count", "collect_only"])
def test_collected_aggregates_on_the_host_store(only_collect):
    """array_agg and COUNT(DISTINCT) in a tumbling window (backend
    "numpy", as the JAX package's planner sets it), keys 0..12 over 100 ms
    windows; with no numeric lane a hidden count tracks the groups."""
    names = ["window_start", "k", "vals", "n_distinct"] + ([] if only_collect else ["cnt"])

    def build(g, rows):
        return count_graph(g, rows, "numpy", count=500, width=100_000, modulus=13,
                           aggregates=collect_aggregates(g[1], only_collect))

    jrows, trows, _eng = run_both(build, f"collect-{only_collect}")
    got = rows_of(trows, names)
    assert got == rows_of(jrows, names)
    assert len(got) == 500 // 100 * 13
    for ws, k, vals, nd, *rest in got:
        assert all(v % 13 == k and ws <= v * 1000 < ws + 100_000 for v in vals)
        assert nd == len({v % 5 for v in vals})
        if rest:
            assert rest[0] == len(vals)


def test_collect_with_jax_backend_fails_as_in_the_reference():
    """A collected aggregate on backend "jax" (which the planner never
    produces) fails at the first close in both packages: the collecting
    store is synchronous and has no extract_start."""
    errors = []
    for pkg, run in ((JAX, lambda g: jax_run_graph(g, job_id="collect-jax-jax")),
                     (TORCH, lambda g: torch_run_graph(g, job_id="collect-jax-torch",
                                                       device="cpu"))):
        with pytest.raises(Exception) as info:
            run(count_graph(pkg, [], "jax", count=300, width=100_000,
                            aggregates=collect_aggregates(pkg[1])))
        errors.append(info.value)
    assert all("extract_start" in str(e) for e in errors), errors


def test_sliding_window_refuses_collected_aggregates():
    from arroyo_tpu_torch.windows.sliding import SlidingAggregate

    with pytest.raises(NotImplementedError, match="collected aggregates"):
        SlidingAggregate({"width_micros": 10, "slide_micros": 5, "backend": "numpy",
                          "aggregates": [("v", "collect", texpr.Col("x"))]})
