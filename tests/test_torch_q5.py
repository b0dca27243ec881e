"""Nexmark q5 (bids -> sliding 10 s / 2 s COUNT per auction) with operator
chaining on, through the port's run_graph on the CPU and arroyo_tpu's
run_graph on the same graph: identical windows, both equal to bench.py's
oracle, and the port's chain ran compiled (SEGMENT_COMPILED, no
SEGMENT_FALLBACK, segment_compiled in the task metrics)."""

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import config as jcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu.obs.events import recorder as jrecorder
from arroyo_tpu_torch.engine import run_graph as torch_run_graph
from arroyo_tpu_torch.metrics import registry as tregistry
from arroyo_tpu_torch.obs.events import recorder as trecorder

EVENTS = 20_000


@pytest.fixture(autouse=True)
def _chaining_on():
    """Chaining on in both packages, every batch compiled (min-rows 0), at
    a small batch and table size."""
    tcfg.reset()
    small = {"pipeline.source-batch-size": 1024, "device.batch-capacity": 1024,
             "worker.queue-size": 2048, "pipeline.chaining.enabled": True,
             "segment.compile.min-rows": 0}
    tcfg.update({**small, "device.table-capacity": 8192})
    jcfg.update(small)
    yield
    tcfg.reset()


def build_q5(g, rows, event_count, parallelism=1):
    """bench.py's q5 graph over either package's modules."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": event_count, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False, "columns": ["bid.auction"]}, 1))
    gr.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("auction", E.Col("bid.auction"))], "filter": E.Col("bid")}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": E.Col(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {"keys": [("auction", E.Col("auction"))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.SLIDING_AGGREGATE, {
        "width_micros": chip_smoke.WIDTH, "slide_micros": chip_smoke.SLIDE,
        "key_fields": ["auction"], "aggregates": [("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, parallelism))
    gr.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": True}, 1))
    for a, b, t in [("src", "bids", "f"), ("bids", "wm", "f"), ("wm", "key", "f"),
                    ("key", "agg", "s"), ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def windows(rows):
    got = {}
    for b in rows:
        for ws, a, c in zip(np.asarray(b["window_start"]).tolist(),
                            np.asarray(b["auction"]).tolist(), np.asarray(b["bids"]).tolist()):
            assert (ws, a) not in got, "a window was emitted twice"
            got[(ws, a)] = c
    return got


def test_q5_chained_matches_jax_engine_and_oracle():
    from arroyo_tpu_torch import batch as tbatch
    from arroyo_tpu_torch import expr as texpr
    from arroyo_tpu_torch import graph as tgraph

    jrows, trows = [], []
    jax_run_graph(build_q5((jbatch, jexpr, jgraph), jrows, EVENTS), job_id="q5c-jax")
    eng = torch_run_graph(build_q5((tbatch, texpr, tgraph), trows, EVENTS), job_id="q5c-torch",
                          device="cpu")
    assert list(eng.graph.nodes) == ["src", "bids+wm+key+agg+sink"]
    got = windows(trows)
    assert got == windows(jrows)
    assert got == chip_smoke.oracle_q5(EVENTS)
    assert [e["code"] for e in trecorder.events("q5c-torch")] == ["SEGMENT_COMPILED"]
    assert [e["code"] for e in jrecorder.events("q5c-jax") if e["code"].startswith("SEGMENT")] \
        == ["SEGMENT_COMPILED"]
    per_task = tregistry.job_metrics("q5c-torch")["bids+wm+key+agg+sink"]
    assert per_task["segment_compiled"] is True
    assert {s: m.get("segment_compiled") for s, m in per_task["per_subtask"].items()} \
        == {"0": True}


def test_q5_chaining_off_matches_oracle():
    """The sliding window's interpreted path (no chain) on the same graph."""
    from arroyo_tpu_torch import batch as tbatch
    from arroyo_tpu_torch import expr as texpr
    from arroyo_tpu_torch import graph as tgraph

    tcfg.update({"pipeline.chaining.enabled": False})
    rows = []
    eng = torch_run_graph(build_q5((tbatch, texpr, tgraph), rows, EVENTS), job_id="q5-torch",
                          device="cpu")
    assert "agg" in eng.graph.nodes
    assert windows(rows) == chip_smoke.oracle_q5(EVENTS)


def test_q5_parallel_window_is_not_chained_and_matches_oracle():
    """At window parallelism 2 the keyed shuffle is a real exchange: the
    chain stops before it (bids+wm+key), and the two window subtasks still
    reproduce the oracle."""
    from arroyo_tpu_torch import batch as tbatch
    from arroyo_tpu_torch import expr as texpr
    from arroyo_tpu_torch import graph as tgraph

    rows = []
    eng = torch_run_graph(build_q5((tbatch, texpr, tgraph), rows, EVENTS, parallelism=2),
                          job_id="q5-p2", device="cpu")
    assert "bids+wm+key" in eng.graph.nodes and "agg" in eng.graph.nodes
    assert windows(rows) == chip_smoke.oracle_q5(EVENTS)
    assert [e["code"] for e in trecorder.events("q5-p2")] == ["SEGMENT_COMPILED"]
