"""The window operators in mesh mode through the port (device.mesh-devices
= 8: a ShardedAggregator of 8 key shards on one device, the CPU here)
against the JAX package's on its 8 emulated CPU devices: tumbling and
sliding windows through run_graph emit the same rows in the same order,
equal to closed-form oracles; a skewed operator's spill residency raises
the same MESH_OVERFLOW event and mesh_stats as the JAX package's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu.hashing import hash_column
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import run_graph as torch_run_graph

pytestmark = pytest.mark.mesh

# tests/test_mesh_operator.py's _mesh_cfg
MESH = {"device.mesh-devices": 8, "device.table-capacity": 1024,
        "device.batch-capacity": 256, "device.emit-capacity": 256,
        "device.spill-capacity": 256, "device.max-probes": 32,
        "pipeline.source-batch-size": 512}


@pytest.fixture(autouse=True)
def _mesh_cfg():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")
    tcfg.reset()
    tcfg.update(MESH)
    jcfg.update(MESH)
    yield
    tcfg.reset()


def tumbling_graph(g, rows, count, width=1_000_000):
    """impulse -> watermark -> key(counter % 7) -> tumbling COUNT + SUM ->
    vec (tests/test_tumbling.py windowed_count_graph)."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "impulse", "message_count": count, "interval_micros": 1000,
        "start_time_micros": 0}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(B.TIMESTAMP_FIELD)}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {
        "keys": [("k", E.BinOp("%", E.Col("counter"), E.Lit(7)))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
        "width_micros": width, "key_fields": ["k"],
        "aggregates": [("cnt", "count", None), ("total", "sum", E.Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def sliding_graph(g, rows, count, n_keys=5):
    """tests/test_mesh_operator.py's sliding graph: 1 s windows every
    250 ms, COUNT per counter % n_keys."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "impulse", "message_count": count, "interval_micros": 1000,
        "start_time_micros": 0}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(B.TIMESTAMP_FIELD)}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {
        "keys": [("k", E.BinOp("%", E.Col("counter"), E.Lit(n_keys)))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.SLIDING_AGGREGATE, {
        "width_micros": 1_000_000, "slide_micros": 250_000, "key_fields": ["k"],
        "aggregates": [("cnt", "count", None), ("top", "max", E.Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def _both(build, job):
    jrows, trows = [], []
    jax_run_graph(build((jbatch, jexpr, jgraph), jrows), job_id=f"{job}-jax", timeout=300)
    torch_run_graph(build((tbatch, texpr, tgraph), trows), job_id=f"{job}-torch",
                    device="cpu", timeout=300)
    return jrows, trows


@pytest.mark.parametrize("chaining", [False, True])
def test_mesh_tumbling_matches_jax_and_oracle(chaining):
    count = 3000
    tcfg.update({"pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 1})
    jcfg.update({"pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 1})
    jrows, trows = _both(lambda g, rows: tumbling_graph(g, rows, count), f"mesh-tw-{chaining}")
    key = lambda r: (r["window_start"], r["k"], r["cnt"], r["total"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    want: dict = {}
    for c in range(count):
        w, k = (c * 1000) // 1_000_000, c % 7
        cnt, tot = want.get((w, k), (0, 0))
        want[(w, k)] = (cnt + 1, tot + c)
    assert {(r["window_start"] // 1_000_000, r["k"]): (r["cnt"], r["total"])
            for r in trows} == want


@pytest.mark.parametrize("chaining", [False, True])
def test_mesh_sliding_matches_jax_and_oracle(chaining):
    """Each slide bin is one synchronous sharded close (K11) when the
    watermark completes it; the windows combine the cached bins."""
    count = 4000
    tcfg.update({"pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 1})
    jcfg.update({"pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 1})
    jrows, trows = _both(lambda g, rows: sliding_graph(g, rows, count), f"mesh-sl-{chaining}")
    key = lambda r: (r["window_start"], r["k"], r["cnt"], r["top"])  # noqa: E731
    assert [key(r) for r in trows] == [key(r) for r in jrows]
    want: dict = {}
    for c in range(count):
        sb = (c * 1000 // 250_000) * 250_000
        for j in range(4):
            w = (sb - j * 250_000, c % 5)
            cnt, top = want.get(w, (0, -1))
            want[w] = (cnt + 1, max(top, c))
    assert {(r["window_start"], r["k"]): (r["cnt"], r["top"]) for r in trows} == want


def _skewed_batches(B, n_batches=3, rows=2048):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n_batches):
        raw = rng.integers(0, 3000, rows).astype(np.int64)
        ts = (i * rows + np.arange(rows)).astype(np.int64) * 10
        out.append(B.Batch({"v": raw, B.TIMESTAMP_FIELD: ts,
                            B.KEY_FIELD: hash_column(raw)}))
    return out


class _Sink:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)

    def broadcast(self, sig):
        pass


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
def test_mesh_overflow_event_and_mesh_stats_match_jax(window):
    """More groups than an 8-shard table of 64 slots places in two probes:
    rows park in the spill buffers. The store's snapshot (what a checkpoint
    takes) refreshes the residency, mesh_stats reports it and
    record_mesh_overflow fires MESH_OVERFLOW once per doubling, as in the
    JAX package."""
    from arroyo_tpu.obs.events import recorder as jrec
    from arroyo_tpu.types import TaskInfo as JTaskInfo
    from arroyo_tpu.windows.sliding import SlidingAggregate as JSliding
    from arroyo_tpu.windows.tumbling import TumblingAggregate as JTumbling
    from arroyo_tpu.windows.tumbling import record_mesh_overflow as j_record
    from arroyo_tpu_torch.obs.events import recorder as trec
    from arroyo_tpu_torch.operators.base import OperatorContext
    from arroyo_tpu_torch.types import TaskInfo as TTaskInfo
    from arroyo_tpu_torch.windows.sliding import SlidingAggregate as TSliding
    from arroyo_tpu_torch.windows.tumbling import TumblingAggregate as TTumbling
    from arroyo_tpu_torch.windows.tumbling import record_mesh_overflow as t_record

    small = {"device.table-capacity": 64, "device.max-probes": 2,
             "device.spill-capacity": 4096, "device.batch-capacity": 512}
    tcfg.update(small)
    jcfg.update(small)

    def cfg(E):
        return {"width_micros": 10_000_000, "slide_micros": 5_000_000, "key_fields": [],
                "aggregates": [("n", "count", None), ("s", "sum", E.Col("v"))],
                "input_dtype_of": lambda e: np.dtype(np.int64)}

    jcls, tcls = (JTumbling, TTumbling) if window == "tumbling" else (JSliding, TSliding)
    jop, top = jcls(cfg(jexpr)), tcls(cfg(texpr))
    job = f"ovf-{window}"

    class JCtx:
        task_info = JTaskInfo(job + "-jax", "agg", "agg", 0, 1)

    tctx = OperatorContext(TTaskInfo(job + "-torch", "agg", "agg", 0, 1), torch.device("cpu"))
    top.on_start(tctx)
    jsink, tsink = _Sink(), _Sink()
    trec.clear_job(job + "-torch")
    jrec.clear_job(job + "-jax")
    for jb, tb in zip(_skewed_batches(jbatch), _skewed_batches(tbatch)):
        jop.process_batch(jb, JCtx(), jsink)
        top.process_batch(tb, tctx, tsink)
        jsnap = jop._agg.snapshot()
        j_record(jop, JCtx())
        tsnap = top._agg.snapshot()
        t_record(top, tctx)
        for a, b in zip(jsnap[:2] + tuple(jsnap[2]), tsnap[:2] + tuple(tsnap[2])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert top.mesh_stats() == jop.mesh_stats()
    assert top.mesh_stats()["overflow_rows"] > 0
    tev = trec.events(job + "-torch", "MESH_OVERFLOW")
    jev = [e for e in jrec.events(job + "-jax") if e["code"] == "MESH_OVERFLOW"]
    assert len(tev) == len(jev) >= 1
    assert [e["data"] for e in tev] == [e["data"] for e in jev]
