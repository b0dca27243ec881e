"""The fused mesh step through the port (arroyo_tpu_torch run_graph on the
CPU, 8 key shards on one device) against the JAX package's shard_map'd
program on its 8 emulated CPU devices: bench.py's --mesh-ab pipeline and
q7, with mesh fusion on and off. The rows emitted are equal in order, to
each other and to the closed-form oracles; the chain runs compiled; the
ledger reads one aggregate step per fused micro-batch with fusion on, and
only host steps with it off; the task metrics say segment_mesh."""

from __future__ import annotations

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu.engine import segment as jseg
from arroyo_tpu.parallel import sharded_agg as jsharded
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import run_graph as torch_run_graph
from arroyo_tpu_torch.engine import segment as tseg
from arroyo_tpu_torch.metrics import registry
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.parallel import sharded_agg as tsharded

from test_torch_q7 import build_q7, oracle_q7, windows

pytestmark = pytest.mark.mesh

N_DEV = 8
WIDTH = 1_000_000
N_KEYS = 7
# bench.py's --mesh-ab settings (bench.py:836-849), the source batch cut so
# a short run spans several micro-batches
MESH_AB = {"device.mesh-devices": N_DEV, "device.table-capacity": 8192,
           "device.batch-capacity": 2048, "device.emit-capacity": 4096,
           "device.spill-capacity": 4096, "device.max-probes": 32,
           "pipeline.chaining.enabled": True, "pipeline.source-batch-size": 1024,
           "engine.coalesce.max-rows": 1024, "segment.compile.min-rows": 1}


def _need_devices():
    import jax

    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


def mesh_ab_graph(g, rows, count):
    """bench.py's --mesh-ab pipeline (bench.py:853-877) over either
    package's modules: impulse -> watermark -> key (counter % 7) ->
    tumbling 1 s COUNT + SUM(counter) -> vec sink."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "impulse", "message_count": count, "interval_micros": 1000,
        "start_time_micros": 0, "event_rate": 0}, 1))
    gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(B.TIMESTAMP_FIELD)}, 1))
    gr.add_node(G.Node("key", G.OpName.KEY, {
        "keys": [("k", E.BinOp("%", E.Col("counter"), E.Lit(N_KEYS)))]}, 1))
    gr.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
        "width_micros": WIDTH, "key_fields": ["k"],
        "aggregates": [("cnt", "count", None), ("total", "sum", E.Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64), "backend": "jax"}, 1))
    gr.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def mesh_ab_oracle(count):
    want: dict = {}
    for c in range(count):
        w, k = (c * 1000) // WIDTH, c % N_KEYS
        cnt, tot = want.get((w, k), (0, 0))
        want[(w, k)] = (cnt + 1, tot + c)
    return want


def _rows_of(rows):
    return [(r["window_start"], r["k"], r["cnt"], r["total"]) for r in rows]


def _run_both(build, settings, job, fuse):
    jcfg.update({**settings, "segment.compile.mesh-fuse": fuse})
    tcfg.update({**settings, "segment.compile.mesh-fuse": fuse})
    jseg.reset_mesh_dispatch_counts()
    jsharded.reset_dispatch_counts()
    tseg.reset_mesh_dispatch_counts()
    tsharded.reset_dispatch_counts()
    jrows, trows = [], []
    jax_run_graph(build((jbatch, jexpr, jgraph), jrows), job_id=f"{job}-jax", timeout=300)
    recorder.clear_job(f"{job}-torch")
    torch_run_graph(build((tbatch, texpr, tgraph), trows), job_id=f"{job}-torch",
                    device="cpu", timeout=300)
    ledgers = {"jax": (jseg.mesh_dispatch_counts(), jsharded.dispatch_counts()),
               "torch": (tseg.mesh_dispatch_counts(), tsharded.dispatch_counts())}
    return jrows, trows, ledgers


def _assert_compiled(job, chained_prefix):
    assert recorder.events(job, "SEGMENT_COMPILED")
    assert not recorder.events(job, "SEGMENT_FALLBACK")
    metrics = registry.job_metrics(job)
    node = next(n for n in metrics if n.startswith(chained_prefix) and "+" in n)
    return metrics[node]


@pytest.mark.parametrize("fuse", [True, False])
def test_mesh_ab_pipeline_matches_jax_and_oracle(fuse):
    _need_devices()
    count = 20_000
    jrows, trows, ledgers = _run_both(
        lambda g, rows: mesh_ab_graph(g, rows, count), MESH_AB, f"mesh-ab-{fuse}", fuse)
    assert _rows_of(trows) == _rows_of(jrows)
    got = {(r["window_start"] // WIDTH, r["k"]): (r["cnt"], r["total"]) for r in trows}
    assert got == mesh_ab_oracle(count)
    (seg, agg), (jseg_c, jagg) = ledgers["torch"], ledgers["jax"]
    task = _assert_compiled(f"mesh-ab-{fuse}-torch", "wm")
    if fuse:
        assert seg["fused"] == agg["fused_steps"] > 0
        assert seg == jseg_c and agg == jagg
        assert any(m.get("segment_mesh") for m in task.values())
    else:
        assert agg["fused_steps"] == 0 and agg["host_steps"] > 0 and seg["fused"] == 0
        assert not any(m.get("segment_mesh") for m in task.values())
    assert any(m.get("mesh", {}).get("exchange_rows") == count for m in task.values())


@pytest.mark.parametrize("fuse", [True, False])
def test_q7_through_the_mesh_matches_jax_and_oracle(fuse):
    """q7 (bids -> tumbling MAX(price) + COUNT per auction) with the window
    state in 8 key shards: the chain's leading filter is hoisted to the
    host, the rest fused into the sharded step."""
    _need_devices()
    events = 30_000
    settings = {"device.mesh-devices": N_DEV, "pipeline.chaining.enabled": True,
                "pipeline.source-batch-size": 4096, "device.batch-capacity": 4096,
                "device.table-capacity": 4096, "device.emit-capacity": 2048,
                "segment.compile.min-rows": 1024, "worker.queue-size": 8192}
    jrows, trows, ledgers = _run_both(
        lambda g, rows: build_q7(g, rows, events), settings, f"q7m-{fuse}", fuse)
    assert windows(trows) == windows(jrows) == oracle_q7(events)
    assert [b["auction"].tolist() for b in trows] == [b["auction"].tolist() for b in jrows]
    (seg, agg), (jseg_c, jagg) = ledgers["torch"], ledgers["jax"]
    _assert_compiled(f"q7m-{fuse}-torch", "bids")
    if fuse:
        assert seg["fused"] == agg["fused_steps"] > 0
        assert (seg, agg) == (jseg_c, jagg)
    else:
        assert agg["fused_steps"] == 0 and agg["host_steps"] > 0


@pytest.mark.parametrize("error", ["kernel", "host"])
def test_fused_step_failure_modes(monkeypatch, error):
    """A kernel error inside the fused step (here: K8's wrapper raising the
    port's KernelError, as a failed build or launch does) fails the job and
    records no SEGMENT_FALLBACK; a failure while staging the batch, before
    the step has changed any state, leaves the batches to the host path
    with a SEGMENT_FALLBACK event (mesh: true) and the output stays exact."""
    import sys

    from arroyo_tpu_torch.ops import kernels, sharded_kernels

    count = 12_000
    tcfg.update({**MESH_AB, "segment.compile.mesh-fuse": True})
    real_sort, real_step = sharded_kernels.agg_sort_reduce, tseg._insert_step

    def failing_sort(*a, n_valid=None, **k):
        if n_valid is not None:  # the fused step's first K8 (the host step passes none)
            raise kernels.KernelError("agg_sort_reduce: CUDA error 700 at launch")
        return real_sort(*a, n_valid=n_valid, **k)

    def failing_staging(member):
        if sys._getframe(1).f_code.co_name == "_mesh_execute":
            raise ValueError("a host-side failure while staging the fused step")
        return real_step(member)

    if error == "kernel":
        monkeypatch.setattr(sharded_kernels, "agg_sort_reduce", failing_sort)
    else:
        monkeypatch.setattr(tseg, "_insert_step", failing_staging)
    job = f"mesh-fail-{error}"
    recorder.clear_job(job)
    rows: list = []
    g = mesh_ab_graph((tbatch, texpr, tgraph), rows, count)
    if error == "kernel":
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            torch_run_graph(g, job_id=job, device="cpu", timeout=300)
        assert recorder.events(job, "SEGMENT_FALLBACK") == []
        return
    torch_run_graph(g, job_id=job, device="cpu", timeout=300)
    fallbacks = recorder.events(job, "SEGMENT_FALLBACK")
    assert len(fallbacks) == 1 and fallbacks[0]["data"]["mesh"] is True
    got = {(r["window_start"] // WIDTH, r["k"]): (r["cnt"], r["total"]) for r in rows}
    assert got == mesh_ab_oracle(count)


@pytest.mark.parametrize("where", ["spill", "sort"])
def test_fused_step_error_after_it_began_fails_the_job(monkeypatch, where):
    """An error that is not a kernel's own, raised inside the fused step
    (here: the spill append after K9 has merged the batch into the table,
    as an out-of-memory error of its scratch would; or the first K8), fails
    the job as a KernelError: the step updates the table in place, so a
    re-run on the host path would count the merged rows twice. No
    SEGMENT_FALLBACK, and no row emitted before the failure is doubled."""
    import torch

    from arroyo_tpu_torch.ops import sharded_kernels

    count = 12_000
    tcfg.update({**MESH_AB, "segment.compile.mesh-fuse": True})
    real_spill, real_sort = sharded_kernels.shard_spill, sharded_kernels.agg_sort_reduce
    merged = []

    def failing_spill(*a, **k):
        if tsharded.dispatch_counts()["fused_steps"] and not merged:  # once
            merged.append(True)
            raise torch.OutOfMemoryError("CUDA out of memory (spill scratch)")
        return real_spill(*a, **k)

    def failing_sort(*a, n_valid=None, **k):
        if n_valid is not None and not merged:  # once
            merged.append(True)
            raise ValueError("a failure inside the fused step")
        return real_sort(*a, n_valid=n_valid, **k)

    if where == "spill":
        monkeypatch.setattr(sharded_kernels, "shard_spill", failing_spill)
    else:
        monkeypatch.setattr(sharded_kernels, "agg_sort_reduce", failing_sort)
    tsharded.reset_dispatch_counts()
    job = f"mesh-fail-after-{where}"
    recorder.clear_job(job)
    rows: list = []
    g = mesh_ab_graph((tbatch, texpr, tgraph), rows, count)
    with pytest.raises(RuntimeError, match="KernelError: .*fused mesh step failed"):
        torch_run_graph(g, job_id=job, device="cpu", timeout=300)
    assert merged
    assert recorder.events(job, "SEGMENT_FALLBACK") == []
    want = mesh_ab_oracle(count)
    for r in rows:
        assert (r["cnt"], r["total"]) == want[(r["window_start"] // WIDTH, r["k"])]
