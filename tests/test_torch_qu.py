"""The Nexmark running aggregate per auction (chip_smoke.py's qu: bids ->
non-windowed GROUP BY auction, COUNT/SUM/AVG of price, as a changelog)
through the port's run_graph on the CPU and arroyo_tpu's on the same
graph, in device mode and host mode, with chaining off and on. With the
timed flush off (a day) the flushes follow the watermarks alone, so the
changelog is fixed by the data: it must be equal row for row across
packages and modes, TTL evictions and compactions included. With the
operator's defaults (1 s flush, 1 day TTL) the merged changelog must equal
chip_smoke's closed-form oracle exactly."""

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import run_graph as jax_run_graph
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import run_graph as torch_run_graph
from arroyo_tpu_torch.obs.events import recorder as trecorder

EVENTS = 60_000
BATCH = 8192
TTL = 12_000_000  # auctions close within seconds of each other: many evictions


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


def _configure(chaining, cap=4096):
    over = {"pipeline.source-batch-size": BATCH, "worker.queue-size": 2 * BATCH,
            "device.batch-capacity": BATCH, "device.table-capacity": cap,
            "device.region-size": 512, "pipeline.chaining.enabled": chaining,
            "segment.compile.min-rows": 0}
    tcfg.update(over)
    jcfg.update(over)


def _run_both(job, **kw):
    trows, jrows = [], []
    eng = torch_run_graph(chip_smoke.qu_graph(tbatch, texpr, tgraph, trows, EVENTS, **kw),
                          job_id=job + "-torch", device="cpu")
    jax_run_graph(chip_smoke.qu_graph(jbatch, jexpr, jgraph, jrows, EVENTS, **kw),
                  job_id=job + "-jax")
    return trows, jrows, eng


@pytest.mark.parametrize("chaining", [False, True], ids=["chaining off", "chaining on"])
@pytest.mark.parametrize("backend", ["jax", "numpy"], ids=["device mode", "host mode"])
def test_qu_changelog_matches_jax_row_for_row(chaining, backend):
    _configure(chaining)
    job = f"qu-{chaining}-{backend}"
    trows, jrows, eng = _run_both(job, backend=backend, ttl_micros=TTL,
                                  flush_interval_micros=chip_smoke.DAY_MICROS)
    got, want = chip_smoke.changelog(trows), chip_smoke.changelog(jrows)
    assert chip_smoke.same_changelog(got, want, "qu") > 1000
    chip_smoke.check_changelog(trows)
    op = eng.tasks[("agg", 0)].operator
    assert op.device_mode == (backend == "jax")
    assert op.evicted_keys > 500
    if backend == "jax":
        assert op.compactions >= 1  # a quarter of the 4096 slots died, more than once
    if chaining:
        assert "bids+wm+key" in eng.graph.nodes
        assert not trecorder.events(job + "-torch", "SEGMENT_FALLBACK")


def test_qu_device_mode_equals_host_mode_with_spill():
    """A table smaller than the live keys: the device mode spills and
    compacts, and still emits the host mode's changelog row for row."""
    _configure(True, cap=1024)
    logs, ops = {}, {}
    for backend in ("jax", "numpy"):
        rows = []
        eng = torch_run_graph(chip_smoke.build_qu(rows, EVENTS, backend=backend, ttl_micros=TTL,
                                                  flush_interval_micros=chip_smoke.DAY_MICROS),
                              job_id=f"qu-spill-{backend}", device="cpu")
        logs[backend], ops[backend] = chip_smoke.changelog(rows), eng.tasks[("agg", 0)].operator
    chip_smoke.same_changelog(logs["jax"], logs["numpy"], "qu spill")
    assert ops["jax"].spill_reads > 0 and ops["jax"].compactions > 1


def test_qu_matches_oracle_at_operator_defaults():
    _configure(True)
    trows, jrows, eng = _run_both("qu-oracle")
    want = chip_smoke.oracle_qu(EVENTS)
    assert chip_smoke.check_qu(trows, want) == chip_smoke.check_qu(jrows, want)
    assert len(want) > 1000
    op = eng.tasks[("agg", 0)].operator
    assert op.device_mode and op.evicted_keys == 0


def test_qu_oracle_counts_every_bid():
    want = chip_smoke.oracle_qu(EVENTS)
    assert sum(n for n, _s, _a in want.values()) == EVENTS * 46 // 50
    for n, s, a in list(want.values())[:50]:
        assert a == s / n
    with pytest.raises(AssertionError, match="does not match the last append"):
        chip_smoke.check_changelog([tbatch.Batch({
            "auction": np.array([1, 1]), "bids": np.array([1, 2]), "volume": np.array([5, 5]),
            "avg_price": np.array([5.0, 2.5]), "_is_retract": np.array([False, True]),
            "_timestamp": np.zeros(2, np.int64)})])


def test_qu_and_qs_chains_run_the_kernel_segment_build_compiles():
    """chip_smoke's segment_build compiles K4 for the qu and qs bids chains
    ahead of their runs; the runs bind the same plan, so the Triton build is
    a cache hit on the card (the same generated source, by digest)."""
    from arroyo_tpu_torch.engine import segment as tseg
    from arroyo_tpu_torch.ops import segment_kernel

    _configure(True)
    built = {label: segment_kernel.SegmentProgram(
        plan, [np.asarray(b[c]).dtype for c in plan.traced_in]).digest
        for label, plan, b in chip_smoke.nexmark_plans()}
    for name, build, cols in (("qu", chip_smoke.build_qu, ["bid.auction", "bid.price"]),
                              ("qs", chip_smoke.build_qs, ["bid.bidder", "bid.price"])):
        tseg.segment_cache.clear()
        torch_run_graph(build([], 20_000), job_id=f"{name}-digest", device="cpu")
        b = chip_smoke.nexmark_columns(10, cols, 1000)
        digests = [segment_kernel.SegmentProgram(
            e.plan, [np.asarray(b[c]).dtype for c in e.plan.traced_in]).digest
            for e in tseg.segment_cache._entries.values()]
        assert digests == [built[f"{name} bids chain"]]
