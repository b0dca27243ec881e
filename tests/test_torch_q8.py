"""Nexmark q8 (bench.py's auctions JOIN bids per tumbling 10 s window,
events 100 us apart) through the port's run_graph on the CPU against
arroyo_tpu's run_graph on the same graph and against chip_smoke.py's copy
of bench.py's oracle_q8, exactly: with chaining off and on, through the
join's host gate and with the device path forced (the port's plain K5/K6
on the CPU, the reference's jitted probe)."""

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
from arroyo_tpu_torch.metrics import registry as tregistry
from arroyo_tpu_torch.obs.events import recorder as trecorder

EVENTS = 300_000  # three 10 s windows of 100,000 events
BATCH = 16384

_ORACLE = {}


def oracle():
    if EVENTS not in _ORACLE:
        _ORACLE[EVENTS] = chip_smoke.oracle_q8(EVENTS)
    return _ORACLE[EVENTS]


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


def columns(rows):
    names = ["id", "bid_auction", "_timestamp", "_key"]
    return {n: np.concatenate([np.asarray(b[n]) for b in rows]) for n in names}


@pytest.mark.parametrize("chaining", [False, True], ids=["chaining off", "chaining on"])
@pytest.mark.parametrize("gate", ["host", "device"])
def test_q8_matches_jax_and_oracle(chaining, gate):
    overrides = {"pipeline.source-batch-size": BATCH, "worker.queue-size": BATCH,
                 "pipeline.chaining.enabled": chaining, "segment.compile.min-rows": 0}
    if gate == "device":
        overrides.update({"device.force-device-join": True, "device.join-min-rows": 0})
    tcfg.update(overrides)
    jcfg.update(overrides)
    job = f"q8-{chaining}-{gate}"
    trows, jrows = [], []
    eng = torch_run_graph(chip_smoke.q8_graph(tbatch, texpr, tgraph, trows, EVENTS),
                          job_id=job + "-torch", device="cpu")
    jax_run_graph(chip_smoke.q8_graph(jbatch, jexpr, jgraph, jrows, EVENTS), job_id=job + "-jax")
    got, want = columns(trows), columns(jrows)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert chip_smoke.check_q8(trows, oracle()) == len(want["id"]) > 0
    if chaining:
        assert {"auctions+akey", "bids+bkey"} <= set(eng.graph.nodes)
        assert not trecorder.events(job + "-torch", "SEGMENT_FALLBACK")
        batches = -(-EVENTS // BATCH)
        assert tregistry.task(job + "-torch", "bids+bkey", 0).segment_batches == batches


def test_q8_windows_and_probe_count_follow_the_generator():
    """The counts chip_smoke's q8c phase holds K5/K6 to: the windows whose
    sides both hold rows and one holds >= device.join-min-rows."""
    sides = chip_smoke.q8_window_sides(EVENTS)
    assert sorted(sides) == [0, 10_000_000, 20_000_000]
    for a, b in sides.values():
        assert a == 6000 and b == 92_000  # 3 and 46 of every 50 events
    assert len({w for w, _id in oracle()}) == 3


def test_q8_chains_take_the_kernel_on_the_same_batches_as_jax(monkeypatch):
    """bench.py's q8 setting (500,000 events, batch 65536, queue 1 x batch,
    chaining on, segment.compile.min-rows 8192): per chain, which batches
    run through the compiled segment and how many rows survive its hoisted
    filter, batch for batch in both packages. The auctions chain keeps
    about 6% of each batch: its first batch runs compiled (build and
    verification), the other seven run interpreted, one short of the
    cost latch's eight; the bids chain runs every batch compiled."""
    from arroyo_tpu.engine import segment as jseg
    from arroyo_tpu_torch.engine import segment as tseg

    events, batch = 500_000, 65536
    seen = {"jax": {}, "port": {}}
    for mod, tag in ((jseg, "jax"), (tseg, "port")):
        # a fresh process-wide segment cache, as at the start of a run: a
        # cache hit skips the first batch's build and verification
        mod.segment_cache.clear()
        def execute(self, b, *a, _orig=mod.CompiledSegment.execute, _tag=tag, **kw):
            r = _orig(self, b, *a, **kw)
            seen[_tag].setdefault(tuple(self.plan.traced_in), []).append(
                (b.num_rows, kw.get("min_rows", 0), None if r is None else r["n"]))
            return r

        monkeypatch.setattr(mod.CompiledSegment, "execute", execute)
    overrides = {"pipeline.source-batch-size": batch, "device.batch-capacity": batch,
                 "worker.queue-size": batch, "pipeline.chaining.enabled": True}
    tcfg.update(overrides)
    jcfg.update(overrides)
    want = chip_smoke.oracle_q8(events)
    trows, jrows = [], []
    torch_run_graph(chip_smoke.q8_graph(tbatch, texpr, tgraph, trows, events),
                    job_id="q8-latch-torch", device="cpu")
    jax_run_graph(chip_smoke.q8_graph(jbatch, jexpr, jgraph, jrows, events), job_id="q8-latch-jax")
    assert chip_smoke.check_q8(trows, want) == chip_smoke.check_q8(jrows, want)
    assert seen["port"] == seen["jax"]
    auctions = seen["port"][("_timestamp", "auction.id")]
    assert [r[2] is not None for r in auctions] == [True] + [False] * 7
    assert all(r[2] is not None for r in seen["port"][("_timestamp", "bid", "bid.auction")])
    assert tregistry.task("q8-latch-torch", "auctions+akey", 0).segment_batches == 1
    assert tregistry.task("q8-latch-torch", "bids+bkey", 0).segment_batches == 8
