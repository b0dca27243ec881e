"""The port's plan-diff pass (arroyo_tpu_torch/analysis/plan_diff.py), its
evolution-mapping sidecar and the engine's plan gate, against the JAX
package's on the same hand-built graphs.

- ``plan_fingerprint`` gives the same string in both packages for every
  graph chip_smoke.py drives (q7, q7c, q5, q8, qu, qs, q7 with its window at
  parallelism 4) and for the tests' graphs, and does not move under a
  rescale;
- ``diff_plans`` gives the same classifications, AR010-AR012 diagnostics
  and mapping on old/new pairs (a widened window, a no-op filter, a removed
  aggregation, a changed sink);
- the sidecar written by either package reads back in the other;
- a restore of q7's epoch 1 under a changed graph: refused with both hashes
  named, before any task starts, without a mapping or under a widened
  window; through the ``diff_plans`` mapping (a no-op filter) the restored
  rows equal the JAX package's and the oracle."""

import shutil

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.analysis import plan_diff as jdiff
from arroyo_tpu.engine import Engine as JEngine
from arroyo_tpu.state import tables as jtables
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.analysis import plan_diff as tdiff
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.state import storage as tstorage
from arroyo_tpu_torch.state import tables as ttables
from test_torch_q5 import build_q5
from test_torch_q7 import build_q7

T = (tbatch, texpr, tgraph)
J = (jbatch, jexpr, jgraph)
MODULES = {"torch": T, "jax": J}
WIDTH = 10_000_000


@pytest.fixture(autouse=True)
def _port_state():
    tcfg.reset()
    tcfg.update({"storage.retry.base-delay-ms": 0})
    yield
    tfaults.clear()
    tstorage.reset_retry_state()
    tcfg.reset()


def q7_variant(m, rows, n, width=WIDTH, noop_filter=False, no_agg=False, sink_columnar=True,
               agg_parallelism=1):
    """bench.py's q7 over either package's modules, with the edits the
    evolution tests make: the window's width, a no-op filter in the VALUE
    node (prices are >= 0), the aggregation removed (the bids straight to
    the sink), a changed sink."""
    B, E, G = m
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    g = G.Graph()
    g.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": n, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False,
        "columns": ["bid.auction", "bid.price"]}, 1))
    filt = E.Col("bid")
    if noop_filter:
        filt = E.BinOp("and", filt, E.BinOp(">=", E.Col("bid.price"), E.Lit(0)))
    g.add_node(G.Node("bids", G.OpName.VALUE, {
        "projections": [("auction", E.Col("bid.auction")), ("price", E.Col("bid.price"))],
        "filter": filt}, 1))
    g.add_node(G.Node("sink", G.OpName.SINK, {
        "connector": "vec", "rows": rows, "columnar": sink_columnar}, 1))
    g.add_edge("src", "bids", G.EdgeType.FORWARD, S)
    if no_agg:
        g.add_edge("bids", "sink", G.EdgeType.FORWARD, S)
        return g
    g.add_node(G.Node("wm", G.OpName.WATERMARK, {
        "expr": E.Col(B.TIMESTAMP_FIELD), "interval_micros": 1_000_000}, 1))
    g.add_node(G.Node("key", G.OpName.KEY, {"keys": [("auction", E.Col("auction"))]}, 1))
    g.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
        "width_micros": width, "key_fields": ["auction"],
        "aggregates": [("max_price", "max", E.Col("price")), ("bids", "count", None)],
        "input_dtype_of": lambda e: np.dtype(np.int64)}, agg_parallelism))
    for a, b, t in [("bids", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        g.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return g


# chip_smoke.py's graphs (the port's, as it builds them) beside the JAX
# package's of the same configuration
SMOKE_GRAPHS = {
    "q7": (lambda rows: chip_smoke.build_q7(rows, 1000),
           lambda rows: build_q7(J, rows, 1000)),
    "q7 at parallelism 4": (lambda rows: chip_smoke.build_q7(rows, 1000, parallelism=4),
                            lambda rows: build_q7(J, rows, 1000, agg_parallelism=4)),
    "q5": (lambda rows: chip_smoke.build_q5(rows, 1000), lambda rows: build_q5(J, rows, 1000)),
    "q8": (lambda rows: chip_smoke.build_q8(rows, 1000),
           lambda rows: chip_smoke.q8_graph(*J, rows, 1000)),
    "qu": (lambda rows: chip_smoke.build_qu(rows, 1000),
           lambda rows: chip_smoke.qu_graph(*J, rows, 1000)),
    "qs": (lambda rows: chip_smoke.build_qs(rows, 1000),
           lambda rows: chip_smoke.qs_graph(*J, rows, 1000)),
}


@pytest.mark.parametrize("name", list(SMOKE_GRAPHS))
def test_fingerprint_equals_the_jax_packages_on_chip_smokes_graphs(name):
    """q7c is q7's graph (chaining rewrites it inside the engine, after the
    fingerprint is taken)."""
    tb, jb = SMOKE_GRAPHS[name]
    fp = tdiff.plan_fingerprint(tb([]))
    assert fp and fp == jdiff.plan_fingerprint(jb([]))
    # every node's identity, its declared tables included, is the JAX one's
    for nid, node in tb([]).nodes.items():
        t, j = tdiff.node_identity(node), jdiff.node_identity(jb([]).nodes[nid])
        assert t.specs is not None, f"{nid}: the port's constructor failed on the CPU"
        assert t.identity == j.identity, nid


TEST_GRAPHS = {
    "q7 test graph": lambda m: build_q7(m, [], 60_000),
    "q5 test graph": lambda m: build_q5(m, [], 60_000),
    "q8 test graph": lambda m: chip_smoke.q8_graph(*m, [], 250_000),
    "qu host mode": lambda m: chip_smoke.qu_graph(*m, [], 60_000, backend="numpy",
                                                  flush_interval_micros=chip_smoke.DAY_MICROS),
    "widened window": lambda m: q7_variant(m, [], 1000, width=2 * WIDTH),
    "no-op filter": lambda m: q7_variant(m, [], 1000, noop_filter=True),
    "no aggregation": lambda m: q7_variant(m, [], 1000, no_agg=True),
    "changed sink": lambda m: q7_variant(m, [], 1000, sink_columnar=False),
}


@pytest.mark.parametrize("name", list(TEST_GRAPHS))
def test_fingerprint_equals_the_jax_packages_on_the_tests_graphs(name):
    t, j = TEST_GRAPHS[name](T), TEST_GRAPHS[name](J)
    assert tdiff.plan_fingerprint(t) == jdiff.plan_fingerprint(j)


def test_fingerprint_is_rescale_invariant_and_sensitive_to_state():
    base = tdiff.plan_fingerprint(q7_variant(T, [], 1000))
    assert tdiff.plan_fingerprint(q7_variant(T, [], 1000, agg_parallelism=4)) == base
    assert tdiff.plan_fingerprint(q7_variant(T, [], 1000)) == base  # a rebuild
    for kw in ({"width": 2 * WIDTH}, {"noop_filter": True}, {"no_agg": True},
               {"sink_columnar": False}):
        assert tdiff.plan_fingerprint(q7_variant(T, [], 1000, **kw)) != base, kw
    # a sink list that already holds rows hashes differently in both
    # packages (the list is part of the config): restores take fresh lists
    held = tdiff.plan_fingerprint(q7_variant(T, [1], 1000))
    assert held != base
    assert held == jdiff.plan_fingerprint(q7_variant(J, [1], 1000))


def _diff_json(d):
    return ([c.to_json() for c in d.classifications], [x.to_dict() for x in d.diagnostics],
            d.mapping, d.rejected)


EVOLUTIONS = {
    "identical": {},
    "widened window": {"width": 2 * WIDTH},
    "no-op filter": {"noop_filter": True},
    "removed aggregation": {"no_agg": True},
    "changed sink": {"sink_columnar": False},
    "rescaled window": {"agg_parallelism": 4},
}


@pytest.mark.parametrize("evolution", list(EVOLUTIONS))
def test_diff_plans_equals_the_jax_packages(evolution):
    kw = EVOLUTIONS[evolution]
    t = tdiff.diff_plans(q7_variant(T, [], 1000), q7_variant(T, [], 1000, **kw))
    j = jdiff.diff_plans(q7_variant(J, [], 1000), q7_variant(J, [], 1000, **kw))
    assert _diff_json(t) == _diff_json(j)
    by = {c.node_id: c for c in t.classifications}
    rules = {d.rule_id for d in t.diagnostics}
    if evolution == "widened window":
        assert t.rejected and rules == {"AR010"} and by["agg"].action == "incompatible"
    elif evolution == "removed aggregation":
        assert not t.rejected and rules == {"AR012"} and "agg" in t.mapping["dropped"]
    elif evolution == "changed sink":
        # the vec sink declares no table: it is stateless, the window carried
        assert not t.rejected and not rules and by["sink"].action == "stateless"
        assert by["agg"].action == "carried"
    else:
        assert not t.rejected and not rules
        assert t.mapping["nodes"]["agg"] == {"action": "carried", "from": "agg",
                                             "tables": ["e", "t"]}
    if evolution in ("identical", "rescaled window"):
        assert t.mapping["old_plan_hash"] == t.mapping["new_plan_hash"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_evolution_sidecar_round_trips_across_the_packages(writer, tmp_path):
    url = str(tmp_path / "ck")
    mapping = tdiff.diff_plans(q7_variant(T, [], 1000),
                               q7_variant(T, [], 1000, noop_filter=True)).mapping
    write = ttables.write_evolution_mapping if writer == "torch" else \
        jtables.write_evolution_mapping
    path = write(url, "job-x", 3, mapping)
    assert path == ttables.evolution_mapping_path(url, "job-x", 3) == \
        jtables.evolution_mapping_path(url, "job-x", 3)
    assert ttables.read_evolution_mapping(url, "job-x", 3) == mapping
    assert jtables.read_evolution_mapping(url, "job-x", 3) == mapping
    assert ttables.read_evolution_mapping(url, "job-x", 4) is None
    # a corrupt sidecar reads as none in both
    with open(path, "r+") as f:
        text = f.read()
        f.seek(0)
        f.write(text.replace("carried", "carriez"))
    assert ttables.read_evolution_mapping(url, "job-x", 3) is None
    assert jtables.read_evolution_mapping(url, "job-x", 3) is None


# --------------------------------------------------- the gate, end to end

EVENTS, BATCH, POLLS = 60_000, 2048, 15


def _configure():
    over = {"pipeline.source-batch-size": BATCH, "device.batch-capacity": BATCH,
            "worker.queue-size": 2 * BATCH, "pipeline.chaining.enabled": True,
            "segment.compile.min-rows": 0}
    tcfg.update({**over, "device.table-capacity": 8192, "storage.retry.base-delay-ms": 0})
    jcfg.update({**over, "checkpoint.file-format": "npz"})


def _engine(pkg, g, url, **kw):
    if pkg == "torch":
        return TEngine(g, job_id="evolve", device="cpu", storage_url=url, **kw)
    return JEngine(g, job_id="evolve", storage_url=url, **kw)


@pytest.fixture(scope="module")
def epoch1(tmp_path_factory):
    """q7's epoch 1 at the gated poll, written by the port, and the first
    run's rows."""
    tcfg.reset()
    _configure()
    url = str(tmp_path_factory.mktemp("evolve") / "ck")
    rows: list = []
    eng = _engine("torch", q7_variant(T, rows, EVENTS), url)
    gate = chip_smoke.gate_source(eng, POLLS)
    eng.start()
    assert gate.reached.wait(120)
    assert eng.checkpoint_and_wait(1, timeout=120, then_stop=True)
    eng.stop()
    eng.join(timeout=120)
    tcfg.reset()
    return url, rows


def _copy(epoch1, tmp_path):
    url = str(tmp_path / "ck")
    shutil.copytree(epoch1[0], url)
    return url


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_restore_under_a_changed_plan_without_a_mapping_is_refused(pkg, epoch1, tmp_path):
    _configure()
    url = _copy(epoch1, tmp_path)
    meta = ttables.read_job_checkpoint_metadata(url, "evolve", 1)
    assert meta["plan_hash"] == tdiff.plan_fingerprint(q7_variant(T, [], EVENTS))
    for kw in ({"width": 2 * WIDTH}, {"noop_filter": True}):
        rows: list = []
        eng = _engine(pkg, q7_variant(MODULES[pkg], rows, EVENTS, **kw), url, restore_epoch=1)
        new_hash = (tdiff if pkg == "torch" else jdiff).plan_fingerprint(
            q7_variant(MODULES[pkg], [], EVENTS, **kw))
        with pytest.raises(RuntimeError) as err:
            eng.build()
        assert meta["plan_hash"] in str(err.value) and new_hash in str(err.value)
        assert "no evolution mapping" in str(err.value)
        assert not any(t.thread for t in eng.tasks.values())
        assert rows == []


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_restore_through_the_diff_plans_mapping_carries_the_state(pkg, epoch1, tmp_path):
    """The no-op filter: diff_plans carries the window; with the mapping
    written the restore runs, the rows equal the oracle and the JAX
    package's restore of the same epoch, and the evolve_cutover site fires
    at the evolved plan's first epoch (here the end-of-data one, none: the
    job drains)."""
    _configure()
    url = _copy(epoch1, tmp_path)
    diff = tdiff.diff_plans(q7_variant(T, [], EVENTS), q7_variant(T, [], EVENTS,
                                                                   noop_filter=True))
    assert {c.node_id: c.action for c in diff.classifications}["agg"] == "carried"
    ttables.write_evolution_mapping(url, "evolve", 1, diff.mapping)
    rows: list = []
    eng = _engine(pkg, q7_variant(MODULES[pkg], rows, EVENTS, noop_filter=True), url,
                  restore_epoch=1)
    eng.run_to_completion(timeout=300)
    assert eng.evolution_mapping == diff.mapping
    want = chip_smoke.oracle_q7(EVENTS)
    chip_smoke.check_q7(epoch1[1] + rows, want)


def test_a_mapping_for_another_plan_pair_is_refused(epoch1, tmp_path):
    _configure()
    url = _copy(epoch1, tmp_path)
    wrong = tdiff.diff_plans(q7_variant(T, [], EVENTS),
                             q7_variant(T, [], EVENTS, sink_columnar=False)).mapping
    ttables.write_evolution_mapping(url, "evolve", 1, wrong)
    eng = _engine("torch", q7_variant(T, [], EVENTS, noop_filter=True), url, restore_epoch=1)
    with pytest.raises(RuntimeError, match="different plan pair"):
        eng.build()


def test_evolve_cutover_crash_fails_the_job_after_the_marker(epoch1, tmp_path):
    """The evolved plan's first durable epoch fires evolve_cutover after its
    marker: a crash there fails the job loudly; the epoch stays restorable
    under its own hash, with no mapping."""
    _configure()
    url = _copy(epoch1, tmp_path)
    new = lambda rows: q7_variant(T, rows, EVENTS, noop_filter=True)  # noqa: E731
    ttables.write_evolution_mapping(url, "evolve", 1, tdiff.diff_plans(
        q7_variant(T, [], EVENTS), new([])).mapping)
    tfaults.install("evolve_cutover:crash@epoch=2")
    eng = _engine("torch", new([]), url, restore_epoch=1)
    gate = chip_smoke.gate_source(eng, 3)
    eng.start()
    assert gate.reached.wait(120)
    with pytest.raises(RuntimeError, match="evolve cutover"):
        eng.checkpoint_and_wait(2, timeout=120)
    with pytest.raises(RuntimeError):
        eng.join(timeout=120)
    assert ttables.read_job_checkpoint_metadata(url, "evolve", 2)["plan_hash"] == \
        tdiff.plan_fingerprint(new([]))
    tfaults.clear()
    rows: list = []
    _engine("torch", new(rows), url, restore_epoch=2).run_to_completion(timeout=300)
    assert rows


def test_a_plan_fingerprint_that_fails_is_reported(monkeypatch, caplog, tmp_path):
    """Where plan_fingerprint raises, the engine stamps no hash, as the JAX
    engine, and says so: a warning names the job, its nodes and the error,
    since that job's checkpoints will not be held to its plan."""
    def broken(graph):
        raise ValueError("a broken operator constructor")

    monkeypatch.setattr(tdiff, "plan_fingerprint", broken)
    with caplog.at_level("WARNING", logger="arroyo_tpu_torch.engine"):
        eng = TEngine(q7_variant(T, [], EVENTS), job_id="unstamped", device="cpu",
                      storage_url=str(tmp_path / "ck"))
    assert eng.plan_hash is None
    said = [r.getMessage() for r in caplog.records if r.name == "arroyo_tpu_torch.engine"]
    assert len(said) == 1
    assert "'unstamped'" in said[0] and "agg" in said[0]
    assert "ValueError: a broken operator constructor" in said[0]
