"""The port's cost attribution (arroyo_tpu_torch/obs/profile.py and
obs/sketch.py) against arroyo_tpu's on the CPU: the key-skew sketch fed the
same keys gives the same summary and the same pickled ``__sketch`` entry;
a keyed SQL job gives the same hot keys across replays, after a checkpoint
and restore, and with the checkpoint written by one package and restored by
the other, in both directions; the state gauges, the chain's and the join's
hooks, the per-job profile and its EXPLAIN ANALYZE rendering; and the
profiler off leaves no surface."""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import arroyo_tpu.config as jcfg
import arroyo_tpu.metrics as jmetrics
import arroyo_tpu_torch.config as tcfg
import arroyo_tpu_torch.metrics as tmetrics
import chip_smoke
from arroyo_tpu.obs import profile as jprofile
from arroyo_tpu.obs.sketch import KeySketch as JSketch
from arroyo_tpu.obs.sketch import merge_topk as jmerge_topk
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Batch
from arroyo_tpu_torch.obs import profile as tprofile
from arroyo_tpu_torch.obs.sketch import KeySketch, merge_topk
from test_torch_metrics import HOT1, HOT2, _snap, keyed_sql


@pytest.fixture(autouse=True)
def _port_config(tmp_path):
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "torch-ck")})
    yield
    tcfg.reset()


# ------------------------------------------------------------- sketch unit


def _feed(sk, keys, chunk):
    for lo in range(0, len(keys), chunk):
        sk.observe(keys[lo:lo + chunk])
    return sk


@pytest.mark.parametrize("capacity,sample_every,seed", [(64, 1, 0), (8, 1, 3), (16, 3, 2)])
def test_sketch_state_equals_the_jax_packages(capacity, sample_every, seed):
    rng = np.random.default_rng(seed)
    cold = rng.integers(1000, 100_000, size=20_000, dtype=np.uint64)
    hot = np.full(5_000, 42, dtype=np.uint64)
    keys = np.concatenate([cold, hot])
    rng.shuffle(keys)
    t = _feed(KeySketch(capacity, sample_every, seed=seed), keys, 997)
    j = _feed(JSketch(capacity, sample_every, seed=seed), keys, 997)
    assert t.state() == j.state()
    # the __sketch table's entry pickles to the same bytes
    assert pickle.dumps({0: t.state()}) == pickle.dumps({0: j.state()})
    assert t.topk(10) == j.topk(10)
    if sample_every == 1:
        top = t.topk(1)[0]
        assert top["key"] == 42 and top["count"] - top["error"] <= 5_000 <= top["count"]


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_eviction_ties_and_high_keys_equal_the_jax_packages(seed):
    """Eviction under many equal counts (ties broken by key) and keys above
    2**63: the same survivors, threshold and errors, in the same order."""
    rng = np.random.default_rng(seed)
    t, j = KeySketch(capacity=16), JSketch(capacity=16)
    for _ in range(40):
        keys = rng.integers(2**63 - 50, 2**63 + 50, 300, dtype=np.uint64)
        keys[:20] = rng.integers(0, 2**64 - 1, 20, dtype=np.uint64)
        t.observe(keys)
        j.observe(keys)
        assert pickle.dumps(t.state()) == pickle.dumps(j.state())
    assert t.threshold > 0 and t.errors


@pytest.mark.parametrize("capacity,sample_every,seed", [(1, 1, 0), (3, 2, 1), (8, 1, 2),
                                                      (64, 1, 3)])
def test_sketch_random_feeds_and_merges_equal_the_jax_packages(capacity, sample_every, seed):
    """Random batches, empty ones, skewed ones and merges of other summaries,
    step by step: the same state, pickled to the same bytes."""
    rng = np.random.default_rng(seed)
    t = KeySketch(capacity, sample_every, seed=seed)
    j = JSketch(capacity, sample_every, seed=seed)
    for step in range(60):
        if step % 7 == 6:
            other = rng.integers(0, 40, 200, dtype=np.uint64)
            ot, oj = KeySketch(capacity), JSketch(capacity)
            ot.observe(other)
            oj.observe(other)
            t.merge_state(ot.state())
            j.merge_state(oj.state())
        else:
            n = int(rng.integers(0, 400))
            keys = rng.zipf(1.3, n).astype(np.uint64) if step % 2 else \
                rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
            t.observe(keys)
            j.observe(keys)
        assert pickle.dumps(t.state()) == pickle.dumps(j.state()), step


def test_sketch_batch_boundary_invariance():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=10_000, dtype=np.uint64)
    a = _feed(KeySketch(capacity=64), keys, len(keys))
    b = _feed(KeySketch(capacity=64), keys, 137)
    assert a.topk(10) == b.topk(10)
    assert a.total == b.total == 10_000


def test_sketch_merge_state_equals_the_jax_packages():
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 30, size=2_000, dtype=np.uint64) for _ in range(3)]
    t, j = KeySketch(capacity=8), JSketch(capacity=8)
    for p in parts:
        for mine, Other in ((t, KeySketch), (j, JSketch)):
            other = Other(capacity=8)
            other.observe(p)
            mine.merge_state(other.state())
    assert t.state() == j.state()
    restored = KeySketch(capacity=64)
    restored.merge_state(JSketch(capacity=64).state())
    fresh = KeySketch(capacity=64, seed=5)
    fresh.merge_state({**t.state(), "tick": 11})
    assert fresh._tick == 11  # a fresh sketch resumes the persisted phase


def test_merge_topk_equals_the_jax_packages():
    for k in (1, 2, 8):
        assert merge_topk([HOT1, HOT2], total=400, k=k) == \
            jmerge_topk([HOT1, HOT2], total=400, k=k)
    merged = merge_topk([HOT1, HOT2], total=400, k=2)
    assert merged[0] == {"key": "00000000000000aa", "count": 160, "error": 5, "share": 0.4}


# -------------------------------------------------------- engine integration


def _engine(pkg, sql, job, url, **kw):
    from arroyo_tpu.engine.engine import Engine as JEngine
    from arroyo_tpu.sql import plan_query as jplan
    from arroyo_tpu_torch.engine import Engine as TEngine
    from arroyo_tpu_torch.sql import plan_query as tplan

    if pkg == "torch":
        return TEngine(tplan(sql).graph, job_id=job, device="cpu", storage_url=url, **kw)
    return JEngine(jplan(sql).graph, job_id=job, storage_url=url, **kw)


REG = {"torch": tmetrics.registry, "jax": jmetrics.registry}


def _hot(pkg, job):
    jm = REG[pkg].job_metrics(job)
    agg = next(op for op in jm if "tumbling" in op)
    return jm[agg]["hot_keys"], jm[agg]["sketch_total"]


def _uninterrupted(pkg, sql, job, url):
    REG[pkg].clear_job(job)
    _engine(pkg, sql, job, url).run_to_completion(timeout=120)
    return _hot(pkg, job)


@pytest.fixture
def keyed(tmp_path):
    jcfg.update({"checkpoint.file-format": "parquet"})
    sql = keyed_sql(str(tmp_path / "in.json"), str(tmp_path / "out.json"), n=6000, keys=11)
    tcfg.update({"pipeline.source-batch-size": 512})
    jcfg.update({"pipeline.source-batch-size": 512})
    return sql


def test_hot_keys_identical_across_replays_and_packages(keyed, tmp_path):
    got = [_uninterrupted(pkg, keyed, "prof-replay", str(tmp_path / f"ck{i}"))
           for i, pkg in enumerate(("torch", "torch", "jax"))]
    assert got[0] == got[1] == got[2]
    assert got[0][1] == 6000 and len(got[0][0]) == 5


@pytest.mark.parametrize("first,second", [("torch", "torch"), ("jax", "torch"),
                                          ("torch", "jax")])
def test_sketch_resumes_across_checkpoint_restore(first, second, keyed, tmp_path):
    """A run checkpointed at a fixed poll, then restored (by either package)
    to the end, ends with the hot keys of an uninterrupted run: the
    ``__sketch`` table carries the summary across, byte-compatible."""
    want = _uninterrupted("torch", keyed, "prof-whole", str(tmp_path / "whole"))
    url = str(tmp_path / "ck")
    job = "prof-ckpt"
    REG[first].clear_job(job)
    eng = _engine(first, keyed, job, url)
    chip_smoke.run_gated_epochs(eng, (4,), timeout=120)
    assert _hot(first, job)[1] < 6000  # the barrier landed mid-stream
    REG[second].clear_job(job)
    _engine(second, keyed, job, url, restore_epoch=1).run_to_completion(timeout=120)
    assert _hot(second, job) == want


def test_state_gauges_match_total_rows_ground_truth(tmp_path):
    from arroyo_tpu_torch.operators.base import Operator
    from arroyo_tpu_torch.state.tables import TableManager
    from arroyo_tpu_torch.types import TaskInfo

    ti = TaskInfo("gauge-job", "op", "value", 0, 1)
    tm = TableManager(ti, str(tmp_path / "ck"))
    exp = tm.expiring_time_key("t", retention_micros=10**9)
    for n in (500, 250):
        exp.insert(Batch({TIMESTAMP_FIELD: np.arange(n, dtype=np.int64),
                          "x": np.arange(n, dtype=np.int64)}))
    g = tm.global_keyed("offsets")
    for i in range(10):
        g.insert(i, {"pos": i})
    tm.global_keyed(tprofile.SKETCH_TABLE).insert(0, {"total": 1})
    tmetrics.registry.clear_job("gauge-job")
    m = tmetrics.registry.task("gauge-job", "op", 0)
    prof = tprofile.TaskProfiler(m, Operator(), tm)
    prof.refresh(force=True)
    assert m.state_rows["t"] == exp.total_rows() == 750
    assert m.state_bytes["t"] == sum(b.nbytes() for b in exp.batches) > 0
    assert m.state_rows["offsets"] == 10 and m.state_bytes["offsets"] > 0
    assert tprofile.SKETCH_TABLE not in m.state_rows  # bookkeeping, not state
    tmetrics.registry.clear_job("gauge-job")


def test_join_side_store_gauges_and_expiry_late_rows():
    from arroyo_tpu_torch.operators.joins import JoinWithExpiration
    from arroyo_tpu_torch.types import Watermark

    op = JoinWithExpiration({"join_type": "inner", "left_names": [("lx", "lx")],
                             "right_names": [("rx", "rx")], "ttl_micros": 1000})
    keys = np.arange(100, dtype=np.uint64)
    op.stores[0].append(keys.view(np.int64), np.zeros(100, dtype=np.int64),
                        [np.arange(100).astype(object)], np.zeros(100, dtype=np.int64), False)
    sizes = op.state_sizes()
    assert sizes["left"][0] == 100 and sizes["left"][1] > 0 and sizes["right"][0] == 0
    assert op.spill_stats() is None  # spilling off
    assert op.handle_watermark(Watermark.event_time(10_000), None, None) is not None
    assert op.late_rows == 100 and op.state_sizes()["left"][0] == 0
    assert tprofile.late_rows_of(op) == 100


def test_chained_operator_aggregates_members():
    from arroyo_tpu_torch.operators.chained import ChainedOperator
    from arroyo_tpu_torch.state.spill import PROBE_FILES_BUCKETS

    class _M:
        late_rows = 3

        def state_sizes(self):
            return {"t": (5, 80)}

        def spill_stats(self):
            h = tmetrics.Histogram(PROBE_FILES_BUCKETS)
            h.observe(2)
            return {"bytes_total": 100, "hot": 1, "cold": 2, "probe_files": h}

    chain = ChainedOperator.__new__(ChainedOperator)
    chain.members = [_M(), _M()]
    assert chain.late_rows == 6
    assert chain.state_sizes() == {"c0.t": (5, 80), "c1.t": (5, 80)}
    st = chain.spill_stats()
    assert (st["bytes_total"], st["hot"], st["cold"], st["probe_files"].count) == (200, 2, 4, 2)


def test_updating_aggregate_hooks_equal_the_jax_packages():
    """The host-mode updating aggregate's live state gauge and its spill
    block (None with spilling off), fed the same batch in both packages."""
    from arroyo_tpu.batch import KEY_FIELD as JKEY
    from arroyo_tpu.batch import Batch as JBatch
    from arroyo_tpu.operators.updating_aggregate import UpdatingAggregate as JUpd
    from arroyo_tpu_torch.batch import KEY_FIELD
    from arroyo_tpu_torch.operators.updating_aggregate import UpdatingAggregate

    cfg = {"key_fields": [], "aggregates": [("n", "count", None)], "backend": "numpy"}
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 40, 300).astype(np.uint64)
    ts = np.arange(300, dtype=np.int64)
    out = []
    for Op, B, K in ((UpdatingAggregate, Batch, KEY_FIELD), (JUpd, JBatch, JKEY)):
        op = Op(dict(cfg))
        if Op is UpdatingAggregate:
            op.device = torch.device("cpu")
        op.process_batch(B({K: keys, TIMESTAMP_FIELD: ts}), None, None)
        out.append((op.state_sizes()["s"][0], op.spill_stats()))
    assert out[0] == out[1] == (40, None)


# ------------------------------------------------------ profile + explain


def test_job_profile_and_render_explain_equal_the_jax_packages(tmp_path):
    from arroyo_tpu_torch.sql import plan_query

    merged = tmetrics.merge_job_metrics([_snap("0", 10, HOT1), _snap("1", 32, HOT2)])
    pp = plan_query(keyed_sql(str(tmp_path / "in.json"), str(tmp_path / "o.json"), n=10))
    agg = next(n for n in pp.graph.nodes if "tumbling" in n)
    merged = {agg: merged["op"], "not-in-plan": merged["op"]}
    prof = tprofile.job_profile(merged)
    assert prof == jprofile.job_profile(merged)
    nodes = [{"id": n.node_id, "op": n.op.value, "description": n.description or n.op.value,
              "parallelism": n.parallelism} for n in pp.graph.nodes.values()]
    edges = [{"src": e.src, "dst": e.dst} for e in pp.graph.edges]
    job = {"id": "prof-view", "state": "Finished"}
    text = tprofile.render_explain(nodes, edges, prof, job)
    assert text == jprofile.render_explain(nodes, edges, prof, job)
    assert "EXPLAIN ANALYZE job prof-view" in text
    assert text.index("sink") < text.index("source")
    assert "[compiled] busy" in text and "hot keys:" in text and "state:" in text
    assert "-> not-in-plan [not in plan]" in text


def test_profile_disabled_zero_surface(keyed, tmp_path):
    tcfg.update({"profile.enabled": False})
    tmetrics.registry.clear_job("prof-off")
    _engine("torch", keyed, "prof-off", str(tmp_path / "ck")).run_to_completion(timeout=120)
    jm = tmetrics.registry.job_metrics("prof-off")
    agg = next(op for op in jm if "tumbling" in op)
    assert sum(jm[agg]["self_time"].values()) == 0
    assert "hot_keys" not in jm[agg] and jm[agg]["busy_pct"] == 0
    assert jm[agg]["arroyo_worker_messages_recv"] == 6000
    tmetrics.registry.clear_job("prof-off")
