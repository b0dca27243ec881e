"""The port's task metrics (arroyo_tpu_torch/metrics.py) against
arroyo_tpu/metrics.py on the CPU: histogram quantiles and their '>' clamp
flag, the bucket tuples, ``merge_job_metrics`` / ``job_profile`` on the same
snapshots, the emit-size and queue-transit histograms, and one keyed SQL
job run through both packages: per-operator row counters, late rows, state
rows, hot keys and the set of Prometheus series (labels kept, values taken
out) held equal. Times are held only to be positive."""

from __future__ import annotations

import json

import numpy as np
import pytest

import arroyo_tpu.config as jcfg
import arroyo_tpu.metrics as jmetrics
import arroyo_tpu_torch.config as tcfg
import arroyo_tpu_torch.metrics as tmetrics
from arroyo_tpu.obs.profile import job_profile as jjob_profile
from arroyo_tpu_torch.obs.profile import job_profile as tjob_profile

BUCKETS = ["EMIT_ROWS_BUCKETS", "TRANSIT_BUCKETS", "SINK_LATENCY_BUCKETS", "PHASE_BUCKETS"]


@pytest.fixture(autouse=True)
def _port_config(tmp_path):
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "torch-ck")})
    yield
    tcfg.reset()


# ------------------------------------------------------------- histograms


def test_bucket_tuples_and_names_equal_the_jax_packages():
    for name in BUCKETS + ["CHECKPOINT_PHASES", "SELF_TIME_CATEGORIES", "_COUNTER_NAMES",
                           "_HISTOGRAM_NAMES"]:
        assert getattr(tmetrics, name) == getattr(jmetrics, name), name
    assert tmetrics.TaskMetrics.__slots__[:-1] == jmetrics.TaskMetrics.__slots__


def test_histogram_quantile_clamps_overflow():
    h = tmetrics.Histogram((1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 100.0, 200.0, 300.0):
        h.observe(v)
    assert h.quantile(0.99) == 4.0
    assert h.quantile_str(0.99) == ">4.00"
    assert h.quantile_str(0.99, scale=1000, precision=1) == ">4000.0"
    assert h.quantile(0.2) == 1.0 and h.quantile_str(0.2) == "1.00"
    empty = tmetrics.Histogram((1.0,))
    assert empty.quantile(0.99) == 0.0 and empty.quantile_str(0.99) == "0.00"


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_equal_the_jax_packages(buckets, seed):
    rng = np.random.default_rng(seed)
    b = getattr(tmetrics, buckets)
    vals = rng.lognormal(np.log(b[len(b) // 2]), 3.0, 500)
    t, j = tmetrics.Histogram(b), jmetrics.Histogram(b)
    for v in vals:
        t.observe(float(v))
        j.observe(float(v))
    assert (t.counts, t.count, t.sum, t.mean()) == (j.counts, j.count, j.sum, j.mean())
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert t._quantile(q) == j._quantile(q)
        assert t.quantile_str(q, scale=1000, precision=3) == \
            j.quantile_str(q, scale=1000, precision=3)


# --------------------------------------------------- snapshot merging


def _snap(sub, sent, hot):
    return {"op": {"per_subtask": {sub: {
        "arroyo_worker_messages_sent": sent,
        "arroyo_worker_messages_recv": 3 * sent,
        "backpressure": 0.5 if sub == "1" else 0.1,
        "watermark_lag_seconds": 2.0 if sub == "1" else None,
        "queue_transit_p99_ms": 7.5,
        "self_time": {"process": 0.25 * sent, "tick": 0.0},
        "self_cpu": {"process": 0.2 * sent},
        "busy_pct": 10.0 + sent,
        "late_rows": sent // 3,
        "state_rows": {"t": sent}, "state_bytes": {"t": 8 * sent},
        "hot_keys": hot, "sketch_total": 400,
        "segment_compiled": sub == "0",
    }}}}


HOT1 = [{"key": "00000000000000aa", "count": 100, "error": 0, "share": 0.5}]
HOT2 = [{"key": "00000000000000aa", "count": 60, "error": 5, "share": 0.3},
        {"key": "00000000000000bb", "count": 40, "error": 0, "share": 0.2}]


def test_merge_job_metrics_and_job_profile_equal_the_jax_packages():
    snaps = [_snap("0", 10, HOT1), _snap("1", 32, HOT2)]
    merged = tmetrics.merge_job_metrics(snaps)
    assert merged == jmetrics.merge_job_metrics(snaps)
    m = merged["op"]
    assert m["subtasks"] == 2 and m["arroyo_worker_messages_sent"] == 42
    assert m["backpressure"] == 0.5 and m["watermark_lag_seconds"] == 2.0
    assert m["hot_keys"][0] == {"key": "00000000000000aa", "count": 160, "error": 5,
                                "share": 0.2}
    # identical snapshots collapse by label instead of double-counting
    again = tmetrics.merge_job_metrics([_snap("0", 10, HOT1), _snap("0", 10, HOT1)])
    assert again["op"]["arroyo_worker_messages_sent"] == 10
    assert tjob_profile(merged) == jjob_profile(merged)
    legacy = [{"op": {"arroyo_worker_messages_sent": 5}}, None, {"op": "bad"}]
    assert tmetrics.merge_job_metrics(legacy) == jmetrics.merge_job_metrics(legacy)


def test_rate_tracker_equals_the_jax_packages():
    t, j = tmetrics.RateTracker(window_s=10.0), jmetrics.RateTracker(window_s=10.0)
    for i, v in enumerate([0, 10, 25, 25, 60, 100]):
        t.observe("k", v, now=i * 3.0)
        j.observe("k", v, now=i * 3.0)
    assert t.rate("k") == j.rate("k") > 0
    assert t.rate("missing") == 0.0
    t.reset()
    assert t.rate("k") == 0.0


def test_emit_and_transit_histograms_exported():
    from arroyo_tpu_torch.batch import Batch
    from arroyo_tpu_torch.engine.queues import TaskInbox
    from arroyo_tpu_torch.graph import EdgeType
    from arroyo_tpu_torch.operators.collector import Collector, OutEdge

    tcfg.update({"engine.coalesce.max-rows": 4})
    dest = TaskInbox(1, 100)
    col = Collector([OutEdge(EdgeType.FORWARD, [dest], [0])], 0)
    tm = tmetrics.registry.task("co-job-torch", "op", 0)
    col.metrics = tm
    col.collect(Batch({"x": np.arange(5, dtype=np.int64)}))
    assert tm.emit_batch_rows.count == 1 and tm.emit_batch_rows.sum == 5
    assert tm.counters["arroyo_worker_messages_sent"] == 5
    inbox = TaskInbox(1, 100)
    inbox.metrics = tm
    inbox.put(0, Batch({"x": np.arange(3, dtype=np.int64)}))
    inbox.get(timeout=1)
    assert tm.queue_transit.count == 1 and tm.queue_transit.sum >= 0
    text = tmetrics.registry.prometheus_text()
    assert "arroyo_worker_emit_batch_rows_bucket" in text
    assert "arroyo_worker_queue_transit_seconds_count" in text
    tmetrics.registry.clear_job("co-job-torch")
    assert "co-job-torch" not in tmetrics.registry.prometheus_text()


def test_registry_job_gauges_and_bad_records_export():
    """The setters a control plane feeds, and the families they export:
    the same lines in both packages."""
    texts = []
    for reg in (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()):
        reg.set_job_health("gj", "degraded")
        reg.set_autoscaler_target("gj", 4)
        reg.set_fleet_stats({"pool_slots": 8, "slots_used": 3, "slots_free": 5,
                             "target_workers": 2, "queue_depth": {'te"n': 1}})
        reg.add_bad_record("gj", "src", 3)
        reg.observe_segment_compile("gj", 0.5)
        reg.add_segment_cache_hit("gj")
        reg.observe_epoch_phases("gj", {"align": 0.2, "snapshot": 1.1, "ack": 0.01,
                                        "commit": 0.002, "other": 9.0})
        assert reg.segment_compile_stats("gj") == (1, 1)
        assert set(reg.phase_histograms("gj")) == {"align", "snapshot", "ack", "commit"}
        texts.append([l for l in reg.prometheus_text().splitlines()
                      if "gj" in l or "fleet" in l])
    assert texts[0] == texts[1]
    assert 'arroyo_job_health{job="gj",state="degraded"} 1' in texts[0]
    assert 'arroyo_fleet_queue_depth{tenant="te\\"n"} 1' in texts[0]


# ------------------------------------------------------ one job, both packages


def keyed_sql(path, out, n=4000, keys=7, late=0):
    """A keyed tumbling count over JSON lines (k, x, _timestamp), written to
    a JSON sink; ``late`` stragglers at event time 0 follow the stream."""
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"k": f"u{i % keys}", "x": i, "_timestamp": i * 1000}) + "\n")
        for i in range(late):
            f.write(json.dumps({"k": "u0", "x": i, "_timestamp": 0}) + "\n")
    return f"""
    CREATE TABLE t (k TEXT, x BIGINT) WITH (connector='single_file',
      path='{path}', format='json', type='source');
    CREATE TABLE o (k TEXT, n BIGINT) WITH (connector='single_file',
      path='{out}', format='json', type='sink');
    INSERT INTO o SELECT k, n FROM (
      SELECT k, count(*) AS n, tumble(interval '1 second') AS w FROM t GROUP BY k, w) x;
    """


def run_both(tmp_path, job, **kw):
    """Run keyed_sql through both packages; returns their job_metrics and
    their registries' Prometheus text."""
    from arroyo_tpu.engine.engine import run_graph as jrun
    from arroyo_tpu.sql import plan_query as jplan
    from arroyo_tpu_torch.engine import run_graph as trun
    from arroyo_tpu_torch.sql import plan_query as tplan

    out = {}
    for pkg, plan, run, reg in (("jax", jplan, jrun, jmetrics.registry),
                                ("torch", tplan, trun, tmetrics.registry)):
        name = f"{job}-{pkg}"
        reg.clear_job(name)
        sql = keyed_sql(str(tmp_path / "in.json"), str(tmp_path / f"out-{pkg}.json"), **kw)
        graph = plan(sql).graph
        if pkg == "torch":
            run(graph, job_id=name, device="cpu", timeout=120)
        else:
            run(graph, job_id=name, timeout=120)
        out[pkg] = (reg.job_metrics(name), reg.prometheus_text())
    return out


def series(text: str, job: str) -> set:
    """The job's series lines with their values taken out and the job label
    made package-neutral."""
    return {line.rsplit(" ", 1)[0].replace(f'job="{job}"', 'job="J"')
            for line in text.splitlines()
            if not line.startswith("#") and f'job="{job}"' in line}


def test_operator_counters_late_and_state_rows_equal_the_jax_packages(tmp_path):
    got = run_both(tmp_path, "met", late=50)
    jm, tm = got["jax"][0], got["torch"][0]
    assert set(tm) == set(jm)
    for op in jm:
        for k in ("arroyo_worker_messages_recv", "arroyo_worker_messages_sent",
                  "arroyo_worker_bytes_recv", "late_rows", "state_rows", "hot_keys",
                  "sketch_total", "subtasks", "segment_compiled", "mesh"):
            assert tm[op].get(k) == jm[op].get(k), (op, k)
        assert tm[op]["per_subtask"]["0"]["uptime_seconds"] > 0
    agg = next(op for op in tm if "tumbling" in op)
    assert tm[agg]["late_rows"] == 50
    assert tm[agg]["self_time"]["process"] > 0 and tm[agg]["busy_pct"] > 0
    assert tm[agg]["hot_keys"][0]["share"] == pytest.approx(1 / 7, abs=0.02)
    sink = next(op for op in tm if op.startswith("sink"))
    assert tm[sink]["sink_event_latency_p99_s"] > 0
    assert tm[sink]["watermark_lag_seconds"] > 0
    assert tm[agg]["sink_event_latency_p99_s"] is None
    src = next(op for op in tm if op.startswith("source"))
    assert tm[src]["arroyo_worker_messages_sent"] == 4050


def test_prometheus_series_equal_the_jax_packages(tmp_path):
    got = run_both(tmp_path, "prom")
    js = series(got["jax"][1], "prom-jax")
    ts = series(got["torch"][1], "prom-torch")
    assert ts == js
    families = {s.split("{", 1)[0] for s in ts}
    assert {"arroyo_worker_messages_recv", "arroyo_worker_watermark_lag_seconds",
            "arroyo_worker_self_time_seconds", "arroyo_state_rows",
            "arroyo_worker_sink_event_latency_seconds_bucket",
            "arroyo_worker_queue_transit_seconds_count",
            "arroyo_worker_emit_batch_rows_sum"} <= families


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_q7c_families_are_chip_smokes(pkg, tmp_path):
    """chip_smoke's obs phase holds the card's q7c exposition to the set of
    families the JAX package exports for a q7c job whose segment built
    afresh; both packages export exactly that set on the CPU."""
    import chip_smoke
    from test_torch_checkpoint_queries import MODULES
    from test_torch_q7 import build_q7

    over = {"pipeline.chaining.enabled": True, "segment.compile.min-rows": 0,
            "pipeline.source-batch-size": 4096, "device.batch-capacity": 4096,
            "worker.queue-size": 8192}
    job = f"fam-q7c-{pkg}"
    if pkg == "jax":
        from arroyo_tpu.engine.engine import run_graph
        from arroyo_tpu.engine.segment import segment_cache

        jcfg.update({**over, "checkpoint.storage-url": str(tmp_path / "j")})
        segment_cache.clear()
        reg = jmetrics.registry
        reg.clear_job(job)
        run_graph(build_q7(MODULES[pkg], [], 100_000), job_id=job)
    else:
        from arroyo_tpu_torch.engine import run_graph
        from arroyo_tpu_torch.engine.segment import segment_cache

        tcfg.update({**over, "device.table-capacity": 8192})
        segment_cache.clear()
        reg = tmetrics.registry
        reg.clear_job(job)
        run_graph(build_q7(MODULES[pkg], [], 100_000), job_id=job, device="cpu")
    fams = {line.split("{", 1)[0] for line in reg.prometheus_text().splitlines()
            if not line.startswith("#") and f'job="{job}"' in line}
    assert fams == chip_smoke.OBS_Q7C_FAMILIES
    compiles, hits = reg.segment_compile_stats(job)
    assert compiles >= 1 and hits == 0
    reg.clear_job(job)
