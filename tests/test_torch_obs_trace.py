"""The port's epoch tracing (arroyo_tpu_torch/obs/trace.py, wired into
engine/engine.py) against arroyo_tpu's on the CPU: q7 gated at a fixed poll
through both packages records the same (event, node, subtask) set for its
epoch; the span tree, its phase durations, the Chrome trace export and the
timeline report; ``checkpoint_timeline`` read from the recorder; the phase
histograms a durable epoch feeds; and a checkpoint that times out carries
the report naming the stuck subtask. Times are held only to be ordered and
non-negative."""

from __future__ import annotations

import json

import pytest

import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu.engine.engine import Engine as JEngine
from arroyo_tpu.obs import trace as jtrace
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.metrics import registry as tregistry
from arroyo_tpu_torch.obs import trace as ttrace
from test_torch_checkpoint_queries import MODULES
from test_torch_q7 import build_q7

EVENTS, BATCH = 40_000, 2048


@pytest.fixture(autouse=True)
def _port_config(tmp_path):
    tcfg.reset()
    over = {"pipeline.source-batch-size": BATCH, "device.batch-capacity": BATCH,
            "worker.queue-size": 2 * BATCH}
    tcfg.update({**over, "device.table-capacity": 8192,
                 "checkpoint.storage-url": str(tmp_path / "torch-ck"),
                 "storage.retry.base-delay-ms": 0})
    jcfg.update({**over, "checkpoint.file-format": "npz"})
    tfaults.clear()
    yield
    tfaults.clear()
    tcfg.reset()


def _engine(pkg, job, url, parallelism=2):
    g = build_q7(MODULES[pkg], [], EVENTS, agg_parallelism=parallelism)
    if pkg == "torch":
        return TEngine(g, job_id=job, device="cpu", storage_url=url)
    return JEngine(g, job_id=job, storage_url=url)


def _epoch_one(pkg, job, url):
    """q7 with its source held at poll 6: epoch 1 there, then to the end."""
    eng = _engine(pkg, job, url)
    gate = chip_smoke.gate_source(eng, 6)
    eng.start()
    assert gate.reached.wait(60)
    assert eng.checkpoint_and_wait(1, timeout=60)
    eng.join(timeout=120)
    return eng


def _spans(events):
    return sorted((e["event"], e["node"] or "", -1 if e["subtask"] is None else e["subtask"])
                  for e in events)


def test_epoch_span_set_equals_the_jax_packages(tmp_path):
    tregistry.clear_job("trace-q7")
    teng = _epoch_one("torch", "trace-q7", str(tmp_path / "t"))
    jtrace.recorder.clear_job("trace-q7")
    _epoch_one("jax", "trace-q7", str(tmp_path / "j"))
    tev = ttrace.recorder.events("trace-q7", 1)
    jev = jtrace.recorder.events("trace-q7", 1)
    assert _spans(tev) == _spans(jev)
    kinds = {e["event"] for e in tev}
    assert {"trigger", "align_start", "snapshot_start", "ack", "metadata_durable",
            "commit_delivered"} <= kinds
    acked = {(e["node"], e["subtask"]) for e in tev if e["event"] == "ack"}
    assert acked == set(teng.tasks)
    for node, sub in teng.tasks:
        ev = {e["event"]: e["t_us"] for e in tev if (e["node"], e["subtask"]) == (node, sub)}
        if node != "src":
            assert ev["align_start"] <= ev["snapshot_start"] <= ev["ack"]
    # checkpoint_timeline reads the same spans: every task, in ms after the trigger
    tl = teng.checkpoint_timeline(1)
    assert set(tl["tasks"]) == {f"{n}/{s}" for n, s in teng.tasks}
    assert tl["durable_ms"] >= max(t["acked"] for t in tl["tasks"].values()) >= 0
    assert all(set(t) <= {"started_alignment", "started_checkpointing", "acked"}
               and "acked" in t for t in tl["tasks"].values())
    assert teng.checkpoint_timeline(7) == {}
    # the durable epoch fed the checkpoint phase histograms
    hists = tregistry.phase_histograms("trace-q7")
    assert set(hists) == {"align", "snapshot", "ack", "commit"}
    assert all(h.count == 1 and h.sum >= 0 for h in hists.values())
    assert 'arroyo_checkpoint_phase_seconds_count{job="trace-q7",phase="snapshot"} 1' \
        in tregistry.prometheus_text()
    tregistry.clear_job("trace-q7")


def test_span_tree_phases_chrome_trace_and_report(tmp_path):
    _epoch_one("torch", "trace-export", str(tmp_path / "t"))
    events = ttrace.recorder.events("trace-export", 1)
    phases = ttrace.phase_durations(events)
    assert set(phases) == {"align", "snapshot", "ack", "commit"}
    assert all(v >= 0 for v in phases.values())
    assert ttrace.dominant_phase(phases) in phases
    assert phases == jtrace.phase_durations(events)
    chrome = ttrace.chrome_trace("trace-export", {1: events})
    assert chrome == jtrace.chrome_trace("trace-export", {1: events})
    evs = chrome["traceEvents"]
    assert any(e["name"] == "epoch 1" and e["ph"] == "X" for e in evs)
    assert any(e["tid"] == "agg/1" and e["name"] == "snapshot" for e in evs)
    assert all(e["ph"] in ("X", "i") for e in evs)
    json.dumps(chrome)
    report = ttrace.timeline_report("trace-export", 1, events)
    assert report == jtrace.timeline_report("trace-export", 1, events)
    assert "metadata_durable" in report and "dominant" in report


def test_recorder_bounds_and_dedup_equal_the_jax_packages():
    recs = [ttrace.EpochTraceRecorder(max_epochs=3, max_events_per_epoch=5),
            jtrace.EpochTraceRecorder(max_epochs=3, max_events_per_epoch=5)]
    for r in recs:
        for epoch in range(6):
            for i in range(8):
                r.record("j", epoch, "ack", node="n", subtask=i % 6, t_us=1000 * epoch + i)
        r.record("j", 5, "ack", node="n", subtask=0, t_us=1)  # duplicate: first wins
        r.ingest("j", [{"epoch": 5, "event": "trigger", "t_us": 3}])
    assert recs[0].epochs("j") == recs[1].epochs("j") == [3, 4, 5]
    assert recs[0].events("j", 5) == recs[1].events("j", 5)
    assert len(recs[0].events("j", 4)) == 5
    recs[0].clear_job("j")
    assert recs[0].epochs("j") == []


def test_checkpoint_timeout_report_names_stuck_subtask(tmp_path):
    """A worker hang after the snapshot, before the barrier goes on, wedges
    the epoch; the timeout carries the report naming the stuck subtask."""
    eng = _engine("torch", "trace-stuck", str(tmp_path / "t"), parallelism=1)
    gate = chip_smoke.gate_source(eng, 4)
    tfaults.install("worker:hang=3@barrier=1&node=agg&subtask=0", seed=3)
    eng.start()
    try:
        assert gate.reached.wait(60)
        wait = eng.checkpoint_and_wait(1, timeout=1.0)
        assert wait.outcome == "timeout" and ("agg", 0) in wait.missing
        assert "stuck:" in wait.report and "agg/0" in wait.report
        assert "snapshot started, never acked" in wait.report
        assert "sink/0: barrier never arrived" in wait.report
        assert wait.report in repr(wait)
    finally:
        tfaults.clear()
        eng.join(timeout=120)
