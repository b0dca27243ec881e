"""The port's structured event log (arroyo_tpu_torch/obs/events.py) against
arroyo_tpu's on the CPU: the catalog, the bounded ring with exact totals,
the level / seq / time filters and the port's code filter, ingest and the
seq floor, rendering and trails, the traceback digest, the logging bridge,
the port's ring length and sketch constants against the JAX package's
config defaults; and, under the same fault plan through both packages'
engines, the codes and scopes of OPERATOR_PANIC (an injected crash
mid-checkpoint fails the job). COMMIT_REDELIVERED is in the catalog; the
coordinated commit path that records it comes with the controller."""

from __future__ import annotations

import logging
import re

import pytest

import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import faults as jfaults
from arroyo_tpu.engine.engine import Engine as JEngine
from arroyo_tpu.obs import events as jevents
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch import metrics as tmetrics
from arroyo_tpu_torch.metrics import registry as tregistry
from arroyo_tpu_torch.obs import events as tevents
from arroyo_tpu_torch.obs import profile as tprofile
from test_torch_checkpoint_queries import MODULES
from test_torch_q7 import build_q7

EVENTS, BATCH = 40_000, 2048
recorder = tevents.recorder


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


def test_catalog_and_levels_equal_the_jax_packages():
    # the same codes at the same default levels (the meanings speak of the
    # port's fused kernel where the JAX package's speak of jit)
    assert {c: lv for c, (lv, _m) in tevents.EVENT_CODES.items()} == \
        {c: lv for c, (lv, _m) in jevents.EVENT_CODES.items()}
    assert tevents.LEVELS == jevents.LEVELS
    for code in ("OPERATOR_PANIC", "COMMIT_REDELIVERED", "SEGMENT_COMPILED",
                 "SEGMENT_FALLBACK", "CHECKPOINT_QUARANTINED", "RESTORE_FELL_BACK",
                 "BAD_DATA_DROPPED", "SPILL_STARTED", "SPILL_FALLBACK", "MESH_OVERFLOW"):
        assert code in tevents.EVENT_CODES


@pytest.mark.parametrize("port_value,jax_key", [
    (tevents.MAX_EVENTS_PER_JOB, "obs.events.max-per-job"),
    (tprofile.SKETCH_CAPACITY, "profile.sketch.capacity"),
    (tprofile.SKETCH_SAMPLE_EVERY, "profile.sketch.sample-every"),
    (tmetrics.HOT_KEYS_TOPK, "profile.sketch.topk"),
])
def test_constants_equal_the_jax_packages_defaults(port_value, jax_key):
    assert port_value == jcfg.config().get(jax_key)


def test_event_ring_bounds_under_flood_but_counts_stay_exact(monkeypatch):
    job = "flood-job-torch"
    recorder.clear_job(job)
    monkeypatch.setattr(recorder, "max_per_job", 64)
    for i in range(500):
        recorder.record(job, "INFO", "LOG", message=f"m{i}")
    ring = recorder.events(job)
    assert len(ring) == 64
    assert [e["seq"] for e in ring] == list(range(437, 501))
    assert ring[-1]["message"] == "m499"
    assert recorder.counts_snapshot()[(job, "LOG", "INFO")] == 500
    assert recorder.last_seq(job) == 500
    assert f'arroyo_events_total{{job="{job}",code="LOG",level="INFO"}} 500' \
        in tregistry.prometheus_text()
    recorder.clear_job(job)
    assert recorder.events(job) == []
    assert all(k[0] != job for k in recorder.counts_snapshot())


def _fill(rec, job):
    rec.clear_job(job)
    rec.record(job, "DEBUG", "LOG", message="noise", t_us=100)
    rec.record(job, "ERROR", "OPERATOR_PANIC", message="div by zero", node="agg",
               subtask=1, epoch=3, data={"digest": "abc123def456"}, t_us=200)
    rec.record(job, "WARN", "RESTORE", message="restoring", epoch=2, worker=0, t_us=300)
    rec.record(job, "fatal?!", "LOG", t_us=400)


def test_event_filters_render_and_trail_equal_the_jax_packages():
    job = "filter-job-both"
    _fill(recorder, job)
    _fill(jevents.recorder, job)
    t, j = recorder, jevents.recorder
    for kw in ({}, {"level": "WARN"}, {"after_seq": 2}, {"since_us": 250},
               {"level": "ERROR", "since_us": 150}):
        assert t.events(job, **kw) == j.events(job, **kw), kw
    warn_up = t.events(job, level="WARN")
    assert [e["code"] for e in warn_up] == ["OPERATOR_PANIC", "RESTORE"]
    assert [e["code"] for e in t.events(job, after_seq=2)] == ["RESTORE", "LOG"]
    assert t.events(job)[-1]["level"] == "INFO"  # an unknown level normalizes
    # the port's own filter: by code, positionally, as its callers pass it
    assert [e["seq"] for e in t.events(job, "LOG")] == [1, 4]
    assert t.events(job, "LOG", level="INFO") == [t.events(job)[-1]]
    line = tevents.render_event(warn_up[0])
    assert line == jevents.render_event(warn_up[0])
    assert "agg/1" in line and "e3" in line and "abc123def456" in line
    assert tevents.trail(warn_up) == jevents.trail(warn_up) == ["OPERATOR_PANIC", "RESTORE"]
    t.clear_job(job)
    j.clear_job(job)


def test_ingest_and_seq_floor():
    job = "ingest-job-torch"
    recorder.clear_job(job)
    ev = recorder.ingest(job, {"seq": 777, "ts_us": 123_000_000, "level": "WARN",
                               "code": "COMMIT_REDELIVERED", "worker": 1, "epoch": 4,
                               "message": "late commit"})
    assert (ev["ts_us"], ev["level"], ev["worker"], ev["epoch"], ev["seq"]) == \
        (123_000_000, "WARN", 1, 4, 1)
    assert recorder.ingest(job, {"event": "not-a-job-event"}) is None
    assert recorder.ingest(job, "garbage") is None
    recorder.ensure_seq_floor(job, 10)
    recorder.ensure_seq_floor(job, 3)  # never lowers
    assert recorder.record(job, "INFO", "LOG")["seq"] == 11
    recorder.clear_job(job)


def test_traceback_digest_equals_the_jax_packages():
    tb = ("Traceback (most recent call last):\n"
          "  File \"x.py\", line 1, in f\n"
          "ZeroDivisionError: division by zero\n")
    d = tevents.traceback_digest(tb)
    assert d == jevents.traceback_digest(tb) == tevents.traceback_digest(tb)
    assert d["error"] == "ZeroDivisionError: division by zero" and len(d["digest"]) == 12
    assert tevents.traceback_digest(tb + "  extra frame\n") != d
    assert tevents.traceback_digest("") == jevents.traceback_digest("")


def test_logging_bridge_captures_job_scoped_records_only():
    job = "bridge-job-torch"
    recorder.clear_job(job)
    log = logging.getLogger("arroyo_tpu_torch.test_bridge")
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = tevents.install_bridge(log)
    assert tevents.install_bridge(log) is handler  # idempotent
    try:
        log.warning("spill started", extra={"job_id": job, "node": "agg", "subtask": 2})
        log.error("custom", extra={"job_id": job, "event_code": "RESCALE"})
        log.info("service-level line with no job context")
        evs = recorder.events(job)
        assert [(e["code"], e["level"], e["node"], e["subtask"]) for e in evs] == \
            [("LOG", "WARN", "agg", 2), ("RESCALE", "ERROR", None, None)]
    finally:
        log.removeHandler(handler)
        recorder.clear_job(job)


# ------------------------------------------------ engine-level events


def _q7(pkg, job, url, **kw):
    g = build_q7(MODULES[pkg], [], EVENTS, agg_parallelism=2)
    if pkg == "torch":
        return TEngine(g, job_id=job, device="cpu", storage_url=url, **kw)
    return JEngine(g, job_id=job, storage_url=url, **kw)


def _scope(e):
    return (e["code"], e["level"], e["node"], e["subtask"], e["worker"], e["epoch"])


def _panic(pkg, job, url):
    rec, faults = ((recorder, tfaults) if pkg == "torch" else (jevents.recorder, jfaults))
    rec.clear_job(job)
    eng = _q7(pkg, job, url)
    gate = chip_smoke.gate_source(eng, 5)
    faults.install("worker:crash@barrier=1&node=agg&subtask=1", seed=5)
    try:
        eng.start()
        assert gate.reached.wait(60)
        eng.trigger_checkpoint(1)
        with pytest.raises(RuntimeError, match="InjectedCrash|injected"):
            eng.join(timeout=120)
    finally:
        faults.clear()
        eng.stop()
    return rec.events(job)


def test_operator_panic_scope_equals_the_jax_packages(tmp_path):
    tev = _panic("torch", "panic-q7", str(tmp_path / "t"))
    jev = _panic("jax", "panic-q7", str(tmp_path / "j"))
    tp = [e for e in tev if e["code"] == "OPERATOR_PANIC"]
    jp = [e for e in jev if e["code"] == "OPERATOR_PANIC"]
    assert [_scope(e) for e in tp] == [_scope(e) for e in jp] == \
        [("OPERATOR_PANIC", "ERROR", "agg", 1, None, 1)]
    assert tp[0]["data"]["operator"] == jp[0]["data"]["operator"]
    assert re.fullmatch(r"[0-9a-f]{12}", tp[0]["data"]["digest"])
    assert tp[0]["message"].split(":")[0].split(".")[-1] == \
        jp[0]["message"].split(":")[0].split(".")[-1]
    assert "InjectedCrash" in tp[0]["message"]
