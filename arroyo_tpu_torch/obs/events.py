"""Structured job event log (the port's copy of arroyo_tpu/obs/events.py):
the catalog of event codes, a bounded per-job ring with total counts per
(code, level) behind ``arroyo_events_total``, and the stdlib logging
bridge.

Every operationally meaningful moment of a job (an operator exception, a
segment compiled or fallen back, a re-delivered commit, a quarantined
checkpoint, spilled state, dropped bad records) is recorded as an event:
timestamp, level, a stable machine-readable ``code``, scope {node,
subtask, worker, epoch}, message and data. Each gets a per-job,
monotonically increasing ``seq``. Epoch-scoped events render as instant
markers in the Chrome trace export (obs/trace.py). Relaying events to a
controller, its database and the ``logs`` command wait for the port's
control plane.

``events(job, code)`` filters by code (the port's callers pass it
positionally); the JAX package's level, time and seq filters are keyword
arguments here.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Iterable, Optional

LEVELS = ("DEBUG", "INFO", "WARN", "ERROR")
_LEVEL_RANK = {name: i for i, name in enumerate(LEVELS)}

# Stable machine-readable event codes (the JAX package's catalog). Every
# code emitted anywhere in the port MUST appear here, so dashboards and
# alerts can key on codes without grepping messages.
EVENT_CODES: dict[str, tuple[str, str]] = {
    # code: (default level, meaning)
    "OPERATOR_PANIC": (
        "ERROR", "an operator raised in the task run loop; the scope names "
                 "the node/subtask and data carries a traceback digest"),
    "WORKER_LOST": (
        "ERROR", "a worker of the set crashed, missed heartbeats, or wedged "
                 "checkpoints past escalation; the whole set comes down"),
    "RESTORE": (
        "WARN", "the worker set is being restored from the last globally "
                "complete checkpoint (epoch in scope)"),
    "EPOCH_WEDGED": (
        "WARN", "the stuck-checkpoint watchdog declared an epoch failed; "
                "its torn shards are subsumed and the checkpoint retried"),
    "COMMIT_REDELIVERED": (
        "WARN", "a dropped phase-2 commit for an earlier epoch was "
                "re-delivered cumulatively with a later one"),
    "RESCALE": (
        "INFO", "a live rescale started (data: from/to parallelism); the "
                "set drains behind a final checkpoint and restarts"),
    "AUTOSCALE_DECISION": (
        "INFO", "the elastic autoscaler decided a target parallelism after "
                "its hysteresis window (data: direction, from/to, raw "
                "target before the min/max rails, breaching signals)"),
    "AUTOSCALE_STARTED": (
        "INFO", "an autoscaler-initiated rescale began actuating: the set "
                "drains behind a final checkpoint (data: from/to)"),
    "AUTOSCALE_DONE": (
        "INFO", "the autoscaled worker set is running at its new "
                "parallelism (data: parallelism, restore epoch)"),
    "AUTOSCALE_BACKOFF": (
        "WARN", "a scale transition was disrupted; the next decision is "
                "gated by an exponential backoff window (data: backoff_s, "
                "consecutive failures)"),
    "HEALTH_DEGRADED": (
        "WARN", "a health rule fired past its hysteresis window; the job "
                "is degraded (data: per-rule detail)"),
    "HEALTH_CRITICAL": (
        "ERROR", "a critical-severity health rule is firing (data: "
                 "per-rule detail)"),
    "HEALTH_OK": (
        "INFO", "all health rules cleared their hysteresis window; the job "
                "is healthy again"),
    "SEGMENT_COMPILED": (
        "INFO", "a chained operator segment compiled into one fused kernel "
                "function; data carries member count, compile time, and "
                "the input schema the cache entry is keyed on"),
    "SEGMENT_FALLBACK": (
        "WARN", "a marked segment could not trace (or its first-batch "
                "verification diverged) and degraded to the interpreted "
                "per-operator path for this run; data carries the reason"),
    "MESH_OVERFLOW": (
        "WARN", "key skew pushed rows past the sharded aggregate's fixed-"
                "capacity exchange lane into the per-shard HBM spill "
                "buffer — correct but slower, and exhausting that buffer "
                "IS an error, so raise device.spill-capacity first "
                "(throttled: re-emitted only when the resident count "
                "doubles; data: overflow_rows)"),
    "JOB_QUEUED": (
        "INFO", "the fleet could not place the job (pool full / tenant at "
                "quota / placement 409'd) — it waits in its tenant's FIFO "
                "admission queue instead of failing (data: tenant, slots, "
                "reason; a 409 re-queue carries its deterministic "
                "backoff_s and is emitted at WARN)"),
    "JOB_ADMITTED": (
        "INFO", "the fleet's deficit-round-robin pass granted the job's "
                "slots; it proceeds to Scheduling (data: tenant, slots, "
                "waited_s when it queued first)"),
    "JOB_REJECTED": (
        "ERROR", "admission rejected structurally: the job's own demand "
                 "exceeds its tenant's max-slots quota, so it could never "
                 "run — the one admission verdict that fails the job"),
    "JOB_PREEMPTED": (
        "WARN", "a quota change left the tenant over its slot budget; the "
                "fleet preempts the tenant's newest job — drain behind a "
                "final checkpoint, then back into the admission queue"),
    "JOB_TICK_OVERRUN": (
        "WARN", "the job's supervision step overran fleet.tick-budget-ms; "
                "it is deprioritized (neighbors tick first, this job is "
                "skipped for `penalty` ticks then always runs again) so a "
                "melting job cannot starve its neighbors' heartbeat/"
                "watchdog checks (data: ms, budget_ms, penalty)"),
    "JOB_EVOLVE_STARTED": (
        "INFO", "a live evolution (versioned redeploy) was accepted: the "
                "running set drains behind a final checkpoint before the "
                "evolved plan restores from it (data: drain_epoch)"),
    "JOB_EVOLVE_CLASSIFIED": (
        "INFO", "the plan-diff pass classified every operator of the "
                "evolved plan (data: per-node carried/rebuilt/dropped/"
                "stateless classifications, pipeline version); emitted at "
                "ERROR with the AR-series diagnostics when the evolution "
                "is rejected and the unchanged plan restarts instead"),
    "JOB_EVOLVE_CUTOVER": (
        "INFO", "blue/green cutover: the evolved set's first epoch went "
                "durable (it caught up past the carried offsets) and its "
                "withheld phase-2 commits are released atomically at this "
                "barrier (epoch in scope)"),
    "JOB_EVOLVE_DONE": (
        "INFO", "the evolution finished: the evolved plan owns the single "
                "committed lineage at its bumped pipeline version"),
    "CHECKPOINT_QUARANTINED": (
        "ERROR", "a checkpoint epoch failed integrity verification (torn/"
                 "corrupt marker, sidecar, table file, or missing spill "
                 "run) and was quarantined: its marker is preserved under "
                 "metadata.json.quarantined, GC refuses the epoch, and an "
                 "operator must resolve it (data: reason)"),
    "RESTORE_FELL_BACK": (
        "WARN", "restore skipped one or more quarantined epochs and fell "
                "back to the next-older valid checkpoint; sources rewind "
                "to that epoch's offsets so replay covers the gap (data: "
                "skipped epochs with reasons, fallback epoch)"),
    "BAD_DATA_DROPPED": (
        "WARN", "a connector dropped undeserializable records under "
                "bad_data=drop (throttled; data carries the drop count "
                "since the last emission and the last error)"),
    "SPILL_STARTED": (
        "INFO", "tiered state engaged: a subtask's resident state passed "
                "its budget and cold partitions began spilling to storage "
                "(data: table, partition, rows, bytes)"),
    "SPILL_FALLBACK": (
        "WARN", "a spill or spill-compaction write failed after retries; "
                "the state stays resident (re-pinned hot) and spilling "
                "backs off — degraded, never corrupted (data: reason)"),
    "LOG": (
        "INFO", "a stdlib logging record carrying job context, bridged by "
                "the logging.capture-events handler"),
}


# the ring's length per job (the JAX package's ``obs.events.max-per-job``
# default); counts are kept past it
MAX_EVENTS_PER_JOB = 512


def now_us() -> int:
    return int(time.time() * 1e6)


def level_rank(level: str) -> int:
    return _LEVEL_RANK.get(str(level).upper(), 1)


class JobEventLog:
    """Bounded per-job ring of structured events, plus total counts per
    (code, level) for the ``arroyo_events_total`` exposition (counts keep
    growing after ring eviction — a log flood bounds memory, not truth).

    Single global instance (``recorder``). Each record gets a per-job,
    monotonically increasing ``seq`` so relays (worker -> controller) and
    persistence (controller -> DB) can drain incrementally: "everything
    after the seq I last saw" — the same cursor the ``logs --follow`` CLI
    and the ``?after=`` API parameter use.
    """

    def __init__(self, max_events_per_job: int = MAX_EVENTS_PER_JOB):
        self.max_per_job = max_events_per_job
        self._lock = threading.Lock()
        self._jobs: dict[str, list[dict]] = {}
        self._seq: dict[str, int] = {}
        # (job, code, level) -> count of ALL events ever recorded
        self._counts: dict[tuple[str, str, str], int] = {}

    def record(self, job_id: str, level: str, code: str, message: str = "",
               node: Optional[str] = None, subtask: Optional[int] = None,
               worker: Optional[int] = None, epoch: Optional[int] = None,
               data: Optional[dict] = None, t_us: Optional[int] = None) -> dict:
        level = str(level).upper()
        if level not in _LEVEL_RANK:
            level = "INFO"
        ev = {
            "ts_us": now_us() if t_us is None else int(t_us),
            "level": level,
            "code": str(code),
            "node": node,
            "subtask": None if subtask is None else int(subtask),
            "worker": None if worker is None else int(worker),
            "epoch": None if epoch is None else int(epoch),
            "message": str(message),
            "data": data or {},
        }
        cap = self.max_per_job
        with self._lock:
            seq = self._seq.get(job_id, 0) + 1
            self._seq[job_id] = seq
            ev["seq"] = seq
            ring = self._jobs.setdefault(job_id, [])
            ring.append(ev)
            if len(ring) > cap:
                del ring[: len(ring) - cap]
            key = (job_id, ev["code"], level)
            self._counts[key] = self._counts.get(key, 0) + 1
        return ev

    def ingest(self, job_id: str, ev: dict) -> Optional[dict]:
        """Replay a relayed event dict (the controller feeds worker ``log``
        events through here). The original timestamp/level/code/scope are
        preserved; a fresh local seq is assigned."""
        if not isinstance(ev, dict) or "code" not in ev:
            return None
        return self.record(
            job_id, ev.get("level", "INFO"), ev["code"],
            message=ev.get("message", ""), node=ev.get("node"),
            subtask=ev.get("subtask"), worker=ev.get("worker"),
            epoch=ev.get("epoch"), data=ev.get("data") or {},
            t_us=ev.get("ts_us"))

    def events(self, job_id: str, code: Optional[str] = None, *,
               level: Optional[str] = None,
               since_us: Optional[int] = None,
               after_seq: Optional[int] = None) -> list[dict]:
        """Ring contents oldest first, filtered by code, minimum level,
        wall-time floor, and/or seq cursor."""
        with self._lock:
            out = list(self._jobs.get(job_id, ()))
        if code is not None:
            out = [e for e in out if e["code"] == code]
        if after_seq is not None:
            out = [e for e in out if e["seq"] > after_seq]
        if since_us is not None:
            out = [e for e in out if e["ts_us"] >= since_us]
        if level is not None:
            floor = level_rank(level)
            out = [e for e in out if _LEVEL_RANK[e["level"]] >= floor]
        return out

    def last_seq(self, job_id: str) -> int:
        with self._lock:
            return self._seq.get(job_id, 0)

    def ensure_seq_floor(self, job_id: str, seq: int) -> None:
        """Raise the job's seq counter to at least ``seq``. A restarted
        controller re-adopting a job must seed this from the DB's max
        persisted seq, or fresh events would collide with already-persisted
        (job, seq) rows and be dropped by the idempotent flush."""
        with self._lock:
            if seq > self._seq.get(job_id, 0):
                self._seq[job_id] = int(seq)

    def counts_snapshot(self) -> dict[tuple[str, str, str], int]:
        with self._lock:
            return dict(self._counts)

    def clear_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            self._seq.pop(job_id, None)
            self._counts = {k: v for k, v in self._counts.items()
                            if k[0] != job_id}


recorder = JobEventLog()


def traceback_digest(tb_text: str) -> dict:
    """Compact identity for an exception: a short stable hash of the
    traceback plus its last line, so repeated panics of the same bug
    aggregate without shipping full stacks through the event feed."""
    import hashlib

    lines = [l for l in tb_text.strip().splitlines() if l.strip()]
    return {
        "digest": hashlib.sha1(tb_text.encode(errors="replace"))
        .hexdigest()[:12],
        "error": lines[-1][:200] if lines else "",
    }


# ------------------------------------------------------- stdlib log bridge

_STDLIB_LEVEL = {"DEBUG": "DEBUG", "INFO": "INFO", "WARNING": "WARN",
                 "ERROR": "ERROR", "CRITICAL": "ERROR"}


class JobEventBridgeHandler(logging.Handler):
    """Captures stdlib log records that carry job context into the event
    ring: ``logger.warning("...", extra={"job_id": jid, "event_code": ...,
    "node": ..., "subtask": ..., "worker": ..., "epoch": ...})``. Records
    without a ``job_id`` pass through untouched (the bridge is a tap, not
    a filter), so service-level logs never pollute per-job feeds."""

    def emit(self, record: logging.LogRecord) -> None:
        job_id = getattr(record, "job_id", None)
        if not job_id:
            return
        try:
            recorder.record(
                str(job_id),
                _STDLIB_LEVEL.get(record.levelname, "INFO"),
                getattr(record, "event_code", "LOG"),
                message=record.getMessage(),
                node=getattr(record, "node", None),
                subtask=getattr(record, "subtask", None),
                worker=getattr(record, "worker", None),
                epoch=getattr(record, "epoch", None),
            )
        except Exception:  # noqa: BLE001 - logging must never raise
            self.handleError(record)


def install_bridge(root: Optional[logging.Logger] = None) -> JobEventBridgeHandler:
    """Idempotently attach the bridge handler to ``root`` (the root logger
    by default)."""
    root = root or logging.getLogger()
    for h in root.handlers:
        if isinstance(h, JobEventBridgeHandler):
            return h
    handler = JobEventBridgeHandler()
    root.addHandler(handler)
    return handler


# ------------------------------------------------------------- rendering


def render_event(ev: dict) -> str:
    """One `logs` CLI line: time, level, code, scope, message, extra data."""
    ts = time.strftime("%H:%M:%S", time.localtime(ev["ts_us"] / 1e6))
    scope = []
    if ev.get("node") is not None:
        sub = ev.get("subtask")
        scope.append(f"{ev['node']}/{sub}" if sub is not None else ev["node"])
    if ev.get("worker") is not None:
        scope.append(f"w{ev['worker']}")
    if ev.get("epoch") is not None:
        scope.append(f"e{ev['epoch']}")
    where = f" [{' '.join(scope)}]" if scope else ""
    extra = ""
    if ev.get("data"):
        import json as _json

        extra = "  " + _json.dumps(ev["data"], sort_keys=True,
                                   separators=(",", ":"))
    return (f"{ts}  {ev['level']:<5} {ev['code']:<18}{where}  "
            f"{ev.get('message', '')}{extra}")


def trail(events: Iterable[dict],
          key: Callable[[dict], str] = lambda e: e["code"]) -> list[str]:
    """Causally-ordered (seq) projection of an event list — what the chaos
    tests assert an ERROR -> RESTORE -> recovery sequence against."""
    return [key(e) for e in sorted(events, key=lambda e: e.get("seq", 0))]
