"""Epoch-lifecycle tracing: correlated span trees for checkpoint epochs
(the port's copy of arroyo_tpu/obs/trace.py).

The reference engine surfaces per-operator rates and backpressure, but when
an epoch takes 90 seconds — or never completes — counters cannot say WHERE
the time went. This module records the checkpoint lifecycle as a timeline of
correlated events per epoch:

    trigger                controller (or single-worker engine) injects the
                           barrier into the sources
    align_start            a subtask saw its FIRST barrier input and began
                           holding traffic behind the alignment
    snapshot_start         alignment complete (every live input delivered the
                           barrier); the subtask starts writing its snapshot
    ack                    the subtask's snapshot is durable and its
                           checkpoint-completed response was posted
    metadata_durable       the job-level metadata marker is durable (global
                           coverage across every worker — 2PC phase 1)
    commit_sent            phase-2 commit left the controller for a worker
    commit_delivered       a worker's engine delivered the commit to its
                           committing operators

Events land in a process-global, bounded, in-memory ring (per job, newest
``obs.trace.max-epochs`` epochs) so the recorder is safe to leave on in
production. Multi-process workers relay their events to the controller over
the existing JSON-lines protocol (``{"event": "span", ...}``); the
controller's recorder therefore always holds the whole job's timeline and
persists it to the DB for ``GET /api/v1/jobs/<id>/traces``.

Exports:

    chrome_trace(...)       Chrome trace-event JSON (trace-viewer /
                            Perfetto's "Open with legacy UI" loads it as-is)
    timeline_report(...)    human-readable per-epoch timeline naming the
                            exact subtask whose barrier never arrived or
                            whose snapshot never acked — attached to the
                            wedged-epoch watchdog report and to
                            CheckpointWait timeouts
    phase_durations(...)    align/snapshot/ack/commit wall seconds per epoch
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

# the epoch lifecycle, in causal order (used for stable sorting of events
# that share a timestamp, and by the timeline report)
EVENT_ORDER = ("trigger", "align_start", "snapshot_start", "ack",
               "metadata_durable", "commit_sent", "commit_delivered")

_EVENT_RANK = {name: i for i, name in enumerate(EVENT_ORDER)}


def now_us() -> int:
    """Wall-clock micros — the same clock CheckpointBarrier timestamps use,
    so spans correlate with barrier metadata across processes."""
    return int(time.time() * 1e6)


class EpochTraceRecorder:
    """Bounded per-job ring of epoch timelines. Single global instance
    (``recorder``); every record is an at-most-once fact keyed by
    (event, node, subtask, worker), so duplicate reports (an embedded
    engine and its controller sharing the process) collapse to the first
    observation instead of double-counting."""

    def __init__(self, max_epochs: int = 32, max_events_per_epoch: int = 4096):
        self.max_epochs = max_epochs
        self.max_events = max_events_per_epoch
        self._lock = threading.Lock()
        # job -> {epoch -> {(event, node, subtask, worker) -> t_us}}
        self._jobs: dict[str, dict[int, dict[tuple, int]]] = {}

    def record(self, job_id: str, epoch: int, event: str,
               node: Optional[str] = None, subtask: Optional[int] = None,
               worker: Optional[int] = None, t_us: Optional[int] = None) -> None:
        t = now_us() if t_us is None else int(t_us)
        key = (event, node, subtask, worker)
        with self._lock:
            epochs = self._jobs.setdefault(job_id, {})
            ev = epochs.get(epoch)
            if ev is None:
                ev = epochs[epoch] = {}
                while len(epochs) > self.max_epochs:
                    epochs.pop(min(epochs))
            if key not in ev and len(ev) < self.max_events:
                ev[key] = t

    def epochs(self, job_id: str) -> list[int]:
        with self._lock:
            return sorted(self._jobs.get(job_id, ()))

    def events(self, job_id: str, epoch: int) -> list[dict]:
        """One epoch's timeline, oldest first (ties broken causally)."""
        with self._lock:
            ev = dict(self._jobs.get(job_id, {}).get(epoch, {}))
        out = [
            {"epoch": epoch, "event": k[0], "node": k[1], "subtask": k[2],
             "worker": k[3], "t_us": t}
            for k, t in ev.items()
        ]
        out.sort(key=lambda e: (e["t_us"], _EVENT_RANK.get(e["event"], 99)))
        return out

    def ingest(self, job_id: str, events: Iterable[dict]) -> None:
        """Replay relayed/persisted event dicts (the controller feeds worker
        ``span`` events through here; the API feeds DB rows)."""
        for e in events:
            self.record(job_id, int(e["epoch"]), e["event"], e.get("node"),
                        e.get("subtask"), e.get("worker"), e.get("t_us"))

    def clear_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)


recorder = EpochTraceRecorder()


# ------------------------------------------------------------ derived views


def _by_subtask(events: list[dict]) -> dict[tuple, dict[str, int]]:
    """(node, subtask) -> {event -> t_us} for per-subtask events."""
    out: dict[tuple, dict[str, int]] = {}
    for e in events:
        if e["node"] is None:
            continue
        out.setdefault((e["node"], e["subtask"]), {})[e["event"]] = e["t_us"]
    return out


def _job_event(events: list[dict], name: str, last: bool = False) -> Optional[int]:
    ts = [e["t_us"] for e in events if e["event"] == name]
    if not ts:
        return None
    return max(ts) if last else min(ts)


def phase_durations(events: list[dict]) -> dict[str, float]:
    """Job-level sequential phase decomposition of one epoch, in seconds:

        align     trigger            -> last subtask's snapshot_start
                  (waiting for barriers to traverse the graph and align)
        snapshot  last snapshot_start -> last ack (state writes)
        ack       last ack           -> metadata_durable (marker publish)
        commit    metadata_durable   -> last commit event (2PC phase 2)

    Phases whose boundary events are missing are omitted; the sum of the
    returned values is the trigger->commit wall time actually observed.
    """
    trigger = _job_event(events, "trigger")
    snap = _job_event(events, "snapshot_start", last=True)
    ack = _job_event(events, "ack", last=True)
    durable = _job_event(events, "metadata_durable")
    commit = max(filter(None, (
        _job_event(events, "commit_sent", last=True),
        _job_event(events, "commit_delivered", last=True))), default=None)
    out: dict[str, float] = {}
    for name, lo, hi in (("align", trigger, snap), ("snapshot", snap, ack),
                         ("ack", ack, durable), ("commit", durable, commit)):
        if lo is not None and hi is not None:
            out[name] = max(0.0, (hi - lo) / 1e6)
    return out


def dominant_phase(phases: dict[str, float]) -> Optional[str]:
    if not phases:
        return None
    return max(phases, key=lambda k: phases[k])


def chrome_trace(job_id: str, events_by_epoch: dict[int, list[dict]],
                 job_events: Optional[list[dict]] = None) -> dict:
    """Chrome trace-event JSON for one job's recorded epochs.

    Spans render one track per subtask (tid = "node/subtask") inside one
    process (pid = job): per subtask an "align" span (align_start ->
    snapshot_start) and a "snapshot" span (snapshot_start -> ack); at the
    job level an "epoch N" span (trigger -> metadata_durable) and a
    "commit" span (metadata_durable -> last commit event). A phase still
    open when the trace was taken (a wedged subtask) is emitted as a "B"
    begin-event with no matching end — trace viewers render it running to
    the end of the timeline, which is exactly the visual for "stuck".

    ``job_events`` (structured obs.events dicts): entries scoped to a
    rendered epoch are added as instant markers — an OPERATOR_PANIC or
    EPOCH_WEDGED lands on its subtask's (or the job's "events") track at
    the exact wall time, so one Perfetto view correlates the span tree
    with the event feed."""
    out: list[dict] = []

    def span(name: str, tid: str, t0: Optional[int], t1: Optional[int],
             epoch: int, **args) -> None:
        if t0 is None:
            return
        base = {"name": name, "cat": "checkpoint", "pid": job_id, "tid": tid,
                "ts": t0, "args": {"epoch": epoch, **args}}
        if t1 is None:
            out.append({**base, "ph": "B"})
        else:
            out.append({**base, "ph": "X", "dur": max(0, t1 - t0)})

    for epoch, events in sorted(events_by_epoch.items()):
        trigger = _job_event(events, "trigger")
        durable = _job_event(events, "metadata_durable")
        commit = max(filter(None, (
            _job_event(events, "commit_sent", last=True),
            _job_event(events, "commit_delivered", last=True))), default=None)
        span(f"epoch {epoch}", "epoch", trigger, durable, epoch)
        span("commit", "epoch", durable, commit, epoch)
        for (node, sub), ev in sorted(_by_subtask(events).items()):
            tid = f"{node}/{sub}"
            align0 = ev.get("align_start")
            snap0 = ev.get("snapshot_start")
            ack = ev.get("ack")
            span("align", tid, align0, snap0, epoch)
            span("snapshot", tid, snap0, ack, epoch)
            if align0 is None and snap0 is None and ack is not None:
                # source subtasks snapshot without alignment; give the ack a
                # point on the track so every participant is visible
                out.append({"name": "ack", "cat": "checkpoint", "ph": "i",
                            "pid": job_id, "tid": tid, "ts": ack, "s": "t",
                            "args": {"epoch": epoch}})
    rendered = set(events_by_epoch)
    for ev in job_events or ():
        if ev.get("epoch") is None or int(ev["epoch"]) not in rendered:
            continue
        tid = (f"{ev['node']}/{ev['subtask']}"
               if ev.get("node") is not None and ev.get("subtask") is not None
               else "events")
        out.append({
            "name": ev.get("code", "EVENT"), "cat": "events", "ph": "i",
            "pid": job_id, "tid": tid, "ts": int(ev["ts_us"]), "s": "p",
            "args": {"epoch": int(ev["epoch"]),
                     "level": ev.get("level"),
                     "message": ev.get("message", "")},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def timeline_report(job_id: str, epoch: int, events: list[dict],
                    expected: Optional[Iterable[tuple]] = None) -> str:
    """Human-readable epoch timeline plus a diagnosis naming the exact
    subtask that is holding the epoch: barriers that never arrived
    (``expected`` subtasks with no events at all) and snapshots that never
    acked. This is what the wedged-epoch watchdog and chaos-test failures
    attach, so a stuck checkpoint is self-diagnosing instead of a
    log-archaeology session."""
    if not events:
        return (f"epoch {epoch} of job {job_id}: no trace events recorded "
                "(trigger never reached the engine?)")
    t0 = events[0]["t_us"]
    lines = [f"epoch {epoch} trace ({job_id}):"]
    for e in events:
        who = ""
        if e["node"] is not None:
            who = f"  {e['node']}/{e['subtask']}"
        elif e["worker"] is not None:
            who = f"  worker {e['worker']}"
        lines.append(f"  +{(e['t_us'] - t0) / 1e3:9.1f}ms  {e['event']}{who}")
    by_sub = _by_subtask(events)
    # root causes first: a subtask that STARTED its snapshot (or alignment)
    # and never acked is holding the epoch; subtasks whose barrier never
    # arrived are usually its downstream victims
    stuck: list[str] = []
    for (node, sub), ev in sorted(by_sub.items()):
        if "ack" in ev:
            continue
        if "snapshot_start" in ev:
            stuck.append(f"{node}/{sub}: snapshot started, never acked")
        else:
            stuck.append(f"{node}/{sub}: aligning, barrier(s) still missing "
                         "on some input")
    victims = [f"{key[0]}/{key[1]}: barrier never arrived"
               for key in sorted(set(expected or ())) if key not in by_sub]
    if len(victims) > 6:
        victims = victims[:6] + [f"... and {len(victims) - 6} more"]
    stuck += victims
    if stuck:
        lines.append("  stuck: " + "; ".join(stuck))
    else:
        phases = phase_durations(events)
        if phases:
            dom = dominant_phase(phases)
            lines.append("  phases: " + "  ".join(
                f"{k}={v * 1e3:.1f}ms" + ("  <- dominant" if k == dom else "")
                for k, v in phases.items()))
    return "\n".join(lines)
