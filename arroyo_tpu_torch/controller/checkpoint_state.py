"""Controller-owned cross-worker checkpoint coordination.

The port's copy of arroyo_tpu/controller/checkpoint_state.py.

Equivalent of crates/arroyo-controller/src/job_controller/checkpoint_state.rs:
the CONTROL PLANE — not any one worker — collects per-subtask
``checkpoint_completed`` acks from every worker of a job, declares the epoch
globally durable by writing the job-level metadata marker only once EVERY
expected subtask has reported (or finished), and only then fans phase-2
``commit`` messages back out to the workers (send_commit_messages,
job_controller/mod.rs:838). Workers running under an assignment never write
job metadata and never self-commit (engine/engine.py relays acks upward
instead), so a committing sink can never finalize against an epoch that
another worker has yet to make durable.

The 2PC ordering invariant — metadata durable across all workers BEFORE any
commit message leaves the controller — is recorded in ``event_log`` as an
ordered trail (("metadata_durable", epoch) strictly precedes every
("commit_sent", epoch, worker)), which the chaos suite asserts directly.

Commit delivery is at-least-once and cumulative: ``Engine.deliver_commit(E)``
first delivers any earlier durable epoch whose commit message was lost (the
``commit`` chaos site drops them on purpose), so a dropped phase-2 message is
re-delivered with the next epoch, never lost.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from ..obs.trace import recorder as trace_recorder
from ..state.tables import write_job_checkpoint_metadata

SubtaskKey = tuple[str, int]  # (node_id, subtask_index)


def expected_subtasks(graph) -> set[SubtaskKey]:
    """Every (node_id, subtask) of a job = the global ack set for an epoch.
    Must be computed against the SAME post-chaining graph the workers run
    (compute_assignment chains first for exactly this reason)."""
    return {
        (nid, s)
        for nid, node in graph.nodes.items()
        for s in range(node.parallelism)
    }


def compute_assignment(graph_json: str, n_workers: int):
    """Place every subtask on a worker (reference compute_assignments,
    states/scheduling.rs:56): round-robin over each node's subtasks so every
    worker holds a slice of every operator — sources included, which keeps
    barrier injection local to each worker.

    Returns ``(assignment, expected, n_actual)``; ``n_actual`` is clamped to
    the widest node so no worker is left with zero subtasks.
    """
    from ..config import config
    from ..graph import Graph

    g = Graph.loads(graph_json)
    if config().get("pipeline.chaining.enabled"):
        # the engine chains its own copy deterministically; assignments must
        # be keyed by the post-chaining node ids or Engine.__init__ rejects
        from ..optimizer import chain_graph

        g = chain_graph(g)
    widest = max((n.parallelism for n in g.nodes.values()), default=1)
    n_actual = max(1, min(int(n_workers), widest))
    assignment = {
        (nid, s): s % n_actual
        for nid, node in g.nodes.items()
        for s in range(node.parallelism)
    }
    return assignment, expected_subtasks(g), n_actual


@dataclass
class CheckpointState:
    """One epoch's cross-worker progress (reference CheckpointState)."""

    epoch: int
    started_at: float
    acked: set = field(default_factory=set)
    publishing: bool = False  # metadata write claimed (single-writer guard)
    # per-epoch integrity manifest, accumulated from the envelopes each
    # subtask ack relays ({"operator-<node>/<file>": {crc,len,algo}}) and
    # folded into the job-level marker at publish time
    integrity: dict = field(default_factory=dict)

    def covered_by(self, finished: set, expected: frozenset) -> bool:
        """Global coverage: every expected subtask either acked this epoch
        or finished outright (a drained task's state is final — reference
        CheckpointState handles TaskFinished the same way)."""
        return expected <= (self.acked | finished)


class CheckpointCoordinator:
    """Tracks every in-flight epoch for one multi-worker job and owns the
    two-phase commit: phase 1 completes when the job-level metadata marker
    is durable (global coverage), phase 2 fans commits to the workers."""

    def __init__(self, job_id: str, storage_url: str,
                 expected: Iterable[SubtaskKey],
                 event_log: Optional[list] = None,
                 plan_hash: Optional[str] = None):
        self.job_id = job_id
        self.storage_url = storage_url
        self.expected = frozenset(expected)
        # plan fingerprint stamped into every epoch's job-level metadata so
        # a later restore can prove it reads state its plan actually wrote
        self.plan_hash = plan_hash
        self._lock = threading.Lock()
        self.pending: dict[int, CheckpointState] = {}
        self.finished: set[SubtaskKey] = set()
        self.durable: list[int] = []  # epochs in durability order
        self.forgotten: set[int] = set()  # subsumed stuck epochs: drop late acks
        # ordered 2PC trail (("metadata_durable", e) / ("commit_sent", e, w) /
        # ("commit_dropped", e, w) / ("subtask_acked", e, node, sub)); shared
        # with the JobController so it survives worker-set restarts
        self.event_log: list[tuple] = event_log if event_log is not None else []

    # ------------------------------------------------------------- phase 1

    def begin(self, epoch: int) -> None:
        with self._lock:
            if epoch not in self.forgotten and epoch not in self.durable:
                self.pending.setdefault(
                    epoch, CheckpointState(epoch, time.monotonic()))

    def on_ack(self, epoch: int, key: SubtaskKey,
               integrity: Optional[dict] = None) -> Optional[int]:
        """Record one subtask's checkpoint-completed ack (``integrity`` is
        its artifact-envelope contribution to the epoch manifest). Returns
        the epoch if this ack made it globally durable (metadata marker
        written)."""
        with self._lock:
            if epoch in self.forgotten or epoch in self.durable:
                return None  # late ack for a subsumed or already-durable epoch
            st = self.pending.setdefault(
                epoch, CheckpointState(epoch, time.monotonic()))
            st.acked.add(key)
            if integrity:
                st.integrity.update(integrity)
            self.event_log.append(("subtask_acked", epoch, key[0], key[1]))
            if st.publishing or not st.covered_by(self.finished, self.expected):
                return None
            st.publishing = True
        self._publish(st)
        return epoch

    def on_task_finished(self, key: SubtaskKey) -> list[int]:
        """A subtask drained; it can no longer take part in barriers, so any
        pending epoch may just have reached coverage. Returns the epochs
        that became durable."""
        with self._lock:
            self.finished.add(key)
            ready = []
            for st in sorted(self.pending.values(), key=lambda s: s.epoch):
                if not st.publishing and st.covered_by(self.finished, self.expected):
                    st.publishing = True
                    ready.append(st)
        for st in ready:
            self._publish(st)
        return [st.epoch for st in ready]

    def _publish(self, st: CheckpointState) -> None:
        """Write the job-level metadata marker — the durability commit point
        of phase 1. Runs outside the lock (storage can block); ``publishing``
        guarantees a single writer per epoch."""
        with self._lock:
            operators = sorted({k[0] for k in st.acked}
                               | {k[0] for k in (self.finished & self.expected)})
        extra = {"operators": operators}
        if self.plan_hash:
            extra["plan_hash"] = self.plan_hash
        if st.integrity:
            extra["integrity"] = dict(sorted(st.integrity.items()))
        write_job_checkpoint_metadata(
            self.storage_url, self.job_id, st.epoch, extra)
        trace_recorder.record(self.job_id, st.epoch, "metadata_durable")
        with self._lock:
            self.pending.pop(st.epoch, None)
            self.durable.append(st.epoch)
            self.event_log.append(("metadata_durable", st.epoch))

    # ------------------------------------------------------------- phase 2

    def send_commits(self, epoch: int,
                     senders: Sequence[Optional[Callable[[int], None]]]) -> None:
        """Fan the phase-2 commit out to every worker (reference
        send_commit_messages). Only ever called for durable epochs — the
        event log proves the ordering. The ``commit`` chaos site drops
        messages here; recovery is the cumulative re-delivery in
        Engine.deliver_commit, not a retry loop."""
        from ..faults import fault_point

        for widx, send in enumerate(senders):
            if send is None:
                continue  # worker already finished and was reaped
            verdict = fault_point("commit", epoch=epoch, worker=widx)
            if verdict is not None and verdict[0] == "drop":
                with self._lock:
                    self.event_log.append(("commit_dropped", epoch, widx))
                continue
            send(epoch)
            trace_recorder.record(self.job_id, epoch, "commit_sent",
                                  worker=widx)
            with self._lock:
                self.event_log.append(("commit_sent", epoch, widx))

    # ------------------------------------------------------------ recovery

    def outstanding(self, epoch: int) -> list[SubtaskKey]:
        """Subtasks that never acked ``epoch`` (stuck-checkpoint diagnostic)."""
        with self._lock:
            st = self.pending.get(epoch)
            if st is None:
                return []
            return sorted(self.expected - st.acked - self.finished)

    def forget(self, epoch: int) -> None:
        """Abandon a wedged epoch (its torn shards are being subsumed);
        late acks for it are dropped instead of resurrecting it."""
        with self._lock:
            self.pending.pop(epoch, None)
            self.forgotten.add(epoch)


class EngineSetCoordinator:
    """Controller-style coordination for a set of in-process Engines sharing
    one job (multi-worker test harnesses and embedded worker sets driven
    without a full ControllerServer): pumps each engine's coordinator event
    queue into a CheckpointCoordinator and fans phase-2 commits back via
    Engine.deliver_commit."""

    def __init__(self, engines: Sequence, storage_url: Optional[str] = None):
        e0 = engines[0]
        self.engines = list(engines)
        self.coordinator = CheckpointCoordinator(
            e0.job_id, storage_url or e0.storage_url, expected_subtasks(e0.graph))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name=f"ckpt-coord-{e0.job_id}")

    def start(self) -> "EngineSetCoordinator":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    @property
    def event_log(self) -> list[tuple]:
        return self.coordinator.event_log

    def _pump(self) -> None:
        while not self._stop.is_set():
            moved = False
            for eng in self.engines:
                while True:
                    try:
                        ev = eng.coordinator_events.get_nowait()
                    except _queue.Empty:
                        break
                    moved = True
                    self._handle(ev)
            if not moved:
                self._stop.wait(0.02)

    def _handle(self, ev: dict) -> None:
        if ev.get("event") == "subtask_acked":
            durable = self.coordinator.on_ack(
                int(ev["epoch"]), (ev["node"], int(ev["subtask"])),
                integrity=ev.get("integrity"))
            if durable is not None:
                self._commit(durable)
        elif ev.get("event") == "subtask_finished":
            for epoch in self.coordinator.on_task_finished(
                    (ev["node"], int(ev["subtask"]))):
                self._commit(epoch)

    def _commit(self, epoch: int) -> None:
        self.coordinator.send_commits(
            epoch, [e.deliver_commit for e in self.engines])
