"""Engine: logical graph -> physical tasks -> running pipeline (the port's
copy of arroyo_tpu/engine/engine.py, single process, single worker).

Each node becomes ``parallelism`` subtasks, each on its own thread. A
FORWARD edge between equal parallelisms is 1:1; every other edge is a full
bipartite set of queues. The port has its OWN operator registry: the JAX
package's is process-global too, and both packages load in one test
process, so sharing one would let either replace the other's constructors.

The engine resolves one torch device (device.py) and hands it to every
operator through its OperatorContext. With ``pipeline.chaining.enabled`` it
first fuses chainable runs (optimizer.chain_graph), whose marked prefix the
tasks run as one fused kernel per micro-batch (engine/segment.py).

Checkpoints: ``trigger_checkpoint(epoch)`` sends a barrier into every
source; each task snapshots its tables at the aligned barrier
(engine/task.py) and reports its metadata. Once every task has reported the
epoch or drained cleanly, the engine writes the job marker, whose
``integrity`` manifest folds every file's envelope (state/integrity.py),
and delivers the epoch's commit to committing operators.
``Engine(graph, restore_epoch=e)`` restores every task's tables from epoch
``e`` before the tasks start. The marker carries the plan fingerprint of
the logical graph (analysis/plan_diff.py ``plan_fingerprint``, equal to the
JAX package's for the same graph); a restore under another fingerprint is
refused unless the epoch's evolution mapping (state/tables.py
``write_evolution_mapping``) covers exactly that pair of plans, and then
each node restores as the mapping says. An epoch that holds state for
operators this graph lacks (and the mapping does not account for) is
refused too. ``compact(epoch)`` merges a completed epoch's per-subtask
files. The checkpoint layout is the JAX package's (state/tables.py). A
configured fault plan (``faults.plan``) is installed at construction.

Every epoch's lifecycle is recorded as spans in obs/trace.py's recorder
(trigger, each subtask's alignment and snapshot start and ack, the marker
durable, the commit delivered); ``checkpoint_timeline`` reads them, a
checkpoint that times out carries the epoch's ``timeline_report``, and a
durable epoch's phase durations feed ``arroyo_checkpoint_phase_seconds``.
Not ported: the multi-worker coordination of controller/ (its commit
path and COMMIT_REDELIVERED come with the controller).
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from ..config import config
from ..metrics import registry as metrics_registry
from ..obs.trace import phase_durations, timeline_report
from ..obs.trace import recorder as trace_recorder
from ..device import resolve_device
from ..faults import fault_point, install_from_config
from ..graph import EdgeType, Graph, OpName
from ..operators.base import OperatorContext
from ..operators.collector import Collector, OutEdge
from ..state.tables import (TableManager, cleanup_checkpoints, compact_job,
                            latest_complete_checkpoint, read_evolution_mapping,
                            read_job_checkpoint_metadata, write_job_checkpoint_metadata)
from ..types import CheckpointBarrier, ControlMessage, ControlResp, TaskInfo
from .queues import TaskInbox
from .task import Task

_log = logging.getLogger("arroyo_tpu_torch.engine")

_CONSTRUCTORS: dict[OpName, Callable[[dict], object]] = {}


def register_operator(op: OpName):
    def deco(fn):
        _CONSTRUCTORS[op] = fn
        return fn

    return deco


def load_operators() -> None:
    """Import every operator/connector module of the port so that its
    constructor registers."""
    from .. import connectors
    from ..operators import (async_udf, builtin, chained, joins,  # noqa: F401
                             updating_aggregate, window_fn)
    from ..windows import session, sliding, tumbling  # noqa: F401

    connectors.load_all()


def construct_operator(op: OpName, cfg: dict):
    load_operators()
    if op not in _CONSTRUCTORS:
        raise NotImplementedError(
            f"operator {op.value} is not ported yet (ROADMAP.md queue A lists what "
            f"is left to port); the port runs {sorted(o.value for o in _CONSTRUCTORS)}")
    return _CONSTRUCTORS[op](cfg)


@dataclass(frozen=True)
class CheckpointWait:
    """Outcome of Engine.checkpoint_and_wait, truthy only when the epoch
    completed: "completed", "finished" (the pipeline drained before the
    barrier) or "timeout" (with the subtasks that never acked)."""

    outcome: str  # "completed" | "finished" | "timeout"
    missing: tuple = ()  # (node_id, subtask) pairs unacked at timeout
    # timeout only: the epoch's trace timeline (obs.trace.timeline_report),
    # naming the subtask whose barrier never arrived or never acked
    report: str = ""

    def __bool__(self) -> bool:
        return self.outcome == "completed"

    def __repr__(self) -> str:
        if self.outcome == "timeout" and self.missing:
            base = f"CheckpointWait(timeout, never acked: {list(self.missing)})"
            return f"{base}\n{self.report}" if self.report else base
        return f"CheckpointWait({self.outcome})"


class Engine:
    def __init__(self, graph: Graph, job_id: str = "job",
                 device: Optional[Union[str, torch.device]] = None,
                 storage_url: Optional[str] = None,
                 restore_epoch: Optional[int] = None):
        """``storage_url`` None takes ``checkpoint.storage-url``;
        ``restore_epoch`` restores every task's state from that epoch."""
        # a configured fault plan activates with fresh counters per engine
        # incarnation, so a restarted job replays its faults
        install_from_config()
        # the fingerprint of the logical graph, before chain_graph renames
        # its nodes: the same hash whatever the chaining setting
        self.plan_hash = self._fingerprint(graph, job_id)
        if config().get("pipeline.chaining.enabled"):
            from ..optimizer import chain_graph

            graph = chain_graph(graph)
        self.graph = graph
        self.job_id = job_id
        # a new incarnation of the job records its epochs' spans afresh
        trace_recorder.clear_job(job_id)
        self.device = resolve_device(device)
        self.storage_url = storage_url or config().get("checkpoint.storage-url")
        self.restore_epoch = restore_epoch
        self.restored_watermark: Optional[int] = None
        self.resp_queue: "_queue.Queue[ControlResp]" = _queue.Queue()
        self.tasks: dict[tuple[str, int], Task] = {}
        self._inboxes: dict[tuple[str, int], TaskInbox] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._finished_tasks: set[tuple[str, int]] = set()
        # the subset that drained cleanly: only their state is final and
        # may stand in for epoch coverage
        self._clean_finished: set[tuple[str, int]] = set()
        self._failed: list[ControlResp] = []
        self._checkpoints: dict[int, dict[tuple[str, int], dict]] = {}
        self._completed_epochs: set[int] = set()
        self._resp_thread: Optional[threading.Thread] = None
        # triggers that arrive before start() are replayed by it, never lost
        self._running = False
        self._pending_triggers: list[tuple[int, bool]] = []
        # the evolution mapping a restore goes through (build), and whether
        # the first epoch completed under it is still to come (the
        # evolve_cutover fault site fires there)
        self.evolution_mapping: Optional[dict] = None
        self._evolve_cutover_pending = False

    # -------------------------------------------------------------- building

    @staticmethod
    def _fingerprint(graph: Graph, job_id: str) -> Optional[str]:
        """analysis.plan_diff.plan_fingerprint, or None where it cannot be
        computed: then the marker carries no hash and no gate runs, as in
        the JAX package, and a warning names the job, its nodes and the
        error, since that job's restores are not held to its plan."""
        try:
            from ..analysis.plan_diff import plan_fingerprint

            return plan_fingerprint(graph)
        except Exception as e:  # noqa: BLE001 - no stamp, as the JAX engine, but said
            _log.warning("job %r (nodes %s): no plan fingerprint (%s: %s); its checkpoints "
                         "carry no plan_hash and a restore of them is not checked against "
                         "the plan", job_id, ", ".join(sorted(graph.nodes)), type(e).__name__, e)
            return None

    def _check_restore(self) -> None:
        """Refuse an epoch whose job marker is missing, torn or corrupt (a
        restore from it would start the job from nothing); an epoch written
        by another plan unless its evolution mapping covers exactly this
        pair of plans (the state would be misread); and an epoch that holds
        state for operators this graph lacks and the mapping does not drop
        or carry (a graph edit, or a chaining change across the restore):
        their state would be dropped without a word."""
        meta = read_job_checkpoint_metadata(self.storage_url, self.job_id, self.restore_epoch)
        if meta is None:
            raise RuntimeError(
                f"checkpoint epoch {self.restore_epoch} of job {self.job_id!r} under "
                f"{self.storage_url} has no complete job marker; pick a restorable epoch "
                f"with state.integrity.latest_valid_checkpoint")
        mapping = read_evolution_mapping(self.storage_url, self.job_id, self.restore_epoch)
        meta_hash = meta.get("plan_hash")
        if meta_hash and self.plan_hash and meta_hash != self.plan_hash:
            if mapping is None:
                raise RuntimeError(
                    f"checkpoint epoch {self.restore_epoch} was written by plan {meta_hash} "
                    f"but this graph is plan {self.plan_hash} and no evolution mapping "
                    f"covers the change; restoring would misread state (prove the "
                    f"carry-over with analysis.plan_diff.diff_plans and "
                    f"state.tables.write_evolution_mapping)")
            if (mapping.get("old_plan_hash") != meta_hash
                    or mapping.get("new_plan_hash") != self.plan_hash):
                raise RuntimeError(
                    f"evolution mapping for epoch {self.restore_epoch} covers "
                    f"{mapping.get('old_plan_hash')} -> {mapping.get('new_plan_hash')} but "
                    f"the restore is {meta_hash} -> {self.plan_hash}; refusing a mapping "
                    f"proven for a different plan pair")
        if mapping is not None:
            self.evolution_mapping = mapping
            self._evolve_cutover_pending = True
        stale = set(meta.get("operators", ())) - set(self.graph.nodes)
        if mapping is not None:
            stale -= set(mapping.get("dropped", ()))
            stale -= {str(m.get("from")) for m in mapping.get("nodes", {}).values()
                      if m.get("from")}
        if stale:
            raise RuntimeError(
                f"checkpoint epoch {self.restore_epoch} holds state for operators "
                f"{sorted(stale)} that do not exist in this graph; restoring across a "
                f"pipeline.chaining.enabled change (or a graph edit) would silently drop "
                f"their state")

    def build(self) -> None:
        g = self.graph
        if self.restore_epoch is not None:
            self._check_restore()
        queue_size = config().get("worker.queue-size")
        for nid, node in g.nodes.items():
            n_inputs = sum(g.nodes[e.src].parallelism for e in g.in_edges(nid))
            for s in range(node.parallelism):
                if n_inputs:
                    self._inboxes[(nid, s)] = TaskInbox(n_inputs, queue_size)
        for nid, node in g.nodes.items():
            in_edges = g.in_edges(nid)
            n_inputs = sum(g.nodes[e.src].parallelism for e in in_edges)

            def edge_of_input(i, _edges=in_edges, _g=g):
                # flat input index -> (edge index, upstream subtask)
                base = 0
                for ei, e in enumerate(_edges):
                    p = _g.nodes[e.src].parallelism
                    if i < base + p:
                        return (ei, i - base)
                    base += p
                raise IndexError(i)

            for s in range(node.parallelism):
                ti = TaskInfo(self.job_id, nid, node.op.value, s, node.parallelism)
                out_edges = []
                for e in g.out_edges(nid):
                    dst_node = g.nodes[e.dst]
                    # flat input base for this edge at the destination
                    base = 0
                    for de in g.in_edges(e.dst):
                        if de is e:
                            break
                        base += g.nodes[de.src].parallelism
                    dests = [self._inboxes[(e.dst, d)] for d in range(dst_node.parallelism)]
                    idxs = [base + s] * dst_node.parallelism
                    etype = e.edge_type
                    if etype == EdgeType.FORWARD and dst_node.parallelism != node.parallelism:
                        etype = EdgeType.SHUFFLE
                    out_edges.append(OutEdge(etype, dests, idxs))
                operator = construct_operator(node.op, node.config)
                tm = TableManager(ti, self.storage_url)
                if self.restore_epoch is not None:
                    node_map = (self.evolution_mapping or {}).get("nodes", {}).get(nid)
                    wm = tm.restore(self.restore_epoch, operator.tables(), mapping=node_map)
                    if wm is not None:
                        self.restored_watermark = (wm if self.restored_watermark is None
                                                   else min(self.restored_watermark, wm))
                self.tasks[(nid, s)] = Task(
                    ti, operator, self._inboxes.get((nid, s)), Collector(out_edges, s),
                    OperatorContext(ti, self.device, edge_of_input, tm), self.resp_queue,
                    n_inputs=n_inputs)

    # -------------------------------------------------------------- running

    def start(self) -> None:
        if not self.tasks:
            self.build()
        self._resp_thread = threading.Thread(target=self._collect_resps, daemon=True)
        self._resp_thread.start()
        # sinks first, so consumers are ready before producers
        for node in reversed(self.graph.topo_order()):
            for s in range(node.parallelism):
                self.tasks[(node.node_id, s)].start()
        with self._lock:
            self._running = True
            pending, self._pending_triggers = self._pending_triggers, []
        for epoch, then_stop in pending:
            self.trigger_checkpoint(epoch, then_stop=then_stop)

    def _collect_resps(self) -> None:
        n_tasks = len(self.tasks)
        while True:
            try:
                resp = self.resp_queue.get(timeout=0.25)
            except _queue.Empty:
                with self._lock:
                    if len(self._finished_tasks) + len(self._failed) >= n_tasks:
                        return
                continue
            if resp.kind == "task_started":
                continue
            if resp.kind == "checkpoint_event":
                ce = resp.checkpoint_event
                name = {"started_alignment": "align_start",
                        "started_checkpointing": "snapshot_start"}.get(ce.event_type)
                if name:
                    self._span(ce.checkpoint_epoch, name, node=resp.node_id,
                               subtask=resp.subtask_index, t_us=ce.time_micros)
                continue
            if resp.kind == "checkpoint_completed":
                self._span(resp.epoch, "ack", node=resp.node_id, subtask=resp.subtask_index)
            with self._lock:
                key = (resp.node_id, resp.subtask_index)
                if resp.kind == "task_finished":
                    self._finished_tasks.add(key)
                    if resp.clean:
                        self._clean_finished.add(key)
                    self._finish_ready_epochs()
                elif resp.kind == "task_failed":
                    self._failed.append(resp)
                    # unstick every surviving task so producers blocked on a
                    # dead consumer's row budget unwind
                    self._abort()
                elif resp.kind == "checkpoint_completed":
                    self._checkpoints.setdefault(resp.epoch, {})[key] = resp.subtask_metadata
                    self._finish_ready_epochs()
                self._cond.notify_all()

    def _finish_ready_epochs(self) -> None:
        """An epoch is complete once every task has snapshotted it or
        drained cleanly (a drained source takes part in no barrier: its
        state is final). Then the job marker goes durable and committing
        operators get the epoch's commit; the epoch's phase durations go to
        the checkpoint phase histograms. Caller holds the lock."""
        from ..state.integrity import fold_integrity

        for epoch, ep in self._checkpoints.items():
            if self._failed:
                return  # a failed job completes no epoch (nor the one it failed at)
            if epoch in self._completed_epochs or not ep:
                continue
            if len(set(ep) | self._clean_finished) < len(self.tasks):
                continue
            extra = {"operators": sorted({k[0] for k in ep})}
            if self.plan_hash:
                extra["plan_hash"] = self.plan_hash
            integ = fold_integrity(m for m in ep.values() if m)
            if integ:
                extra["integrity"] = integ
            write_job_checkpoint_metadata(self.storage_url, self.job_id, epoch, extra)
            self._span(epoch, "metadata_durable")
            if self._evolve_cutover_pending:
                # the evolved plan's first durable epoch: the evolve_cutover
                # fault site fires between its marker and its commits; a
                # crash there fails the job, and a restart restores this
                # epoch under its own plan hash (no mapping needed)
                self._evolve_cutover_pending = False
                try:
                    fault_point("evolve_cutover", epoch=epoch, key=self.job_id)
                except Exception as exc:  # noqa: BLE001 - injected: fails the job
                    self._failed.append(ControlResp(
                        kind="task_failed", node_id="<evolve_cutover>",
                        error=f"injected crash at the evolve cutover barrier (epoch "
                              f"{epoch}): {exc}"))
                    self._abort()
                    return
            self._completed_epochs.add(epoch)
            for key, task in self.tasks.items():
                if key not in self._finished_tasks and task.operator.is_committing():
                    task.control_queue.put(ControlMessage(kind="commit", epoch=epoch))
            # worker 0: the port's one worker (the JAX package's default index)
            self._span(epoch, "commit_delivered", worker=0)
            metrics_registry.observe_epoch_phases(
                self.job_id, phase_durations(trace_recorder.events(self.job_id, epoch)))

    def _span(self, epoch: int, event: str, node: Optional[str] = None,
              subtask: Optional[int] = None, worker: Optional[int] = None,
              t_us: Optional[int] = None) -> None:
        trace_recorder.record(self.job_id, epoch, event, node, subtask, worker, t_us)

    def checkpoint_timeline(self, epoch: int) -> dict:
        """The epoch's times in ms after its trigger, from its trace spans:
        ``durable_ms`` (the job marker written) and per task
        ``started_alignment`` (its first input's barrier),
        ``started_checkpointing`` and ``acked`` (its metadata reached the
        engine)."""
        events = trace_recorder.events(self.job_id, epoch)
        t0 = min((e["t_us"] for e in events if e["event"] == "trigger"), default=None)
        if t0 is None:
            return {}
        names = {"align_start": "started_alignment",
                 "snapshot_start": "started_checkpointing", "ack": "acked"}
        durable = [e["t_us"] for e in events if e["event"] == "metadata_durable"]
        tasks: dict = {}
        for e in events:
            if e["node"] is not None and e["event"] in names:
                tasks.setdefault(f"{e['node']}/{e['subtask']}", {})[names[e["event"]]] = \
                    (e["t_us"] - t0) / 1e3
        return {"durable_ms": (min(durable) - t0) / 1e3 if durable else None, "tasks": tasks}

    # -------------------------------------------------------------- control

    def source_tasks(self) -> list[Task]:
        return [t for t in self.tasks.values() if t.is_source]

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        """A checkpoint starts at the sources; a trigger that arrives before
        the engine runs is replayed by start()."""
        self._span(epoch, "trigger")
        with self._lock:
            if not self._running:
                self._pending_triggers.append((epoch, then_stop))
                return
        barrier = CheckpointBarrier(epoch=epoch, timestamp=int(time.time() * 1e6),
                                    then_stop=then_stop)
        for t in self.source_tasks():
            t.control_queue.put(ControlMessage(kind="checkpoint", barrier=barrier))

    def checkpoint_and_wait(self, epoch: int, timeout: float = 60.0,
                            then_stop: bool = False) -> CheckpointWait:
        """Trigger ``epoch`` and wait for it: "completed" (truthy), "finished"
        (the pipeline drained first) or "timeout"."""
        self.trigger_checkpoint(epoch, then_stop=then_stop)
        deadline = time.monotonic() + timeout
        with self._lock:
            while epoch not in self._completed_epochs:
                if self._failed:
                    raise RuntimeError(f"task failed during checkpoint: {self._failed[0].error}")
                if self.tasks and len(self._finished_tasks) >= len(self.tasks):
                    return CheckpointWait("finished")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    acked = set(self._checkpoints.get(epoch, ()))
                    missing = tuple(sorted(set(self.tasks) - acked - self._finished_tasks))
                    report = timeline_report(
                        self.job_id, epoch, trace_recorder.events(self.job_id, epoch),
                        expected=set(self.tasks) - self._finished_tasks)
                    return CheckpointWait("timeout", missing, report)
                self._cond.wait(timeout=min(remaining, 0.5))
        return CheckpointWait("completed")

    def compact(self, epoch: int) -> int:
        """Merge a completed epoch's per-subtask state files, one
        generation-1 file per table (state/tables.py ``compact_job``);
        returns the files removed. An epoch this engine has not completed
        is refused."""
        with self._lock:
            if epoch not in self._completed_epochs:
                raise ValueError(f"epoch {epoch} is not a completed checkpoint")
        return compact_job(self.storage_url, self.job_id, epoch)

    def cleanup(self, min_epoch: int) -> int:
        """Drop the checkpoints below ``min_epoch``; refuses to delete past
        the newest restorable one."""
        with self._lock:
            newest = max(self._completed_epochs, default=None)
        if newest is None:
            newest = latest_complete_checkpoint(self.storage_url, self.job_id)
        if newest is None or min_epoch > newest:
            raise ValueError(
                f"cleanup(min_epoch={min_epoch}) would delete every restorable "
                f"checkpoint (newest complete epoch: {newest})")
        return cleanup_checkpoints(self.storage_url, self.job_id, min_epoch)

    def stop(self) -> None:
        for t in self.source_tasks():
            t.control_queue.put(ControlMessage(kind="stop"))

    def _abort(self) -> None:
        self.stop()
        for inbox in self._inboxes.values():
            inbox.close()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            if self._failed:
                for t in self.tasks.values():
                    t.join(2.0)
                raise RuntimeError(f"pipeline task failed:\n{self._failed[0].error}")
            alive = [t for t in self.tasks.values() if t.thread and t.thread.is_alive()]
            if not alive:
                break
            if deadline is not None and time.monotonic() > deadline:
                self._abort()
                raise TimeoutError(f"{len(alive)} tasks still running after join timeout")
            alive[0].join(0.2)
        # every thread has exited; the last task_finished / task_failed
        # responses may still be in flight on the response queue
        catchup = time.monotonic() + 5.0
        with self._lock:
            while (len(self._finished_tasks) + len(self._failed) < len(self.tasks)
                   and time.monotonic() < catchup):
                self._cond.wait(timeout=0.1)
        if self._failed:
            raise RuntimeError(f"pipeline task failed:\n{self._failed[0].error}")

    def run_to_completion(self, timeout: Optional[float] = 120.0) -> None:
        self.start()
        self.join(timeout)


def run_graph(graph: Graph, job_id: str = "job", timeout: float = 120.0,
              device: Optional[Union[str, torch.device]] = None, **kw) -> Engine:
    """Build, run to completion, return the finished engine. ``device``
    None runs on CUDA (and raises without it); tests pass ``"cpu"``.
    ``kw`` goes to Engine (``storage_url``, ``restore_epoch``)."""
    eng = Engine(graph, job_id=job_id, device=device, **kw)
    eng.run_to_completion(timeout)
    return eng
