"""Physical subtask run loop (the port's copy of arroyo_tpu/engine/task.py).
A chained operator marked compilable runs its batches through the
compiled-segment runner (engine/segment.py runner_for); signals always take
the operator's hooks, so a barrier never goes through the segment kernel or
the fused mesh step, and every micro-batch's step has ended before the
loop takes the next item.

A loop over control messages, the inbox and a tick interval: batches go to
the operator, watermarks are min-merged over inputs (idle only when every
input is idle), end-of-data closes the operator once every input has
finished, and a stop ends the task. Checkpoint barriers are aligned: an
input that delivered the current epoch's barrier is held until every live
input has, then the operator flushes its state into its tables
(``handle_checkpoint``), the table manager writes them, the barrier goes
downstream and the task reports the epoch's metadata to the engine (the
``worker`` fault site fires between the written tables and that report). A
source checkpoints between its batches (``SourceContext.start_checkpoint``).
With ``then_stop`` nothing after the barrier is processed.

Observability (the JAX package's hooks): the task counts the rows, batches
and bytes it receives; its inbox and collector count transit and what is
sent. With ``profile.enabled`` (the default) a TaskProfiler (obs/profile.py)
wraps every operator hook in wall and thread-CPU self-time, refreshes the
state-size gauges, and feeds the key-skew sketch at exactly one boundary:
the collector's keyed shuffle for an operator that shuffles its output, else
its keyed input here. The sketch goes into the ``__sketch`` table before the
tables are written and resumes from it on restore. A terminal operator
observes each batch's end-to-end event latency; the merged watermark is
stamped for the lag gauge; an operator exception records OPERATOR_PANIC
with its epoch and traceback digest before the job fails.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import traceback
from collections import deque
from typing import Optional, Union

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from ..faults import fault_point
from ..operators.base import Operator, OperatorContext, SourceOperator
from ..operators.collector import Collector
from ..types import (CheckpointBarrier, CheckpointEvent, ControlMessage, ControlResp, Signal,
                     SignalKind, SourceFinishType, TaskInfo, Watermark)
from .queues import TaskInbox


class WatermarkHolder:
    """Min-merge of per-input watermarks."""

    def __init__(self, n_inputs: int):
        self._wms: dict[int, Optional[Watermark]] = {i: None for i in range(n_inputs)}

    def set(self, input_index: int, wm: Watermark) -> None:
        if input_index in self._wms:
            self._wms[input_index] = wm

    def remove(self, input_index: int) -> None:
        self._wms.pop(input_index, None)

    def merged(self) -> Optional[Watermark]:
        """None until every live input has reported; Idle only if all idle."""
        if not self._wms:
            return None
        values = list(self._wms.values())
        if any(v is None for v in values):
            return None
        non_idle = [v.value for v in values if not v.is_idle]
        if not non_idle:
            return Watermark.idle()
        return Watermark.event_time(min(non_idle))


class SourceContext:
    """What a SourceOperator.run sees: control polling between batches and
    the checkpoint helper."""

    def __init__(self, task: "Task"):
        self._task = task
        self.ctx = task.ctx

    def poll_control(self) -> Optional[ControlMessage]:
        # sources poll between batches: this is their liveness beat
        # (Engine.heartbeat) and their time-based coalescing flush
        self._task.last_progress = time.monotonic()
        self._task.collector.flush_expired(self._task.last_progress)
        if self._task.profiler is not None:
            # incremental self-time: a live snapshot shows a streaming
            # source's busy%, not only after run() returns
            self._task.profiler.source_tick()
            self._task.profiler.refresh()
        try:
            return self._task.control_queue.get_nowait()
        except _queue.Empty:
            return None

    def start_checkpoint(self, barrier: CheckpointBarrier) -> None:
        self._task.run_source_checkpoint(barrier)


class Task:
    def __init__(
        self,
        task_info: TaskInfo,
        operator: Union[Operator, SourceOperator],
        inbox: Optional[TaskInbox],
        collector: Collector,
        ctx: OperatorContext,
        resp_queue: "_queue.Queue[ControlResp]",
        n_inputs: int = 0,
    ):
        self.task_info = task_info
        self.operator = operator
        self.inbox = inbox
        self.collector = collector
        self.ctx = ctx
        self.resp_queue = resp_queue
        self.n_inputs = n_inputs
        self.control_queue: "_queue.Queue[ControlMessage]" = _queue.Queue()
        self.thread: Optional[threading.Thread] = None
        # True when the loop drained cleanly (end of data, or checkpoint-
        # then-stop): only such a finish may stand in for epoch coverage
        self.finished_clean = True
        # the run loop's last beat (Engine.heartbeat reads the stalest)
        # concurrency: single-writer — monotonic heartbeat timestamp owned by the task thread; watchdog reads are GIL-atomic float snapshots and only ever see a slightly stale beat
        self.last_progress = time.monotonic()
        # the epoch being snapshotted (None otherwise): an exception
        # mid-checkpoint stamps its OPERATOR_PANIC event with it
        self._ckpt_epoch: Optional[int] = None
        from ..graph import EdgeType
        from ..metrics import registry
        from ..obs.profile import make_profiler

        self.metrics = registry.task(task_info.job_id, task_info.node_id,
                                     task_info.subtask_index)
        self.is_source = isinstance(operator, SourceOperator)
        # built after the engine restored the tables, so the sketch resumes
        # the summary the checkpoint holds; None with profile.enabled off
        self.profiler = make_profiler(self.metrics, task_info, ctx.table_manager, operator)
        # one key space per sketch: an operator that keyed-shuffles its
        # output is observed at the collector's shuffle boundary; only an
        # operator that does not observes its keyed input
        self.observe_input_keys = not any(
            len(e.dests) > 1 and e.edge_type != EdgeType.FORWARD
            for e in collector.out_edges)
        if inbox is not None:
            self.metrics.queue_size = inbox.row_budget * inbox.n_inputs
            self.metrics.queue_rem = self.metrics.queue_size  # an idle queue is empty
            inbox.metrics = self.metrics
        collector.metrics = self.metrics
        # terminal operators (sinks) observe end-to-end event latency
        self._terminal = not collector.out_edges

    def _observe_sink_latency(self, batch: Batch) -> None:
        """Wall clock at arrival minus the batch's newest event time (s)."""
        if TIMESTAMP_FIELD not in batch:
            return
        ts_max = batch[TIMESTAMP_FIELD].max()
        self.metrics.sink_event_latency.observe(max(0.0, time.time() - float(ts_max) / 1e6))

    def start(self) -> None:
        name = f"{self.task_info.node_id}-{self.task_info.subtask_index}"
        self.thread = threading.Thread(target=self._run_guarded, name=name, daemon=True)
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread:
            self.thread.join(timeout)

    def _resp(self, kind: str, **kw) -> None:
        self.resp_queue.put(
            ControlResp(kind=kind, node_id=self.task_info.node_id,
                        subtask_index=self.task_info.subtask_index, **kw)
        )

    def _beat(self) -> None:
        self.last_progress = time.monotonic()

    def _run_guarded(self) -> None:
        try:
            # a producer blocked on a full inbox is backpressured, not hung:
            # the inbox's budget wait loop beats through this thread hook
            threading.current_thread().arroyo_beat = self._beat  # type: ignore[attr-defined]
            self._resp("task_started")
            if self.is_source:
                self._run_source()
            else:
                self._run_operator()
            self._resp("task_finished", clean=self.finished_clean)
        except Exception:  # noqa: BLE001 - reported to the engine, which aborts the job
            tb = traceback.format_exc()
            # the event before the failure propagates: the feed names the
            # node and subtask (and the epoch, mid-checkpoint) with a stable
            # digest of the traceback
            from ..obs.events import recorder, traceback_digest

            dig = traceback_digest(tb)
            recorder.record(
                self.task_info.job_id, "ERROR", "OPERATOR_PANIC",
                message=dig["error"] or "operator raised",
                node=self.task_info.node_id, subtask=self.task_info.subtask_index,
                epoch=self._ckpt_epoch,
                data={"digest": dig["digest"], "operator": self.task_info.operator_name})
            self._resp("task_failed", error=tb)

    def _run_source(self) -> None:
        op: SourceOperator = self.operator  # type: ignore[assignment]
        prof = self.profiler
        op.on_start(self.ctx)
        if prof is None:
            finish = op.run(SourceContext(self), self.collector)
            op.on_close(self.ctx, self.collector)
        else:
            # thread-CPU accrues through source_tick on the poll path; this
            # first tick stamps the mark, the one after run() the tail
            prof.source_tick()
            finish = op.run(SourceContext(self), self.collector)
            prof.source_tick()
            t0 = prof.begin()
            op.on_close(self.ctx, self.collector)
            prof.end("close", t0)
            prof.refresh(force=True)
        if finish == SourceFinishType.GRACEFUL:
            # the drained offset, so that a restore from any later epoch does
            # not replay this source (its state is constant after end of
            # data, and everything it emitted precedes downstream barriers)
            if prof is not None:
                prof.checkpoint_sketch()
            self.ctx.table_manager.checkpoint("final", self.ctx.watermark())
            self.collector.broadcast(Signal.end_of_data())
        elif finish == SourceFinishType.FINAL:
            # checkpoint-then-stop: the barrier went out; end the data
            self.collector.broadcast(Signal.end_of_data())
        else:
            # stopped: no final snapshot, so this exit is no epoch coverage
            self.finished_clean = False
            self.collector.broadcast(Signal.stop())

    def _checkpoint_event(self, epoch: int, event_type: str) -> None:
        self._resp("checkpoint_event", checkpoint_event=CheckpointEvent(
            epoch, self.task_info.node_id, self.task_info.subtask_index,
            int(time.time() * 1e6), event_type))

    def _snapshot(self, barrier: CheckpointBarrier, t0: Optional[tuple] = None) -> None:
        """Write the tables (the sketch first), send the barrier on, report
        the epoch. The operator's snapshot reads have finished on the task's
        stream before the tables are written (they write host copies). With
        the profiler, ``t0`` opened the checkpoint's self-time, which ends
        once the tables are written, before the gauges refresh."""
        prof = self.profiler
        if prof is not None:
            prof.checkpoint_sketch()
        meta = self.ctx.table_manager.checkpoint(barrier.epoch, self.ctx.watermark())
        if prof is not None:
            prof.end("checkpoint", t0)
            if self.is_source:
                # the snapshot's CPU went to "checkpoint": the source's
                # rolling process clock must not count it again
                prof.source_reset()
            # barrier time is when the host tables mirror device state: the
            # freshest moment for the state-size gauges
            prof.refresh(force=True)
        # fault site: a crash here is the worst case, the subtask's state
        # files for this epoch written but the epoch never complete (no job
        # marker), so recovery must ignore them and restore the epoch before
        fault_point("worker", barrier=barrier.epoch, node=self.task_info.node_id,
                    subtask=self.task_info.subtask_index)
        self.collector.broadcast(Signal.barrier_of(barrier))
        self._ckpt_epoch = None
        self._resp("checkpoint_completed", epoch=barrier.epoch, subtask_metadata=meta)

    def run_source_checkpoint(self, barrier: CheckpointBarrier) -> None:
        """A source's checkpoint: its tables (the caller stored its offset
        first), then the barrier downstream."""
        self._checkpoint_event(barrier.epoch, "started_checkpointing")
        self._ckpt_epoch = barrier.epoch
        prof = self.profiler
        t0 = prof.begin() if prof is not None else None
        self._snapshot(barrier, t0)

    def _run_operator(self) -> None:
        op: Operator = self.operator  # type: ignore[assignment]
        prof = self.profiler
        op.on_start(self.ctx)
        # whole-segment compilation (engine/segment.py): a chained run marked
        # compilable at plan time processes batches through ONE fused kernel
        # launch instead of the per-member hook loop; the runner owns
        # build/verify/fallback and delegates to op.process_batch when the
        # segment is (or becomes) interpreted. Signals take the hooks.
        from .segment import runner_for

        runner = runner_for(op, self.ctx, self.metrics)
        process = op.process_batch if runner is None else runner.process_batch
        holder = WatermarkHolder(self.n_inputs)
        finished: set[int] = set()
        blocked: set[int] = set()  # inputs that delivered the current barrier
        held: dict[int, deque] = {}  # their items since, in order
        barrier_inputs: set[int] = set()
        current_barrier: Optional[CheckpointBarrier] = None
        pending: deque[tuple[int, Union[Batch, Signal]]] = deque()  # released held items
        last_merged: Optional[Watermark] = None
        stopping = False
        stop_epoch: Optional[int] = None
        tick_us = op.tick_interval_micros()
        tick_s = tick_us / 1e6 if tick_us else None
        last_tick = time.monotonic()

        def merged_watermark_changed():
            nonlocal last_merged
            merged = holder.merged()
            if merged is not None and merged != last_merged:
                last_merged = merged
                self.ctx.last_watermark = merged
                if not merged.is_idle:
                    # the lag gauge's watermark (lag is derived at export)
                    self.metrics.watermark_micros = merged.value
                # watermark handling (window closes) is data-path work
                t0 = prof.begin() if prof is not None else None
                out = op.handle_watermark(merged, self.ctx, self.collector)
                if prof is not None:
                    prof.end("process", t0)
                if out is not None:
                    self.collector.broadcast(Signal.watermark_of(out))

        def run_checkpoint(b: CheckpointBarrier):
            self._checkpoint_event(b.epoch, "started_checkpointing")
            self._ckpt_epoch = b.epoch
            t0 = prof.begin() if prof is not None else None
            op.handle_checkpoint(b, self.ctx, self.collector)
            self._snapshot(b, t0)

        def try_complete_alignment():
            """Once every live input delivered the barrier: checkpoint, then
            release the held inputs in order (honoring checkpoint-then-stop)."""
            nonlocal current_barrier, stopping, stop_epoch
            if current_barrier is None:
                return
            live = set(range(self.n_inputs)) - finished
            if live <= barrier_inputs:
                run_checkpoint(current_barrier)
                if current_barrier.then_stop:
                    stopping = True
                    stop_epoch = current_barrier.epoch
                current_barrier = None
                barrier_inputs.clear()
                blocked.clear()
                for i in sorted(held):
                    pending.extend(held[i])
                held.clear()

        def drain_control():
            """Commits arrive here once the epoch's job metadata is durable."""
            while True:
                try:
                    msg = self.control_queue.get_nowait()
                except _queue.Empty:
                    return
                if msg.kind == "commit" and msg.epoch is not None:
                    op.handle_commit(msg.epoch, self.ctx)

        while True:
            self.last_progress = time.monotonic()
            drain_control()
            self.collector.flush_expired(self.last_progress)
            if pending:
                idx, item = pending.popleft()
            else:
                timeout = 0.5
                if tick_s is not None:
                    timeout = min(timeout, max(tick_s - (time.monotonic() - last_tick), 0.0))
                deadline_f = self.collector.flush_deadline()
                if deadline_f is not None:
                    timeout = min(timeout, max(deadline_f - time.monotonic(), 0.0))
                got = self.inbox.get(timeout=timeout) if self.inbox else None
                if got is None:
                    if self.inbox is not None and self.inbox.closed:
                        self.finished_clean = False
                        return  # engine aborted the pipeline
                    if tick_s is not None and time.monotonic() - last_tick >= tick_s:
                        t0 = prof.begin() if prof is not None else None
                        op.handle_tick(self.ctx, self.collector)
                        if prof is not None:
                            prof.end("tick", t0)
                        last_tick = time.monotonic()
                    if prof is not None:
                        prof.refresh()  # idle wait: the throttled gauge sweep
                    if self.n_inputs == 0 or len(finished) == self.n_inputs:
                        break
                    continue
                idx, item = got
            if idx in blocked:
                held.setdefault(idx, deque()).append((idx, item))
                continue
            if isinstance(item, Batch):
                self.metrics.add("arroyo_worker_batches_recv")
                self.metrics.add("arroyo_worker_messages_recv", item.num_rows)
                self.metrics.add("arroyo_worker_bytes_recv", item.nbytes())
                if prof is None:
                    process(item, self.ctx, self.collector, input_index=idx)
                else:
                    if self.observe_input_keys and KEY_FIELD in item:
                        prof.observe_keys(item.keys)  # the keyed-insert boundary
                    t0 = prof.begin()
                    process(item, self.ctx, self.collector, input_index=idx)
                    prof.end("process", t0)
                if self._terminal and item.num_rows:
                    self._observe_sink_latency(item)
                self.inbox.release(idx, item)
                self.metrics.queue_rem = self.metrics.queue_size - self.inbox.used_rows()
                continue
            sig: Signal = item
            if sig.kind == SignalKind.WATERMARK:
                holder.set(idx, sig.watermark)
                merged_watermark_changed()
            elif sig.kind == SignalKind.BARRIER:
                b = sig.barrier
                if current_barrier is not None and b.epoch < current_barrier.epoch:
                    continue  # a straggler of an abandoned epoch
                if current_barrier is not None and b.epoch > current_barrier.epoch:
                    # a newer epoch overtook an alignment that never
                    # finished: abandon it and replay the held items (the
                    # blocked inputs' newer barriers are among them)
                    current_barrier = None
                    barrier_inputs.clear()
                    blocked.clear()
                    for i in sorted(held):
                        pending.extend(held[i])
                    held.clear()
                if current_barrier is None:
                    current_barrier = b
                    self._checkpoint_event(b.epoch, "started_alignment")
                barrier_inputs.add(idx)
                blocked.add(idx)
                try_complete_alignment()
            elif sig.kind == SignalKind.END_OF_DATA:
                finished.add(idx)
                holder.remove(idx)
                merged_watermark_changed()
                if len(finished) == self.n_inputs:
                    t0 = prof.begin() if prof is not None else None
                    op.on_close(self.ctx, self.collector)
                    if prof is not None:
                        prof.end("close", t0)
                        prof.refresh(force=True)
                    self.collector.broadcast(Signal.end_of_data())
                    break
                try_complete_alignment()  # a pending alignment may be complete now
            elif sig.kind == SignalKind.STOP:
                # hard stop: state since the last barrier is not persisted
                self.finished_clean = False
                self.collector.broadcast(Signal.stop())
                break
            if stopping:
                # checkpoint-then-stop: what follows the stopping barrier is
                # past the snapshot and is not processed. A committing
                # operator first waits for the stopping epoch's commit.
                if op.is_committing() and stop_epoch is not None:
                    deadline = time.monotonic() + 30
                    committed = False
                    while time.monotonic() < deadline and not committed:
                        try:
                            msg = self.control_queue.get(timeout=0.1)
                        except _queue.Empty:
                            continue
                        if msg.kind == "commit" and msg.epoch is not None:
                            op.handle_commit(msg.epoch, self.ctx)
                            committed = msg.epoch == stop_epoch
                break
