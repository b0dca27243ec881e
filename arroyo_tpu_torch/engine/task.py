"""Physical subtask run loop (the port's copy of arroyo_tpu/engine/task.py,
without checkpoints). A chained operator marked compilable runs its batches
through the compiled-segment runner (engine/segment.py runner_for).

A loop over the inbox and a tick interval: batches go to the operator,
watermarks are min-merged over inputs (idle only when every input is idle),
end-of-data closes the operator once every input has finished, and a stop
ends the task.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import traceback
from typing import Optional, Union

from ..batch import Batch
from ..operators.base import Operator, OperatorContext, SourceOperator
from ..operators.collector import Collector
from ..types import ControlMessage, ControlResp, Signal, SignalKind, SourceFinishType, TaskInfo, Watermark
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
    """What a SourceOperator.run sees: control polling between batches."""

    def __init__(self, task: "Task"):
        self._task = task
        self.ctx = task.ctx

    def poll_control(self) -> Optional[ControlMessage]:
        self._task.collector.flush_expired(time.monotonic())
        try:
            return self._task.control_queue.get_nowait()
        except _queue.Empty:
            return None


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
        from ..metrics import registry

        self.metrics = registry.task(task_info.job_id, task_info.node_id,
                                     task_info.subtask_index)
        self.is_source = isinstance(operator, SourceOperator)

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

    def _run_guarded(self) -> None:
        try:
            self._resp("task_started")
            if self.is_source:
                self._run_source()
            else:
                self._run_operator()
            self._resp("task_finished")
        except Exception:  # noqa: BLE001 - reported to the engine, which aborts the job
            self._resp("task_failed", error=traceback.format_exc())

    def _run_source(self) -> None:
        op: SourceOperator = self.operator  # type: ignore[assignment]
        op.on_start(self.ctx)
        finish = op.run(SourceContext(self), self.collector)
        op.on_close(self.ctx, self.collector)
        if finish == SourceFinishType.GRACEFUL:
            self.collector.broadcast(Signal.end_of_data())
        else:
            self.collector.broadcast(Signal.stop())

    def _run_operator(self) -> None:
        op: Operator = self.operator  # type: ignore[assignment]
        op.on_start(self.ctx)
        # whole-segment compilation (engine/segment.py): a chained run marked
        # compilable at plan time processes batches through ONE fused kernel
        # launch instead of the per-member hook loop; the runner owns
        # build/verify/fallback and delegates to op.process_batch when the
        # segment is (or becomes) interpreted. Signals take the hooks.
        from .segment import runner_for

        runner = runner_for(op, self.ctx, self.metrics)
        process = op.process_batch if runner is None else runner.process_batch
        # the sharded aggregate's residency (task metrics "mesh")
        mesh_stats = getattr(op, "mesh_stats", None)

        def refresh_mesh():
            if mesh_stats is not None:
                stats = mesh_stats()
                if stats is not None:
                    self.metrics.mesh = stats

        holder = WatermarkHolder(self.n_inputs)
        finished: set[int] = set()
        last_merged: Optional[Watermark] = None
        tick_us = op.tick_interval_micros()
        tick_s = tick_us / 1e6 if tick_us else None
        last_tick = time.monotonic()

        def merged_watermark_changed():
            nonlocal last_merged
            merged = holder.merged()
            if merged is not None and merged != last_merged:
                last_merged = merged
                self.ctx.last_watermark = merged
                out = op.handle_watermark(merged, self.ctx, self.collector)
                if out is not None:
                    self.collector.broadcast(Signal.watermark_of(out))

        while True:
            self.collector.flush_expired(time.monotonic())
            timeout = 0.5
            if tick_s is not None:
                timeout = min(timeout, max(tick_s - (time.monotonic() - last_tick), 0.0))
            deadline_f = self.collector.flush_deadline()
            if deadline_f is not None:
                timeout = min(timeout, max(deadline_f - time.monotonic(), 0.0))
            got = self.inbox.get(timeout=timeout) if self.inbox else None
            if got is None:
                if self.inbox is not None and self.inbox.closed:
                    return  # engine aborted the pipeline
                if tick_s is not None and time.monotonic() - last_tick >= tick_s:
                    op.handle_tick(self.ctx, self.collector)
                    last_tick = time.monotonic()
                if self.n_inputs == 0 or len(finished) == self.n_inputs:
                    break
                continue
            idx, item = got
            if isinstance(item, Batch):
                process(item, self.ctx, self.collector, input_index=idx)
                self.inbox.release(idx, item)
                refresh_mesh()
                continue
            sig: Signal = item
            if sig.kind == SignalKind.WATERMARK:
                holder.set(idx, sig.watermark)
                merged_watermark_changed()
            elif sig.kind == SignalKind.END_OF_DATA:
                finished.add(idx)
                holder.remove(idx)
                merged_watermark_changed()
                if len(finished) == self.n_inputs:
                    op.on_close(self.ctx, self.collector)
                    refresh_mesh()
                    self.collector.broadcast(Signal.end_of_data())
                    break
            elif sig.kind == SignalKind.STOP:
                self.collector.broadcast(Signal.stop())
                break
