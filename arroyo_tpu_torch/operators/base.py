"""Operator boundary (the port's copy of arroyo_tpu/operators/base.py).

Operators consume and produce columnar Batches; the task run loop
(engine/task.py) owns watermark merging and end-of-data accounting. State
tables are not part of the port yet, and the checkpoint hook raises.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional

import torch

from ..batch import Batch
from ..types import SourceFinishType, TaskInfo, Watermark

if TYPE_CHECKING:
    from .collector import Collector


class OperatorContext:
    """Per-subtask context handed to operator hooks. ``device`` is the torch
    device the engine resolved; operators that hold device state build it
    there and nowhere else. ``in_edge_of_input`` maps a flat input index to
    (edge index, upstream subtask); a two-input operator (a join) reads its
    side from it."""

    def __init__(self, task_info: TaskInfo, device: torch.device,
                 in_edge_of_input: Optional[Callable[[int], tuple[int, int]]] = None):
        self.task_info = task_info
        self.device = device
        self.last_watermark: Optional[Watermark] = None
        self._in_edge_of_input = in_edge_of_input or (lambda i: (0, i))

    def edge_of_input(self, input_index: int) -> int:
        return self._in_edge_of_input(input_index)[0]

    def watermark(self) -> Optional[int]:
        """Current event-time watermark in micros (None if idle/unset)."""
        if self.last_watermark is None:
            return None
        return self.last_watermark.value


class Operator:
    """Mid-pipeline operator."""

    def name(self) -> str:
        return type(self).__name__

    def on_start(self, ctx: OperatorContext) -> None:
        pass

    def process_batch(
        self, batch: Batch, ctx: OperatorContext, collector: "Collector", input_index: int = 0
    ) -> None:
        raise NotImplementedError

    def handle_watermark(
        self, watermark: Watermark, ctx: OperatorContext, collector: "Collector"
    ) -> Optional[Watermark]:
        """Return the watermark to forward downstream, or None to hold it."""
        return watermark

    def tick_interval_micros(self) -> Optional[int]:
        """If set, handle_tick is invoked at roughly this period."""
        return None

    def handle_tick(self, ctx: OperatorContext, collector: "Collector") -> None:
        pass

    def handle_checkpoint(self, barrier, ctx: OperatorContext, collector: "Collector") -> None:
        raise NotImplementedError(
            f"{self.name()}: checkpoint barrier {getattr(barrier, 'epoch', barrier)}: "
            f"checkpoints come with the checkpoint/restore slice of the port "
            f"(ROADMAP queue A)")

    def on_close(self, ctx: OperatorContext, collector: "Collector") -> None:
        """All inputs reached end-of-data; emit any remaining state."""


class SourceOperator:
    """Source: ``run`` drives it and polls ``sctx.poll_control()`` between
    batches so a stop from the engine is seen."""

    def name(self) -> str:
        return type(self).__name__

    def on_start(self, ctx: OperatorContext) -> None:
        pass

    def run(self, sctx, collector: "Collector") -> SourceFinishType:
        raise NotImplementedError

    def on_close(self, ctx: OperatorContext, collector: "Collector") -> None:
        pass
