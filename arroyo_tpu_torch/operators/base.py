"""Operator boundary (the port's copy of arroyo_tpu/operators/base.py).

Operators consume and produce columnar Batches; the task run loop
(engine/task.py) owns barrier alignment, watermark merging and end-of-data
accounting. An operator declares its state tables (``tables``), reads them
back in ``on_start`` after a restore, and writes them in
``handle_checkpoint``, which the task calls at an aligned barrier before
the table manager snapshots them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

import torch

from ..batch import Batch, Schema
from ..types import CheckpointBarrier, SourceFinishType, TaskInfo, Watermark

if TYPE_CHECKING:
    from ..state.tables import TableManager
    from .collector import Collector


@dataclass
class TableSpec:
    """Declares a state table."""

    name: str
    kind: str  # "global_keyed" | "expiring_time_key"
    retention_micros: int = 0
    schema: Optional[Schema] = None


class OperatorContext:
    """Per-subtask context handed to operator hooks. ``device`` is the torch
    device the engine resolved; operators that hold device state build it
    there and nowhere else. ``in_edge_of_input`` maps a flat input index to
    (edge index, upstream subtask); a two-input operator (a join) reads its
    side from it. ``table_manager`` holds the subtask's state tables."""

    def __init__(self, task_info: TaskInfo, device: torch.device,
                 in_edge_of_input: Optional[Callable[[int], tuple[int, int]]] = None,
                 table_manager: "Optional[TableManager]" = None):
        self.task_info = task_info
        self.device = device
        self.table_manager = table_manager
        self.last_watermark: Optional[Watermark] = None
        self._in_edge_of_input = in_edge_of_input or (lambda i: (0, i))

    def edge_of_input(self, input_index: int) -> int:
        return self._in_edge_of_input(input_index)[0]

    def watermark(self) -> Optional[int]:
        """Current event-time watermark in micros (None if idle/unset)."""
        if self.last_watermark is None:
            return None
        return self.last_watermark.value


def persist_mark(ctx: OperatorContext, table: str, value) -> None:
    """Write this subtask's scalar mark (late-data boundary, event-time
    high-water mark) into a global_keyed table, at every barrier: a mark
    carried as a column of a state batch would vanish with an empty
    snapshot."""
    ctx.table_manager.global_keyed(table).insert(ctx.task_info.subtask_index, value)


def restore_marks(ctx: OperatorContext, table: str) -> list:
    """Every prior subtask's non-None mark from a mark table; the caller
    merges them (``max`` for watermark-aligned boundaries)."""
    return [v for _k, v in ctx.table_manager.global_keyed(table).items() if v is not None]


class Operator:
    """Mid-pipeline operator."""

    def name(self) -> str:
        return type(self).__name__

    def tables(self) -> list[TableSpec]:
        return []

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

    def handle_checkpoint(self, barrier: CheckpointBarrier, ctx: OperatorContext,
                          collector: "Collector") -> None:
        """Flush in-flight device and host state into the state tables
        before the table manager snapshots them."""

    def handle_commit(self, epoch: int, ctx: OperatorContext) -> None:
        pass

    def is_committing(self) -> bool:
        return False

    def on_close(self, ctx: OperatorContext, collector: "Collector") -> None:
        """All inputs reached end-of-data; emit any remaining state."""


class SourceOperator:
    """Source: ``run`` drives it and polls ``sctx.poll_control()`` between
    batches, so that a checkpoint or a stop from the engine is seen; on a
    checkpoint it stores its offset and calls ``sctx.start_checkpoint``."""

    def name(self) -> str:
        return type(self).__name__

    def tables(self) -> list[TableSpec]:
        return []

    def is_committing(self) -> bool:
        return False

    def on_start(self, ctx: OperatorContext) -> None:
        pass

    def run(self, sctx, collector: "Collector") -> SourceFinishType:
        raise NotImplementedError

    def on_close(self, ctx: OperatorContext, collector: "Collector") -> None:
        pass
