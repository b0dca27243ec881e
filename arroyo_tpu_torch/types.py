"""Core dataflow types (the port's copy of arroyo_tpu/types.py).

Timestamps are int64 microseconds since the unix epoch throughout.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Watermark:
    """Event-time watermark; ``value is None`` means the input is idle."""

    value: Optional[int]  # micros, or None for Idle

    @property
    def is_idle(self) -> bool:
        return self.value is None

    @staticmethod
    def event_time(micros: int) -> "Watermark":
        return Watermark(int(micros))

    @staticmethod
    def idle() -> "Watermark":
        return Watermark(None)


@dataclass(frozen=True)
class CheckpointBarrier:
    """Aligned checkpoint barrier flowing with the data."""

    epoch: int
    min_epoch: int = 0
    timestamp: int = 0  # micros
    then_stop: bool = False


class SignalKind(enum.Enum):
    BARRIER = "barrier"
    WATERMARK = "watermark"
    STOP = "stop"
    END_OF_DATA = "end_of_data"


@dataclass(frozen=True)
class Signal:
    """In-band control message interleaved with data batches."""

    kind: SignalKind
    watermark: Optional[Watermark] = None
    barrier: Optional[CheckpointBarrier] = None

    @staticmethod
    def watermark_of(wm: Watermark) -> "Signal":
        return Signal(SignalKind.WATERMARK, watermark=wm)

    @staticmethod
    def barrier_of(b: CheckpointBarrier) -> "Signal":
        return Signal(SignalKind.BARRIER, barrier=b)

    @staticmethod
    def stop() -> "Signal":
        return Signal(SignalKind.STOP)

    @staticmethod
    def end_of_data() -> "Signal":
        return Signal(SignalKind.END_OF_DATA)


class SourceFinishType(enum.Enum):
    """How a source run() ended."""

    GRACEFUL = "graceful"  # emit EndOfData downstream, drain windows
    IMMEDIATE = "immediate"  # stop now (Stop signal)
    FINAL = "final"  # checkpoint-then-stop completed


@dataclass(frozen=True)
class TaskInfo:
    """Identity of one physical subtask."""

    job_id: str
    node_id: str
    operator_name: str
    subtask_index: int
    parallelism: int

    @property
    def key_range(self) -> tuple[int, int]:
        return range_for_server(self.subtask_index, self.parallelism)

    @property
    def task_id(self) -> str:
        return f"{self.node_id}-{self.subtask_index}"


U64_MAX = (1 << 64) - 1


def range_for_server(i: int, n: int) -> tuple[int, int]:
    """Contiguous u64 hash range owned by subtask ``i`` of ``n``, inclusive
    [start, end] (the ranges the keyed shuffle routes by)."""
    if not 0 <= i < n:
        raise ValueError(f"subtask {i} out of range for parallelism {n}")
    size = (U64_MAX // n) + 1
    start = size * i
    end = U64_MAX if i == n - 1 else start + size - 1
    return (start, end)


@dataclass(frozen=True)
class ControlMessage:
    """Engine -> task control: "checkpoint" (with its barrier), "stop" or
    "commit" (with the epoch whose job metadata is durable)."""

    kind: str
    barrier: Optional[CheckpointBarrier] = None
    epoch: Optional[int] = None


@dataclass
class CheckpointEvent:
    checkpoint_epoch: int
    node_id: str
    subtask_index: int
    time_micros: int
    event_type: str  # "started_alignment" | "started_checkpointing"


@dataclass
class ControlResp:
    """Task -> engine status."""

    # task_started | task_finished | task_failed | checkpoint_event |
    # checkpoint_completed
    kind: str
    node_id: str = ""
    subtask_index: int = 0
    error: Optional[str] = None
    checkpoint_event: Optional[CheckpointEvent] = None
    subtask_metadata: Optional[dict] = None  # checkpoint_completed payload
    epoch: int = 0
    # task_finished only: True when the task drained cleanly (end of data,
    # or checkpoint-then-stop), so its state is final and may stand in for
    # epoch coverage; a stopped or aborted task's is not
    clean: bool = True
