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


class SignalKind(enum.Enum):
    WATERMARK = "watermark"
    STOP = "stop"
    END_OF_DATA = "end_of_data"


@dataclass(frozen=True)
class Signal:
    """In-band control message interleaved with data batches."""

    kind: SignalKind
    watermark: Optional[Watermark] = None

    @staticmethod
    def watermark_of(wm: Watermark) -> "Signal":
        return Signal(SignalKind.WATERMARK, watermark=wm)

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


@dataclass(frozen=True)
class TaskInfo:
    """Identity of one physical subtask."""

    job_id: str
    node_id: str
    operator_name: str
    subtask_index: int
    parallelism: int

    @property
    def task_id(self) -> str:
        return f"{self.node_id}-{self.subtask_index}"


@dataclass(frozen=True)
class ControlMessage:
    """Engine -> task control: "stop" is the only kind this slice sends."""

    kind: str


@dataclass
class ControlResp:
    """Task -> engine status."""

    kind: str  # task_started | task_finished | task_failed
    node_id: str = ""
    subtask_index: int = 0
    error: Optional[str] = None
