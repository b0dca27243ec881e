"""Impulse source (the port's copy of arroyo_tpu/connectors/impulse.py): a
synthetic counter stream at a configured rate.

Schema: counter uint64, subtask_index uint64, _timestamp. Each subtask
counts from 0 up to ``message_count``; event time is ``start_time_micros +
counter * interval_micros``. ``event_rate`` paces the stream (0: as fast as
it goes); ``rate_phases`` replaces it with a piecewise-constant schedule of
total rates (``"10000x30000,40000"``: 10k events/s for the first 30k events,
then 40k events/s), whose events carry their scheduled emission wall time
as event time. Offsets and the schedule's wall anchor persist in the
offsets table of the JAX package; the port has no checkpoints yet, so every
run starts at counter 0 with the anchor at its own start.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..batch import TIMESTAMP_FIELD, Batch
from ..config import config
from ..operators.base import SourceOperator
from ..types import SourceFinishType
from . import register_source


def parse_rate_phases(spec) -> list[tuple[Optional[int], float]]:
    """``"10000x30000,40000"`` -> ``[(30000, 10000.0), (None, 40000.0)]``:
    comma-separated ``RATExCOUNT`` phases (events/s for the next COUNT
    events, totals across subtasks); a bare RATE runs unbounded. Lists of
    [count, rate] pairs pass through."""
    if isinstance(spec, (list, tuple)):
        return [(None if c is None else int(c), float(r)) for c, r in spec]
    phases: list[tuple[Optional[int], float]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "x" in part:
            rate, count = part.split("x", 1)
            phases.append((int(float(count)), float(rate)))
        else:
            phases.append((None, float(part)))
    if not phases:
        raise ValueError(f"empty rate_phases spec {spec!r}")
    if phases[-1][0] is not None:
        # the schedule must cover every event number: extend the last rate
        phases.append((None, phases[-1][1]))
    return phases


def _schedule_offsets_us(idx: np.ndarray, phases, parallelism: int) -> np.ndarray:
    """Scheduled emission offset (us from the anchor) for per-subtask event
    indices: each subtask owns 1/p of every phase's count and rate."""
    out = np.zeros(len(idx), dtype=np.float64)
    i = idx.astype(np.float64)
    base_i = 0.0
    base_t = 0.0
    for count, rate in phases:
        per_task_rate = max(rate / parallelism, 1e-9)
        if count is None:
            np.copyto(out, base_t + (i - base_i) * 1e6 / per_task_rate, where=i >= base_i)
            break
        span = count / parallelism
        sel = (i >= base_i) & (i < base_i + span)
        np.copyto(out, base_t + (i - base_i) * 1e6 / per_task_rate, where=sel)
        base_t += span * 1e6 / per_task_rate
        base_i += span
    return out


class ImpulseSource(SourceOperator):
    """config: event_rate (rows/s total, 0 = unthrottled), message_count
    (per subtask; None = unbounded), interval_micros (event-time step;
    default derived from event_rate, else 1 ms), start_time_micros,
    rate_phases (piecewise rate schedule, see parse_rate_phases)."""

    def __init__(self, cfg: dict):
        self.event_rate = float(cfg.get("event_rate") or 0)
        self.message_count = (None if cfg.get("message_count") is None
                              else int(cfg["message_count"]))
        start = cfg.get("start_time_micros")
        self.start_time_micros = int(time.time() * 1e6) if start is None else int(start)
        self.phases = parse_rate_phases(cfg["rate_phases"]) if cfg.get("rate_phases") else None
        if cfg.get("interval_micros") is not None:
            self.interval_micros = int(cfg["interval_micros"])
        elif self.event_rate:
            self.interval_micros = max(int(1e6 / self.event_rate), 1)
        else:
            self.interval_micros = 1000

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        p = ctx.task_info.parallelism
        batch_size = config().get("pipeline.source-batch-size")
        rate_per_task = self.event_rate / p if self.event_rate else 0
        started = time.monotonic()
        anchor_us = int(time.time() * 1e6) if self.phases is not None else None
        counter = 0

        def stopped() -> bool:
            msg = sctx.poll_control()
            return msg is not None and msg.kind == "stop"

        while self.message_count is None or counter < self.message_count:
            if stopped():
                return SourceFinishType.IMMEDIATE
            n = batch_size
            if self.message_count is not None:
                n = min(n, self.message_count - counter)
            idx = np.arange(counter, counter + n, dtype=np.uint64)
            if self.phases is not None:
                # scheduled-emission timestamps: latency at the sink reads as
                # "how far behind schedule"
                offs = _schedule_offsets_us(idx.astype(np.int64), self.phases, p)
                ts = anchor_us + offs.astype(np.int64)
            else:
                ts = self.start_time_micros + idx.astype(np.int64) * self.interval_micros
            collector.collect(Batch({
                "counter": idx,
                "subtask_index": np.full(n, sub, dtype=np.uint64),
                TIMESTAMP_FIELD: ts,
            }))
            counter += n
            if self.phases is not None:
                target = started + _schedule_offsets_us(
                    np.array([counter], dtype=np.int64), self.phases, p)[0] / 1e6
            elif rate_per_task:
                target = started + counter / rate_per_task
            else:
                continue
            while True:
                delay = target - time.monotonic()
                if delay <= 0:
                    break
                if stopped():
                    return SourceFinishType.IMMEDIATE
                time.sleep(min(delay, 0.05))
        return SourceFinishType.GRACEFUL


register_source("impulse")(ImpulseSource)
