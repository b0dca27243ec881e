"""Impulse source (the port's copy of arroyo_tpu/connectors/impulse.py): a
synthetic counter stream at a configured rate.

Schema: counter uint64, subtask_index uint64, _timestamp. Each subtask
counts from 0 up to ``message_count``; event time is ``start_time_micros +
counter * interval_micros``. ``event_rate`` paces the stream (0: as fast as
it goes); ``rate_phases`` replaces it with a piecewise-constant schedule of
total rates (``"10000x30000,40000"``: 10k events/s for the first 30k events,
then 40k events/s), whose events carry their scheduled emission wall time
as event time. The ``"s"`` table holds each subtask's counter (written at
every checkpoint and at end of data; a restore resumes after it) and the
schedule's wall anchor, so a restored scheduled source keeps one schedule
and resumes at its live edge.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..batch import TIMESTAMP_FIELD, Batch
from ..config import config
from ..operators.base import SourceOperator, TableSpec
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


_ANCHOR_KEY = "anchor_us"  # the schedule's wall anchor in the offsets table


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


def _schedule_index_at(offset_us: float, phases, parallelism: int) -> int:
    """Per-subtask event index scheduled at ``offset_us`` past the anchor
    (a restored scheduled source's live edge)."""
    base_i = 0.0
    base_t = 0.0
    for count, rate in phases:
        per_task_rate = max(rate / parallelism, 1e-9)
        if count is None:
            return int(base_i + max(0.0, offset_us - base_t) * per_task_rate / 1e6)
        span = count / parallelism
        phase_end = base_t + span * 1e6 / per_task_rate
        if offset_us < phase_end:
            return int(base_i + max(0.0, offset_us - base_t) * per_task_rate / 1e6)
        base_t = phase_end
        base_i += span
    return int(base_i)


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

    def tables(self):
        return [TableSpec("s", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        p = ctx.task_info.parallelism
        tbl = ctx.table_manager.global_keyed("s")
        batch_size = config().get("pipeline.source-batch-size")
        rate_per_task = self.event_rate / p if self.event_rate else 0
        started = time.monotonic()
        if self.phases is not None:
            # a scheduled source is a load generator, not an exactly-once
            # source: a restart resumes at the schedule's live edge, under
            # the wall anchor of the first run (kept in the offsets table)
            anchor_us = tbl.get(_ANCHOR_KEY)
            if anchor_us is None:
                anchor_us = int(time.time() * 1e6)
                tbl.insert(_ANCHOR_KEY, anchor_us)
            now_wall_us = time.time() * 1e6
            started -= max(0.0, (now_wall_us - anchor_us) / 1e6)
            counter = _schedule_index_at(max(0.0, now_wall_us - anchor_us), self.phases, p)
        else:
            anchor_us = None
            counter = tbl.get(sub, 0)
        # event_rate pacing is relative to the resume point
        pace_base = counter

        def control() -> Optional[SourceFinishType]:
            msg = sctx.poll_control()
            if msg is None:
                return None
            if msg.kind == "checkpoint":
                tbl.insert(sub, counter)
                sctx.start_checkpoint(msg.barrier)
                if msg.barrier.then_stop:
                    return SourceFinishType.FINAL
            elif msg.kind == "stop":
                return SourceFinishType.IMMEDIATE
            return None

        while self.message_count is None or counter < self.message_count:
            r = control()
            if r is not None:
                return r
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
                target = started + (counter - pace_base) / rate_per_task
            else:
                continue
            while True:
                delay = target - time.monotonic()
                if delay <= 0:
                    break
                r = control()
                if r is not None:
                    return r
                time.sleep(min(delay, 0.05))
        # the offset table stays current for the task's "final" snapshot
        tbl.insert(sub, counter)
        return SourceFinishType.GRACEFUL


register_source("impulse")(ImpulseSource)
