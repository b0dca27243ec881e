"""Per-task metrics (the port's minimal copy of arroyo_tpu/metrics.py): for
now the compiled segment's state, ``segment_compiled`` (None until a
chained task decides, then True or False), ``segment_reason`` (why a
segment runs interpreted), ``segment_batches`` (batches that ran through
the segment kernel), ``segment_mesh`` (True once the task committed a
micro-batch through the fused mesh step) and ``mesh`` (the sharded
aggregate's ``{"exchange_rows", "overflow_rows"}``, refreshed by the task
loop from the operator's ``mesh_stats`` hook; None off the mesh).
Counters, histograms and their exposition (the arroyo_mesh_* series among
them) are a later slice of the port. ``add_bad_record`` / ``bad_records``
count the records a source's ``bad_data = drop`` policy dropped."""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Optional


class Histogram:
    """Fixed-bucket histogram (single writer): the spill annex's
    files-per-probe counts (state/spill.py)."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets: tuple):
        self.buckets = buckets  # ascending upper bounds; +Inf is implicit
        self.counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class TaskMetrics:
    __slots__ = ("job_id", "node_id", "subtask", "segment_compiled", "segment_reason",
                 "segment_batches", "segment_mesh", "mesh")

    def __init__(self, job_id: str, node_id: str, subtask: int):
        self.job_id = job_id
        self.node_id = node_id
        self.subtask = subtask
        self.segment_compiled: Optional[bool] = None
        self.segment_reason: Optional[str] = None
        self.segment_batches = 0
        self.segment_mesh: Optional[bool] = None
        self.mesh: Optional[dict] = None


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[tuple[str, str, int], TaskMetrics] = {}
        self._bad_records: dict[tuple[str, str], int] = {}

    def add_bad_record(self, job_id: str, operator: str, n: int = 1) -> None:
        key = (job_id, operator)
        with self._lock:
            self._bad_records[key] = self._bad_records.get(key, 0) + int(n)

    def bad_records(self, job_id: str) -> dict[str, int]:
        """operator -> records dropped under ``bad_data = drop`` for one job."""
        with self._lock:
            return {op: n for (j, op), n in self._bad_records.items() if j == job_id}

    def task(self, job_id: str, node_id: str, subtask: int) -> TaskMetrics:
        key = (job_id, node_id, subtask)
        with self._lock:
            tm = self._tasks.get(key)
            if tm is None:
                tm = self._tasks[key] = TaskMetrics(job_id, node_id, subtask)
            return tm

    def job_metrics(self, job_id: str) -> dict:
        """node -> subtask -> the set fields of that task's metrics."""
        out: dict = {}
        with self._lock:
            tasks = [t for k, t in self._tasks.items() if k[0] == job_id]
        for t in tasks:
            entry = {}
            if t.segment_compiled is not None:
                entry["segment_compiled"] = t.segment_compiled
            if t.segment_reason is not None:
                entry["segment_reason"] = t.segment_reason
            if t.segment_mesh is not None:
                entry["segment_mesh"] = t.segment_mesh
            if t.mesh is not None:
                entry["mesh"] = dict(t.mesh)
            out.setdefault(t.node_id, {})[t.subtask] = entry
        return out


registry = MetricsRegistry()
