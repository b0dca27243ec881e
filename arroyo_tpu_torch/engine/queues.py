"""Task inbox with per-input row-budget backpressure (the port's copy of
arroyo_tpu/engine/queues.py).

Each task owns ONE multiplexed inbox; producers tag items with their flat
input index and block while that input's outstanding row budget
(``worker.queue-size``) is exhausted. Budget is released when the consumer
finishes processing the item. Signals never block: they must be able to
overtake a full queue. Items carry their enqueue time: with the consuming
task's metrics attached (``metrics``), each batch popped observes its wall
time in the queue (the queue-transit histogram).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Union

from ..batch import Batch
from ..faults import fault_point
from ..types import Signal

QueueItem = Union[Batch, Signal]


class TaskInbox:
    def __init__(self, n_inputs: int, row_budget: int):
        self.n_inputs = max(n_inputs, 1)
        self.row_budget = row_budget
        self._queue: deque[tuple[int, QueueItem, float]] = deque()
        self._used = [0] * self.n_inputs
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._budget_freed = threading.Condition(self._lock)
        self._closed = False
        self.metrics = None  # TaskMetrics of the consuming task

    def put(self, input_index: int, item: QueueItem) -> None:
        """Blocks while this input's row budget is exhausted (data only)."""
        # fault site: delay models a stalled consumer (backpressure builds
        # upstream through the blocked producer); fail kills the producer
        fault_point("queue.put", input=input_index)
        rows = item.num_rows if isinstance(item, Batch) else 0
        with self._lock:
            if rows:
                while (
                    self._used[input_index] > 0
                    and self._used[input_index] + rows > self.row_budget
                    and not self._closed
                ):
                    self._budget_freed.wait(timeout=0.5)
            if self._closed:
                return
            self._used[input_index] += rows
            self._queue.append((input_index, item, time.monotonic()))
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[tuple[int, QueueItem]]:
        """Pop next item; None on timeout or close-with-empty-queue."""
        with self._lock:
            if not self._queue:
                self._not_empty.wait(timeout=timeout)
            if not self._queue:
                return None
            idx, item, t_enq = self._queue.popleft()
        if self.metrics is not None and isinstance(item, Batch):
            self.metrics.queue_transit.observe(time.monotonic() - t_enq)
        return idx, item

    def release(self, input_index: int, item: QueueItem) -> None:
        """Consumer finished processing; return the rows to the budget."""
        if not isinstance(item, Batch):
            return
        with self._lock:
            self._used[input_index] -= item.num_rows
            self._budget_freed.notify_all()

    def used_rows(self) -> int:
        with self._lock:
            return sum(self._used)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._budget_freed.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
