"""Collector: output routing, keyed repartition and micro-batch coalescing
(the port's copy of arroyo_tpu/operators/collector.py).

Keyed shuffles hash routing keys to subtasks with ``servers_for_hashes``
(contiguous u64 ranges), group rows stably by destination (the native host
library's counting sort, ``native.partition``, or numpy's stable argsort:
the same order) and slice; unkeyed shuffles send rotating even slices.
Signals go to every output partition. With task metrics attached
(``metrics``, set by the task) every routed batch counts into the sent
counters and the emitted-batch-size histogram, and a keyed shuffle feeds
the task's key-skew sketch (obs/sketch.py) at the shuffle boundary.

Coalescing: sub-threshold output batches accumulate here until
``engine.coalesce.max-rows``/``max-bytes`` trips, the oldest pending row is
older than ``max-delay-ms`` (the task run loop polls ``flush_expired``), or
-- always, and first -- a signal is broadcast, so watermarks and end-of-data
never overtake the rows emitted before them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from ..batch import KEY_FIELD, Batch
from ..graph import EdgeType
from ..hashing import servers_for_hashes
from ..types import Signal

if TYPE_CHECKING:
    from ..engine.queues import TaskInbox


@dataclass
class OutEdge:
    """One logical out-edge: destinations are the downstream subtask inboxes,
    with this producer's flat input index at each destination."""

    edge_type: EdgeType
    dests: Sequence[TaskInbox]
    dest_input_index: Sequence[int]  # parallel to dests: our input idx there


class Collector:
    def __init__(self, out_edges: list[OutEdge], subtask_index: int):
        from ..config import config

        self.out_edges = out_edges
        self.subtask_index = subtask_index
        # decorrelate round-robin starts across producers without
        # randomness: a replay must route exactly as the first run did
        self._rr_offset = (subtask_index * 0x9E3779B1) & 0xFFFF
        c = config()
        self.coalesce = bool(c.get("engine.coalesce.enabled", True))
        self.co_max_rows = int(c.get("engine.coalesce.max-rows", 4096))
        self.co_max_bytes = int(c.get("engine.coalesce.max-bytes", 1 << 20))
        self.co_max_delay_s = float(c.get("engine.coalesce.max-delay-ms", 5)) / 1e3
        self._pending: list[Batch] = []
        self._pending_rows = 0
        self._pending_bytes = 0
        self._pending_since = 0.0
        self._pending_cols: frozenset = frozenset()
        self.metrics = None  # TaskMetrics of the producing task

    def collect(self, batch: Batch) -> None:
        if batch.num_rows == 0:
            return
        if not self.coalesce:
            self._route(batch)
            return
        if self._pending and self._pending_cols != frozenset(batch.columns):
            # schema change between emits (e.g. an outer join's matched vs
            # padded shapes): never concat across it
            self.flush()
        if not self._pending and batch.num_rows >= self.co_max_rows:
            self._route(batch)  # already full-size: skip the copy
            return
        if not self._pending:
            self._pending_since = time.monotonic()
            self._pending_cols = frozenset(batch.columns)
        self._pending.append(batch)
        self._pending_rows += batch.num_rows
        self._pending_bytes += batch.nbytes()
        if (self._pending_rows >= self.co_max_rows
                or self._pending_bytes >= self.co_max_bytes):
            self.flush()

    def flush(self) -> None:
        """Route everything pending as one coalesced batch."""
        if not self._pending:
            return
        batches, self._pending = self._pending, []
        self._pending_rows = self._pending_bytes = 0
        self._route(Batch.concat(batches))

    def flush_expired(self, now: float | None = None) -> None:
        """Time-based flush: called from the task run loop between items so
        a lull in traffic cannot hold sub-threshold rows forever."""
        if self._pending and (now or time.monotonic()) - self._pending_since \
                >= self.co_max_delay_s:
            self.flush()

    def flush_deadline(self) -> Optional[float]:
        """Monotonic time by which pending rows must flush (None when
        nothing is pending). The run loop bounds its queue wait with this so
        the max-delay-ms contract holds without reaching into internals."""
        if not self._pending:
            return None
        return self._pending_since + self.co_max_delay_s

    def _route(self, batch: Batch) -> None:
        if self.metrics is not None:
            self.metrics.add("arroyo_worker_batches_sent")
            self.metrics.add("arroyo_worker_messages_sent", batch.num_rows)
            self.metrics.add("arroyo_worker_bytes_sent", batch.nbytes())
            self.metrics.emit_batch_rows.observe(batch.num_rows)
        for edge in self.out_edges:
            n = len(edge.dests)
            if n == 1:
                edge.dests[0].put(edge.dest_input_index[0], batch)
            elif edge.edge_type == EdgeType.FORWARD:
                d = self.subtask_index % n
                edge.dests[d].put(edge.dest_input_index[d], batch)
            elif KEY_FIELD in batch:
                self._shuffle_keyed(batch, edge)
            else:
                self._shuffle_round_robin(batch, edge)

    def _shuffle_keyed(self, batch: Batch, edge: OutEdge) -> None:
        n = len(edge.dests)
        if self.metrics is not None and self.metrics.sketch is not None:
            # the shuffle boundary is where a hot key melts one downstream
            # subtask; at sample-every 1 the sketch counts every row once,
            # however coalescing draws the batches
            self.metrics.sketch.observe(batch.keys)
        from .. import native

        part = native.partition(batch.keys, n)
        if part is not None:
            order, bounds = part
        else:
            dests = servers_for_hashes(batch.keys, n)
            order = np.argsort(dests, kind="stable")
            bounds = np.searchsorted(dests[order], np.arange(n + 1))
        sorted_batch = batch.take(order)
        for d in range(n):
            lo, hi = bounds[d], bounds[d + 1]
            if hi > lo:
                edge.dests[d].put(edge.dest_input_index[d], sorted_batch.slice(lo, hi))

    def _shuffle_round_robin(self, batch: Batch, edge: OutEdge) -> None:
        # rotating even slices
        n = len(edge.dests)
        rows = batch.num_rows
        per = (rows + n - 1) // n
        start_dest = self._rr_offset % n
        self._rr_offset += 1
        for i in range(n):
            lo, hi = i * per, min((i + 1) * per, rows)
            if hi > lo:
                d = (start_dest + i) % n
                edge.dests[d].put(edge.dest_input_index[d], batch.slice(lo, hi))

    def broadcast(self, signal: Signal) -> None:
        """Signals go to every output partition.
        Pending coalesced rows flush FIRST: a signal must never overtake the
        data emitted before it."""
        self.flush()
        for edge in self.out_edges:
            for dest, idx in zip(edge.dests, edge.dest_input_index):
                dest.put(idx, signal)
