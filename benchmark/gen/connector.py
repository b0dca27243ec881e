"""The load generator and the result tap as connectors of the system under
test: a source that makes its events inside the source task, a batch at a
time (as Arroyo's ``nexmark`` connector does), paced by a ``Feed``; and a
sink that stamps each batch of results with the wall time it arrived.

Registered under the benchmark's own names, so the system's own connectors
are neither used nor changed. Importing this module imports the system.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from arroyo_tpu_torch.batch import Batch
from arroyo_tpu_torch.connectors import register_sink, register_source
from arroyo_tpu_torch.operators.base import Operator, SourceOperator, TableSpec
from arroyo_tpu_torch.types import SourceFinishType

SOURCE = "benchmark_generator"
SINK = "benchmark_tap"


class GeneratorSource(SourceOperator):
    """config: ``feed`` (gen/feed.py). Its ``"s"`` table holds the events
    emitted so far, written at every checkpoint, as the nexmark source's."""

    def __init__(self, cfg: dict):
        self.feed = cfg["feed"]

    def tables(self):
        return [TableSpec("s", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        feed = self.feed
        sub = sctx.ctx.task_info.subtask_index
        tbl = sctx.ctx.table_manager.global_keyed("s")
        i = tbl.get(sub, 0)

        def control():
            msg = sctx.poll_control()
            if msg is None:
                return None
            if msg.kind == "checkpoint":
                tbl.insert(sub, i)
                sctx.start_checkpoint(msg.barrier)
                if msg.barrier.then_stop:
                    return SourceFinishType.FINAL
            elif msg.kind == "stop":
                return SourceFinishType.IMMEDIATE
            return None

        while not feed.go.wait(0.005):
            r = control()
            if r is not None:
                return r
        while True:
            r = control()
            if r is not None:
                return r
            n = feed.take(i)
            if n is None:
                break
            if n == 0:
                feed.wait()
                continue
            collector.collect(Batch(feed.generator.events(i, i + n)))
            i += n
            feed.emitted(i)
        tbl.insert(sub, i)
        return SourceFinishType.GRACEFUL


class TapSink(Operator):
    """config: ``arrivals``, a list that gets ``(wall time, {column:
    array})`` for every batch of results, the columns copied."""

    def __init__(self, cfg: dict):
        self.arrivals: list = cfg["arrivals"]
        self._lock = cfg.setdefault("_lock", threading.Lock())

    def process_batch(self, batch, ctx, collector, input_index=0):
        now = time.perf_counter()
        cols = {k: np.array(v) for k, v in batch.columns.items() if not k.startswith("_")}
        with self._lock:
            self.arrivals.append((now, cols))


register_source(SOURCE)(GeneratorSource)
register_sink(SINK)(TapSink)
