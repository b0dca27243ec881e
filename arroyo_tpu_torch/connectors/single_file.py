"""single_file connector (the port's copy of the JAX package's
``connectors/single_file.py``): a deterministic line-delimited JSON file
source and sink, the fixture the SQL smoke tests are built on.

The source checkpoints its line offset; the sink buffers rows in state and
writes the file contents on checkpoint/close so restores don't duplicate
output.
"""

from __future__ import annotations

import os
import time

from ..batch import Batch, Schema
from ..config import config
from ..formats.json_fmt import JsonDeserializer, serialize_json_lines
from ..operators.base import Operator, SourceOperator, TableSpec
from ..types import SourceFinishType
from . import register_sink, register_source


class SingleFileSource(SourceOperator):
    """config: path, schema: Schema, event_time_field: str|None,
    bad_data: "fail"|"drop"."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.path = cfg["path"]
        self.schema: Schema = cfg["schema"]
        self.event_time_field = cfg.get("event_time_field")
        self.bad_data = cfg.get("bad_data", "fail")

    def tables(self):
        return [TableSpec("s", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        if sub != 0:
            # only subtask 0 reads the file, so the line offset survives
            # restores at any parallelism.
            # Restore CLONES subtask 0's offset into this subtask's table
            # (global tables merge across shards on load); drop the clone
            # before draining, or our "final" snapshot would persist a stale
            # copy of the reader's offset that a later restore could merge
            # OVER the live one — replaying the file from the stale point
            # while the sink keeps its lines (duplicated output).
            ctx.table_manager.global_keyed("s").data.clear()
            return SourceFinishType.GRACEFUL
        tbl = ctx.table_manager.global_keyed("s")
        offset = tbl.get(sub, 0)
        from ..formats.registry import make_deserializer

        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)
        with open(self.path) as f:
            lines = f.read().splitlines()
        # deterministic split across subtasks: round-robin by line number
        i = offset
        my_lines = lines
        # a test throttle (sleep per line), so a controller test acts while
        # the job is mid-stream
        delay_us = config().get("testing.source-read-delay-micros", 0)
        # deterministic mid-stream gate: after reading half the input,
        # hold — still answering control/checkpoints — until ``gate_epochs``
        # barriers have been processed. Guarantees checkpoints land
        # mid-stream regardless of scheduling, so the restore leg of the
        # smoke harness can never be silently skipped.
        gate_epochs = config().get("testing.source-gate-epochs", 0)
        gate_line = len(my_lines) // 2
        seen_epochs = 0
        while i < len(my_lines):
            if delay_us:
                time.sleep(delay_us / 1e6)
            holding = gate_epochs and seen_epochs < gate_epochs and i >= gate_line
            msg = sctx.poll_control()
            if msg is None and holding:
                time.sleep(0.001)
                continue
            if msg is not None:
                if msg.kind == "checkpoint":
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    tbl.insert(sub, i)
                    sctx.start_checkpoint(msg.barrier)
                    seen_epochs += 1
                    if msg.barrier.then_stop:
                        return SourceFinishType.FINAL
                elif msg.kind == "stop":
                    return SourceFinishType.IMMEDIATE
                if holding:
                    continue
            line = my_lines[i]
            i += 1
            if line.strip():
                de.deserialize(line)
            if de.should_flush():
                b = de.flush()
                if b is not None:
                    collector.collect(b)
        b = de.flush()
        if b is not None:
            collector.collect(b)
        # keep the offset table current: the run loop snapshots it into the
        # "final" checkpoint after a graceful drain
        tbl.insert(sub, i)
        return SourceFinishType.GRACEFUL


class SingleFileSink(Operator):
    """config: path. Buffers emitted lines in a global-keyed state table and
    rewrites the output file at each checkpoint/close (exactly-once)."""

    def __init__(self, cfg: dict):
        self.path = cfg["path"]
        self.schema = cfg.get("schema")
        self.lines: list[str] = []

    def tables(self):
        return [TableSpec("out", "global_keyed")]

    def on_start(self, ctx):
        tbl = ctx.table_manager.global_keyed("out")
        self.lines = list(tbl.get(ctx.task_info.subtask_index, []))

    def process_batch(self, batch, ctx, collector, input_index=0):
        self.lines.extend(serialize_json_lines(batch, self.schema))

    def handle_checkpoint(self, barrier, ctx, collector):
        ctx.table_manager.global_keyed("out").insert(
            ctx.task_info.subtask_index, list(self.lines)
        )
        self._write(ctx)

    def on_close(self, ctx, collector):
        self._write(ctx)

    def _write(self, ctx):
        # each subtask appends to its own shard file; parallelism 1 in tests
        path = self.path
        if ctx.task_info.parallelism > 1:
            path = f"{self.path}.{ctx.task_info.subtask_index}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for line in self.lines:
                f.write(line + "\n")


register_source("single_file")(SingleFileSource)
register_sink("single_file")(SingleFileSink)
