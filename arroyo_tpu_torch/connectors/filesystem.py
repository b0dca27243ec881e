"""Filesystem connector (the port's copy of arroyo_tpu/connectors/
filesystem.py): a file source and an exactly-once committing sink, with
partitioning and a Delta Lake table writer on top. Formats: json (lines),
parquet (pyarrow, imported only when a parquet file is read or written),
avro (object container files).

Sink exactly-once protocol (two-phase commit): buffered rows snapshot into
state at every checkpoint; on `commit` of an epoch the rows are written to
``part-{subtask}-{epoch}.{ext}`` via tmp-file + atomic rename, so a crash
between checkpoint and commit replays the write idempotently (same target
name) and uncommitted buffers are restored from state.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import time
import uuid
from typing import Optional

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Schema
from ..config import config
from ..operators.base import Operator, SourceOperator, TableSpec
from ..types import SourceFinishType
from . import register_sink, register_source


def _list_input_files(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in sorted(files))
        return sorted(out)
    matched = sorted(_glob.glob(path))
    return matched if matched else [path]


def _read_file_rows(path: str, fmt: str) -> list[dict]:
    if fmt == "json":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    if fmt == "parquet":
        import pyarrow.parquet as pq

        table = pq.read_table(path, use_threads=False)
        return table.to_pylist()
    if fmt == "avro":
        from ..formats.avro_fmt import read_ocf

        with open(path, "rb") as f:
            _schema, rows = read_ocf(f.read())
        return rows
    raise ValueError(f"filesystem source: unknown format {fmt!r}")


class FileSystemSource(SourceOperator):
    """config: path (file, dir, or glob), format: json|parquet|avro,
    schema, event_time_field, bad_data. State: (file index, row offset) —
    subtask 0 reads (offset survives rescale, like single_file)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.path = str(cfg["path"])
        self.fmt = str(cfg.get("format", "json"))
        self.schema: Schema = cfg["schema"]
        self.event_time_field = cfg.get("event_time_field")

    def tables(self):
        return [TableSpec("f", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        from ..formats.base import rows_to_batch

        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0:
            return SourceFinishType.GRACEFUL
        tbl = ctx.table_manager.global_keyed("f")
        file_idx, row_off = tbl.get("pos", (0, 0))
        files = _list_input_files(self.path)
        batch_size = config().get("pipeline.source-batch-size")
        delay_us = config().get("testing.source-read-delay-micros", 0)
        if delay_us:
            # throttled runs need small chunks so control messages
            # (checkpoints) interleave with the data
            batch_size = min(batch_size, 8)
        while file_idx < len(files):
            rows = _read_file_rows(files[file_idx], self.fmt)
            while row_off < len(rows):
                msg = sctx.poll_control()
                if msg is not None:
                    if msg.kind == "checkpoint":
                        tbl.insert("pos", (file_idx, row_off))
                        sctx.start_checkpoint(msg.barrier)
                        if msg.barrier.then_stop:
                            return SourceFinishType.FINAL
                    elif msg.kind == "stop":
                        return SourceFinishType.IMMEDIATE
                chunk = rows[row_off : row_off + batch_size]
                row_off += len(chunk)
                collector.collect(
                    rows_to_batch(chunk, self.schema, self.event_time_field)
                )
                if delay_us:
                    time.sleep(delay_us / 1e6 * len(chunk))
            file_idx += 1
            row_off = 0
        tbl.insert("pos", (file_idx, 0))
        return SourceFinishType.GRACEFUL


class FileSystemSink(Operator):
    """config: path (output dir), format: json|parquet|avro, schema,
    partition_fields: [col] | None, rollover_rows (default 100k).

    Buffers rows; commits them as immutable part files on the two-phase
    commit of each checkpoint epoch (see module docstring)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.dir = str(cfg["path"])
        self.fmt = str(cfg.get("format", "json"))
        self.schema: Optional[Schema] = cfg.get("schema")
        self.partition_fields: list[str] = list(cfg.get("partition_fields", ()))
        # partition value tuple -> buffered rows
        self.buf: dict[tuple, list[dict]] = {}
        self.pending_commit: dict[int, dict[tuple, list[dict]]] = {}

    def tables(self):
        return [TableSpec("b", "global_keyed")]

    def is_committing(self) -> bool:
        return True

    def on_start(self, ctx):
        tbl = ctx.table_manager.global_keyed("b")
        sub = ctx.task_info.subtask_index
        saved = tbl.get(sub)
        if saved:
            self.buf = {tuple(k): list(v) for k, v in saved.get("buf", [])}
            self.pending_commit = {
                int(e): {tuple(k): list(v) for k, v in groups}
                for e, groups in saved.get("pending", [])
            }
            # a crash after checkpoint but before commit: re-commit now
            # (idempotent: same part-file names)
            for epoch in sorted(self.pending_commit):
                self._write_epoch(ctx, epoch)

    def process_batch(self, batch, ctx, collector, input_index=0):
        rows = batch.to_pylist()
        for r in rows:
            r.pop(KEY_FIELD, None)
            key = tuple(r.get(f) for f in self.partition_fields)
            self.buf.setdefault(key, []).append(r)

    def handle_checkpoint(self, barrier, ctx, collector):
        # phase 1: move the buffer into the epoch's pending-commit set and
        # snapshot everything (reference CommittingState)
        if self.buf:
            self.pending_commit[barrier.epoch] = self.buf
            self.buf = {}
        self._snapshot(ctx)

    def handle_commit(self, epoch, ctx):
        # phase 2: durable write + forget
        self._write_epoch(ctx, epoch)

    def on_close(self, ctx, collector):
        # drain without a final checkpoint: write whatever remains,
        # including checkpointed-but-uncommitted epochs whose commit
        # message raced with task shutdown (idempotent part names)
        for epoch in sorted(self.pending_commit):
            self._write_epoch(ctx, epoch)
        if self.buf:
            epoch = 9_000_000  # "final" drain part, sorts after real epochs
            self.pending_commit[epoch] = self.buf
            self.buf = {}
            self._write_epoch(ctx, epoch)

    # ------------------------------------------------------------------

    def _snapshot(self, ctx) -> None:
        ctx.table_manager.global_keyed("b").insert(
            ctx.task_info.subtask_index,
            {
                "buf": [(list(k), list(v)) for k, v in self.buf.items()],
                "pending": [
                    (e, [(list(k), list(v)) for k, v in groups.items()])
                    for e, groups in self.pending_commit.items()
                ],
            },
        )

    def _partition_dir(self, key: tuple) -> str:
        if not self.partition_fields:
            return self.dir
        parts = [f"{f}={v}" for f, v in zip(self.partition_fields, key)]
        return os.path.join(self.dir, *parts)

    def _write_epoch(self, ctx, epoch: int) -> None:
        groups = self.pending_commit.pop(epoch, None)
        if not groups:
            return
        sub = ctx.task_info.subtask_index
        ext = {"json": "json", "parquet": "parquet", "avro": "avro"}[self.fmt]
        for key, rows in groups.items():
            d = self._partition_dir(key)
            os.makedirs(d, exist_ok=True)
            final = os.path.join(d, f"part-{sub:03d}-{epoch:07d}.{ext}")
            tmp = final + ".tmp"
            self._write_rows(tmp, rows)
            os.replace(tmp, final)

    def _write_rows(self, path: str, rows: list[dict]) -> None:
        drop = {TIMESTAMP_FIELD, KEY_FIELD}
        clean = [{k: v for k, v in r.items() if k not in drop} for r in rows]
        if self.fmt == "json":
            ts_fields = set()
            if self.schema is not None:
                ts_fields = {f.name for f in self.schema.fields if f.dtype == "timestamp"}
            from ..formats.json_fmt import format_iso_micros

            with open(path, "w") as f:
                for r in clean:
                    r = {
                        k: (format_iso_micros(v) if k in ts_fields and v is not None else v)
                        for k, v in r.items()
                    }
                    f.write(json.dumps(r, separators=(",", ":"), default=str) + "\n")
            return
        if self.fmt == "parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq

            names = list(clean[0].keys()) if clean else []
            cols = {n: [r.get(n) for r in clean] for n in names}
            pq.write_table(pa.table(cols), path)
            return
        if self.fmt == "avro":
            from ..formats.avro_fmt import schema_from_table, write_ocf

            if self.schema is None:
                raise ValueError("avro filesystem sink requires a schema")
            asch = schema_from_table(self.schema.fields)
            names = [f["name"] for f in asch.fields]
            with open(path, "wb") as f:
                f.write(write_ocf(asch, [{n: r.get(n) for n in names} for r in clean]))
            return
        raise ValueError(f"filesystem sink: unknown format {self.fmt!r}")


_DELTA_TYPES = {
    "int64": "long", "int32": "integer", "uint64": "long",
    "float64": "double", "float32": "float", "bool": "boolean",
    "string": "string", "timestamp": "timestamp",
}


class DeltaSink(FileSystemSink):
    """Delta Lake table writer: parquet parts plus Delta transaction-log
    commits. Parts land through the same two-phase
    commit as the filesystem sink; each committed epoch then appends one
    version to ``_delta_log`` with its ``add`` actions (version 0 also
    carries ``protocol`` and ``metaData``). Versions are claimed atomically
    with O_EXCL creates, so parallel subtasks committing the same epoch
    serialize instead of clobbering; re-commits after a crash rewrite the
    same deterministic part names, and duplicate ``add`` actions for an
    identical path are a no-op to Delta readers (last action wins)."""

    def __init__(self, cfg: dict):
        cfg = dict(cfg)
        cfg["format"] = "parquet"
        super().__init__(cfg)
        if self.schema is None:
            raise ValueError("delta sink requires a schema")

    def _write_rows(self, path: str, rows: list[dict]) -> None:
        # parquet with proper logical types: Delta declares "timestamp"
        # columns in its schemaString, so the parquet column must carry a
        # timestamp logical type, not raw int64 micros
        import pyarrow as pa
        import pyarrow.parquet as pq

        # Delta protocol: partition column values live in the log's
        # partitionValues and the hive-style directory name, never in the
        # part file itself (readers materialize them; a copy in the file
        # conflicts with the inferred partition field type)
        drop = {TIMESTAMP_FIELD, KEY_FIELD, *self.partition_fields}
        clean = [{k: v for k, v in r.items() if k not in drop} for r in rows]
        ts_fields = {f.name for f in self.schema.fields if f.dtype == "timestamp"}
        names = list(clean[0].keys()) if clean else []
        arrays = []
        for n in names:
            vals = [r.get(n) for r in clean]
            if n in ts_fields:
                arrays.append(pa.array(
                    [None if v is None else int(v) for v in vals],
                    type=pa.timestamp("us"),
                ))
            else:
                arrays.append(pa.array(vals))
        pq.write_table(pa.table(arrays, names=names), path)

    def _schema_string(self) -> str:
        fields = [
            {"name": f.name, "type": _DELTA_TYPES.get(f.dtype, "string"),
             "nullable": True, "metadata": {}}
            for f in self.schema.fields
            if f.name not in (TIMESTAMP_FIELD, KEY_FIELD)
        ]
        return json.dumps({"type": "struct", "fields": fields})

    def _write_epoch(self, ctx, epoch: int) -> None:
        groups = self.pending_commit.pop(epoch, None)
        if not groups:
            return
        sub = ctx.task_info.subtask_index
        adds = []
        now_ms = int(time.time() * 1000)
        for key, rows in groups.items():
            d = self._partition_dir(key)
            os.makedirs(d, exist_ok=True)
            final = os.path.join(d, f"part-{sub:03d}-{epoch:07d}.parquet")
            tmp = final + ".tmp"
            self._write_rows(tmp, rows)
            os.replace(tmp, final)
            rel = os.path.relpath(final, self.dir)
            adds.append({"add": {
                "path": rel.replace(os.sep, "/"),
                "partitionValues": {
                    f: str(v) for f, v in zip(self.partition_fields, key)
                },
                "size": os.path.getsize(final),
                "modificationTime": now_ms,
                "dataChange": True,
            }})
        self._commit_log(adds, now_ms)

    def _commit_log(self, actions: list[dict], now_ms: int) -> None:
        log_dir = os.path.join(self.dir, "_delta_log")
        os.makedirs(log_dir, exist_ok=True)
        while True:
            versions = [
                int(fn.split(".")[0]) for fn in os.listdir(log_dir)
                if fn.endswith(".json") and fn.split(".")[0].isdigit()
            ]
            v = (max(versions) + 1) if versions else 0
            entry = list(actions)
            if v == 0:
                entry = [
                    {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
                    {"metaData": {
                        "id": uuid.uuid4().hex,
                        "format": {"provider": "parquet", "options": {}},
                        "schemaString": self._schema_string(),
                        "partitionColumns": list(self.partition_fields),
                        "configuration": {},
                        "createdTime": now_ms,
                    }},
                ] + entry
            path = os.path.join(log_dir, f"{v:020d}.json")
            # atomic publish: fully write a tmp file, then claim the version
            # with a hard link (fails if another subtask won) — a crash can
            # never leave a truncated version in the log
            tmp = os.path.join(log_dir, f".{uuid.uuid4().hex}.tmp")
            with open(tmp, "w") as f:
                for a in entry:
                    f.write(json.dumps(a, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, path)
            except FileExistsError:
                os.unlink(tmp)
                continue  # another subtask claimed this version; retry
            os.unlink(tmp)
            return


register_source("filesystem")(FileSystemSource)
register_sink("filesystem")(FileSystemSink)
register_sink("delta")(DeltaSink)
