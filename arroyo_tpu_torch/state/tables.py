"""Keyed and timed state tables with columnar checkpoints (the port's copy of
arroyo_tpu/state/tables.py).

The checkpoint layout is the JAX package's, so a checkpoint of either
package restores in the other:

    {storage}/{job}/checkpoints/checkpoint-{epoch:07d}/operator-{node}/
        table-{name}-{subtask:03d}.bin    a global_keyed table (a pickled dict)
        table-{name}-{subtask:03d}.npz    an expiring_time_key table (columns)
        metadata-{subtask:03d}.json       the subtask's sidecar, self-checksummed
    {storage}/{job}/checkpoints/checkpoint-{epoch:07d}/metadata.json
                                          the job marker (the commit point)

Restore filters the columnar files by retention against the restored
watermark and by the restoring subtask's routing-key range, which is what
makes a restore at another parallelism work. A drained source's state comes
from the ``"final"`` snapshot it writes at end of data.

The port writes the npz codec for either value of ``checkpoint.file-format``
("parquet", the default, or "npz"), as the JAX package itself does where
pyarrow is missing, as on the card; another value is refused. Reading a
``.parquet`` state file raises. Values pickled into a global_keyed table
are built-in Python and numpy values only, and a pickle naming anything
else is refused, so neither package ever unpickles the other's classes.

Compaction (``compact_operator`` / ``compact_job``) merges an epoch's
per-subtask files into one generation-1 file per table,
``table-{name}-compacted-g1.{ext}``, listed by the lowest subtask's
metadata; that metadata write is the commit point, and a restore ignores a
directory's generation-0 entries of a table once it holds a generation-1
one. An evolution mapping (analysis/plan_diff.py ``diff_plans``) rides as
the sidecar ``checkpoints/evolution-{epoch:07d}.json`` and redirects a
restore node by node.
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
from typing import Any, Iterable, Optional

import numpy as np

from ..batch import KEY_FIELD, Batch, object_column
from ..types import TaskInfo
from . import storage

_log = logging.getLogger("arroyo_tpu_torch.state")


class RestoreError(RuntimeError):
    """A restore-path read failed: the epoch, the operator, the artifact
    path and the cause (an IntegrityError, a codec error, a missing file)."""

    def __init__(self, epoch, operator: str, path: str, cause: Exception):
        super().__init__(
            f"restore of operator {operator!r} from epoch {epoch} failed "
            f"at {path}: {cause}")
        self.epoch = epoch
        self.operator = operator
        self.path = path
        self.cause = cause


def _should_verify(restore: bool = False) -> bool:
    """Whether a read verifies its envelope, per ``state.integrity.verify``:
    off = never, always = every read, restore (default) = restore reads."""
    mode = storage.verify_mode()
    if mode == "off":
        return False
    if mode == "always":
        return True
    return restore


def dump_json_with_integrity(obj: dict) -> str:
    """A JSON artifact with an embedded ``__integrity__`` envelope over its
    canonical (sorted-keys) form: it verifies without a sidecar."""
    body = json.dumps(obj, sort_keys=True)
    env = storage.checksum_of(body.encode("utf-8"))
    return json.dumps({**obj, "__integrity__": env})


def load_json_with_integrity(text: str, path: str, verify: bool) -> dict:
    """Parse a JSON artifact, verifying its embedded envelope when asked (an
    artifact without one passes). Raises storage.IntegrityError."""
    obj = json.loads(text)
    env = obj.pop("__integrity__", None)
    if env is not None and verify:
        storage.verify_envelope(json.dumps(obj, sort_keys=True).encode("utf-8"), env, path)
    return obj


class _ValuesUnpickler(pickle.Unpickler):
    """Unpickles built-in and numpy values only: a table pickle that names
    another module's class is refused rather than imported."""

    def find_class(self, module: str, name: str):
        if module == "builtins" or module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"state value of type {module}.{name}: checkpoint tables hold built-in "
            f"and numpy values only")


def loads_values(data: bytes):
    return _ValuesUnpickler(io.BytesIO(data)).load()


def _checkpoint_format() -> str:
    """The codec ``checkpoint.file-format`` asks for, as the JAX package
    resolves it where pyarrow is missing: "parquet" falls back to npz, "npz"
    is npz, and any other value is refused."""
    from ..config import config

    fmt = config().get("checkpoint.file-format", "parquet")
    if fmt not in ("parquet", "npz"):
        raise ValueError(f"checkpoint.file-format = {fmt!r}: expected 'parquet' or 'npz'")
    return "npz"


def write_columnar(path: str, columns: dict, footer: bool = False) -> dict:
    """Write named columns as npz; object columns ride a pickled sidecar
    array (``__objcols__``) with their python values. Returns the integrity
    envelope of the written bytes; ``footer=True`` instead appends the
    self-describing integrity trailer (storage.wrap_footer), for spill runs,
    which outlive any one epoch's manifest."""
    _checkpoint_format()
    dense = {}
    objcols: dict[str, list] = {}
    for name, col in columns.items():
        if col.dtype == object:
            objcols[name] = [v.item() if isinstance(v, np.generic) else v for v in col]
        else:
            dense[name] = col
    if objcols:
        dense["__objcols__"] = np.frombuffer(pickle.dumps(objcols), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **dense)
    payload = buf.getvalue()
    if footer:
        payload = storage.wrap_footer(payload)
    return storage.write_bytes(path, payload)


def read_columnar(path: str, expect: Optional[dict] = None, restore: bool = False) -> dict:
    """Read a columnar state file. ``expect`` is the envelope a manifest
    recorded for it; verification follows ``state.integrity.verify``
    (``restore`` marks a restore-path read)."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"state file {path}: the port reads the npz codec only; parquet state "
            f"files need pyarrow, which the port does not use")
    verify = _should_verify(restore)
    data = storage.read_bytes(path)
    if expect is not None and verify and "crc" in expect:
        storage.verify_envelope(data, expect, path)
    data = storage.unwrap_footer(data, path, verify=verify)
    npz = np.load(io.BytesIO(data), allow_pickle=False)
    cols = {name: npz[name] for name in npz.files if name != "__objcols__"}
    if "__objcols__" in npz.files:
        objcols = loads_values(npz["__objcols__"].tobytes())
        for name, vals in objcols.items():
            cols[name] = object_column(vals)
    return cols


def checkpoint_dir(storage_url: str, job_id: str, epoch) -> str:
    """epoch: an int, or "final" for a drained source's snapshot."""
    name = f"checkpoint-{epoch:07d}" if isinstance(epoch, int) else f"checkpoint-{epoch}"
    return os.path.join(storage_url, job_id, "checkpoints", name)


def operator_dir(storage_url: str, job_id: str, epoch, node_id: str) -> str:
    return os.path.join(checkpoint_dir(storage_url, job_id, epoch), f"operator-{node_id}")


class GlobalKeyedTable:
    """Small key/value state, copied whole at every checkpoint: source
    offsets, watermark state, the windows' late-data marks."""

    def __init__(self, name: str):
        self.name = name
        self.data: dict[Any, Any] = {}

    def get(self, key, default=None):
        return self.data.get(key, default)

    def insert(self, key, value) -> None:
        self.data[key] = value

    def items(self):
        return self.data.items()

    def write_checkpoint(self, path: str) -> dict:
        env = storage.write_bytes(path, pickle.dumps(self.data))
        return {"file": os.path.basename(path), "kind": "global_keyed", **env}

    def load_files(self, entries: Iterable) -> None:
        """Entries are paths or (path, file meta) pairs; a meta's envelope
        is verified on this restore read."""
        for e in entries:
            p, fm = e if isinstance(e, tuple) else (e, None)
            data = storage.read_bytes(p)
            if fm is not None and "crc" in fm and _should_verify(True):
                storage.verify_envelope(data, fm, p)
            self.data.update(loads_values(data))


class ExpiringTimeKeyTable:
    """Batches of rows with ``_timestamp`` (and, keyed, ``_key``) columns,
    kept while their timestamp is within the retention of the watermark."""

    def __init__(self, name: str, retention_micros: int = 0):
        self.name = name
        self.retention_micros = retention_micros
        self.batches: list[Batch] = []

    def insert(self, batch: Batch) -> None:
        if batch.num_rows:
            self.batches.append(batch)

    def replace_all(self, batches: list[Batch]) -> None:
        self.batches = [b for b in batches if b.num_rows]

    def all_batches(self) -> list[Batch]:
        return list(self.batches)

    def total_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    def write_checkpoint(self, path: str) -> Optional[dict]:
        if not self.batches:
            return None
        merged = Batch.concat(self.batches)
        env = write_columnar(path, merged.columns)
        ts = merged.timestamps
        meta = {"file": os.path.basename(path), "kind": "expiring_time_key",
                "min_timestamp": int(ts.min()), "max_timestamp": int(ts.max()), **env}
        if KEY_FIELD in merged:
            k = merged.keys
            meta["min_key"] = int(k.min())
            meta["max_key"] = int(k.max())
        return meta

    def load_files(self, entries: Iterable[tuple[str, dict]], key_range: tuple[int, int],
                   watermark_micros: Optional[int]) -> None:
        """Read the files overlapping our key range and retention window."""
        cutoff = None
        if watermark_micros is not None and self.retention_micros:
            cutoff = watermark_micros - self.retention_micros
        lo, hi = key_range
        for path, meta in entries:
            if cutoff is not None and meta.get("max_timestamp", 1 << 62) < cutoff:
                continue
            if "min_key" in meta and (meta["min_key"] > hi or meta["max_key"] < lo):
                continue
            batch = Batch(read_columnar(path, expect=meta, restore=True))
            if KEY_FIELD in batch:
                keys = batch.keys
                mask = (keys >= np.uint64(lo)) & (keys <= np.uint64(hi))
                if not mask.all():
                    batch = batch.filter(mask)
            if cutoff is not None and batch.num_rows:
                mask = batch.timestamps >= cutoff
                if not mask.all():
                    batch = batch.filter(mask)
            if batch.num_rows:
                self.batches.append(batch)


class TableManager:
    """One subtask's state tables and their checkpoint / restore."""

    def __init__(self, task_info: TaskInfo, storage_url: str):
        self.task_info = task_info
        self.storage_url = storage_url
        self.globals: dict[str, GlobalKeyedTable] = {}
        self.expiring: dict[str, ExpiringTimeKeyTable] = {}

    def global_keyed(self, name: str) -> GlobalKeyedTable:
        if name not in self.globals:
            self.globals[name] = GlobalKeyedTable(name)
        return self.globals[name]

    def expiring_time_key(self, name: str, retention_micros: int = 0) -> ExpiringTimeKeyTable:
        if name not in self.expiring:
            self.expiring[name] = ExpiringTimeKeyTable(name, retention_micros)
        t = self.expiring[name]
        if retention_micros:
            t.retention_micros = retention_micros
        return t

    def checkpoint(self, epoch, watermark_micros: Optional[int]) -> dict:
        """Write every table and the subtask's sidecar; returns the subtask's
        metadata for the engine's job marker."""
        ti = self.task_info
        opdir = operator_dir(self.storage_url, ti.job_id, epoch, ti.node_id)
        storage.makedirs(opdir)
        sub = f"{ti.subtask_index:03d}"
        files = []
        for name, table in self.globals.items():
            meta = table.write_checkpoint(os.path.join(opdir, f"table-{name}-{sub}.bin"))
            meta["table"] = name
            if name.endswith("__spill"):
                # the spill annex's manifest table: its run file names ride
                # the metadata, so run GC and fsck see them without
                # unpickling the table
                from .spill import manifest_run_files

                meta["spill_runs"] = manifest_run_files(table.data)
            files.append(meta)
        for name, table in self.expiring.items():
            meta = table.write_checkpoint(os.path.join(opdir, f"table-{name}-{sub}.npz"))
            if meta is not None:
                meta["table"] = name
                meta["retention_micros"] = table.retention_micros
                files.append(meta)
        meta = {"node_id": ti.node_id, "subtask_index": ti.subtask_index,
                "watermark_micros": watermark_micros, "files": files}
        # the sidecar self-checksums; the envelope of its written bytes rides
        # back (unwritten) so the job marker's manifest covers it too
        env = storage.write_text(os.path.join(opdir, f"metadata-{sub}.json"),
                                 dump_json_with_integrity(meta))
        return {**meta, "sidecar": {"file": f"metadata-{sub}.json", **env}}

    def restore(self, epoch, table_specs: list, mapping: Optional[dict] = None) -> Optional[int]:
        """Load the state written at ``epoch``, at this or another
        parallelism. Subtasks absent from the epoch (drained before its
        barrier, as a source at end of data) come from the ``"final"``
        snapshot, read first so that the epoch's own values win a merge.

        ``mapping`` is this node's entry of an evolution mapping
        (analysis/plan_diff.py): ``{"action": "carried", "from": <old node
        id>, ...}`` reads the predecessor's operator directory (the plan
        diff proved the layouts identical); ``{"action": "rebuilt"}``
        restores nothing. Under a mapping, files of tables the operator no
        longer declares are dropped and logged.

        Returns the restored watermark (the min over the prior subtasks)."""
        ti = self.task_info
        src_node = ti.node_id
        if mapping:
            action = mapping.get("action")
            if action == "rebuilt":
                _log.info("evolve: %s state rebuilt by replay (no carry-over from epoch %s)",
                          ti.node_id, epoch)
                return None
            if action == "carried" and mapping.get("from"):
                src_node = str(mapping["from"])
                if src_node != ti.node_id:
                    _log.info("evolve: %s restores carried state from predecessor "
                              "operator %s", ti.node_id, src_node)

        def read_metas(d: str) -> list:
            out = []
            if not storage.isdir(d):
                return out
            for fn in storage.listdir(d):
                if fn.startswith("metadata-") and fn.endswith(".json"):
                    p = os.path.join(d, fn)
                    try:
                        m = load_json_with_integrity(storage.read_text(p), p, _should_verify(True))
                    except Exception as e:  # noqa: BLE001 - context for the fallback ladder
                        raise RestoreError(epoch, ti.node_id, p, e) from e
                    m["__dir__"] = d
                    out.append(m)
            return out

        opdir = operator_dir(self.storage_url, ti.job_id, epoch, src_node)
        metas = read_metas(opdir)
        have = {m["subtask_index"] for m in metas}
        final_dir = operator_dir(self.storage_url, ti.job_id, "final", src_node)
        metas += [m for m in read_metas(final_dir) if m["subtask_index"] not in have]
        if not metas:
            return None
        wms = [m["watermark_micros"] for m in metas if m.get("watermark_micros") is not None]
        restored_wm = min(wms) if wms else None
        spec_by_name = {s.name: s for s in table_specs}
        by_table: dict[str, list[tuple[str, dict, str]]] = {}
        for m in metas:
            for fmeta in m["files"]:
                by_table.setdefault(fmeta["table"], []).append(
                    (os.path.join(m["__dir__"], fmeta["file"]), fmeta, m["__dir__"]))
        # the compaction rule: once a directory holds a generation >= 1
        # entry of a table, its generation-0 entries of that table are
        # leftovers of a compaction torn mid-rewrite (the merged file holds
        # their rows). Per directory: the "final" snapshot is never
        # compacted, and its state survives a compacted epoch beside it.
        for tname, entries in list(by_table.items()):
            compacted = {d for _p, fm, d in entries if int(fm.get("generation", 0)) >= 1}
            if compacted:
                by_table[tname] = [(p, fm, d) for p, fm, d in entries
                                   if int(fm.get("generation", 0)) >= 1 or d not in compacted]
        for tname, es in by_table.items():
            # the "final" snapshot's files load before the epoch's own
            entries = [(p, fm) for p, fm, _d in sorted(es, key=lambda e: e[2] != final_dir)]
            spec = spec_by_name.get(tname)
            if mapping and spec is None:
                _log.warning("evolve: dropping checkpointed table %r of %s (%d file(s)): "
                             "not declared by the evolved operator", tname, ti.node_id,
                             len(entries))
                continue
            kind = entries[0][1].get("kind")
            try:
                if kind == "global_keyed":
                    self.global_keyed(tname).load_files(entries)
                else:
                    retention = (spec.retention_micros if spec
                                 else entries[0][1].get("retention_micros", 0))
                    self.expiring_time_key(tname, retention).load_files(
                        entries, ti.key_range, restored_wm)
            except RestoreError:
                raise
            except Exception as e:  # noqa: BLE001 - context for the fallback ladder
                raise RestoreError(epoch, ti.node_id, getattr(e, "path", entries[0][0]),
                                   e) from e
        return restored_wm


def compact_operator(storage_url: str, job_id: str, epoch, node_id: str) -> int:
    """Merge an operator's per-subtask state files of one epoch into one
    generation-1 file per table, listed by the lowest subtask's metadata;
    the other subtasks keep their watermarks and list no file of a merged
    table, so a restore reads the data once and re-shards it by key range.
    Returns the number of files removed.

    Crash consistency: the generation-1 holder's metadata lands first and
    is the commit point (a restore then ignores the directory's
    generation-0 entries of the table), the other metadata rewrites follow,
    and the old files go last; a crash between any two steps leaves the
    epoch restorable without loss or double reads. A re-run after a torn
    compaction sweeps orphans and finishes the cleanup instead of merging
    again."""
    opdir = operator_dir(storage_url, job_id, epoch, node_id)
    if not storage.isdir(opdir):
        return 0
    metas = []
    for fn in storage.listdir(opdir):
        if fn.startswith("metadata-") and fn.endswith(".json"):
            p = os.path.join(opdir, fn)
            metas.append((fn, load_json_with_integrity(storage.read_text(p), p,
                                                       _should_verify())))
    if not metas:
        return 0
    removed = 0
    # orphan sweep: a table file no metadata lists is a leftover of a torn
    # compaction (a generation-0 file de-listed before its deletion, or a
    # merged file never committed); its live rows are held elsewhere
    referenced = {fm["file"] for _fn, m in metas for fm in m["files"]}
    for fn in storage.listdir(opdir):
        if fn.startswith("table-") and fn not in referenced:
            try:
                storage.remove(os.path.join(opdir, fn))
                removed += 1
            except FileNotFoundError:
                pass
    # resume a torn compaction: a generation >= 1 entry means the table's
    # switch committed; drop the stale generation-0 entries and files
    # (merging again would overwrite the live merged file with part of it)
    done_tables = {fm["table"] for _fn, m in metas for fm in m["files"]
                   if int(fm.get("generation", 0)) >= 1}
    for fn, m in metas:
        stale = [fm for fm in m["files"]
                 if fm["table"] in done_tables and int(fm.get("generation", 0)) == 0]
        if stale:
            m["files"] = [fm for fm in m["files"] if fm not in stale]
            storage.write_text(os.path.join(opdir, fn), dump_json_with_integrity(m))
            for fm in stale:
                try:
                    storage.remove(os.path.join(opdir, fm["file"]))
                    removed += 1
                except FileNotFoundError:
                    pass
    by_table: dict[str, list[dict]] = {}
    for _fn, m in metas:
        for fmeta in m["files"]:
            if int(fmeta.get("generation", 0)) == 0 and fmeta["table"] not in done_tables:
                by_table.setdefault(fmeta["table"], []).append(fmeta)
    merged_files: dict[str, dict] = {}
    ext = _checkpoint_format()
    for tname, fmetas in by_table.items():
        if len(fmetas) < 2:
            continue
        kind = fmetas[0]["kind"]
        out_name = f"table-{tname}-compacted-g1.{'bin' if kind == 'global_keyed' else ext}"
        out_path = os.path.join(opdir, out_name)
        if kind == "global_keyed":
            data: dict = {}
            for fm in fmetas:
                data.update(loads_values(storage.read_bytes(os.path.join(opdir, fm["file"]))))
            env = storage.write_bytes(out_path, pickle.dumps(data))
            merged = {**fmetas[0], **env}
            if any("spill_runs" in fm for fm in fmetas):
                merged["spill_runs"] = sorted(
                    {rf for fm in fmetas for rf in fm.get("spill_runs", ())})
        else:
            parts = [read_columnar(os.path.join(opdir, fm["file"]), expect=fm)
                     for fm in fmetas]
            cols = {n: np.concatenate([p[n] for p in parts]) for n in parts[0].keys()}
            env = write_columnar(out_path, cols)
            merged = {**fmetas[0], **env}
            merged["min_timestamp"] = min(fm["min_timestamp"] for fm in fmetas)
            merged["max_timestamp"] = max(fm["max_timestamp"] for fm in fmetas)
            if all("min_key" in fm for fm in fmetas):
                merged["min_key"] = min(fm["min_key"] for fm in fmetas)
                merged["max_key"] = max(fm["max_key"] for fm in fmetas)
        merged["file"] = out_name
        merged["generation"] = 1
        merged_files[tname] = merged
    if not merged_files:
        return removed
    # commit order: the merged files are written (orphans if we die now);
    # the holder's metadata lands first (the commit point); the other
    # metadata drop their generation-0 entries; the old files go last
    holder = min(mm["subtask_index"] for _f, mm in metas)
    ordered = sorted(metas, key=lambda fm_m: fm_m[1]["subtask_index"] != holder)
    for fn, m in ordered:
        kept = [fm for fm in m["files"]
                if fm["table"] not in merged_files or int(fm.get("generation", 0)) > 0]
        if m["subtask_index"] == holder:
            kept.extend(merged_files.values())
        m["files"] = kept
        storage.write_text(os.path.join(opdir, fn), dump_json_with_integrity(m))
    for fmetas in by_table.values():
        if len(fmetas) < 2:
            continue
        for fm in fmetas:
            try:
                storage.remove(os.path.join(opdir, fm["file"]))
                removed += 1
            except FileNotFoundError:
                pass
    return removed


def compact_job(storage_url: str, job_id: str, epoch) -> int:
    """Compact every operator of one completed checkpoint."""
    cdir = checkpoint_dir(storage_url, job_id, epoch)
    if not storage.isdir(cdir):
        return 0
    total = 0
    for fn in storage.listdir(cdir):
        if fn.startswith("operator-"):
            total += compact_operator(storage_url, job_id, epoch, fn[len("operator-"):])
    return total


QUARANTINE_MARKER = "quarantine.json"
QUARANTINED_METADATA = "metadata.json.quarantined"


def is_quarantined(storage_url: str, job_id: str, epoch: int) -> bool:
    """True when an operator must resolve this epoch first: restore skips
    it, GC and subsume refuse it."""
    d = checkpoint_dir(storage_url, job_id, epoch)
    return (storage.exists(os.path.join(d, QUARANTINE_MARKER))
            or storage.exists(os.path.join(d, QUARANTINED_METADATA)))


def quarantine_epoch(storage_url: str, job_id: str, epoch: int, reason: str) -> None:
    """Take a corrupt or incomplete epoch out of the restore chain without
    deleting anything: the marker's bytes are kept under
    ``metadata.json.quarantined``, ``quarantine.json`` says why, and only
    then is ``metadata.json`` removed. Idempotent, and crash-safe in that
    order."""
    d = checkpoint_dir(storage_url, job_id, epoch)
    marker = os.path.join(d, "metadata.json")
    storage.makedirs(d)
    if storage.exists(marker):
        try:
            storage.write_bytes(os.path.join(d, QUARANTINED_METADATA), storage.read_bytes(marker))
        except Exception as e:  # noqa: BLE001 - the marker itself is unreadable
            _log.warning("quarantine epoch %s: could not preserve marker bytes: %s", epoch, e)
    storage.write_text(os.path.join(d, QUARANTINE_MARKER), dump_json_with_integrity(
        {"job_id": job_id, "epoch": epoch, "reason": reason}))
    if storage.exists(marker):
        try:
            storage.remove(marker)
        except FileNotFoundError:
            pass
    _log.warning("checkpoint epoch %s of job %s QUARANTINED: %s", epoch, job_id, reason)


def cleanup_checkpoints(storage_url: str, job_id: str, min_epoch: int) -> int:
    """Delete the checkpoints below ``min_epoch``; the "final" snapshot and
    every quarantined epoch are kept. Returns the directories removed."""
    base = os.path.join(storage_url, job_id, "checkpoints")
    if not storage.isdir(base):
        return 0
    removed = 0
    for fn in storage.listdir(base):
        if not fn.startswith("checkpoint-"):
            continue
        tag = fn.split("-", 1)[1]
        if not tag.isdigit():
            continue
        if int(tag) < min_epoch and not is_quarantined(storage_url, job_id, int(tag)):
            storage.rmtree(os.path.join(base, fn))
            removed += 1
    return removed


def subsume_torn_epoch(storage_url: str, job_id: str, epoch: int) -> bool:
    """Remove a torn epoch's partial files (some subtasks wrote state, the
    job marker never landed). An epoch without its marker is invisible to
    restore, so this loses nothing; a complete or quarantined epoch is
    refused."""
    d = checkpoint_dir(storage_url, job_id, epoch)
    if storage.exists(os.path.join(d, "metadata.json")):
        return False
    if is_quarantined(storage_url, job_id, epoch) or not storage.isdir(d):
        return False
    storage.rmtree(d)
    return True


def write_job_checkpoint_metadata(storage_url: str, job_id: str, epoch: int,
                                  extra: Optional[dict] = None) -> str:
    """The job marker, written once every subtask finished its snapshot:
    its existence declares the epoch complete (an atomic publish), and it
    self-checksums."""
    d = checkpoint_dir(storage_url, job_id, epoch)
    storage.makedirs(d)
    path = os.path.join(d, "metadata.json")
    payload = {"job_id": job_id, "epoch": epoch}
    if extra:
        payload.update(extra)
    storage.write_text(path, dump_json_with_integrity(payload))
    return path


def read_job_checkpoint_metadata(storage_url: str, job_id: str, epoch: int) -> Optional[dict]:
    """The epoch's marker, or None when it is missing, torn or fails its
    checksum: the predicate latest_complete_checkpoint selects on."""
    path = os.path.join(checkpoint_dir(storage_url, job_id, epoch), "metadata.json")
    if not storage.exists(path):
        return None
    try:
        return load_json_with_integrity(storage.read_text(path), path, _should_verify(True))
    except (json.JSONDecodeError, OSError, storage.IntegrityError):
        return None


def evolution_mapping_path(storage_url: str, job_id: str, epoch: int) -> str:
    return os.path.join(storage_url, job_id, "checkpoints", f"evolution-{epoch:07d}.json")


def write_evolution_mapping(storage_url: str, job_id: str, epoch: int, mapping: dict) -> str:
    """Persist the evolution mapping (analysis/plan_diff.py ``diff_plans``)
    that an evolved plan restores ``epoch`` through: a storage sidecar with
    its integrity envelope, published atomically, so a crash leaves no
    mapping or the whole one."""
    path = evolution_mapping_path(storage_url, job_id, epoch)
    storage.makedirs(os.path.dirname(path))
    storage.write_text(path, dump_json_with_integrity(mapping))
    return path


def read_evolution_mapping(storage_url: str, job_id: str, epoch: int) -> Optional[dict]:
    """The epoch's evolution mapping, or None when it is missing, torn or
    fails its checksum."""
    path = evolution_mapping_path(storage_url, job_id, epoch)
    if not storage.exists(path):
        return None
    try:
        return load_json_with_integrity(storage.read_text(path), path, _should_verify(True))
    except (json.JSONDecodeError, OSError, storage.IntegrityError):
        return None


def latest_complete_checkpoint(storage_url: str, job_id: str) -> Optional[int]:
    """The newest epoch whose job marker parses (and, with verification on,
    checksums)."""
    base = os.path.join(storage_url, job_id, "checkpoints")
    if not storage.isdir(base):
        return None
    epochs = []
    for fn in storage.listdir(base):
        if not fn.startswith("checkpoint-"):
            continue
        tag = fn.split("-", 1)[1]
        if tag.isdigit() and read_job_checkpoint_metadata(storage_url, job_id, int(tag)) is not None:
            epochs.append(int(tag))
    return max(epochs) if epochs else None
