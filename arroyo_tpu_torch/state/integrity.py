"""Checkpoint integrity (the port's copy of arroyo_tpu/state/integrity.py,
without ``fsck_job``): the manifest the job marker carries, the check of one
epoch, and the restore fallback ladder.

``fold_integrity``
    folds the subtasks' checkpoint metadata into the marker's manifest
    ``{"operator-<node>/<file>": {crc, len, algo}}``;
``verify_epoch``
    every reason an epoch is not a safe restore target: its marker, every
    sidecar and every table file must exist, parse and match its envelope;
``latest_valid_checkpoint``
    walks the complete-looking epochs newest first, quarantines each that
    fails (``tables.quarantine_epoch``: the marker renamed, nothing
    deleted) and returns the newest that verifies;
``pick_restore_epoch``
    the ladder as a job's restore runs it, recording
    ``CHECKPOINT_QUARANTINED`` and ``RESTORE_FELL_BACK`` in the port's event
    feed (obs/events.py).

An epoch with no marker at all is torn, invisible to restore, and skipped
without quarantine. The offline auditor ``fsck_job`` waits for the port's
analysis/diagnostics.py.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

from . import storage
from .tables import (_should_verify, checkpoint_dir, is_quarantined, load_json_with_integrity,
                     quarantine_epoch)


def fold_integrity(subtask_metas: Iterable[dict]) -> dict:
    """The per-epoch manifest of the job marker from the subtasks'
    ``TableManager.checkpoint`` results; entries without an envelope are
    skipped."""
    manifest: dict[str, dict] = {}
    for m in subtask_metas:
        if not isinstance(m, dict) or "node_id" not in m:
            continue
        opd = f"operator-{m['node_id']}"
        for fm in m.get("files", ()):
            if isinstance(fm, dict) and fm.get("file") and "crc" in fm:
                manifest[f"{opd}/{fm['file']}"] = {
                    "crc": fm["crc"], "len": fm["len"], "algo": fm.get("algo", "crc32")}
        sc = m.get("sidecar")
        if isinstance(sc, dict) and sc.get("file") and "crc" in sc:
            manifest[f"{opd}/{sc['file']}"] = {
                "crc": sc["crc"], "len": sc["len"], "algo": sc.get("algo", "crc32")}
    return manifest


def _epoch_tags(storage_url: str, job_id: str) -> list[int]:
    base = os.path.join(storage_url, job_id, "checkpoints")
    if not storage.isdir(base):
        return []
    out = []
    for fn in storage.listdir(base):
        if fn.startswith("checkpoint-"):
            tag = fn.split("-", 1)[1]
            if tag.isdigit():
                out.append(int(tag))
    return sorted(out)


def _read_marker(storage_url: str, job_id: str, epoch: int,
                 verify: bool) -> tuple[Optional[dict], Optional[str]]:
    """(marker, problem): marker None when missing; problem set when the
    file exists but is torn or fails its checksum."""
    path = os.path.join(checkpoint_dir(storage_url, job_id, epoch), "metadata.json")
    if not storage.exists(path):
        return None, None
    try:
        return load_json_with_integrity(storage.read_text(path), path, verify), None
    except Exception as e:  # noqa: BLE001 - every parse or crc failure counts
        return None, f"commit marker {path} is torn or corrupt: {e}"


def verify_epoch(storage_url: str, job_id: str, epoch: int,
                 verify_checksums: bool = True) -> list[str]:
    """Every reason ``epoch`` is not a safe restore target (empty: valid).
    Existence and parsing are always checked; the bytes against their
    envelopes only with ``verify_checksums``."""
    marker, prob = _read_marker(storage_url, job_id, epoch, verify_checksums)
    if prob:
        return [prob]
    if marker is None:
        return [f"epoch {epoch} has no commit marker"]
    problems: list[str] = []
    manifest = marker.get("integrity") or {}
    cdir = checkpoint_dir(storage_url, job_id, epoch)
    for node in marker.get("operators", ()):
        opd = f"operator-{node}"
        d = os.path.join(cdir, opd)
        if not storage.isdir(d):
            # a subtask that drained before the barrier writes nothing for
            # the epoch (restore takes its "final" snapshot); only a
            # directory the manifest promised files for is missing
            if any(k.startswith(opd + "/") for k in manifest):
                problems.append(f"operator directory {opd} is missing")
            continue
        sidecars: list[tuple[str, dict]] = []
        for fn in storage.listdir(d):
            if not (fn.startswith("metadata-") and fn.endswith(".json")):
                continue
            p = os.path.join(d, fn)
            try:
                sidecars.append((fn, load_json_with_integrity(
                    storage.read_text(p), p, verify_checksums)))
            except Exception as e:  # noqa: BLE001 - any failure disqualifies
                problems.append(f"sidecar {opd}/{fn} is torn or corrupt: {e}")
        if not sidecars and not problems:
            problems.append(f"operator {node} has no checkpoint sidecars")
        # a compaction (the JAX package's) rewrites sidecars: the marker's
        # manifest then no longer covers them, their own envelopes do
        compacted = any(int(fm.get("generation", 0)) >= 1
                        for _fn, m in sidecars for fm in m.get("files", ()))
        for fn, m in sidecars:
            rel = f"{opd}/{fn}"
            env = manifest.get(rel)
            if env and verify_checksums and not compacted:
                try:
                    storage.verify_envelope(storage.read_bytes(os.path.join(d, fn)), env,
                                            os.path.join(d, fn))
                except storage.IntegrityError as e:
                    problems.append(f"sidecar {rel} fails the epoch manifest envelope: {e.reason}")
            for fm in m.get("files", ()):
                fpath = os.path.join(d, fm["file"])
                if not storage.exists(fpath):
                    problems.append(f"table file {opd}/{fm['file']} is missing")
                    continue
                if verify_checksums and "crc" in fm:
                    try:
                        storage.verify_envelope(storage.read_bytes(fpath), fm, fpath)
                    except storage.IntegrityError as e:
                        problems.append(f"table file {opd}/{fm['file']} fails its envelope: "
                                        f"{e.reason}")
                for run in fm.get("spill_runs", ()):
                    if not storage.exists(os.path.join(storage_url, job_id, "spill", opd, run)):
                        problems.append(f"spill run {opd}/{run} referenced by table "
                                        f"{fm.get('table')!r} is missing")
    return problems


def latest_valid_checkpoint(
    storage_url: str, job_id: str,
    on_quarantine: Optional[Callable[[int, str], None]] = None,
) -> tuple[Optional[int], list[dict]]:
    """The restore fallback ladder: the newest epoch that verifies, and
    ``[{"epoch", "reason"}, ...]`` for every epoch it quarantined on the way
    (each after ``on_quarantine(epoch, reason)`` could see storage already
    consistent). ``(None, skipped)`` when no valid epoch remains."""
    verify_checksums = _should_verify(True)
    skipped: list[dict] = []
    for epoch in reversed(_epoch_tags(storage_url, job_id)):
        if is_quarantined(storage_url, job_id, epoch):
            continue
        marker = os.path.join(checkpoint_dir(storage_url, job_id, epoch), "metadata.json")
        if not storage.exists(marker):
            continue  # torn: invisible to restore
        problems = verify_epoch(storage_url, job_id, epoch, verify_checksums)
        if not problems:
            return epoch, skipped
        reason = "; ".join(problems[:5])
        quarantine_epoch(storage_url, job_id, epoch, reason)
        skipped.append({"epoch": epoch, "reason": reason})
        if on_quarantine is not None:
            on_quarantine(epoch, reason)
    return None, skipped


def pick_restore_epoch(storage_url: str, job_id: str) -> Optional[int]:
    """The ladder as a restore runs it: quarantined epochs are recorded as
    ``CHECKPOINT_QUARANTINED`` and a fall-back past them as
    ``RESTORE_FELL_BACK`` (the JAX package's controller records the same
    two events). None: no valid checkpoint, start from the beginning."""
    from ..obs.events import recorder

    def on_quarantine(epoch: int, reason: str) -> None:
        recorder.record(job_id, "ERROR", "CHECKPOINT_QUARANTINED",
                        message=f"checkpoint epoch {epoch} failed integrity verification "
                                f"and was quarantined: {reason[:400]}",
                        data={"epoch": epoch, "reason": reason[:800]})

    epoch, skipped = latest_valid_checkpoint(storage_url, job_id, on_quarantine=on_quarantine)
    if skipped:
        recorder.record(job_id, "WARN", "RESTORE_FELL_BACK",
                        message=f"restore fell back to epoch {epoch or 0} past "
                                f"{len(skipped)} quarantined epoch(s); sources rewind and "
                                f"replay covers the gap",
                        data={"fallback_epoch": epoch, "skipped": skipped})
    return epoch
