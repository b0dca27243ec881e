"""Checkpoint integrity (the port's copy of arroyo_tpu/state/integrity.py):
the manifest the job marker carries, the check of one epoch, the restore
fallback ladder and the offline auditor.

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

``fsck_job``
    walks a job's whole durable state offline (every epoch, the ``"final"``
    snapshot, spill runs, evolution mappings, orphan files) and reports
    what it finds as the shared Diagnostic model, with checksums always
    verified.

An epoch with no marker at all is torn, invisible to restore, and skipped
without quarantine. A compaction rewrites an operator's sidecars, so the
marker's manifest is only held against uncompacted directories; the
sidecars' own envelopes cover the rest.

FS rules (the JAX package's):

    FS001  torn epoch: directory without a parseable commit marker
    FS002  commit marker fails its integrity checksum
    FS003  quarantined epoch awaiting operator resolution
    FS004  sidecar missing, unparseable, or failing its checksum
    FS005  table file missing or failing its envelope
    FS006  referenced spill run missing or failing its footer
    FS007  evolution mapping unparseable, corrupt, or paired with the
           wrong plan hash
    FS008  orphan file no live metadata references
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Optional

from ..analysis.diagnostics import Diagnostic, Severity, finish
from . import storage
from .tables import (QUARANTINE_MARKER, QUARANTINED_METADATA, _should_verify, checkpoint_dir,
                     is_quarantined, load_json_with_integrity, quarantine_epoch)

from .spill import _RUN_NAME_RE  # the spill annex's run file names


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
        # a compaction rewrites sidecars: the marker's manifest then no
        # longer covers them, their own envelopes do
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


# ------------------------------------------------------------------- fsck


def _fsck_epoch(storage_url: str, job_id: str, epoch: int, diags: list[Diagnostic]) -> None:
    site = f"{job_id}/checkpoints/checkpoint-{epoch:07d}"
    if is_quarantined(storage_url, job_id, epoch):
        diags.append(Diagnostic(
            "FS003", Severity.WARNING, site,
            f"epoch {epoch} is quarantined and awaits operator resolution",
            hint="inspect metadata.json.quarantined + quarantine.json; "
                 "delete the directory (or restore the marker) to resolve"))
        return
    marker, prob = _read_marker(storage_url, job_id, epoch, verify=True)
    if prob:
        diags.append(Diagnostic(
            "FS002", Severity.ERROR, site, prob,
            hint="quarantine-and-fall-back will skip this epoch on the "
                 "next restore; resolve or delete it after forensics"))
        return
    if marker is None:
        diags.append(Diagnostic(
            "FS001", Severity.WARNING, site,
            f"epoch {epoch} has no commit marker (torn mid-checkpoint)",
            hint="harmless: invisible to restore; the controller watchdog "
                 "subsumes torn epochs automatically"))
        return
    for p in verify_epoch(storage_url, job_id, epoch, verify_checksums=True):
        rule = "FS004" if "sidecar" in p else "FS006" if "spill run" in p else "FS005"
        diags.append(Diagnostic(rule, Severity.ERROR, site, p,
                                hint="restore would quarantine this epoch and fall back"))


def _fsck_final(storage_url: str, job_id: str, diags: list[Diagnostic]) -> None:
    """The "final" drained-source snapshot verifies like an epoch's
    operator directories but has no commit marker of its own."""
    cdir = checkpoint_dir(storage_url, job_id, "final")
    if not storage.isdir(cdir):
        return
    site = f"{job_id}/checkpoints/checkpoint-final"
    for opd in sorted(storage.listdir(cdir)):
        d = os.path.join(cdir, opd)
        if not opd.startswith("operator-") or not storage.isdir(d):
            continue
        for fn in sorted(storage.listdir(d)):
            if not (fn.startswith("metadata-") and fn.endswith(".json")):
                continue
            p = os.path.join(d, fn)
            try:
                m = load_json_with_integrity(storage.read_text(p), p, True)
            except Exception as e:  # noqa: BLE001 - report, keep walking
                diags.append(Diagnostic("FS004", Severity.ERROR, site,
                                        f"sidecar {opd}/{fn} is torn or corrupt: {e}"))
                continue
            for fm in m.get("files", ()):
                fpath = os.path.join(d, fm["file"])
                if not storage.exists(fpath):
                    diags.append(Diagnostic("FS005", Severity.ERROR, site,
                                            f"table file {opd}/{fm['file']} is missing"))
                elif "crc" in fm:
                    try:
                        storage.verify_envelope(storage.read_bytes(fpath), fm, fpath)
                    except storage.IntegrityError as e:
                        diags.append(Diagnostic(
                            "FS005", Severity.ERROR, site,
                            f"table file {opd}/{fm['file']} fails its envelope: {e.reason}"))


def _fsck_evolutions(storage_url: str, job_id: str, epochs: list[int],
                     diags: list[Diagnostic]) -> None:
    base = os.path.join(storage_url, job_id, "checkpoints")
    if not storage.isdir(base):
        return
    for fn in sorted(storage.listdir(base)):
        if not (fn.startswith("evolution-") and fn.endswith(".json")):
            continue
        site = f"{job_id}/checkpoints/{fn}"
        tag = fn[len("evolution-"):-len(".json")]
        p = os.path.join(base, fn)
        try:
            mapping = load_json_with_integrity(storage.read_text(p), p, True)
        except Exception as e:  # noqa: BLE001 - report, keep walking
            diags.append(Diagnostic(
                "FS007", Severity.ERROR, site, f"evolution mapping is torn or corrupt: {e}",
                hint="re-run the evolve API so the plan-diff pass rewrites the proven mapping"))
            continue
        if not tag.isdigit():
            diags.append(Diagnostic("FS007", Severity.WARNING, site,
                                    f"evolution mapping has a non-numeric epoch tag {tag!r}"))
            continue
        epoch = int(tag)
        if epoch not in epochs:
            diags.append(Diagnostic(
                "FS008", Severity.WARNING, site,
                f"evolution mapping references epoch {epoch} which has no "
                "checkpoint directory (orphan)",
                hint="safe to delete after confirming no restore targets it"))
            continue
        marker, _prob = _read_marker(storage_url, job_id, epoch, verify=False)
        meta_hash = (marker or {}).get("plan_hash")
        old_hash = mapping.get("old_plan_hash")
        if meta_hash and old_hash and meta_hash != old_hash:
            diags.append(Diagnostic(
                "FS007", Severity.ERROR, site,
                f"evolution mapping pairs old plan {old_hash} but epoch "
                f"{epoch}'s marker records plan {meta_hash} — the mapping "
                "was proven for a different plan pair",
                hint="restore through this mapping would misread state; "
                     "re-run the evolve API against the actual checkpoint"))


def _fsck_orphans(storage_url: str, job_id: str, epochs: list[int],
                  diags: list[Diagnostic]) -> None:
    """FS008: files no live metadata lists. Table files are torn-compaction
    leftovers ``compact_operator`` finishes deleting; spill runs below the
    newest complete epoch are GC targets. Both are warnings: owned by GC,
    not data loss."""
    known_epoch_files = {"metadata.json", QUARANTINE_MARKER, QUARANTINED_METADATA}
    referenced_runs: set[tuple[str, str]] = set()
    newest_complete = None
    for epoch in epochs:
        cdir = checkpoint_dir(storage_url, job_id, epoch)
        site = f"{job_id}/checkpoints/checkpoint-{epoch:07d}"
        marker, _prob = _read_marker(storage_url, job_id, epoch, verify=False)
        if marker is not None:
            newest_complete = epoch
        for fn in sorted(storage.listdir(cdir)):
            d = os.path.join(cdir, fn)
            if storage.isdir(d):
                if not fn.startswith("operator-"):
                    diags.append(Diagnostic("FS008", Severity.WARNING, site,
                                            f"unexpected directory {fn!r} in the epoch dir"))
                    continue
                sidecar_refs: set[str] = set()
                for sfn in storage.listdir(d):
                    if not (sfn.startswith("metadata-") and sfn.endswith(".json")):
                        continue
                    try:
                        m = json.loads(storage.read_text(os.path.join(d, sfn)))
                    except Exception:  # noqa: BLE001 - FS004 reported it
                        continue
                    for fm in m.get("files", ()):
                        sidecar_refs.add(fm.get("file", ""))
                        for run in fm.get("spill_runs", ()):
                            referenced_runs.add((fn, run))
                for sfn in sorted(storage.listdir(d)):
                    if sfn.startswith("table-") and sfn not in sidecar_refs:
                        diags.append(Diagnostic(
                            "FS008", Severity.WARNING, site,
                            f"table file {fn}/{sfn} is referenced by no "
                            "sidecar (torn-compaction leftover)",
                            hint="compact_operator finishes the cleanup on its next pass"))
            elif fn not in known_epoch_files:
                diags.append(Diagnostic("FS008", Severity.WARNING, site,
                                        f"unexpected file {fn!r} in the epoch dir"))
    spill_base = os.path.join(storage_url, job_id, "spill")
    if not storage.isdir(spill_base):
        return
    for opd in sorted(storage.listdir(spill_base)):
        d = os.path.join(spill_base, opd)
        if not storage.isdir(d):
            continue
        for fn in sorted(storage.listdir(d)):
            m = _RUN_NAME_RE.match(fn)
            if m is None:
                continue
            if newest_complete is not None and int(m.group(2)) >= newest_complete:
                continue  # a fresh run after the checkpoint; the next manifest owns it
            if (opd, fn) not in referenced_runs:
                diags.append(Diagnostic(
                    "FS008", Severity.WARNING, f"{job_id}/spill/{opd}",
                    f"spill run {fn} is referenced by no checkpoint manifest (GC target)",
                    hint="cleanup_spill_runs removes it on the next GC cycle"))


def _fsck_spill_footers(storage_url: str, job_id: str, diags: list[Diagnostic]) -> None:
    """FS006: every live spill run's footer must verify (runs outlive
    epochs, so their integrity rides in the file itself)."""
    spill_base = os.path.join(storage_url, job_id, "spill")
    if not storage.isdir(spill_base):
        return
    for opd in sorted(storage.listdir(spill_base)):
        d = os.path.join(spill_base, opd)
        if not storage.isdir(d):
            continue
        for fn in sorted(storage.listdir(d)):
            if _RUN_NAME_RE.match(fn) is None:
                continue
            p = os.path.join(d, fn)
            try:
                storage.unwrap_footer(storage.read_bytes(p), p, verify=True)
            except storage.IntegrityError as e:
                diags.append(Diagnostic(
                    "FS006", Severity.ERROR, f"{job_id}/spill/{opd}",
                    f"spill run {fn} fails its integrity footer: {e.reason}",
                    hint="a probe read would fail here; the worker set "
                         "restores from the checkpoint instead"))


def fsck_job(storage_url: str, job_id: str) -> list[Diagnostic]:
    """Walk one job's whole durable state offline and report every
    integrity finding as a Diagnostic (FS rules, in ``finish``'s order).
    An ERROR means a restore would quarantine and fall back; a WARNING is
    GC-owned debris or a quarantine awaiting an operator. Checksums are
    always verified here, whatever ``state.integrity.verify`` says."""
    diags: list[Diagnostic] = []
    epochs = _epoch_tags(storage_url, job_id)
    if not epochs and not storage.isdir(os.path.join(storage_url, job_id, "checkpoints")):
        diags.append(Diagnostic("FS001", Severity.INFO, f"{job_id}/checkpoints",
                                "job has no checkpoints directory (nothing to verify)"))
        return finish(diags)
    for epoch in epochs:
        _fsck_epoch(storage_url, job_id, epoch, diags)
    _fsck_final(storage_url, job_id, diags)
    _fsck_evolutions(storage_url, job_id, epochs, diags)
    _fsck_orphans(storage_url, job_id, epochs, diags)
    _fsck_spill_footers(storage_url, job_id, diags)
    return finish(diags)
