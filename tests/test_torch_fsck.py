"""The port's offline auditor (arroyo_tpu_torch/state/integrity.py
``fsck_job``) against the JAX package's over the same directories: the
same findings (rule, severity, site, message) in the same order, and
``verify_epoch`` / the fallback ladder agreeing with them.

The directories are a job's checkpoints written by either package (q7
through the engine, three epochs at fixed batches), then: left clean,
compacted, a table file truncated, a table file bit-flipped, a sidecar
bit-flipped, the marker torn, the marker removed, an epoch quarantined,
orphan files, evolution sidecars (good, for another plan, for no epoch,
corrupt), and spill runs (a good one, an orphan, a bad footer)."""

import os
import shutil

import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import Engine as JEngine
from arroyo_tpu.state import integrity as jintegrity
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import faults
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.analysis.diagnostics import Severity
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.state import integrity as tintegrity
from arroyo_tpu_torch.state import storage
from arroyo_tpu_torch.state import tables as ttables
from test_torch_q7 import build_q7

JOB, EVENTS, BATCH, HOLDS = "fsck", 60_000, 2048, (8, 14, 20)
MODULES = {"torch": (tbatch, texpr, tgraph), "jax": (jbatch, jexpr, jgraph)}


@pytest.fixture(autouse=True)
def _port_state():
    tcfg.reset()
    tcfg.update({"storage.retry.base-delay-ms": 0})
    yield
    faults.clear()
    storage.reset_retry_state()
    tcfg.reset()


def _configure():
    over = {"pipeline.source-batch-size": BATCH, "device.batch-capacity": BATCH,
            "worker.queue-size": 2 * BATCH, "pipeline.chaining.enabled": False}
    tcfg.update({**over, "device.table-capacity": 8192, "storage.retry.base-delay-ms": 0})
    jcfg.update({**over, "checkpoint.file-format": "npz"})


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """writer -> a storage root holding q7's epochs 1-3 (window at
    parallelism 2, chaining off: one directory per operator)."""
    out = {}
    for pkg in ("torch", "jax"):
        tcfg.reset()
        _configure()
        url = str(tmp_path_factory.mktemp(f"fsck-{pkg}") / "ck")
        g = build_q7(MODULES[pkg], [], EVENTS, agg_parallelism=2)
        eng = (TEngine(g, job_id=JOB, device="cpu", storage_url=url) if pkg == "torch"
               else JEngine(g, job_id=JOB, storage_url=url))
        chip_smoke.run_gated_epochs(eng, HOLDS, timeout=120)
        out[pkg] = url
    tcfg.reset()
    return out


def _table_file(url, epoch, node="agg", ext=".npz"):
    d = ttables.operator_dir(url, JOB, epoch, node)
    return os.path.join(d, sorted(f for f in os.listdir(d)
                                  if f.startswith("table-") and f.endswith(ext))[0])


def _bitflip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])


def _marker(url, epoch):
    return os.path.join(ttables.checkpoint_dir(url, JOB, epoch), "metadata.json")


def _spill_dir(url):
    d = os.path.join(url, JOB, "spill", "operator-agg")
    os.makedirs(d, exist_ok=True)
    return d


def _spill_run(url, name):
    path = os.path.join(_spill_dir(url), name)
    with open(path, "wb") as f:
        f.write(storage.wrap_footer(name.encode() * 8))
    return path


def _evolution(url, epoch, old_hash=None):
    meta = ttables.read_job_checkpoint_metadata(url, JOB, 1)
    ttables.write_evolution_mapping(url, JOB, epoch, {
        "old_plan_hash": old_hash or meta["plan_hash"], "new_plan_hash": "f" * 16,
        "nodes": {"agg": {"action": "carried", "from": "agg", "tables": ["e", "t"]}},
        "dropped": []})


CASES = {
    "clean": lambda url: None,
    "compacted": lambda url: ttables.compact_job(url, JOB, 2),
    "truncated table file": lambda url: _truncate(_table_file(url, 2)),
    "bit-flipped table file": lambda url: _bitflip(_table_file(url, 3)),
    "bit-flipped sidecar": lambda url: _bitflip(os.path.join(
        ttables.operator_dir(url, JOB, 2, "agg"), "metadata-001.json")),
    "torn marker": lambda url: open(_marker(url, 3), "w").write('{"job_id": "fsck", "epo'),
    "no marker": lambda url: os.remove(_marker(url, 3)),
    "quarantined epoch": lambda url: ttables.quarantine_epoch(url, JOB, 2, "operator says so"),
    "orphans": lambda url: (
        open(os.path.join(ttables.operator_dir(url, JOB, 1, "agg"), "table-t-009.npz"),
             "wb").write(b"x"),
        open(os.path.join(ttables.checkpoint_dir(url, JOB, 1), "stray.txt"), "w").write("x"),
        os.makedirs(os.path.join(ttables.checkpoint_dir(url, JOB, 1), "junk"))),
    "evolution sidecars": lambda url: (
        _evolution(url, 1), _evolution(url, 2, old_hash="0" * 16), _evolution(url, 7),
        open(ttables.evolution_mapping_path(url, JOB, 3), "w").write("{torn")),
    "spill runs": lambda url: (
        _spill_run(url, "run-aa-s0-e3-0.parquet"),  # newer than the last marker: live
        _spill_run(url, "run-bb-s0-e1-0.parquet"),  # listed by no manifest: an orphan
        _bitflip(_spill_run(url, "run-cc-s1-e3-0.parquet"))),  # a bad footer
}


def _view(diags):
    return [(d.rule_id, str(d.severity), d.site, d.message, d.hint) for d in diags]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fsck_reports_what_the_jax_packages_reports(writer, case, jobs, tmp_path):
    url = str(tmp_path / "ck")
    shutil.copytree(jobs[writer], url)
    CASES[case](url)
    got = tintegrity.fsck_job(url, JOB)
    assert _view(got) == _view(jintegrity.fsck_job(url, JOB))
    errors = {d.rule_id for d in got if d.severity == Severity.ERROR}
    rules = {d.rule_id for d in got}
    expect = {"clean": (set(), set()), "compacted": (set(), set()),
              "truncated table file": ({"FS005"}, {"FS005"}),
              "bit-flipped table file": ({"FS005"}, {"FS005"}),
              # the flipped sidecar no longer lists its files: they are orphans
              # too where the flip broke its JSON
              "bit-flipped sidecar": ({"FS004"}, {"FS004"} | (rules & {"FS008"})),
              "torn marker": ({"FS002"}, {"FS002"}),
              "no marker": (set(), {"FS001"}),
              "quarantined epoch": (set(), {"FS003"}),
              "orphans": (set(), {"FS008"}),
              "evolution sidecars": ({"FS007"}, {"FS007", "FS008"}),
              "spill runs": ({"FS006"}, {"FS006", "FS008"})}[case]
    assert (errors, rules) == expect
    # the ladder agrees: walking down from the newest epoch with a marker,
    # it quarantines each epoch fsck finds an ERROR in and stops at the
    # first it finds none in
    bad = {int(d.site.rsplit("-", 1)[1]) for d in got
           if d.severity == Severity.ERROR and "/checkpoint-" in d.site}
    marked = {e for e in (1, 2, 3) if os.path.exists(_marker(url, e))}
    for e in marked:
        assert bool(tintegrity.verify_epoch(url, JOB, e)) == (e in bad), e
    epoch, skipped = tintegrity.latest_valid_checkpoint(url, JOB)
    assert epoch == max(marked - bad)
    assert {s["epoch"] for s in skipped} == {e for e in bad if e > epoch}


def test_fsck_of_a_job_with_no_checkpoints(tmp_path):
    url = str(tmp_path / "none")
    got = tintegrity.fsck_job(url, "nothing")
    assert _view(got) == _view(jintegrity.fsck_job(url, "nothing"))
    assert [(d.rule_id, d.severity) for d in got] == [("FS001", Severity.INFO)]


def test_fsck_verifies_checksums_even_with_verification_off(jobs, tmp_path):
    url = str(tmp_path / "ck")
    shutil.copytree(jobs["torch"], url)
    _bitflip(_table_file(url, 3))
    tcfg.update({"state.integrity.verify": "off"})
    assert tintegrity.verify_epoch(url, JOB, 3, verify_checksums=False) == []
    assert {d.rule_id for d in tintegrity.fsck_job(url, JOB)} == {"FS005"}
