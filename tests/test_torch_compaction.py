"""The port's checkpoint compaction (arroyo_tpu_torch/state/tables.py
``compact_operator`` / ``compact_job``, ``Engine.compact``) and the
restore's generation rule, against the JAX package's.

- the port's mirror of tests/test_compaction.py and of
  tests/test_faults.py's compaction cases: the merge, a rescaled restore,
  cleanup, a compaction torn after each of its three metadata writes and
  at its delete step, each restoring exactly and each finished by a re-run;
- the files of a compaction are the JAX package's (names, generations,
  the holder's entries), and a compacted epoch crosses between the packages
  in both directions with equal rows and globals, at 3, 2 and 1 subtasks;
- q7 with its window at parallelism 4 through the engine: ``compact(1)``
  leaves one generation-1 file per table of ``agg``; restores at 4 and at 2
  (the key-range re-sharding) reach the oracle in the port and in the JAX
  package, and so do restores of the compaction torn at each tear point."""

import json
import os
import shutil

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import expr as jexpr
from arroyo_tpu import faults as jfaults
from arroyo_tpu import graph as jgraph
from arroyo_tpu.engine import Engine as JEngine
from arroyo_tpu.operators import base as jbase
from arroyo_tpu.state import tables as jtables
from arroyo_tpu.types import TaskInfo as JTaskInfo
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import faults
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch.engine import Engine as TEngine
from arroyo_tpu_torch.faults import InjectedFault
from arroyo_tpu_torch.operators import base as tbase
from arroyo_tpu_torch.state import storage
from arroyo_tpu_torch.state import tables as ttables
from arroyo_tpu_torch.state.integrity import fsck_job, verify_epoch
from arroyo_tpu_torch.types import TaskInfo as TTaskInfo
from test_torch_q7 import build_q7

PKG = {"torch": (tbatch, ttables, tbase, TTaskInfo, faults),
       "jax": (jbatch, jtables, jbase, JTaskInfo, jfaults)}


@pytest.fixture(autouse=True)
def _port_state():
    """The port's config with no retry backoff; the JAX package writes the
    npz codec the port reads."""
    tcfg.reset()
    tcfg.update({"storage.retry.base-delay-ms": 0})
    jcfg.update({"checkpoint.file-format": "npz"})
    yield
    faults.clear()
    storage.reset_retry_state()
    tcfg.reset()


# ------------------------------------------- tests/test_compaction.py


def _two_subtasks(pkg, store, epoch):
    B, tables, base, TaskInfo, _f = PKG[pkg]
    specs = [base.TableSpec("t", "expiring_time_key"), base.TableSpec("g", "global_keyed")]
    for sub in range(2):
        ti = TaskInfo("job", "op1", "agg", sub, 2)
        tm = tables.TableManager(ti, store)
        lo, _hi = ti.key_range
        k = lo + 1
        tm.expiring_time_key("t").insert(B.Batch({
            B.KEY_FIELD: np.array([k, k + 1], dtype=np.uint64),
            B.TIMESTAMP_FIELD: np.array([1000 * (sub + 1), 2000 * (sub + 1)], dtype=np.int64),
            "v": np.array([sub * 10, sub * 10 + 1], dtype=np.int64)}))
        tm.global_keyed("g").insert(f"k{sub}", sub * 100)
        tm.checkpoint(epoch, None)
    tables.write_job_checkpoint_metadata(store, "job", epoch)
    return specs


def _restore_all(pkg, store, epoch, parallelism, job="job", node="op1", table="t"):
    B, tables, base, TaskInfo, _f = PKG[pkg]
    specs = [base.TableSpec(table, "expiring_time_key", 10_000_000),
             base.TableSpec("g", "global_keyed")]
    rows, gvals = [], {}
    for sub in range(parallelism):
        tm = tables.TableManager(TaskInfo(job, node, "agg", sub, parallelism), store)
        tm.restore(epoch, specs)
        for b in tm.expiring_time_key(table).all_batches():
            rows += list(zip(b[B.KEY_FIELD].tolist(), b[B.TIMESTAMP_FIELD].tolist(),
                             b["v"].tolist()))
        gvals.update(dict(tm.global_keyed("g").items()))
    return sorted(rows), gvals


def test_compact_then_restore_rescaled(tmp_path):
    store = str(tmp_path / "ck")
    _two_subtasks("torch", store, 1)
    before = _restore_all("torch", store, 1, 3)
    assert ttables.compact_operator(store, "job", 1, "op1") >= 2
    opdir = ttables.operator_dir(store, "job", 1, "op1")
    files = sorted(f for f in os.listdir(opdir) if not f.startswith("metadata"))
    assert files == ["table-g-compacted-g1.bin", "table-t-compacted-g1.npz"]
    assert _restore_all("torch", store, 1, 3) == before
    assert ttables.compact_operator(store, "job", 1, "op1") == 0  # generation 1 is final


def test_compact_job_and_cleanup(tmp_path):
    store = str(tmp_path / "ck")
    _two_subtasks("torch", store, 1)
    _two_subtasks("torch", store, 2)
    assert ttables.compact_job(store, "job", 2) > 0
    assert ttables.cleanup_checkpoints(store, "job", min_epoch=2) == 1
    assert not os.path.isdir(ttables.checkpoint_dir(store, "job", 1))
    rows, g = _restore_all("torch", store, 2, 2)
    assert len(rows) == 4 and len(g) == 2
    assert ttables.compact_job(store, "job", 9) == 0  # no such epoch


def test_final_snapshot_beside_a_compacted_epoch_keeps_its_state(tmp_path):
    """The generation rule is per directory: a drained subtask's "final"
    snapshot is never compacted, and its generation-0 files still load
    beside the epoch's compacted ones."""
    url = str(tmp_path / "ck")
    B = tbatch
    for sub in (0, 1):
        tm = ttables.TableManager(TTaskInfo("job", "src", "source", sub, 3), url)
        tm.global_keyed("g").insert(sub, {"off": sub})
        tm.checkpoint(4, None)
    tm = ttables.TableManager(TTaskInfo("job", "src", "source", 2, 3), url)
    tm.global_keyed("g").insert(2, {"off": 2})
    tm.expiring_time_key("t").insert(B.Batch({
        B.KEY_FIELD: np.array([3], dtype=np.uint64),
        B.TIMESTAMP_FIELD: np.array([5], dtype=np.int64), "v": np.array([7], dtype=np.int64)}))
    tm.checkpoint("final", None)
    assert ttables.compact_operator(url, "job", 4, "src") == 2
    for pkg in ("torch", "jax"):
        rows, g = _restore_all(pkg, url, 4, 1, node="src")
        assert g == {0: {"off": 0}, 1: {"off": 1}, 2: {"off": 2}}
        assert rows == [(3, 5, 7)]


# ------------------------------ tests/test_faults.py: torn compaction

EXPECT_ROWS = [0, 1, 2, 100, 101, 102]
EXPECT_GLOBS = {0: {"off": 0}, 1: {"off": 1}, 2: {"off": 2}}


def _make_epoch(pkg, url, job, epoch, n_sub=3):
    B, tables, _base, TaskInfo, _f = PKG[pkg]
    for sub in range(n_sub):
        tm = tables.TableManager(TaskInfo(job, "op", "op", sub, n_sub), url)
        keys = (np.arange(2, dtype=np.int64) + 10 * sub).view(np.uint64)
        tm.expiring_time_key("t", 10_000_000).insert(B.Batch({
            B.TIMESTAMP_FIELD: np.array([0, 1000], dtype=np.int64), B.KEY_FIELD: keys,
            "v": np.array([sub, sub + 100], dtype=np.int64)}))
        tm.global_keyed("g").insert(sub, {"off": sub})
        tm.checkpoint(epoch, None)
    tables.write_job_checkpoint_metadata(url, job, epoch)


def _rows_globs(pkg, url, job, epoch, parallelism=1):
    rows, g = _restore_all(pkg, url, epoch, parallelism, job=job, node="op")
    return sorted(v for _k, _t, v in rows), g


def _metas(url, job, epoch, node="op"):
    opdir = ttables.operator_dir(url, job, epoch, node)
    return [json.loads(storage.read_text(os.path.join(opdir, fn)))
            for fn in storage.listdir(opdir) if fn.startswith("metadata-")]


@pytest.mark.parametrize("tear_after", [1, 2, 3])
def test_compaction_torn_at_each_metadata_write_restores_exact(tear_after, tmp_path):
    """The first metadata write (the holder's, generation 1) is the commit
    point: either side of it, and after every later write, the epoch
    restores the same rows and globals, in the port and in the JAX
    package; a re-run finishes the cleanup."""
    url = str(tmp_path / "ck")
    _make_epoch("torch", url, "j", 2)
    faults.install(f"storage.put:fail@match=metadata-&after={tear_after}")
    with pytest.raises(InjectedFault):
        ttables.compact_job(url, "j", 2)
    faults.clear()
    for pkg in ("torch", "jax"):
        assert _rows_globs(pkg, url, "j", 2) == (EXPECT_ROWS, EXPECT_GLOBS)
    assert not [d for d in fsck_job(url, "j") if d.severity.name == "ERROR"]
    ttables.compact_job(url, "j", 2)
    gen0 = [fm for m in _metas(url, "j", 2) for fm in m["files"]
            if int(fm.get("generation", 0)) == 0]
    assert not gen0
    assert sorted(f for f in os.listdir(ttables.operator_dir(url, "j", 2, "op"))
                  if f.startswith("table-")) == ["table-g-compacted-g1.bin",
                                                 "table-t-compacted-g1.npz"]
    assert _rows_globs("torch", url, "j", 2) == (EXPECT_ROWS, EXPECT_GLOBS)
    assert not fsck_job(url, "j")


@pytest.mark.parametrize("tear_after", [1, 2, 3])
def test_torn_compaction_leaves_the_jax_packages_files(tear_after, tmp_path):
    """Torn at the same write, the two packages leave the same files and the
    same sidecar entries (names, tables, generations) behind."""
    out = {}
    for pkg in ("torch", "jax"):
        url = str(tmp_path / pkg)
        _make_epoch(pkg, url, "j", 2)
        _B, tables, _b, _t, fmod = PKG[pkg]
        fmod.install(f"storage.put:fail@match=metadata-&after={tear_after}")
        with pytest.raises(Exception, match="injected fault"):
            tables.compact_job(url, "j", 2)
        fmod.clear()
        opdir = ttables.operator_dir(url, "j", 2, "op")
        out[pkg] = (sorted(f for f in os.listdir(opdir) if not f.endswith(".tmp")),
                    sorted((m["subtask_index"], fm["file"], fm["table"],
                            int(fm.get("generation", 0)))
                           for m in _metas(url, "j", 2) for fm in m["files"]))
    assert out["torch"] == out["jax"]


def test_compaction_torn_at_delete_step_sweeps_orphans(tmp_path):
    url = str(tmp_path / "ck")
    _make_epoch("torch", url, "j", 2)
    faults.install("storage.delete:fail@match=table-")
    with pytest.raises(InjectedFault):
        ttables.compact_job(url, "j", 2)
    faults.clear()
    assert _rows_globs("torch", url, "j", 2) == (EXPECT_ROWS, EXPECT_GLOBS)
    assert {d.rule_id for d in fsck_job(url, "j")} == {"FS008"}  # the orphans, warnings
    ttables.compact_job(url, "j", 2)
    leftovers = [fn for fn in os.listdir(ttables.operator_dir(url, "j", 2, "op"))
                 if fn.startswith("table-") and "compacted-g1" not in fn]
    assert not leftovers
    assert _rows_globs("torch", url, "j", 2) == (EXPECT_ROWS, EXPECT_GLOBS)


def test_compaction_transient_fault_recovers_in_place(tmp_path):
    """A transient storage fault inside the compaction is retried by the
    storage layer: the compaction finishes as if it had not happened."""
    url = str(tmp_path / "ck")
    _make_epoch("torch", url, "j", 2)
    faults.install("storage.put:fail_once@match=compacted,storage.get:fail_once@match=table-")
    assert ttables.compact_job(url, "j", 2) == 6
    assert len(faults.active().fired_log) == 2
    assert _rows_globs("torch", url, "j", 2) == (EXPECT_ROWS, EXPECT_GLOBS)


@pytest.mark.parametrize("parallelism", [3, 2, 1])
@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_a_compacted_epoch_crosses_between_the_packages(direction, parallelism, tmp_path):
    writer, reader = direction.split("->")
    url = str(tmp_path / "ck")
    _make_epoch(writer, url, "j", 2)
    want = _rows_globs(writer, url, "j", 2, parallelism)
    assert PKG[writer][1].compact_job(url, "j", 2) == 6
    assert _rows_globs(reader, url, "j", 2, parallelism) == want
    assert _rows_globs(writer, url, "j", 2, parallelism) == want
    # the holder lists the merged entries, the others keep their watermarks
    metas = sorted(_metas(url, "j", 2), key=lambda m: m["subtask_index"])
    assert [[(fm["file"], fm["generation"]) for fm in m["files"]] for m in metas] == \
        [[("table-g-compacted-g1.bin", 1), ("table-t-compacted-g1.npz", 1)], [], []]
    assert not verify_epoch(url, "j", 2) and not jtables.is_quarantined(url, "j", 2)


# ----------------------------------------- q7 through the engine

EVENTS, BATCH, POLLS = 60_000, 2048, 15
MODULES = {"torch": (tbatch, texpr, tgraph), "jax": (jbatch, jexpr, jgraph)}


def _configure():
    over = {"pipeline.source-batch-size": BATCH, "device.batch-capacity": BATCH,
            "worker.queue-size": 2 * BATCH, "pipeline.chaining.enabled": True,
            "segment.compile.min-rows": 0}
    tcfg.update({**over, "device.table-capacity": 8192, "storage.retry.base-delay-ms": 0})
    jcfg.update({**over, "checkpoint.file-format": "npz"})


def _engine(pkg, rows, url, parallelism, **kw):
    g = build_q7(MODULES[pkg], rows, EVENTS, agg_parallelism=parallelism)
    if pkg == "torch":
        return TEngine(g, job_id="q7p", device="cpu", storage_url=url, **kw)
    return JEngine(g, job_id="q7p", storage_url=url, **kw)


@pytest.fixture(scope="module")
def q7_epoch1(tmp_path_factory):
    """q7 with its window at parallelism 4, epoch 1 at the gated poll, then
    stopped; the epoch uncompacted, and the first run's rows."""
    tcfg.reset()
    _configure()
    url = str(tmp_path_factory.mktemp("q7p") / "ck")
    rows: list = []
    eng = _engine("torch", rows, url, 4)
    chip_smoke.run_gated_epochs(eng, (POLLS,), timeout=120)
    tcfg.reset()
    return url, rows, eng


# the window's compacted tables: its key-skew sketch ("__sketch", written by
# the profiler as in the JAX package), its late-data marks and its rows
COMPACTED = ["table-__sketch-compacted-g1.bin", "table-e-compacted-g1.bin",
             "table-t-compacted-g1.npz"]


def _agg_files(url):
    opdir = ttables.operator_dir(url, "q7p", 1, "agg")
    return sorted(f for f in os.listdir(opdir) if f.startswith("table-"))


def test_engine_compact_merges_the_windows_tables(q7_epoch1, tmp_path):
    _configure()
    url = str(tmp_path / "ck")
    shutil.copytree(q7_epoch1[0], url)
    eng = q7_epoch1[2]
    assert len(_agg_files(url)) == 12  # "__sketch", "t" and "e" of each of four subtasks
    eng.storage_url = url
    removed = eng.compact(1)
    assert removed == 12
    assert _agg_files(url) == COMPACTED
    with pytest.raises(ValueError, match="not a completed checkpoint"):
        eng.compact(2)
    assert not fsck_job(url, "q7p")


def _compacted_copy(q7_epoch1, tmp_path, tear_after=None):
    url = str(tmp_path / "ck")
    shutil.copytree(q7_epoch1[0], url)
    if tear_after is not None:
        faults.install(f"storage.put:fail@match=metadata-&after={tear_after}")
        with pytest.raises(InjectedFault):
            ttables.compact_job(url, "q7p", 1)
        faults.clear()
    else:
        ttables.compact_job(url, "q7p", 1)
    return url


@pytest.mark.parametrize("parallelism", [4, 2])
@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_compacted_q7_restores_at_4_and_2_to_the_oracle(pkg, parallelism, q7_epoch1, tmp_path):
    _configure()
    url = _compacted_copy(q7_epoch1, tmp_path)
    rows: list = []
    _engine(pkg, rows, url, parallelism, restore_epoch=1).run_to_completion(timeout=300)
    chip_smoke.check_q7(q7_epoch1[1] + rows, chip_smoke.oracle_q7(EVENTS))


@pytest.mark.parametrize("tear_after", [1, 2, 3])
def test_torn_q7_compaction_restores_and_a_rerun_finishes(tear_after, q7_epoch1, tmp_path):
    _configure()
    url = _compacted_copy(q7_epoch1, tmp_path, tear_after)
    rows: list = []
    _engine("torch", rows, url, 2, restore_epoch=1).run_to_completion(timeout=300)
    chip_smoke.check_q7(q7_epoch1[1] + rows, chip_smoke.oracle_q7(EVENTS))
    ttables.compact_job(url, "q7p", 1)
    assert _agg_files(url) == COMPACTED
    assert not fsck_job(url, "q7p")


def test_a_transient_read_fault_on_restore_recovers_in_place(q7_epoch1, tmp_path):
    """A restore whose first read of a state file fails transiently goes on
    through the retry layer, with no restart, to the oracle."""
    _configure()
    url = _compacted_copy(q7_epoch1, tmp_path)
    faults.install("storage.get:fail_once@match=table-t-compacted")
    rows: list = []
    _engine("torch", rows, url, 4, restore_epoch=1).run_to_completion(timeout=300)
    assert len(faults.active().fired_log) == 1
    chip_smoke.check_q7(q7_epoch1[1] + rows, chip_smoke.oracle_q7(EVENTS))
