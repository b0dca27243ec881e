"""The tiered spill annex (state/spill.py) of the port against the JAX
package's: tests/test_spill.py's cases, each run as one scenario through
both packages, which must give the same results (probe results, manifests,
stats, run file bytes), and the same scenario's own checks in each.

Also: run files and manifests written by either package are read by the
other, a run's pickled payloads name no module but ``builtins`` and
``numpy``, the port's updating aggregate and updating join spill through
the annex on the smoke families to byte-exact goldens, and a checkpoint
taken with spilled runs restores (at another parallelism) from the manifest.
(K10's exchange spill, a different thing, is tests/test_torch_spill.py.)
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import pickletools
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from arroyo_tpu import faults
        from arroyo_tpu.obs.events import recorder
        from arroyo_tpu.operators.base import OperatorContext
        from arroyo_tpu.operators.updating_aggregate import UpdatingAggregate
        from arroyo_tpu.state import spill, storage, tables
        from arroyo_tpu.types import TaskInfo

        def ctx(ti, tm):
            return OperatorContext(ti, None, tm)
        cfg = jcfg
    else:
        from arroyo_tpu_torch import faults
        from arroyo_tpu_torch.obs.events import recorder
        from arroyo_tpu_torch.operators.base import OperatorContext
        from arroyo_tpu_torch.operators.updating_aggregate import UpdatingAggregate
        from arroyo_tpu_torch.state import spill, storage, tables
        from arroyo_tpu_torch.types import TaskInfo

        def ctx(ti, tm):
            return OperatorContext(ti, None, table_manager=tm)
        cfg = tcfg
    return SimpleNamespace(name=name, cfg=cfg, faults=faults, recorder=recorder,
                           spill=spill, storage=storage, tables=tables, TaskInfo=TaskInfo,
                           UpdatingAggregate=UpdatingAggregate, ctx=ctx)


JAX, PORT = _pkg("jax"), _pkg("port")


@pytest.fixture(autouse=True)
def _configs(tmp_path, monkeypatch):
    # the sizes the JAX package reads from its config are constants of the
    # port's state/spill.py: a test may set them, and they are put back
    for name in ("PARTITION_COUNT", "MAX_RUNS", "TARGET_FILE_BYTES"):
        monkeypatch.setattr(PORT.spill, name, getattr(PORT.spill, name))
    for P in (JAX, PORT):
        P.cfg.reset()
        P.faults.clear()
        # npz: the port reads no parquet (ROADMAP A.9), so runs cross as npz
        P.cfg.update({"checkpoint.storage-url": str(tmp_path / f"{P.name}-ckpt"),
                      "checkpoint.file-format": "npz", "storage.retry.base-delay-ms": 10})
    yield
    for P in (JAX, PORT):
        P.faults.clear()
        P.cfg.reset()


def ti(P, subtask=0, parallelism=1, job="spill-job", node="op_1"):
    return P.TaskInfo(job, node, "op", subtask, parallelism)


def keyed_annex(P, root, subtask=0, parallelism=1, job="spill-job", max_runs=4):
    """An annex of 8 partitions a subtask (the JAX package's config keys,
    the port's constants)."""
    if P is JAX:
        P.cfg.update({"state.spill.partition-count": 8, "state.spill.max-runs": max_runs})
    else:
        P.spill.PARTITION_COUNT, P.spill.MAX_RUNS = 8, max_runs
    return P.spill.KeyedSpillAnnex(ti(P, subtask, parallelism, job), str(root), "s")


def row_annex(P, root, job="spill-rows", subtask=0, parallelism=1, n_vals=2):
    return P.spill.RowSpillAnnex(ti(P, subtask, parallelism, job), str(root), "left",
                                 n_vals=n_vals)


def packed(v, ts=100):
    """Annex pack contract: event time rides at index -1."""
    return ("payload", v, ts)


def spill_all(annex, items: dict) -> None:
    by_p: dict = {}
    for h, v in items.items():
        by_p.setdefault(annex.partition_of(h), []).append((h, v))
    for p in sorted(by_p):
        assert annex.spill(p, by_p[p])


def manifest_form(m: dict) -> str:
    return json.dumps(m, sort_keys=True, default=repr)


def run_files(root) -> dict:
    """{relative path: sha256} of every run file under ``root``."""
    out = {}
    for d, _s, fs in os.walk(str(root)):
        for f in fs:
            if f.startswith("run-"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), str(root))] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def both(scenario, tmp_path) -> None:
    """Run ``scenario(P, root)`` through both packages (each checks itself)
    and hold the port's record and run files to the JAX package's."""
    recs = {}
    for P in (JAX, PORT):
        root = tmp_path / P.name
        recs[P.name] = (scenario(P, root), run_files(root))
    assert recs["port"][0] == recs["jax"][0]
    assert recs["port"][1] == recs["jax"][1]


# ------------------------------------------------------------------ units


def test_bloom_matches_the_jax_package():
    keys = np.arange(1, 5000, 7, dtype=np.uint64) * np.uint64(2654435761)
    jb, tb = JAX.spill.BloomFilter.build(keys), PORT.spill.BloomFilter.build(keys)
    assert tb.state() == jb.state()
    assert tb.contains(keys).all()
    others = (np.arange(1, 5000, 7, dtype=np.uint64) + np.uint64(3)) * np.uint64(2654435761)
    assert np.array_equal(tb.contains(others), jb.contains(others))
    assert tb.contains(others).mean() < 0.05
    assert PORT.spill.BloomFilter.from_state(jb.state()).contains(keys).all()


def _lookup_promote(P, root):
    annex = keyed_annex(P, root)
    spill_all(annex, {h: packed(h, ts=100 + h) for h in range(1, 40)})
    got = [annex.lookup_many([3, 7, 12345]), annex.lookup_many([3, 7]),
           annex.lookup_many([5])]
    assert got[0] == {3: packed(3, 103), 7: packed(7, 107)}
    assert got[1] == {} and got[2] == {5: packed(5, 105)}
    return got, manifest_form(annex.manifest())


def _newest_wins(P, root):
    annex = keyed_annex(P, root)
    h = 11
    p = annex.partition_of(h)
    assert annex.spill(p, [(h, packed("old", 50))])
    out = [annex.lookup_many([h])]
    assert annex.spill(p, [(h, packed("new", 60))])
    out += [annex.lookup_many([h]), annex.lookup_many([h])]
    assert annex.spill(p, [])
    out.append(annex.lookup_many([h]))
    assert out == [{h: packed("old", 50)}, {h: packed("new", 60)}, {}, {}]
    return out, manifest_form(annex.manifest())


def _zone_and_bloom(P, root):
    annex = keyed_annex(P, root)
    width = 2 ** 64 // annex.pc
    h_a, h_b = 5, width * (annex.pc // 4) + 5
    pa, pb = annex.partition_of(h_a), annex.partition_of(h_b)
    assert pa != pb
    assert annex.spill(pa, [(h_a, packed("a"))]) and annex.spill(pb, [(h_b, packed("b"))])
    before = annex.stats.probe_files.sum
    got = annex.lookup_many([h_a])
    touched = annex.stats.probe_files.sum - before
    assert got == {h_a: packed("a")} and touched == 1
    assert annex.lookup_many([h_a + 1]) == {}
    return got, touched, annex.stats.probe_files.counts


def _scan_expired(P, root):
    annex = keyed_annex(P, root)
    h_old, h_fresh = 21, 22
    p = annex.partition_of(h_old)
    assert annex.spill(p, [(h_old, packed("o", 100)), (h_fresh, packed("f", 100))])
    annex.lookup_many([h_fresh])
    assert annex.spill(p, [(h_fresh, packed("f2", 500))])
    out = [annex.scan_expired(200, exclude=set()), annex.lookup_many([h_old]),
           annex.scan_expired(200, exclude=set())]
    assert out == [[(h_old, packed("o", 100))], {}, []]
    # a tombstone-only run shadows older copies on the scan too
    h = 17
    annex2 = keyed_annex(P, root, job="dead-marker")
    p2 = annex2.partition_of(h)
    assert annex2.spill(p2, [(h, packed("v", 10))])
    annex2.lookup_many([h])
    assert annex2.spill(p2, [])
    assert annex2.scan_expired(100, exclude=set()) == []
    return out


def _row_adopt_floor(P, root):
    owner = row_annex(P, root, job="floor", n_vals=1)
    assert owner.spill_rows(np.array([5, -5], dtype=np.int64), np.array([10, 50], dtype=np.int64),
                            np.zeros(2, np.int64), np.zeros(2, bool),
                            [np.array(["a", "b"], dtype=object)])
    owner.probe(np.array([5], dtype=np.int64))
    assert owner.runs[0]["alive_min_ts"] == 50
    half = row_annex(P, root, job="floor", subtask=1, parallelism=2, n_vals=1)
    half.adopt([owner.manifest(), {"kind": "rows", "writer": 0, "runs": []}])
    assert half.runs[0]["alive_min_ts"] == 10
    return manifest_form(owner.manifest()), manifest_form(half.manifest())


def _compaction(P, root):
    annex = keyed_annex(P, root, max_runs=3)
    h1, h2 = 31, 33
    p = annex.partition_of(h1)
    for i in range(5):
        if i:
            assert annex.lookup_many([h1]) == {h1: packed(i - 1, 100 + i - 1)}
        assert annex.spill(p, [(h1, packed(i, 100 + i))] + ([(h2, packed("x", 99))] if i == 0 else []))
    assert len(annex.runs) <= 4 and annex.stats.compactions >= 1
    assert any(int(r.get("gen", 0)) >= 1 for r in annex.runs)
    got = annex.lookup_many([h1, h2])
    assert got == {h1: packed(4, 104), h2: packed("x", 99)}
    return got, annex.stats.compactions, manifest_form(annex.manifest())


def _eviction_order(P, root):
    annex = keyed_annex(P, root)
    for p in (3, 1, 5):
        annex.clock += 1
        annex.last_access[p] = annex.clock
    hot = {0: 4, 1: 4, 3: 4, 5: 4}
    v1 = annex.pick_victims(hot, excess_entries=8)
    assert v1 == [0, 3]
    annex2 = keyed_annex(P, root)
    annex2.adopt([annex.manifest()])
    assert annex2.pick_victims(hot, excess_entries=8) == v1 and annex2.clock == annex.clock
    return v1


def _manifest_roundtrip(P, root):
    annex = keyed_annex(P, root)
    spill_all(annex, {h: packed(h) for h in range(50, 90)})
    annex.lookup_many([55, 60])
    fresh = keyed_annex(P, root)
    fresh.adopt([annex.manifest()])
    assert [r["file"] for r in fresh.runs] == [r["file"] for r in annex.runs]
    got = fresh.lookup_many(list(range(50, 90)))
    assert got == {h: packed(h) for h in range(50, 90) if h not in (55, 60)}
    assert fresh.next_seq == annex.next_seq
    return got, manifest_form(annex.manifest())


def _rescale_adopt(P, root):
    annex = keyed_annex(P, root)
    items = {h: packed(h) for h in [5, -5, 2 ** 62, -(2 ** 62)]}
    spill_all(annex, items)
    halves = [keyed_annex(P, root, subtask=s, parallelism=2) for s in (0, 1)]
    for a in halves:
        a.adopt([annex.manifest()])
    out = []
    for h, v in items.items():
        owners = [i for i, a in enumerate(halves) if a.key_lo <= (h & (2 ** 64 - 1)) <= a.key_hi]
        assert len(owners) == 1
        got = halves[owners[0]].lookup_many([h])
        assert got == {h: v}
        out.append((owners[0], got))
    return out


def _write_failure(P, root):
    job = "spill-degrade"
    P.recorder.clear_job(job)
    annex = keyed_annex(P, root, job=job)
    P.faults.install("spill_write:fail", seed=1)
    try:
        assert not annex.spill(0, [(1, packed("a"))])
    finally:
        P.faults.clear()
    assert annex.stats.failures == 1 and not annex.has_runs()
    assert any(e["code"] == "SPILL_FALLBACK" for e in P.recorder.events(job))
    backoff = [annex.spill(0, [(1, packed("a"))]) for _ in range(17)]
    assert backoff == [False] * 16 + [True]
    got = annex.lookup_many([1])
    assert got == {1: packed("a")}
    P.recorder.clear_job(job)
    return backoff, got


def _fail_at_epoch(P, root):
    annex = keyed_annex(P, root, job="spill-epoch")
    annex.epoch = 1
    P.faults.install("spill_write:fail@epoch=1", seed=1)
    try:
        assert not annex.spill(0, [(1, packed("a"))]) and not annex.has_runs()
        annex.epoch = 2
        annex._skip_spills = 0
        assert annex.spill(0, [(1, packed("a"))])
    finally:
        P.faults.clear()
    assert annex.lookup_many([1]) == {1: packed("a")}
    assert "-e0000002-" in annex.runs[0]["file"]
    P.recorder.clear_job("spill-epoch")
    return annex.runs[0]["file"]


def _probe_fail_once(P, root):
    annex = keyed_annex(P, root)
    assert annex.spill(annex.partition_of(7), [(7, packed("v"))])
    P.faults.install("spill_probe:fail_once", seed=1)
    try:
        got = annex.lookup_many([7])
    finally:
        P.faults.clear()
    assert got == {7: packed("v")}
    return got


def _compact_failure(P, root):
    job = "spill-cfail"
    annex = keyed_annex(P, root, job=job, max_runs=2)
    h = 41
    p = annex.partition_of(h)
    P.faults.install("spill_compact:fail", seed=1)
    try:
        for i in range(4):
            if i:
                annex.lookup_many([h])
            assert annex.spill(p, [(h, packed(i, 100 + i))])
    finally:
        P.faults.clear()
    assert annex.stats.failures >= 1
    assert all(int(r.get("gen", 0)) == 0 for r in annex.runs)
    got = annex.lookup_many([h])
    assert got == {h: packed(3, 103)}
    assert any(e["code"] == "SPILL_FALLBACK" for e in P.recorder.events(job))
    P.recorder.clear_job(job)
    return got, annex.stats.failures


def _row_annex(P, root):
    annex = row_annex(P, root)
    keys = np.array([1, 1, 2, 3], dtype=np.int64)
    ts = np.array([10, 20, 30, 40], dtype=np.int64)
    assert annex.spill_rows(keys, ts, np.array([0, 1, 2, 0], dtype=np.int64),
                            np.array([True, False, False, True]),
                            [np.array(["a", "b", "c", "d"], dtype=object),
                             np.array([1, 2, 3, 4], dtype=object)])
    assert annex.alive_rows() == 4 and annex.oldest_ts() == 10
    k, t, m, n, vals = annex.probe(np.array([1], dtype=np.int64))
    assert sorted(k.tolist()) == [1, 1] and sorted(t.tolist()) == [10, 20]
    assert annex.alive_rows() == 2 and annex.oldest_ts() == 30
    assert annex.probe(np.array([1], dtype=np.int64)) is None
    assert annex.expire(cutoff=35) == 1 and annex.oldest_ts() == 40
    fresh = row_annex(P, root)
    fresh.adopt([annex.manifest()])
    seg = fresh.probe(np.array([3], dtype=np.int64))
    assert fresh.alive_rows() == 0 and seg[0].tolist() == [3]
    return ([a.tolist() for a in (k, t, m, n)], [v.tolist() for v in vals],
            [(a.tolist() if hasattr(a, "tolist") else a) for a in seg[:4]],
            manifest_form(annex.manifest()))


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _lookup_promote, _newest_wins, _zone_and_bloom, _scan_expired, _row_adopt_floor,
    _compaction, _eviction_order, _manifest_roundtrip, _rescale_adopt, _write_failure,
    _fail_at_epoch, _probe_fail_once, _compact_failure, _row_annex)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_annex_scenario_matches_the_jax_package(name, tmp_path):
    both(SCENARIOS[name], tmp_path)


def test_merge_spill_stats_matches_the_jax_package():
    out = {}
    for P in (JAX, PORT):
        s1, s2 = P.spill.SpillStats(), P.spill.SpillStats()
        s1.probe_files.observe(2)
        s2.probe_files.observe(5)
        m = P.spill.merge_spill_stats([
            {"bytes_total": 100, "hot": 3, "cold": 1, "probe_files": s1.probe_files}, None,
            {"bytes_total": 50, "hot": 2, "cold": 2, "probe_files": s2.probe_files}])
        assert m["bytes_total"] == 150 and m["cold"] == 3 and m["probe_files"].count == 2
        assert P.spill.merge_spill_stats([None]) is None
        out[P.name] = (m["bytes_total"], m["hot"], m["cold"], m["probe_files"].counts,
                       m["probe_files"].sum)
    assert out["port"] == out["jax"]


def _cleanup(P, root):
    st = P.storage
    job = "gcjob"
    spill_dir = os.path.join(str(root), job, "spill", "operator-op_1")
    st.makedirs(spill_dir)
    names = {"referenced": "run-s-s000-e0000001-000001.npz",
             "orphan_old": "run-s-s000-e0000001-000002.npz",
             "fresh": "run-s-s000-e0000005-000003.npz"}
    for n in names.values():
        st.write_bytes(os.path.join(spill_dir, n), b"x")
    opdir = os.path.join(str(root), job, "checkpoints", "checkpoint-0000005", "operator-op_1")
    st.makedirs(opdir)
    st.write_text(os.path.join(opdir, "metadata-000.json"), json.dumps({
        "subtask_index": 0, "watermark_micros": None,
        "files": [{"table": "s__spill", "file": "table-s__spill-000.bin",
                   "kind": "global_keyed", "spill_runs": [names["referenced"]]}]}))
    removed = P.spill.cleanup_spill_runs(str(root), job, newest_complete_epoch=5)
    left = sorted(st.listdir(spill_dir))
    assert removed == 1 and left == sorted([names["referenced"], names["fresh"]])
    return removed, left


def _manifest_lifted(P, root):
    metas = []
    for sub in (0, 1):
        tm = P.tables.TableManager(ti(P, subtask=sub, parallelism=2, job="mjob"), str(root))
        tm.global_keyed("s__spill").insert(sub, {
            "kind": "keyed", "runs": [{"file": f"run-s-s{sub:03d}-e0000000-000001.npz"}]})
        metas.append(tm.checkpoint(1, None))
    lifted = [next(f for f in m["files"] if f["table"] == "s__spill")["spill_runs"]
              for m in metas]
    assert lifted == [[f"run-s-s{s:03d}-e0000000-000001.npz"] for s in (0, 1)]
    P.tables.compact_operator(str(root), "mjob", 1, "op_1")
    opdir = P.tables.operator_dir(str(root), "mjob", 1, "op_1")
    merged = set()
    for fn in P.storage.listdir(opdir):
        if fn.startswith("metadata-"):
            meta = json.loads(P.storage.read_text(os.path.join(opdir, fn)))
            for f in meta["files"]:
                merged.update(f.get("spill_runs", ()))
    assert merged == {"run-s-s000-e0000000-000001.npz", "run-s-s001-e0000000-000001.npz"}
    return lifted, sorted(merged)


@pytest.mark.parametrize("scenario", [_cleanup, _manifest_lifted], ids=["cleanup", "lifted"])
def test_gc_and_metadata_match_the_jax_package(scenario, tmp_path):
    both(scenario, tmp_path)


def test_restore_with_spill_disabled_fails_in_both(tmp_path):
    """A manifest that references runs cannot restore with spilling off;
    an empty manifest restores."""
    for P in (JAX, PORT):
        P.cfg.update({"state.spill.enabled": False})
        t = ti(P, job="noSpill")
        tm = P.tables.TableManager(t, str(tmp_path / P.name))
        tm.global_keyed("s__spill").insert(0, {
            "kind": "keyed", "runs": [{"file": "run-s-s000-e0000001-000001.npz"}]})
        cfg = {"key_fields": [], "aggregates": [("c", "count", None)],
               "input_dtype_of": lambda e: np.dtype(np.int64)}
        with pytest.raises(RuntimeError, match="state.spill.enabled"):
            P.UpdatingAggregate(dict(cfg)).on_start(P.ctx(t, tm))
        tm.global_keyed("s__spill").insert(0, {"kind": "keyed", "runs": []})
        P.UpdatingAggregate(dict(cfg)).on_start(P.ctx(t, tm))


# ------------------------------------------------- crossing the packages


def _copy_runs(src_root, dst_root) -> None:
    for d, _s, fs in os.walk(str(src_root)):
        for f in fs:
            if f.startswith("run-"):
                rel = os.path.relpath(d, str(src_root))
                os.makedirs(os.path.join(str(dst_root), rel), exist_ok=True)
                shutil.copy(os.path.join(d, f), os.path.join(str(dst_root), rel, f))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_runs_and_manifests_cross_the_packages(writer, tmp_path):
    """Runs and a manifest written by one package are adopted and probed by
    the other: keyed and row annexes, tombstones included."""
    W, R = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    wroot, rroot = tmp_path / "w", tmp_path / "r"
    items = {h: (("acc", np.int64(h), 1.5), h % 3, None, ("k", h), 1000 + h)
             for h in range(-40, 40, 3)}
    ka = keyed_annex(W, wroot)
    spill_all(ka, items)
    ka.lookup_many([-40, 2])
    ra = row_annex(W, wroot)
    keys = np.array([4, 4, -9, 7], dtype=np.int64)
    assert ra.spill_rows(keys, np.array([10, 20, 30, 40], dtype=np.int64),
                         np.array([0, 1, 2, 0], dtype=np.int64),
                         np.array([True, False, False, True]),
                         [np.array(["a", None, "c", "d"], dtype=object),
                          np.array([1, 2.5, None, 4], dtype=object)])
    # as a checkpoint's global table carries them (a pickle of the values)
    km, rm = pickle.loads(pickle.dumps(ka.manifest())), pickle.loads(pickle.dumps(ra.manifest()))
    _copy_runs(wroot, rroot)
    kb = keyed_annex(R, rroot)
    kb.adopt([km])
    want = {h: v for h, v in items.items() if h not in (-40, 2)}
    got = kb.lookup_many(sorted(items))
    assert got == want
    rb = row_annex(R, rroot)
    rb.adopt([rm])
    seg = rb.probe(np.array([4, -9], dtype=np.int64))
    ref = row_annex(W, wroot)
    ref.adopt([rm])
    wseg = ref.probe(np.array([4, -9], dtype=np.int64))
    for a, b in zip(seg[:4], wseg[:4]):
        assert np.asarray(a).tolist() == np.asarray(b).tolist()
    assert [v.tolist() for v in seg[4]] == [v.tolist() for v in wseg[4]]


def _pickle_modules(data: bytes) -> set:
    """The modules a pickle's GLOBAL / STACK_GLOBAL opcodes name."""
    mods, strings = set(), []
    for op, arg, _pos in pickletools.genops(data):
        if op.name == "GLOBAL":
            mods.add(arg.split(" ")[0])
        elif op.name == "STACK_GLOBAL":
            mods.add(strings[-2])
        elif isinstance(arg, str) and "UNICODE" in op.name:
            strings.append(arg)
    return mods


def _allowed(mods: set) -> bool:
    return all(m == "builtins" or m == "numpy" or m.startswith("numpy.") for m in mods)


def test_payload_pickles_name_only_builtins_and_numpy(tmp_path):
    """The updating aggregate's spilled key states (the keyed runs'
    ``__val`` payloads) and the join's spilled object values (the npz
    sidecar) reference no class of either package."""
    from arroyo_tpu_torch.state.tables import read_columnar

    from test_torch_sql_smoke_a import build, port  # noqa: F401
    from test_torch_sql_plan import load_sql, register_port_fixtures

    arroyo_tpu._load_operators()
    register_port_fixtures()
    PORT.spill.TARGET_FILE_BYTES = SPILL_FILE_BYTES
    for fam, budget in (("spill_keyspace", 32768), ("updating_inner_join", 4096)):
        tcfg.update({"checkpoint.storage-url": str(tmp_path / "ckpt"), **SPILL_CFG,
                     "state.spill.budget-bytes": budget})
        build(load_sql(fam, str(tmp_path / f"{fam}.json")), 1, f"pk-{fam}").run_to_completion(
            timeout=120)
    runs = [os.path.join(d, f) for d, _s, fs in os.walk(str(tmp_path / "ckpt"))
            for f in fs if f.startswith("run-")]
    assert any("run-s-" in r for r in runs) and any("run-left-" in r or "run-right-" in r
                                                    for r in runs)
    seen = set()
    for r in runs:
        cols = read_columnar(r)
        if "__val" in cols:
            for v in cols["__val"]:
                if v:
                    seen |= _pickle_modules(bytes(v))
        with open(r, "rb") as f:
            raw = f.read()
        import io
        import zipfile

        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            if "__objcols__.npy" in z.namelist():
                side = np.load(io.BytesIO(z.read("__objcols__.npy")))
                seen |= _pickle_modules(side.tobytes())
    assert seen and _allowed(seen), seen
    assert not _allowed({"arroyo_tpu.batch"}) and not _allowed({"arroyo_tpu_torch.batch"})


# ----------------------------------------- the operators on the smoke families

SPILL_CFG = {"state.spill.enabled": True, "state.spill.budget-bytes": 32768}
SPILL_FILE_BYTES = 16384  # state/spill.py's TARGET_FILE_BYTES beside SPILL_CFG


def _port_run(tmp_path, family, over, job, parallelism=1):
    from test_smoke import assert_outputs
    from test_torch_sql_plan import load_sql, register_port_fixtures
    from test_torch_sql_smoke_a import build

    arroyo_tpu._load_operators()
    register_port_fixtures()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "ckpt"), **over})
    out = str(tmp_path / "out.json")
    PORT.recorder.clear_job(job)
    build(load_sql(family, out), parallelism, job).run_to_completion(timeout=180)
    assert_outputs(family, out)
    runs = [f for _d, _s, fs in os.walk(str(tmp_path / "ckpt" / job)) for f in fs
            if f.startswith("run-")]
    return runs


def test_spill_keyspace_golden_with_spill_engaged(tmp_path):
    job = "spill-smoke-p1"
    PORT.spill.TARGET_FILE_BYTES = SPILL_FILE_BYTES
    runs = _port_run(tmp_path, "spill_keyspace", SPILL_CFG, job)
    assert runs and any(e["code"] == "SPILL_STARTED" for e in PORT.recorder.events(job))


@pytest.mark.parametrize("family", ["updating_inner_join", "updating_full_join",
                                    "updating_inner_join_with_updating"])
def test_updating_join_families_spill_golden(family, tmp_path):
    """The JAX test's join families (tests/test_spill.py:697-720): a budget
    small enough that side-store rows spill and promote back on a match."""
    runs = _port_run(tmp_path, family, {"state.spill.enabled": True,
                                        "state.spill.budget-bytes": 4096}, f"spill-{family}")
    # as in the JAX package at this budget: both sides of the inner joins
    # spill; the full join's side stores stay under it
    want = [] if family == "updating_full_join" else [
        "run-left-s000-e0000000-000001.npz", "run-right-s000-e0000000-000001.npz"]
    assert sorted(runs) == want


@pytest.mark.parametrize("family,p_restore", [("spill_keyspace", 3),
                                              ("updating_inner_join", 2)])
def test_spill_checkpoint_restore(family, p_restore, tmp_path):
    """Checkpoints at p=2 with spilled runs, stop, restore (spill_keyspace
    at p=3): the manifests rebuild the tiered layout; goldens byte-exact."""
    from test_smoke import assert_outputs
    from test_torch_sql_plan import load_sql, register_port_fixtures
    from test_torch_sql_smoke_a import build

    arroyo_tpu._load_operators()
    register_port_fixtures()
    over = SPILL_CFG if family == "spill_keyspace" else {
        "state.spill.enabled": True, "state.spill.budget-bytes": 4096}
    if family == "spill_keyspace":
        PORT.spill.TARGET_FILE_BYTES = SPILL_FILE_BYTES
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "ckpt"), **over,
                 "testing.source-gate-epochs": 2})
    out = str(tmp_path / "out.json")
    job = f"spill-restore-{family}"
    sql = load_sql(family, out)
    eng = build(sql, 2, job)
    eng.start()
    for ep in (1, 2):
        assert eng.checkpoint_and_wait(ep, timeout=60), f"epoch {ep}"
    eng.stop()
    eng.join(timeout=60)
    tcfg.update({"testing.source-gate-epochs": 0})
    build(sql, p_restore, job, restore_epoch=2).run_to_completion(timeout=180)
    assert_outputs(family, out)
