"""Checkpoint and restore in the port (arroyo_tpu_torch/state/, the engine's
barriers and every operator's tables) on the CPU, held against arroyo_tpu:

- the storage and table primitives produce the JAX package's bytes and
  envelopes and read its files (and it reads theirs);
- the port's counterparts of the JAX package's checkpoint scenarios:
  tests/test_engine.py (restore from an offset, a graph that lacks an
  operator), tests/test_tumbling.py and tests/test_sliding.py (windows in
  both backends, mixed key transport) and tests/test_integrity.py (the
  manifest, a truncated table file, a bit-flipped sidecar, a torn and a
  missing marker, GC and quarantine, RestoreError, verification off).

The port's config is its own object: tests/conftest.py resets only
arroyo_tpu's, so the fixture below points the port's checkpoint storage at
the test's temporary directory."""

import os
import pickle

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu.state import storage as jstorage
from arroyo_tpu.state import tables as jtables
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Batch, Schema
from arroyo_tpu_torch.engine import Engine, run_graph
from arroyo_tpu_torch.expr import BinOp, Case, Col, Lit
from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.operators.base import TableSpec
from arroyo_tpu_torch.state import storage
from arroyo_tpu_torch.state.integrity import (fold_integrity, latest_valid_checkpoint,
                                              pick_restore_epoch, verify_epoch)
from arroyo_tpu_torch.state.tables import (QUARANTINE_MARKER, QUARANTINED_METADATA,
                                           GlobalKeyedTable, RestoreError, TableManager,
                                           checkpoint_dir, cleanup_checkpoints,
                                           dump_json_with_integrity, is_quarantined,
                                           latest_complete_checkpoint,
                                           load_json_with_integrity, quarantine_epoch,
                                           read_columnar, read_job_checkpoint_metadata,
                                           subsume_torn_epoch, write_columnar,
                                           write_job_checkpoint_metadata)
from arroyo_tpu_torch.types import TaskInfo

DUMMY = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])


@pytest.fixture(autouse=True)
def tstorage(tmp_path):
    """The port's checkpoint storage under the test's directory, and small
    device tables."""
    tcfg.reset()
    url = str(tmp_path / "torch-checkpoints")
    tcfg.update({"checkpoint.storage-url": url, "device.table-capacity": 8192,
                 "device.batch-capacity": 1024, "device.emit-capacity": 1024,
                 "device.max-probes": 32})
    yield url
    tcfg.reset()


# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("data", [b"", b"x", bytes(range(256)) * 37])
def test_envelopes_and_footers_match_the_jax_package(data, tmp_path):
    assert storage.checksum_of(data) == jstorage.checksum_of(data)
    wrapped = storage.wrap_footer(data)
    assert wrapped == jstorage.wrap_footer(data)
    assert storage.unwrap_footer(wrapped) == jstorage.unwrap_footer(wrapped) == data
    env = storage.write_bytes(str(tmp_path / "a.bin"), data)
    assert env == jstorage.checksum_of(data)
    storage.verify_envelope(jstorage.read_bytes(str(tmp_path / "a.bin")), env, "a")
    if data:
        bad = data[:-1] + bytes([data[-1] ^ 1])
        with pytest.raises(storage.IntegrityError, match="mismatch"):
            storage.verify_envelope(bad, env, "a")
        with pytest.raises(storage.IntegrityError, match="length"):
            storage.verify_envelope(data[:-1], env, "a")


def test_json_integrity_is_the_jax_packages():
    obj = {"job_id": "j", "epoch": 3, "operators": ["a", "b"], "x": [1.5, None]}
    text = dump_json_with_integrity(obj)
    assert text == jtables.dump_json_with_integrity(obj)
    assert load_json_with_integrity(text, "p", True) == obj
    tampered = text.replace('"epoch": 3', '"epoch": 4')
    with pytest.raises(storage.IntegrityError):
        load_json_with_integrity(tampered, "p", True)
    assert load_json_with_integrity(tampered, "p", False)["epoch"] == 4


def _columns():
    from arroyo_tpu_torch.batch import object_column

    return {TIMESTAMP_FIELD: np.arange(5, dtype=np.int64) * 7,
            "_key": np.array([1, 2**63, 5, 2**64 - 1, 0], dtype=np.uint64),
            "f32": np.array([1e-40, -0.0, np.inf, 2.5, -1.0], dtype=np.float32),
            "i32": np.arange(5, dtype=np.int32), "b": np.array([1, 0, 1, 1, 0], dtype=bool),
            "s": object_column(["a", None, "c", "", "e"]),
            "l": object_column([[1, 2], [], ["x"], [None], [3.5]])}


def _same_columns(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype == object:
            assert list(a[k]) == list(b[k]), k
        else:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_columnar_files_cross_read(tmp_path):
    """An npz state file of either package reads back in the other, value
    for value and dtype for dtype, object columns included."""
    from arroyo_tpu import config as jcfg

    jcfg.update({"checkpoint.file-format": "npz"})
    cols = _columns()
    p_t, p_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    write_columnar(p_t, cols)
    jtables.write_columnar(p_j, cols)
    _same_columns(read_columnar(p_j, restore=True), cols)
    _same_columns(jtables.read_columnar(p_t, restore=True), cols)
    _same_columns(read_columnar(p_t), jtables.read_columnar(p_j))


@pytest.mark.parametrize("fmt", ["parquet", "npz", "arrow"])
def test_file_format_key_is_read(fmt, tmp_path):
    """``checkpoint.file-format`` takes the JAX package's values: both write
    npz (its own fallback without pyarrow, the same bytes), and another
    value is refused before anything is written."""
    from arroyo_tpu import config as jcfg

    jcfg.update({"checkpoint.file-format": "npz"})
    tcfg.update({"checkpoint.file-format": fmt})
    cols = _columns()
    p_t, p_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    if fmt == "arrow":
        with pytest.raises(ValueError, match="checkpoint.file-format = 'arrow'"):
            write_columnar(p_t, cols)
        assert not os.path.exists(p_t)
        return
    assert write_columnar(p_t, cols) == jtables.write_columnar(p_j, cols)
    _same_columns(read_columnar(p_t, restore=True), cols)


def test_global_tables_hold_values_only(tmp_path):
    t = GlobalKeyedTable("s")
    t.insert(0, 17)
    t.insert("anchor_us", np.int64(5))
    t.insert(1, {"max_watermark": None, "last_emitted": 3})
    meta = t.write_checkpoint(str(tmp_path / "table-s-000.bin"))
    jt = jtables.GlobalKeyedTable("s")
    jt.load_files([(str(tmp_path / "table-s-000.bin"), meta)])
    assert jt.data == t.data
    # a pickle that names a class is refused, never imported
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(pickle.dumps({0: TableSpec("x", "global_keyed")}))
    with pytest.raises(pickle.UnpicklingError, match="built-in and numpy values"):
        GlobalKeyedTable("s").load_files([str(tmp_path / "bad.bin")])


@pytest.mark.parametrize("p_new", [1, 2, 4])
def test_table_manager_restore_at_another_parallelism(p_new, tmp_path):
    """Two subtasks' tables written by each package: restored at 1, 2 and 4
    subtasks, each takes exactly the rows of its key range, the same rows
    in both packages; global tables merge."""
    from arroyo_tpu import config as jcfg
    from arroyo_tpu.batch import Batch as JBatch
    from arroyo_tpu.operators.base import TableSpec as JSpec
    from arroyo_tpu.types import TaskInfo as JTaskInfo

    jcfg.update({"checkpoint.file-format": "npz"})
    url = str(tmp_path / "ck")
    rng = np.random.default_rng(3)
    for pkg in ("torch", "jax"):
        for sub in range(2):
            keys = rng.integers(0, 2**63, 50, dtype=np.int64).astype(np.uint64) * np.uint64(2)
            cols = {TIMESTAMP_FIELD: rng.integers(0, 10**6, 50), "_key": keys,
                    "v": rng.normal(size=50)}
            if pkg == "torch":
                tm = TableManager(TaskInfo(pkg, "agg", "agg", sub, 2), url)
                tm.expiring_time_key("t", 0).insert(Batch(cols))
            else:
                tm = jtables.TableManager(JTaskInfo(pkg, "agg", "agg", sub, 2), url)
                tm.expiring_time_key("t", 0).insert(JBatch(cols))
            tm.global_keyed("e").insert(sub, 100 + sub)
            tm.checkpoint(1, 1000 + sub)
    seen = {}
    for pkg in ("torch", "jax"):
        all_keys = []
        for sub in range(p_new):
            tm = TableManager(TaskInfo(pkg, "agg", "agg", sub, p_new), url)
            wm = tm.restore(1, [TableSpec("t", "expiring_time_key"), TableSpec("e", "global_keyed")])
            assert wm == 1000
            assert tm.global_keyed("e").data == {0: 100, 1: 101}
            lo, hi = tm.task_info.key_range
            for b in tm.expiring_time_key("t").all_batches():
                assert ((b.keys >= lo) & (b.keys <= hi)).all()
                all_keys.append(b.keys)
            jtm = jtables.TableManager(JTaskInfo(pkg, "agg", "agg", sub, p_new), url)
            jtm.restore(1, [JSpec("t", "expiring_time_key")])
            jk = [b.keys for b in jtm.expiring_time_key("t").all_batches()]
            tk = [b.keys for b in tm.expiring_time_key("t").all_batches()]
            assert sorted(np.concatenate(jk or [np.empty(0, np.uint64)]).tolist()) == \
                sorted(np.concatenate(tk or [np.empty(0, np.uint64)]).tolist())
        seen[pkg] = sorted(np.concatenate(all_keys).tolist())
        assert len(seen[pkg]) == 100
    assert seen["torch"] != seen["jax"]  # different random rows, each whole


# ------------------------------------------------------ engine scenarios


def _impulse_to_vec(rows, count=5000, rate=5000):
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "impulse", "message_count": count,
                                           "event_rate": rate}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "sink", EdgeType.FORWARD, DUMMY)
    return g


def test_checkpoint_and_restore(tstorage):
    """tests/test_engine.py:81: checkpoint mid-stream, stop, restore: the
    source resumes at its offset, exactly once."""
    rows1: list = []
    eng = Engine(_impulse_to_vec(rows1), job_id="ckpt", device="cpu")
    eng.start()
    assert eng.checkpoint_and_wait(1, timeout=30)
    eng.stop()
    eng.join(timeout=30)
    assert 0 < len(rows1) < 5000
    assert latest_complete_checkpoint(tstorage, "ckpt") == 1
    rows2: list = []
    eng2 = Engine(_impulse_to_vec(rows2), job_id="ckpt", device="cpu", restore_epoch=1)
    eng2.run_to_completion(timeout=60)
    counters = sorted(r["counter"] for r in rows2)
    assert counters[0] > 0 and counters == list(range(counters[0], 5000))


def test_restore_graph_mismatch_rejected(tmp_path):
    """tests/test_engine.py:202: an epoch holding state for operators the
    graph lacks is refused; so is an epoch without a marker."""
    url = str(tmp_path / "ck")
    write_job_checkpoint_metadata(url, "j1", 1, {"operators": ["wm+key+agg"]})
    eng = Engine(_impulse_to_vec([], count=1), job_id="j1", device="cpu", storage_url=url,
                 restore_epoch=1)
    with pytest.raises(RuntimeError, match="chaining"):
        eng.build()
    eng = Engine(_impulse_to_vec([], count=1), job_id="j1", device="cpu", storage_url=url,
                 restore_epoch=2)
    with pytest.raises(RuntimeError, match="no complete job marker"):
        eng.build()


def test_checkpoint_then_stop_and_cleanup(tstorage):
    """checkpoint_and_wait(then_stop=True) ends the job at the barrier with
    nothing processed past it; cleanup keeps the newest restorable epoch."""
    rows: list = []
    eng = Engine(_impulse_to_vec(rows, count=100_000, rate=20_000), job_id="cts", device="cpu")
    eng.start()
    assert eng.checkpoint_and_wait(1, timeout=30)
    assert eng.checkpoint_and_wait(2, timeout=30, then_stop=True)
    eng.join(timeout=30)
    n = len(rows)
    assert 0 < n < 100_000
    tl = eng.checkpoint_timeline(2)
    acks = [t["acked"] for t in tl["tasks"].values()]
    assert len(acks) == 2 and 0 <= min(acks) and max(acks) <= tl["durable_ms"]
    offs = TableManager(TaskInfo("cts", "src", "source", 0, 1), tstorage)
    offs.restore(2, [TableSpec("s", "global_keyed")])
    assert offs.global_keyed("s").get(0) == n  # every row before the barrier, none after
    with pytest.raises(ValueError, match="every restorable"):
        eng.cleanup(3)
    assert eng.cleanup(2) == 1
    assert latest_complete_checkpoint(tstorage, "cts") == 2
    assert not os.path.isdir(checkpoint_dir(tstorage, "cts", 1))


def _windowed_count_graph(rows, backend, count, width):
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "impulse", "message_count": count,
                                           "interval_micros": 1000, "start_time_micros": 0}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {"expr": Col(TIMESTAMP_FIELD)}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("k", BinOp("%", Col("counter"), Lit(7)))]}, 1))
    g.add_node(Node("agg", OpName.TUMBLING_AGGREGATE, {
        "width_micros": width, "key_fields": ["k"],
        "aggregates": [("cnt", "count", None), ("total", "sum", Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64), "backend": backend}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "s")]:
        g.add_edge(a, b, EdgeType.FORWARD if t == "f" else EdgeType.SHUFFLE, DUMMY)
    return g


def _checkpoint_stop_restore(build, job, rate=2000):
    """Run throttled, checkpoint epoch 1 mid-stream, stop; restore into a
    fresh engine. Returns (rows before the stop, rows after the restore)."""
    rows2: list = []
    g2 = build(rows2)
    g2.nodes["src"].config["event_rate"] = rate
    eng = Engine(g2, job_id=job, device="cpu")
    gate = chip_smoke.gate_source(eng, 3)  # mid-stream: after 2 batches
    eng.start()
    assert gate.reached.wait(30)
    assert eng.checkpoint_and_wait(1, timeout=30)
    eng.stop()
    eng.join(timeout=30)
    rows3: list = []
    Engine(build(rows3), job_id=job, device="cpu", restore_epoch=1).run_to_completion(timeout=120)
    return rows2, rows3


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_tumbling_checkpoint_restore(backend):
    """tests/test_tumbling.py:167: open windows survive; the merged output
    (a restored window's rows win) equals an uninterrupted run."""
    count, width = 3000, 500_000
    rows1: list = []
    run_graph(_windowed_count_graph(rows1, backend, count, width), job_id=f"ref-{backend}",
              timeout=60, device="cpu")
    expected = {(r["window_start"], r["k"]): (r["cnt"], r["total"]) for r in rows1}
    rows2, rows3 = _checkpoint_stop_restore(
        lambda rows: _windowed_count_graph(rows, backend, count, width), f"ckptw-{backend}")
    assert len(rows2) < len(rows1)
    merged = {}
    for r in rows2 + rows3:
        merged[(r["window_start"], r["k"])] = (r["cnt"], r["total"])
    assert merged == expected


def _sliding_graph(rows, backend, count=2000, width=500_000, slide=125_000, mixed=False):
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "impulse", "message_count": count,
                                           "interval_micros": 1000, "start_time_micros": 0}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {"expr": Col(TIMESTAMP_FIELD)}, 1))
    if mixed:
        parity = Case(((BinOp("==", BinOp("%", Col("counter"), Lit(2)), Lit(0)), Lit("even")),),
                      Lit("odd"))
        keys = [("k", BinOp("%", Col("counter"), Lit(3))), ("p", parity)]
    else:
        keys = [("k", BinOp("%", Col("counter"), Lit(5)))]
    g.add_node(Node("key", OpName.KEY, {"keys": keys}, 1))
    g.add_node(Node("agg", OpName.SLIDING_AGGREGATE, {
        "width_micros": width, "slide_micros": slide, "key_fields": [k for k, _e in keys],
        "aggregates": [("cnt", "count", None), ("total", "sum", Col("counter"))],
        "input_dtype_of": lambda e: np.dtype(np.int64), "backend": backend}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        g.add_edge(a, b, EdgeType.FORWARD if t == "f" else EdgeType.SHUFFLE, DUMMY)
    return g


@pytest.mark.parametrize("mixed", [False, True], ids=["int key", "mixed key transport"])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_sliding_checkpoint_restore(backend, mixed):
    """tests/test_sliding.py:105 and :132: sliding state (the device store,
    the host-cached bins, the string keys' dictionary) survives exactly."""
    kf = ("window_start", "k", "p") if mixed else ("window_start", "k")
    count = 1500 if mixed else 2000
    rows1: list = []
    run_graph(_sliding_graph(rows1, backend, count, mixed=mixed), job_id=f"sref-{backend}",
              timeout=120, device="cpu")
    expected = {tuple(r[f] for f in kf): (r["cnt"], r["total"]) for r in rows1}
    assert expected
    rows2, rows3 = _checkpoint_stop_restore(
        lambda rows: _sliding_graph(rows, backend, count, mixed=mixed), f"sckpt-{backend}-{mixed}")
    merged = {}
    for r in rows2 + rows3:
        merged[tuple(r[f] for f in kf)] = (r["cnt"], r["total"])
    assert merged == expected


# ----------------------------------------------------------- integrity


def _run_epochs(job_id, n_epochs=2):
    rows: list = []
    eng = Engine(_impulse_to_vec(rows), job_id=job_id, device="cpu")
    eng.start()
    for e in range(1, n_epochs + 1):
        assert eng.checkpoint_and_wait(e, timeout=30)
    eng.stop()
    eng.join(timeout=30)
    return rows


def _files(url, job_id, epoch, prefix):
    d = checkpoint_dir(url, job_id, epoch)
    return [os.path.join(d, opd, fn) for opd in sorted(os.listdir(d))
            if opd.startswith("operator-") for fn in sorted(os.listdir(os.path.join(d, opd)))
            if fn.startswith(prefix)]


def _bitflip(path):
    data = open(path, "rb").read()
    mid = len(data) // 2
    with open(path, "wb") as f:
        f.write(data[:mid] + bytes([data[mid] ^ 1]) + data[mid + 1:])


def _restore_replays_the_gap(job, epoch):
    rows: list = []
    Engine(_impulse_to_vec(rows), job_id=job, device="cpu", restore_epoch=epoch).run_to_completion(
        timeout=60)
    counters = sorted(r["counter"] for r in rows)
    assert counters == list(range(counters[0], 5000))


def test_marker_carries_integrity_manifest(tstorage):
    _run_epochs("intg-manifest", 1)
    marker = read_job_checkpoint_metadata(tstorage, "intg-manifest", 1)
    # the JAX package reads the port's marker and manifest the same way
    assert jtables.read_job_checkpoint_metadata(tstorage, "intg-manifest", 1) == marker
    assert marker["operators"] == ["sink", "src"]
    manifest = marker["integrity"]
    assert manifest and all(set(env) >= {"crc", "len", "algo"} for env in manifest.values())
    cdir = checkpoint_dir(tstorage, "intg-manifest", 1)
    for rel, env in manifest.items():
        storage.verify_envelope(storage.read_bytes(os.path.join(cdir, rel)), env, rel)
    assert fold_integrity([{"node_id": "src", "files": [{"file": "a", "crc": 1, "len": 2}],
                            "sidecar": {"file": "m", "crc": 3, "len": 4, "algo": "x"}},
                           {"no_node": 1}]) == {
        "operator-src/a": {"crc": 1, "len": 2, "algo": "crc32"},
        "operator-src/m": {"crc": 3, "len": 4, "algo": "x"}}


def test_truncated_table_file_quarantines_and_falls_back(tstorage):
    """tests/test_integrity.py:156."""
    job = "intg-trunc"
    _run_epochs(job)
    path = _files(tstorage, job, 2, "table-")[0]
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    assert any("table file" in p for p in verify_epoch(tstorage, job, 2))
    quarantined = []
    epoch, skipped = latest_valid_checkpoint(tstorage, job,
                                             on_quarantine=lambda e, r: quarantined.append(e))
    assert epoch == 1 and [s["epoch"] for s in skipped] == [2] and quarantined == [2]
    d2 = checkpoint_dir(tstorage, job, 2)
    assert os.path.exists(os.path.join(d2, QUARANTINED_METADATA))
    assert os.path.exists(os.path.join(d2, QUARANTINE_MARKER))
    assert not os.path.exists(os.path.join(d2, "metadata.json"))
    assert is_quarantined(tstorage, job, 2) and jtables.is_quarantined(tstorage, job, 2)
    # restoring the quarantined epoch itself is refused, never started fresh
    with pytest.raises(RuntimeError, match="no complete job marker"):
        Engine(_impulse_to_vec([]), job_id=job, device="cpu", restore_epoch=2).build()
    _restore_replays_the_gap(job, epoch)


def test_bitflipped_sidecar_quarantines_and_falls_back(tstorage):
    """tests/test_integrity.py:198, through the ladder's job events."""
    job = "intg-flip"
    _run_epochs(job)
    _bitflip(_files(tstorage, job, 2, "metadata-")[0])
    recorder.clear_job(job)
    assert pick_restore_epoch(tstorage, job) == 1
    assert is_quarantined(tstorage, job, 2)
    codes = [e["code"] for e in recorder.events(job)]
    assert codes == ["CHECKPOINT_QUARANTINED", "RESTORE_FELL_BACK"]
    assert recorder.events(job, "RESTORE_FELL_BACK")[0]["data"]["fallback_epoch"] == 1
    # a corrupt sidecar read by a restore raises with its context
    with pytest.raises(RestoreError, match="intg-flip|src|sink"):
        for node in ("src", "sink"):
            TableManager(TaskInfo(job, node, "x", 0, 1), tstorage).restore(2, [])


def test_torn_marker_unified_predicate_and_fallback(tstorage):
    """tests/test_integrity.py:276."""
    job = "intg-torn"
    _run_epochs(job)
    marker = os.path.join(checkpoint_dir(tstorage, job, 2), "metadata.json")
    with open(marker, "w") as f:
        f.write('{"job_id": "intg-torn", "epo')
    assert read_job_checkpoint_metadata(tstorage, job, 2) is None
    assert latest_complete_checkpoint(tstorage, job) == 1
    epoch, skipped = latest_valid_checkpoint(tstorage, job)
    assert epoch == 1 and [s["epoch"] for s in skipped] == [2]
    assert is_quarantined(tstorage, job, 2)


def test_markerless_epoch_is_invisible_not_quarantined(tstorage):
    """tests/test_integrity.py:297; subsume removes the torn epoch."""
    job = "intg-nomark"
    _run_epochs(job)
    os.remove(os.path.join(checkpoint_dir(tstorage, job, 2), "metadata.json"))
    epoch, skipped = latest_valid_checkpoint(tstorage, job)
    assert epoch == 1 and skipped == [] and not is_quarantined(tstorage, job, 2)
    assert latest_complete_checkpoint(tstorage, job) == 1
    assert not subsume_torn_epoch(tstorage, job, 1)  # complete: refused
    assert subsume_torn_epoch(tstorage, job, 2)
    assert not os.path.isdir(checkpoint_dir(tstorage, job, 2))
    _restore_replays_the_gap(job, 1)


def test_gc_never_collects_a_quarantined_epoch(tstorage):
    """tests/test_integrity.py:314."""
    job = "intg-gc"
    _run_epochs(job)
    quarantine_epoch(tstorage, job, 1, "test corruption evidence")
    assert cleanup_checkpoints(tstorage, job, min_epoch=99) >= 1
    assert os.path.isdir(checkpoint_dir(tstorage, job, 1))
    assert not os.path.isdir(checkpoint_dir(tstorage, job, 2))
    assert is_quarantined(tstorage, job, 1)
    assert not subsume_torn_epoch(tstorage, job, 1)


def test_restore_error_carries_context(tstorage):
    """tests/test_integrity.py:356."""
    ti = TaskInfo("intg-re", "src", "source", 0, 1)
    tm = TableManager(ti, tstorage)
    tm.global_keyed("s").insert(0, 42)
    tm.checkpoint(1, None)
    write_job_checkpoint_metadata(tstorage, "intg-re", 1, {"operators": ["src"]})
    _bitflip(_files(tstorage, "intg-re", 1, "table-")[0])
    with pytest.raises(RestoreError) as ei:
        TableManager(ti, tstorage).restore(1, [TableSpec("s", "global_keyed")])
    assert ei.value.epoch == 1 and ei.value.operator == "src"
    assert ei.value.path and isinstance(ei.value.cause, storage.IntegrityError)


def test_verify_off_skips_checksum_on_restore(tstorage):
    """tests/test_integrity.py:374: with state.integrity.verify = off the
    ladder trusts a bit-flipped file; the default verifies it."""
    job = "intg-off"
    _run_epochs(job, 1)
    _bitflip(_files(tstorage, job, 1, "table-")[0])
    tcfg.update({"state.integrity.verify": "off"})
    epoch, skipped = latest_valid_checkpoint(tstorage, job)
    assert epoch == 1 and skipped == []
    tcfg.update({"state.integrity.verify": "restore"})
    assert verify_epoch(tstorage, job, 1)


def test_updating_aggregate_refuses_a_spill_manifest(tmp_path):
    """A JAX package checkpoint whose updating aggregate spilled keys to run
    files (its "s__spill" manifest names them) is refused with spilling off:
    the hot rows alone would drop the spilled keys."""
    import torch

    from arroyo_tpu_torch.operators.base import OperatorContext
    from arroyo_tpu_torch.operators.updating_aggregate import UpdatingAggregate

    ti = TaskInfo("j", "agg", "updating_aggregate", 0, 1)
    for manifest, refused in (({0: {"runs": [{"file": "run-aa-s0-e1-0.parquet"}]}}, True),
                              ({0: {"runs": []}}, False)):
        tm = TableManager(ti, str(tmp_path))
        tm.global_keyed("c3.s__spill").data.update(manifest)
        op = UpdatingAggregate({"aggregates": [("n", "count", None)], "backend": "numpy"})
        ctx = OperatorContext(ti, torch.device("cpu"), table_manager=tm)
        if refused:
            with pytest.raises(RuntimeError, match=r"spilled run file.*state\.spill\.enabled"):
                op.on_start(ctx)
        else:
            op.on_start(ctx)
