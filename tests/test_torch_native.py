"""The port's binding of the native host library (arroyo_tpu_torch/native)
against arroyo_tpu's, on the CPU.

C5: the slot directory resolves a batch's rows in one C pass and hands the
groups that own no slot yet to the allocator in the order the batch first
shows them, in both packages; with native.enabled off, both take numpy's
path, which allocates in code order. The slots of every row, the spilled
(key, bin) groups and the emitted rows are held equal batch by batch.
Also: the native hashes and the keyed shuffle's partition against the
reference and against the port's numpy path, the library's build (into the
port's build directory, never under cpp/; several processes at once; a
failed build raises with the compiler's log)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import arroyo_tpu.hashing as jhashing
import arroyo_tpu.native as jnative
import arroyo_tpu_torch.config as tcfg
import arroyo_tpu_torch.hashing as thashing
import arroyo_tpu_torch.native as tnative
from arroyo_tpu.ops.slot_agg import SlotAggregator as JaxAggregator
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(cap=64, batch_cap=64, region_size=16)
KINDS, DTYPES = ("count", "sum", "max"), (np.int64, np.int64, np.int64)


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def native_on(request, monkeypatch):
    """native.enabled on both sides; off, the JAX package's loader reports
    no library (its flag is read once per process, so the test stubs it)."""
    tcfg.update({"native.enabled": request.param})
    if request.param:
        assert jnative.available() and tnative.available()
    else:
        monkeypatch.setattr(jnative, "lib", lambda: None)
        assert tnative.lib() is None
    return request.param


def _stream(seed, steps=16):
    """Per step: 120 rows over 90 keys in three bins, two of them new: more
    groups than the 64 slots, so each batch opens groups in several bins,
    the table fills and the surplus spills."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        n = 120
        keys = rng.integers(0, 90, n).astype(np.uint64)
        bins = (step // 4 + rng.integers(0, 3, n)).astype(np.int32)
        vals = rng.integers(-50, 100, n)
        out.append((keys, bins, [np.ones(n, np.int64), vals.astype(np.int64),
                                 vals.astype(np.int64)]))
    return out


def _row_slots(agg, keys, bins):
    """The device slot of every row's (key, bin) group, -1 where it spilled."""
    d = agg.directory
    where = {}
    for r, fill in enumerate(np.asarray(d.region_fill).tolist()):
        for s in range(r * agg.region_size, r * agg.region_size + int(fill)):
            where[(int(d.slot_keys[s]), int(d.slot_bins[s]))] = s
    ks = keys.view(np.int64).tolist()
    return [where.get((k, int(b)), -1) for k, b in zip(ks, bins.tolist())]


def _rows(extracted):
    keys, bins, accs = extracted
    return [(int(k), int(b), *(int(a[i]) for a in accs))
            for i, (k, b) in enumerate(zip(keys.tolist(), bins.tolist()))]


def _trace(agg, steps):
    """Per batch: the slot of every row and the spilled groups; every four
    batches, the rows a window close emits, in emission order."""
    out = []
    for i, (keys, bins, vals) in enumerate(steps):
        agg.update(keys, bins, vals)
        out.append(("slots", i, _row_slots(agg, keys, bins)))
        out.append(("spill", i, sorted(agg.spill)))
        if i % 4 == 3:
            close = i // 4 + 1
            out.append(("emit", i, _rows(agg.extract(0, close, close))))
    out.append(("emit", "end", _rows(agg.extract(0, 1 << 30, 1 << 30))))
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_c5_slot_directory_allocates_as_the_jax_package(seed, native_on):
    steps = _stream(seed)
    want = _trace(JaxAggregator(KINDS, DTYPES, backend="jax", emit_cap=64, **KW), steps)
    got = _trace(SlotAggregator(KINDS, DTYPES, device="cpu", **KW), steps)
    for g, w in zip(got, want):
        assert g == w, g[:2]
    assert len(got) == len(want)
    assert any(kind == "spill" and groups for kind, _i, groups in want)
    assert any(kind == "slots" and len({x for x in s if x >= 0}) > 40 for kind, _i, s in want)


def test_c5_native_and_numpy_orders_differ():
    """The two allocation orders really differ on this stream, so the test
    above would fail if one package took the other's path."""
    steps = _stream(3)
    tcfg.update({"native.enabled": True})
    nat = _trace(SlotAggregator(KINDS, DTYPES, device="cpu", **KW), steps)
    tcfg.update({"native.enabled": False})
    num = _trace(SlotAggregator(KINDS, DTYPES, device="cpu", **KW), steps)
    assert nat[0] != num[0]


def test_slots_of_reads_without_allocating(native_on):
    agg = SlotAggregator(KINDS, DTYPES, device="cpu", **KW)
    jagg = JaxAggregator(KINDS, DTYPES, backend="jax", emit_cap=64, **KW)
    keys = np.arange(40, dtype=np.uint64) * np.uint64(7919)
    for a in (agg, jagg):
        a.update(keys[:30], np.zeros(30, np.int32), [np.ones(30, np.int64)] * 3)
    before = agg.directory.to_state()
    got = agg.slots_of(keys)
    assert got.tolist() == jagg.slots_of(keys).tolist()
    assert (got[30:] == -1).all() and (got[:30] >= 0).all()
    after = agg.directory.to_state()
    assert all(np.array_equal(np.asarray(before[k]), np.asarray(after[k]))
               for k in ("slot_keys", "hcode", "hslot"))


# ------------------------------------------------------------ hashes


def _columns(seed, n=4096):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n) * 1e6
    f[:8] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324, -5e-324]
    return {
        "int64": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        "uint64": rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
        "int32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "float64": f,
        "float32": f.astype(np.float32),
        "bool": rng.integers(0, 2, n).astype(bool),
        "str": np.array([f"k{i % 97}" for i in range(n)], dtype=object),
    }


@pytest.mark.parametrize("kind", list(_columns(0)))
def test_hash_column_native_equals_numpy_and_reference(kind):
    col = _columns(5)[kind]
    tcfg.update({"native.enabled": True})
    native = thashing.hash_column(col)
    tcfg.update({"native.enabled": False})
    numpy_path = thashing.hash_column(col)
    assert native.dtype == numpy_path.dtype == np.uint64
    assert np.array_equal(native, numpy_path)
    assert np.array_equal(native, jhashing.hash_column(col))


@pytest.mark.parametrize("names", [("int64", "float64"), ("str", "int32", "bool"),
                                   ("uint64", "float32", "int64", "str")])
def test_hash_columns_native_equals_numpy_and_reference(names):
    cols = [_columns(9)[n] for n in names]
    tcfg.update({"native.enabled": True})
    native = thashing.hash_columns(cols)
    tcfg.update({"native.enabled": False})
    assert np.array_equal(native, thashing.hash_columns(cols))
    assert np.array_equal(native, jhashing.hash_columns(cols))


@pytest.mark.parametrize("n_dest", [1, 2, 3, 7, 8, 32])
def test_partition_equals_reference_and_stable_argsort(n_dest):
    rng = np.random.default_rng(n_dest)
    hashes = rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64)
    hashes[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    perm, offsets = tnative.partition(hashes, n_dest)
    jperm, joffsets = jnative.partition(hashes, n_dest)
    assert np.array_equal(perm, jperm) and np.array_equal(offsets, joffsets)
    dests = thashing.servers_for_hashes(hashes, n_dest)
    order = np.argsort(dests, kind="stable")
    assert np.array_equal(perm, order)
    assert np.array_equal(offsets, np.searchsorted(dests[order], np.arange(n_dest + 1)))


def test_keyed_shuffle_routes_as_the_numpy_path():
    """The collector's keyed shuffle sends each destination the same rows
    in the same order with the native partition as with numpy's."""
    from arroyo_tpu_torch.batch import KEY_FIELD, Batch
    from arroyo_tpu_torch.graph import EdgeType
    from arroyo_tpu_torch.operators.collector import Collector, OutEdge

    class Sink:
        def __init__(self):
            self.got = []

        def put(self, idx, item):
            self.got.append(item)

    rng = np.random.default_rng(1)
    batch = Batch({KEY_FIELD: rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64),
                   "x": np.arange(3000, dtype=np.int64)})
    seen = []
    for on in (True, False):
        tcfg.update({"native.enabled": on, "engine.coalesce.enabled": False})
        sinks = [Sink() for _ in range(5)]
        Collector([OutEdge(EdgeType.SHUFFLE, sinks, [0] * 5)], 0).collect(batch)
        seen.append([np.concatenate([b["x"] for b in s.got]).tolist() for s in sinks])
    assert seen[0] == seen[1]


# ------------------------------------------------------------- build


def test_library_builds_under_the_port_never_under_cpp():
    cpp = os.path.join(REPO, "cpp")
    before = {f: os.stat(os.path.join(cpp, f)).st_mtime_ns for f in os.listdir(cpp)}
    assert tnative.available()
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert os.path.commonpath([str(path), os.path.join(REPO, "arroyo_tpu_torch")]) \
        == os.path.join(REPO, "arroyo_tpu_torch")
    assert path.exists()
    after = {f: os.stat(os.path.join(cpp, f)).st_mtime_ns for f in os.listdir(cpp)}
    assert before == after


_BUILD = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import arroyo_tpu_torch.native as n
    n.BUILD_DIR = Path(sys.argv[1])
    start = float(sys.argv[2])
    while time.time() < start:
        time.sleep(0.005)
    import numpy as np
    h = n.hash_u64(np.arange(4, dtype=np.uint64))
    print(n.build_info["cached"], int(h[1]))
""")


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Four processes build at the same moment into an empty directory:
    each loads a whole library, and exactly one build is left in place
    with no temporary file beside it."""
    import time

    start = time.time() + 2.0
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path), str(start)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    want = int(jhashing.splitmix64(np.arange(4, dtype=np.uint64))[1])
    results = [o.split() for o, _e in outs]
    assert all(int(r[1]) == want for r in results)
    assert sorted(r[0] for r in results).count("False") >= 1  # someone built it
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.endswith(".so")] == [tnative.library_path().name]
    assert not [f for f in files if f.endswith(".tmp")]


def test_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    bad = tmp_path / "arroyo_host.cc"
    bad.write_text("extern \"C\" { int ah_hash_u64( }\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(tnative.NativeBuildError, match="g\\+\\+ failed") as e:
        tnative.hash_u64(np.arange(3, dtype=np.uint64))
    assert "error" in str(e.value)  # the compiler's own message rides along
    tcfg.update({"native.enabled": False})
    assert tnative.hash_u64(np.arange(3, dtype=np.uint64)) is None
    assert np.array_equal(thashing.hash_column(np.arange(3, dtype=np.int64)),
                          jhashing.splitmix64(np.arange(3, dtype=np.uint64)))
