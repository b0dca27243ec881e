"""The port's InstantJoin (arroyo_tpu_torch/operators/joins.py) against
arroyo_tpu's on the same input stream, for inner, left, right and full
joins, through the host gate and through the device path
(``device.force-device-join`` with ``device.join-min-rows`` 0): the
emitted batches and the forwarded watermarks compared in order, columns,
dtypes and object nulls included. Also the pieces the operator rests on:
the Batch operations over object columns and the engine's map from a flat
input index to its edge."""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import batch as jbatch
from arroyo_tpu import config as jcfg
from arroyo_tpu import hashing as jhashing
from arroyo_tpu import types as jtypes
from arroyo_tpu.operators.base import OperatorContext as JaxContext
from arroyo_tpu.operators.joins import InstantJoin as JaxJoin
from arroyo_tpu.state.tables import TableManager
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import hashing as thashing
from arroyo_tpu_torch import types as ttypes
from arroyo_tpu_torch.operators.base import OperatorContext as TorchContext
from arroyo_tpu_torch.operators.joins import InstantJoin as TorchJoin
from arroyo_tpu_torch.ops import join_probe as tjp

TS = "_timestamp"
CFG = {"left_names": [("lid", "id"), ("lv", "v"), ("ls", "s")],
       "right_names": [("rid", "id"), ("rf", "f")]}


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


class Recorder:
    """Collector that keeps batches and broadcast watermarks in order."""

    def __init__(self):
        self.items = []

    def collect(self, b):
        self.items.append(("batch", b))

    def broadcast(self, s):
        self.items.append(("watermark", s.watermark.value if not s.watermark.is_idle else "idle"))


class Side:
    """One package's operator, context and recorder."""

    def __init__(self, pkg, jt, backend, tmp_path):
        self.pkg = pkg
        cfg = {**CFG, "join_type": jt, "backend": backend}
        if pkg == "jax":
            ti = jtypes.TaskInfo("j", "join", "join", 0, 1)
            self.ctx = JaxContext(ti, None, TableManager(ti, str(tmp_path)),
                                  in_edge_of_input=lambda i: (i, 0))
            self.op, self.B, self.types, self.hash = JaxJoin(cfg), jbatch, jtypes, jhashing
        else:
            ti = ttypes.TaskInfo("j", "join", "join", 0, 1)
            self.ctx = TorchContext(ti, torch.device("cpu"), lambda i: (i, 0))
            self.op, self.B, self.types, self.hash = TorchJoin(cfg), tbatch, ttypes, thashing
        self.rec = Recorder()

    def batch(self, side, ts, ids, rng_vals):
        k = np.asarray(ids, dtype=np.int64)
        cols = {TS: np.asarray(ts, dtype=np.int64), "id": k}
        if side == 0:
            cols["v"] = rng_vals.astype(np.int32)
            cols["s"] = np.array([None if i % 3 == 0 else f"s{i}" for i in k], dtype=object)
        else:
            cols["f"] = rng_vals.astype(np.float64)
        cols["_key"] = self.hash.hash_columns([k])
        return self.B.Batch(cols)

    def feed(self, event):
        kind = event[0]
        if kind == "batch":
            _k, side, ts, ids, vals = event
            self.op.process_batch(self.batch(side, ts, ids, vals), self.ctx, self.rec,
                                  input_index=side)
        elif kind == "watermark":
            wm = self.types.Watermark.event_time(event[1])
            out = self.op.handle_watermark(wm, self.ctx, self.rec)
            if out is not None:
                self.rec.items.append(("watermark", out.value))
        else:
            self.op.on_close(self.ctx, self.rec)


def stream(seed):
    """Interleaved batches of both sides over windows 100..700 (rows
    stamped with their window start, some batches spanning several windows
    and out of order), watermarks that close one window, several windows at
    once, late rows behind a closed window, and the end of the stream."""
    rng = np.random.default_rng(seed)

    def rows(side, windows, n):
        ts = rng.choice(windows, n)
        if rng.random() < 0.5:
            ts = np.sort(ts)
        return ("batch", side, ts, rng.integers(0, 12, n), rng.integers(-1000, 1000, n))

    ev = [rows(0, [100], 7), rows(1, [100], 9), rows(1, [100, 200], 30), rows(0, [200], 4),
          ("watermark", 150), rows(0, [200, 300], 25), rows(1, [300], 3), ("watermark", 150),
          rows(1, [100, 200], 6),  # late for 100: dropped; 200 kept
          ("watermark", 250), rows(0, [400], 5), rows(1, [500], 8), rows(0, [500, 600], 40),
          rows(1, [600], 2000), rows(0, [600], 2100),
          ("watermark", 650),  # closes 300, 400, 500 and 600 at once
          rows(0, [700], 3), rows(1, [700, 800], 12), rows(0, [900], 2), ("close",)]
    return ev


def same_item(a, b):
    assert a[0] == b[0]
    if a[0] == "watermark":
        assert a[1] == b[1]
        return
    ja, tb = a[1], b[1]
    assert list(ja.columns) == list(tb.columns)
    for name in ja.columns:
        x, y = np.asarray(ja[name]), np.asarray(tb[name])
        assert x.dtype == y.dtype, name
        if x.dtype == object:
            assert x.tolist() == y.tolist(), name
        else:
            assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("gate", ["host", "device", "numpy backend"])
def test_instant_join_matches_reference_in_order(jt, gate, tmp_path):
    if gate == "device":
        for c in (jcfg, tcfg):
            c.update({"device.force-device-join": True, "device.join-min-rows": 0})
    backend = "numpy" if gate == "numpy backend" else None
    for seed in (1, 2):
        jx, tx = Side("jax", jt, backend, tmp_path), Side("torch", jt, backend, tmp_path)
        for ev in stream(seed):
            jx.feed(ev)
            tx.feed(ev)
        assert len(jx.rec.items) == len(tx.rec.items)
        for a, b in zip(jx.rec.items, tx.rec.items):
            same_item(a, b)
        assert tx.op.late_rows == jx.op.late_rows > 0
        assert tx.op.emitted_before == jx.op.emitted_before
        assert sum(1 for k, _ in tx.rec.items if k == "watermark") >= 3


def test_device_gate_routes_each_window_through_the_probe(tmp_path, monkeypatch):
    """Forced device path on the CPU: every window whose sides both hold rows
    goes through device_join_start (the port's plain K5/K6), none through
    the fused host close; the host gate sends the multi-window close to the
    fused path and no window to the device."""
    calls = []
    real = tjp.device_join_start

    def spy(lk, rk, device):
        calls.append((len(lk), len(rk), str(device)))
        return real(lk, rk, device)

    import arroyo_tpu_torch.operators.joins as tjoins

    monkeypatch.setattr(tjoins, "device_join_start", spy)
    tcfg.update({"device.force-device-join": True, "device.join-min-rows": 0})
    tx = Side("torch", "inner", None, tmp_path)
    for ev in stream(1):
        tx.feed(ev)
    assert len(calls) == 6 and all(d == "cpu" for *_n, d in calls)
    tcfg.update({"device.force-device-join": False, "device.join-min-rows": 2048})
    calls.clear()
    tx = Side("torch", "inner", None, tmp_path)
    for ev in stream(1):
        tx.feed(ev)
    assert calls == []


@pytest.mark.parametrize("gate", ["host", "device"])
def test_checkpoint_barrier_snapshots_and_restores_as_the_reference(gate, tmp_path):
    """A barrier mid-stream drains the closes in flight first (their rows
    precede it); the buffered rows of both sides are written in window
    order, row for row the JAX package's, with the late-data mark; each
    package's
    checkpoint, restored in the port (the JAX package's one too), goes on
    to emit what the uninterrupted reference emits after the barrier, in
    order."""
    from arroyo_tpu_torch.state.tables import TableManager as TorchTables

    if gate == "device":
        for c in (jcfg, tcfg):
            c.update({"device.force-device-join": True, "device.join-min-rows": 0})
    jcfg.update({"checkpoint.file-format": "npz"})
    events = stream(3)
    cut = 10  # after watermark 250, which closes window 200
    sides = {pkg: Side(pkg, "full", None, tmp_path / pkg) for pkg in ("jax", "torch")}
    sides["torch"].ctx.table_manager = TorchTables(sides["torch"].ctx.task_info,
                                                   str(tmp_path / "torch"))
    for ev in events[:cut]:
        for sd in sides.values():
            sd.feed(ev)
    for pkg, sd in sides.items():
        sd.op.handle_checkpoint(sd.types.CheckpointBarrier(1), sd.ctx, sd.rec)
        sd.ctx.table_manager.checkpoint(1, None)
    for a, b in zip(sides["jax"].rec.items, sides["torch"].rec.items, strict=True):
        same_item(a, b)
    tables = {}
    for pkg in sides:
        tm = TorchTables(ttypes.TaskInfo("j", "join", "join", 0, 1), str(tmp_path / pkg))
        tm.restore(1, TorchJoin({**CFG, "join_type": "full"}).tables())
        tables[pkg] = tm
        for name in ("left", "right"):
            got = tm.expiring_time_key(name).all_batches()
            want = tables["jax"].expiring_time_key(name).all_batches()
            assert len(got) == len(want) and len(got) > 0
            for x, y in zip(got, want):
                same_item(("batch", x), ("batch", y))
        assert tm.global_keyed("e").data == {0: 250}  # the watermark that closed 200
    # the rest of the stream, uninterrupted, in the reference
    ref = sides["jax"]
    mark = len(ref.rec.items)
    for ev in events[cut:]:
        ref.feed(ev)
    for pkg in ("torch", "jax"):
        restored = Side("torch", "full", None, tmp_path / "r")
        restored.ctx.table_manager = TorchTables(restored.ctx.task_info, str(tmp_path / pkg))
        restored.ctx.table_manager.restore(1, restored.op.tables())
        restored.op.on_start(restored.ctx)
        for ev in events[cut:]:
            restored.feed(ev)
        assert len(restored.rec.items) == len(ref.rec.items) - mark > 0
        for a, b in zip(ref.rec.items[mark:], restored.rec.items):
            same_item(a, b)


def test_batch_operations_keep_object_columns_and_dtypes():
    def cols(B):
        return B.Batch({
            TS: np.arange(6, dtype=np.int64), "_key": np.arange(6, dtype=np.uint64) * 7,
            "i": np.arange(6, dtype=np.int32), "f": np.linspace(0, 1, 6).astype(np.float32),
            "b": np.array([1, 0, 1, 1, 0, 0], dtype=bool),
            "o": np.array([None, "a", None, 3, "c", None], dtype=object)})

    jb, tb = cols(jbatch), cols(tbatch)
    mask = np.array([1, 0, 1, 0, 1, 1], dtype=bool)
    idx = np.array([5, 0, 0, 3])
    pairs = [(jb.filter(mask), tb.filter(mask)), (jb.take(idx), tb.take(idx)),
             (jb.slice(1, 4), tb.slice(1, 4)),
             (jbatch.Batch.concat([jb, jb.slice(0, 2)]), tbatch.Batch.concat([tb, tb.slice(0, 2)])),
             (jbatch.Batch.concat([jb]), tbatch.Batch.concat([tb]))]
    for a, b in pairs:
        same_item(("batch", a), ("batch", b))
        assert b["o"].dtype == object
    assert tbatch.Batch.concat([tb, tb])["o"].tolist()[6:] == [None, "a", None, 3, "c", None]


def test_engine_maps_flat_inputs_to_their_edge():
    from arroyo_tpu_torch.engine import Engine
    from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName

    S = tbatch.Schema.of([(TS, "int64")])
    g = Graph()
    for nid, p in (("a", 2), ("b", 3)):
        g.add_node(Node(nid, OpName.SOURCE, {"connector": "nexmark", "event_count": 10}, p))
    g.add_node(Node("join", OpName.INSTANT_JOIN, {**CFG, "join_type": "inner"}, 1))
    g.add_edge("a", "join", EdgeType.LEFT_JOIN, S)
    g.add_edge("b", "join", EdgeType.RIGHT_JOIN, S)
    eng = Engine(g, device="cpu")
    eng.build()
    ctx = eng.tasks[("join", 0)].ctx
    assert [ctx.edge_of_input(i) for i in range(5)] == [0, 0, 1, 1, 1]
    assert [ctx._in_edge_of_input(i) for i in range(5)] == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
    with pytest.raises(IndexError):
        ctx.edge_of_input(5)


def test_device_close_on_cuda_without_a_card_raises_not_falls_back(tmp_path):
    """On a CUDA device a close that cannot reach the card (this build of
    torch has no CUDA) raises out of the operator; it is never answered by
    the host probe instead."""
    tcfg.update({"device.join-min-rows": 0})
    tx = Side("torch", "inner", None, tmp_path)
    tx.ctx = TorchContext(tx.ctx.task_info, torch.device("cuda"), lambda i: (i, 0))
    events = stream(1)
    for ev in events[:4]:
        tx.feed(ev)
    with pytest.raises(RuntimeError):
        tx.feed(("watermark", 150))
    assert not [k for k, _b in tx.rec.items if k == "batch"]
