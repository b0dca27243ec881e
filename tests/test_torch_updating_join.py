"""The port's updating join (JoinWithExpiration) against the JAX package's,
batch for batch: tests/test_joins.py's cases (inner, left, right and full
joins; null pads and their retraction at the first match; a retracted last
match restoring the pads; TTL expiry), seeded random streams of appends and
retractions for every join type, with spilling off and on, and checkpoints
written by either package restored by the other."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg

JOIN_TYPES = ("inner", "left", "right", "full")


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from arroyo_tpu.batch import Batch
        from arroyo_tpu.hashing import hash_columns
        from arroyo_tpu.operators.base import OperatorContext
        from arroyo_tpu.operators.joins import JoinWithExpiration
        from arroyo_tpu.state.tables import TableManager
        from arroyo_tpu.types import TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, tm, in_edge_of_input=lambda i: (i, 0))
        cfg = jcfg
    else:
        from arroyo_tpu_torch.batch import Batch
        from arroyo_tpu_torch.hashing import hash_columns
        from arroyo_tpu_torch.operators.base import OperatorContext
        from arroyo_tpu_torch.operators.joins import JoinWithExpiration
        from arroyo_tpu_torch.state.tables import TableManager
        from arroyo_tpu_torch.types import TaskInfo, Watermark

        def ctx(ti, tm):
            return OperatorContext(ti, None, in_edge_of_input=lambda i: (i, 0),
                                   table_manager=tm)
        cfg = tcfg
    return SimpleNamespace(name=name, Batch=Batch, hash_columns=hash_columns, ctx=ctx,
                           Join=JoinWithExpiration, TableManager=TableManager,
                           TaskInfo=TaskInfo, Watermark=Watermark, cfg=cfg)


JAX, PORT = _pkg("jax"), _pkg("port")


@pytest.fixture(autouse=True)
def _configs(tmp_path):
    for P in (JAX, PORT):
        P.cfg.reset()
        P.cfg.update({"checkpoint.storage-url": str(tmp_path / f"{P.name}-ckpt"),
                      "checkpoint.file-format": "npz"})
    yield
    for P in (JAX, PORT):
        P.cfg.reset()


class Collector:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)

    def broadcast(self, s):
        pass


class Side:
    """One package's operator, table manager, context and collector."""

    def __init__(self, P, jt, storage, ttl=None, restore=None):
        self.P = P
        cfg = {"join_type": jt, "left_names": [("lid", "id"), ("lv", "v"), ("lw", "w")],
               "right_names": [("rid", "id"), ("rv", "v")]}
        if ttl is not None:
            cfg["ttl_micros"] = ttl
        self.op = P.Join(cfg)
        self.ti = P.TaskInfo("j", "exp_join", "join_with_expiration", 0, 1)
        self.tm = P.TableManager(self.ti, storage)
        if restore is not None:
            self.tm.restore(restore, self.op.tables())
        self.ctx = P.ctx(self.ti, self.tm)
        self.col = Collector()
        self.op.on_start(self.ctx)

    def batch(self, side, ts, keys, vals, ws, retracts=None):
        k = np.array(keys, dtype=np.int64)
        cols = {"_timestamp": np.array(ts, dtype=np.int64), "id": k,
                "v": np.array(vals, dtype=object), "_key": self.P.hash_columns([k])}
        if side == 0:
            cols["w"] = np.array(ws, dtype=np.float64)
        if retracts is not None:
            cols["_is_retract"] = np.array(retracts, dtype=bool)
        self.op.process_batch(self.P.Batch(cols), self.ctx, self.col, input_index=side)

    def watermark(self, t):
        return self.op.handle_watermark(self.P.Watermark.event_time(t), self.ctx, self.col)

    def checkpoint(self, epoch):
        barrier = SimpleNamespace(epoch=epoch)
        self.op.handle_checkpoint(barrier, self.ctx, self.col)
        self.tm.checkpoint(epoch, None)


def batches_form(col: Collector) -> list:
    """Every emitted batch as (column, dtype, values with their types)."""
    out = []
    for b in col.batches:
        cols = []
        for name, a in b.columns.items():
            a = np.asarray(a)
            vals = ([(type(v).__name__, repr(v)) for v in a.tolist()] if a.dtype == object
                    else a.tobytes())  # repr: a NaN equals itself
            cols.append((name, str(a.dtype), vals))
        out.append(cols)
    return out


def apply(side: Side, steps: list) -> list:
    marks = []
    for st in steps:
        if st[0] == "b":
            side.batch(*st[1:])
        elif st[0] == "wm":
            w = side.watermark(st[1])
            marks.append(None if w is None else w.value)
    return marks


def run_both(jt, steps, tmp_path, ttl=None):
    outs = {}
    for P in (JAX, PORT):
        s = Side(P, jt, str(tmp_path / P.name), ttl=ttl)
        marks = apply(s, steps)
        outs[P.name] = (batches_form(s.col), marks)
    assert outs["port"] == outs["jax"]
    return outs["port"]


def test_inner_append_only(tmp_path):
    out, _ = run_both("inner", [("b", 0, [0], [1], ["a"], [0.5]), ("b", 1, [1], [1], ["x"], None),
                                ("b", 0, [2], [1], ["b"], [1.5])], tmp_path)
    assert len(out) == 2


def test_left_null_then_match_and_last_match_retracted(tmp_path):
    out, _ = run_both("left", [("b", 0, [0], [1], ["a"], [0.5]),
                               ("b", 1, [1], [1], ["x"], None),
                               ("b", 1, [2], [1], ["x"], None, [True])], tmp_path)
    assert len(out) == 3


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_every_join_type_with_pads(jt, tmp_path):
    run_both(jt, [("b", 0, [0, 1], [1, 2], ["a", None], [0.5, np.nan]),
                  ("b", 1, [1, 2, 3], [2, 3, 2], ["x", "y", "z"], None),
                  ("b", 0, [4, 5], [3, 3], ["c", "d"], [1.0, -0.0]),
                  ("b", 1, [6], [2], ["x"], None, [True]),
                  ("b", 0, [7], [1], ["a"], [0.5], [True])], tmp_path)


def test_ttl_expiry_holds_the_watermark(tmp_path):
    _out, marks = run_both("left", [("b", 0, [0, 4000], [1, 2], ["a", "b"], [1.0, 2.0]),
                                    ("wm", 3000), ("wm", 5000),
                                    ("b", 1, [5000], [1], ["x"], None)], tmp_path, ttl=1000)
    assert marks == [3000, 4000]  # held to the oldest stored row


def random_steps(seed: int, n_steps: int = 60, ttl_wm: bool = True) -> list:
    """Appends of a few rows per side over a small keyspace, retractions of
    rows still stored (a retraction names a stored row's values), and
    watermarks that expire rows under a short TTL."""
    rng = np.random.default_rng(seed)
    live = {0: [], 1: []}  # (ts, key, v, w)
    steps, t, cutoff = [], 0, None
    ttl = 5_000
    for _ in range(n_steps):
        r = rng.random()
        side = int(rng.integers(0, 2))
        if ttl_wm and r < 0.1:
            t += int(rng.integers(0, 3000))
            steps.append(("wm", t))
            cutoff = t - ttl
            for s in (0, 1):
                live[s] = [row for row in live[s] if row[0] >= cutoff]
            continue
        if r < 0.3 and live[side]:
            k = int(rng.integers(1, min(3, len(live[side])) + 1))
            pick = sorted(rng.choice(len(live[side]), k, replace=False).tolist(), reverse=True)
            rows = [live[side].pop(i) for i in pick]
            t += int(rng.integers(0, 400))
            steps.append(("b", side, [t] * k, [x[1] for x in rows], [x[2] for x in rows],
                          [x[3] for x in rows] if side == 0 else None, [True] * k))
            continue
        k = int(rng.integers(1, 6))
        ts = (t + np.sort(rng.integers(0, 500, k))).tolist()
        t = ts[-1]
        keys = rng.integers(0, 6, k).tolist()
        vals = [None if rng.random() < 0.15 else f"s{int(x)}" for x in rng.integers(0, 4, k)]
        ws = rng.normal(0, 10, k).round(2).tolist()
        rows = list(zip(ts, keys, vals, ws))
        live[side] += rows
        steps.append(("b", side, ts, keys, vals, ws if side == 0 else None))
    return steps


@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_streams_batch_for_batch(jt, seed, tmp_path):
    run_both(jt, random_steps(100 * seed + len(jt)), tmp_path, ttl=5_000)


def small_spill_files(monkeypatch) -> None:
    """Spilling on in both packages at a budget of a few rows, in run files
    of 1 KiB (the JAX package's config key, the port's constant)."""
    from arroyo_tpu_torch.state import spill

    for P in (JAX, PORT):
        P.cfg.update({"state.spill.enabled": True, "state.spill.budget-bytes": 400})
    JAX.cfg.update({"state.spill.target-file-bytes": 1024})
    monkeypatch.setattr(spill, "TARGET_FILE_BYTES", 1024)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_random_streams_with_spilling(jt, tmp_path, monkeypatch):
    """With a budget of a few rows, side-store rows spill and promote back
    on every probe, in both packages alike."""
    small_spill_files(monkeypatch)
    run_both(jt, random_steps(7 + len(jt), n_steps=80), tmp_path, ttl=5_000)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
@pytest.mark.parametrize("spill", [False, True], ids=["resident", "spilled"])
def test_checkpoint_crosses_the_packages(writer, jt, spill, tmp_path, monkeypatch):
    """The first half of a stream in one package, a checkpoint (tables
    ``left``/``right``, and with spilling the ``*__spill`` manifests), a
    restore into either package: the second half emits the same batches."""
    if spill:
        small_spill_files(monkeypatch)
    steps = random_steps(31 + len(jt), n_steps=70)
    first, second = steps[:35], steps[35:]
    W = JAX if writer == "jax" else PORT
    storage = str(tmp_path / "shared")
    w = Side(W, jt, storage, ttl=5_000)
    apply(w, first)
    w.checkpoint(1)
    if spill:
        assert w.op._annexes[0].has_runs() or w.op._annexes[1].has_runs()
    outs = {}
    for P in (JAX, PORT):
        r = Side(P, jt, storage, ttl=5_000, restore=1)
        apply(r, second)
        outs[P.name] = batches_form(r.col)
    assert outs["port"] == outs["jax"]
