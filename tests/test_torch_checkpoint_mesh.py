"""Checkpoint and restore through the key-sharded mesh (the window state in
a ShardedAggregator of device.mesh-devices shards on one device) in the
port on the CPU, held against arroyo_tpu's mesh on its emulated CPU
devices:

- tests/test_mesh_operator.py:52 and :162: tumbling and sliding windows
  over 8 shards checkpoint mid-stream and restore exactly;
- q7 through 8 shards, the fused mesh step and the host path: both
  packages' epoch-1 tables are equal once decoded, and a restore in either
  direction finishes the stream exactly once. A barrier is a signal, so it
  never arrives inside a fused step: the snapshot is a host copy of the
  sharded state between micro-batches;
- the resize: a checkpoint taken at 4 shards restores at 8, in the port
  and across the packages, and gives the oracle's windows."""

import shutil

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import config as jcfg
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
from arroyo_tpu_torch.engine import Engine
from arroyo_tpu_torch.engine import segment as tseg
from arroyo_tpu_torch.expr import BinOp, Col, Lit
from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
from arroyo_tpu_torch.parallel import sharded_agg as tsharded
from test_torch_checkpoint_queries import MODULES, _engine, decoded_tables
from test_torch_q7 import build_q7, oracle_q7, windows

pytestmark = pytest.mark.mesh

DUMMY = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
Q7_EVENTS = 40_000
Q7_POLLS = 6  # the barrier after 5 batches of 4096 rows
Q7_MESH = {"pipeline.chaining.enabled": True, "pipeline.source-batch-size": 4096,
           "device.batch-capacity": 4096, "device.table-capacity": 4096,
           "device.emit-capacity": 2048, "segment.compile.min-rows": 1024,
           "worker.queue-size": 8192}


def _need_devices():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")


@pytest.fixture(autouse=True)
def _port_config(tmp_path):
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "torch-checkpoints"),
                 "device.mesh-devices": 8, "device.table-capacity": 1024,
                 "device.batch-capacity": 256, "device.emit-capacity": 256,
                 "device.spill-capacity": 256, "device.max-probes": 32})
    yield
    tcfg.reset()


def _impulse_window(rows, op, count, width, slide=None, rate=2000):
    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "impulse", "message_count": count,
                                           "interval_micros": 1000, "start_time_micros": 0,
                                           "event_rate": rate}, 1))
    g.add_node(Node("wm", OpName.WATERMARK, {"expr": Col(TIMESTAMP_FIELD)}, 1))
    g.add_node(Node("key", OpName.KEY, {"keys": [("k", BinOp("%", Col("counter"), Lit(5)))]}, 1))
    cfg = {"width_micros": width, "key_fields": ["k"],
           "aggregates": [("cnt", "count", None), ("total", "sum", Col("counter"))],
           "input_dtype_of": lambda e: np.dtype(np.int64), "backend": "jax"}
    if slide:
        cfg["slide_micros"] = slide
    g.add_node(Node("agg", op, cfg, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    for a, b, t in [("src", "wm", "f"), ("wm", "key", "f"), ("key", "agg", "s"),
                    ("agg", "sink", "f")]:
        g.add_edge(a, b, EdgeType.FORWARD if t == "f" else EdgeType.SHUFFLE, DUMMY)
    return g


@pytest.mark.parametrize("op", ["tumbling", "sliding"])
def test_mesh_window_checkpoint_restore(op):
    """tests/test_mesh_operator.py:52 (tumbling) and :162 (sliding): the
    sharded snapshot -> table -> sharded restore, exact."""
    count, width, slide = 4000, 1_000_000, (250_000 if op == "sliding" else None)
    kind = OpName.SLIDING_AGGREGATE if op == "sliding" else OpName.TUMBLING_AGGREGATE
    rows2: list = []
    eng = Engine(_impulse_window(rows2, kind, count, width, slide), job_id=f"mesh-{op}",
                 device="cpu")
    gate = chip_smoke.gate_source(eng, 4)  # mid-stream: after 3 batches of 512
    eng.start()
    assert gate.reached.wait(60)
    assert eng.checkpoint_and_wait(1, timeout=60)
    eng.stop()
    eng.join(timeout=60)
    rows3: list = []
    Engine(_impulse_window(rows3, kind, count, width, slide, rate=0), job_id=f"mesh-{op}",
           device="cpu", restore_epoch=1).run_to_completion(timeout=120)
    merged = {}
    for r in rows2 + rows3:
        merged[(r["window_start"], r["k"])] = (r["cnt"], r["total"])
    want: dict = {}
    step = slide or width
    for c in range(count):
        ts = c * 1000
        for j in range(width // step):
            ws = (ts // step) * step - j * step
            n, t = want.get((ws, c % 5), (0, 0))
            want[(ws, c % 5)] = (n + 1, t + c)
    assert merged == want


def _configure(shards: int, fuse: bool) -> None:
    over = {**Q7_MESH, "device.mesh-devices": shards, "segment.compile.mesh-fuse": fuse}
    tcfg.update(over)
    jcfg.update({**over, "checkpoint.file-format": "npz"})


def _first_q7(pkg: str, url: str, shards: int, fuse: bool) -> list:
    _configure(shards, fuse)
    rows: list = []
    eng = _engine(pkg, build_q7(MODULES[pkg], rows, Q7_EVENTS), "q7m", url)
    gate = chip_smoke.gate_source(eng, Q7_POLLS)
    eng.start()
    assert gate.reached.wait(120)
    assert eng.checkpoint_and_wait(1, timeout=120, then_stop=True)
    eng.join(timeout=120)
    return rows


def _restore_q7(pkg: str, url: str, shards: int, fuse: bool) -> list:
    _configure(shards, fuse)
    rows: list = []
    _engine(pkg, build_q7(MODULES[pkg], rows, Q7_EVENTS), "q7m", url,
            restore_epoch=1).run_to_completion(timeout=300)
    return rows


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "host path"])
def test_q7_mesh_tables_and_restore_match_jax(fuse, tmp_path):
    _need_devices()
    urls = {pkg: str(tmp_path / pkg) for pkg in ("torch", "jax")}
    before = {pkg: _first_q7(pkg, urls[pkg], 8, fuse) for pkg in urls}
    t, j = decoded_tables(urls["torch"], "q7m"), decoded_tables(urls["jax"], "q7m")
    assert set(t) == set(j) and all(t[k] == j[k] for k in t)
    assert any(isinstance(v, list) and v for v in t.values())
    want = oracle_q7(Q7_EVENTS)
    for writer, reader in (("torch", "torch"), ("jax", "torch")):
        url = str(tmp_path / f"{writer}-{reader}")
        shutil.copytree(urls[writer], url)
        tseg.reset_mesh_dispatch_counts()
        tsharded.reset_dispatch_counts()
        after = _restore_q7(reader, url, 8, fuse)
        assert windows(before[writer] + after) == want
        # a restored fused run takes the fused step from its first batch on
        counts = tsharded.dispatch_counts()
        if fuse:
            assert counts["fused_steps"] > 0 and tseg.mesh_dispatch_counts()["host"] == 0
        else:
            assert counts["fused_steps"] == 0 and counts["host_steps"] > 0


@pytest.mark.parametrize("direction", ["torch->torch", "jax->torch", "torch->jax"])
def test_resize_from_4_to_8_shards(direction, tmp_path):
    """A checkpoint of q7's window at 4 shards restores at 8: the sharded
    snapshot is placement-free, and the restore re-places every partial
    through the 8-shard exchange."""
    _need_devices()
    writer, reader = direction.split("->")
    url = str(tmp_path / "ck")
    before = _first_q7(writer, url, 4, True)
    after = _restore_q7(reader, url, 8, True)
    assert windows(before + after) == oracle_q7(Q7_EVENTS)
