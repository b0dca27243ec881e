"""The port's cross-worker data plane held to the JAX package's: the wire
codec (bytes equal both ways, and each package decodes the other's), the
native framed TCP link (frames cross between the packages' listeners and
connections), ``parse_json_lines``, and a dataflow split over two engines
joined by the data plane (tests/test_native.py's two-worker case) giving
the JAX engines' sink rows."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import native as jnative
from arroyo_tpu.batch import Batch as JBatch
from arroyo_tpu.native import wire as jwire
from arroyo_tpu.types import CheckpointBarrier as JBarrier
from arroyo_tpu.types import Signal as JSignal
from arroyo_tpu.types import Watermark as JWatermark
from arroyo_tpu_torch import native as tnative
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD
from arroyo_tpu_torch.batch import Batch as TBatch
from arroyo_tpu_torch.native import wire as twire
from arroyo_tpu_torch.types import CheckpointBarrier as TBarrier
from arroyo_tpu_torch.types import Signal as TSignal
from arroyo_tpu_torch.types import Watermark as TWatermark


@pytest.fixture(autouse=True)
def port(tmp_path):
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "port-ckpt")})
    yield
    tcfg.reset()


def columns(kind: str, n: int = 10) -> dict:
    """test_native.py::test_wire_codec_dtypes's columns, one kind a case,
    and the string, bytes and null column of its data-plane round trip."""
    if kind == "strings":
        vals = [f"n{i}" if i % 7 else None for i in range(n)]
        vals[3] = b"raw\x00bytes"
        return {"name": np.array(vals, dtype=object)}
    dt = {"i32": np.int32, "u64": np.uint64, "f32": np.float32, "bools": np.bool_,
          TIMESTAMP_FIELD: np.int64, "f64": np.float64, "i64": np.int64}[kind]
    if dt is np.float32 or dt is np.float64:
        return {kind: np.linspace(0, 1, n, dtype=dt)}
    if dt is np.bool_:
        return {kind: np.array([True, False] * (n // 2))}
    return {kind: np.arange(n, dtype=dt)}


WIRE_KINDS = ["i32", "u64", "f32", "bools", TIMESTAMP_FIELD, "f64", "i64", "strings"]


def same_columns(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype == object:
            assert list(a[k]) == list(b[k]), k
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", WIRE_KINDS)
def test_wire_batch_bytes_equal_and_cross_decode(kind):
    cols = columns(kind)
    jb, tb = JBatch(dict(cols)), TBatch(dict(cols))
    tbytes = twire.encode_batch(tb)
    assert tbytes == jwire.encode_batch(jb)
    same_columns(jwire.decode_batch(tbytes).columns, cols)
    same_columns(twire.decode_batch(jwire.encode_batch(jb)).columns, cols)


def test_wire_mixed_batch_bytes_equal():
    cols = {}
    for kind in WIRE_KINDS:
        cols.update(columns(kind, 1000))
    assert twire.encode_batch(TBatch(dict(cols))) == jwire.encode_batch(JBatch(dict(cols)))


SIGNALS = {
    "watermark": lambda S, W, B: S.watermark_of(W.event_time(123456)),
    "idle": lambda S, W, B: S.watermark_of(W.idle()),
    "barrier": lambda S, W, B: S.barrier_of(B(5, 1, 99, True)),
    "end_of_data": lambda S, W, B: S.end_of_data(),
    "stop": lambda S, W, B: S.stop(),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_wire_signal_bytes_equal_and_cross_decode(name):
    tsig = SIGNALS[name](TSignal, TWatermark, TBarrier)
    jsig = SIGNALS[name](JSignal, JWatermark, JBarrier)
    tbytes = twire.encode_signal(tsig)
    assert tbytes == jwire.encode_signal(jsig)
    back = twire.decode_signal(jwire.encode_signal(jsig))
    assert back.kind.value == jsig.kind.value
    assert twire.encode_signal(back) == tbytes
    assert jwire.encode_signal(jwire.decode_signal(tbytes)) == tbytes


def frames_across(listener_mod, conn_mod, wire_mod, batch_cls, signal_cls, wm_cls, bar_cls):
    """Frames sent by one package's DataPlaneConn, received by the other's
    listener: (quad, type, payload) each."""
    listener = listener_mod.DataPlaneListener()
    received = []

    def server():
        conn = listener.accept()
        while True:
            got = conn.recv()
            if got is None:
                break
            received.append(got)
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    client = conn_mod.DataPlaneConn.connect("127.0.0.1", listener.port)
    batch = batch_cls({
        "x": np.arange(1000, dtype=np.int64),
        "name": np.array([f"n{i}" if i % 7 else None for i in range(1000)], dtype=object),
        TIMESTAMP_FIELD: np.arange(1000, dtype=np.int64) * 1000,
    })
    sent = [((1, 0, 2, 3), conn_mod.MSG_DATA, wire_mod.encode_batch(batch)),
            ((7, 1, 0, 1), conn_mod.MSG_SIGNAL,
             wire_mod.encode_signal(signal_cls.barrier_of(bar_cls(5, 1, 99, True)))),
            ((1, 0, 2, 3), conn_mod.MSG_SIGNAL,
             wire_mod.encode_signal(signal_cls.watermark_of(wm_cls.event_time(123456)))),
            ((0, 0, 0, 0), conn_mod.MSG_DATA, b"")]
    for quad, mtype, payload in sent:
        client.send(quad, mtype, payload)
    client.close()
    t.join(timeout=10)
    listener.close()
    return sent, received


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_data_plane_frames_cross_packages(direction):
    if direction == "jax_to_port":
        sent, got = frames_across(tnative, jnative, jwire, JBatch, JSignal, JWatermark, JBarrier)
    else:
        sent, got = frames_across(jnative, tnative, twire, TBatch, TSignal, TWatermark, TBarrier)
    assert [(tuple(q), m, p) for q, m, p in got] == sent
    assert (tnative.MSG_DATA, tnative.MSG_SIGNAL) == (jnative.MSG_DATA, jnative.MSG_SIGNAL)
    out = twire.decode_batch(got[0][2])
    assert out["name"][0] is None and out["name"][1] == "n1"
    assert twire.decode_signal(got[1][2]).barrier.epoch == 5


def test_data_plane_needs_the_native_library():
    tcfg.update({"native.enabled": False})
    with pytest.raises(tnative.DataPlaneError, match="native.enabled is off"):
        tnative.DataPlaneListener()
    with pytest.raises(tnative.DataPlaneError, match="native.enabled is off"):
        tnative.DataPlaneConn.connect("127.0.0.1", 1)


def json_cases() -> dict:
    rows = [{"a": i, "b": i * 0.5, "ok": i % 3 == 0,
             "s": f"val_{i}" if i % 10 else None, "extra": {"nested": [1, 2, {"x": "y"}]}}
            for i in range(500)]
    return {
        "matches_python": ("\n".join(json.dumps(r) for r in rows).encode(),
                           [("a", "int64"), ("b", "float64"), ("ok", "bool"), ("s", "string")],
                           1000),
        "escapes_and_unicode": (json.dumps({"s": 'he said "hi"\n\tümlaut ☃', "a": -42}).encode(),
                                [("s", "string"), ("a", "int64")], 10),
        "malformed": (b"not json", [("a", "int64")], 10),
        "narrow_types": (b'{"i": 7, "f": 1.5, "t": 99}\n{"i": -3, "f": -0.25, "t": 100}',
                         [("i", "int32"), ("f", "float32"), ("t", "timestamp")], 4),
        "max_rows": ("\n".join(json.dumps({"a": i}) for i in range(20)).encode(),
                     [("a", "int64")], 8),
    }


@pytest.mark.parametrize("case", sorted(json_cases()))
def test_parse_json_lines_equals_jax(case):
    data, fields, max_rows = json_cases()[case]
    want = jnative.parse_json_lines(data, fields, max_rows)
    got = tnative.parse_json_lines(data, fields, max_rows)
    if want is None:
        assert got is None
        return
    same_columns(got, want)


def test_two_worker_engine_over_data_plane_matches_jax(tmp_path):
    """tests/test_native.py's split dataflow: worker 0 runs the source,
    worker 1 the keyed aggregate and the sink; the shuffle, barriers and
    watermarks cross the wire. The port's two engines give the JAX
    engines' rows."""
    import arroyo_tpu
    import arroyo_tpu.engine.engine as jeng
    import arroyo_tpu.engine.network as jnet
    import arroyo_tpu.expr as jexpr
    import arroyo_tpu.graph as jgraph
    import arroyo_tpu_torch.engine.engine as teng
    import arroyo_tpu_torch.engine.network as tnet
    import arroyo_tpu_torch.expr as texpr
    import arroyo_tpu_torch.graph as tgraph
    from arroyo_tpu_torch.batch import Schema

    arroyo_tpu._load_operators()

    def build(G, E, rows):
        S = Schema.of([("x", "int64"), (TIMESTAMP_FIELD, "int64")])
        g = G.Graph()
        g.add_node(G.Node("src", G.OpName.SOURCE, {
            "connector": "impulse", "message_count": 300,
            "interval_micros": 100_000, "start_time_micros": 0}, 1))
        g.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": E.Col(TIMESTAMP_FIELD)}, 1))
        g.add_node(G.Node("key", G.OpName.KEY, {
            "keys": [("g", E.BinOp("%", E.Col("counter"), E.Lit(3)))]}, 1))
        g.add_node(G.Node("agg", G.OpName.TUMBLING_AGGREGATE, {
            "width_micros": 10_000_000, "key_fields": ["g"],
            "aggregates": [("n", "count", None)], "backend": "numpy"}, 2))
        g.add_node(G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": rows}, 1))
        g.add_edge("src", "wm", G.EdgeType.FORWARD, S)
        g.add_edge("wm", "key", G.EdgeType.FORWARD, S)
        g.add_edge("key", "agg", G.EdgeType.SHUFFLE, S)
        g.add_edge("agg", "sink", G.EdgeType.FORWARD, S)
        return g

    assignment = {("src", 0): 0, ("wm", 0): 0, ("key", 0): 0,
                  ("agg", 0): 1, ("agg", 1): 1, ("sink", 0): 1}

    def run(G, E, Eng, Net, **kw):
        rows: list = []
        nms = [Net.NetworkManager(), Net.NetworkManager()]
        peers = {i: ("127.0.0.1", m.port) for i, m in enumerate(nms)}
        for m in nms:
            m.set_peers(peers)
        engs = [Eng.Engine(build(G, E, rows), job_id="dist", assignment=assignment,
                           worker_index=i, network=nms[i], **kw) for i in range(2)]
        engs[1].build()
        engs[0].build()
        engs[1].start()
        engs[0].start()
        for e in engs:
            e.join(timeout=120)
        for m in nms:
            m.close()
        return rows, engs

    want, _ = run(jgraph, jexpr, jeng, jnet)
    got, engs = run(tgraph, texpr, teng, tnet, device="cpu")
    key = lambda r: json.dumps({k: int(v) for k, v in r.items()}, sort_keys=True)
    assert sorted(map(key, got)) == sorted(map(key, want))
    assert sum(r["n"] for r in got) == 300
    assert {k for e in engs for k in e.tasks} == set(assignment)
    assert set(engs[0].tasks) == {k for k, w in assignment.items() if w == 0}


def test_assignment_naming_an_unknown_node_is_refused():
    from arroyo_tpu_torch.engine.engine import Engine
    from arroyo_tpu_torch.graph import Graph, Node, OpName

    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "impulse", "message_count": 1}, 1))
    with pytest.raises(ValueError, match="not in the"):
        Engine(g, device="cpu", assignment={("nope", 0): 0})


# ------------------------------------------------ mirrored scenarios

from test_torch_controller import port as port_env, port_mirror, run_mirrored  # noqa: E402,F401

COALESCE = port_mirror("test_coalesce")
SMOKE_CHAOS = port_mirror("test_smoke")


def test_network_frame_coalescing_preserves_order_through_the_port(tmp_path, port_env):
    """tests/test_coalesce.py's case: many small frames and a signal over
    the port's coalescing send buffer arrive whole and in order."""
    run_mirrored(COALESCE, "test_network_frame_coalescing_preserves_order", _storage=port_env)


@pytest.mark.parametrize("name", SMOKE_CHAOS.CHAOS_FAMILIES)
def test_chaos_dataplane_partition_mid_stream_through_the_port(name, tmp_path, port_env):
    """tests/test_smoke.py's chaos case through the port: two engines joined
    by the data plane under EngineSetCoordinator, the data plane cut at
    epoch 2's barrier; a two-worker restore from epoch 1 reproduces the
    goldens, and no commit preceded its epoch's durable marker."""
    run_mirrored(SMOKE_CHAOS, "test_chaos_dataplane_partition_mid_stream",
                 name=name, tmp_path=tmp_path, _storage=port_env)
