"""The port's filesystem connector (connectors/filesystem.py) over
tests/test_connectors.py's filesystem cases (json, parquet and avro round
trips, partitioned parts that appear only at commit, exactly once across a
restore, the commit of a checkpoint-stop) and tests/test_broker_connectors.py's
Delta table, each run through the port with the JAX test's assertions; then
files that cross the packages: what one package's sink commits, the other's
source reads, and a crash between checkpoint and commit re-commits on
restore with no row twice. stdout and blackhole ride along."""

from __future__ import annotations

import json
import os
import time

import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

CONNECTORS = port_mirror("test_connectors")
BROKERS = port_mirror("test_broker_connectors")
FS_CASES = sorted(n for n in dir(CONNECTORS) if n.startswith("test_filesystem"))


def test_every_filesystem_case_is_mirrored():
    assert FS_CASES == ["test_filesystem_commit_on_checkpoint_stop",
                        "test_filesystem_exactly_once_across_restore",
                        "test_filesystem_roundtrip",
                        "test_filesystem_sink_partitioning_and_commit"]


@pytest.mark.parametrize("name,fmt", [(n, f) for n in FS_CASES for f in (
    ("json", "parquet", "avro") if n == "test_filesystem_roundtrip" else (None,))])
def test_filesystem_case_through_the_port(name, fmt, tmp_path, port):
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    run_mirrored(CONNECTORS, name, tmp_path=tmp_path, _storage=port, fmt=fmt)


def test_delta_sink_writes_table(tmp_path, port):
    pytest.importorskip("pyarrow")
    run_mirrored(BROKERS, "test_delta_sink_writes_table", tmp_path=tmp_path, _storage=port)


def _pkg(name):
    """One package's modules by role (its SQL planner and config too); ``kw``
    runs its engine on the CPU."""
    if name == "jax":
        import arroyo_tpu
        from arroyo_tpu import config as cfg
        from arroyo_tpu.batch import TIMESTAMP_FIELD, Schema
        from arroyo_tpu.engine.engine import Engine, run_graph
        from arroyo_tpu.expr import BinOp, Col, Lit
        from arroyo_tpu.graph import EdgeType, Graph, Node, OpName
        from arroyo_tpu.sql import plan_query

        arroyo_tpu._load_operators()
        return dict(TS=TIMESTAMP_FIELD, Schema=Schema, Engine=Engine, run=run_graph,
                    BinOp=BinOp, Col=Col, Lit=Lit, EdgeType=EdgeType, Graph=Graph,
                    Node=Node, OpName=OpName, plan=plan_query, cfg=cfg, kw={})
    import arroyo_tpu_torch
    from arroyo_tpu_torch import config as cfg
    from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
    from arroyo_tpu_torch.engine.engine import Engine, run_graph
    from arroyo_tpu_torch.expr import BinOp, Col, Lit
    from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName
    from arroyo_tpu_torch.sql import plan_query

    arroyo_tpu_torch._load_operators()
    return dict(TS=TIMESTAMP_FIELD, Schema=Schema, Engine=Engine, run=run_graph, BinOp=BinOp,
                Col=Col, Lit=Lit, EdgeType=EdgeType, Graph=Graph, Node=Node, OpName=OpName,
                plan=plan_query, cfg=cfg, kw={"device": "cpu"})


def _write_input(path, n):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"x": i, "name": f"n{i}", "_timestamp": 1000 + i}) + "\n")


def _copy_graph(P, src_cfg, out_dir, fmt, partition=True):
    S = P["Schema"].of([("x", "int64"), ("name", "string"), (P["TS"], "int64")])
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {**src_cfg, "schema": S}, 1))
    g.add_node(P["Node"]("proj", P["OpName"].VALUE, {"projections": [
        ("x", P["Col"]("x")), ("name", P["Col"]("name")),
        ("x_mod", P["BinOp"]("%", P["Col"]("x"), P["Lit"](3)))]}, 1))
    g.add_node(P["Node"]("sink", P["OpName"].SINK, {
        "connector": "filesystem", "path": out_dir, "format": fmt, "schema": S,
        "partition_fields": ["x_mod"] if partition else []}, 1))
    g.add_edge("src", "proj", P["EdgeType"].FORWARD, S)
    g.add_edge("proj", "sink", P["EdgeType"].FORWARD, S)
    return g


def _committed(out_dir):
    files = sorted(os.path.relpath(os.path.join(r, f), out_dir)
                   for r, _d, fs in os.walk(out_dir) for f in fs)
    return files


def _read_back(P, path, fmt):
    S = P["Schema"].of([("x", "int64"), ("name", "string"), (P["TS"], "int64")])
    rows: list = []
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
        "connector": "filesystem", "path": path, "format": fmt, "schema": S}, 1))
    g.add_node(P["Node"]("sink", P["OpName"].SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "sink", P["EdgeType"].FORWARD, S)
    P["run"](g, job_id="read-back", timeout=60, **P["kw"])
    return sorted((r["x"], r["name"]) for r in rows)


@pytest.mark.parametrize("fmt", ["json", "avro", "parquet"])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_committed_files_cross_the_packages(writer, reader, fmt, tmp_path, port):
    """What one package's partitioned sink commits is the same set of files
    with the same bytes as the other's (json and avro), and the other
    package's source reads it back whole."""
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    inp = tmp_path / "in.json"
    _write_input(inp, 90)
    outs = {}
    for pkg in ("jax", "torch"):
        P = _pkg(pkg)
        out = str(tmp_path / f"out-{pkg}")
        P["run"](_copy_graph(P, {"connector": "filesystem", "path": str(inp), "format": "json"},
                             out, fmt), job_id=f"fs-{pkg}", timeout=60, **P["kw"])
        outs[pkg] = out
    assert _committed(outs["jax"]) == _committed(outs["torch"])
    if fmt != "parquet":
        for rel in _committed(outs["jax"]):
            with open(os.path.join(outs["jax"], rel), "rb") as a, \
                    open(os.path.join(outs["torch"], rel), "rb") as b:
                assert a.read() == b.read(), rel
    want = sorted((i, f"n{i}") for i in range(90))
    assert _read_back(_pkg(reader), outs[writer], fmt) == want


def test_crash_between_checkpoint_and_commit_recommits_on_restore(tmp_path, port):
    """A sink whose epoch was checkpointed but never committed (the job died
    between the two phases) writes that epoch's parts when it restores, and
    the finished output holds every row once."""
    from arroyo_tpu_torch.connectors.filesystem import FileSystemSink

    tcfg.update({"testing.source-read-delay-micros": 2000})
    inp = tmp_path / "in.json"
    _write_input(inp, 120)
    out = str(tmp_path / "eo")
    P = _pkg("torch")
    skipped = []
    orig = FileSystemSink.handle_commit

    def no_commit(self, epoch, ctx):  # the process dies before phase 2
        skipped.append(epoch)

    FileSystemSink.handle_commit = no_commit
    try:
        eng = P["Engine"](_copy_graph(P, {"connector": "filesystem", "path": str(inp),
                                          "format": "json"}, out, "json", partition=False),
                          job_id="fs-crash", device="cpu")
        eng.start()
        time.sleep(0.1)
        assert eng.checkpoint_and_wait(1, timeout=60)
        eng.stop()
        eng.join(timeout=60)
    finally:
        FileSystemSink.handle_commit = orig
    assert skipped == [1] and _committed(out) == []
    tcfg.update({"testing.source-read-delay-micros": 0})
    eng = P["Engine"](_copy_graph(P, {"connector": "filesystem", "path": str(inp),
                                      "format": "json"}, out, "json", partition=False),
                      job_id="fs-crash", device="cpu", restore_epoch=1)
    eng.run_to_completion()
    files = _committed(out)
    assert files[0] == "part-000-0000001.json"
    xs = [json.loads(line)["x"] for f in files for line in open(os.path.join(out, f))]
    assert sorted(xs) == list(range(120))


def test_stdout_and_blackhole_sinks(tmp_path, port, capsys):
    P = _pkg("torch")
    from arroyo_tpu_torch.connectors.blackhole import BlackholeSink

    S = P["Schema"].of([("x", "int64"), (P["TS"], "int64")])
    for sink in ("stdout", "blackhole"):
        g = P["Graph"]()
        g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
            "connector": "impulse", "message_count": 5, "interval_micros": 1000,
            "start_time_micros": 0}, 1))
        g.add_node(P["Node"]("val", P["OpName"].VALUE, {
            "projections": [("x", P["Col"]("counter"))]}, 1))
        g.add_node(P["Node"]("snk", P["OpName"].SINK, {"connector": sink}, 1))
        g.add_edge("src", "val", P["EdgeType"].FORWARD, S)
        g.add_edge("val", "snk", P["EdgeType"].FORWARD, S)
        eng = P["Engine"](g, job_id=f"s-{sink}", device="cpu")
        eng.run_to_completion()
        if sink == "blackhole":
            op = eng.tasks[("snk", 0)].operator
            assert isinstance(op, BlackholeSink) and op.rows_seen == 5
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["x"] for r in lines] == list(range(5))
