"""The port's network connectors (connectors/http_conn.py, websocket.py,
broker_base.py, nats.py, mqtt.py, rabbitmq.py, kinesis.py, redis.py and
kafka.py) over the JAX package's own tests of them, each run through the port
with the JAX test's assertions unchanged: tests/test_connectors.py's HTTP,
WebSocket, Redis, preview, registry and Kafka cases, every case of
tests/test_broker_connectors.py but the Delta table (tests/
test_torch_filesystem.py has it) and tests/test_faults.py's connector cases.
The fake brokers of those files speak only the protocol, so they serve either
package.

Then the port held against the JAX package across the wire: what one
package's NATS or Kinesis sink publishes, the other's source reads as the
same rows; what the port's Redis sink writes, the JAX package's RedisLookup
reads back; a q7-shaped SQL job over one NATS broker gives the same lines in
the same order through both packages; and Kafka, whose client package is not
installed, fails in both packages with the same ImportError."""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from test_broker_connectors import MiniKinesis, MiniNats
from test_connectors import _FakeRedis
from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401
from test_torch_filesystem import _pkg

CONNECTORS = port_mirror("test_connectors")
BROKERS = port_mirror("test_broker_connectors")
FAULTS = port_mirror("test_faults")

NET_CASES = ["test_connector_registry_lists_all", "test_gated_connector_raises_helpfully",
             "test_kafka_auth_options_pass_through", "test_kafka_offset_tracker_rescale",
             "test_polling_http_source", "test_preview_rows_via_rest",
             "test_redis_sink_and_lookup", "test_sse_source", "test_webhook_sink",
             "test_websocket_source"]
BROKER_CASES = ["test_kinesis_sink_and_source_roundtrip", "test_mqtt_sink_publishes_qos1",
                "test_mqtt_source_roundtrip", "test_nats_sink_publishes",
                "test_nats_source_roundtrip", "test_rabbitmq_sink_publishes",
                "test_rabbitmq_source_roundtrip"]
FAULT_CASES = ["test_kinesis_reshard_pickup_under_poll_faults",
               "test_kinesis_stable_assignment_is_disjoint_and_total",
               "test_rabbitmq_no_acks_when_crash_precedes_commit"]


def _cases(mod) -> list:
    return sorted(n for n in dir(mod) if n.startswith("test_") and callable(getattr(mod, n)))


def test_every_connector_case_is_mirrored():
    """tests/test_connectors.py: its filesystem cases run in
    test_torch_filesystem.py, every other case here."""
    fs = [n for n in _cases(CONNECTORS) if n.startswith("test_filesystem")]
    assert sorted(set(_cases(CONNECTORS)) - set(fs)) == NET_CASES


def test_every_broker_case_is_mirrored():
    assert sorted(set(_cases(BROKERS)) - {"test_delta_sink_writes_table"}) == BROKER_CASES


def test_every_connector_fault_case_is_mirrored():
    assert sorted(n for n in _cases(FAULTS) if "kinesis" in n or "rabbitmq" in n) == FAULT_CASES


@pytest.mark.parametrize("name", NET_CASES)
def test_connector_case_through_the_port(name, tmp_path, port):
    run_mirrored(CONNECTORS, name, tmp_path=tmp_path, _storage=port)


@pytest.mark.parametrize("name", BROKER_CASES)
def test_broker_case_through_the_port(name, tmp_path, port):
    run_mirrored(BROKERS, name, tmp_path=tmp_path, _storage=port)


@pytest.mark.parametrize("name", FAULT_CASES)
def test_connector_fault_case_through_the_port(name, tmp_path, port):
    run_mirrored(FAULTS, name, tmp_path=tmp_path, _storage=port)


# ----------------------------------------------- across the wire, both packages


PKGS = ("jax", "torch")
PAIRS = [("jax", "torch"), ("torch", "jax")]


def _impulse_sink(P, connector: str, conn_cfg: dict, job: str, count: int = 40) -> None:
    """tests/test_broker_connectors.py's _sink_graph in package P: ``count``
    impulse rows, their counter and event time, into ``connector``."""
    S = P["Schema"].of([("x", "int64"), (P["TS"], "int64")])
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
        "connector": "impulse", "message_count": count,
        "interval_micros": 1000, "start_time_micros": 0}, 1))
    g.add_node(P["Node"]("snk", P["OpName"].SINK, {
        "connector": connector, "format": "json",
        "schema": P["Schema"].of([("counter", "int64"), (P["TS"], "timestamp")]),
        **conn_cfg}, 1))
    g.add_edge("src", "snk", P["EdgeType"].FORWARD, S)
    P["run"](g, job_id=job, timeout=60, **P["kw"])


def _source_engine(P, src_cfg: dict, rows: list, job: str):
    """A started engine of package P reading ``src_cfg`` (the counter) into
    ``rows``."""
    S = P["Schema"].of([("counter", "int64"), (P["TS"], "int64")])
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
        **src_cfg, "format": "json", "schema": P["Schema"].of([("counter", "int64")])}, 1))
    g.add_node(P["Node"]("snk", P["OpName"].SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "snk", P["EdgeType"].FORWARD, S)
    eng = P["Engine"](g, job_id=job, **P["kw"])
    eng.start()
    return eng


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _stop(eng) -> None:
    eng.stop()
    eng.join(timeout=30)


def test_nats_sinks_publish_the_same_bytes(port):
    """Each package's NATS sink publishes the same 40 messages, byte for
    byte, in the same order."""
    broker = MiniNats()
    broker.start()
    try:
        for name in PKGS:
            _impulse_sink(_pkg(name), "nats", {"servers": f"nats://127.0.0.1:{broker.port}",
                                               "subject": name}, f"nats-sink-{name}")
        _wait(lambda: len(broker.published) == 80, 10, "80 messages")
        by = {name: [p for s, p in broker.published if s == name] for name in PKGS}
        assert by["torch"] == by["jax"]
        assert [json.loads(p)["counter"] for p in by["jax"]] == list(range(40))
    finally:
        broker.close()


@pytest.mark.parametrize("sink,src", PAIRS)
def test_nats_rows_cross_the_packages(sink, src, port):
    """What one package's NATS sink publishes, the other's NATS source reads
    as the same rows."""
    broker = MiniNats()
    broker.start()
    rows: list = []
    eng = None
    try:
        _impulse_sink(_pkg(sink), "nats", {"servers": f"nats://127.0.0.1:{broker.port}",
                                           "subject": "out"}, f"nats-x-{sink}")
        _wait(lambda: len(broker.published) == 40, 10, "the sink's 40 messages")
        eng = _source_engine(_pkg(src), {"connector": "nats", "subject": "in",
                                         "servers": f"nats://127.0.0.1:{broker.port}"},
                             rows, f"nats-x-{src}")
        _wait(lambda: broker.subs, 20, "the source's SUB")
        for _s, payload in list(broker.published):
            broker.publish("in", payload)
        _wait(lambda: len(rows) >= 40, 30, "40 rows")
        assert [r["counter"] for r in rows] == list(range(40))
    finally:
        if eng is not None:
            _stop(eng)
        broker.close()


@pytest.mark.parametrize("sink,src", PAIRS)
def test_kinesis_records_cross_the_packages(sink, src, port):
    """What one package's Kinesis sink puts (SigV4-signed, over the shards),
    the other's Kinesis source reads from TRIM_HORIZON as the same rows."""
    srv = MiniKinesis()
    srv.start()
    rows: list = []
    eng = None
    conn = {"stream_name": "s1", "endpoint": f"http://127.0.0.1:{srv.port}",
            "aws_access_key_id": "AK", "aws_secret_access_key": "SK"}
    try:
        _impulse_sink(_pkg(sink), "kinesis", conn, f"kin-x-{sink}")
        assert srv.bad_auth == 0 and len(srv.all_payloads()) == 40
        eng = _source_engine(_pkg(src), {"connector": "kinesis", "poll_interval_s": 0.05,
                                         **conn}, rows, f"kin-x-{src}")
        _wait(lambda: len(rows) >= 40, 30, "40 rows")
        assert sorted(r["counter"] for r in rows) == list(range(40))
    finally:
        if eng is not None:
            _stop(eng)
        srv.close()


def test_kinesis_signature_is_the_jax_packages():
    """SigV4: the port's KinesisClient signs every request as the JAX
    package's does, byte for byte."""
    from arroyo_tpu.connectors.kinesis import KinesisClient as JClient
    from arroyo_tpu_torch.connectors.kinesis import KinesisClient as TClient

    rng = np.random.default_rng(21)
    for region, endpoint in (("us-east-1", None), ("eu-west-2", "http://127.0.0.1:4566"),
                             ("ap-south-1", "https://kinesis.example:8443/base")):
        kw = dict(region=region, endpoint=endpoint, access_key="AKIDEXAMPLE",
                  secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
        j, t = JClient(**kw), TClient(**kw)
        assert (t.endpoint, t.host) == (j.endpoint, j.host)
        for _ in range(5):
            body = rng.bytes(int(rng.integers(0, 300)))
            target = f"Kinesis_20131202.{rng.choice(['PutRecords', 'GetRecords', 'ListShards'])}"
            amz = f"2026{int(rng.integers(1, 13)):02d}{int(rng.integers(1, 29)):02d}T120000Z"
            assert t._sign(body, target, amz) == j._sign(body, target, amz)


def test_port_redis_sink_is_read_by_the_jax_lookup(tmp_path, port):
    """The port's Redis sink SETs rows; the JAX package's RedisLookup reads
    them back; and the port's lookup reads the same."""
    from arroyo_tpu.connectors.redis import RedisLookup as JLookup
    from arroyo_tpu_torch.connectors.redis import RedisLookup as TLookup

    fake = _FakeRedis()
    try:
        src = tmp_path / "in.json"
        with open(src, "w") as f:
            for i in range(6):
                f.write(json.dumps({"x": i, "name": f"n{i}", "_timestamp": 1000 + i}) + "\n")
        P = _pkg("torch")
        S = P["Schema"].of([("x", "int64"), ("name", "string"), (P["TS"], "int64")])
        g = P["Graph"]()
        g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
            "connector": "single_file", "path": str(src), "schema": S}, 1))
        g.add_node(P["Node"]("sink", P["OpName"].SINK, {
            "connector": "redis", "host": "127.0.0.1", "port": fake.port, "target": "string",
            "key_prefix": "row:", "key_field": "x", "schema": S}, 1))
        g.add_edge("src", "sink", P["EdgeType"].FORWARD, S)
        P["run"](g, job_id="redis-x", timeout=60, **P["kw"])
        cfg = {"host": "127.0.0.1", "port": fake.port, "key_prefix": "row:"}
        got = JLookup(cfg).lookup([0, 3, 5, 77])
        assert {k: (v and v["name"]) for k, v in got.items()} == {
            0: "n0", 3: "n3", 5: "n5", 77: None}
        assert TLookup(cfg).lookup([0, 3, 5, 77]) == got
    finally:
        fake.server.close()


Q7_NATS_EVENTS = 20_000
SQL_Q7_NATS_FILE = chip_smoke.SQL_Q7_NATS.split("CREATE TABLE q7n_out")[0] + """
CREATE TABLE q7n_out (start TIMESTAMP, auction BIGINT, max_price BIGINT, bids BIGINT)
WITH (connector = 'single_file', path = '{out}', format = 'json', type = 'sink');
INSERT INTO q7n_out
SELECT window.start AS start, auction, max_price, bids FROM (
  SELECT tumble(interval '10 seconds') AS window, auction, max(price) AS max_price,
    count(*) AS bids
  FROM bids GROUP BY window, auction) x;
"""


def _nats_q7_lines(name: str, broker: MiniNats, payloads: list, out: str) -> list:
    """SQL q7 over ``broker`` in package ``name``: the bids published once
    its SUB is in, then its connection closed (the source ends gracefully);
    the sink's lines."""
    P = _pkg(name)
    g = P["plan"](SQL_Q7_NATS_FILE.format(port=broker.port, subject=f"bids-{name}",
                                          out=out)).graph
    eng = P["Engine"](g, job_id=f"q7-nats-{name}", **P["kw"])
    eng.start()
    try:
        _wait(lambda: any(s == f"bids-{name}" for _c, s, _i in broker.subs), 20, "the SUB")
        for p in payloads:
            broker.publish(f"bids-{name}", p)
        for c, s, _i in list(broker.subs):
            if s == f"bids-{name}":
                c.shutdown(socket.SHUT_WR)
        eng.join(timeout=120)
    finally:
        eng.stop()
        eng.join(timeout=30)
    with open(out) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("store", ["host", "device"])
def test_q7_over_nats_same_lines_in_both_packages(store, tmp_path, port, monkeypatch):
    """The slice as a whole: q7 (tumbling 10 s MAX and COUNT per auction)
    planned from SQL over 20,000 Nexmark events' bids, one JSON message each
    through one NATS broker, chaining on, coalescing off, in each package;
    the rows equal chip_smoke's oracle. A window store's order follows the
    source's batches (first-seen keys a batch), so both sources cut batches
    by size alone (4,096 rows; the linger that would cut them by the clock is
    made longer than the test). With the windows' host store in both
    packages (``device.enabled`` off: a dict's insertion order) the lines are
    then the same in the same order. With the device store the JAX package's
    order within a window follows its table's probes, so the lines are
    compared sorted."""
    from arroyo_tpu_torch.formats import registry

    cols = chip_smoke.bids_columns(Q7_NATS_EVENTS)
    payloads = [json.dumps({"auction": a, "price": p, "ts": t}).encode() for a, p, t in zip(
        cols["auction"].tolist(), cols["price"].tolist(), cols["ts"].tolist())]
    over = {"pipeline.chaining.enabled": True, "engine.coalesce.enabled": False,
            "device.enabled": store == "device", "pipeline.source-batch-size": 4096}
    tcfg.update({**over, "segment.compile.min-rows": 0})
    monkeypatch.setattr(registry, "LINGER_MICROS", 600_000_000)
    _pkg("jax")["cfg"].update({**over, "pipeline.source-batch-linger-ms": 600_000})
    broker = MiniNats()
    broker.start()
    try:
        lines = {name: _nats_q7_lines(name, broker, payloads, str(tmp_path / f"{name}.json"))
                 for name in PKGS}
    finally:
        broker.close()
    if store == "host":
        assert lines["torch"] == lines["jax"]
    else:
        assert sorted(lines["torch"]) == sorted(lines["jax"])
    assert chip_smoke.check_sql_rows("q7", lines["torch"],
                                     chip_smoke.oracle_q7(Q7_NATS_EVENTS)) == len(lines["jax"])


def test_chip_smoke_connectors_run_on_the_cpu(port):
    """chip_smoke's connectors phase at a small size on the CPU: its own NATS
    server (SUB first, chunked writes, closed after the last message) and
    webhook receiver, SQL q7 through the port: every message delivered,
    exactly oracle_q7's rows posted, the chain compiled, no fallback."""
    from arroyo_tpu_torch.obs.events import recorder

    events = 20_000
    r = chip_smoke.nats_q7_run(events, "chip-connectors-cpu", device="cpu")
    assert r["delivered"] == r["messages"] == len(chip_smoke.bids_columns(events)["auction"])
    assert chip_smoke.check_sql_rows("q7", r["lines"], chip_smoke.oracle_q7(events)) > 0
    assert r["eng"].device.type == "cpu"
    assert not recorder.events("chip-connectors-cpu", "SEGMENT_FALLBACK")


def test_chip_nats_refuses_a_stranger_and_counts_nothing_before_the_sub():
    """ChipNats writes nothing before a SUB on its subject and fails (kept in
    ``error``) on one for another subject or sid."""
    chunks = chip_smoke.nats_bid_chunks(chip_smoke.bids_columns(1_000), "bids", "1")
    srv = chip_smoke.ChipNats("bids", chunks)
    srv.start()
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        assert s.recv(4096).startswith(b"INFO ")
        s.sendall(b"CONNECT {}\r\nPING\r\n")
        assert s.recv(4096) == b"PONG\r\n"
        assert srv.delivered == 0
        s.sendall(b"SUB other 1\r\n")
        srv.join(timeout=10)
        assert srv.delivered == 0 and "SUB" in srv.error
    finally:
        s.close()
        srv.close()


def test_kafka_raises_naming_confluent_kafka(port):
    """confluent_kafka is not installed: in both packages alike, the Kafka
    source (where it runs) and sink (where it starts) raise ImportError
    naming it, and a SQL job over connector = 'kafka' fails with the same
    error."""
    with pytest.raises(ImportError):
        import confluent_kafka  # noqa: F401
    failed = {}
    for pkg in PKGS:
        P = _pkg(pkg)
        mod = __import__(f"{'arroyo_tpu' if pkg == 'jax' else 'arroyo_tpu_torch'}.connectors.kafka",
                         fromlist=["KafkaSource"])
        with pytest.raises(ImportError, match="confluent_kafka"):
            mod.KafkaSource({"topic": "t", "schema": None}).run(None, None)
        with pytest.raises(ImportError, match="confluent_kafka"):
            mod.KafkaSink({"topic": "t"}).on_start(None)
        g = P["plan"]("""
        CREATE TABLE k (x BIGINT) WITH (connector = 'kafka', topic = 't',
          bootstrap_servers = 'localhost:9092', format = 'json', type = 'source');
        SELECT x FROM k;""").graph
        with pytest.raises(Exception, match="confluent_kafka") as ei:
            P["run"](g, job_id=f"kafka-{pkg}", timeout=60, **P["kw"])
        failed[pkg] = type(ei.value).__name__
    assert failed["torch"] == failed["jax"]


# ------------------------------------- the RabbitMQ source's commit, delivered


def test_rabbitmq_acks_on_commit_with_chaining_on(port):
    """With chaining on (the source its own task, its successors one
    chain), the engine's commit reaches the committing source: no ack
    before the checkpoint, every tag acked after it."""
    from test_broker_connectors import MiniRabbit

    tcfg.update({"pipeline.chaining.enabled": True})
    P = _pkg("torch")
    BinOp, Col, Lit = P["BinOp"], P["Col"], P["Lit"]
    broker = MiniRabbit()
    broker.start()
    rows: list = []
    S = P["Schema"].of([("v", "int64"), (P["TS"], "int64")])
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
        "connector": "rabbitmq", "host": "127.0.0.1", "port": broker.port, "queue": "in",
        "format": "json", "schema": P["Schema"].of([("v", "int64")])}, 1))
    g.add_node(P["Node"]("dbl", P["OpName"].VALUE, {
        "projections": [("v", BinOp("*", Col("v"), Lit(2)))]}, 1))
    g.add_node(P["Node"]("snk", P["OpName"].SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "dbl", P["EdgeType"].FORWARD, S)
    g.add_edge("dbl", "snk", P["EdgeType"].FORWARD, S)
    eng = P["Engine"](g, job_id="rmq-chained", **P["kw"])
    eng.start()
    try:
        assert list(eng.graph.nodes) == ["src", "dbl+snk"]
        _wait(lambda: broker.consumers, 20, "the source's consume")
        for i in range(12):
            broker.publish("in", json.dumps({"v": i}).encode())
        _wait(lambda: len(rows) >= 12, 30, "12 rows")
        assert sorted(r["v"] for r in rows) == [2 * i for i in range(12)]
        assert broker.acked == []
        assert eng.checkpoint_and_wait(1, timeout=30)
        _wait(lambda: len(broker.acked) >= 12, 10, "12 acks")
        assert sorted(broker.acked) == list(range(1, 13))
    finally:
        _stop(eng)
        broker.close()


def test_rabbitmq_acks_on_the_controllers_commit(tmp_path, port):
    """A SQL job over RabbitMQ under the port's controller with two embedded
    workers: the commit comes through the coordinated path
    (Engine.deliver_commit) once an epoch is durable on both workers, and
    the source acks every tag; a stop with a checkpoint then finishes."""
    from test_broker_connectors import MiniRabbit

    from arroyo_tpu_torch.controller import ControllerServer, Database
    from arroyo_tpu_torch.controller.scheduler import EmbeddedScheduler

    out = tmp_path / "out.json"
    broker = MiniRabbit()
    broker.start()
    tcfg.update({"pipeline.chaining.enabled": True, "checkpoint.interval-ms": 200,
                 "controller.workers-per-job": 2})
    db = Database()
    ctl = ControllerServer(db, EmbeddedScheduler()).start()
    try:
        pid = db.create_pipeline("rmq", f"""
        CREATE TABLE q (v BIGINT) WITH (connector = 'rabbitmq', host = '127.0.0.1',
          port = {broker.port}, queue = 'in', format = 'json', type = 'source');
        CREATE TABLE o (v BIGINT) WITH (connector = 'single_file', path = '{out}',
          format = 'json', type = 'sink');
        INSERT INTO o SELECT v + 1 AS v FROM q;""", 2)
        jid = db.create_job(pid)
        ctl.wait_for_state(jid, "Running", timeout=60)
        _wait(lambda: len(broker.consumers) == 2, 30, "both subtasks' consumes")
        for i in range(12):
            broker.publish("in", json.dumps({"v": i}).encode())
        _wait(lambda: len(broker.acked) >= 12, 30, "12 acks")
        assert sorted(broker.acked) == list(range(1, 13))
        assert any(c["state"] == "complete" for c in db.list_checkpoints(jid))
        db.update_job(jid, desired_stop="checkpoint")
        assert ctl.wait_for_state(jid, "Stopped", timeout=60) == "Stopped"
    finally:
        ctl.stop()
        broker.close()


@pytest.mark.parametrize("broker", ["refused", "silent_close"])
def test_nats_source_without_a_broker_fails_the_job(broker, port):
    """No fallback: a NATS source whose connection is refused, or whose
    broker closes before its INFO, fails the job (no empty output)."""
    srv = socket.create_server(("127.0.0.1", 0))
    addr = srv.getsockname()[1]
    if broker == "refused":
        srv.close()
    else:
        def accept_and_close():
            conn, _ = srv.accept()
            conn.close()

        threading.Thread(target=accept_and_close, daemon=True).start()
    rows: list = []
    P = _pkg("torch")
    S = P["Schema"].of([("v", "int64"), (P["TS"], "int64")])
    g = P["Graph"]()
    g.add_node(P["Node"]("src", P["OpName"].SOURCE, {
        "connector": "nats", "servers": f"nats://127.0.0.1:{addr}", "subject": "in",
        "format": "json", "schema": P["Schema"].of([("v", "int64")])}, 1))
    g.add_node(P["Node"]("snk", P["OpName"].SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "snk", P["EdgeType"].FORWARD, S)
    try:
        with pytest.raises(Exception, match="Connection|NATS"):
            P["run"](g, job_id=f"nats-{broker}", timeout=60, **P["kw"])
    finally:
        srv.close()
    assert rows == []
