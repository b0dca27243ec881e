"""What the port's SQL path still refuses, each with the ROADMAP item that
lifts it: the JAX package's network connectors (its http_conn, websocket,
broker_base, nats, mqtt, rabbitmq, kinesis, redis and kafka modules) are
registered under their names and raise when built, naming ROADMAP A.9's
remainder, through the operator constructor and through a SQL pipeline; the
formats the port now has are taken."""

from __future__ import annotations

import numpy as np
import pytest

from arroyo_tpu_torch.batch import Batch, Schema
from arroyo_tpu_torch.formats import make_deserializer, serialize_batch

REMAINDER = [("sse", "source"), ("polling_http", "source"), ("webhook", "sink"),
             ("websocket", "source"), ("nats", "source"), ("nats", "sink"),
             ("mqtt", "source"), ("mqtt", "sink"), ("rabbitmq", "source"),
             ("rabbitmq", "sink"), ("kinesis", "source"), ("kinesis", "sink"),
             ("redis", "sink"), ("kafka", "source"), ("kafka", "sink")]


def test_remainder_is_what_the_jax_package_registers_and_the_port_does_not_run():
    """Every connector name the JAX package registers is registered in the
    port (each package loaded alone, in a process of its own: tests register
    fixture connectors in both registries); those of the remainder are
    exactly the JAX package's network connector modules."""
    import json
    import os
    import subprocess
    import sys

    from arroyo_tpu_torch.connectors.stubs import REMAINDER as STUBS

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for pkg in ("arroyo_tpu", "arroyo_tpu_torch"):
        code = (f"import json, {pkg}, {pkg}.connectors as c\n"
                f"{pkg}._load_operators()\n"
                "print(json.dumps(c.connectors()))\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                              text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        got[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["arroyo_tpu_torch"] == got["arroyo_tpu"]
    assert sorted({(n, k) for n, (_m, kinds) in STUBS.items() for k in kinds}) == sorted(REMAINDER)
    assert {m for m, _k in STUBS.values()} == {"http_conn", "websocket", "nats", "mqtt",
                                               "rabbitmq", "kinesis", "redis", "kafka"}


@pytest.mark.parametrize("name,kind", REMAINDER, ids=[f"{n}-{k}" for n, k in REMAINDER])
def test_network_connector_raises_naming_a9s_remainder(name, kind):
    from arroyo_tpu_torch.engine.engine import construct_operator
    from arroyo_tpu_torch.graph import OpName

    op = OpName.SOURCE if kind == "source" else OpName.SINK
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9's remainder"):
        construct_operator(op, {"connector": name, "schema": Schema.of([("x", "int64")])})


def test_sql_pipeline_over_kafka_fails_naming_a9s_remainder():
    from arroyo_tpu_torch.engine import run_graph
    from arroyo_tpu_torch.sql import plan_query

    pp = plan_query("""
    CREATE TABLE k (x BIGINT) WITH (connector = 'kafka', topic = 't',
      bootstrap_servers = 'localhost:9092', format = 'json', type = 'source');
    SELECT x FROM k;""")
    with pytest.raises(NotImplementedError, match=r"'kafka' connector.*A\.9's remainder"):
        run_graph(pp.graph, device="cpu")


def test_json_formats_are_taken():
    schema = Schema.of([("x", "int64")])
    for fmt in ("json", "debezium_json"):
        make_deserializer({"format": fmt}, schema)
        assert serialize_batch({"format": fmt}, Batch({"x": np.arange(2)}), schema) == [
            b'{"x":0}', b'{"x":1}']


@pytest.mark.parametrize("fmt", ["raw_string", "raw_bytes", "avro"])
def test_formats_of_this_slice_are_taken(fmt):
    """A format the port used to refuse round-trips a batch, to the rows the
    JAX package's deserializer gives for the same messages."""
    from arroyo_tpu.batch import Schema as JSchema
    from arroyo_tpu.formats import make_deserializer as jmake

    fields = [("value", "string")]
    cfg = {"format": fmt}
    if fmt == "avro":
        cfg["avro.schema"] = ('{"type": "record", "name": "r", "fields": '
                              '[{"name": "value", "type": "string"}]}')
    msgs = serialize_batch(cfg, Batch({"value": np.array(["a", "b"], dtype=object)}),
                           Schema.of(fields))
    got = []
    for de in (make_deserializer(cfg, Schema.of(fields)), jmake(cfg, JSchema.of(fields))):
        for m in msgs:
            de.deserialize(m, timestamp_micros=1)
        got.append(list(de.flush()["value"]))
    assert got[0] == got[1] and len(got[0]) == 2
