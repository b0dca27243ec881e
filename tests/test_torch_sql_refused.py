"""What the port's SQL path once refused, and takes now: every connector the
JAX package registers is registered in the port and none of them is a
refusal (ROADMAP A.9's network connectors were its last, tests/
test_torch_connectors_net.py runs them); the formats the port has are
taken."""

from __future__ import annotations

import numpy as np
import pytest

from arroyo_tpu_torch.batch import Batch, Schema
from arroyo_tpu_torch.formats import make_deserializer, serialize_batch


def test_remainder_is_what_the_jax_package_registers_and_the_port_does_not_run():
    """Every connector name the JAX package registers is registered in the
    port (each package loaded alone, in a process of its own: tests register
    fixture connectors in both registries), and no remainder is left: the
    port's gated stubs are the JAX package's (fluvio alone), with no
    refusal among them."""
    import json
    import os
    import subprocess
    import sys

    from arroyo_tpu_torch.connectors import stubs

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
    assert not hasattr(stubs, "REMAINDER") and not hasattr(stubs, "NotPortedError")
    assert sorted(stubs._SPECS) == ["fluvio"]


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
