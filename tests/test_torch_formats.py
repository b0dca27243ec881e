"""The port's formats (formats/raw_fmt.py, avro_fmt.py, proto_fmt.py,
schema_registry.py and their wiring in registry.py) over
tests/test_formats.py's twelve cases, each run through the port with the JAX
test's assertions (the protobuf case skips without protoc, as the JAX one
does); then the encoders held to the JAX package's bytes: Avro datums,
Confluent framing, raw strings, object container files and protobuf
messages byte for byte."""

from __future__ import annotations

import json
import shutil
import subprocess

import numpy as np
import pytest

from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_formats")
CASES = sorted(n for n in dir(MOD) if n.startswith("test_"))


def test_every_case_is_mirrored():
    assert len(CASES) == 12, CASES


@pytest.mark.parametrize("name", CASES)
def test_format_case_through_the_port(name, tmp_path, port):
    if name == "test_avro_ocf_roundtrip":
        for codec in ("null", "deflate"):
            MOD.test_avro_ocf_roundtrip(codec)
        return
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)


ROWS = MOD.ROWS
SCHEMA = MOD.AVRO_SCHEMA


def _pkgs():
    from arroyo_tpu.formats import avro_fmt as javro
    from arroyo_tpu_torch.formats import avro_fmt as tavro

    return javro, tavro


def test_avro_datums_and_confluent_frames_are_the_jax_packages_bytes():
    javro, tavro = _pkgs()
    js, ts = javro.AvroSchema(json.dumps(SCHEMA)), tavro.AvroSchema(json.dumps(SCHEMA))
    for row in ROWS:
        assert tavro.encode_datum(ts, row) == javro.encode_datum(js, row)
        assert tavro.encode_confluent(ts, 42, row) == javro.encode_confluent(js, 42, row)
        assert tavro.decode_datum(ts, javro.encode_datum(js, row)) == row


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_ocf_is_the_jax_packages_bytes(codec):
    """Both packages write OCF with the same constant 16-byte sync marker, so
    the files are equal byte for byte, and each reads the other's."""
    javro, tavro = _pkgs()
    js, ts = javro.AvroSchema(json.dumps(SCHEMA)), tavro.AvroSchema(json.dumps(SCHEMA))
    rows = ROWS * 300
    a, b = tavro.write_ocf(ts, rows, codec=codec), javro.write_ocf(js, rows, codec=codec)
    assert a == b
    assert javro.read_ocf(a)[1] == rows and tavro.read_ocf(b)[1] == rows


@pytest.mark.parametrize("fmt", ["raw_string", "raw_bytes", "avro", "json"])
def test_serialize_batch_gives_the_jax_packages_bytes(fmt):
    from arroyo_tpu.batch import Batch as JBatch
    from arroyo_tpu.batch import Schema as JSchema
    from arroyo_tpu.formats.registry import serialize_batch as jser
    from arroyo_tpu_torch.batch import Batch, Schema
    from arroyo_tpu_torch.formats.registry import serialize_batch as tser

    fields = [("value", "string"), ("n", "int64"), ("p", "float64")]
    cols = {"value": np.array(["a", "bé", "", "zz"], dtype=object),
            "n": np.array([1, -2, 3, 1 << 40]), "p": np.array([0.5, -1.25, 2.0, 1e300])}
    if fmt == "raw_bytes":
        cols["value"] = np.array([b"\x00\x01", b"", "text", b"\xff"], dtype=object)
    cfg = {"format": fmt}
    got = tser(cfg, Batch(dict(cols)), Schema.of(fields))
    assert got == jser(cfg, JBatch(dict(cols)), JSchema.of(fields))
    assert all(isinstance(m, bytes) for m in got)


def test_protobuf_messages_are_the_jax_packages_bytes(tmp_path):
    if shutil.which("protoc") is None:
        pytest.skip("protoc not installed; descriptor compilation unavailable")
    from arroyo_tpu.formats import proto_fmt as jproto
    from arroyo_tpu_torch.formats import proto_fmt as tproto

    proto = tmp_path / "bid.proto"
    proto.write_text('syntax = "proto3";\n'
                     "message Bid { int64 auction = 1; double price = 2; string bidder = 3; "
                     "repeated int64 tags = 4; }\n")
    desc = tmp_path / "bid.desc"
    subprocess.run(["protoc", f"--descriptor_set_out={desc}", "--proto_path", str(tmp_path),
                    str(proto)], check=True)
    rows = [{"auction": 5, "price": 1.5, "bidder": "bob", "tags": [1, 2]},
            {"auction": -6, "price": 0.0, "bidder": "", "tags": []}]
    msgs = tproto.encode_rows(str(desc), "Bid", rows)
    assert msgs == jproto.encode_rows(str(desc), "Bid", rows)


def test_confluent_registry_resolves_over_http():
    """ConfluentSchemaRegistry against a local fake of the registry's REST
    API: register, fetch by id, latest by subject; the JAX package's client
    gets the same answers from it."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from arroyo_tpu.formats.schema_registry import ConfluentSchemaRegistry as JReg
    from arroyo_tpu_torch.formats.schema_registry import ConfluentSchemaRegistry as TReg

    store: dict = {"ids": {}, "subjects": {}}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            subject = self.path.split("/")[2]
            sid = next((i for i, s in store["ids"].items() if s == body["schema"]),
                       len(store["ids"]) + 1)
            store["ids"][sid] = body["schema"]
            store["subjects"].setdefault(subject, []).append(sid)
            self._json(200, {"id": sid})

        def do_GET(self):
            parts = self.path.strip("/").split("/")
            if parts[:2] == ["schemas", "ids"]:
                self._json(200, {"schema": store["ids"][int(parts[2])]})
            else:
                sid = store["subjects"][parts[1]][-1]
                self._json(200, {"id": sid, "schema": store["ids"][sid], "version": 1})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        t, j = TReg(url), JReg(url)
        sid = t.register("bids-value", json.dumps(SCHEMA))
        assert j.get_schema_by_id(sid) == t.get_schema_by_id(sid) == json.dumps(SCHEMA)
        assert t.get_latest("bids-value") == j.get_latest("bids-value")
    finally:
        srv.shutdown()
