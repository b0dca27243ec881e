"""Avro: a self-contained binary codec, no fastavro (the port's copy of
arroyo_tpu/formats/avro_fmt.py).

Reference: crates/arroyo-formats/src/avro/ (de.rs/ser.rs/schema.rs) —
raw datums with a fixed schema, Confluent wire format (magic 0x00 + 4-byte
BE schema id + datum), and Object Container Files for the filesystem
connector. Supported schema subset: records of
null/boolean/int/long/float/double/bytes/string, nullable unions
([null, T] / [T, null]), enums, arrays, maps, and the timestamp-millis /
timestamp-micros logical types (normalized to int64 micros).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Optional

CONFLUENT_MAGIC = b"\x00"
OCF_MAGIC = b"Obj\x01"


class AvroError(ValueError):
    pass


# --------------------------------------------------------------------------
# schema


class AvroSchema:
    """Parsed schema tree. Nodes are dicts: {"type": ..., ...}."""

    def __init__(self, schema: "str | dict | list"):
        if isinstance(schema, str):
            schema = json.loads(schema)
        self.root = schema
        if self._type_name(schema) != "record":
            raise AvroError("top-level avro schema must be a record")
        self.fields = schema["fields"]

    @staticmethod
    def _type_name(node) -> str:
        if isinstance(node, str):
            return node
        if isinstance(node, list):
            return "union"
        return node["type"]

    def field_names(self) -> list[str]:
        return [f["name"] for f in self.fields]


# --------------------------------------------------------------------------
# binary primitives


def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise AvroError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag


def _write_zigzag(out: io.BytesIO, v: int) -> None:
    u = (v << 1) if v >= 0 else (((-v) << 1) - 1)
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise AvroError("truncated bytes")
    return data


# --------------------------------------------------------------------------
# datum codec


def _decode(node, buf: io.BytesIO) -> Any:
    t = node if isinstance(node, str) else node
    if isinstance(t, list):  # union
        idx = _read_long(buf)
        if not 0 <= idx < len(t):
            raise AvroError(f"union index {idx} out of range")
        return _decode(t[idx], buf)
    if isinstance(t, dict):
        logical = t.get("logicalType")
        base = t["type"]
        if base == "record":
            return {f["name"]: _decode(f["type"], buf) for f in t["fields"]}
        if base == "enum":
            idx = _read_long(buf)
            return t["symbols"][idx]
        if base == "array":
            out = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:  # block with byte size
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    out.append(_decode(t["items"], buf))
        if base == "map":
            out = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    k = _read_bytes(buf).decode()
                    out[k] = _decode(t["values"], buf)
        if base == "fixed":
            return buf.read(t["size"])
        v = _decode(base, buf)
        if logical == "timestamp-millis":
            return int(v) * 1000
        return v
    if t == "null":
        return None
    if t == "boolean":
        b = buf.read(1)
        return bool(b[0])
    if t in ("int", "long"):
        return _read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return _read_bytes(buf)
    if t == "string":
        return _read_bytes(buf).decode("utf-8")
    raise AvroError(f"unsupported avro type {t!r}")


def _encode(node, v, out: io.BytesIO) -> None:
    t = node
    if isinstance(t, list):  # union: pick null vs the other branch
        for i, branch in enumerate(t):
            if (v is None) == (AvroSchema._type_name(branch) == "null"):
                _write_zigzag(out, i)
                _encode(branch, v, out)
                return
        raise AvroError(f"no union branch for value {v!r} in {t}")
    if isinstance(t, dict):
        base = t["type"]
        logical = t.get("logicalType")
        if base == "record":
            for f in t["fields"]:
                _encode(f["type"], v.get(f["name"]), out)
            return
        if base == "enum":
            _write_zigzag(out, t["symbols"].index(v))
            return
        if base == "array":
            if v:
                _write_zigzag(out, len(v))
                for item in v:
                    _encode(t["items"], item, out)
            _write_zigzag(out, 0)
            return
        if base == "map":
            if v:
                _write_zigzag(out, len(v))
                for k, item in v.items():
                    kb = k.encode()
                    _write_zigzag(out, len(kb))
                    out.write(kb)
                    _encode(t["values"], item, out)
            _write_zigzag(out, 0)
            return
        if base == "fixed":
            out.write(v)
            return
        if logical == "timestamp-millis":
            v = int(v) // 1000
        _encode(base, v, out)
        return
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if v else b"\x00")
        return
    if t in ("int", "long"):
        _write_zigzag(out, int(v))
        return
    if t == "float":
        out.write(struct.pack("<f", float(v)))
        return
    if t == "double":
        out.write(struct.pack("<d", float(v)))
        return
    if t == "bytes":
        _write_zigzag(out, len(v))
        out.write(v)
        return
    if t == "string":
        b = str(v).encode("utf-8")
        _write_zigzag(out, len(b))
        out.write(b)
        return
    raise AvroError(f"unsupported avro type {t!r}")


def decode_datum(schema: AvroSchema, data: bytes) -> dict:
    """One bare binary datum -> row dict."""
    return _decode(schema.root, io.BytesIO(data))


def encode_datum(schema: AvroSchema, row: dict) -> bytes:
    out = io.BytesIO()
    _encode(schema.root, row, out)
    return out.getvalue()


# --------------------------------------------------------------------------
# confluent wire format


def decode_confluent(schema: AvroSchema, data: bytes) -> tuple[int, dict]:
    """magic 0x00 + 4-byte BE schema id + datum -> (schema_id, row)."""
    if len(data) < 5 or data[:1] != CONFLUENT_MAGIC:
        raise AvroError("not a confluent-framed avro message")
    schema_id = struct.unpack(">I", data[1:5])[0]
    return schema_id, decode_datum(schema, data[5:])


def encode_confluent(schema: AvroSchema, schema_id: int, row: dict) -> bytes:
    return CONFLUENT_MAGIC + struct.pack(">I", schema_id) + encode_datum(schema, row)


# --------------------------------------------------------------------------
# object container files (the filesystem-connector format)


def read_ocf(data: bytes) -> tuple[AvroSchema, list[dict]]:
    buf = io.BytesIO(data)
    if buf.read(4) != OCF_MAGIC:
        raise AvroError("not an avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:
            _read_long(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode()
            meta[k] = _read_bytes(buf)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported OCF codec {codec!r}")
    schema = AvroSchema(meta["avro.schema"].decode())
    sync = buf.read(16)
    rows: list[dict] = []
    while True:
        try:
            count = _read_long(buf)
        except AvroError:
            break  # clean EOF
        size = _read_long(buf)
        block = buf.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bbuf = io.BytesIO(block)
        for _ in range(count):
            rows.append(_decode(schema.root, bbuf))
        if buf.read(16) != sync:
            raise AvroError("OCF sync marker mismatch")
    return schema, rows


def write_ocf(schema: AvroSchema, rows: list[dict], codec: str = "null") -> bytes:
    out = io.BytesIO()
    out.write(OCF_MAGIC)
    meta = {
        "avro.schema": json.dumps(schema.root).encode(),
        "avro.codec": codec.encode(),
    }
    _write_zigzag(out, len(meta))
    for k, v in meta.items():
        kb = k.encode()
        _write_zigzag(out, len(kb))
        out.write(kb)
        _write_zigzag(out, len(v))
        out.write(v)
    _write_zigzag(out, 0)
    sync = b"arroyo-tpu-sync!"  # deterministic 16-byte marker
    out.write(sync)
    if rows:
        block = io.BytesIO()
        for r in rows:
            _encode(schema.root, r, block)
        payload = block.getvalue()
        if codec == "deflate":
            co = zlib.compressobj(wbits=-15)
            payload = co.compress(payload) + co.flush()
        _write_zigzag(out, len(rows))
        _write_zigzag(out, len(payload))
        out.write(payload)
        out.write(sync)
    return out.getvalue()


def schema_from_table(fields) -> AvroSchema:
    """Build a writer schema from a Schema's (name, dtype) fields."""
    tmap = {
        "int32": "int", "int64": "long", "uint64": "long",
        "float32": "float", "float64": "double", "bool": "boolean",
        "string": ["null", "string"],
        "timestamp": {"type": "long", "logicalType": "timestamp-micros"},
    }
    return AvroSchema({
        "type": "record",
        "name": "Row",
        "fields": [
            {"name": f.name, "type": tmap[f.dtype]}
            for f in fields
            if not f.name.startswith("_")
        ],
    })
