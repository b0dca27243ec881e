"""Format registry (the port's copy of arroyo_tpu/formats/registry.py): table
DDL options -> deserializer / serializer. Options recognized (from CREATE
TABLE ... WITH):
  format = 'json' | 'debezium_json' | 'avro' | 'protobuf' | 'raw_string' |
           'raw_bytes'
  framing = 'newline' | 'length'          (default: per-connector)
  bad_data = 'fail' | 'drop'
  'json.unstructured' = true
  'avro.schema' = '<json schema>'         (reader/writer schema)
  'avro.confluent_schema_registry' = true (magic byte + schema id framing)
  'proto.descriptor_file', 'proto.message_name'
"""

from __future__ import annotations

from typing import Optional

from ..batch import Schema
from .avro_fmt import AvroSchema, decode_confluent, decode_datum
from .base import RowBatchingDeserializer
from .json_fmt import JsonDeserializer
from .proto_fmt import ProtoDeserializer
from .raw_fmt import RawBytesDeserializer, RawStringDeserializer

# a source flushes once the oldest buffered row is this old (the JAX
# package's default of ``pipeline.source-batch-linger-ms``, 100 ms)
LINGER_MICROS = 100_000


class AvroDeserializer(RowBatchingDeserializer):
    def __init__(self, *args, avro_schema: AvroSchema,
                 confluent_wire_format: bool = False, **kw):
        super().__init__(*args, **kw)
        self.avro_schema = avro_schema
        self.confluent = confluent_wire_format

    def _decode(self, payload) -> list[dict]:
        data = payload if isinstance(payload, bytes) else str(payload).encode("latin-1")
        if self.confluent:
            _sid, row = decode_confluent(self.avro_schema, data)
            return [row]
        return [decode_datum(self.avro_schema, data)]


class DebeziumJsonDeserializer(JsonDeserializer):
    """Debezium envelopes -> updating rows with _is_retract
    (reference formats.rs Json{debezium}; de.rs debezium handling)."""

    def _decode(self, payload) -> list[dict]:
        import json as _json

        obj = _json.loads(payload)
        payload_obj = obj.get("payload", obj)
        op = payload_obj.get("op")
        before = payload_obj.get("before")
        after = payload_obj.get("after")
        rows = []
        if op in ("c", "r"):
            rows.append(dict(after, _is_retract=False))
        elif op == "d":
            rows.append(dict(before, _is_retract=True))
        elif op == "u":
            if before is not None:
                rows.append(dict(before, _is_retract=True))
            rows.append(dict(after, _is_retract=False))
        else:
            raise ValueError(f"unknown debezium op {op!r}")
        return rows


def make_deserializer(cfg: dict, schema: Schema,
                      task_info=None) -> RowBatchingDeserializer:
    """Build the configured deserializer for a source node config.

    ``task_info`` (types.TaskInfo) attributes dropped records to a
    job/operator for the ``arroyo_bad_records_total`` counter and the
    throttled ``BAD_DATA_DROPPED`` event; without it drops are only
    counted on the deserializer itself."""
    from ..config import config

    fmt = str(cfg.get("format", "json"))
    common = dict(
        schema=schema,
        batch_size=config().get("pipeline.source-batch-size"),
        linger_micros=LINGER_MICROS,
        bad_data=str(cfg.get("bad_data", "fail")),
        event_time_field=cfg.get("event_time_field"),
        task_info=task_info,
    )
    if fmt == "json":
        return JsonDeserializer(
            **common, unstructured=bool(cfg.get("json.unstructured", False))
        )
    if fmt == "debezium_json":
        return DebeziumJsonDeserializer(**common)
    if fmt == "avro":
        raw = cfg.get("avro.schema")
        if not raw:
            raise ValueError("avro format requires the 'avro.schema' option")
        return AvroDeserializer(
            **common,
            avro_schema=AvroSchema(raw),
            confluent_wire_format=bool(cfg.get("avro.confluent_schema_registry", False)),
        )
    if fmt == "protobuf":
        df = cfg.get("proto.descriptor_file")
        mn = cfg.get("proto.message_name")
        if not df or not mn:
            raise ValueError(
                "protobuf format requires 'proto.descriptor_file' and "
                "'proto.message_name' options"
            )
        return ProtoDeserializer(
            **common, descriptor_file=str(df), message_name=str(mn),
            confluent_wire_format=bool(cfg.get("proto.confluent_schema_registry", False)),
        )
    if fmt == "raw_string":
        return RawStringDeserializer(**common)
    if fmt == "raw_bytes":
        return RawBytesDeserializer(**common)
    raise ValueError(f"unknown format {fmt!r}")


def default_framing(cfg: dict) -> Optional[str]:
    v = cfg.get("framing")
    return str(v) if v else None


def serialize_batch(cfg: dict, batch, schema: Optional[Schema]) -> list[bytes]:
    """Sink-side: batch -> encoded messages for the configured format."""
    fmt = str(cfg.get("format", "json"))
    if fmt in ("json", "debezium_json"):
        from .json_fmt import serialize_json_lines

        return [line.encode() for line in serialize_json_lines(batch, schema)]
    if fmt == "avro":
        from .avro_fmt import encode_datum, schema_from_table

        raw = cfg.get("avro.schema")
        asch = AvroSchema(raw) if raw else schema_from_table(schema.fields)
        names = [f["name"] for f in asch.fields]
        rows = batch.to_pylist()
        return [encode_datum(asch, {n: r.get(n) for n in names}) for r in rows]
    if fmt == "protobuf":
        from .proto_fmt import encode_rows

        return encode_rows(
            str(cfg["proto.descriptor_file"]), str(cfg["proto.message_name"]),
            batch.to_pylist(),
        )
    if fmt == "raw_string":
        from .raw_fmt import serialize_raw_string

        return serialize_raw_string(batch)
    if fmt == "raw_bytes":
        col = batch["value"]
        return [v if isinstance(v, bytes) else str(v).encode() for v in col]
    raise ValueError(f"unknown sink format {fmt!r}")
