"""Format registry (the port's copy of the JAX package's
``formats/registry.py``, JSON formats only): table DDL options ->
deserializer / serializer. Options recognized (from CREATE TABLE ... WITH):
  format = 'json' | 'debezium_json'
  bad_data = 'fail' | 'drop'
  'json.unstructured' = true
  framing = 'newline' | 'length'          (default: per connector)
The JAX package's other formats ('avro', 'protobuf', 'raw_string',
'raw_bytes') are ROADMAP A.9 and refused by name.
"""

from __future__ import annotations

from typing import Optional

from ..batch import Schema
from .base import RowBatchingDeserializer
from .json_fmt import JsonDeserializer

NOT_PORTED = ("avro", "protobuf", "raw_string", "raw_bytes")

# a source flushes once the oldest buffered row is this old (the JAX
# package's default of ``pipeline.source-batch-linger-ms``, 100 ms)
LINGER_MICROS = 100_000


def _refuse(fmt: str):
    if fmt in NOT_PORTED:
        raise NotImplementedError(
            f"format {fmt!r} is not in the port yet (ROADMAP A.9: other connectors and "
            f"formats); the port reads and writes 'json' and 'debezium_json'")


class DebeziumJsonDeserializer(JsonDeserializer):
    """Debezium envelopes -> updating rows with _is_retract."""

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
    job/operator for the bad-record counter and the throttled
    ``BAD_DATA_DROPPED`` event; without it drops are only counted on the
    deserializer itself."""
    from ..config import config

    fmt = str(cfg.get("format", "json"))
    _refuse(fmt)
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
    raise ValueError(f"unknown format {fmt!r}")


def default_framing(cfg: dict) -> Optional[str]:
    v = cfg.get("framing")
    return str(v) if v else None


def serialize_batch(cfg: dict, batch, schema: Optional[Schema]) -> list[bytes]:
    """Sink-side: batch -> encoded messages for the configured format."""
    fmt = str(cfg.get("format", "json"))
    _refuse(fmt)
    if fmt in ("json", "debezium_json"):
        from .json_fmt import serialize_json_lines

        return [line.encode() for line in serialize_json_lines(batch, schema)]
    raise ValueError(f"unknown sink format {fmt!r}")
