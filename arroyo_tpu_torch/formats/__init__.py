"""Formats of the port: bytes <-> columnar batches (the port's share of the
JAX package's ``formats``): JSON (structured, unstructured, debezium),
newline / length framing and the bad-data policy. Avro, Protobuf and raw
string / bytes are ROADMAP A.9 and refused by name.
"""

from .base import BadDataError, RowBatchingDeserializer, rows_to_batch
from .framing import frame_iter, frame_join
from .json_fmt import (
    JsonDeserializer,
    format_iso_micros,
    parse_iso_micros,
    serialize_json_lines,
)
from .registry import (
    DebeziumJsonDeserializer,
    default_framing,
    make_deserializer,
    serialize_batch,
)

__all__ = [
    "BadDataError",
    "RowBatchingDeserializer",
    "rows_to_batch",
    "frame_iter",
    "frame_join",
    "JsonDeserializer",
    "format_iso_micros",
    "parse_iso_micros",
    "serialize_json_lines",
    "DebeziumJsonDeserializer",
    "default_framing",
    "make_deserializer",
    "serialize_batch",
]
