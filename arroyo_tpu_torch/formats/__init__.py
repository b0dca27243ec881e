"""Formats of the port: bytes <-> columnar batches (the port's copy of the
JAX package's ``formats``).

JSON (structured/unstructured/debezium), Avro (bare datums, Confluent wire
format, object container files), Protobuf (descriptor sets), raw
string/bytes; newline/length framing; BadData::{Drop,Fail} policy; Confluent
schema-registry resolver.
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
    AvroDeserializer,
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
    "AvroDeserializer",
    "DebeziumJsonDeserializer",
    "default_framing",
    "make_deserializer",
    "serialize_batch",
]
