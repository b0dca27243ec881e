"""Raw formats (the port's copy of arroyo_tpu/formats/raw_fmt.py):
raw_string and raw_bytes, one ``value`` column per message."""

from __future__ import annotations

from .base import RowBatchingDeserializer


class RawStringDeserializer(RowBatchingDeserializer):
    def _decode(self, payload) -> list[dict]:
        text = payload.decode("utf-8") if isinstance(payload, bytes) else str(payload)
        return [{"value": text}]


class RawBytesDeserializer(RowBatchingDeserializer):
    def _decode(self, payload) -> list[dict]:
        data = payload if isinstance(payload, bytes) else str(payload).encode()
        return [{"value": data}]


def serialize_raw_string(batch, field: str = "value") -> list[bytes]:
    col = batch[field]
    return [("" if v is None else str(v)).encode() for v in col]
