"""JSON format (the port's copy of the JAX package's ``formats/json_fmt.py``):
bytes / lines <-> columnar batches, flushed by ``pipeline.source-batch-size``
or by the linger of ``formats.registry.LINGER_MICROS``.
"""

from __future__ import annotations

import json
import time
from typing import Iterable, Optional

import numpy as np

from ..batch import STRING, TIMESTAMP_FIELD, Batch, Field, Schema
from .base import BadDataError, RowBatchingDeserializer

IS_RETRACT_FIELD = "_is_retract"


def parse_iso_micros(v) -> int:
    """ISO-8601 datetime (or epoch-micros int) -> int64 micros since epoch."""
    if isinstance(v, (int, float)):
        return int(v)
    from datetime import datetime, timezone

    s = str(v)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1_000_000)


def format_iso_micros(us: int) -> str:
    """int64 micros -> naive-UTC ISO string; fraction printed at millisecond
    precision when it is whole millis, microseconds otherwise, omitted when
    zero (matches arrow's display of timestamp columns)."""
    from datetime import datetime, timezone

    us = int(us)
    dt = datetime.fromtimestamp(us // 1_000_000, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    frac = us % 1_000_000
    if frac == 0:
        return base
    if frac % 1000 == 0:
        return f"{base}.{frac // 1000:03d}"
    return f"{base}.{frac:06d}"


class JsonDeserializer(RowBatchingDeserializer):
    """Accumulates JSON objects into columns, flushing by size/linger.
    bad_data: "fail" | "drop". ``unstructured=True`` puts the raw text into
    a single "value" column."""

    def __init__(self, *args, unstructured: bool = False, **kw):
        super().__init__(*args, **kw)
        self.unstructured = unstructured

    def _decode(self, payload) -> list[dict]:
        if self.unstructured:
            text = payload.decode() if isinstance(payload, bytes) else str(payload)
            return [{"value": text}]
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise BadDataError(f"expected JSON object, got {type(obj)}")
        return [obj]


def serialize_json_lines(
    batch: Batch, schema: Optional[Schema] = None, include_internal: bool = False
) -> list[str]:
    """Batch -> JSON lines. With a schema, timestamp columns format as ISO
    strings. Updating batches (_is_retract present) serialize as Debezium
    envelopes {"before","after","op"}."""
    names = [
        n
        for n in batch.columns
        if (include_internal or not n.startswith("_")) and n != IS_RETRACT_FIELD
    ]
    ts_fields = set()
    if schema is not None:
        ts_fields = {f.name for f in schema.fields if f.dtype == "timestamp"}
    cols = [batch.columns[n] for n in names]
    retracts = (
        np.asarray(batch.columns[IS_RETRACT_FIELD], dtype=bool)
        if IS_RETRACT_FIELD in batch.columns
        else None
    )
    out = []
    for i in range(batch.num_rows):
        obj = {}
        for n, c in zip(names, cols):
            v = c[i]
            if isinstance(v, np.generic):
                v = v.item()
            if isinstance(v, float) and v != v:  # NaN -> null
                v = None
            if n in ts_fields and v is not None:
                v = format_iso_micros(v)
            obj[n] = v
        if retracts is not None:
            if retracts[i]:
                obj = {"before": obj, "after": None, "op": "d"}
            else:
                obj = {"before": None, "after": obj, "op": "c"}
        out.append(json.dumps(obj, separators=(",", ":"), default=str))
    return out
