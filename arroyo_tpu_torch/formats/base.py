"""Shared deserializer machinery (the port's copy of the JAX package's
``formats/base.py``): rows -> columnar batches with a batch-size / linger
flush and the ``bad_data = fail | drop`` policy; format-specific
subclasses only turn payload bytes into row dicts.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..batch import STRING, TIMESTAMP_FIELD, Batch, Schema


class BadDataError(ValueError):
    pass


# BAD_DATA_DROPPED events are throttled per deserializer so a poisoned topic
# can't flood the event log; the metric counter stays exact regardless
_DROP_EVENT_INTERVAL_S = 30.0


class RowBatchingDeserializer:
    """Accumulates decoded rows, flushing by batch size / linger.

    Owns the ``bad_data = fail | drop`` policy for EVERY connector:
    decode errors hit it in :meth:`deserialize`, and connectors route
    transport-level record errors through :meth:`drop_bad_data` instead of
    reimplementing the option inline, so drops are counted
    (``arroyo_bad_records_total``) and surfaced (``BAD_DATA_DROPPED``)
    uniformly no matter which layer rejected the record.
    """

    def __init__(
        self,
        schema: Schema,
        batch_size: int = 512,
        linger_micros: int = 100_000,
        bad_data: str = "fail",
        event_time_field: Optional[str] = None,
        task_info=None,
    ):
        self.schema = schema
        self.batch_size = batch_size
        self.linger_micros = linger_micros
        self.bad_data = bad_data
        self.event_time_field = event_time_field
        self.task_info = task_info
        self._rows: list[dict] = []
        self._first_buffer_time: Optional[float] = None
        self.errors = 0
        self._drops_unreported = 0
        self._last_drop_event: Optional[float] = None

    # -- subclass hook -------------------------------------------------------

    def _decode(self, payload) -> list[dict]:
        """payload (bytes/str) -> row dicts; raise on malformed input."""
        raise NotImplementedError

    # -- bad-data policy -----------------------------------------------------

    def drop_bad_data(self, err: Exception) -> bool:
        """The one ``bad_data`` decision point. Returns True when the record
        was dropped (policy ``drop``; drop recorded), False when the caller
        must re-raise (policy ``fail``)."""
        if self.bad_data != "drop":
            return False
        self.errors += 1
        ti = self.task_info
        if ti is None:
            return True
        from ..metrics import registry

        registry.add_bad_record(ti.job_id, ti.node_id)
        self._drops_unreported += 1
        now = time.monotonic()
        if (self._last_drop_event is None
                or now - self._last_drop_event >= _DROP_EVENT_INTERVAL_S):
            from ..obs.events import recorder

            recorder.record(
                ti.job_id, "WARN", "BAD_DATA_DROPPED",
                f"dropped {self._drops_unreported} bad record(s) under "
                f"bad_data=drop: {str(err)[:200]}",
                node=ti.node_id, subtask=ti.subtask_index,
                data={"dropped": self._drops_unreported,
                      "total_dropped": self.errors,
                      "last_error": str(err)[:400]})
            self._drops_unreported = 0
            self._last_drop_event = now
        return True

    # -- public API ----------------------------------------------------------

    def deserialize(self, payload, timestamp_micros: Optional[int] = None) -> None:
        try:
            rows = self._decode(payload)
        except Exception as exc:
            if self.drop_bad_data(exc):
                return
            raise
        if not rows:
            return
        if timestamp_micros is not None:
            for r in rows:
                r.setdefault(TIMESTAMP_FIELD, timestamp_micros)
        if self._first_buffer_time is None:
            self._first_buffer_time = time.monotonic()
        self._rows.extend(rows)

    def should_flush(self) -> bool:
        if len(self._rows) >= self.batch_size:
            return True
        return (
            bool(self._rows)
            and self._first_buffer_time is not None
            and (time.monotonic() - self._first_buffer_time) * 1e6 >= self.linger_micros
        )

    def flush(self) -> Optional[Batch]:
        if not self._rows:
            return None
        rows, self._rows = self._rows, []
        self._first_buffer_time = None
        return rows_to_batch(rows, self.schema, self.event_time_field)


def rows_to_batch(
    rows: list[dict], schema: Schema, event_time_field: Optional[str] = None
) -> Batch:
    from .json_fmt import parse_iso_micros

    cols: dict[str, np.ndarray] = {}
    for f in schema.fields:
        if f.name == TIMESTAMP_FIELD:
            continue
        vals = [r.get(f.name) for r in rows]
        if f.dtype == "timestamp":
            cols[f.name] = np.array(
                [0 if v is None else parse_iso_micros(v) for v in vals], dtype=np.int64
            )
        elif f.dtype == STRING:
            cols[f.name] = np.array(
                [None if v is None else str(v) for v in vals], dtype=object
            )
        elif f.dtype in ("float32", "float64"):
            cols[f.name] = np.array(
                [np.nan if v is None else float(v) for v in vals], dtype=f.numpy_dtype()
            )
        elif f.dtype == "bool":
            cols[f.name] = np.array([bool(v) for v in vals], dtype=np.bool_)
        else:
            cols[f.name] = np.array(
                [0 if v is None else int(v) for v in vals], dtype=f.numpy_dtype()
            )
    if event_time_field:
        cols[TIMESTAMP_FIELD] = np.asarray(cols[event_time_field]).astype(np.int64)
    else:
        now = int(time.time() * 1e6)
        ts = [r.get(TIMESTAMP_FIELD, now) for r in rows]
        cols[TIMESTAMP_FIELD] = np.array(ts, dtype=np.int64)
    # debezium rows carry the retract flag through to the batch; absent
    # for append formats
    if rows and "_is_retract" in rows[0]:
        cols["_is_retract"] = np.array(
            [bool(r.get("_is_retract", False)) for r in rows], dtype=np.bool_)
    return Batch(cols)
