"""In-memory vector sink (collects rows into a caller-owned list)."""

from __future__ import annotations

import threading

from ..operators.base import Operator
from . import register_sink


class VecSink(Operator):
    """config: rows: list (shared, appended under a lock),
    include_internal: bool (keep _timestamp/_key columns),
    columnar: bool (append Batch objects instead of row dicts)."""

    def __init__(self, cfg: dict):
        self.rows: list = cfg["rows"]  # state: ephemeral — test sink appends to a caller-owned list; at-least-once by contract
        self.include_internal = cfg.get("include_internal", False)
        self.columnar = cfg.get("columnar", False)
        self._lock = cfg.setdefault("_lock", threading.Lock())

    def process_batch(self, batch, ctx, collector, input_index=0):
        out = batch
        if not self.include_internal:
            drop = [n for n in batch.columns if n.startswith("_")]
            if drop:
                out = batch.without_columns(drop)
        with self._lock:
            if self.columnar:
                self.rows.append(out)
            else:
                self.rows.extend(out.to_pylist())


register_sink("vec")(VecSink)
