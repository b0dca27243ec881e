"""Stateless and lightly stateful built-in operators (the port's copy of
arroyo_tpu/operators/builtin.py):

- ValueOperator: projection + filter;
- UnnestOperator: one row per element of a list column;
- KeyOperator: key columns + the uint64 routing hash ``_key``;
- WatermarkGenerator: expression watermark with idle detection; its
  ``"s"`` table keeps the watermark it reached and last emitted.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, Field, object_column
from ..engine.engine import register_operator
from ..expr import Expr, eval_expr
from ..graph import OpName
from ..hashing import hash_columns
from ..types import Signal, Watermark
from .base import Operator, TableSpec


class ValueOperator(Operator):
    """config: projections: list[(name, Expr)] | None (passthrough),
    filter: Expr | None. _timestamp passes through unless projected."""

    def __init__(self, cfg: dict):
        self.projections: Optional[list[tuple[str, Expr]]] = cfg.get("projections")
        self.filter: Optional[Expr] = cfg.get("filter")
        # with projections, the filter only materializes the columns the
        # projections and the internal passthroughs read
        self._needed: Optional[set] = None
        if self.projections is not None:
            needed = {TIMESTAMP_FIELD, KEY_FIELD, "_is_retract"}
            for _name, e in self.projections:
                needed |= e.columns()
            self._needed = needed

    def process_batch(self, batch, ctx, collector, input_index=0):
        n = batch.num_rows
        if self.filter is not None:
            mask = np.asarray(eval_expr(self.filter, batch.columns, n), dtype=bool)
            if not mask.any():
                return
            if not mask.all():
                if self._needed is not None:
                    batch = Batch({k: v[mask] for k, v in batch.columns.items()
                                   if k in self._needed})
                else:
                    batch = batch.filter(mask)
            n = batch.num_rows
        if self.projections is None:
            collector.collect(batch)
            return
        cols: dict[str, np.ndarray] = {}
        for name, expr in self.projections:
            cols[name] = eval_expr(expr, batch.columns, n)
        if TIMESTAMP_FIELD not in cols:
            cols[TIMESTAMP_FIELD] = batch.timestamps
        if KEY_FIELD in batch.columns and KEY_FIELD not in cols:
            cols[KEY_FIELD] = batch.keys
        if "_is_retract" in batch.columns and "_is_retract" not in cols:
            cols["_is_retract"] = batch.columns["_is_retract"]
        collector.collect(Batch(cols))


class UnnestOperator(Operator):
    """config: column (list-valued), out_name, out_dtype. Explodes each
    row's list into one output row per element; all other columns repeat.
    A NULL or empty list gives no rows."""

    def __init__(self, cfg: dict):
        self.column = str(cfg["column"])
        self.out_name = str(cfg.get("out_name", self.column))
        self.out_dtype = cfg.get("out_dtype")

    def process_batch(self, batch, ctx, collector, input_index=0):
        import itertools

        col = batch.columns[self.column]
        # UNNEST of a NULL array produces zero rows for that input row
        lens = np.fromiter((0 if v is None else len(v) for v in col),
                           dtype=np.int64, count=batch.num_rows)
        total = int(lens.sum())
        if total == 0:
            return
        flat = list(itertools.chain.from_iterable(v for v in col if v is not None))
        cols: dict[str, np.ndarray] = {}
        for name, c in batch.columns.items():
            if name == self.column:
                continue
            cols[name] = np.repeat(np.asarray(c), lens)
        if self.out_dtype and self.out_dtype != "string":
            vals = np.array(flat, dtype=Field("_", self.out_dtype).numpy_dtype())
        else:
            vals = object_column(flat)
        cols[self.out_name] = vals
        collector.collect(Batch(cols))


class KeyOperator(Operator):
    """config: keys: list[(name, Expr)] -- computes group-by columns and the
    uint64 routing hash (_key)."""

    def __init__(self, cfg: dict):
        self.keys: list[tuple[str, Expr]] = cfg["keys"]

    def process_batch(self, batch, ctx, collector, input_index=0):
        n = batch.num_rows
        cols = dict(batch.columns)
        key_cols = []
        for name, expr in self.keys:
            col = eval_expr(expr, batch.columns, n)
            cols[name] = col
            key_cols.append(np.asarray(col))
        cols[KEY_FIELD] = hash_columns(key_cols)
        collector.collect(Batch(cols))


class WatermarkGenerator(Operator):
    """config: expr: Expr (watermark value per row, e.g. _timestamp - 5s),
    interval_micros: min event-time advance between emissions (default: emit
    whenever it advances), idle_time_micros: wall-time idleness before
    emitting an idle watermark."""

    def __init__(self, cfg: dict):
        self.expr: Expr = cfg["expr"]
        self.interval_micros: int = cfg.get("interval_micros", 0)
        self.idle_time_micros: Optional[int] = cfg.get("idle_time_micros")
        self.max_watermark: Optional[int] = None
        self.last_emitted: Optional[int] = None
        self.last_event_wall: float = time.monotonic()
        self.idle_sent = False

    def tables(self):
        return [TableSpec("s", "global_keyed")]

    def on_start(self, ctx):
        st = ctx.table_manager.global_keyed("s").get(ctx.task_info.subtask_index)
        if st is not None:
            self.max_watermark = st.get("max_watermark")
            self.last_emitted = st.get("last_emitted")

    def handle_checkpoint(self, barrier, ctx, collector):
        ctx.table_manager.global_keyed("s").insert(
            ctx.task_info.subtask_index,
            {"max_watermark": self.max_watermark, "last_emitted": self.last_emitted})

    def tick_interval_micros(self):
        return self.idle_time_micros

    def handle_tick(self, ctx, collector):
        if self.idle_time_micros is None or self.idle_sent:
            return
        if (time.monotonic() - self.last_event_wall) * 1e6 >= self.idle_time_micros:
            collector.broadcast(Signal.watermark_of(Watermark.idle()))
            self.idle_sent = True

    def process_batch(self, batch, ctx, collector, input_index=0):
        vals = np.asarray(eval_expr(self.expr, batch.columns, batch.num_rows))
        m = int(vals.max())
        collector.collect(batch)
        self.observe_batch_max(m, collector)

    def observe_batch_max(self, m: int, collector) -> None:
        """Watermark state machine over one batch's max event-time value,
        shared by process_batch above and the compiled segment's host
        finisher (engine/segment.py), so the two paths cannot drift. Called
        AFTER the batch's rows are collected: the watermark must never
        overtake the data it covers."""
        self.last_event_wall = time.monotonic()
        self.idle_sent = False
        if self.max_watermark is None or m > self.max_watermark:
            self.max_watermark = m
            if self.last_emitted is None or m - self.last_emitted >= self.interval_micros:
                self.last_emitted = m
                collector.broadcast(Signal.watermark_of(Watermark.event_time(m)))

    def handle_watermark(self, watermark, ctx, collector):
        # upstream watermarks stop here; this operator emits its own
        return None


@register_operator(OpName.VALUE)
def _make_value(cfg: dict):
    return ValueOperator(cfg)


@register_operator(OpName.KEY)
def _make_key(cfg: dict):
    return KeyOperator(cfg)


@register_operator(OpName.UNNEST)
def _make_unnest(cfg: dict):
    return UnnestOperator(cfg)


@register_operator(OpName.WATERMARK)
def _make_watermark(cfg: dict):
    return WatermarkGenerator(cfg)
