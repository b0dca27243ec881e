"""SQL window-function (OVER clause) operator (the port's copy of
arroyo_tpu/operators/window_fn.py; host code in both packages).

Rows buffer per event-time bucket (upstream windowed operators stamp the window
start); when the watermark passes a bucket, rows are partitioned and sorted
and the window-function plan runs, emitting the input columns plus the
computed function columns.

Supported functions: row_number, rank, dense_rank, plus unbounded-partition
aggregates (sum/count/min/max/avg). Everything is vectorized: one lexsort per
bucket, segment boundaries via flatnonzero, per-partition reductions via
reduceat broadcast back with repeat.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, object_column
from ..engine.engine import register_operator
from ..expr import Expr, eval_expr
from ..graph import OpName
from ..hashing import hash_columns
from .base import Operator, TableSpec, persist_mark, restore_marks


def _is_na(v) -> bool:
    """A null as pandas.factorize counts one in an object column: None, or
    a float NaN (numpy's included)."""
    return v is None or (isinstance(v, float) and v != v)


def _factorize(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """pandas.factorize of an object column with ``use_na_sentinel``: codes
    in order of first appearance (values equal under Python's ``==`` and
    hash share one), -1 for a null, and the uniques in that order."""
    code_of: dict = {}
    codes = np.empty(len(col), dtype=np.int64)
    for i, v in enumerate(col.tolist()):
        if _is_na(v):
            codes[i] = -1
            continue
        c = code_of.get(v)
        if c is None:
            c = code_of[v] = len(code_of)
        codes[i] = c
    return codes, object_column(list(code_of))


def _sortable(col: np.ndarray, desc: bool) -> np.ndarray:
    """Map a column to an ascending-sortable numeric key. Descending order
    negates a rank transform for everything but floats — negating raw
    unsigned columns wraps (0 would sort first) and int64 min overflows."""
    if col.dtype == object:
        codes, uniques = _factorize(col)
        order = np.argsort(uniques, kind="stable")
        rank_of = np.empty(len(uniques) + 1, dtype=np.int64)
        rank_of[order] = np.arange(len(uniques))
        rank_of[-1] = -1  # None sorts first
        key = rank_of[codes]
    elif col.dtype == np.bool_:
        key = col.astype(np.int64)
    elif col.dtype.kind in "iu":
        _u, key = np.unique(col, return_inverse=True)
        key = key.astype(np.int64)
    else:
        key = col
    return -key if desc else key


class WindowFunctionOperator(Operator):
    """config: partition_fields: [str], order_by: [(Expr, asc_bool)],
    functions: [(out_name, kind, Expr|None)], retain_fields: [str]|None
    (input columns to carry through; default all)."""

    def __init__(self, cfg: dict):
        self.partition_fields: list[str] = list(cfg.get("partition_fields", ()))
        self.order_by: list[tuple[Expr, bool]] = list(cfg.get("order_by", ()))
        self.functions: list[tuple[str, str, Optional[Expr]]] = list(cfg["functions"])
        self.retain_fields = cfg.get("retain_fields")
        self.buf: dict[int, list[Batch]] = {}
        self.emitted_before: Optional[int] = None
        self.late_rows = 0  # state: ephemeral — observability counter (obs/profile.py export); never read into emitted data

    def tables(self):
        return [
            TableSpec("input", "expiring_time_key"),
            TableSpec("e", "global_keyed"),  # late-data barrier
        ]

    def on_start(self, ctx):
        tbl = ctx.table_manager.expiring_time_key("input")
        for b in tbl.all_batches():
            self._buffer(b)
        tbl.replace_all([])
        barriers = restore_marks(ctx, "e")
        if barriers:
            self.emitted_before = max(barriers)

    def _buffer(self, batch: Batch) -> None:
        ts = batch.timestamps
        uniq = np.unique(ts)
        for t in uniq.tolist():
            if len(uniq) == 1:
                self.buf.setdefault(int(t), []).append(batch)
            else:
                self.buf.setdefault(int(t), []).append(batch.filter(ts == t))

    def process_batch(self, batch, ctx, collector, input_index=0):
        if self.emitted_before is not None:
            late = batch.timestamps < self.emitted_before
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return
                batch = batch.filter(~late)
        self._buffer(batch)

    def handle_watermark(self, watermark, ctx, collector):
        if not watermark.is_idle:
            self._emit_closed(watermark.value, collector)
        return watermark

    def on_close(self, ctx, collector):
        self._emit_closed(None, collector)

    def _emit_closed(self, before: Optional[int], collector) -> None:
        for t in sorted(k for k in self.buf if before is None or k < before):
            batches = self.buf.pop(t)
            self._compute_and_emit(Batch.concat(batches), collector)
        if before is not None and (
            self.emitted_before is None or before > self.emitted_before
        ):
            self.emitted_before = before

    def _compute_and_emit(self, b: Batch, collector) -> None:
        n = b.num_rows
        if n == 0:
            return
        # sort: partition hash first, then order-by keys
        sort_keys: list[np.ndarray] = []
        for e, asc in reversed(self.order_by):
            col = np.asarray(eval_expr(e, b.columns, n))
            sort_keys.append(_sortable(col, not asc))
        if self.partition_fields:
            part = hash_columns([np.asarray(b[f]) for f in self.partition_fields])
            part_signed = part.view(np.int64)
        else:
            part_signed = np.zeros(n, dtype=np.int64)
        sort_keys.append(part_signed)
        order = np.lexsort(tuple(sort_keys))
        sb = b.take(order)
        p_s = part_signed[order]
        brk = np.ones(n, dtype=bool)
        brk[1:] = p_s[1:] != p_s[:-1]
        starts = np.flatnonzero(brk)
        counts = np.diff(np.append(starts, n))
        part_start = np.repeat(starts, counts)  # per-row partition start idx
        pos = np.arange(n)
        # order-key change points (for rank/dense_rank ties) — reuse the
        # already-built sort keys, permuted into sorted order
        if self.order_by:
            obrk = brk.copy()
            for k in sort_keys[:-1]:  # all but the partition key
                k_sorted = k[order]
                obrk[1:] |= k_sorted[1:] != k_sorted[:-1]
        else:
            obrk = brk
        cols = dict(sb.columns)
        if self.retain_fields is not None:
            keep = set(self.retain_fields) | {TIMESTAMP_FIELD}
            if KEY_FIELD in cols:
                keep.add(KEY_FIELD)
            cols = {k: v for k, v in cols.items() if k in keep}
        for out_name, kind, e in self.functions:
            if kind == "row_number":
                cols[out_name] = pos - part_start + 1
            elif kind == "rank":
                # index of the first row of the tie-group, relative to partition
                tie_start = pos[obrk]
                cols[out_name] = np.repeat(tie_start, np.diff(np.append(np.flatnonzero(obrk), n))) - part_start + 1
            elif kind == "dense_rank":
                new_in_part = np.cumsum(obrk) - 1
                first_of_part = (np.cumsum(obrk) - 1)[part_start]
                cols[out_name] = new_in_part - first_of_part + 1
            elif kind in ("sum", "count", "min", "max", "avg"):
                if kind == "count" or e is None:
                    vals = np.ones(n, dtype=np.int64)
                else:
                    vals = np.asarray(eval_expr(e, sb.columns, n))
                if kind in ("sum", "count"):
                    red = np.add.reduceat(vals, starts)
                elif kind == "min":
                    red = np.minimum.reduceat(vals, starts)
                elif kind == "max":
                    red = np.maximum.reduceat(vals, starts)
                else:
                    s = np.add.reduceat(vals.astype(np.float64), starts)
                    red = s / counts
                cols[out_name] = np.repeat(red, counts)
            else:
                raise NotImplementedError(f"window function {kind}")
        collector.collect(Batch(cols))

    def handle_checkpoint(self, barrier, ctx, collector):
        tbl = ctx.table_manager.expiring_time_key("input")
        tbl.replace_all([b for lst in self.buf.values() for b in lst])
        persist_mark(ctx, "e", self.emitted_before)


@register_operator(OpName.WINDOW_FUNCTION)
def _make_window_fn(cfg: dict):
    return WindowFunctionOperator(cfg)
