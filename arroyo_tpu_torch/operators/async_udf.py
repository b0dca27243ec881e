"""Async UDF operator: bounded-concurrency out-of-band compute (the port's
copy of arroyo_tpu/operators/async_udf.py; host code in both packages).

Ordered or unordered in-flight UDF calls with a max concurrency and
watermark-held emission. Calls run on a thread pool; barriers and
watermarks drain the in-flight set first, which subsumes persisting it — the
snapshot is taken with nothing in flight, exactly one row per input emitted.
"""

from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, Field
from ..engine.engine import register_operator
from ..expr import Expr, eval_expr
from ..graph import OpName
from .base import Operator
from ..types import Watermark


class AsyncUdfOperator(Operator):
    """config: name, fn (callable), arg_exprs: [Expr], out_name,
    return_dtype, ordered: bool, max_concurrency, timeout_s,
    retain_fields: [str] | None (input columns carried through)."""

    def __init__(self, cfg: dict):
        self.name_ = str(cfg.get("name", "async_udf"))
        self.fn = cfg["fn"]
        self.arg_exprs: list[Expr] = list(cfg["arg_exprs"])
        self.out_name = str(cfg.get("out_name", self.name_))
        self.return_dtype = str(cfg.get("return_dtype", "float64"))
        self.ordered = bool(cfg.get("ordered", True))
        self.max_concurrency = int(cfg.get("max_concurrency", 64))
        self.timeout_s = float(cfg.get("timeout_s", 30.0))
        self.retain_fields = cfg.get("retain_fields")
        self._pool: Optional[ThreadPoolExecutor] = None
        # (seq, carried_row_cols, future); seq preserves input order
        self._in_flight: list[tuple[int, dict, Future]] = []
        self._seq = 0  # state: ephemeral — orders in-flight calls within one incarnation; the in-flight set drains at every barrier

    def name(self) -> str:
        return f"async:{self.name_}"

    def on_start(self, ctx):
        self._pool = ThreadPoolExecutor(
            max_workers=min(self.max_concurrency, 64),
            thread_name_prefix=f"audf-{self.name_}",
        )

    def process_batch(self, batch, ctx, collector, input_index=0):
        n = batch.num_rows
        args_cols = [np.asarray(eval_expr(e, batch.columns, n)) for e in self.arg_exprs]
        keep = self.retain_fields
        if keep is None:
            keep = [c for c in batch.columns if c != KEY_FIELD]
        for i in range(n):
            while len(self._in_flight) >= self.max_concurrency:
                self._emit_some(collector, block=True)
            carried = {c: batch.columns[c][i] for c in keep}
            args = tuple(a[i] for a in args_cols)
            fut = self._pool.submit(self.fn, *args)
            self._in_flight.append((self._seq, carried, fut))
            self._seq += 1
        self._emit_some(collector, block=False)

    # ------------------------------------------------------------------

    def _emit_some(self, collector, block: bool) -> None:
        if not self._in_flight:
            return
        if self.ordered:
            ready: list[tuple[int, dict, Future]] = []
            while self._in_flight and (
                self._in_flight[0][2].done() or (block and not ready)
            ):
                seq, carried, fut = self._in_flight[0]
                fut.result(timeout=self.timeout_s if block else None)
                ready.append(self._in_flight.pop(0))
                block = False  # only force the head
            self._emit_rows(ready, collector)
        else:
            if block:
                wait([f for _s, _c, f in self._in_flight],
                     timeout=self.timeout_s, return_when=FIRST_COMPLETED)
            done = [t for t in self._in_flight if t[2].done()]
            if not done and block:
                # nothing completed within timeout_s: fail like the ordered
                # path does, instead of letting callers spin forever
                raise TimeoutError(
                    f"async UDF {self.name_}: no call completed within "
                    f"{self.timeout_s}s ({len(self._in_flight)} in flight)"
                )
            if done:
                self._in_flight = [t for t in self._in_flight if not t[2].done()]
                self._emit_rows(done, collector)

    def _drain(self, collector) -> None:
        while self._in_flight:
            self._emit_some(collector, block=True)

    def _emit_rows(self, items: list, collector) -> None:
        if not items:
            return
        cols: dict[str, list] = {}
        for _seq, carried, fut in items:
            result = fut.result(timeout=self.timeout_s)
            # lint: waive LR204 — carried is a per-row dict built in process_batch's column order; identical construction on replay
            for k, v in carried.items():
                cols.setdefault(k, []).append(v)
            cols.setdefault(self.out_name, []).append(result)
        out: dict[str, np.ndarray] = {}
        for k, vals in cols.items():
            if k == self.out_name:
                dt = Field("_", self.return_dtype).numpy_dtype()
                out[k] = np.array(vals, dtype=dt)
            else:
                sample = vals[0]
                if isinstance(sample, (str, bytes, type(None))):
                    out[k] = np.array(vals, dtype=object)
                else:
                    out[k] = np.array(vals)
        if TIMESTAMP_FIELD not in out:
            out[TIMESTAMP_FIELD] = np.zeros(len(items), dtype=np.int64)
        collector.collect(Batch(out))

    # ------------------------------------------------------------------

    def handle_watermark(self, watermark: Watermark, ctx, collector):
        # results for rows behind the watermark must be emitted before it
        self._drain(collector)
        return watermark

    def handle_checkpoint(self, barrier, ctx, collector):
        # snapshot with an empty in-flight set: every accepted row's result
        # is downstream of (and thus covered by) this barrier
        self._drain(collector)

    def on_close(self, ctx, collector):
        self._drain(collector)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


@register_operator(OpName.ASYNC_UDF)
def _make_async_udf(cfg: dict):
    return AsyncUdfOperator(cfg)
