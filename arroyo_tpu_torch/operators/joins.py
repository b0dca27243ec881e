"""Windowed stream-stream join (the port's copy of InstantJoin from
arroyo_tpu/operators/joins.py).

Upstream operators stamp each row with its window start, so both inputs
arrive bucketed by exact timestamp; rows buffer per timestamp and the join
for bucket t executes when the merged watermark passes t. Vectorized hash
join on the routing-key column (both sides are keyed on the equi-join
columns, so equal keys share a hash).

The updating join (JoinWithExpiration) and the lookup join have no device
kernel and are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from ..config import config
from ..engine.engine import register_operator
from ..graph import OpName
from ..ops.join_probe import device_join_start, fused_join_indices, host_join_indices
from ..types import Signal
from .base import Operator

_null_cache = np.empty(0, dtype=object)


def _null_col(n: int) -> np.ndarray:
    """All-None object column, served as a view of one shared buffer and
    reused across ``_emit`` calls (emitted columns are never mutated in
    place downstream — filter/take/concat all copy)."""
    global _null_cache
    if len(_null_cache) < n:
        _null_cache = np.empty(max(n, 2 * len(_null_cache), 1024), dtype=object)
    return _null_cache[:n]


def _host_probe(ctx) -> bool:
    """True when the device join would run on the host CPU: there a device
    dispatch costs more than the numpy probe it replaces, so the join stays
    on numpy unless ``device.force-device-join`` forces the device path
    (tests). The reference asks whether JAX's backend is the CPU; the port
    asks whether the engine's torch device is, so the same closes take the
    fused host path on a CPU in both packages."""
    if config().get("device.force-device-join"):
        return False
    return ctx.device.type == "cpu"


class InstantJoin(Operator):
    """config: join_type: inner|left|right|full, left_names/right_names:
    [(out_name, src_name)] column selections per side, backend override
    "jax"|"numpy"|None (default: device when enabled). Graph configs are
    shared with the JAX package, so the port keeps its backend names:
    "jax" means the device path (K5/K6 on the card), "numpy" the host probe.

    Device lowering: the sort/search phase of each window's join runs on
    the device (ops/join_probe.py) and its result streams back while later
    batches keep flowing — closes queue in order and each watermark is
    forwarded only after its windows' rows, the same pipelining discipline
    as the window aggregates."""

    def __init__(self, cfg: dict):
        self.join_type: str = cfg.get("join_type", "inner")
        self.left_names: list[tuple[str, str]] = list(cfg["left_names"])
        self.right_names: list[tuple[str, str]] = list(cfg["right_names"])
        self.backend = cfg.get("backend") or (
            "jax" if config().get("device.enabled") else "numpy"
        )
        # below this many rows on either side, the numpy join is cheaper
        # than a device dispatch
        self.device_min_rows = int(config().get("device.join-min-rows", 2048))
        # t -> [left batches], [right batches]
        self.buf: dict[int, tuple[list, list]] = {}
        self.late_rows = 0
        self.emitted_before: Optional[int] = None
        # in-flight closes: (JoinHandle|None, t, lb, rb, Watermark|None)
        self._pending: deque = deque()

    def _buffer(self, batch: Batch, side: int) -> None:
        """One split per incoming batch: the per-unique-timestamp
        ``filter(ts == t)`` this replaces rescanned the full column once per
        window (O(uniq*n)). Upstream window stamping emits time-ordered
        batches, so the common case needs no sort at all — per-timestamp
        runs are already contiguous and stored as zero-copy slices; only a
        genuinely unordered batch pays one stable argsort."""
        ts = batch.timestamps
        n = len(ts)
        if n == 0:
            return
        d = np.diff(ts)
        if len(d) == 0 or not (d < 0).any():
            sorted_b, sts = batch, ts
        else:
            order = np.argsort(ts, kind="stable")
            sorted_b = batch.take(order)
            sts = ts[order]
            d = np.diff(sts)
        if n == 1 or not (d > 0).any():
            self.buf.setdefault(int(sts[0]), ([], []))[side].append(sorted_b)
            return
        bounds = np.concatenate(([0], np.flatnonzero(d > 0) + 1, [n]))
        for i in range(len(bounds) - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            ent = self.buf.setdefault(int(sts[lo]), ([], []))
            piece = sorted_b.slice(lo, hi)
            if 4 * (hi - lo) <= n:
                # a small view would pin the whole parent batch's columns
                # until this window closes; materialize it instead
                piece = Batch({k: v.copy() for k, v in piece.columns.items()})
            ent[side].append(piece)

    def process_batch(self, batch, ctx, collector, input_index=0):
        if self._pending:
            self._drain_pending(collector)
        side = ctx.edge_of_input(input_index)
        if self.emitted_before is not None:
            late = batch.timestamps < self.emitted_before
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return
                batch = batch.filter(~late)
        self._buffer(batch, side)

    def handle_watermark(self, watermark, ctx, collector):
        if watermark.is_idle:
            self._drain_pending(collector, force=True)
            return watermark
        scheduled = self._schedule_closed(watermark.value, watermark, collector, ctx)
        self._drain_pending(collector)
        if scheduled or self._pending:
            return None  # watermark rides the pending queue, in order
        return watermark

    def on_close(self, ctx, collector):
        self._schedule_closed(None, None, collector, ctx)
        self._drain_pending(collector, force=True)

    def _schedule_closed(self, before: Optional[int], wm, collector, ctx) -> bool:
        """Queue the join for every window closed by the watermark; the
        watermark marker is appended after its windows so emission order is
        preserved. Returns True when anything was queued.

        When one watermark closes SEVERAL buffered windows (catch-up after a
        gap, end-of-stream), the per-window pipeline would emit N tiny
        batches each paying full collector/queue overhead; the fused path
        concatenates the sides, probes once partitioned by window, and emits
        one coalesced batch per match category instead."""
        ts_list = sorted(t for t in self.buf if before is None or t < before)
        if len(ts_list) > 1 and (self.backend != "jax" or _host_probe(ctx)):
            # host-probe backends only: on a real accelerator the per-window
            # pipelined device closes below stay in charge (their async
            # dispatch hides probe latency, and the collector's coalescing
            # still merges the small per-window output batches), so fusing
            # must not silently demote the heaviest closes to the host.
            # Earlier in-flight closes (and their held watermarks) must
            # drain first so emission order is preserved.
            self._drain_pending(collector, force=True)
            self._fused_close(ts_list, collector)
            if before is not None and (
                self.emitted_before is None or before > self.emitted_before
            ):
                self.emitted_before = before
            return False  # rows already emitted; the watermark may forward
        for t in ts_list:
            left, right = self.buf.pop(t)
            while len(self._pending) >= 16:  # bound in-flight joins
                handle, pt, lb, rb, pwm = self._pending.popleft()
                if pwm is not None:
                    collector.broadcast(Signal.watermark_of(pwm))
                else:
                    self._join_and_emit(pt, lb, rb, handle, collector)
            self._pending.append(self._start_join(t, left, right, ctx))
        if before is not None and (
            self.emitted_before is None or before > self.emitted_before
        ):
            self.emitted_before = before
        if wm is not None:
            if self._pending or ts_list:
                self._pending.append((None, None, None, None, wm))
                return True
            return False
        return bool(ts_list)

    def _start_join(self, t: int, left: list, right: list, ctx):
        lb = Batch.concat(left) if left else None
        rb = Batch.concat(right) if right else None
        handle = None
        if lb is not None and rb is not None:
            n = max(lb.num_rows, rb.num_rows)
            if (self.backend == "jax" and n >= self.device_min_rows
                    and not _host_probe(ctx)):
                lk = lb.keys.astype(np.uint64).view(np.int64)
                rk = rb.keys.astype(np.uint64).view(np.int64)
                handle = device_join_start(lk, rk, ctx.device)
        return (handle, t, lb, rb, None)

    def _fused_close(self, ts_list: list, collector) -> None:
        """Close every window in ts_list as ONE join: single probe over the
        concatenated sides partitioned by window, one output batch per match
        category (inner pairs / left pads / right pads) instead of N
        per-window emits. Rows carry their own window timestamps, so the
        emitted groups are identical to per-window closes."""
        jt = self.join_type
        lbs: dict[int, Batch] = {}
        rbs: dict[int, Batch] = {}
        for t in ts_list:
            left, right = self.buf.pop(t)
            if left:
                lbs[t] = Batch.concat(left)
            if right:
                rbs[t] = Batch.concat(right)
        both = [t for t in ts_list if t in lbs and t in rbs]
        if both:
            lb = Batch.concat([lbs[t] for t in both])
            rb = Batch.concat([rbs[t] for t in both])
            l_bounds = np.cumsum([0] + [lbs[t].num_rows for t in both])
            r_bounds = np.cumsum([0] + [rbs[t].num_rows for t in both])
            lk = lb.keys.astype(np.uint64).view(np.int64)
            rk = rb.keys.astype(np.uint64).view(np.int64)
            li, ri = fused_join_indices(lk, rk, l_bounds, r_bounds)
            if len(li):
                self._emit(None, lb, rb, li, ri, collector)
            if jt in ("left", "full"):
                unmatched = np.ones(lb.num_rows, dtype=bool)
                unmatched[li] = False
                if unmatched.any():
                    self._emit(None, lb.filter(unmatched), None, None, None, collector)
            if jt in ("right", "full"):
                unmatched = np.ones(rb.num_rows, dtype=bool)
                unmatched[ri] = False
                if unmatched.any():
                    self._emit(None, None, rb.filter(unmatched), None, None, collector)
        if jt in ("left", "full"):
            lonely = [t for t in ts_list if t in lbs and t not in rbs]
            if lonely:
                self._emit(None, Batch.concat([lbs[t] for t in lonely]),
                           None, None, None, collector)
        if jt in ("right", "full"):
            lonely = [t for t in ts_list if t in rbs and t not in lbs]
            if lonely:
                self._emit(None, None, Batch.concat([rbs[t] for t in lonely]),
                           None, None, collector)

    def _drain_pending(self, collector, force: bool = False) -> None:
        while self._pending:
            handle, t, lb, rb, wm = self._pending[0]
            if wm is None and handle is not None and not force and not handle.is_ready():
                return
            self._pending.popleft()
            if wm is not None:
                collector.broadcast(Signal.watermark_of(wm))
                continue
            self._join_and_emit(t, lb, rb, handle, collector)

    def _join_and_emit(self, t: int, lb, rb, handle, collector) -> None:
        jt = self.join_type
        if lb is None and rb is None:
            return
        if lb is None:
            if jt in ("right", "full"):
                self._emit(t, None, rb, None, None, collector)
            return
        if rb is None:
            if jt in ("left", "full"):
                self._emit(t, lb, None, None, None, collector)
            return
        if handle is not None:
            li, ri = handle.result()
        else:
            lk = lb.keys.astype(np.uint64).view(np.int64)
            rk = rb.keys.astype(np.uint64).view(np.int64)
            li, ri = host_join_indices(lk, rk)
        if len(li):
            self._emit(t, lb, rb, li, ri, collector)
        if jt in ("left", "full"):
            unmatched = np.ones(lb.num_rows, dtype=bool)
            unmatched[li] = False
            if unmatched.any():
                self._emit(t, lb.filter(unmatched), None, None, None, collector)
        if jt in ("right", "full"):
            unmatched = np.ones(rb.num_rows, dtype=bool)
            unmatched[ri] = False
            if unmatched.any():
                self._emit(t, None, rb.filter(unmatched), None, None, collector)

    def _emit(self, t, lb, rb, li, ri, collector) -> None:
        """One output batch. With index arrays (matched-pair path) only the
        PROJECTED columns are gathered — Batch.take would copy every column
        including internals, doubling the close cost of a wide expansion.
        ``t``: the window start, or None for the fused multi-window path
        where each row carries its own window timestamp already."""
        if li is not None:
            n = len(li)
        else:
            n = lb.num_rows if lb is not None else rb.num_rows
        cols: dict[str, np.ndarray] = {}
        for out_name, src in self.left_names:
            if lb is None:
                cols[out_name] = _null_col(n)
            else:
                col = np.asarray(lb[src])
                cols[out_name] = col[li] if li is not None else col
        for out_name, src in self.right_names:
            if rb is None:
                cols[out_name] = _null_col(n)
            else:
                col = np.asarray(rb[src])
                cols[out_name] = col[ri] if ri is not None else col
        if t is not None:
            cols[TIMESTAMP_FIELD] = np.full(n, t, dtype=np.int64)
        else:
            src_ts = (lb if lb is not None else rb).timestamps
            cols[TIMESTAMP_FIELD] = (
                src_ts[li] if (lb is not None and li is not None) else src_ts)
        src_keys = lb if lb is not None else rb
        if KEY_FIELD in src_keys:
            k = np.asarray(src_keys.keys)
            cols[KEY_FIELD] = k[li] if (lb is not None and li is not None) else k
        collector.collect(Batch(cols))


@register_operator(OpName.INSTANT_JOIN)
def _make_instant(cfg: dict):
    return InstantJoin(cfg)
