"""Join operators (the port's copy of arroyo_tpu/operators/joins.py).

InstantJoin, the windowed stream-stream join:

Upstream operators stamp each row with its window start, so both inputs
arrive bucketed by exact timestamp; rows buffer per timestamp and the join
for bucket t executes when the merged watermark passes t. Vectorized hash
join on the routing-key column (both sides are keyed on the equi-join
columns, so equal keys share a hash).

Checkpoints (the JAX package's tables): at a barrier the in-flight closes
drain, then each side's buffered rows, in window order, become the
``"left"`` / ``"right"`` tables and the late-data boundary the ``"e"`` mark;
a restore buffers the rows again.

JoinWithExpiration, the updating non-windowed join: a symmetric hash join
over TTL'd side stores, emitting retract/append pairs so outer joins stay
consistent as matches appear and disappear; its cold rows spill to the
tiered annex (state/spill.py). LookupJoin enriches a stream against an
external keyed table through a connector's ``lookup(keys)`` with a TTL'd
cache. Both are host code in the JAX package, and so here: the updating
join probes with ``host_join_indices``.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from ..config import config
from ..engine.engine import register_operator
from ..expr import eval_expr
from ..graph import OpName
from ..ops.join_probe import device_join_start, fused_join_indices, host_join_indices
from ..types import Signal, Watermark
from .base import Operator, TableSpec, persist_mark, restore_marks
from .updating_aggregate import IS_RETRACT_FIELD


def _object_col(values) -> np.ndarray:
    """Object column from arbitrary python values in one shot (np.fromiter;
    the per-element assignment loop this replaces re-allocated and filled
    element-wise on every emitted batch of the wide-expansion path)."""
    vals = values if isinstance(values, (list, tuple)) else list(values)
    return np.fromiter(vals, dtype=object, count=len(vals))

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

    def tables(self):
        return [TableSpec("left", "expiring_time_key"),
                TableSpec("right", "expiring_time_key"),
                TableSpec("e", "global_keyed")]  # the late-data boundary

    def on_start(self, ctx):
        if ctx.table_manager is None:
            return
        for side, name in ((0, "left"), (1, "right")):
            tbl = ctx.table_manager.expiring_time_key(name)
            for b in tbl.all_batches():
                self._buffer(b, side)
            tbl.replace_all([])
        barriers = restore_marks(ctx, "e")
        if barriers:
            self.emitted_before = max(barriers)

    def handle_checkpoint(self, barrier, ctx, collector):
        # in-flight closes left self.buf: their rows go out before the
        # barrier rather than missing from the snapshot
        self._drain_pending(collector, force=True)
        for side, name in ((0, "left"), (1, "right")):
            # in window order, so that a restore's per-window lists (and so
            # the emission order) do not depend on buf's insertion history
            ctx.table_manager.expiring_time_key(name).replace_all(
                [b for t in sorted(self.buf) for b in self.buf[t][side]])
        persist_mark(ctx, "e", self.emitted_before)

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


class _SideStore:
    """Columnar buffer of one join side's live rows (amortized-growth
    arrays, dead rows masked then compacted): the vectorized probe target
    that replaced JoinWithExpiration's per-row dict-of-_StoredRow store."""

    __slots__ = ("n", "cap", "keys", "ts", "match_count", "null_emitted",
                 "alive", "vals", "n_dead")

    def __init__(self, n_vals: int, cap: int = 1024):
        self.n = 0
        self.cap = cap
        self.keys = np.empty(cap, dtype=np.int64)
        self.ts = np.empty(cap, dtype=np.int64)
        self.match_count = np.empty(cap, dtype=np.int64)
        self.null_emitted = np.empty(cap, dtype=bool)
        self.alive = np.zeros(cap, dtype=bool)
        self.vals = [np.empty(cap, dtype=object) for _ in range(n_vals)]
        self.n_dead = 0

    def _grow(self, need: int) -> None:
        cap = self.cap
        while cap < self.n + need:
            cap *= 2
        for name in ("keys", "ts", "match_count", "null_emitted", "alive"):
            old = getattr(self, name)
            new = (np.zeros(cap, dtype=old.dtype) if name == "alive"
                   else np.empty(cap, dtype=old.dtype))
            new[: self.n] = old[: self.n]
            setattr(self, name, new)
        for i, old in enumerate(self.vals):
            new = np.empty(cap, dtype=object)
            new[: self.n] = old[: self.n]
            self.vals[i] = new
        self.cap = cap

    def append(self, keys: np.ndarray, ts: np.ndarray, vals: list,
               match_count: np.ndarray, null_emitted) -> np.ndarray:
        k = len(keys)
        if self.n + k > self.cap:
            self._grow(k)
        lo, hi = self.n, self.n + k
        self.keys[lo:hi] = keys
        self.ts[lo:hi] = ts
        self.match_count[lo:hi] = match_count
        self.null_emitted[lo:hi] = null_emitted
        self.alive[lo:hi] = True
        for col, v in zip(self.vals, vals):
            col[lo:hi] = v
        self.n = hi
        return np.arange(lo, hi, dtype=np.int64)

    def live_ids(self) -> np.ndarray:
        return np.flatnonzero(self.alive[: self.n])

    def kill(self, ids) -> None:
        self.alive[ids] = False
        self.n_dead += np.size(ids) if not isinstance(ids, (int, np.integer)) else 1
        if self.n_dead > max(1024, self.n - self.n_dead):
            self.compact()

    def compact(self) -> None:
        keep = self.live_ids()
        m = len(keep)
        self.keys[:m] = self.keys[keep]
        self.ts[:m] = self.ts[keep]
        self.match_count[:m] = self.match_count[keep]
        self.null_emitted[:m] = self.null_emitted[keep]
        for col in self.vals:
            col[:m] = col[keep]
        self.alive[:m] = True
        self.alive[m: self.n] = False
        self.n = m
        self.n_dead = 0


class JoinWithExpiration(Operator):
    """Updating symmetric hash join (reference join_with_expiration.rs:29).

    config: join_type, left_names/right_names: [(out_name, src_name)],
    ttl_micros (buffer retention, default 1 day). Outputs an updating stream
    (_is_retract column); outer sides emit (row, nulls) immediately and
    retract it when a first match arrives.

    The buffering/probe hot path is columnar: appends probe the other
    side's _SideStore with the shared sort/search join (host_join_indices)
    and update match counts with one scatter-add; only retract rows — which
    must locate one stored row by full value equality — walk rows in
    Python, and they arrive rarely and in small numbers.
    """

    def __init__(self, cfg: dict):
        self.join_type: str = cfg.get("join_type", "inner")
        self.left_names: list[tuple[str, str]] = list(cfg["left_names"])
        self.right_names: list[tuple[str, str]] = list(cfg["right_names"])
        self.ttl = int(cfg.get("ttl_micros", 24 * 3600 * 1_000_000))
        self.stores: tuple[_SideStore, _SideStore] = (
            _SideStore(len(self.left_names)), _SideStore(len(self.right_names)))
        # TTL-expired buffered rows dropped from the side stores, exported
        # as arroyo_late_rows_total (counting only — expiry semantics are
        # unchanged)
        self.late_rows = 0  # state: ephemeral — observability counter (obs/profile.py export); never read into emitted data
        # tiered state (state/spill.py): cold side-store rows (oldest event
        # times) spill as bloom/zone-mapped runs; a probe that hits a
        # spilled key promotes its rows back into the live store first, so
        # the join logic itself never changes
        from ..state.spill import spill_enabled

        self._spill = spill_enabled()
        self._annexes = None  # (RowSpillAnnex, RowSpillAnnex) in on_start

    def tables(self):
        return [
            TableSpec("left", "expiring_time_key", retention_micros=self.ttl),
            TableSpec("right", "expiring_time_key", retention_micros=self.ttl),
            TableSpec("left__spill", "global_keyed"),
            TableSpec("right__spill", "global_keyed"),
        ]

    def _outer_for(self, side: int) -> bool:
        """Does `side` emit null-padded rows when unmatched?"""
        return self.join_type == "full" or self.join_type == (
            "left" if side == 0 else "right"
        )

    def state_sizes(self) -> dict[str, tuple[int, int]]:
        """Live rows + approximate bytes per side store (obs/profile.py
        state gauges): between barriers the host tables lag this columnar
        state, so the live view overrides them."""
        out: dict[str, tuple[int, int]] = {}
        for side, name in ((0, "left"), (1, "right")):
            store = self.stores[side]
            live = store.n - store.n_dead
            # keys/ts/match_count int64 lanes + two bool lanes + one object
            # pointer per value column (payload bytes live behind pointers;
            # the gauge is a floor, which is the safe direction for spill)
            per_row = 8 * (3 + len(store.vals)) + 2
            out[name] = (live, live * per_row)
        return out

    def _src_names(self, side: int) -> list[tuple[str, str]]:
        return self.left_names if side == 0 else self.right_names

    # ------------------------------------------------------------------

    def on_start(self, ctx):
        if self._spill:
            from ..state.spill import (RowSpillAnnex, SpillStats,
                                       restore_manifest)

            stats = SpillStats()  # one shared stats block for both sides
            self._annexes = tuple(
                RowSpillAnnex(ctx.task_info, ctx.table_manager.storage_url,
                              name, len(self._src_names(side)), stats)
                for side, name in ((0, "left"), (1, "right")))
            self._annexes[0].adopt(restore_manifest(ctx, "left__spill"))
            self._annexes[1].adopt(restore_manifest(ctx, "right__spill"))
        else:
            from ..state.spill import require_spill_for_manifest

            # spilled side-store rows exist only in run files: restoring
            # with spilling disabled must fail loudly, not silently drop
            # buffered join state
            require_spill_for_manifest(ctx, "left__spill")
            require_spill_for_manifest(ctx, "right__spill")
        for side, name in ((0, "left"), (1, "right")):
            tbl = ctx.table_manager.expiring_time_key(name, self.ttl)
            store = self.stores[side]
            srcs = [src for _o, src in self._src_names(side)]
            for b in tbl.all_batches():
                if b.num_rows == 0:
                    continue
                store.append(
                    b.keys.astype(np.uint64).view(np.int64),
                    b.timestamps,
                    [_object_col(np.asarray(b[s])) for s in srcs],
                    np.asarray(b["__match_count"], dtype=np.int64),
                    np.asarray(b["__null_emitted"], dtype=bool),
                )
            tbl.replace_all([])

    # ------------------------------------------------------------------

    def process_batch(self, batch, ctx, collector, input_index=0):
        side = ctx.edge_of_input(input_index)
        n = batch.num_rows
        keys = batch.keys.astype(np.uint64).view(np.int64)
        ts = batch.timestamps
        retracts = (
            np.asarray(batch[IS_RETRACT_FIELD], dtype=bool)
            if IS_RETRACT_FIELD in batch
            else None
        )
        if self._annexes is not None:
            # any spilled row this batch's keys could touch promotes back
            # into the live store FIRST (match counts and null pads mutate,
            # and runs are immutable), so the probe/retract logic below is
            # byte-identical to the fully-resident path
            self._promote(1 - side, keys)
            if retracts is not None and retracts.any():
                self._promote(side, keys[retracts])
        srcs = [src for _o, src in self._src_names(side)]
        src_cols = [np.asarray(batch[s]) for s in srcs]
        out: list[tuple] = []  # emission segments, in order
        if retracts is None or not retracts.any():
            self._append_run(side, keys, ts, src_cols, out)
        else:
            # preserve in-batch ordering: vectorize each contiguous run of
            # appends, walk retract rows one by one (they must locate one
            # stored row by exact value equality)
            edges = np.flatnonzero(np.diff(retracts)) + 1
            for lo, hi in zip(np.r_[0, edges], np.r_[edges, n]):
                lo, hi = int(lo), int(hi)
                if retracts[lo]:
                    for j in range(lo, hi):
                        self._retract_row(
                            side, int(keys[j]), int(ts[j]),
                            tuple(c[j] for c in src_cols), out)
                else:
                    self._append_run(side, keys[lo:hi], ts[lo:hi],
                                     [c[lo:hi] for c in src_cols], out)
        if out:
            self._emit(out, collector)

    def _promote(self, side: int, keys: np.ndarray) -> None:
        """Pull every alive spilled row of ``side`` whose key appears in
        ``keys`` back into the live store (bloom/zone pruned)."""
        annex = self._annexes[side]
        if not annex.has_runs() or not len(keys):
            return
        seg = annex.probe(keys)
        if seg is not None:
            k, t, mc, ne, vals = seg
            self.stores[side].append(k, t, vals, mc, ne)

    def spill_stats(self):
        """The side annexes' counters (arroyo_spill_* series; both sides
        share one stats block); None while spilling is off."""
        if self._annexes is None:
            return None
        stats = self._annexes[0].stats
        cold = sum(1 for a in self._annexes if a.has_runs())
        return {"bytes_total": stats.bytes_total, "hot": 2 - cold,
                "cold": cold, "probe_files": stats.probe_files}

    def _maybe_spill(self) -> None:
        """Budget enforcement across BOTH side stores: the globally oldest
        rows (event time, then side/position as the deterministic
        tie-break) spill first, down to the low-water mark."""
        from ..state.spill import SPILL_HEADROOM, spill_budget_bytes

        if self._annexes is None:
            return
        sizes = self.state_sizes()
        total = sum(b for _r, b in sizes.values())
        budget = spill_budget_bytes()
        if total <= budget:
            return
        target = budget * SPILL_HEADROOM
        parts = []
        for s in (0, 1):
            live = self.stores[s].live_ids()
            if len(live):
                parts.append((self.stores[s].ts[live],
                              np.full(len(live), s, dtype=np.int64), live))
        if not parts:
            return
        ts_all = np.concatenate([p[0] for p in parts])
        side_all = np.concatenate([p[1] for p in parts])
        ids_all = np.concatenate([p[2] for p in parts])
        per_row = max(8 * (3 + len(st.vals)) + 2 for st in self.stores)
        k = min(len(ts_all), int((total - target) / max(per_row, 1)) + 1)
        pick = np.lexsort((ids_all, side_all, ts_all))[:k]
        for s in (0, 1):
            sel = ids_all[pick[side_all[pick] == s]]
            if not len(sel):
                continue
            store = self.stores[s]
            ok = self._annexes[s].spill_rows(
                store.keys[sel], store.ts[sel], store.match_count[sel],
                store.null_emitted[sel], [c[sel] for c in store.vals])
            if ok:
                store.kill(sel)

    def _append_run(self, side: int, keys, ts, src_cols, out: list) -> None:
        """Vectorized append path: probe the other side once, scatter-add
        match counts, emit pairs/pads as columnar segments."""
        other = self.stores[1 - side]
        mine = self.stores[side]
        live = other.live_ids()
        if len(live):
            bi, oi = host_join_indices(keys, other.keys[live])
            oid = live[oi]
        else:
            bi = oid = np.empty(0, dtype=np.int64)
        counts = np.bincount(bi, minlength=len(keys)) if len(bi) else \
            np.zeros(len(keys), dtype=np.int64)
        new_ids = mine.append(keys, ts, src_cols, counts, False)
        if len(oid):
            # store rows seeing their FIRST match: retract their null pads.
            # pairs are ordered by probe row asc, so the first occurrence of
            # a store id carries the earliest matching row's timestamp
            uniq, first = np.unique(oid, return_index=True)
            newly = (other.match_count[uniq] == 0) & other.null_emitted[uniq]
            if newly.any():
                ids = uniq[newly]
                pad_ts = np.maximum(other.ts[ids], ts[bi[first[newly]]])
                out.append(self._pad_seg(1 - side,
                                         [c[ids] for c in other.vals],
                                         pad_ts, True))
                other.null_emitted[ids] = False
            np.add.at(other.match_count, oid, 1)
            pair_ts = np.maximum(other.ts[oid], ts[bi])
            out.append(self._pair_seg(side, [c[bi] for c in src_cols],
                                      [c[oid] for c in other.vals],
                                      pair_ts, False))
        if self._outer_for(side):
            unmatched = counts == 0
            if unmatched.any():
                out.append(self._pad_seg(side, [c[unmatched] for c in src_cols],
                                         ts[unmatched], False))
                mine.null_emitted[new_ids[unmatched]] = True

    def _retract_row(self, side: int, k: int, t: int, vals: tuple,
                     out: list) -> None:
        mine = self.stores[side]
        other = self.stores[1 - side]
        found = None
        for gid in np.flatnonzero(
                (mine.keys[: mine.n] == k) & mine.alive[: mine.n]).tolist():
            if all(v == mine.vals[i][gid] for i, v in enumerate(vals)):
                found = gid
                break
        if found is None:
            raise RuntimeError(
                "retract for a row never seen (updating join ordering violation)"
            )
        null_emitted = bool(mine.null_emitted[found])
        mine.kill(found)
        row_vals = [_object_col([v]) for v in vals]
        if null_emitted:
            out.append(self._pad_seg(side, row_vals,
                                     np.array([t], dtype=np.int64), True))
            return
        m = other.live_ids()
        m = m[other.keys[m] == k]
        if len(m):
            other.match_count[m] -= 1
            pair_ts = np.maximum(other.ts[m], t)
            out.append(self._pair_seg(
                side, [c.repeat(len(m)) for c in row_vals],
                [c[m] for c in other.vals], pair_ts, True))
            if self._outer_for(1 - side):
                renull = m[other.match_count[m] == 0]
                if len(renull):
                    out.append(self._pad_seg(
                        1 - side, [c[renull] for c in other.vals],
                        np.maximum(other.ts[renull], t), False))
                    other.null_emitted[renull] = True

    def _pair_seg(self, side, my_vals, other_vals, ts, retract):
        lv, rv = (my_vals, other_vals) if side == 0 else (other_vals, my_vals)
        return (lv, rv, ts, retract, len(ts))

    def _pad_seg(self, side, vals, ts, retract):
        lv, rv = (vals, None) if side == 0 else (None, vals)
        return (lv, rv, ts, retract, len(ts))

    def _emit(self, segments: list, collector) -> None:
        cols: dict[str, np.ndarray] = {}
        for i, (out_name, _src) in enumerate(self.left_names):
            cols[out_name] = np.concatenate(
                [lv[i] if lv is not None else _null_col(k)
                 for lv, _rv, _t, _r, k in segments])
        for i, (out_name, _src) in enumerate(self.right_names):
            cols[out_name] = np.concatenate(
                [rv[i] if rv is not None else _null_col(k)
                 for _lv, rv, _t, _r, k in segments])
        cols[IS_RETRACT_FIELD] = np.concatenate(
            [np.full(k, r) for _lv, _rv, _t, r, k in segments])
        cols[TIMESTAMP_FIELD] = np.concatenate(
            [np.asarray(t, dtype=np.int64) for _lv, _rv, t, _r, k in segments])
        collector.collect(Batch(cols))

    # ------------------------------------------------------------------

    def handle_watermark(self, watermark, ctx, collector):
        if watermark.is_idle:
            return watermark
        cutoff = watermark.value - self.ttl
        oldest = None
        for store in self.stores:
            live = store.live_ids()
            if not len(live):
                continue
            expired = live[store.ts[live] < cutoff]
            if len(expired):
                self.late_rows += len(expired)
                store.kill(expired)
                live = store.live_ids()
            if len(live):
                lo = int(store.ts[live].min())
                oldest = lo if oldest is None else min(oldest, lo)
        if self._annexes is not None:
            # spilled rows age out too (zone-map gated, whole-run drops when
            # possible), and alive cold rows hold the watermark exactly like
            # resident ones; the budget check runs here — off the per-batch
            # hot path, after expiry freed whatever it could
            for annex in self._annexes:
                self.late_rows += annex.expire(cutoff)
                lo = annex.oldest_ts()
                if lo is not None:
                    oldest = lo if oldest is None else min(oldest, lo)
            self._maybe_spill()
        # future emissions carry ts = max(sides) >= the oldest buffered row;
        # hold the watermark to that bound so downstream never sees late rows
        held = watermark.value if oldest is None else min(watermark.value, oldest)
        return Watermark.event_time(held)

    def handle_checkpoint(self, barrier, ctx, collector):
        if self._annexes is not None:
            from ..state.spill import checkpoint_manifest

            for a in self._annexes:
                a.epoch = barrier.epoch
            self._maybe_spill()
            # spilled runs checkpoint BY REFERENCE: the manifest (run list,
            # dead-row sets) rides the epoch; the files are never re-uploaded
            checkpoint_manifest(ctx, "left__spill", self._annexes[0])
            checkpoint_manifest(ctx, "right__spill", self._annexes[1])
        for side, name in ((0, "left"), (1, "right")):
            tbl = ctx.table_manager.expiring_time_key(name, self.ttl)
            store = self.stores[side]
            live = store.live_ids()
            if not len(live):
                tbl.replace_all([])
                continue
            srcs = [src for _o, src in self._src_names(side)]
            cols: dict[str, np.ndarray] = {
                TIMESTAMP_FIELD: store.ts[live].copy(),
                KEY_FIELD: store.keys[live].copy().view(np.uint64),
                "__match_count": store.match_count[live].copy(),
                "__null_emitted": store.null_emitted[live].copy(),
            }
            for i, s in enumerate(srcs):
                cols[s] = store.vals[i][live]
            tbl.replace_all([Batch(cols)])


class LookupJoin(Operator):
    """config: connector (object with lookup(keys)->dict, from the connector
    registry), key_exprs: [Expr] evaluated on the stream, right_names:
    [(out_name, field)] columns pulled from the looked-up row, join_type:
    inner|left, cache_ttl_micros, cache_max_size, max_concurrency.

    Async pipelined lookups (reference lookup_join.rs:35): cache misses are
    batched per input batch and dispatched to a bounded thread pool off the
    task thread; batches emit strictly in input order as their fetches land,
    and watermarks/barriers drain everything in flight first, so a slow
    lookup source overlaps N fetches instead of serializing the hot loop."""

    def __init__(self, cfg: dict):
        from collections import deque

        self.connector = cfg["connector"]
        self.key_exprs = list(cfg["key_exprs"])
        self.right_names: list[tuple[str, str]] = list(cfg["right_names"])
        self.join_type = cfg.get("join_type", "left")
        self.cache_ttl = int(cfg.get("cache_ttl_micros", 60_000_000))
        self.cache_max = int(cfg.get("cache_max_size", 100_000))
        self.max_concurrency = int(cfg.get("max_concurrency", 16))
        # key -> (row|None, wall_micros); checkpointed into table "c" and
        # restored, so a replayed batch that still hits the cache resolves
        # to the value the original run emitted. The TTL stays WALL-clock:
        # entries whose TTL elapsed during recovery downtime re-fetch (and
        # may see fresher external rows) — a lookup join is only as
        # replay-stable as its cache is fresh, by design
        self.cache: dict = {}
        self._pool = None
        # FIFO of ("batch", batch, keys, resolved, missing, fut, borrowed)
        # and ("wm", Watermark) markers: strictly ordered emission
        self._pending = deque()  # state: ephemeral — drained (block=True) at every barrier before the snapshot
        # key -> in-flight Future: concurrent batches borrow a pending
        # fetch instead of re-asking the source for the same key
        self._inflight: dict = {}  # state: ephemeral — emptied by the blocking barrier drain; every future resolves with its batch

    def tables(self):
        return [TableSpec("c", "global_keyed")]

    def on_start(self, ctx):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=self.max_concurrency, thread_name_prefix="lookup-join")
        saved = ctx.table_manager.global_keyed("c").get(
            ctx.task_info.subtask_index)
        if saved and not self.cache:
            # `not self.cache` guards the lazy on_start re-call in
            # process_batch from clobbering the live cache mid-run
            self.cache = {k: tuple(v) for k, v in saved}

    def process_batch(self, batch, ctx, collector, input_index=0):
        n = batch.num_rows
        key_cols = [
            np.asarray(eval_expr(e, batch.columns, n)) for e in self.key_exprs
        ]
        keys = [
            tuple(c[i] for c in key_cols) if len(key_cols) > 1 else key_cols[0][i]
            for i in range(n)
        ]
        now = int(_time.time() * 1e6)  # lint: waive LR109 — lookup-cache TTL wall clock, not self-measurement
        # resolve hits AT SUBMIT TIME: deferred emission must not depend on
        # cache entries that a later eviction sweep could remove
        resolved: dict = {}
        missing: list = []
        borrowed: dict = {}
        # lint: waive LR204 — populates lookup maps only; emitted rows are ordered by the batch's own key list, and the missing-list order is an external-call detail
        for k in set(keys):
            ent = self.cache.get(k)
            if ent is not None and now - ent[1] <= self.cache_ttl:
                resolved[k] = ent[0]
            elif k in self._inflight:
                borrowed[k] = self._inflight[k]
            else:
                missing.append(k)
        fut = None
        if missing:
            if self._pool is None:
                self.on_start(ctx)
            fut = self._pool.submit(self.connector.lookup, missing)
            for k in missing:
                self._inflight[k] = fut
        self._pending.append(("batch", batch, keys, resolved, missing, fut, borrowed))
        self._drain(collector, block=False)
        # backpressure: bound in-flight batches so a stalled source cannot
        # queue unbounded memory behind the pool
        while sum(1 for e in self._pending if e[0] == "batch") > 2 * self.max_concurrency:
            self._emit_head(collector)

    def _head_ready(self) -> bool:
        e = self._pending[0]
        if e[0] == "wm":
            return True
        fut, borrowed = e[5], e[6]
        if fut is not None and not fut.done():
            return False
        return all(f.done() for f in borrowed.values())

    def _drain(self, collector, block: bool) -> None:
        while self._pending:
            if not block and not self._head_ready():
                return
            self._emit_head(collector)

    def _emit_head(self, collector) -> None:
        entry = self._pending.popleft()
        if entry[0] == "wm":
            collector.broadcast(Signal.watermark_of(entry[1]))
            return
        _tag, batch, keys, resolved, missing, fut, borrowed = entry
        now = int(_time.time() * 1e6)  # lint: waive LR109 — lookup-cache TTL wall clock, not self-measurement
        val_of = dict(resolved)
        if fut is not None:
            fetched = fut.result()
            for k in missing:
                val_of[k] = fetched.get(k)
                self.cache[k] = (fetched.get(k), now)
                if self._inflight.get(k) is fut:
                    del self._inflight[k]
        # lint: waive LR204 — fills the val_of lookup map; row order comes from the batch's key list below
        for k, bf in borrowed.items():
            val_of[k] = bf.result().get(k)
        rows = [val_of[k] for k in keys]
        if len(self.cache) > self.cache_max:
            # evict oldest entries — after gathering, so this batch's keys
            # cannot be evicted before they are read
            # key-repr tie-break: same-wall entries must evict identically
            # on replay (dict order diverges after a restore)
            by_age = sorted(self.cache.items(),
                            key=lambda kv: (kv[1][1], str(kv[0])))
            for k, _ in by_age[: len(self.cache) - self.cache_max]:
                del self.cache[k]
        n = batch.num_rows
        present = np.array([r is not None for r in rows], dtype=bool)
        if self.join_type == "inner" and not present.all():
            batch = batch.filter(present)
            rows = [r for r, p in zip(rows, present) if p]
            present = present[present]
            n = batch.num_rows
            if n == 0:
                return
        cols = dict(batch.columns)
        for out_name, field in self.right_names:
            vals = [r.get(field) if r is not None else None for r in rows]
            sample = next((v for v in vals if v is not None), None)
            if isinstance(sample, (str, type(None))) or not present.all():
                cols[out_name] = _object_col(vals)
            else:
                cols[out_name] = np.array(vals)
        collector.collect(Batch(cols))

    def handle_watermark(self, watermark, ctx, collector):
        # watermark-held ordered emission WITHOUT stalling the pipeline:
        # the watermark queues behind its preceding batches and broadcasts
        # as the queue drains (same shape as TumblingAggregate's pending
        # queue) — blocking here would cap lookup overlap at one batch,
        # since upstream emits a watermark after nearly every batch
        self._drain(collector, block=False)
        if not self._pending:
            return watermark
        self._pending.append(("wm", watermark))
        return None

    def handle_checkpoint(self, barrier, ctx, collector):
        self._drain(collector, block=True)
        # snapshot the cache (sorted by key repr: deterministic file bytes);
        # nothing is in flight after the blocking drain
        ctx.table_manager.global_keyed("c").insert(
            ctx.task_info.subtask_index,
            sorted(self.cache.items(), key=lambda kv: str(kv[0])))

    def on_close(self, ctx, collector):
        self._drain(collector, block=True)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


@register_operator(OpName.JOIN_WITH_EXPIRATION)
def _make_expiring(cfg: dict):
    return JoinWithExpiration(cfg)


@register_operator(OpName.LOOKUP_JOIN)
def _make_lookup(cfg: dict):
    return LookupJoin(cfg)
