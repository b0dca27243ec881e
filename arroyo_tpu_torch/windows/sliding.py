"""Sliding (hop) window aggregate operator (the port's copy of
arroyo_tpu/windows/sliding.py).

Rows are binned by the *slide*; per-bin partial aggregates live in the
same store the tumbling operator builds (bin = slide index), on the backend
it picks (the config's ``backend``, else "jax" when ``device.enabled``):

- "jax": a SlotAggregator on the engine's torch device. Once the watermark
  passes a bin's end, the bin is read off the device exactly once,
  destructively (``extract_start`` over that one bin: the region read and
  clear kernels), on the prefetch threads; a window is emitted when all its
  ``width / slide`` bins are resolved, by a host combine-by-key of the
  cached per-bin partials. Mesh mode (``device.mesh-devices`` > 1):
  per-bin partials in a ShardedAggregator, each bin's extraction one
  synchronous sharded close; the fused mesh step of the compiled segment
  calls ``mesh_insert_begin`` for the host half.
- "numpy": the host dict store, read synchronously: each closing window is
  one ``scan_range`` of its bins, combined by key, and the bins behind the
  next window are freed.

The output timestamp is the window start. Not in this slice: checkpoints
(the base class's ``handle_checkpoint`` raises). Collected aggregates are
refused, as the JAX package's planner refuses them for hop windows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch
from ..config import config
from ..engine.engine import register_operator
from ..expr import Col, eval_expr
from ..graph import OpName
from ..operators.base import Operator
from ..ops.aggregate import combine_by_key, finalize_aggs
from ..ops.prefetch import shared_prefetcher
from ..types import Signal, Watermark
from .tumbling import (WINDOW_END, WINDOW_START, KeyDictionary, acc_plan,
                       dtype_of_from_config, make_window_aggregator)


class SlidingAggregate(Operator):
    """config: width_micros, slide_micros, key_fields: list[str], aggregates:
    [(name, kind, Expr|None)], final_projection: [(name, Expr)]|None,
    input_dtype_of, backend override "jax"|"numpy"|None."""

    def __init__(self, cfg: dict):
        self.width = int(cfg["width_micros"])
        self.slide = int(cfg["slide_micros"])
        if self.width % self.slide != 0 or self.width <= 0 or self.slide <= 0:
            raise ValueError(
                f"hop window width ({self.width}us) must be a positive multiple "
                f"of the slide ({self.slide}us)"
            )
        self.nb = self.width // self.slide  # bins per window
        self.key_fields: list[str] = list(cfg.get("key_fields", ()))
        self.aggregates = cfg["aggregates"]
        self.final_projection = cfg.get("final_projection")
        self.acc_kinds, self.acc_dtypes, self.acc_inputs = acc_plan(
            self.aggregates, dtype_of_from_config(cfg))
        self.n_user_accs = len(self.acc_kinds)
        self.backend = cfg.get("backend") or (
            "jax" if config().get("device.enabled") else "numpy")
        self.device = None  # the engine's device, set in on_start
        self._agg = None
        # key transport split (same as tumbling): numeric group-by columns
        # ride the store as extra max-lanes, the rest a host KeyDictionary
        self.lane_key_fields: Optional[list[str]] = None
        self.dict_key_fields: list[str] = []
        self.key_dict = KeyDictionary([])
        self.base_bin: Optional[int] = None  # abs slide-bin offset
        self.min_bin: Optional[int] = None  # earliest live rel bin
        self.max_bin: Optional[int] = None  # latest rel bin seen
        self.next_window: Optional[int] = None  # rel start-bin of next window to emit
        self.late_rows = 0
        # each slide bin is fetched from the device exactly once
        # (destructively) when the watermark completes it; windows combine
        # the host-cached bins
        self.open_bins: set[int] = set()  # rel bins with device-resident data
        self._bin_cache: dict[int, tuple] = {}  # rel bin -> (keys_u64, accs)
        self._bin_pending: dict = {}  # rel bin -> Future[(keys, bins, accs)]
        self._extracted_before: Optional[int] = None  # extraction progress
        self._late_before: Optional[int] = None  # late-drop boundary
        self._target_window: Optional[int] = None  # emit windows <= this
        self._wm_queue: list = []  # (target_window, Watermark) held in order
        self._mesh_oflow_hwm = 0  # MESH_OVERFLOW event throttle high-water mark

    # ------------------------------------------------------------------

    def on_start(self, ctx):
        self.device = ctx.device

    def _aggregator(self):
        if self._agg is None:
            self._agg = make_window_aggregator(self.acc_kinds, self.acc_dtypes, self.backend,
                                               self.device)
        return self._agg

    def _setup_key_transport(self, batch: Batch) -> None:
        lane, dicty = [], []
        for f in self.key_fields:
            col = np.asarray(batch[f])
            if np.issubdtype(col.dtype, np.integer) or np.issubdtype(col.dtype, np.floating):
                lane.append((f, col.dtype))
            else:
                dicty.append(f)
        self.lane_key_fields = [f for f, _ in lane]
        self.dict_key_fields = dicty
        self.key_dict = KeyDictionary(dicty)
        self.acc_kinds = self.acc_kinds + tuple("max" for _ in lane)
        self.acc_dtypes = self.acc_dtypes + tuple(np.dtype(d) for _, d in lane)
        self.acc_inputs = self.acc_inputs + tuple(Col(f) for f, _ in lane)

    # ------------------------------------------------------------------

    def process_batch(self, batch, ctx, collector, input_index=0):
        # insert_arrays below is this method's compiled-segment twin; a
        # change to the drain / late boundary / update / bin bookkeeping
        # here must be mirrored there
        if self._bin_pending or self._wm_queue:
            self._drain(collector)
        if self.lane_key_fields is None:
            self._setup_key_transport(batch)
        bins_abs = batch.timestamps // self.slide
        if self.base_bin is None:
            self.base_bin = int(bins_abs.min())
        rel = (bins_abs - self.base_bin).astype(np.int64)
        # a row is late if its bin's last window already fired or its bin
        # was already extracted
        late_before = self._late_boundary()
        if late_before is not None:
            late = rel < late_before
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return
                batch = batch.filter(~late)
                rel = rel[~late]
        rel = rel.astype(np.int32)
        n = batch.num_rows
        hashes = batch.keys.astype(np.uint64) if KEY_FIELD in batch else np.zeros(n, dtype=np.uint64)
        self.key_dict.observe(hashes, rel, batch)
        vals = []
        for inp, dt in zip(self.acc_inputs, self.acc_dtypes):
            if inp is None:
                vals.append(np.ones(n, dtype=dt))
            else:
                vals.append(np.asarray(eval_expr(inp, batch.columns, n)).astype(dt))
        self._insert(hashes, rel, vals)

    def insert_arrays(self, hashes, bins_abs, vals, collector) -> None:
        """Compiled-segment twin of process_batch (engine/segment.py, same
        contract as TumblingAggregate.insert_arrays): drain, late filter,
        aggregator update and bin bookkeeping over prefix-computed arrays.
        Only reached when the compile gate proved there are no host key
        dictionary fields."""
        if self._bin_pending or self._wm_queue:
            self._drain(collector)
        if len(hashes) == 0:
            return
        if self.base_bin is None:
            self.base_bin = int(bins_abs.min())
        rel = bins_abs - self.base_bin
        late_before = self._late_boundary()
        if late_before is not None:
            late = rel < late_before
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return
                keep = ~late
                rel = rel[keep]
                hashes = hashes[keep]
                vals = [v[keep] for v in vals]
        self._insert(hashes, rel.astype(np.int32), vals)

    def mesh_insert_begin(self, bins_abs, collector):
        """Host half of the fused mesh step (the contract of
        TumblingAggregate.mesh_insert_begin): drain, base-bin anchor, late
        split and bin bookkeeping of ``insert_arrays`` (the late compare in
        int64 before the int32 cast), without the aggregator update."""
        if self._bin_pending or self._wm_queue:
            self._drain(collector)
        if len(bins_abs) == 0:
            return None
        if self.base_bin is None:
            self.base_bin = int(bins_abs.min())
        rel = bins_abs - self.base_bin
        late_before = self._late_boundary()
        ontime = None
        if late_before is not None:
            late = rel < late_before
            if late.any():
                self.late_rows += int(late.sum())
                ontime = ~late
                rel = rel[ontime]
        if len(rel) == 0:
            return ontime
        rel = rel.astype(np.int32)
        self.open_bins.update(np.unique(rel).tolist())
        lo, hi = int(rel.min()), int(rel.max())
        self.min_bin = lo if self.min_bin is None else min(self.min_bin, lo)
        self.max_bin = hi if self.max_bin is None else max(self.max_bin, hi)
        if self.next_window is None:
            self.next_window = self.min_bin - self.nb + 1
        return ontime

    def mesh_stats(self):
        """The sharded store's residency counters (None off the mesh)."""
        stats = getattr(self._agg, "mesh_stats", None)
        return stats() if stats is not None else None

    def _late_boundary(self) -> Optional[int]:
        late_before = self.next_window
        if self._late_before is not None:
            late_before = (self._late_before if late_before is None
                           else max(late_before, self._late_before))
        return late_before

    def _insert(self, hashes, rel, vals) -> None:
        self._aggregator().update(hashes, rel, vals)
        if self.backend != "numpy":  # the numpy path never reads the set
            self.open_bins.update(np.unique(rel).tolist())
        lo, hi = int(rel.min()), int(rel.max())
        self.min_bin = lo if self.min_bin is None else min(self.min_bin, lo)
        self.max_bin = hi if self.max_bin is None else max(self.max_bin, hi)
        if self.next_window is None:
            self.next_window = self.min_bin - self.nb + 1

    def handle_watermark(self, watermark, ctx, collector):
        if watermark.is_idle:
            self._drain(collector, force=True)
            return watermark
        # future emissions are stamped with window starts strictly after the
        # last closed boundary; forward that lower bound
        held = ((watermark.value - self.width) // self.slide + 1) * self.slide
        out_wm = Watermark.event_time(min(watermark.value, held))
        if self.base_bin is None:
            return out_wm
        if self.backend == "numpy":
            last_closed = (watermark.value - self.width) // self.slide - self.base_bin
            self._emit_through(int(last_closed), collector)
            return out_wm
        # bins complete once the watermark passes their end: dispatch their
        # (destructive) extraction, then emit whatever windows have all bins
        # resolved; later watermarks and batches drain the rest
        complete_before = int(watermark.value // self.slide - self.base_bin)
        self._dispatch_extracts(complete_before)
        last_closed = int((watermark.value - self.width) // self.slide - self.base_bin)
        if self._target_window is None or last_closed > self._target_window:
            self._target_window = last_closed
        self._drain(collector)
        if self._caught_up() and not self._wm_queue:
            return out_wm
        self._wm_queue.append((self._target_window, out_wm))
        return None

    def on_close(self, ctx, collector):
        if self.max_bin is None:
            return
        if self.backend == "numpy":
            self._emit_through(self.max_bin, collector)
            return
        self._dispatch_extracts(self.max_bin + 1)
        self._target_window = max(self._target_window or self.max_bin, self.max_bin)
        self._drain(collector, force=True)

    def _caught_up(self) -> bool:
        return (self.next_window is None or self._target_window is None
                or self.next_window > self._target_window)

    def _dispatch_extracts(self, complete_before: int) -> None:
        """Start the one-time extraction of every complete data-carrying bin
        below complete_before (ascending, so the slot directory's monotone
        close boundary is respected)."""
        if self._extracted_before is not None and complete_before <= self._extracted_before:
            return
        ready = sorted(b for b in self.open_bins if b < complete_before)
        if ready:
            agg = self._aggregator()
            pf = shared_prefetcher()
            for b in ready:
                handle = agg.extract_start(b, b + 1, b + 1)
                self._bin_pending[b] = pf.submit(handle.result)
                self.open_bins.discard(b)
        self._extracted_before = complete_before
        if self._late_before is None or complete_before > self._late_before:
            self._late_before = complete_before

    def _resolve_bins(self, bins: list[int], force: bool) -> bool:
        """Move resolved futures into the cache; True when every requested
        bin is available (cached or known-empty)."""
        ok = True
        for b in bins:
            fut = self._bin_pending.get(b)
            if fut is None:
                continue
            if force or fut.is_ready():
                keys, _bins, accs = fut.result()
                if len(keys):
                    self._bin_cache[b] = (keys, accs)
                del self._bin_pending[b]
            else:
                ok = False
        return ok

    def _drain(self, collector, force: bool = False) -> None:
        """Emit in order every window whose bins are all resolved, fused into
        one output batch per drain, then forward the watermarks whose
        windows are out."""
        fused: list[dict] = []
        while not self._caught_up():
            w = self.next_window
            # event-time gap fast-forward: if no bin could feed a window
            # starting at w, jump to the earliest window the live data can
            # touch
            live = [b for src in (self._bin_cache, self._bin_pending, self.open_bins)
                    for b in src if b >= w]
            if not live:
                self.next_window = self._target_window + 1
                self.key_dict.evict_closed(self.next_window)
                break
            earliest = min(live)
            if earliest >= w + self.nb:
                self.next_window = min(earliest - self.nb + 1, self._target_window + 1)
                self.key_dict.evict_closed(self.next_window)
                continue
            needed = list(range(w, w + self.nb))
            if not self._resolve_bins(needed, force):
                break
            parts = [self._bin_cache[b] for b in needed if b in self._bin_cache]
            if parts:
                keys = np.concatenate([p[0] for p in parts])
                accs = [np.concatenate([p[1][i] for p in parts])
                        for i in range(len(self.acc_kinds))]
                keys_c, accs_c = combine_by_key(self.acc_kinds, keys, accs)
                fused.append(self._window_cols(w, keys_c, accs_c))
            self.next_window = w + 1
            for b in [b for b in self._bin_cache if b < self.next_window]:
                del self._bin_cache[b]
            self.key_dict.evict_closed(self.next_window)
        self._emit_fused(fused, collector)
        while self._wm_queue and (self.next_window is None
                                  or self._wm_queue[0][0] < self.next_window):
            _t, wm = self._wm_queue.pop(0)
            collector.broadcast(Signal.watermark_of(wm))

    def _emit_through(self, last_start_rel: int, collector) -> None:
        """The numpy backend's close: a synchronous scan of each closing
        window's bins (the dict store has no fetch latency to hide); every
        window closed here fuses into one emitted batch."""
        if self.next_window is None:
            return
        agg = self._aggregator()
        fused: list[dict] = []
        while self.next_window <= last_start_rel:
            b = self.next_window
            if self.max_bin is not None and b > self.max_bin:
                # nothing at or after this window's start; fast-forward
                self.next_window = last_start_rel + 1
                break
            if self.min_bin is not None and b + self.nb <= self.min_bin:
                # gap: the window lies entirely before the earliest live bin
                nw = min(last_start_rel + 1, self.min_bin - self.nb + 1)
                self.next_window = max(nw, b + 1)
                agg.free_bins_below(self.next_window)
                self.key_dict.evict_closed(self.next_window)
                continue
            keys, _bins, accs = agg.scan_range(b, b + self.nb)
            if len(keys) == 0:
                # bins < b are freed, so an empty scan proves every live bin
                # is >= b + nb: re-arm the gap fast-forward above
                self.min_bin = b + self.nb
            if len(keys):
                keys_c, accs_c = combine_by_key(self.acc_kinds, keys, accs)
                fused.append(self._window_cols(b, keys_c, accs_c))
            self.next_window = b + 1
            # bins below the next window's range are done
            agg.free_bins_below(self.next_window)
            self.key_dict.evict_closed(self.next_window)
            if self.min_bin is not None:
                self.min_bin = max(self.min_bin, self.next_window)
        self._emit_fused(fused, collector)

    def _window_cols(self, start_rel: int, keys, accs) -> dict:
        """Pre-projection output columns for one closed window (key lookups
        resolved before the caller evicts the window's keys)."""
        start = (start_rel + self.base_bin) * self.slide
        n = len(keys)
        cols: dict[str, np.ndarray] = {}
        if self.dict_key_fields:
            cols.update(self.key_dict.lookup_columns(keys))
        for f, lane in zip(self.lane_key_fields or [], accs[self.n_user_accs:]):
            cols[f] = lane
        cols[WINDOW_START] = np.full(n, start, dtype=np.int64)
        cols[WINDOW_END] = np.full(n, start + self.width, dtype=np.int64)
        finals = finalize_aggs([a[1] for a in self.aggregates], accs[: self.n_user_accs])
        for (name, _k, _e), arr in zip(self.aggregates, finals):
            cols[name] = arr
        # the window start is the output event time
        cols[TIMESTAMP_FIELD] = np.full(n, start, dtype=np.int64)
        return cols

    def _emit_fused(self, fused: list[dict], collector) -> None:
        """One collect for all windows closed in this drain; the final
        projection applies once, row-wise."""
        if not fused:
            return
        if len(fused) == 1:
            cols = fused[0]
        else:
            names = fused[0].keys()
            cols = {f: np.concatenate([c[f] for c in fused]) for f in names}
        out = Batch(cols)
        if self.final_projection is not None:
            n = out.num_rows
            proj = {name: eval_expr(e, out.columns, n) for name, e in self.final_projection}
            if TIMESTAMP_FIELD not in proj:
                proj[TIMESTAMP_FIELD] = out.timestamps
            out = Batch(proj)
        collector.collect(out)


@register_operator(OpName.SLIDING_AGGREGATE)
def _make_sliding(cfg: dict):
    return SlidingAggregate(cfg)
