"""Tumbling window aggregate operator (the port's copy of
arroyo_tpu/windows/tumbling.py).

Rows are binned by the window width and fed into the window's store. The
backend is the config's ``backend``, else "jax" when ``device.enabled``
and "numpy" otherwise, as in the JAX package:

- "jax": a SlotAggregator whose state lives on the engine's torch device;
  on a watermark at or past a bin's end the bin closes: its regions are
  read and cleared on the device and the packed result is fetched on the
  prefetch threads, so emission and the forwarded watermark pipeline
  behind later updates. Mesh mode (``device.mesh-devices`` > 1): a
  ShardedAggregator of that many key shards over the device slots of
  ``device.mesh-placement`` (parallel/; device.mesh_slot_devices), whose
  close is synchronous; the fused mesh step of the
  compiled segment (engine/segment.py) updates it on the device and calls
  ``mesh_insert_begin`` for the host half.
- "numpy": the host dict store (ops/aggregate.py DeviceHashAggregator),
  closed synchronously. Collected aggregates (array_agg, COUNT(DISTINCT))
  keep their values in host lists beside it (CollectingAggregator).

Numeric group-by key VALUES ride along as extra max-lanes of the store
(all rows of a key agree, so max is the identity); string keys go through
a host KeyDictionary. The compiled segment feeds the operator through
``insert_arrays``, the twin of ``process_batch`` over arrays the segment
computed.

Checkpoints (the JAX package's tables): at a barrier the in-flight closes
drain first (their rows and watermarks precede the barrier), then the
store's snapshot (on the device a K2 read of every live region, stream-
ordered after every K1 of earlier batches; on the mesh a host copy of the
sharded state) becomes the ``"t"`` table, one row per (window, key) with
the partial accumulators ``__acc_i``, and the late-data boundary the
``"e"`` mark. A restore merges the rows back (K1's merge mode). UDAFs collect their
input values on the host, as array_agg does, and apply the registered
function (arroyo_tpu_torch.udf) at the close.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, object_column
from ..config import config
from ..engine.engine import register_operator
from ..expr import Col, Expr, eval_expr
from ..graph import OpName
from ..operators.base import Operator, TableSpec, persist_mark, restore_marks
from ..ops.aggregate import finalize_aggs
from ..ops.prefetch import shared_prefetcher
from ..ops.slot_agg import SlotAggregator
from ..types import Signal, Watermark

WINDOW_START = "window_start"
WINDOW_END = "window_end"

# in-flight window closes; the queue force-drains past this depth
_PIPELINE_DEPTH = 16


def dtype_of_from_config(cfg: dict):
    """Accumulator-input dtype resolver: the in-process planner hands a live
    callable; graphs that crossed a process boundary (shipped IR) carry the
    declarative "input_dtypes" column map instead and rebuild it here."""
    fn = cfg.get("input_dtype_of")
    if fn is not None:
        return fn
    dtypes = cfg.get("input_dtypes")
    if dtypes:
        from ..batch import Field
        from ..sql.compile import infer_dtype

        dmap = dict(dtypes)
        return lambda e: Field("_", infer_dtype(e, dmap)).numpy_dtype()
    return lambda e: np.dtype(np.float64)


class CollectingAggregator:
    """Wraps the numeric aggregator with host-side object lanes for
    "collect"-kind accumulators (array_agg, COUNT(DISTINCT)). Numeric lanes
    ride the wrapped store untouched; list state lives in a host dict keyed
    (rel_bin, key_hash). The positional lane layout is kept end to end, so
    the window operators need no index remapping. Synchronous only: the
    planner gives such windows backend "numpy"."""

    def __init__(self, acc_kinds, acc_dtypes, inner_factory):
        self.kinds = tuple(acc_kinds)
        self.col_idx = [i for i, k in enumerate(acc_kinds) if k == "collect"]
        self.num_idx = [i for i, k in enumerate(acc_kinds) if k != "collect"]
        # the inner aggregator tracks (key, bin) membership; with no numeric
        # user lane a hidden count keeps every group represented
        self._hidden = not self.num_idx
        inner_kinds = tuple(acc_kinds[i] for i in self.num_idx) or ("count",)
        inner_dtypes = (tuple(acc_dtypes[i] for i in self.num_idx)
                        or (np.dtype(np.int64),))
        self.inner = inner_factory(inner_kinds, inner_dtypes)
        # (rel_bin, key_hash) -> [list per collect lane]
        self.store: dict[tuple[int, int], list[list]] = {}

    def update(self, hashes, rel, vals) -> None:
        nvals = [vals[i] for i in self.num_idx]
        if self._hidden:
            nvals = [np.ones(len(hashes), dtype=np.int64)]
        self.inner.update(hashes, rel, nvals)
        # store keys are the SIGNED view of the hash, as in the inner store
        signed = hashes.astype(np.uint64).view(np.int64)
        order = np.lexsort((signed, rel))
        h_s = signed[order]
        r_s = rel[order]
        brk = np.ones(len(h_s), dtype=bool)
        if len(h_s) > 1:
            brk[1:] = (h_s[1:] != h_s[:-1]) | (r_s[1:] != r_s[:-1])
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], len(h_s))
        cvals = [np.asarray(vals[i], dtype=object)[order] for i in self.col_idx]
        for s, e in zip(starts, ends):
            ent = self.store.setdefault(
                (int(r_s[s]), int(h_s[s])), [[] for _ in self.col_idx])
            for j, cv in enumerate(cvals):
                ent[j].extend(cv[s:e].tolist())

    def _assemble(self, keys, bins, naccs, pop: bool):
        """The numeric lanes and the collected lists of the given (key, bin)
        rows in lane order; pop=True consumes the store's entries."""
        out: list = [None] * len(self.kinds)
        ni = 0
        for i in self.num_idx:
            out[i] = naccs[ni]
            ni += 1
        if len(keys):
            signed = keys.astype(np.uint64).view(np.int64)
            for j, i in enumerate(self.col_idx):
                if pop and j == len(self.col_idx) - 1:
                    ents = [self.store.pop((int(b), int(k)), None)
                            for k, b in zip(signed, bins)]
                else:
                    ents = [self.store.get((int(b), int(k)))
                            for k, b in zip(signed, bins)]
                out[i] = object_column(
                    (list(e[j]) if e is not None else []) for e in ents)
        else:
            for i in self.col_idx:
                out[i] = np.empty(0, dtype=object)
        return out

    def extract(self, lo, hi, before):
        keys, bins, naccs = self.inner.extract(lo, hi, before)
        return keys, bins, self._assemble(keys, bins, naccs, pop=True)

    def snapshot(self):
        keys, bins, naccs = self.inner.snapshot()
        return keys, bins, self._assemble(keys, bins, naccs, pop=False)

    def restore(self, hashes, rel, accs) -> None:
        naccs = [accs[i] for i in self.num_idx]
        if self._hidden:
            # the hidden count lane from the collected lists' lengths
            naccs = [np.array([len(lst) for lst in accs[self.col_idx[0]]], dtype=np.int64)]
        self.inner.restore(hashes, rel, naccs)
        signed = hashes.astype(np.uint64).view(np.int64)
        for row, (k, b) in enumerate(zip(signed, rel)):
            ent = self.store.setdefault((int(b), int(k)), [[] for _ in self.col_idx])
            for j, i in enumerate(self.col_idx):
                ent[j] = list(accs[i][row])


def record_mesh_overflow(op, ctx) -> int:
    """Throttled MESH_OVERFLOW WARN after a snapshot of the sharded store
    (which refreshes its spill residency with no extra device read). Key
    skew past a fixed-capacity exchange lane parks rows in the per-shard
    spill buffer: correct but slower, and the operator should hear about it
    before the buffer fills (which IS an error). The doubling high-water
    mark keeps a steadily skewed job from flooding the feed. The window
    operators call it from their checkpoint barrier."""
    stats_fn = getattr(op._agg, "mesh_stats", None)
    if stats_fn is None:
        return 0
    rows = int(stats_fn().get("overflow_rows", 0))
    if rows > op._mesh_oflow_hwm:
        op._mesh_oflow_hwm = rows * 2
        from ..obs.events import recorder

        ti = ctx.task_info
        recorder.record(
            ti.job_id, "WARN", "MESH_OVERFLOW",
            message=(f"{rows} rows resident in the sharded aggregate's "
                     f"per-shard spill buffer (key skew past a "
                     f"fixed-capacity exchange lane; raise "
                     f"device.spill-capacity before it exhausts)"),
            node=ti.node_id, subtask=ti.subtask_index,
            data={"overflow_rows": rows})
    return rows


def window_ordered(keys, bins, accs):
    """A close's rows window by window, each window's rows in the store's
    order. The sharded store reads a close that spans several windows in
    slot order, which interleaves them; how many windows one close spans
    follows the batches the window saw, and so the coalescing's clock. The
    single-device store already reads bin by bin: then nothing moves."""
    if len(bins) < 2 or not (bins[1:] < bins[:-1]).any():
        return keys, bins, accs
    order = np.argsort(bins, kind="stable")
    return keys[order], bins[order], [a[order] for a in accs]


def make_window_aggregator(acc_kinds, acc_dtypes, backend: str, device):
    """The single-device SlotAggregator or (backend "jax" and
    device.mesh-devices > 1) the key-space-sharded ShardedAggregator over
    the slots of device.mesh-placement, sized from the device config: one
    construction path for every window operator. Backend "numpy" is the SlotAggregator's host store. Collected
    accumulators wrap the numeric store (on the host) with host lists."""
    if "collect" in acc_kinds:
        return CollectingAggregator(
            acc_kinds, acc_dtypes,
            lambda ks, ds: make_window_aggregator(ks, ds, "numpy", device))
    dev = config().section("device")
    mesh_n = int(dev.get("mesh-devices", 0) or 0)
    if backend == "jax" and mesh_n > 1:
        from ..parallel import ShardedAggregator, make_mesh

        return ShardedAggregator(
            make_mesh(mesh_n, device),
            acc_kinds,
            acc_dtypes,
            cap=dev.get("table-capacity", 65536),
            batch_cap=dev.get("batch-capacity", 8192),
            max_probes=dev.get("max-probes", 64),
            emit_cap=dev.get("emit-capacity", 8192),
            spill_cap=dev.get("spill-capacity", 2048),
        )
    return SlotAggregator(
        acc_kinds,
        acc_dtypes,
        cap=dev.get("table-capacity", 65536),
        batch_cap=dev.get("batch-capacity", 8192),
        emit_cap=dev.get("emit-capacity", 8192),
        backend=backend,
        region_size=dev.get("region-size", 2048),
        device=device,
    )


def acc_plan(aggregates: list[tuple[str, str, Optional[Expr]]], schema_dtype_of,
             collect: bool = False) -> tuple:
    """Flatten SQL aggregates into accumulator (kind, dtype, input) triples.

    aggregates: [(out_name, kind, input_expr|None)]; count has no input.
    Returns (acc_kinds, acc_dtypes, input_specs) where input_specs[i] is the
    Expr for that accumulator or None for a count-style all-ones input.
    ``collect`` admits collected aggregates (array_agg, COUNT(DISTINCT)) as
    one host-resident "collect" lane of object dtype: the tumbling and
    session windows and the updating aggregate take them; the sliding
    window does not (the JAX package's planner refuses them there). A UDAF
    ("udaf:<name>") collects its input the same way.
    """
    kinds, dtypes, inputs = [], [], []
    for _name, kind, expr in aggregates:
        if kind == "count":
            kinds.append("count")
            dtypes.append(np.dtype(np.int64))
            inputs.append(None)
        elif kind == "avg":
            kinds.extend(["sum", "count"])
            dtypes.extend([np.dtype(np.float64), np.dtype(np.int64)])
            inputs.extend([expr, None])
        elif kind.startswith("udaf:") or kind in ("collect", "count_distinct"):
            # UDAF state / array_agg / COUNT(DISTINCT) = collected input
            # values (host-resident python lists)
            if not collect:
                raise NotImplementedError(
                    f"aggregate {kind!r} collects values on the host; this window "
                    f"does not take collected aggregates")
            kinds.append("collect")
            dtypes.append(np.dtype(object))
            inputs.append(expr)
        else:
            kinds.append(kind)
            dtypes.append(schema_dtype_of(expr))
            inputs.append(expr)
    return tuple(kinds), tuple(dtypes), tuple(inputs)


class KeyDictionary:
    """hash -> key-column values, for rebuilding non-numeric group-by
    columns at emission (the device state stores only the 64-bit hash).
    Entries are evicted once every bin that saw the key has closed."""

    def __init__(self, key_fields: list[str]):
        self.key_fields = key_fields
        self.values: dict[int, tuple] = {}
        self.last_bin: dict[int, int] = {}

    def observe(self, hashes: np.ndarray, bins: np.ndarray, batch: Batch) -> None:
        if not self.key_fields:
            return
        u, first = np.unique(hashes, return_index=True)
        u_list = u.tolist()
        # every key seen in this batch is live through the batch's max bin;
        # monotone, so an out-of-order batch never shortens a key's life
        mx = int(bins.max()) if len(bins) else 0
        lb = self.last_bin
        for h in u_list:
            v = lb.get(h)
            if v is None or v < mx:
                lb[h] = mx
        vals = self.values
        new = [h for h in u_list if h not in vals]
        if new:
            cols = [batch[f] for f in self.key_fields]
            idx_of = dict(zip(u_list, first.tolist()))
            for h in new:
                i = idx_of[h]
                vals[h] = tuple(c[i] for c in cols)

    def evict_closed(self, rel_before: int) -> None:
        dead = [h for h, b in self.last_bin.items() if b < rel_before]
        for h in dead:
            del self.values[h]
            del self.last_bin[h]

    def lookup_columns(self, hashes: np.ndarray) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        if not self.key_fields:
            return out
        rows = [self.values[int(h)] for h in hashes]
        for j, f in enumerate(self.key_fields):
            vals = [r[j] for r in rows]
            sample = vals[0] if vals else None
            if isinstance(sample, (str, type(None))):
                out[f] = np.array(vals, dtype=object)
            else:
                out[f] = np.array(vals)
        return out


class TumblingAggregate(Operator):
    """config: width_micros, key_fields: list[str], aggregates:
    [(name, kind, Expr|None)], final_projection: [(name, Expr)]|None,
    input_dtype_of: callable Expr -> np.dtype, backend override
    "jax"|"numpy"|None."""

    def __init__(self, cfg: dict):
        self.width = int(cfg["width_micros"])
        self.key_fields: list[str] = list(cfg.get("key_fields", ()))
        self.aggregates = cfg["aggregates"]
        self.final_projection = cfg.get("final_projection")
        self.acc_kinds, self.acc_dtypes, self.acc_inputs = acc_plan(
            self.aggregates, dtype_of_from_config(cfg), collect=True)
        self.n_user_accs = len(self.acc_kinds)
        self.backend = cfg.get("backend") or (
            "jax" if config().get("device.enabled") else "numpy")
        self.device = None  # the engine's device, set in on_start
        self._agg = None
        # key transport split, decided from the first batch's column dtypes
        self.lane_key_fields: Optional[list[str]] = None  # numeric: device lanes
        self.dict_key_fields: list[str] = []  # strings: host dictionary
        self.key_dict = KeyDictionary([])
        self.base_bin: Optional[int] = None  # bin offset so device bins fit int32
        self.open_bins: set[int] = set()  # relative bins resident on device
        self.emitted_before_rel: Optional[int] = None  # late-data boundary
        # state: ephemeral — observability counter (obs/profile.py late_rows_of); never read into emitted data
        self.late_rows = 0
        # in-flight closes: (Future|None, rel_before|None, Watermark|None, seq)
        # state: ephemeral — force-drained at every barrier (handle_checkpoint) before the snapshot
        self._pending: deque = deque()
        # state: ephemeral — orders in-flight closes within one incarnation; the queue is empty at every barrier
        self._batch_seq = 0
        self._mesh_oflow_hwm = 0  # MESH_OVERFLOW event throttle high-water mark

    def tables(self):
        # retention = width: a bin's partials live until its window closes;
        # "e" holds the late-data boundary, global so that it survives an
        # empty snapshot
        return [TableSpec("t", "expiring_time_key", retention_micros=self.width),
                TableSpec("e", "global_keyed")]

    def on_start(self, ctx):
        self.device = ctx.device
        if ctx.table_manager is None:
            return
        tbl = ctx.table_manager.expiring_time_key("t", self.width)
        batches = tbl.all_batches()
        if batches:
            self._restore_from_batch(Batch.concat(batches))
            tbl.replace_all([])
        # the late-data boundary (an absolute bin): a replay drops exactly
        # the rows the original run dropped; watermark-aligned, so max
        # merges subtasks and rescales
        barriers = restore_marks(ctx, "e")
        if barriers:
            eb_abs = max(barriers)
            if self.base_bin is None:
                # empty snapshot: anchor the bin space at the boundary
                self.base_bin = eb_abs
            self.emitted_before_rel = eb_abs - self.base_bin

    def _restore_from_batch(self, b: Batch) -> None:
        # the checkpoint carries every key field as a column, so the key
        # transport split is re-derived from it
        if self.lane_key_fields is None:
            self._setup_key_transport(b)
        hashes = b.keys.astype(np.uint64)
        bins_abs = b.timestamps // self.width
        self.base_bin = int(bins_abs.min())
        rel = (bins_abs - self.base_bin).astype(np.int32)
        accs = [b[f"__acc_{i}"].astype(d)
                for i, d in enumerate(self.acc_dtypes[: self.n_user_accs])]
        accs += [np.asarray(b[f]).astype(d)
                 for f, d in zip(self.lane_key_fields, self.acc_dtypes[self.n_user_accs:])]
        self._aggregator().restore(hashes, rel, accs)
        self.open_bins = set(np.unique(rel).tolist())
        if self.dict_key_fields:
            self.key_dict.observe(hashes, rel, b)

    def handle_checkpoint(self, barrier, ctx, collector):
        # in-flight closes first: their rows and watermarks precede the
        # barrier, and the snapshot must not race them
        self._drain_pending(collector, force=True)
        persist_mark(ctx, "e", None if self.emitted_before_rel is None
                     else self.emitted_before_rel + (self.base_bin or 0))
        tbl = ctx.table_manager.expiring_time_key("t", self.width)
        if self._agg is None:
            # no data yet: building the store now would fix acc_kinds before
            # the key transport appends the numeric key lanes
            tbl.replace_all([])
            return
        keys, bins, accs = self._agg.snapshot()
        record_mesh_overflow(self, ctx)
        if len(keys) == 0:
            tbl.replace_all([])
            return
        starts = (bins.astype(np.int64) + (self.base_bin or 0)) * self.width
        cols: dict[str, np.ndarray] = {TIMESTAMP_FIELD: starts, KEY_FIELD: keys}
        if self.dict_key_fields:
            cols.update(self.key_dict.lookup_columns(keys))
        for f, lane in zip(self.lane_key_fields or [], accs[self.n_user_accs:]):
            cols[f] = lane
        for i, a in enumerate(accs[: self.n_user_accs]):
            cols[f"__acc_{i}"] = a
        tbl.replace_all([Batch(cols)])

    def _setup_key_transport(self, batch: Batch) -> None:
        """Numeric group-by values ride the device as extra max-lanes; the
        rest go through the host KeyDictionary."""
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

    def _aggregator(self):
        if self._agg is None:
            self._agg = make_window_aggregator(self.acc_kinds, self.acc_dtypes, self.backend,
                                               self.device)
        return self._agg

    # ------------------------------------------------------------------

    def process_batch(self, batch, ctx, collector, input_index=0):
        self._begin_batch(collector)
        if self.lane_key_fields is None:
            self._setup_key_transport(batch)
        admitted = self._admit(batch.timestamps // self.width)
        if admitted is None:
            return
        keep, rel = admitted
        if keep is not None:
            batch = batch.filter(keep)
        n = batch.num_rows
        hashes = batch.keys.astype(np.uint64) if KEY_FIELD in batch else np.zeros(n, dtype=np.uint64)
        if self.dict_key_fields:
            self.key_dict.observe(hashes, rel, batch)
        vals = []
        for inp, dt in zip(self.acc_inputs, self.acc_dtypes):
            if inp is None:
                vals.append(np.ones(n, dtype=dt))
            else:
                vals.append(np.asarray(eval_expr(inp, batch.columns, n)).astype(dt))
        self._update(hashes, rel, vals)

    def insert_arrays(self, hashes, bins_abs, vals, collector) -> None:
        """Compiled-segment twin of process_batch (engine/segment.py): the
        segment already computed the routing hashes, absolute bins and
        accumulator inputs; the same state path (pending-close drain,
        late-data filter, aggregator update) applies to them. Only reached
        when the compile gate proved there are no host key dictionary
        fields."""
        self._begin_batch(collector)
        if len(hashes) == 0:
            return
        admitted = self._admit(bins_abs)
        if admitted is None:
            return
        keep, rel = admitted
        if keep is not None:
            hashes = hashes[keep]
            vals = [v[keep] for v in vals]
        self._update(hashes, rel, vals)

    def mesh_insert_begin(self, bins_abs, collector):
        """Host half of the fused mesh step (engine/segment.py
        ``_mesh_execute``): the pending-close drain, base-bin anchoring, the
        late split and the open-bin bookkeeping of ``insert_arrays``,
        without the aggregator update, which the fused step performs on the
        device. Returns the on-time row mask (None: every row inserts)."""
        self._begin_batch(collector)
        if len(bins_abs) == 0:
            return None
        if self.base_bin is None:
            self.base_bin = int(bins_abs.min())
        rel = (bins_abs - self.base_bin).astype(np.int32)
        ontime = None
        if self.emitted_before_rel is not None:
            late = rel < self.emitted_before_rel
            if late.any():
                self.late_rows += int(late.sum())
                ontime = ~late
                rel = rel[ontime]
        if len(rel):
            self.open_bins.update(np.unique(rel).tolist())
        return ontime

    def mesh_stats(self):
        """The sharded store's residency counters (None off the mesh)."""
        stats = getattr(self._agg, "mesh_stats", None)
        return stats() if stats is not None else None

    def _begin_batch(self, collector) -> None:
        self._batch_seq += 1
        if self._pending:
            self._drain_pending(collector)

    def _admit(self, bins_abs: np.ndarray):
        """Relative int32 bins of a batch's rows, anchoring the bin offset
        on the first batch, and the on-time mask (None when every row is on
        time): rows behind already-emitted windows are dropped, late data
        never re-opens a closed window. None when every row is late."""
        if self.base_bin is None:
            self.base_bin = int(bins_abs.min())
        rel = (bins_abs - self.base_bin).astype(np.int32)
        if self.emitted_before_rel is not None:
            late = rel < self.emitted_before_rel
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return None
                return ~late, rel[~late]
        return None, rel

    def _update(self, hashes, rel, vals) -> None:
        self._aggregator().update(hashes, rel, vals)
        self.open_bins.update(np.unique(rel).tolist())

    # ------------------------------------------------------------- emission

    def _drain_pending(self, collector, force: bool = False) -> None:
        """Emit completed in-flight closes in order; each close's watermark
        is broadcast only after its rows."""
        while self._pending:
            fut, rel_before, wm, _seq = self._pending[0]
            if fut is not None and not force and not fut.is_ready():
                return
            self._pending.popleft()
            if fut is not None:
                keys, bins, accs = window_ordered(*fut.result())
                if len(keys):
                    self._emit_entries(keys, bins, accs, collector)
                if self.dict_key_fields:
                    self.key_dict.evict_closed(rel_before)
            if wm is not None:
                collector.broadcast(Signal.watermark_of(wm))

    def handle_watermark(self, watermark, ctx, collector):
        if watermark.is_idle:
            self._drain_pending(collector, force=True)
            return watermark
        if self._pending:
            self._drain_pending(collector)
        closed_before_abs = watermark.value // self.width
        # forward the start of the oldest window still open, not w itself,
        # so downstream never sees this operator's output as late
        out_wm = Watermark.event_time(closed_before_abs * self.width)
        scheduled = self._schedule_close(closed_before_abs, out_wm, collector)
        if scheduled or self._pending:
            return None  # the watermark rides the pending queue, in order
        return out_wm

    def on_close(self, ctx, collector):
        self._schedule_close(None, None, collector)
        self._drain_pending(collector, force=True)

    def _hold_watermark(self, out_wm: Optional[Watermark], collector) -> bool:
        """No bins are closing: queue the watermark behind in-flight closes
        (bounded by the pipeline depth); True when held."""
        if out_wm is None or not self._pending:
            return False
        tail = self._pending[-1]
        if tail[0] is None and tail[2] is not None:
            # consecutive watermarks with no rows between them collapse
            self._pending[-1] = (None, None, out_wm, tail[3])
            return True
        if len(self._pending) >= _PIPELINE_DEPTH:
            self._drain_pending(collector, force=True)
            return False
        self._pending.append((None, None, out_wm, self._batch_seq))
        return True

    def _schedule_close(self, closed_before_abs: Optional[int],
                        out_wm: Optional[Watermark], collector) -> bool:
        """Dispatch the device reads for every bin the watermark closes (on
        the numpy backend: close them at once); True if a close (or a
        watermark hold) was queued."""
        if self.base_bin is None or not self.open_bins:
            return self._hold_watermark(out_wm, collector)
        if closed_before_abs is None:
            rel_before = max(self.open_bins) + 1
        else:
            rel_before = int(closed_before_abs - self.base_bin)
        if self.emitted_before_rel is None or rel_before > self.emitted_before_rel:
            self.emitted_before_rel = rel_before
        closing = sorted(b for b in self.open_bins if b < rel_before)
        if not closing:
            return self._hold_watermark(out_wm, collector)
        agg = self._aggregator()
        self.open_bins -= set(closing)
        if self.backend == "numpy":
            keys, bins, accs = agg.extract(min(closing), rel_before, rel_before)
            if len(keys):
                self._emit_entries(keys, bins, accs, collector)
            if self.dict_key_fields:
                self.key_dict.evict_closed(rel_before)
            return False  # synchronous: the caller forwards the watermark itself
        if len(self._pending) >= _PIPELINE_DEPTH:
            self._drain_pending(collector, force=True)
        handle = agg.extract_start(min(closing), rel_before, rel_before)
        fut = shared_prefetcher().submit(handle.result)
        self._pending.append((fut, rel_before, out_wm, self._batch_seq))
        return True

    def _emit_entries(self, keys, bins, accs, collector) -> None:
        starts = (bins.astype(np.int64) + self.base_bin) * self.width
        cols: dict[str, np.ndarray] = {}
        if self.dict_key_fields:
            cols.update(self.key_dict.lookup_columns(keys))
        for f, lane in zip(self.lane_key_fields, accs[self.n_user_accs:]):
            cols[f] = lane
        cols[WINDOW_START] = starts
        cols[WINDOW_END] = starts + self.width
        finals = finalize_aggs([a[1] for a in self.aggregates], accs[: self.n_user_accs])
        for (name, _k, _e), arr in zip(self.aggregates, finals):
            cols[name] = arr
        # the window start is the output event time
        cols[TIMESTAMP_FIELD] = starts
        out = Batch(cols)
        if self.final_projection is not None:
            n = out.num_rows
            proj = {name: eval_expr(e, out.columns, n) for name, e in self.final_projection}
            if TIMESTAMP_FIELD not in proj:
                proj[TIMESTAMP_FIELD] = out.timestamps
            out = Batch(proj)
        collector.collect(out)


@register_operator(OpName.TUMBLING_AGGREGATE)
def _make_tumbling(cfg: dict):
    return TumblingAggregate(cfg)
