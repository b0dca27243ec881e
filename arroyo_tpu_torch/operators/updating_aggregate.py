"""Updating (non-windowed) aggregate with retractions and TTL (the port's
copy of arroyo_tpu/operators/updating_aggregate.py).

Keyed incremental accumulators; on each flush (tick, watermark, close) emit
retract/append pairs for keys whose value changed (identical-value updates
suppressed); TTL eviction emits retractions. Updating rows carry the flat
``_is_retract`` boolean column.

COUNT(DISTINCT) accumulates a per-value multiplicity map per key (kind
"collect"), which inverts exactly under retractions.

Input may itself be updating: retractions are applied with invertible
accumulators (sum/count/avg); min/max over an updating input is rejected.

Two modes, chosen as the JAX package chooses them (backend "jax" = the
device, "numpy" = the host; the default follows ``device.enabled``):

  host mode: one ``_KeyState`` per key in a dict, folded per batch.
  device mode (every accumulator sum or count): the running accumulators
      are signed sum lanes of a SlotAggregator on the engine's torch device
      (append +v, retract -v, the count a sum of +-1), updated by K1. A
      flush reads the touched keys' slots with one K7 gather
      (``SlotAggregator.read_slots``); dead keys are zeroed by a negated
      K1 scatter, and once a quarter of the table has died the store is
      rebuilt from its live snapshot (K2 reads, then K1 in merge mode).

Checkpoints (the JAX package's tables): at a barrier the operator flushes
(so that ``emitted`` mirrors what downstream has seen), then ``state_batch``
becomes the ``"s"`` table and the event-time high-water mark the ``"m"``
mark; in device mode the snapshot is a K2 read of the store's regions. A
restore loads them with ``load_state_batch`` (in device mode K1 in merge
mode), from either mode and either package.

Tiered state (``state.spill.enabled``): as in the JAX package, the
operator then takes the host mode, keeps its hot keys in ``state`` and
spills cold hash-range partitions to a ``KeyedSpillAnnex``
(state/spill.py); a key the batch touches is promoted back before it is
folded. The annex's manifest is the ``"s__spill"`` table. A restore with
spilling off of a checkpoint whose manifest references runs raises.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, object_column
from ..config import config
from ..device import resolve_device
from ..engine.engine import register_operator
from ..expr import eval_expr
from ..graph import OpName
from ..ops.aggregate import _identity, finalize_aggs
from ..ops.slot_agg import SlotAggregator
from ..windows.tumbling import acc_plan, dtype_of_from_config
from .base import Operator, TableSpec, persist_mark, restore_marks

IS_RETRACT_FIELD = "_is_retract"


def _pack_key_state(st: "_KeyState", kv) -> tuple:
    """Spill payload for one key (state/spill.py pack contract: the event
    time rides at index -1 so the annex can zone-map runs without
    unpickling); built-in and numpy values only."""
    return (tuple(st.accs), st.count, st.emitted, kv, st.last_update)


def _unpack_key_state(packed: tuple) -> tuple["_KeyState", Optional[tuple]]:
    accs, count, emitted, kv, last_update = packed
    st = _KeyState(list(accs), int(count), int(last_update))
    st.emitted = emitted
    return st, (tuple(kv) if kv is not None else None)


class _KeyState:
    __slots__ = ("accs", "count", "emitted", "last_update")

    def __init__(self, accs: list, count: int, last_update: int):
        self.accs = accs
        self.count = count  # live rows backing this key (0 -> delete)
        self.emitted: Optional[tuple] = None  # last appended output values
        self.last_update = last_update  # event-time micros for TTL


class UpdatingAggregate(Operator):
    """config: key_fields, aggregates: [(name, kind, Expr|None)],
    flush_interval_micros (default 1s), ttl_micros (default 1 day),
    input_dtype_of, backend ("jax" | "numpy" | None)."""

    def __init__(self, cfg: dict):
        from ..state.spill import spill_enabled

        self.key_fields: list[str] = list(cfg.get("key_fields", ()))
        self.aggregates = cfg["aggregates"]
        dtype_of = dtype_of_from_config(cfg)
        self.acc_kinds, self.acc_dtypes, self.acc_inputs = acc_plan(
            self.aggregates, dtype_of, collect=True)
        self.flush_interval = int(cfg.get("flush_interval_micros", 1_000_000))
        self.ttl = int(cfg.get("ttl_micros", 24 * 3600 * 1_000_000))
        self.state: dict[int, _KeyState] = {}
        self.key_values: dict[int, tuple] = {}
        self.updated: set[int] = set()
        # high-water event time: stamps emitted rows and anchors TTL eviction
        self.max_event_time: int = 0
        backend = cfg.get("backend") or ("jax" if config().get("device.enabled") else "numpy")
        # with spilling on, the keyed map runs on the host path: the hot
        # working set stays in self.state and cold partitions in the annex
        self._spill = spill_enabled()
        self._annex = None  # KeyedSpillAnnex, built in on_start when spilling
        self.device_mode = (backend == "jax" and all(k in ("sum", "count") for k in self.acc_kinds)
                            and not self._spill)
        # the device store always carries a count lane (+-1 per row): it is
        # the liveness ground truth even when the SQL has no count(*)
        self._count_lane = next(
            (i for i, k in enumerate(self.acc_kinds) if k == "count"), None)
        self._synthetic_count = self.device_mode and self._count_lane is None
        if self._synthetic_count:
            self._count_lane = len(self.acc_kinds)
        self.device = None  # torch device of the device store (from the context)
        self._dev: Optional[SlotAggregator] = None  # built lazily
        self._dead_since_compact = 0
        self._last_update: dict[int, int] = {}  # key hash -> event time
        self._emitted: dict[int, tuple] = {}  # key hash -> last appended vals
        # observability counters (read by chip_smoke.py; never emitted)
        self.evicted_keys = 0  # keys dropped by TTL eviction
        self.compactions = 0  # device store rebuilds
        self.spill_reads = 0  # flushed keys read from the host spill tier

    # ------------------------------------------------------------------

    def tick_interval_micros(self):
        return self.flush_interval

    def tables(self):
        # "m" holds the event-time high-water mark (global: it survives an
        # empty key snapshot); "s__spill" the JAX package's spill manifest
        return [TableSpec("s", "expiring_time_key", retention_micros=self.ttl),
                TableSpec("m", "global_keyed"),
                TableSpec("s__spill", "global_keyed")]

    def on_start(self, ctx):
        self.device = ctx.device
        tm = ctx.table_manager
        if tm is None:
            return
        if self._spill:
            from ..state.spill import KeyedSpillAnnex, restore_manifest

            self._annex = KeyedSpillAnnex(ctx.task_info, tm.storage_url, "s")
            self._annex.adopt(restore_manifest(ctx, "s__spill"))
        else:
            from ..state.spill import require_spill_for_manifest

            # the spilled keys live only in run files: restoring the hot
            # rows alone would silently drop them
            require_spill_for_manifest(ctx, "s__spill")
        # the high-water mark is data-derived, so per subtask: our own
        # entry, else (a restore at another parallelism) the max
        own = tm.global_keyed("m").get(ctx.task_info.subtask_index)
        if own is not None:
            self.max_event_time = max(self.max_event_time, own)
        else:
            marks = restore_marks(ctx, "m")
            if marks:
                self.max_event_time = max(self.max_event_time, max(marks))
        tbl = tm.expiring_time_key("s", self.ttl)
        batches = tbl.all_batches()
        if batches:
            self.load_state_batch(Batch.concat(batches))
            tbl.replace_all([])

    def handle_checkpoint(self, barrier, ctx, collector):
        # flush first, so that `emitted` mirrors what downstream has seen
        # before the barrier (the set of updated keys is not persisted)
        self._flush(collector)
        # the raw mark, 0 included, at every barrier
        persist_mark(ctx, "m", self.max_event_time)
        if self._annex is not None:
            from ..state.spill import checkpoint_manifest

            # enforce the budget, then snapshot: hot rows into "s", spilled
            # runs by reference into the manifest (never re-uploaded)
            self._annex.epoch = barrier.epoch
            self._maybe_spill()
            checkpoint_manifest(ctx, "s__spill", self._annex)
        b = self.state_batch()
        ctx.table_manager.expiring_time_key("s", self.ttl).replace_all([] if b is None else [b])

    def process_batch(self, batch, ctx, collector, input_index=0):
        if self.device is None:
            self.device = ctx.device
        n = batch.num_rows
        ts = batch.timestamps
        self.max_event_time = max(self.max_event_time, int(ts.max()))
        if KEY_FIELD in batch:
            hashes = batch.keys.astype(np.uint64).view(np.int64)
        else:
            hashes = np.zeros(n, dtype=np.int64)
        retracts = (
            np.asarray(batch[IS_RETRACT_FIELD], dtype=bool)
            if IS_RETRACT_FIELD in batch
            else np.zeros(n, dtype=bool)
        )
        if retracts.any():
            for kind in self.acc_kinds:
                # collect = COUNT(DISTINCT)'s per-value multiplicity map,
                # which inverts exactly (append +1 / retract -1 per value)
                if kind not in ("sum", "count", "collect"):
                    raise ValueError(
                        f"updating aggregate over an updating input requires "
                        f"invertible accumulators; {kind} is not"
                    )
        # accumulate values per row, then fold per unique key
        vals = []
        for inp, dt, kind in zip(self.acc_inputs, self.acc_dtypes, self.acc_kinds):
            if inp is None:
                vals.append(np.ones(n, dtype=dt))
            elif kind == "collect":
                # raw distinct-candidate values (any hashable scalar type)
                v = np.asarray(eval_expr(inp, batch.columns, n))
                vals.append(v if v.dtype == object else v.astype(object))
            else:
                vals.append(np.asarray(eval_expr(inp, batch.columns, n)).astype(dt))
        if self.device_mode:
            self._process_device(hashes, ts, retracts, vals, batch)
            return
        if self._annex is not None:
            self._ensure_hot(hashes)
        order = np.argsort(hashes, kind="stable")
        k_s = hashes[order]
        r_s = retracts[order]
        t_s = np.asarray(ts)[order]
        v_s = [v[order] for v in vals]
        brk = np.ones(n, dtype=bool)
        brk[1:] = k_s[1:] != k_s[:-1]
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], n)
        if self.key_fields:
            cols = [np.asarray(batch[f])[order] for f in self.key_fields]
            for si in starts:
                h = int(k_s[si])
                if h not in self.key_values:
                    self.key_values[h] = tuple(c[si] for c in cols)
        for si, ei in zip(starts, ends):
            h = int(k_s[si])
            st = self.state.get(h)
            last_ts = int(t_s[ei - 1])
            if st is None:
                st = _KeyState(
                    [self._identity(i) for i in range(len(self.acc_kinds))], 0, last_ts
                )
                self.state[h] = st
            st.last_update = max(st.last_update, last_ts)
            seg_r = r_s[si:ei]
            n_app = int((~seg_r).sum())
            n_ret = int(seg_r.sum())
            st.count += n_app - n_ret
            if st.count < 0:
                raise RuntimeError(
                    "retract without matching append for key (updating stream "
                    "ordering violation)"
                )
            for i, kind in enumerate(self.acc_kinds):
                seg = v_s[i][si:ei]
                app = seg[~seg_r]
                ret = seg[seg_r]
                cur = st.accs[i]
                if kind == "collect":
                    # per-value multiplicity map: distinct set = live keys
                    m: dict = cur
                    for v in app:
                        v = v.item() if isinstance(v, np.generic) else v
                        m[v] = m.get(v, 0) + 1
                    for v in ret:
                        v = v.item() if isinstance(v, np.generic) else v
                        c = m.get(v, 0) - 1
                        if c <= 0:
                            m.pop(v, None)
                        else:
                            m[v] = c
                    continue
                if kind in ("sum", "count"):
                    cur = cur + app.sum() - ret.sum()
                elif kind == "min":
                    cur = min(cur, app.min()) if len(app) else cur
                else:
                    cur = max(cur, app.max()) if len(app) else cur
                st.accs[i] = self.acc_dtypes[i].type(cur)
            self.updated.add(h)
        if self._annex is not None:
            self._maybe_spill()

    # --------------------------------------------------------- tiered state

    def _ensure_hot(self, hashes: np.ndarray) -> None:
        """Promote every batch key with a cold (spilled) copy into the hot
        dict before the fold loop touches it — the probe is one bloom/zone
        pruned pass per batch, never per key."""
        annex = self._annex
        uniq = np.unique(hashes)
        annex.touch(uniq)
        if not annex.has_runs():
            return
        missing = [h for h in uniq.tolist() if h not in self.state]
        if not missing:
            return
        for h, packed in sorted(annex.lookup_many(missing).items()):
            st, kv = _unpack_key_state(packed)
            self.state[h] = st
            if kv is not None:
                self.key_values[h] = kv

    def _entry_nbytes(self, h: int, st: _KeyState) -> int:
        """Resident-bytes floor for one key (same role as the join's
        per-row estimate: feeds arroyo_state_bytes AND the spill budget)."""
        import sys as _sys

        b = 160  # dict slots + _KeyState object overhead
        for a in st.accs:
            b += (_sys.getsizeof(a) + 64 * len(a)) if isinstance(a, dict) \
                else 32
        if st.emitted is not None:
            b += 56 + 32 * len(st.emitted)
        kv = self.key_values.get(h)
        if kv is not None:
            b += 56 + sum(_sys.getsizeof(v) for v in kv)
        return b

    def _estimate_state_bytes(self) -> tuple[int, float]:
        """(estimated resident bytes, per-entry average), sampled over up
        to 64 entries so the per-batch budget check stays O(1)."""
        import itertools as _it

        n = len(self.state)
        if not n:
            return 0, 0.0
        tot = cnt = 0
        for h, st in _it.islice(self.state.items(), 64):
            tot += self._entry_nbytes(h, st)
            cnt += 1
        per = tot / cnt
        return int(per * n), per

    def state_sizes(self) -> dict[str, tuple[int, int]]:
        """Live resident-state gauge of the host mode (between barriers the
        "s" table lags the in-memory map); the device mode keeps the
        as-of-barrier table view."""
        if self.device_mode:
            return {}
        est, _per = self._estimate_state_bytes()
        return {"s": (len(self.state), est)}

    def spill_stats(self) -> Optional[dict]:
        """The spill annex's counters (arroyo_spill_* series); None while
        spilling is off."""
        annex = self._annex
        if annex is None:
            return None
        cold = annex.cold_partitions()
        return {"bytes_total": annex.stats.bytes_total,
                "hot": max(0, annex.local_partitions() - cold), "cold": cold,
                "probe_files": annex.stats.probe_files}

    def _maybe_spill(self) -> None:
        """Budget enforcement: when resident state passes
        ``state.spill.budget-bytes``, spill the coldest partitions (the
        annex's deterministic clock-LRU) down to the low-water mark."""
        from ..state.spill import SPILL_HEADROOM, spill_budget_bytes

        annex = self._annex
        if annex is None or not self.state:
            return
        budget = spill_budget_bytes()
        est_total, per_entry = self._estimate_state_bytes()
        if est_total <= budget:
            return
        target = budget * SPILL_HEADROOM
        excess = int((est_total - target) / max(per_entry, 1.0)) + 1
        # keys with pending un-flushed updates are spillable too (the next
        # _flush promotes them back): budget enforcement must not depend
        # on the watermark cadence that clears the updated set. The clock
        # LRU keeps their (just-touched) partitions at the back of the
        # victim line anyway.
        hot_by_p: dict[int, list[int]] = {}
        for h in self.state:
            hot_by_p.setdefault(annex.partition_of(h), []).append(h)
        victims = annex.pick_victims(
            {p: len(ks) for p, ks in hot_by_p.items()}, excess)
        for p in victims:
            items = [(h, _pack_key_state(self.state[h],
                                         self.key_values.get(h)))
                     for h in hot_by_p[p]]
            if not annex.spill(p, items):
                return  # degraded (SPILL_FALLBACK): stay resident, back off
            for h in hot_by_p[p]:
                self.state.pop(h, None)
                self.key_values.pop(h, None)

    def _identity(self, i: int):
        if self.acc_kinds[i] == "collect":
            return {}  # fresh multiplicity map per key
        return _identity(self.acc_kinds[i], self.acc_dtypes[i])

    def _key_columns(self, hashes) -> dict:
        """Group-by columns for the given key hashes (shared by emission and
        both state layouts)."""
        cols: dict = {}
        for j, f in enumerate(self.key_fields):
            vals = [self.key_values.get(int(h), (None,) * len(self.key_fields))[j]
                    for h in hashes]
            sample = next((v for v in vals if v is not None), None)
            if isinstance(sample, (str, type(None))):
                cols[f] = object_column(vals)
            else:
                cols[f] = np.array(vals)
        return cols

    # ------------------------------------------------------- device lowering

    def _dev_dtypes(self) -> tuple:
        if self._synthetic_count:
            return self.acc_dtypes + (np.dtype(np.int64),)
        return self.acc_dtypes

    def _device(self) -> SlotAggregator:
        if self._dev is None:
            dev = config().section("device")
            if self.device is None:
                self.device = resolve_device(None)
            # every lane is a signed sum (count = sum of +-1)
            self._dev = SlotAggregator(
                tuple("sum" for _ in self._dev_dtypes()),
                self._dev_dtypes(),
                cap=dev.get("table-capacity", 65536),
                batch_cap=dev.get("batch-capacity", 8192),
                region_size=dev.get("region-size", 2048),
                device=self.device,
            )
        return self._dev

    def _process_device(self, hashes, ts, retracts, vals, batch) -> None:
        n = len(hashes)
        sign = np.where(retracts, -1, 1).astype(np.int64)
        signed = []
        for v, kind, dt in zip(vals, self.acc_kinds, self.acc_dtypes):
            if kind == "count":
                signed.append(sign.astype(dt))
            else:
                signed.append((np.asarray(v) * sign).astype(dt))
        if self._synthetic_count:
            signed.append(sign)
        self._device().update(hashes.view(np.uint64), np.zeros(n, dtype=np.int32), signed)
        uniq, first = np.unique(hashes, return_index=True)
        mx = np.zeros(len(uniq), dtype=np.int64)
        np.maximum.at(mx, np.searchsorted(uniq, hashes), np.asarray(ts))
        lu = self._last_update
        for h, t in zip(uniq.tolist(), mx.tolist()):
            prev = lu.get(h)
            if prev is None or t > prev:
                lu[h] = t
        self.updated.update(uniq.tolist())
        if self.key_fields:
            cols = [np.asarray(batch[f]) for f in self.key_fields]
            kv = self.key_values
            for h, i in zip(uniq.tolist(), first.tolist()):
                if h not in kv:
                    kv[h] = tuple(c[i] for c in cols)

    def _device_lanes(self, keys: list[int]) -> list[np.ndarray]:
        """Current accumulator lanes (one array per device lane, in its
        dtype) for the given key hashes: one K7 gather of the keys that own
        a device slot, host spill lookups for the rest (0 for a key in
        neither). The JAX package builds one tuple per key and then the
        same columns from them; the values are the same."""
        agg = self._device()
        dts = self._dev_dtypes()
        signed = np.array(keys, dtype=np.int64)
        slots = agg.slots_of(signed.view(np.uint64))
        on_dev = slots >= 0
        lanes = [np.zeros(len(keys), dtype=d) for d in dts]
        if on_dev.any():
            for lane, v in zip(lanes, agg.read_slots(slots[on_dev])):
                lane[on_dev] = v
        off = np.flatnonzero(~on_dev)
        self.spill_reads += len(off)
        for i in off.tolist():
            parts = agg.spill.get((0, int(signed[i])))
            if parts is not None:
                for lane, p in zip(lanes, parts):
                    lane[i] = p
        return lanes

    def _flush_device(self, collector, evict_before) -> None:
        count_i = self._count_lane
        touched = sorted(self.updated)
        self.updated.clear()
        out_rows: list[tuple[int, tuple, bool]] = []
        dead: list[int] = []
        zero_keys: list[int] = []  # dead keys whose slots must reset exactly
        if touched:
            lanes = self._device_lanes(touched)
            counts = lanes[count_i].astype(np.int64)
            if (counts < 0).any():
                raise RuntimeError(
                    "retract without matching append for key (updating "
                    "stream ordering violation)"
                )
            finals = finalize_aggs([a[1] for a in self.aggregates], lanes[:len(self.acc_dtypes)])
            for i, h in enumerate(touched):
                emitted = self._emitted.get(h)
                if counts[i] == 0:
                    if emitted is not None:
                        out_rows.append((h, emitted, True))
                        self._emitted.pop(h, None)
                    dead.append(h)
                    zero_keys.append(h)
                    continue
                new_vals = tuple(f[i] for f in finals)
                if emitted is not None:
                    if emitted == new_vals:
                        continue
                    out_rows.append((h, emitted, True))
                out_rows.append((h, new_vals, False))
                self._emitted[h] = new_vals
        idle: list[int] = []
        if evict_before is not None:
            dead_set = set(dead)
            # sorted: eviction retraction order must not depend on dict order
            idle = sorted(h for h, t in self._last_update.items()
                          if t < evict_before and h not in dead_set)
            for h in idle:
                emitted = self._emitted.pop(h, None)
                if emitted is not None:
                    out_rows.append((h, emitted, True))
                dead.append(h)
            self.evicted_keys += len(idle)
        to_zero = zero_keys + idle
        if to_zero:
            # a returning key must restart from zero: scatter the negated
            # current values (pure sum lanes). This includes count == 0
            # keys: float lanes can hold a residue when the count is 0.
            neg = [-lane for lane in self._device_lanes(to_zero)]
            key_u64 = np.array(to_zero, dtype=np.int64).view(np.uint64)
            self._device().update(key_u64, np.zeros(len(to_zero), dtype=np.int32), neg)
        if out_rows:
            self._emit(out_rows, collector)
        for h in dead:
            self._last_update.pop(h, None)
            self.key_values.pop(h, None)
        self._dead_since_compact += len(dead)
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        """Dead keys keep their device slots (eviction only zeroes values);
        once a quarter of the table has died, rebuild the store from the
        live snapshot so slot and spill capacity is reclaimed."""
        dev = self._dev
        if dev is None or self._dead_since_compact < dev.cap // 4:
            return
        keys_u64, _bins, accs = dev.snapshot()
        live = accs[self._count_lane] > 0
        self._dev = None
        fresh = self._device()
        if live.any():
            fresh.restore(keys_u64[live], np.zeros(int(live.sum()), dtype=np.int32),
                          [a[live] for a in accs])
        self._dead_since_compact = 0
        self.compactions += 1

    # ------------------------------------------------------------------

    def _finalize(self, st: _KeyState) -> tuple:
        arrays = [np.array([a]) for a in st.accs]
        finals = finalize_aggs([a[1] for a in self.aggregates], arrays)
        return tuple(f[0] for f in finals)

    def _flush(self, collector, evict_before: Optional[int] = None) -> None:
        """Emit retract/append pairs for keys whose value changed; TTL-evict
        idle keys with a retraction."""
        if self.device_mode:
            self._flush_device(collector, evict_before)
            return
        out_rows: list[tuple[int, tuple, bool]] = []  # (hash, values, is_retract)
        dead: list[int] = []
        if self._annex is not None:
            # a key can be spilled with its update pending (budget pressure
            # between flushes): promote it back so its emission reads the
            # exact accumulated state
            missing = sorted(h for h in self.updated if h not in self.state)
            if missing:
                for h, pk in sorted(self._annex.lookup_many(missing).items()):
                    st, kv = _unpack_key_state(pk)
                    self.state[h] = st
                    if kv is not None:
                        self.key_values[h] = kv
        for h in sorted(self.updated):
            st = self.state.get(h)
            if st is None:
                continue
            if st.count == 0:
                if st.emitted is not None:
                    out_rows.append((h, st.emitted, True))
                dead.append(h)
                continue
            new_vals = self._finalize(st)
            if st.emitted is not None:
                if st.emitted == new_vals:
                    continue  # suppress no-op updates
                out_rows.append((h, st.emitted, True))
            out_rows.append((h, new_vals, False))
            st.emitted = new_vals
        self.updated.clear()
        if evict_before is not None:
            if self._annex is not None:
                # cold keys expire too: promote every spilled key whose
                # newest copy is past the TTL, so the sweep below retracts
                # it as it retracts a resident one
                for h, packed in self._annex.scan_expired(evict_before, self.state.keys()):
                    st, kv = _unpack_key_state(packed)
                    self.state[h] = st
                    if kv is not None:
                        self.key_values[h] = kv
            dead_set = set(dead)
            # sorted: eviction retractions must not leave in dict order
            idle = sorted(h for h, st in self.state.items()
                          if st.last_update < evict_before and h not in dead_set)
            for h in idle:
                st = self.state[h]
                if st.emitted is not None:
                    out_rows.append((h, st.emitted, True))
                dead.append(h)
            self.evicted_keys += len(idle)
        if out_rows:
            self._emit(out_rows, collector)
        # evict only after emission so retractions can still resolve key values
        for h in dead:
            self.state.pop(h, None)
            self.key_values.pop(h, None)

    def _emit(self, out_rows, collector) -> None:
        n = len(out_rows)
        cols: dict[str, np.ndarray] = {}
        if self.key_fields:
            cols.update(self._key_columns([h for h, _v, _r in out_rows]))
        for i, (name, _k, _e) in enumerate(self.aggregates):
            vals = [v[i] for _h, v, _r in out_rows]
            cols[name] = np.array(vals)
        cols[IS_RETRACT_FIELD] = np.array([r for _h, _v, r in out_rows], dtype=bool)
        cols[TIMESTAMP_FIELD] = np.full(n, self.max_event_time, dtype=np.int64)
        collector.collect(Batch(cols))

    # ------------------------------------------------------------------

    def handle_tick(self, ctx, collector):
        self._flush(collector, evict_before=self.max_event_time - self.ttl)

    def handle_watermark(self, watermark, ctx, collector):
        if not watermark.is_idle:
            self._flush(collector, evict_before=watermark.value - self.ttl)
        return watermark

    def on_close(self, ctx, collector):
        self._flush(collector)

    # ------------------------------------------------------------ state layout

    def state_batch(self) -> Optional[Batch]:
        """The key state as the JAX package writes it to its ``"s"``
        checkpoint table (``handle_checkpoint`` after its flush, host and
        device layouts), or None when no key is live. The caller flushes
        first, as the checkpoint does, so ``emitted`` mirrors what
        downstream has seen; ``max_event_time`` is kept apart (the JAX
        package's ``"m"`` table)."""
        if self.device_mode:
            return self._device_state_batch()
        items = sorted(self.state.items())
        if not items:
            return None
        n_agg = len(self.aggregates)
        cols: dict[str, np.ndarray] = {
            TIMESTAMP_FIELD: np.array([st.last_update for _h, st in items], dtype=np.int64),
            KEY_FIELD: np.array([h for h, _st in items], dtype=np.int64).view(np.uint64),
            "__count": np.array([st.count for _h, st in items], dtype=np.int64),
            "__has_emitted": np.array([st.emitted is not None for _h, st in items], dtype=bool),
        }
        for i, d in enumerate(self.acc_dtypes):
            if self.acc_kinds[i] == "collect":
                # multiplicity maps as JSON [value, count] pairs
                cols[f"__acc_{i}"] = object_column(
                    json.dumps(sorted(st.accs[i].items(), key=str)) for _h, st in items)
            else:
                cols[f"__acc_{i}"] = np.array([st.accs[i] for _h, st in items], dtype=d)
        for i in range(n_agg):
            cols[f"__emitted_{i}"] = np.array(
                [st.emitted[i] if st.emitted is not None else 0 for _h, st in items])
        if self.key_fields:
            cols.update(self._key_columns([h for h, _st in items]))
        return Batch(cols)

    def _device_state_batch(self) -> Optional[Batch]:
        if self._dev is None:
            return None
        keys_u64, _bins, accs = self._dev.snapshot()
        signed = keys_u64.view(np.int64)
        live = accs[self._count_lane] > 0
        signed, accs = signed[live], [a[live] for a in accs]
        if len(signed) == 0:
            return None
        n_agg = len(self.aggregates)
        cols: dict[str, np.ndarray] = {
            TIMESTAMP_FIELD: np.array(
                [self._last_update.get(int(h), self.max_event_time) for h in signed],
                dtype=np.int64),
            KEY_FIELD: signed.view(np.uint64),
            # an explicit __count keeps the layout loadable by the host mode
            "__count": accs[self._count_lane].astype(np.int64),
            "__has_emitted": np.array([int(h) in self._emitted for h in signed], dtype=bool),
        }
        for i, (a, d) in enumerate(zip(accs, self._dev_dtypes())):
            cols[f"__acc_{i}"] = a.astype(d)
        for i in range(n_agg):
            cols[f"__emitted_{i}"] = np.array([
                self._emitted[int(h)][i] if int(h) in self._emitted else 0 for h in signed])
        if self.key_fields:
            cols.update(self._key_columns(signed))
        return Batch(cols)

    def load_state_batch(self, b: Batch) -> None:
        """Load the rows of a ``"s"`` table (``state_batch``'s, or the JAX
        package's checkpoint rows of either mode) into this operator."""
        if self.device_mode:
            self._load_device(b)
            return
        hashes = b.keys.astype(np.uint64).view(np.int64)
        key_cols = [b[f] for f in self.key_fields]
        emitted_mask = b["__has_emitted"].astype(bool) if "__has_emitted" in b else None
        n_agg = len(self.aggregates)
        count_i = next((i for i, k in enumerate(self.acc_kinds) if k == "count"), None)
        for j in range(b.num_rows):
            h = int(hashes[j])
            accs = [
                {p[0]: p[1] for p in json.loads(b[f"__acc_{i}"][j])}
                if self.acc_kinds[i] == "collect"
                else d.type(b[f"__acc_{i}"][j])
                for i, d in enumerate(self.acc_dtypes)
            ]
            if "__count" in b:
                count = int(b["__count"][j])
            elif count_i is not None:
                count = int(accs[count_i])  # device-mode layout
            else:
                count = 1
            st = _KeyState(accs, count, int(b.timestamps[j]))
            if emitted_mask is not None and emitted_mask[j]:
                st.emitted = tuple(b[f"__emitted_{i}"][j] for i in range(n_agg))
            self.state[h] = st
            if self.key_fields:
                self.key_values[h] = tuple(c[j] for c in key_cols)

    def _load_device(self, b: Batch) -> None:
        hashes = b.keys.astype(np.uint64)
        signed = hashes.view(np.int64)
        accs = []
        for i, d in enumerate(self._dev_dtypes()):
            col = f"__acc_{i}"
            if col in b:
                accs.append(np.asarray(b[col]).astype(d))
            elif i == self._count_lane and "__count" in b:
                # host-mode layout: the count lane from __count
                accs.append(np.asarray(b["__count"]).astype(d))
            else:
                accs.append(np.zeros(b.num_rows, dtype=d))
        self._device().restore(hashes, np.zeros(len(signed), dtype=np.int32), accs)
        emitted_mask = (np.asarray(b["__has_emitted"], dtype=bool)
                        if "__has_emitted" in b else np.zeros(len(signed), bool))
        n_agg = len(self.aggregates)
        key_cols = [b[f] for f in self.key_fields]
        for j in range(b.num_rows):
            h = int(signed[j])
            self._last_update[h] = int(b.timestamps[j])
            if emitted_mask[j]:
                self._emitted[h] = tuple(b[f"__emitted_{i}"][j] for i in range(n_agg))
            if self.key_fields:
                self.key_values[h] = tuple(c[j] for c in key_cols)


def merge_updating_rows(rows: list[dict]) -> list[dict]:
    """Materialize an updating stream: apply retract/append pairs in order
    and return the surviving rows."""
    live: Counter = Counter()
    for r in rows:
        retract = bool(r.get(IS_RETRACT_FIELD, False))
        key = tuple(
            (k, v)
            for k, v in sorted(r.items())
            if k not in (IS_RETRACT_FIELD, TIMESTAMP_FIELD)
        )
        if retract:
            live[key] -= 1
        else:
            live[key] += 1
    out = []
    for key, cnt in live.items():
        for _ in range(cnt):
            out.append(dict(key))
    return out


@register_operator(OpName.UPDATING_AGGREGATE)
def _make_updating(cfg: dict):
    return UpdatingAggregate(cfg)
