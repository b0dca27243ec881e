"""Session window aggregate operator (the port's copy of
arroyo_tpu/windows/session.py).

Per-key sessions with gap merges: a session closes once the watermark
passes ``last_event + gap``. Every supported aggregate (sum/count/min/max/
avg, and collected ones such as COUNT(DISTINCT)) is mergeable, so each batch
is collapsed to provisional per-(key, run) partial accumulators with one
sort + segment-reduce, and only those partials hit the session merge. Open
sessions live in parallel numpy columns (key, min_ts, max_ts, acc...) and
gap-merging is one lexsort + segmented running-max scan per batch. It is
host numpy in both packages: no device kernel.

Checkpoints (the JAX package's tables): at a barrier ``state_batch`` becomes
the ``"s"`` table (row timestamp = the session's last event, so retention
``gap`` filters a restore) and the last watermark handled the ``"e"`` mark;
a restore loads them with ``load_state_batch``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Batch, object_column
from ..engine.engine import register_operator
from ..expr import eval_expr
from ..graph import OpName
from ..operators.base import Operator, TableSpec, persist_mark, restore_marks
from ..ops.aggregate import finalize_aggs
from ..types import Watermark
from .tumbling import WINDOW_END, WINDOW_START, acc_plan, dtype_of_from_config

# base for the exclusive running max: low enough that +gap never overflows
_REACH_MIN = np.iinfo(np.int64).min // 4


def _seg_cummax_excl(seg_new: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Exclusive segmented running max: out[i] = max(vals[j]) over j < i
    within i's segment (segments start where seg_new is True); _REACH_MIN at
    segment starts. Hillis-Steele segmented scan — O(n log n) in vectorized
    passes, no Python per-element work."""
    n = len(vals)
    out = np.empty(n, dtype=np.int64)
    out[0] = _REACH_MIN
    if n > 1:
        out[1:] = np.where(seg_new[1:], _REACH_MIN, vals[:-1])
    flag = seg_new.copy()
    d = 1
    while d < n:
        nxt = out.copy()
        np.maximum(out[d:], out[:-d], out=nxt[d:], where=~flag[d:])
        nflag = flag.copy()
        nflag[d:] |= flag[:-d]
        out, flag = nxt, nflag
        d *= 2
    return out


class SessionAggregate(Operator):
    """config: gap_micros, key_fields, aggregates: [(name, kind, Expr|None)],
    final_projection, input_dtype_of."""

    def __init__(self, cfg: dict):
        self.gap = int(cfg["gap_micros"])
        self.key_fields: list[str] = list(cfg.get("key_fields", ()))
        self.aggregates = cfg["aggregates"]
        self.final_projection = cfg.get("final_projection")
        dtype_of = dtype_of_from_config(cfg)
        self.acc_kinds, self.acc_dtypes, self.acc_inputs = acc_plan(
            self.aggregates, dtype_of, collect=True)
        # open sessions as parallel columns (sorted within each merge group)
        self.s_key = np.empty(0, dtype=np.int64)   # signed view of routing hash
        self.s_min = np.empty(0, dtype=np.int64)
        self.s_max = np.empty(0, dtype=np.int64)
        self.s_accs: list[np.ndarray] = [np.empty(0, dtype=d) for d in self.acc_dtypes]
        # per-key-field value columns; created lazily with the input's dtype
        self.s_keycols: Optional[list[np.ndarray]] = None
        self.emitted_watermark: Optional[int] = None
        # state: ephemeral — observability counter (obs/profile.py late_rows_of); never read into emitted data
        self.late_rows = 0

    # ------------------------------------------------------------------

    def tables(self):
        return [TableSpec("s", "expiring_time_key", retention_micros=self.gap),
                TableSpec("e", "global_keyed")]

    def on_start(self, ctx):
        if ctx.table_manager is None:
            return
        tbl = ctx.table_manager.expiring_time_key("s", self.gap)
        batches = tbl.all_batches()
        if batches:
            self.load_state_batch(Batch.concat(batches))
            tbl.replace_all([])
        wms = [v["emitted_watermark"] for v in restore_marks(ctx, "e")
               if v.get("emitted_watermark") is not None]
        if wms:
            # aligned barriers: every prior subtask saw the same watermark
            self.emitted_watermark = max(wms)

    def handle_checkpoint(self, barrier, ctx, collector):
        persist_mark(ctx, "e", {"emitted_watermark": self.emitted_watermark})
        b = self.state_batch()
        ctx.table_manager.expiring_time_key("s", self.gap).replace_all([] if b is None else [b])

    def load_state_batch(self, b: Batch) -> None:
        """Load open sessions from the rows of a ``"s"`` table
        (``state_batch``'s or the JAX package's checkpoint rows). Session
        columns use the SIGNED view of the routing hash; the same key's
        sessions from several batches coalesce."""
        key = b.keys.astype(np.uint64).view(np.int64)
        accs = []
        for i, d in enumerate(self.acc_dtypes):
            col = b[f"__acc_{i}"]
            if self.acc_kinds[i] == "collect":
                accs.append(object_column(list(v) for v in col))
            else:
                accs.append(np.asarray(col).astype(d, copy=True))
        keycols = [np.asarray(b[f]).copy() for f in self.key_fields]
        (self.s_key, self.s_min, self.s_max, self.s_accs, kc) = self._coalesce(
            key, np.asarray(b["__min_ts"], dtype=np.int64),
            np.asarray(b["__max_ts"], dtype=np.int64), accs, keycols)
        self.s_keycols = kc if self.key_fields else []

    # ------------------------------------------------------------------

    def _coalesce(self, key, mn, mx, accs, keycols):
        """Gap-merge candidate sessions (existing + new runs): one lexsort
        by (key, min_ts), an exclusive segmented running max of max_ts, and
        segment reduces for the accumulators."""
        order = np.lexsort((mn, key))
        key, mn, mx = key[order], mn[order], mx[order]
        n = len(key)
        seg_new = np.empty(n, dtype=bool)
        seg_new[0] = True
        seg_new[1:] = key[1:] != key[:-1]
        reach = _seg_cummax_excl(seg_new, mx)
        starts_new = seg_new | (mn > reach + self.gap)
        g0 = np.flatnonzero(starts_new)
        out_accs = []
        for kind, a in zip(self.acc_kinds, accs):
            a = a[order]
            if kind == "collect":
                ends = np.append(g0[1:], n)
                merged = []
                for s, e in zip(g0, ends):
                    if e - s == 1:
                        merged.append(a[s])
                    else:
                        acc: list = []
                        for lst in a[s:e]:
                            acc.extend(lst)
                        merged.append(acc)
                out_accs.append(object_column(merged))
            elif kind in ("sum", "count"):
                out_accs.append(np.add.reduceat(a, g0))
            elif kind == "min":
                out_accs.append(np.minimum.reduceat(a, g0))
            else:
                out_accs.append(np.maximum.reduceat(a, g0))
        # sorted by min_ts within each key: the group start holds the min
        return (key[g0], mn[g0], np.maximum.reduceat(mx, g0), out_accs,
                [c[order][g0] for c in keycols])

    def process_batch(self, batch, ctx, collector, input_index=0):
        n = batch.num_rows
        if n == 0:
            return
        ts = batch.timestamps
        if self.emitted_watermark is not None:
            # a row re-opens an already-emitted session iff the session it
            # would form has max_ts + gap <= emitted watermark, i.e. ts <= wm - gap
            late = ts <= self.emitted_watermark - self.gap
            if late.any():
                self.late_rows += int(late.sum())
                if late.all():
                    return
                batch = batch.filter(~late)
                ts = batch.timestamps
                n = batch.num_rows
        if KEY_FIELD in batch:
            hashes = batch.keys.astype(np.uint64)
        else:
            hashes = np.zeros(n, dtype=np.uint64)
        signed = hashes.view(np.int64)
        order = np.lexsort((ts, signed))
        k_s = signed[order]
        t_s = np.asarray(ts)[order]
        # provisional run breaks: key change or time gap > gap
        brk = np.ones(n, dtype=bool)
        if n > 1:
            brk[1:] = (k_s[1:] != k_s[:-1]) | ((t_s[1:] - t_s[:-1]) > self.gap)
        starts = np.flatnonzero(brk)
        ends = np.append(starts[1:], n)
        # per-accumulator values, segment-reduced per provisional run
        run_accs: list[np.ndarray] = []
        for inp, dt, kind in zip(self.acc_inputs, self.acc_dtypes, self.acc_kinds):
            if kind == "collect":
                v = np.asarray(eval_expr(inp, batch.columns, n))[order]
                run_accs.append(object_column(
                    v[si:ei].tolist() for si, ei in zip(starts, ends)))
                continue
            if inp is None:
                v = np.ones(n, dtype=dt)
            else:
                v = np.asarray(eval_expr(inp, batch.columns, n)).astype(dt)
            v = v[order]
            if kind in ("sum", "count"):
                run_accs.append(np.add.reduceat(v, starts))
            elif kind == "min":
                run_accs.append(np.minimum.reduceat(v, starts))
            else:
                run_accs.append(np.maximum.reduceat(v, starts))
        run_keycols = [np.asarray(batch[f])[order][starts] for f in self.key_fields]
        run_key, run_min, run_max = k_s[starts], t_s[starts], t_s[ends - 1]
        self._merge_runs(run_key, run_min, run_max, run_accs, run_keycols)

    def _merge_runs(self, r_key, r_min, r_max, r_accs, r_keycols) -> None:
        if self.s_keycols is None:
            self.s_keycols = [c[:0] for c in r_keycols]
        if len(self.s_key) == 0:
            # runs from one batch are already gap-separated per key
            self.s_key, self.s_min, self.s_max = r_key, r_min, r_max
            self.s_accs, self.s_keycols = list(r_accs), list(r_keycols)
            return
        # only sessions whose key appears in this batch can merge; leave the
        # (potentially much larger) untouched remainder alone
        touched = np.isin(self.s_key, r_key)
        if touched.any():
            t = touched
            key = np.concatenate([self.s_key[t], r_key])
            mn = np.concatenate([self.s_min[t], r_min])
            mx = np.concatenate([self.s_max[t], r_max])
            accs = [np.concatenate([sa[t], ra]) for sa, ra in zip(self.s_accs, r_accs)]
            kcs = [np.concatenate([sc[t], rc])
                   for sc, rc in zip(self.s_keycols, r_keycols)]
            m_key, m_min, m_max, m_accs, m_kcs = self._coalesce(key, mn, mx, accs, kcs)
            keep = ~touched
            self.s_key = np.concatenate([self.s_key[keep], m_key])
            self.s_min = np.concatenate([self.s_min[keep], m_min])
            self.s_max = np.concatenate([self.s_max[keep], m_max])
            self.s_accs = [np.concatenate([sa[keep], ma])
                           for sa, ma in zip(self.s_accs, m_accs)]
            self.s_keycols = [np.concatenate([sc[keep], mc])
                              for sc, mc in zip(self.s_keycols, m_kcs)]
        else:
            self.s_key = np.concatenate([self.s_key, r_key])
            self.s_min = np.concatenate([self.s_min, r_min])
            self.s_max = np.concatenate([self.s_max, r_max])
            self.s_accs = [np.concatenate([sa, ra])
                           for sa, ra in zip(self.s_accs, r_accs)]
            self.s_keycols = [np.concatenate([sc, rc])
                              for sc, rc in zip(self.s_keycols, r_keycols)]

    # ------------------------------------------------------------------

    def handle_watermark(self, watermark, ctx, collector):
        if watermark.is_idle:
            return watermark
        self._emit_closed(watermark.value, collector)
        self.emitted_watermark = watermark.value
        # future emissions are stamped window_start = session min_ts: open
        # sessions may hold arbitrarily old starts, and brand-new sessions
        # can begin at ts > w - gap; forward the lower bound (see tumbling)
        held = watermark.value - self.gap
        if len(self.s_min):
            held = min(held, int(self.s_min.min()))
        return Watermark.event_time(held)

    def on_close(self, ctx, collector):
        self._emit_closed(None, collector)

    def _emit_closed(self, watermark: Optional[int], collector) -> None:
        if len(self.s_key) == 0:
            return
        if watermark is None:
            closed = np.ones(len(self.s_key), dtype=bool)
        else:
            closed = self.s_max + self.gap <= watermark
        if not closed.any():
            return
        self._emit_rows(closed, collector)
        keep = ~closed
        self.s_key, self.s_min, self.s_max = (
            self.s_key[keep], self.s_min[keep], self.s_max[keep])
        self.s_accs = [a[keep] for a in self.s_accs]
        self.s_keycols = [c[keep] for c in self.s_keycols]

    def _emit_rows(self, closed: np.ndarray, collector) -> None:
        mn, mx, key = self.s_min[closed], self.s_max[closed], self.s_key[closed]
        # deterministic emission order: by (window_start, key); one fused
        # gather index instead of mask-then-permute per column
        idx = np.flatnonzero(closed)[np.lexsort((key, mn))]
        starts = self.s_min[idx]
        n = len(starts)
        cols: dict[str, np.ndarray] = {}
        for f, c in zip(self.key_fields, self.s_keycols):
            cols[f] = c[idx]
        cols[WINDOW_START] = starts
        cols[WINDOW_END] = self.s_max[idx] + self.gap
        finals = finalize_aggs([a[1] for a in self.aggregates],
                               [a[idx] for a in self.s_accs])
        for (name, _k, _e), arr in zip(self.aggregates, finals):
            cols[name] = arr
        cols[TIMESTAMP_FIELD] = starts
        out = Batch(cols)
        if self.final_projection is not None:
            proj = {
                name: eval_expr(e, out.columns, n) for name, e in self.final_projection
            }
            if TIMESTAMP_FIELD not in proj:
                proj[TIMESTAMP_FIELD] = out.timestamps
            out = Batch(proj)
        collector.collect(out)

    # ------------------------------------------------------------------

    def state_batch(self) -> Optional[Batch]:
        """The open sessions as the JAX package writes its ``"s"``
        checkpoint table, or None when none is open; ``emitted_watermark``
        (its ``"e"`` mark) is kept apart."""
        n = len(self.s_key)
        if n == 0:
            return None
        cols: dict[str, np.ndarray] = {
            TIMESTAMP_FIELD: self.s_max.copy(),
            KEY_FIELD: self.s_key.view(np.uint64).copy(),
            "__min_ts": self.s_min.copy(),
            "__max_ts": self.s_max.copy(),
        }
        for i, kind in enumerate(self.acc_kinds):
            if kind == "collect":
                cols[f"__acc_{i}"] = object_column(list(v) for v in self.s_accs[i])
            else:
                cols[f"__acc_{i}"] = self.s_accs[i].copy()
        for f, c in zip(self.key_fields, self.s_keycols):
            cols[f] = c.copy()
        return Batch(cols)


@register_operator(OpName.SESSION_AGGREGATE)
def _make_session(cfg: dict):
    return SessionAggregate(cfg)
