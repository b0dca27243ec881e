"""Runtime cost attribution: where CPU, state, and traffic actually live
(the port's copy of arroyo_tpu/obs/profile.py).

This layer answers three questions: which operator burns the time, which
table holds the state, which keys are hot. Three coordinated signal families, all
owned by the task run loop and exported through the existing
``TaskMetrics`` -> ``job_metrics`` -> controller-DB path:

  self-time     ``TaskProfiler.begin()/end(category)`` wraps every operator
                hook (process/tick/close/checkpoint) with wall
                (``time.perf_counter``) + thread-CPU (``time.thread_time``)
                accounting. busy% = total self wall / subtask uptime;
                cost-per-row = process self-time / rows received. Both are
                derived at EXPORT time — the hot path only accumulates two
                floats per hook call.
  state sizes   ``TaskProfiler.refresh()`` walks the subtask's TableManager
                (plus any live columnar stores the operator exposes via a
                ``state_sizes()`` hook — e.g. the updating join's
                _SideStore) into ``arroyo_state_rows``/``arroyo_state_bytes``
                gauges per table, throttled to ~1/s. Device-resident window
                state mirrors into host tables at barrier time, so those
                gauges read "as of the last checkpoint"; live host stores
                (join side stores) override with their current size.
  key skew      the per-subtask ``obs.sketch.KeySketch`` is fed from
                exactly ONE boundary per operator: the shuffle boundary
                (operators/collector.py keyed repartition) for operators
                that keyed-shuffle their output, else the keyed-insert
                boundary (the run loop, for input batches carrying
                ``_key``) — never both, so one sketch never mixes two hash
                spaces. Its summary checkpoints into a ``__sketch`` global
                table so a restored run rebuilds the exact summary the
                original would have had.

Everything here is attribution for the NEXT PRs: the spill backend reads
the state gauges, the skew-adaptive shuffle reads the hot-key summaries,
the autoscaler reads busy%. ``job_profile`` folds a merged metrics snapshot
into the compact per-job profile the controller persists (``job_profiles``
table) and the API serves at ``GET /api/v1/jobs/<id>/profile``;
``render_explain`` is the terminal EXPLAIN ANALYZE view over a plan graph.

On the card, an operator hook's wall self-time is the time of its host
work and its kernel launches, which are asynchronous: the kernels' own
time shows in it only where the hook waits on a result (a window close's
fetch). The profiler never synchronizes to turn it into device time.
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import Optional

from ..config import config
from . import fmt
from .sketch import KeySketch, merge_topk

# global-keyed table the key-skew summary checkpoints into (one entry per
# subtask index; rides the normal TableManager snapshot/restore path)
SKETCH_TABLE = "__sketch"

# the key-skew sketch of each subtask: space-saving summary entries, and a
# count of 1/N batches (1 is row-deterministic under replay). The JAX
# package's ``profile.sketch.*`` defaults; its ``__sketch`` state carries
# both, so checkpoints cross between the packages unchanged
SKETCH_CAPACITY = 64
SKETCH_SAMPLE_EVERY = 1

# state-gauge refresh throttle: the walk is O(tables), cheap, but there is
# no reason to pay it per batch when consumers read at ~1 Hz
REFRESH_INTERVAL_S = 1.0


def late_rows_of(op) -> int:
    """Late/expired-row drops an operator has accumulated (window operators
    and joins track ``late_rows``; chains sum their members')."""
    return int(getattr(op, "late_rows", 0) or 0)


def _approx_dict_bytes(data: dict) -> int:
    """Approximate heap bytes of a global-keyed table: sample up to 64
    entries for an average entry size (deterministic: insertion order)."""
    n = len(data)
    if not n:
        return 0
    sample = list(itertools.islice(data.items(), 64))
    per = sum(sys.getsizeof(k) + sys.getsizeof(v) for k, v in sample)
    return int(per * n / len(sample))


class TaskProfiler:
    """Per-subtask cost-attribution hooks, owned by the task run loop.

    Single-writer like TaskMetrics (only the task thread calls these);
    ``begin``/``end`` are the only per-hook cost when profiling is on.
    """

    __slots__ = ("metrics", "op", "table_manager", "_last_refresh",
                 "_source_cpu_mark")

    def __init__(self, metrics, op, table_manager):
        self.metrics = metrics
        self.op = op
        self.table_manager = table_manager
        self._last_refresh = 0.0
        self._source_cpu_mark: Optional[float] = None

    # ----------------------------------------------------------- self-time

    def begin(self) -> tuple:
        return (time.perf_counter(), time.thread_time())

    def end(self, category: str, t0: tuple) -> None:
        self.metrics.self_time[category] += time.perf_counter() - t0[0]
        self.metrics.self_cpu[category] += time.thread_time() - t0[1]

    def source_tick(self) -> None:
        """Incremental source attribution, called from the connector poll
        path (and once more when run() returns): accumulate the thread-CPU
        spent since the last tick so LIVE snapshots of a streaming source
        carry its busy% — waiting for run() to return would report 0 for
        the whole job. Source run loops block in poll waits, so wall
        self-time would read ~100% by construction; thread-CPU is the
        honest busy signal and is recorded as BOTH series."""
        now = time.thread_time()
        if self._source_cpu_mark is not None:
            d = now - self._source_cpu_mark
            self.metrics.self_time["process"] += d
            self.metrics.self_cpu["process"] += d
        self._source_cpu_mark = now

    def source_reset(self) -> None:
        """Re-stamp the source CPU mark after work attributed to another
        category (a checkpoint inside the source run loop), so the next
        source_tick does not double-count it into "process"."""
        self._source_cpu_mark = time.thread_time()

    # ------------------------------------------------------------ key skew

    def observe_keys(self, keys) -> None:
        sk = self.metrics.sketch
        if sk is not None:
            sk.observe(keys)

    def checkpoint_sketch(self) -> None:
        """Persist the sketch summary into the ``__sketch`` global table
        (called just before the TableManager snapshot)."""
        sk = self.metrics.sketch
        if sk is not None and sk.total:
            self.table_manager.global_keyed(SKETCH_TABLE).insert(
                self.metrics.subtask, sk.state())

    # --------------------------------------------------------- state sizes

    def refresh(self, force: bool = False) -> None:
        """Refresh late-row counter + per-table state gauges (throttled)."""
        now = time.monotonic()
        if not force and now - self._last_refresh < REFRESH_INTERVAL_S:
            return
        self._last_refresh = now
        m = self.metrics
        m.late_rows = late_rows_of(self.op)
        rows: dict[str, int] = {}
        nbytes: dict[str, int] = {}
        tm = self.table_manager
        for name, tbl in (tm.globals.items() if tm is not None else ()):
            if name == SKETCH_TABLE:
                continue  # profiler bookkeeping, not operator state
            rows[name] = len(tbl.data)
            nbytes[name] = _approx_dict_bytes(tbl.data)
        for name, tbl in (tm.expiring.items() if tm is not None else ()):
            rows[name] = tbl.total_rows()
            nbytes[name] = sum(b.nbytes() for b in tbl.batches)
        sizes = getattr(self.op, "state_sizes", None)
        if sizes is not None:
            # live columnar stores (e.g. the updating join's _SideStore)
            # override the table-manager view — between barriers the host
            # tables lag the operator's resident state
            for name, (r, by) in sizes().items():
                rows[name] = int(r)
                nbytes[name] = int(by)
        m.state_rows = rows
        m.state_bytes = nbytes
        spill = getattr(self.op, "spill_stats", None)
        if spill is not None:
            # tiered state (state/spill.py): spilled bytes, hot/cold
            # partition split, and probe-pruning histogram -> arroyo_spill_*
            m.spill = spill()
        mesh = getattr(self.op, "mesh_stats", None)
        if mesh is not None:
            # sharded mesh execution (parallel/sharded_agg.py): exchange
            # throughput + spill-buffer residency -> arroyo_mesh_*
            m.mesh = mesh()


def make_profiler(metrics, task_info, table_manager, op) -> Optional[TaskProfiler]:
    """Build the task's profiler + sketch per ``profile.enabled``; returns
    None when profiling is disabled (the run loop then has zero added work).
    Restores the sketch from the checkpointed ``__sketch`` table — ONLY this
    subtask's own entry: global tables replicate every subtask's entry on
    restore, and merging them all would multiply the operator-level merge by
    the parallelism. A rescale therefore restarts the sketch from empty
    (it is a rolling traffic estimate, not exact state)."""
    if not config().get("profile.enabled", True):
        metrics.sketch = None
        return None
    sk = KeySketch(
        capacity=SKETCH_CAPACITY,
        sample_every=SKETCH_SAMPLE_EVERY,
        seed=task_info.subtask_index,
    )
    persisted = (None if table_manager is None
                 else table_manager.globals.get(SKETCH_TABLE))
    if persisted is not None:
        sk.merge_state(persisted.get(task_info.subtask_index))
    metrics.sketch = sk
    return TaskProfiler(metrics, op, table_manager)


# ------------------------------------------------------------ job profile


def job_profile(metrics: Optional[dict]) -> dict:
    """Fold a merged per-operator metrics snapshot (metrics.job_metrics /
    merge_job_metrics output) into the compact per-job profile the
    controller persists and ``/profile`` serves. Pure selection/derivation —
    every number already exists in the snapshot."""
    out: dict[str, dict] = {}
    for op, m in (metrics or {}).items():
        if not isinstance(m, dict):
            continue
        per = {
            s: {k: d.get(k) for k in ("busy_pct", "self_time", "late_rows")
                if d.get(k) is not None}
            for s, d in (m.get("per_subtask") or {}).items()
            if isinstance(d, dict)
        }
        out[op] = {
            "subtasks": m.get("subtasks", len(per) or 1),
            "rows_in_per_sec": m.get("messages_recv_per_sec", 0.0),
            "rows_out_per_sec": m.get("messages_per_sec", 0.0),
            "busy_pct": m.get("busy_pct"),
            "self_time": m.get("self_time") or {},
            "self_cpu": m.get("self_cpu") or {},
            "self_us_per_row": m.get("self_us_per_row"),
            "late_rows": int(m.get("late_rows") or 0),
            "state_rows": m.get("state_rows") or {},
            "state_bytes": m.get("state_bytes") or {},
            "hot_keys": m.get("hot_keys") or [],
            "per_subtask": per,
        }
        if m.get("segment_compiled"):
            out[op]["segment_compiled"] = True
        if m.get("segment_mesh"):
            out[op]["segment_mesh"] = True
        if m.get("segment_reason"):
            out[op]["segment_reason"] = m["segment_reason"]
        if m.get("mesh"):
            out[op]["mesh"] = m["mesh"]
    return out


def aggregate_profiles(per_subtask: dict[str, dict]) -> dict:
    """Fold per-subtask profile fields into one operator row: self-time and
    counters sum, busy% takes the worst subtask, hot-key summaries merge via
    the space-saving union. Used by metrics._op_aggregate so a multi-worker
    set's union-by-subtask snapshot aggregates exactly like a local one."""
    self_time: dict[str, float] = {}
    self_cpu: dict[str, float] = {}
    state_rows: dict[str, int] = {}
    state_bytes: dict[str, int] = {}
    late = 0
    busy = None
    topks, sketch_total = [], 0
    for s in per_subtask.values():
        for cat, v in (s.get("self_time") or {}).items():
            self_time[cat] = self_time.get(cat, 0.0) + float(v)
        for cat, v in (s.get("self_cpu") or {}).items():
            self_cpu[cat] = self_cpu.get(cat, 0.0) + float(v)
        for t, v in (s.get("state_rows") or {}).items():
            state_rows[t] = state_rows.get(t, 0) + int(v)
        for t, v in (s.get("state_bytes") or {}).items():
            state_bytes[t] = state_bytes.get(t, 0) + int(v)
        late += int(s.get("late_rows") or 0)
        b = s.get("busy_pct")
        if b is not None and (busy is None or b > busy):
            busy = b
        hot = s.get("hot_keys")
        if hot:
            topks.append(hot)
            sketch_total += int(s.get("sketch_total") or 0)
    out: dict = {}
    if self_time:
        out["self_time"] = {c: round(v, 6) for c, v in self_time.items()}
        out["self_cpu"] = {c: round(v, 6) for c, v in self_cpu.items()}
    if busy is not None:
        out["busy_pct"] = busy
    out["late_rows"] = late
    if state_rows:
        out["state_rows"] = state_rows
        out["state_bytes"] = state_bytes
    if topks:
        out["hot_keys"] = merge_topk(topks, sketch_total)
        out["sketch_total"] = sketch_total
    return out


# --------------------------------------------------------- EXPLAIN ANALYZE


def _fmt_rate(v) -> str:
    return fmt.fmt_rate(v, per_sec=True)


def _fmt_bytes(v) -> str:
    return fmt.fmt_bytes(v, spaced=True)


def _annotations(prof: dict) -> list[str]:
    """The per-operator annotation lines under a plan node."""
    lines = []
    head = (f"busy {prof['busy_pct']:.1f}%" if prof.get("busy_pct") is not None
            else "busy -")
    if prof.get("segment_compiled"):
        # whole-segment compilation: this row's self-time is ONE fused
        # kernel launch covering every chained member, not a per-member sum
        head = "[compiled] " + head
        if prof.get("segment_mesh"):
            # fused mesh execution: that one launch covers the keyed
            # exchange + state update too
            head = "[mesh] " + head
    elif prof.get("segment_reason"):
        # the plan-time reject or runtime fallback reason: the segment is
        # interpreted, and this line says why (AR009 / SEGMENT_FALLBACK)
        head = f"[not compiled: {prof['segment_reason']}] " + head
    head += (f"   in {_fmt_rate(prof.get('rows_in_per_sec'))}"
             f"   out {_fmt_rate(prof.get('rows_out_per_sec'))}")
    st = prof.get("self_time") or {}
    busy_cats = "  ".join(f"{c} {v:.2f}s" for c, v in
                          sorted(st.items(), key=lambda kv: -kv[1]) if v)
    if busy_cats:
        head += f"   self: {busy_cats}"
    if prof.get("self_us_per_row") is not None:
        head += f"   {prof['self_us_per_row']:.2f}us/row"
    lines.append(head)
    rows = prof.get("state_rows") or {}
    if rows:
        parts = "  ".join(
            f"{t} {rows[t]:,} rows/{_fmt_bytes((prof.get('state_bytes') or {}).get(t, 0))}"
            for t in sorted(rows))
        lines.append(f"state: {parts}")
    if prof.get("late_rows"):
        lines.append(f"late rows dropped: {prof['late_rows']:,}")
    hot = prof.get("hot_keys") or []
    if hot:
        parts = "  ".join(
            f"{e['key'][:6]}..{e['key'][-4:]} {100 * e.get('share', 0):.1f}%"
            for e in hot[:5])
        lines.append(f"hot keys: {parts}")
    return lines


def render_explain(nodes: list[dict], edges: list[dict], profile: dict,
                   job: Optional[dict] = None) -> str:
    """EXPLAIN ANALYZE over the logical plan: the dataflow DAG rendered
    sink-first (each ``->`` line is one operator, inputs nested beneath it),
    annotated with the live profile — the reference's
    pipeline-graph-with-metrics UI view, in the terminal.

    ``nodes``: [{id, op, description?, parallelism}], ``edges``:
    [{src, dst}] (the /pipelines/<id>/graph shape); ``profile``: the
    ``job_profile`` dict keyed by operator/node id."""
    lines: list[str] = []
    if job is not None:
        lines.append(
            f"EXPLAIN ANALYZE job {job.get('id', '?')}  "
            f"state={job.get('state', '?')}  "
            f"workers={job.get('n_workers', 1)}  "
            f"epoch={job.get('checkpoint_epoch', 0)}  "
            f"restarts={job.get('restarts', 0)}")
    by_id = {n["id"]: n for n in nodes}
    inputs: dict[str, list[str]] = {n["id"]: [] for n in nodes}
    has_out: set[str] = set()
    for e in edges:
        inputs.setdefault(e["dst"], []).append(e["src"])
        has_out.add(e["src"])
    sinks = [nid for nid in by_id if nid not in has_out] or list(by_id)
    seen: set[str] = set()

    def emit(nid: str, depth: int) -> None:
        pad = "   " * depth
        n = by_id.get(nid, {"id": nid, "op": "?", "parallelism": "?"})
        desc = n.get("description") or n.get("op", "")
        label = f"{pad}-> {nid} [{desc} x{n.get('parallelism', '?')}]"
        if nid in seen:
            lines.append(label + "  (shown above)")
            return
        seen.add(nid)
        lines.append(label)
        prof = profile.get(nid)
        if prof:
            for a in _annotations(prof):
                lines.append(f"{pad}     {a}")
        elif n.get("not_compilable"):
            # no runtime profile yet: the plan-time verdict still explains
            # why this chained run will never compile
            lines.append(f"{pad}     [{n['not_compilable']}]")
        for src in inputs.get(nid, []):
            emit(src, depth + 1)

    for s in sinks:
        emit(s, 0)
    # operators in the profile but not the plan (e.g. a plan re-derived with
    # different chaining than the run used) still deserve their numbers
    for op in sorted(set(profile) - seen):
        lines.append(f"-> {op} [not in plan]")
        for a in _annotations(profile[op]):
            lines.append(f"     {a}")
    return "\n".join(lines)
