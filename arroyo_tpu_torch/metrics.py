"""Task metrics: counters, gauges and histograms with Prometheus text
exposition (the port's copy of arroyo_tpu/metrics.py: the same names,
fields, bucket tuples, series and labels).

Per subtask (``TaskMetrics``, one writer: the task thread): the worker
counters ``arroyo_worker_{messages,batches,bytes}_{recv,sent}``, the inbox
gauges (backpressure = 1 - rem/size), the emitted-batch-size, queue-transit
and sink end-to-end event-latency histograms, the merged watermark (lag is
derived at export), self-time per category in wall and thread-CPU seconds,
late rows, state-size gauges per table, the key-skew sketch, the tiered
state's spill block, the compiled segment's flags and the sharded
aggregate's residency. Per job (``MetricsRegistry``): segment build times
and compile-cache hits, checkpoint phase histograms, dropped bad records,
and the job-health / autoscaler / fleet gauges (set by a control plane the
port does not have yet; ``prometheus_text`` reads them all). The port's
task metrics also count ``segment_batches``: batches that ran through the
segment kernel (K4). No Prometheus client dependency: the text format is
trivial.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Optional

_COUNTER_NAMES = (
    "arroyo_worker_messages_recv",
    "arroyo_worker_messages_sent",
    "arroyo_worker_batches_recv",
    "arroyo_worker_batches_sent",
    "arroyo_worker_bytes_recv",
    "arroyo_worker_bytes_sent",
    "arroyo_worker_deserialization_errors",
)


class Histogram:
    """Fixed-bucket histogram (single writer, like the counters)."""

    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets: tuple):
        self.buckets = buckets  # ascending upper bounds; +Inf is implicit
        self.counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _quantile(self, q: float) -> tuple[float, bool]:
        """(estimate, overflow): overflow=True means the quantile landed in
        the +Inf bucket and the estimate is clamped to the largest finite
        bound (a lower bound on the true value)."""
        if not self.count:
            return 0.0, False
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i < len(self.buckets):
                    return float(self.buckets[i]), False
                break
        return float(self.buckets[-1]), True

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (coalesce
        breakdown lines; not exported — prometheus consumers use _bucket).
        Overflow-bucket hits clamp to the largest finite bound instead of
        returning inf, so downstream arithmetic (bench breakdown lines,
        `top` columns) stays finite/parseable; use quantile_str to surface
        the clamp."""
        return self._quantile(q)[0]

    def quantile_str(self, q: float, scale: float = 1.0,
                     precision: int = 2) -> str:
        """quantile(q) * scale formatted for breakdown lines; a clamped
        overflow estimate is flagged with a leading '>' (it is only a
        lower bound)."""
        v, overflow = self._quantile(q)
        s = f"{v * scale:.{precision}f}"
        return f">{s}" if overflow else s


# emitted batch sizes in rows (powers of two to the queue-budget scale)
EMIT_ROWS_BUCKETS = tuple(1 << i for i in range(17))  # 1 .. 65536
# queue-transit wall latency in seconds (100us .. 2.5s)
TRANSIT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# sink-side end-to-end event latency (wall clock at the sink minus the
# event's _timestamp): real deployments sit in the ms..minutes range;
# synthetic generators with epoch-0 timestamps land in the overflow bucket,
# which quantile() clamps (flagged '>' by quantile_str)
SINK_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0, 3600.0)
# checkpoint phase durations (align/snapshot/ack/commit), seconds
PHASE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
_HISTOGRAM_NAMES = ("arroyo_worker_emit_batch_rows",
                    "arroyo_worker_queue_transit_seconds",
                    "arroyo_worker_sink_event_latency_seconds")
# hot keys exported per operator (the JAX package's profile.sketch.topk)
HOT_KEYS_TOPK = 5

CHECKPOINT_PHASES = ("align", "snapshot", "ack", "commit")
# self-time categories the task run loop attributes operator work to
# watermark handling (window closes) counts as "process" —
# it is data-path work driven by the stream, not bookkeeping
SELF_TIME_CATEGORIES = ("process", "tick", "close", "checkpoint")
# the arroyo_job_health gauge's encoding of a job's health state
_HEALTH_RANK = {"ok": 0, "degraded": 1, "critical": 2}


class TaskMetrics:
    """Per-subtask counters (lock-free: single writer per task thread)."""

    __slots__ = ("job_id", "node_id", "subtask", "counters", "queue_size",
                 "queue_rem", "emit_batch_rows", "queue_transit",
                 "sink_event_latency", "watermark_micros", "self_time",
                 "self_cpu", "late_rows", "state_rows", "state_bytes",
                 "sketch", "started_monotonic", "segment_compiled",
                 "segment_reason", "spill", "segment_mesh", "mesh",
                 "segment_batches")

    def __init__(self, job_id: str, node_id: str, subtask: int):
        self.job_id = job_id
        self.node_id = node_id
        self.subtask = subtask
        self.counters = dict.fromkeys(_COUNTER_NAMES, 0)
        self.queue_size = 0
        self.queue_rem = 0
        # coalescing instrumentation: per-operator emitted-batch-size and
        # inbox transit-latency distributions
        self.emit_batch_rows = Histogram(EMIT_ROWS_BUCKETS)
        self.queue_transit = Histogram(TRANSIT_BUCKETS)
        # event-time health: the task run loop stamps the current
        # merged watermark here; lag (= processing time minus watermark,
        # reference arroyo-metrics) is derived at export time. Sinks observe
        # per-batch end-to-end event latency.
        self.sink_event_latency = Histogram(SINK_LATENCY_BUCKETS)
        self.watermark_micros: Optional[int] = None
        # cost attribution, written only by the owning task
        # thread: wall + thread-CPU self-time seconds per category, the
        # late/expired-row counter, live state-size gauges per table, and
        # the key-skew sketch (obs.sketch.KeySketch, attached by the task
        # when profiling is enabled). busy%, cost-per-row, and hot-key
        # shares are derived at export time — never in the hot path.
        self.self_time = dict.fromkeys(SELF_TIME_CATEGORIES, 0.0)
        self.self_cpu = dict.fromkeys(SELF_TIME_CATEGORIES, 0.0)
        self.late_rows = 0
        self.state_rows: dict[str, int] = {}
        self.state_bytes: dict[str, int] = {}
        self.sketch = None
        self.started_monotonic = time.monotonic()
        # whole-segment compilation (engine/segment.py): True once this
        # subtask's chained segment runs as one fused kernel, False after a
        # fallback, None for operators the compiler never considered —
        # `top` and `explain` render the [compiled] marker from this
        self.segment_compiled: Optional[bool] = None
        # why the segment is NOT compiled: the plan-time reject reason
        # (optimizer.chain_graph "not compilable: ...") or the runtime
        # fallback reason (SEGMENT_FALLBACK) — `top` and `explain` render
        # it next to the [compiled] marker
        self.segment_reason: Optional[str] = None
        # tiered state (state/spill.py): {"bytes_total", "hot", "cold",
        # "probe_files": Histogram}, set by TaskProfiler.refresh from the
        # operator's spill_stats() hook; None while nothing ever spilled
        self.spill: Optional[dict] = None
        # fused mesh execution (engine/segment.py mesh path): True once
        # this subtask committed a micro-batch through the fused mesh
        # step — `top`/`explain` render the [mesh] marker from this
        self.segment_mesh: Optional[bool] = None
        # sharded-aggregate residency: {"exchange_rows", "overflow_rows"},
        # set by TaskProfiler.refresh from the operator's mesh_stats()
        # hook; None off the mesh path -> arroyo_mesh_* series
        self.mesh: Optional[dict] = None
        # batches this subtask ran through the segment kernel (K4)
        self.segment_batches = 0

    def histogram(self, name: str) -> Histogram:
        # explicit mapping: an unknown/typoed name must fail loudly at the
        # first export, not silently serve another series' counts
        return {
            "arroyo_worker_emit_batch_rows": self.emit_batch_rows,
            "arroyo_worker_queue_transit_seconds": self.queue_transit,
            "arroyo_worker_sink_event_latency_seconds": self.sink_event_latency,
        }[name]

    def add(self, name: str, v: int = 1) -> None:
        self.counters[name] += v

    def backpressure(self) -> float:
        """1 - queue_remaining/queue_size (reference job_metrics.rs:95)."""
        if self.queue_size <= 0:
            return 0.0
        return max(0.0, 1.0 - self.queue_rem / self.queue_size)

    def watermark_lag_seconds(self, now_us: Optional[float] = None) -> Optional[float]:
        """Processing time minus current event-time watermark (seconds);
        None until a watermark reached this subtask."""
        if self.watermark_micros is None:
            return None
        now_us = time.time() * 1e6 if now_us is None else now_us
        return max(0.0, (now_us - self.watermark_micros) / 1e6)

    def uptime_seconds(self) -> float:
        return max(1e-9, time.monotonic() - self.started_monotonic)


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[tuple[str, str, int], TaskMetrics] = {}
        # (job_id, phase) -> Histogram of per-epoch phase durations; fed by
        # whoever declares an epoch durable (engine single-worker, the
        # controller's coordinator otherwise) from the epoch trace
        self._phases: dict[tuple[str, str], Histogram] = {}
        # job_id -> ok|degraded|critical, set by the controller's health
        # monitors each supervision tick (obs/health.py)
        self._job_health: dict[str, str] = {}
        # job_id -> target parallelism, set by the controller's elastic
        # autoscaler (controller/autoscaler.py) when enabled: the in-flight
        # target while a scale actuates, else the current parallelism
        self._autoscaler_target: dict[str, int] = {}
        # whole-segment compilation (engine/segment.py): per-job histogram
        # of K4 source-generation + build wall seconds (one observation per compiled
        # (segment, schema, padded-shape)), and the compile-cache hit count
        self._segment_compile: dict[str, Histogram] = {}
        self._segment_cache_hits: dict[str, int] = {}
        # multi-tenant fleet snapshot (controller/fleet.py stats()), set
        # once per ControllerServer tick; None until a fleet pass ran
        self._fleet: Optional[dict] = None
        # (job_id, operator) -> records dropped under bad_data=drop; fed by
        # the shared deserializer policy (formats/base.py) so every
        # connector counts drops identically
        self._bad_records: dict[tuple[str, str], int] = {}

    def set_job_health(self, job_id: str, state: str) -> None:
        with self._lock:
            self._job_health[job_id] = state

    def set_autoscaler_target(self, job_id: str, target: int) -> None:
        with self._lock:
            self._autoscaler_target[job_id] = int(target)

    def set_fleet_stats(self, stats: Optional[dict]) -> None:
        with self._lock:
            self._fleet = stats

    def add_bad_record(self, job_id: str, operator: str, n: int = 1) -> None:
        key = (job_id, operator)
        with self._lock:
            self._bad_records[key] = self._bad_records.get(key, 0) + int(n)

    def bad_records(self, job_id: str) -> dict[str, int]:
        """operator -> dropped-record count for one job (API/test probe)."""
        with self._lock:
            return {op: n for (j, op), n in self._bad_records.items()
                    if j == job_id}

    def task(self, job_id: str, node_id: str, subtask: int) -> TaskMetrics:
        key = (job_id, node_id, subtask)
        with self._lock:
            tm = self._tasks.get(key)
            if tm is None:
                tm = TaskMetrics(job_id, node_id, subtask)
                self._tasks[key] = tm
            return tm

    def observe_segment_compile(self, job_id: str, seconds: float) -> None:
        with self._lock:
            h = self._segment_compile.get(job_id)
            if h is None:
                h = self._segment_compile[job_id] = Histogram(PHASE_BUCKETS)
            h.observe(float(seconds))

    def add_segment_cache_hit(self, job_id: str) -> None:
        with self._lock:
            self._segment_cache_hits[job_id] = \
                self._segment_cache_hits.get(job_id, 0) + 1

    def segment_compile_stats(self, job_id: str) -> tuple[int, int]:
        """(compiles observed, cache hits) for one job — test/CLI probe."""
        with self._lock:
            h = self._segment_compile.get(job_id)
            return (h.count if h else 0,
                    self._segment_cache_hits.get(job_id, 0))

    def observe_epoch_phases(self, job_id: str, phases: dict) -> None:
        """Record one completed epoch's phase durations (seconds)."""
        with self._lock:
            for phase, secs in phases.items():
                if phase not in CHECKPOINT_PHASES:
                    continue
                h = self._phases.get((job_id, phase))
                if h is None:
                    h = self._phases[(job_id, phase)] = Histogram(PHASE_BUCKETS)
                h.observe(float(secs))

    def phase_histograms(self, job_id: str) -> dict[str, Histogram]:
        with self._lock:
            return {p: h for (j, p), h in self._phases.items() if j == job_id}

    def snapshot(self) -> list[TaskMetrics]:
        with self._lock:
            return list(self._tasks.values())

    def clear_job(self, job_id: str) -> None:
        with self._lock:
            self._tasks = {
                k: v for k, v in self._tasks.items() if k[0] != job_id
            }
            self._phases = {
                k: v for k, v in self._phases.items() if k[0] != job_id
            }
            self._job_health.pop(job_id, None)
            self._autoscaler_target.pop(job_id, None)
            self._segment_compile.pop(job_id, None)
            self._segment_cache_hits.pop(job_id, None)
            self._bad_records = {
                k: v for k, v in self._bad_records.items() if k[0] != job_id
            }

    def prometheus_text(self) -> str:
        """Prometheus exposition format (served at /metrics)."""
        lines: list[str] = []
        tasks = self.snapshot()
        for name in _COUNTER_NAMES:
            lines.append(f"# TYPE {name} counter")
            for t in tasks:
                lines.append(
                    f'{name}{{job="{t.job_id}",operator="{t.node_id}",'
                    f'subtask="{t.subtask}"}} {t.counters[name]}'
                )
        lines.append("# TYPE arroyo_worker_tx_queue_size gauge")
        lines.append("# TYPE arroyo_worker_tx_queue_rem gauge")
        for t in tasks:
            label = (f'job="{t.job_id}",operator="{t.node_id}",'
                     f'subtask="{t.subtask}"')
            lines.append(f"arroyo_worker_tx_queue_size{{{label}}} {t.queue_size}")
            lines.append(f"arroyo_worker_tx_queue_rem{{{label}}} {t.queue_rem}")
        lines.append("# TYPE arroyo_worker_watermark_lag_seconds gauge")
        now_us = time.time() * 1e6
        for t in tasks:
            lag = t.watermark_lag_seconds(now_us)
            if lag is None:
                continue
            label = (f'job="{t.job_id}",operator="{t.node_id}",'
                     f'subtask="{t.subtask}"')
            lines.append(
                f"arroyo_worker_watermark_lag_seconds{{{label}}} {lag:.6f}")

        # cost attribution: per-category self-time counters, the
        # late/expired-row counter, and live state-size gauges per table
        lines.append("# TYPE arroyo_worker_self_time_seconds counter")
        lines.append("# TYPE arroyo_worker_self_cpu_seconds counter")
        for t in tasks:
            for cat in SELF_TIME_CATEGORIES:
                if not t.self_time[cat] and not t.self_cpu[cat]:
                    continue
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}",category="{cat}"')
                lines.append(
                    f"arroyo_worker_self_time_seconds{{{label}}} "
                    f"{t.self_time[cat]:.6f}")
                lines.append(
                    f"arroyo_worker_self_cpu_seconds{{{label}}} "
                    f"{t.self_cpu[cat]:.6f}")
        lines.append("# TYPE arroyo_late_rows_total counter")
        for t in tasks:
            if not t.late_rows:
                continue
            lines.append(
                f'arroyo_late_rows_total{{job="{t.job_id}",'
                f'operator="{t.node_id}",subtask="{t.subtask}"}} '
                f"{t.late_rows}")
        lines.append("# TYPE arroyo_state_rows gauge")
        lines.append("# TYPE arroyo_state_bytes gauge")
        for t in tasks:
            for table in sorted(t.state_rows):
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}",table="{table}"')
                lines.append(
                    f"arroyo_state_rows{{{label}}} {t.state_rows[table]}")
                lines.append(
                    f"arroyo_state_bytes{{{label}}} "
                    f"{t.state_bytes.get(table, 0)}")

        # tiered state (state/spill.py): cumulative spilled bytes, the
        # hot/cold partition split, and the files-touched-per-probe
        # histogram (the bloom/zone-map pruning-effectiveness signal)
        spill_tasks = [t for t in tasks if t.spill]
        if spill_tasks:
            lines.append("# TYPE arroyo_spill_bytes_total counter")
            lines.append("# TYPE arroyo_spill_partitions gauge")
            for t in spill_tasks:
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}"')
                lines.append(
                    f"arroyo_spill_bytes_total{{{label}}} "
                    f"{t.spill['bytes_total']}")
                lines.append(
                    f'arroyo_spill_partitions{{{label},state="hot"}} '
                    f"{t.spill['hot']}")
                lines.append(
                    f'arroyo_spill_partitions{{{label},state="cold"}} '
                    f"{t.spill['cold']}")

        # fused mesh execution (parallel/sharded_agg.py): rows fed through
        # the in-program keyed exchange, and the current per-shard HBM
        # spill-buffer residency (key skew past a fixed exchange lane)
        mesh_tasks = [t for t in tasks if t.mesh]
        if mesh_tasks:
            lines.append("# TYPE arroyo_mesh_exchange_rows_total counter")
            lines.append("# TYPE arroyo_mesh_overflow_rows gauge")
            for t in mesh_tasks:
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}"')
                lines.append(
                    f"arroyo_mesh_exchange_rows_total{{{label}}} "
                    f"{t.mesh.get('exchange_rows', 0)}")
                lines.append(
                    f"arroyo_mesh_overflow_rows{{{label}}} "
                    f"{t.mesh.get('overflow_rows', 0)}")

        def emit_histogram(name: str, label: str, h: Histogram) -> None:
            cum = 0
            for le, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{name}_bucket{{{label},le="{le}"}} {cum}')
            lines.append(f'{name}_bucket{{{label},le="+Inf"}} {h.count}')
            lines.append(f"{name}_sum{{{label}}} {h.sum}")
            lines.append(f"{name}_count{{{label}}} {h.count}")

        for name in _HISTOGRAM_NAMES:
            lines.append(f"# TYPE {name} histogram")
            for t in tasks:
                h = t.histogram(name)
                if not h.count:
                    continue
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}"')
                emit_histogram(name, label, h)
        if spill_tasks:
            lines.append("# TYPE arroyo_spill_probe_files histogram")
            for t in spill_tasks:
                h = t.spill.get("probe_files")
                if h is None or not h.count:
                    continue
                label = (f'job="{t.job_id}",operator="{t.node_id}",'
                         f'subtask="{t.subtask}"')
                emit_histogram("arroyo_spill_probe_files", label, h)
        with self._lock:
            phase_hists = sorted(self._phases.items())
            job_health = sorted(self._job_health.items())
            autoscaler_targets = sorted(self._autoscaler_target.items())
            segment_compiles = sorted(self._segment_compile.items())
            segment_hits = sorted(self._segment_cache_hits.items())
        # whole-segment compilation (engine/segment.py): compile-time
        # distribution + compile-cache hits per job
        if segment_compiles:
            lines.append("# TYPE arroyo_segment_compile_seconds histogram")
            for job, h in segment_compiles:
                emit_histogram("arroyo_segment_compile_seconds",
                               f'job="{job}"', h)
        if segment_hits:
            lines.append("# TYPE arroyo_segment_cache_hits_total counter")
            for job, n in segment_hits:
                lines.append(
                    f'arroyo_segment_cache_hits_total{{job="{job}"}} {n}')
        if phase_hists:
            lines.append("# TYPE arroyo_checkpoint_phase_seconds histogram")
            for (job, phase), h in phase_hists:
                emit_histogram("arroyo_checkpoint_phase_seconds",
                               f'job="{job}",phase="{phase}"', h)
        # health state per job (0 ok / 1 degraded / 2 critical) and the
        # structured-event counters (obs/events.py rings keep the newest
        # events; these counts keep the totals)
        if job_health:
            lines.append("# TYPE arroyo_job_health gauge")
            for job, state in job_health:
                lines.append(
                    f'arroyo_job_health{{job="{job}",state="{state}"}} '
                    f"{_HEALTH_RANK.get(state, 0)}")
        if autoscaler_targets:
            lines.append("# TYPE arroyo_autoscaler_target gauge")
            for job, target in autoscaler_targets:
                lines.append(
                    f'arroyo_autoscaler_target{{job="{job}"}} {target}')
        # multi-tenant fleet: slot occupancy, per-tenant admission-queue
        # depth, and the fleet autoscaler's pool target. Slot/target
        # series only export for a BOUNDED pool (an unlimited pass-through
        # fleet has no meaningful occupancy number); queue depth exports
        # whenever jobs are queued.
        with self._lock:
            fleet = self._fleet
        if fleet is not None:
            if fleet.get("pool_slots") is not None:
                lines.append("# TYPE arroyo_fleet_slots gauge")
                lines.append(
                    f'arroyo_fleet_slots{{state="used"}} '
                    f"{int(fleet.get('slots_used') or 0)}")
                lines.append(
                    f'arroyo_fleet_slots{{state="free"}} '
                    f"{int(fleet.get('slots_free') or 0)}")
                lines.append("# TYPE arroyo_fleet_target_workers gauge")
                lines.append(
                    f"arroyo_fleet_target_workers "
                    f"{int(fleet.get('target_workers') or 0)}")
            depth = fleet.get("queue_depth") or {}
            if depth:
                lines.append("# TYPE arroyo_fleet_queue_depth gauge")
                for tenant, n in sorted(depth.items()):
                    # tenant is the one FREE-TEXT (user-supplied) label in
                    # this exposition: escape per the text format or a
                    # quote/newline in a tenant name corrupts the whole
                    # scrape
                    esc = (str(tenant).replace("\\", "\\\\")
                           .replace('"', '\\"').replace("\n", "\\n"))
                    lines.append(
                        f'arroyo_fleet_queue_depth{{tenant="{esc}"}} {n}')
        with self._lock:
            bad = sorted(self._bad_records.items())
        if bad:
            lines.append("# TYPE arroyo_bad_records_total counter")
            for (job, op), n in bad:
                lines.append(
                    f'arroyo_bad_records_total{{job="{job}",'
                    f'operator="{op}"}} {n}')
        from .obs.events import recorder as _events_recorder

        counts = _events_recorder.counts_snapshot()
        if counts:
            lines.append("# TYPE arroyo_events_total counter")
            for (job, code, level), n in sorted(counts.items()):
                lines.append(
                    f'arroyo_events_total{{job="{job}",code="{code}",'
                    f'level="{level}"}} {n}')
        return "\n".join(lines) + "\n"

    def job_metrics(self, job_id: str) -> dict:
        """Per-operator aggregates for the API
        (reference /operator_metric_groups). Carries a ``per_subtask``
        breakdown so the controller can merge snapshots from a multi-worker
        set without double-counting (each worker reports its own subtasks;
        union by subtask label is exact)."""
        topk = HOT_KEYS_TOPK
        now_us = time.time() * 1e6
        out: dict[str, dict] = {}
        for t in self.snapshot():
            if t.job_id != job_id:
                continue
            op = out.setdefault(t.node_id, {"per_subtask": {}})
            lag = t.watermark_lag_seconds(now_us)
            transit_p99 = (round(t.queue_transit.quantile(0.99) * 1000, 3)
                           if t.queue_transit.count else None)
            sink_p99 = (round(t.sink_event_latency.quantile(0.99), 3)
                        if t.sink_event_latency.count else None)
            entry = {
                **{name: t.counters[name] for name in _COUNTER_NAMES},
                "backpressure": round(t.backpressure(), 4),
                "watermark_lag_seconds": lag if lag is None else round(lag, 3),
                "queue_transit_p99_ms": transit_p99,
                "sink_event_latency_p99_s": sink_p99,
                # cost attribution: busy% and cost-per-row are
                # derived HERE, at export — never in the hot path
                "uptime_seconds": round(t.uptime_seconds(), 3),
                "busy_pct": round(
                    100.0 * sum(t.self_time.values()) / t.uptime_seconds(), 2),
                "self_time": {c: round(v, 6) for c, v in t.self_time.items()},
                "self_cpu": {c: round(v, 6) for c, v in t.self_cpu.items()},
                "late_rows": t.late_rows,
                "state_rows": dict(t.state_rows),
                "state_bytes": dict(t.state_bytes),
            }
            if t.segment_compiled is not None:
                entry["segment_compiled"] = t.segment_compiled
            if t.segment_reason is not None:
                entry["segment_reason"] = t.segment_reason
            if t.segment_mesh is not None:
                entry["segment_mesh"] = t.segment_mesh
            if t.mesh is not None:
                entry["mesh"] = dict(t.mesh)
            if t.sketch is not None and t.sketch.total:
                # fixed-width hex: merges deterministically (merge_topk) and
                # survives JSON without 64-bit precision loss
                entry["hot_keys"] = [
                    {**e, "key": f"{e['key']:016x}"}
                    for e in t.sketch.topk(topk)]
                entry["sketch_total"] = t.sketch.total
            op["per_subtask"][str(t.subtask)] = entry
        return {op: _op_aggregate(m["per_subtask"]) for op, m in out.items()}


def _op_aggregate(per_subtask: dict[str, dict]) -> dict:
    """Fold a per-subtask breakdown into one operator row (counters summed,
    health gauges maxed — the worst subtask is the one an operator cares
    about). Rate fields default to 0 and are overwritten by the
    controller's windowed tracker while the job runs, so the field contract
    holds for every consumer (UI charts, `top`)."""
    # profile fields (self-time sums, worst-subtask busy%, state gauges,
    # merged hot keys) fold through one shared helper so a multi-worker
    # union aggregates exactly like a local snapshot
    from .obs.profile import aggregate_profiles

    def _max_opt(key):
        vals = [s[key] for s in per_subtask.values() if s.get(key) is not None]
        return max(vals) if vals else None

    out = {
        "subtasks": len(per_subtask),
        **{name: sum(int(s.get(name, 0)) for s in per_subtask.values())
           for name in _COUNTER_NAMES},
        "backpressure": max((float(s.get("backpressure", 0.0))
                             for s in per_subtask.values()), default=0.0),
        "messages_per_sec": 0.0,
        "messages_recv_per_sec": 0.0,
        "watermark_lag_seconds": _max_opt("watermark_lag_seconds"),
        "queue_transit_p99_ms": _max_opt("queue_transit_p99_ms"),
        "sink_event_latency_p99_s": _max_opt("sink_event_latency_p99_s"),
        "per_subtask": per_subtask,
        **aggregate_profiles(per_subtask),
    }
    if any(s.get("segment_compiled") for s in per_subtask.values()):
        out["segment_compiled"] = True
    if any(s.get("segment_mesh") for s in per_subtask.values()):
        out["segment_mesh"] = True
    mesh = [s["mesh"] for s in per_subtask.values() if s.get("mesh")]
    if mesh:
        out["mesh"] = {k: sum(int(m.get(k, 0)) for m in mesh)
                       for k in ("exchange_rows", "overflow_rows")}
    reasons = sorted({s["segment_reason"] for s in per_subtask.values()
                      if s.get("segment_reason")})
    if reasons:
        out["segment_reason"] = reasons[0]
    process_s = (out.get("self_time") or {}).get("process")
    recv = out.get("arroyo_worker_messages_recv", 0)
    if process_s and recv:
        out["self_us_per_row"] = round(process_s * 1e6 / recv, 3)
    return out


def merge_job_metrics(snapshots) -> dict:
    """Union per-operator snapshots shipped by the workers of one job into
    a single controller-side view. Subtask labels are globally unique under
    an assignment (each worker owns a disjoint slice), so union-by-label is
    exact; embedded worker sets sharing one process registry report
    identical full snapshots, which the union collapses instead of
    double-counting."""
    per_op: dict[str, dict[str, dict]] = {}
    for snap in snapshots:
        for op, m in (snap or {}).items():
            if not isinstance(m, dict):
                continue
            per = m.get("per_subtask")
            if not per:
                # legacy flat snapshot (no breakdown): synthesize one entry
                per = {"*": {name: m.get(name, 0) for name in _COUNTER_NAMES}}
            per_op.setdefault(op, {}).update(per)
    return {op: _op_aggregate(per) for op, per in per_op.items()}


registry = MetricsRegistry()


class RateTracker:
    """Windowed rate computation (reference job_metrics.rs rate windows)."""

    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self._points: dict[str, list[tuple[float, int]]] = defaultdict(list)

    def observe(self, key: str, value: int, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        pts = self._points[key]
        pts.append((now, value))
        cutoff = now - self.window_s
        while len(pts) > 2 and pts[0][0] < cutoff:
            pts.pop(0)

    def reset(self) -> None:
        """Drop all points — counters are about to restart from zero (e.g.
        a replacement worker set), so old points would yield negative rates."""
        self._points.clear()

    def rate(self, key: str) -> float:
        pts = self._points.get(key)
        if not pts or len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return (v1 - v0) / (t1 - t0)
