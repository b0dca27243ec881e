"""Observability plane of the port (arroyo_tpu/obs less the controller-side
health monitors and top view, which wait for the port's control plane).

``obs.trace`` records every checkpoint epoch's span tree (trigger ->
per-subtask alignment -> snapshot -> ack -> metadata durable -> commit)
into a bounded in-memory ring and exports it as Chrome trace-event JSON;
``obs.profile`` is the runtime cost-attribution layer (per-operator
self-time, state-size gauges, key-skew sketches via ``obs.sketch``, the
per-job profile and the EXPLAIN ANALYZE renderer); ``obs.events`` is the
structured per-job event log. The watermark-lag gauge, sink end-to-end
latency and checkpoint phase histograms live in ``arroyo_tpu_torch.metrics``
next to the task counters.
"""

from .trace import (  # noqa: F401 - public API
    EpochTraceRecorder,
    chrome_trace,
    dominant_phase,
    phase_durations,
    recorder,
    timeline_report,
)
