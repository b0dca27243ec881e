"""Controller-side live job view: the rendering behind `arroyo_tpu_torch top`.

The port's copy of arroyo_tpu/obs/topview.py.

Pure formatting over data the controller already persists to the shared DB
(job row, per-operator metrics snapshot, checkpoint history with phase
durations) so the CLI, tests, and any future UI panel share one view model:
per-operator rows/s in/out, backpressure, queue-transit p99, watermark lag,
and the last epoch's duration with its dominant phase — a hot subtask or a
stalled watermark is visible at a glance.
"""

from __future__ import annotations

import json
from typing import Optional

from . import trace
from .fmt import fmt_bytes as _fmt_bytes
from .fmt import fmt_rate as _fmt_rate
from .fmt import fmt_secs as _fmt_secs


def last_epoch_line(checkpoints: list[dict]) -> Optional[str]:
    """"last epoch 7: 1.23s (snapshot 0.91s <- dominant, align 0.21s, ...)"
    from the newest checkpoint row carrying phase durations."""
    for row in sorted(checkpoints, key=lambda r: -int(r["epoch"])):
        if row.get("state") not in ("complete", "compacted"):
            continue
        phases = row.get("phases")
        if isinstance(phases, str):
            try:
                phases = json.loads(phases)
            except json.JSONDecodeError:
                phases = None
        if not phases:
            continue
        total = sum(phases.values())
        dom = trace.dominant_phase(phases)
        parts = ", ".join(
            f"{k} {_fmt_secs(v)}" + (" <- dominant" if k == dom else "")
            for k, v in sorted(phases.items(), key=lambda kv: -kv[1])
        )
        return f"last epoch {row['epoch']}: {_fmt_secs(total)} ({parts})"
    return None


_COLUMNS = ("operator", "sub", "in/s", "out/s", "busy%", "backpr",
            "transit p99", "wm lag", "sink p99", "state", "late", "hot key")


def render(job: dict, metrics: Optional[dict],
           checkpoints: Optional[list[dict]] = None) -> str:
    """One refresh frame of the live job view (plain text, one table)."""
    head = (f"job {job['id']}  state={job['state']}  "
            f"health={job.get('health') or 'ok'}  "
            f"workers={job.get('n_workers', 1)}  "
            f"restarts={job.get('restarts', 0)}  "
            f"epoch={job.get('checkpoint_epoch', 0)}")
    tenant = job.get("tenant")
    if tenant and tenant != "default":
        head += f"  tenant={tenant}"
    if job.get("state") == "Queued":
        # multi-tenant fleet: the job waits in its tenant's admission
        # queue; the position comes from the persisted fleet snapshot
        pos = job.get("queue_position")
        head += ("  queue_pos=" + (str(pos) if pos else "?"))
        return head + "\n  (queued for fleet admission; no worker set yet)"
    if job.get("state") == "Evolving":
        # live evolution: the v1 set drains behind a final checkpoint;
        # the evolved plan restores from it once the carry-over is proven
        head += "  evolving" + (" (redeploy pending)"
                                if job.get("desired_query") else "")
    if not metrics:
        return head + "\n  (no metrics snapshot yet)"
    rows: list[tuple[str, ...]] = []

    def not_compiled(m: dict) -> str:
        # the stored reason may carry the plan-reject boilerplate prefix;
        # strip it so the truncated cell keeps the actionable part
        reason = m["segment_reason"]
        if reason.startswith("not compilable: "):
            reason = reason[len("not compilable: "):]
        return f" [not compiled: {reason[:48]}]"

    for op in sorted(metrics):
        m = metrics[op]
        if not isinstance(m, dict):
            continue
        p99 = m.get("queue_transit_p99_ms")
        busy = m.get("busy_pct")
        srows = m.get("state_rows") or {}
        sbytes = m.get("state_bytes") or {}
        state = ("-" if not srows else
                 f"{sum(srows.values()):,}r/"
                 f"{_fmt_bytes(sum(sbytes.values()))}")
        hot = (m.get("hot_keys") or [{}])[0]
        hot_s = (f"{hot['key'][:6]}.. {100 * hot.get('share', 0):.0f}%"
                 if hot.get("key") else "-")
        rows.append((
            # whole-segment compilation: this chained operator's batches run
            # as one fused kernel launch (its busy% is not a per-member sum);
            # an uncompiled segment names its plan-time reject or runtime
            # fallback reason instead (truncated to keep the table narrow)
            # [mesh] = the dispatch is one shard_map'd program fusing the
            # segment with the sharded aggregate's keyed exchange
            op + ((" [mesh]" if m.get("segment_mesh") else "")
                  + " [compiled]" if m.get("segment_compiled")
                  else not_compiled(m)
                  if m.get("segment_reason") else ""),
            str(m.get("subtasks", len(m.get("per_subtask", {})) or 1)),
            _fmt_rate(m.get("messages_recv_per_sec")),
            _fmt_rate(m.get("messages_per_sec")),
            "-" if busy is None else f"{float(busy):.1f}",
            f"{float(m.get('backpressure', 0.0)):.2f}",
            "-" if p99 is None else f"{float(p99):.1f}ms",
            _fmt_secs(m.get("watermark_lag_seconds")),
            _fmt_secs(m.get("sink_event_latency_p99_s")),
            state,
            str(int(m.get("late_rows") or 0)),
            hot_s,
        ))
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(_COLUMNS)]
    lines = [head, "  ".join(c.ljust(w) for c, w in zip(_COLUMNS, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    epoch_line = last_epoch_line(checkpoints or [])
    if epoch_line:
        lines.append(epoch_line)
    return "\n".join(lines)
