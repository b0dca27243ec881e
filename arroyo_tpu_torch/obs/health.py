"""Controller-side health monitors: the autoscaler's sensor layer.

The port's copy of arroyo_tpu/obs/health.py.

ROADMAP item 5 (elastic autoscaling) needs a layer that *watches*
per-operator backpressure, queue-transit p99, and watermark lag and
*decides* — this module is that watch/decide half. Each controller
supervision tick evaluates a small rule set over the merged per-operator
metrics snapshot the controller already holds (``merge_job_metrics``
output — the same dict behind ``top`` and ``/metrics``), with hysteresis:
a rule FIRES only after ``health.fire-ticks`` consecutive breaching
evaluations and CLEARS only after ``health.clear-ticks`` consecutive
healthy ones, so a metric oscillating around its threshold cannot flap
the job state (or spam transition events).

The job's health is the worst firing rule's severity: ``ok`` ->
``degraded`` -> ``critical``. Transitions emit WARN/ERROR job events
(HEALTH_DEGRADED / HEALTH_CRITICAL / HEALTH_OK); the state surfaces as
the ``arroyo_job_health`` gauge, a ``health`` field on the jobs API, a
header entry in ``top``, and per-rule detail at
``GET /api/v1/jobs/<id>/health``. The future autoscaler only has to add
the actuator: read ``firing`` rules, pick a new worker count.

Thresholds live under ``health.*`` in the config; a rule whose metric is
absent from the snapshot (e.g. no sink latency before the first batch)
evaluates as healthy rather than unknown-degraded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

STATES = ("ok", "degraded", "critical")
_STATE_RANK = {s: i for i, s in enumerate(STATES)}


def _worst(metrics: dict, key: str) -> Optional[float]:
    """Max of a per-operator field over the merged snapshot (the worst
    operator is the one the job's health hinges on)."""
    vals = [m.get(key) for m in (metrics or {}).values()
            if isinstance(m, dict) and m.get(key) is not None]
    return max(vals) if vals else None


@dataclass(frozen=True)
class Rule:
    """One health rule: extract an observed value from the evaluation
    context, compare against its configured threshold."""

    rule_id: str
    severity: str  # "degraded" | "critical"
    config_key: str  # threshold under health.*
    default: float
    description: str
    observe: Callable[[dict], Optional[float]]

    def threshold(self) -> float:
        from ..config import config

        v = config().get(f"health.{self.config_key}")
        return float(v) if v is not None else self.default


def _observe_memory_pressure(ctx: dict) -> Optional[float]:
    """Worst subtask's resident state bytes as a fraction of the
    per-subtask spill budget (``state.spill.budget-bytes``). Fed from the
    same ``arroyo_state_bytes`` accounting the spill layer enforces its
    budget against: a sustained breach means spilling is disabled,
    failing (SPILL_FALLBACK), or falling behind the ingest rate."""
    from ..config import config

    budget = config().get("state.spill.budget-bytes")
    if not budget:
        return None
    worst = None
    for m in (ctx.get("metrics") or {}).values():
        if not isinstance(m, dict):
            continue
        for s in (m.get("per_subtask") or {}).values():
            sb = (s or {}).get("state_bytes") or {}
            if not sb:
                continue
            v = sum(sb.values()) / float(budget)
            if worst is None or v > worst:
                worst = v
    return worst


RULES: tuple[Rule, ...] = (
    Rule("watermark-lag", "degraded", "watermark-lag-max-s", 900.0,
         "worst-operator watermark lag (event time falling behind)",
         lambda ctx: _worst(ctx.get("metrics") or {}, "watermark_lag_seconds")),
    Rule("backpressure", "degraded", "backpressure-max", 0.9,
         "sustained worst-operator backpressure (a queue near its budget)",
         lambda ctx: _worst(ctx.get("metrics") or {}, "backpressure")),
    Rule("queue-transit", "degraded", "queue-transit-p99-max-ms", 1000.0,
         "worst-operator inbox transit p99 over budget",
         lambda ctx: _worst(ctx.get("metrics") or {}, "queue_transit_p99_ms")),
    Rule("sink-latency", "degraded", "sink-latency-p99-max-s", 600.0,
         "sink end-to-end event latency p99 over budget",
         lambda ctx: _worst(ctx.get("metrics") or {},
                            "sink_event_latency_p99_s")),
    Rule("checkpoint-failures", "critical", "checkpoint-failure-streak", 2.0,
         "consecutive failed/wedged checkpoint epochs",
         lambda ctx: float(ctx.get("ckpt_failures") or 0)),
    Rule("memory-pressure", "degraded", "memory-pressure-max", 0.9,
         "worst subtask's resident state vs the per-subtask spill budget",
         _observe_memory_pressure),
)


@dataclass
class _RuleState:
    breach_ticks: int = 0
    healthy_ticks: int = 0
    firing: bool = False
    value: Optional[float] = None


class HealthMonitor:
    """Per-job hysteresis evaluator. ``on_transition(old, new, detail)``
    is called exactly once per state change (the controller records the
    HEALTH_* event and persists the new state there)."""

    def __init__(self, job_id: str,
                 on_transition: Optional[Callable[[str, str, dict], None]] = None):
        self.job_id = job_id
        self.on_transition = on_transition
        self.state = "ok"
        self._rules: dict[str, _RuleState] = {r.rule_id: _RuleState()
                                              for r in RULES}

    def evaluate(self, metrics: Optional[dict],
                 ckpt_failures: int = 0) -> dict:
        """One supervision-tick evaluation; returns the detail dict that
        /health serves (state + per-rule observed/threshold/firing)."""
        from ..config import config

        cfg = config()
        fire_n = max(1, int(cfg.get("health.fire-ticks", 3) or 3))
        clear_m = max(1, int(cfg.get("health.clear-ticks", 5) or 5))
        ctx = {"metrics": metrics, "ckpt_failures": ckpt_failures}
        worst = "ok"
        rules_detail = []
        for rule in RULES:
            st = self._rules[rule.rule_id]
            value = rule.observe(ctx)
            threshold = rule.threshold()
            breaching = value is not None and value >= threshold
            st.value = value
            if breaching:
                st.breach_ticks += 1
                st.healthy_ticks = 0
                if st.breach_ticks >= fire_n:
                    st.firing = True
            else:
                st.healthy_ticks += 1
                st.breach_ticks = 0
                if st.firing and st.healthy_ticks >= clear_m:
                    st.firing = False
            if st.firing:
                worst = max(worst, rule.severity, key=_STATE_RANK.__getitem__)
            rules_detail.append({
                "rule": rule.rule_id,
                "severity": rule.severity,
                "description": rule.description,
                "value": value,
                "threshold": threshold,
                "breaching": breaching,
                "firing": st.firing,
            })
        detail = {"state": worst, "rules": rules_detail}
        if worst != self.state:
            old, self.state = self.state, worst
            if self.on_transition is not None:
                self.on_transition(old, worst, detail)
        return detail

    def firing_rules(self) -> list[str]:
        return [rid for rid, st in self._rules.items() if st.firing]


def health_event_code(state: str) -> str:
    return {"ok": "HEALTH_OK", "degraded": "HEALTH_DEGRADED",
            "critical": "HEALTH_CRITICAL"}[state]


def health_value(state: str) -> int:
    """Numeric encoding for the ``arroyo_job_health`` gauge."""
    return _STATE_RANK.get(state, 0)
