"""Elastic autoscaler: the actuator closing the loop from health signals

The port's copy of arroyo_tpu/controller/autoscaler.py.
to worker count (ROADMAP item 5; reference: the kubernetes scheduler of
PAPER.md §controller, and Enthuse's case — arXiv:2405.18168 — that a
streaming engine must adapt its parallelism to the workload rather than
be provisioned for the peak).

Every sensor already exists: the controller holds a merged per-operator
metrics snapshot (backpressure, queue-transit p99, watermark lag, sink
latency, profiler busy%) and per-job health rules with hysteresis
(obs/health.py). This module is the *decide* half the health monitors
deliberately stopped short of: evaluated once per supervision tick, it
turns sustained pressure into a target parallelism and actuates it
through the exact coordinated path a human rescale uses — take a final
checkpoint, drain the worker set, restore at the new scale
(``JobController`` Rescaling / ``_finish_rescale``). No second rescale
mechanism exists; the autoscaler just writes ``desired_parallelism``.

Most of the machinery here is rails, because an actuator without rails
turns one bad metric into an outage:

* **hysteresis** — scale up only after ``autoscaler.up-ticks``
  consecutive pressured evaluations; scale DOWN only after
  ``autoscaler.down-ticks`` consecutive ticks of *proven* headroom (low
  busy%, low backpressure, no pressure signal; absent metrics prove
  nothing and reset the streak).
* **cooldown** — after any worker-set (re)start — a completed rescale,
  a crash restore, first schedule — decisions freeze for
  ``autoscaler.cooldown-s``: post-restart metrics are warm-up noise.
* **bounds** — every target is clamped to
  ``autoscaler.min/max-parallelism`` *after* the decision (and after the
  ``autoscale_decide`` chaos hook, so a forced-bogus target proves the
  clamp).
* **backoff** — a scale attempt whose transition is disrupted (a worker
  dying mid-drain, a wedged drain escalating) arms an exponential
  backoff window (``backoff-base-s`` · ``backoff-multiplier``ⁿ, capped
  at ``backoff-max-s``); a cleanly completed scale resets the streak.
* **never scale blind** — no decisions unless the job is Running, and
  none mid-checkpoint-failure-streak (a rescale needs a fresh final
  checkpoint; wedging epochs mean it won't get one).

Surfaces: AUTOSCALE_DECISION / AUTOSCALE_STARTED / AUTOSCALE_DONE /
AUTOSCALE_BACKOFF job events, the ``arroyo_autoscaler_target`` gauge,
and a ``autoscaler`` detail block on ``GET /api/v1/jobs/<id>/health``.

The loop is wall-time injectable (``clock=``) so unit tests drive
cooldown/backoff with a fake clock and hand-fed snapshots — no sleeps.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs.health import _worst


@dataclass(frozen=True)
class Signal:
    """One scale-up pressure signal: a merged-snapshot observation
    compared against its ``autoscaler.*`` threshold (same shape as the
    health rules — the worst operator is the one that melts first)."""

    signal_id: str
    config_key: str
    default: float
    description: str
    observe: Callable[[dict], Optional[float]]

    def threshold(self) -> float:
        from ..config import config

        v = config().get(f"autoscaler.{self.config_key}")
        return float(v) if v is not None else self.default


UP_SIGNALS: tuple[Signal, ...] = (
    Signal("backpressure", "up-backpressure", 0.8,
           "worst-operator backpressure (queues near budget)",
           lambda m: _worst(m, "backpressure")),
    Signal("queue-transit", "up-queue-transit-p99-ms", 750.0,
           "worst-operator inbox transit p99",
           lambda m: _worst(m, "queue_transit_p99_ms")),
    Signal("watermark-lag", "up-watermark-lag-s", 30.0,
           "worst-operator watermark lag",
           lambda m: _worst(m, "watermark_lag_seconds")),
    Signal("sink-latency", "up-sink-latency-p99-s", 30.0,
           "sink end-to-end event latency p99",
           lambda m: _worst(m, "sink_event_latency_p99_s")),
)


class Autoscaler:
    """Per-job control loop owned by the JobController and evaluated on
    its supervision tick. ``evaluate`` returns a clamped target
    parallelism to actuate (or None); the controller owns actuation and
    reports the transition back via ``on_worker_set_started`` /
    ``on_scale_disrupted``."""

    def __init__(self, job_id: str,
                 emit: Optional[Callable[..., None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.job_id = job_id
        self._emit = emit or (lambda *a, **k: None)
        self._clock = clock
        self._up_ticks = 0
        self._down_ticks = 0
        self._cooldown_until = 0.0
        self._backoff_until = 0.0
        self._failures = 0  # consecutive disrupted scale attempts
        self._disrupted = False  # the current in-flight transition broke
        self.in_flight: Optional[int] = None  # target being actuated
        self.last_decision: Optional[dict] = None
        self._last_noop: Optional[tuple] = None  # dedup key for at-bound
        self._last_blocked: Optional[tuple] = None  # dedup for fleet-block
        self._last_signals: list[dict] = []

    # ------------------------------------------------------------ config

    @staticmethod
    def _cfg(key: str, default):
        from ..config import config

        v = config().get(f"autoscaler.{key}")
        return default if v is None else v

    @classmethod
    def enabled(cls) -> bool:
        return bool(cls._cfg("enabled", False))

    # ---------------------------------------------------------- the loop

    def evaluate(self, metrics: Optional[dict], *, running: bool,
                 parallelism: int, ckpt_failures: int = 0) -> Optional[int]:
        """One supervision-tick evaluation. Returns the (rail-clamped)
        target parallelism the controller should actuate now, or None.
        Gates in order: enabled → job Running → no checkpoint-failure
        streak → hysteresis counters → cooldown/backoff → bounds."""
        if not self.enabled():
            self._up_ticks = self._down_ticks = 0
            return None
        if not running or self.in_flight is not None:
            # never scale while Recovering/Stopping/Rescaling/Evolving
            # (or while an evolution request is pending — the controller
            # gates `running` on that too) — the counters reset so a
            # breach mid-restore can't fire at the first post-restore
            # tick on stale conviction
            self._up_ticks = self._down_ticks = 0
            return None
        if ckpt_failures > 0:
            # mid-checkpoint-failure-streak: the drain checkpoint a
            # rescale needs is exactly what's currently wedging
            self._up_ticks = self._down_ticks = 0
            return None

        pressure, headroom = self._classify(metrics)
        if pressure:
            self._up_ticks += 1
            self._down_ticks = 0
        elif headroom:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = self._down_ticks = 0

        up_n = max(1, int(self._cfg("up-ticks", 3)))
        down_n = max(1, int(self._cfg("down-ticks", 10)))
        raw: Optional[int] = None
        direction = None
        if self._up_ticks >= up_n:
            factor = float(self._cfg("up-factor", 2.0))
            raw = max(parallelism + 1, math.ceil(parallelism * factor))
            direction = "up"
        elif self._down_ticks >= down_n:
            factor = float(self._cfg("down-factor", 0.5))
            raw = min(parallelism - 1, int(math.floor(parallelism * factor)))
            raw = max(raw, 1)
            direction = "down"
        if raw is None:
            return None

        now = self._clock()
        if now < self._cooldown_until or now < self._backoff_until:
            # gated, not forgotten: the streak stays armed, so sustained
            # pressure fires on the first tick after the window expires
            self._up_ticks = min(self._up_ticks, up_n)
            self._down_ticks = min(self._down_ticks, down_n)
            return None

        # chaos hook: autoscale_decide may force a bogus target (the
        # min/max rails below must clamp it) or drop the decision; a
        # raising action models the decision computation blowing up, and
        # must cost at most this tick's decision — never the job
        from ..faults import InjectedFault, fault_point

        try:
            verdict = fault_point("autoscale_decide", key=self.job_id,
                                  target=raw, direction=direction)
        except InjectedFault:
            self._up_ticks = self._down_ticks = 0
            return None
        if verdict is not None:
            action, arg = verdict
            if action == "drop":
                self._up_ticks = self._down_ticks = 0
                return None
            if action == "force":
                raw = int(arg or 0)

        lo = max(1, int(self._cfg("min-parallelism", 1)))
        hi = max(lo, int(self._cfg("max-parallelism", 8)))
        target = min(hi, max(lo, raw))
        decision = {
            "direction": direction,
            "from": parallelism,
            "to": target,
            "raw_target": raw,
            "clamped": target != raw,
            "signals": [s["signal"] for s in self._last_signals
                        if s.get("breaching")],
        }
        if target == parallelism:
            # rails collapsed the decision to a no-op (already at a
            # bound): record it — once per (direction, from, to), so a
            # sustained breach at the bound cannot re-emit every window
            # just because the breaching-signal set fluctuates — and
            # never churn the worker set
            self._up_ticks = self._down_ticks = 0
            noop_key = (direction, parallelism, target)
            if noop_key != self._last_noop:
                self._last_noop = noop_key
                self._emit("INFO", "AUTOSCALE_DECISION",
                           f"decision {direction} {parallelism} -> {target} "
                           "is a no-op at the configured bounds",
                           data=decision)
            self.last_decision = decision
            return None
        self._last_noop = None
        self.last_decision = decision
        self._up_ticks = self._down_ticks = 0
        self.in_flight = target
        self._emit("INFO", "AUTOSCALE_DECISION",
                   f"scale {direction}: parallelism {parallelism} -> "
                   f"{target}" + (" (rail-clamped)" if decision["clamped"]
                                  else ""),
                   data=decision)
        return target

    def _classify(self, metrics: Optional[dict]) -> tuple[bool, bool]:
        """(pressure, headroom) for one snapshot. Pressure: ANY up-signal
        breaching. Headroom: metrics present, NO signal breaching, worst
        busy% and backpressure both under their scale-down ceilings —
        absent observations prove nothing (a brand-new set with no busy%
        yet must not look idle)."""
        self._last_signals = []
        if not metrics:
            return False, False
        pressure = False
        for sig in UP_SIGNALS:
            value = sig.observe(metrics)
            threshold = sig.threshold()
            breaching = value is not None and value >= threshold
            pressure = pressure or breaching
            self._last_signals.append({
                "signal": sig.signal_id, "value": value,
                "threshold": threshold, "breaching": breaching,
            })
        busy = _worst(metrics, "busy_pct")
        bp = _worst(metrics, "backpressure")
        busy_max = float(self._cfg("down-busy-max-pct", 25.0))
        bp_max = float(self._cfg("down-backpressure-max", 0.1))
        headroom = (not pressure and busy is not None and bp is not None
                    and busy <= busy_max and bp <= bp_max)
        # NOT a "breaching" entry — for this row true means HEALTHY
        # (idle enough to scale down), the opposite polarity of the
        # pressure signals above, so it carries its own field name
        self._last_signals.append({
            "signal": "headroom", "value": busy, "threshold": busy_max,
            "proven": headroom,
        })
        return pressure, headroom

    # ------------------------------------------------------- transitions

    def on_worker_set_started(self) -> None:
        """A worker set (re)started — fresh schedule, crash restore, or
        rescale completion. Cooldown always arms (post-restart metrics
        are warm-up noise whoever caused the restart); a cleanly landed
        autoscale additionally resets the backoff streak."""
        now = self._clock()
        self._cooldown_until = now + float(self._cfg("cooldown-s", 30.0))
        self._up_ticks = self._down_ticks = 0
        self._last_blocked = None
        if self.in_flight is not None:
            self.in_flight = None
            if not self._disrupted:
                # only a CLEAN landing resets the backoff streak — a
                # disrupted transition still reaches the new scale, but
                # its armed backoff must survive this restart
                self._failures = 0
                self._backoff_until = 0.0
        self._disrupted = False

    def on_capacity_blocked(self, parallelism: int, target: int) -> None:
        """The decided scale-up could not be placed into the fleet's
        shared capacity (controller/fleet.py ``try_grow`` refused). The
        decision is abandoned WITHOUT cooldown or disrupted-transition
        backoff — nothing happened to the worker set — and the pressure
        hysteresis is re-armed at its threshold so the decision re-fires
        on the first pressured tick after the fleet grows the pool. The
        shortfall itself was already noted as fleet pressure by try_grow;
        this records why the job did not scale."""
        self.in_flight = None
        self._disrupted = False
        self._up_ticks = max(1, int(self._cfg("up-ticks", 3)))
        key = (parallelism, target)
        if key == self._last_blocked:
            return  # the block re-fires every pressured tick; say it once
        self._last_blocked = key
        self._emit("WARN", "AUTOSCALE_DECISION",
                   f"scale up {parallelism} -> {target} blocked by fleet "
                   "capacity; fleet pressure raised, decision re-arms "
                   "once the pool grows",
                   data={"direction": "up", "from": parallelism,
                         "to": target, "blocked_by": "fleet-capacity"})

    def abandon_in_flight(self) -> None:
        """The decided scale never actuated (e.g. a manual rescale request
        won the desired_parallelism write race): forget it without arming
        cooldown or backoff — nothing happened to the worker set."""
        self.in_flight = None
        self._disrupted = False

    def on_scale_disrupted(self, reason: str) -> None:
        """The transition of an autoscaler-initiated rescale was
        disrupted (worker death mid-drain, wedged-drain escalation). The
        rescale itself still lands — the controller proceeds to the new
        parallelism from whatever checkpoint exists — but the NEXT
        decision backs off exponentially: a transition that keeps
        failing must not be retried on a tight loop."""
        if self.in_flight is None:
            return
        self._disrupted = True
        self._failures += 1
        base = float(self._cfg("backoff-base-s", 10.0))
        mult = float(self._cfg("backoff-multiplier", 2.0))
        cap = float(self._cfg("backoff-max-s", 300.0))
        delay = min(cap, base * (mult ** (self._failures - 1)))
        self._backoff_until = self._clock() + delay
        self._emit("WARN", "AUTOSCALE_BACKOFF",
                   f"scale transition disrupted ({reason.splitlines()[0][:200]}); "
                   f"next decision backed off {delay:.1f}s "
                   f"(attempt {self._failures})",
                   data={"backoff_s": delay, "failures": self._failures})

    # ----------------------------------------------------------- surface

    def target(self, parallelism: int) -> int:
        """The ``arroyo_autoscaler_target`` gauge value: the in-flight
        target while a scale actuates, else the current parallelism."""
        return self.in_flight if self.in_flight is not None else parallelism

    def detail(self, parallelism: int) -> dict:
        """The ``autoscaler`` block on /health: live rail state plus the
        last decision, so an operator can see WHY it is (not) scaling."""
        now = self._clock()
        return {
            "enabled": self.enabled(),
            "parallelism": parallelism,
            "target": self.target(parallelism),
            "in_flight": self.in_flight is not None,
            "up_ticks": self._up_ticks,
            "down_ticks": self._down_ticks,
            "cooldown_remaining_s": round(max(0.0, self._cooldown_until - now), 3),
            "backoff_remaining_s": round(max(0.0, self._backoff_until - now), 3),
            "failures": self._failures,
            "signals": self._last_signals,
            "last_decision": self.last_decision,
        }
