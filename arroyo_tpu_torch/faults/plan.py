"""Fault plan grammar and the deterministic injector.

A plan is a comma-separated list of fault specs::

    site:action[=arg][@cond[&cond]...]

    storage.put:fail_once@match=checkpoint-0000002
    storage.put:fail_n=3@match=compacted
    network.send:partition@step=40
    network.send:delay=25@after=10
    queue.put:delay=50@step=10
    worker:crash@barrier=3&step=1
    connector.poll:fail@prob=0.01

Sites are dotted names named by the instrumented call sites (see
``arroyo_tpu_torch.faults``'s docstring). Actions:

    fail        raise InjectedFault (transient) every time the spec matches
    fail_once   raise on the first match only
    fail_n=K    raise on the first K matches
    crash       raise InjectedCrash (a worker-fatal fault; tasks report
                task_failed and the engine aborts, like a process kill)
    partition   raise InjectedPartition (a ConnectionError: the data plane
                and sockets treat it exactly like a peer going away)
    drop        tell the call site to drop the item (frame, message, ...)
    dup         tell the call site to duplicate the item
    delay=MS    sleep MS milliseconds at the call site, then continue
    hang=S      sleep S seconds (models a stall; pairs with heartbeat
                timeouts), then continue
    force=V     tell the call site to substitute the value V for whatever
                it was about to use (site-specific: e.g. autoscale_decide
                forces a bogus target parallelism the rails must clamp)
    corrupt=M   tell the call site to corrupt the bytes in flight, M one of
                ``bitflip`` (flip one bit of the middle byte) or
                ``truncate`` (keep the first half) — the storage data paths
                apply it to puts (persistent corruption, like a truncated
                upload) and gets (read-side corruption, like bit rot);
                pair with ``@match=<path-substr>`` to hit one artifact

Conditions restrict when a spec matches. ``match=SUBSTR`` tests substring
containment against the call's ``key`` context (paths, shard ids, quads);
any other ``k=v`` compares stringified equality against the call's context
kwargs (``epoch``, ``barrier``, ``subtask``...). Two ordinal conditions run
against the per-spec hit counter of *matching* calls: ``step=N`` fires on
exactly the Nth match, ``after=N`` fires on every match from the Nth on.
``prob=P`` fires with probability P from the injector's seeded RNG — the
only nondeterminism, and it is reproducible given the same seed and call
sequence.

The first firing spec wins per call. All counters live in the injector, so
a given (plan, seed, call sequence) replays identically — the chaos suite
logs both on failure.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

_log = logging.getLogger("arroyo_tpu_torch.faults")

# actions that raise at the fault point; everything else returns a verdict
# the call site applies itself (drop/dup/force) or that the injector
# applies inline (delay/hang)
_RAISING = ("fail", "fail_once", "fail_n", "crash", "partition")
_KNOWN_ACTIONS = _RAISING + ("drop", "dup", "delay", "hang", "force",
                             "corrupt")

# corrupt=<mode> carries a string arg (the corruption mode), not a number
CORRUPT_MODES = ("bitflip", "truncate")


class InjectedFault(RuntimeError):
    """A deliberately injected transient failure."""

    transient = True

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site}" + (f" ({detail})" if detail else ""))
        self.site = site


class InjectedCrash(InjectedFault):
    """Worker-fatal injected failure (simulated crash): not transient, so
    retry layers let it propagate and the task dies."""

    transient = False


class InjectedPartition(ConnectionError):
    """Injected network partition; a ConnectionError so socket-facing code
    handles it exactly like a peer vanishing mid-stream."""

    transient = False

    def __init__(self, site: str):
        super().__init__(f"injected network partition at {site}")
        self.site = site


@dataclass
class FaultSpec:
    site: str
    action: str
    arg: Optional[object] = None  # float, or str for corrupt=<mode>
    conds: dict = field(default_factory=dict)
    hits: int = 0   # calls matching the non-ordinal conditions
    fired: int = 0  # times this spec actually fired

    def describe(self) -> str:
        a = self.action
        if self.arg is not None:
            a += (f"={self.arg:g}" if isinstance(self.arg, float)
                  else f"={self.arg}")
        c = "&".join(f"{k}={v}" for k, v in self.conds.items())
        return f"{self.site}:{a}" + (f"@{c}" if c else "")


class PlanSyntaxError(ValueError):
    pass


def parse_plan(plan: str) -> list[FaultSpec]:
    specs: list[FaultSpec] = []
    for raw in plan.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if ":" not in raw:
            raise PlanSyntaxError(f"fault spec {raw!r}: expected site:action")
        site, rest = raw.split(":", 1)
        cond_str = ""
        if "@" in rest:
            rest, cond_str = rest.split("@", 1)
        action, arg = rest, None
        if "=" in rest:
            action, args = rest.split("=", 1)
            if action == "corrupt":
                if args not in CORRUPT_MODES:
                    raise PlanSyntaxError(
                        f"fault spec {raw!r}: corrupt mode must be one of "
                        f"{', '.join(CORRUPT_MODES)}")
                arg = args
            else:
                try:
                    arg = float(args)
                except ValueError as e:
                    raise PlanSyntaxError(f"fault spec {raw!r}: bad arg {args!r}") from e
        if action not in _KNOWN_ACTIONS:
            raise PlanSyntaxError(
                f"fault spec {raw!r}: unknown action {action!r} "
                f"(have: {', '.join(_KNOWN_ACTIONS)})")
        if action in ("fail_n", "delay", "hang", "force", "corrupt") \
                and arg is None:
            raise PlanSyntaxError(f"fault spec {raw!r}: {action} needs =ARG")
        conds: dict = {}
        if cond_str:
            for c in cond_str.split("&"):
                if "=" not in c:
                    raise PlanSyntaxError(f"fault spec {raw!r}: bad condition {c!r}")
                k, v = c.split("=", 1)
                conds[k.strip()] = v.strip()
        for ordinal in ("step", "after", "prob"):
            if ordinal in conds:
                try:
                    float(conds[ordinal])
                except ValueError as e:
                    raise PlanSyntaxError(
                        f"fault spec {raw!r}: {ordinal} must be numeric") from e
        specs.append(FaultSpec(site=site.strip(), action=action, arg=arg, conds=conds))
    return specs


class FaultInjector:
    """Holds a parsed plan plus deterministic per-spec counters and the
    seeded RNG. One instance is installed globally (``faults.install``);
    call sites consult it through ``faults.fault_point``."""

    def __init__(self, plan: str, seed: int = 0):
        self.plan = plan
        self.seed = int(seed)
        self.specs = parse_plan(plan)
        self.rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.fired_log: list[str] = []  # human trail of fired faults

    def hit(self, site: str, **ctx) -> Optional[tuple[str, Optional[float]]]:
        """Register a call at ``site``. Raises for raising actions; returns
        ("drop"|"dup"|"delay"|"hang", arg) verdicts the caller applies (delay
        and hang have already slept by the time they return); None when no
        spec fires."""
        fired_spec: Optional[FaultSpec] = None
        with self._lock:
            # every matching spec counts every call (its ordinal clock keeps
            # ticking even when another spec fires first); the first spec
            # whose ordinals+quota allow firing wins this call
            for spec in self.specs:
                if spec.site != site:
                    continue
                if not self._conds_match(spec, ctx):
                    continue
                spec.hits += 1
                if fired_spec is not None:
                    continue
                if not self._ordinals_fire(spec):
                    continue
                if spec.action == "fail_once" and spec.fired >= 1:
                    continue
                if spec.action == "fail_n" and spec.fired >= int(spec.arg or 0):
                    continue
                fired_spec = spec
            if fired_spec is None:
                return None
            fired_spec.fired += 1
            verdict = (fired_spec.action, fired_spec.arg)
            self.fired_log.append(
                f"{fired_spec.describe()} fired (hit #{fired_spec.hits}) ctx={ctx}")
        _log.info("fault %s fired at %s ctx=%s", fired_spec.describe(), site, ctx)
        action, arg = verdict
        if action in ("fail", "fail_once", "fail_n"):
            raise InjectedFault(site, fired_spec.describe())
        if action == "crash":
            raise InjectedCrash(site, fired_spec.describe())
        if action == "partition":
            raise InjectedPartition(site)
        if action == "delay":
            time.sleep((arg or 0.0) / 1000.0)
        elif action == "hang":
            time.sleep(arg or 0.0)
        return verdict

    # ------------------------------------------------------------- matching

    def _conds_match(self, spec: FaultSpec, ctx: dict) -> bool:
        for k, v in spec.conds.items():
            if k in ("step", "after", "prob"):
                continue  # ordinal/probabilistic: evaluated post-count
            if k == "match":
                if v not in str(ctx.get("key", "")):
                    return False
            elif k not in ctx or str(ctx[k]) != v:
                return False
        return True

    def _ordinals_fire(self, spec: FaultSpec) -> bool:
        c = spec.conds
        if "step" in c and spec.hits != int(float(c["step"])):
            return False
        if "after" in c and spec.hits < int(float(c["after"])):
            return False
        if "prob" in c and self.rng.random() >= float(c["prob"]):
            return False
        return True
