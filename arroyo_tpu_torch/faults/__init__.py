"""Deterministic fault injection threaded through the engine (the port's
copy of the JAX package's ``faults``: the same plan grammar, verdicts,
counters and seeded replay).

Failures happen on purpose, deterministically, at the seams where real
deployments lose data, so the exactly-once claims (aligned barrier
checkpoints, crash-consistent compaction, integrity-checked restore) are
proved under them rather than claimed.

Usage::

    faults.install("worker:crash@barrier=2&step=1", seed=7)   # direct
    # or config-driven, read at Engine construction:
    config.update({"faults.plan": "storage.put:fail_once@epoch=2"})

Call sites are no-ops (one global read) when no plan is installed, so the
hooks stay in production builds. Plan syntax lives in
``arroyo_tpu_torch.faults.plan``.

Instrumented sites (the port's modules that have them):

    storage.put / storage.get / storage.delete / storage.list
                        storage ops (ctx: key=path); retried by the shared
                        retry layer, so transient actions recover without
                        a job restart. put/get additionally honor
                        ``corrupt=bitflip|truncate@match=<path-substr>``:
                        the bytes in flight are deterministically damaged
                        (put = persistent corruption like a truncated
                        upload; get = read-side bit rot), so the integrity
                        envelope must detect it and a restore quarantine
                        and fall back instead of loading garbage
    queue.put           task inbox enqueue (ctx: input); delay models
                        backpressure stalls
    connector.poll      broker source poll (ctx: connector, key)
    connector.commit    broker ack/commit (ctx: connector, epoch)
    worker              barrier-time crash point in the task run loop
                        (ctx: barrier, node, subtask) — fires AFTER the
                        subtask's state files are written and BEFORE its
                        checkpoint-completed response, the worst spot
    evolve_cutover      the first checkpoint an engine completes after a
                        restore under an evolution mapping (ctx: epoch,
                        key=job): fires after its marker is durable and
                        before its commits are released
    spill_write         tiered-state run write (state/spill.py; ctx:
                        key=path, epoch, subtask): a failure re-pins the
                        partition hot (SPILL_FALLBACK), never loses state
    spill_probe         tiered-state run read on the probe path (ctx: key,
                        epoch, subtask): retried once in place; a second
                        failure propagates so the set restores from the
                        checkpoint instead of inventing data
    spill_compact       spill-generation merge write (ctx: key, epoch,
                        subtask): a failure keeps the old generations

    lock_contend        hold-time delay inside an instrumented critical
                        section (obs/lockorder.py ``make_lock`` proxies;
                        ctx: key="Class.attr"): ``delay=MS@match=<class>``
                        widens the race window the concurrency auditor
                        (LR4xx) flagged statically, so a suspected
                        interleaving becomes a schedulable one. Locks are
                        instrumented when constructed while a plan naming
                        the site is installed (or the lock-order witness
                        is on)

The run files themselves go through the storage sites and their retry
layer. The data plane's, the controller's, the node daemon's and the
fleet's sites (storage.multipart, network.send, network.recv, worker.heartbeat,
node.start_worker, controller_rpc, commit, rescale, autoscale_decide,
admission, fleet_place, job_tick, evolve_drain) have the meanings that the
JAX package's ``faults`` docstring gives them.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .plan import (  # noqa: F401 - public API
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    InjectedFault,
    InjectedPartition,
    PlanSyntaxError,
    parse_plan,
)

_log = logging.getLogger("arroyo_tpu_torch.faults")

_lock = threading.Lock()
_active: Optional[FaultInjector] = None
_from_config = False

# every instrumented site; the repo lint (analysis/repo_lint.py) checks that
# a full sweep finds each one wired to a fault_point call
SITES = (
    "storage.put", "storage.get", "storage.delete", "storage.list",
    "storage.multipart", "network.send", "network.recv", "queue.put",
    "connector.poll", "connector.commit", "worker", "worker.heartbeat",
    "node.start_worker", "controller_rpc", "commit", "rescale",
    "autoscale_decide", "spill_write", "spill_probe", "spill_compact",
    "admission", "fleet_place", "job_tick", "evolve_drain", "evolve_cutover",
    "lock_contend",
)


def install(plan: str, seed: int = 0, _config_origin: bool = False) -> FaultInjector:
    """Parse and activate ``plan``; returns the injector. The plan and seed
    are logged so any chaos failure is replayable."""
    global _active, _from_config
    inj = FaultInjector(plan, seed=seed)
    with _lock:
        _active = inj
        _from_config = _config_origin
    _log.info("fault plan installed: %r (seed=%d)", plan, seed)
    return inj


def clear() -> None:
    global _active, _from_config
    with _lock:
        _active = None
        _from_config = False


def active() -> Optional[FaultInjector]:
    return _active


def install_from_config() -> Optional[FaultInjector]:
    """Sync the injector with ``faults.plan`` / ``faults.seed`` config.

    Called at Engine construction. A non-empty configured plan
    (re)installs with FRESH counters — each engine incarnation replays its
    faults, which is what restart-crash loops need. An empty config only
    clears a plan that came from config; plans installed directly by tests
    are left alone.
    """
    from ..config import config

    plan = config().get("faults.plan") or ""
    if plan:
        seed = int(config().get("faults.seed") or 0)
        return install(str(plan), seed=seed, _config_origin=True)
    with _lock:
        was_config = _from_config
    if was_config:
        clear()
    return None


def fault_point(site: str, **ctx) -> Optional[tuple]:
    """The hook embedded at instrumented call sites. Fast no-op when no
    plan is active. May raise InjectedFault/InjectedCrash/InjectedPartition
    or return a ("drop"|"dup"|"delay"|"hang"|"corrupt"|..., arg) verdict."""
    inj = _active
    if inj is None:
        return None
    return inj.hit(site, **ctx)
