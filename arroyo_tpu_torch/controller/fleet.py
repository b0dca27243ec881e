"""Multi-tenant fleet: shared capacity, admission control, fair queueing.

The port's copy of arroyo_tpu/controller/fleet.py.

ROADMAP item 5. Production scale is not one big pipeline — it is hundreds
of pipelines from many tenants sharing one worker fleet. This module is
the control plane for that sharing, owned by the ControllerServer and
consulted by every JobController on its supervision tick:

* **Slot ledger** — the fleet's capacity is a pool of slots (one slot per
  parallel pipeline lane; a worker set of W processes holds at least W).
  Process/Embedded schedulers get a configurable synthetic pool
  (``fleet.slots``) so the whole feature is testable without daemons; the
  node scheduler derives capacity from registered node daemons' live
  ``/status`` slots. ``fleet.slots = 0`` (the default) means UNLIMITED:
  admission always grants and the layer is pass-through.

* **Admission control** — a job the fleet cannot place (or whose tenant
  is at quota) waits in a FIFO-per-tenant queue instead of failing.
  Dequeue is deficit round-robin across tenants: each admission round
  adds ``fleet.drr-quantum`` slot credit to a tenant with an eligible
  head-of-queue job; the head admits once its credit covers its demand
  AND free capacity exists — so a tenant streaming many small jobs
  cannot starve a tenant with a few big ones. The first credit-satisfied
  head that does NOT fit blocks further admissions (capacity
  reservation): freed slots flow to it, never around it, so big jobs
  cannot be starved by a stream of small ones either.

* **Quotas** — per-tenant ``fleet.quota.max-slots`` / ``max-jobs``
  (0 = unlimited; per-tenant overrides under ``fleet.quota.tenants.<t>``).
  A job whose own demand exceeds its tenant's max-slots is REJECTED (it
  could never run); a job that merely pushes usage past the quota QUEUES
  until a peer finishes. Lowering a quota below current usage marks the
  tenant's most recently admitted jobs for preemption: the controller
  drains each behind a checkpoint and re-queues it (JOB_PREEMPTED).

* **Requeue backoff** — a placement rejection (node-daemon 409, injected
  ``admission`` fault) re-queues the job at the HEAD of its tenant queue
  with a deterministic exponential backoff (``fleet.requeue-backoff-*``);
  it is never failed and never burns a restart-budget token.

* **Fleet elasticity** — sustained capacity-blocked queue demand (or a
  per-job autoscale the pool could not place) is fleet pressure; with
  ``fleet.autoscale.enabled`` the pool grows toward demand through the
  scheduler's ``provision_slots`` hook (synthetic pools apply the new
  size directly; cluster pools surface the target as the
  ``arroyo_fleet_target_workers`` gauge for the node-pool autoscaler).
  Same rails as the per-job loop: hysteresis, cooldown, clamped bounds.

All decisions surface as structured job events (JOB_QUEUED /
JOB_ADMITTED / JOB_REJECTED / JOB_PREEMPTED, emitted by the controller),
the ``arroyo_fleet_*`` gauges, a persisted ``fleet_state`` DB snapshot
behind ``GET /api/v1/fleet``, and queue positions on the jobs API.

The clock is injectable so unit tests drive backoff/cooldown with a fake
clock and zero sleeps.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..obs.lockorder import make_lock

_log = logging.getLogger("arroyo_tpu_torch.controller.fleet")


def _cfg(key: str, default):
    from ..config import config

    v = config().get(f"fleet.{key}")
    return default if v is None else v


def demand_slots(n_workers: int, parallelism: int) -> int:
    """A job's slot demand: one slot per parallel pipeline lane, and at
    least one per worker process of its set."""
    return max(1, int(n_workers or 1), int(parallelism or 1))


@dataclass
class _Held:
    """One admitted job's ledger entry."""

    job_id: str
    tenant: str
    slots: int
    seq: int  # admission order; preemption picks the newest first


@dataclass
class _Queued:
    job_id: str
    tenant: str
    slots: int
    seq: int  # enqueue order (FIFO within the tenant)
    # persisted queue position carried across a controller restart, so
    # re-adopted entries restore in their original FIFO order no matter
    # which JobController happens to tick first (fresh entries: None)
    restored_pos: Optional[int] = None


@dataclass
class _Backoff:
    until: float = 0.0
    failures: int = 0


class FleetManager:
    """Slot ledger + per-tenant admission queues + the fleet autoscaler.

    One instance per ControllerServer, shared by its JobControllers. All
    methods are called from the single-threaded supervision loop; the
    lock exists so ad-hoc readers (tests, stats) stay safe.
    """

    def __init__(self, scheduler=None,
                 clock: Callable[[], float] = time.monotonic):
        self.scheduler = scheduler
        self._clock = clock
        self._lock = make_lock("FleetManager._lock", kind="rlock")
        self._held: dict[str, _Held] = {}
        self._queues: dict[str, deque[_Queued]] = {}
        self._backoff: dict[str, _Backoff] = {}
        self._grants: set[str] = set()  # admitted this pass, not yet observed
        self._preempt: set[str] = set()
        # marked-and-taken preemptions whose drain is still in flight: the
        # job holds its slots until the drain lands, but its recovery
        # already counts toward the tenant's over-quota math (and it must
        # not be re-marked every tick)
        self._preempt_inflight: set[str] = set()
        self._deficit: dict[str, int] = {}  # DRR credit per tenant
        self._seq = 0
        self._last_tenant: Optional[str] = None  # DRR rotation cursor
        # capacity-blocked demand observed by the last admission pass and
        # per-job scale-up shortfalls noted since the last tick — the
        # fleet autoscaler's pressure signals
        self._blocked_demand = 0
        self._pressure_slots = 0
        # fleet autoscaler state
        self._dyn_pool: Optional[int] = None  # synthetic pool, resized
        self._as_up = 0
        self._as_down = 0
        self._as_cooldown_until = 0.0
        self._target: Optional[int] = None
        self._persist_at = 0.0
        self._persist_fp = None
        # the node scheduler's capacity probe (live /status sums); the
        # probe runs on its own thread, so a wedged daemon never stalls a tick
        self._node_capacity: Optional[int] = None
        self._node_probe_at = 0.0
        self._probe_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ capacity

    def pool_slots(self) -> Optional[int]:
        """Current pool size in slots; None = unlimited (feature off). With
        ``fleet.slots`` 0 under the node scheduler, the live sum of the
        registered daemons' slots (None until a probe lands)."""
        base = int(_cfg("slots", 0) or 0)
        with self._lock:  # _dyn_pool / _node_capacity land on other threads
            if base > 0:
                if self._dyn_pool is not None:
                    return max(base, self._dyn_pool)
                return base
            return self._node_capacity

    def _refresh_node_capacity(self, db) -> None:
        """Node scheduler only: the fleet's capacity is the live sum of the
        registered daemons' slots (one worker process a slot; a daemon's own
        409 stays the physical limit). At most every 2 s, on a thread of its
        own: until a probe lands, the last sum stands."""
        from .scheduler import NodeScheduler

        if not isinstance(self.scheduler, NodeScheduler) or db is None:
            return
        now = self._clock()
        if now - self._node_probe_at < 2.0:
            return
        if self._probe_thread is not None and self._probe_thread.is_alive():
            return
        self._node_probe_at = now
        nodes = db.list_nodes(alive_within_s=10.0)

        def _probe() -> None:
            from .node import _get

            total = 0
            for n in nodes:
                try:
                    total += int(_get(f"{n['addr']}/status", timeout=2.0)["slots"])
                except (OSError, KeyError, ValueError):
                    # an unreachable daemon counts its registered slots:
                    # placement finds the truth (409, then a re-queue)
                    total += int(n.get("slots") or 0)
            with self._lock:
                self._node_capacity = total if nodes else None

        self._probe_thread = threading.Thread(target=_probe, daemon=True,
                                              name="fleet-node-probe")
        self._probe_thread.start()

    def _achievable_pool(self) -> float:
        """The largest pool this fleet could ever offer a single job:
        the current pool, or the autoscaler's max-slots ceiling when
        fleet elasticity could grow it. Demands beyond this can never be
        placed and must not hold the admission pass hostage."""
        pool = self.pool_slots()
        if pool is None:
            return float("inf")
        if bool(_cfg("autoscale.enabled", False)):
            return max(pool, int(_cfg("autoscale.max-slots", 64)))
        return pool

    def used_slots(self) -> int:
        with self._lock:
            return sum(e.slots for e in self._held.values())

    def free_slots(self) -> Optional[int]:
        pool = self.pool_slots()
        if pool is None:
            return None
        return max(0, pool - self.used_slots())

    # -------------------------------------------------------------- quotas

    @staticmethod
    def _quota(tenant: str, which: str) -> int:
        from ..config import config

        v = config().get(f"fleet.quota.tenants.{tenant}.{which}")
        if v is None:
            v = config().get(f"fleet.quota.{which}")
        return int(v or 0)

    def tenant_usage(self, tenant: str) -> tuple[int, int]:
        """(slots in use, jobs admitted) for one tenant."""
        with self._lock:
            rows = [e for e in self._held.values() if e.tenant == tenant]
        return sum(e.slots for e in rows), len(rows)

    def _quota_allows(self, tenant: str, slots: int) -> bool:
        used, jobs = self.tenant_usage(tenant)
        max_slots = self._quota(tenant, "max-slots")
        max_jobs = self._quota(tenant, "max-jobs")
        if max_slots and used + slots > max_slots:
            return False
        if max_jobs and jobs + 1 > max_jobs:
            return False
        return True

    # ----------------------------------------------------------- admission

    def admit(self, job_id: str, tenant: str, slots: int) -> tuple[str, str]:
        """Request admission. Returns (verdict, reason) with verdict one of
        ``admitted`` / ``queued`` / ``rejected``. The job is enqueued and a
        DRR pass runs, so a newcomer can never jump ahead of queued peers."""
        with self._lock:
            if job_id in self._held:
                return "admitted", "already holds slots"
            max_slots = self._quota(tenant, "max-slots")
            if max_slots and slots > max_slots:
                return "rejected", (
                    f"demand {slots} slots exceeds tenant {tenant!r} quota "
                    f"max-slots={max_slots}: the job could never run")
            self._enqueue(job_id, tenant, slots, front=False)
            self._run_admissions()
            if job_id in self._grants:
                self._grants.discard(job_id)
                return "admitted", "placed into shared capacity"
            return "queued", self._queue_reason(tenant, slots)

    def _queue_reason(self, tenant: str, slots: int) -> str:
        if not self._quota_allows(tenant, slots):
            return f"tenant {tenant!r} at quota"
        free = self.free_slots()
        return (f"fleet full ({free} of {self.pool_slots()} slots free, "
                f"need {slots})")

    def _enqueue(self, job_id: str, tenant: str, slots: int,
                 front: bool) -> None:
        q = self._queues.setdefault(tenant, deque())
        if any(e.job_id == job_id for e in q):
            return
        self._seq += 1
        entry = _Queued(job_id, tenant, slots, self._seq)
        if front:
            q.appendleft(entry)
        else:
            q.append(entry)

    def should_admit(self, job_id: str) -> bool:
        """True exactly once after an admission pass granted the job; the
        QUEUED JobController consumes this to transition to Scheduling."""
        with self._lock:
            if job_id in self._grants:
                self._grants.discard(job_id)
                return True
            return False

    def holds(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._held

    def adopt(self, job_id: str, tenant: str, slots: int) -> None:
        """Force-register usage for a job a fresh controller adopted
        mid-flight (controller restart): the job is already running, so
        the ledger must reflect it even if that oversubscribes the pool
        (free clamps at zero; pressure drains it over time)."""
        with self._lock:
            if job_id not in self._held:
                self._seq += 1
                self._held[job_id] = _Held(job_id, tenant, slots, self._seq)

    def release(self, job_id: str) -> None:
        """The job went terminal (or its queue entry was cancelled): free
        its slots / queue position. Freed capacity is handed out by the
        next supervision tick's admission pass."""
        with self._lock:
            self._held.pop(job_id, None)
            self._grants.discard(job_id)
            self._preempt.discard(job_id)
            self._preempt_inflight.discard(job_id)
            self._backoff.pop(job_id, None)
            for q in self._queues.values():
                for e in list(q):
                    if e.job_id == job_id:
                        q.remove(e)

    def requeue(self, job_id: str, tenant: str, slots: int,
                backoff: bool = False) -> None:
        """Move an admitted (or granted) job back to the HEAD of its
        tenant queue — placement was rejected (node 409) or the job is
        being preempted. ``backoff`` arms the deterministic exponential
        ineligibility window; a preemption re-queues without one."""
        with self._lock:
            self._held.pop(job_id, None)
            self._grants.discard(job_id)
            self._preempt.discard(job_id)
            self._preempt_inflight.discard(job_id)
            self._enqueue(job_id, tenant, slots, front=True)
            if backoff:
                b = self._backoff.setdefault(job_id, _Backoff())
                b.failures += 1
                base = float(_cfg("requeue-backoff-base-s", 0.5))
                cap = float(_cfg("requeue-backoff-max-s", 30.0))
                delay = min(cap, base * (2.0 ** (b.failures - 1)))
                b.until = self._clock() + delay
            else:
                self._backoff.pop(job_id, None)

    def restore_queued(self, job_id: str, tenant: str, slots: int,
                       position: Optional[int] = None) -> None:
        """Re-adopt a Queued job after a controller restart, preserving
        the PERSISTED queue order: adoption happens per-JobController in
        arbitrary tick order, so each entry carries its old position and
        inserts sorted — ahead of fresh (position-less) entries."""
        with self._lock:
            if job_id in self._held:
                return
            q = self._queues.setdefault(tenant, deque())
            if any(e.job_id == job_id for e in q):
                return
            self._seq += 1
            entry = _Queued(job_id, tenant, slots, self._seq,
                            restored_pos=position)
            if position is None:
                q.append(entry)
                return
            idx = len(q)
            for i, e in enumerate(q):
                if e.restored_pos is None or e.restored_pos > position:
                    idx = i
                    break
            q.insert(idx, entry)

    def clear_backoff(self, job_id: str) -> None:
        """A placement finally landed: the consecutive-rejection streak
        resets so the next (unrelated) requeue starts from the base."""
        with self._lock:
            self._backoff.pop(job_id, None)

    def backoff_remaining(self, job_id: str) -> float:
        with self._lock:
            b = self._backoff.get(job_id)
        return max(0.0, b.until - self._clock()) if b else 0.0

    def _run_admissions(self) -> None:
        """One deficit-round-robin pass (lock held): grant queued jobs
        into free capacity. Grants move straight into the ledger (so
        capacity accounting is correct before the job's own tick) and are
        surfaced once via ``should_admit``."""
        self._blocked_demand = 0
        pool = self.pool_slots()
        free = None if pool is None else max(0, pool - sum(
            e.slots for e in self._held.values()))
        deficit = self._deficit
        quantum = max(1, int(_cfg("drr-quantum", 1)))
        now = self._clock()
        # in-pass capacity reservations: a head that FITS the pool but is
        # still accruing credit pins its demand, so smaller jobs of other
        # tenants cannot drain the capacity out from under it while its
        # deficit counter catches up (at quantum 1 a 3-slot job needs 3
        # rounds — all inside this one pass)
        pending: dict[str, int] = {}
        progress = True
        rounds = 0
        while progress and rounds < 1024:  # bound is a safety net only
            rounds += 1
            progress = False
            tenants = sorted(t for t, q in self._queues.items() if q)
            if not tenants:
                break
            # rotation: resume after the last tenant served
            if self._last_tenant in tenants:
                i = tenants.index(self._last_tenant) + 1
                tenants = tenants[i:] + tenants[:i]
            for tenant in tenants:
                q = self._queues.get(tenant)
                if not q:
                    deficit.pop(tenant, None)
                    continue
                head = q[0]
                b = self._backoff.get(head.job_id)
                if b is not None and now < b.until:
                    continue  # rejected recently; ineligible, no credit
                if not self._quota_allows(tenant, head.slots):
                    continue  # tenant at quota; its whole queue waits
                # chaos site `fleet_place` (ctx: key=job, tenant, slots):
                # drop suppresses this head's placement decision for the
                # pass; force grants it regardless of credit or capacity
                # (the ledger absorbs the oversubscription as pressure)
                from ..faults import InjectedFault, fault_point

                forced = False
                try:
                    verdict = fault_point("fleet_place", key=head.job_id,
                                          tenant=tenant, slots=head.slots)
                except InjectedFault:
                    continue  # decision computation "failed": costs a pass
                if verdict is not None:
                    if verdict[0] == "drop":
                        continue
                    forced = verdict[0] == "force"
                reserved = sum(v for k, v in pending.items()
                               if k != head.job_id)
                if not forced and free is not None:
                    if head.slots > self._achievable_pool():
                        # this head could NEVER fit — not even a fully
                        # drained (or autoscaled-to-max) pool holds it.
                        # It stays Queued (never Failed), but it must not
                        # reserve capacity — that would starve every other
                        # tenant's queue behind an impossible demand —
                        # and it adds no autoscale pressure (no amount of
                        # growth would place it).
                        continue
                    if head.slots > free:
                        # TRUE capacity shortage: the next eligible head
                        # that cannot fit the pool's free slots blocks
                        # the whole pass — freed slots flow to IT, never
                        # around it (anti-starvation for big jobs behind
                        # streams of small ones). Everything still queued
                        # behind a non-quota-blocked head is capacity-
                        # blocked demand: the autoscaler's pressure.
                        self._blocked_demand += sum(
                            e.slots for t2, q2 in self._queues.items()
                            if q2 and self._quota_allows(t2, q2[0].slots)
                            for e in q2)
                        return
                    if head.slots > free - reserved:
                        # the shortage is another head's in-pass
                        # reservation, not real scarcity: skip the round
                        continue
                deficit[tenant] = deficit.get(tenant, 0) + quantum
                if not forced and deficit[tenant] < head.slots:
                    # credit accrues across ROUNDS (the job fits — more
                    # rounds this pass will satisfy it), so a multi-slot
                    # job admits within one tick once capacity exists;
                    # its demand is pinned meanwhile (see `pending`)
                    pending[head.job_id] = head.slots
                    progress = True
                    continue
                q.popleft()
                pending.pop(head.job_id, None)
                deficit[tenant] = max(0, deficit.get(tenant, 0) - head.slots)
                if free is not None:
                    free -= head.slots
                self._seq += 1
                self._held[head.job_id] = _Held(
                    head.job_id, tenant, head.slots, self._seq)
                self._grants.add(head.job_id)
                self._last_tenant = tenant
                progress = True
        # credit does not outlive an empty queue
        for t in list(deficit):
            if not self._queues.get(t):
                deficit.pop(t, None)

    # -------------------------------------------------- demand transitions

    def try_grow(self, job_id: str, new_slots: int) -> bool:
        """Reserve extra slots for a per-job scale-up BEFORE it actuates.
        Returns False (and notes fleet pressure) when the pool cannot
        place it — the autoscale decision is skipped this round and the
        fleet loop grows the pool instead."""
        with self._lock:
            e = self._held.get(job_id)
            if e is None:
                return True  # not under fleet management
            extra = int(new_slots) - e.slots
            if extra <= 0:
                e.slots = int(new_slots)
                return True
            free = self.free_slots()
            if free is None or extra <= free:
                e.slots = int(new_slots)
                return True
            self._pressure_slots += extra - free
            return False

    def set_demand(self, job_id: str, new_slots: int) -> None:
        """Unconditional ledger update (manual rescales always win, even
        if that oversubscribes the pool — free clamps at zero and the
        overdraft reads as fleet pressure)."""
        with self._lock:
            e = self._held.get(job_id)
            if e is None:
                return
            pool = self.pool_slots()
            e.slots = int(new_slots)
            if pool is not None:
                over = sum(x.slots for x in self._held.values()) - pool
                if over > 0:
                    self._pressure_slots += over

    def note_pressure(self, slots_short: int) -> None:
        with self._lock:
            self._pressure_slots += max(0, int(slots_short))

    # ----------------------------------------------------------- preemption

    def take_preemption(self, job_id: str) -> bool:
        """True once when the fleet marked this job for preemption (its
        tenant's quota dropped below current usage); the controller drains
        it behind a checkpoint and re-queues it."""
        with self._lock:
            if job_id in self._preempt:
                self._preempt.discard(job_id)
                return True
            return False

    def _mark_preemptions(self) -> None:
        with self._lock:
            by_tenant: dict[str, list[_Held]] = {}
            for e in self._held.values():
                by_tenant.setdefault(e.tenant, []).append(e)
            for tenant, rows in by_tenant.items():
                max_slots = self._quota(tenant, "max-slots")
                if not max_slots:
                    continue
                over = sum(e.slots for e in rows) - max_slots
                if over <= 0:
                    continue
                # newest admissions yield first; jobs already marked (or
                # mid-drain) count toward the recovery in flight
                for e in sorted(rows, key=lambda x: -x.seq):
                    if over <= 0:
                        break
                    if e.job_id not in self._preempt \
                            and e.job_id not in self._preempt_inflight:
                        self._preempt.add(e.job_id)
                        self._preempt_inflight.add(e.job_id)
                        _log.warning(
                            "tenant %r over quota (%d > %d slots): "
                            "preempting %s", tenant,
                            sum(x.slots for x in rows), max_slots, e.job_id)
                    over -= e.slots

    # ------------------------------------------------------ queue surfaces

    def queue_order(self) -> list[_Queued]:
        """Queued jobs in (approximate) admission order: tenants
        interleaved round-robin, FIFO within each — what queue positions
        are derived from."""
        with self._lock:
            qs = {t: list(q) for t, q in self._queues.items() if q}
        out: list[_Queued] = []
        i = 0
        while any(qs.values()):
            for t in sorted(qs):
                if i < len(qs[t]):
                    out.append(qs[t][i])
            i += 1
            if i > max((len(v) for v in qs.values()), default=0):
                break
        return out

    def queue_position(self, job_id: str) -> Optional[int]:
        for i, e in enumerate(self.queue_order()):
            if e.job_id == job_id:
                return i + 1
        return None

    def queue_depth(self) -> dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def stats(self) -> dict:
        """The fleet snapshot behind the gauges, ``GET /api/v1/fleet``,
        and the persisted fleet_state row."""
        with self._lock:
            held = list(self._held.values())
            order = self.queue_order()
        tenants: dict[str, dict] = {}
        for e in held:
            t = tenants.setdefault(e.tenant, {"slots_used": 0,
                                              "jobs_running": 0,
                                              "queued": 0})
            t["slots_used"] += e.slots
            t["jobs_running"] += 1
        for e in order:
            t = tenants.setdefault(e.tenant, {"slots_used": 0,
                                              "jobs_running": 0,
                                              "queued": 0})
            t["queued"] += 1
        pool = self.pool_slots()
        used = sum(e.slots for e in held)
        return {
            "pool_slots": pool,
            "slots_used": used,
            "slots_free": None if pool is None else max(0, pool - used),
            "target_workers": self._target if self._target is not None
            else (pool if pool is not None else used),
            "queue_depth": {t: sum(1 for e in order if e.tenant == t)
                            for t in {e.tenant for e in order}},
            "queue": [{"job_id": e.job_id, "tenant": e.tenant,
                       "slots": e.slots, "position": i + 1}
                      for i, e in enumerate(order)],
            "tenants": tenants,
        }

    # ----------------------------------------------------------- fleet tick

    def tick(self, db=None) -> None:
        """Once per ControllerServer tick, BEFORE job steps: refresh
        capacity, mark quota preemptions, run the admission pass over
        whatever capacity terminal jobs just freed, evaluate the fleet
        autoscaler, export gauges, and persist the snapshot."""
        self._refresh_node_capacity(db)
        self._mark_preemptions()
        with self._lock:
            self._run_admissions()
            blocked = self._blocked_demand
            pressure_slots = self._pressure_slots
            self._pressure_slots = 0
        self._autoscale(blocked + pressure_slots)
        stats = self.stats()
        from ..metrics import registry as metrics_registry

        metrics_registry.set_fleet_stats(stats)
        self._persist(db, stats)

    def _persist(self, db, stats: dict) -> None:
        if db is None:
            return
        now = self._clock()
        fp = (stats["slots_used"], stats["pool_slots"],
              tuple(sorted((e["job_id"], e["position"])
                           for e in stats["queue"])))
        if fp == self._persist_fp and now - self._persist_at < 1.0:
            return
        self._persist_fp = fp
        self._persist_at = now
        try:
            db.record_fleet_state(stats)
        except Exception:  # noqa: BLE001 - snapshot durability is best-effort
            _log.exception("fleet-state persist failed; retrying next tick")

    def _autoscale(self, shortfall: int) -> None:
        """Fleet-level elasticity over the same rails as the per-job
        loop: hysteresis (up/down tick streaks), cooldown after a resize,
        clamped bounds. Actuation goes through the scheduler's provision
        hook; a scheduler that returns None sizes its pool externally and
        the decision only moves the ``arroyo_fleet_target_workers``
        gauge — the knob a node-pool autoscaler keys off."""
        pool = self.pool_slots()
        if not bool(_cfg("autoscale.enabled", False)) or pool is None:
            self._target = pool
            self._as_up = self._as_down = 0
            return
        base = int(_cfg("slots", 0) or 0) or pool
        hi = max(base, int(_cfg("autoscale.max-slots", 64)))
        headroom = int(_cfg("autoscale.headroom-slots", 0) or 0)
        used = self.used_slots()
        if shortfall > 0:
            self._as_up += 1
            self._as_down = 0
        elif pool - used > headroom and not self.queue_depth():
            self._as_down += 1
            self._as_up = 0
        else:
            self._as_up = self._as_down = 0
        now = self._clock()
        target = self._target if self._target is not None else pool
        decided: Optional[int] = None
        if self._as_up >= max(1, int(_cfg("autoscale.up-ticks", 3))) \
                and now >= self._as_cooldown_until:
            decided = min(hi, max(pool, used + shortfall + headroom))
            self._as_up = 0
        elif self._as_down >= max(1, int(_cfg("autoscale.down-ticks", 20))) \
                and now >= self._as_cooldown_until:
            decided = max(base, used + headroom)
            self._as_down = 0
        # actuate (and arm the cooldown) only when a FRESH decision moves
        # the target: for an externally sized pool (provision hook returns
        # None, the pool itself never changes here) a standing target must
        # not re-enter this branch every tick — that would re-arm the
        # cooldown forever and freeze the gauge at its first value
        if decided is not None and decided != target:
            accepted = None
            if self.scheduler is not None:
                accepted = self.scheduler.provision_slots(decided)
            if accepted is not None:
                with self._lock:
                    self._dyn_pool = max(base, int(accepted))
                _log.info("fleet pool resized %d -> %d slots "
                          "(shortfall %d)", pool, self._dyn_pool, shortfall)
            else:
                _log.info("fleet target %d slots (pool %d is externally "
                          "sized; arroyo_fleet_target_workers carries the "
                          "knob)", decided, pool)
            self._as_cooldown_until = now + float(
                _cfg("autoscale.cooldown-s", 15.0))
            target = decided
        self._target = target
