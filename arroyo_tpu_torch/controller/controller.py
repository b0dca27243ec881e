"""Job supervision: the controller loop.

The port's copy of arroyo_tpu/controller/controller.py.

Reference: ControllerServer (arroyo-controller/src/lib.rs:189) polling the DB
for jobs (start_updater, lib.rs:543-567) and JobController
(job_controller/mod.rs:555) driving heartbeat timeout checks, periodic
checkpoints, failure detection, and the restart budget
(pipeline.allowed-restarts, healthy-duration resets).

A job runs on a WORKER SET of ``controller.workers-per-job`` workers
(start_workers; one by default). For multi-worker sets the controller also
owns cross-worker checkpoint coordination (checkpoint_state.py): per-subtask
acks flow up from every worker, the epoch goes globally durable here, and
phase-2 commits fan back out. Any worker of the set dying, missing
heartbeats, or wedging a checkpoint past ``checkpoint.timeout-ms`` (K
consecutive times) takes the WHOLE set down and restores it from the last
globally complete checkpoint.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Optional

from ..config import config
from ..obs import trace as obs_trace
from ..obs.events import recorder as events_recorder
from ..obs.health import HealthMonitor, health_event_code
from .autoscaler import Autoscaler
from .db import Database
from .fleet import FleetManager, demand_slots
from .scheduler import PlacementFull, Scheduler, WorkerHandle, scheduler_for
from .states import JobState, check_transition

_log = logging.getLogger("arroyo_tpu_torch.controller")


class JobController:
    """Supervises one job end-to-end (FSM + running-worker-set control)."""

    def __init__(self, db: Database, job_id: str, scheduler: Scheduler,
                 storage_url: Optional[str] = None,
                 fleet: Optional[FleetManager] = None):
        self.db = db
        self.job_id = job_id
        self.scheduler = scheduler
        self.storage_url = storage_url or config().get("checkpoint.storage-url")
        job_row = self.db.get_job(job_id)
        self.state = JobState(job_row["state"])
        # multi-tenant fleet (controller/fleet.py): the shared slot pool /
        # admission queue; a standalone JobController gets its own
        # (unlimited by default, so the layer is pass-through)
        self.fleet = fleet if fleet is not None else FleetManager(scheduler)
        self.tenant = job_row.get("tenant") or "default"
        self._queued_since: Optional[float] = None
        # set while a quota-change preemption drains: the stopped set
        # routes back into the admission queue instead of Stopped
        self._requeue_after_stop = False
        # the job's worker set; a finished worker's slot goes None until the
        # whole set drains (index == worker_index for assignment/commit fan-out)
        self.handles: list[Optional[WorkerHandle]] = []
        self.coordinator = None  # CheckpointCoordinator for multi-worker sets
        # ordered 2PC trail (metadata_durable / commit_sent ...); survives
        # worker-set restarts so chaos tests can audit the whole history
        self.checkpoint_event_log: list[tuple] = []
        self.sql: Optional[str] = None
        self.parallelism = 1
        self.restarts = 0
        self.restore_epoch: Optional[int] = None
        self.next_epoch = 1
        self.last_checkpoint_time = time.monotonic()
        self.running_since: Optional[float] = None
        self.stopping_epoch: Optional[int] = None
        self.rescale_to: Optional[int] = None
        # live evolution (versioned redeploy): the evolved SQL while the v1
        # set drains, and the blue/green gate armed between the evolved
        # restart and its first durable epoch (the cutover barrier)
        self.evolve_to: Optional[str] = None
        self._evolve_catchup = False
        self.failure: Optional[str] = None
        # stuck-checkpoint watchdog: epoch -> trigger time, plus the
        # consecutive-failure escalation counter and GC cadence counter
        self._inflight_epochs: dict[int, float] = {}
        self._ckpt_failures = 0
        self._epochs_since_gc = 0
        self._gc_thread: Optional[threading.Thread] = None
        self._last_stop_resend = 0.0
        # durable audit counters (survive worker-set restarts; failure
        # messages get overwritten by later recoveries)
        self.watchdog_failed_epochs = 0
        self.watchdog_escalations = 0
        # latest per-operator metrics snapshot per worker of the set;
        # merged (union by subtask label) before persisting, so no worker's
        # report overwrites another's operators
        self._metrics_by_worker: dict[int, dict] = {}
        from ..metrics import RateTracker

        self.rates = RateTracker(window_s=10.0)
        # the autoscaler's sensor layer (obs/health.py): rule set with
        # hysteresis evaluated every supervision tick over the latest
        # merged metrics snapshot; transitions emit HEALTH_* events
        self.health = HealthMonitor(job_id,
                                    on_transition=self._on_health_transition)
        # the actuator on top of those sensors (controller/autoscaler.py):
        # decides a target parallelism on the same tick and actuates it
        # through the normal desired_parallelism -> Rescaling drain path
        self.autoscaler = Autoscaler(job_id, emit=self._event)
        # the target of the autoscale currently actuating (None when no
        # autoscale is pending): AUTOSCALE_DONE fires only when a worker
        # set actually starts at exactly this parallelism
        self._autoscale_target: Optional[int] = None
        self._last_merged_metrics: Optional[dict] = None
        self._last_health_persist = 0.0
        # job event log: incremental flush cursor into the job_events table.
        # A restarted controller re-adopting the job seeds both the cursor
        # and the in-memory ring's seq counter from the DB's max persisted
        # seq, or every post-restart event would collide with an existing
        # (job, seq) row and be silently dropped by the idempotent flush
        self._events_flushed_seq = self.db.last_event_seq(job_id)
        events_recorder.ensure_seq_floor(job_id, self._events_flushed_seq)
        if self.state not in (JobState.CREATED, JobState.COMPILING,
                              JobState.QUEUED, JobState.RESTARTING) \
                and not self.is_terminal():
            # fresh controller adopting a LIVE job: the fleet ledger must
            # reflect its slots even if that briefly oversubscribes the
            # pool (free clamps at zero; pressure drains the overdraft).
            # RESTARTING is excluded: it is only entered from a terminal
            # state whose slots were released — a manual restart must
            # re-enter admission (the _step_inner restart path), not
            # adopt its way past a full pool and the tenant quota.
            pipeline = self.db.get_pipeline(job_row["pipeline_id"]) or {}
            par = int(job_row.get("desired_parallelism")
                      or pipeline.get("parallelism") or 1)
            self.fleet.adopt(self.job_id, self.tenant, demand_slots(
                int(job_row.get("n_workers") or 1), par))

    def _demand(self) -> int:
        """This job's slot demand: one slot per parallel lane, at least
        one per worker of its set (see fleet.demand_slots)."""
        return demand_slots(
            int(config().get("controller.workers-per-job") or 1),
            self.parallelism)

    def _event(self, level: str, code: str, message: str, **kw) -> None:
        events_recorder.record(self.job_id, level, code, message, **kw)

    def _flush_events(self) -> None:
        """Persist job events recorded (or ingested from workers) since the
        last flush — runs every step so the DB feed trails the ring by at
        most one supervision tick. The cursor advances only AFTER a
        successful write (a transient DB error retries the same events next
        tick instead of silently dropping them), and a failed flush must
        not take the supervision loop down with it."""
        evs = events_recorder.events(self.job_id,
                                     after_seq=self._events_flushed_seq)
        if not evs:
            return
        try:
            self.db.record_events(self.job_id, evs)
        except Exception:  # noqa: BLE001 - feed durability is best-effort
            _log.exception("job-event flush failed for %s; retrying next "
                           "tick", self.job_id)
            return
        self._events_flushed_seq = evs[-1]["seq"]

    def _pick_restore_epoch(self) -> Optional[int]:
        """The restore fallback ladder: verify-before-load. The newest
        complete epoch that passes integrity verification wins; corrupt or
        incomplete ones are QUARANTINED (marker preserved, never deleted —
        GC refuses them until an operator resolves) and the walk falls
        back to the next-older valid epoch. Sources rewind to the chosen
        epoch's checkpointed offsets, so replay covers the gap."""
        from ..state.integrity import latest_valid_checkpoint

        def on_quarantine(epoch: int, reason: str) -> None:
            self._event("ERROR", "CHECKPOINT_QUARANTINED",
                        f"checkpoint epoch {epoch} failed integrity "
                        f"verification and was quarantined: {reason[:400]}",
                        epoch=epoch, data={"reason": reason[:800]})

        epoch, skipped = latest_valid_checkpoint(
            self.storage_url, self.job_id, on_quarantine=on_quarantine)
        if skipped:
            self._event("WARN", "RESTORE_FELL_BACK",
                        f"restore fell back to epoch {epoch or 0} past "
                        f"{len(skipped)} quarantined epoch(s); sources "
                        f"rewind and replay covers the gap byte-exactly",
                        epoch=epoch,
                        data={"fallback_epoch": epoch, "skipped": skipped})
        return epoch

    def _on_health_transition(self, old: str, new: str, detail: dict) -> None:
        firing = [{"rule": r["rule"], "value": r["value"],
                   "threshold": r["threshold"]}
                  for r in detail["rules"] if r["firing"]]
        code = health_event_code(new)
        level = {"HEALTH_OK": "INFO", "HEALTH_DEGRADED": "WARN",
                 "HEALTH_CRITICAL": "ERROR"}[code]
        names = ", ".join(f["rule"] for f in firing) or "all rules clear"
        self._event(level, code, f"health {old} -> {new} ({names})",
                    data={"firing": firing})
        self.db.update_job(self.job_id, health=new)
        detail = {**detail,
                  "autoscaler": self.autoscaler.detail(self.parallelism)}
        self.db.record_health(self.job_id, new, detail)

    def _eval_health(self) -> None:
        from ..metrics import registry as metrics_registry

        health_on = bool(config().get("health.enabled", True))
        autoscale_on = self.autoscaler.enabled()
        if not health_on and not autoscale_on:
            return
        if health_on:
            detail = self.health.evaluate(self._last_merged_metrics,
                                          ckpt_failures=self._ckpt_failures)
            metrics_registry.set_job_health(self.job_id, self.health.state)
        else:
            # monitors off, autoscaler on: the /health payload still has
            # to carry the autoscaler readout (and the gauge must export)
            detail = {"state": self.health.state, "rules": []}
        # the /health payload doubles as the autoscaler's readout: rail
        # state, live signals, and the last decision ride every persist
        detail["autoscaler"] = self.autoscaler.detail(self.parallelism)
        if autoscale_on:
            metrics_registry.set_autoscaler_target(
                self.job_id, self.autoscaler.target(self.parallelism))
        # transitions persist immediately (_on_health_transition); between
        # them, refresh the per-rule observed values at ~1 Hz for /health
        now = time.monotonic()
        if now - self._last_health_persist >= 1.0:
            self._last_health_persist = now
            self.db.record_health(self.job_id, self.health.state, detail)

    # -- single-worker compatibility surface ---------------------------

    @property
    def handle(self) -> Optional[WorkerHandle]:
        """First live handle (the only one for single-worker jobs)."""
        for h in self.handles:
            if h is not None:
                return h
        return None

    @handle.setter
    def handle(self, value: Optional[WorkerHandle]) -> None:
        self.handles = [] if value is None else [value]

    # ------------------------------------------------------------------

    def _set_state(self, nxt: JobState, **fields) -> None:
        check_transition(self.state, nxt)
        self.state = nxt
        self.db.update_job(self.job_id, state=nxt.value, **fields)

    def is_terminal(self) -> bool:
        return self.state in (JobState.FAILED, JobState.FINISHED, JobState.STOPPED)

    # ------------------------------------------------------------------

    def step(self) -> None:
        """One supervision tick; cheap and non-blocking."""
        try:
            # chaos site `job_tick` (ctx: key=job id): delay=MS models a
            # melting job's slow supervision step (storage stall, wedged
            # drain) — the tick budget must detect and deprioritize it
            # while its neighbors keep their heartbeat/watchdog cadence
            from ..faults import fault_point

            fault_point("job_tick", key=self.job_id)
            self._step_inner()
        except Exception:  # noqa: BLE001 - job failure, not controller crash
            self.failure = traceback.format_exc()
            self._fail(self.failure)
        finally:
            # event-feed durability trails the ring by at most one tick
            self._flush_events()

    def _kill_all(self) -> None:
        for h in self.handles:
            if h is None:
                continue
            try:
                h.kill()
            except Exception:  # lint: waive LR102 — best-effort teardown of a worker set; members may already be gone
                pass
        self.handles = []

    def _fail(self, msg: str) -> None:
        self._kill_all()
        if not self.is_terminal():
            self._set_state(JobState.FAILED, failure_message=msg[-4000:])

    def _step_inner(self) -> None:
        job = self.db.get_job(self.job_id)
        if job is None:
            self._fail("job row deleted")
            return
        desired_stop = job["desired_stop"]

        if self.state == JobState.CREATED:
            self._set_state(JobState.COMPILING)
        elif self.state == JobState.COMPILING:
            self._compile(job)
        elif self.state == JobState.QUEUED:
            self._queued_tick(job)
        elif self.state == JobState.SCHEDULING:
            self._schedule(job)
        elif self.state in (JobState.RUNNING, JobState.CHECKPOINT_STOPPING,
                            JobState.STOPPING, JobState.FINISHING):
            self._supervise(desired_stop, job)
        elif self.state == JobState.RESCALING:
            # the old worker is draining behind a final checkpoint; keep
            # supervising it — _supervise's finished/failed handlers do the
            # actual Rescaling -> Scheduling hop (reference rescaling.rs:16)
            if self.handle is not None:
                self._supervise(desired_stop, job)
            else:
                # adopted mid-rescale by a fresh controller: treat like a
                # restart at the (already persisted) new parallelism
                self._finish_rescale(job)
        elif self.state == JobState.EVOLVING:
            # the v1 set is draining behind its final checkpoint; keep
            # supervising it — the finished/failed handlers do the actual
            # Evolving -> Scheduling hop after the plan-diff pass proves
            # (and persists) the state carry-over mapping
            if self.handle is not None:
                self._supervise(desired_stop, job)
            else:
                # adopted mid-evolve by a fresh controller: the drain is
                # over; finish the evolution from the persisted request
                self._finish_evolve(job)
        elif self.state in (JobState.RECOVERING, JobState.RESTARTING):
            restarts_allowed = config().get("pipeline.allowed-restarts")
            if self.state == JobState.RECOVERING and self.restarts > restarts_allowed:
                self._fail(f"exceeded allowed-restarts={restarts_allowed}: {self.failure}")
                return
            # a crash-restoring job still holds its fleet slots; a restart
            # of a TERMINAL job released them and must re-enter admission
            # (Queued when the shared pool or its tenant quota is full)
            if not self.fleet.holds(self.job_id) \
                    and not self._admit_or_queue(job):
                return
            self.restore_epoch = self._pick_restore_epoch()
            self._event("WARN", "RESTORE",
                        f"restoring worker set from epoch "
                        f"{self.restore_epoch or 0} (restart {self.restarts})",
                        epoch=self.restore_epoch,
                        data={"restarts": self.restarts})
            self._set_state(JobState.SCHEDULING, restarts=self.restarts,
                            restore_epoch=self.restore_epoch)

    def _finish_rescale(self, job: dict) -> None:
        """Old worker is gone; restore from the freshest checkpoint at the
        new parallelism (the state layer rescales via key-range-overlap
        file reads on restore)."""
        # re-read the request: the API may have accepted a NEWER target
        # after this drain was triggered — honor the freshest value
        fresh = self.db.get_job(self.job_id) or job
        target = fresh.get("desired_parallelism") or self.rescale_to
        self.rescale_to = None
        if self._autoscale_target is not None and (
                not target or int(target) != self._autoscale_target):
            # the drain completed toward a DIFFERENT parallelism — a newer
            # manual target superseded the autoscale (or the request was
            # cleared) — so no AUTOSCALE_DONE may fire for this restart,
            # nor for any later unrelated one
            self._autoscale_target = None
        if target:
            self.parallelism = int(target)
            self.db.set_pipeline_parallelism(job["pipeline_id"], int(target))
            # conditional clear: a request racing in after the re-read
            # above survives and triggers a follow-up rescale
            self.db.clear_desired_parallelism(self.job_id, int(target))
        # the transition is over: the ledger settles on the final demand
        # (a scale-down frees slots for the next admission pass)
        self.fleet.set_demand(self.job_id, self._demand())
        self.restore_epoch = self._pick_restore_epoch()
        self._event("WARN", "RESTORE",
                    f"restoring worker set from epoch "
                    f"{self.restore_epoch or 0} at parallelism "
                    f"{self.parallelism} (rescale)",
                    epoch=self.restore_epoch,
                    data={"parallelism": self.parallelism})
        self._set_state(JobState.SCHEDULING, restore_epoch=self.restore_epoch,
                        restarts=self.restarts)

    def _finish_evolve(self, job: dict) -> None:
        """The v1 set drained behind its final checkpoint. Re-prove the
        state carry-over with the plan-diff pass against THAT drain (the
        API's plan-time check may be stale by now), persist the evolution
        mapping next to the checkpoint it applies to, bump the pipeline
        version, and reschedule the evolved plan restoring through the
        mapping. A rejection here restarts the UNCHANGED plan from its own
        drain checkpoint — never a torn half-evolved lineage."""
        if not self._hydrate_from_pipeline(job):
            return
        fresh = self.db.get_job(self.job_id) or job
        new_sql = fresh.get("desired_query") or self.evolve_to
        self.evolve_to = None
        self.restore_epoch = self._pick_restore_epoch()
        if not new_sql or new_sql == self.sql:
            # request withdrawn (or no-op) between pickup and drain end:
            # the drained set just restarts unchanged
            self._set_state(JobState.SCHEDULING,
                            restore_epoch=self.restore_epoch,
                            restarts=self.restarts)
            return
        diff = None
        reject_reason = ""
        try:
            from ..analysis.plan_diff import diff_plans
            from ..sql import plan_query

            scope = self.db.list_connection_tables()
            old_graph = plan_query(self.sql, connection_tables=scope).graph
            new_graph = plan_query(new_sql, connection_tables=scope).graph
            diff = diff_plans(old_graph, new_graph)
        except Exception as exc:  # noqa: BLE001 - reject, don't kill the job
            reject_reason = f"evolved query failed to plan: {exc}"
        if diff is not None and diff.rejected:
            reject_reason = "; ".join(
                f"{d.rule_id}: {d.message}" for d in diff.diagnostics
                if d.severity.name == "ERROR")
        if reject_reason:
            self._event(
                "ERROR", "JOB_EVOLVE_CLASSIFIED",
                f"evolution rejected at the drain barrier: "
                f"{reject_reason[:600]}",
                data={"rejected": True,
                      "classifications":
                          [c.to_json() for c in diff.classifications]
                          if diff is not None else []})
            self.db.clear_desired_query(self.job_id, new_sql)
            # the drained v1 restarts UNCHANGED from its own checkpoint
            self._set_state(JobState.SCHEDULING,
                            restore_epoch=self.restore_epoch,
                            restarts=self.restarts)
            return
        counts: dict[str, int] = {}
        for c in diff.classifications:
            counts[c.action] = counts.get(c.action, 0) + 1
        if self.restore_epoch:
            # the mapping is epoch-keyed and atomically written: a crash
            # anywhere after this point re-reads the SAME proof and the
            # restore stays deterministic
            from ..state.tables import write_evolution_mapping

            write_evolution_mapping(self.storage_url, self.job_id,
                                    self.restore_epoch, diff.mapping)
        version = self.db.evolve_pipeline_query(job["pipeline_id"], new_sql)
        self.db.clear_desired_query(self.job_id, new_sql)
        self.sql = new_sql
        # blue/green: phase-2 commits of the evolved set are withheld
        # until its first durable epoch (the cutover barrier, see
        # _epoch_durable); until then only staged output exists
        self._evolve_catchup = True
        self._event(
            "INFO", "JOB_EVOLVE_CLASSIFIED",
            "plan diff proved the carry-over: "
            + ", ".join(f"{counts.get(k, 0)} {k}" for k in
                        ("carried", "rebuilt", "dropped", "stateless"))
            + f"; pipeline version {version}, restoring from epoch "
              f"{self.restore_epoch or 0}",
            epoch=self.restore_epoch,
            data={"rejected": False, "version": version,
                  "classifications":
                      [c.to_json() for c in diff.classifications]})
        self._set_state(JobState.SCHEDULING,
                        restore_epoch=self.restore_epoch,
                        restarts=self.restarts)

    # ------------------------------------------------------------------

    def _compile(self, job: dict) -> None:
        from ..sql import plan_query

        pipeline = self.db.get_pipeline(job["pipeline_id"])
        if pipeline is None:
            self._fail("pipeline deleted")
            return
        self.sql = pipeline["query"]
        self.parallelism = int(pipeline["parallelism"])
        # a rescale accepted before the job ever ran starts the worker at
        # the new scale directly — no wasted drain cycle after Running
        want = job.get("desired_parallelism")
        if want:
            self.parallelism = int(want)
            self.db.set_pipeline_parallelism(job["pipeline_id"], int(want))
            self.db.clear_desired_parallelism(self.job_id, int(want))
        # validate with registered connection tables in scope; workers get
        # the planned IR (graph_json) so they need no DB access
        plan_query(self.sql, connection_tables=self.db.list_connection_tables())
        if not self._admit_or_queue(job):
            return
        self._set_state(JobState.SCHEDULING)

    def _hydrate_from_pipeline(self, job: dict) -> bool:
        """Load sql/parallelism for a job this controller never compiled
        (fresh controller adopting a Restarting/Recovering/Queued job)."""
        if self.sql is not None:
            return True
        pipeline = self.db.get_pipeline(job["pipeline_id"])
        if pipeline is None:
            self._fail("pipeline deleted")
            return False
        self.sql = pipeline["query"]
        self.parallelism = int(job.get("desired_parallelism")
                               or pipeline["parallelism"])
        self.restarts = int(job.get("restarts") or 0)
        return True

    def _admit_or_queue(self, job: dict) -> bool:
        """Ask the fleet for this job's slots. True = admitted, proceed;
        False = the state already moved (Queued on full pool / tenant at
        quota, Failed on a structural quota rejection)."""
        if not self._hydrate_from_pipeline(job):
            return False
        slots = self._demand()
        verdict, reason = self.fleet.admit(self.job_id, self.tenant, slots)
        data = {"tenant": self.tenant, "slots": slots, "reason": reason}
        if verdict == "rejected":
            self._event("ERROR", "JOB_REJECTED",
                        f"admission rejected: {reason}", data=data)
            self._fail(f"admission rejected: {reason}")
            return False
        if verdict == "queued":
            self._queued_since = time.monotonic()
            self._event("INFO", "JOB_QUEUED",
                        f"waiting for admission: {reason}", data=data)
            self._set_state(JobState.QUEUED)
            return False
        if self.fleet.pool_slots() is not None:
            # decision-point visibility only when the fleet is bounded —
            # the unlimited pass-through default stays event-silent
            self._event("INFO", "JOB_ADMITTED",
                        f"admitted into shared capacity ({slots} slots)",
                        data=data)
        return True

    def _queued_tick(self, job: dict) -> None:
        """One supervision tick in QUEUED: react to a cancel, otherwise
        wait for the fleet's deficit-round-robin pass to grant the slots
        (capacity freed by any terminal job triggers re-admission on the
        next tick)."""
        if not self._hydrate_from_pipeline(job):
            return
        if job.get("desired_stop"):
            # cancel path: nothing is running, stop takes effect now
            self.fleet.release(self.job_id)
            self._event("INFO", "JOB_QUEUED",
                        "queued job cancelled by a stop request")
            self._set_state(JobState.STOPPED)
            return
        if not self.fleet.holds(self.job_id) \
                and self.fleet.queue_position(self.job_id) is None:
            # adopted mid-queue by a fresh controller whose fleet ledger
            # is empty: re-enter at the PERSISTED position, so N adopted
            # jobs restore the original FIFO order regardless of which
            # controller ticks first
            self.fleet.restore_queued(
                self.job_id, self.tenant, self._demand(),
                position=self.db.fleet_queue_position(self.job_id))
        if not self.fleet.should_admit(self.job_id):
            return
        waited = (time.monotonic() - self._queued_since
                  if self._queued_since is not None else 0.0)
        self._event("INFO", "JOB_ADMITTED",
                    f"admitted after {waited:.1f}s queued "
                    f"({self._demand()} slots)",
                    data={"tenant": self.tenant, "slots": self._demand(),
                          "waited_s": round(waited, 3)})
        self.fleet.clear_backoff(self.job_id)
        # a preempted (or 409-bounced) job resumes from its freshest
        # checkpoint; a first-time job has none and starts clean
        self.restore_epoch = self._pick_restore_epoch()
        self._set_state(JobState.SCHEDULING,
                        restore_epoch=self.restore_epoch)

    def _requeue_for_capacity(self, reason: str) -> None:
        """Placement was rejected on capacity (node-daemon 409, injected
        admission fault): tear down whatever partially placed, re-queue at
        the head of the tenant queue with deterministic backoff — never a
        job failure, never a restart-budget token."""
        self._kill_all()
        self.fleet.requeue(self.job_id, self.tenant, self._demand(),
                           backoff=True)
        self._queued_since = time.monotonic()
        backoff = self.fleet.backoff_remaining(self.job_id)
        self._event("WARN", "JOB_QUEUED",
                    f"placement rejected; re-queued with {backoff:.1f}s "
                    f"backoff: {reason.splitlines()[0][:200]}",
                    data={"tenant": self.tenant, "slots": self._demand(),
                          "backoff_s": round(backoff, 3), "reason": "409"})
        self._set_state(JobState.QUEUED)

    def _compile_graph(self):
        """Plan once in the control plane and ship the dataflow IR to
        workers as data (reference: the API compiles SQL to a protobuf
        ArrowProgram and StartExecutionReq carries it — workers never
        re-plan). Falls back to shipping SQL when a config carries live
        objects the IR cannot serialize (e.g. in-process lookup tables)."""
        try:
            from ..sql import plan_query
            from ..sql.planner import set_parallelism

            pp = plan_query(self.sql,
                            connection_tables=self.db.list_connection_tables())
            if self.parallelism > 1:
                set_parallelism(pp.graph, self.parallelism)
            dumped = pp.graph.dumps()
            from ..graph import Graph

            Graph.loads(dumped)  # round-trip check before shipping
            return dumped
        except Exception:
            return None

    def _schedule(self, job: dict) -> None:
        if self.sql is None:
            # a fresh JobController adopting a Restarting/Recovering job
            # (reference: Restarting passes back through Compiling)
            pipeline = self.db.get_pipeline(job["pipeline_id"])
            if pipeline is None:
                self._fail("pipeline deleted")
                return
            self.sql = pipeline["query"]
            self.parallelism = int(pipeline["parallelism"])
            self.restarts = int(job["restarts"])
        graph_json = self._compile_graph()
        n_workers = int(config().get("controller.workers-per-job") or 1)
        from ..faults import InjectedFault, fault_point

        try:
            # chaos site `admission`: a node 409 (or delay) at the exact
            # placement moment, injectable for every scheduler. Recovery
            # is re-queue with deterministic backoff, never job failure.
            fault_point("admission", key=self.job_id, job=self.job_id)
            self.handles = list(self.scheduler.start_workers(
                self.sql, self.job_id, self.parallelism, self.restore_epoch,
                self.storage_url, udf_specs=self.db.list_udfs(),
                graph_json=graph_json, n_workers=n_workers,
            ))
        except (PlacementFull, InjectedFault) as e:
            self._requeue_for_capacity(str(e))
            return
        # a placement landed: the consecutive-409 backoff streak resets
        self.fleet.clear_backoff(self.job_id)
        self.coordinator = None
        if len(self.handles) > 1:
            # multi-worker set: this controller owns checkpoint coordination
            from .checkpoint_state import CheckpointCoordinator, compute_assignment

            _assignment, expected, _n = compute_assignment(
                graph_json, len(self.handles))
            # the coordinator writes the job-level metadata markers for
            # this set, so IT stamps the plan fingerprint (single workers
            # stamp their own in the engine); computed over the logical
            # pre-chaining graph so both sides always agree
            plan_hash = None
            try:
                from ..analysis.plan_diff import plan_fingerprint
                from ..graph import Graph

                plan_hash = plan_fingerprint(Graph.loads(graph_json))
            except Exception:  # noqa: BLE001 - stamping is best-effort
                plan_hash = None
            self.coordinator = CheckpointCoordinator(
                self.job_id, self.storage_url, expected,
                event_log=self.checkpoint_event_log, plan_hash=plan_hash)
        # a fresh worker set starts a fresh checkpoint ledger (and a fresh
        # metrics view: the old set's counters restart from zero)
        self._inflight_epochs = {}
        self._ckpt_failures = 0
        self._metrics_by_worker = {}
        # the old set's final merged snapshot is stale the moment the new
        # set exists: health/autoscaler must not act on its (typically
        # terrible) last readings until a fresh report lands
        self._last_merged_metrics = None
        # stale RateTracker points against the old set's (larger) totals
        # would make (new - old)/dt negative for a whole rate window
        self.rates.reset()
        self.db.update_job(self.job_id, n_workers=len(self.handles),
                           health=self.health.state)
        self.running_since = time.monotonic()
        self.last_checkpoint_time = time.monotonic()
        if self.restore_epoch:
            self.next_epoch = self.restore_epoch + 1
        self._set_state(JobState.RUNNING)
        # DONE only when this (re)start actually landed the decided
        # target — a crash restore racing in between the decision and
        # the rescale pickup restarts at the OLD parallelism first (the
        # still-pending desired_parallelism completes the scale on a
        # later pass through here), and a transition superseded by a
        # newer manual target cleared the flag in _finish_rescale
        if self._autoscale_target is not None \
                and self.parallelism == self._autoscale_target:
            self._autoscale_target = None
            self._event("INFO", "AUTOSCALE_DONE",
                        f"worker set running at parallelism "
                        f"{self.parallelism} (autoscale)",
                        data={"parallelism": self.parallelism,
                              "restore_epoch": self.restore_epoch})
        # any (re)start arms the autoscaler cooldown: post-restart metrics
        # are warm-up noise whether a rescale, a crash restore, or a fresh
        # schedule caused it (this also clears an in-flight autoscale)
        self.autoscaler.on_worker_set_started()

    # ------------------------------------------------- worker-set control

    def _trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        """Fan a checkpoint trigger to the whole worker set (each engine
        injects barriers into ITS local source subtasks) and arm the
        stuck-epoch watchdog."""
        if self.coordinator is not None:
            self.coordinator.begin(epoch)
        obs_trace.recorder.record(self.job_id, epoch, "trigger")
        self._inflight_epochs[epoch] = time.monotonic()
        rescaling = then_stop and (self.rescale_to is not None
                                   or self.state == JobState.RESCALING)
        evolving = then_stop and (self.evolve_to is not None
                                  or self.state == JobState.EVOLVING)
        from ..faults import fault_point

        for widx, h in enumerate(self.handles):
            if h is None:
                continue
            if rescaling:
                # chaos site `rescale`: the scale command to one worker
                # can be lost or delayed mid-transition. Recovery is
                # protocol-level: the unreached worker never acks, the
                # stuck-epoch watchdog declares the drain epoch failed
                # and re-triggers it at a fresh epoch (then_stop intact)
                verdict = fault_point("rescale", epoch=epoch, worker=widx)
                if verdict is not None and verdict[0] == "drop":
                    continue
            if evolving:
                # chaos site `evolve_drain`: the final-checkpoint drain
                # command of a live evolution is lost to one worker.
                # Recovery mirrors `rescale`: the unreached worker never
                # acks, the stuck-epoch watchdog re-triggers the drain at
                # a fresh epoch, and the evolved plan restores exactly the
                # lineage that drain proved — never a torn one
                verdict = fault_point("evolve_drain", epoch=epoch,
                                      worker=widx)
                if verdict is not None and verdict[0] == "drop":
                    continue
            h.trigger_checkpoint(epoch, then_stop=then_stop)

    def _epoch_durable(self, epoch: int) -> None:
        """An epoch's job-level metadata marker is durable (written by the
        engine in single-worker mode, by the coordinator at global coverage
        for worker sets). Record it, then — and only then — fan phase-2
        commits out (the coordinator's event log proves the ordering;
        single workers self-commit inside the engine)."""
        self._inflight_epochs.pop(epoch, None)
        self._ckpt_failures = 0
        obs_trace.recorder.record(self.job_id, epoch, "metadata_durable")
        if self._evolve_catchup and epoch != (self.restore_epoch or 0):
            # blue/green cutover: the evolved (v2) set's first durable
            # epoch proves it processed past the v1 drain watermark (its
            # sources resumed from the carried offsets), so the withheld
            # phase-2 commits may now be released — atomically at this
            # barrier, via the cumulative commit delivery. For coordinated
            # sets the `evolve_cutover` chaos site fires HERE, before any
            # commit leaves the controller; single-worker engines fire it
            # themselves at the same protocol point (engine.py).
            self._evolve_catchup = False
            if self.coordinator is not None:
                from ..faults import fault_point

                try:
                    fault_point("evolve_cutover", epoch=epoch,
                                key=self.job_id)
                except Exception as exc:  # noqa: BLE001 - injected crash
                    # crash AT the barrier: the epoch is durable but no
                    # commit was released. Re-arm the gate and take the
                    # normal recovery path — the restored set re-delivers
                    # the withheld commits cumulatively
                    # (COMMIT_REDELIVERED): one committed lineage, never
                    # two
                    self._evolve_catchup = True
                    self._on_worker_failed(
                        f"crash injected at the evolve cutover barrier "
                        f"(epoch {epoch}): {exc}",
                        self.db.get_job(self.job_id) or {})
                    return
            self._event("INFO", "JOB_EVOLVE_CUTOVER",
                        f"cutover: evolved set caught up and went durable "
                        f"at epoch {epoch}; releasing withheld commits",
                        epoch=epoch)
            self._event("INFO", "JOB_EVOLVE_DONE",
                        "evolution complete: the evolved plan owns the "
                        "single committed lineage",
                        epoch=epoch)
        if self.coordinator is not None:
            self.coordinator.send_commits(
                epoch,
                [h.send_commit if h is not None else None for h in self.handles])
        # the epoch's span tree is as complete as it gets: derive the phase
        # durations (align/snapshot/ack/commit), feed the histograms, and
        # persist both to the DB for `top`/`trace` and the API
        events = obs_trace.recorder.events(self.job_id, epoch)
        phases = obs_trace.phase_durations(events)
        if phases:
            from ..metrics import registry as metrics_registry

            metrics_registry.observe_epoch_phases(self.job_id, phases)
        # the trace first: a reader that finds the epoch complete (the
        # `trace` CLI, the API) finds its trace too
        self.db.record_trace(self.job_id, epoch, events)
        self.db.record_checkpoint(self.job_id, epoch, "complete",
                                  phases=phases or None)
        self.db.update_job(self.job_id, checkpoint_epoch=epoch)
        if self.state == JobState.CHECKPOINT_STOPPING and epoch == self.stopping_epoch:
            self._set_state(JobState.STOPPING)
        self._maybe_gc(epoch)

    def _maybe_gc(self, newest_epoch: int) -> None:
        """Controller-driven checkpoint GC: every
        ``checkpoint.compaction.epochs`` completed epochs, compact the
        newest globally-complete epoch's shards and drop everything older.
        ``newest_epoch`` is by construction the newest complete one, so the
        cleanup floor can never delete past a restorable checkpoint (and
        cleanup_checkpoints keeps the "final" drained-source snapshots).
        Runs on a background thread — storage-heavy compaction must not
        stall the supervision tick's heartbeat/watchdog checks for every
        other job (the reference triggers compaction asynchronously too)."""
        every = int(config().get("checkpoint.compaction.epochs") or 0)
        if every <= 0:
            return
        self._epochs_since_gc += 1
        if self._epochs_since_gc < every:
            return
        if self._gc_thread is not None and self._gc_thread.is_alive():
            return  # previous GC still running; counter stays armed
        self._epochs_since_gc = 0

        def _run_gc() -> None:
            from ..state.spill import cleanup_spill_runs
            from ..state.tables import cleanup_checkpoints, compact_job

            try:
                compact_job(self.storage_url, self.job_id, newest_epoch)
                cleanup_checkpoints(self.storage_url, self.job_id, newest_epoch)
                # tiered-state runs outlive single epochs; with the old
                # epochs gone, delete every run no surviving checkpoint
                # references (fresh post-checkpoint runs are epoch-tagged
                # and always kept)
                cleanup_spill_runs(self.storage_url, self.job_id, newest_epoch)
                self.db.record_checkpoint(self.job_id, newest_epoch, "compacted")
            except Exception:  # noqa: BLE001 - GC is best-effort maintenance
                _log.exception("checkpoint GC failed for %s at epoch %d",
                               self.job_id, newest_epoch)

        self._gc_thread = threading.Thread(
            target=_run_gc, daemon=True, name=f"ckpt-gc-{self.job_id}")
        self._gc_thread.start()

    def _record_worker_metrics(self, widx: int, data: dict) -> None:
        """Merge one worker's per-operator snapshot into the job view (union
        by subtask label — under an assignment each worker owns a disjoint
        slice, so a 2-worker set's snapshot carries BOTH workers' subtasks),
        refresh the windowed rates, and persist for the API/`top`."""
        from ..metrics import merge_job_metrics

        self._metrics_by_worker[widx] = data
        merged = merge_job_metrics(self._metrics_by_worker.values())
        self._last_merged_metrics = merged  # the health rules' input
        now = time.monotonic()
        for op, m in merged.items():
            self.rates.observe(
                f"{op}.sent", int(m.get("arroyo_worker_messages_sent", 0)), now)
            self.rates.observe(
                f"{op}.recv", int(m.get("arroyo_worker_messages_recv", 0)), now)
            m["messages_per_sec"] = round(self.rates.rate(f"{op}.sent"), 2)
            m["messages_recv_per_sec"] = round(self.rates.rate(f"{op}.recv"), 2)
        if merged:
            self.db.record_metrics(self.job_id, merged)
            # compact per-job cost profile (obs.profile): the queryable
            # snapshot behind /profile and `arroyo_tpu_torch explain`
            from ..obs.profile import job_profile

            self.db.record_profile(self.job_id, job_profile(merged))

    def _on_worker_finished(self, widx: int, h: WorkerHandle, job: dict) -> bool:
        """One worker of the set drained. Returns True when the whole set
        is done and the job-level transition happened."""
        # release the exited worker's resources (temp sql/udf files,
        # pipes); for a finished process this is pure cleanup
        try:
            h.kill()
        except Exception:  # lint: waive LR102 — best-effort kill during finished-worker cleanup; process is already gone
            pass
        self.handles[widx] = None
        if any(x is not None for x in self.handles):
            return False  # the rest of the set is still draining
        self.handles = []
        if self.state == JobState.RESCALING:
            self._finish_rescale(job)
            return True
        if self.state == JobState.EVOLVING:
            self._finish_evolve(job)
            return True
        if self.state in (JobState.STOPPING, JobState.CHECKPOINT_STOPPING):
            if self._requeue_after_stop:
                self._finish_preemption()
            else:
                self._set_state(JobState.STOPPED)
        else:
            if self._evolve_catchup:
                # the evolved set drained to exhaustion before a periodic
                # epoch could fire: its final flush IS the cutover barrier —
                # everything it produced is committed exactly once at finish
                self._evolve_catchup = False
                self._event("INFO", "JOB_EVOLVE_CUTOVER",
                            "cutover: evolved set drained to completion; "
                            "its final flush releases the withheld commits")
                self._event("INFO", "JOB_EVOLVE_DONE",
                            "evolution complete: the evolved plan owns the "
                            "single committed lineage")
            self._set_state(JobState.FINISHING)
            self._set_state(JobState.FINISHED)
        return True

    def _finish_preemption(self) -> None:
        """A quota-change preemption finished draining: back into the
        admission queue (no backoff — nothing was rejected), resuming from
        the drain checkpoint once the tenant fits its quota again."""
        self._requeue_after_stop = False
        self.fleet.requeue(self.job_id, self.tenant, self._demand())
        self._queued_since = time.monotonic()
        self._event("INFO", "JOB_QUEUED",
                    "preempted worker set drained; job re-entered the "
                    "admission queue",
                    data={"tenant": self.tenant, "slots": self._demand(),
                          "reason": "preempted"})
        self._set_state(JobState.QUEUED)

    def _on_worker_failed(self, error: str, job: dict,
                          worker: Optional[int] = None) -> None:
        """Any worker of the set failing (crash, heartbeat loss, wedged
        checkpoints) takes the WHOLE set down: the survivors hold state the
        failed worker's subtasks fed, so the only consistent restart is the
        full set from the last globally complete checkpoint. State-aware:
        a set dying mid-rescale still rescales, a set dying while stopping
        just stops (Stopping/CheckpointStopping have no Recovering edge)."""
        self.failure = error
        self._event("ERROR", "WORKER_LOST",
                    (error or "worker failure").splitlines()[0][:300],
                    worker=worker)
        self._kill_all()
        self.restarts += 1
        if self.state == JobState.RESCALING:
            # drain failed mid-rescale: still proceed to the new
            # parallelism from whatever checkpoint exists — but an
            # autoscaler-initiated transition that got disrupted arms the
            # exponential backoff before its NEXT decision
            self.autoscaler.on_scale_disrupted(error or "worker failure")
            self._finish_rescale(job)
        elif self.state == JobState.EVOLVING:
            # drain died mid-evolve: the evolution still proceeds, but
            # from the freshest COMPLETE checkpoint — the plan-diff
            # mapping is written against whatever epoch the restore
            # actually uses, so a torn drain can never split the lineage
            self._finish_evolve(job)
        elif self.state in (JobState.STOPPING, JobState.CHECKPOINT_STOPPING):
            if self._requeue_after_stop:
                # the preemption drain died mid-flight; the job still
                # re-queues and will restore from its last complete
                # checkpoint when re-admitted
                self._finish_preemption()
            else:
                self._set_state(JobState.STOPPED)
        else:
            self._set_state(JobState.RECOVERING,
                            failure_message=(self.failure or "")[-4000:])

    def _on_stuck_epochs(self, stuck: list[int], job: dict) -> bool:
        """``checkpoint.timeout-ms`` watchdog: a wedged epoch is declared
        failed, its torn shards are subsumed (they have no metadata marker,
        so restore already ignores them — deleting cannot lose state), and
        the checkpoint is retried at a fresh epoch. After
        ``checkpoint.max-consecutive-failures`` the whole set is restored
        from the last globally complete checkpoint. Returns True when the
        escalation ended this supervision pass."""
        outstanding: list = []
        to_subsume: list[int] = []
        wedge_report = ""
        for epoch in stuck:
            self._inflight_epochs.pop(epoch, None)
            if self.coordinator is not None:
                outstanding = self.coordinator.outstanding(epoch) or outstanding
                # forget FIRST (synchronously): late acks for the epoch are
                # dropped from here on, so deleting its shards cannot race a
                # still-completing worker into a torn-but-"complete" epoch
                self.coordinator.forget(epoch)
                to_subsume.append(epoch)
            # single-worker jobs get NO subsume: the engine owns completion
            # there and has no forget() — deleting shards could race a late-
            # unwedging subtask whose ack then publishes a metadata marker
            # over the emptied directory (silent state loss on restore); a
            # torn epoch without its marker is invisible anyway
            self.db.record_checkpoint(self.job_id, epoch, "failed")
            self._event(
                "WARN", "EPOCH_WEDGED",
                f"epoch {epoch} exceeded checkpoint.timeout-ms; torn shards "
                "subsumed, retrying at a fresh epoch",
                epoch=epoch,
                data={"unacked": [list(s) for s in outstanding]})
            # attach the epoch's trace timeline: the wedge diagnostic names
            # the exact subtask whose barrier never arrived / never acked,
            # and the persisted trace makes the postmortem queryable
            events = obs_trace.recorder.events(self.job_id, epoch)
            wedge_report = obs_trace.timeline_report(
                self.job_id, epoch, events,
                expected=self.coordinator.expected
                if self.coordinator is not None else None)
            self.db.record_trace(self.job_id, epoch, events)
            self._ckpt_failures += 1
            self.watchdog_failed_epochs += 1
        if to_subsume:
            # storage deletions off the supervision tick (same reason GC is
            # backgrounded: the watchdog fires exactly when storage is slow)
            def _subsume(epochs=tuple(to_subsume)) -> None:
                from ..state.tables import subsume_torn_epoch

                for e in epochs:
                    try:
                        subsume_torn_epoch(self.storage_url, self.job_id, e)
                    except Exception:  # noqa: BLE001 - orphans stay invisible
                        _log.exception("subsume of torn epoch %d failed for %s",
                                       e, self.job_id)

            threading.Thread(target=_subsume, daemon=True,
                             name=f"subsume-{self.job_id}").start()
        max_fail = int(config().get("checkpoint.max-consecutive-failures") or 3)
        detail = f" (unacked subtasks: {outstanding})" if outstanding else ""
        if self._ckpt_failures >= max_fail:
            self.watchdog_escalations += 1
            self._on_worker_failed(
                f"checkpoint wedged {self._ckpt_failures} consecutive times "
                f"(last epoch {stuck[-1]}){detail}; restoring the worker set "
                "from the last globally complete checkpoint\n"
                f"{wedge_report}", job)
            return True
        # retry at a FRESH epoch number (the wedged one is subsumed; late
        # acks for it are dropped by the coordinator)
        retry = self.next_epoch
        self.next_epoch += 1
        then_stop = False
        if self.stopping_epoch in stuck and self.state in (
                JobState.CHECKPOINT_STOPPING, JobState.RESCALING,
                JobState.EVOLVING):
            self.stopping_epoch = retry
            then_stop = True
        self._trigger_checkpoint(retry, then_stop=then_stop)
        self.last_checkpoint_time = time.monotonic()
        return False

    def _supervise(self, desired_stop: Optional[str], job: dict) -> None:
        assert self.handle is not None
        cfgv = config()
        # healthy-duration resets the restart budget (default.toml:8 analog)
        healthy_ms = cfgv.get("pipeline.healthy-duration-ms")
        if (self.restarts and self.running_since is not None
                and (time.monotonic() - self.running_since) * 1000 >= healthy_ms):
            self.restarts = 0
            self.db.update_job(self.job_id, restarts=0)

        # liveness snapshot BEFORE draining events: a worker that exits
        # mid-tick (finished/failed posted right after our poll) must be
        # diagnosed from its own terminal event on the NEXT tick, not
        # misreported as a heartbeat loss by the check below
        alive_before = [h is not None and h.alive() for h in self.handles]
        for widx, h in enumerate(list(self.handles)):
            if h is None:
                continue  # this worker already drained
            for ev in h.poll_events():
                kind = ev.get("event")
                if kind == "sink_data":
                    self.db.record_output(self.job_id, ev.get("lines", []))
                elif kind == "metrics":
                    data = ev.get("data") or {}
                    if data:
                        self._record_worker_metrics(widx, data)
                elif kind == "span":
                    # a worker subprocess relayed an epoch-lifecycle span;
                    # the controller's recorder holds the whole job timeline
                    obs_trace.recorder.record(
                        self.job_id, int(ev["epoch"]), ev["name"],
                        ev.get("node"), ev.get("subtask"), ev.get("worker"),
                        ev.get("t_us"))
                elif kind == "log":
                    # a worker subprocess relayed a structured job event
                    # (OPERATOR_PANIC, COMMIT_REDELIVERED, bridged stdlib
                    # records, ...); the controller's feed is authoritative
                    events_recorder.ingest(self.job_id, ev.get("data") or {})
                elif kind == "checkpoint_completed":
                    if self.coordinator is not None:
                        continue  # coordinated sets: durability is decided HERE
                    self._epoch_durable(int(ev["epoch"]))
                elif kind == "subtask_acked" and self.coordinator is not None:
                    durable = self.coordinator.on_ack(
                        int(ev["epoch"]), (ev["node"], int(ev["subtask"])),
                        integrity=ev.get("integrity"))
                    if durable is not None:
                        self._epoch_durable(durable)
                elif kind == "subtask_finished" and self.coordinator is not None:
                    for e in self.coordinator.on_task_finished(
                            (ev["node"], int(ev["subtask"]))):
                        self._epoch_durable(e)
                elif kind == "finished":
                    if self._on_worker_finished(widx, h, job):
                        return
                    break  # slot emptied; finished is a worker's last event
                elif kind == "failed":
                    err = ev.get("error", "unknown worker failure")
                    from .scheduler import NodeScheduler

                    if err.startswith("placement failed") \
                            and self.state == JobState.RUNNING \
                            and NodeScheduler._capacity_reason(err):
                        # a deferred node placement timed out on capacity
                        # (409, no free slots, no daemons): the job never
                        # ran, so it re-queues with backoff instead of
                        # spending a restart; a hard placement error (a
                        # daemon answering 500) takes the failure path
                        self._requeue_for_capacity(err)
                        return
                    self._on_worker_failed(err, job, worker=widx)
                    return

        # health monitors: every supervision tick evaluates the rule set
        # over the latest merged metrics (hysteresis inside the monitor)
        self._eval_health()

        # heartbeat / liveness per worker (reference worker-heartbeat-timeout)
        hb_timeout = cfgv.get("pipeline.worker-heartbeat-timeout-ms") / 1000
        for widx, h in enumerate(self.handles):
            if h is None:
                continue
            dead = not (alive_before[widx] if widx < len(alive_before) else True) \
                and not h.alive()
            if dead or (
                time.monotonic() - h.last_heartbeat() > hb_timeout
            ):
                self._on_worker_failed(
                    f"worker {widx} lost (heartbeat timeout)", job,
                    worker=widx)
                return

        # stuck-checkpoint watchdog (checkpoint.timeout-ms)
        timeout_ms = cfgv.get("checkpoint.timeout-ms") or 0
        if timeout_ms and self._inflight_epochs and self.state in (
                JobState.RUNNING, JobState.CHECKPOINT_STOPPING,
                JobState.RESCALING, JobState.EVOLVING):
            now = time.monotonic()
            stuck = [e for e, t0 in sorted(self._inflight_epochs.items())
                     if (now - t0) * 1000 >= timeout_ms]
            if stuck and self._on_stuck_epochs(stuck, job):
                return

        # a drop-prone control plane (controller_rpc chaos) may lose the stop
        # command; stop is idempotent, so re-send it while draining rather
        # than wedging in Stopping forever
        if self.state == JobState.STOPPING and (
                time.monotonic() - self._last_stop_resend >= 1.0):
            self._last_stop_resend = time.monotonic()
            for h in self.handles:
                if h is not None:
                    h.stop()

        # quota-change preemption: the fleet marked this job (its tenant's
        # quota dropped below current usage) — drain behind a final
        # checkpoint, then back into the admission queue (JOB_PREEMPTED ->
        # drained -> JOB_QUEUED), restoring from that checkpoint once the
        # tenant fits again
        if self.state == JobState.RUNNING \
                and self.fleet.take_preemption(self.job_id):
            self._event("WARN", "JOB_PREEMPTED",
                        f"tenant {self.tenant!r} over quota after a quota "
                        "change; draining behind a final checkpoint and "
                        "re-queueing",
                        data={"tenant": self.tenant,
                              "slots": self._demand()})
            self._requeue_after_stop = True
            self.stopping_epoch = self.next_epoch
            self.next_epoch += 1
            self._trigger_checkpoint(self.stopping_epoch, then_stop=True)
            self._set_state(JobState.CHECKPOINT_STOPPING)
            return

        # elastic autoscaler: sustained pressure (or proven headroom) on
        # the merged metrics becomes a desired_parallelism the rescale
        # block below actuates through the normal drain/restore path. A
        # manual request already in flight always wins — the loop never
        # fights the operator — and a non-Running tick only resets the
        # hysteresis counters.
        can_scale = (self.state == JobState.RUNNING and not desired_stop
                     and not job.get("desired_parallelism")
                     # a pending live evolution owns the next drain cycle:
                     # the autoscaler must not wedge a rescale in front of it
                     and not job.get("desired_query"))
        target = self.autoscaler.evaluate(
            self._last_merged_metrics if can_scale else None,
            running=can_scale, parallelism=self.parallelism,
            ckpt_failures=self._ckpt_failures)
        if target is not None and target > self.parallelism:
            # a scale-up needs extra fleet slots BEFORE it actuates: a
            # pool that cannot place it turns the decision into fleet
            # pressure (the fleet loop grows the pool; the re-armed
            # hysteresis re-fires the decision once it has) instead of a
            # doomed drain/restore cycle
            grow = demand_slots(len(self.handles) or 1, target)
            if not self.fleet.try_grow(self.job_id, grow):
                self.autoscaler.on_capacity_blocked(self.parallelism, target)
                target = None
        if target is not None:
            # compare-and-set: a manual PATCH landing between this tick's
            # job-row read and here must win, not be clobbered
            if not self.db.set_desired_parallelism_if_unset(
                    self.job_id, target):
                self.autoscaler.abandon_in_flight()
            else:
                self._autoscale_target = target
                self._event("INFO", "AUTOSCALE_STARTED",
                            f"autoscale {self.parallelism} -> {target}: "
                            "draining the set behind a final checkpoint",
                            data={"from": self.parallelism, "to": target})
                job = dict(job)
                job["desired_parallelism"] = target  # same-tick pickup below

        # rescale requests from the API (reference states/rescaling.rs:1-70):
        # checkpoint-and-stop the old worker set, then reschedule at the new
        # parallelism restoring from that final checkpoint
        if self.state == JobState.RUNNING and not desired_stop:
            want = job.get("desired_parallelism")
            if want and int(want) != self.parallelism:
                self.rescale_to = int(want)
                # the fleet ledger carries the transition's worst case
                # (old lanes still live while the drain runs); manual
                # requests always win even if that oversubscribes — the
                # overdraft reads as fleet pressure and grows the pool
                self.fleet.set_demand(self.job_id, demand_slots(
                    len(self.handles) or 1,
                    max(self.parallelism, int(want))))
                self._event("INFO", "RESCALE",
                            f"rescale {self.parallelism} -> {int(want)}: "
                            "draining the set behind a final checkpoint",
                            data={"from": self.parallelism, "to": int(want)})
                self.stopping_epoch = self.next_epoch
                self.next_epoch += 1
                self._trigger_checkpoint(self.stopping_epoch, then_stop=True)
                self._set_state(JobState.RESCALING)
                return
            if want and int(want) == self.parallelism:
                # no-op rescale: clear the request
                self.db.update_job(self.job_id, desired_parallelism=None)

        # live evolution requests from the API (versioned redeploy,
        # `POST /pipelines/<id>/evolve`): drain the running (v1) set behind
        # a final checkpoint; _finish_evolve then proves the carry-over
        # with the plan-diff pass and reschedules the evolved plan from
        # exactly that checkpoint
        if self.state == JobState.RUNNING and not desired_stop:
            want_sql = job.get("desired_query")
            if want_sql and want_sql != self.sql:
                self.evolve_to = want_sql
                self._event("INFO", "JOB_EVOLVE_STARTED",
                            "evolution accepted: draining the running set "
                            "behind a final checkpoint before the "
                            "versioned redeploy",
                            data={"drain_epoch": self.next_epoch})
                self.stopping_epoch = self.next_epoch
                self.next_epoch += 1
                self._trigger_checkpoint(self.stopping_epoch,
                                         then_stop=True)
                self._set_state(JobState.EVOLVING)
                return
            if want_sql and want_sql == self.sql:
                # no-op evolution: clear the request
                self.db.clear_desired_query(self.job_id, want_sql)

        # stop requests from the API; a stop also voids any pending rescale
        # so it cannot resurrect as a surprise drain cycle at a later restart
        if self.state == JobState.RUNNING and desired_stop:
            if desired_stop == "checkpoint":
                self.stopping_epoch = self.next_epoch
                self.next_epoch += 1
                self._trigger_checkpoint(self.stopping_epoch, then_stop=True)
                self._set_state(JobState.CHECKPOINT_STOPPING, desired_parallelism=None)
            else:
                for h in self.handles:
                    if h is not None:
                        h.stop()
                self._set_state(JobState.STOPPING, desired_parallelism=None)
            return

        # periodic checkpoints (reference default-checkpoint-interval)
        if self.state == JobState.RUNNING:
            interval = cfgv.get("checkpoint.interval-ms") / 1000
            if time.monotonic() - self.last_checkpoint_time >= interval:
                self._trigger_checkpoint(self.next_epoch)
                self.next_epoch += 1
                self.last_checkpoint_time = time.monotonic()


class ControllerServer:
    """Polls the DB and supervises every live job
    (reference ControllerServer + start_updater)."""

    def __init__(self, db: Database, scheduler: Optional[Scheduler] = None,
                 storage_url: Optional[str] = None, poll_interval: float = 0.1):
        self.db = db
        self.scheduler = scheduler or scheduler_for(
            config().get("controller.scheduler"), db)
        self.storage_url = storage_url
        self.poll_interval = poll_interval
        # concurrency: single-writer — mutated only inside tick(), which runs either on the controller thread (start()) or inline in tests, never both; stop() reads after joining the thread
        self.jobs: dict[str, JobController] = {}
        # the multi-tenant fleet: one shared slot pool / admission queue
        # across every job this controller supervises
        self.fleet = FleetManager(self.scheduler)
        # per-job tick isolation: a job whose supervision step overruns
        # fleet.tick-budget-ms is deprioritized (runs last, skipped for
        # up to tick-penalty-max ticks) so a melting job cannot starve
        # its neighbors' heartbeat/watchdog checks — but it always runs
        # again, never skipped forever
        self._tick_penalty: dict[str, int] = {}  # concurrency: single-writer — tick()-private (see jobs above)
        self._tick_skip: dict[str, int] = {}  # concurrency: single-writer — tick()-private (see jobs above)
        self._overrun_emitted: dict[str, float] = {}  # concurrency: single-writer — tick()-private (see jobs above)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ControllerServer":
        self._thread = threading.Thread(target=self._run, daemon=True, name="controller")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.poll_interval)

    # supervision states the per-job tick budget applies to: compile and
    # schedule steps are EXPECTED to be slow (planning, spawning worker
    # sets) — the isolation target is a melting RUNNING job stalling its
    # neighbors' heartbeat/watchdog checks
    _BUDGETED_STATES = (JobState.RUNNING, JobState.CHECKPOINT_STOPPING,
                        JobState.STOPPING, JobState.FINISHING,
                        JobState.RESCALING, JobState.EVOLVING)

    def tick(self) -> None:
        for row in self.db.list_jobs():
            jid = row["id"]
            if jid not in self.jobs:
                if row["state"] in ("Failed", "Finished", "Stopped"):
                    continue
                self.jobs[jid] = JobController(
                    self.db, jid, self.scheduler, self.storage_url,
                    fleet=self.fleet,
                )
        for jid, jc in list(self.jobs.items()):
            if jc.is_terminal():
                # persist a final snapshot, then free the process-global
                # registry (it would otherwise grow per finished job)
                from ..metrics import registry as metrics_registry

                final = metrics_registry.job_metrics(jid)
                if final:
                    self.db.record_metrics(jid, final)
                    from ..obs.profile import job_profile

                    self.db.record_profile(jid, job_profile(final))
                metrics_registry.clear_job(jid)
                # flush every buffered epoch trace to the DB (postmortems
                # via the API/`trace` CLI survive the recorder eviction)
                for epoch in obs_trace.recorder.epochs(jid):
                    self.db.record_trace(
                        jid, epoch, obs_trace.recorder.events(jid, epoch))
                obs_trace.recorder.clear_job(jid)
                # job event feed: final flush, then free the ring (the DB
                # copy is the postmortem surface)
                jc._flush_events()
                events_recorder.clear_job(jid)
                # freed capacity is handed out by this tick's admission
                # pass below — any terminal job triggers re-admission
                self.fleet.release(jid)
                self._tick_penalty.pop(jid, None)
                self._tick_skip.pop(jid, None)
                self._overrun_emitted.pop(jid, None)
                del self.jobs[jid]
                continue
        # fleet pass BEFORE job steps: capacity refresh, quota-preemption
        # marks, the DRR admission pass over freshly freed slots, the
        # fleet autoscaler, gauge export, and the persisted snapshot
        self.fleet.tick(self.db)
        budget_ms = float(config().get("fleet.tick-budget-ms") or 0)
        pen_max = max(1, int(config().get("fleet.tick-penalty-max") or 4))
        # deprioritized jobs run LAST so a melting job's slow step lands
        # after its neighbors already got their heartbeat/watchdog ticks
        ordered = sorted(self.jobs.items(),
                         key=lambda kv: self._tick_penalty.get(kv[0], 0))
        for jid, jc in ordered:
            if jc.is_terminal():
                continue  # cleaned up at the top of the next tick
            skip = self._tick_skip.get(jid, 0)
            if skip > 0:
                self._tick_skip[jid] = skip - 1
                continue
            budgeted = budget_ms > 0 and jc.state in self._BUDGETED_STATES
            t0 = time.monotonic()
            jc.step()
            dt_ms = (time.monotonic() - t0) * 1000.0
            if budgeted and dt_ms > budget_ms:
                pen = min(self._tick_penalty.get(jid, 0) + 1, pen_max)
                self._tick_penalty[jid] = pen
                self._tick_skip[jid] = pen
                now = time.monotonic()
                if now - self._overrun_emitted.get(jid, 0.0) >= 5.0:
                    self._overrun_emitted[jid] = now
                    jc._event(
                        "WARN", "JOB_TICK_OVERRUN",
                        f"supervision step took {dt_ms:.0f}ms (budget "
                        f"{budget_ms:.0f}ms); deprioritized for {pen} "
                        "ticks — neighbors tick first, this job still "
                        "ticks every cycle after that",
                        data={"ms": round(dt_ms, 1),
                              "budget_ms": budget_ms, "penalty": pen})
            elif self._tick_penalty.get(jid):
                # a compliant step decays the penalty toward zero
                pen = self._tick_penalty[jid] - 1
                if pen:
                    self._tick_penalty[jid] = pen
                else:
                    self._tick_penalty.pop(jid, None)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        for jc in self.jobs.values():
            jc._kill_all()

    def wait_for_state(self, job_id: str, *states: str, timeout: float = 120) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.db.get_job(job_id)
            if job and job["state"] in states:
                return job["state"]
            if job and job["state"] == "Failed" and "Failed" not in states:
                raise RuntimeError(f"job failed: {job['failure_message']}")
            time.sleep(0.05)
        raise TimeoutError(f"job {job_id} never reached {states}")
