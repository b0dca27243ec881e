"""Job state machine.

The port's copy of arroyo_tpu/controller/states.py.

Mirrors the reference FSM (crates/arroyo-controller/src/states/mod.rs:47-228):
Created -> Compiling -> Scheduling -> Running, with Recovering / Restarting /
Rescaling / Evolving / CheckpointStopping / Stopping and terminal Failed /
Finished / Stopped. Transitions are validated so illegal jumps fail loudly.

Evolving (live pipeline evolution, this repo's addition) mirrors Rescaling:
the running set drains behind a final checkpoint, the controller re-plans
the NEW SQL, writes the evolution mapping the plan-diff pass proved sound
(analysis/plan_diff.py), and the evolved plan re-enters Scheduling restoring
carried state from the drained checkpoint.

The multi-tenant fleet (controller/fleet.py) adds QUEUED between
Compiling and Scheduling: a job the shared pool cannot place (or whose
tenant is at quota) waits there — Pending -> Queued -> Scheduled — and is
admitted by the fleet's deficit-round-robin pass when capacity frees.
Scheduling/Running re-enter Queued when placement is rejected (node 409);
CheckpointStopping/Stopping re-enter it when a quota change preempts the
job (drain behind a checkpoint, then back into the queue).
"""

from __future__ import annotations

import enum


class JobState(enum.Enum):
    CREATED = "Created"
    COMPILING = "Compiling"
    QUEUED = "Queued"
    SCHEDULING = "Scheduling"
    RUNNING = "Running"
    RECOVERING = "Recovering"
    RESTARTING = "Restarting"
    RESCALING = "Rescaling"
    EVOLVING = "Evolving"
    CHECKPOINT_STOPPING = "CheckpointStopping"
    STOPPING = "Stopping"
    FINISHING = "Finishing"
    FAILED = "Failed"
    FINISHED = "Finished"
    STOPPED = "Stopped"


TERMINAL = {JobState.FAILED, JobState.FINISHED, JobState.STOPPED}

# legal transitions (reference states/mod.rs transition table)
TRANSITIONS: dict[JobState, set[JobState]] = {
    JobState.CREATED: {JobState.COMPILING, JobState.FAILED, JobState.STOPPED},
    JobState.COMPILING: {JobState.SCHEDULING, JobState.QUEUED,
                         JobState.FAILED, JobState.STOPPED},
    # Queued -> Stopped is the cancel path: nothing is running, so a stop
    # request takes effect immediately without a drain
    JobState.QUEUED: {JobState.SCHEDULING, JobState.STOPPED, JobState.FAILED},
    JobState.SCHEDULING: {JobState.RUNNING, JobState.FAILED, JobState.STOPPED,
                          JobState.RECOVERING, JobState.QUEUED},
    # Running -> Queued: a deferred (lazy) placement was finally rejected
    # by every node — the job never actually ran and re-queues
    JobState.RUNNING: {JobState.RECOVERING, JobState.RESTARTING, JobState.RESCALING,
                       JobState.EVOLVING,
                       JobState.CHECKPOINT_STOPPING, JobState.STOPPING,
                       JobState.FINISHING, JobState.FINISHED, JobState.FAILED,
                       JobState.QUEUED},
    JobState.RECOVERING: {JobState.SCHEDULING, JobState.QUEUED,
                          JobState.FAILED, JobState.STOPPED},
    JobState.RESTARTING: {JobState.SCHEDULING, JobState.QUEUED,
                          JobState.FAILED, JobState.STOPPED},
    JobState.RESCALING: {JobState.SCHEDULING, JobState.FAILED, JobState.STOPPED},
    # Evolving: v1 drains behind a final checkpoint, then the evolved plan
    # re-enters Scheduling with the carried-state mapping applied at restore
    JobState.EVOLVING: {JobState.SCHEDULING, JobState.FAILED, JobState.STOPPED},
    # *Stopping -> Queued: a quota-change preemption drains the set behind
    # a final checkpoint, then the job re-enters the admission queue
    JobState.CHECKPOINT_STOPPING: {JobState.STOPPING, JobState.STOPPED,
                                   JobState.FAILED, JobState.QUEUED},
    JobState.STOPPING: {JobState.STOPPED, JobState.FAILED, JobState.QUEUED},
    JobState.FINISHING: {JobState.FINISHED, JobState.FAILED},
    JobState.FAILED: {JobState.RESTARTING},  # manual restart of a failed job
    JobState.FINISHED: set(),
    JobState.STOPPED: {JobState.RESTARTING},
}


class IllegalTransition(RuntimeError):
    pass


def check_transition(cur: JobState, nxt: JobState) -> None:
    if nxt not in TRANSITIONS[cur]:
        raise IllegalTransition(f"job cannot go {cur.value} -> {nxt.value}")
