"""Control plane: job lifecycle, schedulers, REST API.

The port's copy of arroyo_tpu/controller/__init__.py.

Parallel of crates/arroyo-controller + arroyo-api (SURVEY §2.4):
a job state machine driving pipelines from Created through Running with
bounded restarts, periodic checkpoint triggering, worker supervision via an
embedded engine or spawned worker processes, and an axum-equivalent REST API
(http.server) over a SQLite pipeline/job store.
"""

from .db import Database
from .states import JobState
from .controller import ControllerServer, JobController

__all__ = ["Database", "JobState", "ControllerServer", "JobController"]
