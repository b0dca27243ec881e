"""Per-job structured events (the port's minimal copy of
arroyo_tpu/obs/events.py): a bounded ring of event dicts per job, with the
JAX package's fields. The compiled segment records ``SEGMENT_COMPILED`` and
``SEGMENT_FALLBACK`` here; the exposition (Prometheus text, ``logs``,
``top``) is a later slice of the port."""

from __future__ import annotations

import threading
import time
from typing import Optional

_LEVELS = ("DEBUG", "INFO", "WARN", "ERROR")


class JobEventLog:
    """Bounded per-job ring of events; each gets a per-job ``seq``."""

    def __init__(self, max_events_per_job: int = 512):
        self.max_per_job = max_events_per_job
        self._lock = threading.Lock()
        self._jobs: dict[str, list[dict]] = {}
        self._seq: dict[str, int] = {}

    def record(self, job_id: str, level: str, code: str, message: str = "",
               node: Optional[str] = None, subtask: Optional[int] = None,
               data: Optional[dict] = None) -> dict:
        level = str(level).upper()
        ev = {"ts_us": time.time_ns() // 1000,
              "level": level if level in _LEVELS else "INFO",
              "code": str(code), "node": node,
              "subtask": None if subtask is None else int(subtask),
              "message": str(message), "data": data or {}}
        with self._lock:
            seq = self._seq.get(job_id, 0) + 1
            self._seq[job_id] = seq
            ev["seq"] = seq
            ring = self._jobs.setdefault(job_id, [])
            ring.append(ev)
            if len(ring) > self.max_per_job:
                del ring[: len(ring) - self.max_per_job]
        return ev

    def events(self, job_id: str, code: Optional[str] = None) -> list[dict]:
        """The job's events, oldest first, optionally of one code."""
        with self._lock:
            out = list(self._jobs.get(job_id, ()))
        return [e for e in out if code is None or e["code"] == code]

    def clear_job(self, job_id: str) -> None:
        with self._lock:
            self._jobs.pop(job_id, None)
            self._seq.pop(job_id, None)


recorder = JobEventLog()
