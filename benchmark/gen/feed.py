"""When the load generator emits how many events: a closed loop (full
batches as fast as the system takes them) or an open loop (each event due
at a fixed wall-clock rate; each poll emits what has fallen due, at most a
batch). The feed also keeps the run's record of emissions, so the
throughput and the generator's lag are read from the generator's side.

It imports nothing of the system under test; ``gen/connector.py`` drives it
from inside the system's source task.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class Feed:
    """``limit`` ends the stream after that many events (a warm-up's
    bounded run); ``finish()`` ends it at the next poll (closed loop) or
    once ``end_count`` events have been emitted (open loop). A positive
    ``rate`` (events a second) makes the loop open."""

    POLL_S = 0.005  # the open loop's poll interval where a cell names none

    def __init__(self, generator, batch: int, rate: float = 0.0, poll_s: float = POLL_S,
                 limit: Optional[int] = None):
        self.generator = generator
        self.batch = int(batch)
        self.rate = float(rate)
        self.poll_s = float(poll_s)
        self.limit = limit
        self.go = threading.Event()
        self.t0: Optional[float] = None  # the schedule's origin: event n is due at t0 + n / rate
        self._finish = threading.Event()
        self.end_count: Optional[int] = None
        self._next_poll = 0.0
        # (wall time the batch was accepted, events emitted so far), one a batch
        self.emissions: list[tuple[float, int]] = []
        # the open loop's lateness at each poll that emitted: accepted - due time of its last event
        self.lags_s: list[tuple[float, float]] = []

    # ---------------------------------------------------------- the harness

    def start(self) -> float:
        self.t0 = time.perf_counter()
        self._next_poll = self.t0
        self.go.set()
        return self.t0

    def finish(self, end_count: Optional[int] = None) -> None:
        self.end_count = end_count
        self._finish.set()

    def due_time(self, n: int) -> float:
        """Wall time at which event ``n`` fell due (the open loop)."""
        return self.t0 + n / self.rate

    def emitted_at(self, t: float) -> float:
        """Events emitted by wall time ``t``, interpolated between the two
        batches around it (the count moves a batch at a time)."""
        em = self.emissions
        if not em or t <= em[0][0]:
            return 0.0 if not em else float(em[0][1]) * (t >= em[0][0])
        lo, hi = 0, len(em) - 1
        if t >= em[hi][0]:
            return float(em[hi][1])
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if em[mid][0] <= t:
                lo = mid
            else:
                hi = mid
        (ta, na), (tb, nb) = em[lo], em[hi]
        return na + (nb - na) * (t - ta) / (tb - ta)

    # ---------------------------------------------------------- the source

    def take(self, i: int) -> Optional[int]:
        """How many events to emit after the first ``i``: None ends the
        stream, 0 means none is due yet (call ``wait``)."""
        cap = self.batch
        if self.limit is not None:
            if i >= self.limit:
                return None
            cap = min(cap, self.limit - i)
        if not self.rate:
            return None if self._finish.is_set() else cap
        if self._finish.is_set() and self.end_count is not None:
            if i >= self.end_count:
                return None
            cap = min(cap, self.end_count - i)
        now = time.perf_counter()
        if now < self._next_poll:
            return 0
        due = int((now - self.t0) * self.rate) - i
        if due <= cap:  # caught up: the next poll comes a poll interval on
            self._next_poll = now + self.poll_s
        return max(0, min(cap, due))

    def wait(self) -> None:
        """Sleep to the next poll of the open loop."""
        delay = self._next_poll - time.perf_counter()
        if delay > 0:
            time.sleep(min(delay, self.poll_s))

    def emitted(self, i: int) -> None:
        now = time.perf_counter()
        self.emissions.append((now, i))
        if self.rate:
            self.lags_s.append((now, now - self.due_time(i - 1)))
