"""Shared resilience layer: backoff, deadlines, budgets, circuit breaking
(the port's copy of the JAX package's ``utils/retry.py``, reading the
port's own config).

Every retry loop in the engine goes through this module instead of hand-rolled
``time.sleep`` loops (reference: the Rust engine leans on tower/backoff
middleware plus object_store's built-in retry policy; here the equivalent is
one shared policy object so storage, connectors, and the control plane all
back off the same way and chaos tests can reason about recovery timing).

Pieces:

- ``RetryPolicy``       declarative knobs (attempts, delays, deadline),
                        loadable from config (``retry.*`` keys).
- ``Backoff``           the delay sequence as an object, for loops that
                        cannot be phrased as a retried callable (e.g. the
                        Kinesis per-shard sweep, partial PutRecords retries).
- ``retry_call``        run a callable under a policy, retrying transient
                        failures with decorrelated jitter.
- ``RetryBudget``       token bucket shared across call sites so a broken
                        dependency cannot multiply load.
- ``CircuitBreaker``    fail-fast after repeated failures, with a cooldown
                        half-open probe.

Fault-injection note: ``arroyo_tpu_torch.faults`` raises ``InjectedFault`` (marked
transient) at instrumented call sites; ``default_transient`` classifies those
as retryable, which is how the chaos suite proves "transient storage fault
recovers without job restart".
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

_log = logging.getLogger("arroyo_tpu_torch.retry")


class CircuitOpenError(RuntimeError):
    """Raised instead of attempting a call while a circuit is open."""


def default_transient(exc: BaseException) -> bool:
    """Conservative cross-backend classification of retryable failures."""
    # injected chaos faults declare themselves
    transient = getattr(exc, "transient", None)
    if transient is not None:
        return bool(transient)
    if isinstance(exc, (ConnectionError, TimeoutError, socket.timeout)):
        return True
    import urllib.error

    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in (408, 429) or exc.code >= 500
    if isinstance(exc, urllib.error.URLError):
        return True  # DNS / refused / reset — all worth one more try
    # botocore-style errors carry a response dict
    resp = getattr(exc, "response", None)
    if isinstance(resp, dict):
        code = str(resp.get("Error", {}).get("Code", ""))
        status = resp.get("ResponseMetadata", {}).get("HTTPStatusCode") or 0
        return code in ("SlowDown", "Throttling", "ThrottlingException",
                        "RequestTimeout", "InternalError",
                        "ServiceUnavailable") or int(status) >= 500
    return False


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter, bounded by attempts AND an
    optional wall-clock deadline across all attempts."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # fraction of each delay that is randomized away
    deadline_s: Optional[float] = None

    @classmethod
    def from_config(cls, prefix: str = "retry") -> "RetryPolicy":
        from ..config import config

        c = config()

        def g(key, default):
            v = c.get(f"{prefix}.{key}")
            return default if v is None else v

        return cls(
            max_attempts=int(g("max-attempts", cls.max_attempts)),
            base_delay_s=float(g("base-delay-ms", cls.base_delay_s * 1000)) / 1000,
            max_delay_s=float(g("max-delay-ms", cls.max_delay_s * 1000)) / 1000,
            multiplier=float(g("multiplier", cls.multiplier)),
            jitter=float(g("jitter", cls.jitter)),
            deadline_s=(float(g("deadline-ms", -1)) / 1000) if g("deadline-ms", None) else None,
        )


class Backoff:
    """The policy's delay sequence as a stateful object. Loops that interleave
    other work between failures (shard sweeps, partial batch retries) use this
    directly; ``reset()`` on success."""

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 rng: Optional[random.Random] = None):
        self.policy = policy or RetryPolicy()
        self.rng = rng or random.Random()
        self.attempts = 0
        self._started = time.monotonic()

    def reset(self) -> None:
        self.attempts = 0
        self._started = time.monotonic()

    def next_delay(self) -> float:
        """Delay to sleep before the next attempt (0 jitters downward)."""
        p = self.policy
        # clamp the exponent: retry-forever loops (max_attempts ~ 2**30)
        # would overflow float at multiplier**1024 long before max_delay
        # stops mattering
        exp = min(self.attempts, 64)
        raw = min(p.base_delay_s * (p.multiplier ** exp), p.max_delay_s)
        self.attempts += 1
        if p.jitter:
            raw -= self.rng.random() * p.jitter * raw
        return max(raw, 0.0)

    def exhausted(self) -> bool:
        p = self.policy
        if self.attempts >= p.max_attempts:
            return True
        if p.deadline_s is not None and time.monotonic() - self._started >= p.deadline_s:
            return True
        return False

    def delays(self) -> Iterable[float]:
        while not self.exhausted():
            yield self.next_delay()


class RetryBudget:
    """Token bucket spent by retries (not first attempts). When a dependency
    is hard-down, every caller burning its full local retry schedule
    multiplies load; a shared budget lets the first few callers retry and
    fails the rest fast."""

    def __init__(self, capacity: float = 10.0, refill_per_s: float = 1.0):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.refill_per_s)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class CircuitBreaker:
    """Consecutive-failure breaker. Closed -> open after ``threshold``
    failures; open calls raise ``CircuitOpenError`` immediately until
    ``cooldown_s`` passes, then one probe is allowed (half-open)."""

    def __init__(self, threshold: int = 6, cooldown_s: float = 5.0,
                 name: str = "circuit"):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                return True  # half-open probe
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self.threshold and self._opened_at is None:
                self._opened_at = time.monotonic()
                _log.warning("circuit %s opened after %d consecutive failures",
                             self.name, self._failures)

    @property
    def open(self) -> bool:
        return not self.allow()

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None


def retry_call(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    retry_on: Callable[[BaseException], bool] = default_transient,
    description: str = "",
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    budget: Optional[RetryBudget] = None,
    breaker: Optional[CircuitBreaker] = None,
    rng: Optional[random.Random] = None,
    **kwargs,
):
    """Call ``fn`` retrying transient failures per ``policy``.

    Non-transient failures (per ``retry_on``) raise immediately. On retry
    exhaustion the LAST failure raises — callers see the real error, not a
    wrapper. ``breaker``/``budget`` compose: an open breaker fails fast, a
    drained budget turns the first failure terminal.
    """
    if breaker is not None and not breaker.allow():
        raise CircuitOpenError(
            f"{breaker.name} open; refusing {description or getattr(fn, '__name__', 'call')}")
    backoff = Backoff(policy, rng=rng)
    while True:
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - classified below
            if not retry_on(e):
                # application-level error (404, FileNotFoundError, logic
                # bug): not a dependency-health signal, the breaker must
                # not count it
                raise
            if backoff.exhausted() or (budget is not None
                                       and not budget.try_spend()):
                if breaker is not None:
                    breaker.record_failure()
                raise
            delay = backoff.next_delay()
            if on_retry is not None:
                on_retry(e, backoff.attempts, delay)
            _log.debug("retrying %s after %s (attempt %d, sleeping %.3fs)",
                       description or getattr(fn, "__name__", "call"), e,
                       backoff.attempts, delay)
            sleep(delay)
            continue
        if breaker is not None:
            breaker.record_success()
        return result
