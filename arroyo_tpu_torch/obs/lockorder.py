"""Runtime lock-order witness: the dynamic half of the LR402 audit (the
port's copy of the JAX package's ``obs/lockorder.py``).

The static concurrency auditor (analysis/concurrency_audit.py) builds an
acquires-while-holding graph over ``Class.attr`` lock nodes and flags
cycles. A static model is only as good as its ground truth, so this
module provides the FastTrack-style witness: production locks created
through :func:`make_lock` record, per thread, which named locks were
already held at every acquire, and the resulting edge set is compared to
the static graph by the test suite — an observed edge missing from the
static graph means the model (or the code) is wrong.

Design constraints:

- **Zero overhead when off.** ``make_lock`` returns a plain
  ``threading.Lock``/``RLock``/``Condition`` unless the witness is
  enabled (or a fault plan targets ``lock_contend``) at construction
  time, so steady-state code pays nothing — no ``settrace``, no proxy.
- **Witness mode.** Under :func:`enable`, locks constructed afterwards
  are tracked proxies: each acquire records (held -> acquired) edges
  against a thread-local held stack. Reentrant re-acquires of the same
  named lock record no edge (RLock semantics are not an ordering fact).
- **Chaos hook.** Every tracked acquire fires the ``lock_contend`` fault
  site with ``key=<name>`` *after* taking the inner lock, so a plan like
  ``lock_contend:delay=25@match=FleetManager`` widens the critical
  section of every FleetManager lock — turning a statically-suspected
  race window into a schedulable one.

Names follow the static graph's node grammar exactly: ``Class.attr``
(e.g. ``"FleetManager._lock"``), so the cross-check needs no mapping.
``Condition`` objects share their underlying tracked lock via the
``lock=`` kwarg and therefore alias to its node, matching the static
Condition-aliasing rule.
"""

from __future__ import annotations

import threading

_enabled = False
_edges: set = set()  # (held_name, acquired_name)
_acquired: dict = {}  # name -> acquisitions recorded under the witness
_edges_lock = threading.Lock()
_tls = threading.local()


def enable(reset: bool = True) -> None:
    """Track locks created from now on; optionally clear recorded edges."""
    global _enabled
    if reset:
        _clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def edges() -> set:
    """Snapshot of observed (held, acquired) edges."""
    with _edges_lock:
        return set(_edges)


def acquisitions() -> dict:
    """Snapshot of {lock name: acquisitions} under the witness: which
    locks a run exercised, nested or not (an edge needs two)."""
    with _edges_lock:
        return dict(_acquired)


def reset() -> None:
    _clear()


def _clear() -> None:
    with _edges_lock:
        _edges.clear()
        _acquired.clear()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class _TrackedLock:
    """Proxy over a threading lock that records acquire-order edges and
    fires the ``lock_contend`` fault site inside the critical section.
    Duck-typed to the Lock protocol so ``threading.Condition`` can wrap
    it (wait/notify go through acquire/release on this object)."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner) -> None:
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        stack = _held_stack()
        if _enabled and self._name not in stack:
            new = [(h, self._name) for h in stack if h != self._name]
            with _edges_lock:
                _edges.update(new)
                _acquired[self._name] = _acquired.get(self._name, 0) + 1
        stack.append(self._name)
        from ..faults import fault_point

        fault_point("lock_contend", key=self._name)
        return True

    def release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self._name:
                del stack[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def _should_track() -> bool:
    if _enabled:
        return True
    # a fault plan targeting lock_contend needs instrumented critical
    # sections even without the witness (chaos runs install the plan
    # before building the pipeline, i.e. before locks are constructed)
    from ..faults import active

    inj = active()
    return inj is not None and any(
        getattr(s, "site", None) == "lock_contend"
        for s in getattr(inj, "specs", ()))


def make_lock(name: str, kind: str = "lock", lock=None):
    """Construct a (possibly tracked) lock named after its static graph
    node. ``kind`` is ``"lock"`` | ``"rlock"`` | ``"cond"``; for a
    condition, pass the owning lock via ``lock=`` to share (and alias to)
    it, matching ``threading.Condition(self._lock)``."""
    if kind == "cond":
        return threading.Condition(
            lock if lock is not None else make_lock(name))
    inner = threading.RLock() if kind == "rlock" else threading.Lock()
    if _should_track():
        return _TrackedLock(name, inner)
    return inner
