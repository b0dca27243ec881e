"""The port's concurrency auditor (analysis/concurrency_audit.py, LR401-
LR404) and its lock-order witness (obs/lockorder.py) against the JAX
package's on the CPU: every case of tests/test_concurrency_audit.py runs
through the port (``mirror``), each audited source going to both
packages' auditors, which must give the same rule ids, severities and
lines (``Differential``); the mirrored gate audits the port's own tree and
the witness cases run the port's inbox, send buffer and fleet.

Beyond the mirror: the port's locks are made through ``make_lock`` under
the JAX package's node names, and the witness's edges over a q7 run of the
CPU engine (inboxes) and over two workers joined by the data plane
(coalescing sends) are a subset of the static graph over
``arroyo_tpu_torch/``."""

from __future__ import annotations

import pytest

from test_torch_analysis import jax_cases, mirror, port_cfg, run_case  # noqa: F401

_CONC = None


def conc_mirror():
    global _CONC
    if _CONC is None:
        _CONC = mirror("test_concurrency_audit")
    return _CONC


@pytest.mark.parametrize("name", jax_cases("test_concurrency_audit"))
def test_concurrency_audit_case_through_the_port(name, monkeypatch, tmp_path,
                                                 port_cfg):  # noqa: F811
    diff = run_case(conc_mirror(), name, monkeypatch, tmp_path=tmp_path)
    if name.startswith(("test_lr4", "test_determinism", "test_sarif")):
        assert diff.calls > 0, "no source went through both packages"


# ------------------------------------------------ the port's witness sites


def test_port_locks_are_made_through_the_witness_under_the_jax_names():
    """With the witness on, the six lock sites the JAX package routes
    through make_lock are tracked proxies named as its static graph's
    nodes; with it off they are the plain threading primitives."""
    import threading
    from types import SimpleNamespace

    from arroyo_tpu_torch.controller.fleet import FleetManager
    from arroyo_tpu_torch.controller.node import NodeServer
    from arroyo_tpu_torch.engine.network import NetworkManager, _SendBuffer
    from arroyo_tpu_torch.engine.queues import TaskInbox
    from arroyo_tpu_torch.native import DataPlaneConn
    from arroyo_tpu_torch.obs import lockorder

    def owners():
        nm = NetworkManager()
        node = NodeServer("http://127.0.0.1:9", slots=1, port=0, host="127.0.0.1")
        inbox = TaskInbox(1, row_budget=64)
        try:
            return [
                ("TaskInbox._lock", inbox._lock),
                ("TaskInbox._lock", inbox._not_empty._lock),
                ("TaskInbox._lock", inbox._budget_freed._lock),
                ("_SendBuffer._lock", _SendBuffer(SimpleNamespace(fd=-1), 1 << 10)._lock),
                ("NetworkManager._out_lock", nm._out_lock),
                ("DataPlaneConn._send_lock", DataPlaneConn(-1)._send_lock),
                ("NodeServer._lock", node._lock),
                ("FleetManager._lock", FleetManager(None)._lock),
            ]
        finally:
            nm.close()
            node.httpd.server_close()

    lockorder.enable(reset=True)
    try:
        tracked = owners()
    finally:
        lockorder.disable()
        lockorder.reset()
    for name, lock in tracked:
        assert isinstance(lock, lockorder._TrackedLock) and lock._name == name, name
    plain = (type(threading.Lock()), type(threading.RLock()))
    for name, lock in owners():
        assert isinstance(lock, plain), (name, type(lock))
    # the condition variables share the inbox's one lock
    inbox = TaskInbox(1, row_budget=64)
    assert inbox._not_empty._lock is inbox._lock is inbox._budget_freed._lock


def test_witness_edges_of_q7_over_two_workers_lie_in_the_static_graph(port_cfg,  # noqa: F811
                                                                      tmp_path):
    """chip_smoke's analysis phase on the CPU: SQL q7 through the embedded
    controller over two engines joined by the data plane, the witness on
    from before the controller is built: exact against the oracle, every
    witness edge in the static graph over arroyo_tpu_torch/, and the
    inboxes' and the coalescing sends' locks taken."""
    import chip_smoke

    r = chip_smoke.witness_q7(20_000, str(tmp_path), "witness-q7", device="cpu")
    assert r["rows"] > 0
    assert ("_SendBuffer._lock", "DataPlaneConn._send_lock") in [tuple(e) for e in r["edges"]]
    assert set(chip_smoke.ANALYSIS_LOCKS) <= set(r["acquisitions"])


def test_q7_over_two_workers_is_exact_under_lock_contend(port_cfg, tmp_path):  # noqa: F811
    """The same q7 with every inbox lock's critical section widened by the
    lock_contend fault site: exact, and the delay fired."""
    import chip_smoke

    r = chip_smoke.witness_q7(20_000, str(tmp_path), "contend-q7",
                              plan=chip_smoke.CONTEND_PLAN, device="cpu")
    assert r["rows"] > 0 and r["fault_hits"] > 0
