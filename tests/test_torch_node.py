"""The port's node daemon (controller/node.py) and node scheduler over
tests/test_node.py's three cases (register and a job's lifecycle with a
checkpoint across the node's HTTP hop, lazy placement without a live node,
the slot reservation released on a failed spawn), each run through the port
with the JAX test's assertions; then what the port adds around them: a
node's worker without a device setting failing its job naming CUDA, slots as
a hard limit shown by the fleet's live capacity, a capacity-starved
placement re-queued rather than failed, and the `node` subcommand."""

from __future__ import annotations

import os
import signal
import subprocess
import sys

import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_controller import (assert_golden, port, port_mirror,  # noqa: F401
                                   run_mirrored, smoke_sql, wait_until)

MOD = port_mirror("test_node")
CASES = sorted(n for n in dir(MOD) if n.startswith("test_"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_case_is_mirrored():
    assert len(CASES) == 3, CASES


@pytest.mark.parametrize("name", CASES)
def test_node_case_through_the_port(name, tmp_path, port):
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)


@pytest.fixture
def cluster(port):
    from arroyo_tpu_torch.api import ApiServer
    from arroyo_tpu_torch.controller import Database

    db = Database()
    api = ApiServer(db).start()
    yield db, f"http://127.0.0.1:{api.port}"
    api.stop()


def test_node_worker_without_a_device_setting_fails_naming_cuda(tmp_path, cluster,
                                                                monkeypatch):
    """A worker the node spawns with no device setting takes cuda, as the
    process scheduler's do: without CUDA the job fails with the device's
    error and nothing runs on the host."""
    from arroyo_tpu_torch.controller import ControllerServer
    from arroyo_tpu_torch.controller.node import NodeServer
    from arroyo_tpu_torch.controller.scheduler import NodeScheduler

    db, base = cluster
    monkeypatch.delenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE")
    monkeypatch.setenv("ARROYO_TPU_TORCH__PIPELINE__ALLOWED_RESTARTS", "0")
    tcfg.reset()
    sql, out = smoke_sql(tmp_path)
    node = NodeServer(base, slots=2).start()
    ctl = ControllerServer(db, NodeScheduler(db)).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 2))
        assert ctl.wait_for_state(jid, "Finished", "Failed", timeout=120) == "Failed"
        msg = db.get_job(jid)["failure_message"] or ""
        assert "CUDA is not available" in msg, msg
        assert not os.path.exists(out)
    finally:
        ctl.stop()
        node.stop()


def test_fleet_capacity_is_the_live_node_slots_and_slots_are_a_hard_limit(cluster):
    """With fleet.slots 0 the node scheduler's pool is the registered
    daemons' live slots; a daemon answers 409 past its slots, and the
    scheduler reads that as capacity (a re-queue), not a failure."""
    import urllib.error

    from arroyo_tpu_torch.controller.fleet import FleetManager
    from arroyo_tpu_torch.controller.node import NodeServer, _post
    from arroyo_tpu_torch.controller.scheduler import NodeScheduler

    db, base = cluster
    sched = NodeScheduler(db)
    fleet = FleetManager(sched)
    assert fleet.pool_slots() is None  # no daemon yet
    nodes = [NodeServer(base, slots=s).start() for s in (2, 3)]
    try:
        fleet.tick(db)
        wait_until(lambda: fleet.pool_slots() == 5, 10, "the node probe")
        nodes[0]._workers["pending-a"] = nodes[0]._workers["pending-b"] = None
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{nodes[0].addr}/start_worker", {"job_id": "j", "sql": "x"})
        assert e.value.code == 409
        nodes[1]._workers.update({f"p{i}": None for i in range(3)})
        h, why = sched._place_once(("x", "j", 1, None, None, None, None), "")
        assert h is None and NodeScheduler._capacity_reason(why), why
    finally:
        for n in nodes:
            n._workers.clear()
            n.stop()


def test_capacity_starved_placement_requeues_the_job(tmp_path, cluster):
    """A deferred placement that times out on capacity (no live daemon)
    sends its job back to the fleet's queue, not to Failed; a daemon that
    registers later runs it to the golden."""
    from arroyo_tpu_torch.controller import ControllerServer
    from arroyo_tpu_torch.controller import scheduler as sched_mod
    from arroyo_tpu_torch.controller.node import NodeServer

    db, base = cluster

    class ShortPlacement(sched_mod.NodeScheduler):
        def start_workers(self, *a, **kw):
            kw["placement_timeout_s"] = 0.3
            return super().start_workers(*a, **kw)

    sql, out = smoke_sql(tmp_path)
    ctl = ControllerServer(db, ShortPlacement(db)).start()
    node = None
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 1))
        wait_until(lambda: db.get_job(jid)["state"] == "Queued", 30, "the re-queue")
        assert db.get_job(jid)["state"] != "Failed"
        node = NodeServer(base, slots=2).start()
        assert ctl.wait_for_state(jid, "Finished", "Failed", timeout=120) == "Finished"
        assert_golden(out)
    finally:
        ctl.stop()
        if node is not None:
            node.stop()


def test_node_subcommand_registers_and_stops_its_workers(cluster):
    """`python -m arroyo_tpu_torch node` registers with the cluster API
    (visible at /api/v1/nodes) and exits on SIGINT."""
    from arroyo_tpu_torch.controller.node import _get

    db, base = cluster
    env = dict(os.environ)
    proc = subprocess.Popen([sys.executable, "-m", "arroyo_tpu_torch", "node",
                             "--controller", base, "--slots", "3", "--host", "127.0.0.1"],
                            cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith("node node_") and f"-> {base}" in line, line
        nodes = wait_until(lambda: _get(f"{base}/api/v1/nodes")["nodes"], 30, "registration")
        assert nodes[0]["slots"] == 3 and line.split()[1] == nodes[0]["id"]
        port_ = int(line.split(":")[1].split()[0])
        st = _get(f"http://127.0.0.1:{port_}/status")
        assert st == {"node_id": nodes[0]["id"], "slots": 3, "used": 0}
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
