"""The port's process scheduler and CLI beyond tests/test_controller.py's
cases (tests/test_torch_controller.py runs those): a worker with no device
setting failing its job on a machine without CUDA instead of running on the
host, the stderr drain (a departure by design), and the CLI's `run`."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.controller import ControllerServer, Database
from arroyo_tpu_torch.controller.scheduler import ProcessScheduler
from test_torch_controller import assert_golden, port, smoke_sql, wait_until  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("workers", [1, 2])
def test_worker_without_a_device_setting_fails_the_job_naming_cuda(workers, tmp_path, port,
                                                                    monkeypatch):
    """A worker process started with no device setting takes cuda; without
    CUDA its job goes to Failed with resolve_device's error, and nothing
    runs on the host."""
    monkeypatch.delenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE")
    monkeypatch.setenv("ARROYO_TPU_TORCH__PIPELINE__ALLOWED_RESTARTS", "0")
    tcfg.reset()
    tcfg.update({"controller.workers-per-job": workers})
    sql, out = smoke_sql(tmp_path)
    db = Database()
    ctl = ControllerServer(db, ProcessScheduler()).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 2))
        assert ctl.wait_for_state(jid, "Finished", "Failed", timeout=120) == "Failed"
        msg = db.get_job(jid)["failure_message"] or ""
        assert "CUDA is not available" in msg, msg
        assert not os.path.exists(out)
    finally:
        ctl.stop()


def test_worker_stderr_is_drained_while_it_runs(tmp_path, port):
    """A worker that writes far more than a pipe buffer to stderr keeps
    running (the port drains stderr in a thread, keeping its last 2,000
    characters; the JAX package reads it only at exit, so such a worker
    would block on the write); a failing worker's event still carries the
    tail."""
    from arroyo_tpu_torch.controller.scheduler import ProcessWorkerHandle

    noisy = ("import sys\n"
             "for _ in range(64):\n"
             "    sys.stderr.write('w' * 4096 + '\\n')\n"
             "sys.stderr.flush()\n")
    sql, out = smoke_sql(tmp_path)
    db = Database()
    db.create_udf("noisy", "python", noisy, [], "int64", None)
    ctl = ControllerServer(db, ProcessScheduler()).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 1))
        assert ctl.wait_for_state(jid, "Finished", "Failed", timeout=60) == "Finished"
        assert_golden(out)
    finally:
        ctl.stop()
    bad = ProcessWorkerHandle("SELEC nope", "bad-job", 1, None)
    evs = wait_until(lambda: [e for e in bad.poll_events() if e["event"] == "failed"], 60,
                     "the failed event")
    assert evs[0]["error"].startswith("worker exited 1: ")
    assert 0 < len(evs[0]["error"]) <= len("worker exited 1: ") + 2000
    bad.kill()


def run_cli(args: list, env_extra: dict, timeout: float = 180):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ARROYO_TPU_TORCH__")}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "arroyo_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_run_at_parallelism_two_gives_the_golden(tmp_path, port):
    sql, out = smoke_sql(tmp_path)
    path = tmp_path / "pipeline.sql"
    path.write_text(sql)
    proc = run_cli(["run", str(path), "--parallelism", "2", "--timeout", "120"],
                   {"ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE": "cpu",
                    "ARROYO_TPU_TORCH__CHECKPOINT__STORAGE_URL": port})
    assert proc.returncode == 0, proc.stderr
    assert "Finished" in proc.stderr
    assert_golden(out)


def test_cli_run_without_cuda_exits_one(tmp_path, port):
    """No device setting: the card. Without CUDA the job fails and `run`
    exits 1, as the JAX package's `run` does for a failed job."""
    sql, out = smoke_sql(tmp_path)
    path = tmp_path / "pipeline.sql"
    path.write_text(sql)
    t0 = time.monotonic()
    proc = run_cli(["run", str(path), "--timeout", "120"],
                   {"ARROYO_TPU_TORCH__CHECKPOINT__STORAGE_URL": port,
                    "ARROYO_TPU_TORCH__PIPELINE__ALLOWED_RESTARTS": "0"})
    assert proc.returncode == 1, proc.stderr
    assert "Failed" in proc.stderr and time.monotonic() - t0 < 120
    assert not os.path.exists(out)
