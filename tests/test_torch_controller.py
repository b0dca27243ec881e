"""The port's control plane held to the JAX package's: the job state
machine pair by pair, the controller's database read across the packages,
and every case of tests/test_controller.py run through the port
(``port_mirror``: the JAX test's source with the package renamed, its
assertions unchanged). The helpers here (the ``port`` fixture, the mirror,
the smoke goldens) serve the other control-plane test files."""

from __future__ import annotations

import glob
import json
import os
import re
import time

import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch.controller import Database, JobState
from arroyo_tpu_torch.state import storage as tstorage

SMOKE = os.path.join(os.path.dirname(__file__), "smoke")


@pytest.fixture
def port(tmp_path, monkeypatch):
    """The port's config from its own environment variables (so worker
    subprocesses read the same): the CPU, storage under tmp_path; faults and
    the storage breaker cleared around the test."""
    url = str(tmp_path / "port-ckpt")
    monkeypatch.setenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ARROYO_TPU_TORCH__CHECKPOINT__STORAGE_URL", url)
    monkeypatch.setenv("ARROYO_TPU_TORCH__STORAGE__RETRY__BASE_DELAY_MS", "10")
    # worker and CLI subprocesses: one torch thread each on this shared CPU
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tcfg.reset()
    tfaults.clear()
    yield url
    tfaults.clear()
    tstorage.reset_retry_state()
    tcfg.reset()


def port_mirror(module: str, subs: dict = None):
    """tests/<module>.py with every ``arroyo_tpu`` import and
    ``ARROYO_TPU__`` variable renamed to the port's (and ``subs``'s
    replacements made, such as a helper imported from another JAX test
    swapped for the port's): its scenarios run through the port with their
    assertions unchanged, so the port must decide what the JAX package
    decides."""
    import types

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{module}.py")
    with open(path) as f:
        src = re.sub(r"\barroyo_tpu\b", "arroyo_tpu_torch", f.read())
    src = src.replace("ARROYO_TPU__", "ARROYO_TPU_TORCH__")
    for old, new in (subs or {}).items():
        assert old in src, old
        src = src.replace(old, new)
    mod = types.ModuleType(f"port_mirror_{module}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102 - the repo's own test source
    return mod


def run_mirrored(mod, test: str, /, **fixtures) -> None:
    """Call the mirrored ``test`` with the fixtures and parameters it names
    (the port's storage URL standing for ``_storage``)."""
    import inspect

    fn = getattr(mod, test)
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


def smoke_sql(tmp_path, name: str = "grouped_aggregates", tag: str = "out"):
    with open(os.path.join(SMOKE, "queries", f"{name}.sql")) as f:
        sql = f.read()
    out = str(tmp_path / f"{tag}.json")
    return sql.replace("$input_dir", os.path.join(SMOKE, "inputs")).replace(
        "$output_path", out), out


def sink_rows(out: str) -> list:
    """The single_file sink's rows: ``out`` and its subtasks' ``out.<i>``."""
    got = []
    for p in sorted(glob.glob(out) + glob.glob(out + ".*")):
        with open(p) as f:
            got.extend(json.loads(line) for line in f if line.strip())
    return got


def assert_golden(out: str, name: str = "grouped_aggregates") -> None:
    with open(os.path.join(SMOKE, "golden", f"{name}.json")) as f:
        want = [json.loads(line) for line in f if line.strip()]
    key = lambda r: json.dumps(r, sort_keys=True)
    assert sorted(map(key, sink_rows(out))) == sorted(map(key, want))


def record_states(monkeypatch, controller_mod) -> list:
    """Every (job, state) the package's JobController sets, in order."""
    seen: list = []
    orig = controller_mod.JobController._set_state

    def _set_state(self, nxt, **fields):
        orig(self, nxt, **fields)
        seen.append((self.job_id, nxt.value))

    monkeypatch.setattr(controller_mod.JobController, "_set_state", _set_state)
    return seen


def wait_until(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ------------------------------------------------------------ state machine


@pytest.mark.parametrize("src", [s.value for s in JobState])
def test_transition_table_equals_jax(src):
    from arroyo_tpu.controller import states as jstates
    from arroyo_tpu_torch.controller import states as tstates

    assert [s.value for s in tstates.JobState] == [s.value for s in jstates.JobState]
    for dst in tstates.JobState:
        ok_t = ok_j = True
        try:
            tstates.check_transition(tstates.JobState(src), dst)
        except tstates.IllegalTransition:
            ok_t = False
        try:
            jstates.check_transition(jstates.JobState(src), jstates.JobState(dst.value))
        except jstates.IllegalTransition:
            ok_j = False
        assert ok_t == ok_j, (src, dst.value)


# ---------------------------------------------------------------- database


def fill_db(db, tmp_path) -> None:
    sql, _ = smoke_sql(tmp_path)
    pid = db.create_pipeline("agg", sql, 2)
    jid = db.create_job(pid, tenant="team-1")
    db.update_job(jid, state="Running", restarts=2, n_workers=2)
    db.record_checkpoint(jid, 1, "complete")
    db.record_checkpoint(jid, 2, "failed")
    db.record_trace(jid, 1, [{"event": "trigger", "t_us": 5, "node": None, "subtask": None,
                              "worker": None, "epoch": 1}])
    db.record_metrics(jid, {"src": {"rows_out": 3, "per_subtask": {"0": {"rows_out": 3}}}})
    db.record_events(jid, [{"seq": 1, "ts_us": 7, "level": "WARN", "code": "X",
                            "message": "m", "node": "src", "subtask": 0, "epoch": 1,
                            "data": {"k": 1}}])
    db.record_health(jid, "healthy", {"rules": []})
    db.record_profile(jid, {"src": {"self_time": {"0": 1.0}}})
    db.record_output(jid, ["{\"a\": 1}"])
    db.create_udf("f", "python", "def f(x): return x", ["int64"], "int64", None)
    cp = db.create_connection_profile("p", "kafka", {"bootstrap": "x"})
    db.create_connection_table("t", "impulse", "source", {"event_rate": 1},
                               [{"name": "a", "type": "BIGINT"}], cp)
    db.register_node("n1", "http://127.0.0.1:1", 4)
    db.record_fleet_state({"pool": 2})


def db_view(db) -> dict:
    strip = lambda rows: [{k: v for k, v in r.items() if k not in ("created_at", "updated_at",
                                                                  "last_heartbeat")}
                          for r in rows]
    jobs = db.list_jobs()
    jid = jobs[0]["id"]
    return {"pipelines": strip(db.list_pipelines()), "jobs": strip(jobs),
            "checkpoints": strip(db.list_checkpoints(jid)), "traces": db.list_traces(jid),
            "metrics": db.get_metrics(jid), "events": db.list_events(jid),
            "health": strip([db.get_health(jid) or {}]), "profile": db.get_profile(jid),
            "outputs": strip(db.list_outputs(jid)), "udfs": strip(db.list_udfs()),
            "profiles": strip(db.list_connection_profiles()),
            "tables": strip(db.list_connection_tables()), "nodes": strip(db.list_nodes()),
            "fleet": db.get_fleet_state(), "queue_position": db.fleet_queue_position(jid)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_file_reads_the_same_in_both_packages(writer, tmp_path, port):
    from arroyo_tpu.controller.db import Database as JDatabase

    path = str(tmp_path / "ctl.db")
    W, R = (JDatabase, Database) if writer == "jax" else (Database, JDatabase)
    w = W(path)
    fill_db(w, tmp_path)
    want = db_view(w)
    w.close()
    r = R(path)
    assert db_view(r) == want
    r.close()


# ------------------------------------------------------- embedded scheduler


CONTROLLER = port_mirror("test_controller")
CONTROLLER_CASES = sorted(n for n in dir(CONTROLLER) if n.startswith("test_"))


def test_every_controller_case_is_mirrored():
    assert len(CONTROLLER_CASES) == 12, CONTROLLER_CASES


@pytest.mark.parametrize("name", CONTROLLER_CASES)
def test_controller_case_through_the_port(name, tmp_path, port):
    """tests/test_controller.py's cases through the port's controller:
    the state machine, embedded runs to the golden, stop with a checkpoint
    and restart, process-scheduler crash recovery, live and multi-worker
    rescale, the stuck-checkpoint watchdog, a hung worker's heartbeat,
    checkpoint GC, the two-worker process set and the REST lifecycle."""
    run_mirrored(CONTROLLER, name, tmp_path=tmp_path, _storage=port)
