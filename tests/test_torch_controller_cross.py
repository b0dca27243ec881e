"""The port's controller beside the JAX package's on the same jobs: SQL
jobs over two in-process workers joined by the data plane reach the smoke
goldens through the JAX controller's sequence of job states, and a
coordinated checkpoint completed by either package's controller restores
under the other's."""

from __future__ import annotations

import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.controller import ControllerServer, Database
from arroyo_tpu_torch.controller.scheduler import EmbeddedScheduler
from test_torch_controller import (assert_golden, port, record_states,  # noqa: F401
                                   smoke_sql, wait_until)


@pytest.mark.parametrize("name", ["grouped_aggregates", "select_star"])
def test_two_workers_reach_golden_with_jax_state_sequence(name, tmp_path, port, monkeypatch,
                                                          _storage):
    """controller.workers-per-job 2: both packages' controllers run the
    query over two embedded workers joined by the data plane, each to the
    golden, through the same sequence of job states; the coordinator
    records complete checkpoints."""
    import arroyo_tpu.controller.controller as jctl_mod
    import arroyo_tpu_torch.controller.controller as tctl_mod
    from arroyo_tpu import config as jcfg
    from arroyo_tpu.controller import ControllerServer as JController
    from arroyo_tpu.controller import Database as JDatabase
    from arroyo_tpu.controller.scheduler import EmbeddedScheduler as JEmbedded

    runs = {}
    for pkg, Ctl, Db, Sched, mod in (("jax", JController, JDatabase, JEmbedded, jctl_mod),
                                     ("port", ControllerServer, Database, EmbeddedScheduler,
                                      tctl_mod)):
        jcfg.update({"controller.workers-per-job": 2, "checkpoint.interval-ms": 100,
                     "testing.source-read-delay-micros": 1000})
        tcfg.update({"controller.workers-per-job": 2, "checkpoint.interval-ms": 100,
                     "testing.source-read-delay-micros": 1000})
        states = record_states(monkeypatch, mod)
        sql, out = smoke_sql(tmp_path, name, tag=pkg)
        db = Db()
        ctl = Ctl(db, Sched()).start()
        try:
            jid = db.create_job(db.create_pipeline(name, sql, 2))
            assert ctl.wait_for_state(jid, "Finished", timeout=120) == "Finished"
            assert_golden(out, name)
            assert int(db.get_job(jid)["n_workers"]) == 2
            complete = [c for c in db.list_checkpoints(jid) if c["state"] == "complete"]
            runs[pkg] = ([s for j, s in states if j == jid], complete)
        finally:
            ctl.stop()
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1], "the port's coordinator completed no checkpoint"


# ------------------------------------------------- cross-package restore


@pytest.mark.parametrize("first", ["jax", "port"])
def test_coordinated_checkpoint_restores_across_packages(first, tmp_path, port, _storage):
    """Two workers checkpoint and stop under one package's controller; the
    other package's controller, on the same database file and storage,
    restarts the job from that coordinated epoch and finishes it to the
    golden. The first run's sources hold at half their input
    (``testing.source-gate-epochs``) until the stop, so it cannot finish on
    its own however slow the machine."""
    from arroyo_tpu import config as jcfg
    from arroyo_tpu.controller import ControllerServer as JController
    from arroyo_tpu.controller import Database as JDatabase
    from arroyo_tpu.controller.scheduler import EmbeddedScheduler as JEmbedded

    url = str(tmp_path / "shared-ckpt")
    common = {"controller.workers-per-job": 2, "checkpoint.interval-ms": 150,
              "checkpoint.storage-url": url, "testing.source-gate-epochs": 10_000}
    jcfg.update({**common, "checkpoint.file-format": "parquet"})
    tcfg.update(common)
    path = str(tmp_path / "ctl.db")
    sql, out = smoke_sql(tmp_path)
    pkgs = {"jax": (JController, JDatabase, JEmbedded),
            "port": (ControllerServer, Database, EmbeddedScheduler)}
    second = "port" if first == "jax" else "jax"
    Ctl, Db, Sched = pkgs[first]
    db = Db(path)
    ctl = Ctl(db, Sched()).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 2))
        ctl.wait_for_state(jid, "Running", timeout=60)
        wait_until(lambda: any(c["state"] == "complete" for c in db.list_checkpoints(jid)),
                   60, "a complete checkpoint")
        db.update_job(jid, desired_stop="checkpoint")
        state = ctl.wait_for_state(jid, "Stopped", "Finished", "Failed", timeout=60)
        assert state == "Stopped", (state, db.get_job(jid))
        epochs = [c["epoch"] for c in db.list_checkpoints(jid) if c["state"] == "complete"]
        assert epochs, db.list_checkpoints(jid)
    finally:
        ctl.stop()
        db.close()
    jcfg.update({"testing.source-gate-epochs": 0})
    tcfg.update({"testing.source-gate-epochs": 0})
    Ctl, Db, Sched = pkgs[second]
    db = Db(path)
    db.update_job(jid, desired_stop=None, state="Restarting")
    ctl = Ctl(db, Sched()).start()
    try:
        state = ctl.wait_for_state(jid, "Finished", "Failed", timeout=120)
        assert state == "Finished", (state, db.get_job(jid))
        assert_golden(out)
    finally:
        ctl.stop()
        db.close()


# ------------------------------------------------ epoch traces and timing


def test_an_epoch_is_recorded_complete_only_after_its_trace(tmp_path, port):
    """A reader that finds an epoch complete in the controller's database
    (the `trace` CLI, the API) finds its trace there too: the port persists
    the trace first."""
    tcfg.update({"controller.workers-per-job": 2, "checkpoint.interval-ms": 100,
                 "testing.source-read-delay-micros": 1000})
    traced_first: list = []

    class Checking(Database):
        def record_checkpoint(self, job_id, epoch, state, **kw):
            if state == "complete":
                traced_first.append((epoch, bool(self.list_traces(job_id, epoch=epoch))))
            super().record_checkpoint(job_id, epoch, state, **kw)

    sql, out = smoke_sql(tmp_path)
    db = Checking()
    ctl = ControllerServer(db, EmbeddedScheduler()).start()
    try:
        jid = db.create_job(db.create_pipeline("agg", sql, 2))
        assert ctl.wait_for_state(jid, "Finished", timeout=120) == "Finished"
        assert_golden(out)
    finally:
        ctl.stop()
    assert traced_first and all(ok for _, ok in traced_first), traced_first


def test_chip_smoke_epoch_clock_times_every_complete_epoch(tmp_path, port):
    """chip_smoke's barrier-to-complete reading: under ``epoch_clock`` every
    epoch the coordinator recorded complete has a trigger before its
    durable marker, and a complete epoch without one fails the reading."""
    import chip_smoke

    tcfg.update({"controller.workers-per-job": 2, "checkpoint.interval-ms": 100,
                 "testing.source-read-delay-micros": 1000})
    sql, out = smoke_sql(tmp_path)
    db = Database()
    ctl = ControllerServer(db, EmbeddedScheduler()).start()
    try:
        with chip_smoke.epoch_clock() as clock:
            jid = db.create_job(db.create_pipeline("agg", sql, 2))
            assert ctl.wait_for_state(jid, "Finished", timeout=120) == "Finished"
    finally:
        ctl.stop()
    complete = [c["epoch"] for c in db.list_checkpoints(jid) if c["state"] == "complete"]
    ms = chip_smoke.epoch_durable_ms(clock, jid, complete)
    assert sorted(map(int, ms)) == sorted(complete) and all(v >= 0 for v in ms.values())
    with pytest.raises(AssertionError, match="no trigger"):
        chip_smoke.epoch_durable_ms(clock, jid, complete + [max(complete) + 1000])
