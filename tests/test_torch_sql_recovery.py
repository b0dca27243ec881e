"""The SQL-driven recovery tests of the JAX package, run through the port on
the CPU: tests/test_segment.py's crash-and-restore with compiled segments,
tests/test_mesh_fused.py's crash on the fused mesh path and its 4 -> 8
mesh resize, and tests/test_plan_diff.py's SQL surgery (a projected column
added, a no-op filter added) diffed by the port's ``diff_plans`` over
graphs the port planned, against the JAX package's verdicts."""

from __future__ import annotations

import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch.analysis import Severity
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.state.integrity import fsck_job
from arroyo_tpu_torch.state.tables import latest_complete_checkpoint
from test_plan_diff import add_noop_filter, add_projected_column
from test_smoke import assert_outputs
from test_torch_sql_plan import load_sql
from test_torch_sql_smoke_a import build, port  # noqa: F401

CHAOS_SEED = 1337


def crash_at_barrier_2(sql: str, parallelism: int, job_id: str) -> None:
    """Run until epoch 1 completes, then crash the first subtask to reach
    barrier 2 after its epoch-2 files landed: epoch 1 stays the latest
    complete one."""
    tcfg.update({"testing.source-gate-epochs": 2})
    inj = tfaults.install("worker:crash@barrier=2&step=1", seed=CHAOS_SEED)
    try:
        eng = build(sql, parallelism, job_id)
        eng.start()
        assert eng.checkpoint_and_wait(1, timeout=60), "epoch 1 incomplete"
        with pytest.raises(RuntimeError, match="injected"):
            if eng.checkpoint_and_wait(2, timeout=60):
                raise AssertionError("epoch 2 completed despite the crash")
            eng.join(timeout=60)
    finally:
        tfaults.clear()
        tcfg.update({"testing.source-gate-epochs": 0})
    assert inj.fired_log, "crash fault never fired"
    url = tcfg.config().get("checkpoint.storage-url")
    assert latest_complete_checkpoint(url, job_id) == 1


def assert_fsck_clean(job_id: str) -> None:
    url = tcfg.config().get("checkpoint.storage-url")
    errs = [d.render() for d in fsck_job(url, job_id) if d.severity == Severity.ERROR]
    assert not errs, errs


@pytest.mark.parametrize("name", ["tumbling_aggregates", "sliding_window"])
def test_chaos_crash_restore_compiled(name, tmp_path, port):  # noqa: F811
    """tests/test_segment.py's chaos axis: compiled segments (every batch
    through K4's plain version), a crash mid-epoch-2 at parallelism 2, a
    restore from epoch 1 to byte-exact goldens."""
    tcfg.update({"pipeline.chaining.enabled": True, "segment.compile.min-rows": 0})
    out = str(tmp_path / "out.json")
    sql = load_sql(name, out)
    job_id = f"{name}-seg-chaos"
    recorder.clear_job(job_id)
    crash_at_barrier_2(sql, 2, job_id)
    build(sql, 2, job_id, restore_epoch=1).run_to_completion(timeout=120)
    assert recorder.events(job_id, "SEGMENT_COMPILED"), "no compiled segment ran"
    assert not recorder.events(job_id, "SEGMENT_FALLBACK")
    assert_outputs(name, out)


@pytest.fixture
def fused(port):  # noqa: F811
    """tests/test_mesh_fused.py's _fused_cfg for the port: an 8-shard mesh
    on the one device, chaining on, the compile floor at 1 row, small
    batches so a run spans several micro-batches."""
    from arroyo_tpu_torch.engine.segment import reset_mesh_dispatch_counts
    from arroyo_tpu_torch.parallel.sharded_agg import reset_dispatch_counts

    tcfg.update({
        "device.mesh-devices": 8, "device.table-capacity": 2048,
        "device.batch-capacity": 512, "device.emit-capacity": 512,
        "device.spill-capacity": 512, "device.max-probes": 32,
        "segment.compile.min-rows": 1, "segment.compile.mesh-fuse": True,
        "pipeline.chaining.enabled": True, "pipeline.source-batch-size": 256,
        "engine.coalesce.max-rows": 256,
    })
    reset_mesh_dispatch_counts()
    reset_dispatch_counts()
    yield


# tumbling_aggregates casts its uint64 counter to float64 for avg(), which
# K4 takes (ROADMAP C4, closed): both families fuse in the port, as they do
# in the JAX package, and no segment falls back.
FUSES = {"sliding_window": True, "tumbling_aggregates": True}


def assert_fused_engaged(name: str, job_id: str) -> None:
    from arroyo_tpu_torch.engine.segment import mesh_dispatch_counts
    from arroyo_tpu_torch.parallel.sharded_agg import dispatch_counts

    seg, agg = mesh_dispatch_counts(), dispatch_counts()
    assert FUSES[name]
    assert not recorder.events(job_id, "SEGMENT_FALLBACK")
    assert seg["fused"] > 0, f"fused path never engaged: {seg} / {agg}"
    assert agg["fused_steps"] == seg["fused"], (seg, agg)


@pytest.mark.parametrize("name", ["tumbling_aggregates", "sliding_window"])
def test_mesh_fused_chaos_crash_mid_checkpoint(name, tmp_path, fused):
    """tests/test_mesh_fused.py's chaos point on the fused mesh path: crash
    after epoch-2 files land, restore from epoch 1, fused again, goldens
    byte-exact, the checkpoint chain fsck-clean."""
    out = str(tmp_path / "out.json")
    sql = load_sql(name, out)
    job_id = f"mesh-chaos-{name}"
    recorder.clear_job(job_id)
    crash_at_barrier_2(sql, 1, job_id)
    build(sql, 1, job_id, restore_epoch=1).run_to_completion(timeout=120)
    assert_fused_engaged(name, job_id)
    assert_outputs(name, out)
    assert_fsck_clean(job_id)


@pytest.mark.parametrize("name", ["tumbling_aggregates", "sliding_window"])
def test_mesh_resize_restore_4_to_8(name, tmp_path, fused):
    """Checkpoint on a 4-shard mesh, restore onto 8: the canonical snapshot
    re-shards, the output stays byte-exact (the JAX test's family, and
    sliding_window, which fuses in the port too)."""
    out = str(tmp_path / "out.json")
    sql = load_sql(name, out)
    job_id = f"mesh-resize-{name}"
    recorder.clear_job(job_id)
    tcfg.update({"device.mesh-devices": 4, "testing.source-gate-epochs": 2})
    try:
        eng = build(sql, 1, job_id)
        eng.start()
        assert eng.checkpoint_and_wait(1, timeout=60), "epoch 1 did not complete"
        eng.stop()
        eng.join(timeout=60)
    finally:
        tcfg.update({"testing.source-gate-epochs": 0})
    tcfg.update({"device.mesh-devices": 8})
    build(sql, 1, job_id, restore_epoch=1).run_to_completion(timeout=120)
    assert_fused_engaged(name, job_id)
    assert_outputs(name, out)
    assert_fsck_clean(job_id)


def _diff(pkg_plan, pkg_diff, old_sql, new_sql):
    d = pkg_diff(pkg_plan(old_sql).graph, pkg_plan(new_sql).graph)
    return (d.rejected, sorted((c.node_id, c.action, c.from_node) for c in d.classifications),
            sorted((x.rule_id, str(x.severity), x.site) for x in d.diagnostics), d.mapping)


@pytest.mark.parametrize("surgery", ["add_projected_column", "add_noop_filter"])
def test_sql_surgery_diffs_like_the_jax_package(surgery, tmp_path, port):  # noqa: F811
    from arroyo_tpu.analysis.plan_diff import diff_plans as jdiff
    from arroyo_tpu.sql import plan_query as jplan
    from arroyo_tpu_torch.analysis.plan_diff import diff_plans as tdiff
    from arroyo_tpu_torch.sql import plan_query as tplan

    out = str(tmp_path / "o.json")
    if surgery == "add_projected_column":
        old = load_sql("select_star", out)
        new = add_projected_column(old, out)
    else:
        old = load_sql("sliding_window", out)
        new = add_noop_filter(old)
    got = _diff(tplan, tdiff, old, new)
    assert got == _diff(jplan, jdiff, old, new)
    rejected, classes, diags, mapping = got
    assert not rejected
    actions = {a for _n, a, _f in classes}
    if surgery == "add_projected_column":
        rebuilt = [c for c in classes if c[1] == "rebuilt"]
        assert len(rebuilt) == 1 and rebuilt[0][0].startswith("sink")
        assert rebuilt[0][2] in mapping["dropped"]
        assert {r for r, _s, _site in diags} == {"AR011"}
    else:
        assert any("sliding_aggregate" in n for n, a, _f in classes if a == "carried")
        assert "incompatible" not in actions
