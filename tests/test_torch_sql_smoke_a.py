"""The smoke families through the port (arroyo_tpu_torch.sql planning, the
port's engine, its operators and connectors) on the CPU, chained and
unchained, in tests/test_smoke.py's three runs, against the goldens of
``tests/smoke/golden/`` (compared as test_smoke compares them):

  (a) parallelism 1, run to completion;
  (b) parallelism 2 with checkpoints 1-3 (compaction after 2), stopped at
      3, the sources held mid-file by ``testing.source-gate-epochs``;
  (c) a restore from epoch 3, compacted and its older epochs removed, at
      parallelism 3, run to completion.

And at parallelism 1 the port's output lines equal the JAX package's,
sorted and unrounded (both run with ``engine.coalesce.enabled`` off, so a
batch's rows do not depend on timing).

The 40 families are split over this file and test_torch_sql_smoke_b.py.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu_torch import faults as tfaults
from test_smoke import assert_outputs
from test_torch_sql_plan import QUERIES, load_sql, register_port_fixtures

RUNNABLE = list(QUERIES)
HALF = len(RUNNABLE) // 2
CHAINING = pytest.mark.parametrize("chaining", [False, True], ids=["unchained", "chained"])

# the device caps tests/conftest.py gives the JAX package, for the port
SMALL_DEVICE = {"device.table-capacity": 8192, "device.batch-capacity": 1024,
                "device.emit-capacity": 1024, "device.max-probes": 32}


@pytest.fixture
def port(tmp_path):
    """The port's configuration for one test: storage under tmp_path, the
    JAX package's test caps, no faults; reset after."""
    arroyo_tpu._load_operators()
    register_port_fixtures()
    tcfg.reset()
    tfaults.clear()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "port-checkpoints"),
                 "storage.retry.base-delay-ms": 10, **SMALL_DEVICE})
    yield
    tfaults.clear()
    tcfg.reset()


def build(sql: str, parallelism: int, job_id: str, restore_epoch=None):
    from arroyo_tpu_torch.engine.engine import Engine
    from arroyo_tpu_torch.sql import plan_query
    from arroyo_tpu_torch.sql.planner import set_parallelism

    pp = plan_query(sql)
    if parallelism > 1:
        set_parallelism(pp.graph, parallelism)
    return Engine(pp.graph, job_id=job_id, device="cpu", restore_epoch=restore_epoch)


def three_runs(name: str, chaining: bool, tmp_path) -> None:
    """tests/test_smoke.py test_smoke's three runs, through the port."""
    tcfg.update({"pipeline.chaining.enabled": chaining})
    out1 = str(tmp_path / "out1.json")
    build(load_sql(name, out1), 1, f"{name}-p1").run_to_completion(timeout=120)
    assert_outputs(name, out1)

    out2 = str(tmp_path / "out2.json")
    sql2 = load_sql(name, out2)
    tcfg.update({"testing.source-gate-epochs": 3})
    try:
        eng2 = build(sql2, 2, f"{name}-ckpt")
        eng2.start()
        for epoch in (1, 2):
            assert eng2.checkpoint_and_wait(epoch, timeout=60), (
                f"checkpoint epoch {epoch} did not complete mid-stream")
            if epoch == 2:
                eng2.compact(2)
        assert eng2.checkpoint_and_wait(3, timeout=60, then_stop=True), (
            "checkpoint epoch 3 (stopping) did not complete mid-stream")
        eng2.join(timeout=120)
    finally:
        tcfg.update({"testing.source-gate-epochs": 0})

    eng2.compact(3)
    eng2.cleanup(min_epoch=3)
    build(sql2, 3, f"{name}-ckpt", restore_epoch=3).run_to_completion(timeout=120)
    assert_outputs(name, out2)


# families whose updating join reads two inputs: which side's rows arrive
# first depends on thread timing in either package (the JAX package alone
# gives 125 or 145 lines for updating_left_join over runs), so an outer row
# may be null-padded and then retracted in one run and matched at once in
# another; their lines are compared with such pairs taken out
TWO_INPUT_JOINS = {"null_comparisons", "updating_full_join", "updating_inner_join",
                   "updating_inner_join_with_updating", "updating_left_join",
                   "updating_right_join"}


def standing_lines(lines: list) -> list:
    """A debezium stream's lines, sorted, less each delete and one create
    of the row it deletes (a row created, then retracted): the lines of
    the rows left standing, byte for byte. A delete with no create before
    it stays."""
    envs = [json.loads(line) for line in lines]
    key = lambda row: json.dumps(row, sort_keys=True)  # noqa: E731
    open_: dict = {}
    gone = set()
    for i, env in enumerate(envs):
        if env["op"] == "c":
            open_.setdefault(key(env["after"]), []).append(i)
        elif env["op"] == "d" and open_.get(key(env["before"])):
            gone.update((open_[key(env["before"])].pop(), i))
    return sorted(line for i, line in enumerate(lines) if i not in gone)


def same_lines_as_jax(name: str, chaining: bool, tmp_path) -> None:
    """Parallelism 1 in both packages, coalescing off: the port's output
    lines equal the JAX package's, sorted, byte for byte (a two-input
    updating join's less its created-then-retracted pairs)."""
    from arroyo_tpu.engine.engine import Engine as JEngine
    from arroyo_tpu.sql import plan_query as jplan

    over = {"pipeline.chaining.enabled": chaining, "engine.coalesce.enabled": False}
    tcfg.update(over)
    jcfg.update(over)
    try:
        tout, jout = tmp_path / "port.json", tmp_path / "jax.json"
        build(load_sql(name, str(tout)), 1, f"{name}-port").run_to_completion(timeout=120)
        JEngine(jplan(load_sql(name, str(jout))).graph,
                job_id=f"{name}-jax").run_to_completion(timeout=120)
        got = sorted(tout.read_text().splitlines())
        want = sorted(jout.read_text().splitlines())
        if name in TWO_INPUT_JOINS:
            got = standing_lines(tout.read_text().splitlines())
            want = standing_lines(jout.read_text().splitlines())
        assert got == want, (f"{name}: {len(got)} lines vs {len(want)}; port only "
                             f"{[x for x in got if x not in want][:3]}, JAX only "
                             f"{[x for x in want if x not in got][:3]}")
    finally:
        jcfg.update({"pipeline.chaining.enabled": False, "engine.coalesce.enabled": True})


@CHAINING
@pytest.mark.parametrize("name", RUNNABLE[:HALF])
def test_smoke_family_three_runs(name, chaining, tmp_path, port):
    three_runs(name, chaining, tmp_path)


@CHAINING
@pytest.mark.parametrize("name", RUNNABLE[:HALF])
def test_smoke_family_lines_equal_jax(name, chaining, tmp_path, port):
    same_lines_as_jax(name, chaining, tmp_path)


def test_family_split():
    """Every smoke family runs through the port: none is refused."""
    assert len(RUNNABLE) == 40 and not hasattr(chip_smoke, "SMOKE_REFUSED")
    assert len(RUNNABLE[:HALF]) + len(RUNNABLE[HALF:]) == len(QUERIES)


def test_chip_smoke_updating_set_is_generates():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "smoke"))
    try:
        from generate import UPDATING
    finally:
        sys.path.pop(0)
    assert chip_smoke.SMOKE_UPDATING == UPDATING


@pytest.mark.parametrize("name", QUERIES)
def test_chip_smoke_check_agrees_with_assert_outputs(name, tmp_path):
    """chip_smoke.py's own copy of the golden compare takes what
    tests/test_smoke.py's ``assert_outputs`` takes and refuses what it
    refuses: the golden itself, then (updating families) as debezium
    envelopes with an extra row created and retracted, then with a row
    missing and one changed."""
    golden = os.path.join(chip_smoke.SMOKE_DIR, "golden", f"{name}.json")
    with open(golden) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    cases = [(rows, True)]
    if name in chip_smoke.SMOKE_UPDATING:
        extra = {"__extra": 1}
        cases.append(([{"op": "c", "after": extra}]
                      + [{"op": "c", "after": r} for r in rows]
                      + [{"op": "d", "before": extra}], True))
    if rows:
        cases.append((rows[:-1] + [{**rows[0], "__changed": 1}], False))
    for i, (lines, ok) in enumerate(cases):
        out = tmp_path / f"out{i}.json"
        out.write_text("".join(json.dumps(r) + "\n" for r in lines))
        verdicts = []
        for check in (chip_smoke.smoke_check, assert_outputs):
            try:
                check(name, str(out))
                verdicts.append(True)
            except AssertionError:
                verdicts.append(False)
        assert verdicts == [ok, ok], (name, i)
