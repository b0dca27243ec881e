"""Nexmark q3 written as SQL (chip_smoke.py's text: an updating inner join
of two subqueries over the nexmark source, debezium sink) through both
packages on the CPU at 20,000 events: the same plan, the port's sink lines
equal the JAX package's, sorted, byte for byte, and both equal chip_smoke's
numpy oracle (the one the updating phase holds the card's runs to). With
spilling on and a budget of a few KiB, the port's join spills side-store
rows and its lines stay the same; a crash after a checkpoint and a restore
from it give the oracle's rows."""

from __future__ import annotations

import os

import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu.engine.engine import Engine as JEngine
from arroyo_tpu.sql import plan_query as jplan
from arroyo_tpu_torch import faults as tfaults
from arroyo_tpu_torch.engine.engine import Engine as TEngine
from arroyo_tpu_torch.state import spill as tspill
from arroyo_tpu_torch.sql import plan_query as tplan

EVENTS = 20_000
RUN = {"pipeline.chaining.enabled": True, "pipeline.source-batch-size": 2048,
       "engine.coalesce.enabled": False, "checkpoint.file-format": "npz"}


@pytest.fixture
def configs(tmp_path):
    arroyo_tpu._load_operators()
    tcfg.reset()
    tfaults.clear()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "port-ckpt"), **RUN})
    jcfg.update({"checkpoint.storage-url": str(tmp_path / "jax-ckpt"), **RUN})
    yield
    tfaults.clear()
    tcfg.reset()
    jcfg.reset()


def test_q3_plans_alike_and_lines_equal_jax_and_the_oracle(tmp_path, configs):
    tout, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tg = tplan(chip_smoke.nexmark_q3_sql(EVENTS, tout)).graph
    jg = jplan(chip_smoke.nexmark_q3_sql(EVENTS, tout)).graph
    assert tg.to_json() == jg.to_json()
    ops = sorted(n.op.value for n in tg.nodes.values())
    assert "join_with_expiration" in ops
    TEngine(tg, job_id="q3-port", device="cpu").run_to_completion(timeout=120)
    JEngine(jplan(chip_smoke.nexmark_q3_sql(EVENTS, jout)).graph,
            job_id="q3-jax").run_to_completion(timeout=120)
    got = sorted(chip_smoke.q3_lines(tout))
    assert got == sorted(chip_smoke.q3_lines(jout))
    want = chip_smoke.oracle_q3(EVENTS)
    assert chip_smoke.check_q3_lines(got, want) == sum(want.values()) > 100


def test_q3_spilled_lines_equal_the_resident_ones(tmp_path, configs, monkeypatch):
    tcfg.update({"state.spill.enabled": True, "state.spill.budget-bytes": 4096})
    monkeypatch.setattr(tspill, "TARGET_FILE_BYTES", 4096)
    out = str(tmp_path / "spill.json")
    eng = TEngine(tplan(chip_smoke.nexmark_q3_sql(EVENTS, out)).graph, job_id="q3-spill",
                  device="cpu")
    eng.run_to_completion(timeout=120)
    _node, op = chip_smoke.q3_join(eng)
    stats = chip_smoke.q3_spill_stats(op)
    assert stats["runs_written"] > 0 and stats["probes"] > 0
    want = chip_smoke.oracle_q3(EVENTS)
    assert chip_smoke.check_q3_lines(chip_smoke.q3_lines(out), want) == sum(want.values())


def test_q3_crash_and_restore_with_spilled_runs(tmp_path, configs, monkeypatch):
    """The updating phase's third run at this size: epoch 1 with spilled
    runs in its manifests, a crash at epoch 2's barrier in the join, a
    restore from epoch 1 to the oracle's rows."""
    tcfg.update({"state.spill.enabled": True, "state.spill.budget-bytes": 4096,
                 "testing.source-gate-epochs": 0})
    monkeypatch.setattr(tspill, "TARGET_FILE_BYTES", 4096)
    root = str(tmp_path / "q3")
    os.makedirs(root)
    res = chip_smoke.q3_crash_restore(root, chip_smoke.oracle_q3(EVENTS), EVENTS,
                                      RUN["pipeline.source-batch-size"],
                                      lambda g, **kw: TEngine(g, device="cpu", **kw))
    assert res["epoch1_manifest_runs"] > 0 and res["rows"] > 100
