"""Nexmark q7, q5 and q8 written as SQL (chip_smoke.py's texts) through both
packages on the CPU at a small event count: planned by each package's
``plan_query``, run chained with every batch through the compiled segment
(K4's plain version in the port), the port's sink lines equal the JAX
package's, sorted, byte for byte, and both equal chip_smoke's numpy
oracle (the oracle the sql phase holds the card's runs to)."""

from __future__ import annotations

import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu.engine.engine import Engine as JEngine
from arroyo_tpu.sql import plan_query as jplan
from arroyo_tpu_torch.engine.engine import Engine as TEngine
from arroyo_tpu_torch.obs.events import recorder
from arroyo_tpu_torch.sql import plan_query as tplan

# q7 and q5 at 1000 us between events, q8 at 100 us: two windows of each
EVENTS = {"q7": 24_000, "q5": 24_000, "q8": 240_000}
RUN = {"pipeline.chaining.enabled": True, "segment.compile.min-rows": 0,
       "pipeline.source-batch-size": 4096, "engine.coalesce.enabled": False}


@pytest.fixture
def configs(tmp_path):
    arroyo_tpu._load_operators()
    tcfg.reset()
    tcfg.update({"checkpoint.storage-url": str(tmp_path / "port-ckpt"), **RUN})
    jcfg.update(RUN)
    yield
    tcfg.reset()
    jcfg.update({"pipeline.chaining.enabled": False, "segment.compile.min-rows": 8192,
                 "pipeline.source-batch-size": 512, "engine.coalesce.enabled": True})


@pytest.mark.parametrize("name", ["q7", "q5", "q8"])
def test_nexmark_sql_rows_equal_jax_and_the_oracle(name, tmp_path, configs):
    events = EVENTS[name]
    tout, jout = tmp_path / "port.json", tmp_path / "jax.json"
    job = f"sql-{name}"
    recorder.clear_job(job)
    TEngine(tplan(chip_smoke.nexmark_sql(name, events, str(tout))).graph, job_id=job,
            device="cpu").run_to_completion(timeout=120)
    JEngine(jplan(chip_smoke.nexmark_sql(name, events, str(jout))).graph,
            job_id=f"{job}-jax").run_to_completion(timeout=120)
    got = sorted(tout.read_text().splitlines())
    assert got == sorted(jout.read_text().splitlines())
    assert chip_smoke.check_sql_rows(name, got, chip_smoke.oracle_sql(name, events)) > 0
    assert recorder.events(job, "SEGMENT_COMPILED")
    assert not recorder.events(job, "SEGMENT_FALLBACK")
