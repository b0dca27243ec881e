"""What the port's SQL path still refuses, each with the ROADMAP item that
lifts it: the 10 smoke families whose plans hold an operator the port has
not ported (async UDF, window functions, UNNEST, the updating join) are
planned exactly as the JAX package plans them (test_torch_sql_plan.py) and
refused when the engine builds them (ROADMAP A.5), as is the updating
aggregate's spill annex; the formats other than JSON are refused by name
(ROADMAP A.9)."""

from __future__ import annotations

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.batch import Batch, Schema
from arroyo_tpu_torch.formats import make_deserializer, serialize_batch
from arroyo_tpu_torch.formats.registry import NOT_PORTED
from arroyo_tpu_torch.sql import plan_query
from test_torch_sql_plan import load_sql
from test_torch_sql_smoke_a import REFUSED, build, port  # noqa: F401


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_family_refused_naming_a5(name, tmp_path, port):  # noqa: F811
    sql = load_sql(name, str(tmp_path / "out.json"))
    ops = {n.op.value for n in plan_query(sql).graph.nodes.values()}
    assert REFUSED[name] in ops
    with pytest.raises(NotImplementedError, match=rf"{REFUSED[name]} is not ported yet "
                                                  rf"\(ROADMAP A\.5"):
        build(sql, 1, f"{name}-refused").run_to_completion(timeout=60)


def test_spill_annex_refused_naming_a5(tmp_path, port):  # noqa: F811
    tcfg.update({"state.spill.enabled": True})
    sql = load_sql("spill_keyspace", str(tmp_path / "out.json"))
    with pytest.raises(NotImplementedError, match=r"spill annex .*ROADMAP A\.5"):
        build(sql, 1, "spill-refused").run_to_completion(timeout=60)


@pytest.mark.parametrize("fmt", NOT_PORTED)
def test_other_formats_refused_naming_a9(fmt):
    schema = Schema.of([("x", "int64")])
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        make_deserializer({"format": fmt}, schema)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        serialize_batch({"format": fmt}, Batch({"x": np.arange(3)}), schema)


def test_json_formats_are_taken():
    schema = Schema.of([("x", "int64")])
    for fmt in ("json", "debezium_json"):
        make_deserializer({"format": fmt}, schema)
        assert serialize_batch({"format": fmt}, Batch({"x": np.arange(2)}), schema) == [
            b'{"x":0}', b'{"x":1}']
