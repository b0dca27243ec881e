"""The port's subtask placement (controller/checkpoint_state.py
``compute_assignment``) held to the JAX package's: for every smoke query's
planned graph, at parallelism 3, chaining off and on, the same assignment,
expected subtask set and worker count at 2 and 3 workers, whichever
package planned the graph JSON (a graph holding a live callable, as the
async UDF's, is refused by both packages when loaded: its SQL ships)."""

from __future__ import annotations

import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_sql_plan import QUERIES, load_sql, register_port_fixtures


@pytest.fixture(autouse=True)
def port(tmp_path):
    register_port_fixtures()
    tcfg.reset()
    yield
    tcfg.reset()


def graph_json(pkg: str, name: str, out: str) -> str:
    if pkg == "jax":
        from arroyo_tpu.sql import plan_query
        from arroyo_tpu.sql.planner import set_parallelism
    else:
        from arroyo_tpu_torch.sql import plan_query
        from arroyo_tpu_torch.sql.planner import set_parallelism
    pp = plan_query(load_sql(name, out))
    set_parallelism(pp.graph, 3)
    return pp.graph.dumps()


@pytest.mark.parametrize("chaining", [False, True], ids=["unchained", "chained"])
@pytest.mark.parametrize("name", QUERIES)
def test_compute_assignment_equals_jax(name, chaining, tmp_path):
    from arroyo_tpu import config as jcfg
    from arroyo_tpu.controller.checkpoint_state import compute_assignment as jassign
    from arroyo_tpu_torch.controller.checkpoint_state import compute_assignment as tassign

    jcfg.update({"pipeline.chaining.enabled": chaining})
    tcfg.update({"pipeline.chaining.enabled": chaining})
    out = str(tmp_path / "out.json")
    for pkg in ("jax", "port"):
        gj = graph_json(pkg, name, out)
        for n in (2, 3):
            try:
                want = jassign(gj, n)
            except ValueError as e:  # a live callable in a node's config: SQL ships
                with pytest.raises(ValueError, match="live callable"):
                    tassign(gj, n)
                assert "live callable" in str(e)
                continue
            got = tassign(gj, n)
            assert got == want, (pkg, n)
            assert got[2] == min(n, 3)
            assert set(got[0].values()) == set(range(got[2]))
