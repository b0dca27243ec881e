"""The port's SQL front end (arroyo_tpu_torch.sql) against the JAX
package's on the CPU: every ``tests/smoke/queries`` file and the three
Nexmark SQL texts of chip_smoke.py plan to the same graph (node ids, ops,
parallelism, configs with expressions in their JSON form, edges with their
schemas), the same chained view, the same plan fingerprint and the same
plan-pass diagnostics; the ``tests/smoke/queries_bad`` files are refused
with the same rule, or plan with the same warnings.

The smoke UDFs are registered in the port's own registry with the very
functions ``tests/smoke/udfs.py`` registers in the JAX package's (so a
config holding one serializes alike), and the AR008 fixture connector
``bad_state`` has a port copy here. ``register_port_fixtures`` is shared
with the smoke-run tests.
"""

from __future__ import annotations

import glob
import os
import re
import sys

import pytest

import arroyo_tpu
import arroyo_tpu.config as jcfg
import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import optimizer as joptimizer
from arroyo_tpu.analysis import analyze_graph as janalyze
from arroyo_tpu.analysis.plan_diff import plan_fingerprint as jfingerprint
from arroyo_tpu.engine.engine import construct_operator as jconstruct
from arroyo_tpu.sql import plan_query as jplan
from arroyo_tpu.sql.lexer import SqlError as JSqlError
from arroyo_tpu.sql.planner import executed_graph_view as jview
from arroyo_tpu_torch import optimizer as toptimizer
from arroyo_tpu_torch.analysis import analyze_graph as tanalyze
from arroyo_tpu_torch.analysis.plan_diff import plan_fingerprint as tfingerprint
from arroyo_tpu_torch.engine.engine import construct_operator as tconstruct
from arroyo_tpu_torch.sql import plan_query as tplan
from arroyo_tpu_torch.sql.lexer import SqlError as TSqlError
from arroyo_tpu_torch.sql.planner import executed_graph_view as tview

SMOKE = os.path.join(os.path.dirname(__file__), "smoke")
QUERIES = sorted(os.path.splitext(os.path.basename(p))[0]
                 for p in glob.glob(os.path.join(SMOKE, "queries", "*.sql")))
BAD = sorted(os.path.splitext(os.path.basename(p))[0]
             for p in glob.glob(os.path.join(SMOKE, "queries_bad", "*.sql")))
NEXMARK = {"q7": chip_smoke.SQL_Q7, "q5": chip_smoke.SQL_Q5, "q8": chip_smoke.SQL_Q8}


def register_port_fixtures() -> None:
    """Import tests/smoke/udfs.py (it registers the suite's UDFs, UDAFs and
    the ``bad_state`` connector in the JAX package) and register the same
    functions, and a port copy of ``BadStateSource``, in the port."""
    sys.path.insert(0, SMOKE)
    try:
        import udfs  # noqa: F401
    finally:
        sys.path.pop(0)
    from arroyo_tpu import udf as judf
    from arroyo_tpu_torch import udf as tudf
    from arroyo_tpu_torch.connectors import register_source
    from arroyo_tpu_torch.connectors.single_file import SingleFileSource
    from arroyo_tpu_torch.operators.base import TableSpec

    for name, u in judf.udfs().items():
        tudf.register_udf(name, u.fn, return_dtype=u.return_dtype, vectorized=u.vectorized,
                          is_async=u.is_async, max_concurrency=u.max_concurrency,
                          ordered=u.ordered)
    for name, u in judf._UDAF_REGISTRY.items():
        tudf.register_udaf(name, u.fn, return_dtype=u.return_dtype)

    class BadStateSource(SingleFileSource):
        """The port's copy of udfs.py's AR008 fixture: two state tables
        sharing one name."""

        def tables(self):
            return [TableSpec("s", "global_keyed"), TableSpec("s", "expiring_time_key")]

    register_source("bad_state")(BadStateSource)


def load_sql(name: str, out: str, folder: str = "queries") -> str:
    with open(os.path.join(SMOKE, folder, f"{name}.sql")) as f:
        sql = f.read()
    return sql.replace("$input_dir", os.path.join(SMOKE, "inputs")).replace("$output_path", out)


@pytest.fixture(autouse=True)
def _configs():
    arroyo_tpu._load_operators()
    register_port_fixtures()
    tcfg.reset()
    yield
    tcfg.reset()
    jcfg.update({"pipeline.chaining.enabled": False})


def _diags(ds) -> list:
    return [(d.rule_id, str(d.severity), d.site, d.message) for d in ds]


def _same_plans(jsql: str, tsql: str) -> None:
    jg, tg = jplan(jsql).graph, tplan(tsql).graph
    assert tg.to_json() == jg.to_json()
    assert tg.dumps() == jg.dumps()
    jc, tc = joptimizer.chain_graph(jg), toptimizer.chain_graph(tg)
    assert tc.to_json() == jc.to_json()
    assert _diags(tanalyze(tg)) == _diags(janalyze(jg))
    assert tfingerprint(tg) == jfingerprint(jg)
    for chaining in (False, True):
        jcfg.update({"pipeline.chaining.enabled": chaining})
        tcfg.update({"pipeline.chaining.enabled": chaining})
        assert tview(tsql, parallelism=2) == jview(jsql, parallelism=2)


@pytest.mark.parametrize("name", QUERIES)
def test_smoke_query_plans_alike(name, tmp_path):
    sql = load_sql(name, str(tmp_path / "out.json"))
    _same_plans(sql, sql)


@pytest.mark.parametrize("name", sorted(NEXMARK))
def test_nexmark_sql_plans_alike(name, tmp_path):
    sql = chip_smoke.nexmark_sql(name, 20_000, str(tmp_path / "out.json"))
    _same_plans(sql, sql)
    ops = [n.op.value for n in tplan(sql).graph.nodes.values()]
    assert ops.count("source") == (2 if name == "q8" else 1)
    assert ("instant_join" in ops) == (name == "q8")


def test_nexmark_options_take_numbers_as_the_jax_package_does(tmp_path):
    """A quoted event_count reaches both packages' nexmark sources as the
    string it was written as: neither planner coerces it (the sources then
    fail on it when they run)."""
    sql = chip_smoke.nexmark_sql("q7", 20_000, str(tmp_path / "o.json")).replace(
        "event_count = 20000", "event_count = '20000'")
    srcs = []
    for plan, construct in ((jplan, jconstruct), (tplan, tconstruct)):
        node = next(n for n in plan(sql).graph.nodes.values() if n.op.value == "source")
        srcs.append(construct(node.op, dict(node.config)))
    assert srcs[0].event_count == srcs[1].event_count == "20000"


def _rule(text: str):
    m = re.match(r"--\s*(reject|warn):\s*(\S+)", text)
    return m.group(1), m.group(2)


@pytest.mark.parametrize("name", BAD)
def test_bad_query_refused_or_warned_alike(name, tmp_path):
    path = os.path.join(SMOKE, "queries_bad", f"{name}.sql")
    with open(path) as f:
        kind, rule = _rule(f.readline())
    sql = load_sql(name, str(tmp_path / "out.json"), folder="queries_bad")
    if kind == "reject":
        with pytest.raises(JSqlError) as je:
            jplan(sql)
        with pytest.raises(TSqlError) as te:
            tplan(sql)
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)
        if rule != "AR000":
            assert rule in str(te.value)
        return
    jg, tg = jplan(sql).graph, tplan(sql).graph
    jd, td = _diags(janalyze(jg)), _diags(tanalyze(tg))
    assert td == jd
    assert any(r == rule and s.lower() == "warning" for r, s, _site, _m in td)


def test_bad_queries_are_13_rejects_and_4_warnings():
    kinds = []
    for name in BAD:
        with open(os.path.join(SMOKE, "queries_bad", f"{name}.sql")) as f:
            kinds.append(_rule(f.readline()))
    assert sum(k == "reject" for k, _r in kinds) == 13
    assert sorted(r for k, r in kinds if k == "warn") == ["AR004", "AR004", "AR005", "AR006"]


def test_graph_json_round_trips(tmp_path):
    from arroyo_tpu_torch.graph import Graph

    for name in ("expressions", "session_udaf", "windowed_inner_join"):
        g = tplan(load_sql(name, str(tmp_path / "o.json"))).graph
        assert Graph.loads(g.dumps()).to_json() == g.to_json()
