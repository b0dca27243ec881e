"""The port's compiled segment (arroyo_tpu_torch/engine/segment.py and the
plain version of its kernel, ops/segment_kernel.py) against arroyo_tpu's
(engine/segment.py) on the CPU, byte for byte: the segment function of a
bound plan (outputs, dtypes, mask, watermark aux over the whole padded
batch), the numpy reference, the first-batch verification verdict, and the
plan-time marking and chaining of bench.py's graphs and of the rejects.

The plans are chip_smoke.py's: bench.py's q7 and q5 inserts, q8's two
emit-batch chains (filter hoisted and not), an expression grid over every
allowlisted operator and function and int32/int64/float32/float64/bool
columns with their edge values, multi-column keys and negative timestamps.
"""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu import batch as jbatch
from arroyo_tpu import expr as jexpr
from arroyo_tpu import graph as jgraph
from arroyo_tpu import optimizer as joptimizer
from arroyo_tpu.engine import segment as jseg
from arroyo_tpu.engine.engine import construct_operator as jconstruct
from arroyo_tpu_torch import batch as tbatch
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import graph as tgraph
from arroyo_tpu_torch import optimizer as toptimizer
from arroyo_tpu_torch.engine import segment as tseg
from arroyo_tpu_torch.engine.engine import construct_operator as tconstruct

N = 3001  # odd, pads to 4096
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


class _Pkg:
    def __init__(self, batch, expr, graph, seg, construct):
        self.batch, self.expr, self.graph, self.seg, self.construct = (
            batch, expr, graph, seg, construct)


JAX = _Pkg(jbatch, jexpr, jgraph, jseg, jconstruct)
PORT = _Pkg(tbatch, texpr, tgraph, tseg, tconstruct)


def bind(pkg, members, cols, hoist):
    """A bound plan of either package, as its segment runner binds it."""
    batch = pkg.batch.Batch(dict(cols))
    ops = [pkg.construct(pkg.graph.OpName(op), cfg) for op, cfg in members]
    marking = pkg.seg.segment_marking(members)
    k = int(marking["prefix"])
    if marking["insert"]:
        probe = pkg.seg._bind(ops[:k - 1], k - 1, batch, probe=True)
        ops[k - 1]._setup_key_transport(pkg.batch.Batch(pkg.seg._reference(probe, batch)["cols"]))
    return pkg.seg._bind(ops[:k], k, batch, hoist=hoist), batch


def padded(plan, batch):
    """The segment function's inputs as CompiledSegment.execute stages
    them (hoisted filter applied, zero-padded)."""
    n = batch.num_rows
    fm = None
    if plan.prefilter is not None:
        fm = np.asarray(jexpr.eval_expr(plan.prefilter, batch.columns, n), dtype=bool)
        n = int(fm.sum())
    p = jseg._padded_size(n)
    arrays = []
    for name in plan.traced_in:
        a = np.asarray(batch.columns[name])
        buf = np.zeros(p, dtype=a.dtype)
        buf[:n] = a[fm] if fm is not None else a
        arrays.append(buf)
    return n, arrays


def _plans(port_expr, jax_expr):
    """(label, jax members, port members, columns, hoist) for every plan."""
    out = []
    q7c = chip_smoke.nexmark_columns(N, ["bid.auction", "bid.price"], 1000)
    q5c = chip_smoke.nexmark_columns(N, ["bid.auction"], 1000)
    q8c = chip_smoke.nexmark_columns(N, ["auction.id", "bid.auction"], 100)
    out.append(("q7 insert", chip_smoke.q7_members(jax_expr), chip_smoke.q7_members(port_expr),
                q7c, False))
    out.append(("q5 insert", chip_smoke.q5_members(jax_expr), chip_smoke.q5_members(port_expr),
                q5c, False))
    for side, hoist in (("auctions", True), ("bids", False)):
        out.append((f"q8 {side}", chip_smoke.q8_members(jax_expr, side),
                    chip_smoke.q8_members(port_expr, side), q8c, hoist))
    qsc = chip_smoke.nexmark_columns(N, ["bid.bidder", "bid.price"], 1000)
    for name, key, cols in (("qu", "auction", q7c), ("qs", "bidder", qsc)):
        out.append((f"{name} bids chain", chip_smoke.bids_chain_members(jax_expr, key),
                    chip_smoke.bids_chain_members(port_expr, key), cols, False))
    grid = chip_smoke.grid_columns(N)
    for (label, jm, hoist), (_l, tm, _h) in zip(chip_smoke.segment_grid(jax_expr),
                                                chip_smoke.segment_grid(port_expr)):
        out.append((label, jm, tm, grid, hoist))
    c9 = chip_smoke.c9_columns(N)
    for (label, jm, hoist), (_l, tm, _h) in zip(chip_smoke.c9_segment_plans(jax_expr),
                                                chip_smoke.c9_segment_plans(port_expr)):
        out.append((label, jm, tm, c9, hoist))
    return out


PLANS = _plans(texpr, jexpr)
IDS = [p[0] for p in PLANS]


def _aux_read(aux):
    """Each watermark stage's (max, count) with its dtypes, the max as the
    segment's execute() reads it: int(max) when count > 0 (a NaN max is
    read as NaN: int() raises on either package alike)."""
    out = []
    it = iter(aux)
    for mx, cnt in zip(it, it):
        mx, cnt = np.asarray(mx), np.asarray(cnt)
        val = "nan" if mx.dtype.kind == "f" and np.isnan(mx) else mx.item()
        out.append((mx.dtype, cnt.dtype, val if int(cnt) else None, int(cnt)))
    return out


def _reference_or_none(pkg, plan, batch):
    try:
        return pkg.seg._reference(plan, batch)
    except (ValueError, OverflowError):  # int() of a NaN / inf watermark max
        return None


@pytest.mark.parametrize("label,jm,tm,cols,hoist", PLANS, ids=IDS)
def test_segment_function_matches_jax(label, jm, tm, cols, hoist):
    """Same outputs, dtypes, mask and aux over the whole padded batch, and
    the same bytes as XLA's CPU compilation of the JAX twin on every valid
    row: subnormals flushed, divisions by literals as multiplies by the
    reciprocal, ``x * bool`` as a select, multiply-adds contracted (C9)."""
    jplan, jb = bind(JAX, jm, cols, hoist)
    tplan, tb = bind(PORT, tm, cols, hoist)
    assert tplan.traced_in == jplan.traced_in
    assert tplan.traced_out == jplan.traced_out
    assert tplan.out_plan == jplan.out_plan
    assert (tplan.prefilter is None) == (jplan.prefilter is None) == (not hoist)
    n, arrays = padded(jplan, jb)
    j_outs, j_mask, j_aux = jseg._trace_fn(jplan)(n, arrays)
    in_dtypes = [a.dtype for a in arrays]
    t_outs, t_mask, t_aux = tseg._trace_fn(tplan, in_dtypes, CPU)(n, arrays)
    assert list(t_outs) == list(j_outs)
    assert (t_mask is None) == (j_mask is None)
    if j_mask is not None:
        np.testing.assert_array_equal(t_mask, np.asarray(j_mask))
    assert _aux_read(t_aux) == _aux_read(j_aux)
    idx = np.flatnonzero(np.asarray(j_mask)) if j_mask is not None else np.arange(n)
    for name in j_outs:
        want, got = np.asarray(j_outs[name]), t_outs[name]
        assert got.dtype == want.dtype, f"{label}: {name} {got.dtype} != {want.dtype}"
        u = f"u{want.itemsize}" if want.dtype != np.bool_ else "u1"
        bad = np.flatnonzero(got[idx].view(u) != want[idx].view(u))
        assert not len(bad), (f"{label}: {name} differs from JAX at {len(bad)} valid rows, "
                              f"first {idx[bad[:3]].tolist()}: port {got[idx[bad[:3]]].tolist()} "
                              f"JAX {want[idx[bad[:3]]].tolist()}")


def _verdict(pkg, plan, batch):
    """execute() against _reference, as the first-batch verification does:
    the mismatch text, or the exception both sides must raise alike."""
    entry = plan_entry(pkg, plan, batch)
    try:
        want = pkg.seg._reference(plan, batch)
        got = (entry.execute(batch, "job", observe=False) if pkg is JAX
               else entry.execute(batch))
    except (ValueError, OverflowError) as e:  # int() of a NaN / inf watermark
        return ("raises", type(e).__name__)
    return pkg.seg._outputs_equal(got, want)


def plan_entry(pkg, plan, batch):
    sig = pkg.seg._schema_sig(batch)
    if pkg is JAX:
        return jseg.CompiledSegment(plan, jseg._trace_fn(plan), sig)
    in_dtypes = [np.asarray(batch.columns[c]).dtype for c in plan.traced_in]
    return tseg.CompiledSegment(plan, tseg._trace_fn(plan, in_dtypes, CPU), sig)


@pytest.mark.parametrize("label,jm,tm,cols,hoist", PLANS, ids=IDS)
def test_reference_matches_jax_and_port_verifies_where_jax_does(label, jm, tm, cols, hoist):
    """The numpy reference agrees byte for byte (or raises alike), and
    where the JAX segment's first-batch verification passes, the port's
    passes too."""
    jplan, jb = bind(JAX, jm, cols, hoist)
    tplan, tb = bind(PORT, tm, cols, hoist)
    jref, tref = _reference_or_none(JAX, jplan, jb), _reference_or_none(PORT, tplan, tb)
    assert (jref is None) == (tref is None)
    if jref is not None:
        assert tref["n"] == jref["n"] and tref["aux"] == jref["aux"]
        assert list(tref["cols"]) == list(jref["cols"])
        for name, w in jref["cols"].items():
            g = np.asarray(tref["cols"][name])
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{label}: {name}"
    jv = _verdict(JAX, jplan, jb)
    if jv is None:
        assert _verdict(PORT, tplan, tb) is None


def _fallback_cases(E):
    """Plans whose JAX twin disagrees with its own numpy reference by its
    algorithm, not by XLA's compilation: a float -> int cast saturates
    (NumPy gives INT_MIN for NaN and out-of-range values), and int64 x
    float32 promotes to float32 (NumPy: float64)."""
    c = E.Col
    wm = ("watermark", {"expr": c("w")})
    return {
        "saturating cast": [("value", {"projections": [("y", E.Cast(c("f64"), "int64")),
                                                       ("w", c("i64"))], "filter": None}), wm],
        "int x float32 promotion": [("value", {"projections": [
            ("y", E.BinOp("*", c("i64"), c("f32"))), ("w", c("i64"))], "filter": None}), wm],
    }


@pytest.mark.parametrize("case", sorted(_fallback_cases(texpr)))
def test_port_falls_back_where_the_jax_twin_does(case):
    cols = chip_smoke.grid_columns(N)
    jplan, jb = bind(JAX, _fallback_cases(jexpr)[case], cols, False)
    tplan, tb = bind(PORT, _fallback_cases(texpr)[case], cols, False)
    jv, tv = _verdict(JAX, jplan, jb), _verdict(PORT, tplan, tb)
    assert jv is not None and tv == jv


def _bench_members(E):
    """bench.py's chained runs: q7, q5 and q8's two VALUE+KEY chains, as
    member lists (the sink is a chain member too)."""
    sink = ("sink", {"connector": "vec", "rows": [], "columnar": True})
    return {
        "q7": chip_smoke.q7_members(E) + [sink],
        "q5": chip_smoke.q5_members(E) + [sink],
        "q8 auctions": chip_smoke.q8_members(E, "auctions"),
        "q8 bids": chip_smoke.q8_members(E, "bids"),
    }


def _udf(E):
    """A Python UDF node of either package (refused by name alike)."""
    if E is texpr:
        from arroyo_tpu_torch.udf import UdfExpr
    else:
        from arroyo_tpu.udf import UdfExpr

    return UdfExpr("plus_one", lambda v: v + 1, True, "int64", (E.Col("x"),))


def _rejects(E):
    """Chains the marking must refuse, each for the reason arroyo_tpu gives."""
    c, lit = E.Col, E.Lit
    wm = ("watermark", {"expr": c("_timestamp")})
    key = ("key", {"keys": [("k", c("x"))]})

    def first(e):
        return ("value", {"projections": [("y", e)], "filter": None})

    return {
        "udf": [first(_udf(E)), wm, key],
        "cast to string": [first(E.Cast(c("x"), "string")), wm, key],
        "case without else": [first(E.Case(((E.BinOp(">", c("x"), lit(0)), lit(1)),), None)), wm],
        "ln": [first(E.Func("ln", (c("x"),))), wm, key],
        "host function": [first(E.Func("md5", (c("x"),))), wm, key],
        "second member untraceable": [wm, first(E.Func("exp", (c("x"),))), key],
    }


@pytest.mark.parametrize("name", sorted(_bench_members(texpr)) + sorted(_rejects(texpr)))
def test_marking_matches_jax(name):
    jm = {**_bench_members(jexpr), **_rejects(jexpr)}[name]
    tm = {**_bench_members(texpr), **_rejects(texpr)}[name]
    assert tseg.segment_marking(tm) == jseg.segment_marking(jm)
    assert tseg.segment_reject_reason(tm) == jseg.segment_reject_reason(jm)
    if name in _rejects(texpr) and name != "second member untraceable":
        assert tseg.segment_marking(tm) is None


def test_expr_traceable_matches_jax_on_the_grid():
    for (_l, je), (_m, te) in zip(chip_smoke.expression_grid(jexpr),
                                  chip_smoke.expression_grid(texpr)):
        assert tseg.expr_traceable(te) == jseg.expr_traceable(je)
    assert tseg.expr_traceable(_udf(texpr)) == jseg.expr_traceable(_udf(jexpr))


def bench_graph(g, query):
    """bench.py's q7, q5 or q8 graph (bench.py:49-175) over either
    package's modules; chain_graph reads only op names and configs (the
    port runs q8's INSTANT_JOIN too: tests/test_torch_q8.py)."""
    B, E, G = g
    S = B.Schema.of([("x", "int64"), (B.TIMESTAMP_FIELD, "int64")])
    gr = G.Graph()
    src_cols = {"q7": ["bid.auction", "bid.price"], "q5": ["bid.auction"],
                "q8": ["auction.id", "bid.auction"]}[query]
    gr.add_node(G.Node("src", G.OpName.SOURCE, {
        "connector": "nexmark", "event_count": 1000, "inter_event_micros": 1000,
        "first_event_micros": 0, "include_strings": False, "columns": src_cols}, 1))
    sink = G.Node("sink", G.OpName.SINK, {"connector": "vec", "rows": [], "columnar": True}, 1)
    if query == "q8":
        members = {"auctions": chip_smoke.q8_members(E, "auctions"),
                   "bids": chip_smoke.q8_members(E, "bids")}
        win = members["auctions"][0][1]["projections"][1][1]
        gr.add_node(G.Node("wm", G.OpName.WATERMARK, {"expr": win}, 1))
        for side, (val, key) in members.items():
            gr.add_node(G.Node(side, G.OpName.VALUE, val[1], 1))
            gr.add_node(G.Node(side[0] + "key", G.OpName.KEY, key[1], 1))
        gr.add_node(G.Node("join", G.OpName.INSTANT_JOIN, {
            "join_type": "inner", "left_names": [("id", "id")],
            "right_names": [("bid_auction", "auction")]}, 1))
        gr.add_node(sink)
        for a, b, t in [("src", "wm", G.EdgeType.FORWARD), ("wm", "auctions", G.EdgeType.FORWARD),
                        ("wm", "bids", G.EdgeType.FORWARD), ("auctions", "akey", G.EdgeType.FORWARD),
                        ("bids", "bkey", G.EdgeType.FORWARD), ("akey", "join", G.EdgeType.LEFT_JOIN),
                        ("bkey", "join", G.EdgeType.RIGHT_JOIN), ("join", "sink", G.EdgeType.FORWARD)]:
            gr.add_edge(a, b, t, S)
        return gr
    members = chip_smoke.q7_members(E) if query == "q7" else chip_smoke.q5_members(E)
    for nid, (op, cfg) in zip(("bids", "wm", "key", "agg"), members):
        gr.add_node(G.Node(nid, G.OpName(op), cfg, 1))
    gr.add_node(sink)
    for a, b, t in [("src", "bids", "f"), ("bids", "wm", "f"), ("wm", "key", "f"),
                    ("key", "agg", "s"), ("agg", "sink", "f")]:
        gr.add_edge(a, b, G.EdgeType.FORWARD if t == "f" else G.EdgeType.SHUFFLE, S)
    return gr


def _nodes(g):
    return sorted((nid, n.op.value, repr(n.config.get("compile")), n.config.get("compile_reject"))
                  for nid, n in g.nodes.items())


@pytest.mark.parametrize("query", ["q7", "q5", "q8"])
def test_chain_graph_matches_jax_on_bench_graphs(query):
    tg = toptimizer.chain_graph(bench_graph((tbatch, texpr, tgraph), query))
    jg = joptimizer.chain_graph(bench_graph((jbatch, jexpr, jgraph), query))
    assert _nodes(tg) == _nodes(jg)
    assert sorted((e.src, e.dst, e.edge_type.value) for e in tg.edges) == \
        sorted((e.src, e.dst, e.edge_type.value) for e in jg.edges)
    if query == "q8":
        assert {"auctions+akey", "bids+bkey"} <= set(tg.nodes)
        assert tg.nodes["bids+bkey"].config["compile"]["insert"] is False
    else:
        assert tg.nodes["bids+wm+key+agg+sink"].config["compile"] == {
            "prefix": 4, "insert": True, "stop": "window insert terminates the traced prefix",
            "mesh": True}


def test_padded_size_matches_jax():
    for n in (0, 1, 16, 17, 1000, 4095, 4096, 4097, 65499, 65536, 100_000):
        assert tseg._padded_size(n) == jseg._padded_size(n)


def test_segment_function_refuses_other_devices():
    plan, b = bind(PORT, chip_smoke.q7_members(texpr),
                   chip_smoke.nexmark_columns(64, ["bid.auction", "bid.price"], 1000), False)
    dts = [np.asarray(b.columns[c]).dtype for c in plan.traced_in]
    with pytest.raises(ValueError, match="unsupported device"):
        tseg._trace_fn(plan, dts, torch.device("meta"))
    from arroyo_tpu_torch.ops import segment_kernel

    prog = segment_kernel.SegmentProgram(plan, dts)
    with pytest.raises(ValueError, match="unsupported device"):
        segment_kernel.segment_fused(prog, 10, [torch.zeros(16, dtype=segment_kernel.TORCH_DTYPES[d],
                                                            device="meta") for d in dts])
    assert segment_kernel.segment_fused.launches == 0
