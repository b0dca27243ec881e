"""The Triton source the port generates for K4 from each bound plan of the
grid (chip_smoke.py's plans, as tests/test_torch_segment.py binds them):
it parses, reads only the plan's traced input columns, stores every traced
output, and computes float division and square root with the correctly
rounded libdevice functions and float remainder with libdevice's exact
fmod. Nothing here imports triton: the source is text until the card
compiles it."""

import ast
import sys

import numpy as np
import pytest

import chip_smoke
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch.engine import segment as tseg
from arroyo_tpu_torch.ops import segment_kernel
from test_torch_segment import PLANS, PORT, bind


def _program(tm, cols, hoist):
    plan, batch = bind(PORT, tm, cols, hoist)
    dts = [np.asarray(batch.columns[c]).dtype for c in plan.traced_in]
    return plan, segment_kernel.SegmentProgram(plan, dts)


@pytest.mark.parametrize("label,jm,tm,cols,hoist", PLANS, ids=[p[0] for p in PLANS])
def test_generated_source_parses_and_names_only_the_plan(label, jm, tm, cols, hoist):
    plan, prog = _program(tm, cols, hoist)
    tree = ast.parse(prog.source)
    kernels = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    assert {"segment_fused_kernel", "_splitmix64"} <= set(kernels)
    args = [a.arg for a in kernels["segment_fused_kernel"].args.args]
    assert args[:2] == ["n", "P"]
    assert [a for a in args if a.startswith("in")] == [f"in{k}_ptr" for k in range(len(plan.traced_in))]
    assert [a for a in args if a.startswith("out")] == [f"out{k}_ptr" for k in range(len(plan.traced_out))]
    assert ("mask_ptr" in args) == prog.has_mask
    assert ("segment_fold_kernel" in kernels) == bool(plan.wm_stages)
    body = ast.unparse(kernels["segment_fused_kernel"])
    for k in range(len(plan.traced_in)):
        assert body.count(f"in{k}_ptr + offs") == 1  # each column read once
    for k in range(len(plan.traced_out)):
        assert body.count(f"out{k}_ptr + offs") == 1
    # the plan's column names stay on the host: the kernel sees pointers
    names = {n.id for n in ast.walk(kernels["segment_fused_kernel"]) if isinstance(n, ast.Name)}
    assert not names & set(cols)
    assert set(prog.out_dtypes) == set(plan.traced_out)


def test_grid_uses_correctly_rounded_float_ops():
    """Every float division, sqrt and remainder of the grid goes through
    libdevice's _rn / exact functions; no bare float ``/`` or tl.sqrt."""
    seen = set()
    for label, jm, tm, cols, hoist in PLANS:
        _plan, prog = _program(tm, cols, hoist)
        src = prog.source
        for fn in ("div_rn", "sqrt_rn", "fmod", "round", "floor", "ceil", "trunc"):
            if f"libdevice.{fn}(" in src:
                seen.add(fn)
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                pytest.fail(f"{label}: true division outside libdevice.div_rn: {ast.unparse(node)}")
            if isinstance(node, ast.Attribute) and node.attr in ("sqrt", "div_rn", "sqrt_rn") \
                    and ast.unparse(node.value) == "tl":
                pytest.fail(f"{label}: tl.{node.attr} instead of the libdevice function")
    assert seen == {"div_rn", "sqrt_rn", "fmod", "round", "floor", "ceil", "trunc"}


def test_q7_plan_reads_four_columns_and_writes_four():
    plan, prog = _program(*[p for p in PLANS if p[0] == "q7 insert"][0][2:])
    assert plan.traced_in == ["_timestamp", "bid", "bid.auction", "bid.price"]
    assert plan.traced_out == ["__bins", "__hash", "__val0", "__val2"]
    assert prog.out_dtypes == {"__bins": np.int64, "__hash": np.uint64,
                               "__val0": np.int64, "__val2": np.int64}
    assert prog.has_mask and prog.wm_dtypes == [np.int64]


def test_kernel_nodes_outside_the_kernel_raise_untraceable():
    """A node the kernel does not take is refused when the plan is lowered,
    on any device, so the CPU takes exactly the plans the card takes."""
    E = texpr
    cols = chip_smoke.grid_columns(64)
    cols["u64"] = cols["i64"].view(np.uint64)
    cols["f16"] = cols["f32"].astype(np.float16)
    for proj in ([("y", E.BinOp("+", E.Col("u64"), E.Lit(1)))],
                 [("y", E.BinOp("*", E.Col("f16"), E.Lit(2.0)))],
                 [("y", E.BinOp("-", E.Col("b"), E.Col("b")))]):
        members = [("value", {"projections": proj + [("w", E.Col("i64"))], "filter": None}),
                   ("watermark", {"expr": E.Col("w")})]
        plan, batch = bind(PORT, members, cols, False)
        dts = [np.asarray(batch.columns[c]).dtype for c in plan.traced_in]
        with pytest.raises(tseg.SegmentUntraceable, match="not in the segment kernel"):
            tseg._trace_fn(plan, dts, tseg.torch.device("cpu"))


def test_codegen_imports_no_triton():
    assert "triton" not in sys.modules
