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
import torch

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
    # one kernel a batch: the watermark fold is inside it, behind a ticket
    jitted = [f.name for f in kernels.values()
              if any("triton.jit" in ast.unparse(d) for d in f.decorator_list)]
    assert sorted(jitted) == ["_max_nan", "_splitmix64", "segment_fused_kernel"]
    assert "segment_fold_kernel" not in prog.source
    assert (args[-3:] == ["ticket_ptr", "G", "BLOCK"]) == bool(plan.wm_stages)
    body = ast.unparse(kernels["segment_fused_kernel"])
    if plan.wm_stages:
        assert body.count("tl.atomic_add(ticket_ptr, 1, sem='acq_rel')") == 1
        assert "if ticket == G - 1:" in body
        assert body.index("tl.store(ticket_ptr, 0)") > body.index("if ticket")
        for j in range(len(plan.wm_stages)):
            assert body.count(f"pmax{j}_ptr + fo") == 1 and body.count(f"tl.store(amax{j}_ptr,") == 1
        # the partials are read past L1, after the barrier and the ticket
        assert body.count("cache_modifier='.cg'") == 2 * len(plan.wm_stages)
        assert body.index("tl.debug_barrier()") < body.index("tl.atomic_add")
        # the partials before the ticket, the outputs after it
        assert body.index("pcnt0_ptr + pid") < body.index("tl.atomic_add") < \
            body.index("out0_ptr + offs") < body.index("if ticket")
    else:
        assert "ticket" not in body
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
    """A node the kernel does not take (bool - bool, which jax.numpy
    refuses) is refused when the plan is lowered, on any device, so the CPU
    takes exactly the plans the card takes. uint64 arithmetic and float16
    (C4) are in the kernel: they trace, and the port's compiled segment gives
    the JAX compiled segment's bytes."""
    import arroyo_tpu
    from arroyo_tpu import expr as jexpr
    from test_torch_segment import JAX, plan_entry

    arroyo_tpu._load_operators()
    cols = chip_smoke.grid_columns(64)
    cols["u64"] = cols["i64"].view(np.uint64)
    cols["f16"] = cols["f32"].astype(np.float16)

    def members(E, proj):
        return [("value", {"projections": proj(E) + [("w", E.Col("i64"))], "filter": None}),
                ("watermark", {"expr": E.Col("w")})]

    bad = lambda E: [("y", E.BinOp("-", E.Col("b"), E.Col("b")))]  # noqa: E731
    plan, batch = bind(PORT, members(texpr, bad), cols, False)
    dts = [np.asarray(batch.columns[c]).dtype for c in plan.traced_in]
    with pytest.raises(tseg.SegmentUntraceable, match="not in the segment kernel"):
        tseg._trace_fn(plan, dts, tseg.torch.device("cpu"))
    for proj in (lambda E: [("y", E.BinOp("+", E.Col("u64"), E.Lit(1)))],
                 lambda E: [("y", E.BinOp("*", E.Col("f16"), E.Lit(2.0)))]):
        got = {}
        for pkg, E in ((PORT, texpr), (JAX, jexpr)):
            plan, batch = bind(pkg, members(E, proj), cols, False)
            entry = plan_entry(pkg, plan, batch)
            got[pkg] = (entry.execute(batch, "job", observe=False) if pkg is JAX
                        else entry.execute(batch))
        t, j = np.asarray(got[PORT]["cols"]["y"]), np.asarray(got[JAX]["cols"]["y"])
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


def _packed_run(plan, prog, cols):
    """The plain version's separate outputs and the same call packed into
    one buffer laid out by ``prog.out_layout``."""
    from test_torch_segment import padded

    n, arrays = padded(plan, PORT.batch.Batch(dict(cols)))
    ins = segment_kernel.stage_inputs(prog, arrays, torch.device("cpu"))
    sep = segment_kernel.segment_plain(prog, n, ins)
    P = len(arrays[0])
    lay = prog.out_layout(P)
    packed = torch.full((lay.nbytes,), 0xA5, dtype=torch.uint8)
    views = segment_kernel.segment_fused(prog, n, ins, out=packed)
    return n, arrays, P, lay, sep, packed, views


@pytest.mark.parametrize("label,jm,tm,cols,hoist", PLANS, ids=[p[0] for p in PLANS])
def test_packed_outputs_carve_to_the_separate_outputs(label, jm, tm, cols, hoist):
    """Every traced output, the mask and each watermark stage's (max,
    count) land in their own 16-byte aligned part of one buffer, the
    watermark results last; carved on the device side and unpacked from
    the host copy, they hold the bytes of the separate outputs."""
    plan, prog = _program(tm, cols, hoist)
    n, arrays, P, lay, (outs, mask, aux), packed, views = _packed_run(plan, prog, cols)
    offs = [o for _k, o, _d in lay.outs] + ([lay.mask] if lay.mask is not None else []) + \
        [o for m, _d, c in lay.wm for o in (m, c)]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert lay.wm_offset == (lay.wm[0][0] if lay.wm else lay.nbytes)
    sizes = [P * np.dtype(prog.out_dtypes[k]).itemsize for k in plan.traced_out] + \
        ([P] if prog.has_mask else []) + [x for dt in prog.wm_dtypes for x in (dt.itemsize, 8)]
    assert lay.nbytes == sum(-(-b // 16) * 16 for b in sizes)
    v_outs, v_mask, v_aux = views
    for k in plan.traced_out:
        assert v_outs[k].dtype == outs[k].dtype
        assert v_outs[k].numpy().tobytes() == outs[k].numpy().tobytes()
        assert v_outs[k].untyped_storage().data_ptr() == packed.untyped_storage().data_ptr()
    assert (v_mask is None) == (mask is None)
    if mask is not None:
        assert torch.equal(v_mask, mask)
    host = prog.unpack(packed.numpy(), P)
    for k in plan.traced_out:
        want = outs[k].numpy()
        assert host[0][k].tobytes() == want.tobytes()
        assert host[0][k].dtype == prog.out_dtypes[k]
    if mask is not None:
        assert host[1].tobytes() == mask.numpy().tobytes()
    flat = [x for m, c in aux for x in (m, c)]
    assert len(host[2]) == len(flat) == 2 * len(prog.wm_dtypes)
    for got, want in zip(host[2], flat):
        assert got.shape == () and got.tobytes() == want.numpy().tobytes()
    assert [x.tobytes() for x in prog.unpack_wm(packed.numpy()[lay.wm_offset:], P)] == \
        [x.tobytes() for x in host[2]]
    for (vm, vc), (m, c) in zip(v_aux, aux):
        assert vm.dtype == m.dtype and vm.numpy().tobytes() == m.numpy().tobytes()
        assert int(vc) == int(c)


@pytest.mark.parametrize("label,jm,tm,cols,hoist", PLANS, ids=[p[0] for p in PLANS])
def test_inputs_stage_through_one_buffer(label, jm, tm, cols, hoist):
    """stage_inputs packs a batch's columns into one buffer, each at a
    16-byte boundary (uint64 as its int64 bits), and hands the kernel
    views of it: one copy to the card. On the CPU it is called directly."""
    from test_torch_segment import padded

    plan, prog = _program(tm, cols, hoist)
    _n, arrays = padded(plan, PORT.batch.Batch(dict(cols)))
    ins = segment_kernel.stage_inputs(prog, arrays, torch.device("cpu"))
    nbytes, offs = prog.in_layout(len(arrays[0]))
    base = ins[0].untyped_storage().data_ptr()
    assert {t.untyped_storage().data_ptr() for t in ins} == {base}
    assert ins[0].untyped_storage().nbytes() == nbytes
    assert [t.data_ptr() - base for t in ins] == offs and all(o % 16 == 0 for o in offs)
    for t, a, dt in zip(ins, arrays, prog.in_dtypes):
        want = a.view(np.int64) if dt == np.uint64 else a
        assert t.dtype == segment_kernel.TORCH_DTYPES[dt] and t.numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="where the plan stages"):
        segment_kernel.stage_inputs(prog, [arrays[0].view(np.uint8)] + arrays[1:],
                                    torch.device("cpu"))


def test_out_buffer_of_the_wrong_size_is_refused():
    plan, prog = _program(*[p for p in PLANS if p[0] == "q7 insert"][0][2:])
    from test_torch_segment import padded

    cols = [p for p in PLANS if p[0] == "q7 insert"][0][3]
    n, arrays = padded(plan, PORT.batch.Batch(dict(cols)))
    ins = segment_kernel.stage_inputs(prog, arrays, torch.device("cpu"))
    nbytes = prog.out_layout(len(arrays[0])).nbytes
    for bad in (torch.empty(nbytes - 16, dtype=torch.uint8), torch.empty(nbytes // 8, dtype=torch.int64)):
        with pytest.raises(ValueError, match="contiguous uint8"):
            segment_kernel.segment_fused(prog, n, ins, out=bad)


def test_codegen_imports_no_triton():
    assert "triton" not in sys.modules
