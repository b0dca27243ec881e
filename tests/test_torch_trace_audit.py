"""The port's trace-safety auditor (analysis/trace_audit.py, LR301-LR305,
and AR009) against the JAX package's on the CPU.

The cases of tests/test_trace_audit.py that read no JAX idiom run through
the port (``mirror``; the LR101 alias cases also go to both packages'
lint, ``Differential``). Each case whose fixture is jax code has its
PyTorch counterpart below, under the same name and with the same verdict:
the roots are the ``eval_torch`` twins, K4's plain version
(``segment_plain`` / ``_plain`` in ops/segment_kernel.py) and its
generator (``_Gen``, ``generate``) instead of ``jax.jit`` and shard_map;
LR304's x64 pin becomes torch's default dtype. The parity oracle holds
the twins (eval_torch on CPU tensors) to the numpy path, byte for byte,
on the JAX oracle's dtype matrix, and AR009's dtype model to eval_torch's
real dtypes."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from arroyo_tpu_torch.analysis import (
    Severity,
    audit_trace_source,
    audit_trace_sources,
    lint_source,
    render_json,
)
from test_torch_analysis import jax_cases, mirror, port_cfg, run_case  # noqa: F401

IDIOM_CASES = (
    "test_lr301_positive", "test_lr301_negative_static_metadata_and_identity",
    "test_lr301_self_state", "test_lr301_frozen_reads_are_clean",
    "test_lr301_taint_through_closure_helpers", "test_lr302_positive_and_negative",
    "test_lr303_drift_both_directions", "test_lr303_contradiction",
    "test_lr303_regression_to_timestamp_micros", "test_lr304_ctor_and_astype",
    "test_lr304_missing_x64_pin", "test_x64_pinned_at_trace_entry",
    "test_lr305_positive_and_negative", "test_waiver_grammar",
    "test_determinism_and_json_shape", "test_alias_dodges_do_not_evade_lint",
    "test_lr303_annotated_populated_set_is_read", "test_lr304_positional_arange_dtype",
    "test_oracle_arithmetic", "test_oracle_division", "test_oracle_comparisons",
    "test_oracle_logic", "test_oracle_float_funcs", "test_oracle_time_funcs",
    "test_oracle_composed_case_cast_neg_not", "test_ar009_jnp_dtype_model_matches_real_jax",
    "test_shard_map_is_a_jit_root", "test_shard_map_compat_alias_is_a_jit_root",
    "test_shard_map_clean_body_is_clean",
)
_TRACE = None


def trace_mirror():
    global _TRACE
    if _TRACE is None:
        _TRACE = mirror("test_trace_audit")
    return _TRACE


@pytest.mark.parametrize("name", jax_cases("test_trace_audit", IDIOM_CASES))
def test_trace_audit_case_through_the_port(name, monkeypatch, port_cfg):  # noqa: F811
    diff = run_case(trace_mirror(), name, monkeypatch)
    if name.startswith("test_alias"):
        assert diff.calls > 0, "no source went through both packages"


def test_every_jax_case_is_mirrored_or_has_a_counterpart():
    here = set(jax_cases("test_torch_trace_audit"))
    assert set(IDIOM_CASES) <= here
    assert set(IDIOM_CASES) <= set(jax_cases("test_trace_audit"))


def ids_of(diags):
    return {d.rule_id for d in diags}


K4 = "arroyo_tpu_torch/ops/segment_kernel.py"

# ============================================================ LR301 purity

LR301_FIXTURE = '''
import numpy as np
import torch

def segment_plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    if x > 0:                       # if on a tensor
        pass
    v = float(x)                    # float() on a tensor
    w = np.asarray(x)               # numpy on a tensor
    x.item()                        # host sync
    return v, w
'''


def test_lr301_positive():
    diags = audit_trace_source(LR301_FIXTURE, K4)
    assert ids_of(diags) == {"LR301"}
    assert len([d for d in diags if d.rule_id == "LR301"]) == 4
    assert all(d.severity == Severity.ERROR for d in diags)
    # the torch syncs of the same shape, each its own finding
    syncs = LR301_FIXTURE.replace("x.item()", "x.cpu(); x.numpy(); x.tolist(); "
                                  "torch.cuda.synchronize()")
    assert len(audit_trace_source(syncs, K4)) == 7


def test_lr301_negative_static_metadata_and_identity():
    """Branching on the program's config, on metadata (dtype, dim()) and
    ``is None`` identity is specialization, not impurity; ``n`` is
    annotated int, not a tensor."""
    src = '''
import numpy as np
import torch

def segment_plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    if prog.debug:                  # static config
        y = torch.abs(x)
    else:
        y = x
    if x is None:                   # identity
        return None
    if x.dtype.is_floating_point and x.dim() == 1:   # metadata
        y = y + 1
    if n > 0:                       # a host int
        y = y * 2
    f = np.dtype(np.int64)          # numpy metadata call
    base = torch.arange(x.shape[0], dtype=torch.int64) < n
    return torch.where(base, y, 0)
'''
    assert audit_trace_source(src, K4) == []


def test_lr301_self_state():
    src = '''
import torch

class Op:
    def __init__(self):
        self.cache = None
        self.high = 0
    def bump(self, v):
        self.high = v                  # mutable outside __init__
    def eval_torch(self, cols):
        self.cache = cols["a"]         # write on the twins' path
        return torch.abs(cols["a"]) + self.high   # read of mutable state
'''
    diags = audit_trace_source(src, "arroyo_tpu_torch/expr.py")
    msgs = [d.message for d in diags if d.rule_id == "LR301"]
    assert any("write to self.cache" in m for m in msgs)
    assert any("mutable member state self.high" in m for m in msgs)


def test_lr301_frozen_reads_are_clean():
    src = '''
import torch

class Expr:
    def __init__(self, name):
        self.name = name
    def eval_torch(self, cols):
        return torch.abs(cols[self.name])
'''
    assert audit_trace_source(src, "arroyo_tpu_torch/expr.py") == []


def test_lr301_taint_through_closure_helpers():
    src = '''
import torch

def _lift(v):
    return torch.as_tensor(v)

def _is_float(v):
    return v.dtype.is_floating_point

class Func:
    def eval_torch(self, cols):
        x = cols["a"]
        y = _lift(x)
        if _is_float(x):               # host bool from metadata: clean
            y = y + 1
        v = float(y)                   # y is a tensor through _lift
        return v
'''
    diags = audit_trace_source(src, "arroyo_tpu_torch/expr.py")
    assert [d.rule_id for d in diags] == ["LR301"]
    assert "float()" in diags[0].message


# ====================================================== LR302 shape stable


def test_lr302_positive_and_negative():
    src = '''
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    a = torch.nonzero(x)               # data-dependent shape
    b = torch.where(x > 0)             # single-arg where
    c = x[x > 0]                       # boolean mask
    e = torch.where(x > 0, x, 0)       # three-arg: fine
    idx = torch.argsort(x)
    f = x[idx]                         # integer gather: shape-stable
    return a, b, c, e, f
'''
    diags = audit_trace_source(src, K4)
    assert ids_of(diags) == {"LR302"}
    assert len(diags) == 3
    torch_forms = '''
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    x, m = inputs
    return (torch.unique(x), x.masked_select(m > 0), x.nonzero(), x[~(m > 0)],
            x[(x > 0) & (m > 0)], torch.masked_select(x, m > 0))
'''
    assert len([d for d in audit_trace_source(torch_forms, K4) if d.rule_id == "LR302"]) == 6


# ==================================================== LR303 allowlist drift


SEG_FIXTURE = '''
_TRACEABLE_FUNCS = {"abs", "ghost_fn"}
_TRACEABLE_BINOPS = {"+"}
_KNOWN_DIVERGENT_FUNCS = {"exp"}
'''

EXPR_FIXTURE = '''
_NP_BINOPS = {"+": None, "*": None}
class Func:
    def eval_np(self, cols, n):
        name = self.name
        if name == "abs": return None
        if name == "exp": return None
        if name == "sqrt": return None
    def eval_torch(self, cols):
        name = self.name
        table = {"abs": None, "exp": None, "sqrt": None}
        if name in table: return None
class BinOp:
    def eval_torch(self, cols):
        return binop_torch(self.op, None, None)
def binop_torch(op, l, r):
    if op == "*":
        return None
    return {"+": None}[op]
'''

GEN_FIXTURE = '''
class _Gen:
    def func(self, e, a):
        name = e.name
        if name == "abs":
            return None
        raise TypeError(name)
    def binop(self, op, l, r):
        if op == "*":
            return self.float_binop(op, l, r)
        return None
    def float_binop(self, op, l, r):
        if op in ("+", "-"):
            return None
'''


def drift(seg=SEG_FIXTURE, ex=EXPR_FIXTURE, gen=None):
    named = [(seg, "arroyo_tpu_torch/engine/segment.py"), (ex, "arroyo_tpu_torch/expr.py")]
    if gen is not None:
        named.append((gen, K4))
    return audit_trace_sources(named)


def test_lr303_drift_both_directions():
    diags = drift()
    errs = [d for d in diags if d.severity == Severity.ERROR]
    warns = [d for d in diags if d.severity == Severity.WARNING]
    # ghost_fn is allowlisted with neither twin: two errors (np + torch)
    assert sum("ghost_fn" in d.message for d in errs) == 2
    assert any("'sqrt'" in d.message for d in warns)
    # '*' implemented both ways (on binop_torch's path) but unlisted
    assert any("'*'" in d.message for d in warns)
    assert not any("'exp'" in d.message for d in diags)
    # with K4's generator in the sweep: ghost_fn has no emitter either,
    # while '+' (reached through float_binop) and abs do
    gdiags = drift(gen=GEN_FIXTURE)
    gen_errs = [d for d in gdiags if "K4's generator" in d.message]
    assert [("ghost_fn" in d.message) for d in gen_errs] == [True]
    no_plus = GEN_FIXTURE.replace('if op in ("+", "-"):', 'if op == "-":')
    assert any("'+'" in d.message and "K4's generator" in d.message
               for d in drift(gen=no_plus))


def test_lr303_contradiction():
    seg = SEG_FIXTURE.replace('{"exp"}', '{"exp", "abs"}')
    assert any("both _TRACEABLE_FUNCS and" in d.message
               and d.severity == Severity.ERROR for d in drift(seg))


def test_lr303_regression_to_timestamp_micros():
    """An allowlisted function with no eval_torch twin: every segment using
    it would fail its plain version and fall back."""
    seg = SEG_FIXTURE.replace('"ghost_fn"', '"to_timestamp_micros"')
    assert any("to_timestamp_micros" in d.message and "no twin in expr.Func.eval_torch"
               in d.message for d in drift(seg))


def test_lr303_annotated_populated_set_is_read():
    seg = SEG_FIXTURE + '_KNOWN_DIVERGENT_BINOPS: set = {"*"}\n'
    diags = drift(seg)
    assert not any("'*'" in d.message for d in diags), diags


# ========================================================== LR304 dtypes


def test_lr304_ctor_and_astype():
    src = '''
import numpy as np
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    a = torch.arange(0.5, n)            # a float value: float32
    b = torch.zeros(4)                  # torch's default dtype
    c = x.numpy().astype(int)           # Python builtin width
    d = torch.arange(n, dtype=torch.int64)      # fine
    e = torch.zeros(4, dtype=torch.float64)     # fine
    f = torch.full((4,), 7)                     # an int fill: int64, fine
    return a, b, c, d, e, f
'''
    diags = audit_trace_source(src, K4)
    assert [d.rule_id for d in diags if d.rule_id != "LR301"] == ["LR304"] * 3
    more = '''
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    a = torch.full((n,), 1.5)
    b = torch.tensor([0.0, 1.0])
    c = torch.tensor(2.5)
    d = torch.ones(n)
    e = torch.empty(n)
    f = torch.tensor([1, 2])                            # int64: fine
    g = torch.full((n,), -0.0, dtype=torch.float64)     # fine
    return a, b, c, d, e, f, g
'''
    assert len([d for d in audit_trace_source(more, K4) if d.rule_id == "LR304"]) == 5


def test_lr304_missing_x64_pin():
    """The x64 pin's counterpart: a module that moves torch's default
    dtype changes every dtype-less constructor in the process."""
    src = '''
import torch

def setup():
    torch.set_default_dtype(torch.float32)
'''
    diags = audit_trace_source(src, "arroyo_tpu_torch/engine/fixture.py")
    assert any(d.rule_id == "LR304" and "default dtype" in d.message for d in diags)
    assert audit_trace_source(src.replace("torch.set_default_dtype(torch.float32)", "pass"),
                              "arroyo_tpu_torch/engine/fixture.py") == []


def test_x64_pinned_at_trace_entry():
    """A cold process that imports the segment compiler and K4 keeps
    torch's default dtype, so a dtype-less float constructor anywhere
    still makes what the port's own code expects."""
    code = (
        "import torch\n"
        "import arroyo_tpu_torch.engine.segment, arroyo_tpu_torch.ops.segment_kernel\n"
        "import arroyo_tpu_torch.expr\n"
        "assert torch.get_default_dtype() == torch.float32, torch.get_default_dtype()\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


def test_lr304_positional_arange_dtype():
    src = '''
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    return torch.arange(0, n, 1, dtype=torch.int64), torch.arange(n)
'''
    assert audit_trace_source(src, K4) == []


# ===================================================== LR305 side effects


def test_lr305_positive_and_negative():
    src = '''
import logging
import time

_log = logging.getLogger("x")

class _Gen:
    def let(self, code, dt):
        print("emitting")              # once per compile
        _log.info("line")              # once per compile
        t = time.perf_counter()        # once per compile
        self.recorder.record("j", "INFO", "X")   # once per compile
        self.lines.append(code)        # the generator's own state: fine
        return code

def build(plan):
    src = generate(plan)
    print("compiled")                  # host side: fine
    _log.info("host")                  # host side: fine
    return src
'''
    diags = audit_trace_source(src, K4)
    assert ids_of(diags) == {"LR305"}
    assert len(diags) == 4
    assert all("ONCE per compile" in d.message for d in diags)
    twin = '''
import logging

class Func:
    def eval_torch(self, cols):
        logging.info("x")
        return cols["a"]
'''
    d = audit_trace_source(twin, "arroyo_tpu_torch/expr.py")
    assert [x.rule_id for x in d] == ["LR305"] and "never inside the compiled kernel" \
        in d[0].message


# ================================================= waivers & determinism


def test_waiver_grammar():
    src = '''
import torch

def segment_plain(prog: "P", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    v = float(x)  # lint: waive LR301 — proven scalar aux, synced once
    y = x + 1
    w = int(x)  # lint: waive LR301
    return v, w, y
'''
    diags = audit_trace_source(src, K4)
    assert len(diags) == 1 and "int()" in diags[0].message


def test_determinism_and_json_shape():
    d1 = audit_trace_source(LR301_FIXTURE, K4)
    d2 = audit_trace_source(LR301_FIXTURE, K4)
    assert d1 == d2 and d1
    assert [d.sort_key() for d in d1] == sorted(d.sort_key() for d in d1)
    payload = json.loads(render_json(d1))
    assert all(set(e) == {"rule", "severity", "site", "message", "hint"} for e in payload)


def test_alias_dodges_do_not_evade_lint():
    src = '''
from ..ops.kernels import build_source as J
import torch as whatever
import torch.cuda as wc
import numpy as qq
import time as _clock
from time import perf_counter as pc

class Thing:
    def process_batch(self, batch, ctx, collector):
        f = J("slot_agg", None)
        dev = whatever.abs(batch)
        host = qq.asarray(dev)
        wc.synchronize()
        t = _clock.time()
        t2 = pc()
'''
    diags = lint_source(src, "arroyo_tpu_torch/operators/fixture.py")
    assert {"LR104", "LR109", "LR111"} <= ids_of(diags)
    assert len([d for d in diags if d.rule_id == "LR109"]) == 2
    assert len([d for d in diags if d.rule_id == "LR104"]) == 2


# ============================================ roots without a call site


def test_shard_map_is_a_jit_root():
    """shard_map's counterpart: K4's generator methods are roots though no
    code in the module calls them (the generator runs when a program is
    built), so a side effect in one is found."""
    src = '''
import time

class _Gen:
    def flush(self, x, dt):
        time.sleep(0)                   # once per compile
        return x
'''
    assert ids_of(audit_trace_source(src, K4)) == {"LR305"}


def test_shard_map_compat_alias_is_a_jit_root():
    """The plain version's inner name (``_plain``, which segment_plain
    wraps) is a root too: a branch on a tensor there is found."""
    src = '''
import torch

def _plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    if x > 0:                       # if on a tensor
        pass
    return x
'''
    assert ids_of(audit_trace_source(src, K4)) == {"LR301"}
    # the same names outside K4's module are not roots
    assert audit_trace_source(src, "arroyo_tpu_torch/ops/other.py") == []


def test_shard_map_clean_body_is_clean():
    src = '''
import torch

def _plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    x = inputs[0]
    return torch.where(x > 0, x, 0)

class _Gen:
    def let(self, code, dt):
        self.lines.append(code)
        return code
'''
    assert audit_trace_source(src, K4) == []


# ====================================================== the parity oracle


def _values(dt) -> np.ndarray:
    dt = np.dtype(dt)
    if dt.kind == "f":
        return np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25,
                         np.finfo(dt).max, np.finfo(dt).tiny], dtype=dt)
    if dt.kind == "b":
        return np.array([True, False], dtype=dt)
    info = np.iinfo(dt)
    vals = [info.min, info.max, 0, 7]
    if dt.kind == "i":
        vals.append(-1)
    return np.array(vals, dtype=dt)


def _pairs(dt_l, dt_r, nonzero_right=False):
    a = _values(dt_l)
    b = _values(dt_r)
    if nonzero_right:
        b = b[(b != 0) & np.isfinite(b.astype(np.float64, copy=False)
                                     if np.dtype(dt_r).kind == "f" else b)]
    lv, rv = np.meshgrid(a, b)
    return lv.ravel(), rv.ravel()


def _torch_expr(expr, names, arrays) -> np.ndarray:
    """``expr.eval_torch`` over CPU tensors, back as numpy (uint64 from its
    int64 bits)."""
    from arroyo_tpu_torch.expr import TVal, as_full

    def tv(a):
        a = np.ascontiguousarray(a)
        bits = a.view(np.int64) if a.dtype == np.uint64 else a
        return TVal(torch.from_numpy(bits.copy()), a.dtype)

    n = len(arrays[0]) if arrays else 0
    v = as_full(expr.eval_torch({k: tv(a) for k, a in zip(names, arrays)}), n,
                torch.device("cpu"))
    out = v.t.numpy()
    return out.view(np.uint64) if v.dt == np.uint64 else out.astype(v.dt, copy=False)


def _assert_parity(expr, names, arrays, label):
    from arroyo_tpu_torch.expr import eval_expr

    n = len(arrays[0]) if arrays else 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(eval_expr(expr, dict(zip(names, arrays)), n))
        got = _torch_expr(expr, names, arrays)
    assert got.dtype == want.dtype, f"{label}: dtype {got.dtype} != {want.dtype}"
    assert got.tobytes() == want.tobytes(), f"{label}: values differ"


NUMERIC = ("int32", "int64", "uint64", "float32", "float64")
CONVERGENT_MIXED = (("int32", "int64"), ("int64", "float64"),
                    ("float32", "float64"), ("uint64", "float64"))


@pytest.mark.parametrize("op", ["+", "-", "*"])
def test_oracle_arithmetic(op):
    from arroyo_tpu_torch.expr import BinOp, Col

    e = BinOp(op, Col("l"), Col("r"))
    for dl, dr in [(d, d) for d in NUMERIC] + list(CONVERGENT_MIXED):
        lv, rv = _pairs(dl, dr)
        _assert_parity(e, ("l", "r"), [lv, rv], f"{dl} {op} {dr}")
        _assert_parity(e, ("l", "r"), [np.empty(0, dl), np.empty(0, dr)],
                       f"{dl} {op} {dr} empty")


@pytest.mark.parametrize("op", ["/", "%"])
def test_oracle_division(op):
    """Cells whose numpy result is subnormal are left out, as in the JAX
    oracle: the twins flush them as XLA's CPU code does (C9)."""
    from arroyo_tpu_torch.expr import BinOp, Col, eval_expr

    e = BinOp(op, Col("l"), Col("r"))
    for dl, dr in [(d, d) for d in NUMERIC]:
        lv, rv = _pairs(dl, dr, nonzero_right=True)
        if op == "/" and np.dtype(dl).kind == "i":
            keep = ~((lv == np.iinfo(dl).min) & (rv == -1))
            lv, rv = lv[keep], rv[keep]
        if np.dtype(dl).kind == "f":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = np.asarray(eval_expr(e, {"l": lv, "r": rv}, len(lv)))
            tiny = np.finfo(dl).tiny
            subnormal = (np.abs(want) > 0) & (np.abs(want) < tiny)
            lv, rv = lv[~subnormal], rv[~subnormal]
        _assert_parity(e, ("l", "r"), [lv, rv], f"{dl} {op} {dr}")
        _assert_parity(e, ("l", "r"), [np.empty(0, dl), np.empty(0, dr)],
                       f"{dl} {op} {dr} empty")


@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">="])
def test_oracle_comparisons(op):
    from arroyo_tpu_torch.expr import BinOp, Col

    e = BinOp(op, Col("l"), Col("r"))
    for d in NUMERIC + ("bool",):
        lv, rv = _pairs(d, d)
        _assert_parity(e, ("l", "r"), [lv, rv], f"{d} {op} {d}")
    _assert_parity(e, ("l", "r"), [np.empty(0, np.float64), np.empty(0, np.float64)],
                   f"{op} empty")


@pytest.mark.parametrize("op", ["and", "or"])
def test_oracle_logic(op):
    from arroyo_tpu_torch.expr import BinOp, Col

    lv, rv = _pairs("bool", "bool")
    _assert_parity(BinOp(op, Col("l"), Col("r")), ("l", "r"), [lv, rv], f"bool {op} bool")


@pytest.mark.parametrize("name", ["abs", "floor", "ceil", "sqrt"])
def test_oracle_float_funcs(name):
    from arroyo_tpu_torch.expr import Col, Func

    e = Func(name, (Col("a"),))
    for d in NUMERIC:
        _assert_parity(e, ("a",), [_values(d)], f"{name}({d})")
        _assert_parity(e, ("a",), [np.empty(0, d)], f"{name}({d}) empty")


def test_oracle_time_funcs():
    from arroyo_tpu_torch.expr import Col, Func, Lit

    ts = np.array([0, 1, -1, 1_234_567_890_123, -7_200_000_001,
                   np.iinfo(np.int64).max // 2], dtype=np.int64)
    _assert_parity(Func("extract_epoch", (Col("a"),)), ("a",), [ts], "extract_epoch(int64)")
    _assert_parity(Func("date_trunc_micros", (Lit(60_000_000), Col("a"))), ("a",), [ts],
                   "date_trunc_micros")
    _assert_parity(Func("to_timestamp_micros", (Col("a"),)), ("a",), [ts],
                   "to_timestamp_micros(int64)")
    _assert_parity(Func("to_timestamp_micros", (Col("a"),)), ("a",),
                   [np.array([1, 2, 3], dtype=np.int32)], "to_timestamp_micros(int32)")


def test_oracle_composed_case_cast_neg_not():
    from arroyo_tpu_torch.expr import BinOp, Case, Cast, Col, Lit, Neg, Not

    case = Case(((BinOp(">", Col("a"), Lit(0)), Col("a")),), Neg(Col("a")))
    for d in ("int32", "int64", "float32", "float64"):
        _assert_parity(case, ("a",), [_values(d)], f"case({d})")
    cast = Cast(BinOp("+", Col("a"), Lit(1)), "float64")
    for d in ("int32", "int64", "float64"):
        _assert_parity(cast, ("a",), [_values(d)], f"cast({d})")
    _assert_parity(Not(BinOp("<", Col("a"), Lit(3))), ("a",), [_values("int64")], "not(<)")


def test_ar009_jnp_dtype_model_matches_real_jax():
    """AR009's static dtype model against the dtypes eval_torch really
    computes (its TVal's dt and its tensor's), on the JAX case list."""
    from arroyo_tpu_torch.analysis.trace_audit import _jnp_dtype, _resolve_weak
    from arroyo_tpu_torch.expr import TORCH_DTYPES, BinOp, Case, Cast, Col, Func, Lit

    cases = [
        (BinOp("*", Col("a"), Col("b")), {"a": np.dtype(np.int64), "b": np.dtype(np.float32)}),
        (BinOp("+", Col("a"), Lit(2)), {"a": np.dtype(np.int32)}),
        (BinOp("+", Col("a"), Lit(2.5)), {"a": np.dtype(np.uint64)}),
        (BinOp("/", Col("a"), Col("b")), {"a": np.dtype(np.int64), "b": np.dtype(np.int64)}),
        (BinOp("/", Col("a"), Lit(2.0)), {"a": np.dtype(np.int64)}),
        (BinOp("<", Col("a"), Lit(0)), {"a": np.dtype(np.float32)}),
        (Func("sqrt", (Col("a"),)), {"a": np.dtype(np.int32)}),
        (Func("floor", (Col("a"),)), {"a": np.dtype(np.int64)}),
        (Func("sqrt", (Col("a"),)), {"a": np.dtype(np.bool_)}),
        (Func("extract_epoch", (Col("a"),)), {"a": np.dtype(np.int64)}),
        (Cast(Col("a"), "int32"), {"a": np.dtype(np.int64)}),
        (Case(((BinOp(">", Col("a"), Lit(0)), Col("a")),), Lit(0.5)), {"a": np.dtype(np.int64)}),
        (Func("to_timestamp_micros", (Col("a"),)), {"a": np.dtype(np.int32)}),
    ]
    from arroyo_tpu_torch.expr import TVal

    for expr, env in cases:
        cols = {n: TVal(torch.ones(2, dtype=TORCH_DTYPES[d]), d) for n, d in env.items()}
        v = expr.eval_torch(cols)
        modeled = np.dtype(_resolve_weak(_jnp_dtype(expr, env)))
        assert v.dt == modeled, f"{expr}: model {modeled} != eval_torch {v.dt}"
        assert v.t.dtype == TORCH_DTYPES[v.dt], f"{expr}: tensor {v.t.dtype} for {v.dt}"
