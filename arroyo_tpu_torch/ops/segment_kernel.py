"""K4 ``segment_fused``: the compiled segment's per-batch program as a
Triton kernel generated from the bound plan, with its plain PyTorch version.

Replaces the TPU program ``_trace_fn.fn`` (arroyo_tpu/engine/segment.py:511,
kernel B2) and, inside it, the splitmix64 key hash ``_hash_columns_jnp``
(:242-278, kernel B1). XLA fused that function per (segment, schema); here
the bound ``_SegmentPlan`` is lowered to Triton source text, one template
per stage and per expression node, compiled at first use and cached beside
the plan (engine/segment.py ``_SegmentCache``).

One program handles ``BLOCK`` rows of the padded batch: it loads only the
traced input columns, narrows the validity mask (padding tail, then each
in-trace filter), evaluates projections, keys, the key hash and the window
insert prep, writes one (masked max, valid count) partial per watermark
stage, draws a ticket from a counter, and then stores the traced outputs
and the mask, so the last program's fold overlaps the other programs'
stores. The program that draws the last ticket folds the partials, in
program order, into each stage's result, and sets the counter back to 0
for the next launch. So a batch is one
launch. The work is a fused elementwise pass plus one reduction, so the
card's memory rate
bounds it: at q7's plan about 25 bytes read and 33 written per row, 3.8 MB
per 65536-row batch, about 1.1 us at 3.35 TB/s. The design does what
fusion can about that: every intermediate stays in registers, each column
crosses device memory once, and BLOCK is small enough (chosen by a sweep on
the card, PERF.md) that a 65,536-row batch puts programs on every SM.

Around the kernel, a batch moves in one copy each way: ``stage_inputs``
packs the input columns into one pinned buffer (each column 16-byte
aligned) and copies it to the card once; the kernel writes every output,
the mask and the watermark results into views of one packed buffer
(``SegmentProgram.out_layout``), which the caller copies back once.

Exactness (the first-batch verification compares bytes): every node's
dtype comes from the type functions of ``expr.py``; integer ``//``, ``%``
and the float -> int conversion are written out with JAX's results for a
zero divisor, INT_MIN / -1, NaN and out-of-range values; float division,
square root, remainder, floor, ceil and round go through libdevice's
correctly rounded functions; float negation and abs flip the sign bit; the
kernel is compiled with ``enable_fp_fusion=False`` so ``a*b+c`` is never
contracted to an FMA.

The wrapper ``segment_fused`` takes the plain version (``segment_plain``,
eval_torch over the same plan) only for tensors on the CPU; on a CUDA tensor
it launches the kernel or raises. Calls are counted in
``segment_fused.launches``, Triton launches in
``segment_fused.kernel_launches`` (one a call).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import threading
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..batch import KEY_FIELD, TIMESTAMP_FIELD
from . import kernels, staging
from ..expr import (BinOp, Case, Cast, CAST_TARGETS, Col, F16_NATIVE, F16_WIDE, Func, Lit, Neg, Not,
                    TORCH_DTYPES, UNSIGNED_BITS, TVal, as_full, binop_type, contraction_sites, convert, default_nan_bits, dtype_floor, flush, max_bits,
                    float16_model, float16_model_as, floordiv_torch, floordiv_type, hash_columns_torch,
                    fold_negation, int_div_type, is_minmax_select, jax_type, literal_pow2,
                    literal_reciprocal,
                    literal_rewrite, promote, quiet_bit, scalar_as, storage_dtype, unary_type)

BLOCK = 256
NUM_WARPS = 4
_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "build" / "segment"

_U16 = np.dtype(np.uint16)
_U32 = np.dtype(np.uint32)
_U64 = np.dtype(np.uint64)
_I64 = np.dtype(np.int64)
_F16 = np.dtype(np.float16)
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)
_BOOL = np.dtype(np.bool_)
# uint16/32/64 values are held in the signed type's bits, as the plain
# version holds them (expr.TORCH_DTYPES); _UTL reads them unsigned
_TL = {np.dtype(np.bool_): "tl.int1", np.dtype(np.int8): "tl.int8",
       np.dtype(np.int16): "tl.int16", np.dtype(np.int32): "tl.int32",
       np.dtype(np.int64): "tl.int64", np.dtype(np.uint8): "tl.uint8",
       _F16: "tl.float16", _F32: "tl.float32", _F64: "tl.float64",
       _U16: "tl.int16", _U32: "tl.int32", _U64: "tl.int64"}
_UTL = {_U16: "tl.uint16", _U32: "tl.uint32", _U64: "tl.uint64"}
_IB = {2: np.dtype(np.int16), 4: np.dtype(np.int32), 8: _I64}  # a float's bits

_count_lock = threading.Lock()
_build_lock = threading.Lock()


class KernelError(kernels.KernelError):
    """A fault of K4 on the card: staging, build, launch or read-back. The
    segment runner lets it fail the job (engine/segment.py)."""


def insert_step(member) -> int:
    """Bin width of a window insert: tumbling bins by the window width,
    sliding by the slide (segment.py _insert_step)."""
    return member.slide if hasattr(member, "slide") else member.width


def _ty(x) -> tuple[np.dtype, bool]:
    return (x.dt, x.weak) if isinstance(x, (SV, TVal)) else jax_type(x)


def _int_operand(x) -> bool:
    if isinstance(x, (SV, TVal)):
        return x.dt.kind in "iu"
    return isinstance(x, int) and not isinstance(x, (bool, np.bool_))


# ------------------------------------------------------------ contraction


class _Node:
    """A node of the plan's expression graph as XLA sees it after CSE:
    structurally equal subexpressions over the same inputs are one node."""

    __slots__ = ("key", "kids", "ids", "kind", "literal")

    def __init__(self, key, kids, kind):
        self.key, self.kids, self.ids, self.kind = key, kids, set(), kind
        self.literal = False


def contraction_table(plan) -> dict:
    """Which float adds and subtracts XLA's CPU code contracts with a
    multiply operand, as {id of the BinOp node: (left may, right may)}.

    XLA fuses each output of the segment function (an output column, the
    mask, a watermark's max, the key hash) into its own loop, copying the
    cheap elementwise nodes it needs into each, and reading an output that
    another output needs from memory, except a multiply by a literal, which
    it copies all the same; LLVM then contracts ``a * b + c`` where the
    multiply has one use in that loop. So an operand may contract when it is
    a multiply (or the negation of one, or a division by a literal, which
    becomes a multiply), is not an output read from memory, and has one use
    in every fused loop the add is copied into. Whether it really is a
    product of the add's dtype is left to the evaluation."""
    nodes: dict = {}

    def node(e, env):
        if isinstance(e, Col):
            return env.get(e.name) or _leaf(("in", e.name))
        if isinstance(e, Lit):
            return _leaf(("lit", type(e.value).__name__, repr(e.value)))
        literal = False
        if isinstance(e, BinOp):
            kids = [node(e.left, env), node(e.right, env)]
            head = ("bin", e.op)
            kind = ("mul" if e.op == "*" else "div" if e.op == "/" and isinstance(e.right, Lit)
                    else "add" if e.op in ("+", "-") else None)
            literal = isinstance(e.left, Lit) or isinstance(e.right, Lit)
        elif isinstance(e, Neg):
            kids, head, kind, literal = [node(e.inner, env)], ("neg",), "neg", False
        elif isinstance(e, Not):
            kids, head, kind = [node(e.inner, env)], ("not",), None
        elif isinstance(e, Cast):
            kids, head, kind = [node(e.inner, env)], ("cast", e.dtype), None
        elif isinstance(e, Case):
            kids = [node(x, env) for b in e.branches for x in b]
            kids.append(node(e.otherwise, env) if e.otherwise is not None else _leaf(("none",)))
            head, kind = ("case", len(e.branches)), None
        elif isinstance(e, Func):
            kids, head, kind = [node(a, env) for a in e.args], ("fn", e.name), None
        else:
            kids, head, kind = [], ("other", id(e)), None
        key = head + tuple(k.key for k in kids)
        n = nodes.get(key)
        if n is None:
            n = nodes[key] = _Node(key, kids, kind)
            n.literal = isinstance(e, BinOp) and literal
        n.ids.add(id(e))
        return n

    def _leaf(key):
        n = nodes.get(key)
        if n is None:
            n = nodes[key] = _Node(key, [], None)
        return n

    env = {name: _leaf(("in", name)) for name in plan.traced_in}
    roots: list = []
    outputs: set = set()
    for si, st in enumerate(plan.stages):
        m = st.member
        if st.kind == "value":
            if m.filter is not None and not (si == 0 and plan.prefilter is not None):
                roots.append(node(m.filter, env))
            if m.projections is not None:
                new = {name: node(e, env) for name, e in m.projections}
                for carried in (TIMESTAMP_FIELD, KEY_FIELD, "_is_retract"):
                    if carried not in new and carried in env:
                        new[carried] = env[carried]
                env = new
        elif st.kind == "key":
            ks = []
            for name, e in m.keys:
                env[name] = node(e, env)
                ks.append(env[name])
            env[KEY_FIELD] = _Node(("hash",) + tuple(k.key for k in ks), ks, None)
            roots.append(env[KEY_FIELD])
        elif st.kind == "wm":
            roots.append(node(m.expr, env))
        else:
            roots.append(env.get(TIMESTAMP_FIELD) or _leaf(("in", TIMESTAMP_FIELD)))
            for inp in m.acc_inputs:
                if inp is not None:
                    v = node(inp, env)
                    roots.append(v)
                    outputs.add(id(v))
    if plan.emits_batch:
        for name in plan.traced_out:
            roots.append(env[name])
            outputs.add(id(env[name]))

    verdict: dict = {}
    for r in roots:
        uses: dict = {}
        seen: set = set()
        stack = [r]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            for k in n.kids:
                uses[id(k)] = uses.get(id(k), 0) + 1
                if id(k) not in outputs or k.literal:
                    stack.append(k)
        inside = [n for n in nodes.values() if id(n) in seen]

        def single(k):
            if (id(k) in outputs and not k.literal) or uses.get(id(k), 0) != 1:
                return False
            if k.kind == "neg":
                return single(k.kids[0]) and k.kids[0].kind in ("mul", "div", "neg")
            return k.kind in ("mul", "div")

        for n in inside:
            if n.kind == "add":
                ok = (single(n.kids[0]), single(n.kids[1]))
                prev = verdict.get(id(n))
                verdict[id(n)] = (n, ok if prev is None else (prev[1][0] and ok[0],
                                                              prev[1][1] and ok[1]))
    table = {}
    for n, ok in verdict.values():
        if ok[0] or ok[1]:
            for i in n.ids:
                table[i] = ok
    return table


# ------------------------------------------------------------ plain version


def segment_plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    """The plain PyTorch version of K4: ``_trace_fn.fn`` with eval_torch.
    Returns (outs, mask, aux): ``outs`` maps each traced output to a [P]
    tensor (uint64 as int64 bits), ``mask`` is the [P] validity mask (None
    without an in-trace filter), ``aux`` one (max, count) pair of 0-d
    tensors per watermark stage."""
    with contraction_sites(prog.sites), float16_model_as(prog.f16_model):
        return _plain(prog, n, inputs)


def _plain(prog: "SegmentProgram", n: int, inputs: list[torch.Tensor]):
    plan = prog.plan
    p = inputs[0].shape[0]
    dev = inputs[0].device
    cols: dict[str, Any] = {name: TVal(t, dt) for name, t, dt in
                            zip(plan.traced_in, inputs, prog.in_dtypes)}
    base = torch.arange(p, dtype=torch.int64, device=dev) < n
    valid = None
    aux: list = []
    outs: dict[str, TVal] = {}
    for si, st in enumerate(plan.stages):
        m = st.member
        if st.kind == "value":
            hoisted = si == 0 and plan.prefilter is not None
            if m.filter is not None and not hoisted:
                f = convert(as_full(m.filter.eval_torch(cols), p, dev), _BOOL)
                valid = (base & f) if valid is None else (valid & f)
            if m.projections is not None:
                new = {name: as_full(e.eval_torch(cols), p, dev) for name, e in m.projections}
                for carried in (TIMESTAMP_FIELD, KEY_FIELD, "_is_retract"):
                    # lint: waive LR301 — a key test on the plan's column dicts, not a test of batch values
                    if carried not in new and carried in cols:
                        new[carried] = cols[carried]
                cols = new
        elif st.kind == "key":
            key_cols = []
            for name, e in m.keys:
                c = as_full(e.eval_torch(cols), p, dev)
                cols[name] = c
                key_cols.append(c)
            cols[KEY_FIELD] = TVal(hash_columns_torch(key_cols), _U64)
        elif st.kind == "wm":
            vals = as_full(m.expr.eval_torch(cols), p, dev)
            eff = base if valid is None else valid
            floor = torch.tensor(dtype_floor(vals.dt), dtype=vals.t.dtype, device=dev)
            aux.append((max_bits(torch.where(eff, flush(vals.t), floor), vals.dt), eff.sum()))
        else:  # insert
            outs["__bins"] = floordiv_torch(cols[TIMESTAMP_FIELD], insert_step(m))
            if plan.insert_has_key:
                outs["__hash"] = TVal(convert(cols[KEY_FIELD], _U64), _U64)
            for i, (inp, dt) in enumerate(zip(m.acc_inputs, m.acc_dtypes)):
                if inp is not None:
                    v = as_full(inp.eval_torch(cols), p, dev)
                    outs[f"__val{i}"] = TVal(convert(v, np.dtype(dt)), dt)
    if plan.emits_batch:
        for name in plan.traced_out:
            outs[name] = cols[name]
    return {k: outs[k].t for k in plan.traced_out}, valid, aux


# ------------------------------------------------------------ code generation


class SV:
    """A symbolic [BLOCK] value of the generated kernel: the name of its
    variable, its NumPy dtype (uint64 as int64 bits), JAX's weak flag, and
    for a float product ``prod`` = (x, y, negated): its flushed operands'
    names and whether the value is -(x * y); for a float negation ``neg``
    (expr.TVal's)."""

    __slots__ = ("code", "dt", "weak", "prod", "neg")

    def __init__(self, code: str, dt, weak: bool = False, prod=None, neg=None):
        self.code = code
        self.dt = np.dtype(dt)
        self.weak = weak
        self.prod = prod
        self.neg = neg  # a float negation: the name of the value it negates


class _Gen:
    """Emits the kernel body, one statement per node, with every operand
    converted to the node's compute dtype before the operation, so Triton's
    own promotion rules never decide a type."""

    def __init__(self, sites: Optional[dict] = None, f16: str = F16_WIDE):
        self.lines: list[str] = []
        self._k = 0
        self.sites = sites or {}
        self.f16 = f16  # the float16 model (expr.F16_WIDE / F16_NATIVE)

    def let(self, code: str, dt, weak: bool = False) -> SV:
        name = f"t{self._k}"
        self._k += 1
        self.lines.append(f"{name} = {code}")
        return SV(name, dt, weak)

    # -- constants and conversions ---------------------------------------

    @staticmethod
    def full(value, dt: np.dtype) -> str:
        dt = np.dtype(dt)
        v = scalar_as(value, dt)
        if dt.kind == "b":
            return f"tl.full([BLOCK], {int(v)}, tl.int1)"
        if dt.kind == "f":
            ib = _IB[dt.itemsize]
            bits = int(np.array(v, dtype=dt).view(ib))
            return f"tl.full([BLOCK], {bits}, {_TL[ib]}).to({_TL[dt]}, bitcast=True)"
        return f"tl.full([BLOCK], {v}, {_TL[dt]})"

    def value(self, x) -> SV:
        if isinstance(x, SV):
            return x
        dt, weak = jax_type(x)
        return self.let(self.full(x, dt), dt, weak)

    def conv(self, x, dt) -> str:
        """Code of ``x`` converted to ``dt`` (expr.convert's semantics)."""
        dt = np.dtype(dt)
        if not isinstance(x, SV):
            return self.full(x, dt)
        src = x.dt
        if dt not in _TL:
            raise TypeError(f"conversion to {dt}: not a dtype of the segment kernel")
        if src == dt:
            return x.code
        if dt == _BOOL:
            return self.let(f"{self.flush(x.code, src)} != {self.full(0, src)}", _BOOL).code
        if src.kind == "f" and dt.kind in "iu":
            return self._sat_float_to_int(x, dt)
        if src.kind == "f" and dt.kind == "f":
            if _F16 in (src, dt) and _F64 in (src, dt):  # XLA converts through float32
                return self.conv(SV(self.conv(x, _F32), _F32), dt)
            return self.flush(self.float_convert(self.flush(x.code, src), dt, src), dt)
        code = self.unsigned(x.code, src) if src in UNSIGNED_BITS else x.code
        if dt == _F16:  # from an integer, through float32 as XLA's CPU code converts
            return self.let(f"{code}.to(tl.float32).to(tl.float16)", dt).code
        if src in UNSIGNED_BITS and dt.kind != "f":  # zero-extended, then truncated
            return self.let(f"{code}.to(tl.int64).to({_TL[dt]})", dt).code
        return self.let(f"{code}.to({_TL[dt]})", dt).code

    @staticmethod
    def unsigned(x: str, dt) -> str:
        """``x`` (a uint16/32/64 held in signed bits) read unsigned."""
        return f"{x}.to({_UTL[dt]}, bitcast=True)"

    def in_f32(self, fn: str, dt, *xs: str) -> str:
        """Code of libdevice ``fn`` over ``xs``; float16 computed in float32
        and rounded once."""
        if dt != _F16:
            return f"libdevice.{fn}({', '.join(xs)})"
        return f"libdevice.{fn}({', '.join(x + '.to(tl.float32)' for x in xs)}).to(tl.float16)"

    def flush(self, x: str, dt) -> str:
        """``x`` with a subnormal replaced by the zero of its sign (expr.flush:
        XLA's CPU code reads float operands and writes float results so);
        integers and bools as they are."""
        dt = np.dtype(dt)
        if dt.kind != "f" or dt == _F16:
            return x
        ib = _IB[dt.itemsize]
        sign = self.full(-(1 << (ib.itemsize * 8 - 1)), ib)
        zero = f"({x}.to({_TL[ib]}, bitcast=True) & {sign}).to({_TL[dt]}, bitcast=True)"
        tiny = self.full(float(np.finfo(dt).tiny), dt)
        return self.let(f"tl.where(tl.abs({x}) < {tiny}, {zero}, {x})", dt).code

    def farith(self, op: str, a: str, b: str, dt, weak: bool = False) -> SV:
        """expr.farith: one float operation, operands read flushed, the
        result NaN-fixed and flushed."""
        a, b = self.flush(a, dt), self.flush(b, dt)
        if dt == _F16:  # in float32, rounded once to float16
            a32, b32 = f"{a}.to(tl.float32)", f"{b}.to(tl.float32)"
            code = (f"libdevice.div_rn({a32}, {b32})" if op == "/" else f"({a32} {op} {b32})")
            return SV(self.op(f"{code}.to(tl.float16)", dt, a, b).code, dt, weak)
        code = f"libdevice.div_rn({a}, {b})" if op == "/" else f"{a} {op} {b}"
        r = self.op(code, dt, a, b)
        return SV(self.flush(r.code, dt), dt, weak)

    def _sat_float_to_int(self, x: SV, dt: np.dtype) -> str:
        f = lambda v: self.full(float(v), _F64)  # noqa: E731
        x64 = x.code if x.dt == _F64 else f"{x.code}.to(tl.float64)"
        t = self.let(f"libdevice.trunc({x64})", _F64).code
        bits = dt.itemsize * 8
        signed = dt.kind == "i"
        hi = 2.0 ** (bits - 1) if signed else 2.0 ** bits
        over = self.let(f"{t} >= {f(hi)}", _BOOL).code
        under = self.let(f"{t} < {f(-hi if signed else 0.0)}", _BOOL).code
        safe = self.let(f"tl.where(({t} != {t}) | {over} | {under}, {f(0.0)}, {t})", _F64).code
        if dt == _U64:
            top = self.let(f"{safe} >= {f(2.0 ** 63)}", _BOOL).code
            low = self.let(f"tl.where({top}, {safe} - {f(2.0 ** 63)}, {safe}).to(tl.int64)", _I64).code
            out = self.let(f"tl.where({top}, {low} ^ {self.full(-(1 << 63), _I64)}, {low})", _I64).code
            return self.let(f"tl.where({over}, {self.full(-1, _I64)}, "
                            f"tl.where({under}, {self.full(0, _I64)}, {out}))", _I64).code
        info = np.iinfo(dt)
        r = self.let(f"{safe}.to(tl.int64)", _I64).code
        r = self.let(f"tl.where({over}, {self.full(int(info.max), _I64)}, "
                     f"tl.where({under}, {self.full(int(info.min), _I64)}, {r}))", _I64).code
        return self.let(f"{r}.to({_TL[dt]})", dt).code  # a uint16/32 wraps to its bits

    def operands(self, l, r, ct) -> tuple[str, str]:
        return self.conv(l, ct), self.conv(r, ct)

    # -- integer and float arithmetic with JAX's edge results ------------

    def udivrem(self, a: str, b: str, dt, rem: bool) -> SV:
        """lax.div (x / 0 = the type's max) or lax.rem (x % 0 = x) of two
        uint16/32/64 operands, read unsigned."""
        ua, ub = self.unsigned(a, dt), self.unsigned(b, dt)
        zero = self.let(f"{ub} == 0", _BOOL).code
        bs = self.let(f"tl.where({zero}, {self.full(1, dt)}, {b})", dt).code
        q = self.let(f"({ua} {'%' if rem else '//'} {self.unsigned(bs, dt)})"
                     f".to({_TL[dt]}, bitcast=True)", dt).code
        return self.let(f"tl.where({zero}, {a if rem else self.full(-1, dt)}, {q})", dt)

    def lax_div(self, a: str, b: str, dt) -> SV:
        if dt in UNSIGNED_BITS:
            return self.udivrem(a, b, dt, rem=False)
        c = lambda v: self.full(v, dt)  # noqa: E731
        zero = self.let(f"{b} == {c(0)}", _BOOL).code
        neg1 = self.let(f"{b} == {c(-1)}", _BOOL).code if dt.kind == "i" else None
        odd = f"({zero} | {neg1})" if neg1 else zero
        bs = self.let(f"tl.where({odd}, {c(1)}, {b})", dt).code
        q = self.let(f"{a} // {bs}", dt).code
        if neg1:
            q = self.let(f"tl.where({neg1}, {c(0)} - {a}, {q})", dt).code
        fill = -1 if dt.kind == "i" else int(np.iinfo(dt).max)
        return self.let(f"tl.where({zero}, {c(fill)}, {q})", dt)

    def lax_rem(self, a: str, b: str, dt) -> SV:
        if dt in UNSIGNED_BITS:
            return self.udivrem(a, b, dt, rem=True)
        c = lambda v: self.full(v, dt)  # noqa: E731
        zero = self.let(f"{b} == {c(0)}", _BOOL).code
        neg1 = self.let(f"{b} == {c(-1)}", _BOOL).code if dt.kind == "i" else None
        odd = f"({zero} | {neg1})" if neg1 else zero
        bs = self.let(f"tl.where({odd}, {c(1)}, {b})", dt).code
        r = self.let(f"{a} % {bs}", dt).code
        if neg1:
            r = self.let(f"tl.where({neg1}, {c(0)}, {r})", dt).code
        return self.let(f"tl.where({zero}, {a}, {r})", dt)

    def isign(self, x: str, dt) -> str:
        c = lambda v: self.full(v, dt)  # noqa: E731
        return self.let(f"tl.where({x} > {c(0)}, {c(1)}, tl.where({x} < {c(0)}, {c(-1)}, {c(0)}))",
                        dt).code

    def fsign(self, x: str, dt) -> str:
        """expr._fsign: copysign(x != 0, x) with x read flushed, NaN kept."""
        nz = self.let(f"({self.flush(x, dt)} != {self.full(0.0, dt)}).to({_TL[dt]})", dt).code
        return self.let(f"tl.where({x} != {x}, {x}, {self.in_f32('copysign', dt, nz, x)})",
                        dt).code

    def dnan(self, dt) -> str:
        ib = _IB[dt.itemsize]
        return f"tl.full([BLOCK], {default_nan_bits(dt)}, {_TL[ib]}).to({_TL[dt]}, bitcast=True)"

    def quiet(self, x: str, dt) -> str:
        ib = _IB[dt.itemsize]
        return f"({x}.to({_TL[ib]}, bitcast=True) | {self.full(quiet_bit(dt), ib)}).to({_TL[dt]}, bitcast=True)"

    def nanfix(self, r: str, dt, *ops: str) -> str:
        """expr.nan_fix: each NaN of ``r`` becomes x86's NaN for an operation
        over ``ops``: the first NaN operand quieted, else the default NaN."""
        fix = self.dnan(dt)
        for o in reversed(ops):
            fix = f"tl.where({o} != {o}, {self.quiet(o, dt)}, {fix})"
        return self.let(f"tl.where({r} != {r}, {fix}, {r})", dt).code

    def op(self, code: str, dt, *ops: str, weak: bool = False) -> SV:
        """A float operation's result, NaN-fixed (integers pass through)."""
        r = self.let(code, dt, weak)
        if np.dtype(dt).kind != "f":
            return r
        return SV(self.nanfix(r.code, dt, *ops), dt, weak)

    def fmod(self, a: str, b: str, dt, pow2: bool = False) -> str:
        """libdevice fmod (exact) with the divisor read flushed, NaN-fixed,
        as expr.fmod_torch; with ``pow2`` the dividend read flushed and its
        sign bit copied onto the result."""
        b = self.flush(b, dt)
        sign_of = a
        if pow2:
            a = self.flush(a, dt)
        r = self.op(self.in_f32("fmod", dt, a, b), dt, a, b).code
        return self.copysign_bits(r, sign_of, dt) if pow2 else r

    _COPYSIGN = {2: ("h", "b16", "0x7FFF", "0x8000"), 4: ("r", "b32", "0x7FFFFFFF", "0x80000000"),
                 8: ("l", "b64", "0x7FFFFFFFFFFFFFFF", "0x8000000000000000")}

    def copysign_bits(self, x: str, s: str, dt) -> str:
        """``x`` with the sign bit of ``s``, on the bits in inline PTX: LLVM
        turns and/or on a float's bits into copysign, which writes the
        card's canonical NaN."""
        c, b, rest, top = self._COPYSIGN[dt.itemsize]
        ib = _TL[_IB[dt.itemsize]]
        asm = (f"{{ .reg .{b} t; and.{b} $0, $1, {rest}; and.{b} t, $2, {top}; "
               f"or.{b} $0, $0, t; }}")
        return self.let(f'tl.inline_asm_elementwise("{asm}", "={c},{c},{c}", '
                        f"[{x}.to({ib}, bitcast=True), {s}.to({ib}, bitcast=True)], dtype={ib}, "
                        f"is_pure=True, pack=1).to({_TL[dt]}, bitcast=True)", dt).code

    def float_convert(self, x: str, dt, src=None) -> str:
        """float32 <-> float64 and float16 <-> float32 as
        expr._float_convert: round to nearest, a NaN keeps its sign and the
        top of its payload, quieted."""
        r = self.let(f"{x}.to({_TL[dt]})", dt).code
        if dt == _F16:
            b = self.let(f"{x}.to(tl.int32, bitcast=True)", np.dtype(np.int32)).code
            nan = (f"((({b} >> 16) & 0x8000) | 0x7E00 | (({b} >> 13) & 0x3FF))"
                   f".to(tl.int16).to(tl.float16, bitcast=True)")
        elif src == _F16:
            b = self.let(f"{x}.to(tl.int16, bitcast=True).to(tl.int32) & 0xFFFF",
                         np.dtype(np.int32)).code
            nan = (f"((({b} & 0x8000) << 16) | 0x7FC00000 | (({b} & 0x3FF) << 13))"
                   f".to(tl.float32, bitcast=True)")
        elif dt == _F64:
            b = self.let(f"{x}.to(tl.int32, bitcast=True).to(tl.int64) & "
                         f"{self.full(0xFFFFFFFF, _I64)}", _I64).code
            nan = (f"(((({b} & {self.full(0x80000000, _I64)}) << 32) | "
                   f"{self.full(0x7FF8000000000000, _I64)}) | (({b} & {self.full(0x7FFFFF, _I64)}) << 29))"
                   f".to(tl.float64, bitcast=True)")
        else:
            b = self.let(f"{x}.to(tl.int64, bitcast=True)", _I64).code
            n64 = (f"((({b} >> 32) & {self.full(0x80000000, _I64)}) | {self.full(0x7FC00000, _I64)}) "
                   f"| (({b} >> 29) & {self.full(0x7FFFFF, _I64)})")
            nan = f"({n64}).to(tl.int32).to(tl.float32, bitcast=True)"
        return self.let(f"tl.where({x} != {x}, {nan}, {r})", dt).code

    def floordiv(self, a: str, b: str, dt, weak: bool, rec: Optional[float] = None,
                 pow2: bool = False) -> SV:
        if dt.kind == "u":
            q = self.lax_div(a, b, dt)
            return SV(q.code, dt, weak)
        if dt.kind == "i":
            q = self.lax_div(a, b, dt).code
            rem = self.lax_rem(a, b, dt).code
            fix = self.let(f"({self.isign(a, dt)} != {self.isign(b, dt)}) & "
                           f"({rem} != {self.full(0, dt)})", _BOOL).code
            return self.let(f"tl.where({fix}, {q} - {self.full(1, dt)}, {q})", dt, weak)
        mod = self.fmod(a, b, dt, pow2)
        num = self.farith("-", a, mod, dt).code
        div = (self.farith("/", num, b, dt) if rec is None
               else self.farith("*", num, self.full(rec, dt), dt)).code
        ind = self.let(f"({self.flush(mod, dt)} != {self.full(0.0, dt)}) & "
                       f"({self.fsign(b, dt)} != {self.fsign(mod, dt)})", _BOOL).code
        dm1 = self.farith("-", div, self.full(1.0, dt), dt).code
        div = self.flush(self.let(f"tl.where({ind}, {dm1}, {div})", dt).code, dt)
        return self.op(self.in_f32("round", dt, div), dt, div, weak=weak)

    def mod(self, a: str, b: str, dt, weak: bool, pow2: bool = False) -> SV:
        if dt in UNSIGNED_BITS:  # read unsigned: the remainder, x % 0 = 0
            ua, ub = self.unsigned(a, dt), self.unsigned(b, dt)
            bs = self.unsigned(self.let(f"tl.where({ub} == 0, {self.full(1, dt)}, {b})", dt).code, dt)
            return self.let(f"({ua} % {bs}).to({_TL[dt]}, bitcast=True)", dt, weak)
        z = self.full(0, dt)
        if dt.kind in "iu":
            b = self.let(f"tl.where({b} == {z}, {self.full(1, dt)}, {b})", dt).code
            tm = self.lax_rem(a, b, dt).code
            plus = self.let(f"(({tm} < {z}) != ({b} < {z})) & ({tm} != {z})", _BOOL).code
            return self.let(f"tl.where({plus}, {tm} + {b}, {tm})", dt, weak)
        tm = self.fmod(a, b, dt, pow2)
        ft, fb = self.flush(tm, dt), self.flush(b, dt)
        plus = self.let(f"(({ft} < {z}) != ({fb} < {z})) & ({ft} != {z})", _BOOL).code
        r = self.let(f"tl.where({plus}, {self.farith('+', tm, b, dt).code}, {tm})", dt).code
        r = self.let(f"tl.where({self.flush(r, dt)} == {z}, {self.in_f32('copysign', dt, z, b)}, "
                     f"{r})", dt).code
        return SV(r, dt, weak)

    # -- expression nodes -------------------------------------------------

    def binop(self, op: str, l, r, fuse=None) -> SV:
        if not isinstance(l, SV) and not isinstance(r, SV):
            l = self.value(l)
        lt, rt = _ty(l), _ty(r)
        if op == "/" and _int_operand(l) and _int_operand(r):
            ct = int_div_type(lt, rt)
            if ct.kind == "f":
                return self.float_binop("/", l, r, ct, False, None)
            a, b = self.operands(l, r, ct)
            return self.lax_div(a, b, ct)
        ct, rdt, weak = binop_type(op, lt, rt)
        if op in ("and", "or"):
            a, b = self.operands(l, r, _BOOL)
            return self.let(f"{a} {'&' if op == 'and' else '|'} {b}", _BOOL)
        if ct.kind == "f":
            return self.float_binop(op, l, r, ct, weak, fuse)
        a, b = self.operands(l, r, ct)
        if op == "%":
            return self.mod(a, b, ct, weak)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            if ct == _BOOL:  # compare bools as 0/1, never as signed 1-bit integers
                a, b = f"{a}.to(tl.int8)", f"{b}.to(tl.int8)"
            elif ct in UNSIGNED_BITS:
                a, b = self.unsigned(a, ct), self.unsigned(b, ct)
            return self.let(f"{a} {op} {b}", _BOOL)
        if ct == _BOOL:
            return self.let(f"{a} {'|' if op == '+' else '&'} {b}", ct, weak)
        return self.let(f"{a} {op} {b}", ct, weak)

    def float_binop(self, op: str, l, r, ct, weak: bool, fuse) -> SV:
        """expr._float_binop: XLA's simplifier first, then the operation
        with flushed operands, a contraction where the site allows one."""
        rw = literal_rewrite(op, l, r, ct) if op in ("+", "-", "*", "/") else None
        if rw is not None:
            kind, x = rw[0], rw[1]
            if kind == "same":
                return SV(self.conv(x, ct), ct, weak)
            if kind == "neg":
                v = self.conv(x, ct)
                return SV(self.flip_sign(SV(v, ct), clear=False), ct, weak, neg=v)
            if kind == "select":
                b = self.conv(x, _BOOL)
                return self.let(f"tl.where({b}, {self.conv(rw[2], ct)}, {self.full(0.0, ct)})",
                                ct, weak)
            return self.product(x, rw[2], ct, weak)
        if op == "*":
            return self.product(l, r, ct, weak)
        a, b = self.operands(l, r, ct)
        if op == "%":
            return self.mod(a, b, ct, weak, literal_pow2(r, ct, self.f16))
        if op in ("==", "!=", "<", "<=", ">", ">="):
            return self.let(f"{self.flush(a, ct)} {op} {self.flush(b, ct)}", _BOOL)
        if op in ("+", "-") and fuse is not None:
            for side, v, other in ((0, l, b), (1, r, a)):
                if fuse[side] and isinstance(v, SV) and v.prod is not None and v.dt == ct:
                    x, y, neg_x = v.prod
                    neg_z = op == "-" and side == 0
                    if op == "-" and side == 1:
                        neg_x = not neg_x
                    return self.fma(x, y, other, ct, weak, neg_x, neg_z)
        if op in ("+", "-"):
            folded = fold_negation(op, l, r, a, b, ct)
            if folded is not None:
                return self.farith(*folded, ct, weak)
        return self.farith(op, a, b, ct, weak)

    def product(self, l, r, ct, weak: bool) -> SV:
        """expr._product: a float multiply keeping its flushed operands for
        a contraction (not a multiply by 2.0, which LLVM makes x + x)."""
        two = any(not isinstance(v, SV) and scalar_as(v, ct) == 2.0 for v in (l, r))
        a, b = self.operands(l, r, ct)
        a, b = self.flush(a, ct), self.flush(b, ct)
        if ct == _F16:  # in float32, rounded once; it contracts only under F16_NATIVE
            r = self.farith("*", a, b, ct, weak)
            keep = not two and self.f16 == F16_NATIVE
            return SV(r.code, ct, weak, (a, b, False) if keep else None)
        r = self.op(f"{a} * {b}", ct, a, b)
        return SV(self.flush(r.code, ct), ct, weak, None if two else (a, b, False))

    def fma(self, x: str, y: str, z: str, dt, weak: bool, neg_x: bool, neg_z: bool) -> SV:
        """expr.fma_torch of (-x if neg_x, y, -z if neg_z): one rounding
        (fma.rn; float16 by fma16), operands read flushed, the result
        NaN-fixed (a NaN operand with its own sign) and flushed."""
        x, y, z = self.flush(x, dt), self.flush(y, dt), self.flush(z, dt)
        vx = self.flip_sign(SV(x, dt), clear=False) if neg_x else x
        vz = self.flip_sign(SV(z, dt), clear=False) if neg_z else z
        if dt == _F16:
            r = self.fma16(vx, y, vz)
        else:
            r = self.let(f"tl.fma({vx}, {y}, {vz})", dt).code
        fix = self.dnan(dt)
        for o in reversed((x, y, z)):  # a NaN operand with its own sign
            fix = f"tl.where({o} != {o}, {self.quiet(o, dt)}, {fix})"
        r = self.let(f"tl.where({r} != {r}, {fix}, {r})", dt).code
        return SV(self.flush(r, dt), dt, weak)

    def fma16(self, x: str, y: str, z: str) -> str:
        """float16 fma as expr.fma_torch's: the product exact in float32, the
        sum rounded to odd (two-sum, then a step of the last bit toward the
        error), then rounded once to float16."""
        p = self.let(f"{x}.to(tl.float32) * {y}.to(tl.float32)", _F32).code
        zf = self.let(f"{z}.to(tl.float32)", _F32).code
        t = self.let(f"{p} + {zf}", _F32).code
        bb = self.let(f"{t} - {p}", _F32).code
        e = self.let(f"({p} - ({t} - {bb})) + ({zf} - {bb})", _F32).code
        tb = self.let(f"{t}.to(tl.int32, bitcast=True)", np.dtype(np.int32)).code
        zero = self.full(0.0, _F32)
        step = self.let(f"({e} != {zero}) & (({tb} & 1) == 0) & ({t} == {t}) & ({e} == {e})",
                        _BOOL).code
        up = self.let(f"({e} > {zero}) == ({t} > {zero})", _BOOL).code
        odd = self.let(f"tl.where({step}, tl.where({up}, {tb} + 1, {tb} - 1), {tb})",
                       np.dtype(np.int32)).code
        return self.let(f"{odd}.to(tl.float32, bitcast=True).to(tl.float16)", _F16).code

    def floordiv_node(self, l, r) -> SV:
        if not isinstance(l, SV) and not isinstance(r, SV):
            l = self.value(l)
        ct, weak = floordiv_type(_ty(l), _ty(r))
        a, b = self.operands(l, r, ct)
        return self.floordiv(a, b, ct, weak, literal_reciprocal(r, ct),
                             literal_pow2(r, ct, self.f16))

    def where(self, cond, x, y, minmax: bool = False) -> SV:
        if not isinstance(x, SV) and not isinstance(y, SV):
            x = self.value(x)
        dt, weak = promote(_ty(x), _ty(y))
        if dt not in _TL:
            raise TypeError(f"CASE over {dt}: not in the segment kernel")
        a, b = self.operands(x, y, dt)
        c = self.conv(cond, _BOOL)
        out = self.let(f"tl.where({c}, {a}, {b})", dt, weak)
        if minmax and dt.kind == "f" and all(isinstance(v, SV) and v.dt == dt for v in (x, y)):
            return SV(self.flush(out.code, dt), dt, weak)
        return out

    def flip_sign(self, x: SV, clear: bool) -> str:
        """Float neg (sign flipped) or abs (sign cleared) on the bits."""
        if x.dt == _F16:
            # LLVM turns these bit operations into neg.f16 / abs.f16, which
            # write the canonical NaN; inline PTX keeps a NaN's bits
            asm = "and.b16 $0, $1, 0x7FFF;" if clear else "xor.b16 $0, $1, 0x8000;"
            return self.let(f'tl.inline_asm_elementwise("{asm}", "=h,h", '
                            f"[{x.code}.to(tl.int16, bitcast=True)], dtype=tl.int16, "
                            f"is_pure=True, pack=1).to(tl.float16, bitcast=True)",
                            x.dt, x.weak).code
        ib = _IB[x.dt.itemsize]
        top = -(1 << (ib.itemsize * 8 - 1))
        mask = self.full(~top if clear else top, ib)
        op = "&" if clear else "^"
        return self.let(f"({x.code}.to({_TL[ib]}, bitcast=True) {op} {mask}).to({_TL[x.dt]}, bitcast=True)",
                        x.dt, x.weak).code

    def eval(self, e, cols):
        """The node's value: an SV, or a Python scalar for a literal (as
        eval_jnp returns the literal itself)."""
        if isinstance(e, Col):
            return cols[e.name]
        if isinstance(e, Lit):
            if not isinstance(e.value, (bool, int, float)):
                raise TypeError(f"non-numeric literal {e.value!r}")
            return e.value
        if isinstance(e, BinOp):
            return self.binop(e.op, self.eval(e.left, cols), self.eval(e.right, cols),
                              fuse=self.sites.get(id(e)))
        if isinstance(e, Not):
            c = self.conv(self.value(self.eval(e.inner, cols)), _BOOL)
            return self.let(f"tl.where({c}, {self.full(0, _BOOL)}, {self.full(1, _BOOL)})", _BOOL)
        if isinstance(e, Neg):
            v = self.eval(e.inner, cols)
            if not isinstance(v, SV):
                return -v
            unary_type("neg", v.dt)
            if v.dt.kind == "f":
                prod = None if v.prod is None else (v.prod[0], v.prod[1], not v.prod[2])
                return SV(self.flip_sign(v, clear=False), v.dt, v.weak, prod, neg=v.code)
            return self.let(f"{self.full(0, v.dt)} - {v.code}", v.dt, v.weak)
        if isinstance(e, Cast):
            if e.dtype not in CAST_TARGETS:
                raise TypeError(f"cast to {e.dtype}")
            dt = CAST_TARGETS[e.dtype]
            v = self.value(self.eval(e.inner, cols))
            return SV(self.conv(v, dt), dt)
        if isinstance(e, Case):
            if e.otherwise is None:
                raise TypeError("CASE without ELSE")
            result = self.eval(e.otherwise, cols)
            other = e.otherwise
            for cond, val in reversed(e.branches):
                result = self.where(self.eval(cond, cols), self.eval(val, cols), result,
                                    minmax=is_minmax_select(cond, val, other))
                other = None
            return result
        if isinstance(e, Func):
            return self.func(e, [self.eval(a, cols) for a in e.args])
        raise TypeError(f"expression {type(e).__name__}")

    def func(self, e, a) -> SV:
        name = e.name
        if name == "abs":
            v = self.value(a[0])
            unary_type("abs", v.dt)
            if v.dt.kind in "bu":
                return v  # abs of an unsigned value is the value
            if v.dt.kind == "f":
                return SV(self.flip_sign(v, clear=True), v.dt, v.weak)
            z = self.full(0, v.dt)
            return self.let(f"tl.where({v.code} < {z}, {z} - {v.code}, {v.code})", v.dt, v.weak)
        if name in ("floor", "ceil", "sqrt"):
            v = self.value(a[0])
            dt, weak = unary_type(name, v.dt, v.weak)
            if dt == v.dt and dt.kind == "b":
                return v
            x = self.flush(self.conv(v, dt), dt)
            fn = "sqrt_rn" if name == "sqrt" else name
            # a negative operand's NaN becomes the default NaN in the fix
            return self.op(self.in_f32(fn, dt, x), dt, x, weak=weak)
        if name == "extract_epoch":
            return self.floordiv_node(a[0], 1_000_000)
        if name == "date_trunc_micros":
            return self.binop("*", self.floordiv_node(a[1], a[0]), a[0])
        if name == "to_timestamp_micros":
            v = self.value(a[0])
            return SV(self.conv(v, _I64), _I64)
        raise TypeError(f"function {name}() has no device evaluation")

    def hash_column(self, v: SV) -> str:
        if v.dt.kind == "f":
            f = self.flush(v.code, v.dt)  # a subnormal key hashes as 0.0 (XLA reads it flushed)
            x = self.let(f"tl.where({f} == {self.full(0.0, v.dt)}, {self.full(0.0, v.dt)}, "
                         f"{f})", v.dt).code
            if v.dt != _F64:
                x = self.conv(SV(x, v.dt), _F64)
            bits = f"{x}.to(tl.uint64, bitcast=True)"
        else:
            if v.dt not in _TL:
                raise TypeError(f"hash of dtype {v.dt}")
            bits = f"{self.conv(v, _I64)}.to(tl.uint64, bitcast=True)"
        return self.let(f"_splitmix64({bits})", _U64).code


_HEADER = '''"""Generated from a bound segment plan by arroyo_tpu_torch/ops/segment_kernel.py.

Plan: {summary}
"""
import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _splitmix64(x):
    # x: uint64, so the shifts are logical and the multiplies wrap
    z = x + 0x9E3779B97F4A7C15
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB
    return z ^ (z >> 31)


@triton.jit
def _max_nan(a, b):
    return tl.maximum(a, b, propagate_nan=tl.PropagateNan.ALL)
'''


def generate(plan, in_dtypes, sites: Optional[dict] = None, f16_model: Optional[str] = None
             ) -> tuple[str, dict[str, np.dtype], list[np.dtype], bool]:
    """Triton source of K4 for a bound plan. Returns (source, output dtypes,
    watermark dtypes, has_mask). Raises TypeError where a node or dtype is
    outside the kernel (the segment then falls back, as it would in the
    JAX package for a trace failure). ``sites`` is the plan's
    ``contraction_table``, ``f16_model`` the float16 model (None: the
    host's, ``expr.float16_model``)."""
    g = _Gen(contraction_table(plan) if sites is None else sites, f16_model or float16_model())
    for dt in in_dtypes:
        if dt not in _TL:
            raise TypeError(f"input column of dtype {dt}: not a dtype of the segment kernel")
    cols: dict[str, Any] = {}
    loads = []
    for k, (name, dt) in enumerate(zip(plan.traced_in, in_dtypes)):
        loads.append(f"in{k} = tl.load(in{k}_ptr + offs, mask=inb, other=0)")
        cols[name] = SV(f"in{k}", dt)
    base = g.let("offs < n", _BOOL).code
    valid: Optional[str] = None
    wm: list[tuple[SV, str]] = []
    outs: dict[str, SV] = {}
    for si, st in enumerate(plan.stages):
        m = st.member
        if st.kind == "value":
            hoisted = si == 0 and plan.prefilter is not None
            if m.filter is not None and not hoisted:
                f = g.conv(g.value(g.eval(m.filter, cols)), _BOOL)
                valid = g.let(f"{base if valid is None else valid} & {f}", _BOOL).code
            if m.projections is not None:
                new = {name: g.value(g.eval(e, cols)) for name, e in m.projections}
                for carried in (TIMESTAMP_FIELD, KEY_FIELD, "_is_retract"):
                    if carried not in new and carried in cols:
                        new[carried] = cols[carried]
                cols = new
        elif st.kind == "key":
            h = None
            for name, e in m.keys:
                c = g.value(g.eval(e, cols))
                cols[name] = c
                h2 = g.hash_column(c)
                h = h2 if h is None else g.let(
                    f"_splitmix64({h} ^ ({h2} + 0x9E3779B97F4A7C15))", _U64).code
            cols[KEY_FIELD] = SV(g.let(f"{h}.to(tl.int64, bitcast=True)", _U64).code, _U64)
        elif st.kind == "wm":
            vals = g.value(g.eval(m.expr, cols))
            floor = g.full(dtype_floor(vals.dt), vals.dt)
            eff = base if valid is None else valid
            wm.append((vals, g.let(f"tl.where({eff}, {g.flush(vals.code, vals.dt)}, {floor})",
                                   vals.dt).code))
            g.lines.append(f"c{len(wm) - 1} = tl.sum({eff}.to(tl.int64), axis=0)")
        else:  # insert
            outs["__bins"] = g.floordiv_node(cols[TIMESTAMP_FIELD], insert_step(m))
            if plan.insert_has_key:
                outs["__hash"] = SV(g.conv(cols[KEY_FIELD], _U64), _U64)
            for i, (inp, dt) in enumerate(zip(m.acc_inputs, m.acc_dtypes)):
                if inp is not None:
                    dt = np.dtype(dt)
                    outs[f"__val{i}"] = SV(g.conv(g.value(g.eval(inp, cols)), dt), dt)
    if plan.emits_batch:
        for name in plan.traced_out:
            outs[name] = g.value(cols[name])
    out_dt = {name: outs[name].dt for name in plan.traced_out}
    has_mask = valid is not None
    args = (["n", "P"] + [f"in{k}_ptr" for k in range(len(plan.traced_in))]
            + [f"out{k}_ptr" for k in range(len(plan.traced_out))]
            + (["mask_ptr"] if has_mask else [])
            + [f"{x}{j}_ptr" for j in range(len(wm)) for x in ("pmax", "pcnt", "amax", "acnt")]
            + (["ticket_ptr", "G"] if wm else []))
    body = ["pid = tl.program_id(0)",
            "offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)",
            "inb = offs < P", *loads, *g.lines]
    stores = [f"tl.store(out{k}_ptr + offs, {outs[name].code}, mask=inb)"
              for k, name in enumerate(plan.traced_out)]
    if has_mask:
        stores.append(f"tl.store(mask_ptr + offs, {valid}, mask=inb)")
    if not wm:
        body += stores
    for j, (vals, masked) in enumerate(wm):
        body.append(f"tl.store(pmax{j}_ptr + pid, {_max_code(vals.dt, masked)})")
        body.append(f"tl.store(pcnt{j}_ptr + pid, c{j})")
    if wm:
        # the fold: every program's partials are stored before its ticket
        # (the barrier, then the ticket's release), and its outputs after
        # it, so the last program's fold overlaps the other programs'
        # output stores; the program holding the last ticket (its acquire)
        # reads the G partials past L1, in program order, and sets the
        # counter back to 0 for the next launch
        body += ["tl.debug_barrier()",
                 'ticket = tl.atomic_add(ticket_ptr, 1, sem="acq_rel")',
                 *stores,
                 "if ticket == G - 1:"]
        fold = []
        for j, (vals, _m) in enumerate(wm):
            fold += [f"fm{j} = {_Gen.full(dtype_floor(vals.dt), vals.dt)}",
                     f"fc{j} = tl.zeros([BLOCK], tl.int64)"]
        fold += ["for fs in range(0, G, BLOCK):",
                 "    fo = fs + tl.arange(0, BLOCK)",
                 "    fok = fo < G"]
        for j, (vals, _m) in enumerate(wm):
            floor = _Gen.full(dtype_floor(vals.dt), vals.dt)
            fold += [f'    fx = tl.load(pmax{j}_ptr + fo, mask=fok, other=0, cache_modifier=".cg")',
                     f"    fm{j} = {_max_code(vals.dt, f'fm{j}', f'tl.where(fok, fx, {floor})')}",
                     f'    fc{j} += tl.load(pcnt{j}_ptr + fo, mask=fok, other=0, cache_modifier=".cg")']
        for j, (vals, _m) in enumerate(wm):
            fold += [f"tl.store(amax{j}_ptr, {_max_code(vals.dt, f'fm{j}')})",
                     f"tl.store(acnt{j}_ptr, tl.sum(fc{j}, axis=0))"]
        fold.append("tl.store(ticket_ptr, 0)")
        body += [f"    {ln}" for ln in fold]
    src = [_HEADER.format(summary=_summary(plan, in_dtypes)), "",
           '@triton.jit(do_not_specialize=["n", "G"])' if wm
           else '@triton.jit(do_not_specialize=["n"])',
           f"def segment_fused_kernel({', '.join(args)}, BLOCK: tl.constexpr):"]
    src += [f"    {ln}" for ln in body]
    return "\n".join(src) + "\n", out_dt, [v.dt for v, _ in wm], has_mask


def _max_code(dt: np.dtype, a: str, b: Optional[str] = None) -> str:
    """Code of the max of [BLOCK] values ``a`` and ``b`` of dtype ``dt``,
    or of ``a``'s lanes when ``b`` is None: NaN-propagating for floats,
    uint16/32/64 read unsigned and their max written back as signed bits
    (expr.max_bits). The cast back is an integer cast, not a bitcast:
    tl.max widens a uint16 to int32 (zero-extended) before it reduces."""
    if dt in UNSIGNED_BITS:
        u = [_Gen.unsigned(x, dt) for x in (a, b) if x is not None]
        m = f"tl.maximum({u[0]}, {u[1]})" if b is not None else f"tl.max({u[0]}, axis=0)"
        return f"{m}.to({_TL[dt]})"
    if b is not None:
        return f"_max_nan({a}, {b})" if dt.kind == "f" else f"tl.maximum({a}, {b})"
    return f"tl.reduce({a}, 0, _max_nan)" if dt.kind == "f" else f"tl.max({a}, axis=0)"


def _summary(plan, in_dtypes) -> str:
    stages = ", ".join(st.kind for st in plan.stages)
    ins = ", ".join(f"{n}:{d}" for n, d in zip(plan.traced_in, in_dtypes))
    return (f"stages [{stages}]; in [{ins}]; out {plan.traced_out}; "
            f"hoisted filter: {plan.prefilter is not None}")


# ------------------------------------------------------------ program



class OutLayout(NamedTuple):
    """Where the kernel writes a P-row batch in its packed buffer: each
    traced output ``(name, offset, dtype)`` ([P] values), the mask's offset
    (None without an in-trace filter), and each watermark stage's (max
    offset, max dtype, count offset), one value each; ``wm_offset`` is
    where the watermark part starts, so the bytes from it on hold every
    stage's result."""

    nbytes: int
    outs: list
    mask: Optional[int]
    wm: list
    wm_offset: int


class SegmentProgram:
    """A bound plan lowered for the device: input dtypes, the kernel's
    generated source and the dtypes of what it writes. Built on the host
    (no triton import), so the CPU path takes exactly the plans the kernel
    takes; the Triton module is loaded at the first CUDA launch. On the
    card it also holds, per (device, stream), the fold's ticket counter and
    partials (``_fold_state``): chained tasks call one program from
    several threads."""

    def __init__(self, plan, in_dtypes, f16_model: Optional[str] = None):
        self.plan = plan
        self.in_dtypes = [np.dtype(d) for d in in_dtypes]
        self.sites = contraction_table(plan)
        # the float16 model is a constant of the program: the kernel's source
        # and its plain version both follow it (None: the host's)
        self.f16_model = f16_model or float16_model()
        self.source, self.out_dtypes, self.wm_dtypes, self.has_mask = generate(
            plan, self.in_dtypes, self.sites, self.f16_model)
        self.digest = hashlib.sha256(self.source.encode()).hexdigest()[:16]
        self._module = None
        self._fold: dict = {}
        self._fold_lock = threading.Lock()
        self._in_layouts: dict = {}  # P -> in_layout(P)
        self._out_layouts: dict = {}  # P -> out_layout(P)

    def module(self):
        """The generated module, written under build/segment/ and imported
        (Triton compiles each kernel at its first launch)."""
        if self._module is not None:
            return self._module
        with _build_lock:
            if self._module is None:
                os.environ.setdefault("TRITON_CACHE_DIR", str(_PKG / "build" / "triton"))
                import triton  # noqa: F401 - imported here: the CPU tests lack triton

                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                path = BUILD_DIR / f"segment_{self.digest}.py"
                if not path.exists():
                    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                    tmp.write_text(self.source)
                    os.replace(tmp, path)
                spec = importlib.util.spec_from_file_location(f"arroyo_segment_{self.digest}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                self._module = mod
        return self._module

    # -- the batch's bytes ------------------------------------------------

    def in_layout(self, P: int) -> tuple[int, list[int]]:
        """(bytes, offsets) of the staged input columns of a P-row batch."""
        lay = self._in_layouts.get(P)
        if lay is None:
            lay = self._in_layouts[P] = staging.aligned(P * dt.itemsize for dt in self.in_dtypes)
        return lay

    def out_layout(self, P: int) -> OutLayout:
        lay = self._out_layouts.get(P)
        if lay is None:
            lay = self._out_layouts[P] = self._out_layout(P)
        return lay

    def _out_layout(self, P: int) -> OutLayout:
        names = list(self.plan.traced_out)
        sizes = [P * np.dtype(self.out_dtypes[k]).itemsize for k in names]
        if self.has_mask:
            sizes.append(P)
        for dt in self.wm_dtypes:
            sizes += [dt.itemsize, 8]
        nbytes, offs = staging.aligned(sizes)
        outs = [(k, offs[i], storage_dtype(np.dtype(self.out_dtypes[k]))) for i, k in enumerate(names)]
        i = len(names)
        mask = None
        if self.has_mask:
            mask, i = offs[i], i + 1
        wm = [(offs[i + 2 * j], self.wm_dtypes[j], offs[i + 2 * j + 1])
              for j in range(len(self.wm_dtypes))]
        return OutLayout(nbytes, outs, mask, wm, offs[i] if wm else nbytes)

    def carve(self, packed: torch.Tensor, P: int):
        """The kernel's outputs as views of ``packed``: (outs {name: [P]
        tensor, uint64 as int64 bits}, mask or None, aux [(max, count)] of
        0-d tensors)."""
        lay = self.out_layout(P)
        typed: dict = {}  # the buffer as each dtype (every part is aligned to its size)

        def as_dt(dt):
            t = typed.get(dt)
            if t is None:
                t = typed[dt] = packed.view(TORCH_DTYPES[dt])
            return t

        outs = {k: as_dt(dt)[off // dt.itemsize: off // dt.itemsize + P] for k, off, dt in lay.outs}
        mask = None if lay.mask is None else as_dt(_BOOL)[lay.mask: lay.mask + P]
        aux = [(as_dt(dt)[mo // dt.itemsize], as_dt(_I64)[co // 8]) for mo, dt, co in lay.wm]
        return outs, mask, aux

    def unpack(self, host: np.ndarray, P: int):
        """A host copy of the packed buffer (uint8) as the segment function
        returns it: (outs {name: [P] array, uint64 as uint64}, mask or None,
        aux: max, count, ... as 0-d arrays)."""
        lay = self.out_layout(P)
        outs = {}
        for k, off, dt in lay.outs:
            a = host[off: off + P * dt.itemsize].view(dt)
            dt = np.dtype(self.out_dtypes[k])
            outs[k] = a.view(dt) if dt in UNSIGNED_BITS else a
        mask = None if lay.mask is None else host[lay.mask: lay.mask + P].view(np.bool_)
        return outs, mask, self.unpack_wm(host[lay.wm_offset:], P)

    def unpack_wm(self, tail: np.ndarray, P: int) -> tuple:
        """Each watermark stage's max and count (0-d arrays, flat; a
        uint16/32/64 max read unsigned) from the packed buffer's bytes at
        ``out_layout(P).wm_offset`` on."""
        lay = self.out_layout(P)
        out = []
        for mo, dt, co in lay.wm:
            mo, co = mo - lay.wm_offset, co - lay.wm_offset
            out += [tail[mo: mo + dt.itemsize].view(dt).reshape(()),
                    tail[co: co + 8].view(_I64).reshape(())]
        return tuple(out)

    def _fold_state(self, dev: torch.device, G: int):
        """The fold's ticket counter (int32, zero between launches: the
        last program of each launch resets it) and its partials (one max
        and one count array of at least G entries per watermark stage) for
        ``dev``'s current stream. One launch at a time uses them: launches
        on one stream run in order."""
        key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
        st = self._fold.get(key)
        if st is not None and st[2] >= G:
            return st[0], st[1]
        with self._fold_lock:
            st = self._fold.get(key)
            if st is None or st[2] < G:
                ticket = st[0] if st is not None else torch.zeros(1, dtype=torch.int32, device=dev)
                parts = []
                for dt in self.wm_dtypes:
                    parts += [torch.empty(G, dtype=TORCH_DTYPES[dt], device=dev),
                              torch.empty(G, dtype=torch.int64, device=dev)]
                st = self._fold[key] = (ticket, parts, G)
            return st[0], st[1]


def stage_inputs(prog: SegmentProgram, arrays: list, device: torch.device) -> list:
    """The batch's input columns (numpy, one length P) as the kernel's
    inputs on ``device``: packed into one host buffer (pinned for the
    card), each column at a 16-byte boundary (``prog.in_layout(P)``),
    copied to the card in one copy (``staging.stage``), and carved into
    [P] views (uint64 as int64 bits). On the CPU the views are of the host
    buffer itself."""
    P = len(arrays[0])
    cols = []
    for a, dt in zip(arrays, prog.in_dtypes):
        a = np.asarray(a)
        if len(a) != P or a.dtype != dt:
            raise ValueError(f"input of {a.dtype}[{len(a)}] where the plan stages {dt}[{P}]")
        cols.append(a.view(storage_dtype(dt)))
    return staging.stage(cols, device, [TORCH_DTYPES[dt] for dt in prog.in_dtypes])[0]


def _check_inputs(prog: SegmentProgram, n: int, inputs) -> torch.device:
    if len(inputs) != len(prog.in_dtypes) or not inputs:
        raise ValueError(f"{len(inputs)} inputs for a plan that reads {len(prog.in_dtypes)}")
    dev = inputs[0].device
    p = inputs[0].shape[0] if inputs[0].dim() == 1 else -1
    for t, dt in zip(inputs, prog.in_dtypes):
        if t.device != dev:
            raise ValueError(f"inputs on different devices: {t.device} vs {dev}")
        if t.dim() != 1 or t.shape[0] != p or not t.is_contiguous():
            raise ValueError("every input must be a contiguous 1-D tensor of one length")
        if t.dtype != TORCH_DTYPES[dt]:
            raise TypeError(f"input of dtype {t.dtype} where the plan reads {dt}")
    if not 0 <= n <= p:
        raise ValueError(f"n = {n} outside [0, {p}]")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: the segment runs on cuda or cpu")
    return dev


def segment_fused(prog: SegmentProgram, n: int, inputs: list[torch.Tensor],
                  out: Optional[torch.Tensor] = None):
    """Run the bound segment on one padded batch: (outs, mask, aux) as
    segment_plain gives them, each a view of one packed buffer laid out by
    ``prog.out_layout(P)``: ``out`` (uint8, that many bytes, on the inputs'
    device) when given, else one made here. CUDA tensors launch K4 (a build
    or launch error propagates); CPU tensors take the plain version, whose
    results are copied into the buffer."""
    dev = _check_inputs(prog, n, inputs)
    p = inputs[0].shape[0]
    nbytes = prog.out_layout(p).nbytes
    if out is not None and (out.dtype != torch.uint8 or out.dim() != 1 or out.numel() != nbytes
                            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint8 [{nbytes}] tensor on {dev}")
    packed = torch.empty(nbytes, dtype=torch.uint8, device=dev) if out is None else out
    outs, mask, aux = prog.carve(packed, p)
    if dev.type == "cpu":
        p_outs, p_mask, p_aux = segment_plain(prog, n, inputs)
        for k, t in outs.items():
            t.copy_(p_outs[k])
        if mask is not None:
            mask.copy_(p_mask)
        for (m, c), (pm, pc) in zip(aux, p_aux):
            m.copy_(pm)
            c.copy_(pc)
        return outs, mask, aux
    mod = prog.module()
    grid = max(1, -(-p // BLOCK))
    args = [n, p, *inputs, *outs.values()] + ([mask] if mask is not None else [])
    if aux:
        ticket, parts = prog._fold_state(dev, grid)
        for j, (m, c) in enumerate(aux):
            args += [parts[2 * j], parts[2 * j + 1], m, c]
        args += [ticket, grid]
    mod.segment_fused_kernel[(grid,)](*args, BLOCK=BLOCK, num_warps=NUM_WARPS,
                                      enable_fp_fusion=False)
    with _count_lock:
        segment_fused.launches += 1
        segment_fused.kernel_launches += 1
    return outs, mask, aux


def launch_counts() -> dict[str, int]:
    return {"segment_fused": segment_fused.launches}


def reset_launch_counts() -> None:
    segment_fused.launches = 0
    segment_fused.kernel_launches = 0


reset_launch_counts()
