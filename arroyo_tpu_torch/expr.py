"""Scalar expression engine (the port's copy of arroyo_tpu/expr.py).

The same AST nodes, each with two evaluations:

  - ``eval_np(cols, n)``: vectorized NumPy on host batches; the host
    operators (projection, filter, key, watermark) evaluate with it.
  - ``eval_torch(cols)``: the twin of arroyo_tpu's ``eval_jnp`` for the
    nodes the segment compiler admits (engine/segment.py
    ``expr_traceable``), over ``TVal``s (a torch tensor, its NumPy dtype and
    JAX's weak-type flag). Values AND result dtypes are those of jax.numpy
    in 64-bit mode on the CPU: JAX's type-promotion lattice (not torch's
    and not NumPy's), truncating integer ``lax.div`` with its defined
    results for a zero divisor and INT_MIN / -1, floor-sign ``%``, and
    saturating float-to-int conversion. It is the plain PyTorch version of
    the fused segment kernel (ops/segment_kernel.py), whose code generator
    takes every node's dtype from the same type functions below.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from functools import reduce
from typing import Any, Callable, Optional

import numpy as np
import torch


class Expr:
    """Base scalar expression node."""

    def eval_np(self, cols: dict[str, np.ndarray], n: int):
        raise NotImplementedError

    def eval_torch(self, cols: dict[str, "TVal"]):
        """Device twin of eval_np (see the module docstring); a node the
        segment compiler does not admit raises TypeError."""
        raise TypeError(f"{type(self).__name__} has no device evaluation")

    def columns(self) -> set[str]:
        """Set of input column names referenced."""
        raise NotImplementedError


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def eval_np(self, cols, n):
        return cols[self.name]

    def eval_torch(self, cols):
        return cols[self.name]

    def columns(self):
        return {self.name}

    def __repr__(self):
        return f"Col({self.name})"


@dataclass(frozen=True)
class Lit(Expr):
    value: Any  # python scalar (int/float/str/bool/None)

    def eval_np(self, cols, n):
        return self.value

    def eval_torch(self, cols):
        if not isinstance(self.value, (bool, int, float)):
            raise TypeError(f"non-numeric literal {self.value!r}")
        return self.value

    def columns(self):
        return set()

    def __repr__(self):
        return f"Lit({self.value!r})"


_NP_BINOPS: dict[str, Callable] = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "%": np.mod,
    "==": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "and": np.logical_and,
    "or": np.logical_or,
}


def _div(a, b):
    # SQL integer division truncates toward zero; numpy // floors.
    if _is_integer(a) and _is_integer(b):
        q = np.floor_divide(a, b)
        # nonnegative operands (the hot case: event-time micros / positive
        # window literals): floor == trunc, skip the 4-pass correction
        a_nonneg = (a.size == 0 or np.min(a) >= 0) if np.ndim(a) else a >= 0
        b_nonneg = (b.size == 0 or np.min(b) >= 0) if np.ndim(b) else b >= 0
        if a_nonneg and b_nonneg:
            return q
        r = np.mod(a, b)
        # correct floor -> trunc for mixed signs
        adjust = (r != 0) & ((np.sign(a if np.ndim(a) else np.asarray(a)) < 0) != (np.sign(b if np.ndim(b) else np.asarray(b)) < 0))
        return q + adjust
    return np.divide(a, b)


def _is_integer(x) -> bool:
    if isinstance(x, (bool, np.bool_)):
        return False
    if isinstance(x, (int, np.integer)):
        return True
    return hasattr(x, "dtype") and x.dtype.kind in "iu"


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def eval_np(self, cols, n):
        l = self.left.eval_np(cols, n)
        r = self.right.eval_np(cols, n)
        if self.op == "/":
            return _div(l, r)
        if self.op in ("==", "!=", "<", "<=", ">", ">=") and (
                _is_str(l) or _is_str(r)):
            # object operands (strings / outer-join null padding): SQL
            # three-valued logic — a NULL on either side compares as
            # unknown (NULL), for EVERY comparison op. Projections carry
            # the NULL through to the sink; filter sites coerce with
            # np.asarray(..., dtype=bool), where None lands as False, so
            # WHERE keeps its reject-unknown semantics.
            lo, ro = _as_obj(l, n), _as_obj(r, n)
            null = _null_mask(lo) | _null_mask(ro)
            if null.any():
                out = np.empty(n, dtype=object)
                out[:] = None
                ok = ~null
                if ok.any():
                    fn = _NP_BINOPS[self.op]
                    out[ok] = np.array(
                        [bool(fn(a, b)) for a, b in zip(lo[ok], ro[ok])],
                        dtype=object)
                return out
            l, r = lo, ro
        return _NP_BINOPS[self.op](l, r)

    def eval_torch(self, cols):
        return binop_torch(self.op, self.left.eval_torch(cols), self.right.eval_torch(cols),
                           fuse=contraction_site(self))

    def columns(self):
        return self.left.columns() | self.right.columns()


def _is_str(x) -> bool:
    return isinstance(x, str) or (hasattr(x, "dtype") and x.dtype == object)


def _as_obj(x, n):
    if isinstance(x, str) or not hasattr(x, "dtype"):
        return np.full(n, x, dtype=object)
    return x


@dataclass(frozen=True)
class Not(Expr):
    inner: Expr

    def eval_np(self, cols, n):
        v = self.inner.eval_np(cols, n)
        if hasattr(v, "dtype") and v.dtype == object:
            # three-valued logic: NOT NULL is NULL, not True
            out = np.empty(len(v), dtype=object)
            out[:] = [None if x is None else not x for x in v]
            return out
        return np.logical_not(v)

    def eval_torch(self, cols):
        v = _tval(self.inner.eval_torch(cols))
        return TVal(~convert(v, _BOOL), _BOOL, False)

    def columns(self):
        return self.inner.columns()


@dataclass(frozen=True)
class Neg(Expr):
    inner: Expr

    def eval_np(self, cols, n):
        return np.negative(self.inner.eval_np(cols, n))

    def eval_torch(self, cols):
        v = self.inner.eval_torch(cols)
        if not isinstance(v, TVal):
            return -v  # a python scalar negates as python, like eval_jnp
        unary_type("neg", v.dt)
        if v.dt.kind != "f":
            return TVal(torch.neg(v.t), v.dt, v.weak)
        prod = None if v.prod is None else (_fneg(v.prod[0]), v.prod[1])
        return TVal(_fneg(v.t), v.dt, v.weak, prod)

    def columns(self):
        return self.inner.columns()


@dataclass(frozen=True)
class Cast(Expr):
    inner: Expr
    dtype: str  # Schema dtype string

    def eval_np(self, cols, n):
        v = self.inner.eval_np(cols, n)
        if self.dtype == "string":
            v = np.asarray(v) if hasattr(v, "dtype") else np.full(n, v)
            # CAST(NULL AS TEXT) is NULL, not 'None'
            return np.array([None if x is None else str(x) for x in v],
                            dtype=object)
        target = {"int32": np.int32, "int64": np.int64, "uint64": np.uint64,
                  "float32": np.float32, "float64": np.float64, "bool": np.bool_}[self.dtype]
        if hasattr(v, "dtype") and v.dtype == object:
            conv = float if target in (np.float32, np.float64) else int
            vals = [None if x is None else conv(x) for x in v]
            if any(x is None for x in vals):
                # nulls survive the cast (outer-join padding): stay object
                out = np.empty(len(vals), dtype=object)
                out[:] = vals
                return out
            return np.array(vals, dtype=target)
        return np.asarray(v).astype(target) if hasattr(v, "dtype") else target(v)

    def eval_torch(self, cols):
        if self.dtype not in CAST_TARGETS:
            raise TypeError(f"cast to {self.dtype}")
        v = _tval(self.inner.eval_torch(cols))
        dt = CAST_TARGETS[self.dtype]
        return TVal(convert(v, dt), dt, False)

    def columns(self):
        return self.inner.columns()


@dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE velse END."""

    branches: tuple[tuple[Expr, Expr], ...]
    otherwise: Optional[Expr]

    def eval_np(self, cols, n):
        result = None
        assigned = np.zeros(n, dtype=bool)
        for cond, val in self.branches:
            # conditions may be three-valued (object arrays with None from
            # NULL comparisons): CASE WHEN NULL takes the branch not
            c = np.broadcast_to(
                np.asarray(cond.eval_np(cols, n), dtype=bool), (n,))
            v = val.eval_np(cols, n)
            v = np.broadcast_to(np.asarray(v), (n,)) if not _is_scalar(v) or True else v
            sel = c & ~assigned
            if result is None:
                result = np.array(v, copy=True) if hasattr(v, "dtype") else np.full(n, v)
            result = np.where(sel, v, result)
            assigned |= c
        if self.otherwise is not None:
            v = self.otherwise.eval_np(cols, n)
            v = np.broadcast_to(np.asarray(v), (n,))
            result = np.where(~assigned, v, result) if result is not None else v
        return result

    def eval_torch(self, cols):
        if self.otherwise is None:
            raise TypeError("CASE without ELSE")
        result = self.otherwise.eval_torch(cols)
        other = self.otherwise
        for cond, val in reversed(self.branches):
            result = where_torch(cond.eval_torch(cols), val.eval_torch(cols), result,
                                 minmax=is_minmax_select(cond, val, other))
            other = None
        return result

    def columns(self):
        out = set()
        for c, v in self.branches:
            out |= c.columns() | v.columns()
        if self.otherwise:
            out |= self.otherwise.columns()
        return out


def _is_scalar(v):
    return not hasattr(v, "shape") or v.shape == ()


def _np_concat(args, n):
    parts = [_as_obj(a if _is_str(a) else np.asarray(a), n) for a in args]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = "".join(str(p[i]) for p in parts)
    return out


@dataclass(frozen=True)
class Func(Expr):
    """Scalar function call."""

    name: str  # lowercase
    args: tuple[Expr, ...]

    def eval_np(self, cols, n):
        a = [arg.eval_np(cols, n) for arg in self.args]
        name = self.name
        if name == "abs":
            return np.abs(a[0])
        if name == "round":
            return np.round(a[0], int(a[1]) if len(a) > 1 else 0)
        if name == "floor":
            return np.floor(a[0])
        if name == "ceil":
            return np.ceil(a[0])
        if name == "sqrt":
            return np.sqrt(a[0])
        if name == "power":
            return np.power(a[0], a[1])
        if name == "ln":
            return np.log(a[0])
        if name == "log10":
            return np.log10(a[0])
        if name == "exp":
            return np.exp(a[0])
        if name == "coalesce":
            out = _as_obj(a[0], n).copy() if _is_str(a[0]) else np.array(np.broadcast_to(np.asarray(a[0]), (n,)), copy=True)
            for alt in a[1:]:
                isnull = _null_mask(out)
                alt_b = np.broadcast_to(np.asarray(alt), (n,))
                out = np.where(isnull, alt_b, out)
            return out
        if name == "concat":
            return _np_concat(a, n)
        if name == "lower":
            return np.array([s.lower() if s is not None else None for s in _as_obj(a[0], n)], dtype=object)
        if name == "upper":
            return np.array([s.upper() if s is not None else None for s in _as_obj(a[0], n)], dtype=object)
        if name in ("length", "char_length", "character_length"):
            return np.array([len(s) if s is not None else 0 for s in _as_obj(a[0], n)], dtype=np.int64)
        if name == "substring" or name == "substr":
            start = np.broadcast_to(np.asarray(a[1]), (n,))
            if len(a) > 2:
                ln = np.broadcast_to(np.asarray(a[2]), (n,))
                return np.array([s[max(int(st) - 1, 0):max(int(st) - 1, 0) + int(l)] if s is not None else None
                                 for s, st, l in zip(_as_obj(a[0], n), start, ln)], dtype=object)
            return np.array([s[max(int(st) - 1, 0):] if s is not None else None
                             for s, st in zip(_as_obj(a[0], n), start)], dtype=object)
        if name == "md5":
            import hashlib as _h
            return np.array([_h.md5(str(s).encode()).hexdigest() for s in _as_obj(a[0], n)], dtype=object)
        if name == "hash":
            from .hashing import hash_columns
            return hash_columns([np.broadcast_to(np.asarray(x), (n,)) for x in a])
        if name == "extract_epoch":  # seconds since epoch from micros timestamp
            return np.asarray(a[0]) // 1_000_000
        if name == "date_trunc_micros":  # (granularity_micros, ts)
            g = int(a[0]) if _is_scalar(a[0]) else a[0]
            return (np.asarray(a[1]) // g) * g
        if name == "to_timestamp_micros":
            return np.asarray(a[0]).astype(np.int64)
        if name == "is_null":
            return _null_mask(_as_obj(a[0], n) if _is_str(a[0]) else np.broadcast_to(np.asarray(a[0]), (n,)))
        if name == "is_not_null":
            return ~_null_mask(_as_obj(a[0], n) if _is_str(a[0]) else np.broadcast_to(np.asarray(a[0]), (n,)))
        if name == "like":
            import re as _re

            pat = a[1] if isinstance(a[1], str) else str(a[1])
            # SQL LIKE: % = any run, _ = one char; everything else literal
            rx = _re.compile(
                "^" + "".join(
                    ".*" if c == "%" else "." if c == "_" else _re.escape(c)
                    for c in pat
                ) + "$",
                _re.DOTALL,
            )
            vals = _as_obj(a[0], n)
            return np.array(
                [bool(rx.match(s)) if s is not None else False for s in vals],
                dtype=bool,
            )
        if name in ("json_get", "json_get_str"):
            # -> / ->> accessors (reference arroyo-planner json functions):
            # json_get yields the accessed value re-serialized as JSON text
            # ("155", "\"pickup\"", "null"); json_get_str yields bare text
            # (None for missing/null)
            import json as _json

            keys = a[1]
            key_is_scalar = _is_scalar(keys)
            docs = _as_obj(a[0], n)
            out = np.empty(n, dtype=object)
            for i, doc in enumerate(docs):
                k = keys if key_is_scalar else keys[i]
                v = None
                if doc is not None:
                    try:
                        parsed = _json.loads(doc) if isinstance(doc, (str, bytes)) else doc
                    except (ValueError, TypeError):
                        parsed = None
                    if isinstance(parsed, dict):
                        v = parsed.get(k)
                    elif isinstance(parsed, list):
                        try:
                            v = parsed[int(k)]
                        except (IndexError, ValueError, TypeError):
                            v = None
                if name == "json_get":
                    out[i] = _json.dumps(v, separators=(",", ":"))
                else:
                    out[i] = None if v is None else (
                        v if isinstance(v, str) else _json.dumps(v, separators=(",", ":")))
            return out
        raise NotImplementedError(f"scalar function {name}")

    def eval_torch(self, cols):
        a = [arg.eval_torch(cols) for arg in self.args]
        name = self.name
        if name == "abs":
            v = _tval(a[0])
            unary_type("abs", v.dt)
            if v.dt.kind == "b":
                return v
            if v.dt.kind == "u":
                return v  # abs of an unsigned value is the value
            return TVal(_fabs(v.t) if v.dt.kind == "f" else torch.abs(v.t), v.dt, v.weak)
        if name in ("floor", "ceil", "sqrt"):
            v = _tval(a[0])
            dt, weak = unary_type(name, v.dt, v.weak)
            if dt == v.dt and dt.kind == "b":
                return v  # floor/ceil of a bool is the bool itself (jnp)
            x = convert(v, dt)
            if name == "sqrt":
                return TVal(sqrt_torch(x), dt, weak)
            fn = torch.floor if name == "floor" else torch.ceil
            x = flush(x)
            return TVal(nan_fix(fn(x), x), dt, weak)
        if name == "extract_epoch":
            return floordiv_torch(a[0], 1_000_000)
        if name == "date_trunc_micros":
            return binop_torch("*", floordiv_torch(a[1], a[0]), a[0])
        if name == "to_timestamp_micros":
            v = _tval(a[0])
            return TVal(convert(v, _I64), _I64, False)
        raise TypeError(f"function {name}() has no device evaluation")

    def columns(self):
        out = set()
        for arg in self.args:
            out |= arg.columns()
        return out


def _null_mask(arr) -> np.ndarray:
    if hasattr(arr, "dtype") and arr.dtype == object:
        return np.array([x is None for x in arr], dtype=bool)
    if hasattr(arr, "dtype") and arr.dtype.kind == "f":
        return np.isnan(arr)
    return np.zeros(len(arr), dtype=bool)


# Python UDF expressions serialize by NAME and re-resolve against the port's
# registry on load: the function itself never crosses the wire.


def _expr_registry() -> dict:
    reg = {c.__name__: c for c in (Col, Lit, BinOp, Not, Neg, Cast, Case, Func)}
    from .udf import UdfExpr

    reg["UdfExpr"] = UdfExpr
    return reg


def _ser(v):
    if isinstance(v, Expr):
        return expr_to_json(v)
    if isinstance(v, (list, tuple)):
        return [_ser(x) for x in v]
    return v


def _deser(v):
    if isinstance(v, dict) and "__e__" in v:
        return expr_from_json(v)
    if isinstance(v, list):
        return tuple(_deser(x) for x in v)
    return v


def expr_to_json(e: Expr) -> dict:
    """Tagged-tree form of an expression (the JAX package's serde)."""
    import dataclasses

    from .udf import UdfExpr

    if isinstance(e, UdfExpr):
        return {"__e__": "UdfExpr", "udf_name": e.udf_name,
                "args": [_ser(a) for a in e.args]}
    out = {"__e__": type(e).__name__}
    for f in dataclasses.fields(e):
        out[f.name] = _ser(getattr(e, f.name))
    return out


def expr_from_json(d: dict) -> Expr:
    kind = d["__e__"]
    if kind == "UdfExpr":
        from .udf import lookup_udf

        u = lookup_udf(d["udf_name"])
        if u is None:
            raise ValueError(f"expression references unregistered UDF {d['udf_name']!r}")
        return u.as_expr(tuple(_deser(a) for a in d["args"]))
    cls = _expr_registry()[kind]
    return cls(**{k: _deser(v) for k, v in d.items() if k != "__e__"})


def eval_expr(expr: Expr, batch_cols: dict[str, np.ndarray], n: int) -> np.ndarray:
    """Evaluate to a full-length ndarray (broadcasting scalars)."""
    v = expr.eval_np(batch_cols, n)
    if _is_scalar(v) or (hasattr(v, "shape") and v.shape == ()):
        if isinstance(v, str) or v is None:
            out = np.empty(n, dtype=object)
            out[:] = v
            return out
        return np.full(n, v)
    return np.asarray(v)


# ------------------------------------------------------------ device twins
#
# The JAX package verifies a compiled segment's first batch and then trusts
# XLA's program, so from the second batch on its bytes are those of XLA's CPU
# compilation, not numpy's. That code runs with denormals flushed: float
# arithmetic, comparisons and conversions read a subnormal operand as the
# zero of its sign and write a subnormal result as one (sign-bit operations,
# selects, copies and C's fmod keep them). Its simplifier folds x + 0, x - 0,
# x * 1 and x / 1 to x, x * -1 and x / -1 to a negation and x * bool to a
# select, and divides by a literal c as a multiply by 1 / c; LLVM contracts a
# multiply whose one use in its fusion is an add or a subtract into a fused
# multiply-add. The twins below (the plain version of the segment kernel)
# and the kernel compute exactly that.

_CONTRACT = threading.local()


@contextmanager
def contraction_sites(sites: dict):
    """Within the block, ``contraction_site(node)`` answers from ``sites``
    (id of a BinOp node -> (left may contract, right may contract)), as the
    segment program computed them for its plan."""
    prev = getattr(_CONTRACT, "sites", None)
    _CONTRACT.sites = sites
    try:
        yield
    finally:
        _CONTRACT.sites = prev


def contraction_site(e) -> Optional[tuple]:
    sites = getattr(_CONTRACT, "sites", None)
    return None if sites is None else sites.get(id(e))

#
# The types of jax.numpy in 64-bit mode, shared by eval_torch (the plain
# PyTorch version of the segment kernel) and by the kernel's code generator
# (ops/segment_kernel.py), so the two cannot disagree on a node's dtype.

_BOOL = np.dtype(np.bool_)
_I32 = np.dtype(np.int32)
_I64 = np.dtype(np.int64)
_U16 = np.dtype(np.uint16)
_U32 = np.dtype(np.uint32)
_U64 = np.dtype(np.uint64)
_F16 = np.dtype(np.float16)
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)

CAST_TARGETS = {"int32": _I32, "int64": _I64, "uint64": _U64,
                "float32": _F32, "float64": _F64, "bool": _BOOL}

# dtypes the device twins and the kernel take. uint16, uint32 and uint64
# ride in the bits of the signed type of their size (torch does no unsigned
# arithmetic past 8 bits): sums, differences and products wrap alike, and
# the operations where the two readings part (compares, division,
# remainder, widening and conversion to float) read the bits unsigned.
TORCH_DTYPES = {
    _BOOL: torch.bool, np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    _I32: torch.int32, _I64: torch.int64, np.dtype(np.uint8): torch.uint8,
    _F16: torch.float16, _F32: torch.float32, _F64: torch.float64,
    _U16: torch.int16, _U32: torch.int32, _U64: torch.int64,
}
# the unsigned types held in signed bits
UNSIGNED_BITS = {_U16: np.dtype(np.int16), _U32: _I32, _U64: _I64}


def storage_dtype(dt: np.dtype) -> np.dtype:
    """The NumPy dtype a column of ``dt`` is held in by the twins and the
    kernel (uint16/32/64 as the signed type's bits)."""
    dt = np.dtype(dt)
    return UNSIGNED_BITS.get(dt, dt)

# JAX's type-promotion lattice (jax/_src/dtypes.py), complex types left
# out: "i*" and "f*" are Python ints and floats (weak types)
_NODE_OF = {_BOOL: "b1", np.dtype(np.uint8): "u8", np.dtype(np.uint16): "u16",
            np.dtype(np.uint32): "u32", _U64: "u64", np.dtype(np.int8): "i8",
            np.dtype(np.int16): "i16", _I32: "i32", _I64: "i64",
            np.dtype(np.float16): "f16", _F32: "f32", _F64: "f64"}
_LATTICE = {"b1": ("i*",), "u8": ("i16", "u16"), "u16": ("i32", "u32"),
            "u32": ("i64", "u64"), "u64": ("f*",), "i8": ("i16",), "i16": ("i32",),
            "i32": ("i64",), "i64": ("f*",), "i*": ("u8", "i8"), "f*": ("f16",),
            "f16": ("f32",), "f32": ("f64",), "f64": ()}


def _upper_sets() -> dict[str, frozenset]:
    up: dict[str, frozenset] = {}

    def visit(node):
        if node not in up:
            s = {node}
            for nxt in _LATTICE[node]:
                s |= visit(nxt)
            up[node] = frozenset(s)
        return up[node]

    for node in _LATTICE:
        visit(node)
    return up


_UP = _upper_sets()
_DT_OF_NODE = {v: k for k, v in _NODE_OF.items()}
_DT_OF_NODE.update({"i*": _I64, "f*": _F64})
# jax dtypes.to_inexact_dtype: bool and integers up to 32 bits go to float32
_INEXACT = {_BOOL: _F32, np.dtype(np.uint8): _F32, np.dtype(np.int8): _F32,
            np.dtype(np.uint16): _F32, np.dtype(np.int16): _F32,
            np.dtype(np.uint32): _F32, _I32: _F32, _U64: _F64, _I64: _F64}


def _lub(a: str, b: str) -> str:
    common = _UP[a] & _UP[b]
    for c in common:
        if _UP[c] == common:
            return c
    raise TypeError(f"no common type of {a} and {b}")


def jax_type(x) -> tuple[np.dtype, bool]:
    """(dtype, weak) of a TVal or of a Python scalar as jax.numpy sees it."""
    if isinstance(x, TVal):
        return x.dt, x.weak
    if isinstance(x, (bool, np.bool_)):
        return _BOOL, False
    if isinstance(x, int):
        return _I64, True
    if isinstance(x, float):
        return _F64, True
    raise TypeError(f"value {x!r} has no device type")


def _node(dt: np.dtype, weak: bool) -> str:
    if weak and dt.kind != "b":
        return "f*" if dt.kind == "f" else "i*"
    if dt not in _NODE_OF:
        raise TypeError(f"dtype {dt} has no device type")
    return _NODE_OF[dt]


def promote(*types: tuple[np.dtype, bool]) -> tuple[np.dtype, bool]:
    """jax.numpy's result type of (dtype, weak) operands: the lattice's
    least upper bound, weak only where every operand is weak."""
    node = reduce(_lub, [_node(dt, w) for dt, w in types])
    return _DT_OF_NODE[node], node in ("i*", "f*")


def _check(dt: np.dtype, what: str) -> None:
    if dt not in TORCH_DTYPES:
        raise TypeError(f"{what} over {dt}: not a dtype of the segment kernel")


def _is_int_operand(x) -> bool:
    """_is_integer of arroyo_tpu/expr.py: a Python int or an integer array
    (bool is not an integer there)."""
    if isinstance(x, TVal):
        return x.dt.kind in "iu"
    return isinstance(x, int) and not isinstance(x, (bool, np.bool_))


def binop_type(op: str, lt, rt) -> tuple[np.dtype, np.dtype, bool]:
    """(compute dtype, result dtype, weak) of ``l op r`` as eval_jnp gives
    it; lt/rt are (dtype, weak) pairs, ``int_div`` decided by the caller
    for "/". Raises TypeError where jax.numpy does or the kernel cannot."""
    if op in ("and", "or"):
        return _BOOL, _BOOL, False
    ct, weak = promote(lt, rt)
    if op == "/":
        ct = _INEXACT.get(ct, ct)
        _check(ct, "division")
        return ct, ct, weak
    if op == "%":
        if ct == _BOOL:
            ct, weak = _I32, False  # jax dtypes.to_numeric_dtype
        _check(ct, "modulo")
        return ct, ct, weak
    _check(ct, f"operator {op!r}")
    if op in ("==", "!=", "<", "<=", ">", ">="):
        return ct, _BOOL, False
    if ct == _BOOL and op == "-":
        raise TypeError("boolean subtract is not supported (jax.numpy raises)")
    return ct, ct, weak


def int_div_type(lt, rt) -> np.dtype:
    """_div_jnp's common dtype for two integer operands: promote_types of
    the operands' dtypes with the weak flags dropped."""
    ct, _ = promote((lt[0], False), (rt[0], False))
    _check(ct, "integer division")
    return ct


def floordiv_type(lt, rt) -> tuple[np.dtype, bool]:
    ct, weak = promote(lt, rt)
    if ct == _BOOL:
        ct, weak = _I32, False
    _check(ct, "floor division")
    return ct, weak


def unary_type(name: str, dt: np.dtype, weak: bool = False) -> tuple[np.dtype, bool]:
    """Result (dtype, weak) of neg/abs/floor/ceil/sqrt of a dt operand."""
    _check(dt, name)
    if name == "neg":
        if dt.kind == "b":
            raise TypeError("negative of a boolean (jax.numpy raises)")
        return dt, weak
    if name == "abs":
        return dt, weak
    if dt.kind in "iu":
        return _F64, False  # eval_jnp promotes integers to float64
    if dt.kind == "b":
        return (_F32, False) if name == "sqrt" else (dt, False)
    return dt, weak


def dtype_floor(dt: np.dtype):
    """Identity element for a masked max of dtype ``dt`` (segment.py
    _dtype_floor): 0 for uint16/32/64, whose max reads them unsigned
    (max_bits)."""
    if np.issubdtype(dt, np.floating):
        return float("-inf")
    if dt.kind not in "iu":
        raise TypeError(f"watermark values of dtype {dt}: not in the segment kernel")
    return 0 if dt in UNSIGNED_BITS else int(np.iinfo(dt).min)


def max_bits(t: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """The max of ``t``'s values (0-d), a uint16/32/64 column held in its
    signed bits read unsigned: with the sign bit flipped, the signed order
    is the unsigned one."""
    if np.dtype(dt) not in UNSIGNED_BITS:
        return t.max()
    sign = int(torch.iinfo(t.dtype).min)
    return (t ^ sign).max() ^ sign


def wrap_int(v: int, dt: np.dtype) -> int:
    """A Python int converted to integer dtype ``dt`` as a two's-complement
    truncation (uint16/32/64 as their signed bits)."""
    bits = dt.itemsize * 8
    v &= (1 << bits) - 1
    if (dt.kind == "i" or dt in UNSIGNED_BITS) and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def scalar_as(v, dt: np.dtype):
    """A Python scalar converted to ``dt`` the way jax.numpy converts a weak
    literal: integers wrap, floats round to nearest."""
    if dt.kind == "b":
        return bool(v)
    if dt.kind == "f":
        return float(np.asarray(float(v), dtype=np.float64).astype(dt))
    if isinstance(v, float):
        raise TypeError(f"float literal {v!r} converted to {dt}")
    return wrap_int(int(v), dt)


class TVal:
    """A device-twin value: torch tensor ``t`` (uint64 as int64 bits), its
    NumPy dtype ``dt`` and JAX's weak-type flag. A float product also keeps
    its two operands in ``prod`` (flushed, of dtype ``dt``), so an add that
    XLA contracts with it can compute the fused multiply-add."""

    __slots__ = ("t", "dt", "weak", "prod")

    def __init__(self, t: torch.Tensor, dt, weak: bool = False, prod=None):
        self.t = t
        self.dt = np.dtype(dt)
        self.weak = weak
        self.prod = prod


def _tval(x) -> TVal:
    """A Python scalar as a 0-d TVal on the CPU (moved next to its partner
    when an operation meets one)."""
    if isinstance(x, TVal):
        return x
    dt, weak = jax_type(x)
    return TVal(torch.tensor(scalar_as(x, dt), dtype=TORCH_DTYPES[dt]), dt, weak)


def _sat_float_to_int(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """XLA's float -> integer conversion: truncate, NaN to 0, out-of-range
    values saturate to the type's bounds (uint16/32/64 returned as their
    signed bits)."""
    t = torch.trunc(x.double())
    bits = dt.itemsize * 8
    signed = dt.kind == "i"
    hi = 2.0 ** (bits - 1) if signed else 2.0 ** bits
    over = t >= hi
    under = t < (-hi if signed else 0.0)
    safe = torch.where(torch.isnan(t) | over | under, torch.zeros_like(t), t)
    if dt == _U64:
        top = safe >= 2.0 ** 63
        low = torch.where(top, safe - 2.0 ** 63, safe).to(torch.int64)
        out = torch.where(top, low ^ torch.iinfo(torch.int64).min, low)
        return torch.where(over, -1, torch.where(under, 0, out))
    info = np.iinfo(dt)
    out = safe.to(torch.int64)
    out = torch.where(over, int(info.max), torch.where(under, int(info.min), out))
    return out.to(TORCH_DTYPES[dt])  # a uint16/32 past the signed range wraps to its bits


def int_value(v: "TVal") -> torch.Tensor:
    """An integer or bool TVal's values as int64 (uint16/32 zero-extended,
    uint64 as its int64 bits)."""
    if v.dt in (_U16, _U32):
        return v.t.to(torch.int64) & ((1 << (v.dt.itemsize * 8)) - 1)
    return v.t.to(torch.int64)


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def u64_to_float(bits: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """uint64 (int64 bits) converted to float dtype ``dt``, rounded once to
    nearest as LLVM's uitofp is: the high and low 32-bit halves are exact
    in float64, so their sum rounds once; float32 and float16 keep a sticky
    bit below float64's last place where the value needs more than 53 bits,
    so rounding that float64 to float32 is the one rounding that counts."""
    hi, lo = _lsr(bits, 32).double(), (bits & 0xFFFFFFFF).double()
    if dt == _F64:
        return hi * 4294967296.0 + lo
    wide = _lsr(bits, 53) != 0
    sticky = _lsr(bits, 11) | ((bits & 0x7FF) != 0).to(torch.int64)
    r = torch.where(wide, sticky.double() * 2048.0, hi * 4294967296.0 + lo).to(torch.float32)
    return r if dt == _F32 else r.to(torch.float16)


def _u_cmp(a: torch.Tensor, b: torch.Tensor, dt: np.dtype):
    """Unsigned operands of ``dt`` (signed bits) mapped so that a signed
    compare orders them unsigned: the top bit flipped."""
    if dt not in UNSIGNED_BITS:
        return a, b
    top = torch.iinfo(a.dtype).min
    return a ^ top, b ^ top


def convert(v: TVal, dt: np.dtype) -> torch.Tensor:
    """``v`` as a tensor of dtype ``dt``, with lax.convert_element_type's
    semantics (integers wrap, floats round to nearest, float -> int
    saturates, anything -> bool is ``!= 0``)."""
    dt = np.dtype(dt)
    if dt not in TORCH_DTYPES:
        raise TypeError(f"conversion to {dt}: not a dtype of the segment kernel")
    src = v.dt
    if src == dt:
        return v.t
    if dt == _BOOL:
        return flush(v.t) != 0
    if src.kind == "f" and dt.kind in "iu":
        return _sat_float_to_int(v.t, dt)
    if src.kind == "f" and dt.kind == "f":
        if _F16 in (src, dt) and _F64 in (src, dt):  # XLA converts through float32
            return convert(TVal(convert(v, _F32), _F32), dt)
        return flush(_float_convert(flush(v.t), dt))
    if dt.kind == "f":  # from an integer or a bool
        if src == _U64:
            return u64_to_float(v.t, dt)
        x = int_value(v) if src in UNSIGNED_BITS else v.t
        if dt == _F16:  # through float32, as XLA's CPU code converts
            return x.to(torch.float32).to(torch.float16)
        return x.to(TORCH_DTYPES[dt])
    if src in UNSIGNED_BITS:
        return int_value(v).to(TORCH_DTYPES[dt])  # zero-extended, then truncated
    return v.t.to(TORCH_DTYPES[dt])


def _operands(l, r, ct: np.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands converted to ``ct`` on one device (a Python scalar
    takes the dtype, as a weak literal does)."""
    a = _tval(l) if not isinstance(l, TVal) else l
    b = _tval(r) if not isinstance(r, TVal) else r
    ta = (torch.tensor(scalar_as(l, ct), dtype=TORCH_DTYPES[ct])
          if not isinstance(l, TVal) else convert(a, ct))
    tb = (torch.tensor(scalar_as(r, ct), dtype=TORCH_DTYPES[ct])
          if not isinstance(r, TVal) else convert(b, ct))
    dev = ta.device if ta.dim() else tb.device
    return ta.to(dev), tb.to(dev)


# NaN bytes. x86, where NumPy and XLA on the CPU run, returns for a NaN
# result the first NaN operand with its quiet bit set, and for a NaN made
# from non-NaN operands its default NaN (sign set, quiet, zero payload); a
# float conversion keeps a NaN's sign and the top of its payload. The card
# returns its own canonical NaN, and compilers may fold ``x * 1.0`` to
# ``x``. So every float operation of the twins and of the kernel ends in
# ``nan_fix``, which writes x86's NaN: the plain version and the kernel then
# agree byte for byte on either device, and with the numpy reference.


# float16: XLA's CPU code computes each float16 operation in float32 and
# rounds its result to float16 (no multiply-add contracts), so a float16
# subnormal is a normal float32 operand and no float16 value is flushed;
# the NaN rules are float32's carried through the exact conversions.

_MANT = {_F16: 10, _F32: 23, _F64: 52}


def default_nan_bits(dt: np.dtype) -> int:
    """x86's default NaN of float dtype ``dt`` as signed integer bits (float16:
    float32's converted)."""
    return -(1 << (_MANT[np.dtype(dt)] - 1))


def quiet_bit(dt: np.dtype) -> int:
    return 1 << (_MANT[np.dtype(dt)] - 1)


_ITY = {torch.float16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}
_FDT = {torch.float16: _F16, torch.float32: _F32, torch.float64: _F64}


def _ity(t: torch.Tensor):
    return _ITY[t.dtype]


def _fdt(t: torch.Tensor) -> np.dtype:
    return _FDT[t.dtype]


_TINY = {_F32: float(np.finfo(np.float32).tiny), _F64: float(np.finfo(np.float64).tiny)}


def flush(t: torch.Tensor) -> torch.Tensor:
    """A float tensor with each subnormal replaced by the zero of its sign,
    as XLA's CPU code reads float operands and writes float results
    (denormals-are-zero, flush-to-zero); any other tensor, and float16 (a
    float32 operation's operand and result there), as it is."""
    if not t.is_floating_point() or t.dtype == torch.float16:
        return t
    return torch.where(t.abs() < _TINY[_fdt(t)], torch.copysign(torch.zeros_like(t), t), t)


def _dnan(like: torch.Tensor) -> torch.Tensor:
    bits = default_nan_bits(_fdt(like))
    return torch.tensor(bits, dtype=_ity(like), device=like.device).view(like.dtype)


def _quiet(x: torch.Tensor) -> torch.Tensor:
    return (x.view(_ity(x)) | quiet_bit(_fdt(x))).view(x.dtype)


def nan_fix(r: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """``r`` with each NaN replaced by x86's NaN for an operation over
    ``operands`` (same float dtype): the first NaN operand, quieted, else
    the default NaN."""
    fix = _dnan(r)
    for o in reversed(operands):
        fix = torch.where(torch.isnan(o), _quiet(o), fix)
    return torch.where(torch.isnan(r), fix, r)


def _float_convert(t: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """float32 <-> float64 and float16 <-> float32 rounding to nearest; a NaN
    keeps its sign and the top of its payload and is quieted, as x86's
    cvtss2sd / cvtsd2ss / vcvtph2ps / vcvtps2ph do."""
    r = t.to(TORCH_DTYPES[dt])
    if t.dtype == torch.float16 or dt == _F16:
        wide = t.dtype == torch.float16  # float16 -> float32, else float32 -> float16
        b = t.view(_ity(t)).to(torch.int64) & (0xFFFF if wide else 0xFFFFFFFF)
        if wide:
            n = ((b & 0x8000) << 16) | 0x7F800000 | ((b & 0x3FF) << 13)
            out_t = torch.int32
        else:
            n = ((b >> 16) & 0x8000) | 0x7C00 | ((b >> 13) & 0x3FF)
            out_t = torch.int16
        bits = 32 if wide else 16
        n = torch.where(n >= 1 << (bits - 1), n - (1 << bits), n).to(out_t)
        return torch.where(torch.isnan(t), _quiet(n.view(r.dtype)), r)
    if dt == _F64:
        b = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        nan = ((b & 0x80000000) << 32) | 0x7FF0000000000000 | ((b & 0x7FFFFF) << 29)
        nan = nan.view(torch.float64)
    else:
        b = t.view(torch.int64)
        nan32 = ((b >> 32) & 0x80000000) | 0x7F800000 | ((b >> 29) & 0x7FFFFF)
        nan = torch.where(nan32 >= 1 << 31, nan32 - (1 << 32), nan32).to(torch.int32)
        nan = nan.view(torch.float32)
    return torch.where(torch.isnan(t), _quiet(nan), r)


def _on_host(np_fn, *ts: torch.Tensor) -> torch.Tensor:
    """``np_fn`` over CPU tensors: torch's CPU sqrt (MKL) is up to an ulp
    off and its CPU fmod overflows for huge quotients, where NumPy calls the
    hardware square root and libm's exact fmod. On CUDA tensors torch's own
    ops are the exact ones (IEEE sqrt.rn, the device fmod)."""
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.asarray(np_fn(*[t.numpy() for t in ts])))


def sqrt_torch(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt of the flushed operand; a negative operand
    gives the default NaN."""
    x = flush(x)
    r = _on_host(np.sqrt, x) if x.device.type == "cpu" else torch.sqrt(x)
    return nan_fix(r, x)


def fmod_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lax.rem of floats as XLA's CPU code computes it: C's exact fmod, the
    divisor read flushed (a subnormal divisor gives NaN, as a zero does) and
    the dividend and result as they are."""
    b = flush(b)
    if a.device.type == "cpu":
        a, b = torch.broadcast_tensors(a, b)
        r = _on_host(np.fmod, a.contiguous(), b.contiguous())
    else:
        r = torch.fmod(a, b)
    return nan_fix(r, a, b)


def _fneg(x: torch.Tensor) -> torch.Tensor:
    """Float negation as a sign-bit flip (a NaN keeps its payload)."""
    return (x.view(_ity(x)) ^ torch.iinfo(_ity(x)).min).view(x.dtype)


def _fabs(x: torch.Tensor) -> torch.Tensor:
    """Float abs as a sign-bit clear."""
    return (x.view(_ity(x)) & torch.iinfo(_ity(x)).max).view(x.dtype)


def _fsign(x: torch.Tensor) -> torch.Tensor:
    """lax.sign of a float as XLA computes it: copysign(x != 0, x) with x
    read flushed (a subnormal gives the zero of its sign), NaN kept."""
    nz = (flush(x) != 0).to(x.dtype)
    return torch.where(torch.isnan(x), x, torch.copysign(nz, x))


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round of the flushed operand: half away from zero, the sign of a
    zero kept."""
    x = flush(x)
    t = torch.trunc(x)
    return nan_fix(torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t), x)


def _widened(fn, a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """``fn`` over uint16/uint32 operands (signed bits) read as their int64
    values, its result truncated back to the bits."""
    m = (1 << (dt.itemsize * 8)) - 1
    return fn(a.to(torch.int64) & m, b.to(torch.int64) & m, _I64).to(a.dtype)


def lax_div(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """lax.div of two integer tensors: truncating, x / 0 = -1 (unsigned: the
    type's max), INT_MIN / -1 = INT_MIN."""
    if dt in (_U16, _U32):
        m = (1 << (dt.itemsize * 8)) - 1
        return _widened(lambda x, y, t: torch.where(y == 0, m, lax_div(x, y, t)), a, b, dt)
    if dt == _U64:
        a, b = torch.broadcast_tensors(a, b)
        return torch.where(b == 0, -1, udivrem64(a, torch.where(b == 0, 1, b))[0])
    zero = b == 0
    neg1 = (b == -1) if dt.kind == "i" else torch.zeros_like(zero)
    bs = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, bs, rounding_mode="trunc")
    q = torch.where(neg1, torch.neg(a), q)
    fill = -1 if dt.kind == "i" else int(np.iinfo(dt).max)
    return torch.where(zero, torch.full_like(q, fill), q)


def lax_rem(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """lax.rem of two integer tensors: truncating, x % 0 = x, INT_MIN % -1 = 0."""
    if dt in (_U16, _U32):
        return _widened(lax_rem, a, b, dt)
    if dt == _U64:
        a, b = torch.broadcast_tensors(a, b)
        return torch.where(b == 0, a, udivrem64(a, torch.where(b == 0, 1, b))[1])
    zero = b == 0
    neg1 = (b == -1) if dt.kind == "i" else torch.zeros_like(zero)
    bs = torch.where(zero | neg1, torch.ones_like(b), b)
    r = torch.fmod(a, bs)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def _floordiv(a: torch.Tensor, b: torch.Tensor, dt: np.dtype,
              rec: Optional[float] = None) -> torch.Tensor:
    """jnp.floor_divide over operands already of dtype ``dt``; ``rec`` is
    1 / b rounded in ``dt`` when b is a literal (XLA then multiplies by it)."""
    if dt.kind == "u":
        return lax_div(a, b, dt)
    if dt.kind == "i":
        q = lax_div(a, b, dt)
        fix = (torch.sign(a) != torch.sign(b)) & (lax_rem(a, b, dt) != 0)
        return torch.where(fix, q - 1, q)
    mod = fmod_torch(a, b)
    num = farith("-", a, mod)
    div = farith("/", num, b) if rec is None else farith("*", num, torch.full_like(num, rec))
    ind = (flush(mod) != 0) & (_fsign(b) != _fsign(mod))
    dm1 = farith("-", div, torch.ones_like(div))
    return _round_away(torch.where(ind, dm1, div))


def udivrem64(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 64-bit quotient and remainder of int64 tensors holding
    uint64 bits (b != 0): restoring long division one bit at a time, the
    compares unsigned through the sign flip; a shift out of the top bit
    means the partial remainder is past 2^64 > b, so it subtracts (mod
    2^64, which stays exact)."""
    a, b = torch.broadcast_tensors(a, b)
    top = torch.iinfo(torch.int64).min
    r = torch.zeros_like(a)
    q = torch.zeros_like(a)
    for i in range(63, -1, -1):
        carry = r < 0
        r = (r << 1) | ((a >> i) & 1)
        ge = carry | ((r ^ top) >= (b ^ top))
        r = torch.where(ge, r - b, r)
        q = q | (ge.to(torch.int64) << i)
    return q, r


def _mod(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """_mod_jnp: jnp.remainder (floor-sign) with an exact-zero float
    remainder taking the divisor's sign."""
    if dt == _U64:  # x % 0 = 0, as the JAX twin's b == 0 -> 1
        return udivrem64(a, torch.where(b == 0, torch.ones_like(b), b))[1]
    if dt in (_U16, _U32):
        return _widened(_mod, a, b, dt)
    if dt.kind in "iu":
        b = torch.where(b == 0, torch.ones_like(b), b)
        tm = lax_rem(a, b, dt)
    else:
        tm = fmod_torch(a, b)
    if dt.kind != "f":
        plus = ((tm < 0) != (b < 0)) & (tm != 0)
        return torch.where(plus, tm + b, tm)
    ft, fb = flush(tm), flush(b)
    plus = ((ft < 0) != (fb < 0)) & (ft != 0)
    r = torch.where(plus, farith("+", tm, b), tm)
    return torch.where(flush(r) == 0, torch.copysign(torch.zeros_like(r), b), r)


def binop_torch(op: str, l, r, fuse=None):
    """BinOp.eval_torch: the twin of BinOp.eval_jnp as XLA's CPU code
    computes it. ``fuse`` is the node's contraction site (which operand a
    multiply-add may take, ``contraction_site``)."""
    if not isinstance(l, TVal) and not isinstance(r, TVal):
        l = _tval(l)  # two Python scalars: jax.numpy computes on arrays
    lt, rt = jax_type(l), jax_type(r)
    if op == "/" and _is_int_operand(l) and _is_int_operand(r):
        ct = int_div_type(lt, rt)
        if ct.kind == "f":
            return _float_binop("/", l, r, ct, False, None)
        a, b = _operands(l, r, ct)
        return TVal(lax_div(a, b, ct), ct, False)
    ct, rdt, weak = binop_type(op, lt, rt)
    if op in ("and", "or"):
        a = convert(_tval(l), _BOOL)
        b = convert(_tval(r), _BOOL)
        dev = a.device if a.dim() else b.device
        a, b = a.to(dev), b.to(dev)
        return TVal(a & b if op == "and" else a | b, _BOOL, False)
    if ct.kind == "f":
        return _float_binop(op, l, r, ct, weak, fuse)
    a, b = _operands(l, r, ct)
    if op == "/":
        return TVal(nan_fix(a / b, a, b), ct, weak)
    if op == "%":
        return TVal(_mod(a, b, ct), ct, weak)
    if op in ("==", "!=", "<", "<=", ">", ">="):
        return TVal(_CMP[op](*_u_cmp(a, b, ct)), _BOOL, False)
    if ct == _BOOL:
        return TVal(a | b if op == "+" else a & b, ct, weak)
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul}[op]
    return TVal(fn(a, b), ct, weak)


_CMP = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def farith(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One float add, subtract, multiply or divide as XLA's CPU code does
    it: operands read flushed, the result NaN-fixed and flushed."""
    a, b = flush(a), flush(b)
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}[op]
    if a.dtype == torch.float16:  # in float32, rounded once to float16
        return nan_fix(fn(a.float(), b.float()).half(), a, b)
    out = fn(a, b)
    return flush(nan_fix(out, a, b))


def literal_rewrite(op: str, l, r, ct: np.dtype):
    """What XLA's simplifier makes of a float ``l op r`` with a literal or
    boolean operand, before any arithmetic: ``("same", x)`` for x + 0,
    0 + x, x - 0, x * 1, 1 * x and x / 1 (x converted, nothing flushed);
    ``("neg", x)`` for x * -1, -1 * x and x / -1 (a sign flip);
    ``("select", b, x)`` for x * bool and bool * x (x where b, else +0.0),
    and for bool / c (1 / c where b);
    ``("recip", x, c)`` for x / c, a multiply by the reciprocal of the
    literal c rounded in ``ct``; None otherwise. (A zero literal is any
    zero: XLA does not keep the sign of a zero here.) Operands are values
    with a ``dt`` (TVal, or the kernel generator's SV) or Python scalars."""
    lit_l, lit_r = not hasattr(l, "dt"), not hasattr(r, "dt")
    lv = scalar_as(l, ct) if lit_l else None
    rv = scalar_as(r, ct) if lit_r else None
    if op == "+":
        if lit_r and rv == 0:
            return ("same", l)
        if lit_l and lv == 0:
            return ("same", r)
    elif op == "-":
        if lit_r and rv == 0:
            return ("same", l)
    elif op == "*":
        for lit, v, other in ((lit_r, rv, l), (lit_l, lv, r)):
            if lit and v == 1:
                return ("same", other)
            if lit and v == -1:
                return ("neg", other)
        if getattr(r, "dt", None) == _BOOL:
            return ("select", r, l)
        if getattr(l, "dt", None) == _BOOL:
            return ("select", l, r)
    elif op == "/" and lit_r:
        if rv == 1:
            return ("same", l)
        if rv == -1:
            return ("neg", l)
        rec = literal_reciprocal(r, ct)
        if getattr(l, "dt", None) == _BOOL:
            return ("select", l, rec)  # bool / c: a multiply of a bool by 1 / c
        return ("recip", l, rec)
    return None


def _float_binop(op: str, l, r, ct: np.dtype, weak: bool, fuse) -> TVal:
    rw = literal_rewrite(op, l, r, ct) if op in ("+", "-", "*", "/") else None
    if rw is not None:
        kind, x = rw[0], rw[1]
        if kind == "same":
            return TVal(_as_dtype(x, ct), ct, weak)
        if kind == "neg":
            return TVal(_fneg(_as_dtype(x, ct)), ct, weak)
        if kind == "select":
            b = convert(_tval(x), _BOOL)
            v = _as_dtype(rw[2], ct)
            dev = b.device if b.dim() else v.device
            return TVal(torch.where(b.to(dev), v.to(dev), torch.zeros((), dtype=v.dtype,
                                                                       device=dev)), ct, weak)
        return _product(x, rw[2], ct, weak)
    if op == "*":
        return _product(l, r, ct, weak)
    a, b = _operands(l, r, ct)
    if op == "%":
        return TVal(_mod(a, b, ct), ct, weak)
    if op in _CMP:
        return TVal(_CMP[op](flush(a), flush(b)), _BOOL, False)
    if op in ("+", "-") and fuse is not None:
        for side, v, other in ((0, l, b), (1, r, a)):
            if fuse[side] and isinstance(v, TVal) and v.prod is not None and v.dt == ct:
                x, y = v.prod
                if op == "-":
                    if side == 0:
                        other = _fneg(other)
                    else:
                        x = _fneg(x)
                return TVal(fma_torch(x, y, other), ct, weak)
    return TVal(farith(op, a, b), ct, weak)


def _as_dtype(x, ct: np.dtype) -> torch.Tensor:
    if isinstance(x, TVal):
        return convert(x, ct)
    return torch.tensor(scalar_as(x, ct), dtype=TORCH_DTYPES[ct])


def _product(l, r, ct: np.dtype, weak: bool) -> TVal:
    """A float multiply; it keeps its flushed operands for a contraction,
    except a multiply by 2.0, which LLVM turns into x + x first."""
    a, b = _operands(l, r, ct)
    two = any(not isinstance(v, TVal) and scalar_as(v, ct) == 2.0 for v in (l, r))
    a, b = flush(a), flush(b)
    dev = a.device if a.dim() else b.device
    a, b = a.to(dev), b.to(dev)
    keep = not two and ct != _F16  # a float16 product rounds before any add
    return TVal(farith("*", a, b), ct, weak, (a, b) if keep else None)


# fused multiply-add, correctly rounded (one rounding of a * b + c), the
# operands and the result flushed as x86's vfmadd does it under XLA


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd: of the two floats around an inexact sum, the
    one whose last significand bit is 1."""
    s, e = _two_sum(a, b)
    even = (s.view(_ity(s)) & 1) == 0
    step = (e != 0) & even & torch.isfinite(s) & torch.isfinite(e)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where(step, torch.nextafter(s, toward), s)


def _split(a: torch.Tensor):
    t = a * 134217729.0  # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def _fma_exact(a: float, b: float, c: float) -> float:
    from fractions import Fraction

    if not (np.isfinite(a) and np.isfinite(b) and np.isfinite(c)):
        return a * b + c
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact == 0:
        return (a * b) + c if (a == 0 or b == 0) and c == 0 else 0.0
    try:
        return float(exact)
    except OverflowError:
        return float("inf") if exact > 0 else float("-inf")


def fma_torch(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """fma(x, y, z) of one float dtype, correctly rounded, operands read
    flushed and the result NaN-fixed and flushed. float32 takes the exact
    product in float64 and a sum rounded to odd (so the final rounding to
    float32 is the only one that counts); float64 takes Dekker's exact
    product and the round-to-odd sum of Boldo and Melquiond, and exact
    rational arithmetic on the rows where those could overflow or
    underflow."""
    x, y, z = torch.broadcast_tensors(flush(x), flush(y), flush(z))
    if x.dtype == torch.float32:
        p = x.double() * y.double()
        r = _round_odd_sum(p, z.double()).to(torch.float32)
    else:
        p = x * y
        xh, xl = _split(x)
        yh, yl = _split(y)
        pl = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
        th, tl = _two_sum(z, p)
        r = th + _round_odd_sum(tl, pl)
        # an exact zero takes IEEE's sign for the sum of x * y and z
        r = torch.where((th == 0) & (tl == 0) & (pl == 0), p + z, r)
        big, small = 2.0 ** 995, 2.0 ** -960
        safe = ((x.abs() < big) & (y.abs() < big) & (z.abs() < big)
                & ((p.abs() >= small) | (p == 0)) & ((z.abs() >= small) | (z == 0)))
        bad = (~safe).nonzero().flatten()
        if len(bad):
            xs, ys, zs = (t[bad].cpu().tolist() for t in (x, y, z))
            fix = torch.tensor([_fma_exact(*v) for v in zip(xs, ys, zs)], dtype=torch.float64)
            r = r.clone()
            r[bad] = fix.to(r.device)
        r = torch.where(torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z), r, x * y + z)
    return flush(nan_fix(r, x, y, z))


def floordiv_torch(l, r) -> TVal:
    """``l // r`` as jax.numpy computes it (floor for integers and floats)."""
    if not isinstance(l, TVal) and not isinstance(r, TVal):
        l = _tval(l)
    ct, weak = floordiv_type(jax_type(l), jax_type(r))
    a, b = _operands(l, r, ct)
    return TVal(_floordiv(a, b, ct, literal_reciprocal(r, ct)), ct, weak)


def literal_reciprocal(r, ct: np.dtype) -> Optional[float]:
    """1 / r rounded in float dtype ``ct`` for a literal r (XLA's constant
    folding of a division by a literal), else None."""
    if hasattr(r, "dt") or ct.kind != "f":
        return None
    with np.errstate(all="ignore"):
        return float(np.divide(np.array(1, ct), np.array(scalar_as(r, ct), ct)))


def where_torch(cond, x, y, minmax: bool = False) -> TVal:
    """jnp.where(cond, x, y): cond taken as ``!= 0``, x and y promoted; with
    ``minmax`` (``is_minmax_select``) and float operands of one dtype, the
    result flushed, as the min or max instruction LLVM makes of it."""
    if not isinstance(x, TVal) and not isinstance(y, TVal):
        x = _tval(x)
    dt, weak = promote(jax_type(x), jax_type(y))
    _check(dt, "CASE")
    a, b = _operands(x, y, dt)
    c = convert(_tval(cond), _BOOL)
    dev = next((t.device for t in (a, b, c) if t.dim()), a.device)
    out = torch.where(c.to(dev), a.to(dev), b.to(dev))
    if minmax and dt.kind == "f" and all(isinstance(v, TVal) and v.dt == dt for v in (x, y)):
        out = flush(out)
    return TVal(out, dt, weak)


def is_minmax_select(cond, then, other) -> bool:
    """Whether CASE WHEN cond THEN then ELSE other END is a select that
    LLVM compiles for x86 as a min or max instruction (which reads its
    operands flushed): a strict comparison of the two selected values,
    either way round, or of x with a zero literal selecting x and -x."""
    if other is None or not isinstance(cond, BinOp) or cond.op not in ("<", ">"):
        return False
    a, b = cond.left, cond.right
    if {a, b} == {then, other} and a != b:
        return True
    for x, z in ((a, b), (b, a)):
        if isinstance(z, Lit) and isinstance(z.value, (int, float)) and not isinstance(
                z.value, bool) and z.value == 0 and {then, other} == {x, Neg(x)}:
            return True
    return False


def as_full(v, p: int, device) -> TVal:
    """segment.py _as_full: a scalar broadcast to a full column."""
    v = _tval(v)
    if v.t.dim() == 0:
        return TVal(v.t.to(device).expand(p).contiguous(), v.dt, v.weak)
    return v


def splitmix64_torch(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 over int64 bits: wrapping multiplies, logical shifts
    emulated by masking off the sign extension."""
    z = x + wrap_int(0x9E3779B97F4A7C15, _I64)
    z = (z ^ _lsr(z, 30)) * wrap_int(0xBF58476D1CE4E5B9, _I64)
    z = (z ^ _lsr(z, 27)) * wrap_int(0x94D049BB133111EB, _I64)
    return z ^ _lsr(z, 31)


def hash_column_torch(v: TVal) -> torch.Tensor:
    """_hash_column_jnp: floats canonicalize -0.0 and hash their float64
    bits, bools widen, integers hash their int64 bits; int64 bits out."""
    if v.dt.kind == "f":
        x = flush(v.t)  # XLA reads x == 0.0 flushed: a subnormal key hashes as 0.0
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        if v.dt != _F64:
            x = convert(TVal(x, v.dt), _F64)
        return splitmix64_torch(x.view(torch.int64))
    if v.dt not in TORCH_DTYPES:
        raise TypeError(f"hash of dtype {v.dt}")
    return splitmix64_torch(int_value(v))


def hash_columns_torch(cols: list[TVal]) -> torch.Tensor:
    h = hash_column_torch(cols[0])
    for c in cols[1:]:
        h = splitmix64_torch(h ^ (hash_column_torch(c) + wrap_int(0x9E3779B97F4A7C15, _I64)))
    return h
