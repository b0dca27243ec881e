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
        return binop_torch(self.op, self.left.eval_torch(cols), self.right.eval_torch(cols))

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
        return TVal(_fneg(v.t) if v.dt.kind == "f" else torch.neg(v.t), v.dt, v.weak)

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
        for cond, val in reversed(self.branches):
            result = where_torch(cond.eval_torch(cols), val.eval_torch(cols), result)
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


def expr_to_json(e: Expr) -> dict:
    """Tagged-tree form of an expression (arroyo_tpu/expr.py's serde, without
    UDF expressions, which the port does not have)."""
    import dataclasses

    def ser(v):
        if isinstance(v, Expr):
            return expr_to_json(v)
        if isinstance(v, (list, tuple)):
            return [ser(x) for x in v]
        return v

    out = {"__e__": type(e).__name__}
    for f in dataclasses.fields(e):
        out[f.name] = ser(getattr(e, f.name))
    return out


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
# The types of jax.numpy in 64-bit mode, shared by eval_torch (the plain
# PyTorch version of the segment kernel) and by the kernel's code generator
# (ops/segment_kernel.py), so the two cannot disagree on a node's dtype.

_BOOL = np.dtype(np.bool_)
_I32 = np.dtype(np.int32)
_I64 = np.dtype(np.int64)
_U64 = np.dtype(np.uint64)
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)

CAST_TARGETS = {"int32": _I32, "int64": _I64, "uint64": _U64,
                "float32": _F32, "float64": _F64, "bool": _BOOL}

# dtypes the device twins and the kernel take. uint64 rides in int64 bits and
# may only be passed through, hashed or cast (no unsigned 64-bit arithmetic
# in the kernel); float16 and the 16/32-bit unsigned types are not taken.
TORCH_DTYPES = {
    _BOOL: torch.bool, np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    _I32: torch.int32, _I64: torch.int64, np.dtype(np.uint8): torch.uint8,
    _F32: torch.float32, _F64: torch.float64, _U64: torch.int64,
}

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
    if dt == _U64:
        raise TypeError(f"{what} over uint64: the segment kernel passes uint64 "
                        f"through, hashes and casts it, and does no arithmetic on it")


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
        if ct != _U64:  # uint64 modulo is in the kernel (a key such as counter % 7)
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
    _dtype_floor)."""
    if np.issubdtype(dt, np.floating):
        return float("-inf")
    if dt.kind not in "iu" or dt == _U64:
        raise TypeError(f"watermark values of dtype {dt}")
    return int(np.iinfo(dt).min)


def wrap_int(v: int, dt: np.dtype) -> int:
    """A Python int converted to integer dtype ``dt`` as a two's-complement
    truncation (uint64 as its int64 bits)."""
    bits = dt.itemsize * 8
    v &= (1 << bits) - 1
    if (dt.kind == "i" or dt == _U64) and v >= 1 << (bits - 1):
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
    NumPy dtype ``dt`` and JAX's weak-type flag."""

    __slots__ = ("t", "dt", "weak")

    def __init__(self, t: torch.Tensor, dt, weak: bool = False):
        self.t = t
        self.dt = np.dtype(dt)
        self.weak = weak


def _tval(x) -> TVal:
    """A Python scalar as a 0-d TVal on the CPU (moved next to its partner
    when an operation meets one)."""
    if isinstance(x, TVal):
        return x
    dt, weak = jax_type(x)
    return TVal(torch.tensor(scalar_as(x, dt), dtype=TORCH_DTYPES[dt]), dt, weak)


def _sat_float_to_int(x: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """XLA's float -> integer conversion: truncate, NaN to 0, out-of-range
    values saturate to the type's bounds (uint64 returned as int64 bits)."""
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
    out = safe.to(TORCH_DTYPES[dt])
    return torch.where(over, info.max, torch.where(under, info.min, out)).to(TORCH_DTYPES[dt])


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
    if src == _U64 and dt not in (_I64, _BOOL):
        raise TypeError(f"conversion of uint64 to {dt}: not in the segment kernel")
    if dt == _BOOL:
        return v.t != 0
    if src.kind == "f" and dt.kind in "iu":
        return _sat_float_to_int(v.t, dt)
    if src.kind == "f" and dt.kind == "f":
        return _float_convert(v.t, dt)
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


def default_nan_bits(dt: np.dtype) -> int:
    """x86's default NaN of float dtype ``dt`` as signed integer bits."""
    return -(1 << 22) if dt == _F32 else -(1 << 51)


def quiet_bit(dt: np.dtype) -> int:
    return 1 << 22 if dt == _F32 else 1 << 51


def _ity(t: torch.Tensor):
    return torch.int32 if t.dtype == torch.float32 else torch.int64


def _fdt(t: torch.Tensor) -> np.dtype:
    return _F32 if t.dtype == torch.float32 else _F64


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
    """float32 <-> float64 rounding to nearest; a NaN keeps its sign and the
    top of its payload and is quieted, as x86's cvtss2sd / cvtsd2ss do."""
    r = t.to(TORCH_DTYPES[dt])
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
    """Correctly rounded sqrt; a negative operand gives the default NaN."""
    r = _on_host(np.sqrt, x) if x.device.type == "cpu" else torch.sqrt(x)
    return nan_fix(r, x)


def fmod_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lax.rem of floats: C's exact fmod."""
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
    """lax.sign of a float: -1, +1, zero and NaN kept as they are."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round: half away from zero, the sign of a zero kept."""
    t = torch.trunc(x)
    return nan_fix(torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t), x)


def lax_div(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """lax.div of two integer tensors: truncating, x / 0 = -1 (unsigned: the
    type's max), INT_MIN / -1 = INT_MIN."""
    zero = b == 0
    neg1 = (b == -1) if dt.kind == "i" else torch.zeros_like(zero)
    bs = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, bs, rounding_mode="trunc")
    q = torch.where(neg1, torch.neg(a), q)
    fill = -1 if dt.kind == "i" else int(np.iinfo(dt).max)
    return torch.where(zero, torch.full_like(q, fill), q)


def lax_rem(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """lax.rem of two integer tensors: truncating, x % 0 = x, INT_MIN % -1 = 0."""
    zero = b == 0
    neg1 = (b == -1) if dt.kind == "i" else torch.zeros_like(zero)
    bs = torch.where(zero | neg1, torch.ones_like(b), b)
    r = torch.fmod(a, bs)
    r = torch.where(neg1, torch.zeros_like(r), r)
    return torch.where(zero, a, r)


def _floordiv(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """jnp.floor_divide over operands already of dtype ``dt``."""
    if dt.kind == "u":
        return lax_div(a, b, dt)
    if dt.kind == "i":
        q = lax_div(a, b, dt)
        fix = (torch.sign(a) != torch.sign(b)) & (lax_rem(a, b, dt) != 0)
        return torch.where(fix, q - 1, q)
    mod = fmod_torch(a, b)
    num = nan_fix(a - mod, a, mod)
    div = nan_fix(num / b, num, b)
    ind = (mod != 0) & (_fsign(b) != _fsign(mod))
    return _round_away(torch.where(ind, nan_fix(div - 1, div), div))


def urem64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit remainder of int64 tensors holding uint64 bits (b != 0):
    restoring long division one bit at a time, the compares unsigned through
    the sign flip; a shift out of the top bit means the partial remainder is
    past 2^64 > b, so it subtracts (mod 2^64, which stays exact)."""
    a, b = torch.broadcast_tensors(a, b)
    top = torch.iinfo(torch.int64).min
    r = torch.zeros_like(a)
    for i in range(63, -1, -1):
        carry = r < 0
        r = (r << 1) | ((a >> i) & 1)
        ge = carry | ((r ^ top) >= (b ^ top))
        r = torch.where(ge, r - b, r)
    return r


def _mod(a: torch.Tensor, b: torch.Tensor, dt: np.dtype) -> torch.Tensor:
    """_mod_jnp: jnp.remainder (floor-sign) with an exact-zero float
    remainder taking the divisor's sign."""
    if dt == _U64:  # x % 0 = 0, as the JAX twin's b == 0 -> 1
        return urem64(a, torch.where(b == 0, torch.ones_like(b), b))
    if dt.kind in "iu":
        b = torch.where(b == 0, torch.ones_like(b), b)
        tm = lax_rem(a, b, dt)
    else:
        tm = fmod_torch(a, b)
    plus = ((tm < 0) != (b < 0)) & (tm != 0)
    r = torch.where(plus, nan_fix(tm + b, tm, b) if dt.kind == "f" else tm + b, tm)
    if dt.kind == "f":
        r = torch.where(r == 0, torch.copysign(torch.zeros_like(r), b), r)
    return r


def binop_torch(op: str, l, r):
    """BinOp.eval_torch: the twin of BinOp.eval_jnp."""
    if not isinstance(l, TVal) and not isinstance(r, TVal):
        l = _tval(l)  # two Python scalars: jax.numpy computes on arrays
    lt, rt = jax_type(l), jax_type(r)
    if op == "/" and _is_int_operand(l) and _is_int_operand(r):
        ct = int_div_type(lt, rt)
        a, b = _operands(l, r, ct)
        if ct.kind == "f":
            return TVal(nan_fix(a / b, a, b), ct, False)
        return TVal(lax_div(a, b, ct), ct, False)
    ct, rdt, weak = binop_type(op, lt, rt)
    if op in ("and", "or"):
        a = convert(_tval(l), _BOOL)
        b = convert(_tval(r), _BOOL)
        dev = a.device if a.dim() else b.device
        a, b = a.to(dev), b.to(dev)
        return TVal(a & b if op == "and" else a | b, _BOOL, False)
    a, b = _operands(l, r, ct)
    if op == "/":
        return TVal(nan_fix(a / b, a, b), ct, weak)
    if op == "%":
        return TVal(_mod(a, b, ct), ct, weak)
    if op in ("==", "!=", "<", "<=", ">", ">="):
        fn = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
              ">": torch.gt, ">=": torch.ge}[op]
        return TVal(fn(a, b), _BOOL, False)
    if ct == _BOOL:
        return TVal(a | b if op == "+" else a & b, ct, weak)
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul}[op]
    out = fn(a, b)
    return TVal(nan_fix(out, a, b) if ct.kind == "f" else out, ct, weak)


def floordiv_torch(l, r) -> TVal:
    """``l // r`` as jax.numpy computes it (floor for integers and floats)."""
    if not isinstance(l, TVal) and not isinstance(r, TVal):
        l = _tval(l)
    ct, weak = floordiv_type(jax_type(l), jax_type(r))
    a, b = _operands(l, r, ct)
    return TVal(_floordiv(a, b, ct), ct, weak)


def where_torch(cond, x, y) -> TVal:
    """jnp.where(cond, x, y): cond taken as ``!= 0``, x and y promoted."""
    if not isinstance(x, TVal) and not isinstance(y, TVal):
        x = _tval(x)
    dt, weak = promote(jax_type(x), jax_type(y))
    _check(dt, "CASE")
    a, b = _operands(x, y, dt)
    c = convert(_tval(cond), _BOOL)
    dev = next((t.device for t in (a, b, c) if t.dim()), a.device)
    return TVal(torch.where(c.to(dev), a.to(dev), b.to(dev)), dt, weak)


def as_full(v, p: int, device) -> TVal:
    """segment.py _as_full: a scalar broadcast to a full column."""
    v = _tval(v)
    if v.t.dim() == 0:
        return TVal(v.t.to(device).expand(p).contiguous(), v.dt, v.weak)
    return v


def splitmix64_torch(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 over int64 bits: wrapping multiplies, logical shifts
    emulated by masking off the sign extension."""
    def lsr(z, k):
        return (z >> k) & ((1 << (64 - k)) - 1)

    z = x + wrap_int(0x9E3779B97F4A7C15, _I64)
    z = (z ^ lsr(z, 30)) * wrap_int(0xBF58476D1CE4E5B9, _I64)
    z = (z ^ lsr(z, 27)) * wrap_int(0x94D049BB133111EB, _I64)
    return z ^ lsr(z, 31)


def hash_column_torch(v: TVal) -> torch.Tensor:
    """_hash_column_jnp: floats canonicalize -0.0 and hash their float64
    bits, bools widen, integers hash their int64 bits; int64 bits out."""
    if v.dt.kind == "f":
        x = torch.where(v.t == 0.0, torch.zeros_like(v.t), v.t)
        if v.dt != _F64:
            x = _float_convert(x, _F64)
        return splitmix64_torch(x.view(torch.int64))
    if v.dt not in TORCH_DTYPES:
        raise TypeError(f"hash of dtype {v.dt}")
    return splitmix64_torch(v.t.to(torch.int64))


def hash_columns_torch(cols: list[TVal]) -> torch.Tensor:
    h = hash_column_torch(cols[0])
    for c in cols[1:]:
        h = splitmix64_torch(h ^ (hash_column_torch(c) + wrap_int(0x9E3779B97F4A7C15, _I64)))
    return h
