"""Scalar expression engine (the port's copy of arroyo_tpu/expr.py).

The same AST nodes with their vectorized NumPy evaluation ``eval_np``; the
host operators (projection, filter, key, watermark) evaluate with it. The
device twins that the segment compiler traces belong to the segment slice
of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np


class Expr:
    """Base scalar expression node."""

    def eval_np(self, cols: dict[str, np.ndarray], n: int):
        raise NotImplementedError

    def columns(self) -> set[str]:
        """Set of input column names referenced."""
        raise NotImplementedError


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def eval_np(self, cols, n):
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

    def columns(self):
        return self.inner.columns()


@dataclass(frozen=True)
class Neg(Expr):
    inner: Expr

    def eval_np(self, cols, n):
        return np.negative(self.inner.eval_np(cols, n))

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
