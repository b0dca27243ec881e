"""SQL expression -> runtime expression compilation and dtype inference
(the port's copy of the JAX package's ``sql/compile.py``): SQL expressions
compile into the port's expression nodes (arroyo_tpu_torch.expr), which
evaluate on the host in NumPy and, in a compiled segment, on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..batch import TIMESTAMP_FIELD, Schema
from ..expr import BinOp, Case, Cast, Col, Expr, Func, Lit, Neg, Not
from .ast import (
    Between,
    BinaryOp,
    CaseExpr,
    CastExpr,
    FuncCall,
    Ident,
    InList,
    Interval,
    IsNull,
    Like,
    Literal,
    OverExpr,
    SqlExpr,
    Star,
    UnaryOp,
)
from .lexer import SqlError

AGG_FUNCS = {"count", "sum", "min", "max", "avg", "array_agg"}


def _is_udaf(name: str) -> bool:
    from ..udf import lookup_udaf

    return lookup_udaf(name) is not None
WINDOW_TVFS = {"tumble", "hop", "session"}
RANKING_FUNCS = {"row_number", "rank", "dense_rank"}

# SQL type name -> Schema dtype string
_SQL_TYPES = {
    "INT": "int32",
    "INTEGER": "int32",
    "SMALLINT": "int32",
    "TINYINT": "int32",
    "INT UNSIGNED": "uint64",
    "INTEGER UNSIGNED": "uint64",
    "BIGINT": "int64",
    "BIGINT UNSIGNED": "uint64",
    "FLOAT": "float32",
    "REAL": "float32",
    "DOUBLE": "float64",
    "DOUBLE PRECISION": "float64",
    "NUMERIC": "float64",
    "DECIMAL": "float64",
    "BOOLEAN": "bool",
    "BOOL": "bool",
    "TEXT": "string",
    "VARCHAR": "string",
    "CHAR": "string",
    "CHARACTER VARYING": "string",
    "STRING": "string",
    "JSON": "string",  # raw JSON text column (reference json type)
    "TIMESTAMP": "timestamp",
    "TIMESTAMPTZ": "timestamp",
    "DATE": "timestamp",
}


def sql_type_to_dtype(type_name: str) -> str:
    t = type_name.upper().strip()
    if t not in _SQL_TYPES:
        raise SqlError(f"unsupported SQL type {type_name!r}")
    return _SQL_TYPES[t]


# --------------------------------------------------------------------------
# name resolution scope


class Scope:
    """Column / window-struct name resolution for one relation.

    An entry is (qualifier, name) -> ("col", physical_column) or
    ("window", (start Expr, end Expr)). Unqualified resolution requires the
    name to be unambiguous across qualifiers.
    """

    def __init__(self):
        # name -> list of (qualifier, kind, payload); insertion-ordered
        self._by_name: dict[str, list[tuple[Optional[str], str, object]]] = {}
        self._order: list[tuple[Optional[str], str, str, object]] = []

    def add_col(self, qualifier: Optional[str], name: str, colname: str) -> None:
        self._by_name.setdefault(name, []).append((qualifier, "col", colname))
        self._order.append((qualifier, name, "col", colname))

    def add_window(self, qualifier: Optional[str], name: str, payload: tuple[Expr, Expr]) -> None:
        self._by_name.setdefault(name, []).append((qualifier, "window", payload))
        self._order.append((qualifier, name, "window", payload))

    def try_resolve(self, qualifier: Optional[str], name: str):
        cands = self._by_name.get(name, [])
        if qualifier is not None:
            matches = [(k, p) for q, k, p in cands if q == qualifier]
        else:
            matches = [(k, p) for _q, k, p in cands]
            # identical payloads from multiple qualifiers are not ambiguous
            uniq = {(k, repr(p)) for k, p in matches}
            if len(uniq) > 1:
                raise SqlError(f"ambiguous column reference {name!r}")
        if not matches:
            return None
        return matches[0]

    def resolve(self, qualifier: Optional[str], name: str):
        r = self.try_resolve(qualifier, name)
        if r is None:
            disp = f"{qualifier}.{name}" if qualifier else name
            raise SqlError(f"unknown column {disp!r} (have {sorted(self._by_name)})")
        return r

    def window_entry(self, qualifier: Optional[str] = None):
        """The (single) window struct visible in this scope, if any."""
        for _q, _n, k, p in self._order:
            if k == "window":
                return p
        return None

    def columns_in_order(self, qualifier: Optional[str] = None) -> list[tuple[str, str]]:
        """(name, physical column) pairs for SELECT * expansion; windows
        expand to <name>_start/<name>_end via their payload exprs."""
        out: list[tuple[str, str]] = []
        seen = set()
        for q, n, k, p in self._order:
            if qualifier is not None and q != qualifier:
                continue
            if k != "col" or n.startswith("_"):
                continue
            if (n, p) in seen:
                continue
            seen.add((n, p))
            out.append((n, p))
        return out

    def qualifiers(self) -> set:
        return {q for q, _n, _k, _p in self._order if q is not None}


# --------------------------------------------------------------------------
# compilation


def compile_expr(e: SqlExpr, scope: Scope) -> Expr:
    """SqlExpr AST -> runtime Expr. Aggregates/OVER must already be rewritten
    out by the planner; their presence here is an error."""
    if isinstance(e, Literal):
        return Lit(e.value)
    if isinstance(e, Interval):
        return Lit(e.micros)
    if isinstance(e, Ident):
        # qualifier may be a window-struct alias: [t.]window.start / .end
        if e.qualifier is not None:
            if "." in e.qualifier:
                tq, wname = e.qualifier.rsplit(".", 1)
            else:
                tq, wname = None, e.qualifier
            w = scope.try_resolve(tq, wname)
            if w is not None and w[0] == "window":
                start, end = w[1]
                if e.name == "start":
                    return start
                if e.name == "end":
                    return end
                raise SqlError(f"window struct has no field {e.name!r}")
            if "." in e.qualifier:
                raise SqlError(f"cannot resolve nested reference {e.display()!r}")
        kind, payload = scope.resolve(e.qualifier, e.name)
        if kind == "window":
            raise SqlError(
                f"window column {e.display()!r} cannot be used as a scalar; "
                "use .start/.end"
            )
        return Col(payload)
    if isinstance(e, BinaryOp):
        if e.op == "||":
            return Func("concat", (compile_expr(e.left, scope), compile_expr(e.right, scope)))
        if e.op in ("->", "->>"):
            # -> returns the accessed value as JSON text; ->> as bare text
            # (reference json functions, arroyo-planner json.rs)
            fn = "json_get" if e.op == "->" else "json_get_str"
            return Func(fn, (compile_expr(e.left, scope), compile_expr(e.right, scope)))
        return BinOp(e.op, compile_expr(e.left, scope), compile_expr(e.right, scope))
    if isinstance(e, UnaryOp):
        if e.op == "not":
            return Not(compile_expr(e.operand, scope))
        return Neg(compile_expr(e.operand, scope))
    if isinstance(e, CastExpr):
        dtype = sql_type_to_dtype(e.type_name)
        inner = compile_expr(e.operand, scope)
        if dtype == "timestamp":
            return Cast(inner, "int64")
        return Cast(inner, dtype)
    if isinstance(e, CaseExpr):
        branches = []
        for cond, val in e.branches:
            if e.operand is not None:
                cond = BinaryOp("==", e.operand, cond)
            branches.append((compile_expr(cond, scope), compile_expr(val, scope)))
        other = compile_expr(e.otherwise, scope) if e.otherwise is not None else None
        return Case(tuple(branches), other)
    if isinstance(e, IsNull):
        f = Func("is_not_null" if e.negated else "is_null", (compile_expr(e.operand, scope),))
        return f
    if isinstance(e, InList):
        op = compile_expr(e.operand, scope)
        out: Expr = BinOp("==", op, compile_expr(e.items[0], scope))
        for item in e.items[1:]:
            out = BinOp("or", out, BinOp("==", op, compile_expr(item, scope)))
        return Not(out) if e.negated else out
    if isinstance(e, Between):
        op = compile_expr(e.operand, scope)
        rng = BinOp(
            "and",
            BinOp(">=", op, compile_expr(e.low, scope)),
            BinOp("<=", op, compile_expr(e.high, scope)),
        )
        return Not(rng) if e.negated else rng
    if isinstance(e, Like):
        f = Func("like", (compile_expr(e.operand, scope), compile_expr(e.pattern, scope)))
        return Not(f) if e.negated else f
    if isinstance(e, FuncCall):
        name = e.name
        if name in AGG_FUNCS:
            raise SqlError(f"aggregate {name}() not allowed in this context")
        if name in WINDOW_TVFS:
            raise SqlError(f"window function {name}() only allowed in GROUP BY")
        return _compile_scalar_func(e, scope)
    if isinstance(e, OverExpr):
        raise SqlError("OVER window expression not allowed in this context")
    if isinstance(e, Star):
        raise SqlError("* not allowed in this context")
    raise SqlError(f"cannot compile expression {e!r}")


_FUNC_ALIASES = {
    "pow": "power",
    "log": "ln",
    "char_length": "length",
    "character_length": "length",
    "substr": "substring",
    "ceiling": "ceil",
}

_KNOWN_SCALARS = {
    "abs", "round", "floor", "ceil", "sqrt", "power", "ln", "log10", "exp",
    "coalesce", "concat", "lower", "upper", "length", "substring", "md5",
    "hash", "extract_epoch", "date_trunc_micros", "to_timestamp_micros",
    "is_null", "is_not_null", "like",
}


def _compile_scalar_func(e: FuncCall, scope: Scope) -> Expr:
    name = _FUNC_ALIASES.get(e.name, e.name)
    args = tuple(compile_expr(a, scope) for a in e.args)
    if name == "date_trunc":
        # date_trunc('minute', ts) -> truncate micros timestamp
        if not isinstance(e.args[0], Literal):
            raise SqlError("date_trunc granularity must be a string literal")
        gran = str(e.args[0].value).lower()
        unit = {
            "microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
            "minute": 60_000_000, "hour": 3_600_000_000, "day": 86_400_000_000,
            "week": 7 * 86_400_000_000,
        }.get(gran)
        if unit is None:
            raise SqlError(f"unsupported date_trunc granularity {gran!r}")
        return Func("date_trunc_micros", (Lit(unit), args[1]))
    if name == "to_timestamp":
        return Func("to_timestamp_micros", args)
    if name in ("nullif",):
        a, b = args
        return Case(((BinOp("==", a, b), Lit(None)),), a)
    if name not in _KNOWN_SCALARS:
        from ..udf import lookup_udf

        udf = lookup_udf(name)
        if udf is not None:
            return udf.as_expr(args)
        raise SqlError(f"unknown function {e.name!r}")
    return Func(name, args)


# --------------------------------------------------------------------------
# dtype inference over runtime Exprs


def _promote(a: str, b: str) -> str:
    if a == b:
        return a
    if "string" in (a, b):
        return "string"
    if "float64" in (a, b):
        return "float64"
    if "float32" in (a, b):
        return "float32" if {a, b} <= {"float32", "int32", "bool"} else "float64"
    if {a, b} == {"uint64", "int64"} or {a, b} == {"uint64", "int32"}:
        return "uint64"  # integer-literal-friendly; SQL unsigned wins
    if "int64" in (a, b) or "timestamp" in (a, b):
        return "int64"
    return "int64"


def infer_dtype(expr: Expr, field_dtypes: dict[str, str]) -> str:
    """Schema dtype string an expression evaluates to."""
    if isinstance(expr, Col):
        if expr.name not in field_dtypes:
            raise SqlError(f"unknown column {expr.name!r} during type inference")
        return field_dtypes[expr.name]
    if isinstance(expr, Lit):
        v = expr.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int64"
        if isinstance(v, float):
            return "float64"
        if v is None:
            return "string"
        return "string"
    if isinstance(expr, BinOp):
        if expr.op in ("==", "!=", "<", "<=", ">", ">=", "and", "or"):
            return "bool"
        l = infer_dtype(expr.left, field_dtypes)
        r = infer_dtype(expr.right, field_dtypes)
        # integer literal against unsigned keeps unsigned
        if isinstance(expr.right, Lit) and isinstance(expr.right.value, int) and l in ("uint64", "int32"):
            r = l
        if isinstance(expr.left, Lit) and isinstance(expr.left.value, int) and r in ("uint64", "int32"):
            l = r
        if expr.op == "/" and l not in ("float32", "float64") and r not in ("float32", "float64"):
            return _promote(l, r)  # SQL integer division
        return _promote(l, r)
    if isinstance(expr, Not):
        return "bool"
    if isinstance(expr, Neg):
        d = infer_dtype(expr.inner, field_dtypes)
        return "int64" if d == "uint64" else d
    if isinstance(expr, Cast):
        return expr.dtype
    if isinstance(expr, Case):
        dtypes = [infer_dtype(v, field_dtypes) for _c, v in expr.branches]
        if expr.otherwise is not None:
            dtypes.append(infer_dtype(expr.otherwise, field_dtypes))
        # integer literals defer to the widest non-literal branch
        non_lit = [
            d for (_c, v), d in zip(expr.branches, dtypes[: len(expr.branches)])
            if not isinstance(v, Lit)
        ]
        if expr.otherwise is not None and not isinstance(expr.otherwise, Lit):
            non_lit.append(dtypes[-1])
        pool = non_lit or dtypes
        out = pool[0]
        for d in pool[1:]:
            out = _promote(out, d)
        return out
    if isinstance(expr, Func):
        name = expr.name
        if name in ("length", "hash", "extract_epoch"):
            return "int64" if name != "hash" else "uint64"
        if name in ("is_null", "is_not_null", "like"):
            return "bool"
        if name in ("lower", "upper", "substring", "md5", "concat",
                    "json_get", "json_get_str"):
            return "string"
        if name in ("floor", "ceil", "round", "sqrt", "power", "ln", "log10", "exp"):
            return "float64"
        if name in ("date_trunc_micros", "to_timestamp_micros"):
            return "timestamp"
        if name == "coalesce":
            return infer_dtype(expr.args[0], field_dtypes)
        if hasattr(expr, "return_dtype"):
            return expr.return_dtype
        return "float64"
    if hasattr(expr, "return_dtype"):  # UDF expr nodes
        return expr.return_dtype
    raise SqlError(f"cannot infer dtype of {expr!r}")


def agg_result_dtype(kind: str, input_dtype: Optional[str]) -> str:
    if kind == "count":
        return "int64"
    if kind == "avg":
        return "float64"
    return input_dtype or "int64"


# --------------------------------------------------------------------------
# AST utilities used by the planner


def walk(e: SqlExpr):
    yield e
    if isinstance(e, BinaryOp):
        yield from walk(e.left)
        yield from walk(e.right)
    elif isinstance(e, UnaryOp):
        yield from walk(e.operand)
    elif isinstance(e, CastExpr):
        yield from walk(e.operand)
    elif isinstance(e, CaseExpr):
        if e.operand is not None:
            yield from walk(e.operand)
        for c, v in e.branches:
            yield from walk(c)
            yield from walk(v)
        if e.otherwise is not None:
            yield from walk(e.otherwise)
    elif isinstance(e, IsNull):
        yield from walk(e.operand)
    elif isinstance(e, InList):
        yield from walk(e.operand)
        for i in e.items:
            yield from walk(i)
    elif isinstance(e, Between):
        yield from walk(e.operand)
        yield from walk(e.low)
        yield from walk(e.high)
    elif isinstance(e, Like):
        yield from walk(e.operand)
        yield from walk(e.pattern)
    elif isinstance(e, FuncCall):
        for a in e.args:
            yield from walk(a)
    elif isinstance(e, OverExpr):
        yield from walk(e.func)
        for p in e.window.partition_by:
            yield from walk(p)
        for o, _asc in e.window.order_by:
            yield from walk(o)


def replace_nodes(e: SqlExpr, mapping: list[tuple[SqlExpr, SqlExpr]]) -> SqlExpr:
    """Structurally replace subtrees (outermost match wins)."""
    for old, new in mapping:
        if e == old:
            return new
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, replace_nodes(e.left, mapping), replace_nodes(e.right, mapping))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, replace_nodes(e.operand, mapping))
    if isinstance(e, CastExpr):
        return CastExpr(replace_nodes(e.operand, mapping), e.type_name)
    if isinstance(e, CaseExpr):
        return CaseExpr(
            replace_nodes(e.operand, mapping) if e.operand is not None else None,
            tuple((replace_nodes(c, mapping), replace_nodes(v, mapping)) for c, v in e.branches),
            replace_nodes(e.otherwise, mapping) if e.otherwise is not None else None,
        )
    if isinstance(e, IsNull):
        return IsNull(replace_nodes(e.operand, mapping), e.negated)
    if isinstance(e, InList):
        return InList(
            replace_nodes(e.operand, mapping),
            tuple(replace_nodes(i, mapping) for i in e.items),
            e.negated,
        )
    if isinstance(e, Between):
        return Between(
            replace_nodes(e.operand, mapping),
            replace_nodes(e.low, mapping),
            replace_nodes(e.high, mapping),
            e.negated,
        )
    if isinstance(e, Like):
        return Like(replace_nodes(e.operand, mapping), replace_nodes(e.pattern, mapping), e.negated)
    if isinstance(e, FuncCall):
        return FuncCall(e.name, tuple(replace_nodes(a, mapping) for a in e.args), e.distinct, e.star)
    if isinstance(e, OverExpr):
        return OverExpr(
            replace_nodes(e.func, mapping),  # type: ignore[arg-type]
            e.window,
        )
    return e


def find_aggregates(e: SqlExpr) -> list[FuncCall]:
    """Aggregate calls NOT inside an OVER expression."""
    out: list[FuncCall] = []

    def rec(x: SqlExpr):
        if isinstance(x, OverExpr):
            return  # aggregates inside OVER belong to the window fn
        if isinstance(x, FuncCall) and (x.name in AGG_FUNCS or _is_udaf(x.name)):
            out.append(x)
            return  # nested aggs are illegal anyway
        for child in _children(x):
            rec(child)

    rec(e)
    return out


def find_overs(e: SqlExpr) -> list[OverExpr]:
    return [x for x in walk(e) if isinstance(x, OverExpr)]


def _children(e: SqlExpr) -> list[SqlExpr]:
    if isinstance(e, BinaryOp):
        return [e.left, e.right]
    if isinstance(e, UnaryOp):
        return [e.operand]
    if isinstance(e, CastExpr):
        return [e.operand]
    if isinstance(e, CaseExpr):
        out = list(sum(([c, v] for c, v in e.branches), []))
        if e.operand is not None:
            out.append(e.operand)
        if e.otherwise is not None:
            out.append(e.otherwise)
        return out
    if isinstance(e, IsNull):
        return [e.operand]
    if isinstance(e, InList):
        return [e.operand, *e.items]
    if isinstance(e, Between):
        return [e.operand, e.low, e.high]
    if isinstance(e, Like):
        return [e.operand, e.pattern]
    if isinstance(e, FuncCall):
        return list(e.args)
    if isinstance(e, OverExpr):
        return [e.func, *e.window.partition_by, *[o for o, _ in e.window.order_by]]
    return []
