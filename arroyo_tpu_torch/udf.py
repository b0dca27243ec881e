"""Python scalar UDFs and UDAFs (the port's copy of the JAX package's
``udf.py``), with the port's own registries: plain Python callables
registered into process-global registries the SQL planner consults for
unknown function and aggregate names. Vectorized UDFs receive numpy arrays;
scalar ones are called row by row. The JAX package keeps registries of its
own; a test that runs both registers into each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .expr import Expr


@dataclass(frozen=True)
class UdfExpr(Expr):
    """Expression node calling a registered Python UDF."""

    udf_name: str
    fn: Callable
    vectorized: bool
    return_dtype: str
    args: tuple[Expr, ...]

    def eval_np(self, cols, n):
        import numpy as np

        vals = [a.eval_np(cols, n) for a in self.args]
        vals = [np.broadcast_to(np.asarray(v), (n,)) if not hasattr(v, "shape") or getattr(v, "shape", ()) == () else v for v in vals]
        if self.vectorized:
            return np.asarray(self.fn(*vals))
        out = [self.fn(*(v[i] for v in vals)) for i in range(n)]
        if self.return_dtype == "string":
            return np.array(out, dtype=object)
        from .batch import Field

        return np.array(out, dtype=Field("_", self.return_dtype).numpy_dtype())

    def columns(self):
        out = set()
        for a in self.args:
            out |= a.columns()
        return out


@dataclass
class Udf:
    name: str
    fn: Callable
    return_dtype: str
    vectorized: bool
    is_async: bool = False
    max_concurrency: int = 64
    ordered: bool = True

    def as_expr(self, args: tuple[Expr, ...]) -> UdfExpr:
        if self.is_async:
            from .sql.lexer import SqlError

            raise SqlError(
                f"async UDF {self.name!r} must be the outermost select expression"
            )
        return UdfExpr(self.name, self.fn, self.vectorized, self.return_dtype, args)


_REGISTRY: dict[str, Udf] = {}


def register_udf(
    name: str,
    fn: Optional[Callable] = None,
    *,
    return_dtype: str = "float64",
    vectorized: bool = False,
    is_async: bool = False,
    max_concurrency: int = 64,
    ordered: bool = True,
):
    """Register a Python scalar UDF usable from SQL. Decorator or direct call.

    register_udf("square", lambda x: x * x, return_dtype="int64", vectorized=True)
    """

    def inner(f: Callable) -> Callable:
        _REGISTRY[name.lower()] = Udf(
            name.lower(), f, return_dtype, vectorized, is_async, max_concurrency, ordered
        )
        return f

    if fn is not None:
        return inner(fn)
    return inner


def lookup_udf(name: str) -> Optional[Udf]:
    return _REGISTRY.get(name.lower())


@dataclass
class Udaf:
    """User-defined aggregate. The function receives the group's collected
    input values as one numpy array and returns a scalar; state between
    merges is the collected-value list (mergeable whatever the function).
    Supported where aggregation state is host-resident."""

    name: str
    fn: Callable
    return_dtype: str


_UDAF_REGISTRY: dict[str, Udaf] = {}


def register_udaf(name: str, fn: Optional[Callable] = None, *,
                  return_dtype: str = "float64"):
    """Register a Python UDAF usable from SQL. Decorator or direct call.

    register_udaf("p95", lambda v: float(np.percentile(v, 95)))
    """

    def inner(f: Callable) -> Callable:
        _UDAF_REGISTRY[name.lower()] = Udaf(name.lower(), f, return_dtype)
        return f

    if fn is not None:
        return inner(fn)
    return inner


def lookup_udaf(name: str) -> Optional[Udaf]:
    return _UDAF_REGISTRY.get(name.lower())


def drop_udaf(name: str) -> None:
    _UDAF_REGISTRY.pop(name.lower(), None)


def drop_udf(name: str) -> None:
    _REGISTRY.pop(name.lower(), None)


def udfs() -> dict[str, Udf]:
    return dict(_REGISTRY)
