"""SQL AST node definitions (the port's copy of the JAX package's
``sql/ast.py``): the statement and expression layer of the dialect the
dataflow planner consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union


# --------------------------------------------------------------------------
# scalar expressions


class SqlExpr:
    pass


@dataclass(frozen=True)
class Ident(SqlExpr):
    name: str
    qualifier: Optional[str] = None  # table/alias qualifier: t.col

    def display(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


@dataclass(frozen=True)
class Literal(SqlExpr):
    value: object  # int | float | str | bool | None


@dataclass(frozen=True)
class Interval(SqlExpr):
    micros: int


@dataclass(frozen=True)
class BinaryOp(SqlExpr):
    op: str  # + - * / % = <> < <= > >= and or ||
    left: SqlExpr
    right: SqlExpr


@dataclass(frozen=True)
class UnaryOp(SqlExpr):
    op: str  # "-" | "not"
    operand: SqlExpr


@dataclass(frozen=True)
class CastExpr(SqlExpr):
    operand: SqlExpr
    type_name: str  # SQL type name, uppercase


@dataclass(frozen=True)
class FuncCall(SqlExpr):
    name: str  # lowercase
    args: tuple[SqlExpr, ...]
    distinct: bool = False
    star: bool = False  # count(*)


@dataclass(frozen=True)
class WindowSpec:
    partition_by: tuple[SqlExpr, ...]
    order_by: tuple[tuple[SqlExpr, bool], ...]  # (expr, ascending)


@dataclass(frozen=True)
class OverExpr(SqlExpr):
    func: FuncCall
    window: WindowSpec


@dataclass(frozen=True)
class CaseExpr(SqlExpr):
    operand: Optional[SqlExpr]  # CASE x WHEN v ... (simple form)
    branches: tuple[tuple[SqlExpr, SqlExpr], ...]
    otherwise: Optional[SqlExpr]


@dataclass(frozen=True)
class IsNull(SqlExpr):
    operand: SqlExpr
    negated: bool


@dataclass(frozen=True)
class InList(SqlExpr):
    operand: SqlExpr
    items: tuple[SqlExpr, ...]
    negated: bool


@dataclass(frozen=True)
class Between(SqlExpr):
    operand: SqlExpr
    low: SqlExpr
    high: SqlExpr
    negated: bool


@dataclass(frozen=True)
class Like(SqlExpr):
    operand: SqlExpr
    pattern: SqlExpr
    negated: bool


@dataclass(frozen=True)
class Star(SqlExpr):
    qualifier: Optional[str] = None  # t.*


# --------------------------------------------------------------------------
# statements


@dataclass(frozen=True)
class SelectItem:
    expr: SqlExpr
    alias: Optional[str]


@dataclass(frozen=True)
class TableRef:
    """FROM item: named table/view or subquery."""

    name: Optional[str] = None
    subquery: Optional["Select"] = None
    alias: Optional[str] = None

    def display(self) -> str:
        return self.alias or self.name or "<subquery>"


@dataclass(frozen=True)
class Join:
    join_type: str  # "inner" | "left" | "right" | "full"
    table: TableRef
    on: SqlExpr


@dataclass
class Select:
    items: list[SelectItem]
    from_table: Optional[TableRef]
    joins: list[Join] = field(default_factory=list)
    where: Optional[SqlExpr] = None
    group_by: list[SqlExpr] = field(default_factory=list)
    having: Optional[SqlExpr] = None
    order_by: list[tuple[SqlExpr, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
    # left-associative UNION chain: [("all"|"distinct", rhs), ...]
    union: list[tuple[str, "Select"]] = field(default_factory=list)


@dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str  # SQL type, uppercase
    nullable: bool = True
    generated: Optional[SqlExpr] = None  # GENERATED ALWAYS AS (expr) STORED
    metadata_key: Optional[str] = None  # METADATA FROM 'key'


@dataclass(frozen=True)
class CreateTable:
    name: str
    columns: tuple[ColumnDef, ...]  # empty for schemaless sinks
    options: dict  # WITH (...) key/values, string-valued
    virtual_fields: tuple[str, ...] = ()


@dataclass(frozen=True)
class CreateView:
    name: str
    query: Select


@dataclass(frozen=True)
class Insert:
    table: str
    query: Select


@dataclass(frozen=True)
class Query:
    """Bare SELECT at top level (preview pipeline)."""

    query: Select


@dataclass(frozen=True)
class SetVariable:
    name: str
    value: object


Statement = Union[CreateTable, CreateView, Insert, Query, SetVariable]
