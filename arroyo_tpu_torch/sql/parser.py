"""Recursive-descent SQL parser (the port's copy of the JAX package's
``sql/parser.py``): SQL text to the AST of sql/ast.py, with SET handling,
for the dialect subset the planner plans.
"""

from __future__ import annotations

from typing import Optional

from .ast import (
    Between,
    BinaryOp,
    CaseExpr,
    CastExpr,
    ColumnDef,
    CreateTable,
    CreateView,
    FuncCall,
    Ident,
    InList,
    Insert,
    Interval,
    IsNull,
    Like,
    Literal,
    OverExpr,
    Query,
    Select,
    SelectItem,
    SetVariable,
    Star,
    Statement,
    TableRef,
    UnaryOp,
    WindowSpec,
    Join,
)
from .lexer import SqlError, Token, tokenize

_UNITS_MICROS = {
    "MICROSECOND": 1,
    "MICROSECONDS": 1,
    "MILLISECOND": 1_000,
    "MILLISECONDS": 1_000,
    "SECOND": 1_000_000,
    "SECONDS": 1_000_000,
    "MINUTE": 60_000_000,
    "MINUTES": 60_000_000,
    "HOUR": 3_600_000_000,
    "HOURS": 3_600_000_000,
    "DAY": 86_400_000_000,
    "DAYS": 86_400_000_000,
}

_RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "JOIN", "INNER",
    "LEFT", "RIGHT", "FULL", "CROSS", "ON", "AS", "AND", "OR", "NOT", "UNION",
    "SELECT", "BY", "ASC", "DESC", "WITH", "THEN", "ELSE", "END", "WHEN",
    "INTO", "VALUES", "SET",
}


def parse_interval_str(s: str) -> int:
    """'10 seconds' / '1 minute' / '500 millisecond' -> micros."""
    parts = s.strip().split()
    if len(parts) == 1:
        # bare number: treated as seconds would be ambiguous; reject
        raise SqlError(f"interval string {s!r} must include a unit")
    total = 0
    i = 0
    while i < len(parts):
        try:
            qty = float(parts[i])
        except ValueError:
            raise SqlError(f"bad interval quantity in {s!r}")
        unit = parts[i + 1].upper() if i + 1 < len(parts) else None
        if unit not in _UNITS_MICROS:
            raise SqlError(f"bad interval unit in {s!r}")
        total += int(qty * _UNITS_MICROS[unit])
        i += 2
    return total


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # ------------------------------------------------------------- helpers

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper() in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            t = self.peek()
            raise SqlError(f"expected {kw}, found {t.value!r} at offset {t.pos}")

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value == op

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            t = self.peek()
            raise SqlError(f"expected {op!r}, found {t.value!r} at offset {t.pos}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "quoted_ident":
            self.next()
            return t.value
        if t.kind == "ident":
            self.next()
            return t.value
        raise SqlError(f"expected identifier, found {t.value!r} at offset {t.pos}")

    def skip_until_op(self, op: str) -> None:
        """Consume tokens (paren-aware) until ``op`` at depth 0; raises on
        EOF — next() does not advance past EOF, so a bare while-loop would
        spin forever on truncated input."""
        depth = 0
        while True:
            t = self.peek()
            if t.kind == "eof":
                raise SqlError(f"unexpected end of input, expected {op!r}")
            if t.kind == "op":
                if t.value == op and depth == 0:
                    self.next()
                    return
                if t.value == "(":
                    depth += 1
                elif t.value == ")":
                    depth -= 1
            self.next()

    # ---------------------------------------------------------- statements

    def parse_statements(self) -> list[Statement]:
        out: list[Statement] = []
        while self.peek().kind != "eof":
            if self.eat_op(";"):
                continue
            out.append(self.parse_statement())
            if self.peek().kind != "eof":
                self.expect_op(";")
        return out

    def parse_statement(self) -> Statement:
        if self.at_kw("CREATE"):
            return self._parse_create()
        if self.at_kw("INSERT"):
            return self._parse_insert()
        if self.at_kw("SELECT") or self.at_op("("):
            return Query(self.parse_select())
        if self.at_kw("SET"):
            return self._parse_set()
        t = self.peek()
        raise SqlError(f"unsupported statement starting with {t.value!r} at {t.pos}")

    def _parse_set(self) -> SetVariable:
        self.expect_kw("SET")
        name = self.ident()
        self.expect_op("=")
        t = self.next()
        if t.kind == "string":
            val: object = t.value
        elif t.kind == "number":
            val = float(t.value) if "." in t.value else int(t.value)
        else:
            val = t.value
        return SetVariable(name.lower(), val)

    def _parse_create(self) -> Statement:
        self.expect_kw("CREATE")
        self.eat_kw("TEMPORARY")
        if self.eat_kw("VIEW"):
            name = self.ident()
            self.expect_kw("AS")
            return CreateView(name, self.parse_select())
        self.expect_kw("TABLE")
        if self.eat_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
        name = self.ident()
        columns: list[ColumnDef] = []
        virtual: list[str] = []
        if self.at_op("("):
            self.next()
            while not self.eat_op(")"):
                columns.append(self._parse_column_def())
                if not self.eat_op(","):
                    self.expect_op(")")
                    break
        options: dict = {}
        if self.eat_kw("WITH"):
            self.expect_op("(")
            while not self.eat_op(")"):
                key = self._parse_option_key()
                self.expect_op("=")
                t = self.next()
                if t.kind == "string":
                    options[key] = t.value
                elif t.kind == "number":
                    options[key] = float(t.value) if "." in t.value else int(t.value)
                elif t.kind == "ident" and t.upper() in ("TRUE", "FALSE"):
                    options[key] = t.upper() == "TRUE"
                else:
                    options[key] = t.value
                if not self.eat_op(","):
                    self.expect_op(")")
                    break
        if self.eat_kw("AS"):
            # CREATE TABLE x AS SELECT — memory table from query
            q = self.parse_select()
            return CreateView(name, q) if not options else CreateTable(name, tuple(columns), {**options, "__as_query__": q})
        return CreateTable(name, tuple(columns), options, tuple(virtual))

    def _parse_option_key(self) -> str:
        parts = [self.ident() if self.peek().kind in ("ident", "quoted_ident") else self.next().value]
        while self.eat_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    def _parse_column_def(self) -> ColumnDef:
        if self.at_kw("WATERMARK"):
            # WATERMARK FOR col [AS (expr)] — flink-style; represented as a
            # generated column named "_watermark_for_<col>"; without AS the
            # column itself is the watermark expression
            self.next()
            self.expect_kw("FOR")
            col = self.ident()
            if self.eat_kw("AS"):
                expr = self.parse_expr()
            else:
                expr = Ident(col)
            return ColumnDef(f"__watermark_for_{col}", "WATERMARK", generated=expr)
        name = self.ident()
        type_parts = [self.ident().upper()]
        # multi-word types: DOUBLE PRECISION, TIMESTAMP WITH(OUT) TIME ZONE, BIGINT UNSIGNED
        while self.peek().kind == "ident" and self.peek().upper() in (
            "PRECISION", "UNSIGNED", "VARYING",
        ):
            type_parts.append(self.next().value.upper())
        if type_parts[0] == "TIMESTAMP" and self.at_kw("WITH", "WITHOUT"):
            self.next()
            self.expect_kw("TIME")
            self.expect_kw("ZONE")
        if self.eat_op("("):  # VARCHAR(255), DECIMAL(10, 2)
            self.skip_until_op(")")
        type_name = " ".join(type_parts)
        nullable = True
        generated = None
        metadata_key = None
        while True:
            if self.eat_kw("NOT"):
                self.expect_kw("NULL")
                nullable = False
            elif self.eat_kw("NULL"):
                nullable = True
            elif self.eat_kw("PRIMARY"):
                self.expect_kw("KEY")
            elif self.eat_kw("GENERATED"):
                self.expect_kw("ALWAYS")
                self.expect_kw("AS")
                self.expect_op("(")
                generated = self.parse_expr()
                self.expect_op(")")
                self.eat_kw("STORED")
                self.eat_kw("VIRTUAL")
            elif self.eat_kw("METADATA"):
                self.expect_kw("FROM")
                t = self.next()
                metadata_key = t.value
            else:
                break
        return ColumnDef(name, type_name, nullable, generated, metadata_key)

    def _parse_insert(self) -> Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.ident()
        if self.at_op("("):  # column list — consumed and ignored (order must match)
            self.next()
            self.skip_until_op(")")
        return Insert(table, self.parse_select())

    # -------------------------------------------------------------- select

    def parse_select(self) -> Select:
        if self.eat_op("("):
            q = self.parse_select()
            self.expect_op(")")
        else:
            self.expect_kw("SELECT")
            distinct = self.eat_kw("DISTINCT")
            self.eat_kw("ALL")
            items = [self._parse_select_item()]
            while self.eat_op(","):
                items.append(self._parse_select_item())
            from_table = None
            joins: list[Join] = []
            if self.eat_kw("FROM"):
                from_table = self._parse_table_ref()
                while True:
                    jt = self._maybe_join_type()
                    if jt is None:
                        break
                    tbl = self._parse_table_ref()
                    self.expect_kw("ON")
                    on = self.parse_expr()
                    joins.append(Join(jt, tbl, on))
            where = self.parse_expr() if self.eat_kw("WHERE") else None
            group_by: list = []
            if self.eat_kw("GROUP"):
                self.expect_kw("BY")
                group_by.append(self.parse_expr())
                while self.eat_op(","):
                    group_by.append(self.parse_expr())
            having = self.parse_expr() if self.eat_kw("HAVING") else None
            order_by: list[tuple] = []
            if self.eat_kw("ORDER"):
                self.expect_kw("BY")
                while True:
                    e = self.parse_expr()
                    asc = True
                    if self.eat_kw("DESC"):
                        asc = False
                    else:
                        self.eat_kw("ASC")
                    if self.eat_kw("NULLS"):
                        self.next()  # FIRST/LAST — accepted, default ordering applies
                    order_by.append((e, asc))
                    if not self.eat_op(","):
                        break
            limit = None
            if self.eat_kw("LIMIT"):
                t = self.next()
                limit = int(t.value)
            q = Select(items, from_table, joins, where, group_by, having, order_by, limit, distinct)
        while self.eat_kw("UNION"):
            how = "all" if self.eat_kw("ALL") else "distinct"
            rhs = self.parse_select()
            # append (never overwrite): a parenthesized lhs may already
            # carry its own union branches
            q.union.append((how, rhs))
        return q

    def _maybe_join_type(self) -> Optional[str]:
        if self.eat_kw("JOIN"):
            return "inner"
        if self.at_kw("INNER") and self.peek(1).upper() == "JOIN":
            self.next(); self.next()
            return "inner"
        for kw, jt in (("LEFT", "left"), ("RIGHT", "right"), ("FULL", "full")):
            if self.at_kw(kw):
                nxt = self.peek(1).upper()
                if nxt in ("JOIN", "OUTER"):
                    self.next()
                    self.eat_kw("OUTER")
                    self.expect_kw("JOIN")
                    return jt
        return None

    def _parse_table_ref(self) -> TableRef:
        if self.at_op("("):
            self.next()
            sub = self.parse_select()
            self.expect_op(")")
            alias = None
            if self.eat_kw("AS"):
                alias = self.ident()
            elif self.peek().kind in ("ident", "quoted_ident") and self.peek().upper() not in _RESERVED_STOP:
                alias = self.ident()
            return TableRef(subquery=sub, alias=alias)
        name = self.ident()
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in ("ident", "quoted_ident") and self.peek().upper() not in _RESERVED_STOP:
            alias = self.ident()
        return TableRef(name=name, alias=alias)

    def _parse_select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(Star(), None)
        e = self.parse_expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind in ("ident", "quoted_ident") and self.peek().upper() not in _RESERVED_STOP:
            alias = self.ident()
        return SelectItem(e, alias)

    # ---------------------------------------------------------- expressions

    def parse_expr(self):
        return self._parse_or()

    def _parse_or(self):
        e = self._parse_and()
        while self.at_kw("OR"):
            self.next()
            e = BinaryOp("or", e, self._parse_and())
        return e

    def _parse_and(self):
        e = self._parse_not()
        while self.at_kw("AND"):
            self.next()
            e = BinaryOp("and", e, self._parse_not())
        return e

    def _parse_not(self):
        if self.at_kw("NOT"):
            self.next()
            return UnaryOp("not", self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self):
        e = self._parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = {"=": "==", "<>": "!=", "!=": "!="}.get(t.value, t.value)
                e = BinaryOp(op, e, self._parse_additive())
                continue
            if self.at_kw("IS"):
                self.next()
                negated = self.eat_kw("NOT")
                self.expect_kw("NULL")
                e = IsNull(e, negated)
                continue
            negated = False
            save = self.i
            if self.at_kw("NOT"):
                self.next()
                negated = True
            if self.at_kw("BETWEEN"):
                self.next()
                low = self._parse_additive()
                self.expect_kw("AND")
                high = self._parse_additive()
                e = Between(e, low, high, negated)
                continue
            if self.at_kw("IN"):
                self.next()
                self.expect_op("(")
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                e = InList(e, tuple(items), negated)
                continue
            if self.at_kw("LIKE"):
                self.next()
                e = Like(e, self._parse_additive(), negated)
                continue
            if negated:
                self.i = save  # NOT belonged to an outer context
            break
        return e

    def _parse_additive(self):
        e = self._parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                e = BinaryOp(t.value, e, self._parse_multiplicative())
            else:
                return e

    def _parse_multiplicative(self):
        e = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = BinaryOp(t.value, e, self._parse_unary())
            else:
                return e

    def _parse_unary(self):
        if self.eat_op("-"):
            return UnaryOp("-", self._parse_unary())
        if self.eat_op("+"):
            return self._parse_unary()
        return self._parse_postfix()

    def _parse_postfix(self):
        e = self._parse_primary()
        while True:
            if self.at_op("->") or self.at_op("->>"):
                # JSON access: -> yields JSON text, ->> unquoted text
                op = self.next().value
                e = BinaryOp(op, e, self._parse_primary())
                continue
            if self.eat_op("::"):
                tname = self.ident().upper()
                while self.peek().kind == "ident" and self.peek().upper() in ("PRECISION", "UNSIGNED"):
                    tname += " " + self.next().value.upper()
                e = CastExpr(e, tname)
                continue
            if self.at_op(".") and isinstance(e, Ident):
                self.next()
                if self.at_op("*"):
                    self.next()
                    return Star(qualifier=e.display())
                fieldname = self.ident()
                # chains like t.window.start become qualifier "t.window"
                e = Ident(fieldname, qualifier=e.display())
                continue
            return e

    def _parse_primary(self):
        t = self.peek()
        if t.kind == "string":
            self.next()
            return Literal(t.value)
        if t.kind == "number":
            self.next()
            if "." in t.value or "e" in t.value or "E" in t.value:
                return Literal(float(t.value))
            return Literal(int(t.value))
        if self.eat_op("("):
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "quoted_ident":
            self.next()
            return Ident(t.value)
        if t.kind != "ident":
            raise SqlError(f"unexpected token {t.value!r} at offset {t.pos}")
        upper = t.upper()
        if upper in ("TRUE", "FALSE"):
            self.next()
            return Literal(upper == "TRUE")
        if upper == "NULL":
            self.next()
            return Literal(None)
        if upper == "INTERVAL":
            self.next()
            s = self.next()
            if s.kind != "string":
                raise SqlError(f"INTERVAL requires a string literal at offset {s.pos}")
            if self.peek().kind == "ident" and self.peek().upper() in _UNITS_MICROS:
                unit = self.next().upper()
                return Interval(int(float(s.value) * _UNITS_MICROS[unit]))
            return Interval(parse_interval_str(s.value))
        if upper == "CASE":
            return self._parse_case()
        if upper == "CAST":
            self.next()
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_kw("AS")
            tname = self.ident().upper()
            while self.peek().kind == "ident" and self.peek().upper() in ("PRECISION", "UNSIGNED"):
                tname += " " + self.next().value.upper()
            if self.eat_op("("):
                self.skip_until_op(")")
            self.expect_op(")")
            return CastExpr(inner, tname)
        if upper == "EXTRACT":
            self.next()
            self.expect_op("(")
            part = self.ident().lower()
            self.expect_kw("FROM")
            inner = self.parse_expr()
            self.expect_op(")")
            return FuncCall(f"extract_{part}", (inner,))
        # function call or plain identifier
        if self.peek(1).kind == "op" and self.peek(1).value == "(":
            name = self.ident().lower()
            self.expect_op("(")
            distinct = False
            star = False
            args: list = []
            if self.at_op("*"):
                self.next()
                star = True
            elif not self.at_op(")"):
                if self.eat_kw("DISTINCT"):
                    distinct = True
                args.append(self.parse_expr())
                while self.eat_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            fc = FuncCall(name, tuple(args), distinct, star)
            if self.at_kw("OVER"):
                self.next()
                self.expect_op("(")
                partition: list = []
                order: list[tuple] = []
                if self.eat_kw("PARTITION"):
                    self.expect_kw("BY")
                    partition.append(self.parse_expr())
                    while self.eat_op(","):
                        partition.append(self.parse_expr())
                if self.eat_kw("ORDER"):
                    self.expect_kw("BY")
                    while True:
                        e = self.parse_expr()
                        asc = True
                        if self.eat_kw("DESC"):
                            asc = False
                        else:
                            self.eat_kw("ASC")
                        order.append((e, asc))
                        if not self.eat_op(","):
                            break
                # ROWS BETWEEN ... — accepted and ignored (full-partition frame)
                self.skip_until_op(")")
                self.i -= 1  # skip consumed the ')'; rewind for expect_op
                self.expect_op(")")
                return OverExpr(fc, WindowSpec(tuple(partition), tuple(order)))
            return fc
        return Ident(self.ident())

    def _parse_case(self) -> CaseExpr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches: list[tuple] = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            val = self.parse_expr()
            branches.append((cond, val))
        otherwise = None
        if self.eat_kw("ELSE"):
            otherwise = self.parse_expr()
        self.expect_kw("END")
        return CaseExpr(operand, tuple(branches), otherwise)


def parse_statements(sql: str) -> list[Statement]:
    return Parser(sql).parse_statements()
