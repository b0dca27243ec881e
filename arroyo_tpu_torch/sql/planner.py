"""SQL AST -> logical dataflow Graph (the port's copy of the JAX package's
``sql/planner.py``): statements become Graph nodes whose configs hold
compiled runtime expressions (arroyo_tpu_torch.expr). A single WindowInfo
per planned relation enforces the per-branch windowing discipline.
``plan_query`` ends with the plan passes (arroyo_tpu_torch.analysis) and
plans every operator the JAX planner plans: the ones the port has not yet
ported (ROADMAP A.5) are refused when the engine builds them.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np

_log = logging.getLogger("arroyo_tpu_torch.planner")

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Field, Schema
from ..expr import BinOp, Case, Cast, Col, Expr, Func, Lit, Neg, Not
from ..graph import EdgeType, Graph, Node, OpName
from ..windows.tumbling import WINDOW_END, WINDOW_START
from .ast import (
    CreateTable,
    CreateView,
    FuncCall,
    Ident,
    Insert,
    Interval,
    Literal,
    OverExpr,
    Query,
    Select,
    SelectItem,
    SetVariable,
    SqlExpr,
    Star,
    TableRef,
)
from .compile import (
    AGG_FUNCS,
    RANKING_FUNCS,
    WINDOW_TVFS,
    Scope,
    agg_result_dtype,
    compile_expr,
    find_aggregates,
    find_overs,
    infer_dtype,
    replace_nodes,
    sql_type_to_dtype,
)
from .lexer import SqlError
from .parser import parse_interval_str, parse_statements

IS_RETRACT_FIELD = "_is_retract"


class PlanError(SqlError):
    pass


@dataclass(frozen=True)
class WindowInfo:
    kind: str  # "tumbling" | "sliding" | "session"
    width: int = 0
    slide: int = 0
    gap: int = 0

    @property
    def stride(self) -> Optional[int]:
        """Spacing between successive window starts (None for session)."""
        if self.kind == "tumbling":
            return self.width
        if self.kind == "sliding":
            return self.slide
        return None


@dataclass
class Rel:
    """A planned relation: output node + name resolution + stream traits."""

    node_id: str
    dtypes: dict[str, str]  # physical column -> dtype string
    scope: Scope
    updating: bool = False
    window: Optional[WindowInfo] = None
    keyed: bool = False  # batches carry _key

    def schema(self) -> Schema:
        fields = [Field(n, d) for n, d in self.dtypes.items()]
        names = set(self.dtypes)
        if TIMESTAMP_FIELD not in names:
            fields.append(Field(TIMESTAMP_FIELD, "int64"))
        if self.keyed and KEY_FIELD not in names:
            fields.append(Field(KEY_FIELD, "uint64"))
        return Schema(tuple(fields), has_keys=self.keyed)


@dataclass
class TableDecl:
    name: str
    columns: tuple
    options: dict

    @property
    def connector(self) -> str:
        c = self.options.get("connector")
        if not c:
            raise PlanError(f"table {self.name!r} has no connector option")
        return str(c)

    @property
    def ttype(self) -> Optional[str]:
        t = self.options.get("type")
        return str(t) if t else None

    @property
    def event_time_field(self) -> Optional[str]:
        v = self.options.get("event_time_field")
        return str(v) if v else None

    @property
    def watermark_field(self) -> Optional[str]:
        v = self.options.get("watermark_field")
        return str(v) if v else None

    def physical_columns(self):
        return [c for c in self.columns if c.generated is None and c.type_name != "WATERMARK"]

    def generated_columns(self):
        return [c for c in self.columns if c.generated is not None and c.type_name != "WATERMARK"]

    def watermark_defs(self):
        return [c for c in self.columns if c.type_name == "WATERMARK"]


@dataclass
class SinkInfo:
    node_id: str
    table: str
    connector: str
    rows: Optional[list] = None  # preview sinks


@dataclass
class PlannedPipeline:
    graph: Graph
    sinks: list[SinkInfo]
    settings: dict


def rename_cols(e: Expr, mapping: dict[str, str]) -> Expr:
    """Rewrite Col names in a runtime expression (join output remapping)."""
    if isinstance(e, Col):
        return Col(mapping.get(e.name, e.name))
    if isinstance(e, Lit):
        return e
    if isinstance(e, BinOp):
        return BinOp(e.op, rename_cols(e.left, mapping), rename_cols(e.right, mapping))
    if isinstance(e, Not):
        return Not(rename_cols(e.inner, mapping))
    if isinstance(e, Neg):
        return Neg(rename_cols(e.inner, mapping))
    if isinstance(e, Cast):
        return Cast(rename_cols(e.inner, mapping), e.dtype)
    if isinstance(e, Case):
        return Case(
            tuple((rename_cols(c, mapping), rename_cols(v, mapping)) for c, v in e.branches),
            rename_cols(e.otherwise, mapping) if e.otherwise is not None else None,
        )
    if isinstance(e, Func):
        return Func(e.name, tuple(rename_cols(a, mapping) for a in e.args))
    from ..udf import UdfExpr

    if isinstance(e, UdfExpr):
        return UdfExpr(e.udf_name, e.fn, e.vectorized, e.return_dtype,
                       tuple(rename_cols(a, mapping) for a in e.args))
    raise PlanError(f"cannot rename columns in {e!r}")


def _conjuncts(e: SqlExpr) -> list[SqlExpr]:
    from .ast import BinaryOp

    if isinstance(e, BinaryOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


class Planner:
    """Multi-statement SQL script -> PlannedPipeline."""

    def __init__(self, parallelism: int = 1):
        self.parallelism = parallelism
        self.tables: dict[str, TableDecl] = {}
        self.views: dict[str, Select] = {}
        # connector-less tables: INSERT INTO them plants a named stream in
        # the dataflow that later SELECTs tap (reference memory tables,
        # planner tables.rs Table::MemoryTable)
        self.memory_rels: dict[str, "Rel"] = {}
        self.graph = Graph()
        self.sinks: list[SinkInfo] = []
        self.settings: dict = {}
        self._counter = itertools.count()

    # ---------------------------------------------------------------- ids

    def _id(self, kind: str, hint: str = "") -> str:
        n = next(self._counter)
        return f"{kind}_{n}_{hint}" if hint else f"{kind}_{n}"

    # ------------------------------------------------------------ top level

    def plan(self, sql: str) -> PlannedPipeline:
        stmts = parse_statements(sql)
        for stmt in stmts:
            if isinstance(stmt, CreateTable):
                if "__as_query__" in stmt.options:
                    raise PlanError("CREATE TABLE ... AS with options is unsupported")
                self.tables[stmt.name] = TableDecl(stmt.name, stmt.columns, stmt.options)
            elif isinstance(stmt, CreateView):
                self.views[stmt.name] = stmt.query
            elif isinstance(stmt, SetVariable):
                val = stmt.value
                if stmt.name == "updating_ttl" and isinstance(val, str):
                    val = parse_interval_str(val)
                self.settings[stmt.name] = val
            elif isinstance(stmt, Insert):
                self._plan_insert(stmt)
            elif isinstance(stmt, Query):
                self._plan_preview(stmt.query)
            else:
                raise PlanError(f"unsupported statement {stmt!r}")
        if not self.sinks:
            raise PlanError("pipeline has no INSERT INTO or SELECT statement")
        return PlannedPipeline(self.graph, self.sinks, self.settings)

    # -------------------------------------------------------------- helpers

    def _add_node(self, node_id: str, op: OpName, cfg: dict, parallelism: Optional[int] = None,
                  description: str = "") -> Node:
        p = self.parallelism if parallelism is None else parallelism
        return self.graph.add_node(Node(node_id, op, cfg, p, description))

    def _edge(self, src_rel_or_id, dst: str, etype: EdgeType, schema: Schema):
        src = src_rel_or_id.node_id if isinstance(src_rel_or_id, Rel) else src_rel_or_id
        self.graph.add_edge(src, dst, etype, schema)

    # ------------------------------------------------------------- sources

    def _plan_table_ref(self, tr: TableRef) -> Rel:
        if tr.subquery is not None:
            rel = self.plan_select(tr.subquery)
            return self._aliased(rel, tr.alias)
        name = tr.name
        assert name is not None
        if name in self.views:
            rel = self.plan_select(self.views[name])
            return self._aliased(rel, tr.alias or name)
        if name in self.memory_rels:
            return self._aliased(self.memory_rels[name], tr.alias or name)
        if name not in self.tables:
            raise PlanError(f"unknown table {name!r}")
        decl = self.tables[name]
        if decl.options.get("connector") is None:
            raise PlanError(
                f"memory table {name!r} is read before any INSERT INTO writes it")
        if decl.ttype == "sink":
            raise PlanError(f"table {name!r} is a sink; cannot SELECT from it")
        return self._plan_source(decl, tr.alias or name)

    def _aliased(self, rel: Rel, alias: Optional[str]) -> Rel:
        """Re-qualify a subquery/view output scope under its alias."""
        s = Scope()
        for q, n, k, p in rel.scope._order:
            if q is not None and alias is not None and q != alias:
                continue
            if k == "col":
                s.add_col(alias, n, p)
            else:
                s.add_window(alias, n, p)
        return Rel(rel.node_id, rel.dtypes, s, rel.updating, rel.window, rel.keyed)

    def _plan_source(self, decl: TableDecl, alias: str) -> Rel:
        phys = decl.physical_columns()
        if not phys and decl.connector not in ("impulse", "nexmark"):
            raise PlanError(f"source table {decl.name!r} needs at least one column")
        dtypes: dict[str, str] = {}
        fields = []
        for c in phys:
            dt = sql_type_to_dtype(c.type_name)
            dtypes[c.name] = dt
            fields.append(Field(c.name, dt, c.nullable))
        fields.append(Field(TIMESTAMP_FIELD, "int64"))
        src_schema = Schema(tuple(fields))

        cfg = dict(decl.options)
        cfg.pop("type", None)
        cfg.pop("event_time_field", None)
        cfg["connector"] = decl.connector
        cfg["schema"] = src_schema
        etf = decl.event_time_field
        if etf and any(c.name == etf for c in phys):
            # physical event-time column: the deserializer stamps _timestamp;
            # generated ones are stamped by the generated-columns VALUE node
            cfg["event_time_field"] = etf
        cfg.setdefault("bad_data", str(decl.options.get("bad_data", "fail")))
        src_id = self._id("source", decl.name)
        self._add_node(src_id, OpName.SOURCE, cfg, description=f"{decl.connector}:{decl.name}")

        scope = Scope()
        for c in phys:
            scope.add_col(alias, c.name, c.name)
        rel = Rel(src_id, dict(dtypes), scope)

        # generated columns (incl. generated event-time) via a VALUE node
        gens = decl.generated_columns()
        if gens:
            proj = [(n, Col(n)) for n in dtypes]
            gen_scope = rel.scope
            gen_exprs: dict[str, Expr] = {}
            for c in gens:
                e = compile_expr(c.generated, gen_scope)
                dt = sql_type_to_dtype(c.type_name)
                ce = Cast(e, "int64") if dt == "timestamp" else e
                proj.append((c.name, ce))
                gen_exprs[c.name] = ce
                dtypes[c.name] = dt
            if etf and etf in gen_exprs:
                # projections all evaluate against the INPUT batch, so the
                # event-time column must be re-derived from its generating
                # expression, not referenced by name
                proj.append((TIMESTAMP_FIELD, gen_exprs[etf]))
            vid = self._id("value", f"{decl.name}_gen")
            self._add_node(vid, OpName.VALUE, {"projections": proj})
            self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
            scope = Scope()
            for n in dtypes:
                scope.add_col(alias, n, n)
            rel = Rel(vid, dict(dtypes), scope)

        # watermark node (reference: SourceRewriter inserts WatermarkNode)
        wm_expr: Expr = Col(TIMESTAMP_FIELD)
        wdefs = decl.watermark_defs()
        if wdefs:
            wm_expr = compile_expr(wdefs[0].generated, rel.scope)
        elif decl.watermark_field:
            wf = decl.watermark_field
            if wf in dtypes:
                wm_expr = Col(wf)
            else:
                raise PlanError(f"watermark_field {wf!r} is not a column of {decl.name!r}")
        wm_cfg: dict = {"expr": wm_expr}
        if "idle-time-ms" in decl.options:
            wm_cfg["idle_time_micros"] = int(decl.options["idle-time-ms"]) * 1000
        wid = self._id("watermark", decl.name)
        self._add_node(wid, OpName.WATERMARK, wm_cfg)
        self._edge(rel, wid, EdgeType.FORWARD, rel.schema())
        # a debezium source is an UPDATING relation: rows carry _is_retract
        # and downstream plans must use retract-aware operators (reference
        # tables.rs is_updating; de.rs debezium handling)
        updating = str(decl.options.get("format", "")) == "debezium_json"
        return Rel(wid, dtypes, rel.scope, updating)

    # --------------------------------------------------------------- select

    def plan_select(self, q: Select) -> Rel:
        if q.union:
            return self._plan_union(q)
        if q.order_by:
            raise PlanError("ORDER BY is only supported inside OVER(...) windows")
        if q.limit is not None:
            raise PlanError("LIMIT is unsupported on streaming queries")
        if q.distinct:
            raise PlanError(
                "SELECT DISTINCT is unsupported; GROUP BY the columns instead"
            )
        if q.from_table is None:
            raise PlanError("SELECT without FROM is unsupported")
        rel = self._plan_table_ref(q.from_table)
        for j in q.joins:
            other = self._plan_table_ref(j.table)
            rel = self._plan_join(rel, other, j)

        has_agg = bool(q.group_by) or any(
            find_aggregates(it.expr) for it in q.items if not isinstance(it.expr, Star)
        )
        overs = [o for it in q.items if not isinstance(it.expr, Star) for o in find_overs(it.expr)]
        if has_agg and overs:
            raise PlanError("mixing GROUP BY aggregates and OVER window functions is unsupported")
        if has_agg:
            return self._plan_aggregate(rel, q)
        if overs:
            return self._plan_window_fn(rel, q)
        return self._plan_projection(rel, q)

    # ---------------------------------------------------- plain projection

    def _expand_items(self, items: list[SelectItem], scope: Scope) -> list[tuple[str, SqlExpr]]:
        out: list[tuple[str, SqlExpr]] = []
        for i, it in enumerate(items):
            if isinstance(it.expr, Star):
                for name, col in scope.columns_in_order(it.expr.qualifier):
                    out.append((name, Ident(col)))
                continue
            out.append((self._item_name(it, i), it.expr))
        return out

    @staticmethod
    def _item_name(it: SelectItem, i: int) -> str:
        if it.alias:
            return it.alias
        if isinstance(it.expr, Ident):
            return it.expr.name
        if isinstance(it.expr, FuncCall):
            return it.expr.name
        if isinstance(it.expr, OverExpr):
            return it.expr.func.name
        return f"_col_{i}"

    def _plan_projection(self, rel: Rel, q: Select) -> Rel:
        rel, q = self._plan_async_udfs(rel, q)
        rel, q = self._plan_unnest(rel, q)
        pairs = self._expand_items(q.items, rel.scope)
        proj: list[tuple[str, Expr]] = []
        dtypes: dict[str, str] = {}
        out_scope = Scope()
        window_kept = False
        used = set()
        for name, e in pairs:
            # window struct passthrough: project its physical columns
            if isinstance(e, Ident):
                r = rel.scope.try_resolve(e.qualifier, e.name)
                if r is not None and r[0] == "window":
                    start_e, end_e = r[1]
                    proj.append((WINDOW_START, start_e))
                    proj.append((WINDOW_END, end_e))
                    dtypes[WINDOW_START] = "timestamp"
                    dtypes[WINDOW_END] = "timestamp"
                    out_scope.add_window(None, name, (Col(WINDOW_START), Col(WINDOW_END)))
                    out_scope.add_col(None, WINDOW_START, WINDOW_START)
                    out_scope.add_col(None, WINDOW_END, WINDOW_END)
                    window_kept = True
                    continue
            if name in used:
                name = f"{name}_{len(used)}"
            used.add(name)
            ce = compile_expr(e, rel.scope)
            proj.append((name, ce))
            dtypes[name] = infer_dtype(ce, rel.dtypes)
            out_scope.add_col(None, name, name)
        filt = compile_expr(q.where, rel.scope) if q.where is not None else None
        vid = self._id("value")
        self._add_node(vid, OpName.VALUE, {"projections": proj, "filter": filt})
        self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
        # rel.window (the branch's windowing trait) carries through a
        # projection even when the window struct columns are dropped
        return Rel(vid, dtypes, out_scope, rel.updating, rel.window, rel.keyed)

    def _plan_unnest(self, rel: Rel, q: Select):
        """unnest(array_col) select items explode through a dedicated
        UNNEST node (reference UnnestRewriter, rewriters.rs:323); at most
        one unnest per projection, matching the reference."""
        unnests = [
            (i, it) for i, it in enumerate(q.items)
            if not isinstance(it.expr, Star)
            and isinstance(it.expr, FuncCall) and it.expr.name == "unnest"
        ]
        if not unnests:
            return rel, q
        if len(unnests) > 1:
            raise PlanError("only one unnest() per SELECT is supported")
        i, it = unnests[0]
        call = it.expr
        if call.star or len(call.args) != 1:
            raise PlanError("unnest() takes exactly one argument")
        out_name = self._item_name(it, i)
        arr = compile_expr(call.args[0], rel.scope)
        arr_dt = infer_dtype(arr, rel.dtypes)
        elem_dt = arr_dt.split(":", 1)[1] if arr_dt.startswith("array:") else "int64"
        # stage the array column, then explode it; carry columns under their
        # PHYSICAL names (display names can collide across join sides)
        carried: list[str] = []
        for _q2, _n, k, p in rel.scope._order:
            if k == "col" and p not in carried:
                carried.append(p)
        vid = self._id("value", "pre_unnest")
        self._add_node(vid, OpName.VALUE, {
            "projections": [("__unnest_in", arr)] + [(p, Col(p)) for p in carried],
        })
        self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
        uid = self._id("unnest")
        self._add_node(uid, OpName.UNNEST, {
            "column": "__unnest_in", "out_name": out_name, "out_dtype": elem_dt})
        dt2 = dict(rel.dtypes)
        dt2["__unnest_in"] = arr_dt
        self._edge(vid, uid, EdgeType.FORWARD, Schema.of(
            [(n, "string" if d.startswith("array:") else d) for n, d in dt2.items()]
            + [(TIMESTAMP_FIELD, "int64")]))
        scope = Scope()
        dtypes: dict[str, str] = {}
        for q2, n, k, p in rel.scope._order:
            # preserve qualifiers and window structs: other select items /
            # WHERE may reference t.col or the window after the rewrite
            if k == "col":
                scope.add_col(q2, n, p)
                dtypes[p] = rel.dtypes[p]
            else:
                scope.add_window(q2, n, p)
        scope.add_col(None, out_name, out_name)
        dtypes[out_name] = elem_dt
        new_rel = Rel(uid, dtypes, scope, rel.updating, rel.window, rel.keyed)
        items = list(q.items)
        items[i] = SelectItem(Ident(out_name), it.alias)
        q2 = Select(items, q.from_table, q.joins, q.where, q.group_by,
                    q.having, q.order_by, q.limit, q.distinct)
        return new_rel, q2

    def _plan_async_udfs(self, rel: Rel, q: Select):
        """Select items calling async Python UDFs get their own dataflow
        node (reference AsyncUdfRewriter, rewriters.rs): bounded-concurrency
        out-of-band compute, results re-joined positionally."""
        from ..udf import lookup_udf

        async_calls: list[tuple[str, object, object]] = []  # (out, call, udf)
        for i, it in enumerate(q.items):
            if isinstance(it.expr, FuncCall):
                udf = lookup_udf(it.expr.name)
                if udf is not None and udf.is_async:
                    async_calls.append((self._item_name(it, i), it.expr, udf))
        if not async_calls:
            return rel, q
        # pre-filter applies before the async hop (rows dropped early)
        if q.where is not None:
            filt = compile_expr(q.where, rel.scope)
            vid = self._id("value", "pre_async")
            self._add_node(vid, OpName.VALUE, {"projections": None, "filter": filt})
            self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
            rel = Rel(vid, rel.dtypes, rel.scope, rel.updating, rel.window, rel.keyed)
            q = Select(q.items, q.from_table, q.joins, None, q.group_by,
                       q.having, q.order_by, q.limit, q.distinct)
        rewrites: list[tuple[SqlExpr, SqlExpr]] = []
        for out_name, call, udf in async_calls:
            args = tuple(compile_expr(a, rel.scope) for a in call.args)
            aid = self._id("async_udf", udf.name)
            self._add_node(aid, OpName.ASYNC_UDF, {
                "name": udf.name, "fn": udf.fn, "arg_exprs": list(args),
                "out_name": out_name, "return_dtype": udf.return_dtype,
                "ordered": udf.ordered, "max_concurrency": udf.max_concurrency,
            })
            self._edge(rel, aid, EdgeType.FORWARD, rel.schema())
            dt = dict(rel.dtypes)
            dt[out_name] = udf.return_dtype
            scope = Scope()
            for qq, n, k, p in rel.scope._order:
                if k == "col":
                    scope.add_col(qq, n, p)
                else:
                    scope.add_window(qq, n, p)
            scope.add_col(None, out_name, out_name)
            rel = Rel(aid, dt, scope, rel.updating, rel.window, rel.keyed)
            rewrites.append((call, Ident(out_name)))
        items = [SelectItem(replace_nodes(it.expr, rewrites), it.alias)
                 for it in q.items]
        q = Select(items, q.from_table, q.joins, q.where, q.group_by,
                   q.having, q.order_by, q.limit, q.distinct)
        return rel, q

    # ------------------------------------------------------------ aggregate

    def _substitute_aliases(self, e: SqlExpr, q: Select) -> SqlExpr:
        """GROUP BY may reference select aliases or 1-based positions."""
        if isinstance(e, Literal) and isinstance(e.value, int):
            idx = e.value - 1
            if 0 <= idx < len(q.items):
                return q.items[idx].expr
            raise PlanError(f"GROUP BY position {e.value} out of range")
        if isinstance(e, Ident) and e.qualifier is None:
            for it in q.items:
                if it.alias == e.name:
                    return it.expr
        return e

    def _window_from_call(self, fc: FuncCall) -> WindowInfo:
        def iv(a) -> int:
            if isinstance(a, Interval):
                return a.micros
            raise PlanError(f"{fc.name}() arguments must be INTERVAL literals")

        if fc.name == "tumble":
            if len(fc.args) != 1:
                raise PlanError("tumble(width) takes one interval")
            return WindowInfo("tumbling", width=iv(fc.args[0]))
        if fc.name == "hop":
            if len(fc.args) != 2:
                raise PlanError("hop(slide, width) takes two intervals")
            return WindowInfo("sliding", slide=iv(fc.args[0]), width=iv(fc.args[1]))
        if fc.name == "session":
            if len(fc.args) != 1:
                raise PlanError("session(gap) takes one interval")
            return WindowInfo("session", gap=iv(fc.args[0]))
        raise PlanError(f"unknown window function {fc.name}")

    def _plan_aggregate(self, rel: Rel, q: Select) -> Rel:
        # pre-aggregation filter
        if q.where is not None:
            filt = compile_expr(q.where, rel.scope)
            vid = self._id("value", "filter")
            self._add_node(vid, OpName.VALUE, {"projections": None, "filter": filt})
            self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
            rel = Rel(vid, rel.dtypes, rel.scope, rel.updating, rel.window, rel.keyed)

        # classify GROUP BY items
        window: Optional[WindowInfo] = None
        carried_window = False
        window_name = "window"
        window_refs: list[SqlExpr] = []  # AST forms that denote the window
        key_exprs: list[tuple[str, SqlExpr]] = []
        group_rewrites: list[tuple[SqlExpr, SqlExpr]] = []
        for gi_raw in q.group_by:
            gi = self._substitute_aliases(gi_raw, q)
            if isinstance(gi, FuncCall) and gi.name in WINDOW_TVFS:
                if window is not None:
                    raise PlanError("only one window per GROUP BY")
                window = self._window_from_call(gi)
                window_refs.extend([gi_raw, gi])
                for it in q.items:
                    if it.expr == gi and it.alias:
                        window_name = it.alias
                continue
            if isinstance(gi, Ident):
                r = rel.scope.try_resolve(gi.qualifier, gi.name)
                if r is not None and r[0] == "window":
                    # grouping by an existing (subquery) window column
                    if rel.window is None or rel.window.stride is None:
                        raise PlanError(
                            "GROUP BY on a session window column is unsupported"
                        )
                    if window is not None:
                        raise PlanError("only one window per GROUP BY")
                    window = rel.window
                    carried_window = True
                    window_name = gi.name
                    window_refs.extend([gi_raw, gi])
                    continue
            name = None
            if isinstance(gi, Ident):
                name = gi.name
            else:
                for it in q.items:
                    if it.alias and self._substitute_aliases(it.expr, q) == gi:
                        name = it.alias
                        break
            if name is None:
                name = f"__key_{len(key_exprs)}"
            key_exprs.append((name, gi))
            group_rewrites.append((gi_raw, Ident(name)))
            if gi is not gi_raw:
                group_rewrites.append((gi, Ident(name)))

        if rel.window is not None and window is not None and not carried_window:
            raise PlanError("input is already windowed; nested windowing is invalid")

        # collect aggregates from select + having
        agg_calls: list[FuncCall] = []
        for it in q.items:
            if not isinstance(it.expr, Star):
                agg_calls.extend(find_aggregates(it.expr))
        if q.having is not None:
            agg_calls.extend(find_aggregates(q.having))
        uniq_aggs: list[FuncCall] = []
        for a in agg_calls:
            if a not in uniq_aggs:
                uniq_aggs.append(a)
        if not uniq_aggs and not key_exprs and window is None:
            raise PlanError("GROUP BY query with nothing to aggregate")

        aggregates: list[tuple[str, str, Optional[Expr]]] = []
        agg_rewrites: list[tuple[SqlExpr, SqlExpr]] = []
        agg_out_dtypes: dict[str, str] = {}
        for i, a in enumerate(uniq_aggs):
            out = f"__agg_{i}"
            if a.distinct:
                # COUNT(DISTINCT x): collect machinery in session/tumbling
                # windows; per-value multiplicity maps in the updating
                # aggregate (incl. retracting inputs — beyond the reference,
                # which rejects that case). Other DISTINCT aggregates remain
                # out of scope, like the reference's datafusion fork.
                if a.name != "count" or a.star or len(a.args) != 1:
                    raise PlanError(
                        "only COUNT(DISTINCT expr) is supported among "
                        "DISTINCT aggregates")
                e = compile_expr(a.args[0], rel.scope)
                aggregates.append((out, "count_distinct", e))
                agg_out_dtypes[out] = "int64"
                agg_rewrites.append((a, Ident(out)))
                continue
            if rel.updating and a.name in ("min", "max"):
                # reject at plan time: retractions need invertible
                # accumulators (sum/count/avg); min/max would crash at the
                # first retract row mid-stream
                raise PlanError(
                    f"{a.name}() over an updating input is unsupported "
                    "(non-invertible accumulator)"
                )
            if a.name == "count":
                aggregates.append((out, "count", None))
                agg_out_dtypes[out] = "int64"
            elif a.name == "array_agg":
                # collect-kind accumulator (reference datafusion array_agg +
                # UnnestRewriter pairing, rewriters.rs:323)
                if a.star or len(a.args) != 1:
                    raise PlanError("array_agg() takes exactly one argument")
                e = compile_expr(a.args[0], rel.scope)
                aggregates.append((out, "collect", e))
                agg_out_dtypes[out] = f"array:{infer_dtype(e, rel.dtypes)}"
            elif a.name not in ("sum", "min", "max", "avg"):
                from ..udf import lookup_udaf

                udaf = lookup_udaf(a.name)
                if udaf is None:
                    raise PlanError(f"unknown aggregate {a.name!r}")
                if a.star or len(a.args) != 1:
                    raise PlanError(
                        f"UDAF {a.name}() takes exactly one argument"
                    )
                e = compile_expr(a.args[0], rel.scope)
                aggregates.append((out, f"udaf:{udaf.name}", e))
                agg_out_dtypes[out] = udaf.return_dtype
            else:
                if a.star or not a.args:
                    raise PlanError(f"{a.name}(*) is not valid")
                e = compile_expr(a.args[0], rel.scope)
                aggregates.append((out, a.name, e))
                agg_out_dtypes[out] = agg_result_dtype(
                    a.name, infer_dtype(e, rel.dtypes)
                )
            agg_rewrites.append((a, Ident(out)))

        # KEY node
        keyed = bool(key_exprs)
        key_fields = [n for n, _e in key_exprs]
        key_dtypes: dict[str, str] = {}
        cur = rel
        if keyed:
            keys_cfg = []
            for n, ge in key_exprs:
                ce = compile_expr(ge, rel.scope)
                keys_cfg.append((n, ce))
                key_dtypes[n] = infer_dtype(ce, rel.dtypes)
            kid = self._id("key")
            self._add_node(kid, OpName.KEY, {"keys": keys_cfg})
            self._edge(cur, kid, EdgeType.FORWARD, cur.schema())
            mid_dtypes = dict(rel.dtypes)
            mid_dtypes.update(key_dtypes)
            cur = Rel(kid, mid_dtypes, rel.scope, rel.updating, rel.window, True)

        # aggregate node
        input_dtypes = dict(cur.dtypes)

        def dtype_of(e: Expr) -> np.dtype:
            return Field("_", infer_dtype(e, input_dtypes)).numpy_dtype()

        agg_cfg: dict = {
            "key_fields": key_fields,
            "aggregates": aggregates,
            "input_dtype_of": dtype_of,
            # declarative twin of the callable above: survives graph
            # serialization so shipped-IR workers can rebuild the resolver
            "input_dtypes": dict(input_dtypes),
        }
        updating_out = False
        if window is None:
            op = OpName.UPDATING_AGGREGATE
            if "updating_ttl" in self.settings:
                agg_cfg["ttl_micros"] = int(self.settings["updating_ttl"])
            updating_out = True
        elif carried_window:
            op = OpName.TUMBLING_AGGREGATE
            agg_cfg["width_micros"] = window.stride
        elif window.kind == "tumbling":
            op = OpName.TUMBLING_AGGREGATE
            agg_cfg["width_micros"] = window.width
        elif window.kind == "sliding":
            op = OpName.SLIDING_AGGREGATE
            agg_cfg["width_micros"] = window.width
            agg_cfg["slide_micros"] = window.slide
        else:
            op = OpName.SESSION_AGGREGATE
            agg_cfg["gap_micros"] = window.gap
        if rel.updating and window is not None:
            raise PlanError("windowed aggregates over updating inputs are unsupported")
        has_collect = any(k.startswith("udaf:") or k in ("collect", "count_distinct")
                          for _n, k, _e in aggregates)
        if (has_collect and op == OpName.UPDATING_AGGREGATE
                and all(k == "count_distinct" for _n, k, _e in aggregates
                        if k.startswith("udaf:") or k in ("collect", "count_distinct"))):
            # COUNT(DISTINCT) is invertible via per-value multiplicity maps,
            # so the updating aggregate supports it alongside any other
            # kinds this op takes (min/max over a RETRACTING input are
            # rejected by the earlier updating-input check, not here)
            has_collect = False
        if has_collect and op not in (OpName.SESSION_AGGREGATE,
                                      OpName.TUMBLING_AGGREGATE):
            # collected values are host-resident python lists; the sliding
            # path's partial-combine arithmetic and the updating path's
            # retractions have no list analog
            offenders = sorted({
                "COUNT(DISTINCT)" if k == "count_distinct"
                else "array_agg" if k == "collect" else k[5:] + "()"
                for _n, k, _e in aggregates
                if k.startswith("udaf:") or k in ("collect", "count_distinct")})
            raise PlanError(
                f"{', '.join(offenders)} supported in session and tumbling "
                "windows only")
        if has_collect and op == OpName.TUMBLING_AGGREGATE:
            # object lanes cannot ride HBM; force the host aggregator
            agg_cfg["backend"] = "numpy"
        aid = self._id("agg", op.value)
        self._add_node(aid, op, agg_cfg, parallelism=None if keyed else 1)
        self._edge(cur, aid, EdgeType.SHUFFLE if keyed else EdgeType.FORWARD, cur.schema())

        # post-aggregate scope: key fields, window cols, __agg_i
        post_dtypes: dict[str, str] = dict(key_dtypes)
        post_dtypes.update(agg_out_dtypes)
        post_scope = Scope()
        for n in key_fields:
            post_scope.add_col(None, n, n)
        for n in agg_out_dtypes:
            post_scope.add_col(None, n, n)
        window_payload = None
        if window is not None and window.kind != "session" or carried_window:
            post_dtypes[WINDOW_START] = "timestamp"
            post_dtypes[WINDOW_END] = "timestamp"
            if carried_window:
                end_e: Expr = BinOp("+", Col(WINDOW_START), Lit(window.width))
            else:
                end_e = Col(WINDOW_END)
            window_payload = (Col(WINDOW_START), end_e)
            post_scope.add_window(None, window_name, window_payload)
        elif window is not None and window.kind == "session":
            post_dtypes[WINDOW_START] = "timestamp"
            post_dtypes[WINDOW_END] = "timestamp"
            window_payload = (Col(WINDOW_START), Col(WINDOW_END))
            post_scope.add_window(None, window_name, window_payload)
        agg_rel = Rel(aid, post_dtypes, post_scope, updating_out, window, keyed)

        # final projection + HAVING
        rewrites = agg_rewrites + group_rewrites
        proj: list[tuple[str, Expr]] = []
        out_dtypes: dict[str, str] = {}
        out_scope = Scope()
        used: set = set()
        for i, it in enumerate(q.items):
            if isinstance(it.expr, Star):
                raise PlanError("SELECT * is invalid in an aggregate query")
            name = self._item_name(it, i)
            is_window_item = window_payload is not None and (
                it.expr in window_refs
                or (isinstance(it.expr, Ident) and it.expr.qualifier is None
                    and it.expr.name == window_name)
            )
            if is_window_item:
                # the window struct itself selected: project its columns
                out_scope.add_window(None, it.alias or window_name,
                                     (Col(WINDOW_START), Col(WINDOW_END)))
                out_scope.add_col(None, WINDOW_START, WINDOW_START)
                out_scope.add_col(None, WINDOW_END, WINDOW_END)
                proj.append((WINDOW_START, window_payload[0]))
                proj.append((WINDOW_END, window_payload[1]))
                out_dtypes[WINDOW_START] = "timestamp"
                out_dtypes[WINDOW_END] = "timestamp"
                continue
            e = replace_nodes(it.expr, rewrites)
            if name in used:
                name = f"{name}_{i}"
            used.add(name)
            ce = compile_expr(e, post_scope)
            proj.append((name, ce))
            out_dtypes[name] = infer_dtype(ce, post_dtypes)
            out_scope.add_col(None, name, name)
        having_e = None
        if q.having is not None:
            having_e = compile_expr(replace_nodes(q.having, rewrites), post_scope)
        pvid = self._id("value", "post_agg")
        self._add_node(pvid, OpName.VALUE, {"projections": proj, "filter": having_e})
        self._edge(agg_rel, pvid, EdgeType.FORWARD, agg_rel.schema())
        return Rel(pvid, out_dtypes, out_scope, updating_out, window, False)

    # ----------------------------------------------------------------- join

    def _plan_join(self, left: Rel, right: Rel, j) -> Rel:
        lq = left.scope.qualifiers()
        rq = right.scope.qualifiers()

        def side_of(e: SqlExpr) -> Optional[str]:
            """'l' / 'r' / None(ambiguous or neither) by compilability."""
            okl = okr = True
            try:
                compile_expr(e, left.scope)
            except SqlError:
                okl = False
            try:
                compile_expr(e, right.scope)
            except SqlError:
                okr = False
            if okl and not okr:
                return "l"
            if okr and not okl:
                return "r"
            if okl and okr:
                return "lr"
            return None

        from .ast import BinaryOp

        def win_side(e: SqlExpr) -> Optional[str]:
            """'l'/'r' when e names a window struct of that side."""
            if not isinstance(e, Ident):
                return None
            for tag, rel_ in (("l", left), ("r", right)):
                r = rel_.scope.try_resolve(e.qualifier, e.name)
                if r is not None and r[0] == "window":
                    return tag
            return None

        equi: list[tuple[SqlExpr, SqlExpr]] = []
        residual: list[SqlExpr] = []
        for c in _conjuncts(j.on):
            if isinstance(c, BinaryOp) and c.op == "==":
                wl, wr = win_side(c.left), win_side(c.right)
                if wl == "l" and wr == "r":
                    equi.append((c.left, c.right))
                    continue
                if wl == "r" and wr == "l":
                    equi.append((c.right, c.left))
                    continue
                sl, sr = side_of(c.left), side_of(c.right)
                if sl == "l" and sr == "r":
                    equi.append((c.left, c.right))
                    continue
                if sl == "r" and sr == "l":
                    equi.append((c.right, c.left))
                    continue
            residual.append(c)
        if not equi:
            raise PlanError("join requires at least one equality condition")

        windowed = (
            left.window is not None
            and right.window is not None
            and not left.updating
            and not right.updating
        )
        if residual and j.join_type != "inner":
            raise PlanError("non-equi join conditions require INNER JOIN")
        if windowed and left.window != right.window:
            raise PlanError(
                "windowed join requires both sides to share the same window "
                f"(left={left.window}, right={right.window}); InstantJoin "
                "matches rows per window-start bin"
            )

        # key exprs per side; window structs expand to (start, end)
        def key_exprs(side_rel: Rel, raw: SqlExpr) -> list[Expr]:
            if isinstance(raw, Ident):
                r = side_rel.scope.try_resolve(raw.qualifier, raw.name)
                if r is None and raw.qualifier is not None:
                    w = side_rel.scope.try_resolve(None, raw.qualifier)
                    if w is not None and w[0] == "window":
                        r = w  # window.start/.end handled by compile_expr
                if r is not None and r[0] == "window":
                    return [r[1][0], r[1][1]]
            return [compile_expr(raw, side_rel.scope)]

        lkeys: list[Expr] = []
        rkeys: list[Expr] = []
        for le, re_ in equi:
            lk = key_exprs(left, le)
            rk = key_exprs(right, re_)
            if len(lk) != len(rk):
                raise PlanError("cannot equate a window with a scalar in JOIN ON")
            lkeys.extend(lk)
            rkeys.extend(rk)

        def add_key_node(rel: Rel, keys: list[Expr], tag: str) -> Rel:
            keys_cfg = [(f"__jk_{i}", e) for i, e in enumerate(keys)]
            kid = self._id("key", f"join_{tag}")
            self._add_node(kid, OpName.KEY, {"keys": keys_cfg})
            self._edge(rel, kid, EdgeType.FORWARD, rel.schema())
            dt = dict(rel.dtypes)
            for (n, e) in keys_cfg:
                dt[n] = infer_dtype(e, rel.dtypes)
            return Rel(kid, dt, rel.scope, rel.updating, rel.window, True)

        lrel = add_key_node(left, lkeys, "l")
        rrel = add_key_node(right, rkeys, "r")

        # output column names: dedupe collisions with side qualifier prefixes
        def out_names(rel: Rel, other: Rel, prefix: str):
            pairs = []  # (out, src)
            mapping: dict[str, str] = {}
            other_names = {n for _q, n, k, _p in other.scope._order if k == "col"}
            for q, n, k, p in rel.scope._order:
                if k != "col" or p.startswith("__jk_"):
                    continue
                if p in mapping:
                    continue
                out = n if n not in other_names else f"{q or prefix}_{n}"
                mapping[p] = out
                pairs.append((out, p))
            return pairs, mapping

        lpairs, lmap = out_names(lrel, rrel, "left")
        rpairs, rmap = out_names(rrel, lrel, "right")

        jt = j.join_type
        cfg = {
            "join_type": jt,
            "left_names": lpairs,
            "right_names": rpairs,
        }
        if windowed:
            op = OpName.INSTANT_JOIN
            jid = self._id("join", "instant")
        else:
            op = OpName.JOIN_WITH_EXPIRATION
            jid = self._id("join", "updating")
            if "updating_ttl" in self.settings:
                cfg["ttl_micros"] = int(self.settings["updating_ttl"])
        self._add_node(jid, op, cfg)
        self._edge(lrel, jid, EdgeType.LEFT_JOIN, lrel.schema())
        self._edge(rrel, jid, EdgeType.RIGHT_JOIN, rrel.schema())

        out_scope = Scope()
        out_dtypes: dict[str, str] = {}
        nullable_l = jt in ("right", "full")
        nullable_r = jt in ("left", "full")
        for (rel_, mapping, nullable) in ((lrel, lmap, nullable_l), (rrel, rmap, nullable_r)):
            for q, n, k, p in rel_.scope._order:
                if k == "col":
                    if p in mapping:
                        out_scope.add_col(q, n, mapping[p])
                        out_dtypes[mapping[p]] = rel_.dtypes[p]
                else:
                    start, end = p
                    try:
                        out_scope.add_window(q, n, (rename_cols(start, mapping), rename_cols(end, mapping)))
                    except PlanError:
                        pass
        updating_out = not windowed
        window_out = left.window if windowed else None
        jrel = Rel(jid, out_dtypes, out_scope, updating_out, window_out, True)

        if residual:
            combined = residual[0]
            for c in residual[1:]:
                combined = BinaryOp("and", combined, c)
            f = compile_expr(combined, out_scope)
            vid = self._id("value", "join_filter")
            self._add_node(vid, OpName.VALUE, {"projections": None, "filter": f})
            self._edge(jrel, vid, EdgeType.FORWARD, jrel.schema())
            jrel = Rel(vid, out_dtypes, out_scope, updating_out, window_out, True)
        return jrel

    # -------------------------------------------------------- window fns

    def _plan_window_fn(self, rel: Rel, q: Select) -> Rel:
        if q.where is not None:
            filt = compile_expr(q.where, rel.scope)
            vid = self._id("value", "filter")
            self._add_node(vid, OpName.VALUE, {"projections": None, "filter": filt})
            self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
            rel = Rel(vid, rel.dtypes, rel.scope, rel.updating, rel.window, rel.keyed)

        pairs = self._expand_items(q.items, rel.scope)
        overs: list[tuple[str, OverExpr]] = []
        for name, e in pairs:
            for o in find_overs(e):
                overs.append((name, o))
        specs = {o.window for _n, o in overs}
        if len(specs) > 1:
            raise PlanError("all OVER clauses in one SELECT must share a window spec")
        spec = overs[0][1].window

        # partition fields must be physical columns; window structs -> start col
        part_fields: list[str] = []
        pre_proj_extra: list[tuple[str, Expr]] = []
        for i, pe in enumerate(spec.partition_by):
            if isinstance(pe, Ident):
                r = rel.scope.try_resolve(pe.qualifier, pe.name)
                if r is not None and r[0] == "window":
                    start, end = r[1]
                    if isinstance(start, Col):
                        part_fields.append(start.name)
                    else:
                        pre_proj_extra.append((f"__part_{i}", start))
                        part_fields.append(f"__part_{i}")
                    continue
                if r is not None:
                    part_fields.append(r[1])
                    continue
            ce = compile_expr(pe, rel.scope)
            if isinstance(ce, Col):
                part_fields.append(ce.name)
            else:
                pre_proj_extra.append((f"__part_{i}", ce))
                part_fields.append(f"__part_{i}")
        if pre_proj_extra:
            proj = [(n, Col(n)) for n in rel.dtypes] + pre_proj_extra
            vid = self._id("value", "part_keys")
            self._add_node(vid, OpName.VALUE, {"projections": proj})
            self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
            dt = dict(rel.dtypes)
            for n, e in pre_proj_extra:
                dt[n] = infer_dtype(e, rel.dtypes)
            rel = Rel(vid, dt, rel.scope, rel.updating, rel.window, rel.keyed)

        order_by = [(compile_expr(e, rel.scope), asc) for e, asc in spec.order_by]

        functions: list[tuple[str, str, Optional[Expr]]] = []
        over_rewrites: list[tuple[SqlExpr, SqlExpr]] = []
        for i, (_iname, o) in enumerate(overs):
            fname = o.func.name
            out = f"__wf_{i}"
            if fname in RANKING_FUNCS:
                functions.append((out, fname, None))
            elif fname in AGG_FUNCS:
                arg = None
                if not o.func.star and o.func.args:
                    arg = compile_expr(o.func.args[0], rel.scope)
                functions.append((out, fname, arg))
            else:
                raise PlanError(f"unsupported window function {fname!r}")
            over_rewrites.append((o, Ident(out)))

        # shuffle by partition so parallel instances see whole partitions
        key_cfg = [(f, Col(f)) for f in part_fields]
        cur: Rel = rel
        keyed = bool(part_fields)
        if keyed:
            kid = self._id("key", "wf")
            self._add_node(kid, OpName.KEY, {"keys": key_cfg})
            self._edge(cur, kid, EdgeType.FORWARD, cur.schema())
            cur = Rel(kid, rel.dtypes, rel.scope, rel.updating, rel.window, True)

        wf_cfg = {
            "partition_fields": part_fields,
            "order_by": order_by,
            "functions": functions,
        }
        wid = self._id("window_fn")
        self._add_node(wid, OpName.WINDOW_FUNCTION, wf_cfg, parallelism=None if keyed else 1)
        self._edge(cur, wid, EdgeType.SHUFFLE if keyed else EdgeType.FORWARD, cur.schema())
        post_dtypes = dict(rel.dtypes)
        for out, kind, arg in functions:
            if kind in RANKING_FUNCS or kind == "count":
                post_dtypes[out] = "int64"
            elif kind == "avg":
                post_dtypes[out] = "float64"
            else:
                post_dtypes[out] = infer_dtype(arg, rel.dtypes) if arg is not None else "int64"
        post_scope = Scope()
        for q_, n, k, p in rel.scope._order:
            if k == "col":
                post_scope.add_col(q_, n, p)
            else:
                post_scope.add_window(q_, n, p)
        for out, _k, _a in functions:
            post_scope.add_col(None, out, out)
        wf_rel = Rel(wid, post_dtypes, post_scope, rel.updating, rel.window, keyed)

        # final projection applying the item expressions
        proj = []
        out_dtypes: dict[str, str] = {}
        out_scope = Scope()
        for name, e in pairs:
            if isinstance(e, Ident):
                r = rel.scope.try_resolve(e.qualifier, e.name)
                if r is not None and r[0] == "window":
                    start_e, end_e = r[1]
                    proj.append((WINDOW_START, start_e))
                    proj.append((WINDOW_END, end_e))
                    out_dtypes[WINDOW_START] = "timestamp"
                    out_dtypes[WINDOW_END] = "timestamp"
                    out_scope.add_window(None, name, (Col(WINDOW_START), Col(WINDOW_END)))
                    continue
            ce = compile_expr(replace_nodes(e, over_rewrites), post_scope)
            proj.append((name, ce))
            out_dtypes[name] = infer_dtype(ce, post_dtypes)
            out_scope.add_col(None, name, name)
        pvid = self._id("value", "post_wf")
        self._add_node(pvid, OpName.VALUE, {"projections": proj})
        self._edge(wf_rel, pvid, EdgeType.FORWARD, wf_rel.schema())
        return Rel(pvid, out_dtypes, out_scope, rel.updating, rel.window, False)

    # ---------------------------------------------------------------- union

    def _plan_union(self, q: Select) -> Rel:
        if any(how != "all" for how, _r in q.union):
            raise PlanError("UNION DISTINCT is unsupported; use UNION ALL")
        lhs = Select(
            q.items, q.from_table, q.joins, q.where, q.group_by, q.having,
            q.order_by, q.limit, q.distinct,
        )
        lrel = self.plan_select(lhs)
        lnames = list(lrel.dtypes)
        branches: list[Rel] = [lrel]
        updating = lrel.updating
        for _how, rhs_q in q.union:
            rrel = self.plan_select(rhs_q)
            rnames = list(rrel.dtypes)
            if len(lnames) != len(rnames):
                raise PlanError("UNION sides have different column counts")
            # align each branch positionally to the left's names
            rproj = [(ln, Col(rn)) for ln, rn in zip(lnames, rnames)]
            rvid = self._id("value", "union_align")
            self._add_node(rvid, OpName.VALUE, {"projections": rproj})
            self._edge(rrel, rvid, EdgeType.FORWARD, rrel.schema())
            branches.append(Rel(rvid, dict(lrel.dtypes), lrel.scope, rrel.updating))
            updating = updating or rrel.updating
        uid = self._id("value", "union")
        self._add_node(uid, OpName.VALUE, {"projections": None})
        out_schema = lrel.schema()
        for b in branches:
            self._edge(b, uid, EdgeType.FORWARD, out_schema)
        scope = Scope()
        for n in lnames:
            scope.add_col(None, n, n)
        return Rel(uid, dict(lrel.dtypes), scope, updating, None, False)

    # ---------------------------------------------------------------- sinks

    def _plan_insert(self, stmt: Insert) -> None:
        rel = self.plan_select(stmt.query)
        if stmt.table not in self.tables:
            raise PlanError(f"unknown sink table {stmt.table!r}")
        decl = self.tables[stmt.table]
        if decl.ttype == "source":
            raise PlanError(f"table {stmt.table!r} is a source; cannot INSERT into it")
        if decl.options.get("connector") is None:
            # memory table: no sink node — the coerced stream itself becomes
            # the named relation later FROM clauses read
            if stmt.table in self.memory_rels:
                raise PlanError(
                    f"memory table {stmt.table!r} already written; multiple "
                    "INSERTs into one memory table are unsupported")
            self.memory_rels[stmt.table] = self._coerce_to_decl(rel, decl)
            return
        out_names = list(rel.dtypes)
        sink_cols = decl.physical_columns()
        if sink_cols:
            if len(sink_cols) != len(out_names):
                raise PlanError(
                    f"INSERT INTO {stmt.table}: query produces {len(out_names)} "
                    f"columns but sink has {len(sink_cols)}"
                )
            proj = []
            fields = []
            for c, src in zip(sink_cols, out_names):
                dt = sql_type_to_dtype(c.type_name)
                src_dt = rel.dtypes[src]
                e: Expr = Col(src)
                if dt != src_dt and not (
                    {dt, src_dt} <= {"timestamp", "int64"}
                ):
                    e = Cast(e, "int64" if dt == "timestamp" else dt)
                proj.append((c.name, e))
                fields.append(Field(c.name, dt, c.nullable))
            sink_schema = Schema(tuple(fields) + (Field(TIMESTAMP_FIELD, "int64"),))
            cvid = self._id("value", "sink_coerce")
            self._add_node(cvid, OpName.VALUE, {"projections": proj})
            self._edge(rel, cvid, EdgeType.FORWARD, rel.schema())
            src_id = cvid
        else:
            fields = [Field(n, d) for n, d in rel.dtypes.items()]
            sink_schema = Schema(tuple(fields) + (Field(TIMESTAMP_FIELD, "int64"),))
            src_id = rel.node_id
        cfg = dict(decl.options)
        cfg.pop("type", None)
        cfg["connector"] = decl.connector
        cfg["schema"] = sink_schema
        sid = self._id("sink", decl.name)
        self._add_node(sid, OpName.SINK, cfg, parallelism=1,
                       description=f"{decl.connector}:{decl.name}")
        self._edge(src_id, sid, EdgeType.FORWARD, sink_schema)
        self.sinks.append(SinkInfo(sid, stmt.table, decl.connector))

    def _coerce_to_decl(self, rel: Rel, decl: TableDecl) -> Rel:
        """Project a query's output positionally onto a declared column list
        (names + dtypes), as the sink path does, yielding a Rel scoped under
        the declared names — the body of a memory table."""
        cols = decl.physical_columns()
        out_names = list(rel.dtypes)
        if not cols:
            return rel
        if len(cols) != len(out_names):
            raise PlanError(
                f"INSERT INTO {decl.name}: query produces {len(out_names)} "
                f"columns but table declares {len(cols)}")
        proj = []
        dtypes: dict[str, str] = {}
        for c, src in zip(cols, out_names):
            dt = sql_type_to_dtype(c.type_name)
            src_dt = rel.dtypes[src]
            e: Expr = Col(src)
            if dt != src_dt and not ({dt, src_dt} <= {"timestamp", "int64"}):
                e = Cast(e, "int64" if dt == "timestamp" else dt)
            proj.append((c.name, e))
            dtypes[c.name] = dt
        vid = self._id("value", f"{decl.name}_memory")
        self._add_node(vid, OpName.VALUE, {"projections": proj})
        self._edge(rel, vid, EdgeType.FORWARD, rel.schema())
        scope = Scope()
        for c in cols:
            scope.add_col(None, c.name, c.name)
        return Rel(vid, dtypes, scope, rel.updating, rel.window, rel.keyed)

    def _plan_preview(self, q: Select) -> None:
        rel = self.plan_select(q)
        rows: list = []
        sid = self._id("sink", "preview")
        self._add_node(
            sid, OpName.SINK,
            {"connector": "preview", "rows": rows, "schema": rel.schema()},
            parallelism=1,
        )
        self._edge(rel, sid, EdgeType.FORWARD, rel.schema())
        self.sinks.append(SinkInfo(sid, "<preview>", "preview", rows))


def connection_table_decl(ct: dict) -> TableDecl:
    """A registered connection table (API CRUD rows: name, connector,
    table_type, config, schema_fields) as a planner TableDecl — pipelines
    reference it by name with no inline DDL (reference connection_tables
    registered into the ArroyoSchemaProvider, tables.rs)."""
    from .ast import ColumnDef

    cols = tuple(
        ColumnDef(f["name"], str(f.get("type", "TEXT")).upper(),
                  bool(f.get("nullable", True)))
        for f in ct.get("schema_fields", [])
    )
    options = dict(ct.get("config") or {})
    options["connector"] = ct["connector"]
    options["type"] = ct.get("table_type", "source")
    return TableDecl(ct["name"], cols, options)


def plan_query(sql: str, parallelism: int = 1,
               connection_tables: Optional[list[dict]] = None,
               analyze: bool = True) -> PlannedPipeline:
    """Plan a SQL script; with ``analyze`` (the default) the static plan
    analyzer (arroyo_tpu_torch.analysis) then validates the graph — ERROR
    diagnostics raise AnalysisError (a SqlError) before any execution,
    WARNING diagnostics are logged. Pass analyze=False to collect the full
    diagnostic list yourself (the `check` CLI does)."""
    p = Planner(parallelism)
    for ct in connection_tables or []:
        p.tables[ct["name"]] = connection_table_decl(ct)
    pp = p.plan(sql)
    if analyze:
        from ..analysis import AnalysisError, Severity, analyze_graph

        diags = analyze_graph(pp.graph)
        errors = [d for d in diags if d.severity == Severity.ERROR]
        if errors:
            raise AnalysisError(errors)
        for d in diags:
            _log.warning("plan analysis: %s", d.render())
    return pp


def set_parallelism(graph: Graph, n: int) -> None:
    """Force internal parallelism for tests (reference smoke_tests
    set_internal_parallelism, engine.rs:232-298): scale every node except
    sinks (output determinism) and keyless global stages (pinned at 1)."""
    for node in graph.nodes.values():
        if node.op == OpName.SINK:
            continue
        if node.parallelism == 1 and node.op in (
            OpName.TUMBLING_AGGREGATE, OpName.SLIDING_AGGREGATE,
            OpName.SESSION_AGGREGATE, OpName.UPDATING_AGGREGATE,
            OpName.WINDOW_FUNCTION,
        ) and not node.config.get("key_fields") and not node.config.get("partition_fields"):
            continue  # global stage must stay single-instance
        node.parallelism = n


def executed_graph_view(sql: str, parallelism: int = 1,
                        connection_tables: Optional[list[dict]] = None
                        ) -> tuple[list[dict], list[dict]]:
    """The plan as the engine EXECUTES it — parallelism applied, Forward
    runs fused when ``pipeline.chaining.enabled`` — as plain node/edge
    dicts (the ``/pipelines/<id>/graph`` payload shape). Runtime metrics
    and the cost profile key by the executed graph's node ids (``"a+b"``
    for a chained run), so every plan-annotating consumer (the graph API
    endpoint, ``explain``) must derive its view here or its ids drift from
    the ones the runtime reports."""
    pp = plan_query(sql, connection_tables=connection_tables)
    if parallelism > 1:
        set_parallelism(pp.graph, parallelism)
    g = pp.graph
    from ..config import config as _cfg

    if _cfg().get("pipeline.chaining.enabled"):
        from ..optimizer import chain_graph

        g = chain_graph(g)
    compile_on = _cfg().get("segment.compile.enabled", True)
    nodes = [{"id": n.node_id, "op": n.op.value,
              "description": n.description or n.op.value,
              "parallelism": n.parallelism,
              # plan-time marking (optimizer.chain_graph): this chained run
              # will be offered to the whole-segment compiler. Runtime truth
              # (compiled vs fell back) rides the profile's
              # ``segment_compiled`` flag and the SEGMENT_* events
              **({"compilable": True}
                 if compile_on and n.config.get("compile") else {}),
              # the plan-time reject reason (optimizer.chain_graph /
              # AR009): consumers render "why is my segment not compiled"
              # without waiting for a runtime fallback event
              **({"not_compilable": n.config["compile_reject"]}
                 if compile_on and n.config.get("compile_reject") else {})}
             for n in g.nodes.values()]
    edges = [{"src": e.src, "dst": e.dst, "type": e.edge_type.value}
             for e in g.edges]
    return nodes, edges
