"""Plan-time dataflow analysis: a pass framework over the logical Graph.

The port's copy of the JAX package's ``analysis/plan_passes.py``. Runs
automatically at the end of SQL planning (sql/planner.py). Each pass walks
the planned graph and emits Diagnostics; ERROR findings reject the pipeline
before any state is allocated or a device step built.

Rule catalog:

    AR001 edge-schema-consistency   operator configs must only reference
                                    columns their input edges carry
    AR002 unaligned-hop             hop() slide must evenly divide width
    AR003 updating-into-window      retracting streams cannot feed
                                    event-time window operators
    AR004 unbounded-state           non-TTL'd updating state over unbounded
                                    sources grows without bound (warning)
    AR005 retraction-sink-mismatch  updating operator feeding an
                                    append-only-formatted sink (warning)
    AR006 barrier-reachability      every operator must sit downstream of
                                    sources so checkpoint barriers reach it
    AR007 shuffle-key-consistency   shuffle edges must be keyed upstream
                                    with exactly the keys the consumer
                                    groups by
    AR008 table-spec-consistency    each node's declared TableSpecs must be
                                    collision-free (duplicate names would
                                    share one checkpoint file per subtask)
                                    and expiring specs must carry the
                                    operator's configured TTL (a mismatch
                                    silently widens or narrows the state
                                    restore window)
    AR009 segment-compilability     (trace_audit.pass_segment_compile)
                                    dual-path dtype parity of plan-marked-
                                    compilable segments: reject when the
                                    traced program would compute in a
                                    different dtype than the interpreted
                                    path; surface each unmarked chain's
                                    ``not compilable: <reason>`` as INFO
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..batch import KEY_FIELD, TIMESTAMP_FIELD, Schema
from ..graph import EdgeType, Graph, Node, OpName
from .diagnostics import Diagnostic, Severity, finish

IS_RETRACT_FIELD = "_is_retract"

# connectors whose sources always terminate; impulse/nexmark are bounded
# only when an explicit count option caps them
_BOUNDED_CONNECTORS = {"single_file", "vec", "filesystem"}
_COUNT_CAPPED = {"impulse": "message_count", "nexmark": "event_count"}

_WINDOWED_OPS = (
    OpName.TUMBLING_AGGREGATE,
    OpName.SLIDING_AGGREGATE,
    OpName.SESSION_AGGREGATE,
    OpName.INSTANT_JOIN,
)

# operators that hold checkpointed state: a barrier that cannot reach them
# means their snapshots never cut consistently
_STATEFUL_OPS = _WINDOWED_OPS + (
    OpName.UPDATING_AGGREGATE,
    OpName.JOIN_WITH_EXPIRATION,
    OpName.WINDOW_FUNCTION,
    OpName.LOOKUP_JOIN,
)


class PassContext:
    """Graph + shared derived maps handed to every pass."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.diags: list[Diagnostic] = []
        self._updating: Optional[dict[str, bool]] = None
        self._unbounded: Optional[dict[str, bool]] = None

    def add(self, rule_id: str, severity: Severity, site: str, message: str,
            hint: str = "") -> None:
        self.diags.append(Diagnostic(rule_id, severity, site, message, hint))

    # ---------------------------------------------------- derived properties

    def updating(self) -> dict[str, bool]:
        """node id -> does its OUTPUT stream carry retractions. Mirrors the
        planner's Rel.updating trait, recomputed from the graph alone so
        shipped/hand-built IR is checked too."""
        if self._updating is None:
            out: dict[str, bool] = {}
            for node in self.graph.topo_order():
                ins = [out.get(e.src, False) for e in self.graph.in_edges(node.node_id)]
                if node.op == OpName.SOURCE:
                    upd = str(node.config.get("format", "")) == "debezium_json"
                elif node.op in (OpName.UPDATING_AGGREGATE, OpName.JOIN_WITH_EXPIRATION):
                    upd = True
                elif node.op in _WINDOWED_OPS:
                    upd = False  # event-time windows emit append-only results
                else:  # value/key/watermark/unnest/async_udf/window_fn/... pass through
                    upd = any(ins)
                out[node.node_id] = upd
            self._updating = out
        return self._updating

    def unbounded(self) -> dict[str, bool]:
        """node id -> is it fed (transitively) by an unbounded source."""
        if self._unbounded is None:
            out: dict[str, bool] = {}
            for node in self.graph.topo_order():
                if node.op == OpName.SOURCE:
                    conn = str(node.config.get("connector", ""))
                    if conn in _BOUNDED_CONNECTORS:
                        ub = False
                    elif conn in _COUNT_CAPPED:
                        ub = node.config.get(_COUNT_CAPPED[conn]) is None
                    else:
                        ub = True
                else:
                    ub = any(out.get(e.src, False)
                             for e in self.graph.in_edges(node.node_id))
                out[node.node_id] = ub
            self._unbounded = out
        return self._unbounded

    def input_columns(self, node_id: str) -> set[str]:
        """Union of column names this node's input edges deliver (plus the
        implicit system columns every batch may carry)."""
        cols: set[str] = {TIMESTAMP_FIELD, KEY_FIELD, IS_RETRACT_FIELD}
        for e in self.graph.in_edges(node_id):
            cols.update(f.name for f in e.schema.fields)
        return cols


def _expr_columns(obj) -> set[str]:
    """Column names referenced anywhere inside a config value holding
    Expr nodes (single expr, (name, expr) pairs, nested lists)."""
    from ..expr import Expr

    out: set[str] = set()
    if isinstance(obj, Expr):
        out |= obj.columns()
    elif isinstance(obj, dict):
        for v in obj.values():
            out |= _expr_columns(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out |= _expr_columns(v)
    return out


def _fmt_micros(us: int) -> str:
    if us % 1_000_000 == 0:
        return f"{us // 1_000_000}s"
    if us % 1000 == 0:
        return f"{us // 1000}ms"
    return f"{us}us"


# --------------------------------------------------------------------- passes


def pass_edge_schema(ctx: PassContext) -> None:
    """AR001: operator configs may only name columns their inputs carry.
    (Duplicate edge columns are impossible here: Schema.__post_init__
    already rejects them at construction.)"""
    # which config keys hold input-referencing expressions, per operator
    expr_keys = {
        OpName.VALUE: ("projections", "filter"),
        OpName.KEY: ("keys",),
        OpName.WATERMARK: ("expr",),
        OpName.ASYNC_UDF: ("arg_exprs",),
        OpName.TUMBLING_AGGREGATE: ("aggregates",),
        OpName.SLIDING_AGGREGATE: ("aggregates",),
        OpName.SESSION_AGGREGATE: ("aggregates",),
        OpName.UPDATING_AGGREGATE: ("aggregates",),
        OpName.WINDOW_FUNCTION: ("order_by", "functions"),
        OpName.UNNEST: (),  # references its input by name, not by Expr
    }
    for node in ctx.graph.nodes.values():
        keys = expr_keys.get(node.op)
        if keys is None or not ctx.graph.in_edges(node.node_id):
            continue
        avail = ctx.input_columns(node.node_id)
        used: set[str] = set()
        for k in keys:
            used |= _expr_columns(node.config.get(k))
        if node.op == OpName.UNNEST:
            used.add(str(node.config.get("column")))
        missing = sorted(used - avail)
        if missing:
            ctx.add("AR001", Severity.ERROR, node.node_id,
                    f"{node.op.value} references column(s) {missing} absent "
                    f"from its input edge schema(s)",
                    "a projection upstream dropped or renamed them; carry "
                    "them through or fix the reference")


def pass_watermark_safety(ctx: PassContext) -> None:
    """AR002: unaligned hop(); AR003: updating inputs into event-time
    window operators (their watermark-driven flushes cannot retract)."""
    updating = ctx.updating()
    for node in ctx.graph.nodes.values():
        if node.op == OpName.SLIDING_AGGREGATE:
            width = int(node.config.get("width_micros", 0))
            slide = int(node.config.get("slide_micros", 0))
            if width <= 0 or slide <= 0 or width % slide != 0:
                ctx.add(
                    "AR002", Severity.ERROR, node.node_id,
                    f"hop(slide={_fmt_micros(slide)}, width={_fmt_micros(width)}) "
                    "is unaligned: the slide must be a positive divisor of the "
                    "width",
                    f"use a width that is a multiple of the slide, e.g. "
                    f"hop(interval '{max(slide, 1) // 1_000_000 or 1} seconds', "
                    f"interval '{(max(width // max(slide, 1), 1)) * (max(slide, 1) // 1_000_000 or 1)} seconds')",
                )
        if node.op in _WINDOWED_OPS:
            bad = [e.src for e in ctx.graph.in_edges(node.node_id)
                   if updating.get(e.src, False)]
            if bad:
                ctx.add(
                    "AR003", Severity.ERROR, node.node_id,
                    f"{node.op.value} consumes an updating (retracting) input "
                    f"from {sorted(bad)}; event-time windows emit once per "
                    "window and cannot retract already-emitted results",
                    "aggregate the updating stream with a non-windowed "
                    "(updating) aggregate, or window before the retracting "
                    "operator",
                )


def pass_unbounded_state(ctx: PassContext) -> None:
    """AR004: state that only grows. A non-windowed join or updating
    aggregate over an unbounded source with no TTL retains every key
    forever; the job dies by memory, slowly."""
    unbounded = ctx.unbounded()
    for node in ctx.graph.nodes.values():
        if not unbounded.get(node.node_id, False):
            continue
        if node.config.get("ttl_micros"):
            continue
        if node.op == OpName.JOIN_WITH_EXPIRATION:
            ctx.add(
                "AR004", Severity.WARNING, node.node_id,
                "non-windowed join over unbounded input(s) with no TTL: both "
                "join-side state tables retain every key seen, so state "
                "grows linearly with distinct keys for the life of the job",
                "SET updating_ttl = '1 hour' (or window both sides) to bound "
                "retained state",
            )
        elif node.op == OpName.UPDATING_AGGREGATE:
            ctx.add(
                "AR004", Severity.WARNING, node.node_id,
                "updating aggregate over unbounded input with no TTL: one "
                "accumulator per distinct group key is retained forever, so "
                "state grows with key cardinality for the life of the job",
                "SET updating_ttl = '1 hour' to expire idle groups, or use "
                "an event-time window",
            )


def pass_retraction_sink(ctx: PassContext) -> None:
    """AR005: updating stream into an append-only-formatted sink. The
    engine falls back to Debezium envelopes, so a consumer reading the
    declared plain format sees op/before/after wrappers it did not ask
    for (or double-counts retracted rows)."""
    updating = ctx.updating()
    for node in ctx.graph.nodes.values():
        if node.op != OpName.SINK:
            continue
        conn = str(node.config.get("connector", ""))
        if conn in ("preview", "stdout", "blackhole"):
            continue  # debug sinks render anything
        fmt = str(node.config.get("format", "json"))
        if fmt == "debezium_json":
            continue
        if any(updating.get(e.src, False) for e in ctx.graph.in_edges(node.node_id)):
            ctx.add(
                "AR005", Severity.WARNING, node.node_id,
                f"sink declares append-only format {fmt!r} but receives an "
                "updating stream; rows will be wrapped in Debezium "
                "envelopes the declared schema does not describe",
                "declare format = 'debezium_json' on the sink, or make the "
                "feeding query append-only (window the aggregate/join)",
            )


def pass_barrier_reachability(ctx: PassContext) -> None:
    """AR006: checkpoint barriers flow from sources; an operator with no
    path from a source never aligns a barrier, so its state is never
    snapshotted consistently. Also flags sources whose output reaches no
    sink (dead subgraphs hold barriers/watermarks for nothing)."""
    g = ctx.graph
    for node in g.nodes.values():
        if node.op != OpName.SOURCE and not g.in_edges(node.node_id):
            ctx.add(
                "AR006", Severity.ERROR, node.node_id,
                f"{node.op.value} has no input edges: checkpoint barriers "
                "can never reach it, so it will stall every checkpoint "
                "epoch",
                "connect it downstream of a source or remove it",
            )
    # source -> reaches-a-sink
    reaches_sink: dict[str, bool] = {}
    for node in reversed(g.topo_order()):
        if node.op == OpName.SINK:
            reaches_sink[node.node_id] = True
        else:
            reaches_sink[node.node_id] = any(
                reaches_sink.get(e.dst, False) for e in g.out_edges(node.node_id)
            )
    for node in g.nodes.values():
        if node.op == OpName.SOURCE and not reaches_sink.get(node.node_id, False):
            ctx.add(
                "AR006", Severity.WARNING, node.node_id,
                "source output never reaches a sink; it still gates "
                "watermarks and checkpoint barriers for the whole pipeline",
                "remove the dead branch or add the missing INSERT INTO",
            )


def pass_shuffle_keys(ctx: PassContext) -> None:
    """AR007: a shuffle edge repartitions by the _key routing hash; the
    nearest upstream KEY node must compute exactly the columns the
    consumer groups/partitions by, or parallel instances see torn groups."""
    g = ctx.graph
    for e in g.edges:
        if e.edge_type != EdgeType.SHUFFLE:
            continue
        dst = g.nodes[e.dst]
        want = list(dst.config.get("key_fields")
                    or dst.config.get("partition_fields") or [])
        # walk up through forwarding operators to the key calculation
        cur = e.src
        seen = set()
        key_node: Optional[Node] = None
        while cur not in seen:
            seen.add(cur)
            n = g.nodes[cur]
            if n.op == OpName.KEY:
                key_node = n
                break
            ins = g.in_edges(cur)
            if n.op in (OpName.VALUE, OpName.WATERMARK) and len(ins) == 1:
                cur = ins[0].src
                continue
            break
        if key_node is None:
            ctx.add(
                "AR007", Severity.ERROR, f"{e.src} -> {e.dst}",
                "shuffle edge with no upstream key calculation: batches "
                "carry no _key routing hash, so repartitioning is undefined",
                "insert a KEY node computing the consumer's group-by "
                "columns before the shuffle",
            )
            continue
        have = [name for name, _expr in key_node.config.get("keys", [])]
        if want and sorted(have) != sorted(want):
            ctx.add(
                "AR007", Severity.ERROR, f"{e.src} -> {e.dst}",
                f"shuffle key mismatch: upstream keys by {sorted(have)} but "
                f"{dst.op.value} groups by {sorted(want)}; rows of one group "
                "would land on different instances",
                "make the KEY node compute exactly the consumer's group-by "
                "columns",
            )


def pass_table_specs(ctx: PassContext) -> None:
    """AR008: instantiate each node's operator (the registered constructor,
    exactly what the engine will build) and audit its declared TableSpecs.

    Duplicate names within one node collide on the checkpoint path scheme
    — ``operator-{op}/table-{name}-{subtask}`` — so two tables would write
    one file and restore would resurrect whichever won. An expiring spec
    whose retention differs from the operator's configured ``ttl_micros``
    makes restore load a different horizon than the live operator expires,
    so recovered state diverges from the state the run would have had.
    Nodes whose constructor is unavailable here (unregistered connector,
    missing client package) are skipped — the audit proves what it can
    see, it does not block planning on optional dependencies."""
    from ..engine.engine import construct_operator

    for node in ctx.graph.nodes.values():
        try:
            # a COPY of the config: constructors may validate-and-mutate
            # their cfg (e.g. setdefault a Lock), and the analysis probe
            # must not plant runtime objects into the planned graph
            op = construct_operator(node.op, dict(node.config))
            specs = list(op.tables())
        except Exception:
            continue
        seen: dict[str, int] = {}
        for s in specs:
            seen[s.name] = seen.get(s.name, 0) + 1
        for name in sorted(n for n, c in seen.items() if c > 1):
            ctx.add(
                "AR008", Severity.ERROR, node.node_id,
                f"{node.op.value} declares {seen[name]} state tables named "
                f"{name!r}: the checkpoint path scheme keys files by "
                "(operator, table, subtask), so they would overwrite each "
                "other and restore would resurrect only one",
                "give every TableSpec a unique name within the operator "
                "(chained members are prefixed c<i>. for exactly this "
                "reason)",
            )
        ttl = node.config.get("ttl_micros")
        if not ttl:
            continue
        ttl = int(ttl)
        for s in specs:
            if s.kind != "expiring_time_key" or s.retention_micros == ttl:
                continue
            ctx.add(
                "AR008", Severity.ERROR, node.node_id,
                f"{node.op.value} is configured with ttl_micros="
                f"{_fmt_micros(ttl)} but declares table {s.name!r} with "
                f"retention {_fmt_micros(s.retention_micros)}: restore "
                "would load a different state horizon than the live "
                "operator expires",
                "derive the TableSpec retention from the configured TTL",
            )


# AR009 lives with the trace-safety auditor (dual-path dtype model shared
# with the LR3xx rules) but runs as an ordinary plan pass
from .trace_audit import pass_segment_compile  # noqa: E402

PLAN_PASSES: tuple[tuple[str, Callable[[PassContext], None]], ...] = (
    ("edge-schema-consistency", pass_edge_schema),
    ("watermark-safety", pass_watermark_safety),
    ("unbounded-state", pass_unbounded_state),
    ("retraction-sink-mismatch", pass_retraction_sink),
    ("barrier-reachability", pass_barrier_reachability),
    ("shuffle-key-consistency", pass_shuffle_keys),
    ("table-spec-consistency", pass_table_specs),
    ("segment-compilability", pass_segment_compile),
)


def analyze_graph(graph: Graph) -> list[Diagnostic]:
    """Run every plan pass; returns deterministically ordered diagnostics
    (never raises — callers decide what severity rejects)."""
    ctx = PassContext(graph)
    for _name, p in PLAN_PASSES:
        p(ctx)
    return finish(ctx.diags)
