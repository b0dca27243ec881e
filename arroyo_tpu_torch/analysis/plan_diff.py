"""Plan-diff pass: prove which operator state survives a live evolution
(the port's copy of the JAX package's ``analysis/plan_diff.py``: the same
identities, classifications, diagnostics, mapping and fingerprint, so a
plan hash stamped by either package matches the other's).

Live pipeline evolution restarts a *modified* plan from its predecessor's
final checkpoint. Checkpointed bytes
are keyed by ``operator-{node_id}/table-{name}`` and typed by the operator
that wrote them, so restoring them under a changed plan is only sound when
the new operator would read exactly the layout the old one wrote. This pass
decides that at plan time — the same prove-don't-hope posture as the
replay-soundness auditor (LR2xx): it reuses LR203's literal table-name model
(operators declare their state as literal ``TableSpec`` names; the
checkpoint/restore sets must agree) and AR008's spec-instantiation machinery
(instantiate the registered constructor, read ``tables()`` — exactly what
the engine will build) to derive a per-node **state identity**:

    (op kind, declared TableSpecs, state-shaping config digest)

where the config digest covers everything that shapes state bytes or their
meaning: key fields, window widths/slides/gaps, TTLs, aggregate expressions,
connector/format/path of sources and sinks. Parallelism and descriptions are
excluded — rescale never changes state identity.

Operators are matched across the old and new graphs by stable lineage
(node id, then counter-stripped node name + identity, then identity alone —
planner node ids embed a sequence counter, so inserting one operator renames
everything planned after it) and every node is classified:

    carried        identical state identity: state restored verbatim from
                   the old node's checkpoint directory
    stateless      declares no state tables; nothing to carry
    rebuilt        a genuinely new stateful operator: restores nothing and
                   re-derives its state from rows replayed after the carried
                   source offsets (AR011, INFO). A redefined SINK also lands
                   here, not in incompatible: its only state is transient
                   pending-commit buffers, which the evolve drain's final
                   checkpoint-then-stop flushed to committed output before
                   the old set exited
    dropped        an old stateful operator with no successor: its state is
                   explicitly dropped and logged at restore (AR012, WARNING)
    incompatible   same lineage but changed identity (schema/key/window/
                   aggregate change): the new operator would misread the old
                   bytes, and re-deriving from mid-stream offsets would
                   silently lose the pre-checkpoint prefix — hard ERROR
                   (AR010), the pipeline never reaches Scheduling

``plan_fingerprint`` is the plan-hash stamped into job-level checkpoint
metadata and verified at restore: a restore against a different plan fails
loudly unless an explicit evolution mapping (the ``mapping`` this pass
emits) covers the change — degrade-not-corrupt.

Rule catalog (README "Static analysis" documents each):

    AR010 evolve-incompatible       changed state identity on a surviving
                                    operator would misread checkpointed
                                    bytes (ERROR; rejects the evolution)
    AR011 evolve-rebuilt            new stateful operator re-derives from
                                    replay; its pre-evolution prefix does
                                    not exist (INFO)
    AR012 evolve-dropped-state      old operator state has no successor and
                                    will be dropped (WARNING)
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from typing import Optional

from ..graph import Graph, Node, OpName, _jsonable
from .diagnostics import Diagnostic, Severity, finish

# config keys that never shape state bytes: layout/runtime decoration and
# pacing knobs (they change WHEN rows emit, never what checkpointed state
# means — a rethrottled source restores against the same fingerprint)
_NON_STATE_KEYS = ("description", "parallelism", "event_rate", "rate_phases",
                   "idle-time-ms")

# planner node ids are f"{kind}_{counter}" or f"{kind}_{counter}_{hint}":
# the counter is a global sequence, so ANY earlier plan edit renames every
# later node. Lineage matching strips it.
_ID_RE = re.compile(r"^(?P<kind>.+?)_(?P<n>\d+)(?:_(?P<hint>.*))?$")

# repr() fallbacks of live objects embed addresses ("<... at 0x7f...>");
# scrub them so identities and fingerprints are stable across processes
_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def stable_name(node_id: str) -> str:
    """Node id with the planner's sequence counter stripped:
    ``agg_4_tumbling_aggregate`` -> ``agg_tumbling_aggregate``."""
    m = _ID_RE.match(node_id)
    if not m:
        return node_id
    hint = m.group("hint")
    return f"{m.group('kind')}_{hint}" if hint else m.group("kind")


def _scrub(obj):
    if isinstance(obj, dict):
        if "__callable__" in obj:
            return "<callable>"
        return {k: _scrub(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        return _ADDR_RE.sub(" at 0x..", obj)
    return obj


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(_scrub(_jsonable(obj)), sort_keys=True,
                   separators=(",", ":")).encode()
    ).hexdigest()[:16]


def _table_specs(node: Node) -> Optional[tuple]:
    """The node's declared state tables via AR008's spec-instantiation
    idiom: build the registered constructor on a COPY of the config
    (constructors may validate-and-mutate) and read ``tables()`` — the
    literal table-name model the replay-soundness auditor (LR203) proves
    checkpoint/restore agreement over. None when the constructor is
    unavailable here (optional dependency): the diff then falls back to
    the op-kind stateful heuristic rather than guessing a layout."""
    from ..engine.engine import construct_operator

    try:
        op = construct_operator(node.op, dict(node.config))
        specs = list(op.tables())
    except Exception:
        return None
    return tuple(sorted((s.name, s.kind, int(s.retention_micros))
                        for s in specs))


# ops that hold checkpointed state even when their constructor cannot be
# instantiated here (mirrors plan_passes._STATEFUL_OPS + sources/sinks,
# whose offset/commit tables also live in checkpoints)
_FALLBACK_STATEFUL = {
    OpName.TUMBLING_AGGREGATE, OpName.SLIDING_AGGREGATE,
    OpName.SESSION_AGGREGATE, OpName.INSTANT_JOIN,
    OpName.UPDATING_AGGREGATE, OpName.JOIN_WITH_EXPIRATION,
    OpName.WINDOW_FUNCTION, OpName.LOOKUP_JOIN,
    OpName.SOURCE, OpName.SINK,
}


@dataclass
class NodeIdentity:
    node_id: str
    op: OpName
    stable: str
    specs: Optional[tuple]  # None: constructor unavailable
    cfg_digest: str

    @property
    def stateful(self) -> bool:
        if self.specs is None:
            return self.op in _FALLBACK_STATEFUL
        return bool(self.specs)

    @property
    def identity(self) -> tuple:
        """The state identity two nodes must share for a verbatim carry."""
        return (self.op.value,
                self.specs if self.specs is not None else "<unavailable>",
                self.cfg_digest)


def node_identity(node: Node) -> NodeIdentity:
    cfg = {k: v for k, v in node.config.items() if k not in _NON_STATE_KEYS}
    return NodeIdentity(node.node_id, node.op, stable_name(node.node_id),
                        _table_specs(node), _digest(cfg))


def plan_fingerprint(graph: Graph) -> str:
    """Stable hash of everything that shapes checkpointed state and its
    meaning: per-node (id, op, state-shaping config, declared tables) plus
    the edge topology and schemas. Deliberately EXCLUDES parallelism — a
    rescale restores against the same fingerprint — and survives the
    Graph.dumps()/loads() round-trip the control plane ships IR through."""
    nodes = []
    for n in sorted(graph.nodes.values(), key=lambda n: n.node_id):
        ident = node_identity(n)
        nodes.append({"node_id": n.node_id, "op": n.op.value,
                      "cfg": ident.cfg_digest,
                      "tables": list(map(list, ident.specs or ()))})
    edges = sorted(
        json.dumps({"src": e.src, "dst": e.dst, "type": e.edge_type.value,
                    "schema": _scrub(_jsonable(e.schema.to_json()))},
                   sort_keys=True, separators=(",", ":"))
        for e in graph.edges
    )
    payload = json.dumps({"nodes": nodes, "edges": edges}, sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass
class NodeClassification:
    node_id: str  # new-graph node id ("dropped": the OLD node id)
    action: str  # carried | stateless | rebuilt | dropped | incompatible
    from_node: Optional[str] = None  # old-graph node id (carried)
    detail: str = ""

    def to_json(self) -> dict:
        d = {"node_id": self.node_id, "action": self.action}
        if self.from_node is not None:
            d["from"] = self.from_node
        if self.detail:
            d["detail"] = self.detail
        return d


@dataclass
class PlanDiff:
    classifications: list[NodeClassification]
    diagnostics: list[Diagnostic]
    mapping: dict = field(default_factory=dict)

    @property
    def rejected(self) -> bool:
        return any(d.severity == Severity.ERROR for d in self.diagnostics)

    def to_json(self) -> dict:
        return {
            "classifications": [c.to_json() for c in self.classifications],
            "rejected": self.rejected,
            "mapping": self.mapping,
        }


def diff_plans(old_graph: Graph, new_graph: Graph) -> PlanDiff:
    """Match operators across the old and new plans by stable identity and
    classify each (module docstring has the taxonomy). Returns the
    classifications, the AR010-012 diagnostics, and the evolution mapping
    the restore path applies (``TableManager.restore`` / ``Engine.build``):

        {"old_plan_hash": ..., "new_plan_hash": ...,
         "nodes": {new_id: {"action": "carried", "from": old_id,
                            "tables": [...]}
                   | {"action": "rebuilt"} | {"action": "stateless"}},
         "dropped": [old_id, ...]}
    """
    old_ids = {n.node_id: node_identity(n) for n in old_graph.topo_order()}
    new_ids = {n.node_id: node_identity(n) for n in new_graph.topo_order()}

    cls: list[NodeClassification] = []
    diags: list[Diagnostic] = []
    matched: dict[str, str] = {}  # new id -> old id
    unmatched_old = dict(old_ids)  # topo-ordered (dict preserves insertion)

    def match(nid: str, oid: str) -> None:
        matched[nid] = oid
        unmatched_old.pop(oid, None)

    # stateless new nodes never carry anything: classify directly
    for nid, ident in new_ids.items():
        if not ident.stateful:
            cls.append(NodeClassification(nid, "stateless"))

    stateful_new = {nid: i for nid, i in new_ids.items() if i.stateful}

    # pass A — same node id, same identity: the operator is untouched
    for nid, ident in stateful_new.items():
        old = unmatched_old.get(nid)
        if old is not None and old.stateful and old.identity == ident.identity:
            match(nid, nid)

    # pass B — same counter-stripped name + identity: the planner renumbered
    # it because an earlier statement changed, but the operator is the same
    for nid, ident in stateful_new.items():
        if nid in matched:
            continue
        for oid, old in unmatched_old.items():
            if (old.stateful and old.stable == ident.stable
                    and old.identity == ident.identity):
                match(nid, oid)
                break

    # pass C — identity alone (a rename: same state, different SQL alias)
    for nid, ident in stateful_new.items():
        if nid in matched:
            continue
        for oid, old in unmatched_old.items():
            if old.stateful and old.identity == ident.identity:
                match(nid, oid)
                break

    for nid, oid in matched.items():
        cls.append(NodeClassification(
            nid, "carried", from_node=oid,
            detail="" if nid == oid else f"renamed from {oid}"))

    # pass D — same lineage, CHANGED identity: the old bytes would be
    # misread (or the pre-checkpoint prefix silently lost). Hard reject.
    for nid, ident in stateful_new.items():
        if nid in matched:
            continue
        old = None
        if nid in unmatched_old and unmatched_old[nid].stateful:
            old = unmatched_old[nid]
        else:
            for oid, cand in unmatched_old.items():
                if cand.stateful and cand.stable == ident.stable:
                    old = cand
                    break
        if old is None:
            cls.append(NodeClassification(
                nid, "rebuilt",
                detail="new stateful operator: state re-derived from rows "
                       "replayed after the carried source offsets"))
            diags.append(Diagnostic(
                "AR011", Severity.INFO, nid,
                f"{ident.op.value} is new in the evolved plan: its state is "
                "rebuilt by replay, so results covering rows consumed before "
                "the evolution point will not include it",
                "expected for a genuinely new aggregation; if this operator "
                "was meant to carry state, keep its window/key/aggregate "
                "configuration identical"))
            continue
        unmatched_old.pop(old.node_id, None)
        if ident.op == OpName.SINK and old.op == OpName.SINK:
            # sinks are the one stateful kind whose identity may change:
            # their only state is transient pending-commit buffers, and the
            # evolve drain's final checkpoint-then-stop flushes them to
            # committed part files BEFORE the old set exits (on_close) —
            # the carried prefix is already durable, immutable output, so
            # the redefined sink starts empty without losing a byte
            cls.append(NodeClassification(
                nid, "rebuilt", from_node=old.node_id,
                detail="sink definition changed: the old sink's pending-"
                       "commit buffers were flushed at the drain barrier; "
                       "committed output is immutable"))
            diags.append(Diagnostic(
                "AR011", Severity.INFO, nid,
                f"sink {nid} is redefined (was {old.node_id}): its pending-"
                "commit buffers were flushed by the drain's final "
                "checkpoint, so it restarts empty with the carried prefix "
                "already committed",
                "no action needed; previously committed output files are "
                "never rewritten"))
            continue
        what = _identity_delta(old, ident)
        cls.append(NodeClassification(
            nid, "incompatible", from_node=old.node_id, detail=what))
        diags.append(Diagnostic(
            "AR010", Severity.ERROR, nid,
            f"incompatible evolution of {ident.op.value} "
            f"(was {old.node_id}): {what}; restoring the old checkpoint "
            "bytes under the new definition would misread state, and "
            "replaying from mid-stream offsets would silently drop the "
            "pre-evolution prefix",
            "evolution can only carry state across identical window/key/"
            "aggregate/table definitions; deploy this change as a new "
            "pipeline instead"))

    for oid, old in unmatched_old.items():
        if oid in matched.values() or not old.stateful:
            continue
        cls.append(NodeClassification(
            oid, "dropped",
            detail="no successor in the evolved plan; state dropped"))
        diags.append(Diagnostic(
            "AR012", Severity.WARNING, oid,
            f"{old.op.value} has no successor in the evolved plan: its "
            "checkpointed state will be explicitly dropped at restore "
            "(logged, never silently resurrected)",
            "expected when an aggregation was removed; re-adding it later "
            "starts from empty state"))

    mapping_nodes: dict[str, dict] = {}
    dropped: list[str] = []
    for c in cls:
        if c.action == "carried":
            ident = new_ids[c.node_id]
            mapping_nodes[c.node_id] = {
                "action": "carried", "from": c.from_node,
                "tables": [s[0] for s in (ident.specs or ())],
            }
        elif c.action == "rebuilt":
            mapping_nodes[c.node_id] = {"action": "rebuilt"}
            if c.from_node and c.from_node not in {
                    m.get("from") for m in mapping_nodes.values()}:
                # a redefined sink's predecessor: its buffered state is
                # explicitly dropped (the drain already committed it)
                dropped.append(c.from_node)
        elif c.action == "stateless":
            mapping_nodes[c.node_id] = {"action": "stateless"}
        elif c.action == "dropped":
            dropped.append(c.node_id)
    # stateless old nodes the evolved plan renumbered away still appear in
    # checkpoint metadata's operator list; record them as (harmless) drops
    # so the restore path's stale-operator gate knows they were accounted for
    for oid, old in unmatched_old.items():
        if oid not in matched.values() and not old.stateful:
            dropped.append(oid)
    mapping = {
        "old_plan_hash": plan_fingerprint(old_graph),
        "new_plan_hash": plan_fingerprint(new_graph),
        "nodes": mapping_nodes,
        "dropped": sorted(set(dropped)),
    }
    order = {"incompatible": 0, "dropped": 1, "rebuilt": 2, "carried": 3,
             "stateless": 4}
    cls.sort(key=lambda c: (order[c.action], c.node_id))
    return PlanDiff(cls, finish(diags), mapping)


def _identity_delta(old: "NodeIdentity", new: "NodeIdentity") -> str:
    if old.op != new.op:
        return f"operator kind changed ({old.op.value} -> {new.op.value})"
    if (old.specs or ()) != (new.specs or ()):
        o = {s[0] for s in (old.specs or ())}
        n = {s[0] for s in (new.specs or ())}
        if o != n:
            return (f"declared state tables changed "
                    f"({sorted(o)} -> {sorted(n)})")
        return "state table kinds/retentions changed"
    return ("state-shaping configuration changed (key schema, window "
            "width/slide/gap, TTL, or aggregate expressions)")
