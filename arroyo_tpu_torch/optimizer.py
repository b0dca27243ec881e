"""Graph optimizers (the port's copy of arroyo_tpu/optimizer.py).

Operator chaining: fuse maximal runs of chainable operators connected by
Forward edges with equal parallelism and single fan-in/fan-out into one
CHAINED node, so each fused run executes as one task with no intermediate
queues, threads or collector hops, and mark the run's compilable prefix
(engine/segment.py). Gated by ``pipeline.chaining.enabled``.
"""

from __future__ import annotations

from .graph import EdgeType, Graph, Node, OpName

# chainable single-input operators. The reference merges by graph shape
# alone; multi-input operators (joins) and sources are excluded here, and a
# keyed Shuffle edge is crossable only at parallelism 1 (where hashing to one
# destination is the identity routing and fusion is semantics-preserving).
CHAINABLE = {
    OpName.VALUE,
    OpName.KEY,
    OpName.WATERMARK,
    OpName.TUMBLING_AGGREGATE,
    OpName.SLIDING_AGGREGATE,
    OpName.SINK,
}


def _single_out(g: Graph, nid: str):
    es = g.out_edges(nid)
    return es[0] if len(es) == 1 else None


def _edge_fusable(g: Graph, e) -> bool:
    p_src = g.nodes[e.src].parallelism
    p_dst = g.nodes[e.dst].parallelism
    if p_src != p_dst:
        return False
    if e.edge_type == EdgeType.FORWARD:
        return True
    return e.edge_type == EdgeType.SHUFFLE and p_src == 1


def chain_graph(g: Graph) -> Graph:
    """Returns a new graph with chainable runs fused (input unmodified)."""
    consumed: set[str] = set()
    runs: list[list[str]] = []
    for node in g.topo_order():
        nid = node.node_id
        if nid in consumed or node.op not in CHAINABLE or node.op == OpName.SINK:
            continue
        if len(g.in_edges(nid)) != 1:
            continue
        run = [nid]
        cur = nid
        while True:
            e = _single_out(g, cur)
            if e is None or not _edge_fusable(g, e):
                break
            nxt = g.nodes[e.dst]
            if nxt.op not in CHAINABLE or len(g.in_edges(e.dst)) != 1:
                break
            run.append(e.dst)
            cur = e.dst
        if len(run) >= 2:
            runs.append(run)
            consumed.update(run)

    if not runs:
        return g

    rep: dict[str, str] = {}  # member node -> fused node id
    fused_cfg: dict[str, dict] = {}
    for run in runs:
        fid = "+".join(run)
        for nid in run:
            rep[nid] = fid
        members = [(g.nodes[nid].op.value, g.nodes[nid].config) for nid in run]
        fused_cfg[fid] = {"members": members}
        # plan-time compilability marking (engine/segment.py): the maximal
        # traceable prefix of the run, judged statically from op kinds and
        # expression shapes. The runtime still gates on real column dtypes
        # and verifies the first batch; this marking only says "worth
        # attempting", so an unmarked chain never pays a build
        from .engine.segment import segment_marking, segment_reject_reason

        marking = segment_marking(members)
        if marking is not None:
            fused_cfg[fid]["compile"] = marking
        else:
            # explain WHY at plan time: the task metrics carry this string
            fused_cfg[fid]["compile_reject"] = segment_reject_reason(members)

    out = Graph()
    for nid, node in g.nodes.items():
        if nid in rep:
            fid = rep[nid]
            if fid not in out.nodes:
                out.add_node(Node(fid, OpName.CHAINED, fused_cfg[fid],
                                  node.parallelism, description="chained"))
        else:
            out.add_node(Node(nid, node.op, node.config, node.parallelism,
                              node.description))
    for e in g.edges:
        src = rep.get(e.src, e.src)
        dst = rep.get(e.dst, e.dst)
        if src == dst:
            continue  # internal chain edge
        out.add_edge(src, dst, e.edge_type, e.schema)
    return out
