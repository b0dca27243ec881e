"""Logical dataflow graph (the port's copy of arroyo_tpu/graph.py).

Node configs are plain dicts; the port's engine maps each node's ``OpName``
to a constructor from its own registry (engine/engine.py). ``_jsonable``
gives the JSON-safe view of a config that the segment compiler keys its
cache on; whole-graph serialization is not part of the port yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .batch import Schema


class OpName(enum.Enum):
    """The same operator names as arroyo_tpu.graph.OpName."""

    SOURCE = "source"
    SINK = "sink"
    VALUE = "value"  # projection/filter
    KEY = "key"  # key calculation
    WATERMARK = "watermark"  # expression watermark
    TUMBLING_AGGREGATE = "tumbling_aggregate"
    SLIDING_AGGREGATE = "sliding_aggregate"
    SESSION_AGGREGATE = "session_aggregate"
    UPDATING_AGGREGATE = "updating_aggregate"
    JOIN_WITH_EXPIRATION = "join_with_expiration"
    INSTANT_JOIN = "instant_join"
    LOOKUP_JOIN = "lookup_join"
    WINDOW_FUNCTION = "window_function"
    ASYNC_UDF = "async_udf"
    UNNEST = "unnest"
    CHAINED = "chained"


class EdgeType(enum.Enum):
    FORWARD = "forward"
    SHUFFLE = "shuffle"
    LEFT_JOIN = "left_join"
    RIGHT_JOIN = "right_join"


@dataclass
class Node:
    node_id: str
    op: OpName
    config: dict
    parallelism: int = 1
    description: str = ""


@dataclass
class Edge:
    src: str
    dst: str
    edge_type: EdgeType
    schema: Schema


class Graph:
    """Small DAG container."""

    def __init__(self):
        self.nodes: dict[str, Node] = {}
        self.edges: list[Edge] = []

    def add_node(self, node: Node) -> Node:
        if node.node_id in self.nodes:
            raise ValueError(f"duplicate node {node.node_id}")
        self.nodes[node.node_id] = node
        return node

    def add_edge(self, src: str, dst: str, edge_type: EdgeType, schema: Schema) -> Edge:
        for nid in (src, dst):
            if nid not in self.nodes:
                raise ValueError(f"unknown node {nid}")
        e = Edge(src, dst, edge_type, schema)
        self.edges.append(e)
        return e

    def in_edges(self, node_id: str) -> list[Edge]:
        return [e for e in self.edges if e.dst == node_id]

    def out_edges(self, node_id: str) -> list[Edge]:
        return [e for e in self.edges if e.src == node_id]

    def topo_order(self) -> list[Node]:
        indeg = {nid: len(self.in_edges(nid)) for nid in self.nodes}
        ready = sorted([nid for nid, d in indeg.items() if d == 0])
        out: list[Node] = []
        while ready:
            nid = ready.pop(0)
            out.append(self.nodes[nid])
            for e in self.out_edges(nid):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(out) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return out


def _jsonable(obj):
    """JSON-safe view of a node config (arroyo_tpu/graph.py's): expression
    ASTs as tagged trees, schemas as tagged dicts, the in-process
    ``input_dtype_of`` callable dropped and any other callable marked, and
    anything else as its repr."""
    from .expr import Expr, expr_to_json

    if isinstance(obj, dict):
        return {
            k: ({"__callable__": repr(v)} if callable(v) else _jsonable(v))
            for k, v in obj.items()
            if not (k == "input_dtype_of" and callable(v))
        }
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, Expr):
        return expr_to_json(obj)
    if isinstance(obj, Schema):
        return {"__schema__": obj.to_json()}
    return repr(obj)
