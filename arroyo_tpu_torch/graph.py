"""Logical dataflow graph (the port's copy of arroyo_tpu/graph.py).

Node configs are plain dicts; the port's engine maps each node's ``OpName``
to a constructor from its own registry (engine/engine.py). ``_jsonable``
gives the JSON-safe view of a config that the segment compiler keys its
cache on, and ``Graph.to_json`` / ``dumps`` / ``loads`` the JAX package's
JSON form of a whole graph.
"""

from __future__ import annotations

import enum
import json
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

    def sources(self) -> list[Node]:
        return [n for n in self.nodes.values() if not self.in_edges(n.node_id)]

    def sinks(self) -> list[Node]:
        return [n for n in self.nodes.values() if not self.out_edges(n.node_id)]

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

    # -- serialization (the JAX package's JSON form) -------------------------

    def to_json(self) -> dict:
        return {
            "nodes": [
                {
                    "node_id": n.node_id,
                    "op": n.op.value,
                    "config": _jsonable(n.config),
                    "parallelism": n.parallelism,
                    "description": n.description,
                }
                for n in self.nodes.values()
            ],
            "edges": [
                {
                    "src": e.src,
                    "dst": e.dst,
                    "edge_type": e.edge_type.value,
                    "schema": e.schema.to_json(),
                }
                for e in self.edges
            ],
        }

    @staticmethod
    def from_json(d: dict) -> "Graph":
        g = Graph()
        for nd in d["nodes"]:
            g.add_node(Node(nd["node_id"], OpName(nd["op"]), _config_from_json(nd["config"]),
                            nd["parallelism"], nd.get("description", "")))
        for ed in d["edges"]:
            g.add_edge(ed["src"], ed["dst"], EdgeType(ed["edge_type"]),
                       Schema.from_json(ed["schema"]))
        return g

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def loads(s: str) -> "Graph":
        return Graph.from_json(json.loads(s))


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


def _config_from_json(obj):
    from .expr import expr_from_json

    if isinstance(obj, dict):
        if "__e__" in obj:
            return expr_from_json(obj)
        if "__schema__" in obj:
            return Schema.from_json(obj["__schema__"])
        if "__callable__" in obj:
            raise ValueError(f"graph config holds a live callable and cannot ship as IR: "
                             f"{obj['__callable__']}")
        return {k: _config_from_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        # planner configs carry pair-lists ((name, expr), ...); tuples and
        # lists are interchangeable for every consumer
        return [_config_from_json(v) for v in obj]
    return obj
