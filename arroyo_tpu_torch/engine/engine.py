"""Engine: logical graph -> physical tasks -> running pipeline (the port's
copy of arroyo_tpu/engine/engine.py, single process, no checkpoints).

Each node becomes ``parallelism`` subtasks, each on its own thread. A
FORWARD edge between equal parallelisms is 1:1; every other edge is a full
bipartite set of queues. The port has its OWN operator registry: the JAX
package's is process-global too, and both packages load in one test
process, so sharing one would let either replace the other's constructors.

The engine resolves one torch device (device.py) and hands it to every
operator through its OperatorContext. With ``pipeline.chaining.enabled`` it
first fuses chainable runs (optimizer.chain_graph), whose marked prefix the
tasks run as one fused kernel per micro-batch (engine/segment.py).
Checkpoints and restore are a later slice: asking for them raises
NotImplementedError.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Optional, Union

import torch

from ..config import config
from ..device import resolve_device
from ..graph import EdgeType, Graph, OpName
from ..operators.base import OperatorContext
from ..operators.collector import Collector, OutEdge
from ..types import ControlMessage, ControlResp, TaskInfo
from .queues import TaskInbox
from .task import Task

CHECKPOINT_SLICE = "the checkpoint/restore slice of the port (ROADMAP queue A)"

_CONSTRUCTORS: dict[OpName, Callable[[dict], object]] = {}


def register_operator(op: OpName):
    def deco(fn):
        _CONSTRUCTORS[op] = fn
        return fn

    return deco


def load_operators() -> None:
    """Import every operator/connector module of the port so that its
    constructor registers."""
    from .. import connectors
    from ..operators import builtin, chained, joins, updating_aggregate  # noqa: F401
    from ..windows import session, sliding, tumbling  # noqa: F401

    connectors.load_all()


def construct_operator(op: OpName, cfg: dict):
    load_operators()
    if op not in _CONSTRUCTORS:
        raise NotImplementedError(
            f"operator {op.value} is not ported yet (ROADMAP queue A); the port "
            f"runs {sorted(o.value for o in _CONSTRUCTORS)}")
    return _CONSTRUCTORS[op](cfg)


class Engine:
    def __init__(self, graph: Graph, job_id: str = "job",
                 device: Optional[Union[str, torch.device]] = None,
                 restore_epoch: Optional[int] = None):
        if restore_epoch is not None:
            raise NotImplementedError(
                f"restore from epoch {restore_epoch}: checkpoints come with {CHECKPOINT_SLICE}")
        if config().get("pipeline.chaining.enabled"):
            from ..optimizer import chain_graph

            graph = chain_graph(graph)
        self.graph = graph
        self.job_id = job_id
        self.device = resolve_device(device)
        self.resp_queue: "_queue.Queue[ControlResp]" = _queue.Queue()
        self.tasks: dict[tuple[str, int], Task] = {}
        self._inboxes: dict[tuple[str, int], TaskInbox] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._finished_tasks: set[tuple[str, int]] = set()
        self._failed: list[ControlResp] = []
        self._resp_thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- building

    def build(self) -> None:
        g = self.graph
        queue_size = config().get("worker.queue-size")
        for nid, node in g.nodes.items():
            n_inputs = sum(g.nodes[e.src].parallelism for e in g.in_edges(nid))
            for s in range(node.parallelism):
                if n_inputs:
                    self._inboxes[(nid, s)] = TaskInbox(n_inputs, queue_size)
        for nid, node in g.nodes.items():
            in_edges = g.in_edges(nid)
            n_inputs = sum(g.nodes[e.src].parallelism for e in in_edges)

            def edge_of_input(i, _edges=in_edges, _g=g):
                # flat input index -> (edge index, upstream subtask)
                base = 0
                for ei, e in enumerate(_edges):
                    p = _g.nodes[e.src].parallelism
                    if i < base + p:
                        return (ei, i - base)
                    base += p
                raise IndexError(i)

            for s in range(node.parallelism):
                ti = TaskInfo(self.job_id, nid, node.op.value, s, node.parallelism)
                out_edges = []
                for e in g.out_edges(nid):
                    dst_node = g.nodes[e.dst]
                    # flat input base for this edge at the destination
                    base = 0
                    for de in g.in_edges(e.dst):
                        if de is e:
                            break
                        base += g.nodes[de.src].parallelism
                    dests = [self._inboxes[(e.dst, d)] for d in range(dst_node.parallelism)]
                    idxs = [base + s] * dst_node.parallelism
                    etype = e.edge_type
                    if etype == EdgeType.FORWARD and dst_node.parallelism != node.parallelism:
                        etype = EdgeType.SHUFFLE
                    out_edges.append(OutEdge(etype, dests, idxs))
                operator = construct_operator(node.op, node.config)
                self.tasks[(nid, s)] = Task(
                    ti, operator, self._inboxes.get((nid, s)), Collector(out_edges, s),
                    OperatorContext(ti, self.device, edge_of_input), self.resp_queue, n_inputs=n_inputs)

    # -------------------------------------------------------------- running

    def start(self) -> None:
        if not self.tasks:
            self.build()
        self._resp_thread = threading.Thread(target=self._collect_resps, daemon=True)
        self._resp_thread.start()
        # sinks first, so consumers are ready before producers
        for node in reversed(self.graph.topo_order()):
            for s in range(node.parallelism):
                self.tasks[(node.node_id, s)].start()

    def _collect_resps(self) -> None:
        n_tasks = len(self.tasks)
        while True:
            try:
                resp = self.resp_queue.get(timeout=0.25)
            except _queue.Empty:
                with self._lock:
                    if len(self._finished_tasks) + len(self._failed) >= n_tasks:
                        return
                continue
            with self._lock:
                if resp.kind == "task_finished":
                    self._finished_tasks.add((resp.node_id, resp.subtask_index))
                elif resp.kind == "task_failed":
                    self._failed.append(resp)
                    # unstick every surviving task so producers blocked on a
                    # dead consumer's row budget unwind
                    self._abort()
                self._cond.notify_all()

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        raise NotImplementedError(
            f"checkpoint epoch {epoch}: checkpoints come with {CHECKPOINT_SLICE}")

    def checkpoint_and_wait(self, epoch: int, timeout: float = 60.0,
                            then_stop: bool = False):
        self.trigger_checkpoint(epoch, then_stop)

    def stop(self) -> None:
        for t in self.tasks.values():
            if t.is_source:
                t.control_queue.put(ControlMessage(kind="stop"))

    def _abort(self) -> None:
        self.stop()
        for inbox in self._inboxes.values():
            inbox.close()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            if self._failed:
                for t in self.tasks.values():
                    t.join(2.0)
                raise RuntimeError(f"pipeline task failed:\n{self._failed[0].error}")
            alive = [t for t in self.tasks.values() if t.thread and t.thread.is_alive()]
            if not alive:
                break
            if deadline is not None and time.monotonic() > deadline:
                self._abort()
                raise TimeoutError(f"{len(alive)} tasks still running after join timeout")
            alive[0].join(0.2)
        # every thread has exited; the last task_finished / task_failed
        # responses may still be in flight on the response queue
        catchup = time.monotonic() + 5.0
        with self._lock:
            while (len(self._finished_tasks) + len(self._failed) < len(self.tasks)
                   and time.monotonic() < catchup):
                self._cond.wait(timeout=0.1)
        if self._failed:
            raise RuntimeError(f"pipeline task failed:\n{self._failed[0].error}")

    def run_to_completion(self, timeout: Optional[float] = 120.0) -> None:
        self.start()
        self.join(timeout)


def run_graph(graph: Graph, job_id: str = "job", timeout: float = 120.0,
              device: Optional[Union[str, torch.device]] = None) -> Engine:
    """Build, run to completion, return the finished engine. ``device``
    None runs on CUDA (and raises without it); tests pass ``"cpu"``."""
    eng = Engine(graph, job_id=job_id, device=device)
    eng.run_to_completion(timeout)
    return eng
