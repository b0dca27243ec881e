"""Schedulers: how a job's dataflow gets executed (the port's copy of
arroyo_tpu/controller/scheduler.py).

Reference: crates/arroyo-controller/src/schedulers/mod.rs:43-62 (trait
Scheduler). EmbeddedScheduler runs in-process engines (the run CLI);
ProcessScheduler runs worker subprocesses of this machine, each with its own
CUDA context on the card; NodeScheduler places workers on registered node
daemons (controller/node.py), which spawn the same subprocesses; and
KubernetesScheduler (controller/kube.py) creates a pod per worker.

A worker subprocess's stderr is drained by a thread that keeps its last
2,000 characters (the JAX package reads it only once the process exits):
a worker that writes more than a pipe buffer there, a first-use kernel
build's log or a torch warning, would otherwise block on the write and
look hung to the controller. The ``failed`` event's text is the JAX
package's.

Pipelines are defined by SQL text; workers re-plan locally, so no live
expression objects cross the process boundary (the reference ships protobuf
physical plans instead — same idea, the plan is data).

Worker wire protocol (process scheduler), JSON lines:
  worker -> controller (stdout): {"event": "started", "dp_port": P?} |
      {"event": "heartbeat"} | {"event": "checkpoint_completed", "epoch": N} |
      {"event": "subtask_acked", "epoch": N, "node": id, "subtask": S} |
      {"event": "subtask_finished", "node": id, "subtask": S} |
      {"event": "finished"} | {"event": "failed", "error": "..."}
  controller -> worker (stdin): {"cmd": "checkpoint", "epoch": N,
      "then_stop": bool} | {"cmd": "stop"} | {"cmd": "commit", "epoch": N} |
      {"cmd": "peers", "peers": {"0": [host, port], ...}}
This plays the role of the reference's ControllerGrpc/WorkerGrpc services
(proto/rpc.proto:185-202, :397-410). The subtask_acked/commit/peers legs
exist for multi-worker jobs (start_workers): workers under an assignment
relay checkpoint acks to the controller's CheckpointCoordinator and only
finalize phase 2 on an injected commit (checkpoint_state.py).
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Optional


class PlacementFull(RuntimeError):
    """The cluster has no free capacity for a placement (node-daemon 409,
    no daemon with free slots, or no daemons registered at all). The
    controller treats this as retriable: the job re-queues into the fleet's
    admission queue with deterministic backoff — it is never failed and
    never burns a restart-budget token."""


class WorkerHandle:
    """One running worker of a job (a job's dataflow runs on one or more)."""

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def poll_events(self) -> list[dict]:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def last_heartbeat(self) -> float:
        raise NotImplementedError

    def send_commit(self, epoch: int) -> None:
        """Phase-2 commit injection (multi-worker 2PC): only ever called
        after the epoch's job-level metadata is durable across all workers."""
        raise NotImplementedError


class EmbeddedWorkerHandle(WorkerHandle):
    """Runs the Engine inside the controller process
    (reference schedulers/embedded.rs)."""

    def __init__(self, sql: str, job_id: str, parallelism: int,
                 restore_epoch: Optional[int], storage_url: Optional[str] = None,
                 graph_json: Optional[str] = None, engine=None):
        from ..engine.engine import Engine

        if engine is not None:
            # multi-worker set: EmbeddedScheduler.start_workers pre-built the
            # engine with its assignment/worker_index/network wiring
            self.engine = engine
        else:
            if graph_json is not None:
                from ..graph import Graph

                graph = Graph.loads(graph_json)  # pre-planned, pre-parallelized IR
            else:
                from ..sql import plan_query
                from ..sql.planner import set_parallelism

                pp = plan_query(sql)
                if parallelism > 1:
                    set_parallelism(pp.graph, parallelism)
                graph = pp.graph
            self.engine = Engine(graph, job_id=job_id, restore_epoch=restore_epoch,
                                 storage_url=storage_url)
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._reported_epochs: set[int] = set()
        # _emit_epochs runs on BOTH the worker thread (_run) and the
        # controller thread (poll_events): without the lock two concurrent
        # emits can both compute the completed-minus-reported difference
        # before either records it, double-reporting an epoch
        self._emit_lock = threading.Lock()
        self._done = False  # concurrency: single-writer — monotonic done flag; set once by the worker thread, stale reads just delay done-detection one poll
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._events.put({"event": "started"})
            self.engine.run_to_completion(timeout=None)
            self._emit_epochs()
            if self.engine._aborted:
                # an externally-killed engine's aborted tasks still drain the
                # done-accounting; reporting "finished" here would make the
                # controller wait on the rest of the worker set forever
                # instead of restoring it
                self._events.put({"event": "failed",
                                  "error": "worker aborted (killed)"})
            else:
                self._events.put({"event": "finished"})
        except Exception as e:  # noqa: BLE001 - worker failure is data
            self._emit_epochs()
            self._events.put({"event": "failed", "error": str(e)})
        finally:
            self._done = True

    def _emit_epochs(self) -> None:
        if self.engine.coordinated:
            # multi-worker: relay per-subtask acks upward; the controller's
            # CheckpointCoordinator (not this worker) declares epochs done
            while True:
                try:
                    self._events.put(self.engine.coordinator_events.get_nowait())
                except queue.Empty:
                    break
        else:
            with self._emit_lock:
                for ep in sorted(
                        self.engine._completed_epochs - self._reported_epochs):
                    self._reported_epochs.add(ep)
                    self._events.put(
                        {"event": "checkpoint_completed", "epoch": ep})
        from ..connectors.preview import take_preview_rows

        lines = take_preview_rows(self.engine.job_id)
        if lines:
            self._events.put({"event": "sink_data", "lines": lines})
        now = time.monotonic()
        with self._emit_lock:
            due = now - getattr(self, "_last_metrics", 0.0) >= 1.0
            if due:
                self._last_metrics = now
        if due:
            from ..metrics import registry as _mreg

            self._events.put({
                "event": "metrics",
                "data": _mreg.job_metrics(self.engine.job_id),
            })

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        self.engine.trigger_checkpoint(epoch, then_stop=then_stop)

    def stop(self) -> None:
        self.engine.stop()

    def kill(self) -> None:
        self.engine._abort()
        if self.engine.network is not None:
            # multi-worker set teardown / post-finish cleanup: release the
            # data-plane listener and outgoing connections
            self.engine.network.close()

    def poll_events(self) -> list[dict]:
        self._emit_epochs()
        out = []
        while True:
            try:
                out.append(self._events.get_nowait())
            except queue.Empty:
                return out

    def alive(self) -> bool:
        return not self._done

    def last_heartbeat(self) -> float:
        # actual engine progress, not mere thread existence: a wedged
        # in-process engine (task hung in an operator or a stalled storage
        # call) must still trip the controller's heartbeat timeout
        if self._done:
            return time.monotonic()  # exit/failure is reported via events
        return self.engine.heartbeat()

    def send_commit(self, epoch: int) -> None:
        self.engine.deliver_commit(epoch)


class ProcessWorkerHandle(WorkerHandle):
    """Spawns `python -m arroyo_tpu_torch worker` (reference ProcessScheduler,
    schedulers/mod.rs:72: spawns `arroyo worker` with env-injected config)."""

    def __init__(self, sql: str, job_id: str, parallelism: int,
                 restore_epoch: Optional[int], storage_url: Optional[str] = None,
                 udf_specs: Optional[list] = None, graph_json: Optional[str] = None,
                 worker_index: Optional[int] = None, n_workers: int = 1,
                 assignment: Optional[list] = None, dp_bind: Optional[str] = None):
        import tempfile

        # the planned IR ships as data when serializable (reference:
        # StartExecutionReq carries the protobuf program); SQL remains the
        # fallback for graphs holding live objects
        suffix, payload, flag = (
            (".graph.json", graph_json, "--graph-file") if graph_json is not None
            else (".sql", sql, "--sql-file")
        )
        self._sql_file = tempfile.NamedTemporaryFile(
            "w", suffix=suffix, prefix=f"{job_id}-", delete=False
        )
        self._sql_file.write(payload)
        self._sql_file.close()
        cmd = [
            sys.executable, "-m", "arroyo_tpu_torch", "worker",
            flag, self._sql_file.name,
            "--job-id", job_id,
            "--parallelism", str(parallelism),
        ]
        if restore_epoch is not None:
            cmd += ["--restore-epoch", str(restore_epoch)]
        if storage_url:
            cmd += ["--storage-url", storage_url]
        self._assignment_file: Optional[str] = None
        if n_workers > 1:
            # assignment ships as a temp file: [[node_id, subtask, worker]...]
            af = tempfile.NamedTemporaryFile(
                "w", suffix=".json", prefix=f"{job_id}-assign-", delete=False
            )
            json.dump(assignment or [], af)
            af.close()
            self._assignment_file = af.name
            cmd += ["--worker-index", str(worker_index or 0),
                    "--n-workers", str(n_workers),
                    "--assignment-file", af.name]
            if dp_bind:
                cmd += ["--dp-bind", dp_bind]
        self._udfs_file: Optional[str] = None
        if udf_specs:
            uf = tempfile.NamedTemporaryFile(
                "w", suffix=".json", prefix=f"{job_id}-udfs-", delete=False
            )
            json.dump(udf_specs, uf)
            uf.close()
            self._udfs_file = uf.name
            cmd += ["--udfs-file", uf.name]
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1,
        )
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._hb = time.monotonic()
        self.dp_port: Optional[int] = None  # data-plane port (multi-worker)
        self._started = threading.Event()
        self._stderr_tail = ""
        self._stderr_reader = threading.Thread(target=self._drain_stderr, daemon=True)
        self._stderr_reader.start()
        self._reader = threading.Thread(target=self._read_stdout, daemon=True)
        self._reader.start()

    def _drain_stderr(self) -> None:
        assert self.proc.stderr is not None
        for chunk in iter(lambda: self.proc.stderr.read(4096), ""):
            self._stderr_tail = (self._stderr_tail + chunk)[-2000:]

    def stderr_tail(self, wait_s: float = 5.0) -> str:
        """The last 2,000 characters the worker wrote to stderr, once it
        has exited (waits up to ``wait_s`` for the drain to finish)."""
        if self.proc.poll() is None:
            return ""
        self._stderr_reader.join(timeout=wait_s)
        return self._stderr_tail

    def _read_stdout(self) -> None:
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # worker debug output
            self._hb = time.monotonic()
            if ev.get("event") == "started":
                if ev.get("dp_port") is not None:
                    self.dp_port = int(ev["dp_port"])
                self._started.set()
            if ev.get("event") != "heartbeat":
                self._events.put(ev)
        rc = self.proc.wait()
        self._started.set()  # unblock wait_dp_port on a crashed spawn
        if rc != 0:
            err = self.stderr_tail()
            self._events.put({"event": "failed", "error": f"worker exited {rc}: {err[-2000:]}"})

    def wait_dp_port(self, timeout: float = 60.0) -> Optional[int]:
        """Block until the worker reported its data-plane port (multi-worker
        peer exchange); None if it died or never reported."""
        self._started.wait(timeout)
        return self.dp_port

    def _send(self, obj: dict) -> None:
        if self.proc.stdin and self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps(obj) + "\n")
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError):
                pass

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        self._send({"cmd": "checkpoint", "epoch": epoch, "then_stop": then_stop})

    def stop(self) -> None:
        self._send({"cmd": "stop"})

    def send_commit(self, epoch: int) -> None:
        self._send({"cmd": "commit", "epoch": epoch})

    def send_peers(self, peers: dict[int, tuple[str, int]]) -> None:
        self._send({"cmd": "peers",
                    "peers": {str(k): list(v) for k, v in peers.items()}})

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        for path in (self._sql_file.name, self._udfs_file, self._assignment_file):
            if path:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def poll_events(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self._events.get_nowait())
            except queue.Empty:
                return out

    def alive(self) -> bool:
        return self.proc.poll() is None or not self._events.empty()

    def last_heartbeat(self) -> float:
        return self._hb


class Scheduler:
    """reference trait Scheduler (schedulers/mod.rs:43-62)."""

    def start_worker(self, sql: str, job_id: str, parallelism: int,
                     restore_epoch: Optional[int],
                     storage_url: Optional[str] = None,
                     udf_specs: Optional[list] = None,
                     graph_json: Optional[str] = None) -> WorkerHandle:
        raise NotImplementedError

    def start_workers(self, sql: str, job_id: str, parallelism: int,
                      restore_epoch: Optional[int],
                      storage_url: Optional[str] = None,
                      udf_specs: Optional[list] = None,
                      graph_json: Optional[str] = None,
                      n_workers: int = 1) -> list[WorkerHandle]:
        """Launch the job's worker set. The default keeps one worker per
        job (the kubernetes scheduler's current shape: one pod holds the
        whole dataflow); Embedded/Process/Node override with real
        multi-worker placement under a computed subtask assignment.
        Multi-worker needs the pre-planned IR; without graph_json the set
        degrades to a single worker rather than re-planning per worker."""
        return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                  storage_url, udf_specs, graph_json)]

    def provision_slots(self, target: int) -> Optional[int]:
        """Fleet-elasticity hook (controller/fleet.py): asked to resize
        the worker pool to ``target`` slots. Schedulers whose pool is a
        synthetic budget (embedded/process) return the accepted size; a
        scheduler whose pool is sized externally (node daemons joining a
        cluster, a kubernetes node pool) returns None — the fleet then
        only moves the ``arroyo_fleet_target_workers`` gauge, which is
        the knob an external node-pool autoscaler actuates."""
        return None


class EmbeddedScheduler(Scheduler):
    def provision_slots(self, target):
        # synthetic pool: in-process workers have no physical node budget,
        # so the fleet's resize is accepted as-is
        return int(target)

    def start_worker(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                     udf_specs=None, graph_json=None):
        if udf_specs:
            from ..compiler import activate_udf_specs

            activate_udf_specs(udf_specs)
        return EmbeddedWorkerHandle(sql, job_id, parallelism, restore_epoch, storage_url,
                                    graph_json)

    def start_workers(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                      udf_specs=None, graph_json=None, n_workers=1):
        if n_workers <= 1 or graph_json is None:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json)]
        from ..engine.engine import Engine
        from ..engine.network import NetworkManager
        from ..graph import Graph
        from .checkpoint_state import compute_assignment

        if udf_specs:
            from ..compiler import activate_udf_specs

            activate_udf_specs(udf_specs)
        assignment, _expected, n = compute_assignment(graph_json, n_workers)
        if n <= 1:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json)]
        # ports are known at NetworkManager construction, so peers can be
        # wired before any engine starts sending
        managers = [NetworkManager() for _ in range(n)]
        peers = {i: ("127.0.0.1", m.port) for i, m in enumerate(managers)}
        handles = []
        for i, m in enumerate(managers):
            m.set_peers(peers)
            eng = Engine(Graph.loads(graph_json), job_id=job_id,
                         restore_epoch=restore_epoch, storage_url=storage_url,
                         assignment=assignment, worker_index=i, network=m)
            handles.append(EmbeddedWorkerHandle(
                sql, job_id, parallelism, restore_epoch, storage_url,
                engine=eng))
        return handles


class ProcessScheduler(Scheduler):
    def provision_slots(self, target):
        # synthetic pool (subprocesses on one machine): accepted as-is
        return int(target)

    def start_worker(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                     udf_specs=None, graph_json=None):
        return ProcessWorkerHandle(sql, job_id, parallelism, restore_epoch, storage_url,
                                   udf_specs, graph_json)

    def start_workers(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                      udf_specs=None, graph_json=None, n_workers=1):
        if n_workers <= 1 or graph_json is None:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json)]
        from .checkpoint_state import compute_assignment

        assignment, _expected, n = compute_assignment(graph_json, n_workers)
        if n <= 1:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json)]
        assign_json = [[nid, sub, w] for (nid, sub), w in sorted(assignment.items())]
        handles = [
            ProcessWorkerHandle(sql, job_id, parallelism, restore_epoch,
                                storage_url, udf_specs, graph_json,
                                worker_index=i, n_workers=n,
                                assignment=assign_json, dp_bind="127.0.0.1")
            for i in range(n)
        ]
        # peer exchange: every worker binds its data plane and reports the
        # port in its "started" event; engines only start once all peers
        # are known (the worker holds task startup until the peers cmd)
        peers: dict[int, tuple[str, int]] = {}
        for i, h in enumerate(handles):
            port = h.wait_dp_port(timeout=90.0)
            if port is None:
                for hh in handles:
                    hh.kill()
                # the drained stderr names why a worker died at startup
                # (a device it cannot open, say); the JAX package has none
                tail = h.stderr_tail()
                raise RuntimeError(
                    f"worker {i}/{n} of job {job_id} never reported its "
                    "data-plane port (died during startup?)"
                    + (f": {tail}" if tail else ""))
            peers[i] = ("127.0.0.1", port)
        for h in handles:
            h.send_peers(peers)
        return handles


class NodeWorkerHandle(WorkerHandle):
    """Controller-side proxy for a worker running under a node daemon
    (controller/node.py): commands go over the node's HTTP surface; events
    and liveness are polled."""

    def __init__(self, node_addr: str, sql: str, job_id: str, parallelism: int,
                 restore_epoch, storage_url, udf_specs, graph_json=None,
                 worker_index=None, n_workers=1, assignment=None, dp_bind=None):
        from .node import _get, _post

        self._get, self._post = _get, _post
        self.node_addr = node_addr.rstrip("/")
        body = {
            "sql": sql, "job_id": job_id, "parallelism": parallelism,
            "restore_epoch": restore_epoch, "storage_url": storage_url,
            "udf_specs": udf_specs, "graph_json": graph_json,
        }
        if n_workers > 1:
            body.update({"worker_index": worker_index, "n_workers": n_workers,
                         "assignment": assignment,
                         # bind all interfaces: data-plane peers dial in
                         # from other machines of the cluster
                         "dp_bind": dp_bind or "0.0.0.0"})
        r = _post(f"{self.node_addr}/start_worker", body)
        self.worker_id = r["worker_id"]
        self._alive = True
        self._hb = time.monotonic()
        self._buffer: list[dict] = []
        self.dp_port: Optional[int] = None

    def _command(self, path: str, body: dict) -> None:
        """Controller -> node-daemon command behind the ``controller_rpc``
        fault point (drop, dup, delay: a flaky control network; a dropped
        command is recovered by the protocol's own retries, the stuck-epoch
        watchdog's re-trigger and the cumulative commit re-delivery)."""
        from ..faults import fault_point

        verdict = fault_point("controller_rpc", key=path, op="post")
        if verdict is not None and verdict[0] == "drop":
            return
        try:
            self._post(f"{self.node_addr}{path}", body)
            if verdict is not None and verdict[0] == "dup":
                self._post(f"{self.node_addr}{path}", body)
        except OSError:
            pass

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        self._command(f"/workers/{self.worker_id}/send",
                      {"cmd": "checkpoint", "epoch": epoch, "then_stop": then_stop})

    def stop(self) -> None:
        self._command(f"/workers/{self.worker_id}/stop", {})

    def send_commit(self, epoch: int) -> None:
        self._command(f"/workers/{self.worker_id}/send",
                      {"cmd": "commit", "epoch": epoch})

    def send_peers(self, peers: dict[int, tuple[str, int]]) -> None:
        self._command(f"/workers/{self.worker_id}/send",
                      {"cmd": "peers",
                       "peers": {str(k): list(v) for k, v in peers.items()}})

    def kill(self) -> None:
        try:
            self._post(f"{self.node_addr}/workers/{self.worker_id}/kill", {})
        except OSError:
            pass
        self._alive = False

    def poll_events(self) -> list[dict]:
        from ..faults import fault_point

        out, self._buffer = self._buffer, []
        verdict = fault_point("controller_rpc",
                              key=f"/workers/{self.worker_id}/events", op="get")
        if verdict is not None and verdict[0] == "drop":
            # a dropped poll loses nothing: the daemon only drains its
            # buffer when a poll actually arrives, so the next one catches up
            return out
        try:
            r = self._get(f"{self.node_addr}/workers/{self.worker_id}/events")
        except OSError:
            # node unreachable: let the heartbeat timeout declare death
            return out
        # anchor to the WORKER's own heartbeat (relayed as an age so clocks
        # need not agree): a hung worker must still trip the controller's
        # heartbeat timeout even though the node daemon answers polls
        self._hb = time.monotonic() - float(r.get("hb_age_s", 0.0))
        self._alive = bool(r["alive"]) or bool(r["events"])
        for ev in r["events"]:
            if ev.get("event") == "started" and ev.get("dp_port") is not None:
                self.dp_port = int(ev["dp_port"])
        return out + r["events"]

    def wait_dp_port(self, timeout: float = 90.0) -> Optional[int]:
        """Poll the node daemon until the worker reports its data-plane
        port; events seen along the way are buffered for poll_events."""
        deadline = time.monotonic() + timeout
        while self.dp_port is None and time.monotonic() < deadline:
            try:
                r = self._get(f"{self.node_addr}/workers/{self.worker_id}/events")
            except OSError:
                r = None  # daemon briefly unreachable; re-poll below
            if r is None:
                time.sleep(0.2)
                continue
            self._hb = time.monotonic() - float(r.get("hb_age_s", 0.0))
            for ev in r["events"]:
                if ev.get("event") == "started" and ev.get("dp_port") is not None:
                    self.dp_port = int(ev["dp_port"])
                self._buffer.append(ev)
            if not r["alive"] and not r["events"]:
                return None
            if self.dp_port is None:
                time.sleep(0.1)
        return self.dp_port

    def alive(self) -> bool:
        return self._alive

    def last_heartbeat(self) -> float:
        return self._hb


class LazyNodeWorkerHandle(WorkerHandle):
    """Deferred placement on a node daemon. The controller's supervision
    loop is single-threaded, so start_worker must not block while the
    cluster is briefly full or a daemon is mid-restart: this handle retries
    placement from poll_events (same shape as KubernetesWorkerHandle) and
    queues control commands issued before placement lands."""

    def __init__(self, sched: "NodeScheduler", args: tuple,
                 placement_timeout_s: float):
        self._sched = sched
        self._args = args
        self._deadline = time.monotonic() + placement_timeout_s
        self._inner: Optional[NodeWorkerHandle] = None
        self._queued: list[tuple] = []
        self._dead = False
        self._last = "no live node daemons registered"

    def _try_place(self) -> Optional[list[dict]]:
        inner, self._last = self._sched._place_once(self._args, self._last)
        if inner is not None:
            self._inner = inner
            for cmd in self._queued:
                getattr(inner, cmd[0])(*cmd[1:])
            self._queued.clear()
            return None
        if time.monotonic() > self._deadline:
            self._dead = True
            return [{"event": "failed", "error": f"placement failed: {self._last}"}]
        return None

    def trigger_checkpoint(self, epoch: int, then_stop: bool = False) -> None:
        if self._inner is None:
            self._queued.append(("trigger_checkpoint", epoch, then_stop))
        else:
            self._inner.trigger_checkpoint(epoch, then_stop)

    def stop(self) -> None:
        if self._inner is None:
            self._queued.append(("stop",))
        else:
            self._inner.stop()

    def send_commit(self, epoch: int) -> None:
        if self._inner is None:
            self._queued.append(("send_commit", epoch))
        else:
            self._inner.send_commit(epoch)

    def kill(self) -> None:
        self._dead = True
        if self._inner is not None:
            self._inner.kill()

    def poll_events(self) -> list[dict]:
        if self._dead:
            return []
        if self._inner is None:
            return self._try_place() or []
        return self._inner.poll_events()

    def alive(self) -> bool:
        if self._dead:
            return False
        return True if self._inner is None else self._inner.alive()

    def last_heartbeat(self) -> float:
        if self._inner is None:
            return time.monotonic()  # placement has its own deadline
        return self._inner.last_heartbeat()


class NodeScheduler(Scheduler):
    """Places workers on registered node daemons (least-loaded first)."""

    def __init__(self, db):
        self.db = db

    def _place_once(self, args: tuple, last: str, **multi_kw):
        """One placement sweep over live daemons -> (handle|None, reason).
        A 409 (the daemon's hard slot limit — its status poll races other
        placements) reads as a capacity rejection, which the controller
        answers by re-queueing the job into the fleet's admission queue
        with backoff, never by failing it."""
        import urllib.error

        from ..faults import InjectedFault, fault_point
        from .node import _get

        nodes = self.db.list_nodes(alive_within_s=10.0)
        candidates = []
        for n in nodes:
            try:
                st = _get(f"{n['addr']}/status", timeout=5.0)
            except OSError:
                continue
            free = int(st["slots"]) - int(st["used"])
            if free >= 1:
                candidates.append((free, n))
        candidates.sort(key=lambda fn: -fn[0])
        for _free, n in candidates:
            try:
                # fault point `admission`: a node 409 (or a slow admission
                # call) at the placement itself, after the status poll
                # said free
                fault_point("admission", key=str(n["id"]),
                            job=str(args[1]) if len(args) > 1 else "")
                return NodeWorkerHandle(n["addr"], *args, **multi_kw), last
            except InjectedFault:
                last = f"node {n['id']} full (409, injected)"
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    last = f"node {n['id']} full (409)"
                else:
                    last = f"node {n['id']} rejected placement: {e}"
            except OSError as e:
                last = f"node {n['id']} unreachable: {e}"
        if nodes and not candidates:
            last = "no node daemon with free slots"
        return None, last

    @staticmethod
    def _capacity_reason(last: str) -> bool:
        return ("full (409" in last or "free slots" in last
                or "no live node daemons" in last)

    def start_worker(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                     udf_specs=None, graph_json=None,
                     placement_timeout_s: float = 30.0):
        args = (sql, job_id, parallelism, restore_epoch, storage_url,
                udf_specs, graph_json)
        # fast path: place immediately when capacity exists, so the common
        # case still fails fast on hard errors and tests see a live handle
        handle, last = self._place_once(args, "no live node daemons registered")
        if handle is not None:
            return handle
        lazy = LazyNodeWorkerHandle(self, args, placement_timeout_s)
        lazy._last = last
        return lazy

    def start_workers(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                      udf_specs=None, graph_json=None, n_workers=1,
                      placement_timeout_s: float = 30.0):
        if n_workers <= 1 or graph_json is None:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json,
                                      placement_timeout_s)]
        from urllib.parse import urlparse

        from .checkpoint_state import compute_assignment

        assignment, _expected, n = compute_assignment(graph_json, n_workers)
        if n <= 1:
            return [self.start_worker(sql, job_id, parallelism, restore_epoch,
                                      storage_url, udf_specs, graph_json,
                                      placement_timeout_s)]
        assign_json = [[nid, sub, w] for (nid, sub), w in sorted(assignment.items())]
        # worker-set placement is all-or-nothing and synchronous: the data
        # plane needs every peer's (host, port) before any engine may run,
        # so lazy placement cannot apply here. A partially placed set is
        # torn down rather than left half-running.
        handles: list[NodeWorkerHandle] = []
        deadline = time.monotonic() + placement_timeout_s
        last = "no live node daemons registered"
        try:
            for i in range(n):
                args = (sql, job_id, parallelism, restore_epoch, storage_url,
                        udf_specs, graph_json)
                while True:
                    h, last = self._place_once(
                        args, last, worker_index=i, n_workers=n,
                        assignment=assign_json)
                    if h is not None:
                        handles.append(h)
                        break
                    if time.monotonic() > deadline:
                        if self._capacity_reason(last):
                            # capacity, not a hard error: the controller
                            # re-queues the job instead of failing it
                            raise PlacementFull(
                                f"placed {i}/{n} workers of job {job_id}: "
                                f"{last}")
                        raise RuntimeError(
                            f"placed {i}/{n} workers of job {job_id}: {last}")
                    time.sleep(0.25)
            peers: dict[int, tuple[str, int]] = {}
            for i, h in enumerate(handles):
                port = h.wait_dp_port(timeout=90.0)
                if port is None:
                    raise RuntimeError(
                        f"worker {i}/{n} of job {job_id} never reported its "
                        "data-plane port")
                peers[i] = (urlparse(h.node_addr).hostname or "127.0.0.1", port)
            for h in handles:
                h.send_peers(peers)
        except Exception:
            for h in handles:
                h.kill()
            raise
        return handles


def scheduler_for(name: str, db=None) -> Scheduler:
    if name == "embedded":
        return EmbeddedScheduler()
    if name == "process":
        return ProcessScheduler()
    if name == "node":
        if db is None:
            raise ValueError("node scheduler needs the shared database")
        return NodeScheduler(db)
    if name == "kubernetes":
        if db is None:
            raise ValueError("kubernetes scheduler needs the shared database")
        from .kube import KubernetesScheduler

        return KubernetesScheduler(db)
    raise ValueError(
        f"unknown scheduler {name!r} (have: embedded, process, node, kubernetes)")
