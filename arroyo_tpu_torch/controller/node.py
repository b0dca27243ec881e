"""Node daemon (the port's copy of arroyo_tpu/controller/node.py): the
per-machine worker launcher.

An agent that runs on every machine of a cluster, registers itself (address
and task slots) with the control plane through the REST API, heartbeats, and
launches and kills worker processes on demand over a small JSON-over-HTTP
surface; the controller's NodeScheduler (scheduler.py) places workers on
registered nodes and polls their event streams. A worker is the port's
``ProcessWorkerHandle`` subprocess, which takes CUDA unless its config says
otherwise and fails naming the device where it has none. Slots are a hard
admission limit: a placement past them gets 409.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..obs.lockorder import make_lock


def _post(url: str, body: dict, timeout: float = 10.0) -> dict:
    from ..config import config

    headers = {"Content-Type": "application/json"}
    token = config().get("api.auth-token")
    if token:
        # the cluster API gates mutating requests when a token is set
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST", headers=headers,
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class NodeServer:
    """The per-machine agent. start() registers with the controller API and
    begins heartbeating; workers are spawned as subprocesses via the same
    ProcessWorkerHandle the process scheduler uses, with their event
    streams buffered for the controller to poll."""

    def __init__(self, api_base: str, slots: int = 16,
                 host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None):
        from ..config import config

        self.api_base = api_base.rstrip("/")
        self.slots = slots
        # an explicit id (config node.id / ARROYO_TPU_TORCH__NODE__ID) lets
        # the kubernetes scheduler correlate the pod it created with the
        # node registration that dials home
        self.node_id = config().get("node.id") or f"node_{uuid.uuid4().hex[:12]}"
        self._workers: dict[str, object] = {}  # worker_id -> ProcessWorkerHandle
        self._lock = make_lock("NodeServer._lock")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n)) if n else {}

            def do_POST(self):
                outer._route(self, "POST")

            def do_GET(self):
                outer._route(self, "GET")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        # the address the CONTROLLER dials; binding 0.0.0.0 still needs a
        # routable name advertised to the cluster
        self.addr = f"http://{advertise_host or host}:{self.port}"
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # --------------------------------------------------------------- routes

    _ROUTES = [
        ("POST", r"^/start_worker$", "_start_worker"),
        ("POST", r"^/workers/([^/]+)/stop$", "_stop_worker"),
        ("POST", r"^/workers/([^/]+)/kill$", "_kill_worker"),
        ("POST", r"^/workers/([^/]+)/send$", "_send_worker"),
        ("GET", r"^/workers/([^/]+)/events$", "_worker_events"),
        ("GET", r"^/status$", "_status"),
    ]

    # ThreadingHTTPServer runs each request on a thread of its own
    def _route(self, h, method: str) -> None:
        path = h.path.split("?", 1)[0]
        for m, pat, name in self._ROUTES:
            if m != method:
                continue
            match = re.match(pat, path)
            if match:
                try:
                    getattr(self, name)(h, *match.groups())
                except Exception as e:  # noqa: BLE001
                    h._json(500, {"error": str(e)})
                return
        h._json(404, {"error": f"no route {method} {path}"})

    def _start_worker(self, h) -> None:
        from ..faults import fault_point
        from .scheduler import ProcessWorkerHandle

        body = h._body()
        # fault point: a failed admission answers 500, which the
        # scheduler's placement retry takes
        fault_point("node.start_worker", job=str(body.get("job_id", "")))
        wid = f"worker_{uuid.uuid4().hex[:12]}"
        with self._lock:
            # a None value is another request's under-lock reservation whose
            # handle is still being spawned — it holds a slot too
            used = sum(1 for w in self._workers.values()
                       if w is None or w.alive())
            if used >= self.slots:
                # slots are a hard admission limit, not advisory — the
                # scheduler's status poll races concurrent placements
                h._json(409, {"error": f"node full ({used}/{self.slots} slots)"})
                return
            self._workers[wid] = None  # reserve under the lock
        try:
            handle = ProcessWorkerHandle(
                body["sql"], body["job_id"], int(body.get("parallelism", 1)),
                body.get("restore_epoch"), body.get("storage_url"),
                body.get("udf_specs"), body.get("graph_json"),
                # multi-worker set placement: this worker's slice of the
                # assignment plus its data-plane bind (peers dial in)
                worker_index=body.get("worker_index"),
                n_workers=int(body.get("n_workers") or 1),
                assignment=body.get("assignment"),
                dp_bind=body.get("dp_bind"),
            )
        except BaseException:
            # spawn failure must release the reservation or the slot is
            # consumed forever (fatal on 1-slot kubernetes worker pods)
            with self._lock:
                self._workers.pop(wid, None)
            raise
        with self._lock:
            self._workers[wid] = handle
        h._json(200, {"worker_id": wid})

    def _handle(self, wid: str):
        with self._lock:
            return self._workers.get(wid)  # None while still being spawned

    def _stop_worker(self, h, wid) -> None:
        handle = self._handle(wid)
        if handle is None:
            h._json(404, {"error": "unknown worker"})
            return
        handle.stop()
        h._json(200, {})

    def _kill_worker(self, h, wid) -> None:
        handle = self._handle(wid)
        if handle is None:
            h._json(404, {"error": "unknown worker"})
            return
        handle.kill()
        with self._lock:
            self._workers.pop(wid, None)
        h._json(200, {})

    def _send_worker(self, h, wid) -> None:
        """Forward a control command (checkpoint/stop) to the worker's
        stdin protocol."""
        handle = self._handle(wid)
        if handle is None:
            h._json(404, {"error": "unknown worker"})
            return
        handle._send(h._body())
        h._json(200, {})

    def _worker_events(self, h, wid) -> None:
        handle = self._handle(wid)
        if handle is None:
            h._json(404, {"error": "unknown worker"})
            return
        events = handle.poll_events()
        alive = handle.alive()
        h._json(200, {
            "events": events,
            "alive": alive,
            # real worker liveness, not node-daemon reachability: the
            # controller's hang detection needs the worker's own heartbeat
            "hb_age_s": time.monotonic() - handle.last_heartbeat(),
        })
        if not alive and not events:
            # exited and fully drained: reap (kill() on a dead process only
            # releases pipes and the temp sql/udf files)
            handle.kill()
            with self._lock:
                self._workers.pop(wid, None)

    def _status(self, h) -> None:
        with self._lock:
            used = sum(1 for w in self._workers.values()
                       if w is None or w.alive())
        h._json(200, {"node_id": self.node_id, "slots": self.slots, "used": used})

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "NodeServer":
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name=f"arroyo-node-{self.port}")
        t.start()
        self._threads.append(t)
        self._register()
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb.start()
        self._threads.append(hb)
        return self

    def _register(self) -> None:
        _post(f"{self.api_base}/api/v1/nodes/register", {
            "node_id": self.node_id, "addr": self.addr, "slots": self.slots,
        })

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(2.0):
            try:
                _post(f"{self.api_base}/api/v1/nodes/{self.node_id}/heartbeat", {})
            except Exception:  # noqa: BLE001 - a restarted controller forgot the node
                try:
                    self._register()
                except Exception:  # lint: waive LR102 — controller restart window: the next heartbeat registers again
                    pass

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        with self._lock:
            for w in self._workers.values():
                if w is None:
                    continue  # in-flight reservation, nothing to kill yet
                try:
                    w.kill()
                except Exception:  # lint: waive LR102 — best-effort kill at daemon shutdown; the worker may have exited already
                    pass
            self._workers.clear()
