"""Kubernetes scheduler (the port's copy of arroyo_tpu/controller/kube.py):
one worker pod per job.

It creates worker pods from the ``kubernetes-scheduler`` config and tears
them down with the job. The pod runs the port's node daemon
(``python -m arroyo_tpu_torch node``) with one slot; the daemon dials home to the cluster API, registers under the node id
injected into the pod, and the controller then places the worker over the
node's HTTP surface — so the in-cluster control path is identical to the
node scheduler's, and only pod lifecycle goes through the Kubernetes API.

Pod startup (image pull, scheduling) can take minutes, and the controller
loop steps every job on one thread — so ``start_worker`` only issues the
(fast) pod-create call and returns a handle that finishes placement lazily
from ``poll_events``; the supervision loop keeps servicing every other job
while the pod comes up.

The API client is a small urllib wrapper (the in-cluster service-account
token and CA, or an explicit base URL for tests and kubeconfig-less
setups): no kubernetes package is needed. The manifests carry the port's
names: image ``arroyo-tpu-torch:latest`` by default, the node id in
``ARROYO_TPU_TORCH__NODE__ID``, the label ``app: arroyo-tpu-torch-worker``,
and a limit of one ``nvidia.com/gpu``: the worker runs on the card.
"""

from __future__ import annotations

import json
import os
import ssl
import time
import urllib.error
import urllib.request
import uuid
from typing import Optional

from ..config import config
from .scheduler import NodeWorkerHandle, Scheduler, WorkerHandle

_SA = "/var/run/secrets/kubernetes.io/serviceaccount"
_TOKEN_TTL_S = 60.0  # kubelet rotates bound SA tokens; re-read periodically


class KubeClient:
    def __init__(self, base_url: Optional[str] = None, token: Optional[str] = None,
                 verify_ca: bool = True):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        self._static_token = token
        self._token: Optional[str] = token
        self._token_read_at: Optional[float] = None  # monotonic starts at boot
        self.ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            self.ctx = ssl.create_default_context(
                cafile=f"{_SA}/ca.crt" if os.path.exists(f"{_SA}/ca.crt") else None
            )
            if not verify_ca:
                self.ctx.check_hostname = False
                self.ctx.verify_mode = ssl.CERT_NONE

    def _bearer(self) -> Optional[str]:
        if self._static_token is not None:
            return self._static_token
        now = time.monotonic()
        if (self._token_read_at is None or now - self._token_read_at > _TOKEN_TTL_S) \
                and os.path.exists(f"{_SA}/token"):
            with open(f"{_SA}/token") as f:
                self._token = f.read().strip()
            self._token_read_at = now
        return self._token

    def _req(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        token = self._bearer()
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={
                "Content-Type": "application/json",
                **({"Authorization": f"Bearer {token}"} if token else {}),
            },
        )
        with urllib.request.urlopen(req, timeout=30, context=self.ctx) as r:
            return json.loads(r.read() or b"{}")

    def create_pod(self, namespace: str, manifest: dict) -> dict:
        return self._req("POST", f"/api/v1/namespaces/{namespace}/pods", manifest)

    def delete_pod(self, namespace: str, name: str) -> None:
        try:
            self._req("DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")
        except OSError:
            pass

    def pod_phase(self, namespace: str, name: str) -> str:
        try:
            pod = self._req("GET", f"/api/v1/namespaces/{namespace}/pods/{name}")
            return pod.get("status", {}).get("phase", "Unknown")
        except OSError:
            return "Unknown"


class KubernetesWorkerHandle(WorkerHandle):
    """Pod-backed worker. Placement is lazy: the pod was just created when
    this handle is returned, and each poll_events tick tries to promote to a
    live NodeWorkerHandle once the pod's node daemon has dialed home;
    control commands issued in the window are queued and replayed."""

    def __init__(self, sched: "KubernetesScheduler", pod_name: str, node_id: str,
                 args: tuple):
        self._sched = sched
        self._pod_name = pod_name
        self._node_id = node_id
        # (sql, job_id, parallelism, restore_epoch, storage_url, udf_specs, graph_json)
        self._args = args
        self._inner: Optional[NodeWorkerHandle] = None
        self._deadline = time.monotonic() + sched.startup_timeout
        self._queued: list[tuple] = []
        self._dead = False

    # ---------------------------------------------------------- placement

    def _try_place(self) -> Optional[list[dict]]:
        """Attempt promotion; returns a failure-event list when the pod is
        declared dead, else None."""
        nodes = [n for n in self._sched.db.list_nodes(alive_within_s=10.0)
                 if n["id"] == self._node_id]
        if nodes:
            try:
                self._inner = NodeWorkerHandle(nodes[0]["addr"], *self._args)
            except (urllib.error.HTTPError, OSError):
                self._inner = None  # daemon not quite ready; retry next poll
            else:
                for cmd in self._queued:
                    getattr(self._inner, cmd[0])(*cmd[1:])
                self._queued.clear()
                return None
        if time.monotonic() > self._deadline:
            phase = self._sched.kube.pod_phase(self._sched.namespace, self._pod_name)
            self.kill()
            return [{"event": "failed", "error": (
                f"worker pod {self._pod_name} never registered within "
                f"{self._sched.startup_timeout:.0f}s "
                f"(pod phase: {phase}, image: {self._sched.image})")}]
        return None

    # ------------------------------------------------------------- surface

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

    def kill(self) -> None:
        self._dead = True
        if self._inner is not None:
            self._inner.kill()
        self._sched.kube.delete_pod(self._sched.namespace, self._pod_name)

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
            return time.monotonic()  # pod startup has its own deadline
        return self._inner.last_heartbeat()


class KubernetesScheduler(Scheduler):
    """config (section kubernetes-scheduler): namespace, image,
    controller-url (the cluster API the pod dials home to), worker-env
    (extra env dict), pod-startup-timeout-s."""

    def __init__(self, db, kube: Optional[KubeClient] = None):
        self.db = db
        self.kube = kube or KubeClient()
        k = config().section("kubernetes-scheduler")
        self.namespace = k.get("namespace", "arroyo-tpu")
        self.image = k.get("image", "arroyo-tpu-torch:latest")
        self.controller_url = k.get("controller-url", "http://arroyo-api:5115")
        self.extra_env = dict(k.get("worker-env", {}))
        self.startup_timeout = float(k.get("pod-startup-timeout-s", 120))

    def _manifest(self, pod_name: str, node_id: str) -> dict:
        env = [
            {"name": "ARROYO_TPU_TORCH__NODE__ID", "value": node_id},
            {"name": "POD_IP", "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}}},
        ] + [{"name": k, "value": str(v)} for k, v in self.extra_env.items()]
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod_name,
                "labels": {"app": "arroyo-tpu-torch-worker", "arroyo-node-id": node_id},
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": [{
                    "name": "worker",
                    "image": self.image,
                    "args": ["node", "--controller", self.controller_url,
                             "--slots", "1", "--port", "5200",
                             "--advertise-host", "$(POD_IP)"],
                    "ports": [{"containerPort": 5200}],
                    # the worker runs on the card
                    "resources": {"limits": {"nvidia.com/gpu": 1}},
                    "env": env,
                }],
            },
        }

    def start_worker(self, sql, job_id, parallelism, restore_epoch, storage_url=None,
                     udf_specs=None, graph_json=None):
        node_id = f"node_{uuid.uuid4().hex[:12]}"
        pod_name = f"arroyo-worker-{job_id.replace('_', '-')[:30]}-{node_id[5:11]}"
        self.kube.create_pod(self.namespace, self._manifest(pod_name, node_id))
        return KubernetesWorkerHandle(
            self, pod_name, node_id,
            (sql, job_id, parallelism, restore_epoch, storage_url,
             udf_specs, graph_json),
        )
