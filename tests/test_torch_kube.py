"""The port's Kubernetes scheduler (controller/kube.py) over tests/test_kube.py's
fake kube-apiserver: a job's whole lifecycle through a worker pod whose node
daemon dials home, and a pod that never registers timing out and being
deleted, each run through the port with the JAX test's assertions; the pod
manifest carries the port's image, label and config variable names. (The
JAX test's third case reads the JAX package's k8s/ manifest, not the
scheduler, and is not mirrored.)"""

from __future__ import annotations

import pytest

from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_kube", {'== "arroyo-tpu-worker"': '== "arroyo-tpu-torch-worker"'})
CASES = sorted(n for n in dir(MOD) if n.startswith("test_kubernetes_"))


def test_every_scheduler_case_is_mirrored():
    assert CASES == ["test_kubernetes_pod_never_registers_times_out",
                     "test_kubernetes_scheduler_lifecycle"]


@pytest.mark.parametrize("name", CASES)
def test_kube_case_through_the_port(name, tmp_path, port):
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)


def test_manifest_names_the_port(port):
    from arroyo_tpu_torch.controller import Database
    from arroyo_tpu_torch.controller.kube import KubeClient, KubernetesScheduler
    from arroyo_tpu_torch.controller.scheduler import scheduler_for

    sched = KubernetesScheduler(Database(), KubeClient(base_url="http://127.0.0.1:1"))
    m = sched._manifest("pod-a", "node_abc")
    cont = m["spec"]["containers"][0]
    assert cont["image"] == "arroyo-tpu-torch:latest"
    assert cont["args"][:3] == ["node", "--controller", sched.controller_url]
    assert {e["name"] for e in cont["env"]} >= {"ARROYO_TPU_TORCH__NODE__ID", "POD_IP"}
    assert m["metadata"]["labels"] == {"app": "arroyo-tpu-torch-worker",
                                       "arroyo-node-id": "node_abc"}
    assert isinstance(scheduler_for("kubernetes", Database()), KubernetesScheduler)
    with pytest.raises(ValueError, match="shared database"):
        scheduler_for("kubernetes")


def test_kube_client_sends_the_service_account_token():
    """KubeClient over plain HTTP with a static token: the bearer header and
    the pod calls' paths."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from arroyo_tpu_torch.controller.kube import KubeClient

    seen = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _answer(self):
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                self.rfile.read(n)
            seen.append((self.command, self.path, self.headers.get("Authorization")))
            data = json.dumps({"status": {"phase": "Running"}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = do_DELETE = _answer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        k = KubeClient(base_url=f"http://127.0.0.1:{srv.server_address[1]}", token="tok")
        k.create_pod("ns", {"metadata": {"name": "p"}})
        assert k.pod_phase("ns", "p") == "Running"
        k.delete_pod("ns", "p")
    finally:
        srv.shutdown()
    assert seen == [("POST", "/api/v1/namespaces/ns/pods", "Bearer tok"),
                    ("GET", "/api/v1/namespaces/ns/pods/p", "Bearer tok"),
                    ("DELETE", "/api/v1/namespaces/ns/pods/p", "Bearer tok")]
