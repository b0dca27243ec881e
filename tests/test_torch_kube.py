"""The port's Kubernetes scheduler (controller/kube.py) over tests/test_kube.py's
fake kube-apiserver: a job's whole lifecycle through a worker pod whose node
daemon dials home, and a pod that never registers timing out and being
deleted, each run through the port with the JAX test's assertions; the pod
manifest carries the port's image, label, config variable names and GPU
limit. The JAX test's third case reads the JAX package's k8s/arroyo-tpu.yaml;
its counterpart here reads the port's k8s/arroyo-tpu-torch.yaml with the
port's names, and docker/Dockerfile.torch, the port's image."""

from __future__ import annotations

import os

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
    assert cont["resources"] == {"limits": {"nvidia.com/gpu": 1}}
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_manifest_probes_and_autoscaler_keys():
    """tests/test_kube.py's case of the same name, over the port's
    k8s/arroyo-tpu-torch.yaml with the port's names: liveness and readiness
    probes on both tiers (the API's ping for the control plane, /status for
    the node daemons), the autoscaler enabled with bounds, the fleet's
    quotas, tick budget and node-pool knob; then what the port adds: its
    image and worker label, the node id variable, a GPU on every node pod."""
    path = os.path.join(REPO, "k8s", "arroyo-tpu-torch.yaml")
    with open(path) as f:
        text = f.read()
    assert text.count("livenessProbe") == 2
    assert text.count("readinessProbe") == 2
    assert "/api/v1/ping" in text
    assert "/status" in text
    assert "ARROYO_TPU_TORCH__AUTOSCALER__ENABLED" in text
    assert "ARROYO_TPU_TORCH__AUTOSCALER__MAX_PARALLELISM" in text
    assert "ARROYO_TPU_TORCH__FLEET__QUOTA__MAX_SLOTS" in text
    assert "ARROYO_TPU_TORCH__FLEET__TICK_BUDGET_MS" in text
    assert "ARROYO_TPU_TORCH__FLEET__AUTOSCALE__ENABLED" in text
    assert "arroyo_fleet_target_workers" in text
    readme = os.path.join(os.path.dirname(path), "README.md")
    assert os.path.exists(readme)
    assert "Multi-tenant fleet" in open(readme).read()
    # the port's names, and nothing of the JAX package's
    assert "ARROYO_TPU__" not in text and "image: arroyo-tpu:latest" not in text
    assert text.count("image: arroyo-tpu-torch:latest") == 2
    assert "app: arroyo-tpu-torch-worker" in text
    assert "ARROYO_TPU_TORCH__NODE__ID" in text
    assert "nvidia.com/gpu: 1" in text


def test_the_ports_image_runs_the_port_alone(monkeypatch):
    """docker/Dockerfile.torch: a CUDA development image (nvcc builds the
    kernels at first use), torch, triton and numpy installed, the port and
    cpp/ copied and nothing of arroyo_tpu/, `python -m arroyo_tpu_torch`
    its entry point. Every config variable the manifest sets reaches the
    port's config as the value it names."""
    import re

    from arroyo_tpu_torch import config as tcfg

    with open(os.path.join(REPO, "docker", "Dockerfile.torch")) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    base = next(ln for ln in lines if ln.startswith("FROM "))
    assert "nvidia/cuda" in base and "devel" in base
    pip = next(ln for ln in lines if "pip install" in ln).split()
    assert {"torch", "triton", "numpy"} <= set(pip) and "jax" not in " ".join(pip)
    copies = [ln.split()[1] for ln in lines if ln.startswith("COPY ")]
    assert copies == ["arroyo_tpu_torch/", "cpp/"]
    assert 'ENTRYPOINT ["python", "-m", "arroyo_tpu_torch"]' in lines

    with open(os.path.join(REPO, "k8s", "arroyo-tpu-torch.yaml")) as f:
        text = f.read()
    pairs = re.findall(r"- name: (ARROYO_TPU_TORCH__\w+)\n\s+value(?:From)?: (.+)", text)
    assert len(pairs) >= 10
    for var, value in pairs:
        value = value.strip().strip('"') if not value.startswith("{") else "pod-a"
        monkeypatch.setenv(var, value)
        tcfg.reset()
        key = ".".join(p.lower().replace("_", "-") for p in var.split("__")[1:])
        got = tcfg.config().get(key)
        assert str(got).lower() in (value.lower(), f"{value}.0"), (var, got)
    tcfg.reset()
