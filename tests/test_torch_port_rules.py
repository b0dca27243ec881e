"""Rules of the PyTorch port that hold by construction: it imports neither
JAX nor arroyo_tpu, its entry points run on CUDA unless the CPU is named,
and a missing GPU or compiler raises instead of falling back."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import arroyo_tpu_torch
import arroyo_tpu_torch.config as tcfg
from arroyo_tpu_torch.device import resolve_device
from arroyo_tpu_torch.ops import kernels
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(arroyo_tpu_torch.__path__,
                                                        "arroyo_tpu_torch."))


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


def test_port_and_chip_smoke_import_neither_jax_nor_arroyo_tpu():
    mods = _port_modules()
    assert {"arroyo_tpu_torch.ops.kernels", "arroyo_tpu_torch.ops.slot_agg",
            "arroyo_tpu_torch.windows.tumbling", "arroyo_tpu_torch.engine.engine",
            "arroyo_tpu_torch.ops.join_kernels", "arroyo_tpu_torch.ops.join_probe",
            "arroyo_tpu_torch.operators.joins", "arroyo_tpu_torch.operators.updating_aggregate",
            "arroyo_tpu_torch.windows.session", "arroyo_tpu_torch.ops.sharded_kernels",
            "arroyo_tpu_torch.parallel.mesh", "arroyo_tpu_torch.parallel.sharded_agg",
            "arroyo_tpu_torch.connectors.impulse"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'arroyo_tpu' or m.startswith('arroyo_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda_and_raises_without_it():
    assert not torch.cuda.is_available()  # this suite runs on a CPU-only build
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlotAggregator(("count",), (np.int64,), cap=64, region_size=16)
    from arroyo_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(8)
    assert resolve_device("cpu") == torch.device("cpu")
    tcfg.update({"device.torch-device": "cpu"})
    assert resolve_device() == torch.device("cpu")


def test_default_device_run_graph_raises_without_cuda():
    from arroyo_tpu_torch.engine import run_graph

    rows = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_graph(_tiny_graph(rows))
    assert rows == []


def _tiny_graph(rows):
    from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
    from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName

    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "nexmark", "event_count": 100,
                                           "first_event_micros": 0}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "sink", EdgeType.FORWARD, Schema.of([(TIMESTAMP_FIELD, "int64")]))
    return g


def test_later_slices_are_refused_not_skipped():
    from arroyo_tpu_torch.engine import Engine
    from arroyo_tpu_torch.windows.sliding import SlidingAggregate

    # the next unported feature: a sliding window's checkpoint barrier
    window = SlidingAggregate({"width_micros": 10, "slide_micros": 5,
                               "aggregates": [("n", "count", None)]})

    class Barrier:
        epoch = 1

    with pytest.raises(NotImplementedError, match="checkpoint"):
        window.handle_checkpoint(Barrier(), None, None)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        Engine(_tiny_graph([]), device="cpu", restore_epoch=1)
    eng = Engine(_tiny_graph([]), device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        eng.checkpoint_and_wait(1)


@pytest.mark.parametrize("op", ["updating_aggregate", "session_aggregate"])
def test_checkpoint_barrier_of_slice_4_operators_refused(op):
    """The updating aggregate and the session window carry their state
    layout (state_batch / load_state_batch) but no checkpoint barrier yet."""
    from arroyo_tpu_torch.engine import construct_operator
    from arroyo_tpu_torch.graph import OpName

    cfg = {"aggregates": [("n", "count", None)], "gap_micros": 10}
    with pytest.raises(NotImplementedError, match="checkpoint"):
        construct_operator(OpName(op), cfg).handle_checkpoint(None, None, None)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit at /usr/local/cuda")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library()
    from arroyo_tpu_torch.ops import join_kernels

    with pytest.raises(RuntimeError, match="nvcc not found"):
        join_kernels.build_library()
    from arroyo_tpu_torch.ops import sharded_kernels

    with pytest.raises(kernels.KernelError, match="nvcc not found"):
        sharded_kernels.build_library()
    meta = lambda dt: torch.zeros((2, 4), dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        sharded_kernels.agg_sort_reduce(["count"], meta(torch.int64), meta(torch.int32),
                                        None, [None])
    assert sharded_kernels.launch_counts()["agg_sort_reduce"] == 0
    # a tensor on a device the port has no kernel for is refused, not
    # routed to the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.slot_scatter_combine([torch.zeros(4, device="meta")], ["count"],
                                     torch.zeros(2, dtype=torch.int32, device="meta"), [None])
    assert kernels.launch_counts()["slot_scatter_combine"] == 0


def test_segment_kernel_fault_on_cuda_fails_the_task_not_falls_back():
    """On a CUDA device any fault of the fused segment kernel (here: this
    build of torch has no CUDA, so staging the first batch fails) is a
    KernelError that escapes the segment runner; it is never turned into a
    SEGMENT_FALLBACK that would run the plain version instead."""
    import chip_smoke
    from arroyo_tpu_torch.batch import Batch
    from arroyo_tpu_torch.engine import segment
    from arroyo_tpu_torch.metrics import TaskMetrics
    from arroyo_tpu_torch.obs.events import recorder
    from arroyo_tpu_torch.operators.base import OperatorContext
    from arroyo_tpu_torch.ops.segment_kernel import KernelError
    from arroyo_tpu_torch.optimizer import chain_graph
    from arroyo_tpu_torch.types import TaskInfo

    tcfg.update({"segment.compile.min-rows": 0})
    g = chain_graph(chip_smoke.build_q7([], 1000))
    node = g.nodes["bids+wm+key+agg+sink"]
    from arroyo_tpu_torch.engine import construct_operator

    op = construct_operator(node.op, node.config)
    ctx = OperatorContext(TaskInfo("kfault", node.node_id, "chained", 0, 1), torch.device("cuda"))
    op._ctxs = [OperatorContext(ctx.task_info, ctx.device) for _ in op.members]
    runner = segment.runner_for(op, ctx, TaskMetrics("kfault", node.node_id, 0))
    batch = Batch(chip_smoke.nexmark_columns(512, ["bid.auction", "bid.price"], 1000))
    with pytest.raises(KernelError, match="segment kernel K4 on cuda"):
        runner.process_batch(batch, ctx, None)
    assert recorder.events("kfault", "SEGMENT_FALLBACK") == []
