"""Rules of the PyTorch port that hold by construction: it imports neither
JAX nor arroyo_tpu (nor pandas, which the card's machine lacks), its entry points run on CUDA unless the CPU is named,
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
            "arroyo_tpu_torch.connectors.impulse", "arroyo_tpu_torch.faults",
            "arroyo_tpu_torch.faults.plan", "arroyo_tpu_torch.utils.retry",
            "arroyo_tpu_torch.analysis", "arroyo_tpu_torch.analysis.diagnostics",
            "arroyo_tpu_torch.analysis.plan_diff", "arroyo_tpu_torch.sql.lexer",
            "arroyo_tpu_torch.state.integrity", "arroyo_tpu_torch.sql",
            "arroyo_tpu_torch.sql.ast", "arroyo_tpu_torch.sql.parser",
            "arroyo_tpu_torch.sql.compile", "arroyo_tpu_torch.sql.planner",
            "arroyo_tpu_torch.udf", "arroyo_tpu_torch.formats",
            "arroyo_tpu_torch.formats.base", "arroyo_tpu_torch.formats.framing",
            "arroyo_tpu_torch.formats.json_fmt", "arroyo_tpu_torch.formats.registry",
            "arroyo_tpu_torch.connectors.single_file",
            "arroyo_tpu_torch.analysis.plan_passes",
            "arroyo_tpu_torch.analysis.trace_audit", "arroyo_tpu_torch.state.spill",
            "arroyo_tpu_torch.operators.window_fn",
            "arroyo_tpu_torch.operators.async_udf"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, os\n"
        "name = 'updating_aggregate'\n"  # the card's golden compare, debezium merge and all
        "chip_smoke.smoke_check(name, os.path.join(chip_smoke.SMOKE_DIR, 'golden', name + '.json'))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'arroyo_tpu' or m.startswith('arroyo_tpu.')\n"
        "             or m == 'pandas' or m.startswith('pandas.')\n"
        "             or m in ('pytest', 'test_smoke', 'generate'))\n"
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


def _tiny_graph(rows, event_count=100):
    from arroyo_tpu_torch.batch import TIMESTAMP_FIELD, Schema
    from arroyo_tpu_torch.graph import EdgeType, Graph, Node, OpName

    g = Graph()
    g.add_node(Node("src", OpName.SOURCE, {"connector": "nexmark", "event_count": event_count,
                                           "first_event_micros": 0}, 1))
    g.add_node(Node("sink", OpName.SINK, {"connector": "vec", "rows": rows}, 1))
    g.add_edge("src", "sink", EdgeType.FORWARD, Schema.of([(TIMESTAMP_FIELD, "int64")]))
    return g


def test_later_slices_are_refused_not_skipped(tmp_path, monkeypatch):
    """What the port cannot do raises through the entry points a user calls:
    a checkpoint to an object store with no client (boto3 missing, none
    injected) fails the job naming both ways out; and compaction refuses an
    epoch the engine has not completed."""
    from arroyo_tpu_torch.engine import Engine
    from arroyo_tpu_torch.state import storage

    monkeypatch.setitem(sys.modules, "boto3", None)  # boto3 not installed
    monkeypatch.setattr(storage, "_s3_client", None)
    eng = Engine(_tiny_graph([], event_count=10_000_000), job_id="refused", device="cpu",
                 storage_url="s3://bucket/checkpoints")
    eng.start()
    with pytest.raises(RuntimeError, match="requires boto3.*set_s3_client"):
        eng.checkpoint_and_wait(1, timeout=60)
    with pytest.raises(RuntimeError):
        eng.join(timeout=60)
    eng = Engine(_tiny_graph([]), job_id="refused", device="cpu",
                 storage_url=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="not a completed checkpoint"):
        eng.compact(1)


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


def test_control_plane_imports_neither_jax_nor_arroyo_tpu():
    code = (
        "import sys\n"
        "import arroyo_tpu_torch.cli, arroyo_tpu_torch.controller, arroyo_tpu_torch.api\n"
        "import arroyo_tpu_torch.engine.network, arroyo_tpu_torch.native.wire\n"
        "import arroyo_tpu_torch.controller.scheduler, arroyo_tpu_torch.server_common\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'arroyo_tpu' or m.startswith('arroyo_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("argv,item", [
    pytest.param(["check", "bad.sql", "--json"], "AR002", id="check"),
    pytest.param(["lint", "engine", "--json"], "LR102", id="lint"),
])
def test_left_out_subcommands_exit_nonzero_naming_their_item(argv, item, capsys, tmp_path):
    """No subcommand is left out since ROADMAP A.10 was ported: check and
    lint run, and on a rejected pipeline or a dirty file they exit 1
    naming the rule, as the JAX package's do (no longer 2 naming A.10)."""
    from arroyo_tpu_torch import cli

    (tmp_path / "bad.sql").write_text(
        "CREATE TABLE src (a BIGINT NOT NULL) WITH (connector = 'single_file', "
        "path = '/dev/null', format = 'json', type = 'source');\n"
        "CREATE TABLE out (n BIGINT) WITH (connector = 'single_file', "
        f"path = '{tmp_path / 'out.json'}', format = 'json', type = 'sink');\n"
        "INSERT INTO out SELECT count(*) AS n FROM src "
        "GROUP BY hop(interval '3 seconds', interval '10 seconds');\n")
    (tmp_path / "engine").mkdir()
    (tmp_path / "engine" / "x.py").write_text(
        "def f():\n    try:\n        g()\n    except:\n        pass\n")
    argv = [str(tmp_path / a) if a in ("bad.sql", "engine") else a for a in argv]
    assert cli.main(argv) == 1
    out = capsys.readouterr()
    assert item in out.out and "A.10" not in out.out + out.err


def test_every_ported_subcommand_exists():
    from arroyo_tpu_torch import cli

    for cmd in ("run", "cluster", "api", "worker", "visualize", "fsck", "trace", "top",
                "logs", "explain", "evolve", "node", "compile-service", "check", "lint"):
        with pytest.raises(SystemExit) as ei:
            cli.main([cmd, "--help"])
        assert ei.value.code == 0, cmd


def test_package_and_chip_smoke_import_without_the_optional_libraries():
    """pyarrow, google.protobuf, boto3 and confluent_kafka are imported
    lazily, where a parquet file, a protobuf message, an S3 client or a
    Kafka client is used: with the four blocked, every module of the port
    and chip_smoke import, the parquet default falls back to npz, an S3 URL
    without a client raises, and so does a Kafka source or sink, naming
    confluent_kafka."""
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pyarrow', 'boto3', 'confluent_kafka') \\\n"
        "                or name.startswith('google.protobuf'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke, arroyo_tpu_torch\n"
        "arroyo_tpu_torch._load_operators()\n"
        "from arroyo_tpu_torch.state import tables, storage\n"
        "assert tables._checkpoint_format() == 'npz'\n"
        "try:\n"
        "    storage.write_bytes('s3://b/k', b'x')\n"
        "    sys.exit('an s3 write without a client succeeded')\n"
        "except RuntimeError as e:\n"
        "    assert 'boto3' in str(e), e\n"
        "from arroyo_tpu_torch.connectors.kafka import KafkaSink, KafkaSource\n"
        "for run in (lambda: KafkaSource({'topic': 't', 'schema': None}).run(None, None),\n"
        "            lambda: KafkaSink({'topic': 't'}).on_start(None)):\n"
        "    try:\n"
        "        run()\n"
        "        sys.exit('a kafka operator started without confluent_kafka')\n"
        "    except ImportError as e:\n"
        "        assert 'confluent_kafka' in str(e), e\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pyarrow', 'boto3',\n"
        "                                                           'confluent_kafka')\n"
        "             or m.startswith('google.protobuf'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
