"""A cell's run on the CPU at a size a test run holds: the system's plain
versions in place of its kernels, smaller batches and tables, and events
1 ms apart (a 10 s window holds 10,000 events, so a short run on the CPU
closes several).

A cell whose files are under ``workloads/`` but which ``BENCHMARK.json``
does not name (``q7.hot``: kept as data, out of the benchmark while its
rate is too noisy on a shared host to carry a bound) runs through a copy
of ``BENCHMARK.json`` that names it, so its path stays tested."""

import atexit
import json
import shutil
import tempfile
from pathlib import Path

import torch

import run

# the tests run several processes at once: one intra-op thread each keeps
# the CPU's plain versions from fighting over the cores
torch.set_num_threads(1)

SMALL = {"pipeline.source-batch-size": 8192, "device.batch-capacity": 8192,
         "worker.queue-size": 16384, "device.table-capacity": 8192, "device.region-size": 512,
         "device.emit-capacity": 1024, "segment.compile.min-rows": 1}
STREAM = {"inter_event_micros": 1000}

_parked_root = None


def parked_root() -> Path:
    """A directory whose ``BENCHMARK.json`` is the benchmark's with an entry
    for every cell and configuration that has files but no entry."""
    global _parked_root
    if _parked_root is None:
        spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"] for w in spec["workloads"]}
        configs = {c["name"] for c in spec["configs"]}
        for f in sorted((run.BENCH / "workloads").glob("*.json")):
            cell, work = f.name[:-len(".json")], json.loads(f.read_text())
            if cell in cells:
                continue
            spec["workloads"].append({"name": cell, "config": work["config"],
                                      "traffic": work["traffic"], "chips": work["chips"],
                                      "why": "kept as data"})
            if work["config"] not in configs:
                configs.add(work["config"])
                spec["configs"].append({"name": work["config"], "source": "kept as data",
                                        "file": f"benchmark/configs/{work['config']}.json",
                                        "reduced": [], "why": "kept as data"})
        _parked_root = Path(tempfile.mkdtemp(prefix="benchmark-tests-"))
        atexit.register(shutil.rmtree, _parked_root, True)
        (_parked_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return _parked_root


def cpu_run(cell, seed=20240601, seconds=1.0, trace=False, fault=None, control=None, root=None):
    if root is None:
        named = {w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]}
        root = run.ROOT if cell in named else parked_root()
    return run.run(cell, seed, seconds, trace, device="cpu", overrides=SMALL, fault=fault,
                   control=control, stream_overrides=STREAM, root=root)
