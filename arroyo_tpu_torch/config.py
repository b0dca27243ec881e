"""Process-global configuration of the port (its own copy; the JAX package's
config is a separate object, so tests can load both packages in one
process without one reset clearing the other).

Only the sections the port reads: ``pipeline``, ``worker``,
``engine.coalesce``, ``segment.compile``, ``checkpoint``, ``state``,
``storage.retry``, ``faults``, ``testing``, ``device``, ``native``,
``profile``, and the control plane's ``controller``, ``fleet``, ``health``,
``autoscaler``, ``admin``, ``api`` and ``logging``, with the JAX package's
defaults.

Layers, as the JAX package's loader: the defaults, then the TOML files
``/etc/arroyo-tpu-torch/config.toml``,
``~/.config/arroyo-tpu-torch/config.toml``, ``arroyo-tpu-torch.toml`` and
the file named by ``ARROYO_TPU_TORCH_CONFIG``, then environment variables
``ARROYO_TPU_TORCH__SECTION__KEY`` (``ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE
=cpu`` is ``device.torch-device = "cpu"``). The names are the port's own:
both packages load in one process under the tests, and neither reads the
other's settings. A worker subprocess learns its device and storage this
way. The checkpoint keys have the JAX package's names and meaning;
``checkpoint.storage-url`` defaults to a directory under the temporary
directory (``TMPDIR``) rather than the JAX package's ``/tmp/arroyo-tpu``;
``checkpoint.file-format`` gives parquet state files where pyarrow is
importable and npz where it is not, as in the JAX package (state/tables.py
refuses any other value). The keys the JAX package reads with defaults and
lists nowhere are read the same way here: ``storage.multipart-threshold-bytes``
and ``multipart-part-size-bytes`` (state/storage.py), ``compiler.endpoint``
and ``artifacts-url`` (compiler.py; the artifacts default to the package's
``build/udf-artifacts``), ``node.id`` (controller/node.py) and the
``kubernetes-scheduler`` section (controller/kube.py).
The JAX package reads ``device.join-min-rows`` and
``device.force-device-join`` with defaults and has no entry for them; the
port lists them here with the same defaults and meaning.
``device.torch-device`` names the torch device (None = ``cuda``; see
device.py). ``device.mesh-placement``, a key of the port alone, gives a
mesh's device slots (device.py ``mesh_slot_devices``): None takes the first
``min(n, cards)`` cards on an index-less ``cuda`` and one slot elsewhere; a
TOML array of device names (or, from the environment, one comma-separated
string) gives one slot each, a slot on a card the machine lacks raising. The
mesh keys (``device.mesh-devices``, ``max-probes``,
``emit-capacity``, ``spill-capacity``, ``segment.compile.mesh-fuse``) have
the JAX package's defaults and meaning. ``native.enabled`` (default True,
a key the JAX package reads with that default) takes the native host
library (native/); off, its numpy twins run. ``profile.enabled`` is the
JAX package's key and default; its ``profile.sketch.*`` and
``obs.events.max-per-job`` defaults are constants of the port
(obs/profile.py, metrics.py, obs/events.py).
"""

from __future__ import annotations

import copy
import os
import tempfile
import threading
from typing import Any

import tomllib

ENV_PREFIX = "ARROYO_TPU_TORCH__"
ENV_CONFIG_FILE = "ARROYO_TPU_TORCH_CONFIG"
CONFIG_FILE_NAME = "arroyo-tpu-torch.toml"

_DEFAULTS: dict[str, Any] = {
    "pipeline": {
        "source-batch-size": 512,  # rows per source flush
        # fuse forward-connected runs of operators into one task
        # (optimizer.chain_graph), whose traceable prefix runs as one fused
        # kernel per micro-batch (engine/segment.py)
        "chaining": {"enabled": False},
        # the controller's restart budget and health window
        "allowed-restarts": 20,
        "healthy-duration-ms": 120_000,
        # a worker silent this long is declared hung and its set restored
        "worker-heartbeat-timeout-ms": 30_000,
    },
    "worker": {
        "queue-size": 8192,  # rows of in-flight budget per input edge
    },
    "engine": {
        # micro-batch coalescing on the emission path; signals always flush
        # pending rows first, so ordering is untouched
        "coalesce": {
            "enabled": True,
            "max-rows": 4096,
            "max-bytes": 1_048_576,
            "max-delay-ms": 5,
        },
    },
    "segment": {
        # whole-segment compilation (engine/segment.py): a chained run
        # marked compilable at plan time runs as ONE launch of the fused
        # segment kernel per micro-batch. A segment that cannot be lowered,
        # or whose first-batch verification is not bit-identical to the
        # interpreted path, falls back with a SEGMENT_FALLBACK event.
        "compile": {
            "enabled": True,
            # process-wide LRU of built (segment, schema, device) entries
            "cache-max": 32,
            # batches below this many rows (input, or survivors of the
            # hoisted leading filter) run interpreted
            "min-rows": 8192,
            # with device.mesh-devices > 1, a segment that ends in a window
            # insert feeds the sharded aggregate's exchange + merge on the
            # device directly (the fused mesh step); off, its outputs take
            # the host path (insert_arrays -> round-robin host rows)
            "mesh-fuse": True,
        },
    },
    "checkpoint": {
        # root of every job's checkpoints (state/tables.py layout); local
        # paths only in the port
        "storage-url": os.path.join(tempfile.gettempdir(), "arroyo-tpu-torch", "checkpoints"),
        # "parquet" | "npz": the port writes npz for either (the JAX
        # package's fallback without pyarrow); another value raises
        "file-format": "parquet",
        # the controller's periodic checkpoints
        "interval-ms": 10_000,
        # stuck-checkpoint watchdog: a triggered epoch not globally durable
        # within this window is declared failed, its torn shards subsumed
        # and the checkpoint retried; after max-consecutive-failures the
        # worker set is restored from the last complete checkpoint. 0 = off.
        "timeout-ms": 600_000,
        "max-consecutive-failures": 3,
        # controller-driven GC: compact and drop old checkpoints every N
        # completed epochs (never past the newest complete one). 0 = off.
        "compaction": {"epochs": 0},
    },
    "state": {
        # tiered state (state/spill.py): keep the hot working set in memory
        # and spill cold hash-range partitions as runs (bloom filter and
        # min/max zone maps per run) to checkpoint storage once a subtask's
        # resident state passes the budget; off by default
        "spill": {
            "enabled": False,
            # per-subtask resident-state budget (the operators' resident-state estimates)
            "budget-bytes": 64 * 1024 * 1024,
        },
        # checkpoint-file checksum verification: "restore" verifies the
        # envelopes on the restore path only, "always" on every checkpointed
        # read, "off" trusts storage
        "integrity": {"verify": "restore"},
    },
    "storage": {
        # shared resilience layer (utils/retry.py) for storage operations
        "retry": {
            "max-attempts": 4,
            "base-delay-ms": 50,
            "max-delay-ms": 2000,
            "multiplier": 2.0,
            "jitter": 0.5,
        },
    },
    "faults": {
        # deterministic fault injection (arroyo_tpu_torch.faults); empty = off.
        # e.g. "storage.put:fail_once@epoch=2,worker:crash@barrier=3"
        "plan": "",
        "seed": 0,
    },
    "testing": {
        # single_file: after half its input, hold until this many barriers passed
        "source-gate-epochs": 0,
        # single_file: sleep this long before every line it reads, so a
        # controller test can act while the job is mid-stream
        "source-read-delay-micros": 0,
    },
    "native": {
        # the C++ host library (native/): hashing, the keyed shuffle's
        # partition and the slot directory's resolve; a failed build raises
        "enabled": True,
    },
    "profile": {
        # runtime cost attribution (obs/profile.py): per-operator self-time
        # in the task run loop, state-size gauges and key-skew sketches
        "enabled": True,
    },
    "controller": {
        "scheduler": "embedded",
        # size of each job's worker set; > 1 turns on the controller's
        # cross-worker checkpoint coordination
        "workers-per-job": 1,
    },
    "fleet": {
        # shared worker pool (controller/fleet.py); 0 = unlimited
        "slots": 0,
        "drr-quantum": 1,
        "requeue-backoff-base-s": 0.5,
        "requeue-backoff-max-s": 30.0,
        "tick-budget-ms": 250,
        "tick-penalty-max": 4,
        "quota": {"max-slots": 0, "max-jobs": 0},
        "autoscale": {
            "enabled": False,
            "max-slots": 64,
            "up-ticks": 3,
            "down-ticks": 20,
            "cooldown-s": 15.0,
            "headroom-slots": 0,
        },
    },
    "health": {
        # controller-side health rules (obs/health.py), with hysteresis
        "enabled": True,
        "fire-ticks": 3,
        "clear-ticks": 5,
        "watermark-lag-max-s": 900.0,
        "backpressure-max": 0.9,
        "queue-transit-p99-max-ms": 1000.0,
        "sink-latency-p99-max-s": 600.0,
        "checkpoint-failure-streak": 2,
        "memory-pressure-max": 0.9,
    },
    "autoscaler": {
        # per-job elastic autoscaler (controller/autoscaler.py); off
        "enabled": False,
        "min-parallelism": 1,
        "max-parallelism": 8,
        "up-ticks": 3,
        "down-ticks": 10,
        "up-factor": 2.0,
        "down-factor": 0.5,
        "up-backpressure": 0.8,
        "up-queue-transit-p99-ms": 750.0,
        "up-watermark-lag-s": 30.0,
        "up-sink-latency-p99-s": 30.0,
        "down-busy-max-pct": 25.0,
        "down-backpressure-max": 0.1,
        "cooldown-s": 30.0,
        "backoff-base-s": 10.0,
        "backoff-multiplier": 2.0,
        "backoff-max-s": 300.0,
    },
    "logging": {
        "format": "console",  # console | json | logfmt
        "level": "INFO",
        # stdlib log records carrying job context land in the job event feed
        "capture-events": False,
    },
    # the REST API's port where `cluster` and `api` get no --api-port
    "api": {"http-port": 5115},
    "admin": {"http-port": 5114},
    "device": {
        "torch-device": None,  # None = cuda (device.resolve_device)
        # operators that can lower to the device do so (the join's default
        # backend; the JAX package's key of the same name)
        "enabled": True,
        # a window's join goes to the device only when one of its sides has
        # at least this many rows (below it the host probe is cheaper)
        "join-min-rows": 2048,
        # take the device join even where the device is the host CPU (tests)
        "force-device-join": False,
        "batch-capacity": 8192,  # rows per aggregator update chunk
        "table-capacity": 65536,  # slots of keyed window state on the device
        "region-size": 2048,  # slots per region (one window close reads whole regions)
        # > 1: the window operators keep their state in a ShardedAggregator
        # of this many key shards (parallel/)
        "mesh-devices": 0,
        # the mesh's device slots (device.mesh_slot_devices): None, or device
        # names, one slot each; each slot holds a contiguous run of shards
        "mesh-placement": None,
        "max-probes": 64,  # linear-probing rounds of the sharded hash table
        "emit-capacity": 8192,  # rows per shard per sharded close round
        "spill-capacity": 2048,  # rows of each shard's spill buffer
        "prefetch-workers": 8,  # threads that wait on device->host fetches
    },
}


class Config:
    def __init__(self, data: dict[str, Any]):
        self._data = data

    def get(self, path: str, default=None):
        """Dotted-path lookup: config().get("worker.queue-size")."""
        cur: Any = self._data
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def section(self, name: str) -> dict:
        return self._data.get(name, {})

    def with_overrides(self, overrides: dict[str, Any]) -> "Config":
        data = copy.deepcopy(self._data)
        for path, value in overrides.items():
            _set_path(data, path, value)
        return Config(data)


def _set_path(data: dict, path: str, value):
    parts = path.split(".")
    cur = data
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_env(val: str) -> Any:
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    for conv in (int, float):
        try:
            return conv(val)
        except ValueError:
            continue
    return val


def _load() -> Config:
    """Defaults, then the TOML files, then ``ARROYO_TPU_TORCH__A__B_C``
    environment variables (``a.b-c``)."""
    data = copy.deepcopy(_DEFAULTS)
    paths = ["/etc/arroyo-tpu-torch/config.toml",
             os.path.expanduser("~/.config/arroyo-tpu-torch/config.toml"),
             CONFIG_FILE_NAME]
    if os.environ.get(ENV_CONFIG_FILE):
        paths.append(os.environ[ENV_CONFIG_FILE])
    for path in paths:
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = _merge(data, tomllib.load(f))
    for key, val in os.environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        parts = [p.lower().replace("_", "-") for p in key[len(ENV_PREFIX):].split("__")]
        _set_path(data, ".".join(parts), _parse_env(val))
    return Config(data)


_lock = threading.Lock()
_config: Config | None = None


def config() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = _load()
        return _config


def update(overrides: dict[str, Any]) -> None:
    """Live-update config (used by tests and chip_smoke.py)."""
    global _config
    with _lock:
        base = _config if _config is not None else _load()
        _config = base.with_overrides(overrides)


def reset() -> None:
    global _config
    with _lock:
        _config = None
