"""Process-global configuration of the port (its own copy; the JAX package's
config is a separate object, so tests can load both packages in one
process without one reset clearing the other).

Only the sections the port reads: ``pipeline``, ``worker``,
``engine.coalesce``, ``segment.compile``, ``checkpoint``, ``state``,
``storage.retry``, ``faults``, ``testing``, ``device``, ``native``,
and ``profile``. The checkpoint keys have the JAX package's names and meaning;
``checkpoint.storage-url`` defaults to a directory under the temporary
directory (``TMPDIR``) rather than the JAX package's ``/tmp/arroyo-tpu``,
and the port writes npz state files for either value of
``checkpoint.file-format``, as the JAX package does where pyarrow is
missing (state/tables.py refuses any other value).
The JAX package reads ``device.join-min-rows`` and
``device.force-device-join`` with defaults and has no entry for them; the
port lists them here with the same defaults and meaning.
``device.torch-device`` names the torch device (None = ``cuda``; see
device.py). The mesh keys (``device.mesh-devices``, ``max-probes``,
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

_DEFAULTS: dict[str, Any] = {
    "pipeline": {
        "source-batch-size": 512,  # rows per source flush
        # fuse forward-connected runs of operators into one task
        # (optimizer.chain_graph), whose traceable prefix runs as one fused
        # kernel per micro-batch (engine/segment.py)
        "chaining": {"enabled": False},
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
        # of this many key shards (parallel/), on the one device
        "mesh-devices": 0,
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


_lock = threading.Lock()
_config: Config | None = None


def config() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = Config(copy.deepcopy(_DEFAULTS))
        return _config


def update(overrides: dict[str, Any]) -> None:
    """Live-update config (used by tests and chip_smoke.py)."""
    global _config
    with _lock:
        base = _config if _config is not None else Config(copy.deepcopy(_DEFAULTS))
        _config = base.with_overrides(overrides)


def reset() -> None:
    global _config
    with _lock:
        _config = None
