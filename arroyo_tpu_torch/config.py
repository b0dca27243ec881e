"""Process-global configuration of the port (its own copy; the JAX package's
config is a separate object, so tests can load both packages in one
process without one reset clearing the other).

Only the sections this slice reads: ``pipeline``, ``worker``,
``engine.coalesce`` and ``device``. ``device.torch-device`` names the torch
device (None = ``cuda``; see device.py).
"""

from __future__ import annotations

import copy
import threading
from typing import Any

_DEFAULTS: dict[str, Any] = {
    "pipeline": {
        "source-batch-size": 512,  # rows per source flush
        # chaining fuses operators into compiled segments; the segment
        # compiler is the next slice of the port, so True is refused
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
    "device": {
        "torch-device": None,  # None = cuda (device.resolve_device)
        "batch-capacity": 8192,  # rows per aggregator update chunk
        "table-capacity": 65536,  # slots of keyed window state on the device
        "region-size": 2048,  # slots per region (one window close reads whole regions)
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
