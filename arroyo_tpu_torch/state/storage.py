"""Checkpoint storage on a local file system (the port's copy of
arroyo_tpu/state/storage.py, for local paths).

One path-string API: ``/abs/path`` or ``file:///abs/path``. Every write is an
atomic publish (a temporary file, then ``os.replace``) and returns the
integrity envelope ``{crc, len, algo}`` of the bytes it wrote; readers verify
an envelope with ``verify_envelope``. The algorithm is the JAX package's:
hardware crc32c when the ``crc32c`` module is importable, else zlib's crc32,
and its name rides in every envelope, so either package verifies the
other's files.

Every read, write, listing and delete runs behind the shared retry layer
(utils/retry.py, ``storage.retry.*``) and one circuit breaker, with its
fault point (``storage.get`` / ``put`` / ``list`` / ``delete``) inside the
retried call, so an injected transient fault recovers in place. Puts and
gets also honour ``corrupt=bitflip|truncate``: the bytes in flight are
damaged after the envelope was taken, as a truncated upload or bit rot
would be.

Not in the port yet: object stores (``s3://``, ``gs://``; their URLs raise)
and multipart uploads.
"""

from __future__ import annotations

import logging
import os
import shutil
import struct
import threading
import zlib
from typing import Callable

from ..faults import fault_point
from ..utils.retry import CircuitBreaker, RetryPolicy, default_transient, retry_call

_log = logging.getLogger("arroyo_tpu_torch.storage")


class IntegrityError(RuntimeError):
    """A state artifact's bytes do not match its recorded checksum envelope
    (a truncated upload, bit rot, a torn write). Restore paths catch it to
    quarantine the epoch and fall back; it is never retried."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"integrity check failed for {path}: {reason}")
        self.path = path
        self.reason = reason


_crc_fn = None
_crc_algo = None


def _crc_impl():
    """(crc function, algo name): crc32c when a library provides it, else
    zlib.crc32. The name is recorded in every envelope so a reader
    recomputes with the writer's algorithm."""
    global _crc_fn, _crc_algo
    if _crc_fn is None:
        try:
            from crc32c import crc32c as _c  # type: ignore

            _crc_fn, _crc_algo = _c, "crc32c"
        except ImportError:
            _crc_fn, _crc_algo = zlib.crc32, "crc32"
    return _crc_fn, _crc_algo


def checksum_of(data: bytes) -> dict:
    """Integrity envelope of one artifact: {crc, len, algo}."""
    fn, algo = _crc_impl()
    return {"crc": fn(data) & 0xFFFFFFFF, "len": len(data), "algo": algo}


def verify_envelope(data: bytes, env: dict, path: str) -> None:
    """Raise IntegrityError unless ``data`` matches the recorded envelope.
    An envelope of an algorithm this host cannot compute degrades to the
    length check, with a warning."""
    want_len = env.get("len")
    if want_len is not None and len(data) != int(want_len):
        raise IntegrityError(path, f"length {len(data)} != recorded {want_len}")
    algo = env.get("algo")
    fn, have = _crc_impl()
    if algo not in (None, have):
        if algo == "crc32":
            fn = zlib.crc32
        else:
            _log.warning("cannot verify %s: recorded algo %r unavailable "
                         "(length check only)", path, algo)
            return
    if "crc" in env and (fn(data) & 0xFFFFFFFF) != int(env["crc"]):
        raise IntegrityError(path, f"{algo or have} mismatch (recorded {env['crc']})")


# Self-describing trailer for artifacts that outlive the epoch whose
# manifest would carry their envelope: payload + [crc u32][len u64]
# [algo 8s][magic 8s], the magic last so the tail alone detects it.
FOOTER_MAGIC = b"ARROYOCK"
_FOOTER_LEN = 4 + 8 + 8 + 8


def wrap_footer(data: bytes) -> bytes:
    env = checksum_of(data)
    return (data + struct.pack(">IQ", env["crc"], env["len"])
            + env["algo"].encode().ljust(8) + FOOTER_MAGIC)


def unwrap_footer(data: bytes, path: str = "<buffer>", verify: bool = True) -> bytes:
    """Strip (and optionally verify) the integrity footer; data without one
    passes through untouched."""
    if len(data) < _FOOTER_LEN or not data.endswith(FOOTER_MAGIC):
        return data
    trailer = data[-_FOOTER_LEN:]
    crc, length = struct.unpack(">IQ", trailer[:12])
    algo = trailer[12:20].strip().decode("ascii", "replace")
    payload = data[:-_FOOTER_LEN]
    if verify:
        verify_envelope(payload, {"crc": crc, "len": length, "algo": algo}, path)
    return payload


def _apply_corruption(data: bytes, mode: str) -> bytes:
    """Deterministic injected corruption (``storage.*:corrupt=<mode>``):
    bitflip flips one bit of the middle byte; truncate keeps the first
    half. Both are caught by any crc + length envelope."""
    if not data:
        return data
    if mode == "truncate":
        return data[:len(data) // 2]
    mid = len(data) // 2
    return data[:mid] + bytes([data[mid] ^ 0x01]) + data[mid + 1:]


# One breaker across every storage operation: when the store is hard-down,
# checkpoint attempts fail fast instead of each burning a full retry
# schedule.
_breaker = CircuitBreaker(threshold=8, cooldown_s=5.0, name="storage")


def _policy() -> RetryPolicy:
    return RetryPolicy.from_config("storage.retry")


def reset_retry_state() -> None:
    """Close the storage circuit (tests isolate retry state per test)."""
    _breaker.reset()


def _guarded(site: str, key: str, fn: Callable):
    """Run one storage operation behind the shared retry layer, with the
    fault point inside the retried callable so an injected transient fault
    recovers in place (no job restart)."""

    def _once():
        fault_point(site, key=key)
        return fn()

    return retry_call(_once, policy=_policy(), retry_on=default_transient,
                      description=f"{site} {key}", breaker=_breaker)


def _guarded_v(site: str, key: str, fn: Callable):
    """Like _guarded, but the callable receives the fault point's verdict:
    the data paths (get, put) apply a ``corrupt`` verdict to the bytes in
    flight."""

    def _once():
        return fn(fault_point(site, key=key))

    return retry_call(_once, policy=_policy(), retry_on=default_transient,
                      description=f"{site} {key}", breaker=_breaker)


def _local(path: str) -> str:
    """The file-system path of a storage URL; object stores raise."""
    if path.startswith(("s3://", "gs://")):
        raise NotImplementedError(
            f"storage URL {path!r}: the port writes checkpoints to local paths only; "
            f"the S3 and GCS clients are not ported yet (ROADMAP A.9)")
    return path[len("file://"):] if path.startswith("file://") else path


def read_bytes(path: str) -> bytes:
    def _do(verdict) -> bytes:
        with open(_local(path), "rb") as f:
            data = f.read()
        if verdict and verdict[0] == "corrupt":
            data = _apply_corruption(data, str(verdict[1]))
        return data

    return _guarded_v("storage.get", path, _do)


def write_bytes(path: str, data: bytes) -> dict:
    """Write one artifact atomically; returns the integrity envelope of the
    true bytes, taken before any injected corruption (so a corrupt put is
    caught on read, as a truncated upload is). The temporary file is the
    writer's own, so two writers of one path (jobs of one id in two
    processes) cannot tear each other's write."""
    env = checksum_of(data)
    p = _local(path)

    def _do(verdict) -> None:
        payload = data
        if verdict and verdict[0] == "corrupt":
            payload = _apply_corruption(payload, str(verdict[1]))
        tmp = f"{p}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, p)

    _guarded_v("storage.put", path, _do)
    return env


def read_text(path: str) -> str:
    return read_bytes(path).decode("utf-8")


def write_text(path: str, text: str) -> dict:
    return write_bytes(path, text.encode("utf-8"))


def verify_mode() -> str:
    """``state.integrity.verify``: ``restore`` (default: verify artifacts on
    the restore path only), ``always`` (every checkpointed read) or ``off``
    (trust the store)."""
    from ..config import config

    return str(config().get("state.integrity.verify") or "restore")


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def isdir(path: str) -> bool:
    p = _local(path)
    return _guarded("storage.list", path, lambda: os.path.isdir(p))


def listdir(path: str) -> list[str]:
    """Immediate children, names only, sorted."""
    p = _local(path)
    return _guarded("storage.list", path, lambda: sorted(os.listdir(p)))


def remove(path: str) -> None:
    p = _local(path)
    _guarded("storage.delete", path, lambda: os.remove(p))


def rmtree(path: str) -> None:
    """Best-effort recursive delete (the checkpoint GC path)."""
    shutil.rmtree(_local(path), ignore_errors=True)
