"""ctypes bindings for the C++ host runtime (the port's copy of
arroyo_tpu/native: hashing, repartition, the slot directory's resolve, the
JSON-lines parser and the framed TCP data plane between workers).

The library is built from the repo's ``cpp/arroyo_host.cc`` with ``g++``
into ``arroyo_tpu_torch/build/libarroyo_host_<digest>.so`` at first use
(the digest covers the source and the flags, so a changed source never
loads a stale build). ``cpp/`` is only read. Several processes may build at
once (a test run's workers): each takes a file lock beside the output,
compiles into a temporary name and ``os.replace``s it into place, so no
process ever loads a half-written library.

``native.enabled`` (the port's config, default True) chooses the path. While
it is on, a failed build raises with the compiler's log: the numpy path is
taken only when a caller turns the flag off. This differs from the JAX
package, which falls back silently; a silent fallback would change the slot
directory's allocation order without a word (ops/slot_agg.py).

Each entry point returns None when the flag is off, and the caller runs its
numpy twin, which gives the same bits. ``dir_resolve`` also returns None
when a probe wraps the whole directory, as the JAX package's does, and
``parse_json_lines`` on input it cannot parse (the caller's Python parser
then gives the precise error). The data plane has no numpy twin: with the
flag off, a listener or a connection raises DataPlaneError.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "cpp" / "arroyo_host.cc"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # path, seconds, cached, log of the library this process loaded


class NativeBuildError(RuntimeError):
    """The host library could not be built or loaded while native.enabled
    is on."""


def enabled() -> bool:
    from ..config import config

    return bool(config().get("native.enabled", True))


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libarroyo_host_{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _file_lock(path: Path):
    with open(path, "a+b") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(out: Path) -> str:
    """Compile SOURCE into ``out`` (under the caller's file lock); returns
    the compiler's log."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError(f"no C++ compiler (g++ or $CXX) to build {SOURCE}")
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return log


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None while native.enabled
    is off. Raises NativeBuildError when it cannot be built or loaded."""
    global _lib
    if not enabled():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = library_path()
        log = ""
        cached = out.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with _file_lock(BUILD_DIR / "libarroyo_host.lock"):
                cached = out.exists()  # another process built it meanwhile
                if not cached:
                    log = _build(out)
        try:
            l = ctypes.CDLL(str(out))
            _declare(l)
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {out}: {e}") from e
        build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                          cached=cached, log=log)
        _lib = l
        return _lib


def _declare(l: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    l.ah_hash_u64.argtypes = [u64p, u64p, ctypes.c_int64]
    l.ah_hash_combine.argtypes = [u64p, u64p, ctypes.c_int64]
    l.ah_hash_f64.argtypes = [f64p, u64p, ctypes.c_int64]
    l.ah_partition.argtypes = [u64p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
    l.ah_partition.restype = ctypes.c_int
    l.ah_dir_resolve.argtypes = [
        i64p, i64p, ctypes.c_int64,          # keys, bins, n
        u64p, i64p, i64p,                    # hcode, hbin, hslot
        ctypes.c_int64, ctypes.c_int64,      # hcap, boundary
        i64p, i64p,                          # slot_keys, slot_bins
        i64p, i64p,                          # out_slots, miss_ord
        u64p, i64p, i64p,                    # miss_codes, miss_keys, miss_bins
    ]
    l.ah_dir_resolve.restype = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    l.ah_parse_json_lines.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(i64p), ctypes.POINTER(f64p), ctypes.POINTER(u8p),
        ctypes.POINTER(i64p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    l.ah_parse_json_lines.restype = ctypes.c_int64
    l.ah_free.argtypes = [ctypes.c_void_p]
    l.dp_listen.argtypes = [ctypes.c_char_p, ctypes.c_int]
    l.dp_listen.restype = ctypes.c_int
    l.dp_bound_port.argtypes = [ctypes.c_int]
    l.dp_bound_port.restype = ctypes.c_int
    l.dp_accept.argtypes = [ctypes.c_int]
    l.dp_accept.restype = ctypes.c_int
    l.dp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    l.dp_connect.restype = ctypes.c_int
    l.dp_send_frame.argtypes = [
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
    ]
    l.dp_send_frame.restype = ctypes.c_int
    l.dp_recv_header.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
    l.dp_recv_header.restype = ctypes.c_int
    l.dp_recv_payload.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
    l.dp_recv_payload.restype = ctypes.c_int
    l.dp_close.argtypes = [ctypes.c_int]


def available() -> bool:
    return lib() is not None


# --------------------------------------------------------------- hashing


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def hash_u64(arr: np.ndarray) -> Optional[np.ndarray]:
    """splitmix64 of each uint64."""
    l = lib()
    if l is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    out = np.empty(len(arr), dtype=np.uint64)
    l.ah_hash_u64(_u64p(arr), _u64p(out), len(arr))
    return out


def hash_f64(arr: np.ndarray) -> Optional[np.ndarray]:
    """splitmix64 of each float64's bits, -0.0 taken as 0.0."""
    l = lib()
    if l is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    out = np.empty(len(arr), dtype=np.uint64)
    l.ah_hash_f64(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _u64p(out), len(arr))
    return out


def hash_combine(h: np.ndarray, h2: np.ndarray) -> Optional[np.ndarray]:
    """splitmix64(h ^ (h2 + C1)), row by row (a new array)."""
    l = lib()
    if l is None:
        return None
    h = np.ascontiguousarray(h, dtype=np.uint64).copy()
    h2 = np.ascontiguousarray(h2, dtype=np.uint64)
    l.ah_hash_combine(_u64p(h), _u64p(h2), len(h))
    return h


def partition(hashes: np.ndarray, n_dest: int):
    """(perm, offsets): row indices grouped stably by owning subtask
    (``hashing.servers_for_hashes``), destination d's rows at
    perm[offsets[d]:offsets[d + 1]]; one counting-sort pass."""
    l = lib()
    if l is None:
        return None
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    perm = np.empty(len(hashes), dtype=np.int64)
    offsets = np.empty(n_dest + 1, dtype=np.int64)
    rc = l.ah_partition(_u64p(hashes), len(hashes), n_dest, _i64p(perm), _i64p(offsets))
    if rc != 0:
        raise RuntimeError(f"ah_partition failed ({rc}) for {n_dest} destinations")
    return perm, offsets


def dir_resolve(keys: np.ndarray, bins: np.ndarray, hcode: np.ndarray,
                hbin: np.ndarray, hslot: np.ndarray, boundary: int,
                slot_keys: np.ndarray, slot_bins: np.ndarray):
    """One pass of (key, bin) -> slot over the slot directory's open-
    addressing arrays (ops/slot_agg.py BinSlotDirectory). Returns (slots,
    miss_ord, miss_codes, miss_keys, miss_bins): slots is -1 for a group
    that owns no slot yet, and such groups are deduplicated in row order
    (first seen first) into the miss arrays, miss_ord[i] naming row i's
    entry. None when the flag is off or a probe wrapped the directory.
    Raises on a 64-bit code collision, as lookup_or_assign does."""
    l = lib()
    if l is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    bins = np.ascontiguousarray(bins, dtype=np.int64)
    n = len(keys)
    out_slots = np.empty(n, dtype=np.int64)
    miss_ord = np.empty(n, dtype=np.int64)
    miss_codes = np.empty(n, dtype=np.uint64)
    miss_keys = np.empty(n, dtype=np.int64)
    miss_bins = np.empty(n, dtype=np.int64)
    rc = l.ah_dir_resolve(
        _i64p(keys), _i64p(bins), n,
        _u64p(hcode), _i64p(hbin), _i64p(hslot),
        len(hcode), boundary,
        _i64p(slot_keys), _i64p(slot_bins),
        _i64p(out_slots), _i64p(miss_ord),
        _u64p(miss_codes), _i64p(miss_keys), _i64p(miss_bins),
    )
    if rc == -2:
        raise RuntimeError("64-bit (bin,key) code collision in slot directory")
    if rc == -4:
        raise MemoryError(f"ah_dir_resolve could not allocate its dedup table for {n} rows")
    if rc < 0:
        return None
    m = int(rc)
    return out_slots, miss_ord, miss_codes[:m], miss_keys[:m], miss_bins[:m]


# -------------------------------------------------------------- JSON lines

_KIND = {"int64": 0, "timestamp": 0, "int32": 0, "uint64": 0,
         "float64": 1, "float32": 1, "bool": 2, "string": 3}


def parse_json_lines(data: bytes, fields: list[tuple[str, str]],
                     max_rows: int) -> Optional[dict[str, np.ndarray]]:
    """Newline-delimited flat JSON objects -> columns; ``fields`` are
    (name, dtype) with batch.Schema's dtypes. None when the flag is off, a
    schema has more than 64 columns, or the input is malformed."""
    l = lib()
    if l is None:
        return None
    n_cols = len(fields)
    if n_cols > 64:
        return None
    kinds = np.array([_KIND.get(d, 4) for _n, d in fields], dtype=np.int32)
    names_blob = b"".join(n.encode() + b"\x00" for n, _d in fields)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = {0: (i64p * n_cols)(), 1: (f64p * n_cols)(), 2: (u8p * n_cols)(),
            3: (i64p * n_cols)()}
    # kind -> (numpy dtype, rows allocated, pointer type)
    layout = {0: (np.int64, max_rows, i64p), 1: (np.float64, max_rows, f64p),
              2: (np.uint8, max_rows, u8p), 3: (np.int64, max_rows + 1, i64p)}
    arrays: dict[int, np.ndarray] = {}
    for c in range(n_cols):
        k = int(kinds[c])
        if k in layout:
            dt, rows, pt = layout[k]
            arrays[c] = np.zeros(rows, dtype=dt)
            ptrs[k][c] = arrays[c].ctypes.data_as(pt)
    arena = ctypes.c_char_p()
    arena_len = ctypes.c_int64()
    n = l.ah_parse_json_lines(
        data, len(data), n_cols, names_blob,
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_rows,
        ptrs[0], ptrs[1], ptrs[2], ptrs[3],
        ctypes.byref(arena), ctypes.byref(arena_len),
    )
    if n < 0:
        return None
    try:
        arena_bytes = ctypes.string_at(arena, arena_len.value) if arena_len.value else b""
    finally:
        if arena:
            l.ah_free(arena)
    from ..batch import Field

    out: dict[str, np.ndarray] = {}
    for c, (name, dtype) in enumerate(fields):
        k = int(kinds[c])
        if k in (0, 1):
            out[name] = arrays[c][:n].astype(Field(name, dtype).numpy_dtype(), copy=False)
        elif k == 2:
            out[name] = arrays[c][:n].astype(bool)
        elif k == 3:
            offs = arrays[c]
            col = np.empty(n, dtype=object)
            for i in range(n):
                col[i] = arena_bytes[offs[i]:offs[i + 1]].decode("utf-8")
            out[name] = col
    return out


# -------------------------------------------------------------- data plane


class DataPlaneError(RuntimeError):
    pass


MSG_DATA = 0
MSG_SIGNAL = 1


def _dp_lib() -> ctypes.CDLL:
    l = lib()
    if l is None:
        raise DataPlaneError("the data plane needs the native host library, and "
                             "native.enabled is off")
    return l


class DataPlaneListener:
    """Server half of a worker's data plane: one listening socket, one
    accepted connection per peer worker."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._l = _dp_lib()
        self.fd = self._l.dp_listen(host.encode(), port)
        if self.fd < 0:
            raise DataPlaneError(f"dp_listen failed: {self.fd}")
        self.port = self._l.dp_bound_port(self.fd)

    def accept(self) -> "DataPlaneConn":
        fd = self._l.dp_accept(self.fd)
        if fd < 0:
            raise DataPlaneError("dp_accept failed")
        return DataPlaneConn(fd)

    def close(self) -> None:
        self._l.dp_close(self.fd)


class DataPlaneConn:
    """One framed TCP link that carries every quad (edge, source subtask,
    destination node, destination subtask) between two workers."""

    def __init__(self, fd: int):
        self._l = _dp_lib()
        self.fd = fd
        # every sending task thread of this worker pair shares the link; a
        # frame's header and payload are two writes and must not interleave
        from ..obs.lockorder import make_lock

        self._send_lock = make_lock("DataPlaneConn._send_lock")

    @staticmethod
    def connect(host: str, port: int, retries: int = 10, backoff_ms: int = 50) -> "DataPlaneConn":
        fd = _dp_lib().dp_connect(host.encode(), port, retries, backoff_ms)
        if fd < 0:
            raise DataPlaneError(f"dp_connect failed: {fd}")
        return DataPlaneConn(fd)

    def send(self, quad: tuple[int, int, int, int], msg_type: int, payload: bytes) -> None:
        with self._send_lock:
            rc = self._l.dp_send_frame(self.fd, quad[0], quad[1], quad[2], quad[3],
                                       msg_type, payload, len(payload))
        if rc != 0:
            raise DataPlaneError("dp_send_frame failed (peer closed?)")

    def recv(self):
        """(quad, msg_type, payload bytes), or None on a clean close."""
        header = (ctypes.c_uint32 * 6)()
        rc = self._l.dp_recv_header(self.fd, header)
        if rc == -1:
            return None
        if rc != 0:
            raise DataPlaneError(f"dp_recv_header failed: {rc}")
        n = header[5]
        buf = ctypes.create_string_buffer(n) if n else None
        if n and self._l.dp_recv_payload(self.fd, buf, n) != 0:
            raise DataPlaneError("dp_recv_payload failed")
        quad = (header[0], header[1], header[2], header[3])
        return quad, header[4], (buf.raw[:n] if n else b"")

    def close(self) -> None:
        self._l.dp_close(self.fd)
