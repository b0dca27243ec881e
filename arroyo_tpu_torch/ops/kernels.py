"""The slot aggregator's kernels: wrappers, build, and plain versions.

Four hand-written CUDA kernels (csrc/slot_agg.cu, see its header for what
each replaces and what bounds it) update and read the aggregate state, one
``[cap]`` tensor per accumulator lane, in place:

- ``slot_scatter_combine`` (K1): rows combine into ``state[slot]``; float
  sums add each slot's rows in row order, as the reference does (K5's
  stable sort of the slots, then a walk of each slot's run: a long run by
  a whole block);
- ``slot_region_read_pack`` (K2): k regions of every lane, packed into one
  int64 and one float64 buffer, and, given the lanes' kinds, reset to each
  lane's identity in the same launch;
- ``slot_region_clear`` (K3): k regions reset to each lane's identity (the
  same kernel body as K2, in its clear mode);
- ``slot_gather`` (K7): k single slots of every lane, widened the same
  way into one packed buffer, the lane on the grid.

Each wrapper checks device, dtype, shape and contiguity, and raises on what
the kernel does not take. On a CUDA tensor it launches the kernel (building
the library with nvcc at first use) or raises; it takes the plain PyTorch
version (``*_plain``, beside it) only for tensors on the CPU. Each wrapper
counts its launches in ``<wrapper>.launches`` (K2's read-and-clear
launches apart, in ``slot_region_read_pack.clear_launches``); K7's library
counts its kernels (``gather_kernel_launches``).

Every ``csrc/<name>.cu`` builds the same way (``build_source``): for sm_90a
into ``arroyo_tpu_torch/build/``, named by a digest of the source, the
headers it includes with ``#include "..."`` and the flags, so an edit to
any of them rebuilds, and written under a temporary name first, so a
concurrent build never loads a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .aggregate import _identity
from .staging import aligned

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_LANES = 32  # csrc/slot_agg.cu MAX_LANES
MAX_BASES = 16  # csrc/slot_agg.cu MAX_BASES
REGION_LIMIT = 1 << 31  # K2 / K3 index a region's slots in 32 bits
_REGION_READ, _REGION_CLEAR = 1, 2  # csrc/slot_agg.cu REGION_READ, REGION_CLEAR
# K1's float sums: a slot's run of at least this many sorted rows is walked
# by a whole block (csrc/slot_agg.cu walk_long), a shorter one by one thread
LONG_RUN = 64

# lane dtypes (csrc/slot_agg.cu DT_*); uint64 carries a numeric group-by key
# as a max lane, as in the JAX package's window state
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
               torch.uint64: 4}
_KIND_CODE = {"sum": 0, "count": 0, "min": 1, "max": 2}
_NP = {torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
       torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
       torch.uint64: np.dtype(np.uint64)}
_BITS = {torch.int32: np.uint32, torch.int64: np.uint64,
         torch.float32: np.uint32, torch.float64: np.uint64, torch.uint64: np.uint64}
_I64_MIN = np.iinfo(np.int64).min

_libs: dict[str, ctypes.CDLL] = {}  # source name -> loaded library
_build_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_count_lock = threading.Lock()  # subtasks launch from their own threads
build_info: dict[str, dict] = {}  # source name -> path, seconds, cached, log


class KernelError(RuntimeError):
    """A kernel of the port failed on the card: nvcc missing or failing, or
    a launch error. Never caught to fall back: it fails the job."""


def _find_nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(source: Path) -> str:
    """Digest of a CUDA source, every header it includes with ``#include
    "..."`` (found beside the including file, recursively, each once) and
    the flags: what names its build."""
    h = hashlib.sha256()
    seen: set[Path] = set()
    todo = [source.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        text = f.read_bytes()
        h.update(f.name.encode() + b"\0" + text + b"\0")
        todo += [(f.parent / m.decode()).resolve() for m in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_source(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Compile csrc/<name>.cu with nvcc into build/lib<name>_<digest>.so
    (once per ``source_digest``), load it and let ``bind`` set its argument
    types. Each source has its own lock, so different sources build in
    parallel. Raises KernelError when nvcc is missing or the build fails."""
    with _locks_lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        source = _PKG / "csrc" / f"{name}.cu"
        digest = source_digest(source)
        out = BUILD_DIR / f"lib{name}_{digest}.so"
        t0 = time.perf_counter()
        log = ""
        cached = out.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".lib{name}_{digest}.{os.getpid()}.{threading.get_ident()}.so"
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        bind(lib)
        build_info[name] = dict(path=str(out), seconds=time.perf_counter() - t0,
                                cached=cached, log=log)
        _libs[name] = lib
        return lib


def _bind_slot_agg(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    llp = ctypes.POINTER(ctypes.c_longlong)
    ullp = ctypes.POINTER(ctypes.c_ulonglong)
    lib.arroyo_slot_scatter_combine.argtypes = [i, pp, pp, ip, ip, i, p, i, ll, ll, p, p, p, ll,
                                                ll, p]
    lib.arroyo_slot_add_chain.argtypes = [i, p, ll, i, p, p]
    uip = ctypes.POINTER(ctypes.c_uint)
    lib.arroyo_slot_region.argtypes = [i, pp, ip, ullp, i, llp, uip, i, i, ll, i, p, p, p]
    lib.arroyo_slot_region_grid.argtypes = [llp, i, ll, i, ip]
    lib.arroyo_slot_region_grid.restype = None
    lib.arroyo_slot_empty.argtypes = [i, i, i, i, i, p]
    lib.arroyo_slot_gather.argtypes = [i, pp, ip, i, p, i, ll, ll, p, ll, p]
    lib.arroyo_slot_gather_kernel_launches.argtypes = []
    lib.arroyo_slot_gather_kernel_launches.restype = ll
    for fn in (lib.arroyo_slot_scatter_combine, lib.arroyo_slot_region, lib.arroyo_slot_gather,
               lib.arroyo_slot_add_chain, lib.arroyo_slot_empty):
        fn.restype = ctypes.c_int


def build_library() -> ctypes.CDLL:
    """The slot aggregator's library (csrc/slot_agg.cu)."""
    return build_source("slot_agg", _bind_slot_agg)


def _counted(wrapper, attr: str = "launches") -> None:
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def launch_counts() -> dict[str, int]:
    return {**{f.__name__: f.launches for f in WRAPPERS},
            "slot_region_read_pack_clear": slot_region_read_pack.clear_launches}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0
    slot_region_read_pack.clear_launches = 0


# ------------------------------------------------------------- checks


def _check_state(state: Sequence[torch.Tensor]) -> torch.device:
    if not 1 <= len(state) <= MAX_LANES:
        raise ValueError(f"need 1..{MAX_LANES} state lanes, got {len(state)}")
    dev, cap = state[0].device, state[0].shape[0] if state[0].dim() == 1 else -1
    for a in state:
        if a.device != dev:
            raise ValueError(f"state lanes on different devices: {a.device} vs {dev}")
        if a.dim() != 1 or a.shape[0] != cap or not a.is_contiguous():
            raise ValueError("every state lane must be a contiguous 1-D tensor of the same length")
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"state lane dtype {a.dtype} not one of "
                            f"int32/int64/float32/float64/uint64")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_bases(bases, cap: int, R: int) -> list[int]:
    bl = [int(b) for b in bases]
    if not 1 <= len(bl) <= MAX_BASES:
        raise ValueError(f"need 1..{MAX_BASES} region bases, got {len(bl)}")
    if not 1 <= R < REGION_LIMIT:
        raise ValueError(f"region size {R} is not in [1, 2^31)")
    for b in bl:
        if b < 0 or b + R > cap:
            raise ValueError(f"region [{b}, {b + R}) outside the state [0, {cap})")
    return bl


def _check_slots(slots: torch.Tensor, dev: torch.device) -> None:
    if slots.device != dev or slots.dim() != 1 or not slots.is_contiguous():
        raise ValueError("slots must be a contiguous 1-D tensor on the state's device")
    if slots.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"slots dtype {slots.dtype} is not int32 or int64")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} at launch")


# ------------------------------------------------------------- K1


def bits(t: torch.Tensor) -> torch.Tensor:
    """A uint64 lane as its int64 bits (torch's scatters, gathers, fills
    and, on the card, indexing take no uint64); other lanes as they are."""
    return t.view(torch.int64) if t.dtype == torch.uint64 else t


def widen(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A lane's values widened to ``dt`` (int64 or float64) as K2 and K7
    widen them: a float32 subnormal becomes the zero of its sign, as XLA's
    astype(float64) gives it on the CPU and the TPU (IEEE conversion keeps
    it)."""
    if t.dtype == torch.float32:
        t = torch.where((t.view(torch.int32) & 0x7F800000) == 0, t * 0, t)
    return t.to(dt)


def ordered_add(kind: str, dtype: torch.dtype) -> bool:
    """A float sum lane: K1 adds its rows in row order, not by atomics."""
    return kind in ("sum", "count") and dtype.is_floating_point


def slot_scatter_combine(state: Sequence[torch.Tensor], kinds: Sequence[str],
                         slots: torch.Tensor, vals: Sequence[Optional[torch.Tensor]]) -> None:
    """Combine rows into the state in place: for lane l and row i with
    ``0 <= slots[i] < cap``, ``state[l][slots[i]] = op_l(state[l][slots[i]],
    vals[l][i])`` with op add (sum, count), min or max. Float sums add each
    slot's rows one after another in row order from the state value (the
    reference's order). ``vals[l]`` None is allowed for count lanes only
    and adds 1 (the hot path ships no values for them). Rows with a slot
    outside [0, cap) are dropped."""
    dev = _check_state(state)
    if len(kinds) != len(state) or len(vals) != len(state):
        raise ValueError("kinds, vals and state must have one entry per lane")
    _check_slots(slots, dev)
    n = slots.shape[0]
    for a, k, v in zip(state, kinds, vals):
        if k not in _KIND_CODE:
            raise ValueError(f"unsupported accumulator kind {k!r}")
        if v is None:
            if k != "count":
                raise ValueError(f"lane of kind {k!r} needs values")
            continue
        if (v.device != dev or v.dtype != a.dtype or v.dim() != 1
                or v.shape[0] != n or not v.is_contiguous()):
            raise ValueError("each value lane must be a contiguous 1-D tensor of the "
                             "lane's dtype, on its device, one value per slot")
    if dev.type == "cpu":
        slot_scatter_combine_plain(state, kinds, slots, vals)
        return
    if n == 0:
        return
    sorted_slots = order = runs = None
    if any(ordered_add(k, a.dtype) for a, k in zip(state, kinds)):
        # float sums walk each slot's rows in row order: K5 sorts the slots
        # stably, in range mode (every slot outside [0, cap) sorts last)
        from .join_kernels import INT32_LIMIT, sort_pairs_launch

        if n > INT32_LIMIT:
            raise ValueError(f"{n} rows: K1's float sums index rows in int32")
        cap = state[0].shape[0]
        sorted_slots, order = sort_pairs_launch(
            slots, range_cap=cap if 0 < cap <= INT32_LIMIT else None)
        runs = torch.empty(1 + 2 * (n // LONG_RUN + 1), dtype=torch.int64, device=dev)
    lib = build_library()
    dts = (ctypes.c_int * len(state))(*[_DTYPE_CODE[a.dtype] for a in state])
    kc = (ctypes.c_int * len(state))(*[_KIND_CODE[k] for k in kinds])
    vp = (ctypes.c_void_p * len(state))(*[None if v is None else v.data_ptr() for v in vals])
    err = lib.arroyo_slot_scatter_combine(
        dev.index or 0, _ptrs(state), vp, kc, dts, len(state), slots.data_ptr(),
        int(slots.dtype == torch.int64), n, state[0].shape[0],
        None if order is None else sorted_slots.data_ptr(),
        None if order is None else order.data_ptr(),
        None if runs is None else runs.data_ptr(), n // LONG_RUN + 1, LONG_RUN, _stream(dev))
    _raise_on(err, "slot_scatter_combine")
    _counted(slot_scatter_combine)


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    """Float bits (viewed as signed integers) mapped so that integer order
    is float order with -0.0 below +0.0; the map is its own inverse."""
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def slot_scatter_combine_plain(state, kinds, slots, vals) -> None:
    """Plain PyTorch version of K1 (same semantics, any device). Float sums
    go through the CPU's ``index_add_``, which adds row after row in order
    (on the card the plain version copies such a lane to the host and
    back: a CUDA ``index_add_`` adds with atomics in no fixed order)."""
    cap = state[0].shape[0]
    keep = (slots >= 0) & (slots < cap)
    s = slots[keep].long()
    for a, kind, v in zip(state, kinds, vals):
        # uint64 values as their int64 bits: torch indexes no uint64 on the card
        v = torch.ones(len(s), dtype=bits(a).dtype, device=a.device) if v is None else bits(v)[keep]
        if ordered_add(kind, a.dtype):
            host = a.cpu()
            host.index_add_(0, s.cpu(), v.cpu())
            a.copy_(host)
        elif kind in ("sum", "count"):
            bits(a).index_add_(0, s, bits(v))
        elif a.dtype == torch.uint64:
            # unsigned order is the signed order of the bits with the top bit flipped
            flip = bits(a) ^ _I64_MIN
            flip.scatter_reduce_(0, s, bits(v) ^ _I64_MIN, "amin" if kind == "min" else "amax",
                                 include_self=True)
            bits(a).copy_(flip ^ _I64_MIN)
        elif not a.dtype.is_floating_point:
            a.scatter_reduce_(0, s, v, "amin" if kind == "min" else "amax", include_self=True)
        else:
            # NaN propagates and -0.0 orders below +0.0, independent of the
            # order of the rows (XLA's scatter-min/max semantics)
            ity = torch.int64 if a.dtype == torch.float64 else torch.int32
            u, inv = torch.unique(s, return_inverse=True)
            cur = a[u]
            nan_v = torch.isnan(v)
            key = _ordered(cur.view(ity))
            key.scatter_reduce_(0, inv[~nan_v], _ordered(v[~nan_v].view(ity)),
                                "amin" if kind == "min" else "amax", include_self=True)
            out = _ordered(key).view(a.dtype)
            nan = torch.isnan(cur)
            nan[inv[nan_v]] = True
            out[nan] = float("nan")
            a[u] = out


# ------------------------------------------------------------- K2, K3


@functools.lru_cache(maxsize=256)
def _lane_table(dtypes: tuple, kinds: Optional[tuple]):
    """What K2 / K3 take for one layout of lanes, made once per layout
    (an aggregator's close does not rebuild it): the dtype codes, and with
    kinds each lane's identity bits (else None). The C side only reads
    the shared arrays."""
    if kinds is not None and (len(kinds) != len(dtypes) or any(k not in _KIND_CODE for k in kinds)):
        raise ValueError(f"kinds {list(kinds)!r} do not name one sum/count/min/max per lane")
    dts = (ctypes.c_int * len(dtypes))(*[_DTYPE_CODE[d] for d in dtypes])
    if kinds is None:
        return dts, None
    ids = (ctypes.c_ulonglong * len(dtypes))(*[
        int(_identity(kd, _NP[d]).view(_BITS[d])) for d, kd in zip(dtypes, kinds)])
    return dts, ids


def _distinct(bases: list[int]) -> tuple[list[int], list[int]]:
    """The distinct bases in first-seen order, and for each the mask of the
    positions j that name it (bit j)."""
    first: dict[int, int] = {}
    masks: list[int] = []
    for j, b in enumerate(bases):
        d = first.setdefault(b, len(first))
        if d == len(masks):
            masks.append(0)
        masks[d] |= 1 << j
    return list(first), masks


def _check_apart(distinct: list[int], R: int) -> None:
    """Read-and-clear clears a word after its one read: distinct regions
    must not overlap."""
    ds = sorted(distinct)
    for lo, hi in zip(ds, ds[1:]):
        if hi < lo + R:
            raise ValueError(f"regions [{lo}, {lo + R}) and [{hi}, {hi + R}) overlap: "
                             f"a read-and-clear takes distinct bases at least R apart")


def _region_launch(state, dts, ids, distinct, masks, k, R, mode, ibuf, fbuf, dev) -> None:
    nd = len(distinct)
    err = build_library().arroyo_slot_region(
        dev.index or 0, _ptrs(state), dts, ids, len(state), (ctypes.c_longlong * nd)(*distinct),
        (ctypes.c_uint * nd)(*masks), nd, k, R, mode,
        None if ibuf is None else ctypes.c_void_p(ibuf.data_ptr()),
        None if fbuf is None else ctypes.c_void_p(fbuf.data_ptr()), _stream(dev))
    _raise_on(err, "slot_region_clear" if mode == _REGION_CLEAR else "slot_region_read_pack")


def slot_region_read_pack(state: Sequence[torch.Tensor], bases, R: int,
                          clear_kinds: Optional[Sequence[str]] = None):
    """For each base j and lane, ``state[lane][bases[j]:bases[j]+R]``:
    int lanes widened into one int64 buffer (uint64 as its bits), float
    lanes into one float64 buffer, each laid out [base][lane of its
    class][R] (the layout of arroyo_tpu's ``_pack``). Returns (ibuf, fbuf);
    a class with no lanes gives an empty buffer. Given ``clear_kinds`` (one
    per lane), every base's slots are then reset to the lane's identity, as
    ``make_read_multi(k, do_clear=True)`` reads every base and then clears
    every base; bases may repeat, but distinct ones must lie R apart."""
    dev = _check_state(state)
    bl = _check_bases(bases, state[0].shape[0], R)
    dts, ids = _lane_table(tuple(a.dtype for a in state),
                           None if clear_kinds is None else tuple(clear_kinds))
    distinct, masks = _distinct(bl)
    if clear_kinds is not None:
        _check_apart(distinct, R)
    if dev.type == "cpu":
        return slot_region_read_pack_plain(state, bl, R, clear_kinds)
    k = len(bl)
    n_flt = sum(1 for a in state if a.dtype.is_floating_point)
    ibuf = torch.empty(k * (len(state) - n_flt) * R, dtype=torch.int64, device=dev)
    fbuf = torch.empty(k * n_flt * R, dtype=torch.float64, device=dev)
    mode = _REGION_READ if clear_kinds is None else _REGION_READ | _REGION_CLEAR
    _region_launch(state, dts, ids, distinct, masks, k, R, mode, ibuf, fbuf, dev)
    _counted(slot_region_read_pack, "launches" if clear_kinds is None else "clear_launches")
    return ibuf, fbuf


def slot_region_read_pack_plain(state, bases, R: int, clear_kinds=None):
    """Plain PyTorch version of K2: every base read, then (given the
    kinds) every base cleared, as the reference's ``go``."""
    dev = state[0].device
    k = len(bases)
    idx = (torch.as_tensor(list(bases), dtype=torch.int64, device=dev)[:, None]
           + torch.arange(R, device=dev)).reshape(-1)

    def pack(lanes, dt):
        if not lanes:
            return torch.empty(0, dtype=dt, device=dev)
        return torch.stack([widen(bits(a)[idx], dt).view(k, R) for a in lanes], dim=1).reshape(-1)

    out = (pack([a for a in state if not a.dtype.is_floating_point], torch.int64),
           pack([a for a in state if a.dtype.is_floating_point], torch.float64))
    if clear_kinds is not None:
        slot_region_clear_plain(state, clear_kinds, bases, R)
    return out


def slot_region_clear(state: Sequence[torch.Tensor], kinds: Sequence[str], bases, R: int) -> None:
    """Reset ``state[lane][b:b+R]`` to each lane's identity (0 for sum and
    count, the dtype's top for min and its bottom for max) for every base."""
    dev = _check_state(state)
    bl = _check_bases(bases, state[0].shape[0], R)
    dts, ids = _lane_table(tuple(a.dtype for a in state), tuple(kinds))
    if dev.type == "cpu":
        slot_region_clear_plain(state, kinds, bl, R)
        return
    distinct, _masks = _distinct(bl)
    _region_launch(state, dts, ids, distinct, [0] * len(distinct), 0, R, _REGION_CLEAR, None,
                   None, dev)
    _counted(slot_region_clear)


def slot_region_clear_plain(state, kinds, bases, R: int) -> None:
    """Plain PyTorch version of K3."""
    for a, kd in zip(state, kinds):
        ident = _identity(kd, _NP[a.dtype])
        ident = int(ident.view(np.int64)) if a.dtype == torch.uint64 else ident.item()
        for b in bases:
            bits(a)[b:b + R] = ident


def region_grid(bases, R: int, n_lanes: int) -> tuple[int, int, int, int]:
    """K2 / K3's grid for these bases and lanes, as the library sizes it:
    blocks along x, along y (the distinct bases) and along z (the lanes),
    threads a block."""
    distinct, _masks = _distinct([int(b) for b in bases])
    out = (ctypes.c_int * 4)()
    build_library().arroyo_slot_region_grid((ctypes.c_longlong * len(distinct))(*distinct),
                                            len(distinct), R, n_lanes, out)
    return tuple(out)


# ------------------------------------------------------------- K7


@functools.lru_cache(maxsize=256)
def _gather_table(dtypes: tuple):
    """K7's lane table for one layout of lanes, made once per layout: the
    dtype codes, and how many lanes widen to int64 and to float64."""
    n_flt = sum(1 for d in dtypes if d.is_floating_point)
    return _lane_table(dtypes, None)[0], len(dtypes) - n_flt, n_flt


def slot_gather(state: Sequence[torch.Tensor], slots: torch.Tensor, packed: bool = False):
    """For each of the k slots and every lane, ``state[lane][slots[i]]``:
    int lanes widened into int64 words, float lanes into float64 words (a
    float32 subnormal to the zero of its sign, as ``widen``), each class
    laid out [lane of its class][k]. A slot outside [0, cap) reads 0.
    Returns (ibuf, fbuf), views of one packed uint8 buffer: the int part
    from byte 0, the float part from the next 16-byte boundary; a class
    with no lanes gives an empty view. With ``packed``, returns (ibuf,
    fbuf, buffer), so that the buffer crosses to the host in one copy.
    Launches one kernel on the current stream, after every K1 launched
    there."""
    dev = _check_state(state)
    _check_slots(slots, dev)
    k = slots.shape[0]
    dts, n_int, n_flt = _gather_table(tuple(a.dtype for a in state))
    nbytes, (_i, f_off) = aligned([n_int * k * 8, n_flt * k * 8])
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ibuf = buf[:n_int * k * 8].view(torch.int64)
    fbuf = buf[f_off: f_off + n_flt * k * 8].view(torch.float64)
    out = (ibuf, fbuf, buf) if packed else (ibuf, fbuf)
    if dev.type == "cpu":
        pib, pfb = slot_gather_plain(state, slots)
        ibuf.copy_(pib)
        fbuf.copy_(pfb)
        return out
    if k == 0:
        return out
    err = build_library().arroyo_slot_gather(
        dev.index or 0, _ptrs(state), dts, len(state), ctypes.c_void_p(slots.data_ptr()),
        int(slots.dtype == torch.int64), k, state[0].shape[0],
        ctypes.c_void_p(buf.data_ptr()), f_off, _stream(dev))
    _raise_on(err, "slot_gather")
    _counted(slot_gather)
    return out


def gather_kernel_launches() -> int:
    """Kernels K7 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches."""
    return build_library().arroyo_slot_gather_kernel_launches()


def slot_gather_plain(state, slots):
    """Plain PyTorch version of K7: index each lane, then widen."""
    dev = state[0].device
    s = slots.long()
    ok = (s >= 0) & (s < state[0].shape[0])
    s = torch.where(ok, s, torch.zeros_like(s))

    def pack(lanes, dt):
        if not lanes:
            return torch.empty(0, dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        return torch.stack([torch.where(ok, widen(bits(a)[s], dt), zero) for a in lanes]).reshape(-1)

    return (pack([a for a in state if not a.dtype.is_floating_point], torch.int64),
            pack([a for a in state if a.dtype.is_floating_point], torch.float64))


WRAPPERS = (slot_scatter_combine, slot_region_read_pack, slot_region_clear, slot_gather)
reset_launch_counts()
