"""The single-device hash table's kernels (B9): wrappers, build, and plain
versions.

``arroyo_tpu/ops/aggregate.py`` ``_build_jax`` compiles six programs over
one open-addressing table ``(keys int64, bins int32, occ bool, accs,
oflow int32)``. The port runs them as:

- ``step``: K8 ``agg_sort_reduce`` then K9 ``agg_probe_merge``
  (csrc/sharded_agg.cu) at one shard, K9 adding its unplaced partials to
  ``oflow`` on the device (no host sync per batch);
- ``extract`` / ``extract_packed`` / ``scan_packed``: K11 ``shard_extract``
  at one shard with ``zero_tail`` (the reference's cumsum scatter leaves
  zeros past the emitted rows) and ``oflow`` in its one packed buffer; a
  scan frees nothing (``free_below`` INT32_MIN). The packed buffer is the
  port's transport for every lane set: it is a byte layout, so float lanes
  need no bitcast (the reference's ``_packed_ok`` split works around TPU
  x64 emulation);
- ``scan`` and the host's loop over it (``scan_range`` :752-762, one chunk
  of emit_cap slots at a time): K12 (csrc/hash_agg.cu) in two modes.
  ``hash_scan_walk`` takes the whole loop in one launch: every valid slot
  of the table in slot order, compacted, with their count
  (csrc/table_compact.cuh); ``scan_range`` sizes it from the packed scan's
  total. ``hash_scan_chunk`` is ``scan`` itself, one chunk with its flags;
- ``free``: K13 ``hash_free`` (csrc/hash_agg.cu), in place, a thread a
  16-byte word of occupancy (``free_below`` takes the two arrays alone,
  of any length and alignment).

``KERNELS`` and ``PLAIN`` name the functions the programs call, the
kernels' wrappers and their plain PyTorch versions. A wrapper checks its
inputs; on a CUDA tensor it launches its kernel (building the library with
nvcc at first use, ``kernels.build_source``) or raises, and it takes the
plain version only for tensors on the CPU. K12's two modes and K13 count
their launches in ``<wrapper>.launches`` (K8, K9 and K11 in sharded_kernels);
K13's library counts its kernels (``free_kernel_launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import kernels
from . import sharded_kernels as sk

MAX_LANES = 32  # csrc/hash_agg.cu MAX_LANES
I32_MIN = np.iinfo(np.int32).min


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.arroyo_hash_scan_chunk.argtypes = [i, ll, p, p, p, i, pp, pp, ip, i, i, ll, ll,
                                           p, p, p, p]
    lib.arroyo_hash_scan_walk.argtypes = [i, ll, p, p, p, i, pp, pp, ip, i, i, ll, p, p, p, p, p]
    lib.arroyo_hash_scan_walk_scratch_bytes.argtypes = [ll]
    lib.arroyo_hash_scan_walk_scratch_bytes.restype = ll
    lib.arroyo_hash_free.argtypes = [i, ll, p, p, i, p]
    lib.arroyo_hash_free_kernel_launches.argtypes = []
    lib.arroyo_hash_free_kernel_launches.restype = ll
    for fn in (lib.arroyo_hash_scan_chunk, lib.arroyo_hash_scan_walk, lib.arroyo_hash_free):
        fn.restype = ctypes.c_int


def build_library() -> ctypes.CDLL:
    """The single-device table's library (csrc/hash_agg.cu)."""
    return kernels.build_source("hash_agg", _bind)


def _check_table(table) -> tuple[torch.device, int]:
    """A ``(keys, bins, occ, accs)`` table of ``[cap]`` tensors."""
    keys_t, bins_t, occ_t, accs_t = table
    dev = keys_t.device
    for t, what, dts in ((keys_t, "keys", (torch.int64,)), (bins_t, "bins", (torch.int32,)),
                         (occ_t, "occ", (torch.bool,))):
        if t.dtype not in dts or t.dim() != 1 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"table {what} must be a contiguous 1-D {dts[0]} tensor on {dev}")
    cap = keys_t.shape[0]
    if bins_t.shape[0] != cap or occ_t.shape[0] != cap:
        raise ValueError("table keys, bins and occ differ in length")
    if len(accs_t) > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes")
    for a in accs_t:
        if (a.dtype not in sk._DTYPE_CODE or a.shape != (cap,) or not a.is_contiguous()
                or a.device != dev):
            raise ValueError(f"each table lane must be a contiguous [{cap}] tensor of a lane "
                             f"dtype on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"table capacity {cap} is not a power of two")
    return dev, cap


# ------------------------------------------------------------- K12


def hash_scan_chunk(table, emit_lo: int, emit_hi: int, chunk_start: int,
                    emit_cap: int) -> sk.Extracted:
    """The ``emit_cap`` slots from ``chunk_start``, read without freeing
    (``scan``): key, bin, valid and each lane, in one packed buffer laid
    out as K11's at one shard (``total`` unused, 0). A row is valid when
    its slot lies in the table, is occupied and its bin is in
    [emit_lo, emit_hi); a position past the table reads its last slot."""
    dev, cap = _check_table(table)
    if emit_cap < 1 or chunk_start < 0:
        raise ValueError(f"emit_cap {emit_cap} < 1 or chunk_start {chunk_start} < 0")
    if dev.type == "cpu":
        return hash_scan_chunk_plain(table, emit_lo, emit_hi, chunk_start, emit_cap)
    keys_t, bins_t, occ_t, accs_t = table
    out = sk._extract_out(1, emit_cap, [a.dtype for a in accs_t], dev)
    out.total.zero_()
    n = len(accs_t)
    wide = (ctypes.c_int * max(n, 1))(*[a.element_size() == 8 for a in accs_t])
    err = build_library().arroyo_hash_scan_chunk(
        sk._dev_index(dev), cap, keys_t.data_ptr(), bins_t.data_ptr(), occ_t.data_ptr(), n,
        kernels._ptrs(accs_t), kernels._ptrs(out.accs), wide, int(emit_lo), int(emit_hi),
        int(chunk_start), int(emit_cap), out.key.data_ptr(), out.bin.data_ptr(),
        out.valid.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "hash_scan_chunk")
    kernels._counted(hash_scan_chunk)
    return out


def hash_scan_chunk_plain(table, emit_lo, emit_hi, chunk_start, emit_cap) -> sk.Extracted:
    """Plain PyTorch version of K12 (``scan``: a clamped gather)."""
    keys_t, bins_t, occ_t, accs_t = table
    cap = keys_t.shape[0]
    out = sk._extract_out(1, emit_cap, [a.dtype for a in accs_t], keys_t.device)
    out.total.zero_()
    sel = chunk_start + torch.arange(emit_cap, device=keys_t.device)
    idx = sel.clamp(max=cap - 1)
    b = bins_t[idx]
    out.key[0] = keys_t[idx]
    out.bin[0] = b
    out.valid[0] = (sel < cap) & occ_t[idx] & (b >= emit_lo) & (b < emit_hi)
    for a, o in zip(accs_t, out.accs):
        sk.bits(o)[0] = sk.bits(a)[idx]
    return out


class Walked(NamedTuple):
    """hash_scan_walk's outputs, views of one packed byte buffer: the valid
    slots the kernel found (int64 ``[1]``), and the first ``E`` of their
    rows: key int64, bin int32 and one array per lane, each ``[E]``."""

    packed: torch.Tensor
    count: torch.Tensor
    key: torch.Tensor
    bin: torch.Tensor
    accs: list


def walk_layout(E: int, dtypes) -> tuple[int, list]:
    """(bytes, [(offset, dtype, shape)]) of the packed walk buffer, in the
    order count, key, bin, lanes...; every part 8-byte aligned."""
    parts = [(np.dtype(np.int64), (1,)), (np.dtype(np.int64), (E,)), (np.dtype(np.int32), (E,))]
    parts += [(sk._NP[dt] if isinstance(dt, torch.dtype) else np.dtype(dt), (E,)) for dt in dtypes]
    out, off = [], 0
    for dt, shp in parts:
        out.append((off, dt, shp))
        off += -(-shp[0] * dt.itemsize // 8) * 8
    return off, out


def _walk_out(E: int, dtypes, dev) -> Walked:
    nbytes, layout = walk_layout(E, dtypes)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    v = sk._carve(packed, layout)
    return Walked(packed, v[0], v[1], v[2], v[3:])


def unpack_walk(host: np.ndarray, E: int, dtypes):
    """The host copy of a packed walk buffer of ``E`` rows: (key int64,
    bin, accs) numpy arrays. Raises when the kernel found another number of
    valid slots than the ``E`` it was sized for (the table changed between
    the packed scan and the walk)."""
    _n, layout = walk_layout(E, dtypes)
    parts = [host[off: off + int(np.prod(shp)) * dt.itemsize].view(dt).reshape(shp)
             for off, dt, shp in layout]
    if int(parts[0][0]) != E:
        raise RuntimeError(f"hash_scan_walk found {int(parts[0][0])} valid slots where the "
                           f"packed scan counted {E}")
    return parts[1], parts[2], parts[3:]


def hash_scan_walk(table, emit_lo: int, emit_hi: int, total: int) -> Walked:
    """The reference's walk over every chunk of the table (``scan`` at
    chunk_start 0, emit_cap, ... < cap, its valid rows concatenated), in one
    launch: every occupied slot with emit_lo <= bin < emit_hi, in slot
    order, whatever emit_cap is. ``total`` is the count the caller expects
    (the packed scan's header): the buffer holds that many rows and the
    kernel writes the count it found beside them; ``unpack_walk`` raises
    when the two differ."""
    dev, cap = _check_table(table)
    if total < 0:
        raise ValueError(f"total {total} < 0")
    if dev.type == "cpu":
        return hash_scan_walk_plain(table, emit_lo, emit_hi, total)
    keys_t, bins_t, occ_t, accs_t = table
    lib = build_library()
    out = _walk_out(total, [a.dtype for a in accs_t], dev)
    scratch = sk.compaction_scratch(("hash_scan_walk", cap), dev,
                                    lambda: lib.arroyo_hash_scan_walk_scratch_bytes(cap))
    n = len(accs_t)
    wide = (ctypes.c_int * max(n, 1))(*[a.element_size() == 8 for a in accs_t])
    err = lib.arroyo_hash_scan_walk(
        sk._dev_index(dev), cap, keys_t.data_ptr(), bins_t.data_ptr(), occ_t.data_ptr(), n,
        kernels._ptrs(accs_t), kernels._ptrs(out.accs), wide, int(emit_lo), int(emit_hi),
        int(total), out.key.data_ptr(), out.bin.data_ptr(), out.count.data_ptr(),
        scratch.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "hash_scan_walk")
    kernels._counted(hash_scan_walk)
    return out


def hash_scan_walk_plain(table, emit_lo, emit_hi, total) -> Walked:
    """Plain PyTorch version of K12's walk (the valid slots' indices, then
    one index per array)."""
    keys_t, bins_t, occ_t, accs_t = table
    out = _walk_out(total, [a.dtype for a in accs_t], keys_t.device)
    sel = torch.nonzero(occ_t & (bins_t >= emit_lo) & (bins_t < emit_hi)).squeeze(1)
    out.count[0] = sel.numel()
    sel = sel[:total]
    n = sel.numel()
    out.key[:n] = keys_t[sel]
    out.bin[:n] = bins_t[sel]
    for a, o in zip(accs_t, out.accs):
        sk.bits(o)[:n] = sk.bits(a)[sel]
    return out


# ------------------------------------------------------------- K13


def hash_free(table, below: int) -> None:
    """Drop every entry with bin < below (``free``), in place."""
    _check_table(table)
    _keys, bins_t, occ_t, _accs = table
    free_below(bins_t, occ_t, below)


def free_below(bins: torch.Tensor, occ: torch.Tensor, below: int) -> None:
    """K13 on its two arrays alone: ``occ &= bins >= below`` in place, for
    int32 bins and bool occupancy of one length, any length and any
    alignment (``hash_free`` passes a table's; chip_smoke.py's edge cases
    odd lengths and offset views). Counted as ``hash_free``'s launches."""
    dev = bins.device
    if (bins.dtype != torch.int32 or occ.dtype != torch.bool or bins.dim() != 1
            or occ.shape != bins.shape or not bins.is_contiguous() or not occ.is_contiguous()
            or occ.device != dev):
        raise ValueError("free_below takes int32 bins and bool occ, contiguous 1-D tensors of "
                         "one length on one device")
    if dev.type == "cpu":
        free_below_plain(bins, occ, below)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if bins.shape[0] == 0:
        return
    err = build_library().arroyo_hash_free(sk._dev_index(dev), bins.shape[0], bins.data_ptr(),
                                           occ.data_ptr(), int(below), kernels._stream(dev))
    kernels._raise_on(err, "hash_free")
    kernels._counted(hash_free)


def free_kernel_launches() -> int:
    """Kernels K13 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches."""
    return build_library().arroyo_hash_free_kernel_launches()


def hash_free_plain(table, below: int) -> None:
    """Plain PyTorch version of K13."""
    _keys, bins_t, occ_t, _accs = table
    free_below_plain(bins_t, occ_t, below)


def free_below_plain(bins: torch.Tensor, occ: torch.Tensor, below: int) -> None:
    occ &= bins >= below


# ------------------------------------------------------------- B9's programs


class Ops(NamedTuple):
    """The functions B9's programs call: the kernels' wrappers or their
    plain versions."""

    sort_reduce: object
    probe_merge: object
    extract: object
    scan_chunk: object
    scan_walk: object
    free: object


KERNELS = Ops(sk.agg_sort_reduce, sk.agg_probe_merge, sk.shard_extract, hash_scan_chunk,
              hash_scan_walk, hash_free)
PLAIN = Ops(sk.agg_sort_reduce_plain, sk.agg_probe_merge_plain, sk.shard_extract_plain,
            hash_scan_chunk_plain, hash_scan_walk_plain, hash_free_plain)


def _rows(table):
    """The table's tensors viewed as one shard, ``[1, cap]``: the sharded
    kernels' layout (views, so their in-place writes land in the table)."""
    keys_t, bins_t, occ_t, accs_t = table
    return keys_t[None], bins_t[None], occ_t[None], [a[None] for a in accs_t]


def step(ops: Ops, kinds: Sequence[str], state, key: torch.Tensor, bins: torch.Tensor,
         n_valid: int, vals: Sequence[torch.Tensor], max_probes: int) -> None:
    """``step`` (aggregate.py :317-329) in place: the batch's first
    ``n_valid`` rows of ``[batch_cap]`` key, bin and value tensors reduce
    to unique (key, bin) partials (K8), which merge into the table (K9);
    partials no probe round placed add to ``oflow``."""
    keys_t, bins_t, occ_t, accs_t, oflow = state
    u = ops.sort_reduce(kinds, key[None], bins[None], None, [v[None] for v in vals], 0, n_valid)
    ops.probe_merge(kinds, _rows((keys_t, bins_t, occ_t, accs_t)), *u, max_probes, oflow)


def extract(ops: Ops, state, emit_lo: int, emit_hi: int, free_below: int,
            emit_cap: int) -> sk.Extracted:
    """``extract_packed`` (aggregate.py :392-422): the entries with
    emit_lo <= bin < emit_hi compacted in slot order into ``emit_cap`` rows
    (zeros past them), their total and ``oflow``, in one packed buffer;
    frees entries below ``free_below`` outside the range at once and inside
    it once emitted."""
    keys_t, bins_t, occ_t, accs_t, oflow = state
    return ops.extract(_rows((keys_t, bins_t, occ_t, accs_t)), emit_lo, emit_hi, free_below,
                       emit_cap, zero_tail=True, oflow=oflow)


def scan_packed(ops: Ops, state, emit_lo: int, emit_hi: int, emit_cap: int) -> sk.Extracted:
    """``scan_packed`` (aggregate.py :424-444): ``extract`` freeing nothing."""
    return extract(ops, state, emit_lo, emit_hi, I32_MIN, emit_cap)


WRAPPERS = (hash_scan_chunk, hash_scan_walk, hash_free)


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0


reset_launch_counts()
