"""The key-sharded aggregate's kernels: wrappers, build, and plain versions.

Four hand-written CUDA kernels (csrc/sharded_agg.cu, see its header for what
each replaces and what bounds it) run the device half of the sharded
aggregate, every array laid out ``[shard, ...]`` on one torch device:

- ``agg_sort_reduce`` (K8): per shard, unique (key, bin) partials of a
  padded batch (B7, ``sort_reduce``);
- ``agg_probe_merge`` (K9): partials merged into the open-addressing table
  in place (B8, ``probe_merge``), every round of a shard on one
  thread-block cluster; ``probe_merge_rounds`` reads back the rounds its
  last call ran per shard, the active partials at each and the cluster
  size, ``probe_merge_kernel_launches`` counts the library's launches;
- ``shard_exchange`` (K10): owner bucketing into the send buffers and the
  rows kept local (B10 ``exchange_merge`` steps 2-3) over the whole card
  (``exchange_kernel_launches``: two a call), and ``shard_spill`` (K10,
  step 7): rows the table could not place append to the spill buffer, in
  one launch of csrc/table_compact.cuh's compaction in its SPILL mode
  (``spill_kernel_launches``: one a call; its state buffer,
  ``spill_scratch``, belongs to the caller: ShardedAggregator keeps one per
  layout and stream);
- ``shard_extract`` (K11): the per-shard compaction of a close, with its
  frees (B10 ``local_extract``), into one packed buffer, in one launch of
  csrc/table_compact.cuh's compaction (``extract_kernel_launches`` counts
  the library's launches).

The single-device table (``hash_kernels``, B9) runs K8, K9 and K11 at one
shard: K9 then adds its unplaced partials to the table's overflow counter,
and K11 zero-fills the rows past the emitting ones and carries the counter
in its packed buffer.

Each wrapper checks device, dtype, shape and contiguity, and raises on what
the kernel does not take. On a CUDA tensor it launches the kernel (building
the library with nvcc at first use, ``kernels.build_source``) or raises; it
takes the plain PyTorch version (``*_plain``, beside it) only for tensors on
the CPU. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import kernels
from .aggregate import _identity, probe_merge, sort_reduce

MAX_LANES = 32  # csrc/sharded_agg.cu MAX_LANES
MAX_SHARDS = 32  # csrc/sharded_agg.cu MAX_SHARDS (shard_exchange)
EXCHANGE_TILE = 1024  # csrc/sharded_agg.cu EX_TILE: rows a tile of K10's exchange buckets
COMPACT_TILE = 4096  # csrc/table_compact.cuh TILE: slots a tile of the compaction reads
PROBE_GROUP = 16  # csrc/sharded_agg.cu PM_GROUP: K9's lists hold B rounded up to it
INT32_LIMIT = (1 << 31) - 1
_U64_MAX = (1 << 64) - 1

# lane dtypes: K1's four and uint64 (csrc/sharded_agg.cu DT_U64), which the
# JAX package's sharded store carries for numeric group-by key lanes
_DTYPE_CODE = {**kernels._DTYPE_CODE, torch.uint64: 4}
_KIND_CODE = kernels._KIND_CODE
_NP = {**kernels._NP, torch.uint64: np.dtype(np.uint64)}
_BITS = {**kernels._BITS, torch.uint64: np.uint64}


class _Lanes(ctypes.Structure):
    """csrc/sharded_agg.cu ``struct Lanes``, passed by pointer."""

    _fields_ = [("inp", ctypes.c_void_p * MAX_LANES), ("out", ctypes.c_void_p * MAX_LANES),
                ("aux", ctypes.c_void_p * MAX_LANES), ("ident", ctypes.c_ulonglong * MAX_LANES),
                ("kind", ctypes.c_int * MAX_LANES), ("dtype", ctypes.c_int * MAX_LANES),
                ("n", ctypes.c_int)]


def _lanes(kinds, dtypes, inp=(), out=(), aux=()) -> _Lanes:
    ln = _Lanes()
    ln.n = len(kinds)
    for j, (k, dt) in enumerate(zip(kinds, dtypes)):
        ln.kind[j] = _KIND_CODE[k]
        ln.dtype[j] = _DTYPE_CODE[dt]
        ln.ident[j] = int(_identity(k, _NP[dt]).view(_BITS[dt]))
        for arr, ts in ((ln.inp, inp), (ln.out, out), (ln.aux, aux)):
            if j < len(ts) and ts[j] is not None:
                arr[j] = ts[j].data_ptr()
    return ln


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lp = ctypes.POINTER(_Lanes)
    lib.arroyo_agg_sort_reduce.argtypes = [i, i, ll, p, p, i, ll, p, ll, lp, p, ll, p,
                                           p, p, p, p]
    lib.arroyo_agg_sort_reduce_scratch_bytes.argtypes = [i, ll]
    lib.arroyo_agg_sort_reduce_scratch_bytes.restype = ll
    lib.arroyo_agg_sort_reduce_kernel_launches.argtypes = []
    lib.arroyo_agg_sort_reduce_kernel_launches.restype = ll
    lib.arroyo_agg_sort_reduce_last.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.arroyo_agg_sort_reduce_last.restype = None
    lib.arroyo_agg_sort_reduce_hist_bytes.argtypes = [i, ll]
    lib.arroyo_agg_sort_reduce_hist_bytes.restype = ll
    lib.arroyo_agg_sort_reduce_shards.argtypes = [i, i, p, p]
    lib.arroyo_agg_sort_reduce_shards.restype = ctypes.c_int
    lib.arroyo_agg_probe_merge.argtypes = [i, i, ll, p, p, p, lp, ll, p, p, p, i,
                                           p, p, p, p, p, ctypes.c_uint, p]
    lib.arroyo_agg_probe_merge_kernel_launches.argtypes = []
    lib.arroyo_agg_probe_merge_kernel_launches.restype = ll
    lib.arroyo_agg_probe_merge_list_len.argtypes = [ll]
    lib.arroyo_agg_probe_merge_list_len.restype = ll
    lib.arroyo_agg_probe_merge_cluster.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.arroyo_agg_probe_merge_cluster.restype = None
    lib.arroyo_shard_exchange.argtypes = [i, i, ll, ll, p, p, p, lp, p, p, p, p, p, p, p, p]
    lib.arroyo_shard_exchange_counts_words.argtypes = [i, ll]
    lib.arroyo_shard_exchange_counts_words.restype = ll
    lib.arroyo_shard_exchange_kernel_launches.argtypes = []
    lib.arroyo_shard_exchange_kernel_launches.restype = ll
    lib.arroyo_shard_spill.argtypes = [i, i, ll, p, p, p, lp, ll, p, p, p, p, p, p]
    lib.arroyo_shard_spill_scratch_bytes.argtypes = [i, ll]
    lib.arroyo_shard_spill_scratch_bytes.restype = ll
    lib.arroyo_shard_spill_kernel_launches.argtypes = []
    lib.arroyo_shard_spill_kernel_launches.restype = ll
    lib.arroyo_agg_probe_merge_rounds.argtypes = [i, i, i, p, p]
    lib.arroyo_agg_probe_merge_rounds.restype = ctypes.c_int
    lib.arroyo_shard_extract.argtypes = [i, i, ll, p, p, p, lp, i, i, i, ll, p, p, p, p, p,
                                         i, p, p, p]
    lib.arroyo_shard_extract_scratch_bytes.argtypes = [i, ll, ll, i]
    lib.arroyo_shard_extract_scratch_bytes.restype = ll
    lib.arroyo_shard_extract_kernel_launches.argtypes = []
    lib.arroyo_shard_extract_kernel_launches.restype = ll
    for fn in (lib.arroyo_agg_sort_reduce, lib.arroyo_agg_probe_merge,
               lib.arroyo_shard_exchange, lib.arroyo_shard_spill, lib.arroyo_shard_extract):
        fn.restype = ctypes.c_int


def build_library() -> ctypes.CDLL:
    """The sharded aggregate's library (csrc/sharded_agg.cu)."""
    return kernels.build_source("sharded_agg", _bind)


# ------------------------------------------------------------- checks


def _check_2d(t: torch.Tensor, what: str, dtypes, shape=None, dev=None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} is not one of {sorted(map(str, dtypes))}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [shard, n] tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if dev is not None and t.device != dev:
        raise ValueError(f"{what} on {t.device}, expected {dev}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_lanes(kinds, lanes, shape, dev, what: str, allow_none: bool = False) -> None:
    if not 0 <= len(kinds) <= MAX_LANES or len(lanes) != len(kinds):
        raise ValueError(f"{what}: need one lane per kind (at most {MAX_LANES})")
    for k, a in zip(kinds, lanes):
        if k not in _KIND_CODE:
            raise ValueError(f"unsupported accumulator kind {k!r}")
        if a is None:
            if not allow_none or k != "count":
                raise ValueError(f"{what}: only count lanes may be None (ones)")
            continue
        _check_2d(a, f"{what} lane", tuple(_DTYPE_CODE), shape, dev)


def _dtypes(lanes) -> list[torch.dtype]:
    """Lane dtypes; a count lane of ones (None) is int64, as acc_plan makes it."""
    return [torch.int64 if a is None else a.dtype for a in lanes]


bits = kernels.bits  # a uint64 lane as its int64 bits


def ident_bits(kind: str, dtype: torch.dtype):
    """A lane's identity as a value of ``bits(lane)``'s dtype."""
    ident = _identity(kind, _NP[dtype])
    return int(ident.view(np.int64)) if dtype == torch.uint64 else ident.item()


def _dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


# ------------------------------------------------------------- K8


SORT_SHARDS = 256  # csrc/sharded_agg.cu SR_MAX_SHARDS: the shard is one digit
_LAST_FIELDS = ("launches", "onesweep", "passes", "skipped", "live", "max_live", "synced",
                "memsets", "wait_ns")


def agg_sort_reduce(kinds: Sequence[str], key: torch.Tensor, bins: torch.Tensor,
                    valid: Optional[torch.Tensor], vals: Sequence[Optional[torch.Tensor]],
                    bin_offset: int = 0, n_valid: Optional[int] = None):
    """Per shard of ``[S, L]`` rows, the unique (key, bin) partials (B7):
    returns (u_key int64, u_bin int32, active bool, u_accs), all ``[S, L]``.
    Row r of shard s is valid when ``valid[s, r]`` (None: every row) and its
    flat index ``s * L + r`` is below ``n_valid`` (None: no limit). Bins
    may be int32 or int64: ``bin_offset`` is subtracted before the int32
    cast (the fused mesh step's ``- base_bin``). A count lane of None adds
    ones. On the card the kernel sorts the valid rows alone; where the
    library asks for a pinned buffer (``arroyo_agg_sort_reduce_hist_bytes``:
    past one block's shard size) the call waits once on the stream for
    their digit counts."""
    if key.dim() == 2:  # the sizes first: a meta tensor of any size shows them
        S, L = key.shape
        if L < 1 or S * L > INT32_LIMIT:
            raise ValueError(f"{S} x {L} rows; the kernel indexes rows with int32")
        if S > SORT_SHARDS:
            raise ValueError(f"{S} shards; the kernel sorts at most {SORT_SHARDS}")
    _check_2d(key, "key", (torch.int64,))
    dev, shape = key.device, tuple(key.shape)
    _check_2d(bins, "bins", (torch.int32, torch.int64), shape, dev)
    if valid is not None:
        _check_2d(valid, "valid", (torch.bool,), shape, dev)
    _check_lanes(kinds, vals, shape, dev, "vals", allow_none=True)
    S, L = shape
    n_valid = S * L if n_valid is None else int(n_valid)
    if dev.type == "cpu":
        return agg_sort_reduce_plain(kinds, key, bins, valid, vals, bin_offset, n_valid)
    lib = build_library()
    scratch = torch.empty(lib.arroyo_agg_sort_reduce_scratch_bytes(S, L), dtype=torch.uint8,
                          device=dev)
    hist_bytes = lib.arroyo_agg_sort_reduce_hist_bytes(S, L)
    hist = (torch.empty(hist_bytes, dtype=torch.uint8, pin_memory=True) if hist_bytes
            else None)
    u_key = torch.empty(shape, dtype=torch.int64, device=dev)
    u_bin = torch.empty(shape, dtype=torch.int32, device=dev)
    active = torch.empty(shape, dtype=torch.bool, device=dev)
    dts = _dtypes(vals)
    u_accs = [torch.empty(shape, dtype=dt, device=dev) for dt in dts]
    ln = _lanes(kinds, dts, inp=vals, out=u_accs)
    err = lib.arroyo_agg_sort_reduce(
        _dev_index(dev), S, L, key.data_ptr(), bins.data_ptr(), int(bins.dtype == torch.int64),
        int(bin_offset), None if valid is None else valid.data_ptr(), n_valid, ctypes.byref(ln),
        scratch.data_ptr(), scratch.numel(), None if hist is None else hist.data_ptr(),
        u_key.data_ptr(), u_bin.data_ptr(), active.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "agg_sort_reduce")
    kernels._counted(agg_sort_reduce)
    return u_key, u_bin, active, u_accs


def sort_reduce_kernel_launches() -> int:
    """Kernels K8 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches."""
    return build_library().arroyo_agg_sort_reduce_kernel_launches()


def sort_reduce_last() -> dict:
    """What this thread's last K8 call on the card did: its kernel
    launches, whether it took the onesweep path (else one block per
    shard), the onesweep passes run and skipped, the live rows and the
    most in one shard (-1: not read back), whether it waited for them,
    the memsets it issued and the host's wait for the read-back in ns."""
    out = (ctypes.c_longlong * len(_LAST_FIELDS))()
    build_library().arroyo_agg_sort_reduce_last(out)
    return dict(zip(_LAST_FIELDS, out))


def sort_reduce_shards(S: int, dev: torch.device) -> dict:
    """The last K8 call on ``dev``, per shard of its first ``S`` as the
    kernels wrote it: ``live`` rows and ``block_passes``, the passes the
    shard's block ran (-1: the onesweep path sorted it). Waits for the
    device."""
    live, passes = (ctypes.c_int * S)(), (ctypes.c_int * S)()
    err = build_library().arroyo_agg_sort_reduce_shards(_dev_index(dev), S, live, passes)
    kernels._raise_on(err, "agg_sort_reduce_shards")
    return {"live": list(live), "block_passes": list(passes)}


def agg_sort_reduce_plain(kinds, key, bins, valid, vals, bin_offset=0, n_valid=None):
    """Plain PyTorch version of K8 (ops/aggregate.py ``sort_reduce``)."""
    S, L = key.shape
    dev = key.device
    b32 = (bins.to(torch.int64) - int(bin_offset)).to(torch.int32)
    ok = torch.arange(S * L, device=dev).view(S, L) < (S * L if n_valid is None else n_valid)
    if valid is not None:
        ok = ok & valid
    return sort_reduce(kinds, key, b32, ok, vals)


# ------------------------------------------------------------- K9


def _check_table(table, kinds):
    keys_t, bins_t, occ_t, accs_t = table
    _check_2d(keys_t, "table keys", (torch.int64,))
    dev, shape = keys_t.device, tuple(keys_t.shape)
    _check_2d(bins_t, "table bins", (torch.int32,), shape, dev)
    _check_2d(occ_t, "table occ", (torch.bool,), shape, dev)
    _check_lanes(kinds, accs_t, shape, dev, "table accs")
    cap = shape[1]
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"table capacity {cap} is not a power of two")
    return dev, shape


def probe_merge_scratch(S: int, B: int, cap: int) -> dict:
    """K9's scratch for ``[S, B]`` partials and ``[S, cap]`` tables, name ->
    (shape, dtype): each CTA's segment of the partials left, (index, slot)
    words in two buffers of B rounded up to PROBE_GROUP, a listed
    partial's class, and the tagged claims (uint64 bits, kept per layout
    and stream by ``_claims``)."""
    bp = -(-B // PROBE_GROUP) * PROBE_GROUP
    return {"list": ((S, 2, bp), torch.int64), "code": ((S, bp), torch.uint8),
            "claims": ((S, cap), torch.int64)}


_TAG_LIMIT = (1 << 32) - 1  # a claim's tag is its word's high 32 bits
_claims_lock = threading.Lock()
_claims_cache: dict = {}


def _claims(S: int, cap: int, dev: torch.device, rounds: int) -> tuple[torch.Tensor, int]:
    """K9's claims for one (S, cap) on ``dev``'s current stream and the
    first tag of a call of ``rounds`` rounds (called with ``_claims_lock``
    held across the launch, so the tags rise in launch order). The buffer
    is zeroed once and then never cleared: a call's claims outrank every
    earlier call's by their tags, until the 32-bit tags run out and it is
    zeroed again."""
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    key = (S, cap, dev.type, dev.index, stream)
    entry = _claims_cache.get(key)
    if entry is None:
        shape, dt = probe_merge_scratch(S, 1, cap)["claims"]
        entry = _claims_cache[key] = [torch.zeros(shape, dtype=dt, device=dev), 1]
    if entry[1] + rounds > _TAG_LIMIT:
        entry[0].zero_()
        entry[1] = 1
    tag0 = entry[1]
    entry[1] += rounds
    return entry[0], tag0


def agg_probe_merge(kinds: Sequence[str], table, u_key: torch.Tensor, u_bin: torch.Tensor,
                    active: torch.Tensor, u_accs: Sequence[torch.Tensor],
                    max_probes: int, oflow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge each shard's unique partials ``[S, B]`` into its table
    ``(keys, bins, occ, accs)`` ``[S, cap]`` in place (B8); returns the
    still-active mask ``[S, B]`` (partials no probe round placed). Given
    ``oflow`` (int32 ``[S]``), each shard's still-active count adds to it
    on the device. On the card one launch runs every round of a shard on a
    thread-block cluster. Any ``max_probes <= 0`` runs no round, as the
    reference's loop does."""
    if u_key.dim() == 2:  # the sizes first: a meta tensor of any size shows them
        B = u_key.shape[1]
        if B < 1 or B > INT32_LIMIT - PROBE_GROUP:
            raise ValueError(f"{B} partials per shard; the kernel indexes them with int32")
    # the reference's fori_loop(0, max_probes, ...) runs no round for any
    # max_probes <= 0: every active partial stays active
    max_probes = max(0, int(max_probes))
    if max_probes >= _TAG_LIMIT:
        raise ValueError(f"max_probes {max_probes} is not below {_TAG_LIMIT}")
    dev, tshape = _check_table(table, kinds)
    _check_2d(u_key, "u_key", (torch.int64,), None, dev)
    shape = tuple(u_key.shape)
    if shape[0] != tshape[0]:
        raise ValueError(f"{shape[0]} shards of partials for a table of {tshape[0]}")
    _check_2d(u_bin, "u_bin", (torch.int32,), shape, dev)
    _check_2d(active, "active", (torch.bool,), shape, dev)
    _check_lanes(kinds, u_accs, shape, dev, "u_accs")
    for a, t in zip(u_accs, table[3]):
        if a.dtype != t.dtype:
            raise TypeError(f"partial lane {a.dtype} for a table lane of {t.dtype}")
    S, B = shape
    if oflow is not None:
        _check_counter(oflow, S, dev, "overflow")
    if dev.type == "cpu":
        return agg_probe_merge_plain(kinds, table, u_key, u_bin, active, u_accs, max_probes,
                                     oflow)
    keys_t, bins_t, occ_t, accs_t = table
    cap = tshape[1]
    lib = build_library()
    still = torch.empty(shape, dtype=torch.bool, device=dev)
    spec = probe_merge_scratch(S, B, cap)
    lst = torch.empty(spec["list"][0], dtype=spec["list"][1], device=dev)
    code = torch.empty(spec["code"][0], dtype=spec["code"][1], device=dev)
    ln = _lanes(kinds, [a.dtype for a in accs_t], inp=u_accs, out=accs_t)
    with _claims_lock:
        claims, tag0 = _claims(S, cap, dev, max(1, max_probes))
        err = lib.arroyo_agg_probe_merge(
            _dev_index(dev), S, cap, keys_t.data_ptr(), bins_t.data_ptr(), occ_t.data_ptr(),
            ctypes.byref(ln), B, u_key.data_ptr(), u_bin.data_ptr(), active.data_ptr(),
            max_probes, still.data_ptr(), lst.data_ptr(), claims.data_ptr(),
            code.data_ptr(), None if oflow is None else oflow.data_ptr(), tag0,
            kernels._stream(dev))
    kernels._raise_on(err, "agg_probe_merge")
    kernels._counted(agg_probe_merge)
    return still


def probe_merge_kernel_launches() -> int:
    """Kernels K9 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches."""
    return build_library().arroyo_agg_probe_merge_kernel_launches()


def probe_merge_cluster() -> dict:
    """K9's cluster shape: the CTAs of a shard's cluster in the last call
    (0: none yet), and the clusters of 16 and of 8 CTAs the card holds at
    once, as cudaOccupancyMaxActiveClusters gave them at first use (-1:
    not asked yet; 0 for 16: that size was refused)."""
    out = (ctypes.c_int * 3)()
    build_library().arroyo_agg_probe_merge_cluster(out)
    return {"cluster": out[0], "max_active_clusters_16": out[1],
            "max_active_clusters_8": out[2]}


PROBE_REPORT_ROUNDS = 256  # csrc/sharded_agg.cu PM_REPORT_ROUNDS


def probe_merge_rounds(S: int, dev: torch.device, max_rounds: int = PROBE_REPORT_ROUNDS) -> dict:
    """The last K9 call on ``dev``, per shard of its first ``S`` (at most
    32), as the kernel wrote it: ``rounds`` run, and ``active[s][r]`` the
    partials still active at the start of round r, for every r up to the
    shard's rounds (at r = rounds: those no round placed), or the first
    ``max_rounds`` rounds' starts where it ran more, and the ``cluster``
    size it ran on (CTAs a shard). Waits for the device."""
    rounds = (ctypes.c_int * S)()
    active = (ctypes.c_int * (S * (max_rounds + 1)))()
    err = build_library().arroyo_agg_probe_merge_rounds(_dev_index(dev), S, max_rounds, rounds,
                                                         active)
    kernels._raise_on(err, "agg_probe_merge_rounds")
    per = max_rounds + 1
    return {"rounds": list(rounds), "cluster": probe_merge_cluster()["cluster"],
            "active": [list(active[s * per: s * per + (rounds[s] + 1 if rounds[s] <= max_rounds
                                                        else max_rounds)])
                       for s in range(S)]}


def agg_probe_merge_plain(kinds, table, u_key, u_bin, active, u_accs, max_probes, oflow=None):
    """Plain PyTorch version of K9 (ops/aggregate.py ``probe_merge``)."""
    still = probe_merge(kinds, table, u_key, u_bin, active, u_accs, max_probes)
    if oflow is not None:
        oflow += still.sum(dim=1).to(torch.int32)
    return still


def _check_counter(t: torch.Tensor, S: int, dev, what: str) -> None:
    if t.dtype != torch.int32 or t.shape != (S,) or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 [shard] tensor on {dev}")


# ------------------------------------------------------------- K10


def owner_of(key: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Owning shard of each int64 key (its uint64 bits): contiguous ranges
    ``U64_MAX // n_dev + 1`` wide, the last clamped (the JAX package's
    host ``servers_for_hashes``); unsigned compares through the sign flip."""
    if n_dev == 1:
        return torch.zeros_like(key)
    rng = _U64_MAX // n_dev + 1
    flip = key ^ torch.iinfo(torch.int64).min
    owner = torch.zeros_like(key)
    for k in range(1, n_dev):
        t = (k * rng) ^ (1 << 63)
        owner += (flip >= (t - (1 << 64) if t >= 1 << 63 else t)).to(torch.int64)
    return owner


class Exchange(NamedTuple):
    """shard_exchange's outputs: the send buffers ``[S, S * dest_cap]``
    (destination-major) and the merged rows ``[S, S * dest_cap + L]``,
    whose tail holds the shard's own partials in owner order (valid where
    kept local) and whose head ``all_to_all`` fills."""

    s_key: torch.Tensor
    s_bin: torch.Tensor
    s_valid: torch.Tensor
    s_accs: list
    m_key: torch.Tensor
    m_bin: torch.Tensor
    m_valid: torch.Tensor
    m_accs: list


def _exchange_out(S, L, dc, dtypes, dev) -> Exchange:
    recv, M = S * dc, S * dc + L
    return Exchange(
        torch.empty((S, recv), dtype=torch.int64, device=dev),
        torch.empty((S, recv), dtype=torch.int32, device=dev),
        torch.empty((S, recv), dtype=torch.bool, device=dev),
        [torch.empty((S, recv), dtype=dt, device=dev) for dt in dtypes],
        torch.empty((S, M), dtype=torch.int64, device=dev),
        torch.empty((S, M), dtype=torch.int32, device=dev),
        torch.empty((S, M), dtype=torch.bool, device=dev),
        [torch.empty((S, M), dtype=dt, device=dev) for dt in dtypes])


def exchange_scratch(S: int, L: int) -> dict:
    """K10's exchange scratch for ``[S, L]`` partials, name -> (shape,
    dtype): rows per (source shard, tile of EXCHANGE_TILE rows, owner or
    inactive), written by its first launch and read by its second."""
    return {"counts": ((S, -(-L // EXCHANGE_TILE), S + 1), torch.int32)}


def shard_exchange(kinds: Sequence[str], u_key: torch.Tensor, u_bin: torch.Tensor,
                   active: torch.Tensor, u_accs: Sequence[torch.Tensor],
                   dest_cap: int) -> Exchange:
    """Steps 2-3 of the exchange for ``[S, L]`` partials over S shards:
    each active partial's owner, a stable order by owner, its rank inside
    the owner; ranks below ``dest_cap`` fill the send buffers (the rest
    with 0, 0, invalid and each lane's identity), and every partial lands
    in the merged rows' tail in owner order, valid when its rank is past
    ``dest_cap`` (kept local). On the card: two launches over the whole
    card, the second writing the send buffers' fill with 16-byte stores."""
    if u_key.dim() == 2 and not 1 <= u_key.shape[0] <= MAX_SHARDS:
        raise ValueError(f"{u_key.shape[0]} shards (at most {MAX_SHARDS})")
    if int(dest_cap) < 1:
        raise ValueError(f"dest_cap {dest_cap} < 1")
    _check_2d(u_key, "u_key", (torch.int64,))
    dev, shape = u_key.device, tuple(u_key.shape)
    _check_2d(u_bin, "u_bin", (torch.int32,), shape, dev)
    _check_2d(active, "active", (torch.bool,), shape, dev)
    _check_lanes(kinds, u_accs, shape, dev, "u_accs")
    S, L = shape
    if dev.type == "cpu":
        return shard_exchange_plain(kinds, u_key, u_bin, active, u_accs, dest_cap)
    out = _exchange_out(S, L, dest_cap, [a.dtype for a in u_accs], dev)
    cshape, cdt = exchange_scratch(S, L)["counts"]
    counts = torch.empty(cshape, dtype=cdt, device=dev)
    ln = _lanes(kinds, [a.dtype for a in u_accs], inp=u_accs, out=out.s_accs, aux=out.m_accs)
    err = build_library().arroyo_shard_exchange(
        _dev_index(dev), S, L, int(dest_cap), u_key.data_ptr(), u_bin.data_ptr(),
        active.data_ptr(), ctypes.byref(ln), out.s_key.data_ptr(), out.s_bin.data_ptr(),
        out.s_valid.data_ptr(), out.m_key.data_ptr(), out.m_bin.data_ptr(),
        out.m_valid.data_ptr(), counts.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "shard_exchange")
    kernels._counted(shard_exchange)
    return out


def exchange_kernel_launches() -> int:
    """Kernels K10's exchange has launched on the card in this process
    (builds the library): the difference across one call is that call's
    launches."""
    return build_library().arroyo_shard_exchange_kernel_launches()


def shard_exchange_plain(kinds, u_key, u_bin, active, u_accs, dest_cap) -> Exchange:
    """Plain PyTorch version of K10's exchange (``exchange_merge`` steps
    2-3: argsort by owner, searchsorted starts, rank, scatter)."""
    S, L = u_key.shape
    dev = u_key.device
    recv = S * dest_cap
    out = _exchange_out(S, L, dest_cap, [a.dtype for a in u_accs], dev)
    owner = torch.where(active, owner_of(u_key, S), torch.full_like(u_key, S))
    o_s, order = torch.sort(owner, dim=1, stable=True)
    starts = torch.searchsorted(o_s, torch.arange(S, device=dev).expand(S, S).contiguous())
    rank = torch.arange(L, device=dev) - torch.gather(starts, 1, o_s.clamp(0, S - 1))
    sendable = (o_s < S) & (rank < dest_cap)
    keep_local = (o_s < S) & (rank >= dest_cap)
    slot = torch.where(sendable, o_s * dest_cap + rank, torch.full_like(rank, recv))

    def scatter(dst, src_sorted, fill):
        buf = torch.full((S, recv + 1), fill, dtype=src_sorted.dtype, device=dev)
        buf.scatter_(1, slot, src_sorted)
        dst.copy_(buf[:, :recv])

    scatter(out.s_key, torch.gather(u_key, 1, order), 0)
    scatter(out.s_bin, torch.gather(u_bin, 1, order), 0)
    scatter(out.s_valid, sendable, False)
    for k, a, s in zip(kinds, u_accs, out.s_accs):
        scatter(bits(s), torch.gather(bits(a), 1, order), ident_bits(k, a.dtype))
    out.m_key[:, recv:] = torch.gather(u_key, 1, order)
    out.m_bin[:, recv:] = torch.gather(u_bin, 1, order)
    out.m_valid[:, recv:] = keep_local
    for a, m in zip(u_accs, out.m_accs):
        bits(m)[:, recv:] = torch.gather(bits(a), 1, order)
    return out



def _check_spill(kinds, spill):
    sp_key, sp_bin, sp_fill, sp_accs, oflow = spill
    _check_2d(sp_key, "spill keys", (torch.int64,))
    dev, shape = sp_key.device, tuple(sp_key.shape)
    _check_2d(sp_bin, "spill bins", (torch.int32,), shape, dev)
    _check_lanes(kinds, sp_accs, shape, dev, "spill accs")
    for t, what in ((sp_fill, "spill fill"), (oflow, "overflow")):
        _check_counter(t, shape[0], dev, what)
    return dev, shape


def spill_scratch_bytes(S: int, M: int) -> int:
    """Bytes of K10's spill state for ``[S, M]`` partials: the compaction's
    ticket counter and one status word per tile of COMPACT_TILE flags
    (pinned to the library's ``arroyo_shard_spill_scratch_bytes`` on the
    card)."""
    return 8 * (1 + S * -(-M // COMPACT_TILE))


def spill_scratch(S: int, M: int, dev: torch.device) -> torch.Tensor:
    """A zeroed spill state for ``[S, M]`` partials on ``dev``. The kernel
    numbers its launches on the buffer by a ticket counter that is never
    cleared, so one buffer serves every call of one (S, M) on one stream,
    and no other."""
    return torch.zeros(spill_scratch_bytes(S, M), dtype=torch.uint8, device=dev)


def shard_spill(kinds: Sequence[str], c_key: torch.Tensor, c_bin: torch.Tensor,
                c_accs: Sequence[torch.Tensor], still: torch.Tensor, spill,
                scratch: Optional[torch.Tensor] = None) -> None:
    """Step 7: each shard's still-active partials ``[S, M]`` append, in
    index order, to its spill buffer ``(sp_key, sp_bin, sp_fill, sp_accs,
    oflow)`` in place from ``sp_fill``; rows past its end add to
    ``oflow``. On the card ``scratch`` is the call's ``spill_scratch(S, M)``
    (a buffer kept for this layout and stream); the CPU needs none."""
    if c_key.dim() == 2 and spill[0].dim() == 2:  # the sizes first: meta tensors show them
        M, sc = c_key.shape[1], spill[0].shape[1]
        if M > INT32_LIMIT or sc > INT32_LIMIT:
            raise ValueError(f"{M} partials and {sc} spill rows a shard; the kernel counts "
                             f"them in 32 bits")
    dev, sshape = _check_spill(kinds, spill)
    _check_2d(c_key, "c_key", (torch.int64,), None, dev)
    shape = tuple(c_key.shape)
    if shape[0] != sshape[0]:
        raise ValueError(f"{shape[0]} shards of partials for a spill buffer of {sshape[0]}")
    _check_2d(c_bin, "c_bin", (torch.int32,), shape, dev)
    _check_2d(still, "still", (torch.bool,), shape, dev)
    _check_lanes(kinds, c_accs, shape, dev, "c_accs")
    S, M = shape
    if dev.type == "cpu":
        shard_spill_plain(kinds, c_key, c_bin, c_accs, still, spill)
        return
    want = spill_scratch_bytes(S, M)
    if (scratch is None or scratch.dtype != torch.uint8 or scratch.device != dev
            or scratch.numel() != want or not scratch.is_contiguous()):
        raise ValueError(f"shard_spill on the card needs its state buffer: spill_scratch({S}, "
                         f"{M}), {want} contiguous bytes on {dev}")
    sp_key, sp_bin, sp_fill, sp_accs, oflow = spill
    ln = _lanes(kinds, [a.dtype for a in c_accs], inp=c_accs, out=sp_accs)
    err = build_library().arroyo_shard_spill(
        _dev_index(dev), S, M, c_key.data_ptr(), c_bin.data_ptr(), still.data_ptr(),
        ctypes.byref(ln), sshape[1], sp_key.data_ptr(), sp_bin.data_ptr(), sp_fill.data_ptr(),
        oflow.data_ptr(), scratch.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "shard_spill")
    kernels._counted(shard_spill)


def spill_kernel_launches() -> int:
    """Kernels K10's spill has launched on the card in this process (builds
    the library): one a call."""
    return build_library().arroyo_shard_spill_kernel_launches()


def shard_spill_plain(kinds, c_key, c_bin, c_accs, still, spill) -> None:
    """Plain PyTorch version of K10's spill append (cumsum positions)."""
    sp_key, sp_bin, sp_fill, sp_accs, oflow = spill
    S, sc = sp_key.shape
    sidx = sp_fill[:, None].to(torch.int64) + torch.cumsum(still.to(torch.int64), dim=1) - 1
    ok = still & (sidx < sc)
    pos = torch.where(ok, sidx, torch.full_like(sidx, sc))
    for dst, src in [(sp_key, c_key), (sp_bin, c_bin)] + list(zip(sp_accs, c_accs)):
        dst, src = bits(dst), bits(src)
        buf = torch.cat([dst, dst[:, :1]], dim=1)
        buf.scatter_(1, pos, src)
        dst.copy_(buf[:, :sc])
    n_spilled = ok.sum(dim=1)
    oflow += (still.sum(dim=1) - n_spilled).to(torch.int32)
    sp_fill.copy_(torch.clamp(sp_fill + n_spilled, max=sc).to(torch.int32))


# ------------------------------------------------------------- K11


class Extracted(NamedTuple):
    """shard_extract's outputs, views of one packed byte buffer (one copy
    to the host moves them all): key int64, bin int32, valid bool and one
    array per lane, each ``[S, E]``, total int32 ``[S]``, and the table's
    overflow counter int32 ``[S]`` when it was asked for (else None)."""

    packed: torch.Tensor
    key: torch.Tensor
    bin: torch.Tensor
    valid: torch.Tensor
    accs: list
    total: torch.Tensor
    oflow: Optional[torch.Tensor] = None


def extract_layout(S: int, E: int, dtypes, oflow: bool = False) -> tuple[int, list]:
    """(bytes, [(offset, dtype, shape)]) of the packed extract buffer, in
    the order key, bin, valid, lanes..., total (, overflow); every part
    8-byte aligned."""
    parts = [(np.dtype(np.int64), (S, E)), (np.dtype(np.int32), (S, E)),
             (np.dtype(np.bool_), (S, E))]
    parts += [(_NP[dt] if isinstance(dt, torch.dtype) else np.dtype(dt), (S, E)) for dt in dtypes]
    parts.append((np.dtype(np.int32), (S,)))
    if oflow:
        parts.append((np.dtype(np.int32), (S,)))
    out, off = [], 0
    for dt, shp in parts:
        out.append((off, dt, shp))
        off += -(-int(np.prod(shp)) * dt.itemsize // 8) * 8
    return off, out


_TORCH = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
          np.dtype(np.bool_): torch.bool, np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64, np.dtype(np.uint64): torch.uint64}


def _carve(packed: torch.Tensor, layout) -> list[torch.Tensor]:
    return [packed[off: off + int(np.prod(shp)) * dt.itemsize].view(_TORCH[dt]).view(shp)
            for off, dt, shp in layout]


def unpack_extracted(host: np.ndarray, S: int, E: int, dtypes, oflow: bool = False):
    """The host copy of a packed extract buffer carved as shard_extract's
    outputs: (key, bin, valid, accs, total) numpy arrays, and the overflow
    counter after them when the buffer carries it."""
    _n, layout = extract_layout(S, E, dtypes, oflow)
    parts = [host[off: off + int(np.prod(shp)) * dt.itemsize].view(dt).reshape(shp)
             for off, dt, shp in layout]
    if oflow:
        return parts[0], parts[1], parts[2], parts[3:-2], parts[-2], parts[-1]
    return parts[0], parts[1], parts[2], parts[3:-1], parts[-1]


def _extract_out(S, E, dtypes, dev, oflow: bool = False) -> Extracted:
    nbytes, layout = extract_layout(S, E, dtypes, oflow)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    v = _carve(packed, layout)
    if oflow:
        return Extracted(packed, v[0], v[1], v[2], v[3:-2], v[-2], v[-1])
    return Extracted(packed, v[0], v[1], v[2], v[3:-1], v[-1])


def shard_extract(table, emit_lo: int, emit_hi: int, free_below: int,
                  emit_cap: int, zero_tail: bool = False,
                  oflow: Optional[torch.Tensor] = None) -> Extracted:
    """Close bins [emit_lo, emit_hi) of every shard of ``table`` (keys,
    bins, occ, accs ``[S, cap]``): the first ``E = min(emit_cap, cap)``
    slots of the stable order that puts emitting slots first
    (``argsort(~emit_mask)[:emit_cap]``), ``valid`` marking the emitting
    ones, and ``total`` emitting slots per shard. Frees, in place: slots
    with bin < free_below outside the emit range, and emitting slots with
    bin < free_below that made it into the E rows. With ``zero_tail``,
    ``E = emit_cap`` and the rows past the emitting ones hold zeros (the
    single-device table's cumsum scatter, aggregate.py ``extract``).
    Given ``oflow`` (int32 ``[S]``), the packed buffer carries a copy of
    it (``Extracted.oflow``)."""
    keys_t, bins_t, occ_t, accs_t = table
    _check_2d(keys_t, "table keys", (torch.int64,))
    dev, shape = keys_t.device, tuple(keys_t.shape)
    _check_2d(bins_t, "table bins", (torch.int32,), shape, dev)
    _check_2d(occ_t, "table occ", (torch.bool,), shape, dev)
    if len(accs_t) > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes")
    for a in accs_t:
        _check_2d(a, "table lane", tuple(_DTYPE_CODE), shape, dev)
    S, cap = shape
    E = int(emit_cap) if zero_tail else min(int(emit_cap), cap)
    if E < 1:
        raise ValueError(f"emit_cap {emit_cap} < 1")
    if oflow is not None:
        _check_counter(oflow, S, dev, "overflow")
    if dev.type == "cpu":
        return shard_extract_plain(table, emit_lo, emit_hi, free_below, emit_cap, zero_tail,
                                   oflow)
    lib = build_library()
    dts = [a.dtype for a in accs_t]
    out = _extract_out(S, E, dts, dev, oflow is not None)
    zt = int(bool(zero_tail))
    scratch = compaction_scratch(
        ("shard_extract", S, cap, E, zt), dev,
        lambda: lib.arroyo_shard_extract_scratch_bytes(S, cap, E, zt))
    ln = _lanes(["sum"] * len(dts), dts, inp=accs_t, out=out.accs)
    err = lib.arroyo_shard_extract(
        _dev_index(dev), S, cap, keys_t.data_ptr(), bins_t.data_ptr(), occ_t.data_ptr(),
        ctypes.byref(ln), int(emit_lo), int(emit_hi), int(free_below), E, out.key.data_ptr(),
        out.bin.data_ptr(), out.valid.data_ptr(), out.total.data_ptr(), scratch.data_ptr(), zt,
        None if oflow is None else oflow.data_ptr(),
        None if oflow is None else out.oflow.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "shard_extract")
    kernels._counted(shard_extract)
    return out


def extract_kernel_launches() -> int:
    """Kernels K11 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches."""
    return build_library().arroyo_shard_extract_kernel_launches()


_scratch_cache: dict = {}


def compaction_scratch(layout: tuple, dev: torch.device, nbytes) -> torch.Tensor:
    """The scratch of csrc/table_compact.cuh's compaction (K11, K12's walk)
    for one ``layout`` (what fixes the kernel's grid) on ``dev``'s current
    stream: ``nbytes()`` bytes, zeroed once, at the first call. The kernel
    numbers its launches on the buffer by its never-cleared ticket counter,
    which holds only while every launch on it has the same grid and runs
    after the one before it: hence one buffer per layout and stream."""
    key = (layout, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _scratch_cache.get(key)
    if buf is None:
        buf = _scratch_cache[key] = torch.zeros(int(nbytes()), dtype=torch.uint8, device=dev)
    return buf


def shard_extract_plain(table, emit_lo, emit_hi, free_below, emit_cap, zero_tail=False,
                        oflow=None) -> Extracted:
    """Plain PyTorch version of K11 (``local_extract``: a stable argsort of
    the inverted emit mask; with ``zero_tail`` the rows past the emitting
    ones are zeros, as the single-device ``extract`` writes them)."""
    keys_t, bins_t, occ_t, accs_t = table
    S, cap = keys_t.shape
    E = int(emit_cap) if zero_tail else min(int(emit_cap), cap)
    out = _extract_out(S, E, [a.dtype for a in accs_t], keys_t.device, oflow is not None)
    emit = occ_t & (bins_t >= emit_lo) & (bins_t < emit_hi)
    out.total.copy_(emit.sum(dim=1).to(torch.int32))
    if oflow is not None:
        out.oflow.copy_(oflow)
    order = torch.sort((~emit).to(torch.uint8), dim=1, stable=True)[1]
    if E > cap:  # zero_tail only: rows past cap are tail rows
        order = torch.cat([order, order[:, :1].expand(S, E - cap)], dim=1)
    sel = order[:, :E]
    out.valid.copy_(torch.gather(emit, 1, sel))
    out.key.copy_(torch.gather(keys_t, 1, sel))
    out.bin.copy_(torch.gather(bins_t, 1, sel))
    for a, o in zip(accs_t, out.accs):
        bits(o).copy_(torch.gather(bits(a), 1, sel))
    if zero_tail:
        tail = torch.arange(E, device=keys_t.device)[None, :] >= out.total[:, None].to(torch.int64)
        out.valid.masked_fill_(tail, False)
        for t in (out.key, out.bin, *[bits(o) for o in out.accs]):
            t.masked_fill_(tail, 0)
    free_mask = occ_t & (bins_t < free_below) & ~emit
    emitted_free = out.valid & (out.bin < free_below)
    occ_t &= ~free_mask
    rows = torch.arange(S, device=keys_t.device)[:, None].expand(S, E)
    occ_t[rows[emitted_free], sel[emitted_free]] = False
    return out


WRAPPERS = (agg_sort_reduce, agg_probe_merge, shard_exchange, shard_spill, shard_extract)


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0


reset_launch_counts()
