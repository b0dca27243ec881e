"""The windowed join's probe kernels: wrappers and plain versions.

Two hand-written CUDA kernels (csrc/join_probe.cu, see its header for what
each replaces and what bounds it) do the device half of one window's join:

- ``join_sort_pairs`` (K5): the stable argsort of the build side's int64
  keys, with the sorted keys, by a radix sort of 8-bit digits (in range
  mode on K1's slots too);
- ``join_search_bounds`` (K6): for every probe key, the first sorted index
  whose key is >= it (``lo``) and > it (``hi``).

Each wrapper checks device, dtype, shape and contiguity, and raises on what
the kernel does not take. On a CUDA tensor it launches the kernel (building
the library with nvcc at first use, ``kernels.build_source``) or raises; it
takes the plain PyTorch version (``*_plain``, beside it) only for tensors on
the CPU. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels

INT32_LIMIT = (1 << 31) - 1


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.arroyo_join_sort_scratch_bytes.argtypes = [ll, ll]
    lib.arroyo_join_sort_scratch_bytes.restype = ll
    lib.arroyo_join_sort_pairs.argtypes = [i, p, i, ll, ll, i, p, p, p, ll, p]
    lib.arroyo_join_search_bounds.argtypes = [i, p, ll, p, ll, p, p, p]
    lib.arroyo_join_sort_pairs.restype = ctypes.c_int
    lib.arroyo_join_sort_kernel_launches.argtypes = []
    lib.arroyo_join_sort_kernel_launches.restype = ll
    lib.arroyo_join_search_bounds.restype = ctypes.c_int


def build_library() -> ctypes.CDLL:
    """The join probe's library (csrc/join_probe.cu)."""
    return kernels.build_source("join_probe", _bind)


def _check_keys(t: torch.Tensor, what: str) -> torch.device:
    if t.dtype != torch.int64:
        raise TypeError(f"{what} dtype {t.dtype} is not int64")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D tensor")
    if t.shape[0] > INT32_LIMIT:
        raise ValueError(f"{what} has {t.shape[0]} rows; the kernels index with int32")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


# ------------------------------------------------------------- K5

SORT_TILE = 4096  # csrc/join_probe.cu SORT_TILE: an input this small sorts in one launch
DIGIT_BITS = 8


def sort_bits(key_bits: int = 64, range_cap: Optional[int] = None) -> int:
    """The bits K5 sorts on: ``key_bits`` of the sign-flipped key (full
    mode, 1..64), or in range mode (``range_cap`` in [1, 2^31)) the bit
    length of ``range_cap``: keys in [0, range_cap) sort as themselves and
    every other key as ``range_cap``. Raises ValueError on anything else."""
    if range_cap is not None:
        if not 1 <= range_cap <= INT32_LIMIT:
            raise ValueError(f"range mode needs 1 <= range_cap < 2^31, got {range_cap}")
        return int(range_cap).bit_length()
    if not 1 <= key_bits <= 64:
        raise ValueError(f"key_bits {key_bits} outside 1..64")
    return key_bits


def sort_passes(key_bits: int = 64, range_cap: Optional[int] = None) -> int:
    """K5's radix passes: one per 8-bit digit of ``sort_bits``."""
    return -(-sort_bits(key_bits, range_cap) // DIGIT_BITS)


def sort_launches(n: int, key_bits: int = 64, range_cap: Optional[int] = None) -> int:
    """Kernel launches of one K5 call on n keys: none for no keys, one for
    at most a tile, else the digit count and one per pass (after a memset
    of the scratch's counters)."""
    passes = sort_passes(key_bits, range_cap)
    return 0 if n == 0 else 1 if n <= SORT_TILE else 1 + passes


def join_sort_pairs(keys: torch.Tensor, key_bits: int = 64,
                    range_cap: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys int64, order int32): ``order`` is the stable argsort of
    ``keys`` (equal keys keep their input order) and ``sorted =
    keys[order]``. ``key_bits`` < 64 sorts on the key's low
    ``sort_passes(key_bits)`` digits alone (the caller knows the others are
    equal); ``range_cap`` sorts in range mode
    (``sort_bits``), where ``sorted`` holds ``range_cap`` for every key
    outside [0, range_cap)."""
    sort_bits(key_bits, range_cap)
    dev = _check_keys(keys, "keys")
    if dev.type == "cpu":
        return join_sort_pairs_plain(keys, key_bits, range_cap)
    out = sort_pairs_launch(keys, key_bits, range_cap)
    if keys.shape[0]:
        kernels._counted(join_sort_pairs)
    return out


def sort_pairs_launch(keys: torch.Tensor, key_bits: int = 64,
                      range_cap: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's launches on checked contiguous 1-D CUDA keys (int64, or int32
    sorted as their int64 values), counted by its caller: the join's
    wrapper above, or K1's float sums (kernels.slot_scatter_combine, in
    range mode), which take their stable row order from it. The scratch
    (counters, tile statuses, the ping-pong's second buffers) comes from
    torch.empty and is freed on return: the caching allocator hands it out
    again only to work that the current stream orders after these
    launches."""
    passes = sort_passes(key_bits, range_cap)
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return keys.new_empty(0, dtype=torch.int64), torch.empty(0, dtype=torch.int32, device=dev)
    if n > INT32_LIMIT:
        raise ValueError(f"{n} keys: the kernel orders at most 2^31 - 1 rows")
    lib = build_library()
    cap = range_cap or 0
    scratch = torch.empty(lib.arroyo_join_sort_scratch_bytes(n, cap), dtype=torch.uint8, device=dev)
    out_keys = torch.empty(n, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.arroyo_join_sort_pairs(dev.index or 0, keys.data_ptr(),
                                     int(keys.dtype == torch.int32), n, cap, passes,
                                     out_keys.data_ptr(), order.data_ptr(),
                                     scratch.data_ptr() if scratch.numel() else None,
                                     scratch.numel(), kernels._stream(dev))
    kernels._raise_on(err, "join_sort_pairs")
    return out_keys, order


def sort_kernel_launches() -> int:
    """Kernels K5 has launched on the card in this process (builds the
    library): the difference across one call is that call's launches,
    ``sort_launches`` of its length."""
    return build_library().arroyo_join_sort_kernel_launches()


def join_sort_pairs_plain(keys: torch.Tensor, key_bits: int = 64,
                          range_cap: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 (int64 or int32 keys)."""
    sort_bits(key_bits, range_cap)
    k = keys.long()
    if range_cap is not None:
        k = torch.where((k >= 0) & (k < range_cap), k, torch.full_like(k, range_cap))
        sk, order = torch.sort(k, stable=True)
        return sk, order.to(torch.int32)
    bits = DIGIT_BITS * sort_passes(key_bits)
    if bits < 64:
        # the kernel's digits: below bit 63 the sign-flipped key's bits are the key's own
        _sk, order = torch.sort(k & ((1 << bits) - 1), stable=True)
        return k[order], order.to(torch.int32)
    sk, order = torch.sort(k, stable=True)
    return sk, order.to(torch.int32)


# ------------------------------------------------------------- K6


def join_search_bounds(sorted_keys: torch.Tensor,
                       probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo int32, hi int32) per probe key: ``searchsorted`` over the sorted
    keys with side "left" and side "right"."""
    dev = _check_keys(sorted_keys, "sorted keys")
    if _check_keys(probe, "probe keys") != dev:
        raise ValueError(f"probe keys on {probe.device}, sorted keys on {dev}")
    if dev.type == "cpu":
        return join_search_bounds_plain(sorted_keys, probe)
    p = probe.shape[0]
    lo = torch.empty(p, dtype=torch.int32, device=dev)
    hi = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return lo, hi
    lib = build_library()
    err = lib.arroyo_join_search_bounds(dev.index or 0, sorted_keys.data_ptr(),
                                        sorted_keys.shape[0], probe.data_ptr(), p,
                                        lo.data_ptr(), hi.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "join_search_bounds")
    kernels._counted(join_search_bounds)
    return lo, hi


def join_search_bounds_plain(sorted_keys: torch.Tensor,
                             probe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6."""
    lo = torch.searchsorted(sorted_keys, probe, side="left")
    hi = torch.searchsorted(sorted_keys, probe, side="right")
    return lo.to(torch.int32), hi.to(torch.int32)


WRAPPERS = (join_sort_pairs, join_search_bounds)


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0


reset_launch_counts()
