"""The windowed join's probe kernels: wrappers and plain versions.

Two hand-written CUDA kernels (csrc/join_probe.cu, see its header for what
each replaces and what bounds it) do the device half of one window's join:

- ``join_sort_pairs`` (K5): the stable argsort of the build side's int64
  keys, with the sorted keys;
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

import torch

from . import kernels

INT32_LIMIT = (1 << 31) - 1


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.arroyo_join_sort_pairs.argtypes = [i, p, i, ll, p, p, ll, p]
    lib.arroyo_join_search_bounds.argtypes = [i, p, ll, p, ll, p, p, p]
    lib.arroyo_join_sort_pairs.restype = ctypes.c_int
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


def join_sort_pairs(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys int64, order int32): ``order`` is the stable argsort of
    ``keys`` (equal keys keep their input order) and ``sorted = keys[order]``."""
    dev = _check_keys(keys, "keys")
    if dev.type == "cpu":
        return join_sort_pairs_plain(keys)
    out = sort_pairs_launch(keys)
    if keys.shape[0]:
        kernels._counted(join_sort_pairs)
    return out


def sort_pairs_launch(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's launch on checked contiguous 1-D CUDA keys (int64, or int32
    sorted as their int64 values), counted by its caller: the join's
    wrapper above, or K1's float sums (kernels.slot_scatter_combine), which
    take their stable row order from it."""
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return keys.new_empty(0), torch.empty(0, dtype=torch.int32, device=dev)
    cap = max(64, 1 << (n - 1).bit_length())  # the network's power-of-two length
    if cap > INT32_LIMIT:
        raise ValueError(f"{n} keys round up to {cap} pairs; the kernel sorts at most 2^30")
    out_keys = torch.empty(cap, dtype=torch.int64, device=dev)
    order = torch.empty(cap, dtype=torch.int32, device=dev)
    lib = build_library()
    err = lib.arroyo_join_sort_pairs(dev.index or 0, keys.data_ptr(),
                                     int(keys.dtype == torch.int32), n, out_keys.data_ptr(),
                                     order.data_ptr(), cap, kernels._stream(dev))
    kernels._raise_on(err, "join_sort_pairs")
    return out_keys[:n], order[:n]


def join_sort_pairs_plain(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5."""
    sk, order = torch.sort(keys, stable=True)
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
