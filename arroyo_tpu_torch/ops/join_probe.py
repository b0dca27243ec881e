"""Device-lowered hash-join index computation for windowed joins (the port's
copy of arroyo_tpu/ops/join_probe.py).

The join's heavy phase -- sorting the build side and binary-searching every
probe key -- runs on the card as two kernels (ops/join_kernels.py: K5
``join_sort_pairs``, K6 ``join_search_bounds``); only the data-dependent
pair expansion, whose output size is known only after the search, stays on
the host, where it is a cheap repeat/cumsum.

Both sides are padded to power-of-two buckets with INT64_MAX, as the
reference pads them, so the kernels see the reference's shapes. The three
results stream back through ``HostFetch`` (pinned memory behind a CUDA
event) and a JoinHandle, so the join operator can dispatch the close for
window t and emit it when it is ready, without blocking its loop.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import join_kernels
from .prefetch import HostFetch

_SENTINEL = np.iinfo(np.int64).max


def host_join_indices(
    left_keys: np.ndarray, right_keys: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host (numpy) inner-join row index pairs (li, ri) where keys match:
    sort the right side once, binary-search each left key, expand ranges.
    The same sort/search phase the device path runs via _probe_jit."""
    order = np.argsort(right_keys, kind="stable")
    rk = right_keys[order]
    lo = np.searchsorted(rk, left_keys, side="left")
    hi = np.searchsorted(rk, left_keys, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(left_keys)), counts)
    # for each left row, offsets lo[l]..hi[l] into the sorted right
    if len(li):
        within = np.arange(len(li)) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        ri = order[np.repeat(lo, counts) + within]
    else:
        ri = np.empty(0, dtype=np.int64)
    return li, ri


def fused_join_indices(
    left_keys: np.ndarray,
    right_keys: np.ndarray,
    l_bounds: np.ndarray,
    r_bounds: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Inner-join pairs for W independent partitions (windows) in one call:
    partition w spans left rows l_bounds[w]:l_bounds[w+1] and right rows
    r_bounds[w]:r_bounds[w+1]. Each partition is probed with the shared
    sort/search join on its slice (still a Python loop over W — a true
    (partition, key) lexsort probe is a possible follow-up); the win is in
    the OUTPUT: pairs come back as GLOBAL row indices so the caller
    gathers and emits once for all windows instead of W tiny batches."""
    lis: list[np.ndarray] = []
    ris: list[np.ndarray] = []
    for w in range(len(l_bounds) - 1):
        l0, l1 = int(l_bounds[w]), int(l_bounds[w + 1])
        r0, r1 = int(r_bounds[w]), int(r_bounds[w + 1])
        li, ri = host_join_indices(left_keys[l0:l1], right_keys[r0:r1])
        if len(li):
            lis.append(li + l0)
            ris.append(ri + r0)
    if not lis:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    return np.concatenate(lis), np.concatenate(ris)


def _bucket(n: int) -> int:
    c = 64
    while c < n:
        c <<= 1
    return c


class JoinHandle:
    """In-flight device join for one window: order/lo/hi are streaming to
    host; result() expands them into (li, ri) inner-join index pairs. The
    pinned staging buffers of the keys are held until the results have
    landed: the copies to the card read them asynchronously."""

    def __init__(self, n_l: int, n_r: int, order: HostFetch, lo: HostFetch, hi: HostFetch,
                 staging: tuple = ()):
        self._n_l = n_l
        self._n_r = n_r
        self._bufs = (order, lo, hi)
        self._staging = staging

    def is_ready(self) -> bool:
        """True when all three results are on the host; never blocks."""
        return all(b.is_ready() for b in self._bufs)

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        order, lo, hi = (b.result() for b in self._bufs)
        self._staging = ()
        n_l, n_r = self._n_l, self._n_r
        lo = lo[:n_l].astype(np.int64)
        hi = hi[:n_l].astype(np.int64)
        counts = hi - lo
        li = np.repeat(np.arange(n_l), counts)
        if len(li):
            within = np.arange(len(li)) - np.repeat(np.cumsum(counts) - counts, counts)
            ri = order[np.repeat(lo, counts) + within].astype(np.int64)
            # padded build rows sort to the tail; a probe key equal to the
            # sentinel could reference them — drop those pairs exactly
            keep = ri < n_r
            if not keep.all():
                li, ri = li[keep], ri[keep]
        else:
            ri = np.empty(0, dtype=np.int64)
        return li, ri


def _stage(keys: np.ndarray, cap: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The keys padded to ``cap`` with the sentinel, on ``dev``: written
    once into a pinned host buffer (for the card) and copied without
    blocking. Returns (device tensor, host buffer); the host buffer must
    outlive the copy."""
    pinned = dev.type == "cuda"
    host = torch.empty(cap, dtype=torch.int64, pin_memory=pinned)
    h = host.numpy()
    h[:len(keys)] = keys
    h[len(keys):] = _SENTINEL
    if not pinned:
        return host, host
    return host.to(dev, non_blocking=True), host


def device_join_start(left_keys: np.ndarray, right_keys: np.ndarray,
                      device: Union[str, torch.device]) -> JoinHandle:
    """Dispatch the sort/search phase for an inner join on int64 keys on
    ``device`` (K5 then K6; their plain versions on the CPU); returns a
    JoinHandle whose result() yields (li, ri) pairs."""
    dev = torch.device(device)
    n_l, n_r = len(left_keys), len(right_keys)
    l_cap, r_cap = _bucket(n_l), _bucket(n_r)
    lk, lk_host = _stage(left_keys, l_cap, dev)
    rk, rk_host = _stage(right_keys, r_cap, dev)
    rk_sorted, order = join_kernels.join_sort_pairs(rk)
    lo, hi = join_kernels.join_search_bounds(rk_sorted, lk)
    return JoinHandle(n_l, n_r, HostFetch(order), HostFetch(lo), HostFetch(hi),
                      staging=(lk_host, rk_host))
