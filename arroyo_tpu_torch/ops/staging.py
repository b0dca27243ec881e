"""Host arrays to the card in one copy.

A batch's arrays cross to the card together: packed into one host buffer
(pinned for the card), each at a 16-byte boundary, copied with one
``non_blocking`` copy on the current stream, and carved into views on the
device. K4's batch columns (``segment_kernel.stage_inputs``), K1's slots
and value lanes (``SlotAggregator._update_chunk``) and K7's slots
(``SlotAggregator.read_slots``) go this way: one pinned copy a call where
each array was a pageable copy of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

ALIGN = 16  # bytes: every part of a staged buffer and of a packed output

_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.uint64): torch.uint64, np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def aligned(sizes) -> tuple[int, list[int]]:
    """(total bytes, offsets) of parts of ``sizes`` bytes laid end to end,
    each at a multiple of ALIGN."""
    offs, off = [], 0
    for n in sizes:
        offs.append(off)
        off += -(-int(n) // ALIGN) * ALIGN
    return off, offs


def stage(arrays: Sequence[np.ndarray], device: torch.device,
          dtypes: Optional[Sequence[torch.dtype]] = None) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The 1-D ``arrays`` on ``device`` after one copy: (views, host). Each
    view holds its array's bytes, as its own dtype (``dtypes[i]`` when
    given, of the same item size: uint64 columns cross as int64 bits
    where the kernel reads them so). ``host`` is the packed host buffer
    (pinned for the card; on the CPU the views are of it). The caching
    host allocator does not hand a pinned buffer out again before its copy
    has landed; a caller that waits on an event of its own may hold
    ``host`` until then as well."""
    arrays = [np.asarray(a) for a in arrays]
    if dtypes is None:
        dtypes = [_TORCH[a.dtype] for a in arrays]
    if len(dtypes) != len(arrays):
        raise ValueError(f"{len(dtypes)} dtypes for {len(arrays)} arrays")
    for a, dt in zip(arrays, dtypes):
        if a.ndim != 1 or a.dtype.itemsize != dt.itemsize:
            raise ValueError(f"a {a.dtype}{list(a.shape)} array does not stage as {dt}")
    nbytes, offs = aligned(a.nbytes for a in arrays)
    cuda = device.type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    h = host.numpy()
    for a, off in zip(arrays, offs):
        h[off: off + a.nbytes].view(a.dtype)[:] = a
    buf = host.to(device, non_blocking=True) if cuda else host
    views = [buf[off: off + a.nbytes].view(dt) for a, dt, off in zip(arrays, dtypes, offs)]
    return views, host
