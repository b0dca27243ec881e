"""Background materialization of device->host fetches (the port's copy of
arroyo_tpu/ops/prefetch.py).

A window close dispatches its reads and starts the copy to the host at
once (``HostFetch``: a ``non_blocking`` copy into a pinned host buffer,
with a CUDA event recorded behind it on the caller's stream). The close's
``result`` then runs on a small shared pool of daemon threads, which wait
on that event -- not on the whole device -- while the operator thread goes
on updating state; the operator polls ``Future.is_ready()`` and emits
completed closes in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch


class HostFetch:
    """One device tensor on its way to host memory. The source tensor and
    the pinned buffer are held until the copy has landed, so the caching
    allocators cannot hand either out while the copy is in flight."""

    def __init__(self, t: torch.Tensor):
        self._src: Optional[torch.Tensor] = None
        self._event = None
        if t.device.type == "cuda":
            self._src = t
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._src = None
        return self._host.numpy()


class Future:
    def __init__(self, fn: Callable):
        self._fn = fn
        self._done = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def is_ready(self) -> bool:
        return self._done.is_set()

    def result(self):
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        return self._value

    def _run(self) -> None:
        try:
            self._value = self._fn()
        except BaseException as e:  # noqa: BLE001 - re-raised at result()
            self._exc = e
        self._done.set()


class Prefetcher:
    """A small daemon pool draining a submit queue. Submitted callables
    must not mutate shared aggregator state (SlotExtractHandle.result reads
    only identities snapshotted at dispatch and its own fetches)."""

    def __init__(self, workers: int = 4):
        self._q: "queue.Queue[Future]" = queue.Queue()
        self._workers = workers
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()

    def _ensure_threads(self) -> None:
        with self._lock:
            while len(self._threads) < self._workers:
                t = threading.Thread(target=self._loop,
                                     name=f"arroyo-torch-prefetch-{len(self._threads)}",
                                     daemon=True)
                t.start()
                self._threads.append(t)

    def _loop(self) -> None:
        while True:
            self._q.get()._run()

    def submit(self, fn: Callable) -> Future:
        self._ensure_threads()
        fut = Future(fn)
        self._q.put(fut)
        return fut


_shared: Optional[Prefetcher] = None
_shared_lock = threading.Lock()


def shared_prefetcher() -> Prefetcher:
    global _shared
    with _shared_lock:
        if _shared is None:
            from ..config import config

            _shared = Prefetcher(config().get("device.prefetch-workers", 8))
        return _shared
