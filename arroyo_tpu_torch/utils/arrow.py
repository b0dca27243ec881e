"""pyarrow compatibility shims (the port's copy of arroyo_tpu/utils/arrow.py).

pyarrow is optional: the package imports without it, and parquet state files
and parquet file formats need it. Some pyarrow builds segfault (deterministically, inside
parquet read/write) when its parquet machinery is *first* initialized from a
non-main thread and later used from another thread — the exact pattern of
engine task threads writing sink part-files. A one-time in-memory
write+read from whichever thread gets there first (normally the main thread,
during package init) pins the lazy global state safely; all later
cross-thread use is then stable. The JAX package found this with a two-engine filesystem parquet round trip
(a crash in pq.read_table without the warm-up, a pass with it).
"""

from __future__ import annotations

import threading

_once = threading.Lock()
_initialized = False


def ensure_parquet_initialized() -> None:
    global _initialized
    if _initialized:
        return
    with _once:
        if _initialized:
            return
        try:
            import io

            import pyarrow as pa
            import pyarrow.parquet as pq

            buf = io.BytesIO()
            pq.write_table(pa.table({"_warmup": [1]}), buf)
            pq.read_table(io.BytesIO(buf.getvalue()), use_threads=False)
        except ImportError:
            pass  # no pyarrow: parquet formats are unavailable anyway
        _initialized = True
