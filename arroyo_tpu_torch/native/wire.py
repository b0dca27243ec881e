"""Columnar wire codec: Batch <-> bytes for the data plane (the port's copy
of arroyo_tpu/native/wire.py; batches are numpy on the host, so nothing
here touches the device).

Plays the role of Arrow IPC in the reference's network manager
(network_manager.rs:279-287 encoded_batch): self-describing little-endian
columnar frames. Layout:

  u32 header_len | header json | per-column payloads (in header order)

header: {"n": rows, "cols": [{"name", "dtype", "nbytes"}, ...]}
String columns serialize as i64 offsets[n+1] + utf-8 arena (None -> offset
pair with sentinel -1 length encoded via a null bitmap appended after the
arena). Signals serialize via a tiny tagged json payload.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..batch import Batch, Field
from ..types import CheckpointBarrier, Signal, SignalKind, Watermark


def encode_batch(batch: Batch) -> bytes:
    header_cols = []
    payloads: list[bytes] = []
    for name, col in batch.columns.items():
        if col.dtype == object:
            offs = np.zeros(len(col) + 1, dtype=np.int64)
            # per-value tag: 0 = utf-8 string, 1 = null, 2 = raw bytes
            tags = np.zeros(len(col), dtype=np.uint8)
            parts = []
            total = 0
            for i, v in enumerate(col):
                if v is None:
                    tags[i] = 1
                    b = b""
                elif isinstance(v, bytes):
                    tags[i] = 2
                    b = v
                else:
                    b = str(v).encode("utf-8")
                parts.append(b)
                total += len(b)
                offs[i + 1] = total
            payload = offs.tobytes() + b"".join(parts) + tags.tobytes()
            header_cols.append({"name": name, "dtype": "string", "nbytes": len(payload)})
            payloads.append(payload)
        else:
            c = np.ascontiguousarray(col)
            payload = c.tobytes()
            header_cols.append({
                "name": name, "dtype": c.dtype.str, "nbytes": len(payload),
            })
            payloads.append(payload)
    header = json.dumps({"n": batch.num_rows, "cols": header_cols}).encode()
    return struct.pack("<I", len(header)) + header + b"".join(payloads)


def decode_batch(data: bytes) -> Batch:
    (hlen,) = struct.unpack_from("<I", data, 0)
    header = json.loads(data[4 : 4 + hlen])
    n = header["n"]
    off = 4 + hlen
    cols: dict[str, np.ndarray] = {}
    for c in header["cols"]:
        payload = data[off : off + c["nbytes"]]
        off += c["nbytes"]
        if c["dtype"] == "string":
            offs = np.frombuffer(payload[: 8 * (n + 1)], dtype=np.int64)
            arena_end = 8 * (n + 1) + int(offs[-1])
            arena = payload[8 * (n + 1) : arena_end]
            tags = np.frombuffer(payload[arena_end : arena_end + n], dtype=np.uint8)
            col = np.empty(n, dtype=object)
            for i in range(n):
                if tags[i] == 1:
                    col[i] = None
                elif tags[i] == 2:
                    col[i] = arena[offs[i] : offs[i + 1]]
                else:
                    col[i] = arena[offs[i] : offs[i + 1]].decode("utf-8")
            cols[c["name"]] = col
        else:
            cols[c["name"]] = np.frombuffer(payload, dtype=np.dtype(c["dtype"])).copy()
    return Batch(cols)


def encode_signal(sig: Signal) -> bytes:
    d: dict = {"kind": sig.kind.value}
    if sig.watermark is not None:
        d["watermark"] = sig.watermark.value
        d["has_wm"] = True
    if sig.barrier is not None:
        b = sig.barrier
        d["barrier"] = [b.epoch, b.min_epoch, b.timestamp, b.then_stop]
    return json.dumps(d).encode()


def decode_signal(data: bytes) -> Signal:
    d = json.loads(data)
    wm = Watermark(d["watermark"]) if d.get("has_wm") else None
    barrier = None
    if "barrier" in d:
        e, m, t, s = d["barrier"]
        barrier = CheckpointBarrier(e, m, t, s)
    return Signal(SignalKind(d["kind"]), watermark=wm, barrier=barrier)
