"""Message framing (the port's copy of the JAX package's
``formats/framing.py``): a byte stream -> individual messages, newline- or
length-delimited.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional


def frame_iter(data: bytes, framing: Optional[str]) -> Iterator[bytes]:
    """Split one payload into messages. framing: None (whole payload is one
    message) | "newline" | "length" (u32 BE length prefix per message)."""
    if framing is None:
        if data:
            yield data
        return
    if framing == "newline":
        for line in data.split(b"\n"):
            if line.strip():
                yield line
        return
    if framing == "length":
        off = 0
        n = len(data)
        while off + 4 <= n:
            (ln,) = struct.unpack_from(">I", data, off)
            off += 4
            if off + ln > n:
                raise ValueError(
                    f"length-framed message of {ln} bytes overruns payload ({n - off} left)"
                )
            yield data[off : off + ln]
            off += ln
        return
    raise ValueError(f"unknown framing {framing!r} (have: newline, length)")


def frame_join(messages: list[bytes], framing: Optional[str]) -> bytes:
    if framing is None:
        if len(messages) > 1:
            raise ValueError("unframed output can hold only one message")
        return messages[0] if messages else b""
    if framing == "newline":
        return b"\n".join(messages) + (b"\n" if messages else b"")
    if framing == "length":
        return b"".join(struct.pack(">I", len(m)) + m for m in messages)
    raise ValueError(f"unknown framing {framing!r}")
