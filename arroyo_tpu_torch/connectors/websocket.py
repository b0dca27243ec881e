"""WebSocket source with a from-scratch RFC 6455 client (the port's copy of
arroyo_tpu/connectors/websocket.py): an optional subscription message after
connect, over raw sockets (handshake, frame codec, client masking), so it
needs no external package.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import time
from typing import Iterator, Optional
from urllib.parse import urlparse

from ..batch import Schema
from ..operators.base import SourceOperator
from ..types import SourceFinishType
from . import register_source

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    """One FIN frame (fragmentation is not produced, only consumed)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < (1 << 16):
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return head + key + masked
    return head + payload


class FrameReader:
    """Incremental frame decoder (server->client frames are unmasked; a
    masked frame from a misbehaving peer is still unmasked correctly)."""

    def __init__(self):
        self.buf = b""
        self._fragments: list[bytes] = []
        self._frag_opcode: Optional[int] = None

    def feed(self, data: bytes) -> Iterator[tuple[int, bytes]]:
        self.buf += data
        while True:
            frame = self._try_parse()
            if frame is None:
                return
            fin, opcode, payload = frame
            if opcode == 0x0:  # continuation
                self._fragments.append(payload)
                if fin and self._frag_opcode is not None:
                    yield self._frag_opcode, b"".join(self._fragments)
                    self._fragments, self._frag_opcode = [], None
            elif not fin:
                self._fragments = [payload]
                self._frag_opcode = opcode
            else:
                yield opcode, payload

    def _try_parse(self):
        buf = self.buf
        if len(buf) < 2:
            return None
        fin = bool(buf[0] & 0x80)
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        off = 2
        if n == 126:
            if len(buf) < 4:
                return None
            n = struct.unpack(">H", buf[2:4])[0]
            off = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            n = struct.unpack(">Q", buf[2:10])[0]
            off = 10
        key = None
        if masked:
            if len(buf) < off + 4:
                return None
            key = buf[off : off + 4]
            off += 4
        if len(buf) < off + n:
            return None
        payload = buf[off : off + n]
        if key:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        self.buf = buf[off + n :]
        return fin, opcode, payload


def client_handshake(sock: socket.socket, host: str, path: str,
                     headers: Optional[dict] = None) -> bytes:
    """Performs the upgrade; returns any frame bytes that arrived with the
    handshake response."""
    key = base64.b64encode(os.urandom(16)).decode()
    lines = [
        f"GET {path or '/'} HTTP/1.1",
        f"Host: {host}",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Key: {key}",
        "Sec-WebSocket-Version: 13",
    ]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("websocket handshake: connection closed")
        resp += chunk
    head, rest = resp.split(b"\r\n\r\n", 1)
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise ConnectionError(f"websocket handshake rejected: {status.decode()}")
    expect = base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()
    ).decode()
    for line in head.decode().split("\r\n")[1:]:
        k, _, v = line.partition(":")
        if k.strip().lower() == "sec-websocket-accept" and v.strip() != expect:
            raise ConnectionError("websocket handshake: bad accept key")
    # any bytes after the handshake are already frames
    return rest


def accept_handshake(conn: socket.socket) -> None:
    """Server side of the handshake (used by tests and the webhook-style
    receiving end)."""
    req = b""
    while b"\r\n\r\n" not in req:
        chunk = conn.recv(4096)
        if not chunk:
            raise ConnectionError("closed during handshake")
        req += chunk
    key = ""
    for line in req.decode(errors="replace").split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "sec-websocket-key":
            key = v.strip()
    accept = base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
    conn.sendall(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
        ).encode()
    )


class WebSocketSource(SourceOperator):
    """config: endpoint (ws://host:port/path), subscription_message
    (sent once after connect), headers, schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.endpoint = str(cfg["endpoint"])
        self.subscription = cfg.get("subscription_message")

    # no state tables: this source is non-replayable (no seekable
    # offset), so there is nothing to snapshot

    def run(self, sctx, collector) -> SourceFinishType:
        from ..formats.registry import make_deserializer

        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0:
            return SourceFinishType.GRACEFUL
        url = urlparse(self.endpoint)
        if url.scheme not in ("ws", "wss"):
            raise ValueError(f"websocket endpoint must be ws:// or wss://, got {self.endpoint}")
        port = url.port or (443 if url.scheme == "wss" else 80)
        sock = socket.create_connection((url.hostname, port), timeout=10)
        if url.scheme == "wss":
            import ssl

            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=url.hostname
            )
        path = url.path + (f"?{url.query}" if url.query else "")
        from .http_conn import _parse_headers

        leftover = client_handshake(sock, url.netloc, path, _parse_headers(self.cfg))
        reader = FrameReader()
        pending = list(reader.feed(leftover)) if leftover else []
        if self.subscription:
            sock.sendall(encode_frame(OP_TEXT, str(self.subscription).encode(), mask=True))
        sock.settimeout(0.2)
        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)
        while True:
            msg = sctx.poll_control()
            if msg is not None:
                if msg.kind == "checkpoint":
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    sctx.start_checkpoint(msg.barrier)
                    if msg.barrier.then_stop:
                        sock.close()
                        return SourceFinishType.FINAL
                elif msg.kind == "stop":
                    sock.close()
                    return SourceFinishType.IMMEDIATE
            frames = pending
            pending = []
            if not frames:
                try:
                    data = sock.recv(65536)
                except (TimeoutError, socket.timeout):
                    if de.should_flush():
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)
                    continue
                if not data:
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    return SourceFinishType.GRACEFUL
                frames = list(reader.feed(data))
            for opcode, payload in frames:
                if opcode == OP_PING:
                    sock.sendall(encode_frame(OP_PONG, payload, mask=True))
                elif opcode == OP_CLOSE:
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    sock.close()
                    return SourceFinishType.GRACEFUL
                elif opcode in (OP_TEXT, OP_BINARY):
                    de.deserialize(payload, timestamp_micros=int(time.time() * 1e6))
                    if de.should_flush():
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)


register_source("websocket")(WebSocketSource)
