"""NATS connector: source + sink over a from-scratch client (the port's copy
of arroyo_tpu/connectors/nats.py).

Core NATS is a line-oriented text protocol (INFO/CONNECT/SUB/PUB/MSG/PING/
PONG), spoken here directly over a socket: no client library, so the
connector has no dependency (the websocket and redis connectors do the same).

Delivery: core NATS is at-most-once fan-out with no replay, so the source
checkpoints no offsets (a restore resumes from "now", as a non-JetStream
subscriber does) and the sink is fire-and-forget per row.
"""

from __future__ import annotations

import json
import socket
from typing import Optional

from ..batch import Schema
from ..operators.base import Operator, SourceOperator
from ..types import SourceFinishType
from . import register_sink, register_source


class NatsClient:
    """Minimal core-NATS client: connect, subscribe, publish, read MSGs.

    Received bytes are read at an offset into one buffer, which is cut only
    when more bytes arrive: taking a message copies its payload alone, so a
    subscriber's cost per message does not grow with what is buffered."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4222,
                 timeout: float = 10.0, name: str = "arroyo-tpu"):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        self.pos = 0  # the first unread byte of buf
        info = self._read_line()  # server greeting
        if not info.startswith(b"INFO "):
            raise ConnectionError(f"not a NATS server: {info[:64]!r}")
        self.server_info = json.loads(info[5:])
        self.sock.sendall(
            b"CONNECT " + json.dumps({
                "verbose": False, "pedantic": False, "name": name,
                "lang": "python", "version": "1.0.0", "protocol": 0,
            }).encode() + b"\r\nPING\r\n"
        )
        # drain until PONG so connect errors surface here
        while True:
            line = self._read_line()
            if line == b"PONG":
                break
            if line.startswith(b"-ERR"):
                raise ConnectionError(f"NATS connect rejected: {line.decode()}")

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("NATS connection closed")
        self.buf = self.buf[self.pos:] + chunk
        self.pos = 0

    def _read_line(self) -> bytes:
        while True:
            line = self._peek_line()
            if line is not None:
                self.pos += len(line) + 2
                return line
            self._fill()

    def _peek_line(self) -> Optional[bytes]:
        """Complete line without consuming (so a timeout mid-message never
        loses already-buffered protocol bytes)."""
        end = self.buf.find(b"\r\n", self.pos)
        if end < 0:
            return None
        return self.buf[self.pos:end]

    def subscribe(self, subject: str, sid: str = "1",
                  queue_group: Optional[str] = None) -> None:
        q = f" {queue_group}" if queue_group else ""
        self.sock.sendall(f"SUB {subject}{q} {sid}\r\n".encode())

    def publish(self, subject: str, payload: bytes) -> None:
        self.sock.sendall(
            f"PUB {subject} {len(payload)}\r\n".encode() + payload + b"\r\n"
        )

    def next_msg(self) -> Optional[tuple[str, bytes]]:
        """One protocol op; (subject, payload) for MSG, None otherwise.
        Raises socket.timeout when idle (caller polls control then). The
        buffer is only consumed once a whole op is present, so a timeout
        mid-frame never desyncs the stream."""
        while True:
            buf, pos = self.buf, self.pos
            end = buf.find(b"\r\n", pos)
            if end < 0:
                self._fill()  # raises socket.timeout when idle
                continue
            if buf.startswith(b"MSG ", pos):
                # MSG <subject> <sid> [reply-to] <#bytes>
                n = int(buf[buf.rfind(b" ", pos, end) + 1:end])
                start = end + 2
                if len(buf) < start + n + 2:
                    self._fill()
                    continue
                subject = buf[pos + 4:buf.find(b" ", pos + 4, end)].decode()
                self.pos = start + n + 2
                return subject, buf[start:start + n]
            # non-MSG op: consume the line
            line = buf[pos:end]
            self.pos = end + 2
            if line == b"PING":
                self.sock.sendall(b"PONG\r\n")
            elif line.startswith(b"-ERR"):
                raise ConnectionError(f"NATS error: {line.decode()}")
            return None

    def ping(self) -> None:
        self.sock.sendall(b"PING\r\n")

    def drain_server_ops(self) -> None:
        """Answer pending server PINGs / surface -ERR without blocking —
        write-mostly users (the sink) must still service the link or the
        server declares the connection stale."""
        old = self.sock.gettimeout()
        self.sock.settimeout(0.0)
        try:
            while True:
                line = self._peek_line()
                if line is None:
                    try:
                        self._fill()
                    except (BlockingIOError, TimeoutError, socket.timeout):
                        return
                    continue
                if line.startswith(b"MSG "):
                    return  # subscriber data is the reader loop's business
                self.pos += len(line) + 2
                if line == b"PING":
                    self.sock.sendall(b"PONG\r\n")
                elif line.startswith(b"-ERR"):
                    raise ConnectionError(f"NATS error: {line.decode()}")
        finally:
            self.sock.settimeout(old)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _parse_servers(cfg: dict) -> tuple[str, int]:
    servers = cfg.get("servers", "nats://127.0.0.1:4222")
    first = servers.split(",")[0].strip()
    if "://" in first:
        first = first.split("://", 1)[1]
    host, _, port = first.partition(":")
    return host or "127.0.0.1", int(port or 4222)


class NatsSource(SourceOperator):
    """config: servers ("nats://host:port[,...]"), subject, queue_group
    (optional — NATS-side load balancing across parallel subtasks),
    schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.subject = str(cfg["subject"])
        self.queue_group = cfg.get("queue_group")

    # no state tables: this source is non-replayable (no seekable
    # offset), so there is nothing to snapshot

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0 and not self.queue_group:
            # without a queue group every subscriber sees every message;
            # one subtask reads to avoid duplicates
            return SourceFinishType.GRACEFUL
        host, port = _parse_servers(self.cfg)
        client = NatsClient(host, port)
        client.subscribe(self.subject,
                         sid=str(ctx.task_info.subtask_index + 1),
                         queue_group=self.queue_group)
        client.sock.settimeout(0.2)
        from .broker_base import run_broker_source

        def next_message():
            got = client.next_msg()
            return None if got is None else got[1]

        return run_broker_source(sctx, collector, self.cfg, self.schema,
                                 next_message, client.close,
                                 keepalive=client.ping)


class NatsSink(Operator):
    """config: servers, subject, schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.subject = str(cfg["subject"])
        self.client: Optional[NatsClient] = None

    def on_start(self, ctx):
        host, port = _parse_servers(self.cfg)
        self.client = NatsClient(host, port)

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        assert self.client is not None
        self.client.drain_server_ops()  # answer PINGs, surface -ERR
        for payload in serialize_batch(self.cfg, batch, self.cfg.get("schema")):
            self.client.publish(self.subject, payload)

    def handle_tick(self, ctx, collector):
        # idle sinks must keep the link serviced too, or the server declares
        # it stale after unanswered PINGs
        if self.client is not None:
            self.client.ping()
            self.client.drain_server_ops()

    def tick_interval_micros(self):
        return 20_000_000

    def on_close(self, ctx, collector):
        if self.client is not None:
            self.client.close()


register_source("nats")(NatsSource)
register_sink("nats")(NatsSink)
