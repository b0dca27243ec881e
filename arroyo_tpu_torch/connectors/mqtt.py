"""MQTT connector: source + sink over a from-scratch MQTT 3.1.1 client (the
port's copy of arroyo_tpu/connectors/mqtt.py).

The 3.1.1 wire protocol is implemented here directly (CONNECT/CONNACK,
SUBSCRIBE/SUBACK, PUBLISH (+PUBACK for QoS 1), PINGREQ/PINGRESP,
DISCONNECT) over a socket, so the connector has no dependency.

Delivery: MQTT without persistent sessions
is at-most-once from the pipeline's perspective, so the source checkpoints
no offsets (restore resumes from "now"); the sink publishes at the
configured QoS and, for QoS 1, waits for the broker's PUBACK per batch.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional
from urllib.parse import urlparse

from ..batch import Schema
from ..operators.base import Operator, SourceOperator
from ..types import SourceFinishType
from . import register_sink, register_source

CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
SUBSCRIBE, SUBACK = 8, 9
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


def _encode_len(n: int) -> bytes:
    out = bytearray()
    while True:
        d = n % 128
        n //= 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MqttClient:
    """Minimal MQTT 3.1.1 client."""

    def __init__(self, host: str, port: int = 1883, client_id: str = "arroyo-tpu",
                 username: Optional[str] = None, password: Optional[str] = None,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        self._pkt_id = 0
        flags = 0x02  # clean session
        payload = _utf8(client_id)
        if username is not None:
            flags |= 0x80
            payload += _utf8(username)
            if password is not None:
                flags |= 0x40
                payload += _utf8(password)
        var = _utf8("MQTT") + bytes([4, flags]) + struct.pack(">H", 60)  # keepalive
        self._send(CONNECT, 0, var + payload)
        ptype, _fl, body = self._read_packet()
        if ptype != CONNACK or len(body) < 2 or body[1] != 0:
            raise ConnectionError(f"MQTT CONNACK refused: {body!r}")

    # ----------------------------------------------------------------- wire

    def _send(self, ptype: int, flags: int, body: bytes) -> None:
        self.sock.sendall(bytes([(ptype << 4) | flags]) + _encode_len(len(body)) + body)

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("MQTT connection closed")
        self.buf += chunk

    def _read_packet(self) -> tuple[int, int, bytes]:
        """Parse one packet, consuming the buffer only once it is complete —
        a socket timeout mid-packet leaves every buffered byte in place, so
        the stream never desyncs."""
        while True:
            parsed = self._try_parse()
            if parsed is not None:
                return parsed
            self._fill()  # raises socket.timeout when idle

    def _try_parse(self) -> Optional[tuple[int, int, bytes]]:
        buf = self.buf
        if len(buf) < 2:
            return None
        h = buf[0]
        n, mult, i = 0, 1, 1
        while True:
            if i >= len(buf):
                return None
            d = buf[i]
            n += (d & 0x7F) * mult
            i += 1
            if not (d & 0x80):
                break
            if mult > 128 ** 3:
                raise ConnectionError("MQTT malformed remaining length")
            mult *= 128
        if len(buf) < i + n:
            return None
        body = buf[i:i + n]
        self.buf = buf[i + n:]
        return h >> 4, h & 0x0F, body

    def _next_id(self) -> int:
        self._pkt_id = self._pkt_id % 65535 + 1
        return self._pkt_id

    # ------------------------------------------------------------------ ops

    def subscribe(self, topic: str, qos: int = 0) -> None:
        pid = self._next_id()
        self._send(SUBSCRIBE, 0x02, struct.pack(">H", pid) + _utf8(topic) + bytes([qos]))
        ptype, _fl, body = self._read_packet()
        if ptype != SUBACK or body[2] & 0x80:
            raise ConnectionError(f"MQTT SUBACK refused: {body!r}")

    def publish(self, topic: str, payload: bytes, qos: int = 0) -> Optional[int]:
        var = _utf8(topic)
        pid = None
        if qos:
            pid = self._next_id()
            var += struct.pack(">H", pid)
        self._send(PUBLISH, qos << 1, var + payload)
        return pid

    def wait_puback(self, pid: int) -> None:
        while True:
            ptype, _fl, body = self._read_packet()
            if ptype == PUBACK and struct.unpack(">H", body[:2])[0] == pid:
                return
            if ptype == PINGREQ:
                self._send(PINGRESP, 0, b"")

    def next_publish(self) -> Optional[tuple[str, bytes]]:
        """One inbound packet; (topic, payload) for PUBLISH, None otherwise.
        Raises socket.timeout when idle."""
        ptype, flags, body = self._read_packet()
        if ptype == PUBLISH:
            tlen = struct.unpack(">H", body[:2])[0]
            topic = body[2:2 + tlen].decode()
            off = 2 + tlen
            qos = (flags >> 1) & 0x03
            if qos:
                pid = struct.unpack(">H", body[off:off + 2])[0]
                off += 2
                self._send(PUBACK, 0, struct.pack(">H", pid))
            return topic, body[off:]
        if ptype == PINGREQ:
            self._send(PINGRESP, 0, b"")
        return None

    def ping(self) -> None:
        self._send(PINGREQ, 0, b"")

    def close(self) -> None:
        try:
            self._send(DISCONNECT, 0, b"")
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _endpoint(cfg: dict) -> tuple[str, int]:
    url = str(cfg.get("url", "mqtt://127.0.0.1:1883"))
    u = urlparse(url if "://" in url else f"mqtt://{url}")
    return u.hostname or "127.0.0.1", u.port or 1883


class MqttSource(SourceOperator):
    """config: url (mqtt://host:port), topic, qos (0|1), username/password,
    schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.topic = str(cfg["topic"])
        self.qos = int(cfg.get("qos", 0))

    # no state tables: this source is non-replayable (no seekable
    # offset), so there is nothing to snapshot

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0:
            # MQTT subscriptions are fan-out: one reading subtask avoids
            # duplicate delivery (shared subscriptions exist only on MQTT 5
            # brokers)
            return SourceFinishType.GRACEFUL
        host, port = _endpoint(self.cfg)
        client = MqttClient(
            host, port,
            # unique per operator + subtask: duplicate client ids make a
            # compliant broker disconnect the existing session
            client_id=(f"arroyo-{ctx.task_info.job_id[:10]}-"
                       f"{ctx.task_info.node_id[:8]}-{ctx.task_info.subtask_index}"),
            username=self.cfg.get("username"), password=self.cfg.get("password"),
        )
        client.subscribe(self.topic, self.qos)
        client.sock.settimeout(0.2)
        from .broker_base import run_broker_source

        def next_message():
            got = client.next_publish()
            return None if got is None else got[1]

        return run_broker_source(sctx, collector, self.cfg, self.schema,
                                 next_message, client.close,
                                 keepalive=client.ping)


class MqttSink(Operator):
    """config: url, topic, qos (0|1), username/password, schema + format."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.topic = str(cfg["topic"])
        self.qos = int(cfg.get("qos", 0))
        self.client: Optional[MqttClient] = None

    def on_start(self, ctx):
        host, port = _endpoint(self.cfg)
        self.client = MqttClient(
            host, port,
            client_id=f"arroyo-sink-{ctx.task_info.job_id[:10]}-{ctx.task_info.subtask_index}",
            username=self.cfg.get("username"), password=self.cfg.get("password"),
        )

    def drain_inbound(self) -> None:
        """Answer broker PINGREQs between batches without blocking (idle
        sinks must keep the keepalive contract too)."""
        assert self.client is not None
        old = self.client.sock.gettimeout()
        self.client.sock.settimeout(0.0)
        try:
            while True:
                p = self.client._try_parse()
                if p is None:
                    try:
                        self.client._fill()
                    except (BlockingIOError, TimeoutError, socket.timeout):
                        return
                    continue
                ptype, _fl, _body = p
                if ptype == PINGREQ:
                    self.client._send(PINGRESP, 0, b"")
        finally:
            self.client.sock.settimeout(old)

    def handle_tick(self, ctx, collector):
        if self.client is not None:
            self.client.ping()
            self.drain_inbound()

    def tick_interval_micros(self):
        return 20_000_000  # keepalive ping cadence (negotiated 60s)

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        assert self.client is not None
        self.drain_inbound()
        last_pid = None
        for payload in serialize_batch(self.cfg, batch, self.cfg.get("schema")):
            last_pid = self.client.publish(self.topic, payload, self.qos)
        if self.qos and last_pid is not None:
            # batch-level acknowledgement: the broker processes in order, so
            # the last PUBACK covers the batch
            self.client.wait_puback(last_pid)

    def on_close(self, ctx, collector):
        if self.client is not None:
            self.client.close()


register_source("mqtt")(MqttSource)
register_sink("mqtt")(MqttSink)
