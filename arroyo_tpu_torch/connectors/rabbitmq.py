"""RabbitMQ connector: source + sink over a from-scratch AMQP 0-9-1 client
(the port's copy of arroyo_tpu/connectors/rabbitmq.py): a queue source and
an exchange sink.

AMQP 0-9-1 is a framed binary protocol (protocol header, then method/
content-header/content-body frames on channels), spoken here directly over
a socket with no client library, as the MQTT and NATS connectors do.

Subset implemented: PLAIN auth handshake (Connection Start/Tune/Open),
channel open, Queue.Declare, Basic.Publish (content header + single body
frame per message), Basic.Consume/Deliver with per-message Basic.Ack, and
heartbeat frames both ways. Delivery is at-least-once: delivery tags are
held keyed by checkpoint epoch and acked only when the engine's COMMIT
control message confirms that epoch's checkpoint is durable (the same
two-phase flow the exactly-once Kafka sink uses) — a crash at any point
before the commit leaves the tags unacked, so the broker redelivers.

Options: host, port (5672), username/password (guest/guest), vhost (/),
queue (source), exchange + routing_key (sink; default exchange when empty).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional

from ..batch import Schema
from ..operators.base import Operator, SourceOperator
from ..types import SourceFinishType
from . import register_sink, register_source

FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8
FRAME_END = 0xCE


def _shortstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">B", len(b)) + b


def _longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


class AmqpClient:
    """Minimal AMQP 0-9-1 client on channel 1."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5672,
                 username: str = "guest", password: str = "guest",
                 vhost: str = "/", timeout: float = 10.0,
                 heartbeat: Optional[int] = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        self.heartbeat = 0
        self.sock.sendall(b"AMQP\x00\x00\x09\x01")
        # Connection.Start
        cid, mid, _args = self._expect_method(10, 10)
        # Start-Ok: client-properties(table) mechanism response locale
        plain = b"\x00" + username.encode() + b"\x00" + password.encode()
        self._send_method(0, 10, 11, _longstr(b"") + _shortstr("PLAIN")
                          + _longstr(plain) + _shortstr("en_US"))
        # Tune; a write-mostly client (the sink) negotiates heartbeat=0 so
        # the broker never expects frames on a quiet stream
        _c, _m, args = self._expect_method(10, 30)
        channel_max, frame_max, hb_server = struct.unpack(">HIH", args[:8])
        self.frame_max = frame_max or 131072
        self.heartbeat = hb_server if heartbeat is None else heartbeat
        self._send_method(0, 10, 31, struct.pack(
            ">HIH", channel_max, self.frame_max, self.heartbeat))
        # Open (vhost, reserved shortstr, reserved bit)
        self._send_method(0, 10, 40, _shortstr(vhost) + _shortstr("") + b"\x00")
        self._expect_method(10, 41)
        # Channel.Open
        self._send_method(1, 20, 10, _shortstr(""))
        self._expect_method(20, 11)
        self._last_sent = time.monotonic()

    # ------------------------------------------------------------- framing

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("AMQP connection closed")
        self.buf += chunk

    def _read_frame(self) -> tuple[int, int, bytes]:
        """(type, channel, payload); raises socket.timeout when idle with
        nothing buffered (partial frames stay buffered, never desync)."""
        while len(self.buf) < 7:
            self._fill()
        ftype, channel, size = struct.unpack(">BHI", self.buf[:7])
        while len(self.buf) < 7 + size + 1:
            self._fill()
        payload = self.buf[7:7 + size]
        if self.buf[7 + size] != FRAME_END:
            raise ConnectionError("AMQP framing error (bad frame-end)")
        self.buf = self.buf[7 + size + 1:]
        return ftype, channel, payload

    def _send_frame(self, ftype: int, channel: int, payload: bytes) -> None:
        self.sock.sendall(struct.pack(">BHI", ftype, channel, len(payload))
                          + payload + bytes([FRAME_END]))
        self._last_sent = time.monotonic()

    def _send_method(self, channel: int, cid: int, mid: int, args: bytes) -> None:
        self._send_frame(FRAME_METHOD, channel, struct.pack(">HH", cid, mid) + args)

    def _expect_method(self, cid: int, mid: int) -> tuple[int, int, bytes]:
        while True:
            ftype, _ch, payload = self._read_frame()
            if ftype == FRAME_HEARTBEAT:
                self._send_frame(FRAME_HEARTBEAT, 0, b"")
                continue
            if ftype != FRAME_METHOD:
                continue
            c, m = struct.unpack(">HH", payload[:4])
            if (c, m) == (10, 50) or (c, m) == (20, 40):  # Connection/Channel.Close
                code = struct.unpack(">H", payload[4:6])[0]
                raise ConnectionError(f"AMQP close: code {code}")
            if (c, m) != (cid, mid):
                continue
            return c, m, payload[4:]

    # ------------------------------------------------------------- methods

    def queue_declare(self, queue: str, durable: bool = False) -> None:
        bits = 0x02 if durable else 0x00
        self._send_method(1, 50, 10, struct.pack(">H", 0) + _shortstr(queue)
                          + bytes([bits]) + _longstr(b""))
        self._expect_method(50, 11)

    def publish(self, exchange: str, routing_key: str, body: bytes) -> None:
        self._send_method(1, 60, 40, struct.pack(">H", 0) + _shortstr(exchange)
                          + _shortstr(routing_key) + b"\x00")
        # content header: class 60, weight 0, body size, no properties
        self._send_frame(FRAME_HEADER, 1,
                         struct.pack(">HHQH", 60, 0, len(body), 0))
        cap = self.frame_max - 8
        for i in range(0, len(body), cap):
            self._send_frame(FRAME_BODY, 1, body[i:i + cap])

    def consume(self, queue: str) -> None:
        # no-local=0 no-ack=0 exclusive=0 no-wait=0
        self._send_method(1, 60, 20, struct.pack(">H", 0) + _shortstr(queue)
                          + _shortstr("") + b"\x00" + _longstr(b""))
        self._expect_method(60, 21)

    def ack(self, delivery_tag: int) -> None:
        self._send_method(1, 60, 80, struct.pack(">QB", delivery_tag, 0))

    def _peek_frame(self, off: int) -> Optional[tuple[int, int, bytes, int]]:
        """Frame at buffer offset ``off`` without consuming:
        (type, channel, payload, next_off), or None when incomplete."""
        if len(self.buf) < off + 7:
            return None
        ftype, channel, size = struct.unpack(">BHI", self.buf[off:off + 7])
        end = off + 7 + size + 1
        if len(self.buf) < end:
            return None
        if self.buf[end - 1] != FRAME_END:
            raise ConnectionError("AMQP framing error (bad frame-end)")
        return ftype, channel, self.buf[off + 7:end - 1], end

    def next_delivery(self) -> Optional[tuple[int, bytes]]:
        """(delivery_tag, body) for one Basic.Deliver, None for other
        protocol traffic; raises socket.timeout when idle. A Deliver's
        method/header/body frame group is consumed ATOMICALLY: nothing is
        taken off the buffer until the whole group is present, so a read
        timeout mid-group never drops a message (at-least-once holds)."""
        got = self._peek_frame(0)
        if got is None:
            self._fill()  # raises socket.timeout when idle
            return None
        ftype, _ch, payload, end = got
        if ftype == FRAME_HEARTBEAT:
            self.buf = self.buf[end:]
            self._send_frame(FRAME_HEARTBEAT, 0, b"")
            return None
        if ftype != FRAME_METHOD:
            self.buf = self.buf[end:]
            return None
        c, m = struct.unpack(">HH", payload[:4])
        if (c, m) == (10, 50) or (c, m) == (20, 40):
            raise ConnectionError("AMQP close from server")
        if (c, m) != (60, 60):  # Basic.Deliver
            self.buf = self.buf[end:]
            return None
        off = 4
        taglen = payload[off]
        off += 1 + taglen  # consumer-tag
        (delivery_tag,) = struct.unpack(">Q", payload[off:off + 8])
        off += 8 + 1  # redelivered bit
        exlen = payload[off]
        off += 1 + exlen  # exchange
        rklen = payload[off]
        off += 1 + rklen  # routing key
        # content header frame (peek; do not consume yet)
        got = self._peek_frame(end)
        if got is None:
            self._fill()
            return None  # whole group still buffered; retry next call
        ftype, _ch, hpayload, end = got
        if ftype != FRAME_HEADER:
            raise ConnectionError("AMQP: expected content header")
        (_cls, _w, body_size) = struct.unpack(">HHQ", hpayload[:12])
        body = b""
        while len(body) < body_size:
            got = self._peek_frame(end)
            if got is None:
                self._fill()
                return None  # retry with more bytes buffered
            ftype, _ch, bpayload, end = got
            if ftype != FRAME_BODY:
                raise ConnectionError("AMQP: expected content body")
            body += bpayload
        self.buf = self.buf[end:]  # consume the whole group at once
        return delivery_tag, body

    def send_heartbeat(self) -> None:
        self._send_frame(FRAME_HEARTBEAT, 0, b"")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _client_from(cfg: dict, heartbeat: Optional[int] = None) -> AmqpClient:
    return AmqpClient(
        host=str(cfg.get("host", "127.0.0.1")),
        port=int(cfg.get("port", 5672)),
        username=str(cfg.get("username", "guest")),
        password=str(cfg.get("password", "guest")),
        vhost=str(cfg.get("vhost", "/")),
        heartbeat=heartbeat,
    )


@register_source("rabbitmq")
class RabbitmqSource(SourceOperator):
    """config: host, port, queue, username/password, vhost,
    schema + format options. Parallel subtasks share the queue: AMQP
    round-robins deliveries across consumers, so every subtask consumes."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.queue = str(cfg["queue"])

    def is_committing(self) -> bool:
        # acks are phase 2 of the checkpoint: the engine must send this
        # source a commit message once the epoch's metadata is durable
        return True

    def run(self, sctx, collector) -> SourceFinishType:
        """Commit-deferred acks: tags collect as messages reach the
        deserializer; a checkpoint barrier moves the batch under its epoch,
        and the batch acks only when the engine's post-checkpoint COMMIT for
        that epoch arrives. A crash mid-checkpoint (barrier seen, metadata
        not yet durable) therefore leaves the tags unacked and the broker
        redelivers after restore — at-least-once holds through the exact
        window where barrier-time acking used to lose data."""
        import socket as _socket
        import time as _time

        from ..faults import InjectedFault, fault_point
        from ..formats.registry import make_deserializer
        from ..utils.retry import Backoff, RetryPolicy, retry_call

        client = _client_from(self.cfg)
        client.queue_declare(self.queue)
        client.consume(self.queue)
        client.sock.settimeout(0.2)
        de = make_deserializer(self.cfg, self.schema,
                               task_info=sctx.ctx.task_info)
        pending_tags: list[int] = []        # delivered since the last barrier
        tags_by_epoch: dict[int, list[int]] = {}  # barrier-taken, ack on commit
        ka_interval = client.heartbeat / 2 if client.heartbeat else 20.0
        last_sent = _time.monotonic()
        poll_backoff = Backoff(RetryPolicy(max_attempts=1 << 30,
                                           base_delay_s=0.05, max_delay_s=1.0))

        def flush():
            b = de.flush()
            if b is not None:
                collector.collect(b)

        def ack_through(epoch: int) -> None:
            """Ack every epoch <= the committed one (a straggling commit for
            an older epoch must not strand its tags forever)."""
            for ep in sorted(e for e in tags_by_epoch if e <= epoch):
                tags = tags_by_epoch.pop(ep)

                def _ack_remaining(_tags=tags, _ep=ep):
                    # tags pop as they ack, so a retry after a mid-batch
                    # failure never double-acks (AMQP closes the channel on
                    # an unknown delivery tag)
                    fault_point("connector.commit", connector="rabbitmq", epoch=_ep)
                    while _tags:
                        client.ack(_tags[0])
                        _tags.pop(0)

                try:
                    retry_call(_ack_remaining, policy=RetryPolicy(max_attempts=4),
                               description=f"rabbitmq ack epoch {ep}")
                except Exception as e:  # noqa: BLE001 - transient exhaustion
                    # keep the leftovers staged: a later commit retries them,
                    # and a crash redelivers them (redelivery > data loss)
                    if tags:
                        tags_by_epoch[ep] = tags
                    if isinstance(e, InjectedFault) and not e.transient:
                        raise  # InjectedCrash: worker-fatal, the task must die

        def await_commit(epoch: int, deadline_s: float = 30.0) -> None:
            """Checkpoint-then-stop: wait for the stopping epoch's commit so
            its tags ack before the connection closes (mirrors the committing
            operator wait in the task run loop)."""
            deadline = _time.monotonic() + deadline_s
            while _time.monotonic() < deadline:
                msg = sctx.poll_control()
                if msg is None:
                    _time.sleep(0.05)
                    continue
                if msg.kind == "stop":
                    # engine abort: the commit will never come — leave the
                    # tags unacked (broker redelivers) and shut down now
                    return
                if msg.kind == "commit" and msg.epoch is not None:
                    ack_through(msg.epoch)
                    if msg.epoch >= epoch:
                        return

        while True:
            if client.heartbeat and _time.monotonic() - last_sent > ka_interval:
                try:
                    client.send_heartbeat()
                except OSError:
                    flush()
                    return SourceFinishType.GRACEFUL
                last_sent = _time.monotonic()
            msg = sctx.poll_control()
            if msg is not None:
                if msg.kind == "checkpoint":
                    flush()
                    # the barrier only STAGES the tags under this epoch; the
                    # broker sees acks when the commit confirms durability
                    if pending_tags:
                        tags_by_epoch.setdefault(
                            msg.barrier.epoch, []).extend(pending_tags)
                        pending_tags = []
                    sctx.start_checkpoint(msg.barrier)
                    if msg.barrier.then_stop:
                        await_commit(msg.barrier.epoch)
                        client.close()
                        return SourceFinishType.FINAL
                elif msg.kind == "commit" and msg.epoch is not None:
                    ack_through(msg.epoch)
                elif msg.kind == "stop":
                    client.close()
                    return SourceFinishType.IMMEDIATE
            try:
                fault_point("connector.poll", connector="rabbitmq", key=self.queue)
                got = client.next_delivery()
                poll_backoff.reset()
            except InjectedFault as e:
                if not e.transient:
                    raise  # InjectedCrash: worker-fatal, the task must die
                _time.sleep(poll_backoff.next_delay())  # transient: retry
                continue
            except (TimeoutError, _socket.timeout):
                if de.should_flush():
                    flush()
                continue
            except ConnectionError:
                flush()
                return SourceFinishType.GRACEFUL
            if got is None:
                continue
            tag, body = got
            pending_tags.append(tag)
            de.deserialize(body, timestamp_micros=int(_time.time() * 1e6))
            if de.should_flush():
                flush()


@register_sink("rabbitmq")
class RabbitmqSink(Operator):
    """config: host, port, exchange ('' = default exchange), routing_key
    (defaults to queue, then ''), queue (declared when using the default
    exchange so publishes land somewhere), format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.exchange = str(cfg.get("exchange", ""))
        self.routing_key = str(cfg.get("routing_key", cfg.get("queue", "")))
        self.client: Optional[AmqpClient] = None

    def on_start(self, ctx):
        # write-mostly connection: disable heartbeats so a quiet input
        # stream cannot get the sink's connection reaped mid-job
        self.client = _client_from(self.cfg, heartbeat=0)
        if not self.exchange and self.cfg.get("queue"):
            # default-exchange publishes route by queue name; make sure the
            # queue exists
            self.client.queue_declare(str(self.cfg["queue"]))

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        if self.client is None:
            self.on_start(ctx)
        for payload in serialize_batch(self.cfg, batch, self.cfg.get("schema")):
            self.client.publish(self.exchange, self.routing_key, payload)

    def on_close(self, ctx, collector):
        if self.client is not None:
            self.client.close()
