"""HTTP-family connectors (the port's copy of arroyo_tpu/connectors/
http_conn.py): the SSE source, the polling source and the webhook sink, over
the standard library's http.client / urllib, no gating needed.
"""

from __future__ import annotations

import time
import urllib.request
from collections import deque
from typing import Optional
from urllib.parse import urlparse

from ..batch import Schema
from ..operators.base import Operator, SourceOperator, TableSpec
from ..types import SourceFinishType
from . import register_sink, register_source


def _parse_headers(cfg: dict) -> dict[str, str]:
    out = {}
    raw = cfg.get("headers")
    if isinstance(raw, dict):
        return {str(k): str(v) for k, v in raw.items()}
    if raw:
        for part in str(raw).split(","):
            if ":" in part:
                k, v = part.split(":", 1)
                out[k.strip()] = v.strip()
    return out


class SSESource(SourceOperator):
    """Server-sent events (the eventsource protocol).
    config: endpoint, events (comma-separated filter), headers, schema +
    format options. State: Last-Event-ID for resumption."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.endpoint = str(cfg["endpoint"])
        self.event_filter = {
            e.strip() for e in str(cfg.get("events", "")).split(",") if e.strip()
        } or None
        self.headers = _parse_headers(cfg)

    def tables(self):
        return [TableSpec("e", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        import http.client

        from ..formats.registry import make_deserializer

        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0:
            return SourceFinishType.GRACEFUL
        tbl = ctx.table_manager.global_keyed("e")
        last_id = tbl.get("last_event_id")
        url = urlparse(self.endpoint)
        conn_cls = http.client.HTTPSConnection if url.scheme == "https" else http.client.HTTPConnection
        conn = conn_cls(url.netloc, timeout=10)
        headers = {"Accept": "text/event-stream", **self.headers}
        if last_id:
            headers["Last-Event-ID"] = last_id
        path = url.path + (f"?{url.query}" if url.query else "")
        conn.request("GET", path or "/", headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"SSE endpoint returned {resp.status}")
        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)
        # short socket timeout so control messages are polled between reads
        # (close-delimited responses detach conn.sock -> reach it via resp.fp)
        sock = conn.sock if conn.sock is not None else resp.fp.raw._sock
        sock.settimeout(0.2)

        # own line accumulator over resp.read1 (which applies chunked
        # transfer decoding, unlike reading resp.fp directly) so a timeout
        # mid-line never discards the partial line
        acc = bytearray()
        lines: deque[bytes] = deque()
        stream_done = False
        data_lines: list[str] = []
        event_type = "message"
        while True:
            msg = sctx.poll_control()
            if msg is not None:
                if msg.kind == "checkpoint":
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    if last_id is not None:
                        tbl.insert("last_event_id", last_id)
                    sctx.start_checkpoint(msg.barrier)
                    if msg.barrier.then_stop:
                        return SourceFinishType.FINAL
                elif msg.kind == "stop":
                    return SourceFinishType.IMMEDIATE
            if not lines:
                if stream_done:
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    return SourceFinishType.GRACEFUL
                try:
                    chunk = resp.read1(65536)
                except (TimeoutError, OSError):
                    if de.should_flush():
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)
                    continue
                if not chunk:
                    stream_done = True
                    if acc:
                        lines.append(bytes(acc))
                        acc.clear()
                    continue
                acc += chunk
                while True:
                    nl = acc.find(b"\n")
                    if nl < 0:
                        break
                    lines.append(bytes(acc[:nl]))
                    del acc[: nl + 1]
                continue
            raw = lines.popleft()
            line = raw.decode("utf-8").rstrip("\r")
            if not line:  # dispatch event
                if data_lines and (self.event_filter is None or event_type in self.event_filter):
                    de.deserialize(
                        "\n".join(data_lines),
                        timestamp_micros=int(time.time() * 1e6),
                    )
                    if de.should_flush():
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)
                data_lines = []
                event_type = "message"
                continue
            if line.startswith(":"):
                continue
            field, _, value = line.partition(":")
            value = value.lstrip(" ")
            if field == "data":
                data_lines.append(value)
            elif field == "event":
                event_type = value
            elif field == "id":
                last_id = value


class PollingHTTPSource(SourceOperator):
    """config: endpoint, poll_interval_ms (default 1000), emit_behavior:
    'all' | 'changed' (dedupe identical bodies), method, body, headers,
    framing, schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.endpoint = str(cfg["endpoint"])
        self.interval_s = int(cfg.get("poll_interval_ms", 1000)) / 1000
        self.emit_behavior = str(cfg.get("emit_behavior", "all"))
        self.method = str(cfg.get("method", "GET"))
        self.body = cfg.get("body")
        self.headers = _parse_headers(cfg)
        self.max_polls = cfg.get("testing.max_polls")  # deterministic tests

    # no state tables: this source is non-replayable (no seekable
    # offset), so there is nothing to snapshot

    def run(self, sctx, collector) -> SourceFinishType:
        from ..formats.framing import frame_iter
        from ..formats.registry import default_framing, make_deserializer

        ctx = sctx.ctx
        if ctx.task_info.subtask_index != 0:
            return SourceFinishType.GRACEFUL
        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)
        framing = default_framing(self.cfg) or "newline"
        last_body: Optional[bytes] = None
        polls = 0
        next_poll = time.monotonic()
        while True:
            msg = sctx.poll_control()
            if msg is not None:
                if msg.kind == "checkpoint":
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
                    sctx.start_checkpoint(msg.barrier)
                    if msg.barrier.then_stop:
                        return SourceFinishType.FINAL
                elif msg.kind == "stop":
                    return SourceFinishType.IMMEDIATE
            now = time.monotonic()
            if now < next_poll:
                time.sleep(min(next_poll - now, 0.05))
                continue
            next_poll = now + self.interval_s
            req = urllib.request.Request(
                self.endpoint, method=self.method,
                data=self.body.encode() if self.body else None,
                headers=self.headers,
            )
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    body = resp.read()
            except Exception as exc:
                # transport errors go through the SAME bad_data policy as
                # decode errors — counted and surfaced, never silently eaten
                if de.drop_bad_data(exc):
                    continue
                raise
            if self.emit_behavior == "changed" and body == last_body:
                continue
            last_body = body
            ts = int(time.time() * 1e6)
            for frame in frame_iter(body, framing):
                de.deserialize(frame, timestamp_micros=ts)
            b = de.flush()
            if b is not None:
                collector.collect(b)
            polls += 1
            if self.max_polls is not None and polls >= int(self.max_polls):
                return SourceFinishType.GRACEFUL


class _KeptAlivePost:
    """A kept-alive HTTP/1.1 connection to the webhook's endpoint: each
    message is one POST, in order, and every response must be 2xx (any other
    status raises HTTPError, as urllib's does, redirects included).

    ``post_all`` sends a batch's first message alone. Once the server has
    answered on this connection without closing it, the rest go pipelined,
    up to PIPELINE_MESSAGES (and PIPELINE_BYTES) requests written before
    their responses are read, so a batch costs a round trip per group, not
    per message. A response that closes the connection has its unanswered
    requests sent again on a new one (the server read none of them); a
    connection lost with requests unanswered raises, and the job's restore
    sends the batch again, which is what a failed POST does too. A reused
    connection that the server dropped while idle is opened again once,
    when no byte of a response had arrived; a fresh one is never retried."""

    PIPELINE_MESSAGES = 256
    PIPELINE_BYTES = 64 * 1024

    def __init__(self, endpoint: str, headers: dict, timeout: float = 10.0):
        url = urlparse(endpoint)
        if url.scheme not in ("http", "https"):
            raise ValueError(f"webhook endpoint must be http:// or https://, got {endpoint}")
        self.endpoint = endpoint
        self.tls = url.scheme == "https"
        self.host = url.hostname or "127.0.0.1"
        self.port = url.port or (443 if self.tls else 80)
        self.timeout = timeout
        path = (url.path or "/") + (f"?{url.query}" if url.query else "")
        # the caller's headers override ours whatever their case
        merged = {"host": ("Host", url.netloc),
                  "content-type": ("Content-Type", "application/json")}
        for k, v in headers.items():
            merged[k.lower()] = (k, v)
        merged.pop("content-length", None)
        self.head = (f"POST {path} HTTP/1.1\r\n"
                     + "".join(f"{k}: {v}\r\n" for k, v in merged.values())).encode()
        self.sock = None
        self.buf = b""
        self.persistent = False  # the server kept this connection after a response

    def _connect(self) -> None:
        import socket

        sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.tls:
            import ssl

            sock = ssl.create_default_context().wrap_socket(sock, server_hostname=self.host)
        self.sock, self.buf, self.persistent = sock, b"", False

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock, self.buf, self.persistent = None, b"", False

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("webhook endpoint closed the connection")
        self.buf += chunk

    def _take(self, n: int) -> bytes:
        while len(self.buf) < n:
            self._fill()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            self._fill()
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _response(self) -> bool:
        """Read one whole response; raise unless it is 2xx. Returns whether
        the server keeps the connection."""
        while True:
            version, status, reason = (self._line().decode("latin-1").split(" ", 2) + [""])[:3]
            fields = {}
            while True:
                line = self._line()
                if not line:
                    break
                k, _, v = line.decode("latin-1").partition(":")
                fields[k.strip().lower()] = v.strip()
            if not 100 <= int(status) < 200:
                break
        conn = fields.get("connection", "").lower()
        keep = conn != "close" and (version != "HTTP/1.0" or conn == "keep-alive")
        if "chunked" in fields.get("transfer-encoding", "").lower():
            while True:
                size = int(self._line().split(b";", 1)[0], 16)
                if size == 0:
                    while self._line():  # trailers up to the blank line
                        pass
                    break
                self._take(size + 2)
        elif "content-length" in fields:
            self._take(int(fields["content-length"]))
        elif int(status) not in (204, 304):
            try:  # the body runs to the end of the connection
                while True:
                    self._fill()
            except ConnectionError:
                pass
            keep = False
        if not 200 <= int(status) < 300:
            import urllib.error

            self.close()
            raise urllib.error.HTTPError(self.endpoint, int(status), reason, None, None)
        return keep

    def _request(self, payload: bytes) -> bytes:
        return self.head + b"Content-Length: %d\r\n\r\n" % len(payload) + payload

    def post(self, payload: bytes) -> None:
        """One request alone, its response read before returning."""
        request = self._request(payload)
        reused = self.sock is not None
        if not reused:
            self._connect()
        try:
            self.sock.sendall(request)
            if reused and not self.buf:
                self._fill()  # EOF here: the server dropped the idle connection
        except (ConnectionError, OSError) as e:
            self.close()
            if not reused or isinstance(e, TimeoutError):
                raise
            self._connect()
            self.sock.sendall(request)
        try:
            keep = self._response()
        except BaseException:
            self.close()
            raise
        if keep:
            self.persistent = True
        else:
            self.close()

    def post_all(self, payloads: list) -> None:
        i = 0
        while i < len(payloads):
            if i == 0 or not self.persistent:
                self.post(payloads[i])
                i += 1
                continue
            group, size = [], 0
            while (i + len(group) < len(payloads) and len(group) < self.PIPELINE_MESSAGES
                   and size < self.PIPELINE_BYTES):
                group.append(self._request(payloads[i + len(group)]))
                size += len(group[-1])
            try:
                self.sock.sendall(b"".join(group))
                for _ in group:
                    keep = self._response()
                    i += 1
                    if not keep:
                        self.close()  # the rest of the group goes again
                        break
            except BaseException:
                self.close()
                raise


class WebhookSink(Operator):
    """config: endpoint, headers, format options — POSTs each serialized
    message, over a kept-alive connection (``_KeptAlivePost``)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.endpoint = str(cfg["endpoint"])
        self.headers = _parse_headers(cfg)
        self.schema = cfg.get("schema")
        self.conn: Optional[_KeptAlivePost] = None

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        if self.conn is None:
            self.conn = _KeptAlivePost(self.endpoint, self.headers)
        self.conn.post_all(serialize_batch(self.cfg, batch, self.schema))

    def on_close(self, ctx, collector):
        if self.conn is not None:
            self.conn.close()


register_source("sse")(SSESource)
register_source("polling_http")(PollingHTTPSource)
register_sink("webhook")(WebhookSink)
