"""Redis connector: sink + lookup, over a from-scratch RESP client (the
port's copy of arroyo_tpu/connectors/redis.py): a sink with string/list/hash
targets, also usable as a lookup table. RESP2 is a small line protocol,
spoken here directly over a socket, so no client library is needed.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from ..operators.base import Operator
from . import register_sink


class RespClient:
    """Minimal RESP2 client (inline pipelining, no pubsub)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- wire ----------------------------------------------------------------

    @staticmethod
    def encode(*args) -> bytes:
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(f"${len(b)}\r\n".encode())
            out.append(b)
            out.append(b"\r\n")
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2 :]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if t == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"unexpected RESP type {t!r}")

    def command(self, *args):
        with self._lock:
            self.sock.sendall(self.encode(*args))
            return self._read_reply()

    def pipeline(self, commands: list[tuple]) -> list:
        with self._lock:
            self.sock.sendall(b"".join(self.encode(*c) for c in commands))
            return [self._read_reply() for _ in commands]


class RedisSink(Operator):
    """config: host, port, target: 'string'|'list'|'hash', key_prefix,
    key_field (column used as the redis key suffix), format options.
    Rows serialize with the configured format (default json)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.host = str(cfg.get("host", "127.0.0.1"))
        self.port = int(cfg.get("port", 6379))
        self.target = str(cfg.get("target", "string"))
        self.key_prefix = str(cfg.get("key_prefix", ""))
        self.key_field = cfg.get("key_field")
        self.schema = cfg.get("schema")
        self.client: Optional[RespClient] = None

    def tables(self):
        return []

    def on_start(self, ctx):
        self.client = RespClient(self.host, self.port)

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        payloads = serialize_batch(self.cfg, batch, self.schema)
        keys: list[str]
        if self.key_field and self.key_field in batch:
            keys = [f"{self.key_prefix}{v}" for v in batch[self.key_field]]
        else:
            keys = [self.key_prefix or "arroyo-tpu"] * len(payloads)
        cmds = []
        for k, p in zip(keys, payloads):
            if self.target == "string":
                cmds.append(("SET", k, p))
            elif self.target == "list":
                cmds.append(("RPUSH", k, p))
            elif self.target == "hash":
                cmds.append(("HSET", k, "value", p))
            else:
                raise ValueError(f"unknown redis target {self.target!r}")
        if cmds:
            self.client.pipeline(cmds)

    def on_close(self, ctx, collector):
        if self.client:
            self.client.close()


class RedisLookup:
    """Lookup-table side (LookupJoin `connector` object): GET per key,
    values decoded as JSON objects."""

    def __init__(self, cfg: dict):
        self.client = RespClient(
            str(cfg.get("host", "127.0.0.1")), int(cfg.get("port", 6379))
        )
        self.key_prefix = str(cfg.get("key_prefix", ""))

    def lookup(self, keys: list) -> dict:
        import json

        replies = self.client.pipeline(
            [("GET", f"{self.key_prefix}{k}") for k in keys]
        )
        out = {}
        for k, r in zip(keys, replies):
            out[k] = None if r is None else json.loads(r)
        return out


register_sink("redis")(RedisSink)
