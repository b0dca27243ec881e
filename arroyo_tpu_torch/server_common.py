"""Service plumbing: logging init + admin HTTP server.

The port's copy of arroyo_tpu/server_common.py.

Reference: crates/arroyo-server-common/src/lib.rs — init_logging (:53,
json/logfmt/console formats from the [logging] config section) and the
per-service admin HTTP server (:280, default port 5114) exposing /metrics,
/status, /config (heap profiling is jemalloc-specific and has no analog
here).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_START_TIME = time.time()


# event-scope attributes a record may carry (via ``extra=``; the JobEvent
# bridge reads the same names) — emitted by BOTH structured formatters
_EVENT_FIELDS = ("job_id", "node", "subtask", "worker", "epoch")


def _record_fields(formatter: logging.Formatter,
                   record: logging.LogRecord) -> dict:
    """The shared field set both structured formatters render, in order.
    One extraction point means the json and logfmt views of a record can
    never disagree on names or values (unit-tested for parity)."""
    out = {
        "ts": formatter.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
        "level": record.levelname,
        "target": record.name,
        "message": record.getMessage(),
    }
    code = getattr(record, "event_code", None)
    if code is not None:
        out["code"] = str(code)
    for field in _EVENT_FIELDS:
        v = getattr(record, field, None)
        if v is not None:
            out[field] = v
    return out


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = _record_fields(self, record)
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"))


class _LogfmtFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        parts = []
        for k, v in _record_fields(self, record).items():
            if k == "level":
                v = str(v).lower()
            v = str(v)
            # '=' and '\' also force quoting (`msg=retries=3` would parse
            # ambiguously), and newlines must never split a record across
            # physical lines; backslashes escape before quotes do
            if v == "" or any(c in v for c in ' "=\\\n\r'):
                v = ('"' + v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n").replace("\r", "\\r") + '"')
            parts.append(f"{'msg' if k == 'message' else k}={v}")
        return " ".join(parts)


def init_logging(fmt: Optional[str] = None, level: Optional[str] = None,
                 capture_events: Optional[bool] = None) -> None:
    """fmt: console | json | logfmt (config [logging] section analog).

    ``logging.capture-events`` (or capture_events=True) additionally
    installs the JobEvent bridge handler: stdlib records carrying job
    context (``extra={"job_id": ...}``) land in the structured job event
    feed (obs/events.py) next to the engine's own events."""
    from .config import config

    fmt = fmt or config().get("logging.format", "console")
    level = level or config().get("logging.level", "INFO")
    if capture_events is None:
        capture_events = bool(config().get("logging.capture-events"))
    root = logging.getLogger()
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    if fmt == "json":
        handler.setFormatter(_JsonFormatter())
    elif fmt == "logfmt":
        handler.setFormatter(_LogfmtFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"
        ))
    root.addHandler(handler)
    if capture_events:
        from .obs.events import install_bridge

        install_bridge(root)


class AdminServer:
    """Per-process admin endpoint: /metrics (prometheus), /status, /config,
    /debug/pprof/heap (tracemalloc snapshot — the reference serves jemalloc
    heap profiles from the same path, arroyo-server-common/src/lib.rs:257)
    and /debug/threads (py-spy-style stack dump)."""

    def __init__(self, service: str, port: int = 0, host: str = "127.0.0.1"):
        self.service = service
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    from .metrics import registry

                    body = registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/status":
                    body = json.dumps({
                        "service": outer.service,
                        "uptime_s": round(time.time() - _START_TIME, 1),
                        "healthy": True,
                    }).encode()
                    ctype = "application/json"
                elif path == "/config":
                    from .config import config

                    body = json.dumps(config()._data, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/pprof/heap":
                    import tracemalloc

                    q = self.path.split("?", 1)[1] if "?" in self.path else ""
                    if q == "stop":
                        tracemalloc.stop()
                        body = json.dumps({"status": "tracing stopped"}).encode()
                    elif not tracemalloc.is_tracing():
                        # lineno statistics only render one frame, so one is
                        # all we pay for; ?stop disables tracing again
                        tracemalloc.start(1)
                        body = json.dumps({
                            "status": "tracing started; fetch again for a "
                                      "snapshot, ?stop to disable"
                        }).encode()
                    else:
                        snap = tracemalloc.take_snapshot()
                        stats = snap.statistics("lineno")
                        body = json.dumps({
                            "total_kb": round(sum(s_.size for s_ in stats) / 1024, 1),
                            "top": [
                                {"site": str(s_.traceback), "kb": round(s_.size / 1024, 1),
                                 "count": s_.count}
                                for s_ in stats[:50]
                            ],
                        }).encode()
                    ctype = "application/json"
                elif path == "/debug/threads":
                    import sys as _sys
                    import traceback as _tb

                    frames = _sys._current_frames()
                    dump = {}
                    for t in threading.enumerate():
                        f = frames.get(t.ident)
                        if f is not None:
                            # names collide (several admin/prefetch threads)
                            dump[f"{t.name}-{t.ident}"] = _tb.format_stack(f)
                    body = json.dumps(dump).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AdminServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="admin-server"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
