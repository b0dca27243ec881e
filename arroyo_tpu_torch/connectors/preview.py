"""Preview sink: streams output rows back to the controller (the port's
copy of arroyo_tpu/connectors/preview.py).

Reference: the preview connector (crates/arroyo-connectors, preview sink)
whose rows reach the controller via the SendSinkData gRPC and feed the UI's
live results pane. Here rows land in a bounded in-process registry; the
worker main loop / embedded handle drains it into `sink_data` events, which
the JobController persists to the shared DB for the API to serve.
"""

from __future__ import annotations

import threading
from collections import deque

from ..formats.json_fmt import serialize_json_lines
from ..operators.base import Operator
from . import register_sink

_LOCK = threading.Lock()
_OUTPUTS: dict[str, deque] = {}
_CAP = 10_000  # rows retained per job (reference bounds preview output too)


def take_preview_rows(job_id: str) -> list[str]:
    """Drain buffered preview rows (JSON strings) for a job."""
    with _LOCK:
        q = _OUTPUTS.get(job_id)
        if not q:
            return []
        out = list(q)
        q.clear()
        return out


class PreviewSink(Operator):
    """config: rows (optional list collecting parsed rows, used by the
    planner for bare-SELECT results in-process)."""

    def __init__(self, cfg: dict):
        self.rows = cfg.get("rows")  # state: ephemeral — debug sink shares a caller-owned list; at-least-once by contract
        self.schema = cfg.get("schema")

    def process_batch(self, batch, ctx, collector, input_index=0):
        lines = serialize_json_lines(batch, self.schema)
        job = ctx.task_info.job_id
        with _LOCK:
            q = _OUTPUTS.setdefault(job, deque(maxlen=_CAP))
            q.extend(lines)
        if self.rows is not None:
            self.rows.extend(batch.to_pylist())


register_sink("preview")(PreviewSink)
