"""stdout sink (the port's copy of arroyo_tpu/connectors/stdout.py): each
row as a JSON line on standard output."""

from __future__ import annotations

import sys

from ..formats.json_fmt import serialize_json_lines
from ..operators.base import Operator
from . import register_sink


class StdoutSink(Operator):
    def __init__(self, cfg: dict):
        pass

    def process_batch(self, batch, ctx, collector, input_index=0):
        for line in serialize_json_lines(batch):
            sys.stdout.write(line + "\n")
        sys.stdout.flush()


register_sink("stdout")(StdoutSink)
