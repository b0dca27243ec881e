"""blackhole sink (the port's copy of arroyo_tpu/connectors/blackhole.py):
discards every row and counts them."""

from __future__ import annotations

from ..operators.base import Operator
from . import register_sink


class BlackholeSink(Operator):
    def __init__(self, cfg: dict):
        self.rows_seen = 0  # state: ephemeral — a count of the rows discarded on a throwaway sink; not part of any output contract

    def process_batch(self, batch, ctx, collector, input_index=0):
        self.rows_seen += batch.num_rows


register_sink("blackhole")(BlackholeSink)
