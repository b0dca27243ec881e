"""Operator chaining: fuse Forward-edge neighbors into one task (the port's
copy of arroyo_tpu/operators/chained.py).

A chained run collapses per-batch queue hops and thread handoffs: member i's
output flows into member i+1's ``process_batch`` in place. A run marked
compilable at plan time additionally runs its data path as ONE fused kernel
launch per micro-batch (engine/segment.py); this class stays the interpreted
ground truth the compiled path verifies against and falls back to.

There is no coalescing buffer between chain members: only the chain's
terminal collector (the task's real Collector) coalesces, and a watermark
threaded through ChainCollector.broadcast ends at Collector.broadcast, which
flushes pending rows ahead of the signal. State tables (the JAX package's
PrefixedTables) come with the checkpoint slice of the port.
"""

from __future__ import annotations

from typing import Optional

from ..engine.engine import construct_operator, register_operator
from ..graph import OpName
from ..operators.base import Operator, OperatorContext
from ..types import Signal, SignalKind, Watermark


class ChainCollector:
    """Collector handed to chain member i: data flows into member i+1's
    process_batch in place; watermark broadcasts thread through member i+1's
    handle_watermark (so holds and adjustments still apply); other signals
    pass through untouched."""

    def __init__(self, op: Operator, ctx: OperatorContext, next_collector):
        self.op = op
        self.ctx = ctx
        self.next = next_collector

    def collect(self, batch) -> None:
        self.op.process_batch(batch, self.ctx, self.next)

    def broadcast(self, signal: Signal) -> None:
        if signal.kind == SignalKind.WATERMARK:
            self.ctx.last_watermark = signal.watermark
            out = self.op.handle_watermark(signal.watermark, self.ctx, self.next)
            if out is not None:
                self.next.broadcast(Signal.watermark_of(out))
        else:
            self.next.broadcast(signal)


class ChainedOperator(Operator):
    """config: members = [(op_name_value, member_config), ...] in data order;
    compile / compile_reject: the optimizer's plan-time marking."""

    def __init__(self, cfg: dict):
        self.members: list[Operator] = [
            construct_operator(OpName(op), c) for op, c in cfg["members"]
        ]
        # raw member (op, config) pairs + the plan-time compilability
        # marking: engine/segment.py keys its build cache off these
        self.cfg_members: list = list(cfg["members"])
        self.compile_marking: Optional[dict] = cfg.get("compile")
        # plan-time "not compilable: <reason>" (optimizer.chain_graph):
        # runner_for copies it into the task metrics
        self.compile_reject: Optional[str] = cfg.get("compile_reject")
        self._ctxs: Optional[list[OperatorContext]] = None
        self._cols = None
        self._outer = None
        # only members that declared a tick interval get ticked
        self._tickers = [i for i, m in enumerate(self.members)
                         if m.tick_interval_micros() is not None]

    def name(self) -> str:
        return "+".join(m.name() for m in self.members)

    @property
    def late_rows(self) -> int:
        """Chain-wide late-row drops: the members' sum."""
        return sum(int(getattr(m, "late_rows", 0) or 0) for m in self.members)

    def on_start(self, ctx: OperatorContext) -> None:
        self._ctxs = [OperatorContext(ctx.task_info, ctx.device)
                      for _ in range(len(self.members))]
        for i, m in enumerate(self.members):
            m.on_start(self._ctxs[i])

    def _chain_cols(self, collector):
        if self._cols is None or self._outer is not collector:
            cols = [None] * len(self.members)
            nxt = collector
            for i in range(len(self.members) - 1, -1, -1):
                cols[i] = nxt
                if i > 0:
                    nxt = ChainCollector(self.members[i], self._ctxs[i], nxt)
            self._cols = cols
            self._outer = collector
        return self._cols

    def process_batch(self, batch, ctx, collector, input_index=0) -> None:
        cols = self._chain_cols(collector)
        self.members[0].process_batch(batch, self._ctxs[0], cols[0], input_index=input_index)

    def handle_watermark(self, watermark: Watermark, ctx, collector) -> Optional[Watermark]:
        cols = self._chain_cols(collector)
        w: Optional[Watermark] = watermark
        for i, m in enumerate(self.members):
            self._ctxs[i].last_watermark = w
            w = m.handle_watermark(w, self._ctxs[i], cols[i])
            if w is None:
                return None
        return w

    def handle_checkpoint(self, barrier, ctx, collector) -> None:
        cols = self._chain_cols(collector)
        for i, m in enumerate(self.members):
            m.handle_checkpoint(barrier, self._ctxs[i], cols[i])

    def tick_interval_micros(self) -> Optional[int]:
        ticks = [t for m in self.members if (t := m.tick_interval_micros()) is not None]
        return min(ticks) if ticks else None

    def handle_tick(self, ctx, collector) -> None:
        cols = self._chain_cols(collector)
        for i in self._tickers:
            self.members[i].handle_tick(self._ctxs[i], cols[i])

    def on_close(self, ctx, collector) -> None:
        cols = self._chain_cols(collector)
        for i, m in enumerate(self.members):
            m.on_close(self._ctxs[i], cols[i])

    def mesh_stats(self):
        """The sharded store's residency counters of the chain's window
        member, if it has one (the store lives on exactly one member)."""
        for m in self.members:
            fn = getattr(m, "mesh_stats", None)
            if fn is not None:
                stats = fn()
                if stats is not None:
                    return stats
        return None


@register_operator(OpName.CHAINED)
def _make_chained(cfg: dict):
    return ChainedOperator(cfg)
