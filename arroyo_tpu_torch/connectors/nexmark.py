"""Nexmark benchmark source (the port's copy of
arroyo_tpu/connectors/nexmark.py).

Deterministic and splittable: a whole micro-batch of events is derived from
its event numbers with numpy uint64 lanes (splitmix64 counter RNG), so the
same event number gives the same event as the JAX package's generator.
Subtask i of p owns event numbers n with n % p == i.

Event mix per 50 events: 1 person, 3 auctions, 46 bids, flattened into
presence-flagged column groups ("person.*", "auction.*", "bid.*" with
boolean "person"/"auction"/"bid" presence columns).

Its ``"s"`` table holds each subtask's offset in its own event-number
stream, written at every checkpoint (between batches) and at end of data;
a restored subtask resumes right after it.
"""

from __future__ import annotations

import time

import numpy as np

from ..batch import TIMESTAMP_FIELD, Batch
from ..config import config
from ..hashing import splitmix64
from ..operators.base import SourceOperator, TableSpec
from ..types import SourceFinishType
from . import register_source

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10
PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
BID_PROPORTION = 46
TOTAL_PROPORTION = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION  # 50
HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100

_US_STATES = np.array(["AZ", "CA", "ID", "OR", "WA", "WY"], dtype=object)
_CITIES = np.array(
    ["Phoenix", "Los Angeles", "San Francisco", "Boise", "Portland", "Bend",
     "Redmond", "Seattle", "Kent", "Cheyenne"],
    dtype=object,
)
_CHANNELS = np.array(["Google", "Facebook", "Baidu", "Apple"], dtype=object)


def _rng(n: np.ndarray, salt: int) -> np.ndarray:
    return splitmix64(n ^ np.uint64((salt * 0x9E3779B97F4A7C15 | 1) & ((1 << 64) - 1)))


class NexmarkSource(SourceOperator):
    """config: event_rate (events/s across all subtasks, 0 = unthrottled),
    event_count (total; None = unbounded), first_event_micros,
    inter_event_micros (event-time step; default from event_rate or 1000us),
    bids_only (skip person/auction columns for pure-bid benches: False)."""

    def __init__(self, cfg: dict):
        self.event_rate = cfg.get("event_rate", 0)
        self.event_count = cfg.get("event_count")
        self.first_event_micros = cfg.get("first_event_micros", 1_600_000_000_000_000)
        if cfg.get("inter_event_micros") is not None:
            self.inter_event_micros = cfg["inter_event_micros"]
        elif self.event_rate:
            self.inter_event_micros = max(int(1e6 / self.event_rate), 1)
        else:
            self.inter_event_micros = 1000
        self.include_strings = cfg.get("include_strings", True)
        # projection pushdown: planner-provided set of columns the query
        # reads (presence flags + timestamp always generated); None = all
        self.columns = set(cfg["columns"]) if cfg.get("columns") else None

    def tables(self):
        return [TableSpec("s", "global_keyed")]

    def _generate(self, numbers: np.ndarray) -> Batch:
        """Vectorized event synthesis for the given absolute event numbers.

        ``self.columns`` (planner projection pushdown, like DataFusion's
        projection pushdown into table scans) restricts synthesis to the
        columns a query actually reads; presence flags and the timestamp are
        always produced."""
        n = numbers.astype(np.uint64)
        count = len(n)
        need = self.columns  # None = all
        def want(c):
            return need is None or c in need
        epoch = (n // np.uint64(TOTAL_PROPORTION)).astype(np.int64)
        offset = (n % np.uint64(TOTAL_PROPORTION)).astype(np.int64)
        is_person = offset < PERSON_PROPORTION
        is_auction = (~is_person) & (offset < PERSON_PROPORTION + AUCTION_PROPORTION)
        is_bid = ~(is_person | is_auction)
        ts = self.first_event_micros + n.astype(np.int64) * self.inter_event_micros

        # ids so far (exclusive of current epoch, conservative "active" sets)
        max_person = FIRST_PERSON_ID + epoch * PERSON_PROPORTION
        max_auction = FIRST_AUCTION_ID + epoch * AUCTION_PROPORTION

        r0 = _rng(n, 1)
        r1 = _rng(n, 2)

        auction_id = None
        if want("auction.id") or want("auction.item_name"):
            auction_id = np.where(
                is_auction, FIRST_AUCTION_ID + epoch * AUCTION_PROPORTION + (offset - PERSON_PROPORTION), 0
            ).astype(np.int64)

        cols: dict[str, np.ndarray] = {
            "person": is_person,
            "auction": is_auction,
            "bid": is_bid,
            TIMESTAMP_FIELD: ts,
        }
        if want("event_type"):
            cols["event_type"] = np.where(is_person, 0, np.where(is_auction, 1, 2)).astype(np.int32)
        if want("person.id"):
            cols["person.id"] = np.where(is_person, FIRST_PERSON_ID + epoch, 0).astype(np.int64)
        if auction_id is not None:
            cols["auction.id"] = auction_id
        if want("bid.auction"):
            # bids: hot auctions with ratio 1/HOT of uniform traffic
            recent_window = np.maximum(max_auction - FIRST_AUCTION_ID, 1)
            hot_auction = np.maximum(
                max_auction - 1 - (r0 % np.uint64(HOT_AUCTION_RATIO)).astype(np.int64), FIRST_AUCTION_ID)
            cold_auction = FIRST_AUCTION_ID + (r0.astype(np.int64) % recent_window)
            cols["bid.auction"] = np.where(
                is_bid,
                np.where((r1 % np.uint64(100)).astype(np.int64) < 90, hot_auction, cold_auction),
                0,
            )
        if want("bid.bidder"):
            r2 = _rng(n, 3)
            r3 = _rng(n, 4)
            recent_people = np.maximum(max_person - FIRST_PERSON_ID, 1)
            hot_bidder = np.maximum(
                max_person - 1 - (r2 % np.uint64(HOT_BIDDER_RATIO)).astype(np.int64), FIRST_PERSON_ID)
            cold_bidder = FIRST_PERSON_ID + (r2.astype(np.int64) % recent_people)
            cols["bid.bidder"] = np.where(
                is_bid,
                np.where((r3 % np.uint64(100)).astype(np.int64) < 90, hot_bidder, cold_bidder),
                0,
            )
        if want("bid.price"):
            cols["bid.price"] = np.where(is_bid, (100 + (r1 % np.uint64(9_999_900))).astype(np.int64), 0)
        if want("auction.initial_bid"):
            cols["auction.initial_bid"] = np.where(is_auction, 100 + (r1 % np.uint64(1000)).astype(np.int64), 0)
        if want("auction.reserve"):
            cols["auction.reserve"] = np.where(is_auction, 500 + (_rng(n, 3) % np.uint64(2000)).astype(np.int64), 0)
        if want("auction.expires"):
            cols["auction.expires"] = np.where(
                is_auction, ts + (1 + (_rng(n, 4) % np.uint64(60))).astype(np.int64) * 1_000_000, 0)
        if want("auction.seller"):
            cols["auction.seller"] = np.where(
                is_auction, FIRST_PERSON_ID + (r0.astype(np.int64) % np.maximum(max_person - FIRST_PERSON_ID, 1)), 0
            )
        if want("auction.category"):
            cols["auction.category"] = np.where(is_auction, FIRST_CATEGORY_ID + (r0.astype(np.int64) % 5), 0)
        if want("bid.datetime"):
            cols["bid.datetime"] = np.where(is_bid, ts // 1000, 0)
        if self.include_strings:
            r2s = _rng(n, 3)
            if want("person.name"):
                cols["person.name"] = np.where(
                    is_person, np.char.add("person-", epoch.astype(str)).astype(object), None
                )
            if want("person.email_address"):
                cols["person.email_address"] = np.where(
                    is_person, np.char.add(np.char.add("p", epoch.astype(str)), "@example.com").astype(object), None
                )
            if want("person.city"):
                cols["person.city"] = np.where(is_person, _CITIES[(r1 % np.uint64(len(_CITIES))).astype(np.int64)], None)
            if want("person.state"):
                cols["person.state"] = np.where(is_person, _US_STATES[(r2s % np.uint64(len(_US_STATES))).astype(np.int64)], None)
            if want("auction.item_name"):
                cols["auction.item_name"] = np.where(
                    is_auction, np.char.add("item-", auction_id.astype(str)).astype(object), None
                )
            if want("bid.channel"):
                cols["bid.channel"] = np.where(is_bid, _CHANNELS[(r2s % np.uint64(len(_CHANNELS))).astype(np.int64)], None)
        return Batch(cols)

    def run(self, sctx, collector) -> SourceFinishType:
        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        p = ctx.task_info.parallelism
        tbl = ctx.table_manager.global_keyed("s")
        i = tbl.get(sub, 0)  # index within this subtask's event-number stream
        batch_size = config().get("pipeline.source-batch-size")
        per_task_count = None
        if self.event_count is not None:
            per_task_count = (self.event_count - sub + p - 1) // p
        rate_per_task = self.event_rate / p if self.event_rate else 0
        started = time.monotonic()

        def control():
            msg = sctx.poll_control()
            if msg is None:
                return None
            if msg.kind == "checkpoint":
                tbl.insert(sub, i)
                sctx.start_checkpoint(msg.barrier)
                if msg.barrier.then_stop:
                    return SourceFinishType.FINAL
            elif msg.kind == "stop":
                return SourceFinishType.IMMEDIATE
            return None

        while per_task_count is None or i < per_task_count:
            r = control()
            if r is not None:
                return r
            b = batch_size
            if per_task_count is not None:
                b = min(b, per_task_count - i)
            local = np.arange(i, i + b, dtype=np.uint64)
            numbers = local * np.uint64(p) + np.uint64(sub)
            collector.collect(self._generate(numbers))
            i += b
            if rate_per_task:
                target = started + i / rate_per_task
                while True:
                    delay = target - time.monotonic()
                    if delay <= 0:
                        break
                    r = control()
                    if r is not None:
                        return r
                    time.sleep(min(delay, 0.05))
        # the offset table stays current for the task's "final" snapshot
        tbl.insert(sub, i)
        return SourceFinishType.GRACEFUL


register_source("nexmark")(NexmarkSource)
