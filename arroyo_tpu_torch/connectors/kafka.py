"""Kafka connector: source with exactly-once offsets, transactional sink (the
port's copy of arroyo_tpu/connectors/kafka.py): offsets stored in state for
exactly-once reads; a transactional producer with an id per epoch and a
two-phase commit table.

Gated on the `confluent_kafka` package (librdkafka bindings), imported only
where a source runs or a sink starts. The control flow (offset state,
barrier participation, transactional epochs) is implemented here; without
the package, running the operator raises with install instructions, so the
path is exercised only in deployments that install it and is unit-covered
through the _OffsetTracker/_TxnState helpers.
"""

from __future__ import annotations

from typing import Optional

from ..batch import Schema
from ..operators.base import Operator, SourceOperator, TableSpec
from ..types import SourceFinishType
from . import register_sink, register_source


def _auth_conf(cfg: dict) -> dict:
    """librdkafka auth/transport options passed through to the client —
    security.protocol, sasl.*, ssl.* (a Confluent Cloud connection profile
    is exactly bootstrap + SASL_SSL + key/secret). 'librdkafka.<opt>' passes any other
    client option verbatim."""
    out = {}
    for k, v in cfg.items():
        if k.startswith(("security.", "sasl.", "ssl.")):
            out[k] = v
        elif k.startswith("librdkafka."):
            out[k[len("librdkafka."):]] = v
    return out


def _require_kafka():
    try:
        import confluent_kafka  # noqa: F401

        return confluent_kafka
    except ImportError as e:
        raise ImportError(
            "the kafka connector requires the 'confluent_kafka' package "
            "(librdkafka bindings): pip install confluent-kafka"
        ) from e


class _OffsetTracker:
    """Partition -> next offset, merged across restores at any parallelism:
    each subtask owns partitions where partition % parallelism == subtask."""

    def __init__(self):
        self.offsets: dict[int, int] = {}

    def observe(self, partition: int, offset: int) -> None:
        cur = self.offsets.get(partition, -1)
        if offset >= cur:
            self.offsets[partition] = offset + 1

    def resume_position(self, partition: int) -> Optional[int]:
        return self.offsets.get(partition)

    def merge(self, other: dict[int, int]) -> None:
        for p, o in other.items():
            if o > self.offsets.get(p, -1):
                self.offsets[p] = o

    def partitions_for(self, subtask: int, parallelism: int, n_partitions: int) -> list[int]:
        return [p for p in range(n_partitions) if p % parallelism == subtask]


class _TxnState:
    """Transactional-sink bookkeeping: a transactional id per epoch and the
    committing state."""

    def __init__(self, job_id: str, node_id: str, subtask: int):
        self.base = f"arroyo-tpu-{job_id}-{node_id}-{subtask}"
        self.epoch: Optional[int] = None

    def txn_id(self, epoch: int) -> str:
        return f"{self.base}-{epoch}"


class KafkaSource(SourceOperator):
    """config: bootstrap_servers, topic, group_id, schema, format options,
    'source.offset' = earliest|latest."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.topic = str(cfg["topic"])
        self.bootstrap = str(cfg.get("bootstrap_servers", "localhost:9092"))
        self.auto_offset = str(cfg.get("source.offset", "earliest"))

    def tables(self):
        return [TableSpec("k", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        ck = _require_kafka()
        from ..formats.registry import make_deserializer

        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        p = ctx.task_info.parallelism
        tbl = ctx.table_manager.global_keyed("k")
        tracker = _OffsetTracker()
        # union offsets saved by EVERY prior subtask: after a rescale,
        # partitions move between subtasks, so resume positions must come
        # from the whole job's offset map, not this subtask's old entry
        # lint: waive LR204 — a max-merge of offset maps: the order of the subtasks does not matter
        for _old_sub, saved in tbl.items():
            if saved:
                tracker.merge(saved)
        consumer = ck.Consumer({
            # auth first: operator-managed keys stay authoritative — a
            # pass-through enable.auto.commit=true would silently break the
            # state-based exactly-once contract
            **_auth_conf(self.cfg),
            "bootstrap.servers": self.bootstrap,
            "group.id": str(self.cfg.get("group_id", f"arroyo-tpu-{ctx.task_info.job_id}")),
            "enable.auto.commit": False,
            "auto.offset.reset": self.auto_offset,
        })
        meta = consumer.list_topics(self.topic, timeout=10)
        n_parts = len(meta.topics[self.topic].partitions)
        my_parts = tracker.partitions_for(sub, p, n_parts)
        assignments = []
        for part in my_parts:
            pos = tracker.resume_position(part)
            tp = ck.TopicPartition(self.topic, part)
            if pos is not None:
                tp.offset = pos
            assignments.append(tp)
        consumer.assign(assignments)
        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)
        try:
            while True:
                msg = sctx.poll_control()
                if msg is not None:
                    if msg.kind == "checkpoint":
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)
                        tbl.insert(sub, dict(tracker.offsets))
                        sctx.start_checkpoint(msg.barrier)
                        if msg.barrier.then_stop:
                            return SourceFinishType.FINAL
                    elif msg.kind == "stop":
                        return SourceFinishType.IMMEDIATE
                record = consumer.poll(timeout=0.1)
                if record is None:
                    if de.should_flush():
                        b = de.flush()
                        if b is not None:
                            collector.collect(b)
                    continue
                if record.error():
                    continue
                tracker.observe(record.partition(), record.offset())
                ts_type, ts_ms = record.timestamp()
                ts_us = ts_ms * 1000 if ts_type != ck.TIMESTAMP_NOT_AVAILABLE else None
                de.deserialize(record.value(), timestamp_micros=ts_us)
                if de.should_flush():
                    b = de.flush()
                    if b is not None:
                        collector.collect(b)
        finally:
            consumer.close()


class KafkaSink(Operator):
    """config: bootstrap_servers, topic, format options,
    'sink.commit-mode' = at_least_once | exactly_once.

    exactly_once: records buffer in-operator and snapshot into state at the
    barrier (phase 1); the commit phase produces them inside one Kafka
    transaction. A crash between checkpoint and commit restores the buffered
    epoch from state and re-produces it in a fresh transaction — the fenced
    old transaction was aborted by the broker, so the records land exactly
    once. (librdkafka cannot resume a prepared transaction across processes,
    so produce-at-commit is the sound two-phase mapping.)"""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Optional[Schema] = cfg.get("schema")
        self.topic = str(cfg["topic"])
        self.bootstrap = str(cfg.get("bootstrap_servers", "localhost:9092"))
        self.exactly_once = str(cfg.get("sink.commit-mode", "at_least_once")) == "exactly_once"
        self.producer = None
        self.txn: Optional[_TxnState] = None
        self.buf: list[bytes] = []  # exactly-once: payloads since last barrier
        self.pending: dict[int, list[bytes]] = {}  # epoch -> uncommitted payloads

    def tables(self):
        return [TableSpec("p", "global_keyed")]

    def is_committing(self) -> bool:
        return self.exactly_once

    def on_start(self, ctx):
        ck = _require_kafka()
        # auth first: operator-managed keys stay authoritative (matches the
        # consumer's merge order)
        conf = {**_auth_conf(self.cfg), "bootstrap.servers": self.bootstrap}
        if self.exactly_once:
            ti = ctx.task_info
            self.txn = _TxnState(ti.job_id, ti.node_id, ti.subtask_index)
            # stable transactional id: a post-restart producer with the same
            # id fences (and aborts) the zombie from the failed run
            conf["transactional.id"] = self.txn.base
        self.producer = ck.Producer(conf)
        if self.exactly_once:
            self.producer.init_transactions(10)
            saved = ctx.table_manager.global_keyed("p").get(ctx.task_info.subtask_index)
            if saved:
                self.pending = {int(e): list(p) for e, p in saved.get("pending", [])}
                # crash between checkpoint and commit: the old txn was
                # aborted by fencing, so re-produce + commit now
                for epoch in sorted(self.pending):
                    self._commit_epoch(epoch, ctx)

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..formats.registry import serialize_batch

        payloads = serialize_batch(self.cfg, batch, self.schema)
        if self.exactly_once:
            self.buf.extend(payloads)
            return
        for payload in payloads:
            # effect: idempotent — at_least_once mode only (the exactly_once path returned above: it buffers and produces under handle_commit); duplicates on replay are that mode's contract
            self.producer.produce(self.topic, payload)
        self.producer.poll(0)

    def handle_checkpoint(self, barrier, ctx, collector):
        if not self.exactly_once:
            self.producer.flush(30)
            return
        # phase 1: stage this epoch's records durably
        if self.buf:
            self.pending[barrier.epoch] = self.buf
            self.buf = []
        ctx.table_manager.global_keyed("p").insert(
            ctx.task_info.subtask_index,
            {"pending": [(e, list(p)) for e, p in self.pending.items()]},
        )

    def handle_commit(self, epoch, ctx):
        if self.exactly_once:
            self._commit_epoch(epoch, ctx)

    def _marker_path(self, epoch: int, ctx) -> str:
        import os

        from ..state import storage

        ti = ctx.task_info
        d = os.path.join(ctx.table_manager.storage_url, ti.job_id, "commits")
        storage.makedirs(d)
        return os.path.join(d, f"{ti.node_id}-{ti.subtask_index:03d}-{epoch:07d}.done")

    def _commit_epoch(self, epoch: int, ctx) -> None:
        from ..state import storage

        payloads = self.pending.pop(epoch, None)
        if payloads is None:
            return
        if storage.exists(self._marker_path(epoch, ctx)):
            return  # committed in a previous incarnation; don't re-produce
        if payloads:
            self.producer.begin_transaction()
            for p in payloads:
                self.producer.produce(self.topic, p)
            self.producer.commit_transaction(30)
        # durable commit marker NOW (not at the next barrier): a crash after
        # commit_transaction but before the next checkpoint must not
        # re-produce this epoch on restore. (The marker-write itself leaves
        # a sub-millisecond window after broker commit — the unavoidable 2PC
        # residue without broker-side transaction resumption.)
        # markers live on the shared checkpoint store (durable + visible to a
        # worker restarted on another machine), not the local disk
        storage.write_text(self._marker_path(epoch, ctx), "committed")
        ctx.table_manager.global_keyed("p").insert(
            ctx.task_info.subtask_index,
            {"pending": [(e, list(p)) for e, p in self.pending.items()]},
        )

    def on_close(self, ctx, collector):
        if self.producer is None:
            return
        if self.exactly_once:
            # graceful drain: commit whatever remains (idempotence not
            # needed — this is the only writer for these epochs now)
            for epoch in sorted(self.pending):
                self._commit_epoch(epoch, ctx)
            if self.buf:
                self.producer.begin_transaction()
                for p in self.buf:
                    self.producer.produce(self.topic, p)
                self.producer.commit_transaction(30)
                self.buf = []
        self.producer.flush(30)


register_source("kafka")(KafkaSource)
register_sink("kafka")(KafkaSink)
