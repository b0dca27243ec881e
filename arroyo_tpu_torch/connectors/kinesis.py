"""Kinesis connector: source + sink over a from-scratch HTTP/JSON client (the
port's copy of arroyo_tpu/connectors/kinesis.py): a shard reader with
per-shard iterators and a PutRecords sink.

Kinesis Data Streams speaks plain HTTP with ``X-Amz-Target:
Kinesis_20131202.<Op>`` JSON bodies and SigV4 request signing, both
implemented here directly (hashlib/hmac) with no boto3, as the NATS, MQTT
and redis connectors speak their protocols.

Options: stream_name, aws_region (default us-east-1), endpoint (override
for tests/localstack), aws_access_key_id / aws_secret_access_key (or the
standard env vars), 'source.offset' = earliest|latest (shard TRIM_HORIZON
vs LATEST). The source checkpoints the last-read sequence number per shard
and resumes AFTER_SEQUENCE_NUMBER.

Shard -> subtask assignment is a STABLE hash of the shard id
(crc32(shard_id) % parallelism, identical on every worker), and every
subtask re-lists shards periodically regardless of its open-shard state:
after a reshard, child shards are picked up by whichever subtask owns them
and an existing open shard can never migrate or double-assign when the
shard list changes (index-mod assignment shifted every surviving shard on
each reshard, silently dropping children and transiently double-reading).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import os
import time
import urllib.error
import urllib.request
import zlib
from typing import Optional

from ..batch import Schema
from ..faults import InjectedFault, fault_point
from ..operators.base import Operator, SourceOperator, TableSpec
from ..types import SourceFinishType
from ..utils.retry import Backoff, RetryPolicy
from . import register_sink, register_source


def shard_owner(shard_id: str, parallelism: int) -> int:
    """Stable shard->subtask assignment: identical across processes and
    restarts (python's hash() is salted per process, so it cannot be used)."""
    return zlib.crc32(shard_id.encode()) % max(parallelism, 1)


class KinesisError(RuntimeError):
    pass


class KinesisClient:
    """Minimal Kinesis Data Streams client: signed JSON POSTs."""

    def __init__(self, region: str = "us-east-1", endpoint: Optional[str] = None,
                 access_key: Optional[str] = None, secret_key: Optional[str] = None,
                 timeout: float = 10.0):
        self.region = region
        self.endpoint = (endpoint or f"https://kinesis.{region}.amazonaws.com").rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "anonymous")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "anonymous")
        self.timeout = timeout
        self.host = self.endpoint.split("://", 1)[1].split("/", 1)[0]

    # ------------------------------------------------------------- signing

    def _sign(self, body: bytes, target: str, amz_date: str) -> str:
        """AWS Signature Version 4 for a kinesis POST /."""
        date_stamp = amz_date[:8]
        payload_hash = hashlib.sha256(body).hexdigest()
        canonical_headers = (
            f"content-type:application/x-amz-json-1.1\nhost:{self.host}\n"
            f"x-amz-date:{amz_date}\nx-amz-target:{target}\n")
        signed_headers = "content-type;host;x-amz-date;x-amz-target"
        canonical_request = (
            f"POST\n/\n\n{canonical_headers}\n{signed_headers}\n{payload_hash}")
        scope = f"{date_stamp}/{self.region}/kinesis/aws4_request"
        string_to_sign = (
            f"AWS4-HMAC-SHA256\n{amz_date}\n{scope}\n"
            + hashlib.sha256(canonical_request.encode()).hexdigest())

        def hm(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(b"AWS4" + self.secret_key.encode(), date_stamp)
        k = hm(k, self.region)
        k = hm(k, "kinesis")
        k = hm(k, "aws4_request")
        sig = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        return (f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={sig}")

    def call(self, op: str, payload: dict) -> dict:
        target = f"Kinesis_20131202.{op}"
        body = json.dumps(payload).encode()
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        req = urllib.request.Request(
            self.endpoint + "/", data=body, method="POST",
            headers={
                "Content-Type": "application/x-amz-json-1.1",
                "X-Amz-Target": target,
                "X-Amz-Date": amz_date,
                "Authorization": self._sign(body, target, amz_date),
            })
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise KinesisError(f"{op} failed: HTTP {e.code}: {detail}") from e
        except urllib.error.URLError as e:
            raise KinesisError(f"{op} failed: {e.reason}") from e

    # ------------------------------------------------------------ wrappers

    def list_shards(self, stream: str) -> list[str]:
        out: list[str] = []
        token: Optional[str] = None
        while True:
            payload: dict = ({"NextToken": token} if token
                             else {"StreamName": stream})
            resp = self.call("ListShards", payload)
            out.extend(s["ShardId"] for s in resp.get("Shards", []))
            token = resp.get("NextToken")
            if not token:
                return out

    def shard_iterator(self, stream: str, shard: str, kind: str,
                       sequence: Optional[str] = None) -> str:
        payload = {"StreamName": stream, "ShardId": shard,
                   "ShardIteratorType": kind}
        if sequence is not None:
            payload["StartingSequenceNumber"] = sequence
        return self.call("GetShardIterator", payload)["ShardIterator"]

    def get_records(self, iterator: str, limit: int = 1000) -> dict:
        return self.call("GetRecords", {"ShardIterator": iterator, "Limit": limit})

    def put_records(self, stream: str, records: list[tuple[bytes, str]],
                    max_retries: int = 8) -> None:
        """Retries ONLY the failed subset on partial failure (per-record
        throttling is routine under load; re-sending the whole batch would
        duplicate the records that already landed). Delays come from the
        shared backoff layer so chaos runs and production behave alike."""
        pending = records
        backoff = Backoff(RetryPolicy(max_attempts=max_retries,
                                      base_delay_s=0.1, max_delay_s=2.0,
                                      jitter=0.2))
        while True:
            resp = self.call("PutRecords", {
                "StreamName": stream,
                "Records": [
                    {"Data": base64.b64encode(data).decode(), "PartitionKey": pk}
                    for data, pk in pending
                ],
            })
            if not int(resp.get("FailedRecordCount", 0)):
                return
            results = resp.get("Records", [])
            pending = [rec for rec, res in zip(pending, results)
                       if res.get("ErrorCode")]
            if not pending:
                return
            if backoff.exhausted():
                raise KinesisError(
                    f"PutRecords: {len(pending)} records still failing after "
                    f"{max_retries} retries")
            time.sleep(backoff.next_delay())


def _client_from(cfg: dict) -> KinesisClient:
    return KinesisClient(
        region=str(cfg.get("aws_region", "us-east-1")),
        endpoint=cfg.get("endpoint"),
        access_key=cfg.get("aws_access_key_id"),
        secret_key=cfg.get("aws_secret_access_key"),
    )


@register_source("kinesis")
class KinesisSource(SourceOperator):
    """config: stream_name, aws_region, endpoint, 'source.offset',
    schema + format options."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.schema: Schema = cfg["schema"]
        self.stream = str(cfg["stream_name"])
        self.offset = str(cfg.get("source.offset", "earliest"))

    def tables(self):
        return [TableSpec("k", "global_keyed")]

    def run(self, sctx, collector) -> SourceFinishType:
        from ..formats.registry import make_deserializer

        ctx = sctx.ctx
        sub = ctx.task_info.subtask_index
        par = ctx.task_info.parallelism
        tbl = ctx.table_manager.global_keyed("k")
        # union sequence numbers from every prior subtask: shards can move
        # between subtasks after a rescale (same rule as the kafka source)
        seqs: dict[str, str] = {}
        for _old_sub, saved in tbl.items():
            if saved:
                seqs.update(saved)
        client = _client_from(self.cfg)
        kind = "TRIM_HORIZON" if self.offset == "earliest" else "LATEST"
        iters: dict[str, Optional[str]] = {}
        mine: list[str] = []
        first_list = True

        def assign_shards() -> None:
            """(Re)list shards and open iterators for newly-owned ones.
            Ownership is the stable crc32 hash, so re-listing NEVER moves a
            shard between subtasks — child shards appear under their owner
            and open shards cannot double-assign during a reshard."""
            nonlocal first_list
            shards = client.list_shards(self.stream)
            mine[:] = sorted(s for s in shards if shard_owner(s, par) == sub)
            for s in mine:
                if s in iters:
                    continue
                if s in seqs:
                    iters[s] = client.shard_iterator(
                        self.stream, s, "AFTER_SEQUENCE_NUMBER", seqs[s])
                else:
                    # the configured LATEST/TRIM_HORIZON offset applies only
                    # to the startup listing; a shard appearing mid-run is a
                    # reshard child whose records must be read from the
                    # start or everything written before discovery is lost
                    iters[s] = client.shard_iterator(
                        self.stream, s, kind if first_list else "TRIM_HORIZON")
            first_list = False

        assign_shards()
        de = make_deserializer(self.cfg, self.schema, task_info=ctx.task_info)

        def flush():
            b = de.flush()
            if b is not None:
                collector.collect(b)

        idle_sleep = float(self.cfg.get("poll_interval_s", 0.2))
        # AWS caps GetRecords at 5 calls/sec/shard: pace each shard
        min_gap = float(self.cfg.get("shard_poll_gap_s", 0.2))
        # every subtask re-lists periodically even while its shards are
        # healthy: a reshard's children otherwise sit unread forever on any
        # subtask that still has open long-lived shards
        reshard_interval = float(self.cfg.get("reshard_interval_s", 5.0))
        last_poll: dict[str, float] = {}
        backoff = Backoff(RetryPolicy(max_attempts=1 << 30, base_delay_s=0.2,
                                      max_delay_s=5.0, jitter=0.25))
        reshard_check = time.monotonic()
        while True:
            msg = sctx.poll_control()
            if msg is not None:
                if msg.kind == "checkpoint":
                    flush()
                    tbl.insert(sub, dict(seqs))
                    sctx.start_checkpoint(msg.barrier)
                    if msg.barrier.then_stop:
                        return SourceFinishType.FINAL
                elif msg.kind == "stop":
                    return SourceFinishType.IMMEDIATE
            got_any = False
            for s in list(mine):
                it = iters.get(s)
                if it is None:
                    continue  # shard closed (reshard); children re-listed below
                now = time.monotonic()
                if now - last_poll.get(s, 0.0) < min_gap:
                    continue
                last_poll[s] = now
                try:
                    fault_point("connector.poll", connector="kinesis", key=s)
                    resp = client.get_records(it)
                    backoff.reset()
                except (KinesisError, InjectedFault) as e:
                    if isinstance(e, InjectedFault) and not e.transient:
                        raise  # InjectedCrash: worker-fatal, the task must die
                    # throttling / transient failure: back off (shared layer)
                    # and refresh the iterator (a >5min outage expires it —
                    # retrying the stale one would wedge the shard forever);
                    # never kill the task over a routine 400
                    time.sleep(backoff.next_delay())
                    try:
                        if s in seqs:
                            iters[s] = client.shard_iterator(
                                self.stream, s, "AFTER_SEQUENCE_NUMBER", seqs[s])
                        else:
                            iters[s] = client.shard_iterator(self.stream, s, kind)
                    except KinesisError:
                        pass  # next sweep retries with the old iterator
                    continue
                iters[s] = resp.get("NextShardIterator")
                for rec in resp.get("Records", []):
                    got_any = True
                    data = base64.b64decode(rec["Data"])
                    seqs[s] = rec["SequenceNumber"]
                    ts = rec.get("ApproximateArrivalTimestamp")
                    ts_us = int(float(ts) * 1e6) if ts else int(time.time() * 1e6)
                    de.deserialize(data, timestamp_micros=ts_us)
                    if de.should_flush():
                        flush()
            all_closed = bool(mine) and all(iters.get(s) is None for s in mine)
            now = time.monotonic()
            # a subtask with nothing open re-lists eagerly (2s); a healthy
            # one still sweeps every reshard_interval for child shards
            if (now - reshard_check
                    > (min(2.0, reshard_interval) if (all_closed or not mine)
                       else reshard_interval)):
                reshard_check = now
                try:
                    assign_shards()
                except KinesisError:
                    pass
            if not got_any:
                if de.should_flush():
                    flush()
                time.sleep(idle_sleep)


@register_sink("kinesis")
class KinesisSink(Operator):
    """config: stream_name, aws_region, endpoint, format options. Rows are
    partitioned by the batch's routing key when present (stable shard
    placement), else round-robin."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.stream = str(cfg["stream_name"])
        self.client: Optional[KinesisClient] = None
        self._rr = 0  # state: ephemeral — round-robin shard spreading for keyless rows; placement is not part of the replay contract (at-least-once sink)

    def on_start(self, ctx):
        self.client = _client_from(self.cfg)

    def process_batch(self, batch, ctx, collector, input_index=0):
        from ..batch import KEY_FIELD
        from ..formats.registry import serialize_batch

        if self.client is None:
            self.on_start(ctx)
        payloads = serialize_batch(self.cfg, batch, self.cfg.get("schema"))
        if KEY_FIELD in batch.columns:
            pks = [str(int(k)) for k in batch.keys]
        else:
            pks = []
            for _ in payloads:
                self._rr += 1
                pks.append(str(self._rr))
        records = list(zip(payloads, pks))
        # PutRecords caps at 500 records per request
        for i in range(0, len(records), 500):
            self.client.put_records(self.stream, records[i:i + 500])
