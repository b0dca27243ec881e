"""Shared poll loop for broker-style sources (NATS, MQTT; the port's copy of
arroyo_tpu/connectors/broker_base.py).

One implementation of the control/checkpoint/flush cycle every broker
connector needs: poll control (checkpoint/stop), pull messages from the
client (up to POLL_EVERY between two polls), feed the deserializer, flush on
batch boundaries and idle timeouts, and send a keepalive on its cadence.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, Optional

from ..types import SourceFinishType

# protocol ops read between two polls of the task's control queue while the
# broker keeps the link busy (an idle link polls at each read timeout)
POLL_EVERY = 64


def run_broker_source(
    sctx,
    collector,
    cfg: dict,
    schema,
    next_message: Callable[[], Optional[bytes]],
    close: Callable[[], None],
    keepalive: Optional[Callable[[], None]] = None,
    keepalive_interval_s: float = 20.0,
) -> SourceFinishType:
    """next_message(): one payload or None (non-message protocol op);
    raises socket.timeout when idle and ConnectionError when the broker is
    gone (treated as end-of-stream: these broker sources are
    non-replayable)."""
    from ..formats.registry import make_deserializer

    de = make_deserializer(cfg, schema, task_info=sctx.ctx.task_info)
    last_sent = time.monotonic()

    def flush():
        b = de.flush()
        if b is not None:
            collector.collect(b)

    while True:
        # keepalive is a CLIENT-to-server obligation (MQTT-3.1.2-24): inbound
        # traffic does not reset the broker's timer, so ping on cadence
        # regardless of how busy the subscription is
        if keepalive is not None and time.monotonic() - last_sent > keepalive_interval_s:
            try:
                keepalive()
            except OSError:
                flush()
                close()
                return SourceFinishType.GRACEFUL
            last_sent = time.monotonic()
        msg = sctx.poll_control()
        if msg is not None:
            if msg.kind == "checkpoint":
                flush()
                sctx.start_checkpoint(msg.barrier)
                if msg.barrier.then_stop:
                    close()
                    return SourceFinishType.FINAL
            elif msg.kind == "stop":
                close()
                return SourceFinishType.IMMEDIATE
        # up to POLL_EVERY protocol ops between control polls: a poll (the
        # task's liveness beat, the collector's timed flush, the profiler's
        # tick, the control queue) costs more than decoding a message
        for _ in range(POLL_EVERY):
            try:
                payload = next_message()
            except (TimeoutError, socket.timeout):
                if de.should_flush():
                    flush()
                break
            except ConnectionError:
                # the broker closed the link: the end of the stream
                flush()
                close()
                return SourceFinishType.GRACEFUL
            if payload is None:
                continue
            de.deserialize(payload, timestamp_micros=int(time.time() * 1e6))
            if de.should_flush():
                flush()
