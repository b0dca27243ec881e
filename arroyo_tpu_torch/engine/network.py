"""Cross-worker data plane: remote edges over framed TCP (the port's copy
of arroyo_tpu/engine/network.py; plain ``threading`` locks where the JAX
module makes its locks through its lock-order auditor).

Equivalent of crates/arroyo-worker/src/network_manager.rs: Quad-addressed
frames (src_node, src_subtask, dst_node, dst_subtask) multiplexed over one
TCP connection per worker pair, payloads being wire-codec batches or
signals (native/wire.py standing in for Arrow IPC). Backpressure is
end-to-end: the reader blocks on the destination task's bounded inbox,
TCP backpressures the sender (reference network_manager.rs:164-195).

Frame coalescing: encoded DATA frames append to a per-connection
send buffer and one writev-style syscall carries many small batches; any
SIGNAL frame flushes the buffer first (in-line, same ordering guarantee as
the collector's coalescing layer), as does a byte cap or the periodic
flusher. Frame bytes and per-frame ordering are identical to the unbuffered
path — the receiver cannot tell the difference.

The byte transport itself is the C++ host runtime (cpp/arroyo_host.cc
dp_* functions).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

from ..batch import Batch
from ..config import config
from ..faults import InjectedFault, fault_point
from ..native import MSG_DATA, MSG_SIGNAL, DataPlaneConn, DataPlaneListener
from ..native.wire import decode_batch, decode_signal, encode_batch, encode_signal
from ..obs.lockorder import make_lock
from ..types import Signal

# MUST match cpp/arroyo_host.cc FrameHeader (6x uint32: quad, msg_type,
# len) — the coalesced path packs frames host-side so one write carries
# many; tests/test_coalesce.py round-trips python-packed frames through the
# C receiver, so any layout drift fails there before it can desync a stream
_HEADER = struct.Struct("=IIIIII")


class _SendBuffer:
    """Per-connection frame accumulator: many sub-threshold frames, one
    syscall. Writes happen under the conn's send lock so buffered writes
    and any direct ``conn.send`` never interleave mid-frame."""

    def __init__(self, conn: DataPlaneConn, max_bytes: int):
        self.conn = conn
        self.max_bytes = max_bytes
        self._chunks: list[bytes] = []
        self._bytes = 0
        self._lock = make_lock("_SendBuffer._lock")
        self._error: Optional[Exception] = None

    def append(self, quad, mtype: int, payload: bytes, flush: bool) -> None:
        frame = _HEADER.pack(*quad, mtype, len(payload)) + payload
        with self._lock:
            if self._error is not None:
                # latched: once a flush failed the stream is torn mid-frame;
                # every later append must fail too, never buffer-and-drop
                raise self._error
            self._chunks.append(frame)
            self._bytes += len(frame)
            if flush or self._bytes >= self.max_bytes:
                self._flush_locked()

    def flush_pending(self) -> None:
        """Drain whatever is buffered; write errors surface to the next
        sender (the periodic flusher has nobody to raise to)."""
        with self._lock:
            if self._chunks:
                try:
                    self._flush_locked()
                except Exception as e:
                    if self._error is None:  # _flush_locked latched already
                        self._error = e

    def _flush_locked(self) -> None:
        blob = b"".join(self._chunks)
        self._chunks, self._bytes = [], 0
        # the conn send lock is taken INSIDE the buffer lock on purpose:
        # a frame must hit the fd atomically and in append order, so the
        # buffer drains while both are held (direct conn.send callers take
        # only the inner lock — same order, no cycle)
        with self.conn._send_lock:
            view = memoryview(blob)
            while view:
                try:
                    # lint: waive LR403 — deliberate: frame atomicity and append order require writing under both locks; contenders here are exactly the senders whose frames must serialize
                    n = os.write(self.conn.fd, view)
                except OSError as e:
                    # latch HERE, not in flush_pending: the append path also
                    # reaches this point, and a torn stream must poison later
                    # appends no matter which caller hit the error first
                    self._error = ConnectionError(
                        f"data plane write failed: {e}")
                    raise self._error from e
                view = view[n:]


class RemoteDest:
    """Duck-types TaskInbox.put for the Collector: items sent here travel
    over the data plane to the owning worker's real inbox."""

    def __init__(self, manager: "NetworkManager", worker: int,
                 quad: tuple[int, int, int, int]):
        self.manager = manager
        self.worker = worker
        self.quad = quad

    def put(self, input_index: int, item) -> None:
        # input_index is re-derived on the receiving side from the quad;
        # it is carried implicitly (registration maps quad -> flat index)
        # chaos hook: partition raises ConnectionError here (the sending
        # task dies exactly as if the peer vanished); drop/dup/delay model
        # the failure modes a correct protocol must NOT tolerate silently
        verdict = fault_point("network.send", key=f"{self.quad}",
                              worker=self.worker)
        if verdict is not None and verdict[0] == "drop":
            return
        if isinstance(item, Batch):
            payload, mtype = encode_batch(item), MSG_DATA
        elif isinstance(item, Signal):
            payload, mtype = encode_signal(item), MSG_SIGNAL
        else:
            raise TypeError(f"cannot ship {type(item)} over the data plane")
        buf = self.manager.send_buffer_to(self.worker)
        if buf is not None:
            # signals flush in-line: a watermark/barrier frame must never
            # overtake buffered data frames, and never linger behind them
            buf.append(self.quad, mtype, payload, flush=mtype == MSG_SIGNAL)
            if verdict is not None and verdict[0] == "dup":
                buf.append(self.quad, mtype, payload, flush=mtype == MSG_SIGNAL)
            return
        conn = self.manager.conn_to(self.worker)
        conn.send(self.quad, mtype, payload)
        if verdict is not None and verdict[0] == "dup":
            conn.send(self.quad, mtype, payload)


class NetworkManager:
    """Per-worker endpoint: a listener plus lazy outgoing connections."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.listener = DataPlaneListener(host, port)
        self.host = host
        self.port = self.listener.port
        self.peers: dict[int, tuple[str, int]] = {}
        self._out: dict[int, DataPlaneConn] = {}
        self._out_lock = make_lock("NetworkManager._out_lock")
        # quad -> (inbox, flat_input_index)
        # concurrency: single-writer — receivers register during task wiring, before start() spawns readers; a late frame for an unknown quad is dropped by design
        self._receivers: dict[tuple[int, int, int, int], tuple] = {}
        self._accept_thread: Optional[threading.Thread] = None
        self._flush_thread: Optional[threading.Thread] = None
        self._reader_threads: list[threading.Thread] = []
        # concurrency: single-writer — monotonic stop flag set once by close(); a stale read costs one extra loop tick, never correctness
        self._closed = False
        c = config()
        self._coalesce = bool(c.get("engine.coalesce.enabled", True))
        self._co_max_bytes = int(c.get("engine.coalesce.max-bytes", 1 << 20))
        self._co_max_delay_s = float(
            c.get("engine.coalesce.max-delay-ms", 5)) / 1e3
        self._send_bufs: dict[int, _SendBuffer] = {}

    def set_peers(self, peers: dict[int, tuple[str, int]]) -> None:
        self.peers = dict(peers)

    def register_receiver(self, quad: tuple[int, int, int, int], inbox,
                          input_index: int) -> None:
        self._receivers[quad] = (inbox, input_index)

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dp-accept"
        )
        self._accept_thread.start()
        if self._coalesce:
            self._flush_thread = threading.Thread(
                target=self._flush_loop, daemon=True, name="dp-flush"
            )
            self._flush_thread.start()

    def send_buffer_to(self, worker: int) -> Optional[_SendBuffer]:
        """The frame-coalescing buffer for this worker pair (None when
        coalescing is disabled)."""
        if not self._coalesce:
            return None
        with self._out_lock:
            buf = self._send_bufs.get(worker)
        if buf is not None:
            return buf
        conn = self.conn_to(worker)  # dial outside the lock
        with self._out_lock:
            buf = self._send_bufs.get(worker)
            if buf is None:
                buf = _SendBuffer(conn, self._co_max_bytes)
                self._send_bufs[worker] = buf
        return buf

    def _flush_loop(self) -> None:
        """Time-based safety flush: DATA frames not followed by a signal
        (the common flush trigger) still leave within max-delay-ms. Every
        non-empty buffer flushes each tick — an age test on a full-period
        sleep would let a just-missed frame wait ~2x the knob."""
        while not self._closed:
            time.sleep(self._co_max_delay_s)
            with self._out_lock:  # snapshot; flush outside the dict lock
                bufs = list(self._send_bufs.values())
            for buf in bufs:
                buf.flush_pending()

    def conn_to(self, worker: int) -> DataPlaneConn:
        with self._out_lock:
            conn = self._out.get(worker)
        if conn is not None:
            return conn
        # dial outside the lock (LR105): a slow or unreachable peer must not
        # stall every other sender sharing this manager
        host, port = self.peers[worker]
        fresh = DataPlaneConn.connect(host, port)
        with self._out_lock:
            conn = self._out.get(worker)
            if conn is None:
                self._out[worker] = fresh
                return fresh
        fresh.close()  # lost the race; keep the established connection
        return conn

    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self.listener.accept()
            except Exception:  # noqa: BLE001 - listener closed
                return
            t = threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True, name="dp-reader"
            )
            t.start()
            self._reader_threads.append(t)

    def _read_loop(self, conn: DataPlaneConn) -> None:
        while True:
            try:
                got = conn.recv()
            except Exception:  # noqa: BLE001 - peer died; tasks see EOF-less stall
                return
            if got is None:
                return
            quad, mtype, payload = got
            try:
                verdict = fault_point("network.recv", key=f"{quad}", kind=mtype)
            except (InjectedFault, ConnectionError):
                return  # injected receive-side partition: reader dies
            if verdict is not None and verdict[0] == "drop":
                continue
            target = self._receivers.get(quad)
            if target is None:
                continue  # late frame for a finished task
            inbox, input_index = target
            if mtype == MSG_DATA:
                inbox.put(input_index, decode_batch(payload))
            else:
                inbox.put(input_index, decode_signal(payload))

    def close(self) -> None:
        self._closed = True
        self.listener.close()
        with self._out_lock:  # snapshot; drain outside the dict lock
            bufs = list(self._send_bufs.values())
        for buf in bufs:
            # best-effort drain so frames sent just before close still land
            buf.flush_pending()
        with self._out_lock:
            self._send_bufs.clear()
            for conn in self._out.values():
                conn.close()
            self._out.clear()
