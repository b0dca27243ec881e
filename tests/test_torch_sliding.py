"""The port's SlidingAggregate (arroyo_tpu_torch/windows/sliding.py, state
on the torch device through the slot aggregator) against arroyo_tpu's
(windows/sliding.py, device backend) on the scenarios of
tests/test_sliding.py that need no checkpoint: the same batches and
watermarks go through both operators, and the emitted rows, the forwarded
watermarks and the late-row counts must agree, and equal the closed-form
expectation of tests/test_sliding.py."""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu.batch import Batch as JBatch
from arroyo_tpu.expr import Col as JCol
from arroyo_tpu.types import SignalKind as JSignalKind
from arroyo_tpu.types import Watermark as JWatermark
from arroyo_tpu.windows.sliding import SlidingAggregate as JSliding
from arroyo_tpu_torch.batch import KEY_FIELD, TIMESTAMP_FIELD
from arroyo_tpu_torch.batch import Batch as TBatch
from arroyo_tpu_torch.expr import Col as TCol
from arroyo_tpu_torch.hashing import hash_columns
from arroyo_tpu_torch.operators.base import OperatorContext
from arroyo_tpu_torch.types import SignalKind as TSignalKind
from arroyo_tpu_torch.types import TaskInfo
from arroyo_tpu_torch.types import Watermark as TWatermark
from arroyo_tpu_torch.windows.sliding import SlidingAggregate as TSliding
from test_sliding import expected_sliding


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    tcfg.update({"device.table-capacity": 8192, "device.batch-capacity": 1024,
                 "device.region-size": 512})
    yield
    tcfg.reset()


class _Sink:
    """Collector stand-in: emitted rows and forwarded watermark values."""

    def __init__(self, kind):
        self.kind = kind
        self.rows = []
        self.wms = []

    def collect(self, batch):
        cols = {k: np.asarray(v) for k, v in batch.columns.items()}
        names = sorted(k for k in cols if not k.startswith("_"))
        for i in range(batch.num_rows):
            self.rows.append(tuple((n, getattr(cols[n][i], "item", lambda v=cols[n][i]: v)())
                                   for n in names))

    def broadcast(self, sig):
        assert sig.kind == self.kind.WATERMARK
        self.wms.append(None if sig.watermark.is_idle else sig.watermark.value)


def _cfg(col, width, slide, string_key):
    key = "ks" if string_key else "k"
    return {"width_micros": width, "slide_micros": slide, "key_fields": [key],
            "aggregates": [("cnt", "count", None), ("total", "sum", col("counter"))],
            "input_dtype_of": lambda e: np.dtype(np.int64)}


def _batches(count, interval, batch, string_key, late_at=None):
    """counter c at ts = c * interval, key c % 5; a watermark after each
    batch at its max timestamp; optionally a late batch re-sent at the end."""
    c = np.arange(count, dtype=np.int64)
    k = c % 5
    kcol = np.array([f"key{x}" for x in k], dtype=object) if string_key else k
    out = []
    for lo in range(0, count, batch):
        sl = slice(lo, min(lo + batch, count))
        cols = {"counter": c[sl], TIMESTAMP_FIELD: c[sl] * interval,
                ("ks" if string_key else "k"): kcol[sl], KEY_FIELD: hash_columns([kcol[sl]])}
        out.append(("batch", cols))
        out.append(("wm", int(c[sl][-1] * interval)))
    if late_at is not None:
        sl = slice(late_at, late_at + 7)
        out.append(("batch", {"counter": c[sl], TIMESTAMP_FIELD: c[sl] * interval,
                              ("ks" if string_key else "k"): kcol[sl],
                              KEY_FIELD: hash_columns([kcol[sl]])}))
    return out


def _drive(op, batch_cls, wm_cls, sink, events, ctx):
    for kind, x in events:
        if kind == "batch":
            op.process_batch(batch_cls(dict(x)), ctx, sink)
        else:
            out = op.handle_watermark(wm_cls.event_time(x), ctx, sink)
            if out is not None:
                sink.wms.append(out.value)
    op.on_close(ctx, sink)
    return sink


def _run_both(count=1000, width=1_000_000, slide=250_000, interval=1000, batch=128,
              string_key=False, late_at=None):
    events = _batches(count, interval, batch, string_key, late_at)
    j = JSliding({**_cfg(JCol, width, slide, string_key), "backend": "jax"})
    js = _drive(j, JBatch, JWatermark, _Sink(JSignalKind), events, None)
    t = TSliding(_cfg(TCol, width, slide, string_key))
    t.on_start(OperatorContext(TaskInfo("job", "agg", "sliding_aggregate", 0, 1),
                               torch.device("cpu")))
    ts = _drive(t, TBatch, TWatermark, _Sink(TSignalKind), events, None)
    return j, js, t, ts


def _windows(sink, key="k"):
    out = {}
    for row in sink.rows:
        r = dict(row)
        out[(r["window_start"], r[key])] = (r["cnt"], r["total"])
    assert len(out) == len(sink.rows), "a window was emitted twice"
    return out


@pytest.mark.parametrize("width,slide", [(1_000_000, 250_000), (1_000_000, 1_000_000),
                                         (2_000_000, 500_000)])
def test_sliding_count_sum_matches_jax_and_closed_form(width, slide):
    j, js, t, ts = _run_both(width=width, slide=slide)
    assert sorted(ts.rows) == sorted(js.rows)
    assert ts.wms == js.wms
    assert _windows(ts) == expected_sliding(1000, width, slide)


def test_sliding_incremental_emission_matches_jax():
    """Windows close as the watermark passes them, not only at the end."""
    events = _batches(1000, 1000, 128, False)
    t = TSliding(_cfg(TCol, 1_000_000, 250_000, False))
    t.on_start(OperatorContext(TaskInfo("job", "agg", "sliding_aggregate", 0, 1),
                               torch.device("cpu")))
    sink = _Sink(TSignalKind)
    for kind, x in events:
        if kind == "batch":
            t.process_batch(TBatch(dict(x)), None, sink)
        else:
            out = t.handle_watermark(TWatermark.event_time(x), None, sink)
            if out is not None:
                sink.wms.append(out.value)
    t._drain(sink, force=True)
    before_close = len(sink.rows)
    assert before_close > 0
    t.on_close(None, sink)
    assert len(sink.rows) > before_close
    assert _windows(sink) == expected_sliding(1000, 1_000_000, 250_000)


def test_sliding_string_keys_match_jax():
    """A string group-by key goes through the host KeyDictionary."""
    j, js, t, ts = _run_both(string_key=True)
    assert t.dict_key_fields == ["ks"] and j.dict_key_fields == ["ks"]
    assert sorted(ts.rows) == sorted(js.rows)
    want = {(s, f"key{k}"): v for (s, k), v in expected_sliding(1000, 1_000_000, 250_000).items()}
    assert _windows(ts, key="ks") == want


def test_sliding_late_rows_are_dropped_like_jax():
    j, js, t, ts = _run_both(late_at=10)
    assert t.late_rows == j.late_rows == 7
    assert sorted(ts.rows) == sorted(js.rows)
    assert _windows(ts) == expected_sliding(1000, 1_000_000, 250_000)


def test_width_must_be_multiple_of_slide():
    for cls, col in ((TSliding, TCol), (JSliding, JCol)):
        with pytest.raises(ValueError, match="multiple"):
            cls(_cfg(col, 1_000_000, 300_000, False))


def _settle(op):
    """Wait until every in-flight window close has landed. Both packages
    collapse consecutive held watermarks while a close is in flight, so
    without this the forwarded watermark sequence depends on how fast the
    prefetch threads finish."""
    for fut, *_rest in list(op._pending):
        if fut is not None:
            fut.result()


def test_tumbling_insert_paths_share_late_handling_with_jax():
    """The tumbling window's two insert paths, process_batch and the
    compiled segment's insert_arrays, drop the same late rows and emit the
    same windows as arroyo_tpu's TumblingAggregate.process_batch."""
    from arroyo_tpu.windows.tumbling import TumblingAggregate as JTumbling
    from arroyo_tpu_torch.windows.tumbling import TumblingAggregate as TTumbling

    def cfg(col):
        return {"width_micros": 250_000, "key_fields": ["k"],
                "aggregates": [("cnt", "count", None), ("total", "sum", col("counter"))],
                "input_dtype_of": lambda e: np.dtype(np.int64), "backend": "jax"}

    events = _batches(1000, 1000, 128, False, late_at=10)
    sinks = []
    for path in ("jax", "process_batch", "insert_arrays"):
        if path == "jax":
            op, bcls, wcls, kind = JTumbling(cfg(JCol)), JBatch, JWatermark, JSignalKind
        else:
            op, bcls, wcls, kind = TTumbling(cfg(TCol)), TBatch, TWatermark, TSignalKind
            op.on_start(OperatorContext(TaskInfo("job", "agg", "tumbling_aggregate", 0, 1),
                                        torch.device("cpu")))
        sink = _Sink(kind)
        for ev, x in events:
            _settle(op)
            if ev == "wm":
                out = op.handle_watermark(wcls.event_time(x), None, sink)
                if out is not None:
                    sink.wms.append(out.value)
            elif path != "insert_arrays":
                op.process_batch(bcls(dict(x)), None, sink)
            else:
                if op.lane_key_fields is None:
                    op._setup_key_transport(bcls(dict(x)))
                vals = [np.ones(len(x["counter"]), dtype=np.int64), x["counter"],
                        x["k"].astype(np.int64)]
                op.insert_arrays(x[KEY_FIELD], x[TIMESTAMP_FIELD] // 250_000, vals, sink)
        op.on_close(None, sink)
        sinks.append((op.late_rows, sorted(sink.rows), sink.wms))
    assert sinks[0][0] == 7
    assert sinks[1] == sinks[0] and sinks[2] == sinks[0]
