"""The impulse source of the port (arroyo_tpu_torch/connectors/impulse.py)
against the JAX package's: the same config gives the same batches (columns,
dtypes, values) at every parallelism, and the same rate schedule."""

from __future__ import annotations

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import config as jcfg
from arroyo_tpu.connectors import impulse as jimp
from arroyo_tpu_torch.connectors import impulse as timp


class _Collect:
    def __init__(self):
        self.batches = []

    def collect(self, b):
        self.batches.append(b)


class _TaskInfo:
    def __init__(self, sub, p):
        self.subtask_index, self.parallelism = sub, p
        self.job_id, self.node_id = "impulse", "src"


class _Table:
    def __init__(self):
        self.d = {}

    def get(self, k, default=None):
        return self.d.get(k, default)

    def insert(self, k, v):
        self.d[k] = v


class _Tables:
    def global_keyed(self, name):
        return _Table()


class _Ctx:
    def __init__(self, sub, p):
        self.task_info = _TaskInfo(sub, p)
        self.table_manager = _Tables()


class _SCtx:
    def __init__(self, sub, p):
        self.ctx = _Ctx(sub, p)

    def poll_control(self):
        return None


@pytest.fixture(autouse=True)
def _cfg():
    tcfg.reset()
    yield
    tcfg.reset()


@pytest.mark.parametrize("cfg,batch,p", [
    ({"message_count": 10_000, "interval_micros": 1000, "start_time_micros": 0}, 4096, 1),
    ({"message_count": 777, "interval_micros": 37, "start_time_micros": 5_000}, 100, 3),
    ({"message_count": 2048, "event_rate": 1e9, "start_time_micros": 123}, 512, 2),
])
def test_impulse_batches_equal_jax(cfg, batch, p):
    tcfg.update({"pipeline.source-batch-size": batch})
    jcfg.update({"pipeline.source-batch-size": batch})
    for sub in range(p):
        jout, tout = _Collect(), _Collect()
        assert jimp.ImpulseSource(cfg).run(_SCtx(sub, p), jout).name == \
            timp.ImpulseSource(cfg).run(_SCtx(sub, p), tout).name == "GRACEFUL"
        assert len(jout.batches) == len(tout.batches) > 0
        for jb, tb in zip(jout.batches, tout.batches):
            assert list(jb.columns) == list(tb.columns)
            for name in jb.columns:
                a, b = np.asarray(jb[name]), np.asarray(tb[name])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_rate_phases_schedule_equal_jax():
    spec = "10000x30000,40000"
    assert timp.parse_rate_phases(spec) == jimp.parse_rate_phases(spec)
    assert timp.parse_rate_phases([[100, 5.0], [None, 7.0]]) == \
        jimp.parse_rate_phases([[100, 5.0], [None, 7.0]])
    idx = np.arange(0, 50_000, 7, dtype=np.int64)
    phases = jimp.parse_rate_phases(spec)
    for p in (1, 3):
        np.testing.assert_array_equal(timp._schedule_offsets_us(idx, phases, p),
                                      jimp._schedule_offsets_us(idx, phases, p))
