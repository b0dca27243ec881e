"""The join probe of the port (arroyo_tpu_torch/ops/join_probe.py and the
plain versions of its kernels K5/K6, ops/join_kernels.py) against
arroyo_tpu/ops/join_probe.py on the same keys, exactly: the plain probe's
(order, lo, hi) equal _probe_jit's byte for byte, dtypes included, and the
expanded (li, ri) pairs equal the reference's in order. The keys are the
edge cases chip_smoke.py holds the CUDA kernels to on the card."""

import numpy as np
import pytest
import torch

import arroyo_tpu_torch.config as tcfg
import chip_smoke
from arroyo_tpu.ops import join_probe as jjp
from arroyo_tpu_torch.ops import join_kernels
from arroyo_tpu_torch.ops import join_probe as tjp

CASES = chip_smoke.join_edge_cases(np.random.default_rng(20261017))
LABELS = [c[0] for c in CASES]


@pytest.fixture(autouse=True)
def _port_config():
    tcfg.reset()
    yield
    tcfg.reset()


def _case(label):
    return next(c for c in CASES if c[0] == label)[1:]


def _padded(keys, cap):
    out = np.full(cap, tjp._SENTINEL, np.int64)
    out[:len(keys)] = keys
    return out


def _plain_probe(lk, rk):
    sk, order = join_kernels.join_sort_pairs(torch.from_numpy(rk))
    lo, hi = join_kernels.join_search_bounds(sk, torch.from_numpy(lk))
    return order.numpy(), lo.numpy(), hi.numpy()


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_plain_probe_matches_probe_jit(label, padded):
    lk, rk = _case(label)
    if padded:
        lk, rk = _padded(lk, tjp._bucket(len(lk))), _padded(rk, tjp._bucket(len(rk)))
    for got, want in zip(_plain_probe(lk, rk), jjp._probe_jit()(lk, rk)):
        _same(got, want)


@pytest.mark.parametrize("label", LABELS)
def test_device_join_start_on_the_cpu_matches_reference(label):
    lk, rk = _case(label)
    li, ri = tjp.device_join_start(lk, rk, "cpu").result()
    jli, jri = jjp.device_join_start(lk, rk).result()
    _same(li, jli)
    _same(ri, jri)
    hli, hri = tjp.host_join_indices(lk, rk)
    jhli, jhri = jjp.host_join_indices(lk, rk)
    _same(hli, jhli)
    _same(hri, jhri)
    # the device path and the host probe give the same pairs in one order
    _same(li, hli)
    _same(ri, hri)


def test_fused_join_indices_match_reference():
    rng = np.random.default_rng(7)
    sizes_l, sizes_r = [0, 5, 300, 1, 40], [3, 0, 500, 2, 77]
    lk = rng.integers(-20, 20, sum(sizes_l)).astype(np.int64)
    rk = rng.integers(-20, 20, sum(sizes_r)).astype(np.int64)
    lb, rb = np.cumsum([0] + sizes_l), np.cumsum([0] + sizes_r)
    for got, want in zip(tjp.fused_join_indices(lk, rk, lb, rb),
                         jjp.fused_join_indices(lk, rk, lb, rb)):
        _same(got, want)
    for got, want in zip(tjp.fused_join_indices(lk[:0], rk[:0], [0, 0], [0, 0]),
                         jjp.fused_join_indices(lk[:0], rk[:0], [0, 0], [0, 0])):
        _same(got, want)


def test_bucket_and_sentinel_match_reference():
    assert tjp._SENTINEL == jjp._SENTINEL
    for n in (0, 1, 63, 64, 65, 2047, 2048, 2049, 92_000, 131_072, 131_073):
        assert tjp._bucket(n) == jjp._bucket(n)


def test_handle_on_the_cpu_is_ready_at_once():
    lk, rk = _case("negative keys")
    h = tjp.device_join_start(lk, rk, torch.device("cpu"))
    assert h.is_ready()


def test_kernels_refuse_meta_tensors_and_bad_dtypes_without_counting():
    join_kernels.reset_launch_counts()
    meta = torch.zeros(64, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        join_kernels.join_sort_pairs(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        join_kernels.join_search_bounds(meta, meta)
    with pytest.raises(TypeError, match="int64"):
        join_kernels.join_sort_pairs(torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        join_kernels.join_sort_pairs(torch.zeros(64, 2, dtype=torch.int64)[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        join_kernels.join_search_bounds(torch.zeros(4, dtype=torch.int64), meta)
    assert join_kernels.launch_counts() == {"join_sort_pairs": 0, "join_search_bounds": 0}
