"""K1's row-ordered float sums and K5's stable radix sort (the port's
arroyo_tpu_torch/ops/kernels.py and ops/join_kernels.py) on the edge cases
chip_smoke.py holds the CUDA kernels to on the card, through their
wrappers on CPU tensors (their plain versions), against arroyo_tpu on the
same inputs made with numpy from a seed.

Exact: K1 against _build_slot_jax's step / step_merge bit for bit (a
slot's float sums add its rows one after another in row order from the
state value; NaN positions agree, -0.0 and +0.0 are told apart); K5's
order and sorted keys against _probe_jit's stable argsort byte for byte.
Range mode and key_bits < 64 sort transformed keys: they are held to the
reference's argsort of those keys. The wrapper contract (pass counts,
refusals) is checked on meta tensors, which launch nothing."""

import numpy as np
import pytest
import torch

import chip_smoke
from arroyo_tpu.ops import join_probe as jjp
from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import join_kernels, kernels

R = 512
SCATTER = chip_smoke.scatter_edge_cases(np.random.default_rng(20261017), kernels.LONG_RUN)
SORTS = chip_smoke.sort_edge_cases(np.random.default_rng(20261017))


def _assert_lane(got, want, what):
    """Bit for bit; a NaN equals a NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    ib = np.int64 if want.dtype == np.float64 else np.int32
    np.testing.assert_array_equal(got[~nan].view(ib), want[~nan].view(ib), err_msg=what)


def _jax_step(case, slots, merge):
    import jax.numpy as jnp

    kinds = tuple(k for k, _ in case["lanes"])
    dtypes = tuple(d for _, d in case["lanes"])
    step, step_merge, *_ = _build_slot_jax(kinds, dtypes, case["cap"], R)
    shipped = tuple(v for k, v in zip(kinds, case["vals"]) if merge or k != "count")
    js = tuple(jnp.asarray(a) for a in case["state"])
    return (step_merge if merge else step)(js, slots, shipped)


def _port_step(case, slots, merge):
    kinds = [k for k, _ in case["lanes"]]
    ts = [torch.from_numpy(a.copy()) for a in case["state"]]
    kernels.slot_scatter_combine(
        ts, kinds, torch.from_numpy(slots),
        [None if (k == "count" and not merge) else torch.from_numpy(v)
         for k, v in zip(kinds, case["vals"])])
    return ts


@pytest.mark.parametrize("merge", [False, True], ids=["hot", "merge"])
@pytest.mark.parametrize("idx_dt", [np.int32, np.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("label", [c["label"] for c in SCATTER])
def test_scatter_edge_case_matches_jax_step(label, idx_dt, merge):
    case = next(c for c in SCATTER if c["label"] == label)
    slots = case["slots"].astype(idx_dt)
    want = _jax_step(case, slots, merge)
    got = _port_step(case, slots, merge)
    for (k, _d), g, w in zip(case["lanes"], got, want):
        _assert_lane(g.numpy(), w, f"{label}: {k}")


def test_edge_cases_reach_both_walks():
    """The cases hold runs one thread walks and runs a block walks, and
    runs at the threshold and either side of it."""
    lengths = set()
    for case in SCATTER:
        s = case["slots"]
        s = s[(s >= 0) & (s < case["cap"])]
        lengths |= set(np.bincount(s).tolist())
    L = kernels.LONG_RUN
    assert {1, L - 1, L, L + 1} <= lengths and max(lengths) >= 20 * L


@pytest.mark.parametrize("merge", [False, True], ids=["hot", "merge"])
def test_negative_slots_are_dropped_like_padding(merge):
    """K1 drops a slot of -1 as it drops cap, the reference's padding (the
    reference never ships a negative slot; its indexing would wrap one)."""
    case = chip_smoke.negative_slot_case(np.random.default_rng(5), kernels.LONG_RUN)
    slots = case["slots"]
    assert (slots == -1).any()
    want = _jax_step(case, np.where(slots < 0, case["cap"], slots), merge)
    got = _port_step(case, slots, merge)
    for (k, _d), g, w in zip(case["lanes"], got, want):
        _assert_lane(g.numpy(), w, k)


def _sorted_as(keys, mode):
    """The keys K5 sorts in this mode, as the reference would see them."""
    if "range_cap" in mode:
        cap = mode["range_cap"]
        k = keys.astype(np.int64)
        return np.where((k >= 0) & (k < cap), k, cap), True
    if mode.get("key_bits", 64) < 64:
        bits = 8 * join_kernels.sort_passes(mode["key_bits"])
        return keys & ((1 << bits) - 1), False
    return keys, False


@pytest.mark.parametrize("label", [c[0] for c in SORTS])
def test_sort_edge_case_matches_argsort(label):
    _l, keys, mode = next(c for c in SORTS if c[0] == label)
    sort_keys, transformed = _sorted_as(keys, mode)
    order_j = np.asarray(jjp._probe_jit()(sort_keys[:5], sort_keys)[0])
    kt = torch.from_numpy(keys)
    if kt.dtype == torch.int64:
        sk, order = join_kernels.join_sort_pairs(kt, **mode)
    else:  # int32 keys: K1's slots, through the plain version of K5's launch
        sk, order = join_kernels.join_sort_pairs_plain(kt, **mode)
    assert order.dtype == torch.int32 and sk.dtype == torch.int64
    assert order.numpy().tobytes() == order_j.tobytes()
    want = (sort_keys if transformed else keys).astype(np.int64)[order_j]
    assert sk.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("bits", [1, 7, 8, 9, 16, 23, 31, 32, 57, 63, 64])
def test_pass_count_is_one_per_digit(bits):
    assert join_kernels.sort_passes(key_bits=bits) == -(-bits // 8)
    assert join_kernels.sort_bits(key_bits=bits) == bits


@pytest.mark.parametrize("cap", [1, 2, 255, 256, 4096, 65536, 262144, 1 << 22, (1 << 31) - 1])
def test_range_mode_sorts_the_bit_length_of_cap(cap):
    assert join_kernels.sort_bits(range_cap=cap) == cap.bit_length()
    assert join_kernels.sort_passes(range_cap=cap) == -(-cap.bit_length() // 8)


def test_launches_per_call():
    """One launch for at most a tile, else the digit count and one per
    pass: 9 at q8's window, 4 for K1's deployment state (2^22 slots)."""
    sl = join_kernels.sort_launches
    assert [sl(0), sl(1), sl(4096), sl(4097), sl(131072)] == [0, 1, 1, 9, 9]
    assert sl(65536, range_cap=1 << 22) == 4 and sl(65536, range_cap=262144) == 4
    assert sl(10_000, key_bits=16) == 3


@pytest.mark.parametrize("mode,match", [
    ({"range_cap": 0}, "range_cap"), ({"range_cap": -5}, "range_cap"),
    ({"range_cap": 1 << 31}, "range_cap"), ({"key_bits": 0}, "key_bits"),
    ({"key_bits": 65}, "key_bits")])
def test_sort_refuses_bad_modes_on_meta_tensors_without_counting(mode, match):
    join_kernels.reset_launch_counts()
    meta = torch.zeros(64, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match=match):
        join_kernels.join_sort_pairs(meta, **mode)
    with pytest.raises(ValueError, match=match):
        join_kernels.sort_pairs_launch(meta, **mode)
    with pytest.raises(ValueError, match=match):
        join_kernels.sort_passes(**mode)
    assert join_kernels.launch_counts() == {"join_sort_pairs": 0, "join_search_bounds": 0}


def test_sort_takes_good_modes_up_to_the_device_check():
    """A valid mode gets as far as the device check: a meta tensor is
    refused there, and nothing is counted."""
    join_kernels.reset_launch_counts()
    meta = torch.zeros(64, dtype=torch.int64, device="meta")
    for mode in ({}, {"key_bits": 1}, {"range_cap": 1}, {"range_cap": (1 << 31) - 1}):
        with pytest.raises(ValueError, match="unsupported device"):
            join_kernels.join_sort_pairs(meta, **mode)
    assert join_kernels.launch_counts() == {"join_sort_pairs": 0, "join_search_bounds": 0}
