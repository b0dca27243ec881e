"""K2's read-and-clear mode (arroyo_tpu_torch/ops/kernels.py
``slot_region_read_pack(..., clear_kinds=...)``) through its wrapper on CPU
tensors, i.e. its plain PyTorch version, against arroyo_tpu's
``make_read_multi(k, do_clear=True)`` (``_build_slot_jax(...)[2]``) on the
same inputs made with numpy from a seed: the packed buffers and the state
after, exactly (floats as bits, a NaN equal to a NaN).

Also: a SlotAggregator's destructive close takes that one call and never
K3's wrapper; overlapping distinct bases are refused in the clear mode;
and a numpy model of the kernel's walk of a region in quads of four slots
(csrc/slot_agg.cu region_kernel) covers every slot of the region once,
whatever the base's alignment."""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.slot_agg import SlotAggregator as JaxAggregator
from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import kernels
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator

CAP = 4096
R = 256
KINDS = ("sum", "count", "min", "max")
ALL_LANES = tuple((k, d) for d in (np.int32, np.int64, np.uint64, np.float32, np.float64)
                  for k in KINDS)
LANE_SETS = {
    "all": ALL_LANES,
    "int_only": (("count", np.int64), ("max", np.int32), ("min", np.uint64)),
    "float_only": (("sum", np.float64), ("min", np.float32), ("max", np.float64)),
}


def _ident(kind, dt):
    dt = np.dtype(dt)
    if kind in ("sum", "count"):
        return dt.type(0)
    if np.issubdtype(dt, np.integer):
        return dt.type(np.iinfo(dt).max if kind == "min" else np.iinfo(dt).min)
    return dt.type(np.inf if kind == "min" else -np.inf)


def _lane(rng, kind, dt):
    """The identity on a quarter of the slots, values elsewhere: both ends
    of a uint64's range, signed zeros and NaNs in a float lane."""
    dt = np.dtype(dt)
    if dt == np.uint64:
        v = (rng.integers(-1000, 1000, CAP).astype(np.int64) << 50).view(np.uint64)
    elif np.issubdtype(dt, np.integer):
        v = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, CAP, dtype=dt, endpoint=True)
    else:
        v = rng.normal(0, 100, CAP).astype(dt)
        pick = rng.random(CAP)
        v[pick < 0.05] = -0.0
        v[(pick >= 0.05) & (pick < 0.10)] = np.nan
    v[rng.random(CAP) < 0.25] = _ident(kind, dt)
    return v


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert got[~nan].tobytes() == want[~nan].tobytes()
    else:
        assert got.tobytes() == want.tobytes()


def _pair(rng, lanes):
    import jax.numpy as jnp

    kinds = tuple(k for k, _ in lanes)
    dtypes = tuple(d for _, d in lanes)
    host = [_lane(rng, k, d) for k, d in lanes]
    return kinds, dtypes, tuple(jnp.asarray(h) for h in host), [torch.from_numpy(h.copy())
                                                                 for h in host]


@pytest.mark.parametrize("lanes", list(LANE_SETS), ids=list(LANE_SETS))
@pytest.mark.parametrize("k,n_real", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 3), (8, 2), (8, 5),
                                      (16, 1), (16, 9), (16, 16)])
def test_read_and_clear_matches_make_read_multi(lanes, k, n_real):
    """k bases, the tail padded by duplicating bases[0] as the aggregator
    does: every position's buffer holds its region as it was before any
    clear, and every real region is cleared after."""
    rng = np.random.default_rng(k * 100 + n_real * 7 + len(LANE_SETS[lanes]))
    kinds, dtypes, js, ts = _pair(rng, LANE_SETS[lanes])
    real = list(rng.choice(CAP // R, n_real, replace=False) * R)
    bases = np.array(real + [real[0]] * (k - n_real), dtype=np.int64)
    js, ib, fb = _build_slot_jax(kinds, dtypes, CAP, R)[2](k, True)(js, bases)
    kernels.reset_launch_counts()
    tib, tfb = kernels.slot_region_read_pack(ts, bases, R, clear_kinds=kinds)
    assert tib.dtype == torch.int64 and tfb.dtype == torch.float64
    _same(tib.numpy(), ib)
    _same(tfb.numpy(), fb)
    for j, t in zip(js, ts):
        _same(t.numpy(), j)
    assert kernels.launch_counts()["slot_region_read_pack_clear"] == 0  # the CPU runs no kernel


def test_unaligned_bases_and_size():
    """Bases and R that leave a region off every 16-byte boundary: the
    plain version still equals the reference (the kernel takes such a
    region's ends slot by slot; chip_smoke.py holds it there on the card)."""
    rng = np.random.default_rng(77)
    kinds, dtypes, js, ts = _pair(rng, ALL_LANES)
    r = 253
    bases = np.array([1, 3 * r + 2, 7 * r + 3, 1], dtype=np.int64)
    js, ib, fb = _build_slot_jax(kinds, dtypes, CAP, r)[2](4, True)(js, bases)
    tib, tfb = kernels.slot_region_read_pack(ts, bases, r, clear_kinds=kinds)
    _same(tib.numpy(), ib)
    _same(tfb.numpy(), fb)
    for j, t in zip(js, ts):
        _same(t.numpy(), j)


def test_overlapping_bases_are_refused_in_the_clear_mode_without_counting():
    st = [torch.zeros(64, dtype=torch.int64), torch.zeros(64, dtype=torch.float64)]
    kinds = ["count", "max"]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="overlap"):
        kernels.slot_region_read_pack(st, [0, 8, 0], 16, clear_kinds=kinds)
    with pytest.raises(ValueError, match="overlap"):
        kernels.slot_region_read_pack(st, [32, 17], 16, clear_kinds=kinds)
    with pytest.raises(ValueError, match="kinds"):
        kernels.slot_region_read_pack(st, [0], 16, clear_kinds=["count"])
    with pytest.raises(ValueError, match="region size"):
        kernels.slot_region_read_pack(st, [0], 1 << 31, clear_kinds=kinds)
    # a plain read, and a clear alone, take overlapping regions as before
    ib, fb = kernels.slot_region_read_pack(st, [0, 8], 16)
    assert ib.numel() == 2 * 16 and fb.numel() == 2 * 16
    kernels.slot_region_clear(st, kinds, [0, 8], 16)
    # regions that only touch are apart
    kernels.slot_region_read_pack(st, [16, 0, 32], 16, clear_kinds=kinds)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_distinct_bases_and_their_masks():
    assert kernels._distinct([5, 9, 5, 5]) == ([5, 9], [0b1101, 0b10])
    assert kernels._distinct([3]) == ([3], [1])
    bases = [64 * i for i in range(16)]
    assert kernels._distinct(bases) == (bases, [1 << j for j in range(16)])


def _quad_walk(base: int, r: int):
    """The region offsets region_kernel's threads touch for one base, in
    its 32-bit unsigned arithmetic, and how each is accessed."""
    m = (1 << 32) - 1
    head = base & 3
    nq = (head + r + 3) >> 2
    seen = []
    for q in range(nq):
        r0 = (4 * q - head) & m
        full = (q > 0 or head == 0) and r >= 4 and r0 <= r - 4
        for e in range(4):
            off = (r0 + e) & m
            if full or off < r:
                seen.append((off, full))
    return seen


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 7, 8, 9, 2047, 2048, 2049])
@pytest.mark.parametrize("head", [0, 1, 2, 3])
def test_quad_walk_covers_each_slot_once(head, r):
    base = 4 * 1000 + head
    seen = _quad_walk(base, r)
    assert sorted(o for o, _ in seen) == list(range(r))
    # a quad is taken whole (16-byte accesses) only inside the region, from
    # a slot index that is a multiple of four
    whole = [o for o, f in seen if f]
    assert all((base + o) % 4 == i % 4 for i, o in enumerate(whole))
    assert len(whole) == 4 * max(0, (head + r) // 4 - (1 if head else 0))


def _close_pair(kinds, dtypes):
    kw = dict(cap=1024, batch_cap=256, region_size=16)
    return (JaxAggregator(kinds, dtypes, backend="jax", emit_cap=64, **kw),
            SlotAggregator(kinds, dtypes, device="cpu", **kw))


def _by_key(rows):
    keys, bins, accs = rows
    return {(int(k), int(b)): tuple(a[i].tobytes() for a in accs)
            for i, (k, b) in enumerate(zip(keys.tolist(), bins.tolist()))}


@pytest.mark.parametrize("lanes", list(LANE_SETS), ids=list(LANE_SETS))
def test_destructive_close_makes_one_call_and_no_clear_call(lanes, monkeypatch):
    """extract_start(b, b + 1, b + 1) on bins of 3 to 19 regions: one
    read-and-clear call per group of <= 16 regions and no K3 call. Its
    rows equal the JAX SlotAggregator's key by key (the two directories
    hand out slots in different orders, ROADMAP C5), and the state after
    is the state before with the bin's regions at each lane's identity."""
    kinds = tuple(k for k, _ in LANE_SETS[lanes])
    dtypes = tuple(d for _, d in LANE_SETS[lanes])
    jx, pt = _close_pair(kinds, dtypes)
    rng = np.random.default_rng(len(kinds))
    for b in range(3):
        n = 1000
        keys = rng.integers(0, 40 + 130 * b, n).astype(np.uint64)
        vals = [np.ones(n, dtype=d) if k == "count" else _lane(rng, k, d)[:n]
                for k, d in zip(kinds, dtypes)]
        for agg in (jx, pt):
            agg.update(keys, np.full(n, b, dtype=np.int32), vals)

    def no_clear(*_a, **_k):
        raise AssertionError("the destructive close called slot_region_clear")

    assert len(pt.directory.bin_regions[2]) > kernels.MAX_BASES  # two groups, two calls
    calls = []
    read = kernels.slot_region_read_pack
    monkeypatch.setattr(kernels, "slot_region_clear", no_clear)
    monkeypatch.setattr(kernels, "slot_region_read_pack",
                        lambda *a, **k: calls.append(k.get("clear_kinds")) or read(*a, **k))
    for b in range(3):
        regions = list(pt.directory.bin_regions.get(b, ()))
        assert len(regions) >= 3
        want_state = [t.numpy().copy() for t in pt.state]
        for w, (kd, dt) in zip(want_state, LANE_SETS[lanes]):
            for r in regions:
                w[r * 16:(r + 1) * 16] = _ident(kd, dt)
        calls.clear()
        got = pt.extract_start(b, b + 1, b + 1).result()
        want = jx.extract_start(b, b + 1, b + 1).result()
        assert calls == [kinds] * -(-len(regions) // kernels.MAX_BASES)
        assert len(got[0]) == len(want[0]) > 0
        assert _by_key(got) == _by_key(want)
        for t, w in zip(pt.state, want_state):
            _same(t.numpy(), w)
