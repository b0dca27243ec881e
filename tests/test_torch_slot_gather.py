"""The slot gather K7 (arroyo_tpu_torch/ops/kernels.py slot_gather, its
plain version on CPU tensors) against arroyo_tpu's jitted
``make_read_slots``, and the port's SlotAggregator ``read_slots`` /
``slots_of`` against arroyo_tpu's after the same updates: keys past the
table's capacity (the spill tier: -1), keys never seen (-1), bin-0 slots
freed by a closed bin (-1) and regions reused by later bins. All exact:
a gather moves values and widens them, it adds nothing."""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.slot_agg import SlotAggregator as JaxAggregator
from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import kernels
from arroyo_tpu_torch.ops.slot_agg import SlotAggregator

KW = dict(cap=64, batch_cap=64, region_size=16)
LANES = [
    ((("sum",) * 4), (np.int64,) * 4),  # qu's lanes: count, sum, avg's sum and count
    (("sum", "min", "max", "count"), (np.int32, np.float32, np.float64, np.int64)),
    (("sum",), (np.float64,)),
    (("max", "count"), (np.uint64, np.int64)),  # a numeric uint64 group-by key lane
]
IDS = ["qu", "mixed", "float64", "uint64"]


def _state(rng, dtypes, cap):
    out = []
    for d in dtypes:
        if np.issubdtype(d, np.integer):
            a = rng.integers(np.iinfo(d).min, np.iinfo(d).max, cap, dtype=d)
        else:
            a = rng.normal(0, 1e6, cap).astype(d)
            a[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-40]
        out.append(a)
    return out


@pytest.mark.parametrize("kinds,dtypes", LANES, ids=IDS)
@pytest.mark.parametrize("n", [1, 7, 64, 100, 1000])
def test_slot_gather_plain_matches_make_read_slots(kinds, dtypes, n):
    """K7's plain version against the reference's gather at k = the padded
    power of two (>= 64); the reference's padding rows read slot 0 and are
    dropped. Slot 0, slot cap - 1 and duplicates included."""
    cap = 4096
    rng = np.random.default_rng(n)
    lanes = _state(rng, dtypes, cap)
    slots = rng.integers(0, cap, n)
    slots[: min(n, 3)] = [0, cap - 1, 0][: min(n, 3)]
    k = 64
    while k < n:
        k *= 2
    padded = np.zeros(k, dtype=np.int32)
    padded[:n] = slots
    read = _build_slot_jax(kinds, dtypes, cap, 256)[4]
    want = [np.asarray(o)[:n] for o in read(k)(tuple(lanes), padded)]
    for idx_dt in (torch.int32, torch.int64):
        ib, fb = kernels.slot_gather([torch.from_numpy(a) for a in lanes],
                                     torch.from_numpy(slots).to(idx_dt))
        n_int = sum(1 for d in dtypes if not np.issubdtype(d, np.floating))
        assert ib.dtype == torch.int64 and fb.dtype == torch.float64
        ib, fb = ib.numpy().reshape(n_int, n), fb.numpy().reshape(-1, n)
        ii = fi = 0
        for d, w in zip(dtypes, want):
            if np.issubdtype(d, np.floating):
                g, fi = fb[fi], fi + 1
            else:
                g, ii = ib[ii], ii + 1
            assert g.dtype == w.dtype
            assert g.tobytes() == w.tobytes()  # NaN payloads and -0.0 included


def test_slot_gather_checks_and_out_of_range():
    st = [torch.arange(8, dtype=torch.int64), torch.arange(8, dtype=torch.float32) / 2]
    ib, fb = kernels.slot_gather(st, torch.tensor([7, -1, 8, 3], dtype=torch.int32))
    assert ib.tolist() == [7, 0, 0, 3] and fb.tolist() == [3.5, 0.0, 0.0, 1.5]
    ib, fb = kernels.slot_gather(st, torch.empty(0, dtype=torch.int64))
    assert ib.numel() == 0 and fb.numel() == 0
    with pytest.raises(TypeError, match="int32 or int64"):
        kernels.slot_gather(st, torch.zeros(2, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        kernels.slot_gather(st, torch.zeros((2, 2), dtype=torch.int64))
    assert kernels.launch_counts()["slot_gather"] == 0  # the CPU runs no kernel


def _pair(kinds, dtypes):
    return (JaxAggregator(kinds, dtypes, backend="jax", emit_cap=64, **KW),
            SlotAggregator(kinds, dtypes, device="cpu", **KW))


def _update(aggs, keys, bins, kinds, dtypes, rng):
    vals = rng.integers(-(1 << 40), 1 << 40, len(keys))
    ins = [np.ones(len(keys), dtype=d) if k == "count" else vals.astype(d)
           for k, d in zip(kinds, dtypes)]
    for a in aggs:
        a.update(keys.astype(np.uint64), bins.astype(np.int32), ins)


def _same_reads(jx, pt, keys):
    """The same keys own a slot in both packages, and reading their slots
    gives the same values. Which slot a key owns may differ: the
    reference's native resolver hands out a batch's new slots in another
    order than the port's numpy one when a batch spans several bins."""
    ku = np.asarray(keys, dtype=np.uint64)
    s_j, s_p = np.asarray(jx.slots_of(ku)), pt.slots_of(ku)
    assert s_p.dtype == np.int64
    assert np.array_equal(s_p >= 0, s_j >= 0)
    assert len(np.unique(s_p[s_p >= 0])) == (s_p >= 0).sum()
    for g, w, d in zip(pt.read_slots(s_p[s_p >= 0]), jx.read_slots(s_j[s_j >= 0]),
                       pt.acc_dtypes):
        assert g.dtype == w.dtype == d
        assert g.tobytes() == w.tobytes()
    return s_p


@pytest.mark.parametrize("kinds,dtypes", LANES[:2], ids=IDS[:2])
def test_slots_of_and_read_slots_match_jax(kinds, dtypes):
    """The updating aggregate's use: bin 0 only. 100 keys for 64 slots:
    the first 64 get slots, the rest spill (-1); unseen keys give -1."""
    rng = np.random.default_rng(3)
    jx, pt = _pair(kinds, dtypes)
    for _ in range(4):
        keys = rng.integers(0, 100, 150)
        _update((jx, pt), keys, np.zeros(150), kinds, dtypes, rng)
    s = _same_reads(jx, pt, np.arange(130))
    assert (s >= 0).sum() == 64 and (s[100:] == -1).all()
    assert len(pt.spill) == len(jx.spill) == 36
    # one key's slot read several times; an empty read
    k = np.array([7, 7, 3, 7], dtype=np.uint64)
    for g, w in zip(pt.read_slots(pt.slots_of(k)), jx.read_slots(np.asarray(jx.slots_of(k)))):
        assert g.tobytes() == w.tobytes()
    assert [len(a) for a in pt.read_slots(np.empty(0, np.int64))] == [0] * len(kinds)


def test_slots_of_after_closed_bins_and_region_reuse():
    """Windowed updates: bin 0 closes (its slots die and slots_of gives -1
    for them), later bins reuse its regions; reads of any slot list equal
    the reference's."""
    kinds, dtypes = LANES[1]
    rng = np.random.default_rng(7)
    jx, pt = _pair(kinds, dtypes)
    _update((jx, pt), rng.integers(0, 25, 120), rng.integers(0, 2, 120), kinds, dtypes, rng)
    before = _same_reads(jx, pt, np.arange(50))
    assert (before >= 0).sum() > 15
    for a in (jx, pt):
        a.free_bins_below(1)
    assert (_same_reads(jx, pt, np.arange(50)) == -1).all()
    # bins 2 and 3 take bin 0's freed regions (13 keys each: no spill)
    _update((jx, pt), rng.integers(0, 13, 200), rng.integers(2, 4, 200), kinds, dtypes, rng)
    assert (_same_reads(jx, pt, np.arange(60)) == -1).all()  # bins 1-3 are not bin 0
    assert not pt.spill and not jx.spill

    def slots_by_group(d):
        return {(int(d.slot_bins[s]), int(d.slot_keys[s])): s
                for b, regs in d.bin_regions.items() for r in regs
                for s in range(r * 16, r * 16 + int(d.region_fill[r]))}

    # every live (bin, key) group read in both packages through its own slot
    g_p, g_j = slots_by_group(pt.directory), slots_by_group(jx.directory)
    assert set(g_p) == set(g_j) and len(g_p) > 45
    groups = sorted(g_p)
    for g, w in zip(pt.read_slots(np.array([g_p[k] for k in groups])),
                    jx.read_slots(np.array([g_j[k] for k in groups]))):
        assert g.tobytes() == w.tobytes()


def test_slots_of_long_probe_chains():
    """A directory near its load limit (4096 keys in a 4096-slot table,
    open addressing over 16384 positions): every probe chain resolves to
    the slot the reference finds."""
    kinds, dtypes = LANES[0]
    kw = dict(cap=4096, batch_cap=4096, region_size=256)
    jx = JaxAggregator(kinds, dtypes, backend="jax", emit_cap=64, **kw)
    pt = SlotAggregator(kinds, dtypes, device="cpu", **kw)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 62, 5000)
    _update((jx, pt), keys, np.zeros(5000), kinds, dtypes, rng)
    s = _same_reads(jx, pt, np.concatenate([keys, rng.integers(0, 1 << 62, 500)]))
    assert (s >= 0).sum() == 4096
