"""The port's SlotAggregator (arroyo_tpu_torch/ops/slot_agg.py) on the CPU
against arroyo_tpu's SlotAggregator(backend="jax"): random streams with
window closes, region churn and spill, compared exactly (float sums use
integer-valued inputs, so every order of addition gives the same sum).
Also: state carried across between the two with to/from_numpy_state."""

import numpy as np
import pytest

from arroyo_tpu.ops.slot_agg import BinSlotDirectory as JaxDirectory
from arroyo_tpu.ops.slot_agg import SlotAggregator as JaxAggregator
from arroyo_tpu_torch.ops.slot_agg import BinSlotDirectory, SlotAggregator

KW = dict(cap=64, batch_cap=64, region_size=16)
KINDS = [
    (("count", "sum"), (np.int64, np.int64)),
    (("min", "max"), (np.int64, np.int64)),
    (("sum",), (np.float64,)),
    (("sum", "min", "max", "count"), (np.int32, np.float32, np.float64, np.int64)),
]
IDS = ["count_sum_i64", "min_max_i64", "sum_f64", "mixed"]


def _pair(kinds, dtypes):
    return (JaxAggregator(kinds, dtypes, backend="jax", emit_cap=64, **KW),
            SlotAggregator(kinds, dtypes, device="cpu", **KW))


def _table(keys, bins, accs):
    out = {}
    for i, (k, b) in enumerate(zip(keys.tolist(), bins.tolist())):
        out[(int(k), int(b))] = tuple(a[i].item() for a in accs)
    return out


def _stream(seed, kinds, dtypes, steps=24):
    """Per step: 120 rows over 90 keys (more groups per bin than the 64
    slots, so regions churn and the surplus spills), bins advancing."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        n = 120
        keys = rng.integers(0, 90, n).astype(np.uint64)
        bins = rng.integers(step // 4, step // 4 + 2, n).astype(np.int32)
        vals = rng.integers(-50, 100, n)
        ins = [np.ones(n, dtype=d) if k == "count" else vals.astype(d)
               for k, d in zip(kinds, dtypes)]
        out.append((keys, bins, ins))
    return out


def _run(agg, steps, start=0, got=None):
    got = {} if got is None else got
    for i, (keys, bins, ins) in enumerate(steps):
        step = start + i
        agg.update(keys, bins, ins)
        if step % 4 == 3:
            close = step // 4 + 1
            t = _table(*agg.extract(0, close, close))
            assert not (set(t) & set(got)), "a (key, bin) group was emitted twice"
            got.update(t)
    return got


def _finish(agg, got):
    got.update(_table(*agg.extract(0, 1 << 30, 1 << 30)))
    return got


@pytest.mark.parametrize("kinds,dtypes", KINDS, ids=IDS)
def test_random_stream_matches_jax(kinds, dtypes):
    jx, pt = _pair(kinds, dtypes)
    steps = _stream(3, kinds, dtypes)
    want = _finish(jx, _run(jx, steps))
    got = _finish(pt, _run(pt, steps))
    assert got == want
    assert len(want) > 100


@pytest.mark.parametrize("kinds,dtypes", KINDS[:2], ids=IDS[:2])
def test_spill_scan_snapshot_restore_match_jax(kinds, dtypes):
    """200 groups in one bin >> 64 slots: the surplus spills to the host
    store; scans are non-destructive, snapshots include the spill, and a
    restore (merge mode: counts add the given partial counts) of the
    snapshot reproduces it."""
    jx, pt = _pair(kinds, dtypes)
    keys = np.arange(200, dtype=np.uint64)
    bins = np.repeat(np.arange(2, dtype=np.int32), 100)
    ins = [np.ones(200, dtype=d) if k == "count" else np.arange(200).astype(d)
           for k, d in zip(kinds, dtypes)]
    for a in (jx, pt):
        a.update(keys, bins, ins)
        a.update(keys, bins, ins)
    assert len(pt.spill) == len(jx.spill) > 0
    assert _table(*pt.scan_range(0, 1)) == _table(*jx.scan_range(0, 1))
    assert _table(*pt.scan_range(0, 1)) == _table(*jx.scan_range(0, 1))
    snap_j, snap_p = _table(*jx.snapshot()), _table(*pt.snapshot())
    assert snap_p == snap_j and len(snap_p) == 200
    pt2 = SlotAggregator(kinds, dtypes, device="cpu", **KW)
    pt2.restore(*pt.snapshot())
    assert _table(*pt2.snapshot()) == snap_j
    pt.free_bins_below(1)
    jx.free_bins_below(1)
    assert _table(*pt.extract(0, 2, 2)) == _table(*jx.extract(0, 2, 2))


def _jax_state_into_port(jx, pt):
    pt.from_numpy_state([np.asarray(a) for a in jx.state], jx.directory, jx.spill)


def _port_state_into_jax(pt, jx):
    import jax.numpy as jnp

    lanes, dstate, spill = pt.to_numpy_state()
    d = JaxDirectory(dstate["cap"], dstate["R"])
    for name, v in dstate.items():
        if name not in ("cap", "R"):
            setattr(d, name, v)
    jx.state = tuple(jnp.asarray(a) for a in lanes)
    jx.directory = d
    jx.spill = spill


@pytest.mark.parametrize("kinds,dtypes", KINDS, ids=IDS)
def test_state_carried_across_from_jax_and_back(kinds, dtypes):
    """Half the stream in one package, the state moved, the rest in the
    other: the merged output equals the uninterrupted JAX run exactly."""
    steps = _stream(11, kinds, dtypes)
    ref = _pair(kinds, dtypes)[0]
    want = _finish(ref, _run(ref, steps))
    half = 14  # mid-window: live bins, partly filled regions and spill cross over
    # JAX -> port
    jx, pt = _pair(kinds, dtypes)
    got = _run(jx, steps[:half])
    _jax_state_into_port(jx, pt)
    assert _finish(pt, _run(pt, steps[half:], start=half, got=got)) == want
    # port -> JAX
    jx, pt = _pair(kinds, dtypes)
    got = _run(pt, steps[:half])
    _port_state_into_jax(pt, jx)
    assert _finish(jx, _run(jx, steps[half:], start=half, got=got)) == want


def test_directory_state_round_trip_and_checks():
    d = BinSlotDirectory(64, 16)
    codes = np.array([5, 9, 77], dtype=np.uint64)
    d.lookup_or_assign(codes, np.array([1, 2, 3]), np.array([0, 0, 1]))
    d2 = BinSlotDirectory.from_state(d.to_state())
    for a in ("hcode", "hbin", "hslot", "slot_keys", "slot_bins", "region_fill"):
        np.testing.assert_array_equal(getattr(d2, a), getattr(d, a))
    assert d2.bin_regions == d.bin_regions and d2.free_regions == d.free_regions
    pt = SlotAggregator(("count",), (np.int64,), device="cpu", **KW)
    with pytest.raises(ValueError, match="cap 128"):
        pt.from_numpy_state([np.zeros(128, np.int64)], BinSlotDirectory(128, 16).to_state(), {})
    with pytest.raises(ValueError, match="lane of shape"):
        pt.from_numpy_state([np.zeros(64, np.int32)], d.to_state(), {})
    with pytest.raises(RuntimeError, match="collision"):
        d.lookup_or_assign(codes[:1], np.array([4]), np.array([0]))
