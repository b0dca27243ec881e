"""The port's slot-aggregator kernels (arroyo_tpu_torch/ops/kernels.py),
through their wrappers on CPU tensors, i.e. their plain PyTorch versions,
against arroyo_tpu's jitted slot steps (ops/slot_agg.py _build_slot_jax) on
the same inputs made with numpy from a seed.

Exact: every lane, float sums included, must match bit for bit (NaN
positions must agree; -0.0 and +0.0 are told apart). The reference adds a
slot's rows one after another in batch order, and so does K1 (and its plain
version, the CPU's index_add_). uint64 lanes (a numeric group-by key riding
the state as a max lane) wrap on add and compare unsigned."""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import kernels

CAP = 8192
R = 512
DTYPES = (np.int32, np.int64, np.float32, np.float64, np.uint64)
KINDS = ("sum", "count", "min", "max")


def _ident(kind, dt):
    dt = np.dtype(dt)
    if kind in ("sum", "count"):
        return dt.type(0)
    if np.issubdtype(dt, np.integer):
        return dt.type(np.iinfo(dt).max if kind == "min" else np.iinfo(dt).min)
    return dt.type(np.inf if kind == "min" else -np.inf)


def _values(rng, kind, dt, n):
    dt = np.dtype(dt)
    if dt == np.uint64:
        # near both ends of the range: unsigned order and wrapping sums
        return (rng.integers(-1000, 1000, n).astype(np.int64) << 50).view(np.uint64)
    if np.issubdtype(dt, np.integer):
        return rng.integers(-1000, 1000, n).astype(dt)
    v = rng.normal(0, 100, n).astype(dt)
    if kind in ("min", "max"):
        # signed zeros and NaNs: XLA's scatter-min/max propagates NaN and
        # orders -0.0 below +0.0, whatever the order of the rows
        pick = rng.random(n)
        v[pick < 0.05] = -0.0
        v[(pick >= 0.05) & (pick < 0.10)] = 0.0
        v[(pick >= 0.10) & (pick < 0.101)] = np.nan
    return v


def _slots(rng, n, idx_dt, with_padding=True):
    """Zipf-skewed slots (many duplicates) with padding rows at cap."""
    s = (rng.zipf(1.3, n) - 1) % CAP
    if with_padding:
        s[rng.random(n) < 0.05] = CAP
    return s.astype(idx_dt)


def _assert_lane(got, want, kind):
    """Bit for bit; a NaN equals a NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, kind
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    ib = np.int64 if want.dtype == np.float64 else np.int32
    np.testing.assert_array_equal(got[~nan].view(ib), want[~nan].view(ib))


def _state_pair(kinds, dtypes):
    import jax.numpy as jnp

    js = tuple(jnp.full(CAP, _ident(k, d), dtype=d) for k, d in zip(kinds, dtypes))
    ts = [torch.from_numpy(np.full(CAP, _ident(k, d), dtype=d)) for k, d in zip(kinds, dtypes)]
    return js, ts


@pytest.mark.parametrize("merge", [False, True], ids=["hot", "merge"])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_scatter_combine_matches_jax_step(dt, merge):
    kinds = KINDS
    dtypes = (dt,) * 4
    step, step_merge, _rm, _clear, _rs = _build_slot_jax(kinds, dtypes, CAP, R)
    fn = step_merge if merge else step
    rng = np.random.default_rng(7)
    js, ts = _state_pair(kinds, dtypes)
    for _ in range(3):
        n = 4096
        slots = _slots(rng, n, np.int32)
        vals = [_values(rng, k, dt, n) for k in kinds]
        shipped = [v for k, v in zip(kinds, vals) if merge or k != "count"]
        js = fn(js, slots, tuple(shipped))
        kernels.slot_scatter_combine(
            ts, kinds, torch.from_numpy(slots),
            [None if (k == "count" and not merge) else torch.from_numpy(v)
             for k, v in zip(kinds, vals)])
    for k, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), k)


@pytest.mark.parametrize("merge", [False, True], ids=["hot", "merge"])
def test_float32_subnormals_and_signed_zeros_match_jax_step(merge):
    """XLA reads float32 subnormal operands and writes subnormal results as
    the zero of their sign: K1 does the same in every lane kind, at every
    slot a row touches (a subnormal state that wins a min or max too), and
    leaves untouched slots alone."""
    kinds = KINDS
    dtypes = (np.float32,) * 4
    step, step_merge, *_ = _build_slot_jax(kinds, dtypes, CAP, R)
    import jax.numpy as jnp

    sub = np.float32(1e-40)
    init = []
    for k in kinds:
        a = np.full(CAP, _ident(k, np.float32), dtype=np.float32)
        a[:6] = [sub, -sub, 0.0, -0.0, 1.2e-38, -sub]
        a[100] = sub  # never touched: stays subnormal in both
        init.append(a)
    slots = np.array([0, 0, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8], dtype=np.int32)
    v = np.array([sub, sub, -sub, -0.0, sub, -sub, -1.4e-38, 1e-45, 3e-39, 0.0,
                  1.5e-38, -1.4e-38, -3e-39, -0.0, -1e-45], dtype=np.float32)
    js = tuple(jnp.asarray(a) for a in init)
    ts = [torch.from_numpy(a.copy()) for a in init]
    vals = [v] * 4
    shipped = [x for k, x in zip(kinds, vals) if merge or k != "count"]
    js = (step_merge if merge else step)(js, slots, tuple(shipped))
    kernels.slot_scatter_combine(
        ts, kinds, torch.from_numpy(slots),
        [None if (k == "count" and not merge) else torch.from_numpy(x) for k, x in zip(kinds, vals)])
    for k, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), k)
        assert t.numpy()[100].view(np.int32) == sub.view(np.int32)
    bits = ts[0].numpy()[:9].view(np.int32)
    assert ((bits & 0x7F800000) != 0).sum() + (bits & 0x7FFFFFFF == 0).sum() == 9


@pytest.mark.parametrize("merge", [False, True], ids=["hot", "merge"])
def test_float64_subnormals_and_signed_zeros_match_jax_step(merge):
    """XLA on the CPU reads float64 subnormal operands and writes subnormal
    results as the zero of their sign, as it does float32: K1 does the same
    in every float64 lane kind, at every slot a row touches (a subnormal
    state that wins a min or max, and a sum that cancels below DBL_MIN,
    too), and leaves untouched slots alone."""
    kinds = KINDS
    dtypes = (np.float64,) * 4
    step, step_merge, *_ = _build_slot_jax(kinds, dtypes, CAP, R)
    import jax.numpy as jnp

    sub = 1e-310
    init = []
    for k in kinds:
        a = np.full(CAP, _ident(k, np.float64), dtype=np.float64)
        a[:8] = [sub, -sub, 0.0, -0.0, 3e-308, -sub, 1.0, -3e-308]
        a[100] = sub  # never touched: stays subnormal in both
        init.append(a)
    slots = np.array([0, 0, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 9, 9], dtype=np.int32)
    v = np.array([sub, sub, -sub, -0.0, sub, -sub, -2.9e-308, 5e-324, 3e-309, 0.0,
                  -1.0, 1e-310, 2.9e-308, -1e-300, -5e-324, 3e-308, -2.95e-308, 1e-308],
                 dtype=np.float64)
    js = tuple(jnp.asarray(a) for a in init)
    ts = [torch.from_numpy(a.copy()) for a in init]
    vals = [v] * 4
    shipped = [x for k, x in zip(kinds, vals) if merge or k != "count"]
    js = (step_merge if merge else step)(js, slots, tuple(shipped))
    kernels.slot_scatter_combine(
        ts, kinds, torch.from_numpy(slots),
        [None if (k == "count" and not merge) else torch.from_numpy(x) for k, x in zip(kinds, vals)])
    for k, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), k)
        assert t.numpy()[100].view(np.int64) == np.float64(sub).view(np.int64)
    bits = ts[0].numpy()[:10].view(np.int64)
    normal = (bits & 0x7FF0000000000000) != 0
    assert (normal | (bits & 0x7FFFFFFFFFFFFFFF == 0)).all()


def test_scatter_combine_int64_slots_and_duplicates():
    """int64 slot indices (the dtype for cap >= 2**31-1) are taken as well;
    one slot hit by every row sums every row."""
    kinds, dtypes = ("count", "max"), (np.int64, np.int64)
    step, *_ = _build_slot_jax(kinds, dtypes, CAP, R)
    rng = np.random.default_rng(3)
    js, ts = _state_pair(kinds, dtypes)
    slots = _slots(rng, 2048, np.int64)
    slots[:512] = 17
    v = rng.integers(-5, 5, 2048).astype(np.int64)
    js = step(js, slots, (v,))
    kernels.slot_scatter_combine(ts, kinds, torch.from_numpy(slots), [None, torch.from_numpy(v)])
    for k, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), k)
    assert ts[0][17].item() >= 512


def test_scatter_combine_drops_rows_outside_state():
    state = [torch.zeros(8, dtype=torch.int64)]
    slots = torch.tensor([0, 8, 9, -1, 7, 7], dtype=torch.int32)
    kernels.slot_scatter_combine(state, ["count"], slots, [None])
    assert state[0].tolist() == [1, 0, 0, 0, 0, 0, 0, 2]


LANES = (("sum", np.int32), ("max", np.int64), ("min", np.float32), ("count", np.int64),
         ("max", np.float64), ("min", np.int32), ("sum", np.float64), ("max", np.float32),
         ("max", np.uint64))


def _filled_pair(rng, lanes):
    kinds = tuple(k for k, _ in lanes)
    dtypes = tuple(d for _, d in lanes)
    js, ts = _state_pair(kinds, dtypes)
    # distinct slots: every lane, float sums included, is exact
    slots = rng.permutation(CAP)[: CAP // 2].astype(np.int32)
    vals = [_values(rng, k, d, len(slots)) for k, d in lanes]
    step_merge = _build_slot_jax(kinds, dtypes, CAP, R)[1]
    js = step_merge(js, slots, tuple(vals))
    kernels.slot_scatter_combine(ts, kinds, torch.from_numpy(slots),
                                 [torch.from_numpy(v) for v in vals])
    return kinds, dtypes, js, ts


@pytest.mark.parametrize("do_clear", [False, True], ids=["read", "read_clear"])
@pytest.mark.parametrize("k,n_real", [(1, 1), (2, 2), (4, 3), (8, 5), (16, 16)])
def test_read_pack_and_clear_match_jax(k, n_real, do_clear):
    """make_read_multi: k bases, the tail padded by duplicating bases[0]
    as the aggregator does; with clear, the duplicate's read must still
    see the data (the clear runs after every read)."""
    rng = np.random.default_rng(k * 10 + n_real)
    kinds, dtypes, js, ts = _filled_pair(rng, LANES)
    real = list(rng.choice(CAP // R, n_real, replace=False) * R)
    bases = np.array(real + [real[0]] * (k - n_real), dtype=np.int64)
    fn = _build_slot_jax(kinds, dtypes, CAP, R)[2](k, do_clear)
    if do_clear:
        js, ib, fb = fn(js, bases)
    else:
        ib, fb = fn(js, bases)
    tib, tfb = kernels.slot_region_read_pack(ts, bases, R)
    if do_clear:
        kernels.slot_region_clear(ts, kinds, bases, R)
    assert tib.dtype == torch.int64 and tfb.dtype == torch.float64
    np.testing.assert_array_equal(tib.numpy(), np.asarray(ib))
    _assert_lane(tfb.numpy(), np.asarray(fb), "exact")
    for kd, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), "exact")


def test_clear_single_region_matches_jax():
    rng = np.random.default_rng(5)
    kinds, dtypes, js, ts = _filled_pair(rng, LANES)
    clear = _build_slot_jax(kinds, dtypes, CAP, R)[3]
    js = clear(js, np.int64(3 * R))
    kernels.slot_region_clear(ts, kinds, [3 * R], R)
    for kd, j, t in zip(kinds, js, ts):
        _assert_lane(t.numpy(), np.asarray(j), "exact")


@pytest.mark.parametrize("lanes", [(("count", np.int64), ("max", np.int64)),
                                   (("sum", np.float64), ("min", np.float32))],
                         ids=["int_only", "float_only"])
def test_read_pack_single_class(lanes):
    """A lane class with no lanes gives an empty buffer of its dtype."""
    rng = np.random.default_rng(9)
    kinds, dtypes, js, ts = _filled_pair(rng, lanes)
    bases = np.array([R, 5 * R], dtype=np.int64)
    ib, fb = _build_slot_jax(kinds, dtypes, CAP, R)[2](2, False)(js, bases)
    tib, tfb = kernels.slot_region_read_pack(ts, bases, R)
    assert tib.numel() == np.asarray(ib).size and tfb.numel() == np.asarray(fb).size
    np.testing.assert_array_equal(tib.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(tfb.numpy(), np.asarray(fb))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    st = [torch.zeros(16, dtype=torch.int64), torch.zeros(16, dtype=torch.float64)]
    s = torch.zeros(4, dtype=torch.int32)
    one = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs values"):
        kernels.slot_scatter_combine(st, ["sum", "max"], s, [None, None])
    with pytest.raises(ValueError, match="dtype"):
        kernels.slot_scatter_combine(st, ["count", "max"], s, [None, one])
    with pytest.raises(TypeError, match="slots dtype"):
        kernels.slot_scatter_combine(st, ["count", "max"], s.float(), [None, one.double()])
    with pytest.raises(TypeError, match="int32/int64/float32/float64/uint64"):
        kernels.slot_scatter_combine([torch.zeros(16, dtype=torch.int16)], ["count"], s, [None])
    with pytest.raises(ValueError, match="same length"):
        kernels.slot_region_read_pack([st[0], torch.zeros(8)], [0], 8)
    with pytest.raises(ValueError, match="outside the state"):
        kernels.slot_region_read_pack(st, [12], 8)
    with pytest.raises(ValueError, match="region bases"):
        kernels.slot_region_clear(st, ["count", "max"], [0] * 17, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.slot_region_read_pack([torch.zeros(16, device="meta")], [0], 8)
    with pytest.raises(TypeError, match="slots dtype"):
        kernels.slot_gather(st, s.float())
    with pytest.raises(ValueError, match="state's device"):
        kernels.slot_gather(st, torch.zeros(4, dtype=torch.int32, device="meta"))
    assert kernels.launch_counts() == {"slot_scatter_combine": 0,
                                       "slot_region_read_pack": 0,
                                       "slot_region_clear": 0,
                                       "slot_gather": 0,
                                       "slot_region_read_pack_clear": 0,
                                       "slot_scatter_combine_merge": 0}
