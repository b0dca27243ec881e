"""Float subnormals through the port's device paths other than K1's
scatter-combine (tests/test_torch_slot_kernels.py holds that), against the
JAX package on the same inputs.

XLA on the CPU reads subnormal operands of float arithmetic and writes
subnormal results as the zero of their sign, float64 as float32; moves
(gathers, concatenations) keep them. So:

- K2's region read (``make_read_multi``, with and without the clear) and
  K7's gather (``make_read_slots``) keep a float64 subnormal as it is;
- the keyed table's sort-reduce and probe-merge (K8 and K9, the mesh and
  the single-device table alike) flush every operand and result of their
  float sums and min/max, float32 and float64.

Each is held exactly: floats as bits, -0.0 apart from +0.0. Also here: the
paths of K1's plain ordered sum (``ordered_add_plain``: one sign through
``index_add_``, else by rank and a serial tail) held to one another, and a
numpy model of csrc/float_flush.cuh's two passes held to the flushed walk."""

import numpy as np
import pytest
import torch

from arroyo_tpu.hashing import hash_column
from arroyo_tpu.ops.aggregate import DeviceHashAggregator as JaxHashAgg
from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import kernels
from arroyo_tpu_torch.ops import aggregate as tagg_mod
from arroyo_tpu_torch.ops.aggregate import DeviceHashAggregator
from test_torch_sharded_agg import _pair, _sharded, assert_state_equal

KINDS = ("sum", "count", "min", "max")
CAP, R = 1024, 128
SUB64 = 1e-310
# subnormals of both signs, the smallest, sums that cancel below the
# smallest normal, signed zeros and plain values
CHOICE = {
    np.float64: np.array([SUB64, -SUB64, 3e-308, -2.9e-308, 5e-324, -0.0, 0.0, 1e-300,
                          -1e-300, 2.5e-308, -2.5e-308]),
    np.float32: np.array([1e-40, -1e-40, 3e-38, -2.9e-38, 1e-45, -0.0, 0.0, 1e-30, -1e-30,
                          1.2e-38, -1.2e-38], dtype=np.float32),
}


def _state64(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in KINDS:
        a = rng.normal(0, 1, CAP)
        a[::7] = SUB64
        a[3::7] = -SUB64
        a[5::11] = 5e-324
        out.append(a)
    return out


@pytest.mark.parametrize("clear", [False, True], ids=["read", "read_clear"])
def test_k2_region_read_keeps_float64_subnormals_as_make_read_multi(clear):
    import jax.numpy as jnp

    state = _state64(1)
    dtypes = (np.float64,) * 4
    bases = np.array([0, 256, 512, 0], np.int64)
    out = _build_slot_jax(KINDS, dtypes, CAP, R)[2](4, clear)(
        tuple(jnp.asarray(a) for a in state), bases)
    js, ib, fb = out if clear else (None, *out)
    ts = [torch.from_numpy(a.copy()) for a in state]
    _tib, tfb = kernels.slot_region_read_pack(ts, bases, R, clear_kinds=KINDS if clear else None)
    assert tfb.numpy().tobytes() == np.asarray(fb).tobytes()
    assert (np.abs(tfb.numpy()) < 2.2250738585072014e-308).any()  # subnormals read out
    if clear:
        for j, t in zip(js, ts):
            assert t.numpy().tobytes() == np.asarray(j).tobytes()


def test_k7_gather_keeps_float64_subnormals_as_make_read_slots():
    import jax.numpy as jnp

    state = _state64(2)
    dtypes = (np.float64,) * 4
    slots = np.arange(64, dtype=np.int32)
    want = _build_slot_jax(KINDS, dtypes, CAP, R)[4](64)(tuple(jnp.asarray(a) for a in state),
                                                        slots)
    _ib, fb = kernels.slot_gather([torch.from_numpy(a) for a in state], torch.from_numpy(slots))
    assert fb.numpy().reshape(-1).tobytes() == np.concatenate(
        [np.asarray(w) for w in want]).tobytes()


@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_mesh_float_subnormals_flush_as_the_reference(n_dev, dt):
    """K8's sums and min/max and K9's merges flush, step after step, so the
    nine state arrays stay byte-equal to the JAX mesh's."""
    kinds = ("sum", "min", "max", "sum")
    jagg, tagg = _pair(n_dev, kinds=kinds, dtypes=(dt,) * 4, cap=256, batch_cap=64,
                       max_probes=16, emit_cap=64, spill_cap=64)
    rng = np.random.default_rng(n_dev * 10 + (dt == np.float32))
    choice = CHOICE[dt]
    for _ in range(4):
        n = n_dev * 50
        keys = hash_column(rng.integers(0, 20, n).astype(np.int64))
        bins = rng.integers(0, 2, n).astype(np.int32)
        vals = [choice[rng.integers(0, len(choice), n)] for _ in kinds]
        k, b, valid, vs = _sharded(n_dev, 64, keys, bins, vals)
        jagg.update_sharded(k, b, valid, vs)
        tagg.update_sharded(k, b, valid, vs)
        assert_state_equal(jagg, tagg)


@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
def test_single_device_table_float_subnormals_flush_as_the_reference(dt):
    kinds = ("sum", "min", "max")
    kw = dict(cap=256, batch_cap=128, max_probes=16, emit_cap=64)
    j = JaxHashAgg(kinds, (dt,) * 3, backend="jax", **kw)
    t = DeviceHashAggregator(kinds, (dt,) * 3, backend="jax", device="cpu", **kw)
    rng = np.random.default_rng(5)
    choice = CHOICE[dt]
    for _ in range(3):
        keys = rng.integers(0, 16, 100).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        bins = rng.integers(0, 2, 100).astype(np.int32)
        vals = [choice[rng.integers(0, len(choice), 100)] for _ in kinds]
        j.update(keys, bins, vals)
        t.update(keys, bins, vals)
    keys_t, bins_t, occ_t, accs_t, _oflow = t.state
    jk, jb, jo, ja, _jof = j.state
    assert keys_t.numpy().tobytes() == np.asarray(jk).tobytes()
    assert occ_t.numpy().tobytes() == np.asarray(jo).tobytes()
    for a, w in zip(accs_t, ja):
        assert a.numpy().tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------- K1's plain ordered sum

def _ordered_case(dt, sign, seed):
    """State [CAP] and rows (slots, values) with hot runs past the rank loop
    and the CHOICE values (subnormals, signed zeros, sums that cancel below
    the least normal), signs as ``sign`` says ("+", "-" or "mixed")."""
    rng = np.random.default_rng(seed)
    n = 3000
    choice = np.concatenate([CHOICE[dt], np.asarray([1.5, -2.25, 1e30, -1e30], dt)]).astype(dt)
    state = choice[rng.integers(0, len(choice), CAP)].copy()
    vals = choice[rng.integers(0, len(choice), n)].copy()
    slots = np.minimum(rng.zipf(1.3, n) - 1, CAP - 1).astype(np.int64)
    if sign != "mixed":
        f = np.abs if sign == "+" else (lambda x: -np.abs(x))
        state, vals = f(state).astype(dt), f(vals).astype(dt)
    return state, slots, vals


def _bits(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


@pytest.mark.parametrize("sign", ["+", "-", "mixed"])
@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
def test_ordered_add_plain_paths_give_the_same_bits(dt, sign):
    """``_add_by_rank`` at every rank loop (0: the serial tail alone) gives
    the bits of the serial walk; where the operands have one sign,
    ``_add_one_sign`` gives them too, and ``ordered_add_plain`` takes it."""
    state, slots, vals = _ordered_case(dt, sign, {"+": 1, "-": 2, "mixed": 3}[sign])
    hs, hv = torch.from_numpy(slots), tagg_mod.ftz(torch.from_numpy(vals))
    assert int(torch.unique(hs, return_counts=True)[1].max()) > tagg_mod._RANK_LOOP
    outs = {}
    for loop in (0, 1, 7, tagg_mod._RANK_LOOP, 1 << 30):
        a = torch.from_numpy(state.copy())
        tagg_mod._add_by_rank(a, hs, hv, rank_loop=loop)
        outs[f"rank {loop}"] = _bits(a)
    a = torch.from_numpy(state.copy())
    tagg_mod.ordered_add_plain(a, hs, torch.from_numpy(vals))
    outs["ordered_add_plain"] = _bits(a)
    if sign != "mixed":
        a = torch.from_numpy(state.copy())
        tagg_mod._add_one_sign(a, hs, hv)
        outs["one sign"] = _bits(a)
    assert len(set(outs.values())) == 1, sorted(outs)


# ----------------------------------- csrc/float_flush.cuh's two passes, modelled

TINY_KEY = (64 << 21) - 2
DBL_MIN = float(np.finfo(np.float64).tiny)


def _tiny_key(x: float) -> int:
    """tiny_key: the high word times two less two, in 32 bits."""
    hi = int(np.array([x], np.float64).view(np.uint64)[0]) >> 32
    return (hi * 2 - 2) & 0xFFFFFFFF


def _two_pass(x: float, vals) -> tuple:
    """two_pass over a float64 chain: the fast pass (no result flushed, the
    least key of the operands kept), then the exact pass where it fell below
    TINY_KEY. Returns (sum, whether the exact pass ran)."""
    x = float(tagg_mod.ftz(torch.tensor([x], dtype=torch.float64))[0])
    vals = tagg_mod.ftz(torch.tensor(vals, dtype=torch.float64)).numpy()
    lo, y = 0xFFFFFFFF, x
    for v in vals.tolist():
        lo = min(lo, _tiny_key(v))
        y += v
    if lo < TINY_KEY:
        return float(tagg_mod._serial_add(x, vals, torch.float64)), True
    return y, False


def _f64_bits(x: float) -> int:
    return int(np.array([x], np.float64).view(np.uint64)[0])


TWO_PASS_CASES = {
    # C8's case: a sum cancelling below the least normal
    "cancel to a subnormal": (3e-308, [-2.9e-308, 1e-310]),
    # the first subnormal is the smallest, its high word a zero's
    "cancel to 2^-1074": (DBL_MIN + 5e-324, [-DBL_MIN, 1.0]),
    # the largest operand that can make a subnormal sum: 2^-970, an
    # exponent field of 53
    "cancel at the bound": (-(2.0 ** -970 - 2.0 ** -1023), [2.0 ** -970]),
    "subnormal operands": (0.0, [1e-310, -1e-310, 5e-324]),
    "zeros on a fresh slot": (0.0, [0.0, -0.0, 0.0, 0.0]),
    "a sum cancelling to zero": (1.5, [-1.5, 2.25, -2.25, 0.0]),
    "normals near the least": (2 * DBL_MIN, [DBL_MIN, -3 * DBL_MIN, 4 * DBL_MIN]),
}


@pytest.mark.parametrize("name", sorted(TWO_PASS_CASES))
def test_two_pass_model_gives_the_flushed_walk(name):
    """The model's sum has the flushed walk's bits; the exact pass runs
    where an operand is a normal small enough to make a subnormal partial
    sum, and not for zeros alone."""
    x, vals = TWO_PASS_CASES[name]
    got, exact = _two_pass(x, vals)
    want = tagg_mod._serial_add(float(tagg_mod.ftz(torch.tensor([x], dtype=torch.float64))[0]),
                                tagg_mod.ftz(torch.tensor(vals, dtype=torch.float64)).numpy(),
                                torch.float64)
    assert _f64_bits(got) == _f64_bits(float(want))
    # subnormal operands are zeros once flushed where they are read
    assert exact == (name not in ("zeros on a fresh slot", "a sum cancelling to zero",
                                  "subnormal operands"))


@pytest.mark.parametrize("seed", range(4))
def test_two_pass_model_on_random_chains_near_the_least_normal(seed):
    """Random chains of small multiples of 2^-1074 around the least normal
    (every cancellation lands on a subnormal or a zero), of normals and of
    zeros: the model's fast result, where it stands, is the flushed walk's,
    and a chain whose flushed operands are all zero or above 2^-959 never
    pays the exact pass."""
    rng = np.random.default_rng(seed)
    ulp = 5e-324
    pool = np.concatenate([DBL_MIN + ulp * rng.integers(-3, 4, 16),
                           -(DBL_MIN + ulp * rng.integers(-3, 4, 16)),
                           [0.0, -0.0, 1.0, -1.0, 3 * DBL_MIN, 1e-300]])
    fast = 0
    for _ in range(400):
        x = float(pool[rng.integers(0, len(pool))])
        vals = pool[rng.integers(0, len(pool), rng.integers(1, 12))].tolist()
        got, exact = _two_pass(x, vals)
        fx = float(tagg_mod.ftz(torch.tensor([x], dtype=torch.float64))[0])
        fv = tagg_mod.ftz(torch.tensor(vals, dtype=torch.float64)).numpy()
        want = float(tagg_mod._serial_add(fx, fv, torch.float64))
        assert _f64_bits(got) == _f64_bits(want), (x, vals)
        if not ((fv != 0) & (np.abs(fv) < 2.0 ** -959)).any():
            assert not exact, (x, vals)
            fast += 1
    assert 0 < fast < 400
