"""B9's pieces through the port's wrappers on CPU tensors, i.e. the plain
PyTorch versions of K8 + K9 (``step``, with the overflow counter), K11 with
``zero_tail`` (``extract``, ``extract_packed``, ``scan_packed``), K12
(``scan``) and K13 (``free``), against the arrays of the reference's jitted
programs (arroyo_tpu.ops.aggregate._build_jax) on the same state, made from
a seed with numpy. Exact: every output array and the table after each
program, emit_cap larger than cap and not dividing it included."""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.aggregate import _build_jax
from arroyo_tpu_torch.ops import hash_kernels as hk

KINDS = ("sum", "count", "min", "max", "max")
DTYPES = tuple(np.dtype(d) for d in (np.int64, np.int64, np.int32, np.float64, np.uint64))


def _jax_state(cap):
    import jax.numpy as jnp

    from arroyo_tpu.ops.aggregate import _identity

    return (jnp.zeros(cap, jnp.int64), jnp.zeros(cap, jnp.int32), jnp.zeros(cap, bool),
            tuple(jnp.full(cap, _identity(k, d), dtype=d) for k, d in zip(KINDS, DTYPES)),
            jnp.zeros((), jnp.int32))


def _torch_state(js):
    keys, bins, occ, accs, oflow = js
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (t(keys), t(bins), t(occ), [t(a) for a in accs],
            torch.tensor([int(oflow)], dtype=torch.int32))


def _batch(rng, B, m, n_keys, n_bins):
    key = np.zeros(B, np.int64)
    key[:m] = (rng.integers(0, n_keys, m).astype(np.uint64)
               * np.uint64(0x9E3779B97F4A7C15)).view(np.int64)
    bins = np.zeros(B, np.int32)
    bins[:m] = rng.integers(0, n_bins, m)
    valid = np.arange(B) < m
    vals = []
    for k, d in zip(KINDS, DTYPES):
        v = np.zeros(B, d)
        if k == "count":
            v[:m] = 1
        elif d == np.uint64:
            v[:m] = rng.integers(0, 1 << 62, m).astype(np.uint64) << np.uint64(1)
        elif np.issubdtype(d, np.integer):
            v[:m] = rng.integers(-1000, 1000, m)
        else:
            v[:m] = np.round(rng.normal(0, 50, m), 2)
        vals.append(v)
    return key, bins, valid, vals


def assert_state(ts, js):
    for i, (t, j) in enumerate(zip(ts[:3], js[:3])):
        assert t.numpy().tobytes() == np.asarray(j).tobytes(), f"table array {i} differs"
    for t, j in zip(ts[3], js[3]):
        assert str(t.dtype) == f"torch.{np.asarray(j).dtype.name}"
        assert t.numpy().tobytes() == np.asarray(j).tobytes(), "a table lane differs"
    assert int(ts[4][0]) == int(js[4])


def _filled(cap, B, max_probes, emit_cap, steps, seed, n_keys=60, n_bins=5):
    """Both states after the same steps: the reference's jitted step and
    the port's (K8 + K9 plain) compared after each."""
    step = _build_jax(KINDS, DTYPES, cap, B, max_probes, emit_cap)[0]
    rng = np.random.default_rng(seed)
    js = _jax_state(cap)
    ts = _torch_state(js)
    for _ in range(steps):
        m = int(rng.integers(1, B + 1))
        key, bins, valid, vals = _batch(rng, B, m, n_keys, n_bins)
        js = step(js, key, bins, valid, tuple(vals))
        hk.step(hk.KERNELS, KINDS, ts, torch.from_numpy(key), torch.from_numpy(bins), m,
                [torch.from_numpy(v) for v in vals], max_probes)
        assert_state(ts, js)
    return js, ts


@pytest.mark.parametrize("cap,max_probes", [(512, 64), (64, 4)], ids=["fits", "overflows"])
def test_step_matches_reference_step(cap, max_probes):
    """K8 + K9 at one shard; unplaced partials add to the overflow counter
    as the reference's ``oflow + sum(still_active)``."""
    js, ts = _filled(cap, 128, max_probes, 64, 6, seed=cap)
    assert (int(ts[4][0]) > 0) == (cap == 64)


SHAPES = [(256, 64), (256, 256), (64, 48), (64, 128)]
SHAPE_IDS = ["divides", "equals_cap", "not_dividing", "past_cap"]


@pytest.mark.parametrize("cap,emit_cap", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("lo,hi,below", [(0, 2, 2), (1, 3, 1), (0, 5, 0), (2, 4, 5)])
def test_extract_matches_reference_extract(cap, emit_cap, lo, hi, below):
    """K11 with zero_tail: emit_cap rows, zeros past the emitted ones,
    ``valid`` below min(total, emit_cap), the frees, and the overflow
    counter in the packed buffer."""
    _step, extract, *_r = _build_jax(KINDS, DTYPES, cap, 128, 64, emit_cap)
    js, ts = _filled(cap, 128, 64, emit_cap, 3, seed=emit_cap + lo)
    js, (k, b, v, accs, total) = extract(js, np.int32(lo), np.int32(hi), np.int32(below))
    out = hk.extract(hk.KERNELS, ts, lo, hi, below, emit_cap)
    assert out.key.shape == (1, emit_cap)
    for got, want in [(out.key, k), (out.bin, b), (out.valid, v)] + list(zip(out.accs, accs)):
        assert got[0].numpy().tobytes() == np.asarray(want).tobytes()
    assert int(out.total[0]) == int(total) and int(out.oflow[0]) == int(js[4])
    assert_state(ts, js)


@pytest.mark.parametrize("cap,emit_cap", SHAPES, ids=SHAPE_IDS)
def test_packed_programs_match_reference_buffers(cap, emit_cap):
    """``extract_packed`` and ``scan_packed``: the reference's one int64
    buffer [total, overflow, keys, bins, lanes...] holds what the port's
    packed buffer holds (int lanes widened, the float lane bitcast from
    float64); the scan frees nothing."""
    progs = _build_jax(KINDS, DTYPES, cap, 128, 64, emit_cap)
    js, ts = _filled(cap, 128, 64, emit_cap, 3, seed=7)

    def as_ref_buffer(out):
        lanes = [a[0].numpy().view(np.float64).view(np.int64) if a.dtype.is_floating_point
                 else a[0].numpy().astype(np.int64) for a in out.accs]
        return np.concatenate([[int(out.total[0]), int(out.oflow[0])], out.key[0].numpy(),
                               out.bin[0].numpy().astype(np.int64), *lanes])

    packed = progs[5](js, np.int32(1), np.int32(3))
    out = hk.scan_packed(hk.KERNELS, ts, 1, 3, emit_cap)
    assert np.array_equal(as_ref_buffer(out), np.asarray(packed))
    assert_state(ts, js)
    js, packed = progs[4](js, np.int32(0), np.int32(2), np.int32(2))
    out = hk.extract(hk.KERNELS, ts, 0, 2, 2, emit_cap)
    assert np.array_equal(as_ref_buffer(out), np.asarray(packed))
    assert_state(ts, js)


@pytest.mark.parametrize("cap,emit_cap", SHAPES, ids=SHAPE_IDS)
def test_scan_chunks_match_reference_scan(cap, emit_cap):
    """K12 over every chunk the host walks (range(0, cap, emit_cap)):
    positions past cap read slot cap - 1 and are never valid."""
    scan = _build_jax(KINDS, DTYPES, cap, 128, 64, emit_cap)[2]
    js, ts = _filled(cap, 128, 64, emit_cap, 3, seed=3)
    for chunk in range(0, cap, emit_cap):
        k, b, v, accs = scan(js, np.int32(1), np.int32(4), np.int32(chunk))
        out = hk.KERNELS.scan_chunk(ts[:4], 1, 4, chunk, emit_cap)
        for got, want in [(out.key, k), (out.bin, b), (out.valid, v)] + list(zip(out.accs, accs)):
            assert got[0].numpy().tobytes() == np.asarray(want).tobytes()
    assert_state(ts, js)


@pytest.mark.parametrize("below", [-5, 0, 2, 9])
def test_free_matches_reference_free(below):
    free = _build_jax(KINDS, DTYPES, 256, 128, 64, 64)[3]
    js, ts = _filled(256, 128, 64, 64, 3, seed=below + 20)
    js = free(js, np.int32(below))
    hk.KERNELS.free(ts[:4], below)
    assert_state(ts, js)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    cap = 16
    table = (torch.zeros(cap, dtype=torch.int64), torch.zeros(cap, dtype=torch.int32),
             torch.zeros(cap, dtype=torch.bool), [torch.zeros(cap, dtype=torch.int64)])
    with pytest.raises(ValueError, match="power of two"):
        hk.hash_free(tuple(t[:12] if i < 3 else [t[0][:12]] for i, t in enumerate(table)), 0)
    with pytest.raises(ValueError, match="bins"):
        hk.hash_free((table[0], table[1].long(), table[2], table[3]), 0)
    with pytest.raises(ValueError, match="emit_cap"):
        hk.hash_scan_chunk(table, 0, 1, 0, 0)
    meta = tuple(t.to("meta") if i < 3 else [t[0].to("meta")] for i, t in enumerate(table))
    with pytest.raises(ValueError, match="unsupported device"):
        hk.hash_free(meta, 0)
    assert hk.launch_counts() == {"hash_scan_chunk": 0, "hash_scan_walk": 0, "hash_free": 0}
