"""K7's packed output and walk, K13's word walk, and the shared staging.

- K7 (``kernels.slot_gather``) writes one packed buffer: its int64 and
  float64 views hold the bytes of the plain version's separate buffers,
  the float part at a 16-byte boundary (``packed=True`` hands it back), for every lane
  set of tests/test_torch_slot_gather.py and k of 1, 3, 4, 5, 64 and 1000.
- A numpy model of K7's walk (csrc/slot_agg.cu ``gather_kernel``: the lane
  on blockIdx.y, a quad of four gathered positions a thread, grid-stride,
  the scalar tail at k % 4 and off 16-byte boundaries) against the
  reference's jitted ``make_read_slots``. Slots outside [0, cap) read 0 in
  the port (the reference's gather clamps them instead, and no caller
  passes one): there the model is held to zeros.
- A numpy model of K13's word walk (csrc/hash_agg.cu ``free_words``: a
  16-slot word of occupancy a thread, bins loaded only for a word with an
  occupied slot, a store only where the word changed, bytes past the last
  whole word and unaligned arrays slot by slot) against the reference's
  ``free``.
- ``staging.stage`` hands back the arrays it was given, each 16-byte
  aligned in one buffer, on the CPU.
"""

import numpy as np
import pytest
import torch

from arroyo_tpu.ops.aggregate import _build_jax
from arroyo_tpu.ops.slot_agg import _build_slot_jax
from arroyo_tpu_torch.ops import hash_kernels, kernels, staging
from test_torch_slot_gather import IDS, LANES, _state

KS = [1, 3, 4, 5, 64, 1000]
I32 = np.iinfo(np.int32)


def _lanes(dtypes, cap, seed):
    return [torch.from_numpy(a) for a in _state(np.random.default_rng(seed), dtypes, cap)]


@pytest.mark.parametrize("kinds,dtypes", LANES, ids=IDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("idx_dt", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_packed_output_carves_to_the_separate_buffers(kinds, dtypes, k, idx_dt):
    cap = 2048
    state = _lanes(dtypes, cap, k)
    slots = torch.from_numpy(np.random.default_rng(k + 1).integers(-2, cap + 2, k)).to(idx_dt)
    n_flt = sum(1 for d in dtypes if np.issubdtype(d, np.floating))
    n_int = len(dtypes) - n_flt
    ib, fb, packed = kernels.slot_gather(state, slots, packed=True)
    f_off = -(-n_int * k * 8 // 16) * 16
    assert packed.dtype == torch.uint8 and packed.numel() == -(-(f_off + n_flt * k * 8) // 16) * 16
    pib, pfb = kernels.slot_gather_plain(state, slots)
    assert ib.dtype == torch.int64 and fb.dtype == torch.float64
    assert ib.numpy().tobytes() == pib.numpy().tobytes()
    assert fb.numpy().tobytes() == pfb.numpy().tobytes()
    raw = packed.numpy()
    assert raw[:n_int * k * 8].tobytes() == pib.numpy().tobytes()
    assert raw[f_off: f_off + n_flt * k * 8].tobytes() == pfb.numpy().tobytes()
    # a call that makes its own buffer gives the same views
    ib2, fb2 = kernels.slot_gather(state, slots)
    assert ib2.numpy().tobytes() == pib.numpy().tobytes()
    assert fb2.numpy().tobytes() == pfb.numpy().tobytes()


def test_packed_output_views_lie_in_the_buffer():
    """ibuf from byte 0, fbuf from the 16-byte boundary past it: the one
    buffer ``read_slots`` fetches holds both, and an empty class is an
    empty view."""
    state = [torch.arange(8, dtype=torch.int64), torch.arange(8, dtype=torch.float32)]
    slots = torch.arange(3, dtype=torch.int32)
    ib, fb, packed = kernels.slot_gather(state, slots, packed=True)
    assert ib.data_ptr() == packed.data_ptr()
    assert fb.data_ptr() - packed.data_ptr() == 32 and packed.numel() == 64
    ib, fb, packed = kernels.slot_gather(state[1:], slots, packed=True)
    assert ib.numel() == 0 and fb.data_ptr() == packed.data_ptr() and packed.numel() == 32


# ------------------------------------------------------------- K7's walk


def _widen(a: np.ndarray, i: int) -> int:
    """A state word widened to 64 bits, as its uint64 bits (csrc/slot_agg.cu
    widen_f32: a float32 subnormal to the zero of its sign)."""
    v = a[i]
    if a.dtype == np.float32:
        if v != 0 and abs(v) < np.finfo(np.float32).tiny:
            v = v * np.float32(0)
        return int(np.float64(v).view(np.uint64))
    if a.dtype == np.int32:
        return int(np.int64(v).view(np.uint64))
    return int(np.asarray(v).view(np.uint64))


def k7_model(lanes, slots: np.ndarray, cap: int, threads: int, grid_x: int,
             slots_offset: int = 0) -> tuple[np.ndarray, dict]:
    """csrc/slot_agg.cu gather_kernel, walked in numpy over its grid: the
    packed output's uint64 words, and how many quads took the vector path
    for the slots and for the stores. The output buffer is 16-byte aligned;
    the slots start ``slots_offset`` elements past a 16-byte boundary."""
    k = len(slots)
    is_flt = [a.dtype.kind == "f" for a in lanes]
    n_int = is_flt.count(False)
    f_off = -(-n_int * k * 8 // 16) * 16 // 8  # in words
    out = np.full(f_off + is_flt.count(True) * k, 0xA5A5A5A5A5A5A5A5, dtype=np.uint64)
    rows, n_i, n_f = [], 0, 0
    for f in is_flt:
        rows.append(f_off + n_f * k if f else n_i * k)
        n_f, n_i = n_f + f, n_i + (not f)
    slots_vec = (slots_offset * slots.dtype.itemsize) % 16 == 0
    nq = (k + 3) // 4
    stats = {"vector slot loads": 0, "vector stores": 0, "scalar quads": 0}
    for l, a in enumerate(lanes):  # blockIdx.y
        out_vec = (rows[l] * 8) % 16 == 0
        for tid in range(grid_x * threads):
            for q in range(tid, nq, grid_x * threads):
                i0 = 4 * q
                full = i0 + 4 <= k
                if full and slots_vec:
                    s = [int(x) for x in slots[i0:i0 + 4]]
                    stats["vector slot loads"] += 1
                else:
                    s = [int(slots[i0 + e]) if i0 + e < k else -1 for e in range(4)]
                w = [_widen(a, x) if 0 <= x < cap else 0 for x in s]
                if full and out_vec:
                    stats["vector stores"] += 1
                else:
                    stats["scalar quads"] += 1
                for e in range(4):
                    if i0 + e < k:
                        out[rows[l] + i0 + e] = w[e]
    return out, stats


@pytest.mark.parametrize("kinds,dtypes", LANES, ids=IDS)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 6, 7, 64, 1001])
@pytest.mark.parametrize("slots_offset", [0, 1])
def test_k7_walk_model_matches_make_read_slots(kinds, dtypes, k, slots_offset):
    cap = 512
    rng = np.random.default_rng(k * 7 + slots_offset)
    lanes = _state(rng, dtypes, cap)
    slots = rng.integers(-3, cap + 3, k).astype(np.int32)
    edge = np.array([0, cap - 1, 0, -1, cap, cap - 1], np.int32)
    slots[:min(k, len(edge))] = edge[:min(k, len(edge))]
    if k > 10:
        slots[-4:] = slots[5]  # duplicates
    threads = 32
    grid_x = max(1, min(-(-((k + 3) // 4) // threads), 2))  # a thread takes several quads at 1001
    got, stats = k7_model(lanes, slots, cap, threads, grid_x, slots_offset)
    assert stats["scalar quads"] + stats["vector stores"] == len(lanes) * ((k + 3) // 4)
    if slots_offset:
        assert stats["vector slot loads"] == 0
    ok = (slots >= 0) & (slots < cap)
    k_pad = 64
    while k_pad < k:
        k_pad *= 2
    padded = np.zeros(k_pad, np.int32)
    padded[:k] = np.where(ok, slots, 0)
    want = [np.asarray(o)[:k] for o in _build_slot_jax(kinds, dtypes, cap, 256)[4](k_pad)(
        tuple(lanes), padded)]
    n_int = sum(1 for d in dtypes if not np.issubdtype(d, np.floating))
    f_off = -(-n_int * k * 8 // 16) * 16 // 8
    ii = fi = 0
    for d, w in zip(dtypes, want):
        if np.issubdtype(d, np.floating):
            row, fi = got[f_off + fi * k: f_off + (fi + 1) * k], fi + 1
        else:
            row, ii = got[ii * k: (ii + 1) * k], ii + 1
        assert row[ok].tobytes() == w.view(np.uint64)[ok].tobytes()
        assert (row[~ok] == 0).all()
    # the port's plain version, carved, gives the same words
    _ib, _fb, packed = kernels.slot_gather([torch.from_numpy(a) for a in lanes],
                                           torch.from_numpy(slots), packed=True)
    assert packed.numpy().view(np.uint64)[:len(got)].tobytes() == got.tobytes()


# ------------------------------------------------------------- K13's walk


def k13_model(occ: np.ndarray, bins: np.ndarray, below: int, aligned: bool = True):
    """csrc/hash_agg.cu free_words in numpy: occ (uint8) changed in place;
    returns the counts of word loads, bins loaded and words stored."""
    cap = len(occ)
    n = {"occ words": 0, "bins loaded": 0, "words stored": 0, "slot stores": 0}
    for w in range((cap + 15) // 16):
        j0 = 16 * w
        if aligned and j0 + 16 <= cap:
            word = occ[j0:j0 + 16].copy()
            n["occ words"] += 1
            if not word.any():
                continue
            b = bins[j0:j0 + 16]
            n["bins loaded"] += 16
            new = np.where(b >= below, word, 0).astype(np.uint8)
            if (new != word).any():
                occ[j0:j0 + 16] = new
                n["words stored"] += 1
        else:
            for j in range(j0, min(j0 + 16, cap)):
                if occ[j]:
                    n["bins loaded"] += 1
                    if bins[j] < below:
                        occ[j] = 0
                        n["slot stores"] += 1
    return n


@pytest.mark.parametrize("cap", [1, 15, 16, 17, 4096 + 5])
@pytest.mark.parametrize("below", [int(I32.min), 0, 2, int(I32.max)],
                         ids=["int32 min", "0", "mid bin", "int32 max"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_k13_word_walk_matches_reference_free(cap, below, aligned):
    rng = np.random.default_rng(cap + below % 1000)
    occ = rng.random(cap) < 0.5
    occ[: min(cap, 32)] = False  # two whole empty words (where cap holds them)
    occ[-1] = True
    bins = rng.integers(-1, 5, cap).astype(np.int32)
    if cap > 64:
        occ[48:64] = True
        bins[48:64] = 4  # a whole occupied word that nothing frees
    free = _build_jax(("sum",), (np.int64,), 16, 16, 4, 4)[3]
    state = (np.zeros(cap, np.int64), bins, occ, (np.zeros(cap, np.int64),), np.int32(0))
    want = np.asarray(free(state, np.int32(below))[2])
    got = occ.astype(np.uint8)
    n = k13_model(got, bins, below, aligned)
    assert got.astype(bool).tobytes() == want.tobytes()
    whole = cap // 16 if aligned else 0
    assert n["occ words"] == whole
    if aligned and cap >= 32:
        # the empty words load no bins and store nothing
        assert n["bins loaded"] <= 16 * (whole - 2) + (cap - 16 * whole)
    # a store only where a word changed: never more stores than freed slots
    freed = int(occ.sum() - want.sum())
    assert n["words stored"] + n["slot stores"] <= freed
    assert (n["words stored"] + n["slot stores"] == 0) == (freed == 0)
    # the port's entry on the same arrays (its plain version on the CPU)
    occ_t, bins_t = torch.from_numpy(occ.copy()), torch.from_numpy(bins)
    hash_kernels.free_below(bins_t, occ_t, below)
    assert occ_t.numpy().tobytes() == want.tobytes()


def test_free_below_refuses_what_the_kernel_does_not_take():
    occ, bins = torch.zeros(17, dtype=torch.bool), torch.zeros(17, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 bins"):
        hash_kernels.free_below(bins.long(), occ, 0)
    with pytest.raises(ValueError, match="int32 bins"):
        hash_kernels.free_below(bins[:16], occ, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        hash_kernels.free_below(bins.to("meta"), occ.to("meta"), 0)
    assert hash_kernels.launch_counts()["hash_free"] == 0


# ------------------------------------------------------------- staging


@pytest.mark.parametrize("lengths", [[1], [3, 5, 7], [0, 9, 1], [1001, 2, 33, 4]],
                         ids=["one", "odd", "an empty one", "mixed"])
def test_stage_returns_the_arrays_it_was_given(lengths):
    rng = np.random.default_rng(sum(lengths))
    dts = [np.int32, np.int64, np.float32, np.float64, np.uint64, np.bool_, np.int8]
    arrays = []
    for i, n in enumerate(lengths):
        dt = np.dtype(dts[i % len(dts)] if len(lengths) > 1 else np.uint64)
        if dt == np.bool_:
            a = rng.random(n) < 0.5
        elif dt.kind == "f":
            a = rng.normal(0, 1e3, n).astype(dt)
        else:
            a = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt, endpoint=True)
        arrays.append(a)
    arrays.append(np.arange(20, dtype=np.int64)[::3])  # not contiguous
    views, host = staging.stage(arrays, torch.device("cpu"))
    nbytes, offs = staging.aligned(a.nbytes for a in arrays)
    assert host.dtype == torch.uint8 and host.numel() == nbytes and not host.is_pinned()
    base = host.data_ptr()
    for v, a, off in zip(views, arrays, offs):
        assert off % 16 == 0 and v.numel() == len(a)
        assert v.numpy().dtype == a.dtype and v.numpy().tobytes() == a.tobytes()
        assert v.numel() == 0 or v.data_ptr() == base + off
    # uint64 bits as int64 where the caller stages them so
    u = np.array([0, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    (v,), _ = staging.stage([u], torch.device("cpu"), [torch.int64])
    assert v.dtype == torch.int64 and v.numpy().tobytes() == u.tobytes()
    with pytest.raises(ValueError, match="does not stage"):
        staging.stage([u], torch.device("cpu"), [torch.int32])
