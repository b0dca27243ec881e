"""K10's spill append (B10 step 7), on the CPU: the port's plain version
against the reference's step 7, a numpy model of the kernel's tile walk
(csrc/table_compact.cuh, SPILL mode) against the same, and the wrapper's
contract (its state buffer's size, refusals before any launch).

The reference is the end of ``exchange_merge``
(arroyo_tpu/parallel/sharded_agg.py:243-259): per shard, the still-active
partials append in index order from ``sp_fill``, those past ``spill_cap``
are dropped and counted in ``oflow``. ``_jax_step7`` jits those jnp lines
for one shard; ``reference_step7`` is their numpy copy, held to it first.
The cases are chip_smoke.py's ``spill_cases``, which the card holds the
kernel to, and a sweep of fills from 0 to spill_cap inclusive. Exact
throughout: every spill row's bits, the fill and the overflow."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from arroyo_tpu.ops.aggregate import _identity as jax_identity  # noqa: F401 - 64-bit JAX
from arroyo_tpu_torch.ops import sharded_kernels as sk

CASES = chip_smoke.spill_cases(np.random.default_rng(20261017))
TILE = sk.COMPACT_TILE


def _np(spill) -> list:
    """A spill buffer's arrays as numpy copies, lanes as their bits."""
    sp_key, sp_bin, sp_fill, sp_accs, oflow = spill
    return [sp_key.numpy().copy(), sp_bin.numpy().copy(), sp_fill.numpy().copy(),
            [sk.bits(a).numpy().copy() for a in sp_accs], oflow.numpy().copy()]


def _inputs(c: dict):
    kinds, c_key, c_bin, c_accs, still, spill = chip_smoke.spill_tensors(c, torch.device("cpu"))
    return kinds, c_key, c_bin, c_accs, still, spill


def reference_step7(still, c_key, c_bin, c_accs, spill) -> list:
    """The reference's step 7 in numpy, shard by shard: sidx = fill +
    cumsum(still) - 1, rows with sidx < spill_cap written there, the rest
    dropped; fill = min(fill + spilled, spill_cap); oflow += the dropped."""
    sp_key, sp_bin, sp_fill, sp_accs, oflow = [x.copy() if not isinstance(x, list)
                                               else [a.copy() for a in x] for x in spill]
    S, sc = sp_key.shape
    for s in range(S):
        sidx = sp_fill[s] + np.cumsum(still[s].astype(np.int32)) - 1
        ok = still[s] & (sidx < sc)
        pos = sidx[ok]
        sp_key[s, pos] = c_key[s, ok]
        sp_bin[s, pos] = c_bin[s, ok]
        for dst, src in zip(sp_accs, c_accs):
            dst[s, pos] = src[s, ok]
        n_spilled = np.int32(ok.sum())
        oflow[s] += np.int32(still[s].sum()) - n_spilled
        sp_fill[s] = min(sp_fill[s] + n_spilled, sc)
    return [sp_key, sp_bin, sp_fill, sp_accs, oflow]


def _jax_step7(spill_cap_):
    """The reference's step 7 for one shard, its jnp lines as they stand
    there (lanes as int64 / int32 bits: the scatter moves them unchanged)."""

    @jax.jit
    def f(still_active, c_key, c_bin, c_accs, sp_key, sp_bin, sp_fill, sp_accs, oflow_t):
        sidx = sp_fill + jnp.cumsum(still_active.astype(jnp.int32)) - 1
        ok = still_active & (sidx < spill_cap_)
        pos = jnp.where(ok, sidx, spill_cap_)
        sp_key = sp_key.at[pos].set(c_key, mode="drop")
        sp_bin = sp_bin.at[pos].set(c_bin, mode="drop")
        sp_accs = tuple(sp_accs[i].at[pos].set(c_accs[i], mode="drop")
                        for i in range(len(c_accs)))
        n_spilled = jnp.sum(ok, dtype=jnp.int32)
        n_lost = jnp.sum(still_active, dtype=jnp.int32) - n_spilled
        sp_fill = jnp.minimum(sp_fill + n_spilled, spill_cap_)
        oflow_t = oflow_t + n_lost
        return sp_key, sp_bin, sp_fill, sp_accs, oflow_t

    return f


def spill_walk_model(still, c_key, c_bin, c_accs, spill) -> list:
    """The SPILL mode of csrc/table_compact.cuh in numpy: per shard, tiles
    of TILE flags; each tile's count; tile 0 publishes fill + its count, so
    every tile's prefix P already holds the fill; the tile's rows go to
    P + rank while below spill_cap; the shard's last tile writes fill =
    min(P_total, sc) and adds max(P_total - sc, 0) to oflow."""
    sp_key, sp_bin, sp_fill, sp_accs, oflow = [x.copy() if not isinstance(x, list)
                                               else [a.copy() for a in x] for x in spill]
    S, M = still.shape
    sc = sp_key.shape[1]
    tiles = -(-M // TILE)
    for s in range(S):
        counts = [int(still[s, t * TILE:(t + 1) * TILE].sum()) for t in range(tiles)]
        for t in range(tiles):
            # the look-back: the covering word of tile 0 holds the fill
            P = int(sp_fill[s]) + sum(counts[:t])
            flagged = t * TILE + np.flatnonzero(still[s, t * TILE:(t + 1) * TILE])
            n_rows = counts[t] if P + counts[t] <= sc else max(sc - P, 0)
            dst = P + np.arange(n_rows)
            sp_key[s, dst] = c_key[s, flagged[:n_rows]]
            sp_bin[s, dst] = c_bin[s, flagged[:n_rows]]
            for d, src in zip(sp_accs, c_accs):
                d[s, dst] = src[s, flagged[:n_rows]]
        done = int(sp_fill[s]) + sum(counts)
        sp_fill[s] = min(done, sc)
        oflow[s] += max(done - sc, 0)
    return [sp_key, sp_bin, sp_fill, sp_accs, oflow]


def _same(got: list, want: list, what: str) -> None:
    names = ("keys", "bins", "fill", "lanes", "overflow")
    for name, g, w in zip(names, got, want):
        if name == "lanes":
            for j, (gl, wl) in enumerate(zip(g, w)):
                assert gl.dtype == wl.dtype and gl.tobytes() == wl.tobytes(), f"{what}: lane {j}"
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{what}: {name}"


def _case_arrays(c: dict):
    kinds, c_key, c_bin, c_accs, still, spill = _inputs(c)
    src = (still.numpy(), c_key.numpy(), c_bin.numpy(), [sk.bits(a).numpy() for a in c_accs])
    return kinds, (c_key, c_bin, c_accs, still, spill), src


@pytest.mark.parametrize("c", CASES, ids=[c["label"] for c in CASES])
def test_plain_version_matches_the_reference_step7(c):
    """Each of ``calls`` appends in a row: the wrapper on the CPU (the plain
    version) against the numpy reference."""
    kinds, (c_key, c_bin, c_accs, still, spill), src = _case_arrays(c)
    want = _np(spill)
    for i in range(c["calls"]):
        sk.shard_spill(kinds, c_key, c_bin, c_accs, still, spill)
        want = reference_step7(*src, want)
        _same(_np(spill), want, f"{c['label']}, call {i}")


@pytest.mark.parametrize("c", CASES, ids=[c["label"] for c in CASES])
def test_tile_walk_model_matches_the_reference_step7(c):
    _kinds, (_k, _b, _a, _s, spill), src = _case_arrays(c)
    want = got = _np(spill)
    for i in range(c["calls"]):
        want = reference_step7(*src, want)
        got = spill_walk_model(*src, got)
        _same(got, want, f"{c['label']}, call {i}")


FILL_SC = 48
FILL_MS = (1, 15, TILE - 1, TILE, TILE + 1, 3 * TILE + 5)
FILLS = (0, 1, FILL_SC // 2, FILL_SC - 1, FILL_SC)


def _fill_case(M: int, fill: int, p: float = 0.01) -> dict:
    rng = np.random.default_rng(M * 131 + fill)
    still = rng.random((3, M)) < p
    still[1] = False  # an empty shard
    still[2, -1] = True  # a row at the shard's last slot
    return {"label": f"M {M} fill {fill}", "S": 3, "M": M, "sc": FILL_SC, "still": still,
            "fill": np.array([fill, fill, max(fill - 1, 0)], dtype=np.int32), "calls": 1,
            "lanes": chip_smoke.SPILL_LANES[:3]}


@pytest.mark.parametrize("M", FILL_MS)
@pytest.mark.parametrize("fill", FILLS)
def test_every_fill_up_to_spill_cap(M, fill):
    """Fills 0 to spill_cap inclusive at M inside one tile, at a tile's
    edges and past three tiles: the plain version and the walk model equal
    the reference."""
    c = _fill_case(M, fill, p=min(1.0, 30 / M))
    kinds, (c_key, c_bin, c_accs, still, spill), src = _case_arrays(c)
    before = _np(spill)
    want = reference_step7(*src, before)
    _same(spill_walk_model(*src, before), want, c["label"])
    sk.shard_spill(kinds, c_key, c_bin, c_accs, still, spill)
    _same(_np(spill), want, c["label"])


@pytest.mark.parametrize("c", [c for c in CASES if c["S"] * c["M"] <= 1 << 16],
                         ids=lambda c: c["label"])
def test_numpy_reference_is_the_jax_step7(c):
    """The numpy copy of step 7 against its jnp lines, jitted, shard by
    shard (lanes as their bits)."""
    _kinds, (_k, _b, _a, _s, spill), src = _case_arrays(c)
    still, c_key, c_bin, c_accs = src
    before = _np(spill)
    want = reference_step7(*src, before)
    f = _jax_step7(c["sc"])
    for s in range(c["S"]):
        out = f(jnp.asarray(still[s]), jnp.asarray(c_key[s]), jnp.asarray(c_bin[s]),
                tuple(jnp.asarray(a[s]) for a in c_accs), jnp.asarray(before[0][s]),
                jnp.asarray(before[1][s]), jnp.asarray(before[2][s]),
                tuple(jnp.asarray(a[s]) for a in before[3]), jnp.asarray(before[4][s]))
        got = [np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2]),
               [np.asarray(a) for a in out[3]], np.asarray(out[4])]
        w = [want[0][s], want[1][s], want[2][s], [a[s] for a in want[3]], want[4][s]]
        _same(got, w, f"{c['label']}, shard {s}")


def test_cases_cover_what_the_kernel_must_show():
    labels = [c["label"] for c in CASES]
    assert any(c["still"].sum() == 0 for c in CASES)  # every shard empty
    assert any((c["fill"] == c["sc"]).all() and c["still"].any() for c in CASES)
    assert any(c["M"] % 16 for c in CASES)
    assert any(c["M"] < TILE for c in CASES) and any(c["M"] > 3 * TILE for c in CASES)
    assert any(c["calls"] > 1 for c in CASES)
    q7m = [c for c in CASES if c["label"].startswith("q7m")]
    assert q7m and all((c["S"], c["M"]) == (8, 139264) for c in q7m)
    exhausted = []
    for c in CASES:
        _kinds, _t, src = _case_arrays(c)
        exhausted.append(int(reference_step7(*src, _np(_t[4]))[4].sum()
                             - _t[4][4].sum()) > 0)
    assert sum(exhausted) >= 3, dict(zip(labels, exhausted))


def test_state_buffer_is_one_word_a_tile_and_a_ticket():
    assert sk.spill_scratch_bytes(8, 139264) == 8 * (1 + 8 * 34)
    assert sk.spill_scratch_bytes(1, 1) == 16
    assert sk.spill_scratch_bytes(3, TILE) == 8 * 4 and sk.spill_scratch_bytes(3, TILE + 1) == 8 * 7
    st = sk.spill_scratch(2, 5000, torch.device("cpu"))
    assert st.dtype == torch.uint8 and st.numel() == 8 * 5 and not st.any()


def _meta(*shape, dt=torch.int64):
    return torch.empty(shape, dtype=dt, device="meta")


def test_wrapper_refuses_what_the_kernel_does_not_take_without_counting():
    sk.reset_launch_counts()
    kinds = ["count"]
    spill = (_meta(2, 8), _meta(2, 8, dt=torch.int32), _meta(2, dt=torch.int32), [_meta(2, 8)],
             _meta(2, dt=torch.int32))
    big = 1 << 31
    with pytest.raises(ValueError, match="32 bits"):
        sk.shard_spill(kinds, _meta(2, big), _meta(2, big, dt=torch.int32), [_meta(2, big)],
                       _meta(2, big, dt=torch.bool), spill)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.shard_spill(kinds, _meta(2, 4), _meta(2, 4, dt=torch.int32), [_meta(2, 4)],
                       _meta(2, 4, dt=torch.bool), spill)
    cpu = lambda *s, dt=torch.int64: torch.zeros(s, dtype=dt)  # noqa: E731
    cspill = (cpu(2, 8), cpu(2, 8, dt=torch.int32), cpu(2, dt=torch.int32), [cpu(2, 8)],
              cpu(2, dt=torch.int32))
    with pytest.raises(ValueError, match="3 shards of partials for a spill buffer of 2"):
        sk.shard_spill(kinds, cpu(3, 4), cpu(3, 4, dt=torch.int32), [cpu(3, 4)],
                       cpu(3, 4, dt=torch.bool), cspill)
    with pytest.raises(TypeError, match="still"):
        sk.shard_spill(kinds, cpu(2, 4), cpu(2, 4, dt=torch.int32), [cpu(2, 4)],
                       cpu(2, 4, dt=torch.int32), cspill)
    with pytest.raises(ValueError, match="spill fill must be a contiguous int32"):
        sk.shard_spill(kinds, cpu(2, 4), cpu(2, 4, dt=torch.int32), [cpu(2, 4)],
                       cpu(2, 4, dt=torch.bool), cspill[:2] + (cpu(2),) + cspill[3:])
    with pytest.raises(ValueError, match="one lane per kind"):
        sk.shard_spill(kinds, cpu(2, 4), cpu(2, 4, dt=torch.int32), [],
                       cpu(2, 4, dt=torch.bool), cspill)
    assert sk.launch_counts()["shard_spill"] == 0
    assert callable(sk.spill_kernel_launches)


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    sk.reset_launch_counts()
    c = CASES[2]
    kinds, c_key, c_bin, c_accs, still, spill = _inputs(c)
    sk.shard_spill(kinds, c_key, c_bin, c_accs, still, spill)
    assert sk.launch_counts()["shard_spill"] == 0
