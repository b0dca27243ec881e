"""K10's exchange (B10 steps 2-3) and K9's probe rounds (B8), the port's
plain versions against the JAX package on the CPU, on the edge cases that
chip_smoke.py also holds the kernels to (``exchange_cases``,
``probe_cases``); a numpy model of the exchange kernel's owner arithmetic
(``__umul64hi`` and one compare, no division) against the reference's
``u // range`` at every range start of every shard count up to 32; and
the wrappers' contract (scratch shapes and dtypes, claim tags, refusals).

The reference's exchange is the body of ``exchange_merge``
(arroyo_tpu/parallel/sharded_agg.py:177-213, 231-234) inside its mesh
step; ``_jax_exchange`` below jits those jnp lines for one shard. Exact
throughout: the send buffers with their fill, the owner-ordered local
rows and their flags, the tables, still flags and overflow counters
byte for byte."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from arroyo_tpu.ops.aggregate import _identity as jax_identity
from arroyo_tpu.ops.aggregate import probe_merge as jax_probe_merge
from arroyo_tpu_torch.ops import sharded_kernels as sk

U64_MAX = (1 << 64) - 1
NP = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
      torch.float64: np.float64, torch.uint64: np.uint64}

EXCHANGE_CASES = chip_smoke.exchange_cases(np.random.default_rng(20261017))
PROBE_CASES = chip_smoke.probe_cases(np.random.default_rng(20261018))


def _bytes_equal(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), f"{what} differs"


# ------------------------------------------------------------------ the owner


def owner_model(u: np.ndarray, S: int) -> np.ndarray:
    """csrc/sharded_agg.cu owner_of on uint64 bits, in numpy: e = the high
    word of u * S (split into 32-bit halves: S <= 32 keeps every partial
    product below 2^38), clamped to S - 1, less one where u < e * R, with
    R = U64_MAX // S + 1 computed once on the host."""
    if S == 1:
        return np.zeros(len(u), np.int64)
    u = u.astype(np.uint64)
    s = np.uint64(S)
    hi, lo = u >> np.uint64(32), u & np.uint64(0xFFFFFFFF)
    e = (hi * s + ((lo * s) >> np.uint64(32))) >> np.uint64(32)
    e = np.minimum(e, np.uint64(S - 1))
    R = np.uint64(U64_MAX // S + 1)
    e = np.where((e > 0) & (u < e * R), e - np.uint64(1), e)
    return e.astype(np.int64)


@pytest.mark.parametrize("S", range(1, 33))
def test_owner_without_division_equals_the_reference(S):
    """The kernel's owner arithmetic and the plain version's owner_of
    equal the reference's min(u // range, S - 1) (as jnp computes it and
    in Python integers) at every range start and either side of it, the
    int64 limits, -1 and random keys."""
    rng = np.random.default_rng(S)
    keys = np.concatenate([chip_smoke.owner_boundary_keys(S),
                           rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 2000,
                                        dtype=np.int64, endpoint=True)])
    u = keys.view(np.uint64)
    if S == 1:
        want = np.zeros(len(keys), np.int64)
    else:
        R = U64_MAX // S + 1
        want = np.array([min(int(x) // R, S - 1) for x in u], np.int64)
        ref = jnp.minimum(jnp.asarray(keys.copy()).astype(jnp.uint64) // jnp.uint64(R),
                          jnp.uint64(S - 1))
        assert np.array_equal(np.asarray(ref).astype(np.int64), want)
    assert np.array_equal(owner_model(u, S), want)
    assert np.array_equal(sk.owner_of(torch.from_numpy(keys.copy()), S).numpy(), want)


# ------------------------------------------------------------------ K10


def _jax_exchange(kinds, dtypes, n_dev, dest_cap, blen):
    """Steps 2-3 of the reference's exchange_merge for one shard (and the
    kept rows of step 5), its jnp lines as they stand there."""
    recv_cap = n_dev * dest_cap

    def f(u_key, u_bin, active, u_accs):
        if n_dev == 1:
            owner = jnp.zeros(blen, dtype=jnp.int32)
        else:
            range_size = jnp.uint64(U64_MAX // n_dev + 1)
            owner = jnp.minimum(
                u_key.astype(jnp.uint64) // range_size, jnp.uint64(n_dev - 1)
            ).astype(jnp.int32)
        owner = jnp.where(active, owner, n_dev)
        order = jnp.argsort(owner)
        o_s = owner[order]
        starts = jnp.searchsorted(o_s, jnp.arange(n_dev, dtype=jnp.int32))
        rank = jnp.arange(blen, dtype=jnp.int32) - starts[jnp.clip(o_s, 0, n_dev - 1)]
        sendable = (o_s < n_dev) & (rank < dest_cap)
        keep_local = (o_s < n_dev) & (rank >= dest_cap)
        slot = jnp.where(sendable, o_s * dest_cap + rank, recv_cap)

        def scatter(src, fill):
            buf = jnp.full((recv_cap,), fill, dtype=src.dtype)
            return buf.at[slot].set(src[order], mode="drop")

        s_key = scatter(u_key, jnp.int64(0))
        s_bin = scatter(u_bin, jnp.int32(0))
        s_valid = jnp.zeros((recv_cap,), dtype=bool).at[slot].set(sendable, mode="drop")
        s_accs = tuple(scatter(u_accs[i], jnp.asarray(jax_identity(kinds[i], dtypes[i])))
                       for i in range(len(kinds)))
        kept = (u_key[order], u_bin[order], keep_local, tuple(a[order] for a in u_accs))
        return (s_key, s_bin, s_valid, s_accs), kept

    return jax.jit(f)


@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=[c["label"] for c in EXCHANGE_CASES])
def test_exchange_plain_equals_jax(case):
    kinds, *u = chip_smoke.exchange_tensors(case, "cpu")
    S, L, dc = case["S"], case["L"], case["dc"]
    dtypes = [NP[dt] for _k, dt in chip_smoke.EXCHANGE_LANES]
    ex = sk.shard_exchange(kinds, *u, dc)
    f = _jax_exchange(kinds, [np.dtype(d) for d in dtypes], S, dc, L)
    recv = S * dc
    sent = 0
    for s in range(S):
        (s_key, s_bin, s_valid, s_accs), (k, b, keep, accs) = f(
            jnp.array(case["key"][s]), jnp.array(case["bins"][s]), jnp.array(case["active"][s]),
            tuple(jnp.array(v[s]) for v in case["vals"]))
        for got, want, what in [(ex.s_key[s], s_key, "s_key"), (ex.s_bin[s], s_bin, "s_bin"),
                                (ex.s_valid[s], s_valid, "s_valid"),
                                (ex.m_key[s, recv:], k, "m_key"), (ex.m_bin[s, recv:], b, "m_bin"),
                                (ex.m_valid[s, recv:], keep, "m_valid")]:
            _bytes_equal(got, want, f"{what}[{s}]")
        for j, (g, w, m, mw) in enumerate(zip(ex.s_accs, s_accs, ex.m_accs, accs)):
            _bytes_equal(g[s], w, f"s_accs[{j}][{s}]")
            _bytes_equal(m[s, recv:], mw, f"m_accs[{j}][{s}]")
        sent += int(np.asarray(s_valid).sum())
    if case["label"] == "every row inactive":
        assert sent == 0 and not ex.m_valid[:, recv:].any()
    if case["label"] == "one owner past dest_cap":
        assert bool(ex.m_valid[:, recv:].any())


def test_exchange_cases_cover_the_tile_edges():
    rows = {c["L"] for c in EXCHANGE_CASES}
    assert {1, sk.EXCHANGE_TILE - 1, sk.EXCHANGE_TILE + 1} <= rows
    assert any(c["L"] > 2 * sk.EXCHANGE_TILE for c in EXCHANGE_CASES)
    assert {1, 2, 3, 5, 7, 8, 32} <= {c["S"] for c in EXCHANGE_CASES}
    assert any(c["dc"] == 1 for c in EXCHANGE_CASES)


# ------------------------------------------------------------------ K9


@pytest.mark.parametrize("case", PROBE_CASES, ids=[c["label"] for c in PROBE_CASES])
def test_probe_merge_plain_equals_jax(case):
    """K9's wrapper on CPU tensors (its plain version) against the JAX
    probe_merge shard by shard: table, still flags, and the overflow
    counter as B9's step adds to it."""
    kinds, table, u, oflow = chip_smoke.probe_tensors(case, "cpu")
    S, cap, mp = case["S"], case["cap"], case["max_probes"]
    oflow0 = oflow.clone()
    still = sk.agg_probe_merge(kinds, table, *u, mp, oflow)
    f = jax.jit(lambda t, k, b, a, v: jax_probe_merge(kinds, t, k, b, a, v, cap, mp))
    keys, bins, occ, accs = case["table"]
    for s in range(S):
        jt = (jnp.array(keys[s]), jnp.array(bins[s]), jnp.array(occ[s]),
              tuple(jnp.array(a[s]) for a in accs))
        (jk, jb, jo, ja), still_j = f(jt, jnp.array(case["u_key"][s]), jnp.array(case["u_bin"][s]),
                                      jnp.array(case["active"][s]),
                                      tuple(jnp.array(a[s]) for a in case["u_accs"]))
        for got, want, what in [(table[0][s], jk, "keys"), (table[1][s], jb, "bins"),
                                (table[2][s], jo, "occ"), (still[s], still_j, "still")]:
            _bytes_equal(got, want, f"{what}[{s}]")
        for j, (g, w) in enumerate(zip(table[3], ja)):
            _bytes_equal(g[s], w, f"accs[{j}][{s}]")
        want_oflow = oflow0[s] + int(np.asarray(still_j).sum(dtype=np.int32))
        assert int(oflow[s]) == int(want_oflow)
    if "one home slot" in case["label"]:
        assert int(still.sum()) > 0  # more partials than rounds: some never placed


def test_hot_home_slot_keys_share_their_first_probe():
    rng = np.random.default_rng(5)
    for cap in (64, 1024, 8192):
        keys = chip_smoke.keys_at_home(rng, 500, 17, cap)
        assert len(np.unique(keys)) == 500
        assert set(chip_smoke.probe_home_np(keys, np.zeros(500, np.int32), cap)) == {17}


def test_probe_cases_cover_what_the_issue_names():
    labels = [c["label"] for c in PROBE_CASES]
    assert any("one home slot, 1 shards" in x for x in labels)
    assert any("one home slot, 8 shards" in x for x in labels)
    assert any(int(c["active"].sum(axis=1).max()) > 1024 for c in PROBE_CASES)
    assert any(c["max_probes"] == 0 for c in PROBE_CASES)
    assert any(c["max_probes"] < 0 for c in PROBE_CASES)


# ------------------------------------------------------------------ the wrappers' contract


def _meta(*shape, dt=torch.int64):
    return torch.zeros(shape, dtype=dt, device="meta")


@pytest.mark.parametrize("S,L,tiles", [(1, 1, 1), (4, 1023, 1), (4, 1024, 1), (8, 1025, 2),
                                       (32, 65536, 64)])
def test_exchange_scratch_shape(S, L, tiles):
    assert sk.exchange_scratch(S, L) == {"counts": ((S, tiles, S + 1), torch.int32)}


@pytest.mark.parametrize("B,bp", [(1, 16), (16, 16), (17, 32), (139264, 139264)])
def test_probe_merge_scratch_shape(B, bp):
    assert sk.probe_merge_scratch(8, B, 65536) == {
        "list": ((8, 2, bp), torch.int64), "code": ((8, bp), torch.uint8),
        "claims": ((8, 65536), torch.int64)}


def test_claim_tags_rise_by_rounds_and_wrap_with_a_zeroed_buffer(monkeypatch):
    monkeypatch.setattr(sk, "_claims_cache", {})
    dev = torch.device("meta")
    buf, t0 = sk._claims(2, 16, dev, 64)
    assert (t0, buf.shape, buf.dtype) == (1, (2, 16), torch.int64)
    buf2, t1 = sk._claims(2, 16, dev, 1)
    assert buf2 is buf and t1 == 65
    _b, other = sk._claims(4, 16, dev, 8)
    assert other == 1  # one buffer and tag sequence per layout
    sk._claims_cache[(2, 16, "meta", None, None)][1] = sk._TAG_LIMIT - 10
    buf3, t2 = sk._claims(2, 16, dev, 11)
    assert buf3 is buf and t2 == 1  # the tags ran out: zeroed, from 1 again
    assert sk._claims(2, 16, dev, 3)[1] == 12


def test_wrappers_refuse_what_the_kernels_do_not_take_without_counting():
    sk.reset_launch_counts()
    kinds = ["count"]
    with pytest.raises(ValueError, match="at most 32"):
        sk.shard_exchange(kinds, _meta(33, 4), _meta(33, 4, dt=torch.int32),
                          _meta(33, 4, dt=torch.bool), [_meta(33, 4)], 4)
    with pytest.raises(ValueError, match="dest_cap"):
        sk.shard_exchange(kinds, _meta(2, 4), _meta(2, 4, dt=torch.int32),
                          _meta(2, 4, dt=torch.bool), [_meta(2, 4)], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.shard_exchange(kinds, _meta(2, 4), _meta(2, 4, dt=torch.int32),
                          _meta(2, 4, dt=torch.bool), [_meta(2, 4)], 4)
    table = (_meta(2, 8), _meta(2, 8, dt=torch.int32), _meta(2, 8, dt=torch.bool), [_meta(2, 8)])
    big = 1 << 31
    with pytest.raises(ValueError, match="int32"):
        sk.agg_probe_merge(kinds, table, _meta(2, big), _meta(2, big, dt=torch.int32),
                           _meta(2, big, dt=torch.bool), [_meta(2, big)], 4)
    with pytest.raises(ValueError, match="max_probes"):
        sk.agg_probe_merge(kinds, table, _meta(2, 4), _meta(2, 4, dt=torch.int32),
                           _meta(2, 4, dt=torch.bool), [_meta(2, 4)], sk._TAG_LIMIT)
    # a negative max_probes is taken as no round, as the reference's loop
    # takes it: the call gets past that check to the device's
    with pytest.raises(ValueError, match="unsupported device"):
        sk.agg_probe_merge(kinds, table, _meta(2, 4), _meta(2, 4, dt=torch.int32),
                           _meta(2, 4, dt=torch.bool), [_meta(2, 4)], -1)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.agg_probe_merge(kinds, table, _meta(2, 4), _meta(2, 4, dt=torch.int32),
                           _meta(2, 4, dt=torch.bool), [_meta(2, 4)], 4)
    cpu = (torch.zeros(2, 6, dtype=torch.int64), torch.zeros(2, 6, dtype=torch.int32),
           torch.zeros(2, 6, dtype=torch.bool), [torch.zeros(2, 6, dtype=torch.int64)])
    with pytest.raises(ValueError, match="power of two"):
        sk.agg_probe_merge(kinds, cpu, torch.zeros(2, 4, dtype=torch.int64),
                           torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.bool),
                           [torch.zeros(2, 4, dtype=torch.int64)], 4)
    counts = sk.launch_counts()
    assert counts["shard_exchange"] == 0 and counts["agg_probe_merge"] == 0
    assert callable(sk.exchange_kernel_launches) and callable(sk.probe_merge_kernel_launches)
    assert callable(sk.probe_merge_cluster)


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    sk.reset_launch_counts()
    c = EXCHANGE_CASES[0]
    kinds, *u = chip_smoke.exchange_tensors(c, "cpu")
    got = sk.shard_exchange(kinds, *u, c["dc"])
    want = sk.shard_exchange_plain(kinds, *u, c["dc"])
    for g, w in zip(list(got[:3]) + list(got.s_accs), list(want[:3]) + list(want.s_accs)):
        assert torch.equal(g.view(torch.uint8) if g.dtype.is_floating_point else g,
                           w.view(torch.uint8) if w.dtype.is_floating_point else w)
    p = PROBE_CASES[2]
    kinds, table, u, oflow = chip_smoke.probe_tensors(p, "cpu")
    sk.agg_probe_merge(kinds, table, *u, p["max_probes"], oflow)
    counts = sk.launch_counts()
    assert counts["shard_exchange"] == 0 and counts["agg_probe_merge"] == 0
