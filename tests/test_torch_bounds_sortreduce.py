"""K6 (join_search_bounds) and K8 (agg_sort_reduce) on their edge cases,
through the port's wrappers on CPU tensors (their plain versions), against
the JAX package under jax.jit on the CPU, byte for byte. The cases are
chip_smoke.py's: the card holds each CUDA kernel to these plain versions on
the same inputs. Also the K8 wrapper's contract (what it refuses, what it
counts), chip_smoke.py's ``sort_reduce_plan`` (the path, passes and
launches the kernel should take, which chip_smoke.py holds the library's
own report to on the card) and the build digest over the sources'
headers."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from arroyo_tpu.ops import join_probe as jjp
from arroyo_tpu.ops.aggregate import sort_reduce as jax_sort_reduce
from arroyo_tpu_torch.ops import join_kernels, kernels
from arroyo_tpu_torch.ops import sharded_kernels as sk

K8_CASES = chip_smoke.sort_reduce_edge_cases(np.random.default_rng(20261017))
K8_LABELS = [c["label"] for c in K8_CASES]
K6_CASES = chip_smoke.join_edge_cases(np.random.default_rng(20261017))
K6_LABELS = [c[0] for c in K6_CASES]
I32 = np.iinfo(np.int32)


def _k8_case(label):
    return next(c for c in K8_CASES if c["label"] == label)


def _jax_per_shard(c):
    """The JAX package's sort_reduce of every shard (jax.vmap over the
    shards): each shard's valid rows, its bins minus the offset as int32."""
    S, L = c["key"].shape
    kinds = tuple(k for k, _ in chip_smoke.K8_EDGE_LANES)
    n_valid = S * L if c["n_valid"] is None else c["n_valid"]
    valid = np.arange(S * L).reshape(S, L) < n_valid
    if c["valid"] is not None:
        valid &= c["valid"]
    b32 = (c["bins"].astype(np.int64) - c["bin_offset"]).astype(np.int32)
    vals = tuple(np.ones((S, L), np.int64) if v is None else v for v in c["vals"])
    f = jax.jit(jax.vmap(lambda k, b, v, vs: jax_sort_reduce(kinds, k, b, v, vs, L)))
    u_key, u_bin, active, u_accs = f(c["key"], b32, valid, vals)
    return [np.asarray(u_key), np.asarray(u_bin), np.asarray(active)] + [
        np.asarray(a) for a in u_accs]


def _same_bytes(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    if got.tobytes() == want.tobytes():
        return
    # a NaN's payload: each side writes its own; every other byte is equal
    assert np.issubdtype(want.dtype, np.floating), f"{what} differs"
    both_nan = np.isnan(got) & np.isnan(want)
    assert np.isnan(got).sum() == np.isnan(want).sum() and both_nan.sum() == np.isnan(got).sum()
    assert got[~both_nan].tobytes() == want[~both_nan].tobytes(), f"{what} differs"


@pytest.mark.parametrize("label", K8_LABELS)
def test_k8_edge_case_bytes_equal_jax(label):
    c = _k8_case(label)
    got = sk.agg_sort_reduce(*chip_smoke.k8_case_tensors(c, "cpu"))
    want = _jax_per_shard(c)
    flat = [got[0], got[1], got[2]] + list(got[3])
    assert len(flat) == len(want)
    for i, (g, w) in enumerate(zip(flat, want)):
        _same_bytes(g, w, f"{label}: output {i}")


@pytest.mark.parametrize("label", K8_LABELS)
def test_k8_plan_of_each_edge_case(label):
    """The path, the passes and the launches each case exists for; the
    live rows as the plan counts them."""
    c = _k8_case(label)
    args = chip_smoke.k8_case_tensors(c, "cpu")
    plan = chip_smoke.sort_reduce_plan(*args[1:4], *args[5:])
    for k, v in c["expect"].items():
        assert plan[k] == v, (k, plan)
    S, L = c["key"].shape
    assert plan["synced"] == (L > chip_smoke.K8_BLOCK_ROWS)
    assert plan["launches"] == (3 if plan["path"] == "block" else 6 + plan["passes"])
    assert sum(plan["shard_live"]) == plan["live"] and len(plan["block_passes"]) == S
    if plan["path"] == "block":
        assert plan["max_live"] <= chip_smoke.K8_BLOCK_ROWS
        assert plan["memsets"] == int(plan["synced"])
    else:
        assert plan["max_live"] > chip_smoke.K8_BLOCK_ROWS
        assert plan["passes"] + plan["skipped"] == (13 if S > 1 else 12)
        assert plan["memsets"] == 2 and plan["block_passes"] == [-1] * S


@pytest.mark.parametrize("label", ["valid (INT64_MAX, INT32_MAX) rows with invalid rows",
                                   "valid (INT64_MAX, INT32_MAX) rows and no invalid row"])
def test_k8_invalid_rows_join_a_valid_max_key_run(label):
    """A valid (INT64_MAX, INT32_MAX) row's run takes the invalid rows: one
    slot of each shard holds that key, active, counting its valid rows
    alone; no inactive padding run beside it."""
    c = _k8_case(label)
    u_key, u_bin, active, accs = sk.agg_sort_reduce(*chip_smoke.k8_case_tensors(c, "cpu"))
    count = accs[[k for k, _ in chip_smoke.K8_EDGE_LANES].index("count")]
    for d in range(u_key.shape[0]):
        at = (u_key[d] == np.iinfo(np.int64).max) & (u_bin[d] == I32.max)
        assert int(at.sum()) == 1 and bool(active[d][at].all())
        assert int(count[d][at]) == 5


@pytest.mark.parametrize("shape,n_valid,passes,launches", [
    ((1, 8192), None, 0, 3),           # one block, no read-back
    ((4, 8192), 100, 0, 3),
    ((1, 9000), 8192, 0, 3),           # read back: every shard fits a block
    ((1, 9000), None, 12, 18),         # onesweep at one shard: no shard digit
    ((3, 9000), None, 13, 19),         # and with the shard digit
    ((2, 20000), 20000, 12, 18),       # the live rows all in shard 0
])
def test_k8_launches_per_call(shape, n_valid, passes, launches):
    """Kernel launches of one K8 call as the plan models the library's count: three on
    the one-block path, else the compaction's two, one per digit position
    that varies, the runs' count and scan, the reduce and the long-run
    walk."""
    S, L = shape
    rng = np.random.default_rng(L + S)
    key = torch.from_numpy(rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                                        (S, L), dtype=np.int64))
    bins = torch.from_numpy(rng.integers(I32.min, I32.max, (S, L)).astype(np.int32))
    plan = chip_smoke.sort_reduce_plan(key, bins, None, 0, n_valid)
    assert (plan["passes"], plan["launches"]) == (passes, launches)


def test_k8_refuses_what_the_kernel_cannot_take_without_counting():
    sk.reset_launch_counts()
    meta = lambda *shape, dt=torch.int64: torch.zeros(shape, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        sk.agg_sort_reduce(["count"], meta(2, 4), meta(2, 4, dt=torch.int32), None, [None])
    with pytest.raises(ValueError, match="int32"):
        sk.agg_sort_reduce(["count"], meta(2, 1 << 30), meta(2, 1 << 30, dt=torch.int32), None,
                           [None])
    with pytest.raises(ValueError, match="at most 256"):
        sk.agg_sort_reduce(["count"], meta(257, 4), meta(257, 4, dt=torch.int32), None, [None])
    assert sk.launch_counts()["agg_sort_reduce"] == 0


def test_k8_counts_cpu_calls_nowhere_and_resets():
    """A CPU call takes the plain version and counts no launch; reset
    zeroes every wrapper's count."""
    c = _k8_case("a shard with one live row")
    sk.agg_sort_reduce.launches = 5
    sk.reset_launch_counts()
    sk.agg_sort_reduce(*chip_smoke.k8_case_tensors(c, "cpu"))
    assert sk.launch_counts()["agg_sort_reduce"] == 0


@pytest.mark.parametrize("label", K6_LABELS)
def test_k6_bounds_equal_jax_searchsorted(label):
    """lo and hi of the plain K6 over the K5-sorted build keys equal the JAX
    probe's jnp.searchsorted left and right, dtypes included."""
    lk, rk = next(c for c in K6_CASES if c[0] == label)[1:]
    sk_t, _order = join_kernels.join_sort_pairs(torch.from_numpy(rk))
    lo, hi = join_kernels.join_search_bounds(sk_t, torch.from_numpy(lk))
    _order_j, lo_j, hi_j = jjp._probe_jit()(lk, rk)
    for got, want in ((lo, lo_j), (hi, hi_j)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()


def test_build_digest_covers_included_headers(tmp_path):
    """Editing a header a source includes (here two levels down) renames
    its build, so a stale library is never loaded."""
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "b.cuh"\nint x;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("#define N 1\n")
    first = kernels.source_digest(tmp_path / "a.cu")
    assert kernels.source_digest(tmp_path / "a.cu") == first
    (tmp_path / "c.cuh").write_text("#define N 2\n")
    assert kernels.source_digest(tmp_path / "a.cu") != first


def test_the_port_sources_include_the_shared_radix_header():
    """K5 and K8 sort with csrc/radix_sort.cuh: their digests hash it."""
    for name in ("join_probe", "sharded_agg"):
        text = (kernels._PKG / "csrc" / f"{name}.cu").read_text()
        assert '#include "radix_sort.cuh"' in text
