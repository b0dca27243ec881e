"""The plain PyTorch version of the segment kernel's key hash (B1: splitmix64
over int64 tensors with wrapping multiplies and masked logical shifts)
against arroyo_tpu's host hash (hashing.hash_columns, which decides shuffle
ownership) and its traced twin (_hash_columns_jnp), bit for bit."""

import jax
import numpy as np
import pytest
import torch

from arroyo_tpu import hashing as jhashing
from arroyo_tpu.engine.segment import _hash_columns_jnp, _splitmix64_jnp
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch import hashing as thashing

I64 = np.iinfo(np.int64)


def _columns():
    rng = np.random.default_rng(7)
    n = 257
    i64 = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    # top bit set and clear around the constants' carries, and the bounds
    i64[:8] = [0, -1, I64.min, I64.max, 1, -(1 << 62), 0x61C8864680B583EB, -0x61C8864680B583EB]
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    u64[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    f64 = rng.normal(size=n)
    f64[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324]
    f32 = f64.astype(np.float32)
    f32[5] = 1.5
    return {
        "int64": i64, "uint64": u64, "float64": f64, "float32": f32,
        "int32": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "int16": rng.integers(-2**15, 2**15 - 1, n).astype(np.int16),
        "int8": rng.integers(-128, 127, n).astype(np.int8),
        "uint8": rng.integers(0, 255, n).astype(np.uint8),
        "bool": rng.random(n) < 0.5,
    }


def _tval(a):
    t = torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
    return texpr.TVal(t, a.dtype)


def test_splitmix64_matches_host_and_traced_twin():
    x = _columns()["int64"]
    got = texpr.splitmix64_torch(torch.from_numpy(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, jhashing.splitmix64(x.view(np.uint64)))
    np.testing.assert_array_equal(got, np.asarray(_splitmix64_jnp(x.view(np.uint64))))


def _traced(cols):
    """The JAX package's traced key hash as its compiled segment runs it
    (under jax.jit; op by op, XLA reads subnormals as they are)."""
    return jax.jit(lambda *c: _hash_columns_jnp(list(c)))(*cols)


def _normal_rows(cols) -> np.ndarray:
    """Rows where no float column holds a subnormal: there the traced hash
    (which reads a subnormal as the zero of its sign, as XLA's CPU code
    does) and the host hash (numpy) agree."""
    ok = np.ones(len(cols[0]), dtype=bool)
    for c in cols:
        if c.dtype.kind == "f":
            ok &= ~((c != 0) & (np.abs(c) < np.finfo(c.dtype).tiny))
    return ok


@pytest.mark.parametrize("dtype", sorted(_columns()))
def test_hash_column_matches_jax(dtype):
    """The traced hash equals the JAX package's traced twin on every row
    (float subnormals hashed as 0.0, C9), the port's host hash equals the
    JAX package's host hash, and the two agree off the subnormals."""
    col = _columns()[dtype]
    got = texpr.hash_column_torch(_tval(col)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np.asarray(_traced([col])))
    host = thashing.hash_column(col)
    np.testing.assert_array_equal(host, jhashing.hash_column(col))
    ok = _normal_rows([col])
    np.testing.assert_array_equal(got[ok], host[ok])
    if dtype == "float64":
        assert not ok.all()  # the subnormal row is there, and hashed as 0.0
        zero = texpr.hash_column_torch(_tval(np.zeros(1))).numpy().view(np.uint64)
        assert (got[~ok] == zero[0]).all()


@pytest.mark.parametrize("names", [("int64", "float64"), ("int32", "bool", "float32"),
                                   ("uint64", "int8", "uint8", "int16", "int64")])
def test_hash_columns_folds_like_jax(names):
    cols = [_columns()[n] for n in names]
    got = texpr.hash_columns_torch([_tval(c) for c in cols]).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np.asarray(_traced(cols)))
    host = thashing.hash_columns(cols)
    np.testing.assert_array_equal(host, jhashing.hash_columns(cols))
    ok = _normal_rows(cols)
    np.testing.assert_array_equal(got[ok], host[ok])


def test_float_keys_canonicalize_negative_zero():
    a = np.array([0.0, -0.0], dtype=np.float64)
    h = texpr.hash_column_torch(_tval(a)).numpy()
    assert h[0] == h[1]
