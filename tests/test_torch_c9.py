"""C9: after a first batch that verifies, the port's compiled segment gives
the bytes of the JAX package's compiled segment (XLA's CPU compilation of
its twin), not numpy's.

Both packages' ``CompiledSegment``s are built on the same plan. A clean
first batch (every float 1.0) verifies in both; a second batch then holds
C9's cases (``chip_smoke.c9_columns``: subnormal operands and results,
values next to FLT_MIN and DBL_MIN, +-0.0, NaN) under C9's expressions
(``chip_smoke.c9_expressions``: products that underflow, divisions by
float literals, their multiply-adds, ``x * bool``, comparisons with zero,
conversions) and float keys. Every row, dtype and key hash out of the two
must be equal. With the cases in the first batch, both packages' first-batch
verification must give the same verdict.
"""

import numpy as np
import pytest

import arroyo_tpu
import chip_smoke
from arroyo_tpu import expr as jexpr
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD
from test_torch_segment import JAX, PORT, bind, plan_entry, _verdict

N = 4099
arroyo_tpu._load_operators()


def _plans(E) -> dict:
    c, lit = E.Col, E.Lit
    exprs = chip_smoke.c9_expressions(E)
    plans = {}
    for k in range(0, len(exprs), 24):
        part = exprs[k:k + 24]
        proj = [(f"e{k + j}", e) for j, (_l, e) in enumerate(part)] + [("w", c("g64"))]
        plans[f"c9 expressions {k}-{k + len(part) - 1}"] = [
            ("value", {"projections": proj, "filter": E.BinOp(">", c("i32"), lit(-900))}),
            ("watermark", {"expr": c("w")})]
    plans["float keys"] = [
        ("value", {"projections": None, "filter": E.BinOp("!=", c("d32"), lit(0))}),
        ("watermark", {"expr": c("s64")}),
        ("key", {"keys": [("k1", c("f64")), ("k2", c("f32")),
                          ("k3", E.BinOp("*", c("f64"), lit(0.001)))]})]
    plans["tumbling insert"] = [
        ("value", {"projections": [("auction", c("i64")), ("price", c("f32")),
                                   (TIMESTAMP_FIELD, c(TIMESTAMP_FIELD))], "filter": None}),
        ("watermark", {"expr": c(TIMESTAMP_FIELD)}),
        ("key", {"keys": [("auction", c("auction")), ("p", c("price"))]}),
        ("tumbling_aggregate", {"width_micros": chip_smoke.WIDTH, "key_fields": ["auction"],
                                "aggregates": [("s", "sum", E.BinOp("*", c("price"), lit(1e-3))),
                                               ("q", "max", E.BinOp("/", c("price"), lit(3.0)))],
                                "input_dtype_of": lambda e: np.dtype(np.float64)})]
    return plans


PLANS = sorted(_plans(texpr))


def _clean(cols: dict) -> dict:
    """The same columns with every float and ``i32`` 1 and ``s64`` 0.0: a
    batch on which XLA's code and numpy agree (1 * (1 / c) is 1 / c
    rounded)."""
    out = dict(cols)
    for name in ("f32", "f64", "i32"):
        out[name] = np.ones_like(cols[name])
    out["s64"] = np.zeros_like(cols["s64"])
    return out


def _run(pkg, members, first, second):
    plan, b1 = bind(pkg, members, first, False)
    entry = plan_entry(pkg, plan, b1)
    verdict = _verdict(pkg, plan, b1)
    b2 = pkg.batch.Batch(dict(second))
    got = entry.execute(b2, "job", observe=False) if pkg is JAX else entry.execute(b2)
    return verdict, got


@pytest.mark.parametrize("name", PLANS)
def test_second_batch_gives_the_jax_compiled_bytes(name):
    cases = chip_smoke.c9_columns(N)
    clean = _clean(cases)
    jv, jgot = _run(JAX, _plans(jexpr)[name], clean, cases)
    tv, tgot = _run(PORT, _plans(texpr)[name], clean, cases)
    assert jv is None and tv is None, (jv, tv)
    assert tgot["n"] == jgot["n"] and tgot["aux"] == jgot["aux"]
    assert list(tgot["cols"]) == list(jgot["cols"])
    for col, w in jgot["cols"].items():
        w, g = np.asarray(w), np.asarray(tgot["cols"][col])
        assert g.dtype == w.dtype, f"{name}: {col} {g.dtype} != {w.dtype}"
        u = "u1" if w.dtype == np.bool_ else f"u{w.itemsize}"
        bad = np.flatnonzero(g.view(u) != w.view(u))
        assert not len(bad), (f"{name}: {col} differs at {len(bad)} rows, first "
                              f"{bad[:3].tolist()}: port {g[bad[:3]].tolist()} "
                              f"JAX {w[bad[:3]].tolist()}")


@pytest.mark.parametrize("name", PLANS)
def test_cases_in_the_first_batch_give_the_jax_verdict(name):
    cases = chip_smoke.c9_columns(N)
    jplan, jb = bind(JAX, _plans(jexpr)[name], cases, False)
    tplan, tb = bind(PORT, _plans(texpr)[name], cases, False)
    jv, tv = _verdict(JAX, jplan, jb), _verdict(PORT, tplan, tb)
    assert tv == jv
    if name.startswith("c9 expressions") or name == "float keys":
        assert jv is not None  # XLA departs from numpy on these cases
