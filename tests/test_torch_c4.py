"""C4: the port's compiled segment takes uint16, uint32 and uint64
arithmetic and float16, as the JAX package's compiled segment does, and
gives the bytes of XLA's CPU compilation of its twin.

Both packages' ``CompiledSegment``s are built on the same plan
(``chip_smoke.c4_segment_plans``). A clean first batch (every value 1)
verifies in both; a second batch then holds C4's cases
(``chip_smoke.c4_columns``: wrapping unsigned sums and products, unsigned
compares and divisions past the signed range, uint64 conversions to float,
float16 rounding, subnormals, NaN and +-inf). Every row, dtype and key hash
out of the two must be equal. With the cases in the first batch, both
packages' first-batch verification must give the same verdict.
"""

import numpy as np
import pytest

import arroyo_tpu
import chip_smoke
from arroyo_tpu import expr as jexpr
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch.batch import TIMESTAMP_FIELD
from test_torch_segment import JAX, PORT, bind, plan_entry, _verdict

N = 2053
arroyo_tpu._load_operators()


def _plans(E) -> dict:
    return {label: members for label, members, _h in chip_smoke.c4_segment_plans(E)}


PLANS = sorted(_plans(texpr))


def _clean(cols: dict) -> dict:
    """Every column but the timestamps 1: a batch on which XLA's code and
    numpy agree."""
    return {k: (v if k == TIMESTAMP_FIELD else np.ones_like(v)) for k, v in cols.items()}


def _run(pkg, members, first, second):
    plan, b1 = bind(pkg, members, first, False)
    entry = plan_entry(pkg, plan, b1)
    verdict = _verdict(pkg, plan, b1)
    b2 = pkg.batch.Batch(dict(second))
    got = entry.execute(b2, "job", observe=False) if pkg is JAX else entry.execute(b2)
    return verdict, got


@pytest.mark.parametrize("name", [p for p in PLANS if not p.startswith("c4 departs")])
def test_second_batch_gives_the_jax_compiled_bytes(name):
    cases = chip_smoke.c4_columns(N)
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
    cases = chip_smoke.c4_columns(N)
    jplan, jb = bind(JAX, _plans(jexpr)[name], cases, False)
    tplan, tb = bind(PORT, _plans(texpr)[name], cases, False)
    jv = _verdict(JAX, jplan, jb)
    assert _verdict(PORT, tplan, tb) == jv
    if name.startswith("c4 departs"):
        assert jv is not None  # these depart from numpy in dtype
