"""C10: float16 on a host whose CPU has AVX512-FP16.

XLA's CPU code keeps float16 arithmetic native there: a float16
multiply-add contracts into one rounding, and a remainder by a literal power
of two of at least 1 gives a NaN the dividend's sign (``expr.py``'s float16
models, F16_WIDE and F16_NATIVE). The port's plain version of K4 takes the
host's model (``expr.host_float16_model``, from the CPU flags), and the
segment program takes its model as a constant. Here the plain version runs
C10's plan (``chip_smoke.c10_columns`` / ``c10_segment_plans``) and C4's two
float16 chunks under each model, forced through ``expr.float16_model_as``,
against bytes recorded from the JAX package's compiled segment on each kind
of host; and, on this host, against a live ``jax.jit``.
"""

import hashlib

import numpy as np
import pytest
import torch

import arroyo_tpu
import chip_smoke
from arroyo_tpu import expr as jexpr
from arroyo_tpu_torch import expr as texpr
from arroyo_tpu_torch.ops import segment_kernel
from test_torch_c4 import _clean
from test_torch_segment import JAX, PORT, bind, plan_entry, _verdict

arroyo_tpu._load_operators()
MODELS = (texpr.F16_WIDE, texpr.F16_NATIVE)
C10_N = 64
C4_N = 2053
C4_CHUNKS = ("c4 exprs 384-431", "c4 exprs 432-468")

# sha256 (first 16 hex digits) of each output column's bytes out of the
# JAX package's compiled segment (jax 0.9.0 on the CPU): COMMON where both
# kinds of host agree, XLA_BYTES[model] where they differ. "native" was
# taken on a host whose CPU flags hold avx512_fp16, "wide" on the same host
# with XLA_FLAGS=--xla_cpu_max_isa=AVX2 (XLA's code for a CPU without it).
COMMON = {'c10 exprs 0-29': {'_timestamp': '73d0b66bd5d3be88',
                             'e10': 'cab6a772614ae35b',
                             'e11': 'c5483c37bb0845e8',
                             'e15': 'ebc820a0625680d4',
                             'e16': 'd1180e4fd25d6c02',
                             'e17': 'b759cbc116d9040a',
                             'e19': 'fd075e58e036cc89',
                             'e20': '9f63e66f9c0e7dc8',
                             'e21': '8b706f174fd56daf',
                             'e22': '9f63e66f9c0e7dc8',
                             'e23': 'e146546da6c54a9e',
                             'e24': 'd893c6bc500194b0',
                             'e25': '9239bfabee814f8d',
                             'e26': '79dbb2a795e58cb0',
                             'e27': '591835512e8af8d2',
                             'e28': '1e8696ecf7141dc3',
                             'e29': 'f70cf32b76501d31',
                             'e5': 'ad7cc332d4fb9afa',
                             'e6': '5450ddda4d1d8c7f',
                             'e7': '5d4b0b753882c3b1',
                             'e9': '21230eb0eabd1698',
                             'w': '67d5819142a8919d'},
          'c4 exprs 384-431': {'_timestamp': '2d32f7d5485fe649',
                               'e384': '408b6e4c6dc331a8',
                               'e385': '6286d55978619b1a',
                               'e386': 'fecb2fdcd917fc9d',
                               'e387': 'c0fc7f401df673e7',
                               'e388': 'e40df0d604190ed3',
                               'e389': '93805c694f78e301',
                               'e390': 'd84d26bdb846f511',
                               'e392': 'e7bc4b7d25d8c26f',
                               'e393': '6359c7f7c3e86fda',
                               'e394': '6359c7f7c3e86fda',
                               'e395': '4d991c9143a7ed0c',
                               'e396': '5303247c917c63d1',
                               'e397': 'deeaa3ce6f3783ab',
                               'e398': 'bf360c27b9976b74',
                               'e399': '178bd1083dee8f1a',
                               'e400': '9ea42e240388d18e',
                               'e401': '9ea42e240388d18e',
                               'e402': '9ea42e240388d18e',
                               'e403': '9ea42e240388d18e',
                               'e404': '65890755ee7728c8',
                               'e405': 'e34c511061c723ee',
                               'e406': 'cb86299b58b55661',
                               'e407': '115275add72fabc7',
                               'e408': 'db0a64597e07c317',
                               'e409': '3c2bb1048845cf9b',
                               'e410': '8a5d2f86a88f7171',
                               'e411': 'f20b90e9b4f905b2',
                               'e412': 'cecb7c69f1777d1c',
                               'e413': '0bb5a2d367db2069',
                               'e414': 'f97784a940a768fb',
                               'e415': '2868391ba43574ba',
                               'e416': 'd1af65d4c06d6096',
                               'e417': 'a302f01c80c412f9',
                               'e418': 'b7aba7bafe041247',
                               'e419': 'a050070d8d84f8c6',
                               'e420': 'b6d8cb5a3b38e853',
                               'e421': 'c3b83242e35b559f',
                               'e422': '534280d84bcf592a',
                               'e423': 'f6f64722d1263442',
                               'e424': 'e7bc4b7d25d8c26f',
                               'e425': '250f973b3e26857d',
                               'e426': '704d4bff8ccbad21',
                               'e427': 'cfc67bfbd34d1e37',
                               'e428': '89fd6934220c6d57',
                               'e429': '03884fc3b7a0f660',
                               'e430': 'b4478938aa9fa61c',
                               'e431': 'e607ae2e8c52991c',
                               'w': 'f302f5041f8789d8'},
          'c4 exprs 432-468': {'_timestamp': '2d32f7d5485fe649',
                               'e432': 'a050070d8d84f8c6',
                               'e433': 'c3b83242e35b559f',
                               'e434': 'f6f64722d1263442',
                               'e435': '744430e56b8d63f7',
                               'e436': 'eb4661acfcf0575e',
                               'e437': 'efac64effb073826',
                               'e438': '744430e56b8d63f7',
                               'e439': '744430e56b8d63f7',
                               'e440': '84b1e01abe47975b',
                               'e441': '744430e56b8d63f7',
                               'e442': '744430e56b8d63f7',
                               'e443': '744430e56b8d63f7',
                               'e444': '744430e56b8d63f7',
                               'e445': '744430e56b8d63f7',
                               'e446': '392875850b43a988',
                               'e447': 'cb9ad8c2a0701194',
                               'e448': '69db0fbf5d8159ce',
                               'e449': '179f094eaa0f56c7',
                               'e450': 'c841ce814bae7f5a',
                               'e451': 'e2b01b63a00768f4',
                               'e452': 'ee12d78f1e1a1897',
                               'e453': '4d991c9143a7ed0c',
                               'e454': '885513a3fecdb9ee',
                               'e455': '5039ef083ba02b23',
                               'e456': '261fc29c8d285d9c',
                               'e457': '3268634a172cb9a8',
                               'e458': '1373ecbd0ffa4c1b',
                               'e459': '744430e56b8d63f7',
                               'e461': 'd3c667b048842edd',
                               'e462': '182fce9868e8dc56',
                               'e463': '84bf6b2eadb6c2ce',
                               'e464': 'c50bd6491b618489',
                               'e465': '9994f74b75e4c755',
                               'e466': 'eef5baca634dd287',
                               'e467': '6f310bd08708da8d',
                               'e468': '1ab8eedc85ab3e0e',
                               'w': 'f302f5041f8789d8'}}
XLA_BYTES = {'native': {'c10 exprs 0-29': {'e0': '63ec448ed51c4149',
                                           'e1': '7cd2b8d158e32de8',
                                           'e12': '80f42fe8221d4c92',
                                           'e13': '36faf1c02e7217e7',
                                           'e14': '92eee6117410891d',
                                           'e18': '2cf402c6ba6858cf',
                                           'e2': '1d3c9fcf68b1677f',
                                           'e3': '1d3c9fcf68b1677f',
                                           'e4': '240596a0e807faec',
                                           'e8': 'cf6e92d2a332181a'},
                        'c4 exprs 384-431': {'e391': '396090609fdbc87f'},
                        'c4 exprs 432-468': {'e460': 'b1cb800bfaa88600'}},
             'wide': {'c10 exprs 0-29': {'e0': '9dfdbb6d8eedd8bd',
                                         'e1': '7eb1a49e71fb78da',
                                         'e12': 'a1ecd9f2dbfbde03',
                                         'e13': '90735a2807003f5b',
                                         'e14': '9bb66c15279c8792',
                                         'e18': 'e34f50798d067930',
                                         'e2': 'a50f5e403ad440c6',
                                         'e3': 'a50f5e403ad440c6',
                                         'e4': '006f297c9ec3067f',
                                         'e8': '295e95438cf3a11d'},
                      'c4 exprs 384-431': {'e391': 'f70ecdebc9a8f0dc'},
                      'c4 exprs 432-468': {'e460': 'e7f025538cb3cd03'}}}
VERDICTS = {'native': {'c4 exprs 384-431': 'e391: values differ',
                       'c4 exprs 432-468': 'e450: values differ'},
            'wide': {'c4 exprs 384-431': 'e393: values differ', 'c4 exprs 432-468': 'e450: values differ'}}


def _cases(label):
    return chip_smoke.c10_columns(C10_N) if label.startswith("c10") else chip_smoke.c4_columns(C4_N)


def _members(E, label):
    plans = chip_smoke.c10_segment_plans(E) + chip_smoke.c4_segment_plans(E)
    return next(m for name, m, _h in plans if name == label)


def _digests(cols) -> dict:
    return {k: hashlib.sha256(np.asarray(v).tobytes()).hexdigest()[:16] for k, v in cols.items()}


def _second_batch(pkg, label, model=None):
    """The compiled segment's output on the cases after a clean first batch
    (the port's under float16 ``model``)."""
    E = jexpr if pkg is JAX else texpr
    cases = _cases(label)
    with texpr.float16_model_as(model):
        plan, b1 = bind(pkg, _members(E, label), _clean(cases), False)
        entry = plan_entry(pkg, plan, b1)
        assert _verdict(pkg, plan, b1) is None
        b2 = pkg.batch.Batch(dict(cases))
        got = entry.execute(b2, "job", observe=False) if pkg is JAX else entry.execute(b2)
    return got["cols"]


LABELS = sorted(COMMON)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("label", LABELS)
def test_plain_version_gives_the_recorded_xla_bytes(label, model):
    got = _digests(_second_batch(PORT, label, model))
    want = {**COMMON[label], **XLA_BYTES[model][label]}
    assert sorted(got) == sorted(want)
    bad = sorted(c for c in want if got[c] != want[c])
    assert not bad, f"{label} under {model}: {bad} differ from XLA's bytes"


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("label", C4_CHUNKS)
def test_first_batch_verdict_is_the_recorded_one(label, model):
    cases = _cases(label)
    with texpr.float16_model_as(model):
        plan, b = bind(PORT, _members(texpr, label), cases, False)
        assert _verdict(PORT, plan, b) == VERDICTS[model][label]


@pytest.mark.parametrize("label", LABELS)
def test_live_jax_jit_gives_the_port_bytes_under_the_host_model(label):
    """On this host: the JAX compiled segment, the recorded bytes of this
    host's model and the port's plain version under it agree."""
    model = texpr.host_float16_model()
    want = _second_batch(JAX, label)
    got = _second_batch(PORT, label)
    assert list(got) == list(want)
    for col, w in want.items():
        w, g = np.asarray(w), np.asarray(got[col])
        u = "u1" if w.dtype == np.bool_ else f"u{w.itemsize}"
        bad = np.flatnonzero(g.view(u) != w.view(u))
        assert g.dtype == w.dtype and not len(bad), (
            f"{label}: {col} differs at {bad[:3].tolist()}: port {g[bad[:3]].tolist()} "
            f"JAX {w[bad[:3]].tolist()}")
    assert _digests(want) == {**COMMON[label], **XLA_BYTES[model][label]}


def test_host_model_follows_the_cpu_flags():
    flags = next((line.split() for line in open("/proc/cpuinfo") if line.startswith("flags")), [])
    want = texpr.F16_NATIVE if "avx512_fp16" in flags else texpr.F16_WIDE
    assert texpr.host_float16_model() == want
    assert texpr.float16_model() == want
    with texpr.float16_model_as(texpr.F16_WIDE):
        assert texpr.float16_model() == texpr.F16_WIDE
        with texpr.float16_model_as(texpr.F16_NATIVE):
            assert texpr.float16_model() == texpr.F16_NATIVE
        assert texpr.float16_model() == texpr.F16_WIDE
    assert texpr.float16_model() == want
    with pytest.raises(ValueError, match="float16 model"):
        with texpr.float16_model_as("bf16"):
            pass


def test_segment_program_takes_its_model_as_a_constant():
    """Each model gives its own kernel source (so its own Triton program)
    where the plan holds a contraction or a power-of-two remainder of
    float16, and the plain version follows the program's model, not the
    caller's."""
    cb = chip_smoke.Batch(chip_smoke.c10_columns(C10_N))
    members = _members(texpr, LABELS[0])
    plan = chip_smoke.bind_plan(members, cb, False)
    dts = [np.asarray(cb[c]).dtype for c in plan.traced_in]
    progs = {m: segment_kernel.SegmentProgram(plan, dts, m) for m in MODELS}
    assert progs[texpr.F16_WIDE].digest != progs[texpr.F16_NATIVE].digest
    assert "to(tl.float16)" in progs[texpr.F16_NATIVE].source
    n, ins = chip_smoke.staged_inputs(plan, cb, torch.device("cpu"))
    outs = {}
    for m, prog in progs.items():
        other = MODELS[1 - MODELS.index(m)]
        with texpr.float16_model_as(other):
            outs[m] = segment_kernel.segment_plain(prog, n, ins)[0]
    assert not torch.equal(outs[MODELS[0]]["e0"], outs[MODELS[1]]["e0"])


def _fma16_kernel_model(x, y, z):
    """The kernel's float16 fma (segment_kernel._Gen.fma16) in numpy
    float32, line for line."""
    with np.errstate(all="ignore"):
        p = x.astype(np.float32) * y.astype(np.float32)
        zf = z.astype(np.float32)
        t = p + zf
        bb = t - p
        e = (p - (t - bb)) + (zf - bb)
        tb = t.view(np.int32)
        step = (e != 0) & ((tb & 1) == 0) & (t == t) & (e == e)
        up = (e > 0) == (t > 0)
        odd = np.where(step, np.where(up, tb + 1, tb - 1), tb).astype(np.int32)
        return odd.view(np.float32).astype(np.float16)


def test_fma16_is_one_rounding_in_the_kernel_and_the_plain_version():
    """The kernel's float16 fma and fma_torch's agree with one rounding of
    the exact x * y + z (exact rationals) on random and subnormal operands."""
    from fractions import Fraction

    rng = np.random.default_rng(10)
    n = 3000
    x, y, z = (rng.normal(0, 30, n).astype(np.float16) for _ in range(3))
    sub = rng.integers(1, 1024, n).astype(np.uint16).view(np.float16)
    x[:500], z[500:1000] = sub[:500], sub[500:1000]
    z[1000:1500] = (x[1000:1500].astype(np.float32) * y[1000:1500]).astype(np.float16)
    plain = texpr.fma_torch(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    kern = _fma16_kernel_model(x, y, z)
    grid = np.arange(0x10000, dtype=np.uint32).astype(np.uint16).view(np.float16)
    finite = np.sort(np.unique(grid[np.isfinite(grid)].astype(np.float64)))
    for i in range(n):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + Fraction(float(z[i]))
        k = int(np.searchsorted(finite, float(exact)))
        cand = [finite[j] for j in (k - 1, k) if 0 <= j < len(finite)]
        best = min(cand, key=lambda c: (abs(Fraction(c) - exact),
                                        int(np.float16(c).view(np.uint16)) & 1))
        want = np.float16(best)
        if want == 0:  # an exact zero: IEEE's sign for x * y + z
            want = np.float16(float(x[i]) * float(y[i]) + float(z[i]))
        for name, got in (("plain", plain[i]), ("kernel", kern[i])):
            assert got.view(np.uint16) == want.view(np.uint16), (
                name, i, float(x[i]), float(y[i]), float(z[i]), float(got), float(want))
