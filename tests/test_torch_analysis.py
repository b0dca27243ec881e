"""The port's static analysis (arroyo_tpu_torch.analysis) against the JAX
package's on the CPU.

- Every case of tests/test_analysis.py runs through the port (``mirror``:
  the JAX test's source with the package renamed, its assertions
  unchanged), but the two whose rules read an idiom (LR104, LR111), which
  have PyTorch counterparts below with the same verdicts. While a mirrored
  case runs, each source it hands the port's lint / audit entry points goes
  to the JAX package's too, and the two must give the same rule ids,
  severities and lines (``Differential``).
- ``check_sql`` gives the JAX package's diagnostics, message for message,
  on every tests/smoke/queries and tests/smoke/queries_bad file, and the
  CLI's ``check`` / ``lint`` its exit codes and JSON.
- The port lints clean (the mirrored ``test_repo_lints_clean``).

``mirror`` and ``Differential`` are shared with test_torch_state_audit.py,
test_torch_trace_audit.py and test_torch_concurrency_audit.py.
"""

from __future__ import annotations

import glob
import inspect
import json
import os
import re
import types

import pytest

import arroyo_tpu_torch
import arroyo_tpu_torch.config as tcfg
from arroyo_tpu import analysis as janalysis
from arroyo_tpu.analysis import concurrency_audit as jconc
from arroyo_tpu.analysis import repo_lint as jlint
from arroyo_tpu.analysis import state_audit as jstate
from arroyo_tpu_torch import analysis as tanalysis
from arroyo_tpu_torch.analysis import concurrency_audit as tconc
from arroyo_tpu_torch.analysis import repo_lint as tlint
from arroyo_tpu_torch.analysis import state_audit as tstate
from arroyo_tpu_torch.analysis import trace_audit as ttrace

TESTS = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(TESTS, "smoke")
BAD_FILES = sorted(glob.glob(os.path.join(SMOKE, "queries_bad", "*.sql")))
SQL_FILES = sorted(glob.glob(os.path.join(SMOKE, "queries", "*.sql"))) + BAD_FILES
PORT_PKG = os.path.dirname(os.path.abspath(arroyo_tpu_torch.__file__))


def to_jax(text: str) -> str:
    return re.sub(r"\barroyo_tpu_torch\b", "arroyo_tpu", text)


def verdicts(diags) -> list:
    """(rule, severity, line) of each diagnostic, in order."""
    return [(d.rule_id, d.severity.name, d.site.rsplit(":", 1)[-1]) for d in diags]


def mirror(module: str, subs: dict = None) -> types.ModuleType:
    """tests/<module>.py with ``arroyo_tpu`` renamed to the port (and
    ``subs`` replaced): its cases run through the port with their
    assertions unchanged."""
    path = os.path.join(TESTS, f"{module}.py")
    with open(path) as f:
        src = re.sub(r"\barroyo_tpu\b", "arroyo_tpu_torch", f.read())
    for old, new in (subs or {}).items():
        assert old in src, old
        src = src.replace(old, new)
    mod = types.ModuleType(f"port_mirror_{module}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102 - the repo's own test source
    return mod


class Differential:
    """Wraps the port's lint and audit entry points so that each call also
    runs the JAX package's on the same source (renamed back) and holds the
    two to the same verdicts; ``calls`` counts the comparisons."""

    SOURCE_FNS = ((tlint, jlint, "lint_source"), (tstate, jstate, "audit_source"),
                  (tconc, jconc, "audit_concurrency_source"))
    MODULE_FNS = ((tstate, jstate, "audit_modules"),
                  (tconc, jconc, "audit_concurrency_modules"))

    def __init__(self, monkeypatch, mod: types.ModuleType = None):
        self.calls = 0
        targets = [tanalysis] + ([mod] if mod is not None else [])
        parse = tlint._parse

        def stash_parse(source, relpath):
            info = parse(source, relpath)
            info.source_text = source
            return info

        for m in (tlint, tstate, tconc, ttrace):
            monkeypatch.setattr(m, "_parse", stash_parse)
        for tmod, jmod, name in self.SOURCE_FNS:
            w = self._source(getattr(tmod, name), getattr(jmod, name))
            for t in [tmod] + targets:
                if hasattr(t, name):
                    monkeypatch.setattr(t, name, w)
        for tmod, jmod, name in self.MODULE_FNS:
            w = self._modules(getattr(tmod, name), getattr(jmod, name))
            for t in [tmod] + targets:
                if hasattr(t, name):
                    monkeypatch.setattr(t, name, w)

    def _check(self, got, want, what):
        t = got[0] if isinstance(got, tuple) else got
        j = want[0] if isinstance(want, tuple) else want
        assert verdicts(t) == verdicts(j), f"{what}: port {t} != JAX {j}"
        self.calls += 1

    def _source(self, tfn, jfn):
        def wrapped(source, relpath=None, *a, **kw):
            args = (relpath,) if relpath is not None else ()
            got = tfn(source, *args, *a, **kw)
            want = jfn(to_jax(source), *(to_jax(x) for x in args), *a, **kw)
            self._check(got, want, f"{tfn.__name__}({relpath})")
            return got
        return wrapped

    def _modules(self, tfn, jfn):
        def wrapped(mods, *a, **kw):
            got = tfn(mods, *a, **kw)
            jmods = [jlint._parse(to_jax(m.source_text), to_jax(m.relpath)) for m in mods]
            self._check(got, jfn(jmods, *a, **kw), tfn.__name__)
            return got
        return wrapped


@pytest.fixture
def port_cfg(tmp_path, monkeypatch):
    """The port's config on the CPU, with its storage in tmp_path."""
    from arroyo_tpu_torch import faults as tfaults

    monkeypatch.setenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ARROYO_TPU_TORCH__CHECKPOINT__STORAGE_URL", str(tmp_path / "port-ckpt"))
    tcfg.reset()
    tfaults.clear()
    yield str(tmp_path / "port-ckpt")
    tfaults.clear()
    tcfg.reset()


def run_case(mod, name: str, mp, **fixtures) -> Differential:
    """Call the mirrored case ``name`` with the fixtures it names, the
    port's entry points wrapped by a Differential."""
    diff = Differential(mp, mod)
    fn = getattr(mod, name)
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
    return diff


def jax_cases(module: str, leave_out: tuple = ()) -> list[str]:
    """The test functions of tests/<module>.py, in file order, but those
    left out (their counterparts are written for PyTorch)."""
    with open(os.path.join(TESTS, f"{module}.py")) as f:
        names = re.findall(r"^def (test_\w+)\(", f.read(), re.M)
    return [n for n in names if n not in leave_out]


def register_port_fixtures() -> None:
    from test_torch_sql_plan import register_port_fixtures as register

    register()


# ------------------------------------------------------ tests/test_analysis.py


IDIOM_CASES = ("test_lr104_host_sync_hot_path", "test_lr111_jit_in_hot_path")
ANALYSIS_SUBS = {
    "        import udfs  # noqa: F401\n":
        "        import udfs  # noqa: F401\n"
        "        from test_torch_analysis import register_port_fixtures\n"
        "        register_port_fixtures()\n",
}
_ANALYSIS = None


def analysis_mirror():
    global _ANALYSIS
    if _ANALYSIS is None:
        _ANALYSIS = mirror("test_analysis", ANALYSIS_SUBS)
    return _ANALYSIS


@pytest.mark.parametrize("name", [n for n in jax_cases("test_analysis", IDIOM_CASES)
                                  if n != "test_known_bad_catalog"])
def test_analysis_case_through_the_port(name, monkeypatch, tmp_path, capsys, port_cfg):
    diff = run_case(analysis_mirror(), name, monkeypatch, tmp_path=tmp_path,
                    capsys=capsys, monkeypatch=monkeypatch)
    if name.startswith(("test_lr1", "test_waivers")):
        assert diff.calls > 0, "no source went through both packages"


@pytest.mark.parametrize("path", BAD_FILES, ids=[os.path.basename(p)[:-4] for p in BAD_FILES])
def test_known_bad_catalog_through_the_port(path, monkeypatch, port_cfg):
    """test_analysis.py's catalog case: each bad file gives its annotated
    rule id through the port's check_sql."""
    run_case(analysis_mirror(), "test_known_bad_catalog", monkeypatch, path=path)


def _sql(path: str, out: str) -> str:
    with open(path) as f:
        return f.read().replace("$input_dir", os.path.join(SMOKE, "inputs")).replace(
            "$output_path", out)


@pytest.mark.parametrize("path", SQL_FILES,
                         ids=[os.path.relpath(p, SMOKE)[:-4] for p in SQL_FILES])
def test_check_sql_gives_the_jax_packages_diagnostics(path, tmp_path, port_cfg):
    """Rule, severity, site, message and hint of every diagnostic, in
    order, and whether a pipeline was planned."""
    register_port_fixtures()
    sql = _sql(path, str(tmp_path / "out.json"))
    jp, jd = janalysis.check_sql(sql)
    tp, td = tanalysis.check_sql(sql)
    assert [d.to_dict() for d in td] == [d.to_dict() for d in jd]
    assert (tp is None) == (jp is None)
    if path in BAD_FILES:
        with open(path) as f:
            rule = re.match(r"--\s*(?:reject|warn):\s*(\S+)", f.read()).group(1)
        assert rule in {d.rule_id for d in td}


@pytest.mark.parametrize("argv_of", [
    pytest.param(lambda bad, good: ["check", bad, "--json"], id="check-bad"),
    pytest.param(lambda bad, good: ["check", good, "--json"], id="check-good"),
    pytest.param(lambda bad, good: ["check", bad], id="check-bad-text"),
    pytest.param(lambda bad, good: ["check", good, "--strict"], id="check-good-strict"),
])
def test_cli_check_gives_the_jax_packages_exit_code_and_json(argv_of, tmp_path, capsys,
                                                             port_cfg):
    from arroyo_tpu.cli import main as jmain
    from arroyo_tpu_torch.cli import main as tmain

    register_port_fixtures()
    bad, good = str(tmp_path / "bad.sql"), str(tmp_path / "good.sql")
    for src, dst in ((os.path.join(SMOKE, "queries_bad", "unaligned_hop_group_by.sql"), bad),
                     (os.path.join(SMOKE, "queries", "select_star.sql"), good)):
        with open(dst, "w") as f:
            f.write(_sql(src, str(tmp_path / "out.json")))
    argv = argv_of(bad, good)
    jrc = jmain(argv)
    jout = capsys.readouterr().out
    trc = tmain(argv)
    tout = capsys.readouterr().out
    assert trc == jrc
    assert tout == jout
    if "--json" in argv:
        assert isinstance(json.loads(tout), list)


def test_cli_lint_gives_the_jax_packages_exit_codes(tmp_path, capsys):
    """Over a dirty file both exit 1 with the same findings in their JSON;
    over the port's own package the port's lint exits 0 with ``[]``."""
    from arroyo_tpu.cli import main as jmain
    from arroyo_tpu_torch.cli import main as tmain

    dirty = tmp_path / "engine" / "x.py"
    dirty.parent.mkdir()
    dirty.write_text("def f():\n    try:\n        g()\n    except:\n        pass\n")
    assert jmain(["lint", str(dirty), "--json"]) == 1
    jout = json.loads(capsys.readouterr().out)
    assert tmain(["lint", str(dirty), "--json"]) == 1
    tout = json.loads(capsys.readouterr().out)
    assert [(d["rule"], d["severity"], d["site"].rsplit(":", 1)[-1]) for d in tout] == \
        [(d["rule"], d["severity"], d["site"].rsplit(":", 1)[-1]) for d in jout]
    assert {d["rule"] for d in tout} == {"LR102"}
    assert tmain(["lint", PORT_PKG, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


# ------------------------------------------- LR104 and LR111 in PyTorch idiom


def ids_of(diags):
    return {d.rule_id for d in diags}


def test_lr104_host_sync_hot_path():
    """test_analysis.py's LR104 case in PyTorch's idiom: a host read of a
    tensor inside the hot path, or a device-wide wait anywhere in operator
    code, fires; numpy on host values does not."""
    lint = tanalysis.lint_source
    bad = (
        "import torch\nimport numpy as np\n"
        "class Op:\n"
        "    def process_batch(self, batch, ctx, collector):\n"
        "        v = torch.sum(batch.col)\n"
        "        return float(v)\n"
    )
    assert "LR104" in ids_of(lint(bad, "arroyo_tpu_torch/operators/x.py"))
    for sync in ("np.asarray(v)", "int(v)", "bool(v)", "v.item()", "v.tolist()",
                 "v.cpu()", "v.numpy()"):
        assert "LR104" in ids_of(lint(bad.replace("float(v)", sync),
                                      "arroyo_tpu_torch/operators/x.py")), sync
    for hot in ("handle_watermark", "handle_tick"):
        assert "LR104" in ids_of(lint(bad.replace("process_batch", hot),
                                      "arroyo_tpu_torch/windows/x.py")), hot
    assert "LR104" in ids_of(lint(
        "import torch\ndef flush(x):\n    torch.cuda.synchronize()\n",
        "arroyo_tpu_torch/ops/x.py"))
    host = (
        "import numpy as np\n"
        "class Op:\n"
        "    def process_batch(self, batch, ctx, collector):\n"
        "        v = batch.col\n"
        "        return np.asarray(v), v.tolist()\n"
    )
    assert "LR104" not in ids_of(lint(host, "arroyo_tpu_torch/operators/x.py"))
    # outside the hot methods a host read is the close's own business
    cold = bad.replace("process_batch", "handle_checkpoint")
    assert "LR104" not in ids_of(lint(cold, "arroyo_tpu_torch/operators/x.py"))
    assert "LR104" not in ids_of(lint(bad, "arroyo_tpu_torch/engine/x.py"))


def test_lr111_build_in_hot_path():
    """test_analysis.py's LR111 case in PyTorch's idiom: a kernel build —
    K4's SegmentProgram or its .module(), nvcc through build_source,
    triton.jit, torch.compile — in a hot-path method fires; a builder
    outside the hot path, or the engine's segment compiler, does not."""
    lint = tanalysis.lint_source
    bad = (
        "from arroyo_tpu_torch.ops.segment_kernel import SegmentProgram\n"
        "class Op:\n"
        "    def process_batch(self, batch, ctx, collector, input_index=0):\n"
        "        prog = SegmentProgram(self.plan, self.dtypes)\n"
        "        collector.collect(prog.run(batch))\n"
    )
    for rel in ("arroyo_tpu_torch/operators/x.py", "arroyo_tpu_torch/windows/x.py",
                "arroyo_tpu_torch/ops/x.py"):
        assert "LR111" in ids_of(lint(bad, rel)), rel
    for hot in ("handle_watermark", "handle_tick"):
        assert "LR111" in ids_of(lint(bad.replace("process_batch", hot),
                                      "arroyo_tpu_torch/operators/x.py")), hot
    for build in ("self.prog.module()", "kernels.build_source('slot_agg', bind)",
                  "torch.compile(fn)", "triton.jit(fn)"):
        src = ("import torch\nimport triton\nfrom arroyo_tpu_torch.ops import kernels\n"
               "class Op:\n"
               "    def process_batch(self, b, ctx, collector, input_index=0):\n"
               f"        {build}\n")
        assert "LR111" in ids_of(lint(src, "arroyo_tpu_torch/windows/x.py")), build
    # a relative from-import under another name still resolves
    frm = (
        "from ..ops.kernels import build_source as B\n"
        "class Op:\n"
        "    def process_batch(self, b, ctx, collector, input_index=0):\n"
        "        B('slot_agg', None)\n"
    )
    assert "LR111" in ids_of(lint(frm, "arroyo_tpu_torch/windows/x.py"))
    good = (
        "from arroyo_tpu_torch.ops.segment_kernel import SegmentProgram\n"
        "def _build(plan, dtypes):\n"
        "    return SegmentProgram(plan, dtypes).module()\n"
        "class Op:\n"
        "    def process_batch(self, b, ctx, collector, input_index=0):\n"
        "        self._fn(b)\n"
    )
    assert "LR111" not in ids_of(lint(good, "arroyo_tpu_torch/ops/x.py"))
    assert "LR111" not in ids_of(lint(bad, "arroyo_tpu_torch/engine/x.py"))
    waived = bad.replace(
        "prog = SegmentProgram(self.plan, self.dtypes)",
        "prog = SegmentProgram(self.plan, self.dtypes)  # lint: waive LR111 — test fixture")
    assert "LR111" not in ids_of(lint(waived, "arroyo_tpu_torch/operators/x.py"))
    assert not [d for d in tanalysis.lint_paths([PORT_PKG], root=os.path.dirname(PORT_PKG))
                if d.rule_id == "LR111"]


def test_jax_idiom_is_not_the_ports_concern():
    """The JAX package's LR104/LR111 fixtures (jax.jit, jnp, .block_until_
    ready()) name nothing the port's rules key on: the port's verdict on
    them is clean, and the PyTorch counterparts above carry the rules."""
    src = (
        "import jax\nimport jax.numpy as jnp\n"
        "class Op:\n"
        "    def process_batch(self, batch, ctx, collector, input_index=0):\n"
        "        fn = jax.jit(lambda x: x + 1)\n"
        "        v = jnp.sum(batch.col)\n"
        "        return float(v)\n"
    )
    assert tanalysis.lint_source(src, "arroyo_tpu_torch/operators/x.py") == []
    assert {"LR104", "LR111"} <= ids_of(janalysis.lint_source(src, "arroyo_tpu/operators/x.py"))


# --------------------------------------------------- chip_smoke's pinned copy


def test_chip_smokes_pinned_checks_are_both_packages_diagnostics(tmp_path, port_cfg):
    """chip_smoke.ANALYSIS_CHECKS (the card's copy, since it has no JAX):
    each text's exit code and diagnostics are what the port's and the JAX
    package's check_sql give."""
    import chip_smoke

    for name, (rc, want) in chip_smoke.ANALYSIS_CHECKS.items():
        sql = chip_smoke.analysis_sql(name, str(tmp_path / f"{name}.json"))
        jp, jd = janalysis.check_sql(sql)
        tp, td = tanalysis.check_sql(sql)
        assert [d.to_dict() for d in td] == [d.to_dict() for d in jd] == want, name
        assert rc == int(tp is None or any(d.severity.name == "ERROR" for d in td)), name


def test_chip_smokes_analysis_cli_on_the_cpu(tmp_path):
    """The analysis phase's subprocesses as the card runs them: lint exits
    0 saying "lint clean", each check gives its pinned exit code and JSON."""
    import chip_smoke

    procs = chip_smoke.analysis_cli_start(str(tmp_path))
    try:
        got = chip_smoke.analysis_cli_finish(procs)
    finally:
        for _t0, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(got) == {"lint", *chip_smoke.ANALYSIS_CHECKS}
    assert [got[n]["rc"] for n in chip_smoke.ANALYSIS_CHECKS] == \
        [rc for rc, _ in chip_smoke.ANALYSIS_CHECKS.values()]
