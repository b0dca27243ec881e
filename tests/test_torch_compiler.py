"""The port's native UDF compile service and dylib host (compiler.py) over
tests/test_compiler.py's cases (in-process build and call, g++'s error, an
artifact through the fake S3, a cpp UDF created over REST and run by a
process-scheduler worker, the standalone HTTP service), each run through the
port with the JAX test's assertions; then artifacts that cross the packages
through the fake S3 and GCS, and the same C++ source giving the same values
through both packages' services."""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_compiler")
CASES = sorted(n for n in dir(MOD) if n.startswith("test_"))
CPP_SCALE, CPP_HYPOT = MOD.CPP_SCALE, MOD.CPP_HYPOT


def test_every_case_is_mirrored():
    assert len(CASES) == 5, CASES


@pytest.mark.parametrize("name", CASES)
def test_compiler_case_through_the_port(name, tmp_path, port):
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)


@pytest.fixture
def stores():
    from arroyo_tpu.state import storage as jst
    from arroyo_tpu_torch.state import storage as tst
    from test_storage import FakeGcs, FakeS3

    s3, gcs = FakeS3(), FakeGcs()
    for st in (jst, tst):
        st.set_s3_client(s3)
        st.set_gcs_client(gcs)
    yield s3, gcs
    for st in (jst, tst):
        st.set_s3_client(None)
        st.set_gcs_client(None)


def _drop(*names):
    from arroyo_tpu.udf import drop_udf as jdrop
    from arroyo_tpu_torch.udf import drop_udf as tdrop

    for n in names:
        for drop in (jdrop, tdrop):
            try:
                drop(n)
            except KeyError:
                pass


@pytest.mark.parametrize("built_by,loaded_by,url", [
    ("jax", "torch", "s3://udfs/artifacts"), ("torch", "jax", "s3://udfs/artifacts"),
    ("torch", "torch", "gs://udfs/artifacts"), ("jax", "torch", "gs://udfs/artifacts")])
def test_artifacts_cross_the_packages(built_by, loaded_by, url, stores, port):
    """An artifact one package's service publishes to an object store is
    loaded by the other's host under the same content-addressed name (the
    JAX package's host fetches s3:// only, so it loads gs:// from neither)."""
    from arroyo_tpu import compiler as jcomp
    from arroyo_tpu import udf as judf
    from arroyo_tpu_torch import compiler as tcomp
    from arroyo_tpu_torch import udf as tudf

    build = {"jax": jcomp, "torch": tcomp}[built_by].CompileService(url).build_udf
    spec = build("scale7", CPP_SCALE, ["int64"], "int64")
    assert spec.artifact_url.startswith(url) and spec.artifact_url.endswith(".so")
    other = {"jax": jcomp, "torch": tcomp}["torch" if built_by == "jax" else "jax"]
    assert other.CompileService(url).build_udf(
        "scale7", CPP_SCALE, ["int64"], "int64").artifact_url == spec.artifact_url
    comp, reg = (tcomp, tudf) if loaded_by == "torch" else (jcomp, judf)
    try:
        comp.load_native_udf(comp.NativeUdfSpec(spec.name, spec.arg_dtypes,
                                                spec.return_dtype, spec.artifact_url))
        assert list(reg.lookup_udf("scale7").fn(np.array([1, 2, 3], dtype=np.int64))) == [7, 14, 21]
    finally:
        _drop("scale7")


def test_same_source_same_values_through_both_services(port, tmp_path):
    """The same C++ sources, built by each package's HTTP compile service,
    give the same values, bit for bit, on the same inputs."""
    from arroyo_tpu import compiler as jcomp
    from arroyo_tpu import udf as judf
    from arroyo_tpu_torch import compiler as tcomp
    from arroyo_tpu_torch import udf as tudf

    rng = np.random.default_rng(7)
    a, b = rng.normal(0, 1e3, 4096), rng.normal(0, 1e3, 4096)
    ints = rng.integers(-(1 << 40), 1 << 40, 4096)
    got = {}
    for pkg, comp, reg in (("jax", jcomp, judf), ("torch", tcomp, tudf)):
        srv = comp.CompileServer(artifacts_url=str(tmp_path / pkg)).start()
        try:
            for name, src, args, ret in (("hypot3", CPP_HYPOT, ["float64", "float64"], "float64"),
                                         ("scale7", CPP_SCALE, ["int64"], "int64")):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/compile", method="POST",
                    data=json.dumps({"name": name, "source": src, "arg_dtypes": args,
                                     "return_dtype": ret}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as r:
                    out = json.loads(r.read())
                comp.load_native_udf(comp.NativeUdfSpec(
                    out["name"], tuple(out["arg_dtypes"]), out["return_dtype"],
                    out["artifact_url"]))
            got[pkg] = (reg.lookup_udf("hypot3").fn(a, b), reg.lookup_udf("scale7").fn(ints))
        finally:
            srv.stop()
            _drop("hypot3", "scale7")
    for j, t in zip(got["jax"], got["torch"]):
        assert j.dtype == t.dtype and j.tobytes() == t.tobytes()
    assert got["torch"][1].tolist() == (ints * 7).tolist()


def test_default_artifacts_go_under_the_ignored_build_directory(port):
    from arroyo_tpu_torch import compiler as tcomp

    tcfg.update({"compiler.artifacts-url": None})
    svc = tcomp.CompileService()
    assert svc.artifacts_url == tcomp.DEFAULT_ARTIFACTS
    assert svc.artifacts_url.replace("\\", "/").endswith("arroyo_tpu_torch/build/udf-artifacts")
