"""The port's configuration loader: the JAX package's layers (defaults, TOML
files, environment variables) under the port's own names, a departure by
design (ROADMAP C list): ``ARROYO_TPU_TORCH__A__B_C`` variables,
``ARROYO_TPU_TORCH_CONFIG`` and ``arroyo-tpu-torch.toml``. Both packages load
in one test process, and neither reads the other's settings. The control
plane's sections carry the JAX package's defaults."""

from __future__ import annotations

import pytest

import arroyo_tpu_torch.config as tcfg


@pytest.fixture(autouse=True)
def fresh():
    tcfg.reset()
    yield
    tcfg.reset()


def test_environment_variables_are_the_ports_own(monkeypatch):
    from arroyo_tpu import config as jcfg

    monkeypatch.setenv("ARROYO_TPU_TORCH__DEVICE__TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ARROYO_TPU_TORCH__CONTROLLER__WORKERS_PER_JOB", "3")
    monkeypatch.setenv("ARROYO_TPU_TORCH__PROFILE__ENABLED", "false")
    monkeypatch.setenv("ARROYO_TPU_TORCH__HEALTH__BACKPRESSURE_MAX", "0.5")
    monkeypatch.setenv("ARROYO_TPU__CONTROLLER__SCHEDULER", "process")
    tcfg.reset()
    jcfg.reset()
    try:
        c = tcfg.config()
        assert c.get("device.torch-device") == "cpu"
        assert c.get("controller.workers-per-job") == 3
        assert c.get("profile.enabled") is False
        assert c.get("health.backpressure-max") == 0.5
        assert c.get("controller.scheduler") == "embedded"  # the JAX variable is not read
        j = jcfg.config()
        assert j.get("controller.scheduler") == "process"
        assert j.get("controller.workers-per-job") == 1  # nor the port's by the JAX package
    finally:
        jcfg.reset()


def test_toml_files_by_variable_and_in_the_working_directory(tmp_path, monkeypatch):
    (tmp_path / "arroyo-tpu-torch.toml").write_text(
        "[checkpoint]\ninterval-ms = 250\n[api]\nhttp-port = 6000\n")
    named = tmp_path / "named.toml"
    named.write_text("[checkpoint]\ninterval-ms = 300\n[fleet]\nslots = 4\n")
    (tmp_path / "arroyo-tpu.toml").write_text("[fleet]\nslots = 99\n")  # the JAX package's
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARROYO_TPU_TORCH_CONFIG", str(named))
    monkeypatch.setenv("ARROYO_TPU_TORCH__API__HTTP_PORT", "7000")
    c = tcfg.config()
    assert c.get("checkpoint.interval-ms") == 300  # the named file comes last
    assert c.get("fleet.slots") == 4
    assert c.get("api.http-port") == 7000  # variables over files
    assert c.get("checkpoint.storage-url")  # defaults stay under the files


SECTIONS = ["controller", "fleet", "health", "autoscaler", "admin", "api", "logging"]


@pytest.mark.parametrize("section", SECTIONS)
def test_control_plane_defaults_equal_jax(section):
    from arroyo_tpu import config as jcfg

    assert tcfg._DEFAULTS[section] == jcfg._DEFAULTS[section]


@pytest.mark.parametrize("key", [
    "pipeline.worker-heartbeat-timeout-ms", "pipeline.allowed-restarts",
    "pipeline.healthy-duration-ms", "checkpoint.interval-ms", "checkpoint.timeout-ms",
    "checkpoint.max-consecutive-failures", "checkpoint.compaction.epochs",
])
def test_runtime_keys_default_as_jax(key):
    from arroyo_tpu import config as jcfg

    def get(d, path):
        for p in path.split("."):
            d = d[p]
        return d

    assert get(tcfg._DEFAULTS, key) == get(jcfg._DEFAULTS, key)


@pytest.mark.parametrize("sub", ["cluster", "api"])
def test_api_port_defaults_to_the_config(sub, monkeypatch):
    """`cluster` and `api` serve the REST API on ``--api-port``, else on the
    config's ``api.http-port`` (the JAX package's 5115)."""
    from arroyo_tpu_torch import api, cli, server_common

    class Bound(Exception):
        pass

    class FakeApi:
        def __init__(self, db, port):
            raise Bound(port)

    class FakeAdmin:
        def __init__(self, *a, **kw):
            pass

        def start(self):
            return self

    monkeypatch.setattr(api, "ApiServer", FakeApi)
    monkeypatch.setattr(server_common, "AdminServer", FakeAdmin)
    for argv, want in (([sub], 5115), ([sub, "--api-port", "6123"], 6123)):
        with pytest.raises(Bound) as ei:
            cli.main(argv)
        assert ei.value.args == (want,)
    monkeypatch.setenv("ARROYO_TPU_TORCH__API__HTTP_PORT", "7001")
    tcfg.reset()
    with pytest.raises(Bound) as ei:
        cli.main([sub])
    assert ei.value.args == (7001,)
