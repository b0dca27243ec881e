"""The port's elastic autoscaler (controller/autoscaler.py) and its
controller wiring over tests/test_autoscaler.py's scenarios: the rails under
a fake clock (hysteresis, cooldown, proven headroom, backoff, clamped
targets) and the end-to-end rescales to the golden, each run through the
port with the JAX test's assertions."""

from __future__ import annotations

import pytest

from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_autoscaler")
SCENARIOS = sorted(n for n in dir(MOD) if n.startswith("test_"))
# The scale-up scenario reads the health record's autoscaler detail at
# parallelism 3, which the controller writes on a supervision tick while the
# job runs. The port's engines get through the smoke input sooner after a
# restore than the JAX package's (which compiles each new shape), so on a
# loaded machine the job could finish before that tick. Each incarnation's
# source holds at half its input for 12 barriers (about 1.8 s at the
# scenario's 150 ms interval), so the job at 3 lives through ticks.
HELD = {"test_autoscale_up_midstream_golden": {"testing.source-gate-epochs": 12}}


def test_every_scenario_is_mirrored():
    assert len(SCENARIOS) == 14, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_autoscaler_scenario_through_the_port(name, tmp_path, port, monkeypatch):
    if name in HELD:
        monkeypatch.setattr(MOD, "BASE_CFG", {**MOD.BASE_CFG, **HELD[name]})
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)
