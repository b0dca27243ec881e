"""The port's multi-tenant fleet (controller/fleet.py) over
tests/test_fleet.py's scenarios: the slot ledger, deficit-round-robin
admission, quotas, backoff, preemption, the fleet autoscaler and tick
budgets, and the controller-level admissions (a placement refused at the
admission site among them) to the golden, each run through the port with the
JAX test's assertions."""

from __future__ import annotations

import pytest

from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_fleet")
SCENARIOS = sorted(n for n in dir(MOD) if n.startswith("test_"))


def test_every_scenario_is_mirrored():
    assert len(SCENARIOS) == 24, SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_fleet_scenario_through_the_port(name, tmp_path, port):
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port)
