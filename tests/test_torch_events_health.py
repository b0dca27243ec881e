"""The port's job event feed through the controller and its health
monitor (obs/health.py) over tests/test_events.py's scenarios: the rule
set's hysteresis, the relayed events of a process worker, a chaos crash's
causal trail, a sustained breach degrading a job, a restarted controller
resuming past persisted sequence numbers and the `logs` CLI, each run
through the port with the JAX test's assertions. The ring-size scenario
sets ``obs.events.max-per-job``, which the port keeps as a constant
(obs/events.py ``MAX_EVENTS_PER_JOB``; tests/test_torch_events.py holds its
ring)."""

from __future__ import annotations

import pytest

import arroyo_tpu_torch.config as tcfg
from test_torch_controller import port, port_mirror, run_mirrored  # noqa: F401

MOD = port_mirror("test_events")
RING_SIZE_IS_A_CONSTANT = {"test_event_ring_bounds_under_flood_but_counts_stay_exact"}
SCENARIOS = sorted(n for n in dir(MOD)
                   if n.startswith("test_") and n not in RING_SIZE_IS_A_CONSTANT)


def test_the_ring_size_scenario_sets_a_key_the_port_keeps_constant():
    import inspect

    from arroyo_tpu_torch.obs import events

    for name in RING_SIZE_IS_A_CONSTANT:
        assert "obs.events.max-per-job" in inspect.getsource(getattr(MOD, name))
    assert events.MAX_EVENTS_PER_JOB > 0


# Two scenarios need the job alive for a few more barriers than a loaded
# machine may leave them (the JAX tests race their source's read delay too):
# the crash fault installs after the first complete epoch and fires at the
# next barrier, and the dropped epoch-1 commit is re-delivered only with
# epoch 2's. Each incarnation's source (in the workers too, through the
# environment) holds at half its input for that many barriers.
HELD = {"test_chaos_crash_leaves_causal_event_trail": 4,
        "test_process_worker_relays_events_over_wire": 3}


@pytest.mark.parametrize("name", SCENARIOS)
def test_event_and_health_scenario_through_the_port(name, tmp_path, port, capsys,
                                                     monkeypatch):
    if name in HELD:
        monkeypatch.setenv("ARROYO_TPU_TORCH__TESTING__SOURCE_GATE_EPOCHS", str(HELD[name]))
        tcfg.reset()
    run_mirrored(MOD, name, tmp_path=tmp_path, _storage=port, capsys=capsys)
