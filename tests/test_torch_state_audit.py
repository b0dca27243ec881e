"""The port's replay-soundness auditor (analysis/state_audit.py, LR201-
LR204) against the JAX package's on the CPU: every case of
tests/test_state_audit.py runs through the port (``mirror``), each audited
source going to both packages' auditors, which must give the same rule
ids, severities and lines (``Differential``). The mirrored gate
``test_repo_audit_clean`` audits the port's own operators, windows and
connectors; the runtime cross-checks drive the port's operators through a
real checkpoint and restore of its TableManager on the CPU."""

from __future__ import annotations

import pytest

from test_torch_analysis import jax_cases, mirror, port_cfg, run_case  # noqa: F401

# the port's OperatorContext takes the torch device before the tables
STATE_SUBS = {
    "    return OperatorContext(ti, None, tm), tm\n":
        "    import torch\n\n"
        "    return OperatorContext(ti, torch.device('cpu'), None, tm), tm\n",
}
_STATE = None


def state_mirror():
    global _STATE
    if _STATE is None:
        _STATE = mirror("test_state_audit", STATE_SUBS)
    return _STATE


@pytest.mark.parametrize("name", jax_cases("test_state_audit"))
def test_state_audit_case_through_the_port(name, monkeypatch, tmp_path, port_cfg):  # noqa: F811
    diff = run_case(state_mirror(), name, monkeypatch, _storage=port_cfg,
                    tmp_path=tmp_path, monkeypatch=monkeypatch)
    if name.startswith(("test_lr2", "test_spill_", "test_audit_output",
                        "test_same_named")):
        assert diff.calls > 0, "no source went through both packages"
