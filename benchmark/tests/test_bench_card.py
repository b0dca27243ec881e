"""On the card: each one-card cell that BENCHMARK.json names runs correct,
and its control does not. Skips without a CUDA card (decided inside the
test)."""

import json
import subprocess
import sys

import pytest

from run import BENCH, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_cell(cell, seed, *extra):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
                          str(seed), "--seconds", "3", "--trace", "0", *extra],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["q7m.hot"])
def test_cell_correct_and_its_control_not(card, cell):
    assert run_cell(cell, 2**31 + 101)["correct"]
    assert not run_cell(cell, 2**31 + 102, "--control", "at_least_once")["correct"]
