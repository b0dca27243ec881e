"""The second half of the smoke families through the port (see
test_torch_sql_smoke_a.py: the same three runs against the goldens,
chained and unchained, and the same output lines as the JAX package at
parallelism 1)."""

from __future__ import annotations

import pytest

from test_torch_sql_smoke_a import (CHAINING, HALF, RUNNABLE, port,  # noqa: F401
                                    same_lines_as_jax, three_runs)


@CHAINING
@pytest.mark.parametrize("name", RUNNABLE[HALF:])
def test_smoke_family_three_runs(name, chaining, tmp_path, port):  # noqa: F811
    three_runs(name, chaining, tmp_path)


@CHAINING
@pytest.mark.parametrize("name", RUNNABLE[HALF:])
def test_smoke_family_lines_equal_jax(name, chaining, tmp_path, port):  # noqa: F811
    same_lines_as_jax(name, chaining, tmp_path)
