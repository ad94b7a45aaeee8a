"""One laikago ARS iteration with top_directions = 2 in the port against
the JAX package in float64, from the JAX package's own draws, on the eager
and the fused env: the helpers and the top_directions = 0 case are in
tests/test_torch_ars.py. A file of its own, so that its JAX compile (about
a minute) runs on another worker than that one's."""

import pytest

pytest.importorskip("torch")

from test_torch_ars import check_port_iteration, jax_iteration  # noqa: E402


@pytest.fixture(scope="module")
def jax_top2():
    return jax_iteration(top_directions=2)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_iteration_matches_jax(jax_top2, fused):
    check_port_iteration(jax_top2, 2, fused)
