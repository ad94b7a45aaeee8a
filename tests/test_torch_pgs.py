"""The port's PGS: its plain version against the JAX package's unrolled
solve_pgs and its Pallas kernel (interpret mode on the CPU), float64,
tolerance 1e-10, and the device dispatch of solve_pgs. The CUDA kernel's
own tests are in test_torch_pgs_cuda.py, which imports no JAX."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu.contact.pallas_pgs import solve_pgs_pallas  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread: its many small operations gain nothing from
    more, and the test workers' threads would contend for the cores. The
    JAX package's reference compiled without XLA's optimisation passes:
    its compiles are most of these tests' time, and its results agree to
    rounding."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)

TOL = 1e-10
# (batch, contacts, sweeps, pallas block): the problems of
# tests/test_pallas_pgs.py plus an n = 24 one (ant / terrain with top_k = 8)
CASES = {"32x12x3": (32, 4, 3, 16), "21x6x2": (21, 2, 2, 8), "40x24x1": (40, 8, 1, 16)}


def _problem(bsz, n_c, seed=0):
    """Numpy (a, b, lo, hi, dep) as in tests/test_pallas_pgs.py: n = 3 n_c
    rows, n_c normal rows, then two friction rows per contact."""
    return _rows_problem(bsz, 3 * n_c, seed)


def _port(a, b, lo, hi, dep, iterations, device="cpu"):
    args = [torch.from_numpy(x).to(device) for x in (a, b, lo, hi)]
    return pgs.solve_pgs_reference(*args, dep, iterations)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_unrolled(case):
    bsz, n_c, iterations, _ = CASES[case]
    a, b, lo, hi, dep = _problem(bsz, n_c, seed=bsz)
    expected = j_solve_pgs(*(jnp.asarray(x) for x in (a, b, lo, hi)), dep, jnp.zeros((bsz, 3 * n_c)), iterations)
    np.testing.assert_allclose(_port(a, b, lo, hi, dep, iterations).numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_kernel(case):
    bsz, n_c, iterations, block = CASES[case]
    a, b, lo, hi, dep = _problem(bsz, n_c, seed=bsz + 1)
    expected = solve_pgs_pallas(*(jnp.asarray(x) for x in (a, b, lo, hi)), dep, iterations=iterations, block_batch=block)
    np.testing.assert_allclose(_port(a, b, lo, hi, dep, iterations).numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


def _rows_problem(bsz, n, seed):
    """Numpy (a, b, lo, hi, dep) with n rows of any count: _problem's layout
    with n / 3 contacts when 3 divides n, else n / 2 normal rows and one
    friction direction (n = 8: laikago with num_friction_dir = 1)."""
    rng = np.random.default_rng(seed)
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n)
    b = rng.normal(size=(bsz, n))
    lo = np.concatenate([np.zeros((bsz, n_c)), np.full((bsz, n - n_c), -0.5)], axis=-1)
    hi = np.concatenate([np.full((bsz, n_c), 1e5), np.full((bsz, n - n_c), 0.5)], axis=-1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    return a, b, lo, hi, dep


@pytest.mark.parametrize("n", [3, 8, 48, 105])
def test_reference_matches_jax_at_any_row_count(n):
    """The row counts the card's kernel now takes beyond 12 and 24: laikago
    with top_k = 1 (3) or one friction direction (8), the half-cheetah (48)
    and the humanoid (105), against the JAX package's unrolled solve_pgs
    (run eagerly: a jit of 105 unrolled rows would cost more than it saves;
    one sweep at n = 105, whose eager dispatch sets this test's time)."""
    bsz, iterations = 5, 1 if n > 48 else 2
    a, b, lo, hi, dep = _rows_problem(bsz, n, seed=n)
    expected = j_solve_pgs(*(jnp.asarray(x) for x in (a, b, lo, hi)), dep, jnp.zeros((bsz, n)), iterations)
    np.testing.assert_allclose(_port(a, b, lo, hi, dep, iterations).numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


def test_solve_pgs_on_cpu_runs_the_plain_version():
    a, b, lo, hi, dep = _problem(9, 4, seed=2)
    before = pgs.launches
    got = pgs.solve_pgs(*(torch.from_numpy(x) for x in (a, b, lo, hi)), dep, 2)
    assert pgs.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(a, b, lo, hi, dep, 2).numpy())


def test_solve_pgs_refuses_other_devices():
    a, b, lo, hi, dep = _problem(3, 4)
    meta = [torch.from_numpy(x).to("meta") for x in (a, b, lo, hi)]
    with pytest.raises(ValueError):
        pgs.solve_pgs(*meta, dep, 1)
    with pytest.raises(ValueError):
        pgs.solve_pgs(meta[0], *(torch.from_numpy(x) for x in (b, lo, hi)), dep, 1)
