"""Gradients of the port's PGS (``contact/pgs.py``) against ``jax.grad`` of
the JAX package's unrolled sweep (``tds_tpu.contact.mlcp.solve_pgs``),
float64 on the CPU, within 1e-12 relative.

Both take the vector-Jacobian product with the same cotangent of x, so
every entry of the gradients of A, b, lo and hi is compared. The problems
are tests/test_pallas_pgs.py's (normal rows, then two friction rows per
contact bounded by +-0.5 times the normal impulse), at n = 3, 12, 24 and
48 rows, one and two sweeps, in batches that hold:

- random envs, away from every tie;
- envs whose normal impulses are all exactly 0 (b pushes them below their
  bound), so each friction row's s = max(x_n, 0) sits at its kink and its
  bounds at lo s = hi s = 0;
- envs with x = b = 0 everywhere (no toe on the ground), where every row's
  value sits on its bound.

At a tie ``jnp.maximum`` and ``jnp.clip`` pass half the gradient to each
side; ``torch.clamp`` and ``clamp_min``, which the plain version used
before, pass all of it to x, and fail the tie cases. On problems away from
the kinks ``torch.autograd.gradcheck`` holds the plain version's gradient
against its own finite differences.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402

RTOL = 1e-12


def _problem(n, seed, kind):
    """Numpy (a, b, lo, hi, dep) of a batch of 4 envs with n = 3 n_c rows
    (n = 3: one contact): 'random', or with env 1 at zero normal impulse
    and env 2 at x = b = 0 ('ties')."""
    rng = np.random.default_rng(seed)
    bsz, n_c = 4, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))  # not symmetric
    b = rng.normal(size=(bsz, n))
    lo = np.concatenate([np.zeros((bsz, n_c)), np.full((bsz, n - n_c), -0.5)], axis=-1)
    hi = np.concatenate([np.full((bsz, n_c), 1e5), np.full((bsz, n - n_c), 0.5)], axis=-1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    if kind == "ties":
        # env 1: every normal row pulled apart (x_n = 0 < p_n); the friction
        # rows then have s = 0 and lo s = hi s = 0
        b[1, :n_c] = -10.0 * np.abs(b[1, :n_c]) - 1.0
        b[1, :n_c] -= 50.0 * np.abs(a[1, :n_c, :n_c]).sum(-1)
        # env 2: nothing on the ground
        b[2] = 0.0
    return a, b, lo, hi, dep


@functools.lru_cache(maxsize=None)
def _jax_case(n, seed, kind, iterations):
    """(x, [A-bar, b-bar, lo-bar, hi-bar]) of the JAX package for the case,
    shared by both port entry points. Eager: a jit of the unrolled rows
    compiles for longer than the eager ops take."""
    a, b, lo, hi, dep = _problem(n, seed, kind)
    x, vjp = jax.vjp(lambda *t: j_solve_pgs(*t, dep, jnp.zeros_like(t[1]), iterations), *(jnp.asarray(v) for v in (a, b, lo, hi)))
    return np.asarray(x), [np.asarray(g) for g in vjp(jnp.asarray(_cotangent(n, b.shape)))]


def _cotangent(n, shape):
    return np.random.default_rng(n).normal(size=shape)


def _torch_vjp(solve, a, b, lo, hi, dep, iterations, x_bar):
    inputs = [torch.tensor(v, requires_grad=True) for v in (a, b, lo, hi)]
    x = solve(*inputs, dep, iterations)
    grads = torch.autograd.grad(x, inputs, torch.from_numpy(x_bar))
    return x.detach().numpy(), [g.numpy() for g in grads]


def _assert_close(got, want, label):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=label)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("n", [3, 12, 24, 48])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("solve", [pgs.solve_pgs_reference, pgs.solve_pgs], ids=["reference", "solve_pgs"])
def test_gradients_match_jax(solve, kind, n, iterations):
    seed = n + 100 * iterations
    a, b, lo, hi, dep = _problem(n, seed, kind)
    want_x, want = _jax_case(n, seed, kind, iterations)
    got_x, got = _torch_vjp(solve, a, b, lo, hi, dep, iterations, _cotangent(n, b.shape))
    _assert_close(got_x, want_x, "x")
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        _assert_close(g, w, name)


def test_the_tie_cases_hit_their_ties():
    """Env 1's normal impulses are exactly 0 after one sweep and env 2's
    whole x is 0: the cases above reach the kinks they are built for."""
    a, b, lo, hi, dep = _problem(12, seed=112, kind="ties")
    x = pgs.solve_pgs_reference(*(torch.from_numpy(v) for v in (a, b, lo, hi)), dep, 1)
    assert torch.all(x[1, :4] == 0) and torch.all(x[1, 4:] == 0)
    assert torch.all(x[2] == 0)
    assert torch.any(x[0] != 0)


def test_ties_take_half_the_gradient_like_jax():
    """One row at x = b = 0 with bounds [0, 0]: clip(0, 0, 0) passes 1/4
    to x, 1/4 to lo and 1/2 to hi, as jax.grad of jnp.clip does."""
    a, b, lo, hi = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in ([[[2.0]]], [[0.0]], [[0.0]], [[0.0]]))
    x = pgs.solve_pgs_reference(a, b, lo, hi, [-1], 1)
    ga, gb, glo, ghi = torch.autograd.grad(x.sum(), (a, b, lo, hi))
    want = jax.grad(lambda a, b, lo, hi: j_solve_pgs(a, b, lo, hi, [-1], jnp.zeros_like(b), 1).sum(), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.detach().numpy()) for t in (a, b, lo, hi))
    )
    assert [float(g) for g in (gb, glo, ghi)] == [0.125, 0.25, 0.5] == [float(w.reshape(())) for w in want[1:]]
    assert float(ga) == float(want[0].reshape(())) == 0.0


@pytest.mark.parametrize("n,iterations", [(3, 1), (6, 2), (9, 1)])
def test_gradcheck_away_from_the_kinks(n, iterations):
    """Normal impulses well above 0 and friction rows well inside their
    cone: the plain version is smooth there, and its gradient matches its
    finite differences."""
    rng = np.random.default_rng(n)
    n_c = n // 3
    j = rng.normal(size=(2, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + np.eye(n)
    b = np.concatenate([rng.uniform(5.0, 6.0, size=(2, n_c)), 0.01 * rng.normal(size=(2, n - n_c))], axis=-1)
    lo = np.concatenate([np.zeros((2, n_c)), np.full((2, n - n_c), -10.0)], axis=-1)
    hi = np.concatenate([np.full((2, n_c), 1e5), np.full((2, n - n_c), 10.0)], axis=-1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    inputs = tuple(torch.tensor(v, requires_grad=True) for v in (a, b, lo, hi))
    x = pgs.solve_pgs_reference(*inputs, dep, iterations).detach()
    assert torch.all(x[:, :n_c] > 0.1) and torch.all(x[:, n_c:].abs() < 9.0 * x[:, dep[n_c:]])  # inside the cone
    assert torch.autograd.gradcheck(lambda *t: pgs.solve_pgs_reference(*t, dep, iterations), inputs)
