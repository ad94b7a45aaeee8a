"""The port's differentiation facade and sys-id toolkit
(``utils/diff.py``, ``utils/estimation.py``, ``model/pendulum.py``)
against the JAX package, the cases of tests/test_estimation.py, float64 on
the CPU.

- ``GradientFunctional`` in all three ``DiffMethod``s gives 2x for
  ||x||^2, and the JAX package's gradient of a pendulum rollout's loss;
- ``check_gradient`` through the 400-step two-link pendulum rollout passes
  at the JAX test's rtol 1e-4, and the port's gradient equals ``jax.grad``
  within 1e-10 relative;
- the pendulum mass sys-id: the cost and its gradient equal the JAX
  package's at the initial guess within 1e-10, and the first 15 Adam
  iterations of ``adam_estimate`` (lr 0.05) follow the JAX package's
  within 1e-8 and lower the cost. The JAX test runs all 150 iterations to
  a cost below 1e-6; the port's CPU rollout takes about 2.5 ms a step
  under autograd, so its 150 iterations (about 6 minutes) are left out;
- ``gradient_descent`` on the quadratic, the box projection and the
  regularisation.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.dynamics import forward_dynamics as j_forward_dynamics  # noqa: E402
from tds_tpu.dynamics import integrate_euler as j_integrate_euler  # noqa: E402
from tds_tpu.model.pendulum import compound_pendulum as j_compound_pendulum  # noqa: E402
from tds_tpu.utils.estimation import EstimationParameter as JParameter  # noqa: E402
from tds_tpu.utils.estimation import OptimizationProblem as JProblem  # noqa: E402
from tds_tpu.utils.estimation import adam_estimate as j_adam_estimate  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics  # noqa: E402
from tds_tpu_torch.dynamics.integrator import integrate_euler  # noqa: E402
from tds_tpu_torch.model.pendulum import compound_pendulum  # noqa: E402
from tds_tpu_torch.utils.diff import DiffMethod, GradientFunctional, check_gradient  # noqa: E402
from tds_tpu_torch.utils.estimation import (  # noqa: E402
    EstimationParameter,
    OptimizationProblem,
    adam_estimate,
    gradient_descent,
)

GRAVITY = (0.0, 0.0, -9.81)
X0 = (0.4, -0.3, 0.2, 0.1)


def _rollout_loss(model, steps):
    """tests/test_estimation.py's loss: the pendulum from (q, qd) = x for
    ``steps`` steps of 1 ms, sum q^2 + 0.1 sum qd^2."""
    g = torch.tensor(GRAVITY, dtype=torch.float64)

    def loss(x):
        q, qd = x[None, 0:2], x[None, 2:4]
        for _ in range(steps):
            qdd = forward_dynamics(model, q, qd, q.new_zeros(1, 2), g)
            q, qd = integrate_euler(model, q, qd, qdd, 1e-3)
        return (q**2).sum() + 0.1 * (qd**2).sum()

    return loss


def _jax_rollout_loss(model, steps):
    def loss(x):
        def step(carry, _):
            q, qd = carry
            qdd = j_forward_dynamics(model, q, qd, jnp.zeros(2), jnp.asarray(GRAVITY))
            return j_integrate_euler(model, q, qd, qdd, 1e-3), None

        (q, qd), _ = jax.lax.scan(step, (x[0:2], x[2:4]), None, length=steps)
        return jnp.sum(q**2) + 0.1 * jnp.sum(qd**2)

    return loss


@pytest.mark.parametrize("method", list(DiffMethod), ids=[m.name for m in DiffMethod])
def test_gradient_functional_norm_squared(method):
    gf = GradientFunctional(lambda x: (x**2).sum(), method=method)
    x = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    assert float(gf.value(x)) == 14.0
    np.testing.assert_allclose(gf.gradient(x).numpy(), 2 * x.numpy(), rtol=1e-5)


@pytest.mark.parametrize("method", list(DiffMethod), ids=[m.name for m in DiffMethod])
def test_gradient_functional_through_a_rollout_matches_jax(method):
    want = jax.grad(_jax_rollout_loss(j_compound_pendulum(2), 50))(jnp.asarray(X0))
    gf = GradientFunctional(_rollout_loss(compound_pendulum(2, device="cpu"), 50), method=method)
    got = gf.gradient(torch.tensor(X0, dtype=torch.float64))
    rtol = 1e-6 if method == DiffMethod.NUMERICAL else 1e-10
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol)


def test_check_gradient_through_rollout():
    loss = _rollout_loss(compound_pendulum(2, device="cpu"), 400)
    ad, fd, err = check_gradient(loss, torch.tensor(X0, dtype=torch.float64), rtol=1e-4)
    want = jax.jit(jax.grad(_jax_rollout_loss(j_compound_pendulum(2), 400)))(jnp.asarray(X0))
    np.testing.assert_allclose(ad.numpy(), np.asarray(want), rtol=1e-10)
    assert err < 1e-6


def test_pendulum_mass_sysid_follows_jax():
    true_masses, steps, iterations = [0.9, 1.7], 300, 15
    q0, qd0 = (0.8, -0.2), (0.0, 0.0)
    g = torch.tensor(GRAVITY, dtype=torch.float64)

    def rollout(model):
        q, qd = torch.tensor([q0], dtype=torch.float64), torch.tensor([qd0], dtype=torch.float64)
        traj = []
        for _ in range(steps):
            traj.append(q)
            qdd = forward_dynamics(model, q, qd, q.new_zeros(1, 2), g)
            q, qd = integrate_euler(model, q, qd, qdd, 1e-3)
        return torch.cat(traj)

    base = compound_pendulum(2, device="cpu")
    with torch.no_grad():
        observed = rollout(compound_pendulum(2, masses=true_masses, device="cpu"))

    def cost(x):
        scale = x / base.mass
        model = dataclasses.replace(base, mass=x, com=base.com * scale[:, None], inertia=base.inertia * scale[:, None, None])
        return ((rollout(model) - observed) ** 2).mean()

    params = [EstimationParameter("m0", 1.2, minimum=0.1, maximum=5.0), EstimationParameter("m1", 1.2, minimum=0.1, maximum=5.0)]
    problem = OptimizationProblem(cost, params, device="cpu")

    j_base = j_compound_pendulum(2)

    def j_rollout(model):
        def step(carry, _):
            q, qd = carry
            qdd = j_forward_dynamics(model, q, qd, jnp.zeros(2), jnp.asarray(GRAVITY))
            return j_integrate_euler(model, q, qd, qdd, 1e-3), q

        _, traj = jax.lax.scan(step, (jnp.asarray(q0), jnp.asarray(qd0)), None, length=steps)
        return traj

    j_observed = j_rollout(j_compound_pendulum(2, masses=true_masses))
    np.testing.assert_allclose(observed.numpy(), np.asarray(j_observed), rtol=1e-12, atol=1e-14)

    def j_cost(x):
        scale = x / j_base.mass
        m = j_base.replace(mass=x, com=j_base.com * scale[:, None], inertia=j_base.inertia * scale[:, None, None])
        return jnp.mean((j_rollout(m) - j_observed) ** 2)

    j_problem = JProblem(j_cost, [JParameter(p.name, p.value, p.minimum, p.maximum) for p in params])
    x0 = problem.initial_guess()
    np.testing.assert_allclose(float(problem.fitness(x0)), float(j_problem.fitness(j_problem.initial_guess())), rtol=1e-10)
    np.testing.assert_allclose(problem.gradient(x0).numpy(), np.asarray(j_problem.gradient(j_problem.initial_guess())), rtol=1e-10)

    x, c, history = adam_estimate(problem, learning_rate=0.05, iterations=iterations)
    j_x, j_c, j_history = j_adam_estimate(j_problem, learning_rate=0.05, iterations=iterations)
    np.testing.assert_allclose(history, j_history, rtol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(j_x), rtol=1e-8)
    assert c < 0.1 * float(problem.fitness(x0)), (c, history)


def test_gradient_descent_quadratic():
    problem = OptimizationProblem(
        lambda x: ((x - 2.0) ** 2).sum(), [EstimationParameter("a", 0.0), EstimationParameter("b", 5.0)], device="cpu"
    )
    x, c, _ = gradient_descent(problem, learning_rate=0.2, iterations=100)
    np.testing.assert_allclose(x.numpy(), [2.0, 2.0], atol=1e-3)


def test_projection_and_regularisation():
    params = [EstimationParameter("a", 0.0, minimum=-1.0, maximum=1.0, l1_regularization=0.5, l2_regularization=0.25)]
    problem = OptimizationProblem(lambda x: (x * 0.0).sum(), params, device="cpu")
    x = torch.tensor([3.0], dtype=torch.float64)
    assert problem.project(x).tolist() == [1.0] and problem.project(-x).tolist() == [-1.0]
    assert float(problem.fitness(x)) == 0.5 * 3 + 0.25 * 9
    assert problem.gradient(x).tolist() == [0.5 + 0.5 * 3]


def test_problem_defaults_to_the_card():
    params = [EstimationParameter("a", 1.0)]
    if torch.cuda.is_available():
        assert OptimizationProblem(lambda x: x.sum(), params).initial_guess().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OptimizationProblem(lambda x: x.sum(), params)
