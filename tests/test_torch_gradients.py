"""Gradients through laikago's MLCP contact rollout in the port
(``tds_tpu_torch/tools/contact_loss.py``) against the JAX package, the
loss of tests/test_contact_gradients.py: a PD-held laikago sliding forward
at 0.8 m/s from z = 0.47, the loss its final x plus its mean height, as a
function of the PD gain kp, one link's density scale and the ground
friction under ``friction_mode="world_default"``.

The horizon here is 100 steps, not the JAX test's 500, for the CPU's
budget: the port's CPU gradient takes about 12 s at 100 steps (the Python
loop under autograd), and ``chip_smoke.py`` phase 14 (b) runs the 500-step
loss on the card. Over 100 steps the friction gradient is smaller than
over 500 (8.7e-4 against the JAX test's floor of 1e-3); each gradient is
held above a floor that this horizon clears by a factor of 4 or more.

- the port's gradient equals ``jax.grad`` of the JAX loss within 1e-8
  relative, float64;
- it matches the port's own central differences at the JAX test's rtol
  2e-4 and eps;
- one gradient step on a trajectory-matching cost moves the friction
  toward the true value from 0.4 and from 0.9 (the JAX test's
  ``test_friction_sysid_direction``, through the port alone);
- ``World.friction_mode`` refuses other values, and ``"world_default"``
  takes the solver's friction where ``"geom_min"`` takes the geoms'.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.control.pd import pd_tau as j_pd_tau  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import aba_factor as j_aba_factor  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import forward_dynamics_from_kin as j_fd  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_euler_qdd as j_euler_qdd  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_q as j_integrate_q  # noqa: E402
from tds_tpu.dynamics.kinematics import fk_links as j_fk_links  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.world import resolve_contacts as j_resolve_contacts  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.tools import contact_loss  # noqa: E402
from tds_tpu_torch.world import World  # noqa: E402

STEPS = 100


def _jax_loss(env, steps):
    """tests/test_contact_gradients.py's ``_make_loss`` at ``steps``."""
    q0 = env.model.zero_q()
    off = env._joint_q_offset()
    q0 = q0.at[off : off + 12].set(env.initial_poses).at[2].set(0.47)
    qd0 = env.model.zero_qd().at[0].set(0.8)
    link = int(np.argmax(np.asarray(env.model.mass) > 1e-6))
    model0 = env.model

    def loss(kp, mscale, friction):
        s = jnp.ones_like(model0.mass).at[link].set(mscale)
        model = model0.replace(mass=model0.mass * s, com=model0.com * s[:, None], inertia=model0.inertia * s[:, None, None])
        world = env.world.replace(
            bodies=(env.world.bodies[0], model),
            solver=env.world.solver._replace(friction=friction),
            friction_mode="world_default",
        )

        def step(carry, _):
            q, qd = carry
            tau = j_pd_tau(model, q, qd, env.initial_poses, kp, env.kd, env.max_force, skip_links=env.skip_links)
            kin = j_fk_links(model, q, qd)
            factor = j_aba_factor(model, kin)
            qdd = j_fd(model, kin, q, qd, tau, env.gravity, factor=factor)
            qd = j_euler_qdd(model, q, qd, qdd, env.dt)
            zero = jnp.zeros((0,), q.dtype)
            qds = j_resolve_contacts(world, (zero, q), (zero, qd), env.dt, kins=[None, kin], factors=[None, factor])
            q, qd = j_integrate_q(model, q, qds[1], env.dt)
            return (q, qd), q[2]

        (q, _), heights = jax.lax.scan(step, (q0, qd0), None, length=steps)
        return q[0] + jnp.mean(heights)

    return loss, link


@pytest.fixture(scope="module")
def port():
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    q0, qd0, link = contact_loss.sliding_start(env)
    return env, contact_loss.make_loss(env, q0, qd0, link, STEPS), link


@pytest.fixture(scope="module")
def port_gradient(port):
    _, loss, _ = port
    value, grad = contact_loss.gradient(loss, contact_loss.POINT, torch.float64, "cpu")
    return float(value), grad.numpy()


def test_gradient_matches_jax(port, port_gradient):
    j_loss, j_link = _jax_loss(JaxLaikago(), STEPS)
    value, grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2)))(*contact_loss.POINT)
    assert port[2] == j_link
    np.testing.assert_allclose(port_gradient[0], float(value), rtol=1e-12)
    np.testing.assert_allclose(port_gradient[1], np.array([float(g) for g in grads]), rtol=1e-8)


def test_gradient_matches_central_differences(port, port_gradient):
    _, loss, _ = port
    fd = contact_loss.central_differences(loss, contact_loss.POINT, contact_loss.FD_EPS, torch.float64, "cpu").numpy()
    g_kp, g_ms, g_mu = port_gradient[1]
    # the loss depends on every parameter (floors for this horizon; see the docstring)
    assert abs(g_kp) > 1e-6 and abs(g_ms) > 1e-5 and abs(g_mu) > 1e-4, port_gradient[1]
    np.testing.assert_allclose(port_gradient[1], fd, rtol=2e-4)


def test_friction_sysid_direction(port):
    """One gradient step on (loss(mu) - loss(0.7))^2 moves mu toward 0.7."""
    env, loss, _ = port
    kp, ms, true_mu = 100.0, 1.0, 0.7
    with torch.no_grad():
        target = loss(*(torch.tensor(v, dtype=torch.float64) for v in (kp, ms, true_mu)))
    for mu0 in (0.4, 0.9):
        mu = torch.tensor(mu0, dtype=torch.float64, requires_grad=True)
        cost = (loss(torch.tensor(kp, dtype=torch.float64), torch.tensor(ms, dtype=torch.float64), mu) - target) ** 2
        (g,) = torch.autograd.grad(cost, mu)
        assert torch.isfinite(g)
        assert np.sign(-float(g)) == np.sign(true_mu - mu0), (mu0, float(g))


def test_friction_mode():
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="friction_mode"):
        dataclasses.replace(env.world, friction_mode="geom_max")
    from tds_tpu_torch.dynamics.kinematics import fk_links
    from tds_tpu_torch.world import gather_pair_contacts

    q = env.model.zero_q((2,))
    ground = q.new_zeros((2, 0))
    kin = [fk_links(env.world.bodies[0], ground, ground), fk_links(env.model, q, env.model.zero_qd((2,)))]
    geom = gather_pair_contacts(env.world, kin, 0, 1, q)
    mu = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    world = dataclasses.replace(env.world, solver=env.world.solver._replace(friction=mu, restitution=0.25), friction_mode="world_default")
    default = gather_pair_contacts(world, kin, 0, 1, q)
    assert isinstance(env.world, World) and env.world.friction_mode == "geom_min"
    assert geom.friction.tolist() == [0.5] * 4 and default.friction.tolist() == [0.9] * 4
    assert default.restitution.tolist() == [0.25] * 4 and default.friction.requires_grad
