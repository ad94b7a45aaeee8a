"""The spring-damper contact model in the port against the JAX package,
float64 on the CPU:

- ``compute_contact_force`` and ``compute_friction_force`` in every
  smoothing and friction mode (soft and hard gates, exponents, v_t = 0) at
  1e-12, and their gradients at v_t = 0;
- ``tests/test_spring_contact.py``'s ball through ``world_step``, 100 steps
  at 1e-10, and its d(final z)/d(z0) through ``world_rollout`` against
  ``jax.grad`` at 1e-9;
- the spring laikago (``LaikagoEnv(contact_model="spring")``), 20 steps at
  1e-10.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.contact import spring as jax_spring  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.model.geometry import GeomAttachment as JaxGeom  # noqa: E402
from tds_tpu.model.geometry import Sphere as JaxSphere  # noqa: E402
from tds_tpu.model.multibody import MultiBodyBuilder as JaxBuilder  # noqa: E402
from tds_tpu.world import build_world as jax_build_world  # noqa: E402
from tds_tpu.world import make_ground_plane as jax_ground  # noqa: E402
from tds_tpu.world import world_step as jax_world_step  # noqa: E402
from tds_tpu_torch.contact import spring  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import GeomAttachment, Sphere  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.world import build_world, make_ground_plane, world_rollout, world_step  # noqa: E402

GRAVITY = (0.0, 0.0, -9.81)
MODES = [
    dict(),
    dict(smoothing_method=spring.VelocitySmoothing.SIGMOID),
    dict(smoothing_method=spring.VelocitySmoothing.TANH),
    dict(smoothing_method=spring.VelocitySmoothing.ABS),
    dict(friction_model=spring.FrictionModel.ANDERSSON, mu_static=0.8, andersson_p=1.5),
    dict(friction_model=spring.FrictionModel.NONE),
    dict(smooth_alpha_normal=200.0, exponent_n=1.5, hard_contact_condition=False),
    dict(exponent_n=2.0, damper_d=30.0),
]
MODE_IDS = ["coulomb", "sigmoid", "tanh", "abs", "andersson", "no friction", "soft gate", "exponent 2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def unoptimized_jax():
    """The JAX package's reference compiled without XLA's optimisation
    passes: its compiles are most of this file's time, and its results
    agree to rounding."""
    optimized = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables


def params(kind, **kw):
    cls = jax_spring.SpringContactParams if kind == "jax" else spring.SpringContactParams
    return cls(**kw)


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_force_laws_match_jax(kw):
    rng = np.random.default_rng(0)
    distance = rng.uniform(-0.02, 0.01, 64)
    distance[:4] = (0.0, -1e-13, 1e-13, -0.01)
    vn = rng.normal(size=64)
    v_t = rng.normal(0.0, 0.3, (64, 3))
    v_t[:3] = 0.0  # the subgradient at rest
    v_t[3] = (1e-10, 0.0, 0.0)
    jp, tp = params("jax", **kw), params("torch", **kw)
    j_fn = jax.jit(lambda d, vn, vt: (lambda f: (f, jax_spring.compute_friction_force(f, vt, jp)))(jax_spring.compute_contact_force(d, vn, jp)))
    j_fn_n, j_ft = j_fn(*(jnp.asarray(x) for x in (distance, vn, v_t)))
    t_fn_n = spring.compute_contact_force(torch.from_numpy(distance), torch.from_numpy(vn), tp)
    t_ft = spring.compute_friction_force(t_fn_n, torch.from_numpy(v_t), tp)
    np.testing.assert_allclose(t_fn_n.numpy(), np.asarray(j_fn_n), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_ft.numpy(), np.asarray(j_ft), rtol=1e-12, atol=1e-12)
    # gradients of a scalar of both laws, at rest included
    def j_loss(d, vn, vt):
        f = jax_spring.compute_contact_force(d, vn, jp)
        return jnp.sum(f) + jnp.sum(jax_spring.compute_friction_force(f, vt, jp) * jnp.asarray([1.0, -2.0, 0.5]))

    j_grads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (distance, vn, v_t)))
    t_in = [torch.from_numpy(x).requires_grad_() for x in (distance, vn, v_t)]
    f = spring.compute_contact_force(t_in[0], t_in[1], tp)
    loss = f.sum() + (spring.compute_friction_force(f, t_in[2], tp) * torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)).sum()
    for got, want in zip(torch.autograd.grad(loss, t_in, allow_unused=True, materialize_grads=True), j_grads):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def balls(k=5000.0, d=100.0):
    """tests/test_spring_contact.py's ball (1 kg, inertia 0.1, radius 0.5)
    in both packages."""
    jb = JaxBuilder(is_floating=True, name="ball")
    jb.set_base_inertia(1.0, (0, 0, 0), np.diag([0.1] * 3))
    j_ball = jb.finalize()
    j_world = jax_build_world([jax_ground(), (j_ball, (JaxGeom(link_index=-1, shape=JaxSphere(0.5)),))],
                              contact_model="spring", spring=params("jax", spring_k=k, damper_d=d))
    tb = MultiBodyBuilder(is_floating=True, name="ball")
    tb.set_base_inertia(1.0, (0, 0, 0), np.diag([0.1] * 3))
    t_ball = tb.finalize(dtype=torch.float64, device="cpu")
    t_world = build_world([make_ground_plane(dtype=torch.float64, device="cpu"), (t_ball, (GeomAttachment(link_index=-1, shape=Sphere(0.5)),))],
                          contact_model="spring", spring=params("torch", spring_k=k, damper_d=d))
    return j_world, t_world


def test_ball_matches_jax():
    """100 steps of the ball dropped from 0.6 m with a slide and a spin."""
    j_world, t_world = balls()
    q = np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.52]])
    qd = np.array([[0.3, -0.2, 0.5, 0.8, -0.4, -0.5]])
    zero = np.zeros((1, 0))
    j_step = jax.jit(lambda qs, qds: jax_world_step(j_world, qs, qds, (zero, zero), jnp.asarray(GRAVITY), 1e-3))
    jqs, jqds = (jnp.asarray(zero), jnp.asarray(q)), (jnp.asarray(zero), jnp.asarray(qd))
    tqs, tqds = (torch.zeros(1, 0, dtype=torch.float64), torch.from_numpy(q)), (torch.zeros(1, 0, dtype=torch.float64), torch.from_numpy(qd))
    gravity = torch.tensor(GRAVITY, dtype=torch.float64)
    touched = False
    for t in range(100):
        jqs, jqds = j_step(jqs, jqds)
        tqs, tqds = world_step(t_world, tqs, tqds, None, gravity, 1e-3)
        touched |= bool(tqs[1][0, 6] < 0.5)
        np.testing.assert_allclose(tqs[1].numpy(), np.asarray(jqs[1]), rtol=1e-10, atol=1e-10, err_msg=f"q at step {t + 1}")
        np.testing.assert_allclose(tqds[1].numpy(), np.asarray(jqds[1]), rtol=1e-10, atol=1e-10, err_msg=f"qd at step {t + 1}")
    assert touched


def test_ball_gradient_matches_jax():
    """d(final z)/d(z0) over 400 steps from 0.9 m (k 2000, d 50), the JAX
    test's loss, against jax.grad."""
    j_world, t_world = balls(2000.0, 50.0)
    zero = jnp.zeros(0)

    def j_final_z(z0):
        q = jnp.zeros(7).at[3].set(1.0).at[6].set(z0)

        def step(carry, _):
            return jax_world_step(j_world, carry[0], carry[1], (zero, zero), jnp.asarray(GRAVITY), 1e-3), None

        (qs, _), _ = jax.lax.scan(step, ((zero, q), (zero, jnp.zeros(6))), None, length=400)
        return qs[1][6]

    j_grad = float(jax.jit(jax.grad(j_final_z))(0.9))
    z0 = torch.tensor([0.9], dtype=torch.float64, requires_grad=True)
    ball = t_world.bodies[1]
    q0 = torch.cat([ball.zero_q((1,))[:, :6], z0[:, None]], dim=-1)
    ground = torch.zeros(1, 0, dtype=torch.float64)
    qs, _ = world_rollout(t_world, (ground, q0), (ground, ball.zero_qd((1,))), torch.tensor(GRAVITY, dtype=torch.float64), 1e-3, 400)
    (t_grad,) = torch.autograd.grad(qs[1][0, 6], z0)
    assert abs(t_grad.item() - j_grad) <= 1e-9 * (1 + abs(j_grad)), (t_grad.item(), j_grad)


def test_spring_laikago_matches_jax():
    """20 float64 steps of the laikago on spring contact from a lowered
    start (the toes touch from the first step), seeded actions."""
    start = (0.0, 0.0, 0.45)
    j_env = JaxLaikago(dtype=jnp.float64, contact_model="spring", start_base_position=start)
    env = LaikagoEnv(dtype=torch.float64, device="cpu", contact_model="spring", start_base_position=start)
    rng = np.random.default_rng(13)
    q, qd = env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (3, env.action_dim))))
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    for t in range(1, 21):
        action = rng.uniform(-0.4, 0.4, size=(3, env.action_dim))
        jq, jqd = j_step(jq, jqd, jnp.asarray(action))
        q, qd = env.sim_step(q, qd, torch.from_numpy(action))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-10, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=1e-10, atol=1e-10, err_msg=f"qd at step {t}")
    assert (env.world.contact_model, env.step_params) == ("spring", None)
