"""``world_step`` in the port against the JAX package's and the C++ golden,
float64 on the CPU.

- a ball on the plane, a floating body with a revolute link under
  ``f_exts`` and joint torques, and a sphere on a 20-degree incline
  (``pgs_iterations=20``) against the JAX package's ``world_step`` (jitted
  one step at a time) at 1e-9;
- ``tests/golden/sphere_contact_trajectory.json`` (a spinning sphere
  dropped on the plane, 500 steps) at ``tests/test_golden_reference.py``'s
  tolerances, through ``world_rollout``'s scan between the snapshots;
- the gradient of a 100-step ball loss (``tools/ball_loss.py``) with
  respect to the initial velocity against ``jax.grad`` at 1e-9;
- ``system_constructor(..., is_floating=True)`` against the JAX package's.
"""

import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.contact.mlcp import ContactSolverParams as JaxSolverParams  # noqa: E402
from tds_tpu.model.geometry import GeomAttachment as JaxGeom  # noqa: E402
from tds_tpu.model.geometry import Sphere as JaxSphere  # noqa: E402
from tds_tpu.model.joints import JointType as JaxJointType  # noqa: E402
from tds_tpu.model.multibody import MultiBodyBuilder as JaxBuilder  # noqa: E402
from tds_tpu.world import build_world as jax_build_world  # noqa: E402
from tds_tpu.world import make_ground_plane as jax_ground  # noqa: E402
from tds_tpu.world import world_step as jax_world_step  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.model.geometry import GeomAttachment, Sphere  # noqa: E402
from tds_tpu_torch.model.joints import JointType  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.tools import ball_loss  # noqa: E402
from tds_tpu_torch.world import build_world, make_ground_plane, world_rollout, world_step  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sphere_contact_trajectory.json")
GRAVITY = (0.0, 0.0, -9.81)
TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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


def _both(build):
    """``build(Builder, Geom, Sphere, JointType, ground, build_world,
    Solver)`` with each package's classes: (JAX world, port world)."""
    jax_world = build(JaxBuilder, JaxGeom, JaxSphere, JaxJointType, jax_ground, jax_build_world, JaxSolverParams, {})
    port_world = build(MultiBodyBuilder, GeomAttachment, Sphere, JointType, make_ground_plane, build_world, ContactSolverParams,
                       dict(device="cpu"))
    return jax_world, port_world


def _ball(Builder, Geom, Sphere, JointType, ground, build_world, Solver, device):
    b = Builder(is_floating=True, name="ball")
    b.set_base_inertia(1.5, (0, 0, 0), np.diag([0.024] * 3))
    ball = b.finalize(dtype=torch.float64, **device) if device else b.finalize()
    return build_world([ground(**device), (ball, (Geom(link_index=-1, shape=Sphere(0.2)),))])


def _flywheel(Builder, Geom, Sphere, JointType, ground, build_world, Solver, device):
    """A floating ball with a revolute arm about its x axis carrying 0.5 kg:
    the arm takes torques and world-frame link forces."""
    b = Builder(is_floating=True, name="flywheel")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.016] * 3))
    b.add_link(JointType.REVOLUTE_X, -1, x_t_pos=(0.0, 0.0, 0.05), mass=0.5, com=(0.0, 0.15, 0.0),
               inertia_about_com=(0.004, 0.001, 0.004))
    body = b.finalize(dtype=torch.float64, **device) if device else b.finalize()
    solver = Solver(pgs_iterations=4)
    return build_world([ground(**device), (body, (Geom(link_index=-1, shape=Sphere(0.2)),))], solver=solver)


INCLINE = math.radians(20.0)


def _incline(Builder, Geom, Sphere, JointType, ground, build_world, Solver, device):
    """tests/test_inclined_plane.py's rolling sphere: radius 0.5, mass 1,
    friction 0.8, 20 PGS sweeps, on a plane tilted 20 degrees about y."""
    b = Builder(is_floating=True, name="body")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.4 * 0.25] * 3))
    body = b.finalize(dtype=torch.float64, **device) if device else b.finalize()
    normal = (-math.sin(INCLINE), 0.0, math.cos(INCLINE))
    geom = Geom(link_index=-1, shape=Sphere(0.5), friction=0.8)
    return build_world([ground(normal=normal, **device), (body, (geom,))], solver=Solver(friction=0.8, pgs_iterations=20))


def _run_both(jax_world, world, q0, qd0, steps, taus=None, f_ext=None):
    """``steps`` world_steps of a batch in both packages (JAX: one jitted,
    vmapped step at a time), comparing every step at TOL; ``taus`` (B, 1)
    and ``f_ext`` (B, 1, 6) on the robot when given."""
    batch = q0.shape[0]
    g = jnp.asarray(GRAVITY)

    def one(q, qd, tau, fe):
        j_taus = None if taus is None else (jnp.zeros(0), tau)
        j_fext = None if f_ext is None else (None, fe)
        return jax_world_step(jax_world, (jnp.zeros(0), q), (jnp.zeros(0), qd), j_taus, g, 1e-3, f_exts=j_fext)

    j_step = jax.jit(jax.vmap(one))
    j_tau = jnp.zeros((batch, 1)) if taus is None else jnp.asarray(taus)
    j_fe = jnp.zeros((batch, 1, 6)) if f_ext is None else jnp.asarray(f_ext)
    jq, jqd = jnp.asarray(q0), jnp.asarray(qd0)
    ground = torch.zeros(batch, 0, dtype=torch.float64)
    qs, qds = (ground, torch.from_numpy(q0)), (ground, torch.from_numpy(qd0))
    t_taus = None if taus is None else (ground, torch.from_numpy(taus))
    f_exts = None if f_ext is None else (None, torch.from_numpy(f_ext))
    gravity = torch.tensor(GRAVITY, dtype=torch.float64)
    for t in range(1, steps + 1):
        (_, jq), (_, jqd) = j_step(jq, jqd, j_tau, j_fe)
        qs, qds = world_step(world, qs, qds, t_taus, gravity, 1e-3, f_exts=f_exts)
        assert qs[0] is ground and qds[0] is ground
        np.testing.assert_allclose(qs[1].numpy(), np.asarray(jq), rtol=TOL, atol=TOL, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qds[1].numpy(), np.asarray(jqd), rtol=TOL, atol=TOL, err_msg=f"qd at step {t}")
    return qs, qds


def test_ball_on_the_plane_matches_jax():
    """Two balls dropped spinning and sliding, one from just above the
    plane (it lands in a few steps) and one resting in it."""
    jax_world, world = _both(_ball)
    q0 = np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.21], [0.0, 0.0, 0.0, 1.0, 0.5, 0.2, 0.199]])
    qd0 = np.array([[0.3, 0.0, 0.0, 1.0, -0.5, 0.0], [0.0, 2.0, 0.5, -0.3, 0.8, 0.0]])
    qs, _ = _run_both(jax_world, world, q0, qd0, 100)
    assert qs[1][:, 6].max() < 0.2  # both in contact at the end


def test_body_with_f_exts_and_torques_matches_jax():
    """A floating body whose revolute arm is driven by a torque and pushed
    by a world-frame force (f_exts): the floating base's bias and ABA,
    through world_step, with the contact."""
    jax_world, world = _both(_flywheel)
    rng = np.random.default_rng(8)
    q0 = np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.199, 0.3], [0.0, 0.0, 0.0, 1.0, 0.1, -0.1, 0.2005, -0.4]])
    qd0 = rng.normal(0.0, 0.3, size=(2, 7))
    taus = np.array([[0.2], [-0.1]])
    f_ext = rng.normal(0.0, 0.5, size=(2, 1, 6))
    _run_both(jax_world, world, q0, qd0, 60, taus=taus, f_ext=f_ext)
    # the torque and the force move the state: one step without them differs
    ground = torch.zeros(2, 0, dtype=torch.float64)
    start = ((ground, torch.from_numpy(q0)), (ground, torch.from_numpy(qd0)), torch.tensor(GRAVITY, dtype=torch.float64))
    pushed = world_step(world, start[0], start[1], (ground, torch.from_numpy(taus)), start[2], 1e-3,
                        f_exts=(None, torch.from_numpy(f_ext)))[1][1]
    assert (pushed - world_step(world, *start[:2], None, start[2], 1e-3)[1][1]).abs().amax(-1).min() > 1e-4


def test_sphere_on_the_incline_matches_jax():
    jax_world, world = _both(_incline)
    n = np.array([-math.sin(INCLINE), 0.0, math.cos(INCLINE)])
    q0 = np.concatenate([[0.0, 0.0, 0.0, 1.0], (0.5 - 1e-4) * n])[None]
    qs, qds = _run_both(jax_world, world, q0, np.zeros((1, 6)), 80)
    downhill = np.array([-math.cos(INCLINE), 0.0, -math.sin(INCLINE)])
    assert float(qds[1][0, 3:6] @ torch.from_numpy(downhill)) > 0.1  # it rolls downhill


def test_golden_sphere_contact_trajectory():
    """The reference's spinning sphere through its MLCP world for 500 steps,
    stepped by world_rollout between the snapshots."""
    _, world = _both(_ball)
    with open(GOLDEN) as f:
        golden = json.load(f)
    snaps, dt = golden["snapshots"], golden["dt"]
    ground = torch.zeros(1, 0, dtype=torch.float64)
    qs = (ground, torch.tensor([snaps["0"]["q"]], dtype=torch.float64))
    qds = (ground, torch.tensor([snaps["0"]["qd"]], dtype=torch.float64))
    gravity = torch.tensor(GRAVITY, dtype=torch.float64)
    done = 0
    for t in sorted(int(k) for k in snaps if k != "0"):
        qs, qds = world_rollout(world, qs, qds, gravity, dt, t - done)
        done = t
        tol = 1e-8 if t <= 100 else 1e-6
        np.testing.assert_allclose(qs[1][0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qds[1][0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
    assert done == 500


def test_ball_loss_gradient_matches_jax_grad():
    """d loss / d (vx, vy) of tools/ball_loss.py's 100-step loss: the port's
    autograd through world_rollout's scan against jax.grad of the JAX
    package's lax.scan of world_step."""
    steps = 100
    b = JaxBuilder(is_floating=True, name="ball")
    b.set_base_inertia(ball_loss.MASS, (0, 0, 0), np.diag([0.4 * ball_loss.MASS * ball_loss.RADIUS**2] * 3))
    j_ball = b.finalize()
    geom = (JaxGeom(link_index=-1, shape=JaxSphere(ball_loss.RADIUS), friction=0.2, restitution=0.9),)
    j_world = jax_build_world([jax_ground(), (j_ball, geom)],
                              solver=JaxSolverParams(restitution=0.9, friction=0.2, pgs_iterations=4))
    q0 = j_ball.zero_q().at[6].set(ball_loss.RADIUS)

    def j_loss(v):
        qd0 = j_ball.zero_qd().at[3:5].set(v)

        def step(carry, _):
            return jax_world_step(j_world, *carry, (jnp.zeros(0), jnp.zeros(0)), jnp.asarray(GRAVITY), ball_loss.DT), None

        (qs, _), _ = jax.lax.scan(step, ((jnp.zeros(0), q0), (jnp.zeros(0), qd0)), None, length=steps)
        return jnp.sum((qs[1][4:6] - jnp.asarray(ball_loss.GOAL)) ** 2)

    shots = np.array([ball_loss.VELOCITY, (1.2, -0.6)])
    j_value, j_grad = jax.jit(jax.vmap(jax.value_and_grad(j_loss)))(jnp.asarray(shots))
    world = ball_loss.ball_world(device="cpu")
    value, grad = ball_loss.gradient(world, torch.from_numpy(shots), steps)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=TOL, atol=TOL)
    assert np.abs(grad.numpy()).min() > 1e-3


def test_system_constructor_floating_matches_jax():
    from tds_tpu.urdf.system_constructor import system_constructor as jax_system_constructor
    from tds_tpu_torch.urdf.system_constructor import system_constructor

    urdf = "laikago/laikago_toes_zup.urdf"
    j_model, j_world = jax_system_constructor(urdf_filename=urdf, is_floating=True, joint_damping=0.1)
    model, world = system_constructor(urdf_filename=urdf, is_floating=True, joint_damping=0.1, device="cpu")
    assert model.is_floating and (model.dof_q, model.dof_qd) == (j_model.dof_q, j_model.dof_qd) == (19, 18)
    for field in ("x_t_pos", "x_t_rot", "joint_axis", "mass", "com", "inertia", "damping", "base_mass", "base_com",
                  "base_inertia"):
        np.testing.assert_array_equal(getattr(model, field).numpy(), np.asarray(getattr(j_model, field)), err_msg=field)
    assert world.num_bodies == j_world.num_bodies == 2 and world.bodies[0].dof_qd == 0
    assert [[(g.link_index, type(g.shape).__name__, g.pos) for g in geoms] for geoms in world.geoms] == \
        [[(g.link_index, type(g.shape).__name__, g.pos) for g in geoms] for geoms in j_world.geoms]
    with open(os.path.join(os.path.dirname(__file__), "..", "tds_tpu", "data", urdf)) as f:
        text = f.read()
    from_text, _ = system_constructor(urdf_string=text, is_floating=True, device="cpu")
    np.testing.assert_array_equal(from_text.inertia.numpy(), model.inertia.numpy())
    with pytest.raises(ValueError):
        system_constructor(device="cpu")
