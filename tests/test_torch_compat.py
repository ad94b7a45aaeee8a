"""The pytinydiffsim-style shim in the port (tds_tpu_torch.compat) on the
CPU: its names against the JAX package's, the reference's step loop (a
floating ball dropped on the plane, tests/test_compat.py) and the
contact-solver objects against the JAX shim in float64, the math and
record helpers, and the stateful env adapters."""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu import compat as J  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_q as j_integrate_q  # noqa: E402
from tds_tpu_torch import compat as T  # noqa: E402
from tds_tpu_torch.dynamics.integrator import integrate_q  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread; the JAX reference compiled without XLA's
    optimisation passes (its compiles are most of the JAX side's time)."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()
    torch.set_num_threads(threads)


TOL = 1e-12  # float64, the same ABA, contact solve and integrator
BALL = """
<robot name="ball">
  <link name="base">
    <inertial><mass value="1"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial>
    <collision><geometry><sphere radius="0.5"/></geometry></collision>
  </link>
</robot>
"""
PLANE = """
<robot name="plane"><link name="base">
<collision><geometry><plane normal="0 0 1"/></geometry></collision>
</link></robot>
"""


def public(module):
    """A module's public names, less the modules and typing names it imports."""
    return {
        n for n, v in vars(module).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType) and getattr(v, "__module__", None) != "typing"
    }


def test_every_name_of_the_jax_shim():
    """The name sweep: every public name of tds_tpu.compat (the 84 bound
    names, the enum members at module scope, the functional-core names it
    re-exports) is in the port's."""
    missing = sorted(public(J) - public(T))
    assert not missing, missing
    assert len(public(J)) > 84


def port_step(mb, world, dt=1e-3):
    """tests/test_compat.py's loop body: forward dynamics, the velocity
    update, the world's contact pass, the position update."""
    T.forward_dynamics(mb, world.gravity)
    mb.qd = mb.qd + mb.qdd * dt
    mb.qdd = torch.zeros_like(mb.qdd)
    world.step(dt)
    q, qd = integrate_q(mb.model, mb.q[None], mb.qd[None], dt)
    mb.q, mb.qd = q[0], qd[0]


def ball_world(z0):
    mb = T.UrdfParser.load_urdf_from_string(BALL, is_floating=True, device="cpu")
    world = T.TinyWorld(device="cpu")
    world.bodies.append(mb)
    q = mb.q.clone()
    q[6] = z0
    mb.set_q(q)
    return mb, world


@pytest.mark.parametrize("z0", [1.0, 0.52], ids=["dropped", "landing"])
def test_world_step_loop_matches_jax(z0):
    """100 steps of the loop against the JAX shim's, at 1e-12 each step:
    from test_compat.py's z = 1 (in flight all 100 steps) and from z = 0.52,
    which lands at step ~64, so the contact pass resolves contacts."""
    jmb = J.UrdfParser.load_urdf_from_string(BALL, is_floating=True)
    jworld = J.TinyWorld()
    jworld.bodies.append(jmb)

    @jax.jit
    def j_step(q, qd):
        jmb.q, jmb.qd = q, qd
        J.forward_dynamics(jmb, jworld.gravity)
        jmb.qd = jmb.qd + jmb.qdd * 1e-3
        jmb.qdd = jnp.zeros_like(jmb.qdd)
        jworld.step(1e-3)
        return j_integrate_q(jmb.model, jmb.q, jmb.qd, 1e-3)

    mb, world = ball_world(z0)
    jq, jqd = jmb.q.at[6].set(z0), jmb.qd
    for k in range(100):
        jq, jqd = j_step(jq, jqd)
        port_step(mb, world)
        np.testing.assert_allclose(mb.q.numpy(), np.asarray(jq), rtol=TOL, atol=TOL, err_msg=f"q at step {k + 1}")
        np.testing.assert_allclose(mb.qd.numpy(), np.asarray(jqd), rtol=TOL, atol=TOL, err_msg=f"qd at step {k + 1}")
    if z0 < 0.6:
        assert float(mb.q[6]) < 0.5 + 1e-4 and float(mb.qd[5]) > -0.1  # landed: the contact pass acted


def test_world_step_loop_rests_on_the_plane():
    """test_compat.py's 700 steps from z = 1 in the port alone, at its
    thresholds: the ball fell and rests on the plane."""
    mb, world = ball_world(1.0)
    for _ in range(700):
        port_step(mb, world)
    assert 0.45 < float(mb.q[6]) < 0.55
    assert abs(float(mb.qd[5])) < 0.1


def test_contact_solver_bindings_match_jax():
    """test_compat.py's contact-solver objects (:189) on both shims: the
    sequential-impulse pair, the MLCP solver object on a ball sinking into
    a plane, the spring solver's force laws, at 1e-12."""
    j_a, t_a = J.TinyRigidBody(1.0, position=(0.0, 0.0, 0.45)), T.TinyRigidBody(1.0, position=(0.0, 0.0, 0.45), device="cpu")
    j_a.state = j_a.state.replace(linear_velocity=jnp.asarray([0.0, 0.0, -1.0]))
    t_a.state = t_a.state._replace(linear_velocity=torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64))
    # the JAX shim's rigid bodies hold float32 masses and positions: a heavy
    # floor of 2^40 kg is exact in both types, as is 1 / 2^40
    j_b, t_b = J.TinyRigidBody(2.0**40), T.TinyRigidBody(2.0**40, device="cpu")
    for shim, a, b, device in ((J, j_a, j_b, {}), (T, t_a, t_b, {"device": "cpu"})):
        cp = shim.TinyContactPointRigidBody(**device)
        cp.rigid_body_a, cp.rigid_body_b = a, b
        cp.world_normal_on_b = [0.0, 0.0, 1.0]
        cp.world_point_on_a = [0.0, 0.0, -0.05]
        cp.world_point_on_b = [0.0, 0.0, 0.0]
        cp.distance = -0.05
        shim.TinyConstraintSolver().resolve_collision(cp, 0.01)
    for field in ("linear_velocity", "angular_velocity"):
        np.testing.assert_allclose(getattr(t_a.state, field).numpy(), np.asarray(getattr(j_a.state, field)), rtol=TOL,
                                   atol=TOL, err_msg=field)
    assert float(t_a.state.linear_velocity[2]) > -1e-6  # the approach is cancelled

    bodies = []
    for shim, device in ((J, {}), (T, {"device": "cpu"})):
        mb = shim.UrdfParser.load_urdf_from_string(BALL, is_floating=True, **device)
        q, qd = np.zeros(7), np.zeros(6)
        q[3], q[6], qd[5], qd[0] = 1.0, 0.45, -1.0, 0.3
        mb.set_q(q if device else jnp.asarray(q))
        mb.set_qd(qd if device else jnp.asarray(qd))
        plane = shim.UrdfParser.load_urdf_from_string(PLANE, **device)
        mcp = shim.TinyContactPointMultiBody(**device)
        mcp.multi_body_a, mcp.multi_body_b = mb, plane
        mcp.world_normal_on_b = [0.0, 0.0, 1.0]
        mcp.world_point_on_a = [0.0, 0.0, -0.05]
        mcp.world_point_on_b = [0.0, 0.0, 0.0]
        mcp.distance = -0.05
        solver = shim.TinyMultiBodyConstraintSolver()
        solver.pgs_iterations_ = 30
        solver.resolve_collision([mcp], 0.01)
        bodies.append(mb)
    np.testing.assert_allclose(bodies[1].qd.numpy(), np.asarray(bodies[0].qd), rtol=TOL, atol=TOL)
    assert float(bodies[1].qd[5]) > -1e-6  # the normal velocity is resolved

    j_spring, t_spring = J.TinyMultiBodyConstraintSolverSpring(), T.TinyMultiBodyConstraintSolverSpring()
    for d, vn in ((-0.01, -0.1), (-0.003, 0.2), (0.01, -0.1)):
        np.testing.assert_allclose(t_spring.compute_contact_force(d, vn).numpy(),
                                   np.asarray(j_spring.compute_contact_force(d, vn)), rtol=TOL, atol=TOL)
    v_t = np.array([[0.2, 0.0], [-0.03, 0.05]])
    np.testing.assert_allclose(t_spring.compute_friction_force(10.0, v_t).numpy(),
                               np.asarray(j_spring.compute_friction_force(jnp.asarray(10.0), jnp.asarray(v_t))),
                               rtol=TOL, atol=TOL)


def test_math_and_records_match_jax():
    """The quaternion and Euler helpers, the inertia dyad, TinyLink's jcalc,
    TinyPose, IK toward a point and TinyRaycast's volumes on both shims."""
    rpy = np.array([0.1, -0.2, 0.3])
    q = T.quat_from_euler_rpy(rpy)
    np.testing.assert_allclose(q.numpy(), np.asarray(J.quat_from_euler_rpy(jnp.asarray(rpy))), atol=TOL)
    np.testing.assert_allclose(T.get_euler_rpy(q).numpy(), rpy, atol=1e-12)
    qa, qb = T.quaternion_axis_angle([0.0, 0.0, 1.0], 0.5), T.quaternion_axis_angle([0.0, 0.0, 1.0], 0.7)
    np.testing.assert_allclose(T.quat_difference(qa, qb).numpy(), np.asarray(J.quat_difference(
        J.quaternion_axis_angle([0.0, 0.0, 1.0], 0.5), J.quaternion_axis_angle([0.0, 0.0, 1.0], 0.7))), atol=TOL)
    np.testing.assert_allclose(T.matrix_to_euler_xyz(T.quat_to_matrix(qa)).numpy(), [0.0, 0.0, 0.5], atol=1e-12)
    np.testing.assert_allclose(T.quat_integrate(T.Quaternion(device="cpu"), [0.0, 0.0, 1.0], 0.01).numpy(),
                               np.asarray(J.quat_integrate(J.Quaternion(), [0.0, 0.0, 1.0], 0.01)), atol=TOL)
    t_dyad, j_dyad = T.compute_inertia_dyad(1.5, [0.0, 0.1, 0.2], 0.02 * np.eye(3)), J.compute_inertia_dyad(
        1.5, [0.0, 0.1, 0.2], 0.02 * np.eye(3))
    for field in ("mass", "h", "inertia"):
        np.testing.assert_allclose(getattr(t_dyad, field).numpy(), np.asarray(getattr(j_dyad, field)), atol=TOL)

    from tds_tpu_torch.algebra.transform import Transform

    eye = Transform(pos=torch.zeros(3, dtype=torch.float64), rot=torch.eye(3, dtype=torch.float64))
    link = T.TinyLink(T.JOINT_REVOLUTE_Z, eye, t_dyad)
    xw = link.jcalc(np.pi / 2)
    np.testing.assert_allclose((xw.rot @ torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)).numpy(), [0.0, 1.0, 0.0],
                               atol=1e-12)
    pose = T.TinyPose([1.0, 0.0, 0.0], T.quaternion_axis_angle([0, 0, 1], np.pi / 2))
    np.testing.assert_allclose(pose.inverse_transform(pose.transform([1.0, 0.0, 0.0])).numpy(), [1.0, 0.0, 0.0],
                               atol=1e-12)

    from tds_tpu.model.pendulum import compound_pendulum as j_pendulum
    from tds_tpu_torch.model.pendulum import compound_pendulum

    j_mb, t_mb = J.TinyMultiBody(j_pendulum(2)), T.TinyMultiBody(compound_pendulum(2, device="cpu"))
    j_mb.set_q(jnp.array([0.4, -0.1]))
    t_mb.set_q([0.4, -0.1])
    target = np.asarray(J.forward_kinematics(j_mb)[1][1].pos) + [0.01, 0.0, 0.01]
    np.testing.assert_allclose(T.inverse_kinematics_compat(t_mb, 1, target).numpy(),
                               np.asarray(J.inverse_kinematics_compat(j_mb, 1, target)), atol=1e-10)
    np.testing.assert_allclose(T.mass_matrix(t_mb).numpy(), np.asarray(J.mass_matrix(j_mb)), atol=TOL)
    for shim, mb in ((J, j_mb), (T, t_mb)):
        mb.qdd = mb.q * 0 + 1.0
        shim.integrate_euler_qdd(mb, 0.01)
    np.testing.assert_allclose(t_mb.qd.numpy(), np.asarray(j_mb.qd), atol=TOL)

    col = T.TinyUrdfCollision()
    col.geometry = T.TinyUrdfGeometry(geom_type="sphere", radius=0.25)
    box = T.TinyUrdfCollision()
    box.geometry = T.TinyUrdfGeometry(geom_type="box", extents=(1.0, 1.0, 1.0))
    box.origin_rpy = (0.0, 0.0, 0.3)
    rays = ([[0.0, 0.1, 1.0], [0.2, 0.0, 1.0]], [[0.0, 0.1, -1.0], [0.2, 0.05, -1.0]])
    t_rc, j_rc = T.TinyRaycast(), J.TinyRaycast()
    t_hits, j_hits = t_rc.cast_rays(*rays, [col, box]), j_rc.cast_rays(*rays, [col, box])
    for t_ray, j_ray in zip(t_hits, j_hits):
        assert [h.collider_index for h in t_ray] == [h.collider_index for h in j_ray]
        np.testing.assert_allclose([h.hit_fraction for h in t_ray], [h.hit_fraction for h in j_ray], atol=1e-12)
    assert t_rc.volume(t_hits) == pytest.approx(j_rc.volume(j_hits), abs=1e-12)


def test_stateful_env_adapters():
    """The .inl stateful API over the port's envs on the CPU: the cartpole's
    reset / step / policy / rollout, the functional pass-through, and the
    vectorized ant's reset and step shapes with the visual transforms."""
    env = T.CartpoleEnv(dtype=torch.float64, device="cpu")
    env.seed(3)
    obs = env.reset()
    assert obs.shape == (env.observation_dim,)
    out = env.step(torch.zeros(env.action_dim))
    assert isinstance(out, T.CartpoleEnvOutput) and np.isfinite(out.reward)
    env.init_neural_network(torch.zeros(env._policy.num_parameters))
    assert env.policy(obs).shape == (env.action_dim,)
    ro = env.rollout(max_steps=20)
    assert isinstance(ro, T.CartpoleRolloutOutput) and ro.num_steps <= 20 and np.isfinite(ro.total_reward)
    state, obs2 = env.reset(torch.Generator().manual_seed(0))
    state, obs2, r, d = env.step(state, torch.zeros(1, env.action_dim, dtype=torch.float64))
    assert bool(torch.isfinite(r).all())

    venv = T.VectorizedAntEnv(num_envs=2, dtype=torch.float64, device="cpu")
    assert venv.action_dim() == venv.env.action_dim and venv.obs_dim() == venv.env.observation_dim
    assert venv.urdf_filename().endswith(".urdf")
    vobs = venv.reset()
    assert vobs.shape == (2, venv.env.observation_dim)
    vout = venv.step(torch.zeros((2, venv.env.action_dim)))
    assert isinstance(vout, T.VectorizedAntEnvOutput) and vout.rewards.shape == (2,)
    n_links = len(venv.env.model.joint_types)
    assert vout.visual_world_transforms.shape == (2, 1 + n_links, 7)
    assert bool(torch.isfinite(vout.visual_world_transforms).all())
    quat_norm = torch.linalg.vector_norm(vout.visual_world_transforms[..., 3:], dim=-1)
    np.testing.assert_allclose(quat_norm.numpy(), 1.0, atol=1e-12)


def test_default_device_is_the_card():
    """Without a device the shim's objects go to the card, and raise where
    there is none."""
    if torch.cuda.is_available():
        assert T.Vector3(1.0, 2.0, 3.0).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.TinyWorld()
