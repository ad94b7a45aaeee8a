"""Control in the port against the JAX package, float64 on the CPU, on
inputs drawn from a numpy seed:

- single rigid bodies and the sequential impulse solver; the actuators
  (direct, series-elastic, servo, the actuator net on a flat ``MLPSpec``
  vector crossed by ``convert.mlp_params_from_numpy``); the three IK
  methods on the panda (1e-9: ``torch.linalg.pinv`` and ``solve_ex`` for
  ``jnp.linalg.pinv`` and ``solve``);
- the MPC stack over 4 envs against ``jax.vmap`` of the JAX functions at
  1e-10: ``gait_update``, the velocity window, the swing-leg functions,
  ``discretize``, ``condensed_qp_mats``, ``compute_contact_forces``;
- one ``controller.update`` and 2 ticks of ``make_walk_step`` (the
  controller and 5 physics substeps a tick) against
  ``jax.vmap(jax.jit(tick))`` at 1e-9, from a state crossed by
  ``convert.mpc_state_from_numpy``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from examples.laikago_mpc_walk import build as jax_build  # noqa: E402
from tds_tpu import rigid_body as jax_rb  # noqa: E402
from tds_tpu.control import actuators as jax_act  # noqa: E402
from tds_tpu.control.ik import IKMethod as JaxIKMethod  # noqa: E402
from tds_tpu.control.ik import IKTarget as JaxIKTarget  # noqa: E402
from tds_tpu.control.ik import inverse_kinematics as jax_ik  # noqa: E402
from tds_tpu.control.mpc import convex_mpc as jax_mpc  # noqa: E402
from tds_tpu.control.mpc import gait as jax_gait  # noqa: E402
from tds_tpu.control.mpc import swing_leg as jax_swing  # noqa: E402
from tds_tpu.control.mpc.locomotion import LocomotionMpcState as JaxMpcState  # noqa: E402
from tds_tpu.control.mpc.locomotion import make_walk_step as jax_make_walk_step  # noqa: E402
from tds_tpu.urdf.cache import construct as jax_construct  # noqa: E402
from tds_tpu_torch import rigid_body as rb  # noqa: E402
from tds_tpu_torch.control import actuators as act  # noqa: E402
from tds_tpu_torch.control.ik import IKMethod, IKTarget, inverse_kinematics  # noqa: E402
from tds_tpu_torch.control.mpc import convex_mpc as mpc  # noqa: E402
from tds_tpu_torch.control.mpc import gait, swing_leg  # noqa: E402
from tds_tpu_torch.control.mpc.locomotion import make_walk_step  # noqa: E402
from tds_tpu_torch.convert import mlp_params_from_numpy, mpc_state_from_numpy  # noqa: E402
from tds_tpu_torch.tools.mpc_walk import build  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402
from tds_tpu_torch.utils.tensors import constant_like  # noqa: E402

B = 4


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


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


# -- rigid bodies, actuators, IK ----------------------------------------------
def rigid_body_run(mod, arr, dtype, pos, quat, vel, ang, rel, normal, distance):
    """A body of 2.5 kg under gravity, a central force and a torque, its
    contact impulse against a static one, then an integration step, in the
    package ``mod``; returns its fields, a point velocity and the static
    body's velocity."""
    body = mod.RigidBodyState.create(dtype=dtype)
    fields = dict(position=arr(pos), orientation=arr(quat), linear_velocity=arr(vel), angular_velocity=arr(ang),
                  total_force=arr(np.zeros_like(pos)), total_torque=arr(rel))
    body = body.replace(**fields) if mod is jax_rb else body._replace(**fields)
    params, static = mod.RigidBodyParams.create(2.5, dtype=dtype), mod.RigidBodyParams.create(0.0, dtype=dtype)
    body = mod.apply_force_impulse(mod.apply_central_force(mod.apply_gravity(body, params, arr((0.0, 0.0, -9.81))), arr(rel)),
                                   params, 1e-3)
    body, ground = mod.resolve_contact_sequential_impulse(
        body, params, mod.RigidBodyState.create(dtype=dtype), static, arr(normal), arr(pos + rel), arr(pos + rel - 0.01),
        arr(distance), 1e-3, friction=0.7, restitution=0.1)
    body = mod.integrate(mod.clear_forces(body), 1e-3)
    names = ("position", "orientation", "linear_velocity", "angular_velocity", "total_force", "total_torque")
    return [np.asarray(getattr(body, n)) for n in names] + [np.asarray(mod.point_velocity(body, arr(rel))),
                                                             np.asarray(ground.linear_velocity)]


def test_rigid_bodies_match_jax():
    rng = np.random.default_rng(0)
    pos, vel, ang, rel = (rng.normal(size=(B, 3)) for _ in range(4))
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    inputs = (pos, quat, vel, ang, rel, np.tile((0.0, 0.0, 1.0), (B, 1)), np.array([-0.01, 0.02, -0.005, -0.03]))
    want = rigid_body_run(jax_rb, jnp.asarray, jnp.float64, *inputs)
    got = rigid_body_run(rb, t, torch.float64, *inputs)
    for k, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-12, f"output {k}")


def test_actuators_match_jax():
    rng = np.random.default_rng(1)
    q, qd, u = (rng.normal(size=(B, 3)) for _ in range(3))
    gears, limits = np.array([2.0, 0.5, 1.5]), np.array([0.4, 1.0, 0.7])
    pairs = [
        (jax_act.DirectActuator(jnp.asarray(gears), jnp.asarray(limits)), act.DirectActuator(t(gears), t(limits))),
        (jax_act.SeriesElasticActuator(3.0, jnp.asarray(gears), jnp.asarray(limits)), act.SeriesElasticActuator(3.0, t(gears), t(limits))),
        (jax_act.ServoActuator(20.0, 0.5, -3.0, 2.0, jnp.asarray(limits)), act.ServoActuator(20.0, 0.5, -3.0, 2.0, t(limits))),
    ]
    gear_pos = rng.normal(size=(B, 3))
    for j_a, t_a in pairs:
        state = gear_pos if isinstance(t_a, act.SeriesElasticActuator) else ()
        j_tau, _ = j_a.compute_torques(jnp.asarray(state) if len(state) else (), *(jnp.asarray(x) for x in (q, qd, u)))
        t_tau, _ = t_a.compute_torques(t(state) if len(state) else (), t(q), t(qd), t(u))
        close(t_tau, j_tau, 1e-12, type(t_a).__name__)
        if isinstance(t_a, act.SeriesElasticActuator):
            close(t_a.integrate(t(gear_pos), t(q), t(qd), t(u), 1e-2),
                  j_a.integrate(jnp.asarray(gear_pos), *(jnp.asarray(x) for x in (q, qd, u)), 1e-2), 1e-12, "gear positions")
    j_net, t_net = jax_act.ActuatorNetSpec(3, 3), act.ActuatorNetSpec(3, 3)
    params = rng.normal(0.0, 0.3, j_net.network.num_parameters)
    history = rng.normal(size=(B, 3, 6))
    j_tau, j_hist = jax.vmap(lambda h, q, qd, u: j_net.compute_torques(jnp.asarray(params), h, q, qd, u))(
        *(jnp.asarray(x) for x in (history, q, qd, u)))
    t_tau, t_hist = t_net.compute_torques(mlp_params_from_numpy(params, torch.float64, "cpu"), t(history), t(q), t(qd), t(u))
    close(t_hist, j_hist, 1e-12, "history")
    close(t_tau, j_tau, 1e-12, "actuator net")
    assert t_net.init_state(torch.float64, "cpu", (B,)).shape == (B, 3, 6)


@pytest.mark.parametrize("method", [IKMethod.JAC_TRANSPOSE, IKMethod.JAC_PINV, IKMethod.DAMPED_LM], ids=lambda m: m.name)
def test_ik_matches_jax(method):
    j_model, _ = jax_construct("franka_panda/panda.urdf", dtype=jnp.float64)
    t_model, _ = construct("franka_panda/panda.urdf")
    rng = np.random.default_rng(2)
    q0 = np.array((0.0, 0.2, 0.0, -2.0, 0.0, 2.2, 0.79, 0.02, 0.02)) + rng.normal(0.0, 0.05, (B, 9))
    target, point = np.array((0.45, 0.1, 0.3)), np.array((0.0, 0.01, 0.02))
    q_ref = q0[0] + 0.1
    kw = dict(max_iterations=10, alpha=0.1, q_reference_weight=0.05 if method == IKMethod.DAMPED_LM else 0.0)
    j_res = jax.jit(lambda q: jax_ik(j_model, [JaxIKTarget(11, jnp.asarray(target), jnp.asarray(point))], q,
                                     method=JaxIKMethod(int(method)), q_reference=jnp.asarray(q_ref), **kw))(jnp.asarray(q0))
    t_res = inverse_kinematics(t_model, [IKTarget(11, t(target), t(point))], t(q0), method=method, q_reference=t(q_ref), **kw)
    close(t_res.q, j_res.q, 1e-9, "q")
    close(t_res.residual, j_res.residual, 1e-9, "residual")
    np.testing.assert_array_equal(t_res.converged.numpy(), np.asarray(j_res.converged))


# -- the MPC stack -------------------------------------------------------------
def test_gait_and_swing_match_jax():
    rng = np.random.default_rng(3)
    times = rng.uniform(0.0, 2.0, B)
    contacts = rng.uniform(size=(B, 4)) < 0.5
    j_cfg, t_cfg = jax_gait.GaitConfig.laikago_trotting(), gait.GaitConfig.laikago_trotting()
    j_state = jax.vmap(lambda tm, c: jax_gait.gait_update(j_cfg, tm, c))(jnp.asarray(times), jnp.asarray(contacts))
    t_state = gait.gait_update(t_cfg, t(times), torch.from_numpy(contacts))
    for name in ("desired_leg_state", "leg_state"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)), err_msg=name)
    close(t_state.normalized_phase, j_state.normalized_phase, 1e-10, "phase")
    close(gait.swing_duration(t_cfg, t(times)), jax_gait.swing_duration(j_cfg), 1e-12, "swing duration")
    # the velocity window, 6 samples through a window of 4
    j_f = jax.vmap(lambda _: jax_gait.VelocityFilterState.create(4, jnp.float64))(jnp.arange(B))
    t_f = gait.VelocityFilterState.create(4, torch.float64, "cpu", (B,))
    for k in range(6):
        v = rng.normal(size=(B, 3))
        j_f, j_avg = jax.vmap(lambda f, v: f.update(v))(j_f, jnp.asarray(v))
        t_f, t_avg = t_f.update(t(v))
        close(t_avg, j_avg, 1e-12, f"average {k}")
    # swing: the warp, the parabola, the trajectory, Raibert targets and the latch
    phase = rng.uniform(size=(B, 4))
    start, end = rng.normal(size=(B, 4, 3)), rng.normal(size=(B, 4, 3))
    close(swing_leg.swing_phase_warp(t(phase)), jax_swing.swing_phase_warp(jnp.asarray(phase)), 1e-12)
    close(swing_leg.swing_foot_trajectory(t(phase), t(start), t(end)),
          jax.vmap(jax_swing.swing_foot_trajectory)(*(jnp.asarray(x) for x in (phase, start, end))), 1e-12)
    hips, vel, yaw_rate = rng.normal(size=(4, 3)), rng.normal(size=(B, 3)), rng.normal(size=B)
    j_targets = jax.vmap(lambda v, w: jax_swing.raibert_foot_targets(v, w, jnp.asarray(hips), j_cfg.stance_duration,
                                                                      jnp.asarray([0.4, 0.1, 0.0]), 0.3, 0.41))(
        jnp.asarray(vel), jnp.asarray(yaw_rate))
    t_targets = swing_leg.raibert_foot_targets(t(vel), t(yaw_rate), t(hips), constant_like(t_cfg.stance_duration, t(vel)),
                                               t([0.4, 0.1, 0.0]), 0.3, 0.41)
    close(t_targets, j_targets, 1e-10, "Raibert targets")
    last = rng.integers(0, 2, (B, 4))
    j_latch = jax.vmap(jax_swing.swing_leg_update)(jax_swing.SwingLegState(jnp.asarray(last), jnp.asarray(start)),
                                                   j_state.desired_leg_state, jnp.asarray(end))
    t_latch = swing_leg.swing_leg_update(swing_leg.SwingLegState(torch.from_numpy(last), t(start)), t_state.desired_leg_state, t(end))
    close(t_latch.phase_switch_foot_position, j_latch.phase_switch_foot_position, 0.0, "latched positions")


def mpc_inputs(seed):
    """A COM state, stance flags and feet of 4 envs, and the walk's MPC
    config (examples/laikago_mpc_walk.py's)."""
    rng = np.random.default_rng(seed)
    com = [rng.normal(0.0, s, (B, 3)) for s in (0.05, 0.2, 0.1, 0.3)]  # rpy, position, angular and linear velocity
    com[1][:, 2] += 0.42
    contact = (rng.uniform(size=(B, 4)) < 0.7).astype(np.float64)
    contact[0] = 0.0  # no stance leg
    feet = np.array([[0.2, 0.15, -0.4], [0.2, -0.15, -0.4], [-0.2, 0.15, -0.4], [-0.2, -0.15, -0.4]]) + rng.normal(0.0, 0.03, (B, 4, 3))
    return com, contact, feet


def mpc_configs():
    kw = dict(mass=13.7, planning_horizon=10, timestep=0.025, solver_iterations=300, alpha=1e-6)
    inertia = np.diag([0.07, 0.25, 0.25])
    weights = (5, 5, 0.2, 0, 0, 10, 0, 0, 1, 1, 1, 0, 0)
    return (jax_mpc.MpcConfig(inertia=jnp.asarray(inertia), qp_weights=jnp.asarray(weights, jnp.float64), **kw),
            mpc.MpcConfig(inertia=tuple(map(tuple, inertia)), qp_weights=weights, **kw))


def test_mpc_matrices_and_forces_match_jax():
    j_cfg, t_cfg = mpc_configs()
    (rpy, pos, ang, vel), contact, feet = mpc_inputs(4)
    inv_inertia = np.linalg.inv(np.diag([0.07, 0.25, 0.25]))[None].repeat(B, 0)
    j_a = jax.vmap(lambda r: jax_mpc.calculate_a_mat(r, jnp.float64))(jnp.asarray(rpy))
    j_b = jax.vmap(lambda i, f: jax_mpc.calculate_b_mat(1.0 / 13.7, i, f))(jnp.asarray(inv_inertia), jnp.asarray(feet))
    t_a, t_b = mpc.calculate_a_mat(t(rpy)), mpc.calculate_b_mat(1.0 / 13.7, t(inv_inertia), t(feet))
    close(t_a, j_a, 1e-12, "A")
    close(t_b, j_b, 1e-12, "B")
    j_ad, j_bd = jax.vmap(lambda a, b: jax_mpc.discretize(a, b, 0.025))(j_a, j_b)
    t_ad, t_bd = mpc.discretize(t_a, t_b, 0.025)
    close(t_ad, j_ad, 1e-10, "A_d")
    close(t_bd, j_bd, 1e-10, "B_d")
    j_aqp, j_bqp = jax.vmap(lambda a, b: jax_mpc.condensed_qp_mats(a, b, 10))(j_ad, j_bd)
    t_aqp, t_bqp = mpc.condensed_qp_mats(t_ad, t_bd, 10)
    close(t_aqp, j_aqp, 1e-10, "A_qp")
    close(t_bqp, j_bqp, 1e-10, "B_qp")
    desired = [jnp.asarray(x) for x in ((0.0, 0.0, 0.42), (0.4, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.1))]
    j_f = jax.jit(jax.vmap(lambda p, v, r, w, c, f: jax_mpc.compute_contact_forces(j_cfg, p, v, r, w, c, f, *desired)))(
        *(jnp.asarray(x) for x in (pos, vel, rpy, ang, contact, feet)))
    t_f = mpc.compute_contact_forces(t_cfg, t(pos), t(vel), t(rpy), t(ang), t(contact), t(feet),
                                     *(t(np.asarray(d)) for d in desired))
    close(t_f, j_f, 1e-10, "stance forces")
    assert np.abs(t_f.numpy()[0]).max() == 0.0 and np.abs(t_f.numpy()[1:]).max() > 1.0


@pytest.fixture(scope="module")
def walkers():
    j_env, j_ctrl = jax_build(dtype=jnp.float64)
    t_env, t_ctrl = build(dtype=torch.float64, device="cpu")
    return (j_env, j_ctrl, jax_make_walk_step(j_env, j_ctrl, 5)), (t_env, t_ctrl, make_walk_step(t_env, t_ctrl, 5))


def walk_start(t_env, t_ctrl, seed):
    """Poses with the toes near the ground, and a controller state in the
    middle of a gait (a clock, a latch, a half-full velocity window) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    q, qd = t_env.initial_state(noise=t(rng.uniform(-0.05, 0.05, (B, 12))))
    q[:, 2] = 0.415 + t(rng.uniform(-0.01, 0.01, B))
    qd = qd + t(rng.normal(0.0, 0.1, qd.shape))
    feet = t_ctrl.init_state(q).swing.phase_switch_foot_position.numpy()
    state = (rng.uniform(0.0, 1.5, B), rng.integers(0, 2, (B, 4)), feet + rng.normal(0.0, 0.01, feet.shape),
             rng.normal(0.0, 0.2, (B, 4, 3)), rng.integers(0, 5, B))
    return q.numpy(), qd.numpy(), state


def jax_state(time, last, latched, buffer, count):
    return JaxMpcState(time=jnp.asarray(time), swing=jax_swing.SwingLegState(jnp.asarray(last), jnp.asarray(latched)),
                       vel_filter=jax_gait.VelocityFilterState(jnp.asarray(buffer), jnp.asarray(count, jnp.int32)))


def test_controller_update_and_walk_ticks_match_jax(walkers):
    (j_env, j_ctrl, j_step), (t_env, t_ctrl, t_step) = walkers
    q, qd, state = walk_start(t_env, t_ctrl, 5)
    j_s = jax_state(*state)
    t_s = mpc_state_from_numpy(*state, device="cpu")
    j_new, j_tau = jax.jit(jax.vmap(j_ctrl.update))(j_s, jnp.asarray(q), jnp.asarray(qd))
    t_new, t_tau = t_ctrl.update(t_s, t(q), t(qd))
    assert np.abs(np.asarray(j_tau)).max() > 1.0
    close(t_tau, j_tau, 1e-9, "tau")
    for got, want in zip(t_new.flat(), jax.tree_util.tree_leaves(j_new)):
        close(got, want, 1e-9, "controller state")
    j_carry, t_carry = (j_s, jnp.asarray(q), jnp.asarray(qd)), (t_s, t(q), t(qd))
    j_tick = jax.vmap(j_step)
    for k in range(2):
        j_carry, t_carry = j_tick(j_carry), t_step(t_carry)
        close(t_carry[1], j_carry[1], 1e-9, f"q after tick {k + 1}")
        close(t_carry[2], j_carry[2], 1e-9, f"qd after tick {k + 1}")
        for got, want in zip(t_carry[0].flat(), jax.tree_util.tree_leaves(j_carry[0])):
            close(got, want, 1e-9, f"controller state after tick {k + 1}")
    assert t_ctrl.config.control_dt == 5 * t_env.dt
