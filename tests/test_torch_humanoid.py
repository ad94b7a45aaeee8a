"""The port's humanoid (spherical base joint, ``humanoid_xyz_spherical.urdf``)
against the JAX package's, float64 on the CPU:

- the model and its 19 geoms; every link's motion subspace;
- the spherical slice, at 1e-12 relative: FK, ``aba_factor`` and
  ``forward_dynamics``, ``minv_mul``, ``integrate_q``, the point Jacobian
  and ``pd_tau`` (the spherical joint PD-driven too), from numpy-seeded
  states with the base quaternion away from the identity and at it (where
  ``to_axis_angle`` takes its 2/qw limit);
- the quaternion helpers and the 6x3 algebra the slice adds;
- tests/golden/humanoid_spherical_dynamics.json and the ABA half of
  humanoid_spherical_random_sweep.json at test_golden_reference.py's 1e-9
  (the port reads the JSON and the bundled URDF, so these run where the
  JAX package's own golden tests skip);
- ``initial_state`` from the JAX package's reset draws, then 50 env steps
  at batch 2 from numpy-made states with the feet in the ground, at 1e-8,
  with contacts active on every step;
- ``reward_done`` with each shaping knob on;
- logs/humanoid_ars/policy_curr2.pkl carried across by ``convert.py``.

One JAX compile (the batched env step) serves the file, through a
module-scoped fixture; the other JAX calls run eagerly.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_ant import TOL, check_model_matches_jax, reset_noise, step_tol  # noqa: E402
from tds_tpu.algebra import quaternion as j_quat  # noqa: E402
from tds_tpu.algebra.inertia import ArticulatedBodyInertia as JAbi  # noqa: E402
from tds_tpu.algebra.linalg import inv3 as j_inv3  # noqa: E402
from tds_tpu.algebra.transform import Transform as JTransform  # noqa: E402
from tds_tpu.control.pd import pd_tau as j_pd_tau  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import aba_factor as j_aba_factor  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import forward_dynamics_from_kin as j_forward_dynamics_from_kin  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import minv_mul as j_minv_mul  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_q as j_integrate_q  # noqa: E402
from tds_tpu.dynamics.jacobian import point_jacobian_kin as j_point_jacobian_kin  # noqa: E402
from tds_tpu.dynamics.kinematics import fk_links as j_fk_links  # noqa: E402
from tds_tpu.dynamics.kinematics import forward_kinematics_q as j_forward_kinematics_q  # noqa: E402
from tds_tpu.envs.base import EnvState as JEnvState  # noqa: E402
from tds_tpu.envs.humanoid import HumanoidEnv as JaxHumanoid  # noqa: E402
from tds_tpu.learn.nn import linear_policy as j_linear_policy  # noqa: E402
from tds_tpu.learn.running_stat import RunningStat as JRunningStat  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch import world as t_world  # noqa: E402
from tds_tpu_torch.algebra import quaternion as t_quat  # noqa: E402
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia  # noqa: E402
from tds_tpu_torch.algebra.linalg import inv3  # noqa: E402
from tds_tpu_torch.algebra.transform import Transform  # noqa: E402
from tds_tpu_torch.control.pd import pd_tau  # noqa: E402
from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics, minv_mul  # noqa: E402
from tds_tpu_torch.dynamics.integrator import integrate_q  # noqa: E402
from tds_tpu_torch.dynamics.jacobian import point_jacobian_kin  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links  # noqa: E402
from tds_tpu_torch.envs.base import EnvState  # noqa: E402
from tds_tpu_torch.envs.humanoid import HumanoidEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Capsule, Sphere  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402


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


@pytest.fixture
def optimized_jax():
    """The JAX package's default compiles for one test, whose JAX draws are
    held bit for bit to recorded ones (this file's reference otherwise
    compiles without XLA's optimisation passes, which moves a float32 draw
    by an ulp)."""
    jax.config.update("jax_disable_most_optimizations", False)
    jax.clear_caches()  # jit's caches ignore the flag: compile the draws anew
    yield
    jax.config.update("jax_disable_most_optimizations", True)

URDF = "humanoid_xyz_spherical.urdf"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "logs", "humanoid_ars", "policy_curr2.pkl")
REL = 1e-12  # the slice's functions: relative, with an absolute floor of REL
GRAVITY = (0.0, 0.0, -9.81)
FOOT = 36  # the last link: the left foot, at the end of a chain through the base


def close(got, want, tol=REL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def models():
    j_model, j_geoms = j_construct(URDF, dtype=jnp.float64)
    t_model, t_geoms = construct(URDF)
    return j_model, j_geoms, t_model, t_geoms


@pytest.fixture(scope="module")
def envs():
    """(JAX env, its jitted batched step, port env): the file's one JAX
    compile is the step's, made at the first test that steps."""
    j_env = JaxHumanoid(dtype=jnp.float64)
    return j_env, jax.jit(jax.vmap(j_env.step)), HumanoidEnv(dtype=torch.float64, device="cpu")


def states(model, batch=3, seed=0, tau=True):
    """numpy (q, qd, tau): the base 1.2-1.4 m up, the base quaternion random
    in all envs but the last, which keeps the identity; joint angles in
    +-0.6 rad; rates and torques normal."""
    rng = np.random.default_rng(seed)
    q = np.zeros((batch, model.dof_q))
    q[:, 0:3] = rng.uniform(-0.2, 0.2, (batch, 3)) + (0.0, 0.0, 1.3)
    quat = rng.normal(size=(batch, 4))
    quat[-1] = (0.0, 0.0, 0.0, 1.0)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = rng.uniform(-0.6, 0.6, (batch, model.dof_q - 7))
    qd = rng.normal(0.0, 0.8, (batch, model.dof_qd))
    return q, qd, rng.normal(0.0, 5.0, (batch, model.dof_actuated))


def both(*arrays):
    """(JAX arrays, torch tensors) of numpy arrays."""
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


# -- model and algebra -------------------------------------------------------
def test_model_and_geoms_match_jax(models):
    check_model_matches_jax(models)
    j_model, _, t_model, t_geoms = models
    assert (t_model.dof_q, t_model.dof_qd, t_model.num_links, t_model.dof_actuated) == (28, 27, 37, 27)
    assert t_model.joint_types[:4] == (0, 1, 2, 8)
    assert sorted({type(g.shape) for g in t_geoms}, key=str) == sorted({Capsule, Sphere}, key=str) and len(t_geoms) == 19
    for i in range(t_model.num_links):
        np.testing.assert_array_equal(t_model.subspace(i).numpy(), np.asarray(j_model.motion_subspace(i)), err_msg=f"S of link {i}")
    zero = t_model.zero_q((2,))
    np.testing.assert_array_equal(zero[0].numpy(), np.asarray(j_model.zero_q()))


def test_spherical_algebra_matches_jax():
    """The quaternion helpers and the 6x3 algebra of the slice, on random
    batched inputs; to_axis_angle at the identity and 1e-14 from it too."""
    rng = np.random.default_rng(3)
    quat = rng.normal(size=(6, 4))
    quat[4] = (0.0, 0.0, 0.0, 1.0)
    quat[5] = (1e-14, 0.0, 0.0, 1.0)
    other, omega = rng.normal(size=(6, 4)), rng.normal(size=(6, 3))
    m3, s63, t63 = rng.normal(size=(6, 3, 3)), rng.normal(size=(6, 6, 3)), rng.normal(size=(6, 6, 3))
    abi = [rng.normal(size=(6, 3, 3)) for _ in range(3)]
    pos, rot = rng.normal(size=(6, 3)), np.asarray(j_quat.to_matrix(jnp.asarray(other)))
    (jq, jo, jw, jm, js, jt, jp, jr, *jabi), (tq, to, tw, tm, ts, tt, tp, tr, *tabi) = both(quat, other, omega, m3, s63, t63, pos, rot, *abi)
    pairs = {
        "mul": (t_quat.mul(tq, to), j_quat.mul(jq, jo)),
        "conjugate": (t_quat.conjugate(tq), j_quat.conjugate(jq)),
        "normalize": (t_quat.normalize(tq), j_quat.normalize(jq)),
        "to_axis_angle": (t_quat.to_axis_angle(tq), j_quat.to_axis_angle(jq)),
        "velocity_local": (t_quat.velocity_local(tq, tw, 1e-3), j_quat.velocity_local(jq, jw, 1e-3)),
        "integrate_local": (t_quat.integrate_local(tq, tw, 1e-3), j_quat.integrate_local(jq, jw, 1e-3)),
        "identity": (t_quat.identity(), j_quat.identity()),
        "inv3": (inv3(tm), j_inv3(jm)),
        "mul_matrix63": (ArticulatedBodyInertia(*tabi).mul_matrix63(ts), JAbi(*jabi).mul_matrix63(js)),
        "motion_matrix_to_parent": (Transform(tp, tr).motion_matrix_to_parent(ts), JTransform(jp, jr).motion_matrix_to_parent(js)),
    }
    for name, (got, want) in pairs.items():
        close(got.numpy(), want, what=name)
    for got, want in zip(ArticulatedBodyInertia.outer_63(ts, tt), JAbi.outer_63(js, jt)):
        close(got.numpy(), want, what="outer_63")
    # the identity's rotation vector is exactly zero through the 2/qw branch
    assert t_quat.to_axis_angle(tq[4:5]).abs().max() == 0.0


# -- dynamics on the humanoid ------------------------------------------------
@pytest.fixture(scope="module")
def kin_state(models):
    """One numpy-seeded state (q, qd, tau) with the JAX package's FK and
    articulated factor on it, computed once (eagerly) for the file."""
    j_model, _, t_model, _ = models
    q, qd, tau = states(t_model, seed=1)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    j_kin = j_fk_links(j_model, jq, jqd)
    return q, qd, tau, j_kin, j_aba_factor(j_model, j_kin)


def test_fk_matches_jax(models, kin_state):
    _, _, t_model, _ = models
    q, qd, _, want, _ = kin_state
    got = fk_links(t_model, torch.from_numpy(q), torch.from_numpy(qd))
    for i in range(t_model.num_links):
        for field in ("v", "c", "pA"):
            close(getattr(got, field)[i].numpy(), getattr(want, field)[i], what=f"{field} of link {i}")
        for frame in ("x_world", "x_parent"):
            close(getattr(got, frame)[i].pos.numpy(), getattr(want, frame)[i].pos, what=f"{frame}.pos of link {i}")
            close(getattr(got, frame)[i].rot.numpy(), getattr(want, frame)[i].rot, what=f"{frame}.rot of link {i}")


def test_aba_factor_and_forward_dynamics_match_jax(models, kin_state):
    j_model, _, t_model, _ = models
    q, qd, tau, j_kin, want = kin_state
    (jq, jqd, jtau), (tq, tqd, ttau) = both(q, qd, tau)
    got = aba_factor(t_model, fk_links(t_model, tq, tqd))
    for i in range(t_model.num_links):
        close(got.u[i].numpy(), want.u[i], what=f"U of link {i}")
        close(got.d_inv[i].numpy(), want.d_inv[i], what=f"D^-1 of link {i}")
        for g, w in zip(got.ia[i], want.ia[i]):
            close(g.numpy(), w, what=f"I^a of link {i}")
    assert got.u[3].shape == (3, 6, 3) and got.d_inv[3].shape == (3, 3, 3)
    qdd = forward_dynamics(t_model, tq, tqd, ttau, torch.tensor(GRAVITY, dtype=torch.float64))
    want_qdd = j_forward_dynamics_from_kin(j_model, j_kin, jq, jqd, jtau, jnp.asarray(GRAVITY), factor=want)
    close(qdd.numpy(), want_qdd, what="qdd")


def test_minv_mul_matches_jax(models, kin_state):
    """M^-1 of 4 right-hand sides at once, through the spherical joint."""
    j_model, _, t_model, _ = models
    q, qd, _, j_kin, j_factor = kin_state
    x = np.random.default_rng(12).normal(size=(4, 3, t_model.dof_qd))
    t_kin = fk_links(t_model, torch.from_numpy(q), torch.from_numpy(qd))
    got = minv_mul(t_model, t_kin, aba_factor(t_model, t_kin), torch.from_numpy(x))
    close(got.numpy(), j_minv_mul(j_model, j_kin, j_factor, jnp.asarray(x)), what="M^-1 x")


def test_integrate_q_matches_jax(models):
    j_model, _, t_model, _ = models
    q, qd, _ = states(t_model, seed=4)
    (jq, jqd), (tq, tqd) = both(q, qd)
    got_q, got_qd = integrate_q(t_model, tq, tqd, 1e-3)
    want_q, want_qd = j_integrate_q(j_model, jq, jqd, 1e-3)
    close(got_q.numpy(), want_q, what="q")
    close(got_qd.numpy(), want_qd, what="qd")
    # the spherical rates decay by joint_damping = 0.995 once a ms step
    np.testing.assert_allclose(got_qd[:, 3:6].numpy(), 0.995 * qd[:, 3:6], rtol=1e-15)
    np.testing.assert_allclose(np.linalg.norm(got_q[:, 3:7].numpy(), axis=-1), 1.0, rtol=1e-15)


@pytest.mark.parametrize("local", [False, True], ids=["world", "base"])
def test_point_jacobian_matches_jax(models, local):
    """The foot's Jacobian, whose path to the root runs through the 3
    columns of the spherical joint."""
    j_model, _, t_model, _ = models
    q, qd, _ = states(t_model, seed=5)
    point = np.random.default_rng(6).normal(size=(3, 3))
    (jq, jqd, jp), (tq, tqd, tp) = both(q, qd, point)
    t_kin = fk_links(t_model, tq, tqd)
    j_base, j_xw, j_xb = j_forward_kinematics_q(j_model, jq)
    if local:
        t_xb = [t_kin.x_parent[0]]
        for i in range(1, t_model.num_links):
            parent = t_model.parents[i]
            t_xb.append(t_kin.x_parent[i] if parent < 0 else t_xb[parent].compose(t_kin.x_parent[i]))
    else:
        t_xb = None
    got = point_jacobian_kin(t_model, t_kin.base_x_world, t_kin.x_world, t_xb, FOOT, tp, is_local_point=local)
    want = j_point_jacobian_kin(j_model, j_base, j_xw, j_xb, FOOT, jp, is_local_point=local, batch=(3,), dtype=jnp.float64)
    assert np.abs(np.asarray(want)[..., 3:6]).max() > 0.1, "the spherical columns should not vanish"
    close(got.numpy(), want, what="J")


@pytest.mark.parametrize("skip_links", [0, 4], ids=["spherical-driven", "env"])
def test_pd_tau_matches_jax(models, skip_links):
    """With skip_links = 0 the spherical joint is PD-driven toward the
    identity (and takes no target); 4 is the env's."""
    j_model, _, t_model, _ = models
    q, qd, _ = states(t_model, seed=7)
    n_pd = sum(1 for i, jt in enumerate(t_model.joint_types) if i >= skip_links and jt not in (-1, 8))
    targets = np.random.default_rng(8).uniform(-0.4, 0.4, (3, n_pd))
    (jq, jqd, jt), (tq, tqd, tt) = both(q, qd, targets)
    got = pd_tau(t_model, tq, tqd, tt, 50.0, 1.5, 50.0, skip_links=skip_links)
    want = j_pd_tau(j_model, jq, jqd, jt, 50.0, 1.5, 50.0, skip_links=skip_links)
    close(got.numpy(), want, what="tau")
    assert (np.abs(got[:, 3:6].numpy()) > 0).all() == (skip_links == 0)


@pytest.mark.parametrize("golden", ["humanoid_spherical_dynamics.json", "humanoid_spherical_random_sweep.json"])
def test_forward_dynamics_matches_golden(models, golden):
    """qdd at tests/test_golden_reference.py's 1e-9 (the sweep's mass
    matrices wait for the port's mass_matrix, ROADMAP Queue 1 item 10)."""
    _, _, t_model, _ = models
    with open(os.path.join(GOLDEN, golden)) as f:
        data = json.load(f)
    assert (t_model.dof_q, t_model.dof_qd) == (data["dof"], data["dof_qd"])
    cases = data["cases"]
    q, qd, tau = (torch.tensor([c[k] for c in cases], dtype=torch.float64) for k in ("q", "qd", "tau"))
    qdd = forward_dynamics(t_model, q, qd, tau, torch.tensor(GRAVITY, dtype=torch.float64))
    np.testing.assert_allclose(qdd.numpy(), np.array([c["qdd"] for c in cases]), rtol=1e-9, atol=1e-9)


# -- the env -----------------------------------------------------------------
def test_env_defaults(envs):
    _, _, env = envs
    assert (env.kp, env.kd, env.max_force, env.dt, env.skip_links) == (50.0, 1.5, 50.0, 1e-3, 4)
    assert (env.action_dim, env.observation_dim) == (21, 55)
    assert env.pd_q_indices()[:2] == (7, 8) and env.world.solver.top_k == 0
    assert env.start_base_position == (0.0, 0.0, 1.4)
    with pytest.raises(NotImplementedError):
        HumanoidEnv(dtype=torch.float64, device="cpu", fused_step=True)


def test_initial_state_matches_jax(envs):
    """The standing start from the JAX package's reset draws: the base's
    identity quaternion untouched, the joint noise in the 1-DoF slots."""
    j_env, _, t_env = envs
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    t_q, t_qd = t_env.initial_state(noise=reset_noise(j_env, keys))

    def start(key):
        return j_env.initial_state(jax.random.split(key)[1])

    j_q, j_qd = jax.vmap(start)(keys)
    close(t_q.numpy(), j_q, tol=TOL, what="q")
    close(t_qd.numpy(), j_qd, tol=TOL, what="qd")
    np.testing.assert_array_equal(t_q[:, 3:7].numpy(), np.tile([0.0, 0.0, 0.0, 1.0], (3, 1)))


def penetrating(env, q):
    """(B,) count of the plane candidates with distance < 0."""
    zero = q.new_zeros(q.shape[0], 0)
    kins = [fk_links(env.world.bodies[0], zero, zero), fk_links(env.model, q, torch.zeros(q.shape[0], env.model.dof_qd, dtype=q.dtype))]
    return (t_world.gather_pair_contacts(env.world, kins, 0, 1, q).contact.distance < 0).sum(-1)


def test_env_matches_jax_for_50_steps(envs):
    """50 steps at batch 2 from numpy-made states: the base 8.5 and 10 cm
    below the standing start (the feet rest 7.45 cm above the ground there),
    one base quaternion tilted, joint noise and small rates; seeded actions
    past the action limit. q, qd, observation and reward at 1e-8, done
    exactly; the feet bounce off the ground, and each env solves contacts
    on its first 10 steps at least."""
    j_env, j_step, t_env = envs
    rng = np.random.default_rng(21)
    q0, qd0 = t_env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (2, t_env.action_dim))))
    q0[:, 2] = torch.tensor([1.315, 1.3])
    tilt = np.array([0.03, -0.02, 0.01, 1.0])
    q0[1, 3:7] = torch.from_numpy(tilt / np.linalg.norm(tilt))
    qd0 = torch.from_numpy(rng.normal(0.0, 0.1, (2, t_env.model.dof_qd)))
    t_state = EnvState(q=q0, qd=qd0, t=torch.zeros(2, dtype=torch.int32))
    j_state = JEnvState(q=jnp.asarray(q0.numpy()), qd=jnp.asarray(qd0.numpy()), t=jnp.zeros(2, jnp.int32),
                        key=jax.random.split(jax.random.PRNGKey(0), 2))
    in_contact = []
    for t in range(1, 51):
        action = rng.uniform(-0.5, 0.5, size=(2, t_env.action_dim))
        in_contact.append(penetrating(t_env, t_state.q))
        j_state, j_obs, j_reward, j_done = j_step(j_state, jnp.asarray(action))
        t_state, t_obs, t_reward, t_done = t_env.step(t_state, torch.from_numpy(action))
        tol = step_tol(t)
        for name, got, want in (("q", t_state.q, j_state.q), ("qd", t_state.qd, j_state.qd), ("obs", t_obs, j_obs), ("reward", t_reward, j_reward)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"{name} at step {t}")
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"done at step {t}")
    counts = torch.stack(in_contact)
    assert bool((counts[:10] > 0).all()), f"penetrating candidates per step: {counts.tolist()}"


@pytest.mark.parametrize(
    "knob", [{}, {"height_bonus": 0.7}, {"crouch_penalty": 2.0}, {"crouch_penalty": 2.0, "crouch_ref": 1.35},
             {"z_damping": 0.3}, {"alive_bonus": 1.5}],
    ids=["reference", "height_bonus", "crouch_penalty", "crouch_ref", "z_damping", "alive_bonus"],
)
def test_reward_done(models, knob):
    """Four states: alive, too low (z < 0.8), tipped over (up.z < 0.6) and
    alive below crouch_ref, with each shaping knob on alone."""
    _, _, t_model, _ = models
    j_env = JaxHumanoid(dtype=jnp.float64, **knob)
    t_env = HumanoidEnv(dtype=torch.float64, device="cpu", **knob)
    q, qd, _ = states(t_model, batch=4, seed=9)
    q_prev = q.copy()
    q[:, 2] = (1.3, 0.7, 1.3, 1.0)
    tipped = np.array([np.sin(0.7), 0.0, 0.0, np.cos(0.7)])  # 80 degrees about x
    q[:, 3:7] = ((0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.0, 1.0), tipped, (0.0, 0.0, 0.0, 1.0))
    j_reward, j_done = j_env.reward_done(*(jnp.asarray(x) for x in (q_prev, qd, q, qd)))
    t_reward, t_done = t_env.reward_done(*(torch.from_numpy(x) for x in (q_prev, qd, q, qd)))
    assert t_done.tolist() == [False, True, True, False]
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=TOL, atol=TOL)
    if knob:
        plain = HumanoidEnv(dtype=torch.float64, device="cpu").reward_done(*(torch.from_numpy(x) for x in (q_prev, qd, q, qd)))[0]
        assert not torch.equal(t_reward, plain), "the knob should change the reward of a live env"


def test_trained_policy_carried_across():
    """policy_curr2.pkl through convert.policy_from_numpy: the port's
    normalised linear policy gives the JAX package's actions."""
    saved, _ = load_checkpoint(CKPT)
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=torch.float64, device="cpu")
    assert (policy.in_features, policy.out_features) == (55, 21)
    j_stat = saved["obs_stat"] if isinstance(saved["obs_stat"], JRunningStat) else JRunningStat(*saved["obs_stat"])
    j_stat = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), j_stat)
    obs = np.random.default_rng(13).normal(0.0, 1.0, (5, 55))
    want = j_linear_policy(55, 21).apply(jnp.asarray(saved["params"], jnp.float64), j_stat.normalize(jnp.asarray(obs)))
    with torch.no_grad():
        got = policy(stat.normalize(torch.from_numpy(obs)))
    close(got.numpy(), want, tol=TOL, what="actions")


def test_policy_replay_starts_are_the_jax_tests(envs, optimized_jax):
    """chip_smoke.py replays policy_curr2.pkl on the card from
    tests/golden/humanoid_policy_reset_noise.json: the joint noise that the
    JAX env's reset draws for tests/test_humanoid_policy.py's seeds."""
    with open(os.path.join(GOLDEN, "humanoid_policy_reset_noise.json")) as f:
        recorded = json.load(f)
    assert recorded["seeds"] == [0, 7, 123, 42]
    slots = list(envs[2].pd_q_indices())  # the initial poses are 0: q there is the noise
    j_env = JaxHumanoid(dtype=jnp.float32)
    for seed, noise in zip(recorded["seeds"], recorded["noise"]):
        q, _ = j_env.initial_state(jax.random.split(jax.random.PRNGKey(seed))[1])
        np.testing.assert_array_equal(np.asarray(q)[slots], np.float32(noise))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert HumanoidEnv().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HumanoidEnv()
