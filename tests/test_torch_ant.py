"""The port's ant against the JAX package's and the C++ goldens, float64 on
the CPU unless a test says otherwise.

- ``construct("gym/ant_org_xyz_xyzrot.urdf")``: every array leaf, static
  field and geom (the capsules among them) as the JAX package's;
- ``plane_capsule`` on random batched transforms and capsules at 1e-12;
- ``resolve_collision`` with ``top_k=8`` at 1e-10 in qd and p: on the state
  whose distances tie in groups of 4 (the kept indices must be the JAX
  package's), on lowered noisy states where more than 8 of the 17
  candidates penetrate, and on states where 8 or fewer do;
- tests/golden/ant_pd_contact_trajectory.json, 500 zero-action steps at the
  tolerances of tests/test_golden_reference.py;
- reset, step, reward_done and observation against the JAX ``AntEnv`` over
  200 steps from the same reset noise, 1e-8 up to step 100, 1e-6 after;
- ``forward_dynamics`` against the qdd of tests/golden/ant_dynamics.json
  and ant_random_sweep.json;
- logs/ant_ars/policy.pkl replayed in float32 at the thresholds of
  tests/test_ant_policy.py;
- ``python -m tds_tpu_torch.tools.ars_train --env ant`` for 2 tiny
  iterations on the CPU.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_model_urdf import LEAVES, STATIC  # noqa: E402
from tds_tpu import world as j_world  # noqa: E402
from tds_tpu.algebra.transform import Transform as JTransform  # noqa: E402
from tds_tpu.collision import narrowphase as j_narrowphase  # noqa: E402
from tds_tpu.contact.mlcp import resolve_collision as j_resolve_collision  # noqa: E402
from tds_tpu.dynamics.kinematics import fk_links as j_fk_links  # noqa: E402
from tds_tpu.envs.ant import AntEnv as JaxAnt  # noqa: E402
from tds_tpu.model import geometry as j_geometry  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch import world as t_world  # noqa: E402
from tds_tpu_torch.algebra.rotation import from_rpy  # noqa: E402
from tds_tpu_torch.algebra.transform import Transform  # noqa: E402
from tds_tpu_torch.collision import narrowphase  # noqa: E402
from tds_tpu_torch.contact import mlcp  # noqa: E402
from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links  # noqa: E402
from tds_tpu_torch.envs.ant import AntEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Capsule, Plane, Sphere  # noqa: E402
from tds_tpu_torch.tools import ars_train  # noqa: E402
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

URDF = "gym/ant_org_xyz_xyzrot.urdf"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "logs", "ant_ars", "policy.pkl")
TOL = 1e-10


def step_tol(t):
    """tests/test_golden_reference.py's tolerance of a contact trajectory."""
    return 1e-8 if t <= 100 else 1e-6


@pytest.fixture(scope="module")
def envs():
    return JaxAnt(dtype=jnp.float64), AntEnv(dtype=torch.float64, device="cpu")


# -- model and URDF ---------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    j_model, j_geoms = j_construct(URDF, dtype=jnp.float64)
    t_model, t_geoms = construct(URDF)
    return j_model, j_geoms, t_model, t_geoms


def check_model_matches_jax(models):
    """Every array leaf at 1e-15, every static field and every geom
    exactly."""
    j_model, j_geoms, t_model, t_geoms = models
    for leaf in LEAVES:
        np.testing.assert_allclose(
            getattr(t_model, leaf).numpy(), np.asarray(getattr(j_model, leaf)), rtol=1e-15, atol=1e-15, err_msg=leaf
        )
    for field in STATIC:
        assert getattr(t_model, field) == getattr(j_model, field), field
    assert len(t_geoms) == len(j_geoms)
    for t, j in zip(t_geoms, j_geoms):
        assert type(t.shape).__name__ == type(j.shape).__name__
        assert dataclasses.asdict(t.shape) == dataclasses.asdict(j.shape)
        for field in ("link_index", "pos", "rpy", "friction", "restitution"):
            assert getattr(t, field) == getattr(j, field), field


def test_model_and_geoms_match_jax(models):
    check_model_matches_jax(models)
    _, _, t_model, t_geoms = models
    assert (t_model.dof_q, t_model.num_links) == (14, 14)
    assert [type(g.shape) for g in t_geoms] == [Sphere] + [Capsule] * 8


# -- narrowphase -------------------------------------------------------------
def test_plane_capsule_matches_jax():
    rng = np.random.default_rng(7)
    batch = 64
    pos = rng.normal(size=(batch, 3))
    rpy = rng.uniform(-np.pi, np.pi, size=(batch, 3))
    rot = from_rpy(*(torch.from_numpy(rpy[:, i]) for i in range(3)))
    xb = Transform(pos=torch.from_numpy(pos), rot=rot)
    jxb = JTransform(pos=jnp.asarray(pos), rot=jnp.asarray(rot.numpy()))
    plane = Plane((0.0, 0.0, 1.0), 0.1)
    j_plane = j_geometry.Plane((0.0, 0.0, 1.0), 0.1)
    identity = Transform(pos=torch.zeros(3, dtype=torch.float64), rot=torch.eye(3, dtype=torch.float64))
    j_identity = JTransform(pos=jnp.zeros(3), rot=jnp.eye(3))
    for radius, length in rng.uniform(0.02, 0.6, size=(4, 2)):
        capsule, j_capsule = Capsule(radius, length), j_geometry.Capsule(radius, length)
        for order in ("plane-capsule", "capsule-plane"):
            if order == "plane-capsule":
                got = narrowphase.compute_contacts(plane, identity, capsule, xb)
                want = j_narrowphase.compute_contacts(j_plane, j_identity, j_capsule, jxb)
            else:
                got = narrowphase.compute_contacts(capsule, xb, plane, identity)
                want = j_narrowphase.compute_contacts(j_capsule, jxb, j_plane, j_identity)
            assert got.count == 2
            for field in got._fields:
                np.testing.assert_allclose(
                    getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=1e-12, atol=1e-12, err_msg=f"{order} {field}"
                )
    # the +length/2 endpoint is the first candidate
    tip = xb.apply_point(torch.tensor([0.0, 0.0, 0.5 * length], dtype=torch.float64))
    got = narrowphase.plane_capsule(plane, identity, capsule, xb)
    torch.testing.assert_close(got.distance[:, 0], tip[:, 2] - 0.1 - radius, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pair", [(Capsule(0.1, 0.2), Sphere(0.1)), (Sphere(0.1), Capsule(0.1, 0.2))], ids=["capsule-sphere", "sphere-capsule"])
def test_capsule_sphere_raises_rather_than_skipping(pair):
    """Capsule-sphere, which the ant's own contacts never pair, is computed
    now, neither skipped nor refused: a sphere centred 0.05 beyond the
    capsule's +length/2 end overlaps it 0.15 deep, the normal along the
    axis."""
    assert narrowphase.supported(*pair)
    centre = Transform(pos=torch.zeros(1, 3, dtype=torch.float64), rot=torch.eye(3, dtype=torch.float64).expand(1, 3, 3))
    end = Transform(pos=torch.tensor([[0.0, 0.0, 0.15]], dtype=torch.float64), rot=centre.rot)
    xs = (centre, end) if isinstance(pair[0], Capsule) else (end, centre)
    got = narrowphase.compute_contacts(pair[0], xs[0], pair[1], xs[1])
    torch.testing.assert_close(got.distance, torch.tensor([[-0.15]], dtype=torch.float64), rtol=0, atol=1e-15)
    sign = -1.0 if isinstance(pair[0], Capsule) else 1.0  # the normal on b points from b toward a
    torch.testing.assert_close(got.normal_on_b, torch.tensor([[[0.0, 0.0, sign]]], dtype=torch.float64), rtol=0, atol=1e-15)


# -- top_k compaction --------------------------------------------------------
def collide_port(env, q, qd):
    """(qd', p, distance) of the ground-robot contact solve, as sim_step
    calls it."""
    ground = env.world.bodies[0]
    zero = q.new_zeros(q.shape[:-1] + (0,))
    kins = [fk_links(ground, zero, zero), fk_links(env.model, q, qd)]
    batch = t_world.gather_pair_contacts(env.world, kins, 0, 1, q)
    _, qd_new, p = mlcp.resolve_collision(
        ground, zero, zero, env.model, q, qd, batch, env.dt, env.world.solver, kin_a=kins[0], kin_b=kins[1]
    )
    return qd_new, p, batch.contact.distance


def collide_jax(env, q, qd):
    def one(q, qd):
        ground = env.world.bodies[0]
        zero = jnp.zeros(0, q.dtype)
        kins = [j_fk_links(ground, zero, zero), j_fk_links(env.model, q, qd)]
        batch = j_world.gather_pair_contacts(env.world, kins, 0, 1, q.dtype)
        _, qd_new, p = j_resolve_collision(
            ground, zero, zero, env.model, q, qd, batch, env.dt, env.world.solver, kin_a=kins[0], kin_b=kins[1]
        )
        return qd_new, p, batch.contact.distance

    return jax.jit(jax.vmap(one))(jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()))


def lowered_states(env, rng, batch, z_range):
    """Noisy joint poses, a tilted base at a height in ``z_range`` and
    random velocities."""
    q, _ = env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (batch, env.action_dim))))
    q[:, 2] = torch.from_numpy(rng.uniform(*z_range, batch))
    q[:, 3:6] = torch.from_numpy(rng.uniform(-0.1, 0.1, (batch, 3)))
    qd = torch.from_numpy(rng.normal(0.0, 0.5, (batch, env.model.dof_qd)))
    return q, qd


@pytest.mark.parametrize("case", ["ties", "more-than-8-penetrate", "8-or-fewer-penetrate"])
def test_resolve_collision_top_k_matches_jax(envs, case):
    j_env, t_env = envs
    assert t_env.world.solver.top_k == 8
    rng = np.random.default_rng(31)
    if case == "ties":
        # the zero-noise initial poses with the base on the ground: all 17
        # candidates penetrate and the distances tie in groups of 4
        env = AntEnv(dtype=torch.float64, device="cpu", start_base_position=(0.0, 0.0, 0.0))
        q, qd = env.initial_state(noise=torch.zeros(1, env.action_dim, dtype=torch.float64))
    else:
        q, qd = lowered_states(t_env, rng, 6, (0.0, 0.06) if case == "more-than-8-penetrate" else (0.15, 0.4))
    got_qd, got_p, got_d = collide_port(t_env, q, qd)
    want_qd, want_p, want_d = collide_jax(j_env, q, qd)
    want_d = np.asarray(want_d)
    penetrating = (want_d < 0).sum(-1)
    if case == "ties":
        assert penetrating.tolist() == [17]
        ties = want_d[0][:, None] == want_d[0][None, :]
        assert ties.sum() > 17, "the JAX package's distances should tie"
        port_d = got_d[0].numpy()
        np.testing.assert_array_equal(port_d[:, None] == port_d[None, :], ties)
        assert mlcp.top_k_indices(got_d, 8).tolist() == [[0, 1, 3, 5, 7, 9, 11, 15]]
    elif case == "more-than-8-penetrate":
        assert (penetrating > 8).all()
    else:
        assert (penetrating <= 8).all() and (penetrating > 0).all()
    j_idx = np.sort(np.asarray(jax.lax.top_k(-jnp.asarray(want_d), 8)[1]), axis=-1)
    np.testing.assert_array_equal(mlcp.top_k_indices(got_d, 8).numpy(), j_idx)
    assert got_p.shape == (q.shape[0], 24)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=TOL, atol=TOL)


# -- the env -----------------------------------------------------------------
def test_golden_pd_contact_trajectory(envs):
    """The C++ reference's 500-step ant PD contact trajectory (zero action)."""
    _, t_env = envs
    with open(os.path.join(GOLDEN, "ant_pd_contact_trajectory.json")) as f:
        golden = json.load(f)
    snaps = golden["snapshots"]
    assert abs(golden["dt"] - t_env.dt) < 1e-15
    q = torch.tensor([snaps["0"]["q"]], dtype=torch.float64)
    qd = torch.tensor([snaps["0"]["qd"]], dtype=torch.float64)
    zero = torch.zeros(1, t_env.action_dim, dtype=torch.float64)
    checked = 0
    for t in range(1, 501):
        q, qd = t_env.sim_step(q, qd, zero)
        if str(t) in snaps:
            tol = step_tol(t)
            np.testing.assert_allclose(q[0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
            np.testing.assert_allclose(qd[0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
            checked += 1
    assert checked == 10


def reset_noise(j_env, keys):
    """The draws LocomotionEnv.reset makes inside initial_state."""

    def noise(key):
        _, sub = jax.random.split(key)
        return jax.random.uniform(sub, (j_env.action_dim,), minval=-j_env.reset_noise, maxval=j_env.reset_noise, dtype=jnp.float64)

    return torch.from_numpy(np.array(jax.vmap(noise)(keys)))


def check_env_matches_jax(j_env, t_env, seed, steps=200, batch=4, action_scale=0.5):
    """reset from the JAX package's reset noise, then ``steps`` env steps
    with seeded actions in +-action_scale (past the action limit): state,
    observation and reward at 1e-8 up to step 100 and 1e-6 after, done
    exactly. Returns how many (step, env) pairs were done."""
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    t_state, t_obs = t_env.reset(noise=reset_noise(j_env, keys))
    for got, want in ((t_state.q, j_state.q), (t_state.qd, j_state.qd), (t_obs, j_obs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    j_step = jax.jit(jax.vmap(j_env.step))
    rng = np.random.default_rng(seed)
    dones = 0
    for t in range(1, steps + 1):
        action = rng.uniform(-action_scale, action_scale, size=(batch, t_env.action_dim))
        j_state, j_obs, j_reward, j_done = j_step(j_state, jnp.asarray(action))
        t_state, t_obs, t_reward, t_done = t_env.step(t_state, torch.from_numpy(action))
        tol = step_tol(t)
        for name, got, want in (("q", t_state.q, j_state.q), ("qd", t_state.qd, j_state.qd), ("obs", t_obs, j_obs), ("reward", t_reward, j_reward)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"{name} at step {t}")
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"done at step {t}")
        assert t_state.t.tolist() == [t] * batch
        dones += int(t_done.sum())
    return dones


def test_env_matches_jax_for_200_steps(envs):
    check_env_matches_jax(*envs, seed=3)


def test_reward_done(envs):
    j_env, t_env = envs
    rng = np.random.default_rng(5)
    q_prev = rng.normal(0.0, 0.3, (4, 14))
    q = q_prev + rng.normal(0.0, 0.05, (4, 14))
    q[:, 2] = (0.5, 0.2, 0.27, 0.25)  # alive, done, alive, done
    j_reward, j_done = jax.vmap(j_env.reward_done)(*(jnp.asarray(x) for x in (q_prev, q_prev, q, q)))
    t_reward, t_done = t_env.reward_done(*(torch.from_numpy(x) for x in (q_prev, q_prev, q, q)))
    assert t_done.tolist() == [False, True, False, True]
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kwargs", [dict(contact_model="spring")], ids=["spring"])
def test_unported_options_raise(kwargs):
    """Spring contact is ported: 12 float64 ant steps from the standing
    start with seeded actions against the JAX package's at TOL; the feet
    touch from step 9. (At the ant's 10 ms step the default spring, k =
    5000, is unstable in both packages: velocities pass 1e3 by step 21.)"""
    j_env, env = JaxAnt(dtype=jnp.float64, **kwargs), AntEnv(dtype=torch.float64, device="cpu", **kwargs)
    rng = np.random.default_rng(21)
    q, qd = env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (2, env.action_dim))))
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    for t in range(1, 13):
        action = rng.uniform(-0.4, 0.4, size=(2, env.action_dim))
        jq, jqd = j_step(jq, jqd, jnp.asarray(action))
        q, qd = env.sim_step(q, qd, torch.from_numpy(action))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=TOL, atol=TOL, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=TOL, atol=TOL, err_msg=f"qd at step {t}")
    assert env.world.contact_model == "spring" and float(q[:, 2].min()) < 0.45  # on the ground


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert AntEnv().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AntEnv()


# -- dynamics goldens -------------------------------------------------------
@pytest.mark.parametrize("golden, tol", [("ant_dynamics.json", 1e-10), ("ant_random_sweep.json", 1e-9)])
def test_forward_dynamics_matches_golden(golden, tol):
    """qdd; the files' mass matrices are held in
    tests/test_torch_floating.py (test_golden_mass_matrices)."""
    with open(os.path.join(GOLDEN, golden)) as f:
        data = json.load(f)
    model, _ = construct(URDF)
    assert (model.dof_q, model.dof_qd) == (data["dof"], data["dof_qd"])
    cases = data["cases"]
    q, qd, tau = (torch.tensor([c[k] for c in cases], dtype=torch.float64) for k in ("q", "qd", "tau"))
    qdd = forward_dynamics(model, q, qd, tau, torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64))
    np.testing.assert_allclose(qdd.numpy(), np.array([c["qdd"] for c in cases]), rtol=tol, atol=tol)


# -- the trained policy and the trainer ------------------------------------
def test_trained_ant_policy_walks():
    """logs/ant_ars/policy.pkl in float32 on the CPU, 4 envs for 1000 steps
    from seeded reset noise: every env alive for >= 900 steps and > 9.0 m
    forward (tests/test_ant_policy.py's thresholds; the JAX package
    measured 13.0-13.5 m, alive 1000/1000)."""
    saved, _ = load_checkpoint(CKPT)
    env = AntEnv(dtype=torch.float32, device="cpu")
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=torch.float32, device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0), batch_size=4)
    x0 = state.q[:, 0].clone()
    x, alive, steps = x0.clone(), torch.ones(4), torch.zeros(4)
    with torch.no_grad():
        for _ in range(1000):
            state, obs, _, done = env.step(state, env.action_transform(policy(stat.normalize(obs))))
            steps += alive
            x = torch.where(alive > 0, state.q[:, 0], x)
            alive = alive * (1.0 - done.float())
    assert bool(torch.isfinite(state.q).all())
    assert (steps >= 900).all(), f"alive for {steps.tolist()} steps (the JAX package: 1000)"
    assert (x - x0 > 9.0).all(), f"{(x - x0).tolist()} m forward (the JAX package: >= 13.0)"


def check_trainer(env_name, tmp_path):
    """Two tiny iterations of the trainer on the CPU: finite params,
    obs_stat and metrics, an eval, and the checkpoint written."""
    path = str(tmp_path / "policy.pkl")
    state, history = ars_train.main(
        ["--device", "cpu", "--env", env_name, "--iterations", "2", "--eval_interval", "2",
         "--num_directions", "2", "--rollout_length", "10", "--checkpoint", path]
    )
    assert bool(torch.isfinite(state.params).all()) and state.params.abs().max() > 0
    for part in state.obs_stat:
        assert bool(torch.isfinite(torch.as_tensor(part)).all())
    assert len(history) == 2 and "eval_reward_min" in history[-1]
    for metrics in history:
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    written, meta = load_checkpoint(path)
    assert meta["iteration"] == 2
    np.testing.assert_array_equal(np.asarray(written["params"]), state.params.numpy())


def test_trainer_on_the_ant(tmp_path):
    check_trainer("ant", tmp_path)
    assert ars_train.parse_args(["--env", "ant"]).checkpoint == "./logs/ant_ars/policy_torch.pkl"
