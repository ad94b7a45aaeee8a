"""The port's laikago env against the JAX package's and against the C++
golden trajectory, float64 on the CPU.

- sim_step step by step for 200 steps at batch 4 with seeded random
  actions in +-0.4: 1e-8 up to step 100, 1e-6 after;
- tests/golden/laikago_pd_contact_trajectory.json for 500 steps at the
  tolerances of tests/test_golden_reference.py;
- reset from the same noise (10 settle steps), then observation, step and
  reward_done on the same states, at 1e-10; the reset's settle steps run as
  one ``graphs.scan`` and match the JAX package's scanned reset at 1e-12.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.contact.mlcp import ContactSolverParams as JaxSolverParams  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Sphere  # noqa: E402


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

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "laikago_pd_contact_trajectory.json")
TOL = 1e-10


@pytest.fixture(scope="module")
def envs():
    return JaxLaikago(dtype=jnp.float64), LaikagoEnv(dtype=torch.float64, device="cpu")


def _step_tol(t):
    return 1e-8 if t <= 100 else 1e-6


def test_sim_step_matches_jax_for_200_steps(envs):
    j_env, t_env = envs
    batch, rng = 4, np.random.default_rng(2024)
    q, qd = jax.vmap(j_env.initial_state)(jax.random.split(jax.random.PRNGKey(0), batch))
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    tq, tqd = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(qd))
    for t in range(1, 201):
        action = rng.uniform(-0.4, 0.4, size=(batch, j_env.action_dim))
        q, qd = j_step(q, qd, jnp.asarray(action))
        tq, tqd = t_env.sim_step(tq, tqd, torch.from_numpy(action))
        tol = _step_tol(t)
        np.testing.assert_allclose(tq.numpy(), np.asarray(q), rtol=tol, atol=tol, err_msg=f"q at step {t}")
        np.testing.assert_allclose(tqd.numpy(), np.asarray(qd), rtol=tol, atol=tol, err_msg=f"qd at step {t}")


def test_golden_pd_contact_trajectory(envs):
    """The C++ reference's 500-step PD contact trajectory (zero action)."""
    _, t_env = envs
    with open(GOLDEN) as f:
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
            tol = _step_tol(t)
            np.testing.assert_allclose(q[0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
            np.testing.assert_allclose(qd[0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
            checked += 1
    assert checked >= 5


@pytest.fixture(scope="module")
def reset_noise(envs):
    """JAX reset keys per env and the joint noise each key's reset draws
    inside initial_state, as a (B, action_dim) numpy array."""
    j_env, _ = envs
    keys = jax.random.split(jax.random.PRNGKey(11), 3)

    def noise(key):
        _, sub = jax.random.split(key)
        return jax.random.uniform(sub, (j_env.action_dim,), minval=-j_env.reset_noise, maxval=j_env.reset_noise, dtype=jnp.float64)

    return keys, np.array(jax.vmap(noise)(keys))


@pytest.fixture(scope="module")
def reset_pair(envs, reset_noise):
    """JAX reset(key) per env and the port's reset from the same draws."""
    j_env, t_env = envs
    keys, noise = reset_noise
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    t_state, t_obs = t_env.reset(noise=torch.from_numpy(noise))
    return j_state, j_obs, t_state, t_obs


def test_reset_from_the_same_noise(reset_pair):
    j_state, j_obs, t_state, t_obs = reset_pair
    for got, expected in ((t_state.q, j_state.q), (t_state.qd, j_state.qd), (t_obs, j_obs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_state.t.numpy(), np.asarray(j_state.t))


def test_reset_runs_its_settle_steps_as_one_scan_like_jax(envs, reset_noise, reset_pair, monkeypatch):
    """The settle steps go through graphs.scan (its plain path on the CPU;
    replayed graphs on the card), the counterpart of the JAX reset's
    lax.scan, and land on the JAX package's scanned reset at 1e-12."""
    from tds_tpu_torch.envs import locomotion

    _, t_env = envs
    calls, scan = [], locomotion.scan

    def recording(body, carry, consts, length, key):
        calls.append((length, key))
        return scan(body, carry, consts, length, key)

    monkeypatch.setattr(locomotion, "scan", recording)
    t_state, t_obs = t_env.reset(noise=torch.from_numpy(reset_noise[1]))
    assert calls == [(t_env.settle_steps, ("settle", t_env))]
    j_state, j_obs = reset_pair[:2]
    for got, expected in ((t_state.q, j_state.q), (t_state.qd, j_state.qd), (t_obs, j_obs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-12)


def test_step_observation_reward_done(envs, reset_pair):
    j_env, t_env = envs
    j_state, _, t_state, _ = reset_pair
    action = np.random.default_rng(3).uniform(-0.3, 0.3, size=(3, j_env.action_dim))
    j_out = jax.jit(jax.vmap(j_env.step))(j_state, jnp.asarray(action))
    t_out = t_env.step(t_state, torch.from_numpy(action))
    for got, expected in zip((t_out[0].q, t_out[0].qd, t_out[1], t_out[2]), (j_out[0].q, j_out[0].qd, j_out[1], j_out[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    np.testing.assert_array_equal(t_out[0].t.numpy(), np.asarray(j_out[0].t))


def test_reward_done_on_fallen_and_tilted_states(envs, reset_pair):
    j_env, t_env = envs
    q = np.asarray(reset_pair[0].q).copy()
    q[1, 2] = 0.1  # base too low
    q[2, 3] = 1.2  # rolled over: up.z < 0.6
    qd = np.asarray(reset_pair[0].qd)
    j_reward, j_done = jax.vmap(j_env.reward_done)(*(jnp.asarray(x) for x in (q, qd, q, qd)))
    t_reward, t_done = t_env.reward_done(*(torch.from_numpy(x) for x in (q, qd, q, qd)))
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    assert t_done.tolist() == [False, True, True]
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_env.observation(*(torch.from_numpy(x) for x in (q, qd))).numpy(), np.asarray(j_env.observation(jnp.asarray(q), jnp.asarray(qd))))


def test_initial_state_from_a_generator(envs):
    _, t_env = envs
    q1, _ = t_env.initial_state(torch.Generator().manual_seed(5), batch_size=6)
    q2, qd2 = t_env.initial_state(torch.Generator().manual_seed(5), batch_size=6)
    torch.testing.assert_close(q1, q2, rtol=0, atol=0)
    assert q1.shape == (6, 18) and qd2.abs().max() == 0
    offsets = q1[:, 6:] - torch.tensor((0.2, 0.0, -0.7) * 4, dtype=torch.float64)
    assert offsets.abs().max() <= t_env.reset_noise and offsets.std() > 0
    torch.testing.assert_close(q1[:, :3], torch.tensor([[0.0, 0.0, 0.48]] * 6, dtype=torch.float64))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert LaikagoEnv().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LaikagoEnv()


def check_steps_match_jax(steps, seed, **kwargs):
    """``steps`` float64 sim_steps at batch 3 against the JAX package's at
    TOL from a lowered start (0, 0, 0.45), where the toes touch from the
    first step, with seeded actions; ``kwargs`` (``solver`` as the port's
    ContactSolverParams) go to both envs."""
    start = (0.0, 0.0, 0.45)
    jax_kwargs = dict(kwargs)
    if "solver" in kwargs:
        jax_kwargs["solver"] = JaxSolverParams(**kwargs["solver"]._asdict())
    j_env = JaxLaikago(dtype=jnp.float64, start_base_position=start, **jax_kwargs)
    env = LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=start, **kwargs)
    rng = np.random.default_rng(seed)
    q, qd = env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (3, env.action_dim))))
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    for t in range(1, steps + 1):
        action = rng.uniform(-0.4, 0.4, size=(3, env.action_dim))
        jq, jqd = j_step(jq, jqd, jnp.asarray(action))
        q, qd = env.sim_step(q, qd, torch.from_numpy(action))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=TOL, atol=TOL, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=TOL, atol=TOL, err_msg=f"qd at step {t}")
    return env


@pytest.mark.parametrize(
    "kwargs, error",
    [
        # a sphere for the ground: ported, the toes collide with it sphere
        # against sphere
        (dict(terrain=Sphere(1.0)), None),
        # terrain, height_scan and reset_pool are ported: what they refuse
        (dict(height_scan=((0.0, 0.0),)), ValueError),
        (dict(reset_pool=(np.zeros((1, 17)), np.zeros((1, 18)))), ValueError),
        # ported: spring contact matches the JAX package, and K2 refuses it
        (dict(contact_model="spring"), None),
    ],
    ids=["terrain", "height_scan", "reset_pool", "spring"],
)
def test_unported_options_raise(kwargs, error):
    """Unported options raise NotImplementedError at construction; the
    ported terrain options raise ValueError on what the JAX package
    refuses (a height scan without a terrain, a pool of the wrong width).
    Spring contact is ported: 10 steps against the JAX package at TOL (the
    20-step case is tests/test_torch_spring.py's), and the fused step K2,
    whose source is the MLCP step, refuses it. A sphere for the ground is
    ported: the toes' sphere-sphere contacts with it, gathered by the world
    of each package from one seeded state, agree at TOL."""
    if "terrain" in kwargs:
        check_sphere_terrain_contacts()
        return
    if error is None:
        check_steps_match_jax(10, 14, **kwargs)
        with pytest.raises(NotImplementedError, match="contact_model='spring'"):
            LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True, **kwargs)
        return
    with pytest.raises(error):
        LaikagoEnv(dtype=torch.float64, device="cpu", **kwargs)


def check_sphere_terrain_contacts():
    """The laikago over a 1 m sphere in place of the plane: the candidates
    of the ground-robot pair of both worlds (eager JAX) at a seeded pose."""
    from tds_tpu.dynamics.kinematics import fk_links as j_fk_links
    from tds_tpu.model import geometry as j_geometry
    from tds_tpu.world import gather_pair_contacts as j_gather
    from tds_tpu_torch.dynamics.kinematics import fk_links
    from tds_tpu_torch.world import gather_pair_contacts

    env = LaikagoEnv(dtype=torch.float64, device="cpu", terrain=Sphere(1.0))
    j_env = JaxLaikago(dtype=jnp.float64, terrain=j_geometry.Sphere(1.0))
    q, _ = env.initial_state(noise=torch.from_numpy(np.random.default_rng(3).uniform(-0.05, 0.05, (1, env.action_dim))))
    q[:, :3] += torch.tensor([0.3, -0.2, 0.6], dtype=torch.float64)
    ground, zero = torch.zeros(1, 0, dtype=torch.float64), torch.zeros_like(q[:, : env.model.dof_qd])
    got = gather_pair_contacts(env.world, [fk_links(env.world.bodies[0], ground, ground), fk_links(env.model, q, zero)], 0, 1, q)
    jq = jnp.asarray(q[0].numpy())
    j_kins = [j_fk_links(j_env.world.bodies[0], jnp.zeros(0), jnp.zeros(0)), j_fk_links(j_env.model, jq, jnp.zeros(j_env.model.dof_qd))]
    want = j_gather(j_env.world, j_kins, 0, 1, jnp.float64)
    assert got.link_a == want.link_a and got.link_b == want.link_b and got.contact.count == 4
    for field in got.contact._fields:
        np.testing.assert_allclose(getattr(got.contact, field)[0].numpy(), np.asarray(getattr(want.contact, field)), rtol=TOL, atol=TOL,
                                   err_msg=field)
    assert float(got.contact.distance.min()) < 0  # the toes overlap the sphere


@pytest.mark.parametrize(
    "solver",
    [ContactSolverParams(minv_method="crba"), ContactSolverParams(top_k=2), ContactSolverParams(delassus_dtype="bf16")],
    ids=["crba", "top_k", "bf16"],
)
def test_unported_solver_options_raise(solver):
    """Every solver option is ported; each case holds the port against the
    JAX package at TOL from a lowered start, where the toes touch from the
    first step: top_k compaction over 50 steps (it drops the shallower 2 of
    4), the CRBA M^-1 and the bf16 Delassus product over 20. K2 refuses
    the CRBA and bf16 options (its source computes neither)."""
    check_steps_match_jax(50 if solver.top_k else 20, 12, solver=solver)
    if not solver.top_k:
        with pytest.raises(NotImplementedError, match="the fused step"):
            LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True, solver=solver)
