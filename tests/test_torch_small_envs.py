"""The port's small envs and wrappers on the CPU, float64 against the JAX
package where it has a counterpart:

- ``envs/reacher.py``: a 50-step episode under seeded actions from the
  JAX package's reset draws, states, observations, rewards and done within
  1e-12; and the port's versions of tests/test_humanoid_reacher_envs.py's
  reacher tests (a finite, negative-reward episode that ends at
  ``episode_length``; a driven and a passive run; 15 ARS iterations that do
  not diverge);
- ``envs/vectorized.py``: ``VectorizedEnv``'s auto-reset against the JAX
  package's over 40 cartpole steps from its keys' draws, and ``rollout``
  against its ``rollout``;
- ``envs/domain_randomization.py``: tests/test_wrappers.py's batch checks,
  and the two-link pendulum's qdd through ``vmap_with_models`` against the
  JAX package's vmapped models from the same draws within 1e-12;
- ``envs/gym_wrapper.py``: tests/test_wrappers.py's API check, with
  ``gymnasium`` and without it (its own ``Box``), and the vector wrapper.
"""

import builtins
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.envs import domain_randomization as j_dr  # noqa: E402
from tds_tpu.envs import vectorized as j_vec  # noqa: E402
from tds_tpu.envs.cartpole import CartpoleEnv as JaxCartpole  # noqa: E402
from tds_tpu.envs.reacher import ReacherEnv as JaxReacher  # noqa: E402
from tds_tpu.dynamics import forward_dynamics as j_forward_dynamics  # noqa: E402
from tds_tpu.model.pendulum import compound_pendulum as j_compound_pendulum  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics  # noqa: E402
from tds_tpu_torch.envs import domain_randomization as dr  # noqa: E402
from tds_tpu_torch.envs import gym_wrapper  # noqa: E402
from tds_tpu_torch.envs.cartpole import CartpoleEnv  # noqa: E402
from tds_tpu_torch.envs.reacher import ReacherEnv  # noqa: E402
from tds_tpu_torch.envs.vectorized import VectorizedEnv, rollout  # noqa: E402
from tds_tpu_torch.model.pendulum import compound_pendulum  # noqa: E402


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

TOL = 1e-12


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def _reacher_noise(key):
    """The JAX reacher's reset draws for ``key``: [q, qd, target]."""
    _, k1, k2, k3 = jax.random.split(key, 4)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (2,), minval=-3.1, maxval=3.1)),
                           np.asarray(jax.random.uniform(k2, (2,), minval=-0.005, maxval=0.005)),
                           np.asarray(jax.random.uniform(k3, (2,), minval=-0.18, maxval=0.18))])


# -- reacher -----------------------------------------------------------------
def test_reacher_matches_jax():
    jenv, env = JaxReacher(dtype=jnp.float64), ReacherEnv(dtype=torch.float64, device="cpu")
    key = jax.random.PRNGKey(4)
    js, jobs = jenv.reset(key)
    state, obs = env.reset(noise=torch.from_numpy(_reacher_noise(key))[None])
    _close(state.q[0], js.q)
    _close(obs[0], jobs)
    actions = np.random.default_rng(0).uniform(-1.5, 1.5, size=(jenv.episode_length, 2))
    step = jax.jit(jenv.step)
    for a in actions:
        js, jobs, jr, jd = step(js, jnp.asarray(a))
        state, obs, r, d = env.step(state, torch.from_numpy(a)[None])
        _close(state.q[0], js.q)
        _close(state.qd[0], js.qd)
        _close(obs[0], jobs)
        _close(r[0], jr)
        assert bool(d[0]) == bool(jd) and int(state.t[0]) == int(js.t)
    assert bool(d[0])


def test_reacher_rollout_finite_and_rewarding():
    env = ReacherEnv(device="cpu")
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (1, env.observation_dim)
    total = 0.0
    for _ in range(env.episode_length):
        state, obs, reward, done = env.step(state, torch.zeros(1, env.action_dim))
        total += float(reward[0])
        assert torch.isfinite(obs).all()
    assert bool(done[0]) and total < 0.0


def test_reacher_reward_tracks_distance():
    env = ReacherEnv(device="cpu")

    def run(policy_fn):
        state, obs = env.reset(torch.Generator().manual_seed(3))
        total = 0.0
        for _ in range(env.episode_length):
            state, obs, r, _ = env.step(state, policy_fn(obs))
            total += float(r[0])
        return total

    passive = run(lambda obs: torch.zeros(1, 2))
    driven = run(lambda obs: (-20.0 * obs[:, 8:10]).clamp(-1.0, 1.0))
    assert np.isfinite(driven) and np.isfinite(passive)


def test_reacher_ars_improves():
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec

    env = ReacherEnv(episode_length=30, device="cpu")
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(num_directions=16, rollout_length=30, delta_std=0.05, step_size=0.05)
    step_fn = ars.make_train_step(env, policy, config)
    state = ars.init_ars(env, policy, 0)
    first = None
    for _ in range(15):
        state, metrics = step_fn(state)
        first = float(metrics["reward_pos_mean"]) if first is None else first
    last = float(metrics["reward_pos_mean"])
    assert np.isfinite(last) and last > first - 1.0, (first, last)


# -- vectorized ----------------------------------------------------------------
def _cartpole_reset_noise(key):
    """The JAX cartpole's reset draw for ``key``."""
    _, sub = jax.random.split(key)
    return np.asarray(jax.random.uniform(sub, (4,), minval=-0.05, maxval=0.05))


def test_vectorized_env_auto_resets_like_jax():
    """8 cartpoles pushed by seeded forces for 40 steps: the JAX package's
    VectorizedEnv and the port's, each finished env reset from the draw
    the JAX env's key gives at that step (maybe_reset's split, then
    reset's); several envs finish and reset, and the states agree."""
    n = 8
    jvec = j_vec.VectorizedEnv(JaxCartpole(dtype=jnp.float64), n)
    vec = VectorizedEnv(CartpoleEnv(dtype=torch.float64, device="cpu"), n)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    js, jobs = jvec.reset(jax.random.PRNGKey(1))
    state, obs = vec.reset(noise=torch.from_numpy(np.stack([_cartpole_reset_noise(k) for k in keys])))
    step = jax.jit(jvec.step)
    actions = np.random.default_rng(1).uniform(-1.0, 1.0, size=(40, n, 1))
    finished = 0
    for a in actions:
        noise = np.stack([_cartpole_reset_noise(jax.random.split(k)[1]) for k in js.key])
        js, jobs, jr, jd = step(js, jnp.asarray(10.0 * a))
        state, obs, r, d = vec.step(state, torch.from_numpy(10.0 * a), reset_noise=torch.from_numpy(noise))
        finished += int(d.sum())
        _close(state.q, js.q)
        _close(state.qd, js.qd)
        _close(obs, jobs)
        assert np.array_equal(d.numpy(), np.asarray(jd)) and np.array_equal(state.t.numpy(), np.asarray(js.t))
    assert finished >= 3


def test_rollout_matches_jax():
    """A linear policy's 60-step cartpole rollout from the JAX package's
    reset draw: the same total reward and steps alive."""
    w = np.random.default_rng(2).normal(size=(1, 4))

    def j_policy(params, obs):
        return params @ obs

    def policy(params, obs):
        return obs @ params.T

    key = jax.random.PRNGKey(7)
    want_total, want_steps = j_vec.rollout(JaxCartpole(dtype=jnp.float64), j_policy, jnp.asarray(w), key, 60)
    env = CartpoleEnv(dtype=torch.float64, device="cpu")
    total, steps = rollout(env, policy, torch.from_numpy(w), 60, noise=torch.from_numpy(_cartpole_reset_noise(key))[None])
    _close(total[0], want_total)
    _close(steps[0], want_steps)
    assert 0 < float(steps[0]) < 60  # the policy drops the pole inside the rollout


# -- domain randomisation -------------------------------------------------------
def test_domain_randomization_batch():
    """tests/test_wrappers.py's checks through the port: 16 models with
    masses scaled in [0.5, 2], varied, every leaf batched; the vmapped qdd
    differs between them."""
    base = compound_pendulum(2)
    models = dr.randomize_batch(base, 16, dr.RandomizationSpec(mass_range=(0.5, 2.0)), generator=torch.Generator().manual_seed(0))
    assert models.mass.shape == (16, 2) and models.x_t_pos.shape == (16, 2, 3)
    ratio = (models.mass / base.mass).numpy()
    assert ratio.min() >= 0.5 and ratio.max() <= 2.0 and ratio.std() > 0.05
    q, qd = torch.tensor([0.4, -0.2], dtype=torch.float64), torch.zeros(2, dtype=torch.float64)
    g = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)
    qdds = torch.func.vmap(lambda m: forward_dynamics(m, q, qd, torch.zeros(2, dtype=torch.float64), g))(models)
    assert qdds.shape == (16, 2) and qdds.std(0).max() > 1e-3


def test_vmap_with_models_matches_jax():
    """Mass, damping and com randomised from the JAX package's draws (its
    keys' uniforms), 6 models and 6 states: the two-link pendulum's qdd
    through vmap_with_models against jax.vmap over the JAX package's
    randomised models, within 1e-12."""
    spec = dict(mass_range=(0.5, 2.0), damping_range=(0.9, 1.1), com_range=(0.8, 1.25))
    j_models = j_dr.randomize_batch(j_compound_pendulum(2), jax.random.PRNGKey(5), 6, j_dr.RandomizationSpec(**spec))
    uniforms = np.stack([np.stack([np.asarray(jax.random.uniform(k, (2,), jnp.float64)) for k in jax.random.split(key, 3)])
                         for key in jax.random.split(jax.random.PRNGKey(5), 6)])
    models = dr.randomize_batch(compound_pendulum(2), 6, dr.RandomizationSpec(**spec), uniforms=torch.from_numpy(uniforms))
    for name in ("mass", "com", "inertia", "damping"):
        _close(getattr(models, name), getattr(j_models, name))
    rng = np.random.default_rng(3)
    q, qd, tau = rng.normal(size=(6, 2)), rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    g = np.array([0.0, 0.0, -9.81])
    want = jax.vmap(lambda m, a, b, c: j_forward_dynamics(m, a, b, c, jnp.asarray(g)))(j_models, *(jnp.asarray(x) for x in (q, qd, tau)))
    step = dr.vmap_with_models(lambda m, a, b, c: forward_dynamics(m, a, b, c, torch.from_numpy(g)))
    _close(step(models, *(torch.from_numpy(x) for x in (q, qd, tau))), want)


# -- gym wrapper -------------------------------------------------------------------
def _episode(env):
    obs, info = env.reset(seed=3)
    assert obs.shape == (4,) and obs.dtype == np.float32 and info == {}
    total, terminated, truncated = 0.0, False, False
    for _ in range(60):
        action = env.action_space.sample()
        assert env.action_space.contains(action)
        obs, reward, terminated, truncated, info = env.step(action)
        total += reward
        if terminated or truncated:
            break
    assert total > 0 and (terminated or truncated)


def test_gym_wrapper_api():
    """tests/test_wrappers.py's test_gym_wrapper_api through the port, with
    gymnasium where it imports (else the module's own Box)."""
    _episode(gym_wrapper.GymEnv(CartpoleEnv(device="cpu"), max_episode_steps=50))


def test_gym_wrapper_without_gymnasium(monkeypatch):
    """With ``import gymnasium`` failing, the wrapper imports, derives from
    object, and its spaces are its own Box, which samples inside its
    bounds."""
    real_import = builtins.__import__

    def no_gymnasium(name, *args, **kwargs):
        if name == "gymnasium" or name.startswith("gymnasium."):
            raise ImportError("no gymnasium")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_gymnasium)
    module = importlib.reload(gym_wrapper)
    try:
        env = module.GymEnv(CartpoleEnv(device="cpu"), max_episode_steps=50)
        assert module.gymnasium is None and type(env).__mro__[1] is object
        assert isinstance(env.action_space, module.Box) and env.action_space.shape == (1,)
        _episode(env)
    finally:
        monkeypatch.undo()
        importlib.reload(gym_wrapper)


def test_gym_vector_env():
    """4 reachers of 5 steps behind the vector wrapper: numpy out, every env
    finishes at step 5 and starts a new episode in the same step."""
    vec = gym_wrapper.GymVectorEnv(ReacherEnv(dtype=torch.float64, episode_length=5, device="cpu"), 4, seed=1)
    obs, _ = vec.reset()
    assert obs.shape == (4, 10) and obs.dtype == np.float32
    for i in range(6):
        obs, reward, done, truncated, _ = vec.step(np.zeros((4, 2)))
        assert reward.shape == (4,) and np.isfinite(reward).all()
        assert done.all() == (i == 4) and not truncated.any()
