"""The cartpole env in the port (tds_tpu_torch.envs.cartpole, through the
port's forward_dynamics and integrate_euler) against the JAX package's in
float64, and ARS learning to balance it in the port alone, with the recipe
and thresholds of tests/test_learn.py. Inputs are made from numpy seeds."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from tds_tpu.envs.cartpole import CartpoleEnv as JaxCartpole  # noqa: E402
from tds_tpu_torch.envs.cartpole import CartpoleEnv  # noqa: E402
from tds_tpu_torch.learn import ars  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec  # noqa: E402


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

TOL = 1e-12  # float64, the same ABA and Euler arithmetic for 200 steps


def test_cartpole_matches_jax():
    """Reset from given noise, then 200 steps of seeded raw actions in
    +-1.5 (clipped by action_transform), batch 4: states, observations
    and rewards at 1e-12, actions and done equal."""
    batch, rng = 4, np.random.default_rng(8)
    j_env, env = JaxCartpole(dtype=jnp.float64), CartpoleEnv(dtype=torch.float64, device="cpu")
    noise = rng.uniform(-0.05, 0.05, (batch, 4))
    state, obs = env.reset(noise=torch.from_numpy(noise))
    j_state = JaxEnvState(
        q=jnp.asarray(noise[:, :2]), qd=jnp.asarray(noise[:, 2:]), t=jnp.zeros(batch, jnp.int32),
        key=jax.random.split(jax.random.PRNGKey(0), batch),
    )
    np.testing.assert_array_equal(obs.numpy(), noise)
    j_step = jax.jit(jax.vmap(j_env.step))
    dones = 0
    for t in range(200):
        raw = rng.uniform(-1.5, 1.5, (batch, 1))
        action = env.action_transform(torch.from_numpy(raw))
        j_action = j_env.action_transform(jnp.asarray(raw))
        np.testing.assert_array_equal(action.numpy(), np.asarray(j_action))
        state, obs, reward, done = env.step(state, action)
        j_state, j_obs, j_reward, j_done = j_step(j_state, j_action)
        for name, got, want in (("q", state.q, j_state.q), ("qd", state.qd, j_state.qd), ("obs", obs, j_obs), ("reward", reward, j_reward)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=f"{name} at step {t + 1}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))
        dones += int(done.sum())
    assert state.t.tolist() == [200] * batch
    assert 0 < dones < 200 * batch  # both sides of the done thresholds were checked


def test_ars_improves_cartpole():
    """tests/test_learn.py's recipe and thresholds: 64 directions x 200
    steps, delta_std 0.3, step size 1, 30 iterations, through ars.train
    with an eval every 10."""
    env = CartpoleEnv(dtype=torch.float64, device="cpu")
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(num_directions=64, rollout_length=200, delta_std=0.3, step_size=1.0, shift=0.0)
    eval_fn = ars.make_eval(env, policy, config, num_rollouts=8)
    before = float(eval_fn(ars.init_ars(env, policy, seed=0), torch.Generator().manual_seed(100))["eval_reward_mean"])
    logged = []
    state, history = ars.train(env, policy, config, 30, seed=0, log_fn=lambda it, s, m: logged.append(it))
    after = float(eval_fn(state, torch.Generator().manual_seed(100))["eval_reward_mean"])
    # the zero policy survives ~40 steps; a trained one clearly longer
    assert after > before + 8, (before, after)
    assert int(state.total_timesteps) > 0 and state.iteration == 30
    assert float(state.obs_stat.count) > 0
    assert logged == list(range(30)) and len(history) == 30
    assert [it for it, m in enumerate(history) if "eval_reward_min" in m] == [9, 19, 29]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in history[-1].values())
