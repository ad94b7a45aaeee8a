"""PPO on the ant (``tds_tpu_torch.learn.ppo`` through the port's contact
step, 24 MLCP rows) against the JAX package's ``make_ppo``, float64 on the
CPU: one iteration of a 4-step unroll of 2 envs from the JAX package's
draws, env 0 started low enough (base z = 0.2 < 0.26) to finish at its
first step, so that its auto-reset (a reset with 10 settle contact steps)
runs inside the unroll. The envs' states and observations, the
observation statistics, the metrics and the updated params and Adam
moments agree within 1e-8.

Alone in its file: the JAX package's compile of the iteration (the contact
step and the reset's settle steps) is most of its minute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tds_tpu.envs.ant import AntEnv as JaxAnt  # noqa: E402
from tds_tpu.learn import ppo as j_ppo  # noqa: E402
from tds_tpu_torch.convert import ppo_state_from_numpy  # noqa: E402
from tds_tpu_torch.envs.ant import AntEnv  # noqa: E402
from tds_tpu_torch.learn import ppo  # noqa: E402


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

TOL = 1e-8
HIDDEN = (16, 16)
CONFIG = dict(num_envs=2, unroll_length=4, num_minibatches=2, num_epochs=1, learning_rate=1e-3, init_log_std=-1.0)
RESET_SLOTS = 2


def _adam(state):
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), {k: np.asarray(v) for k, v in adam.mu.items()}, {k: np.asarray(v) for k, v in adam.nu.items()}


def _jax_draws(env, state, config):
    """The iteration's draws recreated from the JAX state's keys: the
    action noise, each env's r-th reset noise (maybe_reset's split, then
    reset's, then initial_state's uniform), the epochs' permutations."""
    key = state.key
    noise = []
    for _ in range(config.unroll_length):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (config.num_envs, env.action_dim), jnp.float64))
    perms = []
    for _ in range(config.num_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(jax.random.permutation(k_perm, config.unroll_length * config.num_envs))
    resets, keys = [], list(state.env_states.key)
    for _ in range(RESET_SLOTS):
        row = []
        for b, k in enumerate(keys):
            k1, k2 = jax.random.split(k)
            _, sub = jax.random.split(k2)
            row.append(jax.random.uniform(sub, (env.action_dim,), minval=-env.reset_noise, maxval=env.reset_noise,
                                          dtype=jnp.float64))
            keys[b] = k1
        resets.append(jnp.stack(row))
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return ppo.PPODraws(as_t(jnp.stack(noise)), as_t(jnp.stack(resets)), as_t(jnp.stack(perms)).to(torch.int64))


def _close(got, want, label):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=label)


def test_ant_iteration_matches_jax():
    env = JaxAnt(dtype=jnp.float64)
    config = j_ppo.PPOConfig(**CONFIG)
    nets = j_ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    init_fn, step_fn = j_ppo.make_ppo(env, nets, config)
    state = init_fn(jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, state)
    q = state.env_states.q.at[0, 2].set(0.2)  # env 0 below the done height
    state = state.replace(env_states=state.env_states.replace(q=q), obs=jnp.concatenate([q, state.env_states.qd], -1))
    draws = _jax_draws(env, state, config)
    new, metrics = step_fn(state)

    port_env = AntEnv(dtype=torch.float64, device="cpu")
    count, mu, nu = _adam(state)
    es = state.env_states
    start = ppo_state_from_numpy({k: np.asarray(v) for k, v in state.params.items()},
                                 tuple(np.asarray(x) for x in state.obs_stat), (np.asarray(es.q), np.asarray(es.qd), np.asarray(es.t)),
                                 np.asarray(state.obs), adam=(count, mu, nu), dtype=torch.float64, device="cpu")
    port_nets = ppo.PPONetworks(port_env.observation_dim, port_env.action_dim, hidden=HIDDEN)
    got, got_metrics = ppo.ppo_iteration(port_env, port_nets, ppo.PPOConfig(**CONFIG), start, draws)

    assert int(got_metrics["resets"]) >= 1 and float(metrics["episode_done_rate"]) > 0
    _close(got.env_state.q, new.env_states.q, "q")
    _close(got.env_state.qd, new.env_states.qd, "qd")
    _close(got.obs, new.obs, "obs")
    for name, g, w in zip(("count", "mean", "m2"), got.obs_stat, new.obs_stat):
        _close(g, w, f"obs_stat.{name}")
    for k, v in metrics.items():
        _close(got_metrics[k], v, k)
    count, mu, nu = _adam(new)
    assert got.opt_state.count == count
    for k in ("policy", "value", "log_std"):
        _close(got.params[k], new.params[k], f"params[{k}]")
        _close(got.opt_state.mu[k], mu[k], f"mu[{k}]")
        _close(got.opt_state.nu[k], nu[k], f"nu[{k}]")
