"""PPO from a reset pool (``tds_tpu_torch.learn.ppo`` on a ``LocomotionEnv``
with ``reset_pool``) against the JAX package's ``make_ppo``, float64 on
the CPU: one iteration of an 8-step unroll of 4 hoppers from the JAX
package's draws (the action noise, each env's reset noise and its pool
draws, recreated from its keys, and the epoch's permutation). Every env
starts pitched past the fall, so that it finishes at its first step; the
pool holds brink states (pitch 0.97 rad, falling at 4 rad/s), so that an
env reset from the pool finishes again within the unroll. Inside the
unroll at least one auto-reset takes a pool state and at least one does
not; the envs' states, observations, statistics, metrics, params and Adam
moments agree within 1e-9.

The JAX state is put together here (``init_fn`` would compile the
batched reset, as long as the iteration's own compile); one thread, the
JAX package's iteration compiled without XLA's optimisation passes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tds_tpu.envs.base import EnvState as JaxEnvState  # noqa: E402
from tds_tpu.envs.hopper import HopperEnv as JaxHopper  # noqa: E402
from tds_tpu.learn import ppo as j_ppo  # noqa: E402
from tds_tpu.learn.running_stat import RunningStat as JaxRunningStat  # noqa: E402
from tds_tpu_torch.convert import ppo_state_from_numpy  # noqa: E402
from tds_tpu_torch.envs.hopper import HopperEnv  # noqa: E402
from tds_tpu_torch.learn import ppo  # noqa: E402

TOL = 1e-9
HIDDEN = (8, 8)
CONFIG = dict(num_envs=4, unroll_length=8, num_minibatches=2, num_epochs=1, learning_rate=1e-3, init_log_std=-1.0)
RESET_SLOTS, POOL_SIZE, POOL_PROB = 4, 5, 0.5


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)


def _pool(dof_q, dof_qd):
    """Brink states from a seed: x anywhere (reset moves it back to 0),
    pitch +-0.97 rad and falling further at 4 rad/s, the joints bent."""
    rng = np.random.default_rng(7)
    q, qd = np.zeros((POOL_SIZE, dof_q)), np.zeros((POOL_SIZE, dof_qd))
    side = np.where(np.arange(POOL_SIZE) % 2 == 0, 1.0, -1.0)
    q[:, 0] = rng.normal(size=POOL_SIZE)
    q[:, 2] = 0.97 * side
    q[:, 3:] = 0.2 * rng.normal(size=(POOL_SIZE, dof_q - 3))
    qd[:, 2] = 4.0 * side
    return q, qd


def _jax_start(env, config, nets):
    """The state make_ppo's init_fn gives for PRNGKey(0), with every env
    pitched to 0.99 rad and falling at 5 rad/s (done at its first step)."""
    key, k_net, k_env = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), nets.init(k_net, config))
    optimizer = optax.chain(optax.clip_by_global_norm(config.max_grad_norm), optax.adam(config.learning_rate))
    b = config.num_envs
    q = jnp.zeros((b, env.model.dof_q)).at[:, 2].set(0.99)
    qd = jnp.zeros((b, env.model.dof_qd)).at[:, 2].set(5.0)
    env_states = JaxEnvState(q=q, qd=qd, t=jnp.zeros(b, jnp.int32), key=jax.random.split(k_env, b))
    return j_ppo.PPOState(params=params, opt_state=optimizer.init(params), env_states=env_states,
                          obs=jnp.concatenate([q, qd], -1), obs_stat=JaxRunningStat.create(env.observation_dim, jnp.float64),
                          key=key, iteration=jnp.zeros((), jnp.int32))


def _jax_draws(env, state, config):
    """The iteration's draws recreated from the JAX state's keys: the action
    noise, each env's r-th reset (maybe_reset's split, then reset's: its
    initial_state's uniform, then the pool's bernoulli and randint), the
    epoch's permutation."""
    key = state.key
    noise = []
    for _ in range(config.unroll_length):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (config.num_envs, env.action_dim), jnp.float64))
    perms = []
    for _ in range(config.num_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(jax.random.permutation(k_perm, config.unroll_length * config.num_envs))
    resets, use, index, keys = [], [], [], list(state.env_states.key)
    for _ in range(RESET_SLOTS):
        rows = ([], [], [])
        for b, k in enumerate(keys):
            k1, k2 = jax.random.split(k)
            k_reset, sub = jax.random.split(k2)
            rows[0].append(jax.random.uniform(sub, (env.action_dim,), minval=-env.reset_noise, maxval=env.reset_noise,
                                              dtype=jnp.float64))
            _, k_use, k_idx = jax.random.split(k_reset, 3)
            rows[1].append(jax.random.bernoulli(k_use, env.reset_pool_prob))
            rows[2].append(jax.random.randint(k_idx, (), 0, POOL_SIZE))
            keys[b] = k1
        resets.append(jnp.stack(rows[0]))
        use.append(jnp.stack(rows[1]))
        index.append(jnp.stack(rows[2]))
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return ppo.PPODraws(as_t(jnp.stack(noise)), as_t(jnp.stack(resets)), as_t(jnp.stack(perms)).to(torch.int64),
                        (as_t(jnp.stack(use)), as_t(jnp.stack(index)).to(torch.int64)))


def _adam(state):
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), {k: np.asarray(v) for k, v in adam.mu.items()}, {k: np.asarray(v) for k, v in adam.nu.items()}


def _close(got, want, label):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=label)


def test_pool_iteration_matches_jax():
    pool = _pool(6, 6)
    env = JaxHopper(dtype=jnp.float64, reset_pool=pool, reset_pool_prob=POOL_PROB)
    config = j_ppo.PPOConfig(**CONFIG)
    nets = j_ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    state = _jax_start(env, config, nets)
    draws = _jax_draws(env, state, config)
    new, metrics = j_ppo.make_ppo(env, nets, config)[1](state)

    port_env = HopperEnv(dtype=torch.float64, device="cpu", reset_pool=pool, reset_pool_prob=POOL_PROB)
    count, mu, nu = _adam(state)
    es = state.env_states
    start = ppo_state_from_numpy({k: np.asarray(v) for k, v in state.params.items()},
                                 tuple(np.asarray(x) for x in state.obs_stat), (np.asarray(es.q), np.asarray(es.qd), np.asarray(es.t)),
                                 np.asarray(state.obs), adam=(count, mu, nu), dtype=torch.float64, device="cpu")
    port_nets = ppo.PPONetworks(port_env.observation_dim, port_env.action_dim, hidden=HIDDEN)
    got, got_metrics = ppo.ppo_iteration(port_env, port_nets, ppo.PPOConfig(**CONFIG), start, draws)

    # both branches inside the unroll: a reset from the pool and one from the settled start
    resets, pooled = int(got_metrics["resets"]), int(got_metrics["pool_resets"])
    assert 0 < pooled < resets, (pooled, resets)
    _close(got.env_state.q, new.env_states.q, "q")
    _close(got.env_state.qd, new.env_states.qd, "qd")
    assert np.array_equal(got.env_state.t.numpy(), np.asarray(new.env_states.t))
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


def test_make_ppo_draws_pool_slots():
    """make_ppo on a pool env (it refused one before): step_fn draws each
    slot's pool draws beside its noise, retries with more slots when an env
    runs out, and a slot appended by more_resets carries pool draws too."""
    env = HopperEnv(dtype=torch.float64, device="cpu", reset_pool=_pool(6, 6), reset_pool_prob=POOL_PROB)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    cfg = ppo.PPOConfig(**CONFIG)
    init_fn, step_fn = ppo.make_ppo(env, nets, cfg)
    state = init_fn(0)
    q = state.env_state.q.clone()
    q[:, 2] = 0.99
    qd = state.env_state.qd.clone()
    qd[:, 2] = 5.0
    state = state._replace(env_state=state.env_state._replace(q=q, qd=qd), obs=env.observation(q, qd))
    draws = ppo.draw_iteration(env, cfg, torch.Generator().manual_seed(3), torch.float64, reset_slots=1)
    assert draws.reset_pool[0].shape == draws.reset_pool[1].shape == (1, cfg.num_envs)
    more = ppo.more_resets(env, cfg, draws, torch.Generator().manual_seed(4), 3)
    assert more.reset_pool[0].shape == (3, cfg.num_envs) and torch.equal(more.reset_pool[1][:1], draws.reset_pool[1])
    new, metrics = step_fn(state)
    assert new.iteration == 1 and int(metrics["resets"]) >= cfg.num_envs
    assert 0 <= int(metrics["pool_resets"]) <= int(metrics["resets"])
    assert all(bool(torch.isfinite(p).all()) for p in new.params.values())
