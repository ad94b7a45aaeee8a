"""PPO in the port (``tds_tpu_torch.learn.ppo``) on cartpole, float64 on the
CPU:

- one and two iterations against the JAX package's ``make_ppo`` from its
  draws (the action noise of every step, each env's reset noise, the
  epochs' permutations, recreated from its keys), with the learning-rate
  anneal on and envs started near the fall, so that several finish and
  auto-reset inside the unroll: params, Adam's count and moments, the
  observation statistics, the envs' states and the metrics within 1e-9;
- an env that finishes more often than the draws hold resets raises
  ``ResetsExhausted``, and ``step_fn`` draws more and runs on;
- the port's counterparts of tests/test_ppo.py: PPO improves cartpole's
  deterministic return (averaged over 8 starts, after 40 iterations), and
  the anneal freezes the late policy;
- checkpoints: the port writes the JAX package's PPO format and reads it
  back, and reads the JAX package's (``logs/ant_ppo/policy.pkl``);
- ``tools/ppo_train.py`` at a tiny size writes both checkpoints;
- tests/golden/ant_ppo_policy_reset_noise.json, the starts from which
  ``chip_smoke.py`` and tests/test_torch_ppo_cuda.py replay the committed
  ant checkpoints, holds the JAX ant's reset draws for the seeds of
  tests/test_ppo_ant_policy.py.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tds_tpu.envs.ant import AntEnv as JaxAnt  # noqa: E402
from tds_tpu.envs.cartpole import CartpoleEnv as JaxCartpole  # noqa: E402
from tds_tpu.learn import ppo as j_ppo  # noqa: E402
from tds_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from tds_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from tds_tpu_torch.convert import ppo_checkpoint, ppo_from_checkpoint, ppo_state_from_numpy  # noqa: E402
from tds_tpu_torch.envs.cartpole import CartpoleEnv  # noqa: E402
from tds_tpu_torch.learn import ppo  # noqa: E402
from tds_tpu_torch.tools import ppo_train  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
HIDDEN = (8, 8)
CONFIG = dict(num_envs=4, unroll_length=8, num_minibatches=2, num_epochs=2, learning_rate=1e-3, lr_anneal_iterations=3,
              init_log_std=0.0)
# the envs' start: env 0 and 2 tilted to 0.2 rad (the fall is at 12
# degrees, 0.209 rad) and falling, env 1 at the rail's end: they finish in
# the unroll and reset
START_Q = np.array([[0.0, 0.2], [0.39, 0.0], [0.0, -0.2], [0.0, 0.01]])
START_QD = np.array([[0.0, 1.0], [0.5, 0.0], [0.0, -1.0], [0.0, 0.0]])
RESET_SLOTS = 3


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _adam(state):
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
    return int(adam.count), {k: np.asarray(v) for k, v in adam.mu.items()}, {k: np.asarray(v) for k, v in adam.nu.items()}


def _jax_draws(state, config):
    """The draws of the JAX iteration from ``state``, recreated from its keys:
    action noise (T, B, A), reset noise (R, B, 4) of each env's r-th reset,
    permutations (E, T B)."""
    key = state.key
    noise = []
    for _ in range(config.unroll_length):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (config.num_envs, 1), jnp.float64))
    perms = []
    for _ in range(config.num_epochs):
        key, k_perm = jax.random.split(key)
        perms.append(jax.random.permutation(k_perm, config.unroll_length * config.num_envs))
    resets = []
    keys = list(state.env_states.key)
    for _ in range(RESET_SLOTS):
        row = []
        for b, k in enumerate(keys):
            k1, k2 = jax.random.split(k)
            _, sub = jax.random.split(k2)
            row.append(jax.random.uniform(sub, (4,), minval=-0.05, maxval=0.05))
            keys[b] = k1
        resets.append(jnp.stack(row))
    as_t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    return ppo.PPODraws(as_t(jnp.stack(noise)), as_t(jnp.stack(resets)), as_t(jnp.stack(perms)).to(torch.int64))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's start (its init at PRNGKey(0), float64, the envs
    moved to START) and two iterations, with each iteration's draws."""
    env = JaxCartpole(dtype=jnp.float64)
    config = j_ppo.PPOConfig(**CONFIG)
    nets = j_ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    init_fn, step_fn = j_ppo.make_ppo(env, nets, config)
    state = _f64(init_fn(jax.random.PRNGKey(0)))
    q, qd = jnp.asarray(START_Q), jnp.asarray(START_QD)
    state = state.replace(env_states=state.env_states.replace(q=q, qd=qd), obs=jnp.concatenate([q, qd], -1))
    states, draws, metrics = [state], [], []
    for _ in range(2):
        draws.append(_jax_draws(states[-1], config))
        new, m = step_fn(states[-1])
        states.append(new)
        metrics.append({k: float(v) for k, v in m.items()})
    return config, states, draws, metrics


def _port_state(state):
    count, mu, nu = _adam(state)
    es = state.env_states
    return ppo_state_from_numpy(
        {k: np.asarray(v) for k, v in state.params.items()}, tuple(np.asarray(x) for x in state.obs_stat),
        (np.asarray(es.q), np.asarray(es.qd), np.asarray(es.t)), np.asarray(state.obs), adam=(count, mu, nu),
        dtype=torch.float64, device="cpu",
    )


def _close(got, want, label):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=label)


def _assert_matches(port_state, metrics, jax_state, jax_metrics):
    count, mu, nu = _adam(jax_state)
    assert port_state.opt_state.count == count
    for k in ("policy", "value", "log_std"):
        _close(port_state.params[k], jax_state.params[k], f"params[{k}]")
        _close(port_state.opt_state.mu[k], mu[k], f"mu[{k}]")
        _close(port_state.opt_state.nu[k], nu[k], f"nu[{k}]")
    for name, got, want in zip(("count", "mean", "m2"), port_state.obs_stat, jax_state.obs_stat):
        _close(got, want, f"obs_stat.{name}")
    _close(port_state.env_state.q, jax_state.env_states.q, "q")
    _close(port_state.env_state.qd, jax_state.env_states.qd, "qd")
    assert np.array_equal(port_state.env_state.t.numpy(), np.asarray(jax_state.env_states.t))
    _close(port_state.obs, jax_state.obs, "obs")
    for k, v in jax_metrics.items():
        _close(metrics[k], v, k)


def _port_env():
    return CartpoleEnv(dtype=torch.float64, device="cpu")


def test_iterations_match_jax(jax_run):
    """One iteration, then a second from the port's own state, each from
    the JAX package's draws; envs finish and reset inside the unrolls."""
    config, states, draws, metrics = jax_run
    env = _port_env()
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    cfg = ppo.PPOConfig(**CONFIG)
    state = _port_state(states[0])
    resets = 0
    for i in range(2):
        state, m = ppo.ppo_iteration(env, nets, cfg, state, draws[i])
        resets += int(m["resets"])
        _assert_matches(state, m, states[i + 1], metrics[i])
    assert resets >= 3, resets


def test_an_env_that_finishes_past_its_slots_raises_and_step_fn_draws_more(jax_run):
    """Reset noise that starts env 0 past the fall: with one slot it
    finishes again and the iteration raises before any update; with slots
    appended from a generator (what step_fn's loop does) it completes."""
    config, states, draws, _ = jax_run
    env = _port_env()
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=HIDDEN)
    cfg = ppo.PPOConfig(**CONFIG)
    state = _port_state(states[0])
    falling = draws[0].reset_noise[:1].clone()
    falling[0, 0] = torch.tensor([0.0, 0.3, 0.0, 0.0], dtype=torch.float64)  # past 12 degrees: done at once
    with pytest.raises(ppo.ResetsExhausted) as e:
        ppo.ppo_iteration(env, nets, cfg, state, draws[0]._replace(reset_noise=falling))
    assert e.value.needed > 1  # env 0 falls again at every step after its first reset
    more = ppo.more_resets(env, cfg, draws[0]._replace(reset_noise=falling), torch.Generator().manual_seed(0), e.value.needed)
    assert more.reset_noise.shape[0] == e.value.needed and torch.equal(more.reset_noise[:1], falling)
    new, metrics = ppo.ppo_iteration(env, nets, cfg, state, more)
    # fresh slots drawn from the generator stand: env 0 resets once more
    assert new.iteration == 1 and 3 <= int(metrics["resets"]) < e.value.needed


@pytest.fixture
def one_thread():
    """One intra-op thread: the learning tests' many small operations run
    no faster on more, and far slower when the test workers share the
    cores; and their float sums, so the trajectories, do not depend on the
    machine's thread count."""
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


def _eval_deterministic(env, nets, state, starts=8, n=300):
    """The mean policy's 300-step return, averaged over 8 starts drawn from
    a generator seeded 123."""
    s, obs = env.reset(torch.Generator().manual_seed(123), batch_size=starts)
    total = torch.zeros(starts, dtype=obs.dtype)
    alive = torch.ones(starts, dtype=obs.dtype)
    with torch.no_grad():
        for _ in range(n):
            mean = nets.policy.apply(state.params["policy"], state.obs_stat.normalize(obs))
            s, obs, r, d = env.step(s, env.action_transform(mean))
            total += r * alive
            alive *= 1.0 - d.to(obs.dtype)
    return float(total.mean())


def test_ppo_improves_cartpole(one_thread):
    """tests/test_ppo.py's test_ppo_improves_cartpole through the port (32
    envs, 64-step unrolls, hidden (32, 32), its hyperparameters): after 40
    iterations the deterministic return, averaged over 8 starts, rises by
    more than 50 (a single start's swings with PPO's late oscillations)."""
    env = _port_env()
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(32, 32))
    cfg = ppo.PPOConfig(num_envs=32, unroll_length=64, learning_rate=1e-3, num_epochs=4, entropy_cost=1e-4, init_log_std=-1.0)
    init_fn, step_fn = ppo.make_ppo(env, nets, cfg)
    state = init_fn(0)
    before = _eval_deterministic(env, nets, state)
    for _ in range(40):
        state, metrics = step_fn(state)
    after = _eval_deterministic(env, nets, state)
    assert after > before + 50, (before, after)


def test_lr_anneal_freezes_late_policy(one_thread):
    """tests/test_ppo.py's anneal test through the port: the last of 10
    annealed iterations moves the policy far less than the first."""
    env = _port_env()
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(16, 16))
    cfg = ppo.PPOConfig(num_envs=8, unroll_length=32, learning_rate=1e-3, lr_anneal_iterations=10)
    init_fn, step_fn = ppo.make_ppo(env, nets, cfg)
    state = init_fn(0)
    p0 = state.params["policy"]
    state, _ = step_fn(state)
    early = (state.params["policy"] - p0).abs().max().item()
    for _ in range(8):
        state, _ = step_fn(state)
    before = state.params["policy"]
    state, _ = step_fn(state)
    late = (state.params["policy"] - before).abs().max().item()
    assert late < early / 5 and late < 5e-3, (early, late)
    assert ppo.learning_rate(cfg, 10 * cfg.num_epochs * cfg.num_minibatches) == 0.0


def test_checkpoints_round_trip_with_jax(tmp_path):
    """The port's PPO checkpoint reads back in the JAX package (its params
    dict, obs_stat tuple and hidden) and in the port; the JAX package's
    committed ant checkpoint reads in the port, and a checkpoint the JAX
    package writes reads back equal."""
    params, stat, hidden, meta = ppo_from_checkpoint(os.path.join(REPO, "logs", "ant_ppo", "policy.pkl"), dtype=torch.float64,
                                                     device="cpu")
    assert hidden == 64 and meta["iteration"] == 400 and params["policy"].shape == (28 * 64 + 64 + 64 * 64 + 64 + 64 * 8 + 8,)
    path = str(tmp_path / "port.pkl")
    ppo_checkpoint(path, params, stat, hidden, {"iteration": 1})
    saved, metadata = j_load_checkpoint(path)
    assert metadata == {"iteration": 1} and saved["hidden"] == 64
    for k in ("policy", "value", "log_std"):
        np.testing.assert_array_equal(saved["params"][k], params[k].numpy())
    for got, want in zip(saved["obs_stat"], stat):
        np.testing.assert_array_equal(got, want.numpy())
    jax_path = str(tmp_path / "jax.pkl")
    j_save_checkpoint(jax_path, {"params": {k: jnp.asarray(v) for k, v in saved["params"].items()},
                                 "obs_stat": j_ppo.RunningStat(*(jnp.asarray(x) for x in saved["obs_stat"])), "hidden": 64})
    back, back_stat, back_hidden, _ = ppo_from_checkpoint(jax_path, dtype=torch.float64, device="cpu")
    assert back_hidden == 64
    for k in ("policy", "value", "log_std"):
        assert torch.equal(back[k], params[k])
    assert all(torch.equal(a, b) for a, b in zip(back_stat, stat))


def test_trainer_command_line(tmp_path):
    """tools/ppo_train.py on cartpole at a tiny size on the CPU: the
    metrics finite, the best-eval checkpoint and ``.final`` written and
    read back."""
    path = str(tmp_path / "ppo.pkl")
    ppo_train.main(["--env", "cartpole", "--device", "cpu", "--num_envs", "4", "--unroll", "8", "--num_minibatches", "2",
                    "--num_epochs", "1", "--hidden", "8", "--iterations", "2", "--eval_interval", "1", "--eval_length", "20",
                    "--checkpoint", path])
    for p in (path, path + ".final"):
        params, _, hidden, metadata = ppo_from_checkpoint(p, device="cpu")
        assert hidden == 8 and all(torch.isfinite(v).all() for v in params.values()), metadata


def test_ant_replay_starts_are_the_jax_tests(optimized_jax):
    with open(os.path.join(REPO, "tests", "golden", "ant_ppo_policy_reset_noise.json")) as f:
        recorded = json.load(f)
    assert recorded["seeds"] == [0, 7, 123, 42]
    env = JaxAnt(dtype=jnp.float32)
    for seed, noise in zip(recorded["seeds"], recorded["noise"]):
        sub = jax.random.split(jax.random.PRNGKey(seed))[1]
        want = jax.random.uniform(sub, (env.action_dim,), minval=-env.reset_noise, maxval=env.reset_noise, dtype=jnp.float32)
        np.testing.assert_array_equal(np.float32(noise), np.asarray(want))
