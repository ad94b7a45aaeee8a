"""ARS in the port (tds_tpu_torch.learn.ars) on the CPU: the running
statistics and one laikago iteration against the JAX package in float64,
from a trained policy's params and observation statistics (the top-2
iteration is in tests/test_torch_ars_top.py, so that the two
JAX compiles, about a minute each, run on different workers), a diverging
env, the fused laikago env against the eager one, checkpoints both
packages read, and the trainer's command line at a tiny size. Inputs are
made from numpy seeds or recreated from the JAX package's own keys."""

import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.learn import ars as j_ars  # noqa: E402
from tds_tpu.learn.nn import linear_policy as j_linear_policy  # noqa: E402
from tds_tpu.learn.running_stat import RunningStat as JaxRunningStat  # noqa: E402
from tds_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint, save_checkpoint  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402
from tds_tpu_torch.envs.base import Env, EnvState  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn import ars  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec  # noqa: E402
from tds_tpu_torch.learn.running_stat import RunningStat  # noqa: E402
from tds_tpu_torch.tools import ars_train  # noqa: E402

LOGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "logs", "laikago_ars")
CKPT = os.path.join(LOGS, "policy_r2b.pkl")
# the parity start: a laikago policy whose obs_stat has a finite m2 (its
# stds run from 0.03 to 5.4), so that the normalisation divides by them
# (policy_r2b.pkl's m2 is NaN, read as std 1)
START_CKPT = os.path.join(LOGS, "policy.pkl")
N_DIRECTIONS, ROLLOUT_LENGTH = 4, 100
# float64, the JAX package's iteration against the port's from the same
# draws, abs + rel: 110 laikago steps (1e-8 holds over 100 steps of the
# step alone, tests/test_torch_laikago.py), summed into the rewards and
# statistics
PARITY_TOL = 1e-8


def parity_start():
    """(params, (count, mean, m2)) of START_CKPT as float64 numpy arrays."""
    saved, _ = load_checkpoint(START_CKPT)
    return np.asarray(saved["params"], np.float64), tuple(np.asarray(x, np.float64) for x in saved["obs_stat"])


def jax_iteration(top_directions):
    """The JAX package's iteration on laikago in float64 from the params
    and obs_stat of START_CKPT and the key PRNGKey(0), with the draws it
    made, recreated from its key: (new state, metrics, deltas (n, p), reset
    noise (n, 12))."""
    env = JaxLaikago(dtype=jnp.float64)
    policy = j_linear_policy(env.observation_dim, env.action_dim)
    config = j_ars.ARSConfig(num_directions=N_DIRECTIONS, rollout_length=ROLLOUT_LENGTH, top_directions=top_directions)
    params, obs_stat = parity_start()
    state = j_ars.init_ars(env, policy, jax.random.PRNGKey(0), dtype=jnp.float64).replace(
        params=jnp.asarray(params), obs_stat=JaxRunningStat(*(jnp.asarray(x) for x in obs_stat))
    )
    new_state, metrics = j_ars.make_train_step(env, policy, config)(state)
    _, k_delta, k_env = jax.random.split(state.key, 3)
    deltas = jax.random.normal(k_delta, (N_DIRECTIONS, policy.num_parameters), jnp.float64)
    noise = [
        jax.random.uniform(jax.random.split(k)[1], (env.action_dim,), jnp.float64, -env.reset_noise, env.reset_noise)
        for k in jax.random.split(k_env, N_DIRECTIONS)
    ]
    return new_state, metrics, np.array(deltas), np.stack([np.asarray(x) for x in noise])


def check_port_iteration(expected, top_directions, fused):
    """The port's iteration from the JAX package's draws agrees with its
    result, and the rollouts reached active contact rows."""
    j_state, j_metrics, deltas, noise = expected
    env = LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=fused)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(num_directions=N_DIRECTIONS, rollout_length=ROLLOUT_LENGTH, top_directions=top_directions)
    last = []
    env_step = env.step

    def recording_step(state, action):
        out = env_step(state, action)
        last[:] = [out[0].q]
        return out

    env.step = recording_step
    start = ars_state_from_numpy(*parity_start(), dtype=torch.float64, device="cpu")
    assert bool((start.obs_stat.scale() != 1).all()), "the normalisation must divide by real stds"
    state, metrics = ars.ars_iteration(env, policy, config, start, torch.from_numpy(deltas), torch.from_numpy(noise))
    pairs = [("params", state.params, j_state.params), ("total_timesteps", state.total_timesteps, j_state.total_timesteps)]
    pairs += [(f"obs_stat.{f}", getattr(state.obs_stat, f), getattr(j_state.obs_stat, f)) for f in RunningStat._fields]
    pairs += [(k, metrics[k], j_metrics[k]) for k in j_metrics]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PARITY_TOL, atol=PARITY_TOL, err_msg=name)
    assert state.iteration == 1 and float(metrics["g_hat_norm"]) > 0
    params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, device="cpu"))
    assert bool((fused_step.sphere_distances(params, last[0]) < 0).any()), "no contact row was active at step 100"


@pytest.fixture(scope="module")
def jax_top0():
    return jax_iteration(top_directions=0)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_iteration_matches_jax(jax_top0, fused):
    check_port_iteration(jax_top0, 0, fused)


def test_running_stat_matches_jax():
    """update_batch over chunks and merge, against the JAX package's
    RunningStat on tests/test_learn.py's data, at 1e-12."""
    rng = np.random.default_rng(0)
    data = rng.normal(loc=3.0, scale=2.0, size=(1000, 5))
    stat, j_stat = RunningStat.create(5, torch.float64, device="cpu"), JaxRunningStat.create(5, jnp.float64)
    for chunk in np.split(data, 10):
        stat, j_stat = stat.update_batch(torch.from_numpy(chunk)), j_stat.update_batch(jnp.asarray(chunk))
    for got, want in zip(stat, j_stat):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(stat.std.numpy(), data.std(0), rtol=1e-9)
    np.testing.assert_allclose(stat.normalize(torch.from_numpy(data[0])).numpy(), (data[0] - data.mean(0)) / data.std(0), rtol=1e-7)

    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(100, 3)), rng.normal(size=(50, 3)) + 1.0
    empty = RunningStat.create(3, torch.float64, device="cpu")
    s_ab = empty.update_batch(torch.from_numpy(a)).merge(empty.update_batch(torch.from_numpy(b)))
    j_ab = JaxRunningStat.create(3, jnp.float64).update_batch(jnp.asarray(a)).merge(
        JaxRunningStat.create(3, jnp.float64).update_batch(jnp.asarray(b))
    )
    s_all = empty.update_batch(torch.from_numpy(np.concatenate([a, b])))
    for got, want, whole in zip(s_ab, j_ab, s_all):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-9)
    merged_empty = empty.merge(empty)
    assert float(merged_empty.count) == 0 and bool(torch.isfinite(merged_empty.mean).all())


class ExplodingEnv(Env):
    """Its state turns NaN after 5 steps (tests/test_learn.py's)."""

    observation_dim = 2
    action_dim = 1
    device = torch.device("cpu")
    dtype = torch.float64

    def draw_reset_noise(self, generator=None, batch_size=1):
        return torch.zeros(batch_size, 1, dtype=self.dtype)

    def reset(self, generator=None, batch_size=1, noise=None):
        batch = batch_size if noise is None else noise.shape[0]
        zero = torch.zeros(batch, 2, dtype=self.dtype)
        return EnvState(q=zero, qd=zero, t=torch.zeros(batch, dtype=torch.int32)), zero

    def step(self, state, action):
        q = torch.where((state.t >= 5)[:, None], torch.nan, state.q + 0.1)
        done = torch.zeros(q.shape[0], dtype=torch.bool)
        return EnvState(q=q, qd=state.qd, t=state.t + 1), q, q.sum(-1), done


def test_ars_survives_nan_envs():
    env = ExplodingEnv()
    policy = MLPSpec(2, [1])
    config = ars.ARSConfig(num_directions=4, rollout_length=20, delta_std=0.1, step_size=0.1)
    step_fn = ars.make_train_step(env, policy, config)
    state = ars.init_ars(env, policy)
    for _ in range(3):
        state, metrics = step_fn(state)
    assert bool(torch.isfinite(state.params).all()) and bool(torch.isfinite(state.obs_stat.mean).all())
    assert bool(torch.isfinite(metrics["reward_pos_mean"]))
    # each rollout is alive for the 6 steps whose observations are finite,
    # the reset's and 5 steps', and counts those in the statistics
    assert int(state.total_timesteps) == float(state.obs_stat.count) == 3 * 2 * config.num_directions * 6


def test_fused_env_matches_the_eager_env():
    """LaikagoEnv(fused_step=True) on the CPU (the plain fused step) against
    the eager env: reset, then 100 steps of seeded actions, at 1e-10; the
    toes are down by then."""
    rng = np.random.default_rng(11)
    fused = LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True)
    eager = LaikagoEnv(dtype=torch.float64, device="cpu")
    assert eager.step_params is None and isinstance(fused.step_params, fused_step.StepParams)
    noise = torch.from_numpy(rng.uniform(-0.05, 0.05, (2, fused.action_dim)))
    (fs, fo), (es, eo) = fused.reset(noise=noise), eager.reset(noise=noise)
    for _ in range(100):
        action = torch.from_numpy(rng.uniform(-0.4, 0.4, (2, fused.action_dim)))
        fs, fo, fr, fd = fused.step(fs, action)
        es, eo, er, ed = eager.step(es, action)
        for got, want in ((fs.q, es.q), (fs.qd, es.qd), (fo, eo), (fr, er)):
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
        assert torch.equal(fd, ed) and torch.equal(fs.t, es.t)
    assert bool((fused_step.sphere_distances(fused.step_params, fs.q) < 0).any())


@pytest.mark.parametrize(
    "kwargs, error",
    [(dict(solver=ContactSolverParams(top_k=2)), NotImplementedError), (dict(solver=ContactSolverParams(num_friction_dir=1)), ValueError)],
    ids=["packing-refuses", "no-kernel-instance"],
)
def test_fused_env_refuses_what_the_kernel_does_not_handle(kwargs, error):
    with pytest.raises(error):
        LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True, **kwargs)


def test_checkpoints_both_packages_read(tmp_path):
    """The port's save_checkpoint is read by both packages' load_checkpoint;
    its obs_stat is a plain tuple that the JAX package's trainer turns into
    its RunningStat; the file names neither package."""
    saved, _ = load_checkpoint(CKPT)
    state = ars_state_from_numpy(saved["params"], saved["obs_stat"], seed=3, dtype=torch.float32, device="cpu")
    assert state.params.dtype == torch.float32 and state.params.shape == (444,) and state.iteration == 0
    np.testing.assert_array_equal(state.params.numpy(), np.asarray(saved["params"], np.float32))
    path = tmp_path / "policy.pkl"
    save_checkpoint(str(path), {"params": state.params, "obs_stat": state.obs_stat}, metadata={"iteration": 7})
    assert b"tds_tpu" not in path.read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
    for load in (j_load_checkpoint, load_checkpoint):
        loaded, meta = load(str(path))
        assert meta == {"iteration": 7} and type(loaded["obs_stat"]) is tuple
        np.testing.assert_array_equal(loaded["params"], state.params.numpy())
        for got, want in zip(loaded["obs_stat"], state.obs_stat):
            np.testing.assert_array_equal(got, want.numpy())
    j_stat = JaxRunningStat(*(jnp.asarray(x) for x in j_load_checkpoint(str(path))[0]["obs_stat"]))
    np.testing.assert_array_equal(np.asarray(j_stat.mean), state.obs_stat.mean.numpy())
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"state", "metadata"}


def test_trainer_writes_a_finite_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "policy.pkl")
    ars_train.main(
        ["--device", "cpu", "--iterations", "2", "--num_directions", "2", "--rollout_length", "20", "--eval_interval", "2",
         "--checkpoint", path]
    )
    written, meta = load_checkpoint(path)
    assert meta == {"iteration": 2}
    assert np.isfinite(written["params"]).all() and all(np.isfinite(x).all() for x in written["obs_stat"])
    assert np.abs(written["params"]).max() > 0
    assert load_checkpoint(path + ".best")[1]["iteration"] == 2
    assert "eval_reward_min" in capsys.readouterr().out
    # every env of the JAX trainer is ported but the terrain laikago, whose
    # flags are not: a name the trainer does not know is refused
    with pytest.raises(SystemExit):
        ars_train.main(["--device", "cpu", "--env", "cartpole"])
