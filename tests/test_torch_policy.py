"""The trained laikago policy carried into the port: its checkpoint loads
without the JAX package, gives the JAX policy's actions at 1e-12 (float64),
and drives the port's rollout as the JAX env does; and importing the whole
port pulls in neither jax nor tds_tpu."""

import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.learn.nn import linear_policy as j_linear_policy  # noqa: E402
from tds_tpu.learn.running_stat import RunningStat as JaxRunningStat  # noqa: E402
from tds_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy  # noqa: E402
from tds_tpu_torch.envs.base import EnvState  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec, linear_policy  # noqa: E402
from tds_tpu_torch.learn.running_stat import RunningStat  # noqa: E402
from tds_tpu_torch.rollout import rollout  # noqa: E402


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "logs", "laikago_ars", "policy_r2b.pkl")
TOL = 1e-12


@pytest.fixture(scope="module")
def saved():
    state, _ = load_checkpoint(CKPT)
    return state


def _jax_policy(state):
    params = jnp.asarray(np.asarray(state["params"]), jnp.float64)
    stat = JaxRunningStat(*(jnp.asarray(np.asarray(x), jnp.float64) for x in state["obs_stat"]))
    return params, stat


def test_checkpoint_loads_like_the_jax_package(saved):
    j_state, j_meta = j_load_checkpoint(CKPT)
    _, meta = load_checkpoint(CKPT)
    assert meta == j_meta
    assert isinstance(saved["obs_stat"], RunningStat)
    np.testing.assert_array_equal(saved["params"], j_state["params"])
    for got, expected in zip(saved["obs_stat"], j_state["obs_stat"]):
        np.testing.assert_array_equal(got, expected)


def test_policy_actions_match_jax(saved):
    obs = np.random.default_rng(0).normal(size=(16, 36)) * 0.5
    params, stat = _jax_policy(saved)
    expected = j_linear_policy(36, 12).apply(params, stat.normalize(jnp.asarray(obs)))
    policy, t_stat = policy_from_numpy(saved["params"], saved["obs_stat"], device="cpu")
    with torch.no_grad():
        got = policy(t_stat.normalize(torch.from_numpy(obs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
    flat = MLPSpec(36, [12]).apply(torch.from_numpy(np.asarray(saved["params"], np.float64)), t_stat.normalize(torch.from_numpy(obs)))
    np.testing.assert_allclose(flat.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(policy.flat().numpy(), np.asarray(saved["params"], np.float64))


def test_policy_from_numpy_needs_a_width():
    """The observation width comes from obs_stat; parameters that do not
    form a linear layer of that width are refused."""
    stat = (np.array(3.0), np.zeros(36), np.ones(36))
    with pytest.raises(ValueError):
        policy_from_numpy(np.zeros(36 * 12 + 11), stat, device="cpu")
    policy, t_stat = policy_from_numpy(np.zeros(36 * 12 + 12), stat, dtype=torch.float32, device="cpu")
    assert (policy.in_features, policy.out_features) == (36, 12)
    assert policy.weight.dtype == t_stat.mean.dtype == torch.float32
    assert policy.weight.device.type == t_stat.mean.device.type == "cpu"


@pytest.mark.parametrize("entry", ["linear_policy", "policy_from_numpy"])
def test_policy_entry_points_default_to_the_card(entry):
    """Like LaikagoEnv, both policy entry points run on the card unless the
    caller names another device, and raise rather than fall back to the CPU."""
    stat = (np.array(3.0), np.zeros(36), np.ones(36))
    make = {
        "linear_policy": lambda: linear_policy(36, 12),
        "policy_from_numpy": lambda: policy_from_numpy(np.zeros(36 * 12 + 12), stat)[0],
    }[entry]
    if torch.cuda.is_available():
        assert make().weight.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_rollout_matches_jax(saved):
    """20 steps of the trained policy from the same reset, batch 2."""
    steps, batch = 20, 2
    j_env = JaxLaikago(dtype=jnp.float64)
    params, stat = _jax_policy(saved)
    policy = j_linear_policy(j_env.observation_dim, j_env.action_dim)
    keys = jax.random.split(jax.random.PRNGKey(4), batch)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)

    @jax.jit
    def j_step(st, obs, total, alive):
        action = jax.vmap(lambda o: policy.apply(params, stat.normalize(o)))(obs)
        st, obs, reward, done = jax.vmap(j_env.step)(st, action)
        return st, obs, total + reward * alive, alive * (1.0 - done.astype(obs.dtype))

    t_env = LaikagoEnv(dtype=torch.float64, device="cpu")
    t_state = EnvState(
        q=torch.from_numpy(np.array(j_state.q)), qd=torch.from_numpy(np.array(j_state.qd)), t=torch.zeros(batch, dtype=torch.int32)
    )
    t_policy, t_stat = policy_from_numpy(saved["params"], saved["obs_stat"], device="cpu")
    t_state, t_obs, t_total, t_alive = rollout(t_env, t_policy, t_stat, t_state, torch.from_numpy(np.array(j_obs)), steps)

    total, alive = jnp.zeros(batch), jnp.ones(batch)
    for _ in range(steps):
        j_state, j_obs, total, alive = j_step(j_state, j_obs, total, alive)
    for got, expected in ((t_state.q, j_state.q), (t_obs, j_obs), (t_total, total), (t_alive, alive)):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-9, atol=1e-9)
    assert t_state.t.tolist() == [steps] * batch


def test_checkpoint_refuses_other_jax_package_globals(tmp_path):
    path = tmp_path / "bad.pkl"
    path.write_bytes(b"ctds_tpu.envs.laikago\nLaikagoEnv\n.")
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(path))


def test_port_imports_neither_jax_nor_the_jax_package():
    script = f"""
import importlib, pkgutil, sys
import tds_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tds_tpu_torch.__path__, "tds_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
state, _ = load_checkpoint({CKPT!r})
policy_from_numpy(state["params"], state["obs_stat"], device="cpu")
bad = sorted(m for m in sys.modules if m in ("jax", "flax", "tds_tpu") or m.startswith(("jax.", "flax.", "tds_tpu.")))
assert not bad, bad
assert "tds_tpu_torch.contact.pgs" in names and len(names) > 25, names
assert set(("tds_tpu_torch.envs.fused_step", "tds_tpu_torch.tools.megastep", "tds_tpu_torch.tools.kernel_probe", "tds_tpu_torch.utils.op_count")) <= set(names), names
assert set(("tds_tpu_torch.learn.ars", "tds_tpu_torch.envs.cartpole", "tds_tpu_torch.tools.ars_train")) <= set(names), names
assert set(("tds_tpu_torch.envs.ant", "tds_tpu_torch.envs.hopper")) <= set(names), names
assert set(("tds_tpu_torch.utils.obj", "tds_tpu_torch.utils.terrain", "tds_tpu_torch.collision.raycast")) <= set(names), names
assert set(("tds_tpu_torch.learn.apg", "tds_tpu_torch.utils.diff", "tds_tpu_torch.utils.estimation", "tds_tpu_torch.model.pendulum", "tds_tpu_torch.tools.apg_train", "tds_tpu_torch.tools.contact_loss")) <= set(names), names
assert set(("tds_tpu_torch.learn.ppo", "tds_tpu_torch.tools.ppo_train", "tds_tpu_torch.utils.neural_augmentation", "tds_tpu_torch.envs.vectorized", "tds_tpu_torch.envs.reacher", "tds_tpu_torch.envs.domain_randomization", "tds_tpu_torch.envs.gym_wrapper")) <= set(names), names
assert set(("tds_tpu_torch.compat", "tds_tpu_torch.parallel.distributed", "tds_tpu_torch.parallel.mesh", "tds_tpu_torch.utils.experiment", "tds_tpu_torch.utils.motion_import", "tds_tpu_torch.utils.profiling", "tds_tpu_torch.utils.debug", "tds_tpu_torch.utils.dataset", "tds_tpu_torch.visualizer.renderer", "tds_tpu_torch.visualizer.meshcat", "tds_tpu_torch.tools.mocap_track")) <= set(names), names
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
