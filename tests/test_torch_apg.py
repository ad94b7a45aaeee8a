"""APG in the port (``learn/apg.py``, ``learn/nn.py``) against the JAX
package's ``make_apg_train_step`` and ``MLPSpec``, float64 on the CPU.

- ``MLPSpec.apply`` for each of the eight activations, with and without a
  bias, within 1e-12;
- one and three ``train_step``s on the cartpole (horizon 40, batch 4,
  truncation 10, with and without remat; test_learn.py's smooth balance
  cost and its MLP [16, 1] with tanh): params, ``mean_return`` and
  ``grad_norm`` within 1e-9 relative. Both start from the JAX package's
  params and Adam state, and the port's step takes the start states that
  JAX's step draws (``key, sub = split(state.key)``, then ``vmap(env.reset)``
  over ``split(sub, batch)``);
- one laikago ``train_step`` (test_learn.py's setup: MLP [32, 12] with
  tanh, the forward-progress reward, horizon 30, batch 2, truncation 10)
  within 1e-8;
- the clip is optax's ``clip_by_global_norm``: below the norm the gradient
  passes as it is, above it scales by max_norm / norm;
- the checkpoint ``logs/laikago_apg/policy_h100.pkl`` loads through
  ``convert.mlp_params_from_numpy`` and acts like the JAX policy.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tds_tpu.envs.cartpole import CartpoleEnv as JaxCartpole  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.learn import apg as j_apg  # noqa: E402
from tds_tpu.learn.nn import Activation as JActivation  # noqa: E402
from tds_tpu.learn.nn import MLPSpec as JMLPSpec  # noqa: E402
from tds_tpu_torch.convert import apg_state_from_numpy, mlp_params_from_numpy  # noqa: E402
from tds_tpu_torch.envs.cartpole import CartpoleEnv  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn import apg  # noqa: E402
from tds_tpu_torch.learn.nn import Activation, MLPSpec  # noqa: E402


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("activation", list(Activation), ids=[a.name for a in Activation])
def test_mlp_apply_matches_jax(activation, use_bias):
    rng = np.random.default_rng(int(activation) + 2)
    acts = [activation, Activation.TANH, activation]
    spec = MLPSpec(5, [7, 3, 2], acts, use_bias=use_bias)
    j_spec = JMLPSpec(5, [7, 3, 2], [JActivation(int(a)) for a in acts], use_bias=use_bias)
    assert spec.num_parameters == j_spec.num_parameters
    params = rng.normal(size=(4, spec.num_parameters))
    x = 3.0 * rng.normal(size=(4, 5))
    x[0, :] = 0.0  # the kinks of relu and elu
    x[1, 0] = 40.0  # past F.softplus's threshold
    got = spec.apply(torch.from_numpy(params), torch.from_numpy(x)).numpy()
    want = np.asarray(jax.vmap(j_spec.apply)(jnp.asarray(params), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_mlp_init_schemes():
    spec = MLPSpec(6, [4, 2], use_bias=False)
    xavier = spec.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float64)
    he = spec.init(torch.Generator().manual_seed(0), scheme="he", device="cpu")
    zero = MLPSpec(6, [4, 2]).init(scheme="zero", device="cpu")
    assert xavier.shape == he.shape == (spec.num_parameters,) and xavier.dtype == torch.float64
    assert xavier[:24].abs().max() <= np.sqrt(6 / 10) and xavier.abs().min() > 0
    assert zero.shape == (6 * 4 + 4 + 4 * 2 + 2,) and not zero.any()
    with pytest.raises(ValueError):
        spec.init(scheme="lecun", device="cpu")


def _balance_cost_jax(q, qd, a):
    return -(q[1] ** 2 + 0.05 * q[0] ** 2 + 0.01 * qd[1] ** 2 + 0.001 * qd[0] ** 2 + 1e-4 * jnp.sum(a**2))


def _balance_cost(q, qd, a):
    return -(q[..., 1] ** 2 + 0.05 * q[..., 0] ** 2 + 0.01 * qd[..., 1] ** 2 + 0.001 * qd[..., 0] ** 2 + 1e-4 * (a**2).sum(-1))


def _jax_starts(env, state, batch):
    """The start states JAX's train_step draws from ``state.key``."""
    _, sub = jax.random.split(state.key)
    states, _ = jax.vmap(env.reset)(jax.random.split(sub, batch))
    return torch.from_numpy(np.array(states.q)), torch.from_numpy(np.array(states.qd))


def _init_f64(env, policy, cfg):
    """The JAX package's init_apg with its params in float64 (``MLPSpec.init``
    draws float32) and the optimizer's state made for them."""
    state, opt = j_apg.init_apg(env, policy, jax.random.PRNGKey(0), cfg)
    params = state.params.astype(jnp.float64)
    return state._replace(params=params, opt_state=opt.init(params)), opt


def _port_state(j_state):
    adam = j_state.opt_state[1][0]
    return apg_state_from_numpy(
        np.asarray(j_state.params), (int(adam.count), np.asarray(adam.mu), np.asarray(adam.nu)), dtype=torch.float64, device="cpu"
    )


def _assert_step(state, metrics, j_state, j_metrics, rtol):
    np.testing.assert_allclose(state.params.numpy(), np.asarray(j_state.params), rtol=rtol, atol=rtol * float(jnp.abs(j_state.params).max()))
    for name in ("mean_return", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]), rtol=rtol)
    adam = j_state.opt_state[1][0]
    assert state.opt_state.count == int(adam.count)
    np.testing.assert_allclose(state.opt_state.nu.numpy(), np.asarray(adam.nu), rtol=rtol, atol=rtol * float(jnp.abs(adam.nu).max()))


@pytest.mark.parametrize("remat", [True, False])
def test_cartpole_train_steps_match_jax(remat):
    j_env = JaxCartpole()
    j_policy = JMLPSpec(4, [16, 1], [JActivation.TANH, JActivation.TANH])
    cfg = dict(horizon=40, batch=4, learning_rate=2e-2, truncation=10, remat=remat)
    j_state, opt = _init_f64(j_env, j_policy, j_apg.APGConfig(**cfg))
    j_train = jax.jit(j_apg.make_apg_train_step(j_env, j_policy, j_apg.APGConfig(**cfg), reward_fn=_balance_cost_jax, opt=opt))
    env = CartpoleEnv(dtype=torch.float64, device="cpu")
    policy = MLPSpec(4, [16, 1], [Activation.TANH, Activation.TANH])
    train = apg.make_apg_train_step(env, policy, apg.APGConfig(**cfg), reward_fn=_balance_cost)
    state = _port_state(j_state)
    for _ in range(3):
        starts = _jax_starts(j_env, j_state, cfg["batch"])
        j_state, j_metrics = j_train(j_state)
        state, metrics = train(state, starts=starts)
        _assert_step(state, metrics, j_state, j_metrics, rtol=1e-9)


def test_laikago_train_step_matches_jax():
    j_env = JaxLaikago()
    j_policy = JMLPSpec(j_env.observation_dim, [32, j_env.action_dim], [JActivation.TANH, JActivation.TANH])

    def j_reward(q, qd, a):
        _, up = j_env.base_pose_xyz_rpy(q)
        return qd[0] + 0.5 * up - 1e-3 * jnp.sum(a**2)

    cfg = dict(horizon=30, batch=2, learning_rate=5e-3, truncation=10)
    j_state, opt = _init_f64(j_env, j_policy, j_apg.APGConfig(**cfg))
    starts = _jax_starts(j_env, j_state, cfg["batch"])
    j_state2, j_metrics = jax.jit(j_apg.make_apg_train_step(j_env, j_policy, j_apg.APGConfig(**cfg), reward_fn=j_reward, opt=opt))(j_state)

    from tds_tpu_torch.tools.apg_train import forward_reward, make_policy

    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    train = apg.make_apg_train_step(env, make_policy(env), apg.APGConfig(**cfg), reward_fn=forward_reward(env))
    state, metrics = train(_port_state(j_state), starts=starts)
    _assert_step(state, metrics, j_state2, j_metrics, rtol=1e-8)


def test_clip_is_optax_clip_by_global_norm():
    rng = np.random.default_rng(3)
    clip = optax.clip_by_global_norm(10.0)
    for scale in (0.1, 7.0, 300.0):
        g = scale * rng.normal(size=50)
        want, _ = clip.update(jnp.asarray(g), clip.init(jnp.asarray(g)))
        got = apg.clip_by_global_norm(torch.from_numpy(g), 10.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15, atol=0)
        if np.linalg.norm(g) < 10.0:
            assert torch.equal(got, torch.from_numpy(g))
        else:
            np.testing.assert_allclose(torch.linalg.vector_norm(got).item(), 10.0, rtol=1e-14)


def test_adam_is_optax_adam():
    rng = np.random.default_rng(4)
    adam = optax.adam(5e-3)
    params = rng.normal(size=20)
    j_state = adam.init(jnp.asarray(params))
    state = apg.adam_init(torch.from_numpy(params))
    for _ in range(4):
        g = rng.normal(size=20)
        want, j_state = adam.update(jnp.asarray(g), j_state)
        got, state = apg.adam_update(torch.from_numpy(g), state, 5e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=0)


def test_committed_apg_policy_loads():
    """policy_h100.pkl's flat vector through mlp_params_from_numpy: the
    port's MLP gives the JAX MLP's actions."""
    with open(os.path.join(REPO, "logs", "laikago_apg", "policy_h100.pkl"), "rb") as f:
        flat = pickle.load(f)["params"]
    spec = MLPSpec(36, [32, 12], [Activation.TANH, Activation.TANH])
    params = mlp_params_from_numpy(flat, dtype=torch.float64, device="cpu")
    assert params.shape == (spec.num_parameters,) == (1580,)
    obs = np.random.default_rng(5).normal(size=(8, 36))
    j_spec = JMLPSpec(36, [32, 12], [JActivation.TANH, JActivation.TANH])
    want = jax.vmap(j_spec.apply, in_axes=(None, 0))(jnp.asarray(np.asarray(flat, np.float64)), jnp.asarray(obs))
    np.testing.assert_allclose(spec.apply(params, torch.from_numpy(obs)).numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        apg_state_from_numpy(flat, (0, np.zeros(3), np.zeros(3)), device="cpu")


def test_apg_reset_golden_matches_jax(optimized_jax):
    """tests/golden/laikago_apg_reset.json holds the JAX package's
    LaikagoEnv(dtype=float32).reset(PRNGKey(5)), the start of
    test_committed_apg_policy_walks: its joint noise and settled state,
    exactly. The port's reset from that noise lands within float32
    rounding of the same state."""
    import json

    with open(os.path.join(REPO, "tests", "golden", "laikago_apg_reset.json")) as f:
        golden = json.load(f)
    env = JaxLaikago(dtype=jnp.float32)
    state, _ = env.reset(jax.random.PRNGKey(5))
    _, sub = jax.random.split(jax.random.PRNGKey(5))
    noise = jax.random.uniform(sub, (12,), minval=-0.05, maxval=0.05, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(golden["noise"], np.float32), np.asarray(noise))
    np.testing.assert_array_equal(np.asarray(golden["q"], np.float32), np.asarray(state.q))
    np.testing.assert_array_equal(np.asarray(golden["qd"], np.float32), np.asarray(state.qd))
    port = LaikagoEnv(dtype=torch.float32, device="cpu")
    t_state, _ = port.reset(noise=torch.tensor([golden["noise"]]))
    np.testing.assert_allclose(t_state.q[0].numpy(), np.asarray(state.q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_state.qd[0].numpy(), np.asarray(state.qd), rtol=1e-4, atol=1e-4)
