"""The port's hopper and half-cheetah against the JAX package's
``HopperEnv`` and ``HalfCheetahEnv``, float64 on the CPU: the models and
their capsules (4 and 8), the contact solves (24 and 48 rows: 8 and 16
plane candidates, no compaction) at 1e-10, reset, step, reward_done and
observation over 200 steps from the same reset noise (1e-8 up to step 100,
1e-6 after), and the trainer's ``--env hopper`` for 2 tiny iterations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_ant import TOL, check_env_matches_jax, check_model_matches_jax, check_trainer, collide_jax, collide_port  # noqa: E402
from tds_tpu.envs.hopper import HalfCheetahEnv as JaxHalfCheetah  # noqa: E402
from tds_tpu.envs.hopper import HopperEnv as JaxHopper  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch.envs.hopper import HalfCheetahEnv, HopperEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Capsule  # noqa: E402
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

URDF = "hopper_link0_1.urdf"
CHEETAH_URDF = "cheetah_link0_1.urdf"


@pytest.fixture(scope="module")
def envs():
    return JaxHopper(dtype=jnp.float64), HopperEnv(dtype=torch.float64, device="cpu")


def test_model_and_geoms_match_jax():
    j_model, j_geoms = j_construct(URDF, dtype=jnp.float64)
    t_model, t_geoms = construct(URDF)
    check_model_matches_jax((j_model, j_geoms, t_model, t_geoms))
    assert (t_model.dof_q, t_model.num_links) == (6, 10)
    assert [type(g.shape) for g in t_geoms] == [Capsule] * 4


def test_env_defaults(envs):
    _, env = envs
    assert (env.kp, env.kd, env.max_force, env.dt, env.skip_links) == (50.0, 1.0, 30.0, 2e-3, 3)
    assert env.action_dim == 3 and env.pd_q_indices() == (3, 4, 5)
    assert env.world.solver.top_k == 0


def check_contact_solve(j_env, t_env, rows, z_range=(-0.1, -0.03)):
    """``rows`` MLCP rows, from noisy poses below the rest height (the base's
    z in ``z_range``: 3 to 10 cm for the hopper, whose feet rest 4 cm above
    the ground) with random velocities."""
    rng = np.random.default_rng(17)
    q, qd = t_env.initial_state(noise=torch.from_numpy(rng.uniform(-0.3, 0.3, (6, t_env.action_dim))))
    q[:, 1] = torch.from_numpy(rng.uniform(*z_range, 6))
    q[:, 2] = torch.from_numpy(rng.uniform(-0.2, 0.2, 6))
    qd = torch.from_numpy(rng.normal(0.0, 0.5, (6, t_env.model.dof_qd)))
    got_qd, got_p, got_d = collide_port(t_env, q, qd)
    want_qd, want_p, want_d = collide_jax(j_env, q, qd)
    assert got_p.shape == (6, rows)
    assert (np.asarray(want_d) < 0).sum(-1).min() > 0
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=TOL, atol=TOL)


def test_contact_solve_matches_jax(envs):
    """8 candidates, 24 MLCP rows."""
    check_contact_solve(*envs, rows=24)


def test_env_matches_jax_for_200_steps(envs):
    check_env_matches_jax(*envs, seed=8)


def test_reward_done(envs):
    j_env, t_env = envs
    rng = np.random.default_rng(2)
    q_prev = rng.normal(0.0, 0.1, (4, 6))
    q = q_prev + rng.normal(0.0, 0.01, (4, 6))
    q[:, 1] = (0.0, -0.4, 0.0, 0.0)  # alive, too low, tilted, alive
    q[:, 2] = (0.1, 0.0, -1.2, 0.9)
    j_reward, j_done = j_env.reward_done(*(jnp.asarray(x) for x in (q_prev, q_prev, q, q)))
    t_reward, t_done = t_env.reward_done(*(torch.from_numpy(x) for x in (q_prev, q_prev, q, q)))
    assert t_done.tolist() == [False, True, True, False]
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=TOL, atol=TOL)


def test_trainer_on_the_hopper(tmp_path):
    check_trainer("hopper", tmp_path)
    assert ars_train.parse_args(["--env", "hopper"]).checkpoint == "./logs/hopper_ars/policy_torch.pkl"
    # every env of the JAX trainer is ported: an unknown name is refused by
    # the argument parser
    with pytest.raises(SystemExit):
        ars_train.parse_args(["--env", "cartpole"])


# -- the half-cheetah ---------------------------------------------------------
@pytest.fixture(scope="module")
def cheetah_envs():
    return JaxHalfCheetah(dtype=jnp.float64), HalfCheetahEnv(dtype=torch.float64, device="cpu")


def test_cheetah_model_and_geoms_match_jax():
    j_model, j_geoms = j_construct(CHEETAH_URDF, dtype=jnp.float64)
    t_model, t_geoms = construct(CHEETAH_URDF)
    check_model_matches_jax((j_model, j_geoms, t_model, t_geoms))
    assert (t_model.dof_q, t_model.num_links) == (9, 16)
    assert [type(g.shape) for g in t_geoms] == [Capsule] * 8


def test_cheetah_env_defaults(cheetah_envs):
    _, env = cheetah_envs
    assert (env.kp, env.kd, env.max_force, env.dt, env.skip_links) == (60.0, 1.5, 60.0, 2e-3, 3)
    assert env.action_dim == 6 and env.pd_q_indices() == (3, 4, 5, 6, 7, 8)
    assert env.world.solver.top_k == 0


def test_cheetah_contact_solve_matches_jax(cheetah_envs):
    """16 candidates, 48 MLCP rows; the feet rest 7.6 cm above the ground,
    so the base goes 10 to 18 cm below its rest height."""
    check_contact_solve(*cheetah_envs, rows=48, z_range=(-0.18, -0.1))


def test_cheetah_env_matches_jax_for_200_steps(cheetah_envs):
    check_env_matches_jax(*cheetah_envs, seed=9)


def test_cheetah_reward_done(cheetah_envs):
    j_env, t_env = cheetah_envs
    rng = np.random.default_rng(4)
    q_prev = rng.normal(0.0, 0.1, (4, 9))
    q = q_prev + rng.normal(0.0, 0.01, (4, 9))
    q[:, 1] = (0.0, -0.45, -0.3, 0.2)  # alive, too low, alive, alive
    j_reward, j_done = j_env.reward_done(*(jnp.asarray(x) for x in (q_prev, q_prev, q, q)))
    t_reward, t_done = t_env.reward_done(*(torch.from_numpy(x) for x in (q_prev, q_prev, q, q)))
    assert t_done.tolist() == [False, True, False, False]
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=TOL, atol=TOL)
