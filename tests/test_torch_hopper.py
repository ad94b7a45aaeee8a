"""The port's hopper against the JAX package's ``HopperEnv``, float64 on the
CPU: the model and its 4 capsules, the 24-row contact solve (8 plane
candidates, no compaction) at 1e-10, reset, step, reward_done and
observation over 200 steps from the same reset noise (1e-8 up to step 100,
1e-6 after), and the trainer's ``--env hopper`` for 2 tiny iterations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_ant import TOL, check_env_matches_jax, check_model_matches_jax, check_trainer, collide_jax, collide_port  # noqa: E402
from tds_tpu.envs.hopper import HopperEnv as JaxHopper  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch.envs.hopper import HopperEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Capsule  # noqa: E402
from tds_tpu_torch.tools import ars_train  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402

URDF = "hopper_link0_1.urdf"


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


def test_contact_solve_matches_jax(envs):
    """8 candidates, 24 MLCP rows, from noisy poses 3 to 10 cm below the
    rest height with random velocities."""
    j_env, t_env = envs
    rng = np.random.default_rng(17)
    q, qd = t_env.initial_state(noise=torch.from_numpy(rng.uniform(-0.3, 0.3, (6, t_env.action_dim))))
    q[:, 1] = torch.from_numpy(rng.uniform(-0.1, -0.03, 6))
    q[:, 2] = torch.from_numpy(rng.uniform(-0.2, 0.2, 6))
    qd = torch.from_numpy(rng.normal(0.0, 0.5, (6, t_env.model.dof_qd)))
    got_qd, got_p, got_d = collide_port(t_env, q, qd)
    want_qd, want_p, want_d = collide_jax(j_env, q, qd)
    assert got_p.shape == (6, 24)
    assert (np.asarray(want_d) < 0).sum(-1).min() > 0
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=TOL, atol=TOL)


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
    with pytest.raises(NotImplementedError, match="not ported"):
        ars_train.main(["--device", "cpu", "--env", "halfcheetah"])
