"""One laikago ARS iteration with top_directions = 2 in the port against
the JAX package in float64, from the JAX package's own draws, on the eager
and the fused env: the helpers and the top_directions = 0 case are in
tests/test_torch_ars.py. A file of its own, so that its JAX compile (about
a minute) runs on another worker than that one's. Also the trainer on the
envs it gained last, the half-cheetah and the humanoid (with the shaping
flags on), one tiny iteration each on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_ars import check_port_iteration, jax_iteration  # noqa: E402
from tds_tpu_torch.convert import load_checkpoint  # noqa: E402
from tds_tpu_torch.tools import ars_train  # noqa: E402


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


@pytest.fixture(scope="module")
def jax_top2():
    return jax_iteration(top_directions=2)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_iteration_matches_jax(jax_top2, fused):
    check_port_iteration(jax_top2, 2, fused)


SHAPING_FLAGS = ["--height_bonus", "0.5", "--crouch_penalty", "2.0", "--crouch_ref", "1.3", "--z_damping", "0.1",
                 "--alive_bonus", "1.0"]


@pytest.mark.parametrize("env_name", ["halfcheetah", "humanoid"])
def test_trainer_on_the_new_envs(tmp_path, env_name):
    """One iteration of 1 direction (a batch of 2 rollouts) of 5 steps and
    an eval, on the CPU: finite params and metrics, the checkpoint written
    and read back; the humanoid with every shaping flag on."""
    path = str(tmp_path / "policy.pkl")
    argv = ["--device", "cpu", "--env", env_name, "--iterations", "1", "--eval_interval", "1",
            "--num_directions", "1", "--rollout_length", "5", "--checkpoint", path]
    if env_name == "humanoid":
        argv += SHAPING_FLAGS
        args = ars_train.parse_args(argv)
        env = ars_train.make_env("humanoid", "cpu", **{k: getattr(args, k) for k in ars_train.SHAPING})
        assert (env.height_bonus, env.crouch_penalty, env.crouch_ref, env.z_damping, env.alive_bonus) == (0.5, 2.0, 1.3, 0.1, 1.0)
    state, history = ars_train.main(argv)
    assert bool(torch.isfinite(state.params).all()) and state.params.abs().max() > 0
    assert len(history) == 1 and "eval_reward_min" in history[-1]
    assert all(bool(torch.isfinite(v)) for v in history[-1].values()), history[-1]
    written, meta = load_checkpoint(path)
    assert meta["iteration"] == 1 and written["params"].shape == state.params.shape
