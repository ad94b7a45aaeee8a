"""ARS on the card through the fused step kernel K2
(``LaikagoEnv(fused_step=True)``): one float64 iteration, 4 directions x
100 steps from ``policy.pkl``'s params and observation statistics, on the
card against the same on the CPU from the same draws,
within 1e-9 abs + rel (K2 float64 agrees with the CPU to ~4e-13 over 50
steps, chip_smoke.py phase 7), with K2 launched once per step for the + and
- rollouts together: settle_steps + rollout_length K2 kernels in a
torch.profiler trace of a call that replays the rollouts' CUDA graphs (a
replay calls no Python, so the wrapper's counter stays). Every test here
needs the card and skips without one. The file imports neither JAX nor the
JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ars_cuda.py -q
"""

import os

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn import ars  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-9
# a trained policy whose obs_stat has a finite m2, so that the
# normalisation divides by real stds
START_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "logs", "laikago_ars", "policy.pkl")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused step kernel has no CPU mode")
    return torch.device("cuda")


def _k2_in_trace(fn):
    """(``fn()``, K2 kernels in a torch.profiler trace of the call, K2
    wrapper launches during it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = fused_step.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    traced = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and "megastep_kernel" in e.name)
    return out, traced, fused_step.launches - before


@pytest.mark.parametrize("top_directions", [0, 2])
def test_iteration_on_the_card_matches_the_cpu(cuda_device, top_directions):
    config = ars.ARSConfig(num_directions=4, rollout_length=100, top_directions=top_directions)
    policy = MLPSpec(36, [12])
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True)
    gpu_env = LaikagoEnv(dtype=torch.float64, device=cuda_device, fused_step=True)
    gen = torch.Generator(device="cpu").manual_seed(3)
    deltas = torch.randn(config.num_directions, policy.num_parameters, generator=gen, dtype=torch.float64)
    noise = cpu_env.draw_reset_noise(gen, config.num_directions)
    saved, _ = load_checkpoint(START_CKPT)
    start = [ars_state_from_numpy(saved["params"], saved["obs_stat"], dtype=torch.float64, device=d) for d in ("cpu", cuda_device)]
    expected, expected_metrics = ars.ars_iteration(cpu_env, policy, config, start[0], deltas, noise)
    def iteration():
        return ars.ars_iteration(gpu_env, policy, config, start[1], deltas.to(cuda_device), noise.to(cuda_device))

    first, _ = iteration()  # captures the graphs
    (got, metrics), traced, wrapper = _k2_in_trace(iteration)
    assert traced == gpu_env.settle_steps + config.rollout_length and wrapper == 0
    assert torch.equal(got.params, first.params)
    pairs = [(got.params, expected.params), (got.total_timesteps, expected.total_timesteps)]
    pairs += list(zip(got.obs_stat, expected.obs_stat)) + [(metrics[k], expected_metrics[k]) for k in expected_metrics]
    for g, e in pairs:
        torch.testing.assert_close(g.cpu(), e, rtol=TOL, atol=TOL)


def test_train_step_draws_on_the_card_and_launches_k2_once_per_step(cuda_device):
    env = LaikagoEnv(dtype=torch.float32, device=cuda_device, fused_step=True)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(num_directions=8, rollout_length=30, top_directions=4)
    state = ars.init_ars(env, policy, seed=1)
    assert state.generator.device.type == "cuda"
    step_fn = ars.make_train_step(env, policy, config)
    state, _ = step_fn(state)  # captures the graphs
    (state, metrics), traced, wrapper = _k2_in_trace(lambda: step_fn(state))
    assert traced == env.settle_steps + config.rollout_length and wrapper == 0
    assert state.params.device.type == "cuda" and bool(torch.isfinite(state.params).all())
    assert all(v.device.type == "cuda" for v in metrics.values())
