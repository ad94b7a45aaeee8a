"""PPO on the card (``tds_tpu_torch.learn.ppo``), float64 and float32:

- one ant iteration (4 envs, 8-step unroll, env 0 started below the done
  height, so that its auto-reset runs inside the unroll) on the card,
  through replayed graphs and K1, against the same iteration on the CPU
  from the same draws: within 1e-9 relative in float64;
- the same iteration through graphs against ``graphs.eager()`` on the card,
  bit for bit (the unroll's buffers written in place inside the graphs);
- the committed checkpoints ``logs/ant_ppo/policy.pkl`` and
  ``policy_anneal.pkl.final`` walk on the card in float32 over 1000 steps
  from the JAX test's starts (tests/golden/ant_ppo_policy_reset_noise.json)
  at tests/test_ppo_ant_policy.py's thresholds.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ppo_cuda.py -q
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.convert import ppo_from_checkpoint  # noqa: E402
from tds_tpu_torch.envs.ant import AntEnv  # noqa: E402
from tds_tpu_torch.learn import ppo  # noqa: E402
from tds_tpu_torch.tools.ppo_train import policy_rollout  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ppo.PPOConfig(num_envs=4, unroll_length=8, num_minibatches=2, num_epochs=2, learning_rate=1e-3, lr_anneal_iterations=5,
                       init_log_std=-1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    return torch.device("cuda")


def _start(device):
    """(env, nets, state, draws) of the float64 ant on ``device`` from seed
    0, env 0 lowered to z = 0.2 (done at its first step), the draws from a
    CPU generator."""
    env = AntEnv(dtype=torch.float64, device=device)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(16, 16))
    init_fn, _ = ppo.make_ppo(env, nets, CONFIG)
    state = init_fn(0)
    cpu_env = AntEnv(dtype=torch.float64, device="cpu")
    start, obs = cpu_env.reset(torch.Generator().manual_seed(1), batch_size=CONFIG.num_envs)
    q = start.q.clone()
    q[0, 2] = 0.2
    obs = cpu_env.observation(q, start.qd)
    state = state._replace(env_state=type(start)(q.to(device), start.qd.to(device), start.t.to(device)), obs=obs.to(device))
    draws = ppo.draw_iteration(cpu_env, CONFIG, torch.Generator().manual_seed(2), torch.float64, reset_slots=2)
    return env, nets, state, draws.to(device)


def _flat(state, metrics):
    return ([state.params[k] for k in ("policy", "value", "log_std")] + [state.opt_state.mu[k] for k in ("policy", "value")]
            + [state.env_state.q, state.env_state.qd, state.obs, *state.obs_stat] + list(metrics.values()))


def test_card_iteration_matches_the_cpu(cuda_device):
    env, nets, state, draws = _start(cuda_device)
    before = pgs.launches
    got, got_metrics = ppo.ppo_iteration(env, nets, CONFIG, state, draws)
    torch.cuda.synchronize()
    assert pgs.launches > before and int(got_metrics["resets"]) >= 1
    cpu_env, _, cpu_state, cpu_draws = _start("cpu")
    want, want_metrics = ppo.ppo_iteration(cpu_env, nets, CONFIG, cpu_state, cpu_draws)
    for g, w in zip(_flat(got, got_metrics), _flat(want, want_metrics)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-9 * max(1.0, w.abs().max().item()))


def test_graph_iteration_equals_the_eager_loop(cuda_device):
    env, nets, state, draws = _start(cuda_device)
    got = _flat(*ppo.ppo_iteration(env, nets, CONFIG, state, draws))
    with graphs.eager():
        want = _flat(*ppo.ppo_iteration(env, nets, CONFIG, state, draws))
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g - w).abs().max().item()


@pytest.mark.parametrize("name,x_min,mean_min,survivors", [("policy.pkl", 4.0, 8.0, 2), ("policy_anneal.pkl.final", 8.0, 0.0, 4)])
def test_committed_checkpoint_walks(cuda_device, name, x_min, mean_min, survivors):
    """tests/test_ppo_ant_policy.py's thresholds: every start more than
    ``x_min`` m forward, the mean more than ``mean_min`` m, at least
    ``survivors`` of 4 alive for 900 of the 1000 steps."""
    params, stat, hidden, _ = ppo_from_checkpoint(os.path.join(REPO, "logs", "ant_ppo", name), device=cuda_device)
    with open(os.path.join(REPO, "tests", "golden", "ant_ppo_policy_reset_noise.json")) as f:
        noise = torch.tensor(json.load(f)["noise"], dtype=torch.float32)
    env = AntEnv(dtype=torch.float32, device=cuda_device)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(hidden, hidden))
    state, obs = env.reset(noise=noise)
    _, steps, x = policy_rollout(env, nets, params, stat, state, obs, 1000)
    dx = (x - state.q[:, 0]).cpu()
    assert torch.all(dx > x_min) and dx.mean() > mean_min, dx
    assert int((steps >= 900).sum()) >= survivors, steps
