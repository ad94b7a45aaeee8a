"""``tds_tpu_torch.utils.graphs.scan`` on the card: the rollouts replayed as
CUDA graphs against the same rollouts run eagerly on the card
(``graphs.eager()``: ``scan_reference``, the Python loop), float64.

- laikago's and the ant's ``rollout`` at batch 37 over 23 steps, the reset's
  settle steps included, one step a graph: the same carry, bit for bit; the
  kernel wrapper counts the warm-ups' and the captures' K1 launches and no
  replay's, and a trace of a replayed call holds as many K1 kernels as the
  eager loop launched;
- the same step body in chunks of 10 steps and a remainder of 3 one-step
  replays: the same carry;
- ARS's fused rollout (K2) at batch 256 over 150 steps: a chunk of
  ``ars.FUSED_CHUNK`` steps and a remainder, the same sums, and as many K2
  kernels in a replayed call's trace as the eager loop launched;
- two calls with other params, statistics and start states each match their
  own eager run, and the second result does not alias the first; two envs
  of one class keep graphs of their own;
- a capture that fails (a host sync in the body) raises and runs nothing in
  the Python loop, and the card goes on working; under grad, an operand
  that requires grad is refused.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scan_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402
from tds_tpu_torch.envs.ant import AntEnv  # noqa: E402
from tds_tpu_torch.envs.base import EnvState  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn import ars  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec, linear_policy  # noqa: E402
from tds_tpu_torch.learn.running_stat import RunningStat  # noqa: E402
from tds_tpu_torch.rollout import rollout  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402

pytestmark = pytest.mark.cuda
BATCH, STEPS, CHUNK = 37, 23, 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: scan's graphs have no CPU mode")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


def _policy(env, seed):
    """A linear policy with small seeded weights and statistics with seeded
    means and stds."""
    gen = torch.Generator().manual_seed(seed)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype, device=env.device)
    with torch.no_grad():
        policy.weight.copy_(0.05 * torch.randn(policy.weight.shape, generator=gen, dtype=env.dtype))
        policy.bias.copy_(0.05 * torch.randn(policy.bias.shape, generator=gen, dtype=env.dtype))
    dim = env.observation_dim
    mean = 0.1 * torch.randn(dim, generator=gen, dtype=env.dtype)
    m2 = 10.0 * (0.5 + torch.rand(dim, generator=gen, dtype=env.dtype))
    return policy, RunningStat(torch.tensor(10.0, dtype=env.dtype), mean, m2).to(env.device)


def _run(env, policy, stat, noise, steps):
    """reset from ``noise`` and a rollout; returns (every output tensor,
    K1 launches counted by its wrapper)."""
    before = pgs.launches
    state, obs = env.reset(noise=noise)
    out = rollout(env, policy, stat, state, obs, steps)
    torch.cuda.synchronize()
    return [state.q, state.qd, obs, out[0].q, out[0].qd, out[0].t, out[1], out[2], out[3]], pgs.launches - before


def _traced(fn, kernel):
    """(``fn()``, the kernels whose name holds ``kernel`` in a
    torch.profiler trace of the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), (g - w).abs().max().item()


@pytest.mark.parametrize("make_env", [LaikagoEnv, AntEnv], ids=["laikago", "ant"])
def test_graph_rollout_equals_the_eager_loop(cuda_device, make_env):
    env = make_env(dtype=torch.float64, device=cuda_device)
    policy, stat = _policy(env, seed=1)
    noise = env.draw_reset_noise(torch.Generator().manual_seed(2), BATCH)
    got, captured = _run(env, policy, stat, noise, STEPS)
    (again, replayed), traced = _traced(lambda: _run(env, policy, stat, noise, STEPS), "pgs_kernel")
    with graphs.eager():
        want, eager_launches = _run(env, policy, stat, noise, STEPS)
    _assert_same(got, want)
    _assert_same(again, want)
    # the settle and the rollout graphs: a warm-up step and a one-step capture each
    assert captured == 4 and replayed == 0
    assert traced == eager_launches == env.settle_steps + STEPS
    rollouts = [s for s in graphs.stats() if s.key[0] == "rollout"]
    assert [(s.batch, s.steps) for s in rollouts] == [(BATCH, 1)] and rollouts[0].nodes > 1000


@pytest.mark.parametrize("make_env", [LaikagoEnv, AntEnv], ids=["laikago", "ant"])
def test_chunks_and_a_remainder_equal_the_eager_loop(cuda_device, make_env):
    env = make_env(dtype=torch.float64, device=cuda_device)
    policy, stat = _policy(env, seed=7)
    state, obs = env.reset(noise=env.draw_reset_noise(torch.Generator().manual_seed(7), BATCH))

    def body(carry, consts):
        q, qd, t, obs = carry
        weight, bias, mean, scale = consts
        action = env.action_transform(F.linear((obs - mean) / scale, weight, bias))
        state, obs, _, _ = env.step(EnvState(q, qd, t), action)
        return state.q, state.qd, state.t, obs

    carry = (state.q, state.qd, state.t, obs)
    consts = (policy.weight.detach(), policy.bias.detach(), stat.mean, stat.scale())
    got = graphs.scan(body, carry, consts, STEPS, key=("chunks", env), chunk=CHUNK)
    want = graphs.scan_reference(body, carry, consts, STEPS)
    _assert_same(got, want)
    assert sorted(s.steps for s in graphs.stats() if s.key[0] == "chunks") == [1, CHUNK]


def test_second_call_reads_its_own_params_stats_and_start(cuda_device):
    env = LaikagoEnv(dtype=torch.float64, device=cuda_device)
    runs = []
    for seed in (3, 4):
        policy, stat = _policy(env, seed)
        noise = env.draw_reset_noise(torch.Generator().manual_seed(seed), BATCH)
        got, _ = _run(env, policy, stat, noise, STEPS)
        runs.append((policy, stat, noise, [t.clone() for t in got], got))
    for policy, stat, noise, copy, got in runs:
        with graphs.eager():
            want, _ = _run(env, policy, stat, noise, STEPS)
        _assert_same(copy, want)
        _assert_same(got, want)  # the second call left the first's results alone
    first, second = runs[0][4], runs[1][4]
    assert not torch.equal(first[3], second[3])
    assert {t.data_ptr() for t in first}.isdisjoint(t.data_ptr() for t in second)


def test_envs_of_one_class_keep_graphs_of_their_own(cuda_device):
    standing = LaikagoEnv(dtype=torch.float64, device=cuda_device)
    lowered = LaikagoEnv(dtype=torch.float64, device=cuda_device, start_base_position=(0.0, 0.0, 0.45), kp=80.0)
    policy, stat = _policy(standing, seed=5)
    noise = standing.draw_reset_noise(torch.Generator().manual_seed(5), BATCH)
    got = [_run(env, policy, stat, noise, STEPS)[0] for env in (standing, lowered)]
    with graphs.eager():
        want = [_run(env, policy, stat, noise, STEPS)[0] for env in (standing, lowered)]
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert not torch.equal(got[0][3], got[1][3])


def test_fused_ars_rollout_equals_the_eager_loop(cuda_device):
    env = LaikagoEnv(dtype=torch.float64, device=cuda_device, fused_step=True)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(num_directions=128, rollout_length=150, shift=0.5)
    gen = torch.Generator().manual_seed(6)
    params = (0.05 * torch.randn(256, policy.num_parameters, generator=gen, dtype=env.dtype)).to(cuda_device)
    _, stat = _policy(env, seed=6)
    noise = env.draw_reset_noise(gen, 256)

    def run():
        out = ars._rollout_with_stats(env, policy, params, stat, noise, config)
        torch.cuda.synchronize()
        return [out[0], out[1], *out[2]]

    got = run()
    before = fused_step.launches
    again, traced = _traced(run, "megastep_kernel")
    replayed = fused_step.launches - before
    with graphs.eager():
        before = fused_step.launches
        want = run()
        eager_launches = fused_step.launches - before
    _assert_same(got, want)
    _assert_same(again, want)
    assert replayed == 0 and traced == eager_launches == env.settle_steps + config.rollout_length
    steps = sorted(s.steps for s in graphs.stats() if s.key[0] == "ars_rollout")
    assert steps == [1, ars.FUSED_CHUNK] and config.rollout_length % ars.FUSED_CHUNK  # a chunk and a remainder


def test_a_failed_capture_raises_and_runs_nothing_eagerly(cuda_device):
    calls = []

    def syncing(carry, consts):
        calls.append(1)
        (x,) = carry
        if x.sum().item() > 1e30:  # a host sync: the capture cannot record it
            x = x * 0
        return (x + 1,)

    with pytest.raises(RuntimeError):
        graphs.scan(syncing, (torch.zeros(4, device=cuda_device),), (), 50, key="syncing")
    assert len(calls) == 2  # the warm-up and the capture, no step of a Python loop
    assert not any(s.key == "syncing" for s in graphs.stats())
    out = graphs.scan(lambda c, k: (c[0] + k[0],), (torch.zeros(4, device=cuda_device),), (torch.ones(4, device=cuda_device),), 50, key="adding")
    assert out[0].tolist() == [50.0] * 4


def test_an_operand_that_requires_grad_is_refused(cuda_device):
    x = torch.zeros(4, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        graphs.scan(lambda c, k: (c[0] + 1,), (x,), (), 3, key="grad")
    with torch.no_grad():
        assert graphs.scan(lambda c, k: (c[0] + 1,), (x,), (), 3, key="grad")[0].tolist() == [3.0] * 4
