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
  the Python loop, and the card goes on working;
- under grad, the carry's and the consts' gradients through the replayed
  graphs (the forward graph, then the one-step VJP graph in reverse) equal
  the Python loop's under autograd bit for bit in float64: a toy body, APG's
  laikago rollout return (K1's backward kernel once a replayed step) and
  the contact-gradient loss;
- under torch.func transforms, the same contact loss over 20 steps:
  ``jacfwd`` (a JVP graph of three tangents, K1's JVP kernel inside)
  within 1e-9 relative of the CPU's and of ``jacrev`` on the card (the
  VJP graph once per cotangent), ``jvp`` and ``vmap`` of a toy body equal
  to the Python loop's; forward AD through the card's scan raises.

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
from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402

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


def _traced(fn, kernel, expected):
    """(``fn()``, the kernels whose name holds ``kernel`` in the fullest of
    up to 4 torch.profiler traces of the call: ``timing.counted_trace``)."""
    _, out, _, count = counted_trace(fn, kernel, expected)
    return out, count


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
    (again, replayed), traced = _traced(lambda: _run(env, policy, stat, noise, STEPS), "pgs_kernel", env.settle_steps + STEPS)
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
    again, traced = _traced(run, "megastep_kernel", env.settle_steps + config.rollout_length)
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
    """No operand is refused under grad now: scan on the card carries the
    gradient of its carry and consts through the replayed graphs (the
    one-step VJP graph in reverse), equal bit for bit to the Python loop's
    under autograd; under torch.no_grad() it replays as before."""
    x = torch.linspace(-1.0, 1.0, 4, device=cuda_device, dtype=torch.float64, requires_grad=True)
    k = torch.full((4,), 2.0, device=cuda_device, dtype=torch.float64, requires_grad=True)

    def body(c, kk):
        # kk enters the step once: the loop's sum of its gradient over the
        # steps associates as the graphs' does (a const used twice a step
        # sums its two parts first in the graphs, into the running sum in
        # the loop, and agrees to rounding only)
        return (torch.sin(c[0]) * kk[0] + c[0] ** 2,)

    out = graphs.scan(body, (x,), (k,), 7, key="grad")
    got = torch.autograd.grad(out[0].sum(), (x, k))
    with graphs.eager():
        ref = graphs.scan(body, (x,), (k,), 7, key="grad")
        want = torch.autograd.grad(ref[0].sum(), (x, k))
    _assert_same([out[0].detach(), *got], [ref[0].detach(), *want])
    with torch.no_grad():
        assert torch.equal(graphs.scan(body, (x,), (k,), 7, key="grad")[0], out[0].detach())


def test_torch_func_transforms_through_scan(cuda_device):
    """A toy body (a carry of a vector and a step counter, a const) over 7
    steps: jvp, jacfwd, jacrev and vmap through the replayed graphs equal
    the same transforms of the Python loop within 1e-12 relative; the
    transforms' graphs are cached under keys of their own; forward AD
    raises."""
    import torch.autograd.forward_ad as fwAD

    x = torch.linspace(-1.0, 1.0, 4, device=cuda_device, dtype=torch.float64)
    k = torch.full((4,), 2.0, device=cuda_device, dtype=torch.float64)

    def body(c, kk):
        return torch.sin(c[0]) * kk[0] + 0.3 * c[0] ** 2, c[1] + 1

    def run(v, kk):
        return graphs.scan(body, (v, torch.zeros((), dtype=torch.int64, device=v.device)), (kk,), 7, key="transforms")[0]

    def close(got, want):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * max(1.0, w.abs().max().item()))

    dirs = (torch.ones_like(x), torch.linspace(0.5, 2.0, 4, device=cuda_device, dtype=torch.float64))
    got = [torch.func.jvp(run, (x, k), dirs)[1], *torch.func.jacfwd(run, argnums=(0, 1))(x, k),
           *torch.func.jacrev(run, argnums=(0, 1))(x, k), torch.func.vmap(run, in_dims=(0, None))(torch.stack([x, -x]), k)]
    with graphs.eager():
        want = [torch.func.jvp(run, (x, k), dirs)[1], *torch.func.jacfwd(run, argnums=(0, 1))(x, k),
                *torch.func.jacfwd(run, argnums=(0, 1))(x, k), torch.func.vmap(run, in_dims=(0, None))(torch.stack([x, -x]), k)]
    close(got, want)
    keys = {s.key[0] if isinstance(s.key, tuple) else s.key for s in graphs.stats()}
    assert {"transforms", "jvp", "vmap"} <= keys, keys
    with fwAD.dual_level(), pytest.raises(NotImplementedError, match="forward AD"):
        run(fwAD.make_dual(x, torch.ones_like(x)), k)


def test_jacfwd_through_a_contact_rollout_matches_the_cpu_and_jacrev(cuda_device):
    """tools/contact_loss.py's loss over 20 steps touching down at the
    first: jacfwd of (kp, mass scale, friction) on the card replays a JVP
    graph of 3 tangents (K1's JVP kernel launched in its warm-up and
    capture, once a step in a replayed call's trace) and agrees within
    1e-9 relative with the CPU's jacfwd and with jacrev on the card."""
    from tds_tpu_torch.tools import contact_loss

    def jac(device, forward=True):
        env = LaikagoEnv(dtype=torch.float64, device=device)
        q0, qd0, link = contact_loss.sliding_start(env, height=0.44)
        loss = contact_loss.make_loss(env, q0, qd0, link, 20)
        return contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, device, forward)

    before = pgs.jvp_launches
    got = jac(cuda_device)
    assert pgs.jvp_launches - before == 2  # the JVP graph's warm-up and capture
    want = jac("cpu")
    rev = jac(cuda_device, forward=False)
    assert torch.all(want != 0)
    for other in (want, rev.cpu()):
        torch.testing.assert_close(got.cpu(), other, rtol=1e-9, atol=0)


def _apg_grads(env, policy, reward, params, q0, qd0, cfg):
    from tds_tpu_torch.learn import apg

    p = params.clone().requires_grad_()
    ret = apg.rollout_return(env, policy, cfg, p, q0, qd0, reward)
    (g,) = torch.autograd.grad(ret, p)
    torch.cuda.synchronize()
    return [ret.detach(), g]


def test_gradients_equal_the_eager_loop(cuda_device):
    """APG's rollout return and its gradient (laikago, contacts active, an
    MLP, horizon 12 cut every 5 steps) through replayed graphs against the
    same loop under autograd inside graphs.eager(): equal bit for bit in
    float64. K1's backward wrapper launches in the VJP graph's warm-up and
    capture only; a trace of a replayed backward holds one backward kernel
    a step."""
    from tds_tpu_torch.learn import apg
    from tds_tpu_torch.tools.apg_train import forward_reward, make_policy

    env = LaikagoEnv(dtype=torch.float64, device=cuda_device)
    policy, reward = make_policy(env), forward_reward(env)  # one reward function: one key, one set of graphs
    params = 0.1 * policy.init(torch.Generator().manual_seed(1), dtype=torch.float64, device=cuda_device)
    state, _ = env.reset(noise=env.draw_reset_noise(torch.Generator().manual_seed(1), 3))
    q0, qd0 = state.q.clone(), state.qd
    q0[:, 2] -= 0.03  # the toes in the ground from the first step
    cfg = apg.APGConfig(horizon=12, batch=3, truncation=5)
    before = pgs.backward_launches
    got = _apg_grads(env, policy, reward, params, q0, qd0, cfg)
    assert pgs.backward_launches - before == 2  # the VJP graph's warm-up and capture
    before = pgs.backward_launches
    (again, traced) = _traced(lambda: _apg_grads(env, policy, reward, params, q0, qd0, cfg), "pgs_backward", cfg.horizon)
    assert pgs.backward_launches == before and traced == cfg.horizon
    with graphs.eager():
        want = _apg_grads(env, policy, reward, params, q0, qd0, cfg)
    _assert_same(got, want)
    _assert_same(again, want)
    assert torch.isfinite(got[1]).all() and got[1].abs().max() > 0
    vjp = [s for s in graphs.vjp_stats() if s.key[0] == "apg"]
    assert len(vjp) == 1 and vjp[0].batch == 3 and vjp[0].nodes > 1000


def test_contact_loss_gradient_equals_the_eager_loop(cuda_device):
    """The consts' gradients (kp, a link's mass scale, the friction) of
    tools/contact_loss.py's loss over 30 steps, through graphs and eager,
    bit for bit in float64."""
    from tds_tpu_torch.tools import contact_loss

    env = LaikagoEnv(dtype=torch.float64, device=cuda_device)
    q0, qd0, link = contact_loss.sliding_start(env)
    loss = contact_loss.make_loss(env, q0, qd0, link, 30)
    got = contact_loss.gradient(loss, contact_loss.POINT, torch.float64, cuda_device)
    with graphs.eager():
        want = contact_loss.gradient(loss, contact_loss.POINT, torch.float64, cuda_device)
    _assert_same(got, want)
