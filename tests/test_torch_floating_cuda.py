"""Floating bases on the card: the floating laikago
(``laikago/laikago_toes_zup.urdf``, 12 MLCP rows) and balls through
``world_step`` (3 rows), K1 solving every contact.

- the floating laikago's rollout through graphs equal to the eager loop
  (``graphs.eager()``) on the card bit for bit, K1 launched in the graphs'
  warm-ups and captures and once a replayed step in a trace;
- 20 float64 steps at batch 4 on the card against the CPU within 1e-9
  abs + rel;
- under ``reference_base_abi_quirk`` a scan captures a graph of its own,
  which replays the quirk, and the graph without it does not;
- ``world_rollout`` of balls through graphs equal to its eager loop bit for
  bit, the ground's (B, 0) state carried; the gradient of
  ``tools/ball_loss.py``'s loss through the scan's VJP graph equal to the
  eager loop's and within 1e-9 of the CPU's.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_floating_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import reference_base_abi_quirk  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn.nn import linear_policy  # noqa: E402
from tds_tpu_torch.rollout import rollout  # noqa: E402
from tds_tpu_torch.tools import ball_loss  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402
from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402
from tds_tpu_torch.world import world_rollout  # noqa: E402

pytestmark = pytest.mark.cuda
URDF = "laikago/laikago_toes_zup.urdf"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_floating_rollout_graphs_equal_eager(cuda_device, dtype):
    env = LaikagoEnv(urdf=URDF, is_floating=True, dtype=dtype, device=cuda_device, start_base_position=(0.0, 0.0, 0.45))
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=dtype, device=cuda_device)
    with torch.no_grad():
        policy.weight.normal_(0.0, 0.05, generator=torch.Generator(device=cuda_device).manual_seed(0))
    pgs.launches = 0
    state, obs = env.reset(batch_size=64)
    graph = rollout(env, policy, None, state, obs, 30)
    assert pgs.launches == 4  # the reset's and the rollout's warm-ups and captures
    with graphs.eager():
        eager = rollout(env, policy, None, state, obs, 30)
    for g, e in zip((*graph[0], *graph[1:]), (*eager[0], *eager[1:])):
        assert torch.equal(g, e)
    assert bool(graph[3].all()) and bool(torch.isfinite(graph[0].q).all())
    _, _, _, count = counted_trace(lambda: rollout(env, policy, None, state, obs, 5), "pgs_kernel", 5)
    assert count == 5


def test_floating_card_matches_the_cpu(cuda_device):
    start = (0.0, 0.0, 0.45)
    cpu_env = LaikagoEnv(urdf=URDF, is_floating=True, dtype=torch.float64, device="cpu", start_base_position=start)
    gpu_env = LaikagoEnv(urdf=URDF, is_floating=True, dtype=torch.float64, device=cuda_device, start_base_position=start)
    gen = torch.Generator().manual_seed(5)
    qc, qdc = cpu_env.initial_state(batch_size=4)
    qg, qdg = gpu_env.initial_state(batch_size=4)
    before = pgs.launches
    for _ in range(20):
        action = (torch.rand(4, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
        qc, qdc = cpu_env.sim_step(qc, qdc, action)
        qg, qdg = gpu_env.sim_step(qg, qdg, action.to(cuda_device))
        for got, want in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            assert ((got - want).abs() - 1e-9 * (1 + want.abs())).max() <= 0
    assert pgs.launches - before == 20


def test_the_quirk_keys_its_own_graph(cuda_device):
    env = LaikagoEnv(urdf=URDF, is_floating=True, dtype=torch.float64, device=cuda_device, start_base_position=(0.0, 0.0, 0.45))
    q, qd = env.initial_state(batch_size=2)
    zero = torch.zeros(2, env.action_dim, dtype=torch.float64, device=cuda_device)

    def body(carry, consts):
        return env.sim_step(*carry, *consts)

    key = ("quirk test", env)
    plain = graphs.scan(body, (q, qd), (zero,), 40, key=key)
    with reference_base_abi_quirk():
        quirk = graphs.scan(body, (q, qd), (zero,), 40, key=key)
        with graphs.eager():
            quirk_eager = graphs.scan(body, (q, qd), (zero,), 40, key=key)
    again = graphs.scan(body, (q, qd), (zero,), 40, key=key)
    with graphs.eager():
        plain_eager = graphs.scan(body, (q, qd), (zero,), 40, key=key)
    assert len([g for g in graphs.stats() if g.key == key]) == 2
    for a, b in zip(quirk, quirk_eager):
        assert torch.equal(a, b)
    for a, b, c in zip(plain, again, plain_eager):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (quirk[1] - plain[1]).abs().max() > 1e-9


def test_world_rollout_graphs_equal_eager(cuda_device):
    world = ball_loss.ball_world(dtype=torch.float32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q0 = world.bodies[1].zero_q((256,))
    q0[:, 6] = 0.05 + 0.3 * torch.rand(256, generator=gen, device=cuda_device)
    qd0 = torch.randn(256, 6, generator=gen, device=cuda_device)
    ground = torch.zeros(256, 0, device=cuda_device)
    gravity = torch.tensor((0.0, 0.0, -9.81), device=cuda_device)
    pgs.launches = 0
    qs, qds = world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, 200)
    assert pgs.launches == 2
    with graphs.eager():
        eqs, eqds = world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, 200)
    assert qs[0].shape == qds[0].shape == (256, 0)
    assert torch.equal(qs[1], eqs[1]) and torch.equal(qds[1], eqds[1])
    assert qs[1][:, 6].min() > ball_loss.RADIUS - 0.01


def test_ball_gradient_through_the_vjp_graph(cuda_device):
    shots = torch.tensor([ball_loss.VELOCITY, (1.2, -0.6), (0.5, 0.5)], dtype=torch.float64)
    world = ball_loss.ball_world(device=cuda_device)
    pgs.backward_launches = 0
    value, grad = ball_loss.gradient(world, shots.to(cuda_device), 60)
    assert pgs.backward_launches == 2  # the VJP graph's warm-up and capture
    with graphs.eager():
        e_value, e_grad = ball_loss.gradient(world, shots.to(cuda_device), 60)
    assert torch.equal(value, e_value) and torch.equal(grad, e_grad)
    c_value, c_grad = ball_loss.gradient(ball_loss.ball_world(device="cpu"), shots, 60)
    assert ((grad.cpu() - c_grad).abs() - 1e-9 * (1 + c_grad.abs())).max() <= 0
    assert ((value.cpu() - c_value).abs() - 1e-9 * (1 + c_value.abs())).max() <= 0
