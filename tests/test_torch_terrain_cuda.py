"""The terrain laikago on the card: bench.py's +-2 cm heightfield (and its
mesh form) with 9 scan points, the contact MLCP (12 candidates, the 8
deepest kept: 24 rows) solved by the PGS kernel K1.

- 50 float64 steps at batch 8 against the same on the CPU within 1e-9 abs
  + rel, on the heightfield and on the mesh, K1 launched once a step;
- the reset (a pool reset among them) and a rollout through graphs equal to
  the eager loop on the card bit for bit, and one K1 a replayed step in a
  trace of it (``utils.timing.counted_trace``).

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_terrain_cuda.py -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.learn.nn import linear_policy  # noqa: E402
from tds_tpu_torch.model.geometry import Mesh  # noqa: E402
from tds_tpu_torch.rollout import rollout  # noqa: E402
from tds_tpu_torch.tools.ars_train import SCAN_GRID  # noqa: E402
from tds_tpu_torch.utils import graphs, terrain  # noqa: E402
from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-9
GRID = (13, 7, (-1.0, 5.0), (-1.5, 1.5))


def bump(x, y):
    return 0.02 * math.sin(math.pi * x) * math.cos(math.pi * y)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.fixture
def terrains(tmp_path):
    path = terrain.write_heightfield(str(tmp_path / "bench.obj"), *GRID, bump)
    return {"heightfield": terrain.make_heightfield(*GRID, bump, max_contacts=3), "mesh": Mesh(file_name=path, max_contacts=3)}


@pytest.mark.parametrize("kind", ["heightfield", "mesh"])
def test_card_matches_the_cpu_through_k1(cuda_device, terrains, kind):
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", terrain=terrains[kind], height_scan=SCAN_GRID)
    gpu_env = LaikagoEnv(dtype=torch.float64, device=cuda_device, terrain=terrains[kind], height_scan=SCAN_GRID)
    gen = torch.Generator().manual_seed(4)
    qc, qdc = cpu_env.initial_state(noise=cpu_env.draw_reset_noise(gen, 8))
    qc[:, 2] = 0.43  # the toes in the ground from the first step
    actions = (torch.rand(50, 8, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qg, qdg = qc.to(cuda_device), qdc.to(cuda_device)
    before = pgs.launches
    for t in range(50):
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
        qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].to(cuda_device))
    torch.cuda.synchronize()
    assert pgs.launches == before + 50
    for got, want in ((qg.cpu(), qc), (qdg.cpu(), qdc), (gpu_env.observation(qg, qdg).cpu(), cpu_env.observation(qc, qdc))):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_graph_rollout_equals_the_eager_loop(cuda_device, terrains):
    """The reset (half the envs from a pool of settled states) and 23 steps
    of a rollout through graphs, against the same on the card eagerly: bit
    for bit; a replayed call runs one K1 a step."""
    batch, steps = 37, 23
    plain = LaikagoEnv(dtype=torch.float64, device=cuda_device, terrain=terrains["heightfield"], height_scan=SCAN_GRID)
    start, _ = plain.reset(torch.Generator(device=cuda_device).manual_seed(1), batch_size=5)
    env = LaikagoEnv(dtype=torch.float64, device=cuda_device, terrain=terrains["heightfield"], height_scan=SCAN_GRID,
                     reset_pool=(start.q, start.qd))
    gen = torch.Generator().manual_seed(2)
    noise = env.draw_reset_noise(gen, batch)
    use, idx = env.draw_reset_pool(gen, batch)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype, device=env.device)
    with torch.no_grad():
        policy.weight.copy_(0.05 * torch.randn(policy.weight.shape, generator=gen, dtype=env.dtype))

    def run():
        state, obs = env.reset(noise=noise, pool_draws=(use, idx))
        out = rollout(env, policy, None, state, obs, steps)
        torch.cuda.synchronize()
        return [state.q, state.qd, obs, out[0].q, out[0].qd, out[1], out[2], out[3]]

    got = run()
    _, again, _, traced = counted_trace(run, "pgs_kernel", env.settle_steps + steps)
    with graphs.eager():
        want = run()
    assert 0 < int(use.sum()) < batch
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w), (g - w).abs().max().item()
    assert traced == env.settle_steps + steps
