"""The ant, the hopper, the half-cheetah and the humanoid on the card, their
contact MLCP (24, 24, 48 and 105 rows) solved by the PGS kernel K1: 10
float64 steps at batch 8 against the same on the CPU within 1e-9 abs + rel,
with K1 launched once per step; and the ant without ``top_k`` compaction
(51 rows, which K1's warp per env solves since K1 takes any row count)
against the CPU, without the plain version running on the card. Every test here needs the card and
skips without one. The file imports neither JAX nor the JAX package, so on
a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ant_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.envs.ant import AntEnv  # noqa: E402
from tds_tpu_torch.envs.hopper import HalfCheetahEnv, HopperEnv  # noqa: E402
from tds_tpu_torch.envs.humanoid import HumanoidEnv  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    return torch.device("cuda")


def _lowered(env, batch, seed):
    """Reset noise and base heights where the ant's torso or the other
    robots' feet are in contact from the first step (half the ants on the
    torso, where the compaction drops candidates; the half-cheetah's and the
    humanoid's feet rest 7.6 and 7.45 cm above the ground)."""
    gen = torch.Generator().manual_seed(seed)
    q, qd = env.initial_state(noise=env.draw_reset_noise(gen, batch))
    if isinstance(env, AntEnv):
        q[: batch // 2, 2] = 0.05
        q[batch // 2 :, 2] = 0.35
    elif isinstance(env, HumanoidEnv):
        q[:, 2] = 1.31
    else:
        q[:, 1] = -0.12 if isinstance(env, HalfCheetahEnv) else -0.05
    return q, qd, gen


@pytest.mark.parametrize("make_env", [AntEnv, HopperEnv, HalfCheetahEnv, HumanoidEnv],
                         ids=["ant", "hopper", "halfcheetah", "humanoid"])
def test_card_matches_the_cpu_through_k1(cuda_device, make_env):
    cpu_env = make_env(dtype=torch.float64, device="cpu")
    gpu_env = make_env(dtype=torch.float64, device=cuda_device)
    qc, qdc, gen = _lowered(cpu_env, 8, seed=4)
    qg, qdg = qc.to(cuda_device), qdc.to(cuda_device)
    actions = (torch.rand(10, 8, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    for t in range(10):
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
    before = pgs.launches
    for t in range(10):
        qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].to(cuda_device))
    torch.cuda.synchronize()
    assert pgs.launches == before + 10
    for got, want in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_ant_without_compaction_is_refused_on_the_card(cuda_device, monkeypatch):
    """Refused no longer: K1 takes any row count. The 51-row ant steps on
    the card through one K1 launch, never through the plain version there,
    and matches the CPU's step in float64."""
    cpu_env = AntEnv(dtype=torch.float64, device="cpu", solver=ContactSolverParams(top_k=0))
    env = AntEnv(dtype=torch.float64, device=cuda_device, solver=ContactSolverParams(top_k=0))
    q, qd, _ = _lowered(cpu_env, 4, seed=5)
    want_q, want_qd = cpu_env.sim_step(q, qd, torch.zeros(4, env.action_dim, dtype=torch.float64))

    def refuse(*args, **kwargs):
        raise AssertionError("the plain PGS ran on a CUDA tensor")

    monkeypatch.setattr(pgs, "solve_pgs_reference", refuse)
    before = pgs.launches
    got_q, got_qd = env.sim_step(q.to(cuda_device), qd.to(cuda_device), torch.zeros(4, env.action_dim, dtype=torch.float64, device=cuda_device))
    torch.cuda.synchronize()
    assert pgs.launches == before + 1
    torch.testing.assert_close(got_q.cpu(), want_q, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_qd.cpu(), want_qd, rtol=TOL, atol=TOL)
