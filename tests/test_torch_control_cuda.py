"""Control and the rest of dynamics on the card against the CPU, float64:

- the MPC walk (``tools/mpc_walk.py``'s build, batch 4, 3 ticks of 5
  substeps through graphs) within 1e-9 abs + rel on q, qd and the
  controller's torques, K1 launched in the tick graph's warm-up and
  capture and once a replayed substep in a trace;
- the laikago under spring contact (no PGS launch), ``minv_method="crba"``
  and ``delassus_dtype="bf16"``, 20 seeded steps at batch 4 within 1e-9;
  one CRBA step against ABA's within 1e-10;
- ``tests/test_spring_contact.py``'s ball: d(final z)/d(z0) over 400
  steps through the scan's VJP graph within 1e-9 of the CPU's.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_control_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.contact.spring import SpringContactParams  # noqa: E402
from tds_tpu_torch.control.mpc.locomotion import make_walk_step  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import GeomAttachment, Sphere  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.tools.mpc_walk import build  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402
from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402
from tds_tpu_torch.world import build_world, make_ground_plane, world_rollout  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


def assert_close(got, want, tol=TOL, what=""):
    err = (got.cpu() - want).abs()
    assert bool(torch.isfinite(got).all()) and (err - tol * (1 + want.abs())).max().item() <= 0, \
        f"{what}: max |cuda - cpu| {err.max().item():.3e}"


def test_mpc_walk_card_matches_the_cpu(cuda_device):
    cpu_env, cpu_ctrl = build(dtype=torch.float64, device="cpu")
    gpu_env, gpu_ctrl = build(dtype=torch.float64, device=cuda_device)
    step_c, step_g = make_walk_step(cpu_env, cpu_ctrl), make_walk_step(gpu_env, gpu_ctrl)
    state, _ = cpu_env.reset(torch.Generator().manual_seed(3), batch_size=4)
    carry_c = (cpu_ctrl.init_state(state.q), state.q, state.qd)
    carry_g = (gpu_ctrl.init_state(state.q.to(cuda_device)), state.q.to(cuda_device), state.qd.to(cuda_device))
    assert_close(gpu_ctrl.update(*carry_g)[1], cpu_ctrl.update(*carry_c)[1], what="tau")
    pgs.launches = 0
    for tick in range(3):
        carry_c, carry_g = step_c(carry_c), step_g(carry_g)
        assert_close(carry_g[1], carry_c[1], what=f"q after tick {tick + 1}")
        assert_close(carry_g[2], carry_c[2], what=f"qd after tick {tick + 1}")
    assert pgs.launches == 10  # the tick graph's warm-up and capture, 5 substeps each
    assert_close(gpu_ctrl.update(*carry_g)[1], cpu_ctrl.update(*carry_c)[1], what="tau after 3 ticks")
    _, _, _, count = counted_trace(lambda: step_g(carry_g, 2), "pgs_kernel", 10)
    assert count == 10


@pytest.mark.parametrize(
    "kwargs",
    [dict(contact_model="spring"), dict(solver=ContactSolverParams(minv_method="crba")),
     dict(solver=ContactSolverParams(delassus_dtype="bf16"))],
    ids=["spring", "crba", "bf16"],
)
def test_contact_options_card_match_the_cpu(cuda_device, kwargs):
    start = (0.0, 0.0, 0.45)
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=start, **kwargs)
    gpu_env = LaikagoEnv(dtype=torch.float64, device=cuda_device, start_base_position=start, **kwargs)
    gen = torch.Generator().manual_seed(7)
    qc, qdc = cpu_env.initial_state(gen, batch_size=4)
    qg, qdg = qc.to(cuda_device), qdc.to(cuda_device)
    before = pgs.launches
    for t in range(20):
        action = (torch.rand(4, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
        qc, qdc = cpu_env.sim_step(qc, qdc, action)
        qg, qdg = gpu_env.sim_step(qg, qdg, action.to(cuda_device))
        assert_close(qg, qc, what=f"q at step {t + 1}")
        assert_close(qdg, qdc, what=f"qd at step {t + 1}")
    assert pgs.launches - before == (0 if "contact_model" in kwargs else 20)


def test_crba_step_matches_aba(cuda_device):
    start = (0.0, 0.0, 0.45)
    aba = LaikagoEnv(dtype=torch.float64, device=cuda_device, start_base_position=start)
    crba = LaikagoEnv(dtype=torch.float64, device=cuda_device, start_base_position=start,
                      solver=ContactSolverParams(minv_method="crba"))
    q, qd = aba.initial_state(torch.Generator(device=cuda_device).manual_seed(8), batch_size=4)
    zero = torch.zeros(4, aba.action_dim, dtype=torch.float64, device=cuda_device)
    for _ in range(5):
        q, qd = aba.sim_step(q, qd, zero)
    for got, want in zip(crba.sim_step(q, qd, zero), aba.sim_step(q, qd, zero)):
        assert_close(got, want.cpu(), tol=1e-10, what="crba against aba")


def spring_final_z(device, z0):
    b = MultiBodyBuilder(is_floating=True, name="ball")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.1] * 3))
    ball = b.finalize(dtype=torch.float64, device=device)
    world = build_world([make_ground_plane(dtype=torch.float64, device=device), (ball, (GeomAttachment(link_index=-1, shape=Sphere(0.5)),))],
                        contact_model="spring", spring=SpringContactParams(spring_k=2000.0, damper_d=50.0))
    ground = z0.new_zeros(1, 0)
    q0 = torch.cat([ball.zero_q((1,))[:, :6], z0[:, None]], dim=-1)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=torch.float64, device=device)
    qs, _ = world_rollout(world, (ground, q0), (ground, ball.zero_qd((1,))), gravity, 1e-3, 400)
    return qs[1][0, 6]


def test_spring_ball_gradient_card_matches_the_cpu(cuda_device):
    z0 = torch.tensor([0.9], dtype=torch.float64, device=cuda_device, requires_grad=True)
    (grad,) = torch.autograd.grad(spring_final_z(cuda_device, z0), z0)
    cpu_z0 = torch.tensor([0.9], dtype=torch.float64, requires_grad=True)
    (cpu_grad,) = torch.autograd.grad(spring_final_z("cpu", cpu_z0), cpu_z0)
    assert len(graphs.vjp_stats()) == 1
    assert_close(grad, cpu_grad, what="d(final z)/d(z0)")
