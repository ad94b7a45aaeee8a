"""The rest of collision on the card, the long runs the CPU tests leave
out:

- ``tools/panda_push.py``: 1000 float32 steps of 256 scenes through a
  replayed graph, scene 0 (the example's start) pushed more than 4 cm and
  upright, K1 launched 3 times in the warm-up and 3 in the capture of the
  one-step graph, and 3 times a replayed step in a trace; 20 float64
  steps of 4 scenes in contact against the CPU within 1e-9 abs + rel;
- tests/test_mesh_contact.py's mesh-cube stack: 1200 float64 steps of 64
  cubes dropped from 1.35 m through ``world_rollout``, cube 0 at that
  test's thresholds (z within 0.03 of 1.3, |qd| < 0.1);
- ``cast_rays`` over a grid of 256 x 256 rays on a sphere, a box, a plane
  and a mesh cube, float64, against the CPU within 1e-12, ``geom_index``
  equal.

Every test here needs the card and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_collision_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.algebra.transform import Transform  # noqa: E402
from tds_tpu_torch.collision.raycast import cast_rays  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.model.geometry import Box, GeomAttachment, Mesh, Plane, Sphere  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.tools import panda_push  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402
from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402
from tds_tpu_torch.world import build_world, world_rollout  # noqa: E402

pytestmark = pytest.mark.cuda

# tests/test_mesh_contact.py's unit cube, wound outward
CUBE_OBJ = "\n".join(
    f"v {sx} {sy} {sz}" for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)
) + "\n" + "\n".join(
    f"f {a} {b} {c}"
    for a, b, c in [(1, 3, 7), (1, 7, 5), (2, 6, 8), (2, 8, 4), (1, 2, 4), (1, 4, 3),
                    (5, 7, 8), (5, 8, 6), (1, 5, 6), (1, 6, 2), (3, 4, 8), (3, 8, 7)]
) + "\n"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.fixture
def cube_file(tmp_path):
    path = tmp_path / "cube.obj"
    path.write_text(CUBE_OBJ)
    return str(path)


def test_panda_push_on_the_card(cuda_device):
    world, arm, _ = panda_push.build_scene(dtype=torch.float32, device=cuda_device)
    q0, q1 = panda_push.ik_waypoints(arm)
    box_x = panda_push.box_starts(256, 0, torch.float32, cuda_device)
    pgs.launches = 0
    qs, _, seen = panda_push.push(world, q0, q1, box_x)
    assert pgs.launches == 6  # 3 solves in the one-step graph's warm-up and capture
    moved, z = (qs[2][:, 4] - box_x).cpu(), qs[2][:, 6].cpu()
    assert moved[0] > panda_push.PUSHED and abs(z[0] - panda_push.BOX_EXTENTS[2] / 2) < 5e-3, (moved[0], z[0])
    assert len(seen) == len(panda_push.REPORT_STEPS) and bool(torch.isfinite(qs[2]).all())
    _, _, _, count = counted_trace(lambda: panda_push.push(world, q0, q1, box_x, steps=5, report=()), "pgs_kernel", 15)
    assert count == 15


def test_panda_push_card_matches_the_cpu(cuda_device):
    cpu_world, cpu_arm, _ = panda_push.build_scene(dtype=torch.float64, device="cpu")
    gpu_world, _, _ = panda_push.build_scene(dtype=torch.float64, device=cuda_device)
    q0, q1 = panda_push.ik_waypoints(cpu_arm)
    box_x = panda_push.box_starts(4, 1, torch.float64) - 0.057  # the box against the end effector from the start
    got = panda_push.push(gpu_world, q0.to(cuda_device), q1.to(cuda_device), box_x.to(cuda_device), steps=20, report=())
    want = panda_push.push(cpu_world, q0, q1, box_x, steps=20, report=())
    for g_part, w_part in zip(got[:2], want[:2]):
        for g, w in zip(g_part[1:], w_part[1:]):  # the ground's (4, 0) state holds nothing
            err = (g.cpu() - w).abs()
            assert (err - 1e-9 * (1 + w.abs())).max().item() <= 0, err.max().item()


def test_mesh_cube_stack_on_the_card(cuda_device, cube_file):
    m = Mesh(file_name=cube_file, max_contacts=4)
    b = MultiBodyBuilder(is_floating=True, name="mesh_cube_dyn")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.36 / 6.0] * 3))
    cube = b.finalize(dtype=torch.float64, device=cuda_device)
    static = MultiBodyBuilder(name="mesh_cube_static").finalize(dtype=torch.float64, device=cuda_device)
    world = build_world(
        [(static, (GeomAttachment(link_index=-1, shape=m, pos=(0.0, 0.0, 0.5), friction=0.8),)),
         (cube, (GeomAttachment(link_index=-1, shape=dataclasses.replace(m, scale=(0.6, 0.6, 0.6)), friction=0.8),))],
        solver=ContactSolverParams(friction=0.8, restitution=0.0),
    )
    q = cube.zero_q((64,))
    q[1:, 4:6] = (torch.rand(63, 2, generator=torch.Generator().manual_seed(0), dtype=torch.float64) - 0.5).to(cuda_device) * 0.1
    q[:, 6] = 1.35
    ground = q.new_zeros(64, 0)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=torch.float64, device=cuda_device)
    pgs.launches = 0
    qs, qds = world_rollout(world, (ground, q), (ground, cube.zero_qd((64,))), gravity, 1e-3, 1200)
    assert pgs.launches == 2  # the one-step graph's warm-up and capture
    assert abs(qs[1][0, 6].item() - 1.3) < 0.03 and qds[1][0].abs().max().item() < 0.1


def test_cast_rays_card_matches_the_cpu(cuda_device, cube_file):
    shapes = [Sphere(0.5), Box((0.8, 0.8, 0.8)), Plane((0.0, 0.0, 1.0), 0.0), Mesh(file_name=cube_file)]

    def placed(device):
        eye = torch.eye(3, dtype=torch.float64, device=device)
        return [Transform(pos=torch.tensor(p, dtype=torch.float64, device=device), rot=eye)
                for p in ((-0.8, 0.0, 0.5), (0.8, 0.0, 0.4), (0.0, 0.0, 0.0), (0.0, -1.2, 0.5))]

    xs = torch.linspace(-2.0, 2.0, 256, dtype=torch.float64)
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    o = torch.stack([gx, gy, torch.full_like(gx, 3.0)], -1).reshape(-1, 3)
    t = torch.stack([gx, gy, torch.full_like(gx, -1.0)], -1).reshape(-1, 3)
    got = cast_rays(o.to(cuda_device), t.to(cuda_device), shapes, placed(cuda_device))
    want = cast_rays(o, t, shapes, placed("cpu"))
    assert torch.equal(got.geom_index.cpu(), want.geom_index)
    assert (got.fraction.cpu() - want.fraction).abs().max().item() <= 1e-12
    assert set(want.geom_index.tolist()) == {0, 1, 2, 3}
