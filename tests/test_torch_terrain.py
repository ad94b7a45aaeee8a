"""The port's terrain pieces against the JAX package's, float64 on the CPU:

- ``heightfield_obj``'s text byte for byte, ``make_heightfield``'s heights,
  and the OBJ reader against ``tds_tpu.native.mesh.load_obj``, exactly;
- ``sphere_heightfield``, ``capsule_heightfield``, ``sphere_mesh``,
  ``capsule_mesh``, ``plane_mesh`` and ``heightfield_height`` at 1e-12 abs
  + rel, every ``Contact`` field in the same candidate order, on 200
  centres over the grid (drawn as tests/test_heightfield.py draws them),
  20 centres within a cell of a border, and centres over grid vertices,
  where several triangles share the nearest point (a tie of distances);
- ``ray_mesh`` at 1e-12, misses equal to ``BIG``;
- the port's own oracle at 1e-12: its heightfield pairs against its mesh
  pairs on one surface, its heights against its rays;
- the height scan's geometry (tests/test_terrain.py:98-144), the fused
  step's refusal of a terrain, the trainer's terrain flags and refusals,
  and the JAX reset draws that chip_smoke.py replays the terrain policies
  from (tests/golden/laikago_terrain_policy_reset_noise.json).

The terrain env's trajectories against the JAX package's are in
tests/test_torch_terrain_env.py, so that their JAX compiles run on another
worker.
"""

import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.algebra.transform import Transform as JTransform  # noqa: E402
from tds_tpu.collision import narrowphase as j_narrowphase  # noqa: E402
from tds_tpu.collision import raycast as j_raycast  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.model import geometry as j_geometry  # noqa: E402
from tds_tpu.native.mesh import load_obj as j_load_obj  # noqa: E402
from tds_tpu.utils import terrain as j_terrain  # noqa: E402
from tds_tpu_torch import world as t_world  # noqa: E402
from tds_tpu_torch.algebra.rotation import from_rpy  # noqa: E402
from tds_tpu_torch.algebra.transform import Transform  # noqa: E402
from tds_tpu_torch.collision import narrowphase  # noqa: E402
from tds_tpu_torch.collision.raycast import BIG, ray_mesh  # noqa: E402
from tds_tpu_torch.convert import load_checkpoint  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links  # noqa: E402
from tds_tpu_torch.envs.laikago import LAIKAGO_INITIAL_POSES, LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Capsule, Heightfield, Mesh, Plane, Sphere  # noqa: E402
from tds_tpu_torch.tools import ars_train  # noqa: E402
from tds_tpu_torch.utils import obj, terrain  # noqa: E402


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


@pytest.fixture
def optimized_jax():
    """The JAX package's default compiles for one test, whose JAX draws are
    held bit for bit to recorded ones (this file's reference otherwise
    compiles without XLA's optimisation passes, which moves a float32 draw
    by an ulp)."""
    jax.config.update("jax_disable_most_optimizations", False)
    jax.clear_caches()  # jit's caches ignore the flag: compile the draws anew
    yield
    jax.config.update("jax_disable_most_optimizations", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "laikago_terrain_policy_reset_noise.json")
TOL = 1e-12

# tests/test_heightfield.py's grid, and bench.py's terrain
NX, NY = 9, 7
XR, YR = (-1.0, 3.0), (-1.5, 1.5)


def h_fn(x, y):
    return 0.08 * math.sin(2.0 * x) * math.cos(1.5 * y) + 0.03 * y


def bench_fn(x, y):
    return 0.02 * math.sin(math.pi * x) * math.cos(math.pi * y)


GRIDS = {"test_heightfield-9x7": (NX, NY, XR, YR, h_fn), "bench-13x7": (13, 7, (-1.0, 5.0), (-1.5, 1.5), bench_fn)}


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """(port Heightfield, port Mesh, JAX Heightfield, JAX Mesh) on
    test_heightfield.py's grid, max_contacts 3, and the flat grid's pair."""
    out = {}
    for name, fn in (("sine", h_fn), ("flat", lambda x, y: 0.0)):
        path = str(tmp_path_factory.mktemp("terrain") / f"{name}.obj")
        terrain.write_heightfield(path, NX, NY, XR, YR, fn)
        out[name] = (
            terrain.make_heightfield(NX, NY, XR, YR, fn, max_contacts=3),
            Mesh(file_name=path, max_contacts=3),
            j_terrain.make_heightfield(NX, NY, XR, YR, fn, max_contacts=3),
            j_geometry.Mesh(file_name=path, max_contacts=3),
        )
    return out


def _centres(fn, xs, ys, zs):
    return np.stack([xs, ys, np.array([fn(x, y) for x, y in zip(xs, ys)]) + zs], axis=-1)


def interior_centres():
    """test_heightfield.py:55-62: 200 centres over the grid's interior,
    -1 to 15 cm above the surface."""
    rng = np.random.default_rng(0)
    n = 200
    xs = rng.uniform(XR[0] + 0.3, XR[1] - 0.3, n)
    ys = rng.uniform(YR[0] + 0.3, YR[1] - 0.3, n)
    return _centres(h_fn, xs, ys, rng.uniform(-0.01, 0.15, n))


def border_centres():
    """20 centres within one cell of the grid's edges and corners, 4 of them
    just off the grid."""
    rng = np.random.default_rng(1)
    dx, dy = (XR[1] - XR[0]) / (NX - 1), (YR[1] - YR[0]) / (NY - 1)
    xs = np.concatenate([rng.uniform(XR[0], XR[0] + dx, 4), rng.uniform(XR[1] - dx, XR[1], 4), rng.uniform(*XR, 8),
                         [XR[0] - 0.05, XR[1] + 0.05, XR[0] + 0.01, XR[1] - 0.01]])
    ys = np.concatenate([rng.uniform(*YR, 8), rng.uniform(YR[0], YR[0] + dy, 4), rng.uniform(YR[1] - dy, YR[1], 4),
                         [YR[0] + 0.01, YR[1] - 0.01, YR[0] - 0.05, YR[1] + 0.05]])
    return _centres(h_fn, xs, ys, rng.uniform(0.0, 0.06, 20))


def vertex_centres(fn):
    """Centres 2 cm over grid vertices: on the flat grid every triangle
    around the vertex returns the vertex itself, a tie of distances."""
    xs = np.array([XR[0] + (XR[1] - XR[0]) * i / (NX - 1) for i in (1, 3, 4, 6, 0, 8)])
    ys = np.array([YR[0] + (YR[1] - YR[0]) * j / (NY - 1) for j in (1, 2, 3, 5, 0, 6)])
    return _centres(fn, xs, ys, np.full(6, 0.02))


def random_rotations(n, seed):
    rpy = np.random.default_rng(seed).uniform(-math.pi, math.pi, (n, 3))
    return from_rpy(*torch.from_numpy(rpy).unbind(-1)).numpy()


def port_x(pos, rot=None):
    pos = torch.as_tensor(pos, dtype=torch.float64)
    rot = torch.eye(3, dtype=torch.float64).expand(*pos.shape[:-1], 3, 3) if rot is None else torch.as_tensor(rot)
    return Transform(pos=pos, rot=rot)


def jax_x(pos, rot=None):
    pos = jnp.asarray(pos, jnp.float64)
    rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float64), pos.shape[:-1] + (3, 3)) if rot is None else jnp.asarray(rot)
    return JTransform(pos=pos, rot=rot)


def assert_contacts_equal(got, want, what):
    for field in got._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {field}")


# -- terrain text and the OBJ reader -------------------------------------------
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_heightfield_obj_text_and_heights_equal_jax(grid):
    args = GRIDS[grid]
    text = terrain.heightfield_obj(*args)
    assert text == j_terrain.heightfield_obj(*args)
    assert terrain.make_heightfield(*args, max_contacts=3).heights == j_terrain.make_heightfield(*args, max_contacts=3).heights


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_obj_reader_equals_jax(grid, tmp_path):
    text = terrain.heightfield_obj(*GRIDS[grid])
    verts, tris = obj.load_obj(text)
    j_verts, j_tris = j_load_obj(text)
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(tris, j_tris)
    assert verts.dtype == np.float64 and tris.dtype == np.int32
    # the cached mesh data: scaled vertices, read once per (file, scale)
    path = terrain.write_heightfield(str(tmp_path / "t.obj"), *GRIDS[grid])
    scale = (1.0, 2.0, 0.5)
    scaled, scaled_tris = obj.mesh_data(path, scale)
    j_scaled, j_scaled_tris = j_narrowphase._mesh_data(path, scale)
    np.testing.assert_array_equal(scaled, j_scaled)
    np.testing.assert_array_equal(scaled_tris, j_scaled_tris)
    assert obj.mesh_data(path, scale)[0] is scaled


def test_obj_reader_fans_polygons_and_reads_negative_indices():
    verts, tris = obj.load_obj("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4/1 -3/2 -1/3\n")
    j_verts, j_tris = j_load_obj("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4/1 -3/2 -1/3\n")
    assert tris.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 3]]
    np.testing.assert_array_equal(tris, j_tris)
    np.testing.assert_array_equal(verts, j_verts)


def test_heightfield_and_mesh_validate():
    with pytest.raises(ValueError):
        Heightfield(1, 2, (0, 1), (0, 1), (0.0, 0.0))
    with pytest.raises(ValueError):
        Heightfield(2, 2, (0, 1), (0, 1), (0.0, 0.0, 0.0))
    with pytest.raises(ValueError):
        terrain.heightfield_obj(1, 5, (0, 1), (0, 1), lambda x, y: 0.0)
    # max_contacts 0: visual-only, collides with nothing
    assert not narrowphase.supported(Sphere(0.1), Heightfield(2, 2, (0, 1), (0, 1), (0.0,) * 4, max_contacts=0))
    assert not narrowphase.supported(Mesh(file_name="x.obj"), Sphere(0.1))
    assert narrowphase.supported(Sphere(0.1), Mesh(file_name="x.obj", max_contacts=1))
    assert Heightfield(2, 2, (0, 1), (0, 1), (0.0,) * 4).local_inertia(1.0) == (0.0, 0.0, 0.0)
    # a missing file: zeros, as in the JAX package (a visual-only mesh stays harmless)
    assert Mesh(file_name="x.obj", max_contacts=1).local_inertia(1.0) == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("pair", ["box-mesh", "mesh-box", "mesh-mesh"])
def test_unported_mesh_pairs_raise(shapes, pair):
    """The mesh pairs this slice left to tests/test_torch_collision_rest.py
    are computed now and raise nothing: a box and a copy of the terrain
    mesh over the terrain, at 1e-12 against the JAX package."""
    from tds_tpu_torch.model.geometry import Box

    _, mesh, _, j_mesh = shapes["sine"]
    box, j_box = Box((0.1, 0.2, 0.1)), j_geometry.Box((0.1, 0.2, 0.1))
    a, b, j_a, j_b = {"box-mesh": (box, mesh, j_box, j_mesh), "mesh-box": (mesh, box, j_mesh, j_box),
                      "mesh-mesh": (mesh, mesh, j_mesh, j_mesh)}[pair]
    centres = np.array([[0.3, 0.2, 0.1], [1.1, -0.4, 0.05]])
    rot = random_rotations(2, 7)
    xa, j_xa = (port_x(centres, rot), jax_x(centres, rot)) if pair != "mesh-box" else (port_x(np.zeros(3)), jax_x(np.zeros(3)))
    xb, j_xb = (port_x(np.zeros(3)), jax_x(np.zeros(3))) if pair != "mesh-box" else (port_x(centres, rot), jax_x(centres, rot))
    assert narrowphase.supported(a, b)
    got = narrowphase.compute_contacts(a, xa, b, xb)
    want = jax.vmap(lambda p, r: j_narrowphase.compute_contacts(
        j_a, JTransform(pos=p, rot=r) if pair != "mesh-box" else j_xa, j_b, j_xb if pair != "mesh-box" else JTransform(pos=p, rot=r)
    ))(jnp.asarray(centres), jnp.asarray(rot))
    assert_contacts_equal(got, want, pair)


# -- the narrowphase functions against JAX ---------------------------------------
CENTRES = {"interior": interior_centres, "border": border_centres, "vertex": lambda: vertex_centres(h_fn),
           "flat-vertex": lambda: vertex_centres(lambda x, y: 0.0)}


def _pair_inputs(name, shapes, centres, tie):
    """(port shape a, port xa, port shape b, port xb, JAX shape a, JAX xa,
    JAX shape b, JAX xb) for the pair ``name`` at ``centres``; with
    ``tie``, capsules stand upright and the mesh lies level, so that their
    probes and vertices tie."""
    hf, mesh, j_hf, j_mesh = shapes
    n = centres.shape[0]
    rot = None if tie else random_rotations(n, 5)
    ident, j_ident = port_x(np.zeros(3)), jax_x(np.zeros(3))
    if name in ("sphere_heightfield", "sphere_mesh"):
        b, j_b = (hf, j_hf) if name == "sphere_heightfield" else (mesh, j_mesh)
        return Sphere(0.04), port_x(centres), b, ident, j_geometry.Sphere(0.04), jax_x(centres), j_b, j_ident
    if name in ("capsule_heightfield", "capsule_mesh"):
        b, j_b = (hf, j_hf) if name == "capsule_heightfield" else (mesh, j_mesh)
        cap, j_cap = Capsule(0.03, 0.1), j_geometry.Capsule(0.03, 0.1)
        return cap, port_x(centres, rot), b, ident, j_cap, jax_x(centres, rot), j_b, j_ident
    # plane_mesh: the terrain mesh placed at the centres, rotated, against
    # the plane z = 0.01: the deepest vertices
    shift = centres - centres.mean(0)
    plane, j_plane = Plane((0.0, 0.0, 1.0), 0.01), j_geometry.Plane((0.0, 0.0, 1.0), 0.01)
    return plane, ident, mesh, port_x(shift, rot), j_plane, j_ident, j_mesh, jax_x(shift, rot)


@pytest.mark.parametrize("where", sorted(CENTRES))
@pytest.mark.parametrize("name", ["sphere_heightfield", "capsule_heightfield", "sphere_mesh", "capsule_mesh", "plane_mesh"])
def test_narrowphase_matches_jax(shapes, name, where):
    """Every field of the candidates, in the JAX package's order, in both
    argument orders (the reversed one flips the contact)."""
    tie = where == "flat-vertex"
    terrain_shapes = shapes["flat" if tie else "sine"]
    sa, xa, sb, xb, j_sa, j_xa, j_sb, j_xb = _pair_inputs(name, terrain_shapes, CENTRES[where](), tie)
    got = narrowphase.compute_contacts(sa, xa, sb, xb)
    n = CENTRES[where]().shape[0]
    if name == "plane_mesh":
        want = jax.vmap(lambda xb: j_narrowphase.compute_contacts(j_sa, j_xa, j_sb, xb))(j_xb)
    else:
        want = jax.vmap(lambda xa: j_narrowphase.compute_contacts(j_sa, xa, j_sb, j_xb))(j_xa)
    k = terrain_shapes[0].max_contacts * (2 if name.startswith("capsule") else 1)
    assert got.distance.shape == (n, k)
    assert_contacts_equal(got, want, f"{name} at the {where} centres")
    reversed_ = narrowphase.compute_contacts(sb, xb, sa, xa)
    torch.testing.assert_close(reversed_.normal_on_b, -got.normal_on_b, rtol=0, atol=0)
    torch.testing.assert_close(reversed_.point_a, got.point_b, rtol=0, atol=0)
    if tie:
        # a tie of distances among the kept candidates: the order rests on
        # the tie-break alone (the lower index first, as jax.lax.top_k)
        d = got.distance
        assert bool((d[:, 0] == d[:, 1]).all())


def test_candidate_order_is_nearest_first_not_candidate_order(shapes):
    """``nearest`` keeps jax.lax.top_k's order, nearest first; mlcp's
    top_k_indices, which re-sorts into candidate order, would not."""
    from tds_tpu_torch.contact.mlcp import top_k_indices

    hf = shapes["sine"][0]
    centres = interior_centres()
    got = narrowphase.sphere_heightfield(Sphere(0.04), port_x(centres), hf, port_x(np.zeros(3)))
    assert bool((got.distance[:, 1:] >= got.distance[:, :-1]).all())
    d = torch.tensor([[0.3, 0.1, 0.2, 0.1]], dtype=torch.float64)
    assert narrowphase.nearest(d, 3)[1].tolist() == [[1, 3, 2]]
    assert top_k_indices(d, 3).tolist() == [[1, 2, 3]]
    with pytest.raises(ValueError):
        narrowphase.nearest(d, 5)


@pytest.mark.parametrize("where", ["interior", "border", "vertex"])
def test_heightfield_height_matches_jax(shapes, where):
    hf, _, j_hf, _ = shapes["sine"]
    xy = CENTRES[where]()[:, :2]
    xy = np.concatenate([xy, np.random.default_rng(2).uniform((-1.5, -2.0), (3.5, 2.0), (50, 2))])  # some off the grid
    got = narrowphase.heightfield_height(hf, *torch.from_numpy(xy).unbind(-1))
    want = j_narrowphase.heightfield_height(j_hf, *jnp.asarray(xy).T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_ray_mesh_matches_jax(shapes):
    _, mesh, _, j_mesh = shapes["sine"]
    rng = np.random.default_rng(3)
    xy = np.concatenate([rng.uniform((XR[0], YR[0]), (XR[1], YR[1]), (64, 2)), [[XR[0] - 0.5, 0.0], [0.0, YR[1] + 0.5]]])
    origins = np.concatenate([xy, np.full((66, 1), 10.0)], -1)
    targets = origins + np.array([0.0, 0.0, -20.0]) + rng.uniform(-0.3, 0.3, (66, 3)) * [1, 1, 0]  # some slanted
    frac, normal = ray_mesh(torch.from_numpy(origins), torch.from_numpy(targets), mesh, port_x(np.zeros(3)))
    j_frac, j_normal = j_raycast.ray_mesh(jnp.asarray(origins), jnp.asarray(targets), j_mesh, jax_x(np.zeros(3)))
    np.testing.assert_allclose(frac.numpy(), np.asarray(j_frac), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(normal.numpy(), np.asarray(j_normal), rtol=TOL, atol=TOL)
    assert bool((frac[-2:] == BIG).all()) and int((frac[:-2] < 1.0).sum()) >= 60  # a slanted ray may leave the grid


# -- the port's own oracle: the heightfield is the mesh ---------------------------
@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """(Heightfield, Mesh) of one surface: the heights rounded to the 9
    significant digits of the mesh's OBJ text (its x and y are exact on
    this grid), so that the two hold the same vertices to the bit."""
    path = terrain.write_heightfield(str(tmp_path_factory.mktemp("oracle") / "t.obj"), NX, NY, XR, YR, h_fn)
    hf = terrain.make_heightfield(NX, NY, XR, YR, lambda x, y: float(f"{h_fn(x, y):.9g}"), max_contacts=3)
    mesh = Mesh(file_name=path, max_contacts=3)
    verts, _ = obj.mesh_data(path, mesh.scale)
    assert tuple(verts[:, 2]) == hf.heights
    return hf, mesh


@pytest.mark.parametrize("where", ["interior", "vertex"])
def test_heightfield_pairs_equal_the_mesh_pairs(oracle, where):
    """tests/test_heightfield.py:52-80 in the port, spheres and capsules."""
    hf, mesh = oracle
    centres = CENTRES[where]()
    rot = random_rotations(centres.shape[0], 6)
    for shape, x in ((Sphere(0.04), port_x(centres)), (Capsule(0.03, 0.1), port_x(centres, rot))):
        a = narrowphase.compute_contacts(shape, x, hf, port_x(np.zeros(3)))
        b = narrowphase.compute_contacts(shape, x, mesh, port_x(np.zeros(3)))
        for field in a._fields:
            torch.testing.assert_close(getattr(a, field), getattr(b, field), rtol=TOL, atol=TOL, msg=f"{shape}: {field}")


def test_heightfield_height_equals_the_mesh_rays(oracle):
    hf, mesh = oracle
    rng = np.random.default_rng(1)
    xs, ys = torch.from_numpy(rng.uniform(*XR, 64)), torch.from_numpy(rng.uniform(*YR, 64))
    origins = torch.stack([xs, ys, torch.full_like(xs, 10.0)], -1)
    targets = origins - torch.tensor([0.0, 0.0, 20.0], dtype=torch.float64)
    frac, _ = ray_mesh(origins, targets, mesh, port_x(np.zeros(3)))
    torch.testing.assert_close(narrowphase.heightfield_height(hf, xs, ys), 10.0 - frac * 20.0, rtol=TOL, atol=TOL)


# -- the env on terrain --------------------------------------------------------------
def test_height_scan_geometry(tmp_path):
    """tests/test_terrain.py:98-144 in the port, and its scan on a batch
    against the JAX env's observation at 1e-12."""

    def h(x, y):
        return 0.05 * math.sin(2.0 * x) + 0.02 * y

    path = terrain.write_heightfield(str(tmp_path / "scan.obj"), 25, 25, (-2.0, 2.0), (-2.0, 2.0), h)
    scan = [(0.0, 0.0), (0.3, 0.0), (0.0, 0.2), (-0.3, -0.2)]
    env = LaikagoEnv(dtype=torch.float64, device="cpu", terrain=Mesh(file_name=path, max_contacts=3), height_scan=scan)
    plain = LaikagoEnv(dtype=torch.float64, device="cpu", terrain=Mesh(file_name=path, max_contacts=3))
    assert env.observation_dim == plain.observation_dim + len(scan)
    q, qd = env.initial_state(torch.Generator().manual_seed(0), batch_size=3)
    q[:, :2] += torch.tensor([[0.0, 0.0], [0.4, -0.3], [-0.7, 0.5]], dtype=torch.float64)
    obs = env.observation(q, qd)
    assert obs.shape == (3, env.observation_dim)
    heights = obs[:, -len(scan):]
    for b in range(3):
        base = q[b, :3].tolist()
        for (ox, oy), got in zip(scan, heights[b].tolist()):
            assert abs(got - (h(base[0] + ox, base[1] + oy) - base[2])) < 5e-3, (b, ox, oy)
    # after a 90 degree yaw the (0.3, 0) point samples +y
    q_yaw = q.clone()
    q_yaw[:, 5] = math.pi / 2
    h_yaw = env.observation(q_yaw, qd)[:, -len(scan):]
    for b in range(3):
        base = q[b, :3].tolist()
        assert abs(h_yaw[b, 1].item() - (h(base[0], base[1] + 0.3) - base[2])) < 5e-3
    j_env = JaxLaikago(dtype=jnp.float64, terrain=j_geometry.Mesh(file_name=path, max_contacts=3), height_scan=scan)
    for qq in (q, q_yaw):
        want = jax.vmap(j_env.observation)(jnp.asarray(qq.numpy()), jnp.asarray(qd.numpy()))
        np.testing.assert_allclose(env.observation(qq, qd).numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="height_scan requires terrain"):
        LaikagoEnv(dtype=torch.float64, device="cpu", height_scan=scan)


def test_terrain_world_and_solver():
    """The terrain hangs on the zero-DoF ground in the env's dtype (so float32
    stays float32 through the mesh narrowphase), and the laikago's terrain
    default keeps the 8 deepest of its 12 candidates."""
    from tds_tpu_torch.contact.mlcp import ContactSolverParams

    hf = terrain.make_heightfield(13, 7, (-1.0, 5.0), (-1.5, 1.5), bench_fn, max_contacts=3)
    env = LaikagoEnv(dtype=torch.float32, device="cpu", terrain=hf)
    assert env.world.geoms[0][0].shape is hf and env.world.geoms[0][0].link_index == -1
    assert env.world.bodies[0].dof_qd == 0 and env.world.bodies[0].base_pos.dtype == torch.float32
    assert env.world.solver.top_k == 8
    assert LaikagoEnv(dtype=torch.float32, device="cpu", terrain=hf, solver=ContactSolverParams()).world.solver.top_k == 0
    assert LaikagoEnv(dtype=torch.float32, device="cpu").world.solver.top_k == 0
    q, qd = env.initial_state(torch.Generator().manual_seed(0), batch_size=2)
    zero = q.new_zeros(2, 0)
    kins = [fk_links(env.world.bodies[0], zero, zero), fk_links(env.model, q, qd)]
    assert kins[0].base_x_world.pos.dtype == torch.float32
    batch = t_world.gather_pair_contacts(env.world, kins, 0, 1, q)
    assert batch.contact.distance.shape == (2, 12) and batch.contact.point_b.dtype == torch.float32
    q2, qd2 = env.sim_step(q, qd, torch.zeros(2, 12))
    assert q2.dtype == qd2.dtype == torch.float32


def test_fused_step_refuses_terrain():
    hf = terrain.make_heightfield(13, 7, (-1.0, 5.0), (-1.5, 1.5), bench_fn, max_contacts=3)
    with pytest.raises(NotImplementedError, match="ground plane"):
        LaikagoEnv(dtype=torch.float32, device="cpu", terrain=hf, fused_step=True)


# -- the trainer ------------------------------------------------------------------
def test_trainer_on_terrain(tmp_path, capsys):
    """tests/test_terrain.py:147-175 through the port's trainer: one
    iteration on the +-2 cm heightfield with 9 scan points."""
    path = str(tmp_path / "terrain.pkl")
    state, history = ars_train.main(
        ["--device", "cpu", "--terrain_bump", "0.02", "--terrain_scan", "9", "--num_directions", "2", "--rollout_length",
         "8", "--iterations", "1", "--checkpoint", path]
    )
    assert "terrain mode: +-2 cm heightfield, 9 height-scan observations" in capsys.readouterr().out
    assert state.params.shape[0] == 12 * (36 + 9 + 1) and int(state.total_timesteps) > 0
    assert all(bool(torch.isfinite(v)) for v in history[0].values()) and bool(torch.isfinite(state.params).all())
    # the scan columns' mean is the (negative) base height over the terrain
    scan_mean = state.obs_stat.mean[-9:]
    assert bool((scan_mean.abs() > 0.05).all()), scan_mean
    env = ars_train.make_terrain_env(0.02, 0, device="cpu")
    assert env.height_scan is None and env.observation_dim == 36 and env.step_params is None


@pytest.mark.parametrize(
    "argv, message",
    [
        (["--env", "ant", "--terrain_bump", "0.02"], "--terrain_bump is laikago-only for now"),
        (["--env", "laikago", "--reset_pool", "logs/humanoid_ars/pool_r5.npz"], "--reset_pool is humanoid-only for now"),
    ],
    ids=["terrain-off-laikago", "pool-off-humanoid"],
)
def test_trainer_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        ars_train.main(["--device", "cpu", *argv])


def test_trainer_with_a_reset_pool(tmp_path, capsys):
    """The humanoid trains from logs/humanoid_ars/pool_r5.npz and evaluates
    on the env without it, at a tiny size."""
    from tds_tpu_torch.learn import ars

    evaluated = []
    make_eval = ars.make_eval

    def recording(env, *args, **kwargs):
        evaluated.append(env)
        return make_eval(env, *args, **kwargs)

    ars.make_eval = recording
    try:
        path = str(tmp_path / "humanoid.pkl")
        state, history = ars_train.main(
            ["--device", "cpu", "--env", "humanoid", "--reset_pool", os.path.join(REPO, "logs", "humanoid_ars", "pool_r5.npz"),
             "--num_directions", "1", "--rollout_length", "2", "--iterations", "1", "--eval_interval", "1",
             "--checkpoint", path]
        )
    finally:
        ars.make_eval = make_eval
    assert "reset pool: 730 brink states (p=0.5)" in capsys.readouterr().out
    assert len(evaluated) == 1 and evaluated[0].reset_pool is None
    assert "eval_reward_min" in history[0] and load_checkpoint(path)[1] == {"iteration": 1}


# -- the JAX reset draws chip_smoke.py replays the terrain policies from -----------
def test_terrain_policy_starts_are_the_jax_tests(optimized_jax):
    """tests/golden/laikago_terrain_policy_reset_noise.json: the joint noise
    that the JAX env's reset draws for tests/test_terrain_policy.py's keys
    (split(PRNGKey(0), 4)) and tests/test_terrain.py's (PRNGKey(0)), in
    float32, and the JAX env's initial state from it."""
    with open(GOLDEN) as f:
        recorded = json.load(f)
    j_env = JaxLaikago(dtype=jnp.float32, terrain=j_terrain.make_heightfield(13, 7, (-1.0, 5.0), (-1.5, 1.5), bench_fn,
                                                                              max_contacts=3))
    starts = {"policy": list(jax.random.split(jax.random.PRNGKey(0), 4)), "mesh": [jax.random.PRNGKey(0)]}
    assert sorted(starts) == sorted(k for k in recorded if k != "about")
    for name, keys in starts.items():
        assert len(recorded[name]) == len(keys)
        for key, noise in zip(keys, recorded[name]):
            sub = jax.random.split(key)[1]
            draw = jax.random.uniform(sub, (12,), minval=-0.05, maxval=0.05, dtype=jnp.float32)
            np.testing.assert_array_equal(np.asarray(draw), np.float32(noise))
            q, _ = j_env.initial_state(sub)
            np.testing.assert_array_equal(np.asarray(q)[6:], np.float32(LAIKAGO_INITIAL_POSES) + np.float32(noise))
