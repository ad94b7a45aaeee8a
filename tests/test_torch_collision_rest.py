"""The rest of the port's collision layer against the JAX package's, float64
on the CPU, from numpy seeds:

- every pair of ``tds_tpu/collision/narrowphase.py``'s table that the
  terrain slice did not port (sphere-sphere, plane-box, sphere-box,
  capsule-sphere, box-mesh, mesh-mesh with and without edge candidates), in
  both argument orders, batched, every ``Contact`` field in the same
  candidate order at 1e-12 abs + rel: random poses, sphere-box's inside
  case and its face ties (a centre at a cube's centre ties all six faces,
  the first wins), plane-box's 8 corners, and tests/test_mesh_contact.py's
  unit cube at its poses (separated, penetrating, edge on edge);
- ``ray_sphere``, ``ray_plane``, ``ray_box`` and ``cast_rays`` at 1e-12
  with ``geom_index`` equal, ties of shapes included;
- ``mesh_mass_properties`` against the JAX package's (its native library)
  and ``Mesh.local_inertia`` at 1e-12, and the analytic cube;
- ``construct_from_string(..., mesh_contacts=K)``'s attachments;
- the gradients of ``box_mesh`` and ``mesh_mesh`` from ``torch.autograd``
  against ``jax.grad`` at 1e-9.

The worlds these pairs open (the Panda push, the mesh cubes) are in
tests/test_torch_collision_world.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.algebra.transform import Transform as JTransform  # noqa: E402
from tds_tpu.collision import narrowphase as j_narrowphase  # noqa: E402
from tds_tpu.collision import raycast as j_raycast  # noqa: E402
from tds_tpu.model import geometry as j_geometry  # noqa: E402
from tds_tpu.native import mesh as j_native  # noqa: E402
from tds_tpu.urdf.cache import construct_from_string as j_construct_from_string  # noqa: E402
from tds_tpu_torch.algebra.transform import Transform  # noqa: E402
from tds_tpu_torch.collision import narrowphase, raycast  # noqa: E402
from tds_tpu_torch.model import geometry  # noqa: E402
from tds_tpu_torch.native.mesh import mesh_mass_properties  # noqa: E402
from tds_tpu_torch.urdf.cache import construct_from_string  # noqa: E402
from tds_tpu_torch.utils.obj import mesh_data  # noqa: E402

TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: its many small operations gain nothing from
    more, and the test workers' threads would contend for the cores. The
    JAX package's reference runs as it is compiled by default: a tie of
    distances here is decided by the last bit of its roundings."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# tests/test_mesh_contact.py's unit cube: vertices (-/+0.5)^3 x-major, 12
# triangles wound outward
CUBE_OBJ = "\n".join(
    f"v {sx} {sy} {sz}" for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)
) + "\n" + "\n".join(
    f"f {a} {b} {c}"
    for a, b, c in [(1, 3, 7), (1, 7, 5), (2, 6, 8), (2, 8, 4), (1, 2, 4), (1, 4, 3),
                    (5, 7, 8), (5, 8, 6), (1, 5, 6), (1, 6, 2), (3, 4, 8), (3, 8, 7)]
) + "\n"


@pytest.fixture(scope="module")
def cube_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "cube.obj"
    path.write_text(CUBE_OBJ)
    return str(path)


def rotations(n, seed):
    """(n, 3, 3) rotations of random unit quaternions."""
    q = np.random.default_rng(seed).normal(size=(n, 4))
    x, y, z, w = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_about(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    return {"x": np.array([[1, 0, 0], [0, c, -s], [0, s, c]]),
            "y": np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
            "z": np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])}[axis]


def poses(pos, rot=None):
    """(port Transform, JAX Transform) of positions (B, 3) and rotations
    (B, 3, 3), the identity by default."""
    pos = np.asarray(pos, np.float64)
    rot = np.array(np.broadcast_to(np.eye(3), pos.shape[:-1] + (3, 3)) if rot is None else rot, np.float64)
    return (Transform(pos=torch.from_numpy(pos.copy()), rot=torch.from_numpy(rot)),
            JTransform(pos=jnp.asarray(pos), rot=jnp.asarray(rot)))


def jax_contacts(a, xa, b, xb):
    """The JAX package's contacts of the pair over the batch, eager: a jit
    fuses the operations, and its roundings may break a tie of distances
    another way than the port's (and the JAX package's own eager) do."""
    return j_narrowphase.compute_contacts(a, xa, b, xb)


def check_pair(shapes, xs, tol=TOL):
    """compute_contacts of the port and of the JAX package, both orders."""
    (a, j_a), (b, j_b) = shapes
    (xa, j_xa), (xb, j_xb) = xs
    for order, (p, q) in {"a-b": ((a, j_a, xa, j_xa), (b, j_b, xb, j_xb)), "b-a": ((b, j_b, xb, j_xb), (a, j_a, xa, j_xa))}.items():
        got = narrowphase.compute_contacts(p[0], p[2], q[0], q[2])
        want = jax_contacts(p[1], p[3], q[1], q[3])
        for field in got._fields:
            np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=tol, atol=tol,
                                       err_msg=f"{order} {field}")
    return got


def both(name, *args, **kwargs):
    """(the port's shape, the JAX package's) of the geometry class ``name``."""
    return getattr(geometry, name)(*args, **kwargs), getattr(j_geometry, name)(*args, **kwargs)


def mesh(cube_file, **kwargs):
    return both("Mesh", file_name=cube_file, **{"max_contacts": 4, **kwargs})


B = 24


def test_sphere_sphere():
    rng = np.random.default_rng(0)
    ca = rng.uniform(-0.4, 0.4, (B, 3))
    cb = rng.uniform(-0.4, 0.4, (B, 3))
    cb[0] = ca[0]  # coincident centres: a zero normal, no NaN
    got = check_pair((both("Sphere", 0.3), both("Sphere", 0.2)), (poses(ca), poses(cb)))
    assert bool((got.distance < 0).any()) and bool((got.distance > 0).any())
    assert torch.isfinite(got.normal_on_b).all()


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (0.6, 0.0, 0.8)], ids=["level", "tilted"])
def test_plane_box(normal):
    rng = np.random.default_rng(1)
    box = rng.uniform(-0.5, 0.5, (B, 3)) + np.array([0.0, 0.0, 0.1])
    got = check_pair((both("Plane", normal, 0.05), both("Box", (0.2, 0.3, 0.1))), (poses(np.zeros((B, 3))), poses(box, rotations(B, 2))))
    assert got.count == 8
    # an upright box 4 cm up: the corner spheres (r = 1 cm) alternate upper
    # and lower, (+,+,+), (+,+,-), ...; the lower ones 1 cm into the plane
    level, _ = poses(np.array([[0.0, 0.0, 0.04]]))
    c = narrowphase.compute_contacts(geometry.Plane(), Transform(pos=torch.zeros(1, 3, dtype=torch.float64), rot=level.rot),
                                     geometry.Box((0.2, 0.3, 0.1)), level)
    np.testing.assert_allclose(c.distance[0].numpy(), [0.07, -0.01] * 4, atol=1e-15)


def test_sphere_box_outside_inside_and_ties():
    rng = np.random.default_rng(3)
    he = np.array([0.1, 0.15, 0.2])
    centres = rng.uniform(-1.6, 1.6, (B, 3)) * he  # inside and outside
    xb = rng.uniform(-0.2, 0.2, (B, 3))
    check_pair((both("Sphere", 0.05), both("Box", tuple(2 * he))), (poses(xb + centres @ np.eye(3)), poses(xb, rotations(B, 4))))
    # a cube: the centre ties all six faces (+x wins), a point on the
    # x = y diagonal ties +x and +y (+x wins), a point on a face's plane
    # sits outside at distance 0
    ties = np.array([[0.0, 0.0, 0.0], [0.05, 0.05, 0.0], [-0.05, 0.0, -0.05], [0.0, -0.03, -0.03], [0.1, 0.02, 0.0]])
    got = check_pair((both("Sphere", 0.05), both("Box", (0.2, 0.2, 0.2))), (poses(ties), poses(np.zeros_like(ties))))
    np.testing.assert_allclose(got.normal_on_b[:4, 0].numpy(), [[-1, 0, 0], [-1, 0, 0], [1, 0, 0], [0, 1, 0]])  # b-a: flipped
    np.testing.assert_allclose(got.distance[:, 0].numpy(), [-0.15, -0.1, -0.1, -0.12, -0.05], atol=1e-15)


def test_capsule_sphere():
    rng = np.random.default_rng(5)
    xa = rng.uniform(-0.2, 0.2, (B, 3))
    rot = rotations(B, 6)
    # sphere centres along the axis beyond both ends, beside it, and on it
    t = rng.uniform(-0.5, 0.5, B)
    side = rng.normal(size=(B, 3)) * 0.2
    centres = xa + rot[:, :, 2] * t[:, None] + side
    centres[0] = xa[0] + rot[0, :, 2] * 0.2  # exactly at the +length/2 end
    check_pair((both("Capsule", 0.1, 0.4), both("Sphere", 0.15)), (poses(xa, rot), poses(centres)))


def test_box_mesh(cube_file):
    rng = np.random.default_rng(7)
    xa = rng.uniform(-0.7, 0.7, (B, 3))
    xa[0] = (0.0, 0.0, 0.65)  # tests/test_mesh_contact.py's box over the top face
    got = check_pair((both("Box", (0.2, 0.2, 0.2)), mesh(cube_file, max_contacts=2)), (poses(xa, rotations(B, 8)), poses(np.zeros((B, 3)))))
    assert got.count == 16


# tests/test_mesh_contact.py's poses of a half-size cube over the unit cube
# (separated by 0.05, penetrating by 0.05) and the stack's 0.6 cube resting
# on it, each nudged to a batch of MESH_BATCH; every case has that batch and
# 4 candidates a direction, so that the JAX package's eager operations
# compile once for all of them
MESH_BATCH = 6
MESH_POSES = {"separated": (0.5, 0.80), "penetrating": (0.5, 0.70), "stacked": (0.6, 0.79)}


def nudged(pos, rot, seed, scale=0.01):
    """MESH_BATCH poses: ``pos`` and ``rot`` first, then small moves of them."""
    rng = np.random.default_rng(seed)
    p = np.asarray(pos, np.float64) + np.concatenate([np.zeros((1, 3)), rng.uniform(-scale, scale, (MESH_BATCH - 1, 3))])
    turns = [np.eye(3)] + [rot_about("xyz"[i % 3], a) for i, a in enumerate(rng.uniform(-0.1, 0.1, MESH_BATCH - 1))]
    return poses(p, np.stack([rot @ t for t in turns]))


@pytest.mark.parametrize("edges", [0, 3], ids=["vertices", "edges"])
@pytest.mark.parametrize("where", sorted(MESH_POSES) + ["edge-cross", "random"])
def test_mesh_mesh(cube_file, where, edges):
    m = mesh(cube_file, edge_contacts=edges)
    ident = poses(np.zeros((MESH_BATCH, 3)))
    if where == "edge-cross":
        # the unit cubes crossing edge on edge, 45 degrees about x and y:
        # lowered 0.02 past touching, lifted 0.03 clear, and nudged
        za = np.sqrt(2.0) - np.array([0.02, -0.03] + [0.02] * (MESH_BATCH - 2))
        rot = nudged(np.zeros(3), rot_about("x", np.pi / 4), 17, scale=0.0)[0].rot.numpy()
        rot[1] = rot[0]  # the first two unturned
        xa = poses(np.stack([np.zeros(MESH_BATCH), np.zeros(MESH_BATCH), za], -1), rot)
        xb = poses(np.zeros((MESH_BATCH, 3)), np.stack([rot_about("y", np.pi / 4)] * MESH_BATCH))
        got = check_pair((m, m), (xa, xb))
        assert got.count == 8 + 2 * edges
        if edges:
            np.testing.assert_allclose(got.distance[:2].min(-1).values.numpy(), [-0.02 / np.sqrt(2.0), 0.03], atol=1e-9)
        else:  # vertices alone miss the crossing edges
            assert float(got.distance[0].min()) > 0
        return
    if where == "random":
        rng = np.random.default_rng(9)
        small = mesh(cube_file, scale=(0.4, 0.5, 0.6), edge_contacts=edges)
        check_pair((small, m), (poses(rng.uniform(-0.9, 0.9, (MESH_BATCH, 3)), rotations(MESH_BATCH, 10)), ident))
        return
    scale, za = MESH_POSES[where]
    small = mesh(cube_file, scale=(scale,) * 3, edge_contacts=edges)
    got = check_pair((small, m), (nudged((0.0, 0.0, za), np.eye(3), 18), ident))
    assert got.count == 8 + 2 * edges
    if where == "penetrating":  # the small cube's 4 lower vertices 0.05 inside, a-b order's last half
        np.testing.assert_allclose(got.distance[0, 4:8].numpy(), [-0.05] * 4, atol=1e-12)


def test_pair_table_and_refusals(cube_file):
    """The port collides every pair of the JAX package's table and nothing
    else; a visual-only mesh collides with nothing."""
    port = {(a.__name__, b.__name__) for a, b in narrowphase._PAIR_TABLE}
    jax_pairs = {(a.__name__, b.__name__) for a, b in j_narrowphase._PAIR_TABLE}
    assert port == jax_pairs and len(port) == 24
    visual = geometry.Mesh(file_name=cube_file)
    assert not narrowphase.supported(visual, visual) and not narrowphase.supported(geometry.Box((1, 1, 1)), visual)
    assert not narrowphase.supported(geometry.Cylinder(0.1, 0.2), geometry.Plane())
    with pytest.raises(KeyError):
        narrowphase.compute_contacts(geometry.Cylinder(0.1, 0.2), None, geometry.Plane(), None)


# -- gradients ---------------------------------------------------------------
def test_mesh_pair_gradients_match_jax(cube_file):
    """d(sum of the contacts' distances and points)/d(the pose's position
    and a rotation angle) of box-mesh and mesh-mesh (with edges)."""
    cases = {
        "box_mesh": (both("Box", (0.3, 0.2, 0.25)), mesh(cube_file, max_contacts=2), np.array([0.13, -0.21, 0.62])),
        "mesh_mesh": (mesh(cube_file, scale=(0.5, 0.6, 0.4), edge_contacts=2), mesh(cube_file, edge_contacts=2),
                      np.array([0.07, 0.11, 0.68])),
    }
    for name, ((a, j_a), (b, j_b), pos) in cases.items():
        def port_loss(p, theta):
            c, s = torch.cos(theta), torch.sin(theta)
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            rot = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]), torch.stack([zero, zero, one])])
            k = narrowphase.compute_contacts(a, Transform(pos=p[None], rot=rot[None]), b,
                                             Transform(pos=torch.zeros(1, 3, dtype=torch.float64), rot=torch.eye(3, dtype=torch.float64)[None]))
            return k.distance.sum() + 0.3 * k.point_a.sum() - 0.7 * k.point_b.sum() + 0.2 * k.normal_on_b.sum()

        def jax_loss(p, theta):
            c, s = jnp.cos(theta), jnp.sin(theta)
            rot = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            k = j_narrowphase.compute_contacts(j_a, JTransform(pos=p, rot=rot), j_b, JTransform(pos=jnp.zeros(3), rot=jnp.eye(3)))
            return k.distance.sum() + 0.3 * k.point_a.sum() - 0.7 * k.point_b.sum() + 0.2 * k.normal_on_b.sum()

        p = torch.tensor(pos, requires_grad=True)
        theta = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
        g_p, g_t = torch.autograd.grad(port_loss(p, theta), (p, theta))
        j_p, j_t = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(pos), 0.3)
        np.testing.assert_allclose(g_p.numpy(), np.asarray(j_p), rtol=1e-9, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(float(g_t), float(j_t), rtol=1e-9, atol=1e-9, err_msg=name)
        assert np.abs(g_p.numpy()).max() > 0


# -- raycasts ----------------------------------------------------------------
def rays(n, seed):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-2.0, 2.0, (n, 3)) + np.array([0.0, 0.0, 1.5])
    targets = rng.uniform(-2.0, 2.0, (n, 3)) - np.array([0.0, 0.0, 0.5])
    return origins, targets


def test_ray_primitives():
    o, t = rays(400, 12)
    o[0] = (-0.8, 0.0, 0.5)  # inside the sphere: the far root
    t[1] = o[1] * np.array([1.0, 1.0, 0.0]) + np.array([0.3, 0.0, 0.0])
    o[1, 2] = 0.0  # in the plane's
    to, tt = torch.from_numpy(o), torch.from_numpy(t)
    jo, jt = jnp.asarray(o), jnp.asarray(t)
    centre = np.array([-0.8, 0.0, 0.5])
    np.testing.assert_allclose(raycast.ray_sphere(to, tt, torch.from_numpy(centre), 0.5).numpy(),
                               np.asarray(j_raycast.ray_sphere(jo, jt, jnp.asarray(centre), 0.5)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(raycast.ray_plane(to, tt, (0.0, 0.0, 1.0), 0.0).numpy(),
                               np.asarray(j_raycast.ray_plane(jo, jt, (0.0, 0.0, 1.0), 0.0)), rtol=TOL, atol=TOL)
    x, j_x = poses(np.array([0.8, 0.0, 0.4]), rotations(1, 13)[0])
    got = raycast.ray_box(to, tt, x, (0.4, 0.3, 0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_raycast.ray_box(jo, jt, j_x, (0.4, 0.3, 0.5))), rtol=TOL, atol=TOL)
    assert bool((got < 1.0).any()) and bool((got == raycast.BIG).any())


def raycast_scene(cube_file, rotated):
    """examples/raycast_example.py's sphere, box and ground plane, and the
    unit mesh cube; ``rotated`` turns the box and the cube."""
    shapes = [both("Sphere", 0.5), both("Box", (0.8, 0.8, 0.8)), both("Plane", (0.0, 0.0, 1.0), 0.0),
              both("Mesh", file_name=cube_file)]
    rot = rotations(2, 14) if rotated else np.stack([np.eye(3)] * 2)
    xs = [poses(np.array([-0.8, 0.0, 0.5])), poses(np.array([0.8, 0.0, 0.4]), rot[0]), poses(np.zeros(3)),
          poses(np.array([0.0, -1.2, 0.5]), rot[1])]
    return shapes, xs


@pytest.mark.parametrize("rotated", [False, True], ids=["example", "rotated"])
def test_cast_rays(cube_file, rotated):
    shapes, xs = raycast_scene(cube_file, rotated)
    n = 40  # the example's grid of downward rays, finer
    gx, gy = np.meshgrid(np.linspace(-2.0, 2.0, n), np.linspace(-2.0, 2.0, n))
    o = np.stack([gx, gy, np.full_like(gx, 3.0)], -1).reshape(-1, 3)
    t = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3)
    o2, t2 = rays(400, 15)
    o, t = np.concatenate([o, o2]), np.concatenate([t, t2])
    got = raycast.cast_rays(torch.from_numpy(o), torch.from_numpy(t), [s for s, _ in shapes], [x for x, _ in xs])
    want = jax.jit(lambda o, t: j_raycast.cast_rays(o, t, [s for _, s in shapes], [x for _, x in xs]))(jnp.asarray(o), jnp.asarray(t))
    np.testing.assert_array_equal(got.geom_index.numpy(), np.asarray(want.geom_index))
    np.testing.assert_allclose(got.fraction.numpy(), np.asarray(want.fraction), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), rtol=TOL, atol=TOL)
    assert set(got.geom_index.tolist()) == {0, 1, 2, 3, -1} and got.geom_index.dtype == torch.int32
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    # the plane under the mesh cube's footprint ties nothing: the cube is nearer
    if not rotated:
        over_cube = (np.abs(o[: n * n, 0]) < 0.45) & (np.abs(o[: n * n, 1] + 1.2) < 0.45)
        assert (got.geom_index[: n * n].numpy()[over_cube] == 3).all()
        np.testing.assert_allclose(got.fraction[: n * n].numpy()[over_cube], 2.0 / 4.0, atol=1e-15)


def test_cast_rays_ties_keep_the_first_shape():
    """Two equal spheres at one place: the first in the list wins."""
    o, t = rays(50, 16)
    shapes = [geometry.Sphere(1.5), geometry.Sphere(1.5)]
    x, _ = poses(np.zeros(3))
    got = raycast.cast_rays(torch.from_numpy(o), torch.from_numpy(t), shapes, [x, x])
    assert set(got.geom_index.tolist()) <= {0, -1} and bool((got.geom_index == 0).any())


# -- mass properties -----------------------------------------------------------
@pytest.mark.parametrize("name", ["cube", "shifted-cube", "laikago/chassis_zup.obj", "laikago/lower_leg3.obj"])
def test_mesh_mass_properties_match_jax(cube_file, name):
    assert j_native.get_lib() is not None  # the JAX package's native sums, built by its build.sh
    path = {"cube": cube_file, "shifted-cube": cube_file}.get(name, name)
    verts, tris = mesh_data(path, (1.0, 1.0, 1.0))
    if name == "shifted-cube":
        verts = verts + np.array([1.0, 2.0, 3.0])
    got = mesh_mass_properties(verts, tris, density=2.0)
    want = j_native.mesh_mass_properties(verts, tris, density=2.0)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=TOL, atol=TOL * np.abs(want[2]).max())
    if "cube" in name:  # a solid unit cube of mass 2: I = 2/6 on the diagonal
        np.testing.assert_allclose(got[0], 2.0, rtol=1e-15)
        np.testing.assert_allclose(got[2], np.eye(3) / 3.0, atol=1e-12)


def test_mesh_local_inertia_matches_jax(cube_file):
    for scale in ((1.0, 1.0, 1.0), (0.6, 0.6, 0.6), (0.5, 1.0, 2.0)):
        got = geometry.Mesh(file_name=cube_file, scale=scale).local_inertia(2.4)
        want = j_geometry.Mesh(file_name=cube_file, scale=scale).local_inertia(2.4)
        np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(geometry.Mesh(file_name=cube_file).local_inertia(2.4), [0.4] * 3, rtol=1e-12)
    got = geometry.Mesh(file_name="laikago/chassis_zup.obj").local_inertia(3.0)
    np.testing.assert_allclose(got, j_geometry.Mesh(file_name="laikago/chassis_zup.obj").local_inertia(3.0), rtol=TOL)
    assert geometry.Mesh(file_name="/nonexistent.obj").local_inertia(1.0) == (0.0, 0.0, 0.0)
    for name, args in (("Sphere", (0.3,)), ("Box", ((0.1, 0.2, 0.3),)), ("Capsule", (0.1, 0.4)), ("Cylinder", (0.2, 0.5)),
                       ("Plane", ())):
        port, jax_shape = both(name, *args)
        np.testing.assert_allclose(port.local_inertia(1.7), jax_shape.local_inertia(1.7), rtol=1e-15)


# -- URDF mesh contacts ----------------------------------------------------------
def test_urdf_mesh_contacts(cube_file):
    urdf = f"""
    <robot name="meshbot">
      <link name="base">
        <inertial><mass value="1.0"/><inertia ixx="0.1" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/></inertial>
        <collision><geometry><mesh filename="{cube_file}" scale="0.5 0.5 0.5"/></geometry></collision>
        <collision><origin xyz="0 0 0.3"/><geometry><cylinder radius="0.1" length="0.2"/></geometry></collision>
      </link>
      <joint name="j" type="revolute"><parent link="base"/><child link="arm"/><axis xyz="0 0 1"/></joint>
      <link name="arm">
        <inertial><mass value="0.5"/><inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
        <collision><origin xyz="0.1 0 0" rpy="0 0.3 0"/><geometry><mesh filename="{cube_file}"/></geometry></collision>
        <collision><geometry><sphere radius="0.05"/></geometry></collision>
      </link>
    </robot>"""
    for k in (0, 2):
        _, got = construct_from_string(urdf, mesh_contacts=k)
        _, want = j_construct_from_string(urdf, mesh_contacts=k)
        assert len(got) == len(want) == (2 if k == 0 else 4)
        for g, w in zip(got, want):
            assert dataclasses.asdict(g.shape) == dataclasses.asdict(w.shape) and type(g.shape).__name__ == type(w.shape).__name__
            assert (g.link_index, g.pos, g.rpy, g.friction, g.restitution) == (w.link_index, w.pos, w.rpy, w.friction, w.restitution)
    assert got[0].shape == geometry.Mesh(cube_file, (0.5, 0.5, 0.5), max_contacts=2)
    plane = geometry.Plane()
    x, _ = poses(np.array([[0.0, 0.0, 0.2]]))
    c = narrowphase.compute_contacts(plane, Transform(pos=torch.zeros(1, 3, dtype=torch.float64), rot=x.rot), got[0].shape, x)
    np.testing.assert_allclose(c.distance.numpy(), [[-0.05, -0.05]], atol=1e-15)
