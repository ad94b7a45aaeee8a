"""The worlds the rest of the collision layer opens, the port against the
JAX package in float64 on the CPU:

- ``tools/panda_push.py``'s scene (examples/panda_push.py): the IK
  waypoints at 1e-9, and 5 ``world_step``s at 1e-9 from a state with all
  three pairs in contact (the end effector's sphere pressing the box, the
  box's lower corners on the plane), with the stroke's PD torques; the
  world's pairs resolved in the JAX package's order, K1's three solves a
  step at 3, 24 and 3 rows;
- tests/test_mesh_contact.py's mesh cube on the plane and on the static
  mesh cube (mesh-mesh), 20 ``world_step``s at 1e-10 from states already
  in contact, tilted and moving.

The JAX side is one jitted step of ``jax.vmap`` over the batch, reused for
every step; its IK is its own ``lax.scan``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import ContactSolverParams as JSolver  # noqa: E402
from tds_tpu.control.ik import IKMethod as JIKMethod, IKTarget as JIKTarget, inverse_kinematics as j_ik  # noqa: E402
from tds_tpu.control.pd import pd_tau as j_pd_tau  # noqa: E402
from tds_tpu.model import geometry as j_geometry  # noqa: E402
from tds_tpu.model.multibody import MultiBodyBuilder as JBuilder  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu.world import build_world as j_build_world, make_ground_plane as j_ground, world_step as j_world_step  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.model import geometry  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.tools import panda_push  # noqa: E402
from tds_tpu_torch.world import build_world, make_ground_plane, world_step  # noqa: E402

from test_torch_collision_rest import CUBE_OBJ  # noqa: E402


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


def j_stepper(world, dt):
    """The JAX package's world_step over the batch (``jax.vmap``), jitted
    once for all the steps of a test: its eager operations, dispatched one
    by one under vmap, take seconds a step."""
    return jax.jit(jax.vmap(lambda q, qd, tau, gravity: j_world_step(world, q, qd, tau, gravity, dt), in_axes=(0, 0, 0, None)))


def check_states(got, want, tol, when):
    for name, g, w in (("qs", got[0], want[0]), ("qds", got[1], want[1])):
        for body, (gb, wb) in enumerate(zip(g, w)):
            np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=tol, atol=tol, err_msg=f"{name}[{body}] {when}")


# -- the Panda push ----------------------------------------------------------------
def jax_panda_scene():
    """examples/panda_push.py's build_scene, float64."""
    arm, _ = j_construct("franka_panda/panda.urdf", dtype=jnp.float64)
    b = JBuilder(is_floating=True, name="box")
    mass = panda_push.BOX_MASS
    b.set_base_inertia(mass, (0, 0, 0), np.diag(j_geometry.Box(panda_push.BOX_EXTENTS).local_inertia(mass)))
    box = b.finalize(dtype=jnp.float64)
    world = j_build_world(
        [j_ground(dtype=jnp.float64),
         (arm, (j_geometry.GeomAttachment(link_index=panda_push.EE_LINK, shape=j_geometry.Sphere(0.025), friction=0.3),)),
         (box, (j_geometry.GeomAttachment(link_index=-1, shape=j_geometry.Box(panda_push.BOX_EXTENTS), friction=0.3),))],
        solver=JSolver(pgs_iterations=10),
    )
    return world, arm, box


@pytest.fixture(scope="module")
def panda():
    world, arm, box = panda_push.build_scene(dtype=torch.float64, device="cpu")
    return (world, arm, box), jax_panda_scene(), panda_push.ik_waypoints(arm)


def test_panda_ik_waypoints_match_jax(panda):
    """examples/panda_push.py's ik_waypoints: damped LM, 200 iterations,
    the second waypoint from the first."""
    _, (_, j_arm, _), (q0, q1) = panda
    start = jnp.asarray(panda_push.HOME_Q)
    for target, got in ((panda_push.PUSH_START, q0), (panda_push.PUSH_END, q1)):
        res = j_ik(j_arm, [JIKTarget(link_index=panda_push.EE_LINK, position=jnp.asarray(target))], start,
                   method=JIKMethod.DAMPED_LM, max_iterations=200)
        assert bool(res.converged)
        np.testing.assert_allclose(got.numpy(), np.asarray(res.q), rtol=1e-9, atol=1e-9)
        start = res.q


def test_panda_world_steps_match_jax(panda):
    """5 steps of 2 scenes, the box pressed 2 and 4 mm into the end
    effector's sphere at the stroke's start, PD toward the stroke's targets."""
    (world, arm, box), (j_world, j_arm, _), (q0, q1) = panda
    box_x = torch.tensor([0.503, 0.501], dtype=torch.float64)
    qs, qds = panda_push.initial_state(world, q0, box_x)
    qds = (qds[0], qds[1] + 0.05, qds[2])  # the arm moving
    jqs, jqds = tuple(jnp.asarray(q.numpy()) for q in qs), tuple(jnp.asarray(q.numpy()) for q in qds)
    gravity = torch.tensor(panda_push.GRAVITY, dtype=torch.float64)
    counts, j_step = [], j_stepper(j_world, panda_push.DT)
    for t in range(5):
        target = q0 + min(t / panda_push.STROKE_STEPS, 1.0) * (q1 - q0)
        tau = panda_push.pd_tau(arm, qs[1], qds[1], target.expand(2, -1), kp=panda_push.KP, kd=panda_push.KD,
                                max_force=panda_push.MAX_FORCE)
        j_tau = jax.vmap(lambda q, qd: j_pd_tau(j_arm, q, qd, jnp.asarray(target.numpy()), kp=panda_push.KP, kd=panda_push.KD,
                                                max_force=panda_push.MAX_FORCE))(jqs[1], jqds[1])
        np.testing.assert_allclose(tau.numpy(), np.asarray(j_tau), rtol=1e-9, atol=1e-9)
        calls = []
        solve = pgs.solve_pgs
        pgs.solve_pgs = lambda *args: calls.append(args[1].shape[-1]) or solve(*args)
        try:
            qs, qds = world_step(world, qs, qds, (None, tau, None), gravity, panda_push.DT)
        finally:
            pgs.solve_pgs = solve
        counts.append(calls)
        zero = jnp.zeros((2, 0))
        jqs, jqds = j_step(jqs, jqds, (zero, j_tau, zero), jnp.asarray(panda_push.GRAVITY))
        check_states((qs, qds), (jqs, jqds), 1e-9, f"after step {t + 1}")
    assert counts == [[3, 24, 3]] * 5  # plane-arm, plane-box, arm-box
    assert float((qs[2][:, 4] - box_x).min()) > 0  # the boxes were pushed


# -- the mesh cubes -----------------------------------------------------------------
@pytest.fixture(scope="module")
def cube_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "cube.obj"
    path.write_text(CUBE_OBJ)
    return str(path)


def mesh_world(kind, cube_file, lib):
    """(world, cube) of tests/test_mesh_contact.py in the package ``lib``
    (``"port"`` or ``"jax"``): the unit mesh cube (4 candidates) dropped on
    the plane, or its 0.6-scale copy on the static unit cube (mesh-mesh)."""
    geo, builder, build, ground, solver = (
        (geometry, MultiBodyBuilder, build_world, make_ground_plane, ContactSolverParams) if lib == "port"
        else (j_geometry, JBuilder, j_build_world, j_ground, JSolver)
    )
    dtype = torch.float64 if lib == "port" else jnp.float64
    m = geo.Mesh(file_name=cube_file, max_contacts=4)
    b = builder(is_floating=True, name="mesh_cube")
    if kind == "plane":
        b.set_base_inertia(1.0, (0, 0, 0), np.diag([1.0 / 6.0] * 3))
        cube = b.finalize(dtype=dtype)
        first = ground(dtype=dtype)
        shape = m
    else:
        b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.36 / 6.0] * 3))
        cube = b.finalize(dtype=dtype)
        first = (builder(name="mesh_cube_static").finalize(dtype=dtype),
                 (geo.GeomAttachment(link_index=-1, shape=m, pos=(0.0, 0.0, 0.5), friction=0.8),))
        shape = dataclasses.replace(m, scale=(0.6, 0.6, 0.6))
    world = build([first, (cube, (geo.GeomAttachment(link_index=-1, shape=shape, friction=0.8),))],
                  solver=solver(friction=0.8, restitution=0.0))
    return world, cube


@pytest.mark.parametrize("kind", ["plane", "stack"])
def test_mesh_cube_worlds_match_jax(cube_file, kind):
    """20 steps of 3 cubes landing at 0.1 m/s, 0.1 mm in: level, tilted,
    and sliding."""
    world, cube = mesh_world(kind, cube_file, "port")
    j_world, _ = mesh_world(kind, cube_file, "jax")
    rest = 0.5 if kind == "plane" else 1.3
    q = cube.zero_q((3,))
    q[:, 6] = rest - 1e-4
    q[1, :4] = torch.tensor([0.02, -0.03, 0.01, 1.0], dtype=torch.float64) / np.sqrt(1 + 0.02**2 + 0.03**2 + 0.01**2)
    q[2, 4:6] = torch.tensor([0.05, -0.04], dtype=torch.float64)
    qd = cube.zero_qd((3,))
    qd[:, 5] = -0.1
    qd[2] = torch.tensor([0.1, -0.2, 0.05, 0.3, 0.1, -0.1], dtype=torch.float64)
    zero = torch.zeros(3, 0, dtype=torch.float64)
    qs, qds = (zero, q), (zero, qd)
    jqs, jqds = tuple(jnp.asarray(x.numpy()) for x in qs), tuple(jnp.asarray(x.numpy()) for x in qds)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=torch.float64)
    rows, j_step = [], j_stepper(j_world, 1e-3)
    for t in range(20):
        solve = pgs.solve_pgs
        pgs.solve_pgs = lambda *args: rows.append((args[1] != 0).sum().item()) or solve(*args)
        try:
            qs, qds = world_step(world, qs, qds, None, gravity, 1e-3)
        finally:
            pgs.solve_pgs = solve
        jqs, jqds = j_step(jqs, jqds, (jnp.zeros((3, 0)), jnp.zeros((3, 0))), jnp.asarray(gravity.numpy()))
        check_states((qs, qds), (jqs, jqds), 1e-10, f"after step {t + 1}")
    assert min(rows) > 0  # contact rows were active at every step
    assert abs(float(qs[1][0, 6]) - rest) < 2e-3
