"""The rest of the JAX package's public API in the port, float64 on the CPU,
each function held to its JAX counterpart on the same numpy inputs (made
from a seed) within 1e-12:

- algebra: ``spatial.top``, ``bottom``, ``zero``, ``safe_norm`` and
  ``safe_normalize`` (and their gradients at v = 0),
  ``quaternion.from_xyzw``, ``split`` and ``rotate``,
  ``rotation.from_axis_angle``, ``Transform.identity``, ``from_pos``,
  ``from_rot``, ``matrix``, ``motion_matrix_to_child`` and
  ``rbi_to_parent``, ``RigidBodyInertia.from_mass_com_inertia``,
  ``ArticulatedBodyInertia.zero`` and ``inv_mul``, and the
  ``algebra``, ``dynamics`` and ``model`` packages' re-exports;
- model: ``REVOLUTE_TYPES``, ``MultiBodyState``, ``MultiBodyModel.dof`` and
  ``motion_subspace``, ``add_link``'s ``x_t_rot`` and ``stiffness`` (a
  stiffness moves ABA as in the JAX package), ``spherical_pendulum`` and
  ``double_pendulum_qdd``;
- ``dynamics.jacobian.point_jacobian_fd`` on a floating base with a
  spherical joint;
- URDF: ``converter.load_urdf``, ``inertia_convention="urdf"`` on a URDF
  with off-diagonal inertias and rotated inertial frames, and
  ``cache.clear_cache``;
- ``native.mesh.load_obj`` and ``load_obj_file``;
  ``utils.checkpoint.save_policy_weights`` and ``load_policy_weights``
  across the two packages both ways; ``utils.file_utils.add_search_path``;
- ``PPONetworks.sample``;
- the package's names (``tds_tpu_torch.World``, ``load_urdf``, ...), which
  import in a fresh interpreter without JAX or triton.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tds_tpu  # noqa: E402
import tds_tpu_torch  # noqa: E402
from tds_tpu.algebra import quaternion as j_quat, rotation as j_rot, spatial as j_spatial  # noqa: E402
from tds_tpu.algebra.inertia import ArticulatedBodyInertia as JABI, RigidBodyInertia as JRBI  # noqa: E402
from tds_tpu.algebra.transform import Transform as JTransform  # noqa: E402
from tds_tpu_torch.algebra import quaternion, rotation, spatial  # noqa: E402
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia  # noqa: E402
from tds_tpu_torch.algebra.transform import Transform  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
RNG = np.random.default_rng(16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(got, want, label="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))), err_msg=label)


def _rotations(n):
    q = RNG.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(j_quat.to_matrix(jnp.asarray(q)))


# -- algebra ----------------------------------------------------------------
def test_spatial_helpers():
    v = RNG.normal(size=(5, 6))
    _close(spatial.top(_t(v)), j_spatial.top(v), "top")
    _close(spatial.bottom(_t(v)), j_spatial.bottom(v), "bottom")
    zero = spatial.zero(torch.float64, (2, 3))
    assert zero.dtype == torch.float64
    _close(zero, j_spatial.zero(jnp.float64, (2, 3)), "zero")
    w = np.concatenate([RNG.normal(size=(4, 3)), np.zeros((1, 3))])
    _close(spatial.safe_norm(_t(w)), j_spatial.safe_norm(jnp.asarray(w)), "safe_norm")
    got, got_n = spatial.safe_normalize(_t(w))
    want, want_n = j_spatial.safe_normalize(jnp.asarray(w))
    _close(got, want, "safe_normalize")
    _close(got_n, want_n, "safe_normalize's norm")
    # the gradients, at v = 0 among them, are finite and the JAX package's
    x = _t(w).requires_grad_()
    (g,) = torch.autograd.grad(spatial.safe_normalize(x)[0].sum() + spatial.safe_norm(x).sum(), x)
    want_g = jax.grad(lambda y: j_spatial.safe_normalize(y)[0].sum() + j_spatial.safe_norm(y).sum())(jnp.asarray(w))
    assert bool(torch.isfinite(g).all())
    _close(g, want_g, "gradients")


def test_quaternion_and_rotation_helpers():
    x, y, z, w = (RNG.normal(size=3) for _ in range(4))
    _close(quaternion.from_xyzw(*map(_t, (x, y, z, w))), j_quat.from_xyzw(x, y, z, w), "from_xyzw")
    q = RNG.normal(size=(4, 4))
    vec, w = quaternion.split(_t(q))
    want_vec, want_w = j_quat.split(jnp.asarray(q))
    _close(vec, want_vec, "split vec")
    _close(w, want_w, "split w")
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = RNG.normal(size=(4, 3))
    _close(quaternion.rotate(_t(q), _t(v)), j_quat.rotate(jnp.asarray(q), jnp.asarray(v)), "rotate")
    _close(quaternion.rotate(_t(q[0]), _t(v)), j_quat.rotate(jnp.asarray(q[0]), jnp.asarray(v)), "rotate, broadcast")
    axis = RNG.normal(size=(4, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = RNG.normal(size=4)
    _close(rotation.from_axis_angle(_t(axis), _t(angle)), j_rot.from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)),
           "from_axis_angle")


def test_transform_helpers():
    ident, want = Transform.identity(torch.float64, (2,)), JTransform.identity(jnp.float64, (2,))
    _close(ident.pos, want.pos, "identity pos")
    _close(ident.rot, want.rot, "identity rot")
    pos, rot = RNG.normal(size=(3, 3)), _rotations(3)
    for got, want in ((Transform.from_pos(_t(pos)), JTransform.from_pos(pos)), (Transform.from_rot(_t(rot)), JTransform.from_rot(rot))):
        _close(got.pos, want.pos, "from_* pos")
        _close(got.rot, want.rot, "from_* rot")
    x, jx = Transform(_t(pos), _t(rot)), JTransform(jnp.asarray(pos), jnp.asarray(rot))
    _close(x.matrix(), jx.matrix(), "matrix")
    s = RNG.normal(size=(3, 6, 3))
    _close(x.motion_matrix_to_child(_t(s)), jx.motion_matrix_to_child(jnp.asarray(s)), "motion_matrix_to_child")
    mass, com = RNG.uniform(0.5, 2.0, size=3), RNG.normal(size=(3, 3))
    a = RNG.normal(size=(3, 3, 3))
    icom = a @ np.swapaxes(a, -1, -2)
    rbi = RigidBodyInertia.from_mass_com_inertia(_t(mass), _t(com), _t(icom))
    jrbi = JRBI.from_mass_com_inertia(jnp.asarray(mass), jnp.asarray(com), jnp.asarray(icom))
    for name in ("mass", "h", "inertia"):
        _close(getattr(rbi, name), getattr(jrbi, name), f"from_mass_com_inertia {name}")
    moved, jmoved = x.rbi_to_parent(rbi), jx.rbi_to_parent(jrbi)
    for name in ("mass", "h", "inertia"):
        _close(getattr(moved, name), getattr(jmoved, name), f"rbi_to_parent {name}")


def test_articulated_inertia_helpers():
    z, jz = ArticulatedBodyInertia.zero(torch.float64, (2,)), JABI.zero(jnp.float64, (2,))
    for name in ("I", "H", "M"):
        _close(getattr(z, name), getattr(jz, name), f"zero {name}")
    m = RNG.normal(size=(3, 6, 6))
    m = m @ np.swapaxes(m, -1, -2) + 6.0 * np.eye(6)  # symmetric positive definite
    blocks = (m[:, :3, :3], m[:, :3, 3:], m[:, 3:, 3:])
    abi, jabi = ArticulatedBodyInertia(*map(_t, blocks)), JABI(*map(jnp.asarray, blocks))
    f = RNG.normal(size=(3, 6))
    a = abi.inv_mul(_t(f))
    _close(a, jabi.inv_mul(jnp.asarray(f)), "inv_mul")
    _close(abi.mul_motion(a), f, "Ia (Ia^-1 f)", tol=1e-10)


def test_package_reexports():
    import tds_tpu_torch.algebra as alg
    import tds_tpu_torch.dynamics as dyn
    import tds_tpu_torch.model as mdl
    import importlib

    from tds_tpu_torch.dynamics import integrator, kinematics

    assert alg.Transform is Transform and alg.RigidBodyInertia is RigidBodyInertia and alg.spatial is spatial
    assert dyn.fk_links is kinematics.fk_links and dyn.integrate_q is integrator.integrate_q
    # as in the JAX package, the package's name is the function, not its module
    assert dyn.forward_dynamics is importlib.import_module("tds_tpu_torch.dynamics.forward_dynamics").forward_dynamics
    from tds_tpu_torch.model import joints, multibody

    assert mdl.MultiBodyState is multibody.MultiBodyState and mdl.JointType is joints.JointType
    from tds_tpu_torch.urdf import cache

    assert tds_tpu_torch.load_urdf is cache.construct and tds_tpu.load_urdf.__name__ == "construct"


# -- model ------------------------------------------------------------------
def test_model_names():
    from tds_tpu.model import joints as j_joints
    from tds_tpu.model.multibody import MultiBodyState as JState
    from tds_tpu.urdf.cache import construct as j_construct
    from tds_tpu_torch.model import joints
    from tds_tpu_torch.model.multibody import MultiBodyState
    from tds_tpu_torch.urdf.cache import construct

    assert tuple(int(t) for t in joints.REVOLUTE_TYPES) == tuple(int(t) for t in j_joints.REVOLUTE_TYPES)
    q, qd = RNG.normal(size=4), RNG.normal(size=3)
    state, jstate = MultiBodyState(q=_t(q), qd=_t(qd)), JState(q=jnp.asarray(q), qd=jnp.asarray(qd))
    _close(state.q, jstate.q, "state q")
    _close(state.qd, jstate.qd, "state qd")
    model, jmodel = construct("humanoid_xyz_spherical.urdf")[0], j_construct("humanoid_xyz_spherical.urdf")[0]
    assert model.dof == jmodel.dof == model.dof_q
    for i in range(model.num_links):
        _close(model.motion_subspace(i), jmodel.motion_subspace(i), f"motion_subspace({i})")


def _stiff_chain(chain_type, joint_type, stiffness, rots, dtype):
    """A 3-link chain with rotated joint frames (x_t_rot given) and joint
    stiffness, through either package's MultiBodyBuilder."""
    b = chain_type(is_floating=False, name="stiff")
    for i in range(3):
        b.add_link(
            joint_type.REVOLUTE_AXIS if i != 1 else joint_type.PRISMATIC_Y,
            parent=i - 1,
            x_t_pos=(0.1 * i, 0.0, -0.3),
            x_t_rot=rots[i],
            axis=(0.3, 0.5, 0.8) if i != 1 else (0.0, 1.0, 0.0),
            mass=1.0 + i,
            com=(0.05, 0.0, -0.15),
            inertia_about_com=(0.01, 0.02, 0.03),
            stiffness=stiffness[i],
            damping=0.1,
        )
    return b.finalize(dtype=dtype)


def test_add_link_stiffness_and_rotation_move_aba_as_in_jax():
    from tds_tpu.dynamics import forward_dynamics as j_fd
    from tds_tpu.model.joints import JointType as JJT
    from tds_tpu.model.multibody import MultiBodyBuilder as JBuilder
    from tds_tpu_torch.dynamics import forward_dynamics
    from tds_tpu_torch.model.joints import JointType
    from tds_tpu_torch.model.multibody import MultiBodyBuilder

    stiffness, rots = (40.0, 15.0, 25.0), _rotations(3)
    model = _stiff_chain(MultiBodyBuilder, JointType, stiffness, rots, torch.float64)
    jmodel = _stiff_chain(JBuilder, JJT, stiffness, rots, jnp.float64)
    _close(model.stiffness, jmodel.stiffness, "stiffness")
    _close(model.x_t_rot, jmodel.x_t_rot, "x_t_rot")
    q, qd, tau = (RNG.normal(size=(4, 3)) for _ in range(3))
    g = np.array([0.0, 0.0, -9.81])
    got = forward_dynamics(model, _t(q), _t(qd), _t(tau), _t(g))
    want = jax.jit(jax.vmap(lambda a, b, c: j_fd(jmodel, a, b, c, jnp.asarray(g))))(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau))
    _close(got, want, "qdd")
    loose = _stiff_chain(MultiBodyBuilder, JointType, (0.0, 0.0, 0.0), rots, torch.float64)
    assert (forward_dynamics(loose, _t(q), _t(qd), _t(tau), _t(g)) - got).abs().max() > 1.0


def test_pendulums():
    from tds_tpu.dynamics import forward_dynamics as j_fd
    from tds_tpu.model import pendulum as j_pendulum
    from tds_tpu_torch.dynamics import forward_dynamics
    from tds_tpu_torch.model import pendulum

    model, jmodel = pendulum.spherical_pendulum(3, masses=(1.0, 2.0, 0.5)), j_pendulum.spherical_pendulum(3, masses=(1.0, 2.0, 0.5))
    for name in ("x_t_pos", "x_t_rot", "mass", "com", "inertia"):
        _close(getattr(model, name), getattr(jmodel, name), name)
    assert model.joint_types == jmodel.joint_types and model.dof_q == jmodel.dof_q == 12
    quats = RNG.normal(size=(2, 3, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    q, qd, g = quats.reshape(2, 12), RNG.normal(size=(2, 9)), np.array([0.0, 0.0, -9.81])
    got = forward_dynamics(model, _t(q), _t(qd), torch.zeros(2, 9, dtype=torch.float64), _t(g))
    want = jax.jit(jax.vmap(lambda a, b: j_fd(jmodel, a, b, jnp.zeros(9), jnp.asarray(g))))(jnp.asarray(q), jnp.asarray(qd))
    # the links' 1e-6 inertias about their rods leave the spin about a rod
    # ill-conditioned: rounding there grows by ~1e6, so the dynamics of the
    # model (beyond the constructor's fields, equal above) agree to 1e-9
    _close(got, want, "spherical pendulum qdd", tol=1e-9)
    q, qd = RNG.normal(size=(5, 2)), RNG.normal(size=(5, 2))
    got = pendulum.double_pendulum_qdd(_t(q), _t(qd), m1=1.5, l2=0.7)
    _close(got, j_pendulum.double_pendulum_qdd(jnp.asarray(q), jnp.asarray(qd), m1=1.5, l2=0.7), "double_pendulum_qdd")


def test_point_jacobian_fd():
    from tds_tpu.dynamics.jacobian import point_jacobian_fd as j_fd_jac
    from tds_tpu.urdf.cache import construct as j_construct
    from tds_tpu_torch.dynamics.jacobian import point_jacobian, point_jacobian_fd
    from tds_tpu_torch.urdf.cache import construct

    urdf = "pendulum5spherical.urdf"
    model, jmodel = construct(urdf, is_floating=True)[0], j_construct(urdf, is_floating=True)[0]
    q = RNG.normal(size=model.dof_q) * 0.3
    for k in [0] + [model.q_offsets[i] for i in range(model.num_links) if model.joint_types[i] == 5]:
        q[k:k + 4] = RNG.normal(size=4)
        q[k:k + 4] /= np.linalg.norm(q[k:k + 4])
    point = RNG.normal(size=3)
    link = model.num_links - 1
    got = point_jacobian_fd(model, _t(q), link, _t(point))
    _close(got, j_fd_jac(jmodel, jnp.asarray(q), link, jnp.asarray(point)), "point_jacobian_fd", tol=1e-10)
    # and close to the analytic Jacobian, to the difference's order
    exact = point_jacobian(model, _t(q)[None], link, _t(point)[None])[0]
    assert (got - exact).abs().max() < 1e-2


# -- URDF -------------------------------------------------------------------
URDF_FULL_INERTIA = """<?xml version="1.0"?>
<robot name="tilted">
  <link name="base">
    <inertial>
      <origin xyz="0.01 -0.02 0.03" rpy="0.3 -0.2 0.5"/>
      <mass value="2.0"/>
      <inertia ixx="0.4" ixy="0.05" ixz="-0.03" iyy="0.3" iyz="0.02" izz="0.2"/>
    </inertial>
  </link>
  <link name="arm">
    <inertial>
      <origin xyz="0.1 0.0 -0.2" rpy="-0.4 0.7 0.1"/>
      <mass value="1.5"/>
      <inertia ixx="0.05" ixy="-0.01" ixz="0.004" iyy="0.06" iyz="0.008" izz="0.02"/>
    </inertial>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="0 0.1 0" rpy="0.2 0 0"/>
    <axis xyz="0 1 0"/>
  </joint>
</robot>
"""


def test_urdf_convention_and_loaders(tmp_path):
    from tds_tpu.urdf import converter as j_converter
    from tds_tpu.urdf.parser import parse_urdf_string as j_parse
    from tds_tpu_torch.urdf import cache, converter
    from tds_tpu_torch.urdf.parser import parse_urdf_string

    fields = ("mass", "com", "inertia", "base_mass", "base_com", "base_inertia", "x_t_pos", "x_t_rot")
    for convention in ("urdf", "reference"):
        model = converter.convert_to_multibody(parse_urdf_string(URDF_FULL_INERTIA), inertia_convention=convention)[0]
        jmodel = j_converter.convert_to_multibody(j_parse(URDF_FULL_INERTIA), inertia_convention=convention)[0]
        for name in fields:
            _close(getattr(model, name), getattr(jmodel, name), f"{convention}: {name}")
    off_diagonal = model.inertia[0] - torch.diag(torch.diagonal(model.inertia[0]))
    urdf = converter.convert_to_multibody(parse_urdf_string(URDF_FULL_INERTIA), inertia_convention="urdf")[0]
    assert (urdf.inertia - model.inertia).abs().max() > 1e-3 and off_diagonal.abs().max() > 0
    with pytest.raises(ValueError):
        converter.convert_to_multibody(parse_urdf_string(URDF_FULL_INERTIA), inertia_convention="spec")
    path = tmp_path / "tilted.urdf"
    path.write_text(URDF_FULL_INERTIA)
    model, geoms = converter.load_urdf(str(path), is_floating=True)
    jmodel, jgeoms = j_converter.load_urdf(str(path), is_floating=True)
    assert model.is_floating and model.dof_q == jmodel.dof_q and len(geoms) == len(jgeoms)
    for name in fields:
        _close(getattr(model, name), getattr(jmodel, name), f"load_urdf: {name}")
    cache.construct("pendulum5.urdf")
    assert cache._MODEL_CACHE and cache._DOC_CACHE is not None
    cache.clear_cache()
    assert not cache._MODEL_CACHE and not cache._DOC_CACHE


# -- mesh, utilities --------------------------------------------------------
OBJ = """# a unit square and a triangle, 1-based, negative and slashed indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
v 0.5 0.5 1
f -1/1 1//1 2/2/2
"""


def test_obj_loaders(tmp_path):
    from tds_tpu.native import mesh as j_mesh
    from tds_tpu_torch.native import mesh

    verts, tris = mesh.load_obj(OBJ)
    want_verts, want_tris = j_mesh.load_obj(OBJ)
    _close(verts, want_verts, "vertices")
    assert tris.dtype == np.int32 and np.array_equal(tris, want_tris) and len(tris) == 3
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    got = mesh.load_obj_file(str(path))
    assert np.array_equal(got[0], verts) and np.array_equal(got[1], tris)


def test_policy_weights_between_the_packages(tmp_path):
    from tds_tpu.utils import checkpoint as j_checkpoint
    from tds_tpu_torch.utils import checkpoint

    params = RNG.normal(size=37)
    checkpoint.save_policy_weights(str(tmp_path / "port" / "w.bin"), _t(params), reward=12.5)
    assert np.array_equal(j_checkpoint.load_policy_weights(str(tmp_path / "port" / "w.bin")), params)
    j_checkpoint.save_policy_weights(str(tmp_path / "jax.bin"), jnp.asarray(params), reward=12.5)
    assert np.array_equal(checkpoint.load_policy_weights(str(tmp_path / "jax.bin")), params)
    assert json.loads((tmp_path / "port" / "w.bin.json").read_text()) == json.loads((tmp_path / "jax.bin.json").read_text())
    checkpoint.save_policy_weights(str(tmp_path / "plain.bin"), params.astype(np.float32))
    assert json.loads((tmp_path / "plain.bin.json").read_text()) == {"size": 37}


def test_add_search_path(tmp_path, monkeypatch):
    from tds_tpu_torch.utils import file_utils

    monkeypatch.setattr(file_utils, "_SEARCH_PATHS", [])
    (tmp_path / "only_here.urdf").write_text(URDF_FULL_INERTIA)
    with pytest.raises(FileNotFoundError):
        file_utils.find_file("only_here.urdf")
    file_utils.add_search_path(str(tmp_path))
    assert file_utils.find_file("only_here.urdf") == str(tmp_path / "only_here.urdf")
    assert file_utils.data_search_paths().index(str(tmp_path)) < len(file_utils.data_search_paths()) - 2


def test_ppo_networks_sample():
    """The action is mean + std eps for eps from the generator, and its
    log-probability is the JAX package's for the same action."""
    from tds_tpu.learn.ppo import PPONetworks as JNets
    from tds_tpu_torch.learn.ppo import PPONetworks

    nets, jnets = PPONetworks(5, 3, hidden=(8,)), JNets(5, 3, hidden=(8,))
    params = {"policy": _t(RNG.normal(size=nets.policy.num_parameters) * 0.3),
              "value": _t(RNG.normal(size=nets.value.num_parameters) * 0.3), "log_std": _t([-0.5, 0.1, -1.0])}
    obs = _t(RNG.normal(size=(6, 5)))
    action, logp = nets.sample(params, obs, torch.Generator().manual_seed(9))
    eps = torch.randn((6, 3), generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    mean, std = nets.dist(params, obs)
    _close(action, (mean + std * eps).numpy(), "action")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    _close(logp, jnets.log_prob(jparams, jnp.asarray(obs.numpy()), jnp.asarray(action.numpy())), "log_prob")


def test_the_package_names_import_without_jax():
    """The acceptance line: the package's names in a fresh interpreter,
    with no jax, flax, tds_tpu or triton module loaded."""
    code = ("import sys, tds_tpu_torch as t; t.World; t.load_urdf; t.MultiBodyState; t.build_world; t.Transform; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tds_tpu', 'triton')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
