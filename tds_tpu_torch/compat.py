"""pytinydiffsim-flavoured compatibility shim (counterpart of
tds_tpu/compat.py): the same 84 names the reference's pybind11 module
binds (python/pytinydiffsim.inl), on top of the port's functional core, so
that a reference user script ports mechanically. It is a veneer: new code
should call the functional API on batched tensors directly.

Objects hold tensors on an explicit device, the card unless ``device``
names another, in float64 (the reference's double) unless ``dtype`` says
otherwise. A multibody's state is unbatched, (dof_q,) and (dof_qd,), as in
the reference; each call runs the core on a batch of one, so that
``TinyWorld.step``'s contact solve runs the PGS kernel K1 at B = 1 on the
card. Random draws (``TinyNeuralNetwork.initialize``, the env adapters)
come from a ``torch.Generator`` on the object's device.

The names cover the math types and constructors, TinyMultiBody, TinyWorld
and the URDF parsers, the scalar-trait math surface, contact-point and
constraint-solver objects, actuators, IK, TinyRaycast volume fitting,
enums with their members at module scope, the env simulation records and
stateful EnvOutput-style adapters. What is not bound, and why, closes the
file.
"""

import enum as _enum
import math as _math
from typing import List, Optional

import numpy as np
import torch

from tds_tpu_torch.algebra import quaternion as _quat
from tds_tpu_torch.algebra import rotation as _rotation
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia
from tds_tpu_torch.algebra.spatial import cross_matrix as _cross_matrix
from tds_tpu_torch.algebra.transform import Transform as _Transform
from tds_tpu_torch.contact.spring import VelocitySmoothing as _VelSmooth
from tds_tpu_torch.control.ik import IKMethod, IKTarget, inverse_kinematics
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics as _fd
from tds_tpu_torch.dynamics.integrator import integrate_euler as _ie
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd as _ieq
from tds_tpu_torch.dynamics.inverse_dynamics import inverse_dynamics as _id
from tds_tpu_torch.dynamics.jacobian import point_jacobian as _pj
from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q as _fkq
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix as _mm
from tds_tpu_torch.learn.nn import Activation as _Activation
from tds_tpu_torch.model.geometry import Box as TinyBox
from tds_tpu_torch.model.geometry import Capsule as TinyCapsule
from tds_tpu_torch.model.geometry import GeomAttachment
from tds_tpu_torch.model.geometry import Plane as TinyPlane
from tds_tpu_torch.model.geometry import Sphere as TinySphere
from tds_tpu_torch.model.joints import JointType as _JointType
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.urdf.cache import construct, construct_from_string
from tds_tpu_torch.urdf.structures import UrdfCollision as TinyUrdfCollision
from tds_tpu_torch.urdf.structures import UrdfGeometry as TinyUrdfGeometry
from tds_tpu_torch.urdf.structures import UrdfInertial as TinyUrdfInertial
from tds_tpu_torch.urdf.structures import UrdfJoint as TinyUrdfJoint
from tds_tpu_torch.urdf.structures import UrdfLink as TinyUrdfLink
from tds_tpu_torch.urdf.structures import UrdfStructures as TinyUrdfStructures
from tds_tpu_torch.urdf.structures import UrdfVisual as TinyUrdfVisual
from tds_tpu_torch.utils.tensors import resolve_device
from tds_tpu_torch.world import ContactSolverParams, World, build_world, make_ground_plane, resolve_contacts

_F64 = torch.float64


def _tensor(x, dtype=_F64, device=None):
    """``x`` as a tensor in ``dtype`` on ``device`` (the card unless named)."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def _like(x, like: torch.Tensor):
    """``x`` as a tensor in ``like``'s dtype and on its device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _arg(x):
    """A number or array as a float64 tensor where it lies (numbers and
    numpy on the CPU); a tensor stays as it is."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=_F64)


# ---- small math helpers (TinyVector3 / TinyQuaternion) --------------------
def Vector3(x=0.0, y=0.0, z=0.0, device=None):
    return _tensor([x, y, z], device=device)


def Quaternion(x=0.0, y=0.0, z=0.0, w=1.0, device=None):
    return _tensor([x, y, z, w], device=device)


quat_to_matrix = _quat.to_matrix
matrix_to_quat = _quat.from_matrix
quat_from_xyzw = Quaternion


def get_axis_difference_quaternion(q_desired, q_actual):
    """Orientation error as a rotation vector (matrix_utils.hpp:77-89)."""
    from tds_tpu_torch.control.pd import spherical_pd_error

    return spherical_pd_error(q_desired, q_actual)


class TinyMultiBody:
    """A static model and its mutable state (q, qd, qdd, tau), unbatched,
    on the model's device."""

    def __init__(self, model: MultiBodyModel, geoms=()):
        self.model = model
        self.geoms = tuple(geoms)
        self.q = model.zero_q()
        self.qd = model.zero_qd()
        self.qdd = model.zero_qd()
        self.tau = self.q.new_zeros(model.dof_actuated)

    def dof(self):
        return self.model.dof_q

    def dof_qd(self):
        return self.model.dof_qd

    def dof_actuated(self):
        return self.model.dof_actuated

    def set_q(self, q):
        self.q = _like(q, self.q)

    def set_qd(self, qd):
        self.qd = _like(qd, self.qd)

    def set_tau(self, tau):
        self.tau = _like(tau, self.tau)

    def forward_dynamics(self, gravity):
        g = _like(gravity, self.q)
        self.qdd = _fd(self.model, self.q[None], self.qd[None], self.tau[None], g)[0]
        return self.qdd

    def integrate(self, dt):
        q, qd = _ie(self.model, self.q[None], self.qd[None], self.qdd[None], dt)
        self.q, self.qd = q[0], qd[0]

    def mass_matrix(self):
        return _mm(self.model, self.q[None])[0]

    def point_jacobian(self, link_index, point, is_local=False):
        return _pj(self.model, self.q[None], link_index, _like(point, self.q)[None], is_local)[0]


class TinyWorld:
    """Multibodies and a ground plane; ``step`` applies the contact impulses
    to the bodies' velocities (world.hpp:29-368; as in the reference, the
    multibody integration stays with the caller)."""

    def __init__(self, device=None, dtype=_F64):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.gravity = torch.tensor([0.0, 0.0, -9.81], dtype=dtype, device=self.device)
        self.bodies: List[TinyMultiBody] = []
        self._world: Optional[World] = None
        self._plane = make_ground_plane(dtype=dtype, device=self.device)
        self.friction = 0.5
        self.restitution = 0.0
        self.num_solver_iterations = 1

    def set_gravity(self, g):
        self.gravity = _like(g, self.gravity)

    def create_multi_body(self, model: MultiBodyModel, geoms=()):
        mb = TinyMultiBody(model, geoms)
        self.bodies.append(mb)
        self._world = None
        return mb

    def _build(self):
        entries = [self._plane] + [(mb.model, mb.geoms) for mb in self.bodies]
        if self._world is None or len(self._world.bodies) != len(entries):
            self._world = build_world(
                entries,
                solver=ContactSolverParams(
                    pgs_iterations=self.num_solver_iterations, friction=self.friction, restitution=self.restitution
                ),
            )
        return self._world

    def step(self, dt):
        """One contact-impulse pass over every body's velocity (a batch of
        one: K1 on the card)."""
        world = self._build()
        zero = self.gravity.new_zeros(1, 0)
        qs = (zero,) + tuple(mb.q[None] for mb in self.bodies)
        qds = (zero,) + tuple(mb.qd[None] for mb in self.bodies)
        new_qds = resolve_contacts(world, qs, qds, dt)
        for mb, qd in zip(self.bodies, new_qds[1:]):
            mb.qd = qd[0]


class UrdfParser:
    @staticmethod
    def load_urdf(path, is_floating=False, device=None, dtype=_F64):
        model, geoms = construct(path, is_floating=is_floating)
        return TinyMultiBody(model.to(resolve_device(device), dtype), geoms)

    @staticmethod
    def load_urdf_from_string(text, is_floating=False, device=None, dtype=_F64):
        model, geoms = construct_from_string(text, is_floating=is_floating)
        return TinyMultiBody(model.to(resolve_device(device), dtype), geoms)


# free functions mirroring pytinydiffsim.inl:657-686
def forward_dynamics(mb: TinyMultiBody, gravity):
    return mb.forward_dynamics(gravity)


def integrate_euler(mb: TinyMultiBody, dt):
    mb.integrate(dt)


def mass_matrix(mb: TinyMultiBody):
    return mb.mass_matrix()


def point_jacobian(mb: TinyMultiBody, link_index, point, is_local=False):
    return mb.point_jacobian(link_index, point, is_local)


def inverse_dynamics(mb: TinyMultiBody, qdd, gravity):
    return _id(mb.model, mb.q[None], mb.qd[None], _like(qdd, mb.q)[None], _like(gravity, mb.q))[0]


# ---- math parity names (pytinydiffsim.inl vector/quaternion surface) -------
def VectorX(values, device=None):
    return _tensor(values, device=device)


def quat_from_euler_rpy(rpy):
    rpy = _arg(rpy)
    return _quat.from_matrix(_rotation.from_rpy(rpy[..., 0], rpy[..., 1], rpy[..., 2]))


def _matrix_rpy(m):
    """Roll, pitch, yaw of a rotation matrix (eigen_algebra.hpp get_euler_rpy)."""
    sy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    return torch.stack(
        [torch.atan2(m[..., 2, 1], m[..., 2, 2]), torch.atan2(-m[..., 2, 0], sy), torch.atan2(m[..., 1, 0], m[..., 0, 0])],
        dim=-1,
    )


def get_euler_rpy(q):
    """Quaternion -> roll, pitch, yaw."""
    return _matrix_rpy(_quat.to_matrix(_arg(q)))


quaternion_integrate = _quat.integrate_world
quat_velocity = _quat.velocity_world
quat_axis_angle = _quat.from_axis_angle


# ---- single rigid body (pytinydiffsim.inl TinyRigidBody) --------------------
class TinyRigidBody:
    """Mutable veneer over the functional rigid body (rigid_body.py)."""

    def __init__(self, mass, inv_inertia_world=None, position=None, device=None, dtype=_F64):
        from tds_tpu_torch import rigid_body as _rb

        device = resolve_device(device)
        self.params = _rb.RigidBodyParams.create(mass, inv_inertia_world, dtype=dtype, device=device)
        self.state = _rb.RigidBodyState.create(position=position, dtype=dtype, device=device)
        self._rb = _rb

    def _t(self, x):
        return _like(x, self.state.position)

    @property
    def world_pose(self):
        return self.state.position, self.state.orientation

    def apply_gravity(self, gravity):
        self.state = self._rb.apply_gravity(self.state, self.params, self._t(gravity))

    def apply_central_force(self, force):
        self.state = self._rb.apply_central_force(self.state, self._t(force))

    def apply_force_impulse(self, dt):
        self.state = self._rb.apply_force_impulse(self.state, self.params, dt)

    def apply_impulse(self, impulse, rel_pos):
        self.state = self._rb.apply_impulse(self.state, self.params, self._t(impulse), self._t(rel_pos))

    def clear_forces(self):
        self.state = self._rb.clear_forces(self.state)

    def integrate(self, dt):
        self.state = self._rb.integrate(self.state, dt)


# ---- neural network (pytinydiffsim.inl TinyNeuralNetwork) -------------------
class TinyNeuralNetwork:
    """A specification and flat parameters; ``compute`` as in the bindings."""

    def __init__(self, input_dim, layer_dims, activations=None, learn_bias=True, device=None, dtype=_F64):
        from tds_tpu_torch.learn.nn import MLPSpec

        self.spec = MLPSpec(input_dim, layer_dims, activations, use_bias=learn_bias)
        self.device, self.dtype = resolve_device(device), dtype
        self.params = torch.zeros(self.spec.num_parameters, dtype=dtype, device=self.device)

    @property
    def num_parameters(self):
        return self.spec.num_parameters

    def set_parameters(self, params):
        self.params = _like(params, self.params)

    def compute(self, inputs):
        return self.spec.apply(self.params, _like(inputs, self.params))

    def initialize(self, generator: Optional[torch.Generator] = None, method="xavier"):
        """Parameters drawn from ``generator`` (None: one seeded 0 on the
        network's device)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.params = self.spec.init(generator, scheme=method, dtype=self.dtype, device=self.device)
        return self.params


# ---- raycasting (pytinydiffsim.inl TinyRaycast) ------------------------------
def cast_rays(origins, targets, shapes, transforms):
    from tds_tpu_torch.collision.raycast import cast_rays as _cast

    like = transforms[0].pos
    return _cast(_like(origins, like), _like(targets, like), shapes, transforms)


# ---- environments (pytinydiffsim.inl:1078-1185) ------------------------------
def ReacherEnv(**kw):
    """A stateful (.inl-style) adapter over the reacher env: reset() /
    step(a) / rollout, plus the functional reset(generator) / step(state,
    action)."""
    from tds_tpu_torch.envs.reacher import ReacherEnv as _E

    return TinyEnv(_E(**kw), output_cls=ReacherEnvOutput, rollout_cls=ReacherRolloutOutput)


def CartpoleEnv(**kw):
    from tds_tpu_torch.envs.cartpole import CartpoleEnv as _E

    return TinyEnv(_E(**kw), output_cls=CartpoleEnvOutput, rollout_cls=CartpoleRolloutOutput)


def AntEnv(**kw):
    from tds_tpu_torch.envs.ant import AntEnv as _E

    return _E(**kw)


def LaikagoEnv(**kw):
    from tds_tpu_torch.envs.laikago import LaikagoEnv as _E

    return _E(**kw)


def _vectorized(env, num_envs, auto_reset=True):
    from tds_tpu_torch.envs.vectorized import VectorizedEnv

    return VectorizedEnv(env, num_envs, auto_reset=auto_reset)


def VectorizedAntEnv(num_envs: int = 128, auto_reset: bool = True, **kw):
    """The batched ant env (inl:1185) behind a TinyVectorizedEnv adapter."""
    return TinyVectorizedEnv(
        _vectorized(AntEnv(**kw), num_envs, auto_reset),
        urdf_filename="gym/ant_org_xyz_xyzrot.urdf",
        output_cls_name="VectorizedAntEnvOutput",
    )


def VectorizedLaikagoEnv(num_envs: int = 128, auto_reset: bool = True, **kw):
    """The batched laikago env (inl:1165)."""
    return TinyVectorizedEnv(
        _vectorized(LaikagoEnv(**kw), num_envs, auto_reset),
        urdf_filename="laikago/laikago_toes_zup_xyz_xyzrot.urdf",
        output_cls_name="VectorizedLaikagoEnvOutput",
    )


def fraction(n, d):
    """The scalar trait's constant constructor (tiny_double_utils.h)."""
    return float(n) / float(d)


# ---- scalar-trait math surface (pytinydiffsim.inl:676-686) ------------------
def pi():
    return float(np.pi)


def copy(x):
    """A value copy (inl:658)."""
    return _arg(x).clone()


def cos(x):
    return torch.cos(_arg(x))


def sin(x):
    return torch.sin(_arg(x))


def acos(x):
    return torch.arccos(_arg(x))


def sqrt(x):
    return torch.sqrt(_arg(x))


def max(a, b):  # noqa: A001 - the bindings' name
    return torch.maximum(_arg(a), _arg(b))


def min(a, b):  # noqa: A001
    return torch.minimum(_arg(a), _arg(b))


def clip(x, lo, hi):
    return torch.clamp(_arg(x), lo, hi)


def where_gt(a, b, if_true, if_false):
    return torch.where(_arg(a) > _arg(b), _arg(if_true), _arg(if_false))


def where_lt(a, b, if_true, if_false):
    return torch.where(_arg(a) < _arg(b), _arg(if_true), _arg(if_false))


def where_eq(a, b, if_true, if_false):
    return torch.where(_arg(a) == _arg(b), _arg(if_true), _arg(if_false))


def quat_difference(start, end):
    """The shortest-arc difference start^-1 * end (inl:670)."""
    start, end = _arg(start), _arg(end)
    end = torch.where((start * end).sum(-1, keepdim=True) < 0.0, -end, end)
    return _quat.mul(_quat.conjugate(start), end)


def quaternion_axis_angle(axis, angle):
    """inl:671 Quaternion_Axis_Angle."""
    axis = _arg(axis)
    return _quat.from_axis_angle(axis, _like(angle, axis))


def matrix_to_euler_xyz(m):
    """inl:673 (extrinsic xyz, the matrix's roll, pitch, yaw)."""
    return _matrix_rpy(_arg(m))


def quat_integrate(q, angular_velocity, dt):
    """inl:666 MyQuatIntegrate."""
    q = _arg(q)
    return _quat.integrate_world(q, _like(angular_velocity, q), dt)


def find_file(name):
    """inl:669 MyFindFile, bundled data first."""
    from tds_tpu_torch.utils.file_utils import find_file as _ff

    return _ff(name)


def forward_kinematics(mb: TinyMultiBody):
    """inl:660: (base_x_world, links_x_world) of the body's q."""
    base_x, links_x, _ = _fkq(mb.model, mb.q)
    return base_x, links_x


def integrate_euler_qdd(mb: TinyMultiBody, dt):
    """inl:663: the velocity update from qdd alone (q untouched)."""
    mb.qd = _ieq(mb.model, mb.q[None], mb.qd[None], mb.qdd[None], dt)[0]


def link_transform_base_frame(mb: TinyMultiBody, link_index: int):
    """inl:668 MyGetLinkTransformInBase."""
    base_x, links_x, _ = _fkq(mb.model, mb.q)
    return base_x.inverse().compose(links_x[link_index])


def compute_inertia_dyad(mass, com, inertia_c):
    """inl:664 MyComputeInertia: the RigidBodyInertia of a mass, a centre of
    mass and the inertia about it (parallel axis: I_o = I_c + m c_x c_x^T,
    h = m c)."""
    com = _arg(com)
    mass, inertia_c = _like(mass, com), _like(inertia_c, com)
    cx = _cross_matrix(com)
    inertia = inertia_c + mass[..., None, None] * (cx @ cx.transpose(-1, -2))
    return RigidBodyInertia(mass=mass, h=mass[..., None] * com, inertia=inertia)


# ---- contact-point classes (pytinydiffsim.inl:751-807) ----------------------
class TinyContactPoint:
    """A mutable record with the bindings' field names (contact_point.hpp);
    vectors on ``device`` (the card unless named)."""

    def __init__(self, device=None):
        z = torch.zeros(3, dtype=_F64, device=resolve_device(device))
        self.world_normal_on_b = z
        self.world_point_on_a = z
        self.world_point_on_b = z
        self.distance = 0.0
        self.normal_force = 0.0
        self.lateral_friction_force_1 = 0.0
        self.lateral_friction_force_2 = 0.0
        self.fr_direction_1 = z
        self.fr_direction_2 = z


class TinyContactPointRigidBody(TinyContactPoint):
    """inl:773-787: a contact between two TinyRigidBody instances."""

    def __init__(self, device=None):
        super().__init__(device)
        self.rigid_body_a: Optional[TinyRigidBody] = None
        self.rigid_body_b: Optional[TinyRigidBody] = None
        self.restitution = 0.0
        self.friction = 0.5


class TinyContactPointMultiBody(TinyContactPoint):
    """inl:789-807: a contact between two TinyMultiBody instances."""

    def __init__(self, device=None):
        super().__init__(device)
        self.multi_body_a: Optional[TinyMultiBody] = None
        self.multi_body_b: Optional[TinyMultiBody] = None
        self.restitution = 0.0
        self.friction = 0.5
        self.link_a = -1
        self.link_b = -1


# ---- constraint solvers (pytinydiffsim.inl:809-856) -------------------------
class TinyConstraintSolver:
    """The rigid-body sequential-impulse solver (inl:809-813)."""

    def resolve_collision(self, cp: TinyContactPointRigidBody, dt):
        from tds_tpu_torch import rigid_body as _rb

        a, b = cp.rigid_body_a, cp.rigid_body_b
        like = a.state.position
        a.state, b.state = _rb.resolve_contact_sequential_impulse(
            a.state, a.params, b.state, b.params,
            _like(cp.world_normal_on_b, like), _like(cp.world_point_on_a, like), _like(cp.world_point_on_b, like),
            _like(cp.distance, like), dt, friction=cp.friction, restitution=cp.restitution,
        )


def _mb_contact_batch(cps, like):
    """TinyContactPointMultiBody records as a ContactBatch of one env."""
    from tds_tpu_torch.collision.narrowphase import Contact
    from tds_tpu_torch.contact.mlcp import ContactBatch

    def stacked(name):
        return torch.stack([_like(getattr(c, name), like) for c in cps])[None]

    contact = Contact(
        normal_on_b=stacked("world_normal_on_b"),
        point_a=stacked("world_point_on_a"),
        point_b=stacked("world_point_on_b"),
        distance=_like([float(c.distance) for c in cps], like)[None],
    )
    return ContactBatch(
        contact=contact,
        link_a=tuple(c.link_a for c in cps),
        link_b=tuple(c.link_b for c in cps),
        friction=_like([c.friction for c in cps], like),
        restitution=_like([c.restitution for c in cps], like),
    )


def _resolve_pair(resolve, contact_points, dt, params):
    """Apply ``resolve`` to the bodies of the contact points; writes qd."""
    if not contact_points:
        return
    cps = list(contact_points)
    a, b = cps[0].multi_body_a, cps[0].multi_body_b
    like = a.q if a.q.numel() else b.q
    qd_a, qd_b, _ = resolve(
        a.model, a.q[None], a.qd[None], b.model, b.q[None], b.qd[None], _mb_contact_batch(cps, like), dt, params
    )
    a.qd, b.qd = qd_a[0], qd_b[0]


class TinyMultiBodyConstraintSolver:
    """The MLCP/PGS solver with the bindings' parameter names (inl:815-822:
    pgs_iterations_, keep_all_points_, cfm_, erp_)."""

    def __init__(self):
        self.pgs_iterations_ = 50
        self.keep_all_points_ = False
        self.cfm_ = 1e-5
        self.erp_ = 0.2
        self.num_friction_dir_ = 1

    def _params(self):
        # keep_all_points_ has no knob: the batched solver emits every
        # candidate row and masks the ones that do not penetrate, the
        # keep_all_points_=True semantics with zero-force inactive rows
        return ContactSolverParams(
            pgs_iterations=self.pgs_iterations_, cfm=self.cfm_, erp=self.erp_, num_friction_dir=self.num_friction_dir_
        )

    def resolve_collision(self, contact_points, dt):
        """Applies the contact impulses and writes qd of both multibodies
        (inl:819 resolve_collision2)."""
        from tds_tpu_torch.contact.mlcp import resolve_collision as _rc

        _resolve_pair(_rc, contact_points, dt, self._params())


class TinyMultiBodyConstraintSolverSpring:
    """The spring-damper solver with the bindings' parameter names
    (inl:836-856; the reference ships this surface behind ``#if 0``)."""

    def __init__(self):
        self.spring_k = 5000.0
        self.damper_d = 100.0
        self.hard_contact_condition = True
        self.exponent_n = 1.0
        self.smoothing_method = 0
        self.smooth_alpha_vel = 100.0
        self.smooth_alpha_normal = -1.0
        self.mu_static = 0.5
        self.andersson_vs = 0.1
        self.andersson_p = 1.0
        self.andersson_ktanh = 10.0
        self.v_transition = 0.01
        self.friction_model = 0

    def _params(self):
        from tds_tpu_torch.contact.spring import SpringContactParams as _P

        return _P(
            spring_k=self.spring_k,
            damper_d=self.damper_d,
            hard_contact_condition=self.hard_contact_condition,
            exponent_n=self.exponent_n,
            smoothing_method=self.smoothing_method,
            smooth_alpha_vel=self.smooth_alpha_vel,
            smooth_alpha_normal=self.smooth_alpha_normal,
            mu_static=self.mu_static,
            andersson_vs=self.andersson_vs,
            andersson_p=self.andersson_p,
            andersson_ktanh=self.andersson_ktanh,
            v_transition=self.v_transition,
            friction_model=self.friction_model,
        )

    def compute_contact_force(self, distance, vn):
        from tds_tpu_torch.contact.spring import compute_contact_force as _f

        distance = _arg(distance)
        return _f(distance, _like(vn, distance), self._params())

    def compute_friction_force(self, f_n, v_t):
        from tds_tpu_torch.contact.spring import compute_friction_force as _f

        f_n = _arg(f_n)
        return _f(f_n, _like(v_t, f_n), self._params())

    def resolve_collision(self, contact_points, dt):
        from tds_tpu_torch.contact.spring import resolve_collision_spring as _rc

        _resolve_pair(_rc, contact_points, dt, self._params())


# ---- inverse kinematics (inl:667, pytinydiffsim_includes.h:325-341) ---------
def inverse_kinematics_compat(mb: TinyMultiBody, target_link_index, target_point):
    """MyInverseKinematics: damped least-squares IK toward one point target
    from the body's q (alpha 0.3, no pull toward a reference pose, as in
    the reference wrapper). Returns the target q; the body is unchanged."""
    res = inverse_kinematics(
        mb.model,
        [IKTarget(int(target_link_index), _like(target_point, mb.q))],
        mb.q[None],
        method=IKMethod.DAMPED_LM,
        alpha=0.3,
        q_reference=mb.q[None],
        q_reference_weight=0.0,
    )
    return res.q[0]


# ---- actuators (tiny_actuator.h; the reference binds none) -----------------
class TinyActuator:
    """tiny_actuator.h:30-76: gear ratios and limits from u to tau."""

    def __init__(self, dof, device=None):
        self.dof = dof
        self.gear_ratios = torch.ones(dof, dtype=_F64, device=resolve_device(device))
        self.limits = torch.full_like(self.gear_ratios, float("inf"))

    def compute_torques(self, u):
        from tds_tpu_torch.control.actuators import DirectActuator

        act = DirectActuator(gear_ratios=_arg(self.gear_ratios), limits=_arg(self.limits))
        tau, _ = act.compute_torques((), None, None, _like(u, act.gear_ratios))
        return tau


class TinyUrdfParser:
    """The TinyUrdfParser binding (inl:1013-1015): ``load_urdf`` returns the
    parsed structures; UrdfToMultiBody2 converts them."""

    def load_urdf(self, path):
        from tds_tpu_torch.urdf.parser import parse_urdf_file

        return parse_urdf_file(path)

    def load_urdf_from_string(self, text):
        from tds_tpu_torch.urdf.parser import parse_urdf_string

        return parse_urdf_string(text)


class UrdfToMultiBody2:
    """inl:1032-1034: parsed structures into a multibody."""

    def convert2(self, urdf_structures, world=None, is_floating=False, device=None, dtype=_F64):
        from tds_tpu_torch.urdf.converter import convert_to_multibody

        model, geoms = convert_to_multibody(urdf_structures, is_floating)
        device = world.device if world is not None and device is None else device
        mb = TinyMultiBody(model.to(resolve_device(device), dtype), geoms)
        if world is not None:
            world.bodies.append(mb)
            world._world = None
        return mb


class TinyServoActuator:
    """A PD servo (control/actuators.py ServoActuator)."""

    def __init__(self, dof, kp=100.0, kd=2.0, min_force=-500.0, max_force=500.0):
        from tds_tpu_torch.control.actuators import ServoActuator as _S

        self.dof = dof
        self._act = _S(kp=kp, kd=kd, min_force=min_force, max_force=max_force)

    def compute_torques(self, q, qd, target_positions):
        q = _arg(q)
        tau, _ = self._act.compute_torques((), q, _like(qd, q), _like(target_positions, q))
        return tau


# ---- matrix constructors (pytinydiffsim.inl Matrix surface) -----------------
# every matrix is a tensor: shape-checked constructors, zeros by default and
# the identity for the square 3x3, as the reference's default TinyMatrix3x3
def Matrix3(values=None, device=None):
    if values is None:
        return torch.eye(3, dtype=_F64, device=resolve_device(device))
    m = _tensor(values, device=device)
    assert m.shape[-2:] == (3, 3), f"Matrix3 expects 3x3, got {tuple(m.shape)}"
    return m


def Matrix(rows, cols=None, device=None):
    """MatrixXxX: Matrix(r, c) zeros; Matrix(nested_list) the values."""
    if cols is not None:
        return torch.zeros((int(rows), int(cols)), dtype=_F64, device=resolve_device(device))
    return _tensor(rows, device=device)


def Matrix3X(cols_or_values, device=None):
    if isinstance(cols_or_values, int):
        return torch.zeros((3, cols_or_values), dtype=_F64, device=resolve_device(device))
    m = _tensor(cols_or_values, device=device)
    assert m.shape[-2] == 3, f"Matrix3X expects 3 rows, got {tuple(m.shape)}"
    return m


def Matrix6x3(values=None, device=None):
    if values is None:
        return torch.zeros((6, 3), dtype=_F64, device=resolve_device(device))
    m = _tensor(values, device=device)
    assert m.shape[-2:] == (6, 3), f"Matrix6x3 expects 6x3, got {tuple(m.shape)}"
    return m


TinyMatrix3x3 = Matrix3
TinyMatrix3xX = Matrix3X
TinyMatrixXxX = Matrix
TinyVectorX = VectorX
TinyVector3 = Vector3
TinyQuaternion = Quaternion


# ---- enums (pytinydiffsim.inl:525-546,719-741,827-833) -----------------------
class TinyJointType(_enum.IntEnum):
    """JointType with the bindings' JOINT_* spelling (link.hpp:9-21)."""

    JOINT_FIXED = int(_JointType.FIXED)
    JOINT_PRISMATIC_X = int(_JointType.PRISMATIC_X)
    JOINT_PRISMATIC_Y = int(_JointType.PRISMATIC_Y)
    JOINT_PRISMATIC_Z = int(_JointType.PRISMATIC_Z)
    JOINT_PRISMATIC_AXIS = int(_JointType.PRISMATIC_AXIS)
    JOINT_REVOLUTE_X = int(_JointType.REVOLUTE_X)
    JOINT_REVOLUTE_Y = int(_JointType.REVOLUTE_Y)
    JOINT_REVOLUTE_Z = int(_JointType.REVOLUTE_Z)
    JOINT_REVOLUTE_AXIS = int(_JointType.REVOLUTE_AXIS)
    JOINT_SPHERICAL = int(_JointType.SPHERICAL)
    JOINT_INVALID = -2


class TinyGeometryTypes(_enum.IntEnum):
    """geometry.hpp:30-38."""

    SPHERE_TYPE = 0
    PLANE_TYPE = 1
    CAPSULE_TYPE = 2
    MESH_TYPE = 3
    BOX_TYPE = 4
    CYLINDER_TYPE = 5


class NeuralNetworkActivation(_enum.IntEnum):
    """math/neural_network.hpp:33-42 (the values of learn.nn.Activation)."""

    NN_ACT_IDENTITY = int(_Activation.IDENTITY)
    NN_ACT_TANH = int(_Activation.TANH)
    NN_ACT_SIN = int(_Activation.SIN)
    NN_ACT_RELU = int(_Activation.RELU)
    NN_ACT_SOFT_RELU = int(_Activation.SOFT_RELU)
    NN_ACT_ELU = int(_Activation.ELU)
    NN_ACT_SIGMOID = int(_Activation.SIGMOID)
    NN_ACT_SOFTSIGN = int(_Activation.SOFTSIGN)


class NeuralNetworkInitialization(_enum.IntEnum):
    """math/neural_network.hpp:44-48."""

    NN_INIT_ZERO = -1
    NN_INIT_XAVIER = 0
    NN_INIT_HE = 1


class TinyVelocitySmoothingMethod(_enum.IntEnum):
    """The spring solver's smoothing (the values of spring.VelocitySmoothing)."""

    SMOOTH_VEL_NONE = int(_VelSmooth.NONE)
    SMOOTH_VEL_SIGMOID = int(_VelSmooth.SIGMOID)
    SMOOTH_VEL_TANH = int(_VelSmooth.TANH)
    SMOOTH_VEL_ABS = int(_VelSmooth.ABS)


# export_values(): the reference puts the enum members at module scope
for _e in (TinyJointType, TinyGeometryTypes, NeuralNetworkActivation, NeuralNetworkInitialization,
           TinyVelocitySmoothingMethod):
    for _member in _e:
        globals()[_member.name] = _member
del _e, _member


# ---- TinyPose / TinyLink (inl:450-457,548-561) -------------------------------
class TinyPose:
    """A position and an xyzw quaternion (pose.hpp; inl:450-457)."""

    def __init__(self, position=None, orientation=None, device=None):
        self.position = torch.zeros(3, dtype=_F64, device=resolve_device(device)) if position is None else _arg(position)
        self.orientation = (
            _like([0.0, 0.0, 0.0, 1.0], self.position) if orientation is None else _like(orientation, self.position)
        )

    def transform(self, point):
        return self.position + _quat.to_matrix(self.orientation) @ _like(point, self.position)

    def inverse_transform(self, point):
        return _quat.to_matrix(self.orientation).T @ (_like(point, self.position) - self.position)


class TinyLink:
    """A standalone link record (link.hpp; inl:548-561). The functional core
    keeps links inside the static MultiBodyModel; this class is for scripts
    that build or inspect links one by one."""

    def __init__(self, joint_type, X_T, rbi: RigidBodyInertia):
        self.joint_type = TinyJointType(int(joint_type))
        self.X_T = X_T  # the parent-to-joint Transform
        self.rbi = rbi
        self.axis = _like([1.0, 0.0, 0.0], X_T.pos)  # for the *_AXIS joints
        self.stiffness = 0.0
        self.damping = 0.0
        self.link_name = ""
        self.joint_name = ""
        self.q_index = -1
        self.qd_index = -1
        self.world_transform = None  # set by jcalc

    def set_joint_type(self, joint_type):
        self.joint_type = TinyJointType(int(joint_type))

    def jcalc(self, q_link, parent_transform=None):
        """X_parent = X_T * X_J(q), composed onto the parent's world
        transform (the identity if omitted); stores and returns it."""
        from tds_tpu_torch.model.joints import jcalc_transform, motion_subspace

        jt = _JointType(int(self.joint_type))
        q_link = torch.atleast_1d(_like(q_link, self.X_T.pos))
        x_parent = jcalc_transform(jt, self.X_T, motion_subspace(jt, _like(self.axis, self.X_T.pos)), q_link)
        if parent_transform is None:
            eye = torch.eye(3, dtype=self.X_T.pos.dtype, device=self.X_T.pos.device)
            parent_transform = _Transform(pos=torch.zeros_like(self.X_T.pos), rot=eye)
        self.world_transform = parent_transform.compose(x_parent)
        return self.world_transform


# ---- TinyRaycast shape fitting (inl:879-891) ---------------------------------
class TinyRaycastResult:
    """tiny_raycast.h TinyRaycastResult (hit_fraction, collider_index)."""

    def __init__(self, hit_fraction=1.0, collider_index=-1):
        self.hit_fraction = float(hit_fraction)
        self.collider_index = int(collider_index)

    def __repr__(self):
        return f"TinyRaycastResult({self.hit_fraction:.6f}, {self.collider_index})"


class TinyRaycast:
    """Entry and exit sweeps of rays over TinyUrdfCollision shapes and the
    interval-union volume estimates of the reference's shape-fitting
    examples (tiny_raycast.h:92-265): a host-side utility over small ray
    grids, in numpy; the batched raycaster is collision/raycast.py."""

    @staticmethod
    def _collider_intervals(ray_from, ray_to, collider):
        """[(t_enter, t_exit)] of the ray segment inside one collider."""
        f = np.asarray(ray_from, dtype=float)
        t = np.asarray(ray_to, dtype=float)
        d = t - f
        geom = collider.geometry
        kind = geom.geom_type
        if kind == "sphere":
            rs = f - np.asarray(collider.origin_xyz, dtype=float)
            a = float(d @ d)
            b = float(rs @ d)
            c = float(rs @ rs) - geom.radius**2
            disc = b * b - a * c
            if disc <= 0.0 or a == 0.0:
                return []
            sq = _math.sqrt(disc)
            t0, t1 = (-b - sq) / a, (-b + sq) / a
        elif kind == "box":
            rpy = torch.as_tensor(collider.origin_rpy, dtype=_F64)
            r = _rotation.from_rpy(rpy[0], rpy[1], rpy[2]).numpy()
            o = np.asarray(collider.origin_xyz, dtype=float)
            fl, dl = r.T @ (f - o), r.T @ d
            half = np.asarray(geom.extents, dtype=float) / 2.0
            # the slab method
            t0, t1 = -np.inf, np.inf
            for ax in range(3):
                if abs(dl[ax]) < 1e-300:
                    if abs(fl[ax]) > half[ax]:
                        return []
                    continue
                lo = (-half[ax] - fl[ax]) / dl[ax]
                hi = (half[ax] - fl[ax]) / dl[ax]
                t0, t1 = np.maximum(t0, np.minimum(lo, hi)), np.minimum(t1, np.maximum(lo, hi))
            if not np.isfinite(t0) or not np.isfinite(t1):
                return []
        else:
            raise NotImplementedError(
                f"TinyRaycast supports sphere and box colliders, got {kind!r} (as the reference, tiny_raycast.h:106-155)"
            )
        t0c, t1c = np.clip(t0, 0.0, 1.0), np.clip(t1, 0.0, 1.0)
        if t1 < 0.0 or t0 > 1.0 or t1c <= t0c:
            return []
        return [(float(t0c), float(t1c))]

    def cast_rays(self, rays_from, rays_to, collision_objects):
        """Each ray's entry and exit TinyRaycastResults, sorted."""
        out = []
        for f, t in zip(rays_from, rays_to):
            hits = []
            for ci, col in enumerate(collision_objects):
                for t0, t1 in self._collider_intervals(f, t, col):
                    hits.append(TinyRaycastResult(t0, ci))
                    hits.append(TinyRaycastResult(t1, ci))
            hits.sort(key=lambda h: h.hit_fraction)
            out.append(hits)
        return out

    @staticmethod
    def _union_intervals(hits):
        """A ray's sorted entry and exit events merged into disjoint occupied
        [t0, t1) intervals (any collider counts)."""
        open_count = {}
        inside = 0
        spans = []
        start = 0.0
        for h in hits:
            c = h.collider_index
            if open_count.get(c, 0) > 0:  # an exit
                open_count[c] -= 1
                inside -= 1
                if inside == 0:
                    spans.append((start, h.hit_fraction))
            else:  # an entry
                open_count[c] = open_count.get(c, 0) + 1
                if inside == 0:
                    start = h.hit_fraction
                inside += 1
        return spans

    def volume(self, results, num_objects=None):
        """The sum over rays of the union's length along each
        (tiny_raycast.h:166-197; scale by ray length and cell area outside,
        as the reference examples do)."""
        del num_objects  # the events imply it
        total = 0.0
        for hits in results:
            for t0, t1 in self._union_intervals(hits):
                total += t1 - t0
        return total

    def intersection_volume(self, results_target, results_prims, num_objects=None):
        """The length covered by both the target shape and the primitives
        (tiny_raycast.h:199-265, by interval intersection)."""
        del num_objects
        total = 0.0
        for t_hits, p_hits in zip(results_target, results_prims):
            for a0, a1 in self._union_intervals(t_hits):
                for b0, b1 in self._union_intervals(p_hits):
                    lo, hi = np.maximum(a0, b0), np.minimum(a1, b1)
                    if hi > lo:
                        total += float(hi - lo)
        return total


# ---- misc free functions (inl:493,672) ---------------------------------------
def get_debug_double(x):
    """A scalar as a Python float (MyTinyConstants::getDouble)."""
    return float(x)


def mb_collision_geometries(mb: TinyMultiBody):
    """The collision geometries attached to a multibody (inl:672)."""
    return list(mb.geoms)


# ---- env simulations and the stateful .inl-style env API (inl:940-1185) -------
class CartpoleSimulation:
    """Record parity with the bound simulation structs: the resolved URDF
    path (cartpole_environment.h:27-70)."""

    def __init__(self):
        self.m_urdf_filename = find_file("cartpole.urdf")


class ReacherSimulation:
    def __init__(self):
        self.m_urdf_filename = find_file("gym/reacher.urdf")


class AntContactSimulation:
    def __init__(self):
        self.m_urdf_filename = find_file("gym/ant_org_xyz_xyzrot.urdf")


class _EnvOutput:
    """An obs, reward and done record (CartpoleEnvOutput et al., inl:947-975)."""

    def __init__(self, obs=None, reward=0.0, done=False):
        self.obs = obs
        self.reward = reward
        self.done = done


class CartpoleEnvOutput(_EnvOutput):
    pass


class ReacherEnvOutput(_EnvOutput):
    pass


class _RolloutOutput:
    def __init__(self, total_reward=0.0, num_steps=0):
        self.total_reward = total_reward
        self.num_steps = num_steps


class CartpoleRolloutOutput(_RolloutOutput):
    pass


class ReacherRolloutOutput(_RolloutOutput):
    pass


class TinyEnv:
    """A stateful .inl-flavoured adapter over any of the port's envs, one env
    at a time: reset() -> obs, step(action) -> EnvOutput, rollout(params) ->
    RolloutOutput, init_neural_network / update_weights / policy / seed
    (inl:1078-1130); reset(generator) and step(state, action) pass through
    to the env (batched, as the port's envs are)."""

    _output_cls = _EnvOutput
    _rollout_cls = _RolloutOutput

    def __init__(self, env, rollout_length: int = 1000, output_cls=None, rollout_cls=None):
        from tds_tpu_torch.learn.nn import MLPSpec

        self.env = env
        self.rollout_length = rollout_length
        if output_cls is not None:
            self._output_cls = output_cls
        if rollout_cls is not None:
            self._rollout_cls = rollout_cls
        self._policy = MLPSpec(env.observation_dim, [env.action_dim])
        self._params = torch.zeros(self._policy.num_parameters, dtype=env.dtype, device=env.device)
        self._generator = torch.Generator(device=env.device).manual_seed(0)
        self._state = None

    def __getattr__(self, name):
        # everything else (observation_dim, action_dim, model, ...) is the env's
        if name == "env":  # not set yet (unpickling): no recursion
            raise AttributeError(name)
        return getattr(self.env, name)

    def seed(self, n):
        self._generator.manual_seed(int(n))

    def reset(self, generator: Optional[torch.Generator] = None):
        if generator is not None:  # the functional call
            return self.env.reset(generator)
        self._state, obs = self.env.reset(self._generator)
        return obs[0]

    def step(self, a, b=None):
        if b is not None:  # the functional call: step(state, action)
            return self.env.step(a, b)
        action = torch.as_tensor(a, dtype=self.env.dtype, device=self.env.device).reshape(1, -1)
        self._state, obs, reward, done = self.env.step(self._state, action)
        return self._output_cls(obs=obs[0], reward=float(reward[0]), done=bool(done[0]))

    def init_neural_network(self, weights):
        self._params = _like(weights, self._params)

    update_weights = init_neural_network

    def policy(self, obs):
        return self._policy.apply(self._params, _like(obs, self._params))

    def rollout(self, weights=None, max_steps=None):
        from tds_tpu_torch.envs.vectorized import rollout as _rollout

        params = self._params if weights is None else _like(weights, self._params)
        total, steps = _rollout(self.env, self._policy.apply, params, max_steps or self.rollout_length, self._generator)
        return self._rollout_cls(total_reward=float(total[0]), num_steps=int(steps[0]))


class _VectorizedEnvOutput:
    """obs, rewards, dones and the links' world poses for rendering
    (inl:1140-1160): visual_world_transforms is (num_envs, 1 + links, 7),
    rows of [pos (3), quat xyzw (4)]."""

    def __init__(self, obs=None, rewards=None, dones=None, visual_world_transforms=None):
        self.obs = obs
        self.rewards = rewards
        self.dones = dones
        self.visual_world_transforms = visual_world_transforms


class VectorizedAntEnvOutput(_VectorizedEnvOutput):
    pass


class VectorizedLaikagoEnvOutput(_VectorizedEnvOutput):
    pass


class TinyVectorizedEnv:
    """A stateful adapter over VectorizedEnv with the .inl vectorized-env API
    (reset() -> obs, step(actions) -> Output with the visual transforms,
    action_dim() / obs_dim() / urdf_filename()); reset(generator) and
    step(states, actions) pass through to the VectorizedEnv."""

    def __init__(self, venv, urdf_filename="", output_cls_name=""):
        self.venv = venv
        self.env = venv.env
        self._urdf = urdf_filename
        self._output_cls = globals()[output_cls_name] if output_cls_name else _VectorizedEnvOutput
        self._generator = torch.Generator(device=self.env.device).manual_seed(0)
        self._states = None

    def action_dim(self):
        return self.env.action_dim

    def obs_dim(self):
        return self.env.observation_dim

    def urdf_filename(self):
        return self._urdf

    def _visual_transforms(self, states):
        base_x, links_x, _ = _fkq(self.env.model, states.q)
        batch = states.q.shape[:-1]

        def pose7(x):
            pos = torch.broadcast_to(x.pos, batch + (3,))
            return torch.cat([pos, torch.broadcast_to(_quat.from_matrix(x.rot), batch + (4,))], dim=-1)

        return torch.stack([pose7(base_x)] + [pose7(x) for x in links_x], dim=-2)

    def reset(self, generator: Optional[torch.Generator] = None):
        if generator is not None:  # the functional call
            return self.venv.reset(generator)
        self._states, obs = self.venv.reset(self._generator)
        return obs

    def step(self, a, b=None):
        if b is not None:  # the functional call: step(states, actions)
            return self.venv.step(a, b, self._generator)
        actions = torch.as_tensor(a, dtype=self.env.dtype, device=self.env.device)
        self._states, obs, rewards, dones = self.venv.step(self._states, actions, self._generator)
        return self._output_cls(
            obs=obs, rewards=rewards, dones=dones, visual_world_transforms=self._visual_transforms(self._states)
        )


# ---- not bound, and why -------------------------------------------------------
# - pytinydiffsim_ad / _dual, the scalar-variant modules: every function here
#   is differentiable through torch.autograd and torch.func (K1 carries its
#   backward and its JVP); there is nothing to switch.
# - pytinyopengl3 / TinyOpenGL3, the windowed visualizer: the card's machines
#   have no display; visualizer/meshcat.py and visualizer/renderer.py cover
#   visualization.
# - the Fix64 scalar: float64 on the card and the CPU is deterministic for a
#   given batch and kernel build; a fixed-point scalar would give up the
#   card's floating-point units.
# - PyBullet URDF import (b3RobotSimulatorClientAPI): it needs a live Bullet
#   server process; the bundled URDF assets cover the reference's robots.
