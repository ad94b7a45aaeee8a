"""Static multibody model: tensor parameters plus Python topology
(counterpart of tds_tpu/model/multibody.py).

The numeric parameters (joint frames, inertias, damping) are tensors that
move together with ``model.to(device, dtype)``. The topology (joint types,
parents, q/qd offsets) is plain Python, so every dynamics function unrolls
its link loops in Python, as the JAX package does at trace time.

State layout:
- fixed base: q = [joint coords...], qd = [joint vels...];
- floating base: q = [qx, qy, qz, qw, x, y, z, joint coords...] and
  qd = [wx, wy, wz, vx, vy, vz, joint vels...], the base's twist in the
  world frame.
A spherical joint takes 4 q slots (an xyzw quaternion) and 3 qd slots, so
with one, q and qd have different offsets. tau covers the actuated DoF
only: its index is the qd index less 6 on a floating base.
"""

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tds_tpu_torch.algebra.inertia import RigidBodyInertia
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.model.joints import JointType, motion_subspace, q_width, qd_width

_TENSOR_FIELDS = (
    "x_t_pos", "x_t_rot", "joint_axis", "mass", "com", "inertia", "stiffness",
    "damping", "base_mass", "base_com", "base_inertia", "base_pos", "base_rot",
    "joint_damping",
)


@dataclasses.dataclass(frozen=True)
class MultiBodyModel:
    """A pytree (registered below): its tensor parameters are the leaves,
    its topology the static context, so ``torch.func.vmap`` maps a batch of
    models whose leaves carry a leading axis."""

    # --- tensor parameters ---
    x_t_pos: torch.Tensor  # (nl, 3) joint frame origin in the parent link frame
    x_t_rot: torch.Tensor  # (nl, 3, 3) joint frame rotation in the parent
    joint_axis: torch.Tensor  # (nl, 3) joint axis (unit x for fixed joints)
    mass: torch.Tensor  # (nl,)
    com: torch.Tensor  # (nl, 3) first moment h = m*com
    inertia: torch.Tensor  # (nl, 3, 3) about the link origin
    stiffness: torch.Tensor  # (nl,)
    damping: torch.Tensor  # (nl,)
    base_mass: torch.Tensor  # ()
    base_com: torch.Tensor  # (3,) first moment
    base_inertia: torch.Tensor  # (3, 3)
    base_pos: torch.Tensor  # (3,) fixed-base world placement
    base_rot: torch.Tensor  # (3, 3)
    joint_damping: torch.Tensor  # () spherical-joint velocity decay factor, pow(joint_damping, 1000 dt) a step

    # --- static topology ---
    joint_types: Tuple[int, ...]
    parents: Tuple[int, ...]
    q_offsets: Tuple[int, ...]
    qd_offsets: Tuple[int, ...]
    is_floating: bool
    dof_q: int
    dof_qd: int
    dof_actuated: int
    link_names: Tuple[str, ...] = ()
    joint_names: Tuple[str, ...] = ()
    name: str = "multibody"

    def to(self, device=None, dtype=None) -> "MultiBodyModel":
        """A copy with every tensor parameter on ``device`` in ``dtype``."""
        return dataclasses.replace(
            self,
            **{f: getattr(self, f).to(device=device, dtype=dtype) for f in _TENSOR_FIELDS},
        )

    @property
    def device(self):
        return self.x_t_pos.device

    @property
    def dtype(self):
        return self.x_t_pos.dtype

    @property
    def num_links(self) -> int:
        return len(self.joint_types)

    @property
    def dof(self) -> int:
        return self.dof_q

    @functools.cached_property
    def subspaces(self) -> torch.Tensor:
        """(nl, 6) motion subspaces of the fixed and 1-DoF joints, derived
        once from joint types and axes; a spherical joint's row is zero (its
        (6, 3) subspace is :meth:`subspace`)."""
        return torch.stack(
            [
                self.joint_axis.new_zeros(6) if jt == JointType.SPHERICAL else motion_subspace(JointType(jt), self.joint_axis[i])
                for i, jt in enumerate(self.joint_types)
            ]
        )

    @functools.cached_property
    def _spherical_subspace(self) -> torch.Tensor:
        return motion_subspace(JointType.SPHERICAL, self.joint_axis.new_zeros(3))

    def subspace(self, i: int) -> torch.Tensor:
        """Link i's motion subspace: (6,), or (6, 3) for a spherical joint."""
        if self.joint_types[i] == JointType.SPHERICAL:
            return self._spherical_subspace
        return self.subspaces[i]

    def motion_subspace(self, i: int) -> torch.Tensor:
        """Link i's motion subspace, the JAX package's name for :meth:`subspace`."""
        return self.subspace(i)

    def x_t(self, i: int) -> Transform:
        return Transform(pos=self.x_t_pos[i], rot=self.x_t_rot[i])

    def rbi(self, i: int) -> RigidBodyInertia:
        return RigidBodyInertia(mass=self.mass[i], h=self.com[i], inertia=self.inertia[i])

    def base_rbi(self) -> RigidBodyInertia:
        return RigidBodyInertia(mass=self.base_mass, h=self.base_com, inertia=self.base_inertia)

    def base_x_world(self) -> Transform:
        return Transform(pos=self.base_pos, rot=self.base_rot)

    def q_for_link(self, q, i: int):
        off = self.q_offsets[i]
        return q[..., off : off + q_width(JointType(self.joint_types[i]))]

    def qd_for_link(self, qd, i: int):
        off = self.qd_offsets[i]
        return qd[..., off : off + qd_width(JointType(self.joint_types[i]))]

    def tau_for_link(self, tau, i: int):
        """tau holds the actuated DoF only."""
        off = self.qd_offsets[i] - (6 if self.is_floating else 0)
        return tau[..., off : off + qd_width(JointType(self.joint_types[i]))]

    def zero_q(self, batch_shape=()):
        """The zero pose: every coordinate 0 but the identity quaternions of
        a floating base and of each spherical joint."""
        q = torch.zeros(batch_shape + (self.dof_q,), dtype=self.dtype, device=self.device)
        if self.is_floating:
            q[..., 3] = 1.0
        for i, jt in enumerate(self.joint_types):
            if jt == JointType.SPHERICAL:
                q[..., self.q_offsets[i] + 3] = 1.0
        return q

    def zero_qd(self, batch_shape=()):
        return torch.zeros(batch_shape + (self.dof_qd,), dtype=self.dtype, device=self.device)

    def dof_coupling_mask(self) -> np.ndarray:
        """Boolean (dof_qd, dof_qd) numpy mask: M[i, j] can be nonzero only
        when the joints carrying DoFs i and j lie on one root-to-leaf path
        (the CRBA structure); a floating base's 6 DoFs couple with all."""
        n = self.dof_qd
        mask = np.eye(n, dtype=bool)
        if self.is_floating:
            mask[:6, :] = True
            mask[:, :6] = True

        def dofs_of(link):
            off = self.qd_offsets[link]
            return range(off, off + qd_width(JointType(self.joint_types[link])))

        for i in range(self.num_links):
            j, chain = i, []
            while j >= 0:
                chain.append(j)
                j = self.parents[j]
            for a in chain:
                for di in dofs_of(i):
                    for dj in dofs_of(a):
                        mask[di, dj] = mask[dj, di] = True
        return mask


class MultiBodyState(NamedTuple):
    """Generalized coordinates, the only state carried between steps."""

    q: torch.Tensor
    qd: torch.Tensor


class MultiBodyBuilder:
    """Imperative model construction, links appended in topological order
    (parent index < link index). Host-side numpy until ``finalize``."""

    def __init__(self, is_floating: bool = False, name: str = "multibody"):
        self.is_floating = is_floating
        self.name = name
        self.joint_types = []
        self.parents = []
        self.x_t_pos = []
        self.x_t_rot = []
        self.joint_axes = []
        self.masses = []
        self.coms = []  # first moments (m * com)
        self.inertias = []  # about the link origin
        self.stiffnesses = []
        self.dampings = []
        self.link_names = []
        self.joint_names = []
        self.base_mass = 0.0
        self.base_com = (0.0, 0.0, 0.0)
        self.base_inertia = ((0.0,) * 3,) * 3
        self.base_pos = (0.0, 0.0, 0.0)
        self.base_rot = ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))
        self.joint_damping = 0.995  # pow(joint_damping, 1000*dt) decay factor

    def set_base_inertia(self, mass, com, inertia_about_com):
        """Set the base inertia (com given as the center of mass)."""
        mass = float(mass)
        com = np.asarray(com, dtype=float)
        cx = np_cross_matrix(com)
        self.base_mass = mass
        self.base_com = tuple(mass * com)
        self.base_inertia = np.asarray(inertia_about_com, dtype=float) + mass * (cx @ cx.T)
        return self

    def add_link(
        self,
        joint_type: JointType,
        parent: int,
        *,
        x_t_pos=(0.0, 0.0, 0.0),
        x_t_rpy=None,
        x_t_rot=None,
        axis=(1.0, 0.0, 0.0),
        mass=0.0,
        com=(0.0, 0.0, 0.0),
        inertia_about_com=None,
        stiffness=0.0,
        damping=0.0,
        link_name: str = "",
        joint_name: str = "",
    ) -> int:
        if parent >= len(self.joint_types):
            raise ValueError("links must be appended in topological order")
        ax = np.asarray(axis, dtype=float)
        if np.linalg.norm(ax) == 0.0:
            raise ValueError("zero joint axis")
        self.joint_types.append(JointType(joint_type))
        self.parents.append(int(parent))
        self.x_t_pos.append(np.asarray(x_t_pos, dtype=float))
        # the rotation as given, else from rpy, else the identity
        if x_t_rot is not None:
            self.x_t_rot.append(np.asarray(x_t_rot, dtype=float))
        else:
            self.x_t_rot.append(np.eye(3) if x_t_rpy is None else np_rpy(*x_t_rpy))
        # not normalized: URDF axes are used verbatim, as in the JAX package
        self.joint_axes.append(ax)
        mass = float(mass)
        com = np.asarray(com, dtype=float)
        icom = np.zeros((3, 3)) if inertia_about_com is None else np.asarray(inertia_about_com, dtype=float)
        if icom.ndim == 1:  # a diagonal, as the JAX package's builder takes it
            icom = np.diag(icom)
        cx = np_cross_matrix(com)
        self.masses.append(mass)
        self.coms.append(mass * com)
        self.inertias.append(icom + mass * (cx @ cx.T))
        self.stiffnesses.append(float(stiffness))
        self.dampings.append(float(damping))
        self.link_names.append(link_name)
        self.joint_names.append(joint_name)
        return len(self.joint_types) - 1

    def finalize(self, dtype=torch.float64, device=None) -> MultiBodyModel:
        nl = len(self.joint_types)
        q_off, qd_off = [], []
        qi = 7 if self.is_floating else 0
        qdi = 6 if self.is_floating else 0
        n_act = 0
        for jt in self.joint_types:
            if jt == JointType.FIXED:
                q_off.append(-2)
                qd_off.append(-2)
            else:
                q_off.append(qi)
                qd_off.append(qdi)
                qi += q_width(jt)
                qdi += qd_width(jt)
                n_act += qd_width(jt)

        def arr(x, empty_shape=None):
            a = np.asarray(x, dtype=float)
            if nl == 0 and empty_shape is not None:
                a = a.reshape(empty_shape)
            return torch.as_tensor(a, dtype=dtype, device=device)

        def stacked(xs, shape):
            return arr(np.stack(xs) if nl else np.zeros((0,) + shape))

        return MultiBodyModel(
            x_t_pos=stacked(self.x_t_pos, (3,)),
            x_t_rot=stacked(self.x_t_rot, (3, 3)),
            joint_axis=stacked(self.joint_axes, (3,)),
            mass=arr(self.masses, (0,)),
            com=stacked(self.coms, (3,)),
            inertia=stacked(self.inertias, (3, 3)),
            stiffness=arr(self.stiffnesses, (0,)),
            damping=arr(self.dampings, (0,)),
            base_mass=arr(self.base_mass),
            base_com=arr(self.base_com),
            base_inertia=arr(self.base_inertia),
            base_pos=arr(self.base_pos),
            base_rot=arr(self.base_rot),
            joint_damping=arr(self.joint_damping),
            joint_types=tuple(int(t) for t in self.joint_types),
            parents=tuple(self.parents),
            q_offsets=tuple(q_off),
            qd_offsets=tuple(qd_off),
            is_floating=self.is_floating,
            dof_q=qi,
            dof_qd=qdi,
            dof_actuated=n_act,
            link_names=tuple(self.link_names),
            joint_names=tuple(self.joint_names),
            name=self.name,
        )


def np_cross_matrix(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def np_rpy(r, p, y):
    """URDF rpy rotation Rz(y) @ Ry(p) @ Rx(r) in numpy."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _flatten(model: MultiBodyModel):
    static = tuple(getattr(model, f.name) for f in dataclasses.fields(model) if f.name not in _TENSOR_FIELDS)
    return [getattr(model, f) for f in _TENSOR_FIELDS], static


def _unflatten(leaves, static) -> MultiBodyModel:
    names = [f.name for f in dataclasses.fields(MultiBodyModel) if f.name not in _TENSOR_FIELDS]
    return MultiBodyModel(**dict(zip(_TENSOR_FIELDS, leaves)), **dict(zip(names, static)))


pytree.register_pytree_node(
    MultiBodyModel, _flatten, _unflatten, serialized_type_name="tds_tpu_torch.model.multibody.MultiBodyModel"
)
