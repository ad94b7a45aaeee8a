"""Forward kinematics, phase 1 of ABA and CRBA (counterpart of
tds_tpu/dynamics/kinematics.py): joint transforms, world poses, link
spatial velocities, bias accelerations and bias forces, with the link loop
unrolled in Python over the static topology. A spherical joint's transform
is its quaternion's rotation and its velocity [qd, 0].

A floating base's pose is q[0:7] (an xyzw quaternion, then the position)
and its twist qd[0:6]; its articulated inertia starts as its rigid-body
inertia and its bias force as the gyroscopic w x (R I R^T) w, less any
``base_applied_force``. ``f_ext`` holds a world-frame force on each link.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.algebra import quaternion, spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.algebra.spatial import cross, matvec
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.model.joints import JointType, jcalc_transform, jcalc_velocity
from tds_tpu_torch.model.multibody import MultiBodyModel


class KinLinks(NamedTuple):
    """Per-link kinematics as tuples of per-link values."""

    x_parent: Tuple[Transform, ...]
    x_world: Tuple[Transform, ...]
    v: Tuple[torch.Tensor, ...]  # spatial velocity in the link frame
    c: Tuple[torch.Tensor, ...]  # velocity-product acceleration
    pA: Tuple[torch.Tensor, ...]  # bias force
    abi: Tuple[ArticulatedBodyInertia, ...]
    base_x_world: Transform
    base_velocity: torch.Tensor  # (..., 6)
    base_abi: Optional[ArticulatedBodyInertia]
    base_bias_force: Optional[torch.Tensor]


def base_pose_from_q(model: MultiBodyModel, q) -> Transform:
    """The base's world pose: q[0:7] for a floating base, the model's
    placement for a fixed one."""
    if model.is_floating:
        return Transform(pos=q[..., 4:7], rot=quaternion.to_matrix(q[..., 0:4]))
    return model.base_x_world()


def fk_links(model: MultiBodyModel, q, qd, f_ext=None, base_applied_force=None) -> KinLinks:
    """Unrolled forward-kinematics pass; q and qd are (B, dof_q) and
    (B, dof_qd). ``f_ext``: a world-frame force (..., 6) for each link, as a
    sequence or a (..., num_links, 6) tensor; ``base_applied_force``: a
    force (..., 6) on a floating base."""
    base_x_world = base_pose_from_q(model, q)
    base_abi = base_bias = None
    if model.is_floating:
        base_velocity = qd[..., 0:6]
        base_abi = ArticulatedBodyInertia.from_rbi(model.base_rbi())
        w = base_velocity[..., 0:3]
        r = base_x_world.rot
        gyro = cross(w, matvec(r @ model.base_inertia @ r.transpose(-1, -2), w))
        base_bias = spatial.fv(gyro, torch.zeros_like(gyro))
        if base_applied_force is not None:
            base_bias = base_bias - base_applied_force
    else:
        base_velocity = q.new_zeros(q.shape[:-1] + (6,))
    xp_list, xw_list, v_list, c_list, pa_list, abi_list = [], [], [], [], [], []
    for i in range(model.num_links):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        s = model.subspace(i)
        x_parent = jcalc_transform(jt, model.x_t(i), s, model.q_for_link(q, i))
        if parent >= 0:
            x_world = xw_list[parent].compose(x_parent)
            v_in = x_parent.motion_to_child(v_list[parent])
        else:
            x_world = base_x_world.compose(x_parent)
            v_in = x_parent.motion_to_child(base_velocity) if model.is_floating else None
        abi = ArticulatedBodyInertia.from_rbi(model.rbi(i))
        if jt == JointType.FIXED:
            # vJ = 0, so c = v x vJ = 0 exactly
            v = base_velocity if v_in is None else v_in
            c = torch.zeros_like(v)
        else:
            v_j = jcalc_velocity(jt, s, model.qd_for_link(qd, i))
            v = v_j if v_in is None else v_in + v_j
            c = spatial.cross_mm(v, v_j)
        p_a = spatial.cross_mf(v, abi.mul_motion(v))
        if f_ext is not None:
            fe = f_ext[i] if isinstance(f_ext, (list, tuple)) else f_ext[..., i, :]
            p_a = p_a - x_world.force_to_child(fe)

        xp_list.append(x_parent)
        xw_list.append(x_world)
        v_list.append(v)
        c_list.append(c)
        pa_list.append(p_a)
        abi_list.append(abi)

    return KinLinks(
        x_parent=tuple(xp_list),
        x_world=tuple(xw_list),
        v=tuple(v_list),
        c=tuple(c_list),
        pA=tuple(pa_list),
        abi=tuple(abi_list),
        base_x_world=base_x_world,
        base_velocity=base_velocity,
        base_abi=base_abi,
        base_bias_force=base_bias,
    )


def forward_kinematics(model: MultiBodyModel, q, qd=None):
    """(world poses as a Transform of (num_links, ...) leaves, link
    velocities (num_links, ..., 6)); ``qd`` None is zero."""
    if qd is None:
        qd = q.new_zeros(q.shape[:-1] + (model.dof_qd,))
    kin = fk_links(model, q, qd)
    x_world = Transform(
        pos=torch.stack([t.pos for t in kin.x_world]), rot=torch.stack([t.rot for t in kin.x_world])
    )
    return x_world, torch.stack(kin.v)


def forward_kinematics_q(model: MultiBodyModel, q):
    """Position-only FK: (base pose, each link's world pose, each link's
    pose in the base frame)."""
    base_x_world = base_pose_from_q(model, q)
    xw, xb = [], []
    for i in range(model.num_links):
        parent = model.parents[i]
        x_parent = jcalc_transform(JointType(model.joint_types[i]), model.x_t(i), model.subspace(i), model.q_for_link(q, i))
        if parent >= 0:
            xw.append(xw[parent].compose(x_parent))
            xb.append(xb[parent].compose(x_parent))
        else:
            xw.append(base_x_world.compose(x_parent))
            xb.append(x_parent)
    return base_x_world, tuple(xw), tuple(xb)
