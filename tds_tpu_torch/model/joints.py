"""Joint types and joint calculations (counterpart of
tds_tpu/model/joints.py). Joint-type dispatch happens in Python over the
static topology, as the JAX package resolves it at trace time.

A spherical joint has 4 coordinates (an xyzw quaternion) and 3 rates (the
body-frame angular velocity); its motion subspace is the (6, 3) matrix
[I; 0].
"""

import enum

import torch

from tds_tpu_torch.algebra import quaternion, rotation
from tds_tpu_torch.algebra.spatial import matvec
from tds_tpu_torch.algebra.transform import Transform


class JointType(enum.IntEnum):
    # values mirror tds_tpu.model.joints.JointType
    FIXED = -1
    PRISMATIC_X = 0
    PRISMATIC_Y = 1
    PRISMATIC_Z = 2
    PRISMATIC_AXIS = 3
    REVOLUTE_X = 4
    REVOLUTE_Y = 5
    REVOLUTE_Z = 6
    REVOLUTE_AXIS = 7
    SPHERICAL = 8


PRISMATIC_TYPES = (
    JointType.PRISMATIC_X,
    JointType.PRISMATIC_Y,
    JointType.PRISMATIC_Z,
    JointType.PRISMATIC_AXIS,
)

_AXIS_OF = {
    JointType.PRISMATIC_X: 0,
    JointType.PRISMATIC_Y: 1,
    JointType.PRISMATIC_Z: 2,
    JointType.REVOLUTE_X: 0,
    JointType.REVOLUTE_Y: 1,
    JointType.REVOLUTE_Z: 2,
}

_ROTFN = {0: rotation.rotation_x, 1: rotation.rotation_y, 2: rotation.rotation_z}


def q_width(joint_type: JointType) -> int:
    if joint_type == JointType.FIXED:
        return 0
    if joint_type == JointType.SPHERICAL:
        return 4
    return 1


def qd_width(joint_type: JointType) -> int:
    if joint_type == JointType.FIXED:
        return 0
    if joint_type == JointType.SPHERICAL:
        return 3
    return 1


def motion_subspace(joint_type: JointType, axis):
    """Motion subspace S: (6,) for a fixed or 1-DoF joint, (6, 3) for a
    spherical one; ``axis`` is the (3,) joint-axis tensor, which also sets
    dtype and device."""
    if joint_type == JointType.SPHERICAL:
        s = torch.zeros(6, 3, dtype=axis.dtype, device=axis.device)
        s[:3] = torch.eye(3, dtype=axis.dtype, device=axis.device)
        return s
    s = torch.zeros(6, dtype=axis.dtype, device=axis.device)
    if joint_type == JointType.FIXED:
        return s
    prismatic = joint_type in PRISMATIC_TYPES
    half = slice(3, 6) if prismatic else slice(0, 3)
    if joint_type in (JointType.PRISMATIC_AXIS, JointType.REVOLUTE_AXIS):
        s[half] = axis
    else:
        # fill_ on a view copies nothing from the host, so a model rebuilt
        # inside a CUDA graph capture (a mass scale under grad) recomputes it
        s[half.start + _AXIS_OF[joint_type]].fill_(1.0)
    return s


def jcalc_transform(joint_type: JointType, x_t: Transform, s, q_link):
    """X_parent = X_T * X_J(q) for one link; ``s`` is the link's motion
    subspace (it carries the joint axis) and ``q_link`` is (..., q_width)."""
    if joint_type == JointType.FIXED:
        return x_t
    if joint_type in PRISMATIC_TYPES:
        d = s[3:] * q_link[..., 0:1]
        return Transform(pos=x_t.pos + matvec(x_t.rot, d), rot=x_t.rot)
    if joint_type == JointType.REVOLUTE_AXIS:
        # the rotation normalizes the axis while S keeps the raw axis, as
        # in the JAX package (reference behavior for approximate axes)
        axis = s[:3]
        r = quaternion.to_matrix(
            quaternion.from_axis_angle(axis / torch.linalg.vector_norm(axis), q_link[..., 0])
        )
    elif joint_type == JointType.SPHERICAL:
        r = quaternion.to_matrix(q_link)
    else:
        r = _ROTFN[_AXIS_OF[joint_type]](q_link[..., 0])
    return Transform(pos=x_t.pos, rot=x_t.rot @ r)


def jcalc_velocity(joint_type: JointType, s, qd_link):
    """Local joint velocity vJ = S qd: [qd, 0] for a spherical joint."""
    if joint_type == JointType.FIXED:
        return torch.zeros(qd_link.shape[:-1] + (6,), dtype=qd_link.dtype, device=qd_link.device)
    if joint_type == JointType.SPHERICAL:
        return torch.cat([qd_link, torch.zeros_like(qd_link)], dim=-1)
    return s * qd_link[..., 0:1]
