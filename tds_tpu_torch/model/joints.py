"""Joint types and joint calculations (counterpart of
tds_tpu/model/joints.py). Joint-type dispatch happens in Python over the
static topology, as the JAX package resolves it at trace time.

Spherical joints are not ported yet: they raise NotImplementedError.
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


def _no_spherical():
    return NotImplementedError("spherical joints are not ported to tds_tpu_torch yet")


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
    """Motion subspace S (6,) of a fixed or 1-DoF joint; ``axis`` is the
    (3,) joint-axis tensor, which also sets dtype and device."""
    if joint_type == JointType.SPHERICAL:
        raise _no_spherical()
    s = torch.zeros(6, dtype=axis.dtype, device=axis.device)
    if joint_type == JointType.FIXED:
        return s
    prismatic = joint_type in PRISMATIC_TYPES
    half = slice(3, 6) if prismatic else slice(0, 3)
    if joint_type in (JointType.PRISMATIC_AXIS, JointType.REVOLUTE_AXIS):
        s[half] = axis
    else:
        s[half.start + _AXIS_OF[joint_type]] = 1.0
    return s


def jcalc_transform(joint_type: JointType, x_t: Transform, s, q_link):
    """X_parent = X_T * X_J(q) for one link; ``s`` is the link's motion
    subspace (it carries the joint axis) and ``q_link`` is (..., q_width)."""
    if joint_type == JointType.FIXED:
        return x_t
    if joint_type == JointType.SPHERICAL:
        raise _no_spherical()
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
    else:
        r = _ROTFN[_AXIS_OF[joint_type]](q_link[..., 0])
    return Transform(pos=x_t.pos, rot=x_t.rot @ r)


def jcalc_velocity(joint_type: JointType, s, qd_link):
    """Local joint velocity vJ = S qd for fixed and 1-DoF joints."""
    if joint_type == JointType.SPHERICAL:
        raise _no_spherical()
    if joint_type == JointType.FIXED:
        return torch.zeros(qd_link.shape[:-1] + (6,), dtype=qd_link.dtype, device=qd_link.device)
    return s * qd_link[..., 0:1]
