"""Point Jacobians, 3 x dof_qd (counterpart of
tds_tpu/dynamics/jacobian.py); a spherical joint gives 3 columns, and a
floating base 6: the transposed cross matrix of the point (relative to the
base) on the angular ones and the identity on the linear ones, for its
world-frame twist."""

import torch

from tds_tpu_torch.algebra.spatial import cross, cross_matrix
from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel


def point_jacobian(model: MultiBodyModel, q, link_index: int, point, is_local_point: bool = False):
    """Jacobian (B, 3, dof_qd) of the world-frame velocity of ``point``
    (B, 3) on link ``link_index`` (-1: the base) with respect to qd; the
    point is in the world frame, or with ``is_local_point`` in the base
    frame."""
    base_x_world, links_x_world, links_x_base = forward_kinematics_q(model, q)
    return point_jacobian_kin(model, base_x_world, links_x_world, links_x_base, link_index, point, is_local_point)


def point_jacobian_kin(
    model: MultiBodyModel,
    base_x_world,
    links_x_world,
    links_x_base,
    link_index: int,
    point,
    is_local_point: bool = False,
):
    """Jacobian (B, 3, dof_qd) of the velocity of ``point`` (B, 3) on link
    ``link_index`` with respect to qd, from precomputed link transforms.
    ``point`` is in the world frame, or in the base frame with
    ``is_local_point`` (then ``links_x_base`` supplies the link frames).
    Columns are gathered per joint on the path to the root and stacked
    once."""
    cols = {}
    if model.is_floating:
        base_point = point if is_local_point else point - base_x_world.pos
        cr = cross_matrix(base_point).transpose(-1, -2)
        for k in range(3):
            cols[k] = cr[..., :, k]
        eye = torch.eye(3, dtype=point.dtype, device=point.device)
        for k in range(3):
            cols[3 + k] = eye[:, k].expand(point.shape)
    i = link_index if link_index is not None else -1
    while i >= 0:
        jt = JointType(model.joint_types[i])
        x_frame = links_x_base[i] if is_local_point else links_x_world[i]
        if jt == JointType.SPHERICAL:
            st = x_frame.motion_matrix_to_parent(model.subspace(i))
            top = st[..., 0:3, :]
            bottom = st[..., 3:6, :] - cross_matrix(point) @ top
            for k in range(3):
                cols[model.qd_offsets[i] + k] = bottom[..., :, k]
        elif jt != JointType.FIXED:
            st = x_frame.motion_to_parent(model.subspaces[i])
            cols[model.qd_offsets[i]] = st[..., 3:6] - cross(point, st[..., 0:3])
        i = model.parents[i]
    zero = point.new_zeros(point.shape)
    return torch.stack([cols.get(c, zero) for c in range(model.dof_qd)], dim=-1)
