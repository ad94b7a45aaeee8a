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


def point_jacobian_fd(model: MultiBodyModel, q, link_index: int, start_point, eps: float = 1e-3):
    """A finite-difference Jacobian, for tests: each velocity DoF moves q by
    ``eps`` (a floating base's and a spherical joint's quaternion through
    the integrator's world- and local-frame increments) and the world
    motion of the material point at ``start_point`` (world frame) on link
    ``link_index`` (-1: the base) is tracked; (..., 3, dof_qd) for q
    (..., dof_q)."""
    from tds_tpu_torch.algebra import quaternion
    from tds_tpu_torch.model.joints import qd_width

    base_x_world, links_x_world, _ = forward_kinematics_q(model, q)
    start_point = torch.as_tensor(start_point, dtype=q.dtype, device=q.device)
    frame = links_x_world[link_index] if link_index >= 0 else base_x_world
    local_point = frame.apply_inverse_point(start_point)

    def unit(k):
        w = q.new_zeros(q.shape[:-1] + (3,))
        w[..., k] = 1.0
        return w

    cols = []
    for i in range(model.dof_qd):
        q_x = q.clone()
        if model.is_floating and i < 3:
            q_x[..., 0:4] = quaternion.integrate_world(q[..., 0:4], unit(i), eps)
        elif model.is_floating and i < 6:
            q_x[..., i + 1] += eps
        else:
            for li in range(model.num_links):
                jt = JointType(model.joint_types[li])
                off = model.qd_offsets[li]
                if jt != JointType.FIXED and off <= i < off + qd_width(jt):
                    qo = model.q_offsets[li]
                    if jt == JointType.SPHERICAL:
                        q_x[..., qo:qo + 4] = quaternion.integrate_local(q[..., qo:qo + 4], unit(i - off), eps)
                    else:
                        q_x[..., qo + (i - off)] += eps
                    break
        bxw, lxw, _ = forward_kinematics_q(model, q_x)
        world_point = (lxw[link_index] if link_index >= 0 else bxw).apply_point(local_point)
        cols.append((world_point - start_point) / eps)
    return torch.stack(cols, dim=-1)
