"""Elementary rotation matrices and the URDF rpy convention (active
rotations, v_parent = R @ v_child; counterpart of tds_tpu/algebra/rotation.py).
"""

import torch


def _rot(c, s, axis):
    o = torch.zeros_like(c)
    i = torch.ones_like(c)
    if axis == 0:
        rows = [[i, o, o], [o, c, -s], [o, s, c]]
    elif axis == 1:
        rows = [[c, o, s], [o, i, o], [-s, o, c]]
    else:
        rows = [[c, -s, o], [s, c, o], [o, o, i]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_x(angle):
    return _rot(angle.cos(), angle.sin(), 0)


def rotation_y(angle):
    return _rot(angle.cos(), angle.sin(), 1)


def rotation_z(angle):
    return _rot(angle.cos(), angle.sin(), 2)


def from_axis_angle(axis, angle):
    """Rodrigues' formula: the rotation by ``angle`` about the unit ``axis``."""
    from tds_tpu_torch.algebra.spatial import cross_matrix

    k = cross_matrix(axis)
    eye = torch.eye(3, dtype=k.dtype, device=k.device)
    return eye + angle.sin()[..., None, None] * k + (1.0 - angle.cos())[..., None, None] * (k @ k)


def from_rpy(roll, pitch, yaw):
    """URDF rpy: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    return rotation_z(yaw) @ rotation_y(pitch) @ rotation_x(roll)
