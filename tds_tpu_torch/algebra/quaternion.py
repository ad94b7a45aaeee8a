"""Quaternion operations, xyzw storage, broadcasting over leading dims
(counterpart of tds_tpu/algebra/quaternion.py: the subset the laikago
slice runs, for REVOLUTE_AXIS joints).
"""

import torch


def to_matrix(q):
    """Active rotation matrix (R @ v_local = v_world) with the 2/|q|^2
    normalization, so unnormalized quaternions map to the same rotation."""
    x, y, z, w = q.unbind(-1)
    d = x * x + y * y + z * z + w * w
    s = 2.0 / d
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    one = torch.ones_like(d)
    return torch.stack(
        [
            torch.stack([one - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, one - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, one - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def from_axis_angle(axis, angle):
    """Quaternion for a rotation of ``angle`` (...,) about the unit
    ``axis`` (..., 3)."""
    half = 0.5 * angle
    vec = axis * half.sin().unsqueeze(-1)
    w = half.cos().unsqueeze(-1).expand(vec.shape[:-1] + (1,))
    return torch.cat([vec, w], dim=-1)
