"""Quaternion operations, xyzw storage, broadcasting over leading dims
(counterpart of tds_tpu/algebra/quaternion.py: what revolute-axis and
spherical joints and floating bases use).
"""

import torch


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def mul(a, b):
    """Hamilton product a ⊗ b (both xyzw)."""
    av, aw = a[..., :3], a[..., 3:4]
    bv, bw = b[..., :3], b[..., 3:4]
    if av.shape != bv.shape:
        av, bv = torch.broadcast_tensors(av, bv)
        aw, bw = torch.broadcast_tensors(aw, bw)
    vec = aw * bv + bw * av + torch.linalg.cross(av, bv, dim=-1)
    w = aw * bw - (av * bv).sum(-1, keepdim=True)
    return torch.cat([vec, w], dim=-1)


def conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


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


def from_matrix(m):
    """Rotation matrix -> xyzw quaternion (Shepperd's method without
    branches: four candidates, each stable in one regime, and the one with
    the largest pivot kept)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(1e-30))

    t_w = 1.0 + tr
    t_x = 1.0 + m00 - m11 - m22
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22
    qw = torch.stack([t_w, m21 - m12, m02 - m20, m10 - m01], dim=-1) / (2.0 * safe_sqrt(t_w))[..., None]
    qx = torch.stack([m21 - m12, t_x, m01 + m10, m02 + m20], dim=-1) / (2.0 * safe_sqrt(t_x))[..., None]
    qy = torch.stack([m02 - m20, m01 + m10, t_y, m12 + m21], dim=-1) / (2.0 * safe_sqrt(t_y))[..., None]
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, t_z], dim=-1) / (2.0 * safe_sqrt(t_z))[..., None]
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = pivots.argmax(-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, wxyz)
    sel = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
    return torch.cat([sel[..., 1:4], sel[..., 0:1]], dim=-1)


def from_axis_angle(axis, angle):
    """Quaternion for a rotation of ``angle`` (...,) about the unit
    ``axis`` (..., 3)."""
    half = 0.5 * angle
    vec = axis * half.sin().unsqueeze(-1)
    w = half.cos().unsqueeze(-1).expand(vec.shape[:-1] + (1,))
    return torch.cat([vec, w], dim=-1)


def to_axis_angle(q):
    """Rotation vector theta * axis, theta = 2 atan2(|qv|, qw); the scale
    theta / |qv| becomes its limit 2 / qw where |qv| <= 1e-12 (at the
    identity, where the humanoid's base starts)."""
    qv, qw = q[..., :3], q[..., 3]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    far = n > 1e-12
    scale = torch.where(far, theta / torch.where(far, n, torch.ones_like(n)), 2.0 / qw)
    return qv * scale[..., None]


def velocity_world(q, omega_world, dt):
    """Quaternion increment 0.5 dt (omega_world ⊗ q), the world-frame
    derivative of a floating base."""
    w = torch.cat([omega_world, torch.zeros_like(omega_world[..., :1])], dim=-1)
    return mul(w, q) * (0.5 * dt)


def integrate_world(q, omega_world, dt):
    """q + 0.5 dt (omega ⊗ q), renormalized."""
    return normalize(q + velocity_world(q, omega_world, dt))


def velocity_local(q, omega_local, dt):
    """Quaternion increment 0.5 dt (q ⊗ omega_local), the body-frame
    derivative of a spherical joint."""
    w = torch.cat([omega_local, torch.zeros_like(omega_local[..., :1])], dim=-1)
    return mul(q, w) * (0.5 * dt)


def integrate_local(q, omega_local, dt):
    """q + 0.5 dt (q ⊗ omega), renormalized."""
    return normalize(q + velocity_local(q, omega_local, dt))
