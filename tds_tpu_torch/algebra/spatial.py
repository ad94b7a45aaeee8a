"""Spatial (6D) vector algebra, Featherstone style, on batched tensors.

A spatial vector is a tensor of shape (..., 6) laid out as
``[top(3), bottom(3)]``: motion vectors are ``[w, v]``, force vectors
``[n, f]`` (counterpart of tds_tpu/algebra/spatial.py).
"""

import torch


def mv(top, bottom):
    """Spatial vector from its top (angular) and bottom (linear) halves,
    broadcast to a common batch shape."""
    if top.shape[:-1] != bottom.shape[:-1]:
        top, bottom = torch.broadcast_tensors(top, bottom)
    return torch.cat([top, bottom], dim=-1)


fv = mv  # force vectors share the container


def top(v):
    return v[..., :3]


def bottom(v):
    return v[..., 3:]


def zero(dtype=None, batch_shape=(), device=None):
    return torch.zeros(tuple(batch_shape) + (6,), dtype=dtype, device=device)


def cross(a, b):
    """3-vector cross product over the last axis, broadcasting."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def cross_mm(a, b):
    """Motion x motion: [w_a x w_b, w_a x v_b + v_a x w_b]."""
    at, ab = a[..., :3], a[..., 3:]
    bt, bb = b[..., :3], b[..., 3:]
    return mv(cross(at, bt), cross(at, bb) + cross(ab, bt))


def cross_mf(a, f):
    """Motion x* force: [w x n + v x f, w x f]."""
    at, ab = a[..., :3], a[..., 3:]
    ft, fb = f[..., :3], f[..., 3:]
    return fv(cross(at, ft) + cross(ab, fb), cross(at, fb))


def dot(a, b):
    """Scalar pairing of a motion and a force vector."""
    return (a * b).sum(-1)


def cross_matrix(v):
    """Skew-symmetric 3x3 matrix vx such that vx @ u = v x u."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def safe_norm(v, axis=-1):
    """|v| with a zero gradient at v = 0 (the double-where trick: a plain
    norm backpropagates NaN there)."""
    sq = (v * v).sum(axis)
    positive = sq > 0
    safe = torch.where(positive, sq, torch.ones_like(sq))
    return torch.where(positive, safe.sqrt(), torch.zeros_like(sq))


def safe_normalize(v, axis=-1, eps=1e-12):
    """(v / |v|, |v|), zero with a finite gradient at v = 0."""
    n = safe_norm(v, axis=axis)
    return v / torch.maximum(n, torch.full_like(n, eps)).unsqueeze(-1), n


def matvec(m, v):
    """(..., M, N) @ (..., N) -> (..., M), broadcasting the batch dims."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def matTvec(m, v):
    """m^T v: (..., N, M)^T @ (..., N) -> (..., M)."""
    return (v.unsqueeze(-2) @ m).squeeze(-2)
