"""Rays against a triangle mesh (counterpart of ``ray_mesh`` in
tds_tpu/collision/raycast.py), branchless over the mesh's triangles. The
JAX package's rays against spheres, planes and boxes and its ``cast_rays``
are not ported yet (ROADMAP Queue 1 item 9)."""

import torch

from tds_tpu_torch.algebra.spatial import cross
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.collision.narrowphase import _world_triangles
from tds_tpu_torch.model.geometry import Mesh

BIG = 1e30  # the fraction of a ray that hits nothing


def ray_mesh(origin, target, mesh: Mesh, x: Transform):
    """Moller-Trumbore over every triangle of ``mesh`` placed by ``x``, for
    rays (..., 3) from ``origin`` to ``target``. Returns (fraction (...,)
    along origin -> target of the nearest hit, BIG on a miss; world normal
    (..., 3) of the hit triangle, turned against the ray). Among equal
    fractions the lower triangle index wins."""
    a, b, c = _world_triangles(mesh, x)  # (..., T, 3)
    d = (target - origin)[..., None, :]  # (..., 1, 3)
    o = origin[..., None, :]
    e1 = b - a
    e2 = c - a
    h = cross(d, e2)
    det = (e1 * h).sum(-1)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    s = o - a
    u = (s * h).sum(-1) * inv_det
    q = cross(s, e1)
    v = (d * q).sum(-1) * inv_det
    t = (e2 * q).sum(-1) * inv_det
    valid = (det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    t = torch.where(valid, t, BIG)  # (..., T)
    imin = t.argmin(-1, keepdim=True)
    n_tri = cross(e1, e2)
    n_tri = n_tri / torch.linalg.vector_norm(n_tri, dim=-1, keepdim=True).clamp_min(1e-12)
    n_hit = n_tri.expand(*t.shape, 3).gather(-2, imin[..., None].expand(*imin.shape, 3))[..., 0, :]
    # turned against the ray's direction
    side = torch.sign((n_hit * d[..., 0, :]).sum(-1))
    n_hit = -n_hit * torch.where(side == 0, 1.0, side)[..., None]
    return t.gather(-1, imin)[..., 0], n_hit
