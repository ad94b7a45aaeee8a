"""Batched raycasts against spheres, planes, boxes and triangle meshes
(counterpart of tds_tpu/collision/raycast.py). Rays are (..., 3) origin
and target tensors, every hit test is branchless, and :func:`cast_rays`
takes the closest hit over a static list of shapes: a LIDAR-style scan of
a whole grid of rays in one call, on the card or the CPU."""

from typing import NamedTuple, Sequence

import torch

from tds_tpu_torch.algebra.spatial import cross, matvec
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.collision.narrowphase import _world_triangles, at_least
from tds_tpu_torch.model.geometry import Box, Mesh, Plane, Sphere
from tds_tpu_torch.utils.tensors import constant

BIG = 1e30  # the fraction of a ray that hits nothing


class RayHit(NamedTuple):
    fraction: torch.Tensor  # (...,) the hit's fraction along the ray, BIG on a miss
    normal: torch.Tensor  # (..., 3) the world normal at the hit
    geom_index: torch.Tensor  # (...,) int32 index of the closest shape, -1 for none

    @property
    def hit(self):
        return self.fraction <= 1.0


def ray_sphere(origin, target, center, radius):
    """Fraction along origin -> target of the first intersection with the
    sphere, BIG on a miss (the far root when the origin is inside)."""
    d = target - origin
    oc = origin - center
    a = (d * d).sum(-1)
    b = 2.0 * (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - 4 * a * c
    safe = at_least(disc, 0.0).sqrt()
    t0 = (-b - safe) / (2 * at_least(a, 1e-30))
    t1 = (-b + safe) / (2 * at_least(a, 1e-30))
    t = torch.where(t0 >= 0.0, t0, t1)
    return torch.where((disc < 0.0) | (t < 0.0), BIG, t)


def ray_plane(origin, target, normal, offset):
    """Fraction along origin -> target where the ray meets the plane
    n.x = offset, BIG when parallel or behind."""
    d = target - origin
    n = constant(tuple(normal), origin.dtype, origin.device)
    denom = (d * n).sum(-1)
    parallel = denom.abs() <= 1e-12
    t = (offset - (origin * n).sum(-1)) / torch.where(parallel, 1e-12, denom)
    return torch.where(parallel | (t < 0.0), BIG, t)


def ray_box(origin, target, x: Transform, half_extents):
    """Slab test in the box's frame, branchless: the entry fraction, BIG on a
    miss or when the origin is inside."""
    o = x.apply_inverse_point(origin)
    d = x.apply_inverse_point(target) - o
    he = constant(tuple(half_extents), origin.dtype, origin.device)
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    t1 = (-he - o) * inv
    t2 = (he - o) * inv
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= at_least(tmin, 0.0)) & (tmin >= 0.0)
    return torch.where(hit, tmin, BIG)


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


def cast_rays(origins, targets, shapes: Sequence, transforms: Sequence[Transform]) -> RayHit:
    """The closest hit of each ray over a static list of shapes, each placed
    by its world transform (a sphere's centre is its transform's position;
    a plane ignores its transform). ``origins`` and ``targets`` (..., 3)
    share their batch shape; shapes of other types are skipped. Among equal
    fractions the earlier shape wins."""
    dtype, device = origins.dtype, origins.device
    best_t = torch.full(origins.shape[:-1], BIG, dtype=dtype, device=device)
    best_n = torch.zeros_like(origins)
    best_i = torch.full(origins.shape[:-1], -1, dtype=torch.int32, device=device)
    d = targets - origins
    for idx, (shape, x) in enumerate(zip(shapes, transforms)):
        if isinstance(shape, Sphere):
            t = ray_sphere(origins, targets, x.pos, shape.radius)
            n = origins + t[..., None] * d - x.pos
            n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
        elif isinstance(shape, Plane):
            t = ray_plane(origins, targets, shape.normal, shape.constant)
            n = constant(tuple(shape.normal), dtype, device).expand(origins.shape)
        elif isinstance(shape, Box):
            he = [0.5 * e for e in shape.extents]
            t = ray_box(origins, targets, x, he)
            # the face's normal: the dominant axis of the local hit point
            scaled = x.apply_inverse_point(origins + t[..., None] * d) / constant(tuple(he), dtype, device)
            axis = scaled.abs().argmax(-1)
            n_local = torch.sign(scaled) * (torch.arange(3, device=device) == axis[..., None]).to(dtype)
            n = matvec(x.rot, n_local)
        elif isinstance(shape, Mesh):
            t, n = ray_mesh(origins, targets, shape, x)
        else:
            continue
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_n = torch.where(closer[..., None], n, best_n)
        best_i = torch.where(closer, idx, best_i)
    return RayHit(fraction=best_t, normal=best_n, geom_index=best_i)
