"""Analytic narrowphase with static contact counts (counterpart of
tds_tpu/collision/narrowphase.py). Every pair function emits its fixed
number of candidate points; the ``distance`` field decides activity
downstream by masking:

- sphere-sphere, plane-sphere, sphere-box and capsule-sphere (1
  candidate each), plane-capsule (2: one sphere probe at each end of the
  axis), plane-box (8: a shrunk sphere at each corner);
- the terrains: sphere-heightfield and sphere-mesh (``max_contacts`` each:
  the nearest triangles' closest points), capsule-heightfield and
  capsule-mesh (twice that, the two end probes), plane-mesh (the
  ``max_contacts`` deepest vertices);
- box-mesh (8 ``max_contacts``: the corner spheres against the mesh) and
  mesh-mesh (``max_contacts`` of the larger per direction, each mesh's
  vertices probing the other's surface, and ``edge_contacts`` more per
  direction when both meshes set it: closest points between edges).

Contacts are ``Contact`` tuples with fields shaped (B, k, 3) / (B, k). A
shape pair's candidates come in the JAX package's order: where it picks
the k nearest with ``jax.lax.top_k`` (nearest first, the lower index first
among equal distances), the port takes a stable ``argsort``, whose first k
come in that order, and where it picks one with ``argmin``, the first
index among equal values wins, as ``torch.argmin``'s does. The row order is
the Gauss-Seidel order of the contact solve, so it is part of the result.
Clips and floors are ``torch.maximum``/``torch.minimum``, whose gradient
splits half and half at a tie as ``jnp.clip``'s and ``jnp.maximum``'s do.
"""

from typing import NamedTuple

import functools

import numpy as np
import torch

from tds_tpu_torch.algebra.spatial import cross, matvec
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.model.geometry import Box, Capsule, Heightfield, Mesh, Plane, Sphere
from tds_tpu_torch.utils.obj import mesh_data
from tds_tpu_torch.utils.tensors import constant


class Contact(NamedTuple):
    """Candidate contact points (k per pair, stacked on axis -2)."""

    normal_on_b: torch.Tensor  # (B, k, 3) world normal on body b
    point_a: torch.Tensor  # (B, k, 3) world point on a
    point_b: torch.Tensor  # (B, k, 3) world point on b
    distance: torch.Tensor  # (B, k) signed distance, negative when penetrating

    @property
    def count(self):
        return self.normal_on_b.shape[-2]

    @staticmethod
    def concatenate(contacts):
        return Contact(
            normal_on_b=torch.cat([c.normal_on_b for c in contacts], dim=-2),
            point_a=torch.cat([c.point_a for c in contacts], dim=-2),
            point_b=torch.cat([c.point_b for c in contacts], dim=-2),
            distance=torch.cat([c.distance for c in contacts], dim=-1),
        )


def plane_sphere(pa: Plane, xa: Transform, sb: Sphere, xb: Transform) -> Contact:
    """Sphere against an infinite plane; the normal on b is -plane normal."""
    n = constant(tuple(pa.normal), xb.pos.dtype, xb.pos.device)
    t = (xb.pos * n).sum(-1) - pa.constant
    point_a = xb.pos - t[..., None] * n
    distance = t - sb.radius
    point_b = xb.pos - sb.radius * n
    normal = (-n).expand(point_b.shape)
    return Contact(
        normal_on_b=normal[..., None, :],
        point_a=point_a[..., None, :],
        point_b=point_b[..., None, :],
        distance=distance[..., None],
    )


def plane_capsule(pa: Plane, xa: Transform, cb: Capsule, xb: Transform) -> Contact:
    """Two sphere probes at the capsule's axis endpoints, +length/2 first
    (the capsule's axis is its local Z)."""
    half = 0.5 * cb.length
    sphere = Sphere(cb.radius)
    probes = []
    for sz in (half, -half):
        center = xb.apply_point(constant((0.0, 0.0, sz), xb.pos.dtype, xb.pos.device))
        probes.append(plane_sphere(pa, xa, sphere, Transform(pos=center, rot=xb.rot)))
    return Contact.concatenate(probes)


def safe_norm(v):
    """|v| over the last axis, with a zero (not NaN) gradient at v = 0."""
    sq = (v * v).sum(-1)
    positive = sq > 0
    return torch.where(positive, torch.where(positive, sq, 1.0).sqrt(), 0.0)


def at_least(x, floor: float):
    """``jnp.maximum(x, floor)``: at a tie the gradient splits half and half."""
    return torch.maximum(x, torch.full_like(x, floor))


def clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``, ``minimum(maximum(x, lo), hi)`` with its
    half-and-half gradient at a bound (``torch.clamp`` passes all of it);
    the bounds are numbers or tensors that broadcast against ``x``."""
    lo = torch.full_like(x, lo) if isinstance(lo, (int, float)) else lo
    hi = torch.full_like(x, hi) if isinstance(hi, (int, float)) else hi
    return torch.minimum(torch.maximum(x, lo), hi)


def sphere_sphere(sa: Sphere, xa: Transform, sb: Sphere, xb: Transform) -> Contact:
    """Two spheres: the normal on b points from b's centre toward a's."""
    diff = xa.pos - xb.pos
    length = safe_norm(diff)
    normal = diff / at_least(length, 1e-12)[..., None]
    distance = length - (sa.radius + sb.radius)
    point_a = xa.pos - sa.radius * normal
    point_b = point_a - distance[..., None] * normal
    return Contact(
        normal_on_b=normal[..., None, :],
        point_a=point_a[..., None, :],
        point_b=point_b[..., None, :],
        distance=distance[..., None],
    )


def _box_corners(box: Box, dtype, device):
    """(the 8 shrunk corners (8, 3) in the box frame, their sphere's radius):
    spheres of radius r = 1e-2 (the reference's least corner radius; a box
    carries none of its own) inside the corners, x the outer loop and +
    before -, the JAX package's order."""
    r = 1e-2
    he = [0.5 * e - r for e in box.extents]
    corners = tuple(
        (sx * he[0], sy * he[1], sz * he[2]) for sx in (1.0, -1.0) for sy in (1.0, -1.0) for sz in (1.0, -1.0)
    )
    return constant(corners, dtype, device), r


def plane_box(pa: Plane, xa: Transform, bb: Box, xb: Transform) -> Contact:
    """Eight corner-sphere probes against the plane."""
    corners, r = _box_corners(bb, xb.pos.dtype, xb.pos.device)
    centers = torch.einsum("...ij,kj->...ki", xb.rot, corners) + xb.pos[..., None, :]  # (..., 8, 3)
    n = constant(tuple(pa.normal), xb.pos.dtype, xb.pos.device)
    t = (centers * n).sum(-1) - pa.constant
    point_b = centers - r * n
    return Contact(
        normal_on_b=(-n).expand(point_b.shape),
        point_a=centers - t[..., None] * n,
        point_b=point_b,
        distance=t - r,
    )


# the outward normals of a box's faces in the order of sphere_box's face
# distances: +x, -x, +y, -y, +z, -z
_FACE_NORMALS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))


def sphere_box(sa: Sphere, xa: Transform, bb: Box, xb: Transform) -> Contact:
    """Branchless sphere-box: the sphere's centre clipped to the box; a
    centre inside the box is pushed out through its nearest face (the
    first of +x, -x, +y, -y, +z, -z among equal distances)."""
    dtype, device = xa.pos.dtype, xa.pos.device
    he = constant(tuple(0.5 * e for e in bb.extents), dtype, device)
    rel = xb.apply_inverse_point(xa.pos)
    closest = clip(rel, -he, he)
    delta = rel - closest
    dist_out = safe_norm(delta)
    outside = dist_out > 1e-12
    n_out = delta / at_least(dist_out, 1e-12)[..., None]
    # inside: the distance to each face, the nearest face taken
    face_d = torch.stack(
        [he[0] - rel[..., 0], he[0] + rel[..., 0], he[1] - rel[..., 1], he[1] + rel[..., 1], he[2] - rel[..., 2], he[2] + rel[..., 2]],
        dim=-1,
    )
    face = face_d.argmin(-1)
    n_in = constant(_FACE_NORMALS, dtype, device)[face]
    d_in = -face_d.gather(-1, face[..., None])[..., 0]
    closest_in = rel - d_in[..., None] * n_in
    n_local = torch.where(outside[..., None], n_out, n_in)
    dist_center = torch.where(outside, dist_out, d_in)
    closest_local = torch.where(outside[..., None], closest, closest_in)
    normal = matvec(xb.rot, n_local)
    return Contact(
        normal_on_b=normal[..., None, :],
        point_a=(xa.pos - sa.radius * normal)[..., None, :],
        point_b=xb.apply_point(closest_local)[..., None, :],
        distance=(dist_center - sa.radius)[..., None],
    )


def capsule_sphere(ca: Capsule, xa: Transform, sb: Sphere, xb: Transform) -> Contact:
    """The sphere against the nearest point of the capsule's axis segment,
    as sphere-sphere."""
    half = 0.5 * ca.length
    t = clip(xa.apply_inverse_point(xb.pos)[..., 2], -half, half)
    zero = torch.zeros_like(t)
    center = xa.apply_point(torch.stack([zero, zero, t], dim=-1))
    return sphere_sphere(Sphere(ca.radius), Transform(pos=center, rot=xa.rot), sb, xb)


def nearest(distance, k: int):
    """(distances, indices) of the k least ``distance`` values of each row,
    least first, the lower index first among equal values: the order of
    ``jax.lax.top_k(-distance, k)``. Unlike ``mlcp.top_k_indices`` it keeps
    that order (no re-sort into candidate order), and it runs on the CPU
    and the card alike (a stable sort; ``torch.topk`` keeps no order among
    ties)."""
    if k > distance.shape[-1]:
        raise ValueError(f"k = {k} exceeds the {distance.shape[-1]} candidates")
    idx = torch.argsort(distance, dim=-1, stable=True)[..., :k]
    return distance.gather(-1, idx), idx


def _take(x, idx):
    """x (..., n, 3) at the indices idx (..., k) of its axis -2."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


@functools.lru_cache(maxsize=64)
def _mesh_tensors(file_name: str, scale, dtype: torch.dtype, device: torch.device):
    """(vertices (V, 3), and the triangles' first, second and third vertex
    indices, each (T,)) of a mesh on ``device``, built once."""
    vertices, triangles = mesh_data(file_name, scale)
    corners = torch.from_numpy(np.ascontiguousarray(triangles.T, dtype=np.int64)).to(device)
    return (torch.from_numpy(vertices).to(device=device, dtype=dtype), *corners.unbind(0))


def _world_vertices(mesh: Mesh, xb: Transform):
    """The mesh's vertices (..., V, 3) placed by ``xb``, in its dtype."""
    verts = _mesh_tensors(mesh.file_name, mesh.scale, xb.pos.dtype, xb.pos.device)[0]
    return torch.einsum("...ij,vj->...vi", xb.rot, verts) + xb.pos[..., None, :]


def _world_triangles(mesh: Mesh, xb: Transform):
    """The triangles' corners (a, b, c), each (..., T, 3), placed by ``xb``."""
    _, ia, ib, ic = _mesh_tensors(mesh.file_name, mesh.scale, xb.pos.dtype, xb.pos.device)
    w = _world_vertices(mesh, xb)
    return w.index_select(-2, ia), w.index_select(-2, ib), w.index_select(-2, ic)


def plane_mesh(pa: Plane, xa: Transform, mb: Mesh, xb: Transform) -> Contact:
    """The mesh's ``max_contacts`` deepest vertices against the plane."""
    n = constant(tuple(pa.normal), xb.pos.dtype, xb.pos.device)
    w = _world_vertices(mb, xb)  # (..., V, 3)
    distance, idx = nearest((w * n).sum(-1) - pa.constant, int(mb.max_contacts))
    point_b = _take(w, idx)
    point_a = point_b - distance[..., None] * n
    return Contact(normal_on_b=(-n).expand(point_b.shape), point_a=point_a, point_b=point_b, distance=distance)


def _closest_point_on_triangles(p, a, b, c):
    """Branchless closest point on each triangle (a, b, c) to the point p
    (Ericson, Real-Time Collision Detection 5.1.5, the Voronoi regions as
    nested ``torch.where``s, the vertex regions applied last so that they
    win). p (..., 1, 3) broadcasts against the corners (..., T, 3)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(x.abs() > 1e-30, x, 1e-30)

    # the candidate point of each region
    p_ab = a + (d1 / safe(d1 - d3))[..., None] * ab
    p_ac = a + (d2 / safe(d2 - d6))[..., None] * ac
    p_bc = b + ((d4 - d3) / safe((d4 - d3) + (d5 - d6)))[..., None] * (c - b)
    denom = safe(va + vb + vc)
    out = a + (vb / denom)[..., None] * ab + (vc / denom)[..., None] * ac
    for region, point in (
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), p_bc),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), p_ac),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), p_ab),
        ((d6 >= 0) & (d5 <= d6), c),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d1 <= 0) & (d2 <= 0), a),
    ):
        out = torch.where(region[..., None], point, out)
    return out


def sphere_mesh(sa: Sphere, xa: Transform, mb: Mesh, xb: Transform) -> Contact:
    """The closest points of the ``max_contacts`` triangles nearest to the
    sphere's centre. The distance is unsigned (the centre is taken to lie
    outside the surface); adjacent triangles may report the same point,
    redundant rows for the solve."""
    ta, tb, tc = _world_triangles(mb, xb)
    center = xa.pos[..., None, :]
    closest = _closest_point_on_triangles(center, ta, tb, tc)  # (..., T, 3)
    diff = center - closest
    length = safe_norm(diff)
    distance, idx = nearest(length - sa.radius, int(mb.max_contacts))
    # the unit normal from the surface toward the sphere's centre
    normal = _take(diff, idx) / length.gather(-1, idx).clamp_min(1e-12)[..., None]
    return Contact(
        normal_on_b=normal, point_a=center - sa.radius * normal, point_b=_take(closest, idx), distance=distance
    )


def _grid(hf: Heightfield):
    """(x0, y0, dx, dy) of the heightfield's grid."""
    (x0, x1), (y0, y1) = hf.x_range, hf.y_range
    return x0, y0, (x1 - x0) / (hf.nx - 1), (y1 - y0) / (hf.ny - 1)


def _heightfield_cell_triangles(hf: Heightfield, i, j, dtype):
    """The local-frame corners (a, b, c), each (..., 2, 3), of the two
    triangles of cell (i, j), (a, b, d) and (a, d, c) as
    ``utils.terrain.heightfield_obj`` writes them; ``i`` and ``j`` are
    integer tensors of clipped cell indices. The cell's origin x0 + i dx
    is computed in ``dtype``, the working type (the JAX package computes it
    in its default float type, float64 under x64, then casts)."""
    x0, y0, dx, dy = _grid(hf)
    h = constant(hf.heights, dtype, i.device)
    xi = x0 + i.to(dtype) * dx
    yj = y0 + j.to(dtype) * dy

    def corner(di, dj):
        z = h.take((j + dj) * hf.nx + (i + di))
        return torch.stack([xi + di * dx, yj + dj * dy, z], dim=-1)

    pa, pb, pc, pd = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    return torch.stack([pa, pa], dim=-2), torch.stack([pb, pd], dim=-2), torch.stack([pd, pc], dim=-2)


def _cell_index(hf: Heightfield, x, y):
    """The (clipped) indices of the cells holding the local points (x, y)."""
    x0, y0, dx, dy = _grid(hf)
    i = torch.floor((x - x0) / dx).long().clamp(0, hf.nx - 2)
    j = torch.floor((y - y0) / dy).long().clamp(0, hf.ny - 2)
    return i, j


def heightfield_height(hf: Heightfield, x, y):
    """Height of the triangulated surface (piecewise planar, the surface the
    contacts see) at the local points (x, y); outside the grid, the
    border cells' planes extended."""
    x0, y0, dx, dy = _grid(hf)
    fx = (x - x0) / dx
    fy = (y - y0) / dy
    i = torch.floor(fx).long().clamp(0, hf.nx - 2)
    j = torch.floor(fy).long().clamp(0, hf.ny - 2)
    u = fx - i
    v = fy - j
    h = constant(hf.heights, x.dtype, x.device)

    def z(di, dj):
        return h.take((j + dj) * hf.nx + (i + di))

    h00, h10, h01, h11 = z(0, 0), z(1, 0), z(0, 1), z(1, 1)
    lower = h00 + u * (h10 - h00) + v * (h11 - h10)  # triangle (a, b, d)
    upper = h00 + u * (h11 - h01) + v * (h01 - h00)  # triangle (a, d, c)
    return torch.where(v <= u, lower, upper)


# the 3x3 cells around a point's own, di the outer loop, as the JAX package
# enumerates them
_NEIGHBOURS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


def sphere_heightfield(sa: Sphere, xa: Transform, hf: Heightfield, xb: Transform) -> Contact:
    """The closest points of the ``max_contacts`` nearest of the 18
    triangles of the 3x3 cells around the sphere's centre: O(1) in the
    grid's size, and the same contacts as ``sphere_mesh`` on the equivalent
    mesh while the nearest feature lies within one cell of the centre (a
    radius under the cell size). Neighbour cells off the grid are masked to
    a length of 1e30, not clipped: a clipped one would repeat a border
    cell's triangles among the candidates."""
    device = xa.pos.device
    local = xb.apply_inverse_point(xa.pos)  # (..., 3)
    i0, j0 = _cell_index(hf, local[..., 0], local[..., 1])
    ri = i0[..., None] + constant(tuple(di for di, _ in _NEIGHBOURS), torch.long, device)  # (..., 9)
    rj = j0[..., None] + constant(tuple(dj for _, dj in _NEIGHBOURS), torch.long, device)
    valid = (ri >= 0) & (ri <= hf.nx - 2) & (rj >= 0) & (rj <= hf.ny - 2)
    corners = _heightfield_cell_triangles(hf, ri.clamp(0, hf.nx - 2), rj.clamp(0, hf.ny - 2), local.dtype)
    ta, tb, tc = (t.flatten(-3, -2) for t in corners)  # (..., 18, 3): cell by cell, two triangles each
    valid = valid[..., None].expand(*valid.shape, 2).flatten(-2)  # (..., 18)
    center = local[..., None, :]
    closest = _closest_point_on_triangles(center, ta, tb, tc)
    diff = center - closest
    length = torch.where(valid, safe_norm(diff), 1e30)
    distance, idx = nearest(length - sa.radius, int(hf.max_contacts))
    n_local = _take(diff, idx) / length.gather(-1, idx).clamp_min(1e-12)[..., None]
    normal = matvec(xb.rot[..., None, :, :], n_local)
    return Contact(
        normal_on_b=normal,
        point_a=xa.pos[..., None, :] - sa.radius * normal,
        point_b=xb.apply_point(_take(closest, idx)),
        distance=distance,
    )


def _capsule_probes(pair_fn, ca: Capsule, xa: Transform, shape_b, xb: Transform) -> Contact:
    """A capsule against ``shape_b`` as two sphere probes at its axis ends,
    +length/2 first (the capsule's axis is its local Z)."""
    half = 0.5 * ca.length
    sphere = Sphere(ca.radius)
    probes = []
    for sz in (half, -half):
        center = xa.apply_point(constant((0.0, 0.0, sz), xa.pos.dtype, xa.pos.device))
        probes.append(pair_fn(sphere, Transform(pos=center, rot=xa.rot), shape_b, xb))
    return Contact.concatenate(probes)


def capsule_heightfield(ca: Capsule, xa: Transform, hf: Heightfield, xb: Transform) -> Contact:
    """Two sphere probes against the heightfield: 2 max_contacts candidates."""
    return _capsule_probes(sphere_heightfield, ca, xa, hf, xb)


def capsule_mesh(ca: Capsule, xa: Transform, mb: Mesh, xb: Transform) -> Contact:
    """Two sphere probes against the mesh: 2 max_contacts candidates."""
    return _capsule_probes(sphere_mesh, ca, xa, mb, xb)


def box_mesh(ba: Box, xa: Transform, mb: Mesh, xb: Transform) -> Contact:
    """Eight shrunk corner-sphere probes against the mesh, as plane-box's:
    8 max_contacts candidates, corner by corner."""
    corners, r = _box_corners(ba, xa.pos.dtype, xa.pos.device)
    sphere = Sphere(r)
    return Contact.concatenate(
        [sphere_mesh(sphere, Transform(pos=xa.apply_point(corner), rot=xa.rot), mb, xb) for corner in corners.unbind(0)]
    )


def _triangle_normals(ta, tb, tc):
    """Unit normals of triangles wound counter-clockwise seen from outside."""
    n = cross(tb - ta, tc - ta)
    return n / at_least(safe_norm(n), 1e-12)[..., None]


def _probe_points_vs_mesh(p, mesh: Mesh, xs: Transform, k: int):
    """The k deepest of the probe points ``p`` (..., P, 3) against the
    surface of ``mesh`` placed by ``xs``: each probe's closest point over
    the triangles, the nearest triangle's (the first among equal distances)
    outward normal giving the sign (exact for convex surfaces, a local test
    for closed meshes wound consistently). Returns the k chosen probes'
    (points, surface points, outward normals) (..., k, 3) and signed
    distances (..., k), negative inside."""
    ta, tb, tc = _world_triangles(mesh, xs)  # (..., T, 3)
    nrm = _triangle_normals(ta, tb, tc)
    closest = _closest_point_on_triangles(
        p[..., :, None, :], ta[..., None, :, :], tb[..., None, :, :], tc[..., None, :, :]
    )  # (..., P, T, 3)
    # a static body's points or surface carry no batch axis: give it theirs
    batch = closest.shape[:-3]
    p, nrm = p.expand(*batch, *p.shape[-2:]), nrm.expand(*batch, *nrm.shape[-2:])
    dist = safe_norm(p[..., :, None, :] - closest)  # (..., P, T)
    tmin = dist.argmin(-1)  # (..., P) the nearest triangle
    d_near = dist.gather(-1, tmin[..., None])[..., 0]
    c_near = closest.gather(-2, tmin[..., None, None].expand(*tmin.shape, 1, 3))[..., 0, :]
    n_near = _take(nrm, tmin)
    side = torch.sign(((p - c_near) * n_near).sum(-1))
    side = torch.where(side == 0, 1.0, side)
    distance, idx = nearest(side * d_near, k)
    return _take(p, idx), _take(c_near, idx), _take(n_near, idx), distance


def _closest_point_segments(p1, q1, p2, q2, eps=1e-12):
    """Branchless closest points between the segments [p1, q1] and [p2, q2]
    (Ericson, Real-Time Collision Detection 5.1.9, clamped): s for parallel
    segments 0, t solved for s and clipped, then s solved again for the
    clipped t. The inputs broadcast; returns (c1 on segment 1, c2 on 2)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = (d1 * d1).sum(-1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = a * e - b * b
    s = torch.where(denom > eps, clip((b * f - c * e) / at_least(denom, eps), 0.0, 1.0), 0.0)
    t = clip((b * s + f) / at_least(e, eps), 0.0, 1.0)
    s = clip((b * t - c) / at_least(a, eps), 0.0, 1.0)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


@functools.lru_cache(maxsize=64)
def _mesh_edges(file_name: str, scale, device: torch.device):
    """The mesh's unique undirected edges: (first, second) vertex indices,
    each (E,), sorted as ``numpy.unique`` sorts the (low, high) pairs."""
    _, tris = mesh_data(file_name, scale)
    e = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    edges = torch.from_numpy(np.ascontiguousarray(np.unique(e, axis=0).T, dtype=np.int64)).to(device)
    return edges[0], edges[1]


def _world_edge_endpoints(mesh: Mesh, x: Transform):
    """The endpoints of the mesh's edges, each (..., E, 3), placed by ``x``."""
    w = _world_vertices(mesh, x)
    first, second = _mesh_edges(mesh.file_name, mesh.scale, x.pos.device)
    return w.index_select(-2, first), w.index_select(-2, second)


def mesh_mesh(ma: Mesh, xa: Transform, mbb: Mesh, xb: Transform) -> Contact:
    """Mesh against mesh, both ways: A's vertices probe B's surface, then
    B's probe A's, k = the larger ``max_contacts`` deepest of each. With
    ``edge_contacts`` = k_e on both meshes, the closest point of each of A's
    edges to each of B's probes B's surface and the one on B's edge probes
    A's, the k_e deepest of each (crossing edges touch where no vertex is:
    two cubes meeting edge on edge). O(E_a E_b T): for small meshes.

    A probe lying exactly on the other surface (equal cubes side by side,
    their side faces coincident) measures 0 to that face, which may hide a
    deeper penetration through another: the signed distance is local."""
    k = int(max(ma.max_contacts, mbb.max_contacts))
    pa1, pb1, n1, d1 = _probe_points_vs_mesh(_world_vertices(ma, xa), mbb, xb, k)
    pb2, pa2, n2, d2 = _probe_points_vs_mesh(_world_vertices(mbb, xb), ma, xa, k)
    parts = [
        Contact(normal_on_b=n1, point_a=pa1, point_b=pb1, distance=d1),
        Contact(normal_on_b=-n2, point_a=pa2, point_b=pb2, distance=d2),  # B's probes: roles swapped back
    ]
    k_e = int(min(ma.edge_contacts, mbb.edge_contacts))
    if k_e > 0:
        a0, a1 = _world_edge_endpoints(ma, xa)
        b0, b1 = _world_edge_endpoints(mbb, xb)
        ca, cb = _closest_point_segments(a0[..., :, None, :], a1[..., :, None, :], b0[..., None, :, :], b1[..., None, :, :])
        pe1, se1, ne1, de1 = _probe_points_vs_mesh(ca.flatten(-3, -2), mbb, xb, k_e)
        parts.append(Contact(normal_on_b=ne1, point_a=pe1, point_b=se1, distance=de1))
        pe2, se2, ne2, de2 = _probe_points_vs_mesh(cb.flatten(-3, -2), ma, xa, k_e)
        # the probes lie on B's edges here, the surface points on A
        parts.append(Contact(normal_on_b=-ne2, point_a=se2, point_b=pe2, distance=de2))
    return Contact.concatenate(parts)


def flip(contact: Contact) -> Contact:
    """Swap the roles of a and b."""
    return Contact(
        normal_on_b=-contact.normal_on_b,
        point_a=contact.point_b,
        point_b=contact.point_a,
        distance=contact.distance,
    )


_PAIR_TABLE = {
    (Sphere, Sphere): (sphere_sphere, False),
    (Plane, Sphere): (plane_sphere, False),
    (Plane, Capsule): (plane_capsule, False),
    (Plane, Box): (plane_box, False),
    (Sphere, Box): (sphere_box, False),
    (Capsule, Sphere): (capsule_sphere, False),
    (Plane, Mesh): (plane_mesh, False),
    (Sphere, Mesh): (sphere_mesh, False),
    (Capsule, Mesh): (capsule_mesh, False),
    (Box, Mesh): (box_mesh, False),
    (Mesh, Mesh): (mesh_mesh, False),
    (Sphere, Heightfield): (sphere_heightfield, False),
    (Capsule, Heightfield): (capsule_heightfield, False),
    # reversed pairs
    (Sphere, Plane): (plane_sphere, True),
    (Capsule, Plane): (plane_capsule, True),
    (Box, Plane): (plane_box, True),
    (Box, Sphere): (sphere_box, True),
    (Sphere, Capsule): (capsule_sphere, True),
    (Mesh, Plane): (plane_mesh, True),
    (Mesh, Sphere): (sphere_mesh, True),
    (Mesh, Capsule): (capsule_mesh, True),
    (Mesh, Box): (box_mesh, True),
    (Heightfield, Sphere): (sphere_heightfield, True),
    (Heightfield, Capsule): (capsule_heightfield, True),
}


def supported(shape_a, shape_b) -> bool:
    """Whether the pair collides. A mesh or heightfield with
    ``max_contacts <= 0`` collides with nothing (a visual-only mesh)."""
    if any(isinstance(s, (Mesh, Heightfield)) and s.max_contacts <= 0 for s in (shape_a, shape_b)):
        return False
    return (type(shape_a), type(shape_b)) in _PAIR_TABLE


def compute_contacts(shape_a, xa: Transform, shape_b, xb: Transform) -> Contact:
    """Dispatch on the static shape types; a and b keep the argument order."""
    key = (type(shape_a), type(shape_b))
    if key not in _PAIR_TABLE:
        raise KeyError(f"unsupported collision pair {key}")
    fn, reversed_ = _PAIR_TABLE[key]
    if reversed_:
        return flip(fn(shape_b, xb, shape_a, xa))
    return fn(shape_a, xa, shape_b, xb)
