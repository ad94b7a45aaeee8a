"""Analytic narrowphase with static contact counts (counterpart of
tds_tpu/collision/narrowphase.py). Every pair function emits its fixed
number of candidate points; the ``distance`` field decides activity
downstream by masking:

- plane-sphere (1 candidate), which the laikago slice collides, and
  plane-capsule (2: one sphere probe at each end of the axis), which the
  ant and the hopper collide;
- the terrains: sphere-heightfield and sphere-mesh (``max_contacts`` each:
  the nearest triangles' closest points), capsule-heightfield and
  capsule-mesh (twice that, the two end probes), plane-mesh (the
  ``max_contacts`` deepest vertices).

Contacts are ``Contact`` tuples with fields shaped (B, k, 3) / (B, k). A
shape pair's candidates come in the JAX package's order: where it picks
the k nearest with ``jax.lax.top_k`` (nearest first, the lower index first
among equal distances), the port takes a stable ``argsort``, whose first k
come in that order. The row order is the Gauss-Seidel order of the contact
solve, so it is part of the result. Sphere-sphere, capsule-sphere, every
box pair and mesh-mesh raise NotImplementedError in
:func:`compute_contacts` (ROADMAP Queue 1 item 9).
"""

from typing import NamedTuple

import functools

import numpy as np
import torch

from tds_tpu_torch.algebra.spatial import matvec
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


def flip(contact: Contact) -> Contact:
    """Swap the roles of a and b."""
    return Contact(
        normal_on_b=-contact.normal_on_b,
        point_a=contact.point_b,
        point_b=contact.point_a,
        distance=contact.distance,
    )


_PAIR_TABLE = {
    (Plane, Sphere): (plane_sphere, False),
    (Plane, Capsule): (plane_capsule, False),
    (Plane, Mesh): (plane_mesh, False),
    (Sphere, Mesh): (sphere_mesh, False),
    (Capsule, Mesh): (capsule_mesh, False),
    (Sphere, Heightfield): (sphere_heightfield, False),
    (Capsule, Heightfield): (capsule_heightfield, False),
    # reversed pairs
    (Sphere, Plane): (plane_sphere, True),
    (Capsule, Plane): (plane_capsule, True),
    (Mesh, Plane): (plane_mesh, True),
    (Mesh, Sphere): (sphere_mesh, True),
    (Mesh, Capsule): (capsule_mesh, True),
    (Heightfield, Sphere): (sphere_heightfield, True),
    (Heightfield, Capsule): (capsule_heightfield, True),
}


# pairs of ported shapes that the JAX package collides and the port does
# not yet: compute_contacts raises for them rather than skipping the pair
_UNPORTED_PAIRS = {
    (Sphere, Sphere), (Capsule, Sphere), (Sphere, Capsule),
    (Plane, Box), (Box, Plane), (Sphere, Box), (Box, Sphere),
    (Box, Mesh), (Mesh, Box), (Mesh, Mesh),
}


def supported(shape_a, shape_b) -> bool:
    """Whether the pair collides. A mesh or heightfield with
    ``max_contacts <= 0`` collides with nothing (a visual-only mesh)."""
    if any(isinstance(s, (Mesh, Heightfield)) and s.max_contacts <= 0 for s in (shape_a, shape_b)):
        return False
    key = (type(shape_a), type(shape_b))
    return key in _PAIR_TABLE or key in _UNPORTED_PAIRS


def ported(shape_a, shape_b) -> bool:
    """Whether :func:`compute_contacts` computes the pair (when it collides)."""
    return (type(shape_a), type(shape_b)) in _PAIR_TABLE


def compute_contacts(shape_a, xa: Transform, shape_b, xb: Transform) -> Contact:
    """Dispatch on the static shape types; a and b keep the argument order."""
    key = (type(shape_a), type(shape_b))
    if key not in _PAIR_TABLE:
        raise NotImplementedError(f"collision pair {key} is not ported to tds_tpu_torch yet")
    fn, reversed_ = _PAIR_TABLE[key]
    if reversed_:
        return flip(fn(shape_b, xb, shape_a, xa))
    return fn(shape_a, xa, shape_b, xb)
