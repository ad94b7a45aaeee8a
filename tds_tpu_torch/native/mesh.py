"""The mass properties of a closed triangle mesh and the isosurface of a
signed-distance grid (counterparts of ``mesh_mass_properties`` and
``marching_cubes`` in tds_tpu/native/mesh.py, whose C++ source
``tds_tpu/native/src/mesh_native.cpp`` these compute the same values as),
in numpy: no native library. ``load_obj`` and ``load_obj_file`` read OBJ
text and files through ``utils.obj``'s reader (the JAX package's
``get_lib``, its ctypes build of that source, has no counterpart: the port
builds nothing but its CUDA kernels).

Each triangle (a, b, c), wound counter-clockwise seen from outside, and the
origin span a tetrahedron of signed volume det[a, b, c] / 6; the sums of
their volumes, first moments and second moments are the solid's mass,
centre of mass and inertia about the origin, shifted to the centre of mass
by the parallel-axis theorem.
"""

import numpy as np

from tds_tpu_torch.utils import obj


def load_obj(text: str):
    """(vertices (n, 3) float64, triangles (m, 3) int32) of OBJ ``text``."""
    return obj.load_obj(text)


def load_obj_file(path: str):
    """:func:`load_obj` of the file at ``path``."""
    with open(path) as f:
        return obj.load_obj(f.read())


def mesh_mass_properties(vertices, triangles, density: float = 1000.0):
    """(mass, com (3,), inertia about the com (3, 3)) of the solid bounded
    by ``triangles`` (m, 3) int over ``vertices`` (n, 3), at ``density``."""
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int64)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    det = (
        a[:, 0] * (b[:, 1] * c[:, 2] - b[:, 2] * c[:, 1])
        - a[:, 1] * (b[:, 0] * c[:, 2] - b[:, 2] * c[:, 0])
        + a[:, 2] * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
    )
    vol = det / 6.0
    volume = vol.sum()
    first = (vol[:, None] * (a + b + c) / 4.0).sum(0)

    def sq(i):
        """The second moment's x_i x_i integrand over a tetrahedron."""
        x0, x1, x2 = a[:, i], b[:, i], c[:, i]
        return x0 * x0 + x1 * x1 + x2 * x2 + x0 * x1 + x0 * x2 + x1 * x2

    def product(i, j):
        """The product-of-inertia integrand x_i x_j over a tetrahedron."""
        return (
            2.0 * (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j])
            + a[:, i] * b[:, j] + a[:, j] * b[:, i] + a[:, i] * c[:, j] + a[:, j] * c[:, i]
            + b[:, i] * c[:, j] + b[:, j] * c[:, i]
        )

    xx, yy, zz = sq(0), sq(1), sq(2)
    mass = density * volume
    com = first / volume if abs(volume) > 1e-30 else np.zeros(3)
    k = density / 60.0
    ixx = k * (det * (yy + zz)).sum()
    iyy = k * (det * (xx + zz)).sum()
    izz = k * (det * (xx + yy)).sum()
    ixy = -density / 120.0 * (det * product(0, 1)).sum()
    ixz = -density / 120.0 * (det * product(0, 2)).sum()
    iyz = -density / 120.0 * (det * product(1, 2)).sum()
    # the origin's inertia shifted to the centre of mass
    x, y, z = com
    ixx -= mass * (y * y + z * z)
    iyy -= mass * (x * x + z * z)
    izz -= mass * (x * x + y * y)
    ixy += mass * x * y
    ixz += mass * x * z
    iyz += mass * y * z
    inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return float(mass), com, inertia


# marching tetrahedra: each grid cube splits into 6 tetrahedra around its
# 0-6 diagonal; a tetrahedron that the isosurface crosses emits 1 or 2
# triangles by its 4-bit inside pattern
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def _tet_table():
    """(edges (16, 2, 3, 2): each pattern's triangles as (from, to) vertex
    pairs of the tetrahedron, count (16,)), in the order the C++
    ``polygonize_tet`` writes them."""
    edges = np.zeros((16, 2, 3, 2), np.int64)
    count = np.zeros(16, np.int64)
    for pattern in range(16):
        inside = [i for i in range(4) if pattern >> i & 1]
        outside = [i for i in range(4) if not pattern >> i & 1]
        if len(inside) in (1, 3):
            apex = inside[0] if len(inside) == 1 else outside[0]
            others = [i for i in range(4) if i != apex]
            edges[pattern, 0] = [(apex, o) for o in others]
            count[pattern] = 1
        elif len(inside) == 2:
            (a0, a1), (b0, b1) = inside, outside
            quad = [(a0, b0), (a0, b1), (a1, b1), (a1, b0)]
            edges[pattern, 0] = [quad[0], quad[1], quad[2]]
            edges[pattern, 1] = [quad[0], quad[2], quad[3]]
            count[pattern] = 2
    return edges, count


_TET_EDGES, _TET_COUNT = _tet_table()


def marching_cubes(sdf, origin, dx: float, iso: float = 0.0, max_triangles: int = 500000) -> np.ndarray:
    """Isosurface triangle soup (t, 3, 3) of a dense SDF grid indexed
    [z, y, x], by marching tetrahedra, in the C++ loop's order (cubes z,
    then y, then x outermost first; the 6 tetrahedra of a cube in turn) and
    with its arithmetic: a crossing at mu = (iso - v1) / (v2 - v1), 0.5
    where |v2 - v1| < 1e-30, clipped to [0, 1]. At most ``max_triangles``,
    as the C++ loop stops: a tetrahedron that needs two triangles where
    one is left emits none."""
    sdf = np.ascontiguousarray(sdf, dtype=np.float64)
    nz, ny, nx = sdf.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3, 3))
    k, j, i = np.meshgrid(np.arange(nz - 1), np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
    ii = i[..., None] + _CORNERS[:, 0]  # (nz-1, ny-1, nx-1, 8)
    jj = j[..., None] + _CORNERS[:, 1]
    kk = k[..., None] + _CORNERS[:, 2]
    value = sdf[kk, jj, ii]
    point = np.stack([origin[0] + ii * dx, origin[1] + jj * dx, origin[2] + kk * dx], axis=-1)
    tv, tp = value[..., _TETS], point[..., _TETS, :]  # (..., 6, 4), (..., 6, 4, 3)
    pattern = ((tv < iso) << np.arange(4)).sum(-1)  # (..., 6)
    edges = _TET_EDGES[pattern]  # (..., 6, 2, 3, 2)
    count = _TET_COUNT[pattern]  # (..., 6)
    lead = tv.shape[:-1]
    a, b = edges[..., 0].reshape(lead + (6,)), edges[..., 1].reshape(lead + (6,))
    v1, v2 = np.take_along_axis(tv, a, -1), np.take_along_axis(tv, b, -1)
    p1 = np.take_along_axis(tp, a[..., None], -2)
    p2 = np.take_along_axis(tp, b[..., None], -2)
    denom = v2 - v1
    with np.errstate(divide="ignore", invalid="ignore"):
        mu = np.where(np.abs(denom) < 1e-30, 0.5, (iso - v1) / denom)
    mu = np.clip(mu, 0.0, 1.0)
    out = (p1 + mu[..., None] * (p2 - p1)).reshape(lead + (2, 3, 3))
    flat_count = count.reshape(-1)
    if flat_count.sum() > max_triangles:
        # the C++ loop's stop: walk the tetrahedra in order
        kept, room = np.zeros_like(flat_count), max_triangles
        for t, c in enumerate(flat_count):
            if c and c <= room:
                kept[t], room = c, room - c
            if room == 0:
                break
        flat_count = kept
    mask = np.arange(2) < flat_count[:, None]  # (cubes * 6, 2)
    return out.reshape(-1, 2, 3, 3)[mask]
