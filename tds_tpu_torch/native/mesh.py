"""The mass properties of a closed triangle mesh (counterpart of
``mesh_mass_properties`` in tds_tpu/native/mesh.py, whose C++ source
``tds_tpu/native/src/mesh_native.cpp`` this computes the same sums as),
in numpy: no native library. OBJ files are read by ``utils.obj``.

Each triangle (a, b, c), wound counter-clockwise seen from outside, and the
origin span a tetrahedron of signed volume det[a, b, c] / 6; the sums of
their volumes, first moments and second moments are the solid's mass,
centre of mass and inertia about the origin, shifted to the centre of mass
by the parallel-axis theorem.
"""

import numpy as np


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
