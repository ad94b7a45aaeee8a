"""Collision geometry descriptors and their local inertias (counterpart of
tds_tpu/model/geometry.py): the sphere, the plane, the capsule, the box,
the cylinder (a descriptor that collides with nothing, as in the JAX
package), the triangle mesh and the heightfield. Descriptors are hashable
plain Python; ``collision.narrowphase`` turns a pair of them into fixed-size
contact computations.
"""

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float

    def local_inertia(self, mass: float):
        e = 0.4 * mass * self.radius**2
        return (e, e, e)


@dataclasses.dataclass(frozen=True)
class Plane:
    """Infinite plane n.x = constant."""

    normal: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    constant: float = 0.0

    def local_inertia(self, mass: float):
        return (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Capsule:
    """Capsule along local Z with cylindrical section ``length``."""

    radius: float
    length: float

    def local_inertia(self, mass: float):
        """A cylinder and two hemispherical caps, the mass split by volume."""
        r, l = self.radius, self.length
        vol_cyl = math.pi * r * r * l
        vol_sph = (4.0 / 3.0) * math.pi * r**3
        total = vol_cyl + vol_sph
        m_cyl = mass * vol_cyl / total
        m_sph = mass * vol_sph / total
        i_sph = 0.4 * m_sph * r * r
        d = 0.5 * l
        ixx = m_cyl * (l * l / 12.0 + r * r / 4.0) + i_sph + m_sph * d * d
        izz = m_cyl * r * r / 2.0 + i_sph
        return (ixx, ixx, izz)


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box with full extents."""

    extents: Tuple[float, float, float]

    def local_inertia(self, mass: float):
        x, y, z = self.extents
        k = mass / 12.0
        return (k * (y * y + z * z), k * (x * x + z * z), k * (x * x + y * y))


@dataclasses.dataclass(frozen=True)
class Cylinder:
    """Cylinder along local Z."""

    radius: float
    length: float

    def local_inertia(self, mass: float):
        r, l = self.radius, self.length
        ixx = mass * (3 * r * r + l * l) / 12.0
        return (ixx, ixx, 0.5 * mass * r * r)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh read from the OBJ file ``file_name``, its vertices
    scaled by ``scale``. ``max_contacts = 0`` (the default) leaves it
    visual-only: every pair with it is unsupported. ``max_contacts = K``
    makes its K nearest triangles (against a sphere) or K deepest vertices
    (against a plane or another mesh) the pair's candidates.
    ``edge_contacts`` = K_e, read by the mesh-mesh pair only and only when
    both meshes set it, adds the K_e deepest closest points between the two
    meshes' edges in each direction (O(E_a E_b), for small meshes)."""

    file_name: str = ""
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    max_contacts: int = 0
    edge_contacts: int = 0

    def local_inertia(self, mass: float):
        """The principal diagonal of the solid mesh's inertia about its
        centre of mass, scaled to ``mass`` (signed-tetrahedron sums,
        ``native.mesh.mesh_mass_properties``); zeros when the file is
        missing or unreadable, so that a visual-only mesh stays harmless."""
        from tds_tpu_torch.native.mesh import mesh_mass_properties
        from tds_tpu_torch.utils.obj import mesh_data

        try:
            m0, _, inertia = mesh_mass_properties(*mesh_data(self.file_name, self.scale), density=1.0)
        except (OSError, ValueError):
            return (0.0, 0.0, 0.0)
        if m0 <= 0.0:
            return (0.0, 0.0, 0.0)
        s = mass / m0
        return (float(inertia[0, 0] * s), float(inertia[1, 1] * s), float(inertia[2, 2] * s))


@dataclasses.dataclass(frozen=True)
class Heightfield:
    """Axis-aligned triangulated height grid: the same surface as the Mesh
    that ``utils.terrain.heightfield_obj`` writes for the same grid, each
    cell the same two triangles, queried in O(1) (the 3x3 cells around a
    point). ``heights`` is row-major in x, ``nx * ny`` long."""

    nx: int
    ny: int
    x_range: Tuple[float, float]
    y_range: Tuple[float, float]
    heights: Tuple[float, ...]
    max_contacts: int = 1

    def __post_init__(self):
        if self.nx < 2 or self.ny < 2:
            raise ValueError("need at least a 2x2 vertex grid")
        if len(self.heights) != self.nx * self.ny:
            raise ValueError(f"heights has {len(self.heights)} entries, expected nx*ny = {self.nx * self.ny}")

    def local_inertia(self, mass: float):
        return (0.0, 0.0, 0.0)  # terrain is static


@dataclasses.dataclass(frozen=True)
class GeomAttachment:
    """A collision shape attached to a link (or the base, link_index=-1)."""

    link_index: int
    shape: object
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # offset in the link frame
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    friction: float = 0.5
    restitution: float = 0.0
