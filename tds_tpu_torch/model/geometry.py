"""Collision geometry descriptors (counterpart of
tds_tpu/model/geometry.py): the plane and the sphere, which the laikago
slice collides, the capsule, which the ant and the hopper collide with the
plane, the box, which the cartpole URDF declares and nothing collides yet,
and the terrains: the triangle mesh and the heightfield. Descriptors are
hashable plain Python; the cylinder of the JAX package is not ported yet.
"""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float


@dataclasses.dataclass(frozen=True)
class Capsule:
    """Capsule along local Z with cylindrical section ``length``."""

    radius: float
    length: float


@dataclasses.dataclass(frozen=True)
class Plane:
    """Infinite plane n.x = constant."""

    normal: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    constant: float = 0.0


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box with full extents."""

    extents: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh read from the OBJ file ``file_name``, its vertices
    scaled by ``scale``. ``max_contacts = 0`` (the default) leaves it
    visual-only: every pair with it is unsupported. ``max_contacts = K``
    makes its K nearest triangles (against a sphere) or K deepest vertices
    (against a plane) the pair's candidates. ``edge_contacts`` is read by
    the mesh-mesh pair only, which is not ported yet."""

    file_name: str = ""
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    max_contacts: int = 0
    edge_contacts: int = 0

    def local_inertia(self, mass: float):
        """The solid mesh's inertia needs the native mass properties of the
        JAX package, not ported yet (ROADMAP Queue 1 item 9). A terrain
        hangs on the zero-DoF ground and never asks for one."""
        raise NotImplementedError("the solid mesh's inertia is not ported to tds_tpu_torch yet (ROADMAP Queue 1 item 9)")


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
