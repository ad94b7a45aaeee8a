"""Collision geometry descriptors (counterpart of
tds_tpu/model/geometry.py): the plane and the sphere, which the laikago
slice collides, the capsule, which the ant and the hopper collide with the
plane, and the box, which the cartpole URDF declares and nothing collides
yet. Descriptors are hashable plain Python; the other shapes of the JAX
package are not ported yet.
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
class GeomAttachment:
    """A collision shape attached to a link (or the base, link_index=-1)."""

    link_index: int
    shape: object
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # offset in the link frame
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    friction: float = 0.5
    restitution: float = 0.0
