"""Parsed URDF document model (pure Python; a copy of tds_tpu/urdf/structures.py)."""

import dataclasses
from typing import Dict, List, Optional, Tuple

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass
class UrdfInertial:
    mass: float = 0.0
    inertia_xxyyzz: Vec3 = (0.0, 0.0, 0.0)
    # full inertia tensor entries if off-diagonals present
    inertia_full: Optional[Tuple[float, ...]] = None  # (ixx,ixy,ixz,iyy,iyz,izz)
    origin_xyz: Vec3 = (0.0, 0.0, 0.0)
    origin_rpy: Vec3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class UrdfContact:
    """<contact> material parameters (reference urdf_structures.hpp:46-59)."""

    lateral_friction: float = 0.5
    restitution: float = 0.0
    stiffness: float = 1.0
    damping: float = 0.0


@dataclasses.dataclass
class UrdfGeometry:
    geom_type: str = ""  # sphere|box|capsule|cylinder|plane|mesh
    radius: float = 1.0
    length: float = 1.0
    extents: Vec3 = (1.0, 1.0, 1.0)
    normal: Vec3 = (0.0, 0.0, 1.0)
    constant: float = 0.0
    mesh_file: str = ""
    mesh_scale: Vec3 = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class UrdfVisual:
    origin_xyz: Vec3 = (0.0, 0.0, 0.0)
    origin_rpy: Vec3 = (0.0, 0.0, 0.0)
    geometry: UrdfGeometry = dataclasses.field(default_factory=UrdfGeometry)
    material_name: str = ""
    rgba: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass
class UrdfCollision:
    origin_xyz: Vec3 = (0.0, 0.0, 0.0)
    origin_rpy: Vec3 = (0.0, 0.0, 0.0)
    geometry: UrdfGeometry = dataclasses.field(default_factory=UrdfGeometry)


@dataclasses.dataclass
class UrdfLink:
    link_name: str = ""
    parent_index: int = -2
    inertial: UrdfInertial = dataclasses.field(default_factory=UrdfInertial)
    contact: UrdfContact = dataclasses.field(default_factory=UrdfContact)
    visuals: List[UrdfVisual] = dataclasses.field(default_factory=list)
    collisions: List[UrdfCollision] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UrdfJoint:
    joint_name: str = ""
    joint_type: str = "fixed"  # fixed|revolute|continuous|prismatic|spherical
    parent_name: str = ""
    child_name: str = ""
    origin_xyz: Vec3 = (0.0, 0.0, 0.0)
    origin_rpy: Vec3 = (0.0, 0.0, 0.0)
    axis_xyz: Vec3 = (1.0, 0.0, 0.0)
    damping: float = 0.0
    friction: float = 0.0
    limit_lower: float = 0.0
    limit_upper: float = 0.0
    effort_limit: float = 0.0
    velocity_limit: float = 0.0


@dataclasses.dataclass
class UrdfStructures:
    """Topologically ordered document: base_links[0] is the root;
    links[i] is the child link of joints[i] (reference urdf_parser.hpp:836-905).
    """

    robot_name: str = ""
    base_links: List[UrdfLink] = dataclasses.field(default_factory=list)
    links: List[UrdfLink] = dataclasses.field(default_factory=list)
    joints: List[UrdfJoint] = dataclasses.field(default_factory=list)
    name_to_link_index: Dict[str, int] = dataclasses.field(default_factory=dict)
    materials: Dict[str, Tuple[float, float, float, float]] = dataclasses.field(
        default_factory=dict
    )
