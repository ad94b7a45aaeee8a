"""UrdfStructures -> MultiBodyModel + collision attachments (counterpart of
tds_tpu/urdf/converter.py), keeping the JAX package's deliberate reference
quirks:

- only the DIAGONAL inertia entries are read, and the inertial frame's
  rotation maps I -> R^T I R and com -> R^T com (note the transpose), by
  default; ``inertia_convention="urdf"`` reads the specification's way
  instead: the full tensor, R I R^T, the COM left in the link frame;
- revolute/prismatic axes snap to X/Y/Z only when they are exact unit
  vectors, and other axes are used verbatim (not normalized);
- URDF joint damping is dropped unless ``use_joint_damping``;
- collision meshes are visual-only (skipped) unless ``mesh_contacts`` = K
  > 0 opts them into the mesh narrowphase with K candidates each;
- each geom carries its link's ``<contact>`` lateral friction and
  restitution, which ``world.gather_pair_contacts`` reads.
"""

from typing import List, Tuple

import numpy as np
import torch

from tds_tpu_torch.model.geometry import Box, Capsule, Cylinder, GeomAttachment, Mesh, Plane, Sphere
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel, np_rpy
from tds_tpu_torch.urdf.structures import UrdfStructures

_UNIT_AXES = {(1.0, 0.0, 0.0): 0, (0.0, 1.0, 0.0): 1, (0.0, 0.0, 1.0): 2}


def _inertia_com_and_matrix(inertial, convention: str = "reference"):
    """(com, inertia about the com) in the link frame: "reference" reads the
    diagonal and applies R^T to both, as the C++ converter does; "urdf" the
    full tensor rotated R I R^T, the COM as given."""
    rot = np_rpy(*inertial.origin_rpy)
    com = np.asarray(inertial.origin_xyz, dtype=float)
    if convention == "reference":
        return rot.T @ com, rot.T @ np.diag(inertial.inertia_xxyyzz) @ rot
    if convention != "urdf":
        raise ValueError(f"unknown inertia convention {convention!r}")
    if inertial.inertia_full is not None:
        ixx, ixy, ixz, iyy, iyz, izz = inertial.inertia_full
        i = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    else:
        i = np.diag(inertial.inertia_xxyyzz)
    return com, rot @ i @ rot.T


def _joint_type(urdf_type: str, axis) -> Tuple[JointType, Tuple[float, float, float]]:
    axis = tuple(float(a) for a in axis)
    if urdf_type == "fixed":
        return JointType.FIXED, (1.0, 0.0, 0.0)
    if urdf_type == "spherical":
        return JointType.SPHERICAL, (1.0, 0.0, 0.0)
    if urdf_type in ("revolute", "continuous"):
        first, general = JointType.REVOLUTE_X, JointType.REVOLUTE_AXIS
    elif urdf_type == "prismatic":
        first, general = JointType.PRISMATIC_X, JointType.PRISMATIC_AXIS
    else:
        raise ValueError(f"cannot convert joint type {urdf_type!r}")
    if axis in _UNIT_AXES:
        return JointType(int(first) + _UNIT_AXES[axis]), axis
    return general, axis


def _shape(geom, mesh_contacts: int = 0):
    t = geom.geom_type
    if t == "sphere":
        return Sphere(geom.radius)
    if t == "box":
        return Box(tuple(geom.extents))
    if t == "capsule":
        return Capsule(geom.radius, geom.length)
    if t == "cylinder":
        return Cylinder(geom.radius, geom.length)
    if t == "plane":
        return Plane(tuple(geom.normal), geom.constant)
    if t == "mesh":
        return Mesh(geom.mesh_file, tuple(geom.mesh_scale), max_contacts=mesh_contacts)
    raise ValueError(f"unknown geometry {t!r}")


def _attachments(link_index, link, mesh_contacts) -> List[GeomAttachment]:
    out = []
    for col in link.collisions:
        if col.geometry.geom_type == "mesh" and mesh_contacts <= 0:
            continue  # visual-only, as in the reference
        out.append(
            GeomAttachment(
                link_index=link_index,
                shape=_shape(col.geometry, mesh_contacts),
                pos=tuple(col.origin_xyz),
                rpy=tuple(col.origin_rpy),
                friction=link.contact.lateral_friction,
                restitution=link.contact.restitution,
            )
        )
    return out


def convert_to_multibody(
    urdf: UrdfStructures,
    is_floating: bool = False,
    dtype=torch.float64,
    use_joint_damping: bool = False,
    inertia_convention: str = "reference",
    mesh_contacts: int = 0,
) -> Tuple[MultiBodyModel, Tuple[GeomAttachment, ...]]:
    """Returns (model on the CPU, collision attachments); base shapes use
    link_index=-1. The root link's inertia is the base's: a floating base
    moves with it, a fixed one holds it still."""
    b = MultiBodyBuilder(is_floating=is_floating, name=urdf.robot_name)
    base = urdf.base_links[0]
    b.set_base_inertia(base.inertial.mass, *_inertia_com_and_matrix(base.inertial, inertia_convention))
    geoms = _attachments(-1, base, mesh_contacts)
    for i, joint in enumerate(urdf.joints):
        link = urdf.links[i]
        jt, axis = _joint_type(joint.joint_type, joint.axis_xyz)
        com, inertia = _inertia_com_and_matrix(link.inertial, inertia_convention)
        b.add_link(
            jt,
            parent=link.parent_index,
            x_t_pos=joint.origin_xyz,
            x_t_rpy=joint.origin_rpy,
            axis=axis,
            mass=link.inertial.mass,
            com=com,
            inertia_about_com=inertia,
            damping=joint.damping if use_joint_damping else 0.0,
            link_name=link.link_name,
            joint_name=joint.joint_name,
        )
        geoms += _attachments(i, link, mesh_contacts)
    return b.finalize(dtype=dtype), tuple(geoms)


def load_urdf(path: str, is_floating: bool = False, dtype=torch.float64):
    """Parse and convert in one call: (model on the CPU, collision
    attachments), uncached (``urdf.cache.construct`` caches)."""
    from tds_tpu_torch.urdf.parser import parse_urdf_file

    return convert_to_multibody(parse_urdf_file(path), is_floating, dtype)
