"""URDF parser (xml.etree; a copy of tds_tpu/urdf/parser.py), behaviorally
matching the reference parser
(src/urdf/urdf_parser.hpp:64-928):

- joint types: revolute/continuous -> revolute-axis, prismatic ->
  prismatic-axis, spherical, fixed; planar/floating rejected
- default joint axis (1,0,0) when <axis> missing
- the base link is the unique link that is no joint's child
- links/joints are re-ordered topologically by DFS from the base, visiting
  joints in document order (urdf_parser.hpp:836-905); links[i] is the child
  of joints[i], parent_index resolves through name_to_link_index
"""

import xml.etree.ElementTree as ET
from typing import Dict, List

from tds_tpu_torch.urdf.structures import (
    UrdfCollision,
    UrdfContact,
    UrdfGeometry,
    UrdfInertial,
    UrdfJoint,
    UrdfLink,
    UrdfStructures,
    UrdfVisual,
)


class UrdfError(ValueError):
    pass


def _vec3(s, default=(0.0, 0.0, 0.0)):
    if s is None:
        return tuple(default)
    parts = [float(x) for x in s.replace(",", " ").split()]
    if len(parts) != 3:
        raise UrdfError(f"expected 3 floats, got {s!r}")
    return tuple(parts)


def _origin(el):
    o = el.find("origin")
    if o is None:
        return (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    return _vec3(o.get("xyz")), _vec3(o.get("rpy"))


def _parse_geometry(el) -> UrdfGeometry:
    g = UrdfGeometry()
    geom = el.find("geometry")
    if geom is None:
        raise UrdfError("visual/collision without geometry")
    for child in geom:
        tag = child.tag
        if tag == "sphere":
            g.geom_type = "sphere"
            g.radius = float(child.get("radius", 1.0))
        elif tag == "box":
            g.geom_type = "box"
            g.extents = _vec3(child.get("size"), (1.0, 1.0, 1.0))
        elif tag == "cylinder":
            g.geom_type = "cylinder"
            g.radius = float(child.get("radius", 1.0))
            g.length = float(child.get("length", 1.0))
        elif tag == "capsule":
            g.geom_type = "capsule"
            g.radius = float(child.get("radius", 1.0))
            g.length = float(child.get("length", 1.0))
        elif tag == "plane":
            g.geom_type = "plane"
            g.normal = _vec3(child.get("normal"), (0.0, 0.0, 1.0))
        elif tag == "mesh":
            g.geom_type = "mesh"
            g.mesh_file = child.get("filename", "")
            g.mesh_scale = _vec3(child.get("scale"), (1.0, 1.0, 1.0))
        else:
            raise UrdfError(f"unknown geometry type {tag!r}")
        break
    return g


def _parse_inertial(link_el) -> UrdfInertial:
    inr = UrdfInertial()
    el = link_el.find("inertial")
    if el is None:
        return inr
    xyz, rpy = _origin(el)
    inr.origin_xyz, inr.origin_rpy = xyz, rpy
    mass_el = el.find("mass")
    if mass_el is not None:
        inr.mass = float(mass_el.get("value", 0.0))
    i_el = el.find("inertia")
    if i_el is not None:
        ixx = float(i_el.get("ixx", 0.0))
        iyy = float(i_el.get("iyy", 0.0))
        izz = float(i_el.get("izz", 0.0))
        ixy = float(i_el.get("ixy", 0.0))
        ixz = float(i_el.get("ixz", 0.0))
        iyz = float(i_el.get("iyz", 0.0))
        inr.inertia_xxyyzz = (ixx, iyy, izz)
        if ixy or ixz or iyz:
            inr.inertia_full = (ixx, ixy, ixz, iyy, iyz, izz)
    return inr


def _parse_contact(link_el) -> UrdfContact:
    c = UrdfContact()
    el = link_el.find("contact")
    if el is None:
        return c
    for tag, attr in (
        ("lateral_friction", "lateral_friction"),
        ("restitution", "restitution"),
        ("stiffness", "stiffness"),
        ("damping", "damping"),
    ):
        t = el.find(tag)
        if t is not None and t.get("value") is not None:
            setattr(c, attr, float(t.get("value")))
    return c


def _parse_link(link_el, materials) -> UrdfLink:
    link = UrdfLink(link_name=link_el.get("name", ""))
    link.inertial = _parse_inertial(link_el)
    link.contact = _parse_contact(link_el)
    for v_el in link_el.findall("visual"):
        v = UrdfVisual()
        v.origin_xyz, v.origin_rpy = _origin(v_el)
        v.geometry = _parse_geometry(v_el)
        m = v_el.find("material")
        if m is not None:
            v.material_name = m.get("name", "")
            color = m.find("color")
            if color is not None:
                rgba = [float(x) for x in color.get("rgba", "1 1 1 1").split()]
                v.rgba = tuple(rgba + [1.0] * (4 - len(rgba)))
                materials[v.material_name] = v.rgba
            elif v.material_name in materials:
                v.rgba = materials[v.material_name]
        link.visuals.append(v)
    for c_el in link_el.findall("collision"):
        c = UrdfCollision()
        c.origin_xyz, c.origin_rpy = _origin(c_el)
        c.geometry = _parse_geometry(c_el)
        link.collisions.append(c)
    return link


def _parse_joint(j_el) -> UrdfJoint:
    j = UrdfJoint(joint_name=j_el.get("name", ""))
    jtype = j_el.get("type")
    if jtype is None:
        raise UrdfError(f"joint {j.joint_name!r} has no type")
    if jtype in ("planar", "floating"):
        raise UrdfError(f"{jtype} joints not supported")
    if jtype not in ("revolute", "continuous", "prismatic", "spherical", "fixed"):
        raise UrdfError(f"joint {j.joint_name!r} has unknown type {jtype!r}")
    j.joint_type = jtype
    parent = j_el.find("parent")
    child = j_el.find("child")
    if parent is None or child is None or not child.get("link"):
        raise UrdfError(f"joint {j.joint_name!r} missing parent/child link")
    j.parent_name = parent.get("link")
    j.child_name = child.get("link")
    j.origin_xyz, j.origin_rpy = _origin(j_el)
    if jtype != "fixed":
        axis = j_el.find("axis")
        if axis is not None:
            j.axis_xyz = _vec3(axis.get("xyz"), (1.0, 0.0, 0.0))
    dyn = j_el.find("dynamics")
    if dyn is not None:
        j.damping = float(dyn.get("damping", 0.0))
        j.friction = float(dyn.get("friction", 0.0))
    lim = j_el.find("limit")
    if lim is not None:
        j.limit_lower = float(lim.get("lower", 0.0))
        j.limit_upper = float(lim.get("upper", 0.0))
        j.effort_limit = float(lim.get("effort", 0.0))
        j.velocity_limit = float(lim.get("velocity", 0.0))
    return j


def parse_urdf_string(text: str) -> UrdfStructures:
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise UrdfError("expected <robot> root element")
    s = UrdfStructures(robot_name=root.get("name", ""))

    joints: List[UrdfJoint] = [_parse_joint(j) for j in root.findall("joint")]
    links_by_name: Dict[str, UrdfLink] = {}
    for link_el in root.findall("link"):
        link = _parse_link(link_el, s.materials)
        if not link.link_name:
            raise UrdfError("link with no name")
        links_by_name[link.link_name] = link

    child_names = {j.child_name for j in joints}
    roots = [n for n in links_by_name if n not in child_names]
    if len(roots) != 1:
        raise UrdfError(f"need exactly one base link, found {roots}")
    base_name = roots[0]

    # topological DFS in joint document order (reference assign_links)
    s.name_to_link_index[base_name] = -1
    order: List[UrdfJoint] = []

    def assign(parent_name: str):
        for j in joints:
            if j.parent_name == parent_name:
                if j.child_name in s.name_to_link_index:
                    raise UrdfError(f"link {j.child_name!r} has two parents")
                if j.child_name not in links_by_name:
                    raise UrdfError(f"joint {j.joint_name!r} child link missing")
                s.name_to_link_index[j.child_name] = len(order)
                order.append(j)
                assign(j.child_name)

    assign(base_name)
    if len(order) != len(joints):
        raise UrdfError("inconsistent joint/link connections (disconnected tree)")

    s.base_links.append(links_by_name[base_name])
    s.joints = order
    for j in order:
        link = links_by_name[j.child_name]
        link.parent_index = s.name_to_link_index[j.parent_name]
        s.links.append(link)
    return s


def parse_urdf_file(path: str) -> UrdfStructures:
    with open(path) as f:
        return parse_urdf_string(f.read())
