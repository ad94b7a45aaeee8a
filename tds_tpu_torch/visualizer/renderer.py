"""Headless software renderer (counterpart of tds_tpu/visualizer/renderer.py).

Rasterises the collision or visual geometry of a scene into an RGB image
with a z-buffer and Lambertian shading, in numpy: procedural meshes for the
analytic shapes, OBJ meshes through ``utils.obj``. The scene's poses come
from the port's kinematics on tensors on any device, copied to the host
once per frame.

Usage:
    img = render_scene(camera, instances)      # (H, W, 3) uint8
    save_png(img, "frame.png")
"""

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

import torch

from tds_tpu_torch.model.geometry import Box, Capsule, Cylinder, Plane, Sphere
from tds_tpu_torch.model.multibody import np_rpy


class Camera(NamedTuple):
    eye: np.ndarray
    target: np.ndarray
    up: np.ndarray = None
    fov_deg: float = 50.0
    width: int = 640
    height: int = 480
    near: float = 0.05

    @staticmethod
    def look_at(eye, target, up=(0.0, 0.0, 1.0), **kw):
        return Camera(
            eye=np.asarray(eye, float), target=np.asarray(target, float),
            up=np.asarray(up, float), **kw,
        )


# ---------------- procedural meshes ---------------------------------------
def sphere_mesh(radius, n=12):
    verts = []
    for i in range(n + 1):
        theta = math.pi * i / n
        for j in range(2 * n):
            phi = math.pi * j / n
            verts.append(
                [
                    radius * math.sin(theta) * math.cos(phi),
                    radius * math.sin(theta) * math.sin(phi),
                    radius * math.cos(theta),
                ]
            )
    verts = np.asarray(verts)
    tris = []
    cols = 2 * n
    for i in range(n):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            tris += [[a, b, c], [b, d, c]]
    return verts, np.asarray(tris, np.int32)


def box_mesh(extents):
    ex, ey, ez = [0.5 * e for e in extents]
    v = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ]
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
            [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
            [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7],
        ],
        np.int32,
    )
    return v, f


def capsule_mesh(radius, length, n=10):
    v, f = sphere_mesh(radius, n)
    v = v.copy()
    v[:, 2] += np.where(v[:, 2] > 0, 0.5 * length, -0.5 * length)
    return v, f


def plane_mesh(size=8.0):
    v = np.array(
        [[-size, -size, 0], [size, -size, 0], [size, size, 0], [-size, size, 0]],
        float,
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def shape_mesh(shape):
    if isinstance(shape, Sphere):
        return sphere_mesh(shape.radius)
    if isinstance(shape, Box):
        return box_mesh(shape.extents)
    if isinstance(shape, (Capsule, Cylinder)):
        return capsule_mesh(shape.radius, shape.length)
    if isinstance(shape, Plane):
        return plane_mesh()
    return None


class Instance(NamedTuple):
    vertices: np.ndarray  # (n, 3) local
    triangles: np.ndarray  # (m, 3) int
    position: np.ndarray  # (3,)
    rotation: np.ndarray  # (3, 3)
    color: Tuple[float, float, float] = (0.6, 0.7, 0.9)


def render_scene(camera: Camera, instances: Sequence[Instance], bg=(18, 18, 24)):
    """Returns (H, W, 3) uint8."""
    w, h = camera.width, camera.height
    color = np.zeros((h, w, 3), np.float32)
    color[:] = np.asarray(bg, np.float32) / 255.0
    zbuf = np.full((h, w), np.inf, np.float32)

    # camera basis
    fwd = camera.target - camera.eye
    fwd = fwd / np.linalg.norm(fwd)
    up0 = camera.up if camera.up is not None else np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    focal = 0.5 * h / math.tan(0.5 * math.radians(camera.fov_deg))
    light = np.array([0.4, 0.3, 0.85])
    light /= np.linalg.norm(light)

    for inst in instances:
        verts_w = inst.vertices @ inst.rotation.T + inst.position
        rel = verts_w - camera.eye
        cam = np.stack(
            [rel @ right, rel @ up, rel @ fwd], axis=-1
        )  # x right, y up, z depth
        tri = inst.triangles
        v0, v1, v2 = cam[tri[:, 0]], cam[tri[:, 1]], cam[tri[:, 2]]
        # world normals for shading + backface culling in camera space
        n_w = np.cross(
            verts_w[tri[:, 1]] - verts_w[tri[:, 0]],
            verts_w[tri[:, 2]] - verts_w[tri[:, 0]],
        )
        n_norm = np.linalg.norm(n_w, axis=-1, keepdims=True)
        n_w = n_w / np.maximum(n_norm, 1e-12)
        shade = 0.25 + 0.75 * np.abs(n_w @ light)

        # project
        def proj(v):
            z = np.maximum(v[:, 2], camera.near)
            return np.stack(
                [w / 2 + focal * v[:, 0] / z, h / 2 - focal * v[:, 1] / z, z],
                axis=-1,
            )

        p0, p1, p2 = proj(v0), proj(v1), proj(v2)
        visible = (v0[:, 2] > camera.near) | (v1[:, 2] > camera.near) | (
            v2[:, 2] > camera.near
        )
        for t in np.nonzero(visible)[0]:
            a, b, c = p0[t], p1[t], p2[t]
            xmin = max(int(min(a[0], b[0], c[0])), 0)
            xmax = min(int(max(a[0], b[0], c[0])) + 1, w)
            ymin = max(int(min(a[1], b[1], c[1])), 0)
            ymax = min(int(max(a[1], b[1], c[1])) + 1, h)
            if xmin >= xmax or ymin >= ymax:
                continue
            xs, ys = np.meshgrid(
                np.arange(xmin, xmax) + 0.5, np.arange(ymin, ymax) + 0.5
            )
            d = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
            if abs(d) < 1e-9:
                continue
            w1 = ((xs - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (ys - a[1])) / d
            w2 = ((b[0] - a[0]) * (ys - a[1]) - (xs - a[0]) * (b[1] - a[1])) / d
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            z = w0 * a[2] + w1 * b[2] + w2 * c[2]
            sub_z = zbuf[ymin:ymax, xmin:xmax]
            closer = inside & (z < sub_z) & (z > camera.near)
            sub_z[closer] = z[closer]
            col = np.asarray(inst.color, np.float32) * shade[t]
            sub_c = color[ymin:ymax, xmin:xmax]
            sub_c[closer] = col
    return (np.clip(color, 0, 1) * 255).astype(np.uint8)


def _host_poses(base_x, links_x):
    """(positions (1 + L, 3), rotations (1 + L, 3, 3)) float64 numpy of one
    state's base and link transforms: one copy from the device."""
    frames = (base_x,) + tuple(links_x)
    shape = frames[-1].pos.shape
    pos = torch.stack([torch.broadcast_to(x.pos, shape) for x in frames])
    rot = torch.stack([torch.broadcast_to(x.rot, shape + (3,)) for x in frames])
    packed = torch.cat([pos.reshape(len(frames), -1), rot.reshape(len(frames), -1)], dim=1).cpu().double().numpy()
    return packed[:, :3].reshape(len(frames), 3), packed[:, 3:].reshape(len(frames), 3, 3)


def _posed(pos, rot, off_pos, off_rpy):
    """A shape's world (position, rotation) from its frame's and its offset."""
    return pos + rot @ np.asarray(off_pos, float), rot @ np_rpy(*off_rpy)


def scene_instances_from_world(world, qs, colors=None) -> List[Instance]:
    """Renderable instances of a World's collision shapes in the state
    ``qs`` (one (dof_q,) tensor a body)."""
    from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q

    out = []
    palette = colors or [(0.85, 0.45, 0.3), (0.3, 0.6, 0.85), (0.45, 0.8, 0.4), (0.8, 0.75, 0.3)]
    for bi in range(world.num_bodies):
        model = world.bodies[bi]
        base_x, links_x, _ = forward_kinematics_q(model, qs[bi])
        pos, rot = _host_poses(base_x, links_x)
        for g in world.geoms[bi]:
            mesh = shape_mesh(g.shape)
            if mesh is None:
                continue
            p, r = _posed(pos[g.link_index + 1], rot[g.link_index + 1], g.pos, g.rpy)
            color = (0.5, 0.5, 0.55) if isinstance(g.shape, Plane) else palette[bi % len(palette)]
            out.append(Instance(mesh[0], mesh[1], p, r, color))
    return out


def scene_instances_from_urdf(urdf, model, q, urdf_dir: str = "", colors=None) -> List[Instance]:
    """Renderable instances of a URDF's visuals (OBJ meshes read from
    ``urdf_dir``, primitives procedurally) posed by forward kinematics of
    the state ``q`` (dof_q,), a tensor on any device."""
    import os

    from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q
    from tds_tpu_torch.utils.obj import load_obj

    base_x, links_x, _ = forward_kinematics_q(model, q)
    pos, rot = _host_poses(base_x, links_x)
    out: List[Instance] = []
    palette = colors or [(0.8, 0.55, 0.35), (0.35, 0.6, 0.85)]

    def mesh_for(g):
        if g.geom_type == "sphere":
            return sphere_mesh(g.radius)
        if g.geom_type == "box":
            return box_mesh(g.extents)
        if g.geom_type in ("capsule", "cylinder"):
            return capsule_mesh(g.radius, g.length)
        if g.geom_type == "mesh" and g.mesh_file:
            path = os.path.join(urdf_dir, g.mesh_file)
            if os.path.exists(path):
                with open(path) as f:
                    v, tris = load_obj(f.read())
                return v * np.asarray(g.mesh_scale), tris
        return None

    links = [urdf.base_links[0]] + list(urdf.links)
    for idx, link in enumerate(links):
        for visual in link.visuals:
            m = mesh_for(visual.geometry)
            if m is None:
                continue
            p, r = _posed(pos[idx], rot[idx], visual.origin_xyz, visual.origin_rpy)
            color = tuple(visual.rgba[:3]) if visual.rgba != (1.0, 1.0, 1.0, 1.0) else palette[idx % len(palette)]
            out.append(Instance(m[0], m[1], p, r, color))
    return out


def save_png(img: np.ndarray, path: str):
    """Minimal PNG writer (no external deps)."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[row].tobytes() for row in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw, 6))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)
