"""MeshCat visualizer: three.js JSON commands over ZeroMQ (counterpart of
tds_tpu/visualizer/meshcat.py).

Commands are msgpack-encoded JSON sent as 3-part ZMQ messages [type, path,
payload] to a meshcat-server (``meshcat-server --zmq-url
tcp://127.0.0.1:6000``); ``msgpack`` and ``zmq`` are imported only when a
command is packed or a socket opened.

``MeshcatVisualizer(connection=...)`` accepts any object with a
``send(type, path, payload_bytes)`` method, so tests can record commands
without a server (:class:`RecordingConnection`). Link transforms come from
the port's kinematics on tensors on any device, copied to the host once
per sync.
"""

import math
import uuid
from typing import List, Optional, Sequence

import numpy as np


class RecordingConnection:
    """Collects commands instead of sending them (for tests/offline dumps)."""

    def __init__(self):
        self.commands = []

    def send(self, cmd_type: str, path: str, payload: bytes):
        self.commands.append((cmd_type, path, payload))


class ZmqConnection:
    """REQ socket to a meshcat-server (meshcat_zmq.h:270-292)."""

    def __init__(self, zmq_url: str = "tcp://127.0.0.1:6000", timeout_ms: int = 2000):
        import zmq

        self.url = zmq_url
        self.timeout_ms = timeout_ms
        self.ctx = zmq.Context.instance()
        self.sock = None
        self._connect()

    def _connect(self):
        import zmq

        if self.sock is not None:
            self.sock.close(linger=0)
        self.sock = self.ctx.socket(zmq.REQ)
        self.sock.setsockopt(zmq.RCVTIMEO, self.timeout_ms)
        self.sock.setsockopt(zmq.SNDTIMEO, self.timeout_ms)
        self.sock.connect(self.url)

    def send(self, cmd_type: str, path: str, payload: bytes):
        self.sock.send_multipart(
            [cmd_type.encode(), path.encode(), payload]
        )
        try:
            self.sock.recv()
        except Exception:
            # A REQ socket that missed its reply refuses further sends
            # (EFSM); reset it so a dead/slow server degrades to lossy
            # streaming instead of crashing the caller.
            self._connect()


def _pack(cmd: dict) -> bytes:
    import msgpack

    return msgpack.packb(cmd, use_single_float=False)


def _material(color_rgb: int, opacity: float = 1.0) -> dict:
    return {
        "color": color_rgb,
        "reflectivity": 0.5,
        "side": 2,
        "transparent": opacity < 1.0,
        "opacity": opacity,
        "type": "MeshPhongMaterial",
        "uuid": str(uuid.uuid4()),
    }


def _object_cmd(path: str, geometry: dict, material: dict, pos=(0, 0, 0)) -> dict:
    object_uid = str(uuid.uuid4())
    return {
        "type": "set_object",
        "path": path,
        "object": {
            "metadata": {"type": "Object", "version": 4.5},
            "geometries": [geometry],
            "materials": [material],
            "object": {
                "geometry": geometry["uuid"],
                "material": material["uuid"],
                "matrix": [
                    1.0, 0, 0, 0,
                    0, 1.0, 0, 0,
                    0, 0, 1.0, 0,
                    float(pos[0]), float(pos[1]), float(pos[2]), 1.0,
                ],
                "type": "Mesh",
                "uuid": object_uid,
            },
        },
    }


class MeshcatVisualizer:
    def __init__(self, connection=None, zmq_url: str = "tcp://127.0.0.1:6000"):
        self.conn = connection if connection is not None else ZmqConnection(zmq_url)

    def _send(self, cmd: dict):
        self.conn.send(cmd["type"], cmd.get("path", ""), _pack(cmd))

    # ---- objects ----------------------------------------------------------
    def set_sphere(self, path: str, radius: float, color=0x22AA99, opacity=1.0):
        geom = {"radius": radius, "type": "SphereGeometry", "uuid": str(uuid.uuid4())}
        self._send(_object_cmd(path, geom, _material(color, opacity)))

    def set_box(self, path: str, extents, color=0x3366CC, opacity=1.0):
        geom = {
            "type": "BoxGeometry",
            "width": float(extents[0]),
            "height": float(extents[1]),
            "depth": float(extents[2]),
            "uuid": str(uuid.uuid4()),
        }
        self._send(_object_cmd(path, geom, _material(color, opacity)))

    def set_cylinder(self, path: str, radius, length, color=0x999933, opacity=1.0):
        geom = {
            "type": "CylinderGeometry",
            "radiusTop": float(radius),
            "radiusBottom": float(radius),
            "height": float(length),
            "radialSegments": 32,
            "uuid": str(uuid.uuid4()),
        }
        self._send(_object_cmd(path, geom, _material(color, opacity)))

    def set_capsule(self, path: str, radius, length, color=0x999933, opacity=1.0):
        # meshcat has no capsule primitive; cylinder approximation like the
        # reference's create_cylinder usage
        self.set_cylinder(path, radius, length + 2 * radius, color, opacity)

    def set_ground_plane(self, path: str = "/tds/ground", size=10.0, color=0xDDDDDD):
        self.set_box(path, (size, size, 0.01), color=color, opacity=0.6)

    def set_mesh_obj(self, path: str, obj_text: str, color=0xCCAA66, opacity=1.0):
        """Wavefront OBJ payload (meshcat _meshfile_geometry)."""
        geom = {
            "type": "_meshfile_geometry",
            "format": "obj",
            "data": obj_text,
            "uuid": str(uuid.uuid4()),
        }
        self._send(_object_cmd(path, geom, _material(color, opacity)))

    # ---- transforms -------------------------------------------------------
    def set_transform(self, path: str, position, rotation=None):
        """Column-major 4x4 (meshcat_zmq.h:255-268)."""
        r = np.eye(3) if rotation is None else np.asarray(rotation, dtype=float)
        p = np.asarray(position, dtype=float)
        matrix = [
            float(r[0, 0]), float(r[1, 0]), float(r[2, 0]), 0.0,
            float(r[0, 1]), float(r[1, 1]), float(r[2, 1]), 0.0,
            float(r[0, 2]), float(r[1, 2]), float(r[2, 2]), 0.0,
            float(p[0]), float(p[1]), float(p[2]), 1.0,
        ]
        self._send({"type": "set_transform", "path": path, "matrix": matrix})

    def delete(self, path: str):
        self._send({"type": "delete", "path": path})


class MeshcatUrdfVisualizer:
    """Builds meshcat objects from a parsed URDF and syncs link transforms
    (meshcat_urdf_visualizer.h:112-360)."""

    def __init__(self, visualizer: Optional[MeshcatVisualizer] = None, prefix="/tds"):
        self.viz = visualizer or MeshcatVisualizer()
        self.prefix = prefix
        self.paths = []  # (path, link_index, offset_pos, offset_rot)

    def convert_visuals(self, urdf, model):
        from tds_tpu_torch.model.multibody import np_rpy as _np_rpy

        def add(link, link_index, name):
            for vi, visual in enumerate(link.visuals):
                path = f"{self.prefix}/{name}_{vi}"
                g = visual.geometry
                color = int(
                    int(visual.rgba[0] * 255) << 16
                    | int(visual.rgba[1] * 255) << 8
                    | int(visual.rgba[2] * 255)
                )
                if g.geom_type == "sphere":
                    self.viz.set_sphere(path, g.radius, color)
                elif g.geom_type == "box":
                    self.viz.set_box(path, g.extents, color)
                elif g.geom_type in ("cylinder", "capsule"):
                    self.viz.set_cylinder(path, g.radius, g.length, color)
                else:
                    continue
                self.paths.append(
                    (
                        path,
                        link_index,
                        np.asarray(visual.origin_xyz, dtype=float),
                        _np_rpy(*visual.origin_rpy),
                    )
                )

        add(urdf.base_links[0], -1, urdf.base_links[0].link_name or "base")
        for i, link in enumerate(urdf.links):
            add(link, i, link.link_name or f"link{i}")

    def sync_visual_transforms(self, model, q):
        """Push the world transform of every visual for the state ``q``
        (dof_q,), a tensor on any device."""
        from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q
        from tds_tpu_torch.visualizer.renderer import _host_poses

        base_x, lxw, _ = forward_kinematics_q(model, q)
        pos, rot = _host_poses(base_x, lxw)
        for path, link_index, off_p, off_r in self.paths:
            frame_rot, frame_pos = rot[link_index + 1], pos[link_index + 1]
            self.viz.set_transform(path, frame_pos + frame_rot @ off_p, frame_rot @ off_r)
