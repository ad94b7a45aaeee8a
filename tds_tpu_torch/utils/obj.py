"""Wavefront OBJ meshes: the port's copy of the JAX package's pure-Python
reader (``tds_tpu/native/mesh.py`` ``_load_obj_py``) and of the cached mesh
data its narrowphase reads (``tds_tpu/collision/narrowphase.py``
``_mesh_data``). No native library: the JAX package's ctypes build stays
its own."""

import functools

import numpy as np

from tds_tpu_torch.utils.file_utils import find_file


def load_obj(text: str):
    """(vertices (n, 3) float64, triangles (m, 3) int32) of OBJ ``text``:
    ``v`` lines and ``f`` lines, 1-based or negative indices, polygons
    fanned into triangles from their first vertex."""
    verts, tris = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "f" and len(parts) >= 4:
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
            for k in range(2, len(idx)):
                tris.append([idx[0], idx[k - 1], idx[k]])
    return np.asarray(verts, dtype=np.float64), np.asarray(tris, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def mesh_data(file_name: str, scale):
    """(vertices * scale as float64, triangles as int32) of the OBJ file
    ``file_name`` (resolved by ``find_file``), read once per (file,
    scale). Never write to the arrays: every caller shares them."""
    with open(find_file(file_name)) as f:
        vertices, triangles = load_obj(f.read())
    return vertices * np.asarray(scale, np.float64), triangles
