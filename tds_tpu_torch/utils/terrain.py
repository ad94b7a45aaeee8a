"""Heightfield terrains (counterpart of tds_tpu/utils/terrain.py): a
triangulated grid with z = height_fn(x, y), as OBJ text for a ``Mesh`` or
as the analytic ``Heightfield`` over the same grid and triangulation."""

from typing import Callable, Tuple

from tds_tpu_torch.model.geometry import Heightfield


def heightfield_obj(
    nx: int,
    ny: int,
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    height_fn: Callable[[float, float], float],
) -> str:
    """OBJ text for an (nx x ny)-vertex grid with z = height_fn(x, y):
    vertices row-major in x, 2 (nx - 1) (ny - 1) triangles, cell (i, j)
    split into (a, b, d) and (a, d, c)."""
    if nx < 2 or ny < 2:
        raise ValueError("need at least a 2x2 vertex grid")
    x0, x1 = x_range
    y0, y1 = y_range
    lines = []
    for j in range(ny):
        y = y0 + (y1 - y0) * j / (ny - 1)
        for i in range(nx):
            x = x0 + (x1 - x0) * i / (nx - 1)
            lines.append(f"v {x:.9g} {y:.9g} {float(height_fn(x, y)):.9g}")
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i + 1  # OBJ indices are 1-based
            b = a + 1
            c = a + nx
            d = c + 1
            lines.append(f"f {a} {b} {d}")
            lines.append(f"f {a} {d} {c}")
    return "\n".join(lines) + "\n"


def write_heightfield(path: str, *args, **kwargs) -> str:
    """Write ``heightfield_obj(*args, **kwargs)`` to ``path``; returns path."""
    with open(path, "w") as f:
        f.write(heightfield_obj(*args, **kwargs))
    return path


def make_heightfield(
    nx: int,
    ny: int,
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    height_fn: Callable[[float, float], float],
    max_contacts: int = 1,
) -> Heightfield:
    """The ``Heightfield`` over the grid and triangulation of
    ``heightfield_obj``: the same contact surface, O(1) queries."""
    x0, x1 = x_range
    y0, y1 = y_range
    heights = tuple(
        float(height_fn(x0 + (x1 - x0) * i / (nx - 1), y0 + (y1 - y0) * j / (ny - 1)))
        for j in range(ny)
        for i in range(nx)
    )
    return Heightfield(
        nx=nx, ny=ny, x_range=tuple(x_range), y_range=tuple(y_range), heights=heights, max_contacts=max_contacts
    )
