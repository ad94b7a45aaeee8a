"""Asset path resolution (counterpart of tds_tpu/utils/file_utils.py).

Search order: the ``TDS_TPU_DATA_PATH`` environment variable (os.pathsep
separated), the directories given to :func:`add_search_path` (the latest
first), the JAX package's bundled ``tds_tpu/data`` directory read by path
(nothing of ``tds_tpu`` is imported), then ``./data``.
"""

import os
from pathlib import Path
from typing import List

_BUNDLED_DATA = Path(__file__).resolve().parents[2] / "tds_tpu" / "data"
_SEARCH_PATHS: List[str] = []


def data_search_paths() -> List[str]:
    paths = []
    env = os.environ.get("TDS_TPU_DATA_PATH")
    if env:
        paths.extend(env.split(os.pathsep))
    paths.extend(_SEARCH_PATHS)
    paths.append(str(_BUNDLED_DATA))
    paths.append(os.path.join(os.getcwd(), "data"))
    return paths


def add_search_path(path: str) -> None:
    """Searches ``path`` for assets before the bundled directory."""
    _SEARCH_PATHS.insert(0, str(path))


def find_file(name: str) -> str:
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for base in data_search_paths():
        candidate = os.path.join(base, name)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"asset {name!r} not found in {data_search_paths()}")
