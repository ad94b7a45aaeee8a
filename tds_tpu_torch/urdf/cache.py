"""Memoizing URDF loader (counterpart of tds_tpu/urdf/cache.py)."""

from typing import Dict, Tuple

import torch

from tds_tpu_torch.urdf.converter import convert_to_multibody
from tds_tpu_torch.urdf.parser import parse_urdf_file, parse_urdf_string
from tds_tpu_torch.utils.file_utils import find_file

_DOC_CACHE: Dict[str, object] = {}
_MODEL_CACHE: Dict[Tuple, object] = {}


def load_document(name: str):
    """The parsed URDF document (its links' visuals too), cached by path."""
    path = find_file(name)
    if path not in _DOC_CACHE:
        _DOC_CACHE[path] = parse_urdf_file(path)
    return _DOC_CACHE[path]


def construct(name: str, is_floating: bool = False, dtype=torch.float64, mesh_contacts: int = 0):
    """Returns (MultiBodyModel on the CPU, collision attachments), cached by
    (resolved path, floating flag, dtype, mesh_contacts). Move the model to
    the card with ``model.to(device, dtype)``."""
    path = find_file(name)
    key = (path, is_floating, dtype, mesh_contacts)
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = convert_to_multibody(
            parse_urdf_file(path), is_floating, dtype, mesh_contacts=mesh_contacts
        )
    return _MODEL_CACHE[key]


def construct_from_string(text: str, is_floating: bool = False, dtype=torch.float64, mesh_contacts: int = 0):
    """:func:`construct` of a URDF document given as text, not cached."""
    return convert_to_multibody(parse_urdf_string(text), is_floating, dtype, mesh_contacts=mesh_contacts)
