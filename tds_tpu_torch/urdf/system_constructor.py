"""A URDF robot and a ground plane in one call (counterpart of
tds_tpu/urdf/system_constructor.py)."""

import dataclasses
from typing import Optional, Tuple

import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.urdf.cache import construct, construct_from_string
from tds_tpu_torch.utils.tensors import resolve_device
from tds_tpu_torch.world import World, build_world, make_ground_plane


def system_constructor(
    urdf_filename: Optional[str] = None,
    urdf_string: Optional[str] = None,
    is_floating: bool = False,
    with_ground_plane: bool = True,
    joint_stiffness: float = 0.0,
    joint_damping: float = 0.0,
    solver: ContactSolverParams = ContactSolverParams(),
    contact_model: str = "mlcp",
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[MultiBodyModel, World]:
    """(model, world) of the URDF, from a file or from text, on ``device``
    (None: the CUDA device, raising when there is none) in ``dtype``, with
    a ground plane first in the world unless ``with_ground_plane`` is
    False. ``joint_stiffness`` and ``joint_damping``, when either is set,
    apply to every joint."""
    device = resolve_device(device)
    if urdf_filename is not None:
        model, geoms = construct(urdf_filename, is_floating=is_floating, dtype=dtype)
    elif urdf_string is not None:
        model, geoms = construct_from_string(urdf_string, is_floating=is_floating, dtype=dtype)
    else:
        raise ValueError("need urdf_filename or urdf_string")
    model = model.to(device, dtype)
    if joint_stiffness or joint_damping:
        model = dataclasses.replace(
            model,
            stiffness=torch.full_like(model.stiffness, joint_stiffness),
            damping=torch.full_like(model.damping, joint_damping),
        )
    entries = [make_ground_plane(dtype=dtype, device=device)] if with_ground_plane else []
    entries.append((model, geoms))
    return model, build_world(entries, solver=solver, contact_model=contact_model)
