"""The compound pendulum (counterpart of
tds_tpu/model/pendulum.py::compound_pendulum): an n-link chain of
revolute-X joints, link i hanging one link length below its parent joint,
a point mass at the end of each rod."""

from typing import Optional, Sequence

import numpy as np
import torch

from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel


def compound_pendulum(
    num_links: int = 2,
    masses: Optional[Sequence[float]] = None,
    link_length: float = 0.5,
    link_lengths: Optional[Sequence[float]] = None,
    dtype=torch.float64,
    device=None,
) -> MultiBodyModel:
    """n-link compound pendulum swinging in the y-z plane: link i's joint
    sits ``link_lengths[i - 1]`` below its parent's (``link_length`` for
    every link unless ``link_lengths`` is given), its point mass
    ``link_lengths[i]`` below its own joint."""
    masses = [1.0] * num_links if masses is None else list(masses)
    link_lengths = [link_length] * num_links if link_lengths is None else list(link_lengths)
    if len(masses) != num_links or len(link_lengths) != num_links:
        raise ValueError(f"{len(masses)} masses and {len(link_lengths)} lengths for {num_links} links")
    b = MultiBodyBuilder(is_floating=False, name=f"pendulum{num_links}")
    for i in range(num_links):
        b.add_link(
            JointType.REVOLUTE_X,
            parent=i - 1,
            x_t_pos=(0.0, 0.0, 0.0) if i == 0 else (0.0, 0.0, -link_lengths[i - 1]),
            mass=masses[i],
            com=np.array([0.0, 0.0, -link_lengths[i]]),
            inertia_about_com=np.zeros((3, 3)),
            link_name=f"link{i}",
            joint_name=f"joint{i}",
        )
    return b.finalize(dtype=dtype, device=device)
