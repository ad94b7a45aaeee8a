"""Pendulums (counterpart of tds_tpu/model/pendulum.py): the compound
pendulum, an n-link chain of revolute-X joints, link i hanging one link
length below its parent joint, a point mass at the end of each rod; the
spherical pendulum; the double pendulum's closed-form accelerations."""

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


def spherical_pendulum(
    num_links: int = 2,
    masses: Optional[Sequence[float]] = None,
    link_length: float = 0.5,
    dtype=torch.float64,
    device=None,
) -> MultiBodyModel:
    """An n-link chain of spherical joints, each link hanging
    ``link_length`` below its parent's joint with a near-point mass at the
    rod's end."""
    masses = [1.0] * num_links if masses is None else list(masses)
    b = MultiBodyBuilder(is_floating=False, name=f"spherical_pendulum{num_links}")
    for i in range(num_links):
        b.add_link(
            JointType.SPHERICAL,
            parent=i - 1,
            x_t_pos=(0.0, 0.0, 0.0) if i == 0 else (0.0, 0.0, -link_length),
            mass=masses[i],
            com=np.array([0.0, 0.0, -link_length]),
            inertia_about_com=np.diag([1e-6, 1e-6, 1e-6]),
            link_name=f"link{i}",
        )
    return b.finalize(dtype=dtype, device=device)


def double_pendulum_qdd(q, qd, m1=1.0, m2=1.0, l1=0.5, l2=0.5, g=9.81):
    """The planar double pendulum's accelerations in closed form (point
    masses), the analytic check of the dynamics: angles from straight down,
    q2 relative to link 1, as compound_pendulum's joints."""
    t1, t2 = q[..., 0], q[..., 1]
    w1, w2 = qd[..., 0], qd[..., 1]
    d = t2  # the relative angle between the rods
    den = m1 + m2 * d.sin() ** 2
    a1 = (
        m2 * l1 * w1**2 * d.sin() * d.cos()
        + m2 * g * (t1 + d).sin() * d.cos()
        + m2 * l2 * (w1 + w2) ** 2 * d.sin()
        - (m1 + m2) * g * t1.sin()
    ) / (l1 * den)
    a2 = (
        -m2 * l2 * (w1 + w2) ** 2 * d.sin() * d.cos()
        - (m1 + m2) * (g * t1.sin() * d.cos() - g * (t1 + d).sin() + l1 * w1**2 * d.sin())
    ) / (l2 * den) - a1
    return torch.stack([a1, a2], dim=-1)
