"""Semi-implicit Euler integration (counterpart of
tds_tpu/dynamics/integrator.py) for fixed-base models with 1-DoF joints:
velocities first, then positions from the updated velocities."""

import torch

from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel


def integrate_euler_qdd(model: MultiBodyModel, q, qd, qdd, dt):
    """Velocity half-step only: qd + qdd*dt. Returns qd."""
    return qd + qdd * dt


def integrate_euler(model: MultiBodyModel, q, qd, qdd, dt):
    """The full semi-implicit Euler step; returns (q, qd)."""
    return integrate_q(model, q, integrate_euler_qdd(model, q, qd, qdd, dt), dt)


def integrate_q(model: MultiBodyModel, q, qd, dt):
    """Position update from the (already updated) velocities; returns
    (q, qd). With fixed and 1-DoF joints only, q and qd share one layout."""
    if model.is_floating or JointType.SPHERICAL in model.joint_types:
        raise NotImplementedError(
            "floating bases and spherical joints are not ported to tds_tpu_torch yet"
        )
    return q + qd * dt, qd
