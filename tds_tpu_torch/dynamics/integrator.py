"""Semi-implicit Euler integration (counterpart of
tds_tpu/dynamics/integrator.py): velocities first, then positions from the
updated velocities. A floating base's quaternion integrates its
world-frame angular velocity, renormalized, and its position its linear
velocity. A spherical joint's rates decay by pow(joint_damping, 1000 dt)
and its quaternion integrates the body-frame angular velocity,
renormalized."""

import torch

from tds_tpu_torch.algebra import quaternion
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
    (q, qd), qd with the spherical joints' decay applied."""
    q_parts, qd_parts = [], []
    q_at = qd_at = 0
    if model.is_floating:
        q_parts += [quaternion.integrate_world(q[..., 0:4], qd[..., 0:3], dt), q[..., 4:7] + qd[..., 3:6] * dt]
        qd_parts.append(qd[..., 0:6])
        q_at, qd_at = 7, 6
    elif JointType.SPHERICAL not in model.joint_types:
        # fixed and 1-DoF joints only: q and qd share one layout
        return q + qd * dt, qd
    for i in range(model.num_links):
        jt = JointType(model.joint_types[i])
        if jt == JointType.FIXED:
            continue
        qo, qdo = model.q_offsets[i], model.qd_offsets[i]
        if jt == JointType.SPHERICAL:
            # the 1-DoF joints before this one move together
            q_parts.append(q[..., q_at:qo] + qd[..., qd_at:qdo] * dt)
            qd_parts.append(qd[..., qd_at:qdo])
            omega = qd[..., qdo : qdo + 3] * torch.pow(model.joint_damping, dt * 1000.0)
            q_parts.append(quaternion.integrate_local(q[..., qo : qo + 4], omega, dt))
            qd_parts.append(omega)
            q_at, qd_at = qo + 4, qdo + 3
    q_parts.append(q[..., q_at:] + qd[..., qd_at:] * dt)
    qd_parts.append(qd[..., qd_at:])
    return torch.cat(q_parts, dim=-1), torch.cat(qd_parts, dim=-1)
