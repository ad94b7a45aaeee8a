"""PD servo control (counterpart of tds_tpu/control/pd.py)."""

import torch

from tds_tpu_torch.algebra import quaternion
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.utils.tensors import constant


def pd_force(kp, kd, q_desired, q_actual, qd_desired, qd_actual, max_force):
    """Elementwise PD with force clamping."""
    force = kp * (q_desired - q_actual) + kd * (qd_desired - qd_actual)
    return force.clamp(-max_force, max_force)


def spherical_pd_error(q_desired, q_actual):
    """Rotation vector from the actual to the desired orientation,
    to_axis_angle(conj(q_actual) ⊗ q_desired)."""
    return quaternion.to_axis_angle(quaternion.mul(quaternion.conjugate(q_actual), q_desired))


def pd_tau(model: MultiBodyModel, q, qd, q_targets, kp, kd, max_force, skip_links: int = 0):
    """Torques (B, dof_actuated) over the actuated DoF.

    ``q_targets`` (B, n_pd) holds one target per PD-controlled 1-DoF joint,
    the compact pose-vector convention of the JAX package: joints before
    ``skip_links`` stay passive (zero torque) and consume no target, and a
    spherical joint consumes none either: its target is the identity (the
    C++ reference reserves it 4 slots it never reads). The 1-DoF PD law is
    elementwise, so those joints are evaluated in one gather.
    """
    base_off = 6 if model.is_floating else 0
    q_idx, qd_idx, tau_idx, spherical = [], [], [], []
    for i in range(model.num_links):
        jt = JointType(model.joint_types[i])
        if jt == JointType.FIXED or i < skip_links:
            continue
        if jt == JointType.SPHERICAL:
            spherical.append(i)
            continue
        q_idx.append(model.q_offsets[i])
        qd_idx.append(model.qd_offsets[i])
        tau_idx.append(model.qd_offsets[i] - base_off)
    if q_targets.shape[-1] != len(q_idx):
        raise ValueError(f"q_targets has {q_targets.shape[-1]} entries, model has {len(q_idx)} PD joints")
    q_idx, qd_idx, tau_idx = (constant(tuple(xs), torch.long, q.device) for xs in (q_idx, qd_idx, tau_idx))
    force = pd_force(kp, kd, q_targets, q[..., q_idx], 0.0, qd[..., qd_idx], max_force)
    tau = q.new_zeros(q.shape[:-1] + (model.dof_actuated,)).index_copy(-1, tau_idx, force)
    for i in spherical:
        qo, qdo = model.q_offsets[i], model.qd_offsets[i]
        target = constant((0.0, 0.0, 0.0, 1.0), q.dtype, q.device)
        err = spherical_pd_error(target, q[..., qo : qo + 4])
        force = (kp * err - kd * qd[..., qdo : qdo + 3]).clamp(-max_force, max_force)
        tau = torch.cat([tau[..., : qdo - base_off], force, tau[..., qdo - base_off + 3 :]], dim=-1)
    return tau
