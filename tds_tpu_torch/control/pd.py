"""PD servo control (counterpart of tds_tpu/control/pd.py) for 1-DoF
joints. Spherical-joint PD is not ported yet."""

import torch

from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.utils.tensors import constant


def pd_force(kp, kd, q_desired, q_actual, qd_desired, qd_actual, max_force):
    """Elementwise PD with force clamping."""
    force = kp * (q_desired - q_actual) + kd * (qd_desired - qd_actual)
    return force.clamp(-max_force, max_force)


def pd_tau(model: MultiBodyModel, q, qd, q_targets, kp, kd, max_force, skip_links: int = 0):
    """Torques (B, dof_actuated) over the actuated DoF.

    ``q_targets`` (B, n_pd) holds one target per PD-controlled 1-DoF joint,
    the compact pose-vector convention of the JAX package: joints before
    ``skip_links`` stay passive (zero torque) and consume no target. The PD
    law is elementwise, so all joints are evaluated in one gather.
    """
    base_off = 6 if model.is_floating else 0
    q_idx, qd_idx, tau_idx = [], [], []
    for i in range(model.num_links):
        jt = JointType(model.joint_types[i])
        if jt == JointType.FIXED or i < skip_links:
            continue
        if jt == JointType.SPHERICAL:
            raise NotImplementedError("spherical-joint PD is not ported to tds_tpu_torch yet")
        q_idx.append(model.q_offsets[i])
        qd_idx.append(model.qd_offsets[i])
        tau_idx.append(model.qd_offsets[i] - base_off)
    if q_targets.shape[-1] != len(q_idx):
        raise ValueError(f"q_targets has {q_targets.shape[-1]} entries, model has {len(q_idx)} PD joints")
    q_idx, qd_idx, tau_idx = (constant(tuple(xs), torch.long, q.device) for xs in (q_idx, qd_idx, tau_idx))
    force = pd_force(kp, kd, q_targets, q[..., q_idx], 0.0, qd[..., qd_idx], max_force)
    tau = q.new_zeros(q.shape[:-1] + (model.dof_actuated,))
    return tau.index_copy(-1, tau_idx, force)
