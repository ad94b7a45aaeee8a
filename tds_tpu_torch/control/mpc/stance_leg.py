"""Stance-leg torques from the MPC's contact forces (counterpart of
tds_tpu/control/mpc/stance_leg.py; the reference's
torque_stance_leg_controller.hpp): tau = sum over the stance feet of
J_foot^T (-f_world)."""

from typing import Sequence

from tds_tpu_torch.dynamics.jacobian import point_jacobian_kin
from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q
from tds_tpu_torch.model.multibody import MultiBodyModel


def stance_torques_from_forces(
    model: MultiBodyModel,
    q,
    foot_link_indices: Sequence[int],
    foot_positions_world,  # (B, num_legs, 3)
    forces_world,  # (B, num_legs, 3): the ground's forces ON the robot
    contact_mask=None,  # (B, num_legs), 1 for stance legs
    fk=None,
):
    """Generalized torques (B, dof_qd) that apply -f at each stance foot,
    the reaction the actuators must produce; ``fk`` is
    ``forward_kinematics_q(model, q)`` when the caller has it."""
    base_x, lxw, lxb = forward_kinematics_q(model, q) if fk is None else fk
    tau = None
    for leg, link in enumerate(foot_link_indices):
        jac = point_jacobian_kin(model, base_x, lxw, lxb, link, foot_positions_world[..., leg, :])
        contrib = (-forces_world[..., leg, None, :] @ jac).squeeze(-2)
        if contact_mask is not None:
            contrib = contrib * contact_mask[..., leg, None]
        tau = contrib if tau is None else tau + contrib
    return tau
