"""Raibert-heuristic swing-leg controller (counterpart of
tds_tpu/control/mpc/swing_leg.py; the reference's
raibert_swing_leg_controller.hpp), batched: foot placement = hip + v
T_stance / 2 - kp (v_des - v), a parabolic swing with a warped phase (a
fast first half, 0.8 sin(pi phase))."""

import math
from typing import NamedTuple

import torch

from tds_tpu_torch.control.mpc.gait import SWING
from tds_tpu_torch.utils.tensors import constant_like

KP_RAIBERT = 0.1
MAX_CLEARANCE = 0.1


def swing_phase_warp(input_phase):
    """0.8 sin(pi phase) up to phase 0.5, then 0.8 + (phase - 0.5) 0.4."""
    return torch.where(input_phase <= 0.5, 0.8 * torch.sin(input_phase * math.pi), 0.8 + (input_phase - 0.5) * 0.4)


def gen_parabola(phase, start, mid, end):
    """The point at ``phase`` on the parabola through (0, start),
    (0.5, mid) and (1, end)."""
    mid_phase = 0.5
    d1 = mid - start
    d2 = end - start
    d3 = mid_phase**2 - mid_phase
    a = (d1 - d2 * mid_phase) / d3
    b = d2 - a
    return a * phase**2 + b * phase + start


def swing_foot_trajectory(input_phase, start_pos, end_pos):
    """The swing foot's position in the base frame: x, y interpolated,
    z on the parabola MAX_CLEARANCE above the higher end."""
    phase = swing_phase_warp(input_phase)
    xy = (1.0 - phase)[..., None] * start_pos[..., 0:2] + phase[..., None] * end_pos[..., 0:2]
    mid = torch.maximum(end_pos[..., 2], start_pos[..., 2]) + MAX_CLEARANCE
    z = gen_parabola(phase, start_pos[..., 2], mid, end_pos[..., 2])
    return torch.cat([xy, z[..., None]], dim=-1)


def raibert_foot_targets(
    com_velocity_body,  # (B, 3)
    yaw_rate,  # (B,)
    hip_positions,  # (num_legs, 3) in the base frame
    stance_duration,  # (num_legs,)
    desired_speed,  # (3,)
    desired_twisting_speed,
    desired_height,  # the standing height less the foot clearance
):
    """Raibert landing targets (B, num_legs, 3) in the base frame."""
    v = torch.cat([com_velocity_body[..., 0:2], torch.zeros_like(com_velocity_body[..., 2:3])], dim=-1)
    twisting = torch.stack([-hip_positions[..., 1], hip_positions[..., 0], torch.zeros_like(hip_positions[..., 0])], dim=-1)
    hip_vel = v[..., None, :] + yaw_rate[..., None, None] * twisting
    target_hip_vel = desired_speed + desired_twisting_speed * twisting
    target = hip_vel * stance_duration[:, None] / 2.0 - KP_RAIBERT * (target_hip_vel - hip_vel)
    offset = torch.cat([hip_positions[..., 0:2], torch.full_like(hip_positions[..., 2:3], -desired_height)], dim=-1)
    return target + offset


class SwingLegState(NamedTuple):
    last_leg_state: torch.Tensor  # (B, num_legs) int64
    phase_switch_foot_position: torch.Tensor  # (B, num_legs, 3) base frame

    @staticmethod
    def create(initial_leg_state, foot_positions):
        """The initial leg states broadcast over the batch of
        ``foot_positions`` (B, num_legs, 3)."""
        last = constant_like(initial_leg_state, foot_positions, torch.int64)
        return SwingLegState(last_leg_state=last.expand(foot_positions.shape[:-1]).clone(),
                             phase_switch_foot_position=foot_positions)


def swing_leg_update(state: SwingLegState, desired_leg_state, foot_positions_base) -> SwingLegState:
    """Latch the take-off foot positions on STANCE -> SWING switches."""
    switched = (desired_leg_state == SWING) & (state.last_leg_state != desired_leg_state)
    latched = torch.where(switched[..., None], foot_positions_base, state.phase_switch_foot_position)
    return SwingLegState(last_leg_state=desired_leg_state, phase_switch_foot_position=latched)


def swing_foot_positions(state: SwingLegState, normalized_phase, foot_targets):
    """Each leg's swing foot command (B, num_legs, 3), base frame."""
    return swing_foot_trajectory(normalized_phase, state.phase_switch_foot_position, foot_targets)
