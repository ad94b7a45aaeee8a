"""Open-loop gait scheduling and the COM velocity's moving window
(counterpart of tds_tpu/control/mpc/gait.py; the reference's
openloop_gait_generator.hpp and com_velocity_estimator.hpp), over a
leading batch of envs: the gait clock is a (B,) tensor, one time per env,
as ``jax.vmap`` of the JAX package's tick carries it.

Leg states are integers: SWING=0, STANCE=1, EARLY_CONTACT=2,
LOSE_CONTACT=3. A ``GaitConfig`` holds plain numbers (or tensors); they
become cached constants in the dtype and on the device of the state.
"""

from typing import NamedTuple, Sequence, Union

import torch

from tds_tpu_torch.utils.tensors import constant_like

SWING, STANCE, EARLY_CONTACT, LOSE_CONTACT = 0, 1, 2, 3

# laikago's trot (the reference's openloop_gait_generator.hpp constants)
NOMINAL_STANCE_DURATION = (0.3, 0.3, 0.3, 0.3)
NOMINAL_DUTY_FACTOR = (0.6, 0.6, 0.6, 0.6)
INITIAL_LEG_PHASE = (0.9, 0.0, 0.0, 0.9)
TROTTING_INIT_STATE = (SWING, STANCE, STANCE, SWING)
CONTACT_DETECTION_PHASE_THRESHOLD = 0.1

Values = Union[Sequence[float], torch.Tensor]


class GaitConfig(NamedTuple):
    stance_duration: Values  # (num_legs,)
    duty_factor: Values
    initial_leg_phase: Values
    initial_leg_state: Sequence[int]  # (num_legs,)
    contact_detection_phase_threshold: float = CONTACT_DETECTION_PHASE_THRESHOLD

    @staticmethod
    def laikago_trotting():
        return GaitConfig(
            stance_duration=NOMINAL_STANCE_DURATION,
            duty_factor=NOMINAL_DUTY_FACTOR,
            initial_leg_phase=INITIAL_LEG_PHASE,
            initial_leg_state=TROTTING_INIT_STATE,
        )


class GaitState(NamedTuple):
    desired_leg_state: torch.Tensor  # (B, num_legs) int64
    leg_state: torch.Tensor  # (B, num_legs) int64, contact-corrected
    normalized_phase: torch.Tensor  # (B, num_legs) in [0, 1)


def _mod(x, y):
    """``jnp.mod``: the remainder with the divisor's sign, from fmod."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def gait_update(config: GaitConfig, current_time, foot_contacts) -> GaitState:
    """Phase scheduling and early / lost contact detection, branchless;
    ``current_time`` (B,), ``foot_contacts`` (B, num_legs) bool."""
    stance = constant_like(config.stance_duration, current_time)
    duty = constant_like(config.duty_factor, current_time)
    initial_state = constant_like(config.initial_leg_state, current_time, torch.int64)
    full_cycle = stance / duty
    augmented = current_time[..., None] + constant_like(config.initial_leg_phase, current_time) * full_cycle
    phase_in_cycle = _mod(augmented, full_cycle) / full_cycle
    init_is_swing = initial_state == SWING
    ratio = torch.where(init_is_swing, 1.0 - duty, duty)
    in_initial = phase_in_cycle < ratio
    desired = torch.where(in_initial, initial_state, torch.where(init_is_swing, STANCE, SWING))
    phase = torch.where(in_initial, phase_in_cycle / ratio, (phase_in_cycle - ratio) / (1.0 - ratio))
    detect = phase >= config.contact_detection_phase_threshold
    contacts = foot_contacts.to(torch.bool)
    state = torch.where(detect & (desired == SWING) & contacts, EARLY_CONTACT, desired)
    state = torch.where(detect & (desired == STANCE) & ~contacts, LOSE_CONTACT, state)
    return GaitState(desired_leg_state=desired, leg_state=state, normalized_phase=phase)


def swing_duration(config: GaitConfig, like: torch.Tensor):
    """Each leg's swing time, in ``like``'s dtype and on its device."""
    stance = constant_like(config.stance_duration, like)
    return stance / constant_like(config.duty_factor, like) - stance


class VelocityFilterState(NamedTuple):
    """A moving average over the last W samples: a ring buffer (B, W, 3)
    and the count of samples (B,) int32."""

    buffer: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(window: int = 20, dtype=torch.float32, device=None, batch_shape=()):
        return VelocityFilterState(
            buffer=torch.zeros(batch_shape + (window, 3), dtype=dtype, device=device),
            count=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        )

    def update(self, velocity):
        """(state', the average) with ``velocity`` (B, 3) shifted in."""
        buf = torch.cat([self.buffer[..., 1:, :], velocity[..., None, :]], dim=-2)
        count = (self.count + 1).clamp_max(buf.shape[-2])
        avg = buf.sum(-2) / count.clamp_min(1)[..., None]
        return VelocityFilterState(buf, count), avg
