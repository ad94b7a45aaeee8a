"""Actuator models: the gear and limit base, series-elastic, position
servo and actuator net (counterpart of tds_tpu/control/actuators.py; the
reference's tiny_actuator.h). Each is a function ``(state, q, qd, u) ->
(tau, state')`` over batched tensors; a stateless actuator carries ().
"""

from typing import NamedTuple, Optional

import torch

from tds_tpu_torch.learn.nn import Activation, MLPSpec


def _apply_limits(tau, limits):
    if limits is None:
        return tau
    limits = torch.as_tensor(limits, dtype=tau.dtype, device=tau.device)
    return torch.clamp(tau, -limits, limits)


class DirectActuator(NamedTuple):
    """tau = u / gear_ratio, clamped."""

    gear_ratios: Optional[torch.Tensor] = None
    limits: Optional[torch.Tensor] = None

    def compute_torques(self, state, q, qd, u):
        tau = u if self.gear_ratios is None else u / self.gear_ratios
        return _apply_limits(tau, self.limits), state

    def init_state(self, dof, dtype=torch.float32, device=None):
        return ()


class SeriesElasticActuator(NamedTuple):
    """Motor, gearbox and spring: the input is the motor velocity, the
    state the gear positions."""

    spring_k: float = 1.0
    gear_ratios: Optional[torch.Tensor] = None
    limits: Optional[torch.Tensor] = None

    def init_state(self, dof, dtype=torch.float32, device=None):
        return torch.zeros(dof, dtype=dtype, device=device)

    def compute_torques(self, gear_positions, q, qd, u):
        tau = (gear_positions - q) * self.spring_k
        return _apply_limits(tau, self.limits), gear_positions

    def integrate(self, gear_positions, q, qd, u, dt):
        """gear_pos += dt u / gear_ratio."""
        ratios = 1.0 if self.gear_ratios is None else self.gear_ratios
        return gear_positions + dt * u / ratios


class ServoActuator(NamedTuple):
    """Position servo: PD toward the target positions u."""

    kp: float
    kd: float
    min_force: float
    max_force: float
    limits: Optional[torch.Tensor] = None

    def init_state(self, dof, dtype=torch.float32, device=None):
        return ()

    def compute_torques(self, state, q, qd, u):
        tau = torch.clamp(self.kp * (u - q) - self.kd * qd, self.min_force, self.max_force)
        return _apply_limits(tau, self.limits), state


class ActuatorNetSpec:
    """A neural servo over a history of (position error, velocity)
    samples: an ``MLPSpec`` softsign 32-32-32 -> dof, on the JAX package's
    flat parameter layout (``convert.mlp_params_from_numpy`` carries a
    trained one over)."""

    def __init__(self, history_size: int, dof: int):
        self.history_size = history_size
        self.dof = dof
        self.network = MLPSpec(
            history_size * 2 * dof,
            [32, 32, 32, dof],
            [Activation.SOFTSIGN, Activation.SOFTSIGN, Activation.SOFTSIGN, Activation.IDENTITY],
        )

    def init_state(self, dtype=torch.float32, device=None, batch_shape=()):
        """The history ring buffer (..., history_size, 2 dof)."""
        return torch.zeros(batch_shape + (self.history_size, 2 * self.dof), dtype=dtype, device=device)

    def compute_torques(self, params, history, q, qd, u):
        """``u`` holds the target joint positions; the newest (u - q, qd)
        sample shifts into the history before the network runs."""
        sample = torch.cat([u - q, qd], dim=-1)
        history = torch.cat([history[..., 1:, :], sample[..., None, :]], dim=-2)
        return self.network.apply(params, history.reshape(history.shape[:-2] + (-1,))), history
