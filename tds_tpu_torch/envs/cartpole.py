"""Cartpole balance env (counterpart of tds_tpu/envs/cartpole.py), on
batched tensors.

No contact: ABA and semi-implicit Euler at dt = 1/60 under gravity
(0, 0, -10), the rail hung at z = 1. The action is the cart force, the
policy's output clipped to [-1, 1] and scaled to +-10; reward 1 per step;
done when |x| > 0.4 or |theta| > 12 degrees; reset uniform in +-0.05 on
all four states.
"""

import dataclasses
import math
from typing import Optional

import torch

from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics
from tds_tpu_torch.dynamics.integrator import integrate_euler
from tds_tpu_torch.envs.base import Env, EnvState
from tds_tpu_torch.urdf.cache import construct
from tds_tpu_torch.utils.tensors import resolve_device

THETA_THRESHOLD = 12.0 * 2.0 * math.pi / 360.0
X_THRESHOLD = 0.4


class CartpoleEnv(Env):
    """Runs on the CUDA device unless ``device`` names another, in
    ``dtype`` (float32 by default; the CPU tests pass float64)."""

    observation_dim = 4
    action_dim = 1

    def __init__(self, urdf: str = "cartpole.urdf", dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        model, _ = construct(urdf, is_floating=False)
        # the rail hangs at z = 1; the dynamics do not depend on this offset
        base_pos = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=self.device)
        self.model = dataclasses.replace(model.to(self.device, dtype), base_pos=base_pos)
        self.dt = 1.0 / 60.0
        self.gravity = torch.tensor([0.0, 0.0, -10.0], dtype=dtype, device=self.device)
        self.action_low = -10.0
        self.action_high = 10.0

    def action_transform(self, raw_action):
        """Clip to [-1, 1], then scale to [action_low, action_high]."""
        a = raw_action.clamp(-1.0, 1.0)
        return a * (self.action_high - self.action_low) / 2.0 + (self.action_low + self.action_high) / 2.0

    def sim_step(self, q, qd, action):
        """One step on (B, 2), (B, 2), (B, 1): the clipped force drives the cart."""
        force = action.clamp(self.action_low, self.action_high)
        # the force on the cart's slider, none on the pole's hinge
        tau = torch.nn.functional.pad(force[..., :1], (0, self.model.dof_actuated - 1))
        qdd = forward_dynamics(self.model, q, qd, tau, self.gravity)
        return integrate_euler(self.model, q, qd, qdd, self.dt)

    def observation(self, q, qd):
        return torch.cat([q, qd], dim=-1)

    def draw_reset_noise(self, generator: Optional[torch.Generator] = None, batch_size: int = 1):
        """(B, 4) uniform in +-0.05: [x, theta, x_dot, theta_dot], drawn
        from ``generator`` on the generator's device and moved to the env's."""
        gen_device = generator.device if generator is not None else self.device
        u = torch.rand((batch_size, 4), generator=generator, dtype=self.dtype, device=gen_device)
        return (-0.05 + 0.1 * u).to(self.device)

    def reset(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, noise=None):
        """The state is the noise, drawn from ``generator`` or given as an
        explicit (B, 4) tensor."""
        if noise is None:
            noise = self.draw_reset_noise(generator, batch_size)
        x = noise.to(self.device, self.dtype)
        q, qd = x[..., 0:2], x[..., 2:4]
        t = torch.zeros(x.shape[:-1], dtype=torch.int32, device=self.device)
        return EnvState(q=q, qd=qd, t=t), self.observation(q, qd)

    def step(self, state: EnvState, action):
        q, qd = self.sim_step(state.q, state.qd, action)
        x, theta = q[..., 0], q[..., 1]
        done = (x < -X_THRESHOLD) | (x > X_THRESHOLD) | (theta < -THETA_THRESHOLD) | (theta > THETA_THRESHOLD)
        return EnvState(q=q, qd=qd, t=state.t + 1), self.observation(q, qd), torch.ones_like(x), done
