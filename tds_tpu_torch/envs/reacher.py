"""Two-link reacher (counterpart of tds_tpu/envs/reacher.py), on batched
tensors.

A fixed-base 2R arm in the horizontal plane (gravity zero, no contact)
reaches for a target point: ABA and semi-implicit Euler at dt = 0.02, the
action clipped to [-1, 1] and scaled by 0.05 into joint torques, reward
minus the fingertip's distance to the target minus the action's squared
norm, done after ``episode_length`` steps. Observation [cos q, sin q, qd,
target, fingertip - target]; the target rides in q's tail (q is 4 wide,
qd 2).
"""

from typing import Optional

import torch

from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics
from tds_tpu_torch.dynamics.integrator import integrate_euler
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.envs.base import Env, EnvState
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyBuilder
from tds_tpu_torch.utils.tensors import constant, resolve_device

# the reset's uniform ranges: joint angles, joint velocities, target x and y
RESET_RANGES = ((-3.1, 3.1),) * 2 + ((-0.005, 0.005),) * 2 + ((-0.18, 0.18),) * 2


def reacher_model(l1: float = 0.1, l2: float = 0.11, dtype=torch.float64, device=None):
    b = MultiBodyBuilder(name="reacher")
    b.add_link(JointType.REVOLUTE_Z, -1, mass=0.1, com=(l1 / 2, 0, 0), inertia_about_com=(1e-4, 1e-4, 1e-4), link_name="link0")
    b.add_link(JointType.REVOLUTE_Z, 0, x_t_pos=(l1, 0, 0), mass=0.1, com=(l2 / 2, 0, 0), inertia_about_com=(1e-4, 1e-4, 1e-4),
               link_name="link1")
    return b.finalize(dtype=dtype, device=device)


class ReacherEnv(Env):
    """Runs on the CUDA device unless ``device`` names another, in
    ``dtype`` (float32 by default; the CPU tests pass float64)."""

    observation_dim = 10
    action_dim = 2

    def __init__(self, dtype: torch.dtype = torch.float32, dt: float = 0.02, episode_length: int = 50, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = reacher_model(dtype=dtype, device=self.device)
        self.l_tip = 0.11
        self.dt = dt
        self.episode_length = episode_length
        self.gravity = torch.zeros(3, dtype=dtype, device=self.device)  # the horizontal plane
        self.torque_scale = 0.05

    def fingertip(self, q):
        """(B, 2): the tip of link 1 in the plane."""
        x_world = fk_links(self.model, q, torch.zeros_like(q)).x_world[1]
        tip = constant((self.l_tip, 0.0, 0.0), q.dtype, q.device).expand(q.shape[:-1] + (3,))
        return x_world.apply_point(tip)[..., 0:2]

    def observation(self, q, qd, target):
        tip = self.fingertip(q)
        return torch.cat([q.cos(), q.sin(), qd, target, tip - target], dim=-1)

    def draw_reset_noise(self, generator: Optional[torch.Generator] = None, batch_size: int = 1):
        """(B, 6): joint angles, joint velocities and the target, uniform in
        :data:`RESET_RANGES`, drawn from ``generator`` on its device and
        moved to the env's."""
        gen_device = generator.device if generator is not None else self.device
        u = torch.rand((batch_size, 6), generator=generator, dtype=self.dtype, device=gen_device)
        lo = torch.tensor([r[0] for r in RESET_RANGES], dtype=self.dtype, device=gen_device)
        hi = torch.tensor([r[1] for r in RESET_RANGES], dtype=self.dtype, device=gen_device)
        return (lo + (hi - lo) * u).to(self.device)

    def reset(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, noise=None):
        """The state is the noise: (B, 6) [q, qd, target], drawn from
        ``generator`` or given."""
        if noise is None:
            noise = self.draw_reset_noise(generator, batch_size)
        x = noise.to(self.device, self.dtype)
        q, qd, target = x[..., 0:2], x[..., 2:4], x[..., 4:6]
        t = torch.zeros(x.shape[:-1], dtype=torch.int32, device=self.device)
        return EnvState(q=torch.cat([q, target], -1), qd=qd, t=t), self.observation(q, qd, target)

    def step(self, state: EnvState, action):
        q, target, qd = state.q[..., 0:2], state.q[..., 2:4], state.qd
        tau = self.torque_scale * action.clamp(-1.0, 1.0)
        qdd = forward_dynamics(self.model, q, qd, tau, self.gravity)
        q, qd = integrate_euler(self.model, q, qd, qdd, self.dt)
        tip = self.fingertip(q)
        dist = torch.linalg.vector_norm(tip - target, dim=-1)
        reward = -dist - (action**2).sum(-1)
        done = state.t + 1 >= self.episode_length
        new_state = EnvState(q=torch.cat([q, target], -1), qd=qd, t=state.t + 1)
        return new_state, self.observation(q, qd, target), reward, done
