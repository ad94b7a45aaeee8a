"""Hopper planar locomotion env (counterpart of tds_tpu/envs/hopper.py's
``HopperEnv``).

Built on the reference's planar URDF ``hopper_link0_1.urdf``: an x/z
prismatic + y revolute passive base chain and 4 capsule collision bodies;
the zero configuration stands at the URDF's rest height. The reward is the
forward velocity plus a survival bonus; the env is done on the torso's
height or pitch. The half-cheetah of the same JAX module is not ported.
"""

import torch

from tds_tpu_torch.envs.locomotion import LocomotionEnv
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.urdf.cache import construct


class HopperEnv(LocomotionEnv):
    """kp=50, kd=1, max_force=30, dt=2e-3, the base chain's 3 links not
    PD-driven. Runs on the CUDA device unless ``device`` names another, in
    ``dtype`` (float32 by default; the CPU tests pass float64)."""

    TORSO_REST_Z = 1.05  # torso capsule center at q = 0 (FK of the URDF)

    def __init__(self, urdf: str = "hopper_link0_1.urdf", dtype: torch.dtype = torch.float32, device=None, **kwargs):
        model, geoms = construct(urdf, is_floating=False)
        n_act = sum(1 for i, jt in enumerate(model.joint_types) if jt != JointType.FIXED and i >= 3)
        defaults = dict(
            initial_poses=(0.0,) * n_act,
            kp=50.0,
            kd=1.0,
            max_force=30.0,
            dt=2e-3,
            start_base_position=(0.0, 0.0, 0.0),  # the URDF's rest pose stands
            skip_links=3,  # x, z prismatic + y revolute passive base
        )
        defaults.update(kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **defaults)

    def reward_done(self, q_prev, qd_prev, q, qd):
        # q layout: [x, z, pitch, joints...]
        vel_x = (q[..., 0] - q_prev[..., 0]) / self.dt
        height = q[..., 1] + self.TORSO_REST_Z
        pitch = q[..., 2]
        done = (height < 0.7) | (pitch.abs() > 1.0)
        reward = torch.where(done, 0.0, vel_x + 1.0)
        return reward, done
