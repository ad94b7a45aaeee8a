"""Hopper and half-cheetah planar locomotion envs (counterpart of
tds_tpu/envs/hopper.py).

Built on the reference's planar URDFs ``hopper_link0_1.urdf`` and
``cheetah_link0_1.urdf``: an x/z prismatic + y revolute passive base chain
and capsule collision bodies (4 and 8, so 24 and 48 contact MLCP rows); the
zero configuration stands at the URDF's rest height. The rewards are the
forward velocity (plus a survival bonus for the hopper); an env is done on
the torso's height (and the hopper's pitch).
"""

import torch

from tds_tpu_torch.envs.locomotion import LocomotionEnv
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.urdf.cache import construct


def _planar_env_args(urdf, kp, kd, max_force, kwargs):
    """(model, geoms, LocomotionEnv arguments) of a planar robot whose
    first 3 links are the passive x, z, pitch base chain."""
    model, geoms = construct(urdf, is_floating=False)
    n_act = sum(1 for i, jt in enumerate(model.joint_types) if jt != JointType.FIXED and i >= 3)
    defaults = dict(
        initial_poses=(0.0,) * n_act,
        kp=kp,
        kd=kd,
        max_force=max_force,
        dt=2e-3,
        start_base_position=(0.0, 0.0, 0.0),  # the URDF's rest pose stands
        skip_links=3,  # x, z prismatic + y revolute passive base
    )
    defaults.update(kwargs)
    return model, geoms, defaults


class HopperEnv(LocomotionEnv):
    """kp=50, kd=1, max_force=30, dt=2e-3, the base chain's 3 links not
    PD-driven. Runs on the CUDA device unless ``device`` names another, in
    ``dtype`` (float32 by default; the CPU tests pass float64)."""

    TORSO_REST_Z = 1.05  # torso capsule center at q = 0 (FK of the URDF)

    def __init__(self, urdf: str = "hopper_link0_1.urdf", dtype: torch.dtype = torch.float32, device=None, **kwargs):
        model, geoms, args = _planar_env_args(urdf, 50.0, 1.0, 30.0, kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **args)

    def reward_done(self, q_prev, qd_prev, q, qd):
        # q layout: [x, z, pitch, joints...]
        vel_x = (q[..., 0] - q_prev[..., 0]) / self.dt
        height = q[..., 1] + self.TORSO_REST_Z
        pitch = q[..., 2]
        done = (height < 0.7) | (pitch.abs() > 1.0)
        reward = torch.where(done, 0.0, vel_x + 1.0)
        return reward, done


class HalfCheetahEnv(LocomotionEnv):
    """kp=60, kd=1.5, max_force=60, dt=2e-3, the base chain's 3 links not
    PD-driven; reward = forward velocity, done when the torso is below
    0.3 m. Device and dtype as the hopper's."""

    TORSO_REST_Z = 0.7

    def __init__(self, urdf: str = "cheetah_link0_1.urdf", dtype: torch.dtype = torch.float32, device=None, **kwargs):
        model, geoms, args = _planar_env_args(urdf, 60.0, 1.5, 60.0, kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **args)

    def reward_done(self, q_prev, qd_prev, q, qd):
        vel_x = (q[..., 0] - q_prev[..., 0]) / self.dt
        done = q[..., 1] + self.TORSO_REST_Z < 0.3
        reward = torch.where(done, 0.0, vel_x)
        return reward, done
