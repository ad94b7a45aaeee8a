"""Ant locomotion env (counterpart of tds_tpu/envs/ant.py)."""

import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.envs.locomotion import LocomotionEnv
from tds_tpu_torch.urdf.cache import construct

ANT_INITIAL_POSES = (0.0, -0.5) * 4  # hip, knee x 4 legs


class AntEnv(LocomotionEnv):
    """kp=15, kd=0.3, max_force=3, dt=0.01, start z=0.48; reward = forward
    base velocity, done when z < 0.26.

    The solver keeps the 8 deepest of the 17 plane candidates (8 capsules x
    2 endpoint probes + the torso sphere), so the contact MLCP has 24 rows
    and not 51.

    Runs on the CUDA device unless ``device`` names another, in ``dtype``
    (float32 by default, the card's type; the CPU tests pass float64)."""

    def __init__(
        self,
        urdf: str = "gym/ant_org_xyz_xyzrot.urdf",
        is_floating: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        **kwargs,
    ):
        model, geoms = construct(urdf, is_floating=is_floating)
        defaults = dict(
            initial_poses=ANT_INITIAL_POSES,
            kp=15.0,
            kd=0.3,
            max_force=3.0,
            dt=0.01,
            start_base_position=(0.0, 0.0, 0.48),
            solver=ContactSolverParams(top_k=8),
        )
        defaults.update(kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **defaults)

    def reward_done(self, q_prev, qd_prev, q, qd):
        pos_prev, _ = self.base_pose_xyz_rpy(q_prev)
        pos, _ = self.base_pose_xyz_rpy(q)
        vel_x = (pos[..., 0] - pos_prev[..., 0]) / self.dt
        done = pos[..., 2] < 0.26
        reward = torch.where(done, 0.0, vel_x)
        return reward, done
