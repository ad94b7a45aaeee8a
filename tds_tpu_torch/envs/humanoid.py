"""Humanoid locomotion env with a spherical base joint (counterpart of
tds_tpu/envs/humanoid.py)."""

import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.envs.locomotion import LocomotionEnv
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.urdf.cache import construct


class HumanoidEnv(LocomotionEnv):
    """kp=50, kd=1.5, max_force=50, dt=1e-3, start z=1.4; reward = torso x
    while upright, done when up.z < 0.6 or torso z < 0.8.

    ``humanoid_xyz_spherical.urdf`` emulates the floating base with 3
    prismatic joints and a spherical one (q[3:7], an xyzw quaternion), all
    passive (``skip_links=4``); the 21 revolute joints take the actions.
    Its 19 collision geoms (16 capsules and 3 spheres) give 35 plane
    candidates, and the solver keeps them all (``top_k=0``, the JAX
    package's default): a 105-row contact MLCP.

    The five shaping knobs, off by default (the reference reward), add
    ``height_bonus * (z - 1)``, ``- crouch_penalty * max(crouch_ref - z,
    0)``, ``- z_damping * qd[2]**2`` and ``alive_bonus`` to the reward of a
    live step.

    Runs on the CUDA device unless ``device`` names another, in ``dtype``
    (float32 by default, the card's type; the CPU tests pass float64)."""

    def __init__(
        self,
        urdf: str = "humanoid_xyz_spherical.urdf",
        is_floating: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        height_bonus: float = 0.0,
        crouch_penalty: float = 0.0,
        crouch_ref: float = 1.2,
        z_damping: float = 0.0,
        alive_bonus: float = 0.0,
        **kwargs,
    ):
        self.height_bonus = float(height_bonus)
        self.crouch_penalty = float(crouch_penalty)
        self.crouch_ref = float(crouch_ref)
        self.z_damping = float(z_damping)
        self.alive_bonus = float(alive_bonus)
        model, geoms = construct(urdf, is_floating=is_floating)
        n_base_links = 0 if is_floating else (4 if "spherical" in urdf else 6)
        n_single = sum(
            1
            for i, jt in enumerate(model.joint_types)
            if jt not in (JointType.FIXED, JointType.SPHERICAL) and i >= n_base_links
        )
        defaults = dict(
            initial_poses=(0.0,) * n_single,
            kp=50.0,
            kd=1.5,
            max_force=50.0,
            dt=1e-3,
            start_base_position=(0.0, 0.0, 1.4),
            skip_links=n_base_links,
            solver=ContactSolverParams(top_k=0),
        )
        defaults.update(kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **defaults)

    def reward_done(self, q_prev, qd_prev, q, qd):
        pos, up = self.base_pose_xyz_rpy(q)
        done = (up < 0.6) | (pos[..., 2] < 0.8)
        reward = pos[..., 0]
        if self.height_bonus:
            reward = reward + self.height_bonus * (pos[..., 2] - 1.0)
        if self.crouch_penalty:
            reward = reward - self.crouch_penalty * (self.crouch_ref - pos[..., 2]).clamp_min(0.0)
        if self.z_damping:
            # qd[2]: the rate of the base's z prismatic joint
            reward = reward - self.z_damping * qd[..., 2] ** 2
        if self.alive_bonus:
            reward = reward + self.alive_bonus
        return torch.where(done, 0.0, reward), done
