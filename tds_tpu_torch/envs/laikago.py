"""Laikago quadruped locomotion env (counterpart of tds_tpu/envs/laikago.py)."""

import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.envs.locomotion import LocomotionEnv
from tds_tpu_torch.urdf.cache import construct

LAIKAGO_INITIAL_POSES = (0.2, 0.0, -0.7) * 4  # abduction, hip, knee x 4 legs


class LaikagoEnv(LocomotionEnv):
    """kp=100, kd=2, max_force=50, dt=1e-3, start z=0.48; reward = base x
    position, done when up.z < 0.6 or z < 0.2.

    On a ``terrain`` the solver keeps the 8 deepest candidates
    (``ContactSolverParams(top_k=8)``, 24 MLCP rows) unless ``solver`` is
    given: 4 toes against ``max_contacts`` cells each, of which about 2 a
    toe penetrate at once.

    Runs on the CUDA device unless ``device`` names another, in ``dtype``
    (float32 by default, the card's type; the CPU tests pass float64)."""

    def __init__(
        self,
        urdf: str = "laikago/laikago_toes_zup_xyz_xyzrot.urdf",
        is_floating: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        **kwargs,
    ):
        model, geoms = construct(urdf, is_floating=is_floating)
        defaults = dict(
            initial_poses=LAIKAGO_INITIAL_POSES,
            kp=100.0,
            kd=2.0,
            max_force=50.0,
            dt=1e-3,
            start_base_position=(0.0, 0.0, 0.48),
        )
        if kwargs.get("terrain") is not None and "solver" not in kwargs:
            defaults["solver"] = ContactSolverParams(top_k=8)
        defaults.update(kwargs)
        super().__init__(model, geoms, device=device, dtype=dtype, **defaults)

    def reward_done(self, q_prev, qd_prev, q, qd):
        pos, up = self.base_pose_xyz_rpy(q)
        done = (up < 0.6) | (pos[..., 2] < 0.2)
        reward = torch.where(done, 0.0, pos[..., 0])
        return reward, done
