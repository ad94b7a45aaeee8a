"""Locomotion environment over a URDF robot and a ground plane (counterpart
of tds_tpu/envs/locomotion.py), on batched tensors.

Per control step: PD(initial poses + clipped action) -> ABA -> velocity
half-step -> contact impulses -> position update, with observation
[q, qd]. Fixed-base variants emulate the floating base with 3 prismatic +
3 revolute passive joints (the *_xyz_xyzrot URDFs) that the PD loop skips.

``fused_step=True`` picks the fused step kernel K2 for the whole control
step (``envs/fused_step.py``), as ``ContactSolverParams(pgs_impl=
"pallas")`` picks the JAX package's kernel path: the constructor packs the
kernel's operands once, and every ``sim_step`` (reset's settle steps too)
launches K2 on the card and runs its plain version on the CPU. An env the
kernel does not handle raises at construction.

Not ported yet (they raise NotImplementedError): floating bases, the
spring contact model, terrain, ``height_scan`` and ``reset_pool``.
"""

from typing import Optional, Sequence

import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.control.pd import pd_tau
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics_from_kin
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.envs.base import Env, EnvState
from tds_tpu_torch.envs.fused_step import check_instance, mega_step, pack_step_params
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant, resolve_device
from tds_tpu_torch.world import build_world, make_ground_plane, resolve_contacts


class LocomotionEnv(Env):
    """``model`` is moved to ``device`` (None: the CUDA device, raising when
    there is none) in ``dtype`` (None: the model's own); ``fused_step``
    picks K2 for the control step."""

    def __init__(
        self,
        model: MultiBodyModel,
        geoms,
        initial_poses: Sequence[float],
        kp: float,
        kd: float,
        max_force: float,
        dt: float = 1e-3,
        start_base_position=(0.0, 0.0, 0.48),
        action_limit: float = 0.4,
        reset_noise: float = 0.05,
        settle_steps: int = 10,
        gravity=(0.0, 0.0, -9.81),
        solver: ContactSolverParams = ContactSolverParams(),
        contact_model: str = "mlcp",
        skip_links: Optional[int] = None,
        terrain=None,
        height_scan=None,
        reset_pool=None,
        device=None,
        dtype: Optional[torch.dtype] = None,
        fused_step: bool = False,
    ):
        for name, value in (("terrain", terrain), ("height_scan", height_scan), ("reset_pool", reset_pool)):
            if value is not None:
                raise NotImplementedError(f"{name} is not ported to tds_tpu_torch yet")
        if model.is_floating:
            raise NotImplementedError("floating bases are not ported to tds_tpu_torch yet")
        self.device = resolve_device(device)
        self.dtype = dtype or model.dtype
        self.model = model.to(self.device, self.dtype)
        self.dt = dt
        self.kp = kp
        self.kd = kd
        self.max_force = max_force
        self.action_limit = action_limit
        self.reset_noise = reset_noise
        self.settle_steps = settle_steps
        self.start_base_position = tuple(start_base_position)
        self.gravity = torch.tensor(gravity, dtype=self.dtype, device=self.device)
        self.initial_poses = torch.tensor(initial_poses, dtype=self.dtype, device=self.device)
        self.action_dim = len(initial_poses)
        self.observation_dim = model.dof_q + model.dof_qd
        self.skip_links = 6 if skip_links is None else skip_links
        plane_model, plane_geoms = make_ground_plane(dtype=self.dtype, device=self.device)
        self.world = build_world(
            [(plane_model, plane_geoms), (self.model, tuple(geoms))],
            solver=solver,
            contact_model=contact_model,
        )
        self.step_params = None
        if fused_step:
            params = pack_step_params(self)
            check_instance(params, self.model.dof_qd)
            self.step_params = params

    # -- dynamics ----------------------------------------------------------
    def sim_step(self, q, qd, action):
        """One control step on (B, dof_q), (B, dof_qd), (B, action_dim)."""
        if self.step_params is not None:
            return mega_step(self.step_params, q, qd, action.contiguous())
        clipped = action.clamp(-self.action_limit, self.action_limit)
        targets = self.initial_poses + clipped
        tau = pd_tau(self.model, q, qd, targets, self.kp, self.kd, self.max_force, skip_links=self.skip_links)
        # one FK pass and one articulated factor shared by ABA and the
        # contact solver's O(n) M^-1 J^T
        kin = fk_links(self.model, q, qd)
        factor = aba_factor(self.model, kin)
        qdd = forward_dynamics_from_kin(self.model, kin, q, qd, tau, self.gravity, factor=factor)
        qd = integrate_euler_qdd(self.model, q, qd, qdd, self.dt)
        zero = q.new_zeros(q.shape[:-1] + (0,))
        qd = resolve_contacts(self.world, (zero, q), (zero, qd), self.dt, kins=[None, kin], factors=[None, factor])[1]
        return integrate_q(self.model, q, qd, self.dt)

    def observation(self, q, qd):
        return torch.cat([q, qd], dim=-1)

    # -- env API -----------------------------------------------------------
    def pd_q_indices(self):
        """q slots of the PD-controlled 1-DoF joints, in pose-vector order."""
        out = []
        for i in range(self.skip_links, self.model.num_links):
            jt = JointType(self.model.joint_types[i])
            if jt == JointType.SPHERICAL:
                raise NotImplementedError("spherical joints are not ported to tds_tpu_torch yet")
            if jt != JointType.FIXED:
                out.append(self.model.q_offsets[i])
        assert len(out) == self.action_dim, (len(out), self.action_dim)
        return tuple(out)

    def _set_joint_poses(self, q, poses):
        """Scatter the compact pose vector (B, action_dim) into q."""
        return q.index_copy(-1, constant(self.pd_q_indices(), torch.long, q.device), poses)

    def draw_reset_noise(self, generator: Optional[torch.Generator] = None, batch_size: int = 1):
        """(B, action_dim) joint noise, uniform in +-reset_noise, drawn from
        ``generator`` on the generator's device and moved to the env's."""
        gen_device = generator.device if generator is not None else self.device
        u = torch.rand((batch_size, self.action_dim), generator=generator, dtype=self.dtype, device=gen_device)
        return (-self.reset_noise + 2.0 * self.reset_noise * u).to(self.device)

    def initial_state(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, noise=None):
        """Standing start with uniform joint noise in +-reset_noise.

        The noise is drawn from ``generator`` (:meth:`draw_reset_noise`), or
        given as an explicit (B, action_dim) ``noise`` tensor, so a test can
        feed the draws of another implementation."""
        if noise is None:
            noise = self.draw_reset_noise(generator, batch_size)
        noise = noise.to(self.device, self.dtype)
        q = self.model.zero_q(noise.shape[:-1])
        n_base = min(3, self.pd_q_indices()[0])
        q[..., :n_base] = constant(self.start_base_position[:n_base], self.dtype, self.device)
        q = self._set_joint_poses(q, self.initial_poses + noise)
        return q, self.model.zero_qd(noise.shape[:-1])

    def reset(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, noise=None):
        """initial_state followed by the settle steps with zero action, one
        :func:`~tds_tpu_torch.utils.graphs.scan` (replayed CUDA graphs on
        the card). The noise is drawn before the scan, so a graph holds no
        random op."""
        q, qd = self.initial_state(generator, batch_size, noise)

        def settle(carry, consts):
            return self.sim_step(*carry, *consts)

        zero_action = q.new_zeros(q.shape[:-1] + (self.action_dim,))
        q, qd = scan(settle, (q, qd), (zero_action,), self.settle_steps, key=("settle", self))
        t = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
        return EnvState(q=q, qd=qd, t=t), self.observation(q, qd)

    def step(self, state: EnvState, action):
        q, qd = self.sim_step(state.q, state.qd, action)
        reward, done = self.reward_done(state.q, state.qd, q, qd)
        return EnvState(q=q, qd=qd, t=state.t + 1), self.observation(q, qd), reward, done

    # -- per-robot specialization -----------------------------------------
    def base_pose_xyz_rpy(self, q):
        """(base position (B, 3), up.z (B,)) of the xyz_xyzrot emulation
        chain, where q[3:6] holds roll, pitch, yaw."""
        jt = tuple(int(t) for t in self.model.joint_types[:4])
        if len(jt) == 4 and jt[3] == JointType.SPHERICAL and jt[:3] == (0, 1, 2):
            raise NotImplementedError("the xyz_spherical emulated base is not ported to tds_tpu_torch yet")
        # (Rz(yaw) Ry(pitch) Rx(roll))[2, 2] = cos(pitch) cos(roll)
        up = q[..., 4].cos() * q[..., 3].cos()
        return q[..., 0:3], up

    def reward_done(self, q_prev, qd_prev, q, qd):
        raise NotImplementedError
