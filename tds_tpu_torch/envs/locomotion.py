"""Locomotion environment over a URDF robot and a ground plane (counterpart
of tds_tpu/envs/locomotion.py), on batched tensors.

Per control step: PD(initial poses + clipped action) -> ABA -> velocity
half-step -> contact impulses -> position update, with observation
[q, qd]. A floating base (``is_floating=True`` on the URDF) carries its
pose in q[0:7], [qx, qy, qz, qw, x, y, z], and its twist in qd[0:6]; every
joint is PD-controlled (``skip_links`` 0) and the standing start draws no
joint noise, as in the JAX package. Fixed-base variants emulate the
floating base with passive joints that the PD loop skips: 3 prismatic + 3
revolute (the *_xyz_xyzrot URDFs) or 3 prismatic + 1 spherical (the
humanoid's xyz_spherical URDF, whose q[3:7] is the base's xyzw quaternion,
so q and qd differ in length).

``fused_step=True`` picks the fused step kernel K2 for the whole control
step (``envs/fused_step.py``), as ``ContactSolverParams(pgs_impl=
"pallas")`` picks the JAX package's kernel path: the constructor packs the
kernel's operands once, and every ``sim_step`` (reset's settle steps too)
launches K2 on the card and runs its plain version on the CPU. An env the
kernel does not handle (a terrain among them) raises at construction.

``terrain`` puts a ``Heightfield`` or a ``Mesh`` on the ground in place of
the plane; ``height_scan`` adds the terrain's height under egocentric scan
points to the observation; ``reset_pool`` makes ``reset`` start from pool
states with probability ``reset_pool_prob``. ``contact_model="spring"``
puts the world on the spring-damper contact (no LCP, so no K1; K2
refuses it), and ``solver``'s ``minv_method="crba"`` and
``delassus_dtype="bf16"`` pass through to the MLCP.
"""

from typing import Optional, Sequence

import torch

from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.collision.narrowphase import heightfield_height
from tds_tpu_torch.collision.raycast import ray_mesh
from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.control.pd import pd_tau
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics_from_kin
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.envs.base import Env, EnvState
from tds_tpu_torch.envs.fused_step import check_instance, mega_step, pack_step_params
from tds_tpu_torch.model.geometry import GeomAttachment, Heightfield
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant, resolve_device
from tds_tpu_torch.world import build_world, make_ground_plane, resolve_contacts


_EYE = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


class LocomotionEnv(Env):
    """``model`` is moved to ``device`` (None: the CUDA device, raising when
    there is none) in ``dtype`` (None: the model's own); ``fused_step``
    picks K2 for the control step.

    ``terrain``: a ``Heightfield`` or a ``Mesh`` with ``max_contacts > 0``
    on the ground in place of the plane. ``height_scan``: (x, y) offsets in
    the base's yawed frame; the terrain's height under each, less the
    base's height, joins the observation (needs a terrain). ``reset_pool``:
    (q (P, dof_q), qd (P, dof_qd)) states; with probability
    ``reset_pool_prob`` ``reset`` replaces the settled state of an env by a
    pool state with its base x set to 0 (a training-only start: an eval
    env takes none)."""

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
        reset_pool_prob: float = 0.5,
        device=None,
        dtype: Optional[torch.dtype] = None,
        fused_step: bool = False,
    ):
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
        if skip_links is None:
            skip_links = 0 if model.is_floating else 6
        self.skip_links = skip_links
        # the ground in the env's dtype and on its device: a terrain's
        # narrowphase works in the dtype of the ground's transform
        plane_model, plane_geoms = make_ground_plane(dtype=self.dtype, device=self.device)
        if terrain is not None:
            plane_geoms = (GeomAttachment(link_index=-1, shape=terrain),)
        self.terrain = terrain
        self.world = build_world(
            [(plane_model, plane_geoms), (self.model, tuple(geoms))],
            solver=solver,
            contact_model=contact_model,
        )
        self.height_scan = None
        if height_scan is not None:
            if terrain is None:
                raise ValueError("height_scan requires terrain=Mesh(...)")
            self.height_scan = constant(tuple((float(x), float(y)) for x, y in height_scan), self.dtype, self.device)
            self.observation_dim += len(height_scan)
        self.reset_pool = None
        self.reset_pool_prob = float(reset_pool_prob)
        if reset_pool is not None:
            pool_q, pool_qd = (torch.as_tensor(p, dtype=self.dtype, device=self.device) for p in reset_pool)
            if pool_q.ndim != 2 or pool_q.shape[1] != model.dof_q or pool_qd.shape != (pool_q.shape[0], model.dof_qd):
                raise ValueError(
                    f"reset_pool holds q {tuple(pool_q.shape)} and qd {tuple(pool_qd.shape)}, expected (P, {model.dof_q}) "
                    f"and (P, {model.dof_qd})"
                )
            self.reset_pool = (pool_q, pool_qd)
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
        """[q, qd], and the scan heights with a ``height_scan``."""
        if self.height_scan is None:
            return torch.cat([q, qd], dim=-1)
        return torch.cat([q, qd, self._scan_heights(q)], dim=-1)

    def _base_yaw(self, q):
        """The yaw of a floating base's quaternion; on a fixed base q[..., 5],
        the yaw of the xyz_xyzrot emulation chain, whatever the base chain
        is (as the JAX package reads it)."""
        if self.model.is_floating:
            x, y, z, w = q[..., 0:4].unbind(-1)
            return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
        return q[..., 5]

    def _scan_heights(self, q):
        """(B, S) terrain height under each scan point less the base's
        height, clipped to +-10: the exact surface of a ``Heightfield``;
        for a ``Mesh`` vertical rays from z = 100 down 200, whose misses
        (fraction BIG) read as -10."""
        pos, _ = self.base_pose_xyz_rpy(q)
        ox, oy = self.height_scan[:, 0], self.height_scan[:, 1]
        yaw = self._base_yaw(q)
        c, s = yaw.cos()[..., None], yaw.sin()[..., None]
        xy = pos[..., None, :2] + torch.stack([c * ox - s * oy, s * ox + c * oy], dim=-1)  # (B, S, 2)
        if isinstance(self.terrain, Heightfield):
            height = heightfield_height(self.terrain, xy[..., 0], xy[..., 1])
        else:
            top, span = 100.0, 200.0
            origins = torch.cat([xy, torch.full_like(xy[..., :1], top)], dim=-1)
            targets = torch.cat([xy, torch.full_like(xy[..., :1], top - span)], dim=-1)
            identity = Transform(pos=constant((0.0,) * 3, q.dtype, q.device), rot=constant(_EYE, q.dtype, q.device))
            frac, _ = ray_mesh(origins, targets, self.terrain, identity)
            height = top - frac * span
        return (height - pos[..., None, 2]).clamp(-10.0, 10.0)

    # -- env API -----------------------------------------------------------
    def pd_q_indices(self):
        """q slots of the PD-controlled 1-DoF joints, in pose-vector order
        (a spherical joint keeps its quaternion and takes no pose entry)."""
        out = []
        for i in range(self.skip_links, self.model.num_links):
            jt = JointType(self.model.joint_types[i])
            if jt not in (JointType.FIXED, JointType.SPHERICAL):
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
        feed the draws of another implementation. A floating base starts at
        ``start_base_position`` (q[4:7]) with the initial poses and no noise
        (the JAX package's floating start ignores its key): neither the
        generator nor ``noise`` (whose rows give the batch) moves it."""
        if noise is None:
            noise = self.draw_reset_noise(generator, batch_size)
        noise = noise.to(self.device, self.dtype)
        q = self.model.zero_q(noise.shape[:-1])
        start = constant(self.start_base_position, self.dtype, self.device)
        if self.model.is_floating:
            q[..., 4:7] = start
            q = self._set_joint_poses(q, self.initial_poses.expand(noise.shape))
        else:
            n_base = min(3, self.pd_q_indices()[0])
            q[..., :n_base] = start[:n_base]
            q = self._set_joint_poses(q, self.initial_poses + noise)
        return q, self.model.zero_qd(noise.shape[:-1])

    def draw_reset_pool(self, generator: Optional[torch.Generator] = None, batch_size: int = 1):
        """(use (B,) bool, index (B,) int64): whether each env's reset starts
        from the pool (probability ``reset_pool_prob``) and from which
        state, drawn from ``generator`` on its device and moved to the
        env's."""
        gen_device = generator.device if generator is not None else self.device
        use = torch.rand(batch_size, generator=generator, dtype=torch.float64, device=gen_device) < self.reset_pool_prob
        idx = torch.randint(self.reset_pool[0].shape[0], (batch_size,), generator=generator, device=gen_device)
        return use.to(self.device), idx.to(self.device)

    def reset(self, generator: Optional[torch.Generator] = None, batch_size: int = 1, noise=None, pool_draws=None):
        """initial_state followed by the settle steps with zero action, one
        :func:`~tds_tpu_torch.utils.graphs.scan` (replayed CUDA graphs on
        the card); then, with a ``reset_pool``, the pool states where
        ``pool_draws`` = (use, index) says so, drawn from ``generator``
        when not given (:meth:`draw_reset_pool`; a test feeds another
        implementation's). Every draw is made outside the scan, so a graph
        holds no random op."""
        q, qd = self.initial_state(generator, batch_size, noise)

        def settle(carry, consts):
            return self.sim_step(*carry, *consts)

        zero_action = q.new_zeros(q.shape[:-1] + (self.action_dim,))
        q, qd = scan(settle, (q, qd), (zero_action,), self.settle_steps, key=("settle", self))
        if self.reset_pool is not None:
            use, idx = self.draw_reset_pool(generator, q.shape[0]) if pool_draws is None else pool_draws
            use = use.to(self.device)[:, None]
            pool_q, pool_qd = (p.index_select(0, idx.to(self.device)) for p in self.reset_pool)
            pool_q[:, 4 if self.model.is_floating else 0] = 0.0  # translated back to the origin in x
            q, qd = torch.where(use, pool_q, q), torch.where(use, pool_qd, qd)
        t = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
        return EnvState(q=q, qd=qd, t=t), self.observation(q, qd)

    def step(self, state: EnvState, action):
        q, qd = self.sim_step(state.q, state.qd, action)
        reward, done = self.reward_done(state.q, state.qd, q, qd)
        return EnvState(q=q, qd=qd, t=state.t + 1), self.observation(q, qd), reward, done

    # -- per-robot specialization -----------------------------------------
    def base_pose_xyz_rpy(self, q):
        """(base position (B, 3), up.z (B,)): a floating base's q[4:7] and
        R(q[0:4])[2, 2]; on the emulation chains, q[0:3] and R[2, 2] of
        roll, pitch, yaw in q[3:6] on the xyz_xyzrot base, of the base's
        xyzw quaternion q[3:7] on the xyz_spherical one."""
        if self.model.is_floating:
            return q[..., 4:7], _quaternion_up_z(q[..., 0:4])
        jt = tuple(int(t) for t in self.model.joint_types[:4])
        if len(jt) == 4 and jt[3] == JointType.SPHERICAL and jt[:3] == (0, 1, 2):
            up = _quaternion_up_z(q[..., 3:7])
        else:
            # (Rz(yaw) Ry(pitch) Rx(roll))[2, 2] = cos(pitch) cos(roll)
            up = q[..., 4].cos() * q[..., 3].cos()
        return q[..., 0:3], up

    def reward_done(self, q_prev, qd_prev, q, qd):
        raise NotImplementedError


def _quaternion_up_z(quat):
    """R[2, 2] of ``quaternion.to_matrix(quat)``, in its order of operations."""
    x, y, z, w = quat.unbind(-1)
    s = 2.0 / (x * x + y * y + z * z + w * w)
    return 1.0 - (x * (x * s) + y * (y * s))
