"""The whole-body MPC locomotion controller, trot walking (counterpart of
tds_tpu/control/mpc/locomotion.py; the reference's laikago_tds_mpc.cpp):
gait scheduler -> COM velocity window -> Raibert swing targets (per-leg
IK, joint PD) and convex-MPC stance forces (J^T torques), combined per
leg by the desired gait state, then ``control_every`` physics substeps.

Batched over a leading axis of envs; each env's tick is what
``jax.vmap`` of the JAX package's tick computes. :func:`make_walk_step`
returns the tick as one ``graphs.scan`` body: on the card a whole tick,
controller and substeps, is one replayed CUDA graph, and its contact
solves run K1 (through ``world.resolve_contacts``).

The per-leg IK is a fixed number of damped Gauss-Newton iterations over
each leg's 3 joints, all legs on one FK pass an iteration; it computes
only the leg's 3 Jacobian columns, which are the full point Jacobian's,
and after the first iteration only the transforms of the links below a
leg joint (the others do not move). A tick's FK at q is computed once and
shared by the feet, the IK's first iteration and the stance torques.
"""

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tds_tpu_torch.algebra import rotation
from tds_tpu_torch.algebra.linalg import inv3
from tds_tpu_torch.algebra.spatial import cross, matTvec, matvec
from tds_tpu_torch.control.mpc.convex_mpc import MpcConfig, compute_contact_forces
from tds_tpu_torch.control.mpc.gait import (
    EARLY_CONTACT, STANCE, SWING, GaitConfig, VelocityFilterState, gait_update,
)
from tds_tpu_torch.control.mpc.stance_leg import stance_torques_from_forces
from tds_tpu_torch.control.mpc.swing_leg import (
    SwingLegState, raibert_foot_targets, swing_foot_positions, swing_leg_update,
)
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics_from_kin
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links, forward_kinematics_q
from tds_tpu_torch.model.joints import JointType, jcalc_transform, qd_width
from tds_tpu_torch.model.multibody import MultiBodyModel
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant_like
from tds_tpu_torch.world import resolve_contacts


class LocomotionMpcConfig(NamedTuple):
    mpc: MpcConfig
    gait: GaitConfig
    desired_speed: Tuple[float, float, float] = (0.4, 0.0, 0.0)
    desired_twisting_speed: float = 0.0
    desired_height: float = 0.42
    foot_clearance: float = 0.01
    swing_kp: float = 100.0
    swing_kd: float = 1.0
    max_torque: float = 50.0
    ik_iterations: int = 6
    ik_damping: float = 0.02
    contact_height_threshold: float = 0.035  # the toe sphere's radius and a margin
    velocity_filter_window: int = 4  # control ticks
    # seconds the gait clock advances a tick; make_walk_step sets it to
    # env.dt * control_every
    control_dt: float = 0.001


class LocomotionMpcState(NamedTuple):
    time: torch.Tensor  # (B,)
    swing: SwingLegState
    vel_filter: VelocityFilterState

    def flat(self):
        """The state as a flat tuple of tensors (a scan's carry)."""
        return (self.time, *self.swing, *self.vel_filter)

    @staticmethod
    def unflat(tensors):
        time, last, latched, buffer, count = tensors
        return LocomotionMpcState(time, SwingLegState(last, latched), VelocityFilterState(buffer, count))


def _leg_chains(model: MultiBodyModel, toe_links, num_passive):
    """For each toe, its 1-DoF ancestor links above the passive chain,
    root first."""
    legs = []
    for toe in toe_links:
        chain, li = [], toe
        while li >= num_passive:
            if qd_width(JointType(model.joint_types[li])) == 1:
                chain.append(li)
            li = model.parents[li]
        legs.append(tuple(reversed(chain)))
    return tuple(legs)


def leg_structure(model: MultiBodyModel, toe_links: Sequence[int], num_passive=6):
    """Each leg's actuated qd indices, root first: the 1-DoF ancestors of
    its toe above the passive base-emulation chain."""
    return tuple(tuple(model.qd_offsets[li] for li in chain) for chain in _leg_chains(model, toe_links, num_passive))


def hip_positions_base_frame(model: MultiBodyModel, toe_links, num_passive=6):
    """(num_legs, 3) numpy: each leg's top link's origin in the base frame
    at the zero pose, computed in the model's dtype."""
    _, lxw, _ = forward_kinematics_q(model, model.zero_q())
    hips = []
    for toe in toe_links:
        li, top = toe, toe
        while li >= num_passive:
            top = li
            li = model.parents[li]
        hips.append(lxw[top].pos.detach().cpu().double().numpy())
    return np.stack(hips)


class LocomotionMpcController:
    """(state, q, qd) -> (state', tau_actuated) ticks for a fixed-base
    *_xyz_xyzrot quadruped (6 passive DoFs, then the leg joints), on a
    batch of envs."""

    def __init__(self, model: MultiBodyModel, toe_links, config: LocomotionMpcConfig):
        self.model = model
        self.toe_links = tuple(toe_links)
        self.config = config
        self.leg_qd = leg_structure(model, self.toe_links)
        self._leg_links = _leg_chains(model, self.toe_links, 6)
        self.hip_positions = hip_positions_base_frame(model, self.toe_links)
        self.num_legs = len(self.toe_links)
        self._joints = tuple(j for leg in self.leg_qd for j in leg)
        self._joint_leg = tuple(leg for leg, js in enumerate(self.leg_qd) for _ in js)
        leg_links = {li for chain in self._leg_links for li in chain}
        moving = []
        for i, parent in enumerate(model.parents):
            if i in leg_links or parent in moving:
                moving.append(i)
        self._moving = tuple(moving)  # the links a leg joint moves, parents first

    # -- state ------------------------------------------------------------
    def init_state(self, q, dtype=None) -> LocomotionMpcState:
        """The state at time 0 for a batch of poses q (B, dof_q)."""
        dtype = dtype or q.dtype
        feet = self._feet_base(q).to(dtype)
        return LocomotionMpcState(
            time=torch.zeros(q.shape[:-1], dtype=dtype, device=q.device),
            swing=SwingLegState.create(self.config.gait.initial_leg_state, feet),
            vel_filter=VelocityFilterState.create(self.config.velocity_filter_window, dtype, q.device, q.shape[:-1]),
        )

    # -- frames (the fixed-base xyz_xyzrot emulation layout) -------------
    def _base_pose(self, q):
        return q[..., 0:3], rotation.from_rpy(q[..., 3], q[..., 4], q[..., 5])

    def _feet_world(self, q, lxw=None):
        if lxw is None:
            _, lxw, _ = forward_kinematics_q(self.model, q)
        return torch.stack([lxw[link].pos for link in self.toe_links], dim=-2)

    def _feet_base(self, q):
        pos, rot = self._base_pose(q)
        return (self._feet_world(q) - pos[..., None, :]) @ rot

    # -- per-leg IK --------------------------------------------------------
    def _legs_ik(self, q, targets_world, fk):
        """``ik_iterations`` damped Gauss-Newton steps on each leg's 3
        joints toward its target (B, num_legs, 3); ``fk`` is
        ``forward_kinematics_q`` at q."""
        lam2 = self.config.ik_damping**2
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        index = constant_like(self._joints, q, torch.int64)
        base_x, lxw = fk[0], list(fk[1])
        for k in range(self.config.ik_iterations):
            if k:
                self._move_legs(q, base_x, lxw)
            feet = torch.stack([lxw[toe].pos for toe in self.toe_links], dim=-2)
            jac = torch.stack([self._leg_jacobian(lxw, links, feet[..., leg, :])
                               for leg, links in enumerate(self._leg_links)], dim=-3)  # (B, legs, 3, 3)
            jt = jac.transpose(-1, -2)
            dq = matvec(inv3(jt @ jac + lam2 * eye), matvec(jt, targets_world - feet))
            q = q.index_add(-1, index, dq.flatten(-2))
        return q

    def _move_legs(self, q, base_x, lxw):
        """The world transforms of the links below a leg joint at q, in
        place in ``lxw`` (as ``forward_kinematics_q`` computes them)."""
        model = self.model
        for i in self._moving:
            x_parent = jcalc_transform(JointType(model.joint_types[i]), model.x_t(i), model.subspace(i), model.q_for_link(q, i))
            parent = model.parents[i]
            lxw[i] = (lxw[parent] if parent >= 0 else base_x).compose(x_parent)

    def _leg_jacobian(self, lxw, links, point):
        """The point Jacobian's columns (B, 3, 3) of a leg's joints."""
        cols = []
        for li in links:
            st = lxw[li].motion_to_parent(self.model.subspaces[li])
            cols.append(st[..., 3:6] - cross(point, st[..., 0:3]))
        return torch.stack(cols, dim=-1)

    # -- one control tick --------------------------------------------------
    def update(self, state: LocomotionMpcState, q, qd):
        """Returns (state', tau (B, dof_actuated - 6))."""
        cfg = self.config
        dtype = q.dtype
        pos, rot = self._base_pose(q)
        rpy = q[..., 3:6]
        lin_vel_world = qd[..., 0:3]
        ang_vel = qd[..., 3:6]

        fk = forward_kinematics_q(self.model, q)
        feet_world = self._feet_world(q, fk[1])
        feet_com_world = feet_world - pos[..., None, :]
        feet_base = feet_com_world @ rot
        contacts = feet_world[..., 2] < cfg.contact_height_threshold

        gait = gait_update(cfg.gait, state.time, contacts)
        vel_filter, com_vel_world = state.vel_filter.update(lin_vel_world)
        com_vel_body = matTvec(rot, com_vel_world)

        swing = swing_leg_update(state.swing, gait.desired_leg_state, feet_base)
        targets_base = raibert_foot_targets(
            com_vel_body,
            ang_vel[..., 2],
            constant_like(self.hip_positions, q),
            constant_like(cfg.gait.stance_duration, q),
            constant_like(tuple(cfg.desired_speed), q),
            cfg.desired_twisting_speed,
            cfg.desired_height - cfg.foot_clearance,
        )
        swing_pos_base = swing_foot_positions(swing, gait.normalized_phase, targets_base)
        swing_pos_world = swing_pos_base @ rot.transpose(-1, -2) + pos[..., None, :]

        # swing legs: IK, then joint PD
        index = constant_like(self._joints, q, torch.int64)
        q_des = self._legs_ik(q, swing_pos_world, fk)
        q_j, qd_j = q.index_select(-1, index), qd.index_select(-1, index)
        tau_swing = cfg.swing_kp * (q_des.index_select(-1, index) - q_j) - cfg.swing_kd * qd_j

        # stance legs: the convex MPC's ground forces through J^T
        in_stance = ((gait.leg_state == STANCE) | (gait.leg_state == EARLY_CONTACT)).to(dtype)
        zero3 = constant_like((0.0, 0.0, 0.0), q)
        forces = compute_contact_forces(
            cfg.mpc,
            com_position=pos,
            com_velocity=com_vel_world,
            com_rpy=rpy,
            com_angular_velocity=ang_vel,
            foot_contact_states=in_stance,
            foot_positions_body=feet_com_world,
            desired_com_position=constant_like((0.0, 0.0, cfg.desired_height), q),
            desired_com_velocity=constant_like(tuple(cfg.desired_speed), q),
            desired_com_rpy=zero3,
            desired_com_angular_velocity=constant_like((0.0, 0.0, cfg.desired_twisting_speed), q),
        )
        tau_stance = stance_torques_from_forces(self.model, q, self.toe_links, feet_world, forces, contact_mask=in_stance, fk=fk)

        # the hybrid per-leg combination, on the DESIRED state
        use_swing = (gait.desired_leg_state == SWING).to(dtype).index_select(-1, constant_like(self._joint_leg, q, torch.int64))
        tau = use_swing * tau_swing + (1.0 - use_swing) * tau_stance.index_select(-1, index)
        tau_full = torch.zeros_like(qd).index_copy(-1, index, tau).clamp(-cfg.max_torque, cfg.max_torque)
        new_state = LocomotionMpcState(time=state.time + cfg.control_dt, swing=swing, vel_filter=vel_filter)
        return new_state, tau_full[..., 6:]


def make_walk_step(env, controller: LocomotionMpcController, control_every: int = 5):
    """Returns ``step((ctrl_state, q, qd), ticks=1) -> (ctrl_state', q,
    qd)``: ``ticks`` control ticks, each a controller update and
    ``control_every`` physics substeps of ``env`` under its torques, as one
    ``graphs.scan`` (a CUDA graph a tick on the card, a Python loop on the
    CPU). Sets the controller's ``control_dt`` to env.dt * control_every,
    as the JAX package's does."""
    model = env.model
    tick_dt = float(env.dt) * control_every
    if abs(tick_dt - controller.config.control_dt) > 1e-12:
        controller.config = controller.config._replace(control_dt=tick_dt)

    def substep(q, qd, full_tau):
        kin = fk_links(model, q, qd)
        factor = aba_factor(model, kin)
        qdd = forward_dynamics_from_kin(model, kin, q, qd, full_tau, env.gravity, factor=factor)
        qd2 = integrate_euler_qdd(model, q, qd, qdd, env.dt)
        zero = q.new_zeros(q.shape[:-1] + (0,))
        qd3 = resolve_contacts(env.world, (zero, q), (zero, qd2), env.dt, kins=[None, kin], factors=[None, factor])[1]
        return integrate_q(model, q, qd3, env.dt)

    def tick(carry, consts):
        ctrl, q, qd = LocomotionMpcState.unflat(carry[:5]), carry[5], carry[6]
        ctrl, tau = controller.update(ctrl, q, qd)
        full_tau = torch.cat([tau.new_zeros(tau.shape[:-1] + (model.dof_actuated - tau.shape[-1],)), tau], dim=-1)
        for _ in range(control_every):
            q, qd = substep(q, qd, full_tau)
        return (*ctrl.flat(), q, qd)

    key = ("mpc walk", env, controller, control_every)

    def step(carry, ticks: int = 1):
        ctrl, q, qd = carry
        out = scan(tick, (*ctrl.flat(), q, qd), (), ticks, key=key)
        return LocomotionMpcState.unflat(out[:5]), out[5], out[6]

    return step
