"""The MIT-Cheetah convex MPC for a quadruped's stance forces
(counterpart of tds_tpu/control/mpc/convex_mpc.py; the reference's
osqp_mpc_controller.hpp; Di Carlo et al., IROS 2018), over a leading
batch of envs: each env's QP is its own, as ``jax.vmap`` of the JAX
function gives it.

- 13 states X = [rpy, pos, omega, v, -g], Xdot = A X + B u;
- the discretization exp([[A, B], [0, 0]] dt) as the order-6 truncated
  series (the JAX package's, not ``torch.linalg.matrix_exp``);
- the condensed QP over the horizon, min ||A_qp x0 + B_qp U - X_des||_Q^2
  + alpha ||U||^2 under each foot's friction pyramid, solved by 12 power
  iterations for the step and a fixed number of projected FISTA
  iterations. The (B, 12 h, 12 h) products are batched matrix products
  (``torch.bmm``); a gradient step y - step (P y + q) is one of them, with
  the symmetric (I - step P) formed once a solve and multiplied from the
  left by y^T. FISTA's momentum coefficients depend
  on the iteration alone, so they are computed once on the host in the
  working dtype. The port's rounding differs from the JAX package's there
  (1e-10 against ``jax.vmap`` of it in float64).
"""

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tds_tpu_torch.algebra.linalg import inv3
from tds_tpu_torch.algebra.spatial import cross_matrix, matvec
from tds_tpu_torch.control.mpc.gait import Values
from tds_tpu_torch.utils.tensors import constant_like

STATE_DIM = 13
# the reference's _MPC_WEIGHTS (torque_stance_leg_controller.py)
DEFAULT_WEIGHTS = (5.0, 5.0, 0.2, 0.0, 0.0, 10.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0)
POWER_ITERATIONS = 12


class MpcConfig(NamedTuple):
    mass: float
    inertia: Values  # (3, 3) body inertia
    num_legs: int = 4
    planning_horizon: int = 10
    timestep: float = 0.025
    qp_weights: Optional[Values] = None  # (13,)
    alpha: float = 1e-5
    friction_coeff: float = 0.45
    fz_min: float = 10.0
    fz_max: float = 210.0
    solver_iterations: int = 200


def _rpy_rate_matrix(yaw):
    """Rz(yaw)^T (B, 3, 3): world angular velocity to rpy rates, the MIT
    paper's yaw-only approximation."""
    c, s = yaw.cos(), yaw.sin()
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack(
        [torch.stack([c, s, z], dim=-1), torch.stack([-s, c, z], dim=-1), torch.stack([z, z, o], dim=-1)], dim=-2
    )


def calculate_a_mat(rpy):
    """A (B, 13, 13): omega to rpy rates, v to position, -g to vz."""
    batch = rpy.shape[:-1]
    a = rpy.new_zeros(batch + (STATE_DIM, STATE_DIM))
    a[..., 0:3, 6:9] = _rpy_rate_matrix(rpy[..., 2])
    a[..., 3:6, 9:12] = torch.eye(3, dtype=rpy.dtype, device=rpy.device)
    a[..., 11, 12].fill_(1.0)  # vz integrates -g (fill_: no host scalar copy inside a captured step)
    return a


def calculate_b_mat(inv_mass, inv_inertia_world, foot_positions):
    """B (B, 13, 3 num_legs): the torque rows I_w^-1 [r]x, the force rows
    1/m."""
    num_legs = foot_positions.shape[-2]
    b = foot_positions.new_zeros(foot_positions.shape[:-2] + (STATE_DIM, 3 * num_legs))
    eye = torch.eye(3, dtype=foot_positions.dtype, device=foot_positions.device)
    for leg in range(num_legs):
        b[..., 6:9, 3 * leg : 3 * leg + 3] = inv_inertia_world @ cross_matrix(foot_positions[..., leg, :])
        b[..., 9:12, 3 * leg : 3 * leg + 3] = inv_mass * eye
    return b


def discretize(a_mat, b_mat, dt, order: int = 6):
    """exp([[A, B], [0, 0]] dt) by its Taylor series to ``order``:
    (A_d, B_d)."""
    n, m = a_mat.shape[-1], b_mat.shape[-1]
    batch = a_mat.shape[:-2]
    ab = a_mat.new_zeros(batch + (n + m, n + m))
    ab[..., :n, :n] = a_mat * dt
    ab[..., :n, n:] = b_mat * dt
    eye = torch.eye(n + m, dtype=a_mat.dtype, device=a_mat.device)
    result = eye.expand(ab.shape)
    term = eye.expand(ab.shape)
    for k in range(1, order + 1):
        term = term @ ab / k
        result = result + term
    return result[..., :n, :n], result[..., :n, n:]


@functools.lru_cache(maxsize=None)
def _block_index(horizon: int):
    """(h, h) indices into [B_d, A B_d, ..., A^(h-1) B_d, 0]: block (i, j)
    of B_qp is A^(i-j) B_d for j <= i, else the zero block (index h)."""
    i, j = np.meshgrid(np.arange(horizon), np.arange(horizon), indexing="ij")
    return tuple(map(tuple, np.where(j <= i, i - j, horizon).tolist()))


def condensed_qp_mats(a_exp, b_exp, horizon: int):
    """A_qp (B, 13 h, 13), B_qp (B, 13 h, m h): the prediction matrices."""
    n, m = a_exp.shape[-1], b_exp.shape[-1]
    batch = a_exp.shape[:-2]
    powers = [torch.eye(n, dtype=a_exp.dtype, device=a_exp.device).expand(a_exp.shape)]
    for _ in range(horizon):
        powers.append(a_exp @ powers[-1])
    a_qp = torch.cat(powers[1:], dim=-2)
    blocks = [powers[k] @ b_exp for k in range(horizon)] + [torch.zeros_like(b_exp)]
    stacked = torch.stack(blocks, dim=-3)  # (B, h + 1, n, m)
    index = constant_like(_block_index(horizon), stacked, torch.int64)
    b_qp = stacked[..., index, :, :]  # (B, h, h, n, m)
    return a_qp, b_qp.transpose(-3, -2).reshape(batch + (horizon * n, horizon * m))


def _project_pyramid(u, fz_lo, fz_hi, config: MpcConfig):
    """Each foot's friction pyramid over the horizon, in place on ``u``
    (B, 3 num_legs h): fz clamped to [fz_lo, fz_hi] ((B, 1, num_legs):
    fz_min, fz_max times the contact), then |fx|, |fy| <= mu fz."""
    f = u.unflatten(-1, (config.planning_horizon, config.num_legs, 3))
    fz = f[..., 2].clamp_(fz_lo, fz_hi)
    lim = (config.friction_coeff * fz)[..., None]
    f[..., 0:2].clamp_(-lim, lim)
    return u


@functools.lru_cache(maxsize=None)
def fista_momentum(iterations: int, dtype: torch.dtype):
    """(t_k - 1) / t_(k+1) for each FISTA iteration, t_0 = 1 and
    t_(k+1) = (1 + sqrt(1 + 4 t_k^2)) / 2, computed on the host in
    ``dtype`` as the JAX package computes them in its carry."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    one, half, four = np_dtype(1.0), np_dtype(0.5), np_dtype(4.0)
    t, out = one, []
    for _ in range(iterations):
        t_new = half * (one + np.sqrt(one + four * t * t))
        out.append(float((t - one) / t_new))
        t = t_new
    return tuple(out)


def _symv(m, v, offset=None):
    """m v (+ offset) for symmetric m (..., n, n) and v (..., n), computed as
    the row product v^T m: cuBLAS's batched kernel for that form reads P
    at 2.1 TB/s on an H100, the column form's at 1.6-1.8 (tools/mpc_profile.py)."""
    n = v.shape[-1]
    rows, mats = v.reshape(-1, 1, n), m.expand(v.shape[:-1] + (n, n)).reshape(-1, n, n)
    out = torch.bmm(rows, mats) if offset is None else torch.baddbmm(offset.reshape(-1, 1, n), rows, mats)
    return out.reshape(v.shape)


def compute_contact_forces(
    config: MpcConfig,
    com_position,
    com_velocity,
    com_rpy,
    com_angular_velocity,
    foot_contact_states,  # (B, num_legs) 0/1
    foot_positions_body,  # (B, num_legs, 3)
    desired_com_position,
    desired_com_velocity,
    desired_com_rpy,
    desired_com_angular_velocity,
    gravity: float = 9.81,
):
    """Each env's optimal stance forces (B, num_legs, 3) in the
    yaw-aligned world frame; the COM state is (B, 3) each, the desired
    state (3,) each (shared by the batch) or (B, 3)."""
    like = foot_positions_body
    dtype = like.dtype
    batch = like.shape[:-2]
    h, legs = config.planning_horizon, config.num_legs
    qp_w = constant_like(config.qp_weights if config.qp_weights is not None else DEFAULT_WEIGHTS, like)
    contact = foot_contact_states.to(dtype)
    minus_g = torch.full(batch + (1,), -gravity, dtype=dtype, device=like.device)
    x0 = torch.cat([com_rpy, com_position, com_angular_velocity, com_velocity, minus_g], dim=-1)
    x_des = torch.cat(
        [t.expand(batch + (3,)) for t in (desired_com_rpy, desired_com_position, desired_com_angular_velocity, desired_com_velocity)]
        + [minus_g],
        dim=-1,
    ).repeat((1,) * len(batch) + (h,))

    inertia = constant_like(config.inertia, like)
    rot = _rpy_rate_matrix(com_rpy[..., 2]).transpose(-1, -2)  # Rz(yaw)
    inv_inertia_world = inv3(rot @ inertia @ rot.transpose(-1, -2))
    a_mat = calculate_a_mat(com_rpy)
    b_mat = calculate_b_mat(1.0 / config.mass, inv_inertia_world, foot_positions_body)
    a_exp, b_exp = discretize(a_mat, b_mat, config.timestep)
    a_qp, b_qp = condensed_qp_mats(a_exp, b_exp, h)

    bt_q = b_qp.transpose(-1, -2) * qp_w.repeat(h)
    width = b_qp.shape[-1]
    p_mat = 2.0 * (bt_q @ b_qp + config.alpha * torch.eye(width, dtype=dtype, device=like.device))
    q_vec = 2.0 * matvec(bt_q, matvec(a_qp, x0) - x_des)

    # the step from a power-iteration estimate of the Lipschitz constant
    v = torch.full(batch + (width,), 1.0 / width, dtype=dtype, device=like.device)
    for _ in range(POWER_ITERATIONS):
        v = _symv(p_mat, v)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    lipschitz = (v * _symv(p_mat, v)).sum(-1).clamp_min(1e-6)
    neg_step = (-1.0 / lipschitz)[..., None]

    fz_lo = (config.fz_min * contact)[..., None, :]
    fz_hi = (config.fz_max * contact)[..., None, :]
    # the warm start: the weight shared by the stance legs
    fz0 = config.mass * gravity / contact.sum(-1).clamp_min(1.0)
    u0 = torch.cat([torch.zeros(batch + (h, legs, 2), dtype=dtype, device=like.device),
                    fz0[..., None, None, None].expand(batch + (h, legs, 1))], dim=-1).flatten(-3)
    u = y = _project_pyramid(u0, fz_lo, fz_hi, config)
    # y - step (P y + q) as one batched product: (I - step P) y - step q
    descent = torch.eye(width, dtype=dtype, device=like.device) + neg_step[..., None] * p_mat
    offset = neg_step * q_vec
    for coef in fista_momentum(config.solver_iterations, dtype):
        u_new = _project_pyramid(_symv(descent, y, offset), fz_lo, fz_hi, config)
        y = torch.lerp(u, u_new, 1.0 + coef)  # u_new + coef (u_new - u)
        u = u_new
    # the first step's forces
    return u[..., : 3 * legs].unflatten(-1, (legs, 3))
