"""Force-based nonlinear spring-damper contact, the "soft" contact model
(counterpart of tds_tpu/contact/spring.py).

- normal force f_n = spring_k p^n + damper_d max(-vn, 0), gated by the
  penetration p = max(-d, 0) (or a softplus of it), never adhesive;
- friction: Coulomb, -mu f_n dir(v_t) with the direction smoothed near
  v_t = 0 (none, sigmoid, tanh or abs), or Andersson's
  mu(v) = mu_k + (mu_s - mu_k) exp(-(|v|/vs)^p) scaled by tanh(ktanh |v|);
- the forces enter the velocities as qd += dt M^-1 J^T f: through the
  step's ABA factor (``minv_mul``) when one is given, else through the
  CRBA mass matrix and :func:`~tds_tpu_torch.algebra.linalg.solve_pd`.

No LCP is solved, so no kernel runs on this path.
"""

import enum
from typing import NamedTuple

import torch

from tds_tpu_torch.algebra.linalg import solve_pd
from tds_tpu_torch.collision.narrowphase import safe_norm
from tds_tpu_torch.contact.mlcp import ContactBatch
from tds_tpu_torch.dynamics.forward_dynamics import minv_mul
from tds_tpu_torch.dynamics.jacobian import point_jacobian_kin
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix_from_kin
from tds_tpu_torch.model.multibody import MultiBodyModel


class VelocitySmoothing(enum.IntEnum):
    NONE = 0
    SIGMOID = 1
    TANH = 2
    ABS = 3


class FrictionModel(enum.IntEnum):
    NONE = 0
    COULOMB = 1
    ANDERSSON = 2


class SpringContactParams(NamedTuple):
    """The JAX package's defaults (the reference's binding surface)."""

    spring_k: float = 5000.0
    damper_d: float = 100.0
    exponent_n: float = 1.0
    hard_contact_condition: bool = True
    smoothing_method: int = VelocitySmoothing.NONE
    smooth_alpha_vel: float = 100.0
    smooth_alpha_normal: float = -1.0  # <= 0: a hard penetration gate
    mu_static: float = 0.5
    mu_kinetic: float = 0.5
    andersson_vs: float = 0.1
    andersson_p: float = 1.0
    andersson_ktanh: float = 10.0
    v_transition: float = 0.01
    friction_model: int = FrictionModel.COULOMB


def _smooth_dir(v_t, speed, params: SpringContactParams):
    """The tangential velocity's direction, scaled down near zero speed by
    the smoothing; v_t / max(speed, 1e-9), so that at v_t = 0 it and its
    gradient are JAX's."""
    m = params.smoothing_method
    if m == VelocitySmoothing.SIGMOID:
        scale = 1.0 / (1.0 + torch.exp(-params.smooth_alpha_vel * speed)) * 2.0 - 1.0
    elif m == VelocitySmoothing.TANH:
        scale = torch.tanh(params.smooth_alpha_vel * speed)
    elif m == VelocitySmoothing.ABS:
        scale = speed / (speed.abs() + params.v_transition)
    else:
        scale = torch.ones_like(speed)
    safe = speed.clamp_min(1e-9)
    return v_t / safe[..., None] * scale[..., None]


def compute_contact_force(distance, vn, params: SpringContactParams):
    """The normal force's magnitude (>= 0) for a signed distance and a
    normal velocity (vn > 0 separates)."""
    if params.smooth_alpha_normal and params.smooth_alpha_normal > 0:
        x = -params.smooth_alpha_normal * distance
        p = torch.logaddexp(torch.zeros_like(x), x) / params.smooth_alpha_normal
    else:
        p = (-distance).clamp_min(0.0)
    in_contact = (p > 0).to(p.dtype)
    pn = torch.pow(p.clamp_min(1e-12), params.exponent_n) * in_contact
    f = params.spring_k * pn + params.damper_d * (-vn).clamp_min(0.0) * in_contact
    if params.hard_contact_condition:
        f = torch.where(distance < 0.0, f, torch.zeros_like(f))
    return f


def compute_friction_force(f_n, v_t, params: SpringContactParams):
    """The tangential force (..., 3) opposing the lateral velocity."""
    speed = safe_norm(v_t)
    if params.friction_model == FrictionModel.NONE:
        return torch.zeros_like(v_t)
    if params.friction_model == FrictionModel.ANDERSSON:
        mu = params.mu_kinetic + (params.mu_static - params.mu_kinetic) * torch.exp(
            -torch.pow(speed / params.andersson_vs, params.andersson_p)
        )
        mag = mu * f_n * torch.tanh(params.andersson_ktanh * speed)
        safe = speed.clamp_min(1e-9)
        return -mag[..., None] * v_t / safe[..., None]
    return -(params.mu_kinetic * f_n)[..., None] * _smooth_dir(v_t, speed, params)


def resolve_collision_spring(
    model_a: MultiBodyModel,
    q_a,
    qd_a,
    model_b: MultiBodyModel,
    q_b,
    qd_b,
    batch: ContactBatch,
    dt,
    params: SpringContactParams = SpringContactParams(),
    kin_a=None,
    kin_b=None,
    factor_a=None,
    factor_b=None,
):
    """Returns (qd_a', qd_b', forces (B, k, 3)) with the contact forces
    integrated into the generalized velocities over ``dt``. Either body may
    have zero DoF (a static ground plane)."""
    n_a, n_b = model_a.dof_qd, model_b.dof_qd
    cp = batch.contact
    n_c = cp.count
    if n_c == 0 or (n_a == 0 and n_b == 0):
        return qd_a, qd_b, None
    if kin_a is None and n_a:
        kin_a = fk_links(model_a, q_a, torch.zeros_like(qd_a))
    if kin_b is None and n_b:
        kin_b = fk_links(model_b, q_b, torch.zeros_like(qd_b))

    def jac(model, kin, link, point):
        return point_jacobian_kin(model, kin.base_x_world, kin.x_world, None, link, point)

    gen_a = gen_b = None
    forces = []
    for i in range(n_c):
        # the normal points from b to a; a positive vn separates
        normal = cp.normal_on_b[..., i, :]
        ja = jac(model_a, kin_a, batch.link_a[i], cp.point_a[..., i, :]) if n_a else None
        jb = jac(model_b, kin_b, batch.link_b[i], cp.point_b[..., i, :]) if n_b else None
        rel_vel = 0.0
        if n_a:
            rel_vel = rel_vel + (ja @ qd_a[..., None]).squeeze(-1)
        if n_b:
            rel_vel = rel_vel - (jb @ qd_b[..., None]).squeeze(-1)
        vn = (normal * rel_vel).sum(-1)
        f_n = compute_contact_force(cp.distance[..., i], vn, params)
        v_t = rel_vel - vn[..., None] * normal
        force = f_n[..., None] * normal + compute_friction_force(f_n, v_t, params)
        forces.append(force)
        if n_a:
            g = (force[..., None, :] @ ja).squeeze(-2)
            gen_a = g if gen_a is None else gen_a + g
        if n_b:
            g = (force[..., None, :] @ jb).squeeze(-2)
            gen_b = -g if gen_b is None else gen_b - g

    if n_a:
        qd_a = qd_a + dt * _minv(model_a, kin_a, factor_a, q_a, gen_a)
    if n_b:
        qd_b = qd_b + dt * _minv(model_b, kin_b, factor_b, q_b, gen_b)
    return qd_a, qd_b, torch.stack(forces, dim=-2)


def _minv(model, kin, factor, q, force):
    """M^-1 force: the ABA factor's O(n) sweeps when given, else the dense
    CRBA mass matrix's Cholesky solve."""
    if factor is not None:
        return minv_mul(model, kin, factor, force)
    return solve_pd(mass_matrix_from_kin(model, kin, q), force)
