"""Articulated-Body Algorithm forward dynamics, O(n) (counterpart of
tds_tpu/dynamics/forward_dynamics.py), for fixed-base models with fixed,
1-DoF and spherical joints.

The backward sweep is split into a velocity-independent articulated factor
(:class:`AbaFactor`) and a bias sweep. The factor doubles as an O(n)
factorization of the joint-space mass matrix: :func:`minv_mul` applies
M(q)^-1 to many generalized-force vectors at once, which the contact
solver uses for M^-1 J^T. Gravity enters as a fictitious base acceleration
-g. A spherical joint's U is (6, 3) and its D^-1 the closed-form inverse
of the 3x3 S^T U; its stiffness acts on the quaternion's rotation vector.
Floating bases and the JAX package's ``reference_base_abi_quirk`` are not
ported yet.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.algebra import quaternion, spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.algebra.linalg import inv3
from tds_tpu_torch.algebra.spatial import matTvec, matvec
from tds_tpu_torch.dynamics.kinematics import KinLinks, fk_links
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel


class AbaFactor(NamedTuple):
    """Per-link U = I^A S ((..., 6) or (..., 6, 3) for a spherical joint),
    D^-1 (a scalar, 0 for fixed joints, or (..., 3, 3)) and the post-update
    articulated inertia I^a = I^A - U D^-1 U^T."""

    u: Tuple[torch.Tensor, ...]
    d_inv: Tuple[torch.Tensor, ...]
    ia: Tuple[ArticulatedBodyInertia, ...]


def aba_factor(model: MultiBodyModel, kin: KinLinks) -> AbaFactor:
    """Backward articulated-inertia sweep. Depends on q (through ``kin``)
    but not on velocities or forces, so one factor per step serves ABA and
    the contact solver."""
    nl = model.num_links
    abi = list(kin.abi)
    u_terms, d_inv, ia_list = [None] * nl, [None] * nl, [None] * nl
    for i in reversed(range(nl)):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        s = model.subspace(i)
        if jt == JointType.SPHERICAL:
            u = abi[i].mul_matrix63(s)
            invd = inv3(s.transpose(-1, -2) @ u)
            ia = abi[i] - ArticulatedBodyInertia.outer_63(u, u @ invd)
        elif jt == JointType.FIXED:
            u = abi[i].mul_motion(s)
            # S = 0, so U = 0 and I^a = I^A
            invd = torch.zeros_like(u[..., 0])
            ia = abi[i]
        else:
            u = abi[i].mul_motion(s)
            invd = 1.0 / spatial.dot(s, u)
            ia = abi[i] - ArticulatedBodyInertia.outer_ff(u, u * invd[..., None])
        u_terms[i], d_inv[i], ia_list[i] = u, invd, ia
        if parent >= 0:
            abi[parent] = abi[parent] + kin.x_parent[i].abi_to_parent(ia)
    return AbaFactor(u=tuple(u_terms), d_inv=tuple(d_inv), ia=tuple(ia_list))


def forward_dynamics(model: MultiBodyModel, q, qd, tau, gravity):
    """Generalized accelerations qdd (B, dof_qd): FK, the articulated
    factor and the ABA sweeps. ``tau`` holds the actuated DoF only."""
    if q.shape[-1] != model.dof_q:
        raise ValueError(f"q has {q.shape[-1]} coords, model needs {model.dof_q}")
    if qd.shape[-1] != model.dof_qd:
        raise ValueError(f"qd has {qd.shape[-1]} coords, model needs {model.dof_qd}")
    if tau.shape[-1] != model.dof_actuated:
        raise ValueError(f"tau has {tau.shape[-1]} entries, model has {model.dof_actuated} actuated DoF")
    return forward_dynamics_from_kin(model, fk_links(model, q, qd), q, qd, tau, gravity)


def forward_dynamics_from_kin(
    model: MultiBodyModel, kin: KinLinks, q, qd, tau, gravity, factor: Optional[AbaFactor] = None
):
    """ABA bias and forward sweeps over a precomputed FK pass; returns qdd
    (B, dof_qd). ``tau`` is (B, dof_actuated); ``gravity`` a (3,) tensor."""
    nl = model.num_links
    if factor is None:
        factor = aba_factor(model, kin)
    p_a = list(kin.pA)
    u_bias = [None] * nl

    for i in reversed(range(nl)):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        pa = p_a[i] + factor.ia[i].mul_motion(kin.c[i])
        if jt == JointType.SPHERICAL:
            tau_l = model.tau_for_link(tau, i)
            tau_l = tau_l - model.stiffness[i] * quaternion.to_axis_angle(model.q_for_link(q, i))
            tau_l = tau_l - model.damping[i] * model.qd_for_link(qd, i)
            u_b = tau_l - matTvec(model.subspace(i), p_a[i])
            pa = pa + matvec(factor.u[i], matvec(factor.d_inv[i], u_b))
            u_bias[i] = u_b
        elif jt != JointType.FIXED:
            s = model.subspaces[i]
            tau_l = model.tau_for_link(tau, i)[..., 0]
            q_l = model.q_for_link(q, i)[..., 0]
            qd_l = model.qd_for_link(qd, i)[..., 0]
            tau_l = tau_l - model.stiffness[i] * q_l - model.damping[i] * qd_l
            u_b = tau_l - spatial.dot(s, p_a[i])
            pa = pa + factor.u[i] * (u_b * factor.d_inv[i])[..., None]
            u_bias[i] = u_b
        if parent >= 0:
            p_a[parent] = p_a[parent] + kin.x_parent[i].force_to_parent(pa)

    spatial_gravity = torch.cat([torch.zeros_like(gravity), gravity])
    base_acc = (-spatial_gravity).expand(q.shape[:-1] + (6,))
    return _forward_sweep(model, kin, factor, u_bias, base_acc, kin.c)


def minv_mul(model: MultiBodyModel, kin: KinLinks, factor: AbaFactor, x):
    """M(q)^-1 x in O(n): the ABA sweeps at zero velocity and gravity with
    generalized force ``x`` (*extra, B, dof_qd); extra leading axes (for
    example many right-hand sides) broadcast against the state batch."""
    nl = model.num_links
    p_a = [None] * nl  # None stands for a zero force
    u_bias = [None] * nl
    for i in reversed(range(nl)):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        if jt == JointType.FIXED:
            pa = p_a[i]
        elif jt == JointType.SPHERICAL:
            off = model.qd_offsets[i]
            x_l = x[..., off : off + 3]
            u_b = x_l if p_a[i] is None else x_l - matTvec(model.subspace(i), p_a[i])
            uud = matvec(factor.u[i], matvec(factor.d_inv[i], u_b))
            pa = uud if p_a[i] is None else p_a[i] + uud
            u_bias[i] = u_b
        else:
            x_l = x[..., model.qd_offsets[i]]
            u_b = x_l if p_a[i] is None else x_l - spatial.dot(model.subspaces[i], p_a[i])
            uud = factor.u[i] * (u_b * factor.d_inv[i])[..., None]
            pa = uud if p_a[i] is None else p_a[i] + uud
            u_bias[i] = u_b
        if parent >= 0 and pa is not None:
            delta = kin.x_parent[i].force_to_parent(pa)
            p_a[parent] = delta if p_a[parent] is None else p_a[parent] + delta
    base_acc = x.new_zeros(x.shape[:-1] + (6,))
    return _forward_sweep(model, kin, factor, u_bias, base_acc, None)


def _forward_sweep(model, kin, factor, u_bias, base_acc, c):
    """Forward acceleration sweep shared by ABA (with the bias accelerations
    ``c``) and minv_mul (``c`` None); returns the stacked joint
    accelerations (..., dof_qd)."""
    nl = model.num_links
    a = [None] * nl
    cols = [None] * model.dof_qd
    for i in range(nl):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        a_parent = a[parent] if parent >= 0 else base_acc
        ai = kin.x_parent[i].motion_to_child(a_parent)
        if c is not None:
            ai = ai + c[i]
        if jt == JointType.SPHERICAL:
            qdd_val = matvec(factor.d_inv[i], u_bias[i] - matTvec(factor.u[i], ai))
            for k in range(3):
                cols[model.qd_offsets[i] + k] = qdd_val[..., k]
            ai = ai + matvec(model.subspace(i), qdd_val)
        elif jt != JointType.FIXED:
            qdd_val = factor.d_inv[i] * (u_bias[i] - spatial.dot(factor.u[i], ai))
            cols[model.qd_offsets[i]] = qdd_val
            ai = ai + model.subspaces[i] * qdd_val[..., None]
        a[i] = ai
    return torch.stack(cols, dim=-1)
