"""Articulated-Body Algorithm forward dynamics, O(n) (counterpart of
tds_tpu/dynamics/forward_dynamics.py), for fixed-base models with fixed
and 1-DoF joints.

The backward sweep is split into a velocity-independent articulated factor
(:class:`AbaFactor`) and a bias sweep. The factor doubles as an O(n)
factorization of the joint-space mass matrix: :func:`minv_mul` applies
M(q)^-1 to many generalized-force vectors at once, which the contact
solver uses for M^-1 J^T. Gravity enters as a fictitious base acceleration
-g. Floating bases, spherical joints and the JAX package's
``reference_base_abi_quirk`` are not ported yet.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.dynamics.kinematics import KinLinks, fk_links
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel


class AbaFactor(NamedTuple):
    """Per-link U = I^A S, 1/D (0 for fixed joints) and the post-update
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
        s = model.subspaces[i]
        u = abi[i].mul_motion(s)
        if jt == JointType.FIXED:
            # S = 0, so U = 0 and I^a = I^A
            invd = torch.zeros_like(u[..., 0])
            ia = abi[i]
        else:
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
        if jt != JointType.FIXED:
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
        if jt != JointType.FIXED:
            qdd_val = factor.d_inv[i] * (u_bias[i] - spatial.dot(factor.u[i], ai))
            cols[model.qd_offsets[i]] = qdd_val
            ai = ai + model.subspaces[i] * qdd_val[..., None]
        a[i] = ai
    return torch.stack(cols, dim=-1)
