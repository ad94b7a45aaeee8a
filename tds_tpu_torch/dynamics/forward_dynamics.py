"""Articulated-Body Algorithm forward dynamics, O(n) (counterpart of
tds_tpu/dynamics/forward_dynamics.py), for fixed and floating bases with
fixed, 1-DoF and spherical joints.

The backward sweep is split into a velocity-independent articulated factor
(:class:`AbaFactor`) and a bias sweep. The factor doubles as an O(n)
factorization of the joint-space mass matrix: :func:`minv_mul` applies
M(q)^-1 to many generalized-force vectors at once, which the contact
solver uses for M^-1 J^T. Gravity enters as a fictitious base acceleration
-g, and is added back to a floating base's qdd[0:6]. A spherical joint's U
is (6, 3) and its D^-1 the closed-form inverse of the 3x3 S^T U; its
stiffness acts on the quaternion's rotation vector.

A floating base gathers its children's articulated inertias into its own;
its acceleration is -inv(base ABI) (base bias force). Inside
:func:`reference_base_abi_quirk` ABA inverts the base ABI with the C++
reference's shipped block formula (``inverse_reference_quirk``), to replay
the reference's floating-base trajectories; ``minv_mul``, and so the
contact solver, keeps the correct inverse, as in the reference, whose
constraint solver inverts the CRBA mass matrix.
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
from tds_tpu_torch.utils import graphs

QUIRK = "reference_base_abi_quirk"


def reference_base_abi_quirk():
    """A context manager: within it, floating-base ABA inverts the base ABI
    with the reference's shipped (C = -H) formula. The switch is one of
    :func:`graphs.switch`'s, so a graph captured inside the block is never
    replayed outside it, nor one captured outside replayed inside."""
    return graphs.switch(QUIRK, True)


class AbaFactor(NamedTuple):
    """Per-link U = I^A S ((..., 6) or (..., 6, 3) for a spherical joint),
    D^-1 (a scalar, 0 for fixed joints, or (..., 3, 3)) and the post-update
    articulated inertia I^a = I^A - U D^-1 U^T. A floating base adds its
    accumulated ABI, its inverse, and the inverse ABA's base solve uses
    (the same object but inside :func:`reference_base_abi_quirk`)."""

    u: Tuple[torch.Tensor, ...]
    d_inv: Tuple[torch.Tensor, ...]
    ia: Tuple[ArticulatedBodyInertia, ...]
    base_abi: Optional[ArticulatedBodyInertia] = None
    base_abi_inv: Optional[ArticulatedBodyInertia] = None
    base_abi_inv_aba: Optional[ArticulatedBodyInertia] = None


def aba_factor(model: MultiBodyModel, kin: KinLinks) -> AbaFactor:
    """Backward articulated-inertia sweep. Depends on q (through ``kin``)
    but not on velocities or forces, so one factor per step serves ABA and
    the contact solver."""
    nl = model.num_links
    abi = list(kin.abi)
    base_abi = kin.base_abi
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
        elif model.is_floating:
            base_abi = base_abi + kin.x_parent[i].abi_to_parent(ia)
    base_abi_inv = base_abi_inv_aba = None
    if model.is_floating:
        base_abi_inv = base_abi.inverse()
        base_abi_inv_aba = base_abi.inverse_reference_quirk() if graphs.switched(QUIRK) else base_abi_inv
    return AbaFactor(
        u=tuple(u_terms), d_inv=tuple(d_inv), ia=tuple(ia_list),
        base_abi=base_abi, base_abi_inv=base_abi_inv, base_abi_inv_aba=base_abi_inv_aba,
    )


def forward_dynamics(model: MultiBodyModel, q, qd, tau, gravity, f_ext=None, base_applied_force=None):
    """Generalized accelerations qdd (B, dof_qd): FK, the articulated
    factor and the ABA sweeps. ``tau`` holds the actuated DoF only (a
    floating base's wrench goes in ``base_applied_force`` or ``f_ext``, see
    :func:`~tds_tpu_torch.dynamics.kinematics.fk_links`)."""
    if q.shape[-1] != model.dof_q:
        raise ValueError(f"q has {q.shape[-1]} coords, model needs {model.dof_q}")
    if qd.shape[-1] != model.dof_qd:
        raise ValueError(f"qd has {qd.shape[-1]} coords, model needs {model.dof_qd}")
    if tau.shape[-1] != model.dof_actuated:
        raise ValueError(
            f"tau has {tau.shape[-1]} entries, model has {model.dof_actuated} actuated DoF (a base wrench belongs in "
            "base_applied_force, not tau)"
        )
    kin = fk_links(model, q, qd, f_ext=f_ext, base_applied_force=base_applied_force)
    return forward_dynamics_from_kin(model, kin, q, qd, tau, gravity)


def forward_dynamics_from_kin(
    model: MultiBodyModel, kin: KinLinks, q, qd, tau, gravity, factor: Optional[AbaFactor] = None
):
    """ABA bias and forward sweeps over a precomputed FK pass; returns qdd
    (B, dof_qd). ``tau`` is (B, dof_actuated); ``gravity`` a (3,) tensor."""
    nl = model.num_links
    if factor is None:
        factor = aba_factor(model, kin)
    p_a = list(kin.pA)
    base_bias = kin.base_bias_force
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
        elif model.is_floating:
            base_bias = base_bias + kin.x_parent[i].force_to_parent(pa)

    spatial_gravity = torch.cat([torch.zeros_like(gravity), gravity])
    if not model.is_floating:
        base_acc = (-spatial_gravity).expand(q.shape[:-1] + (6,))
        return _forward_sweep(model, kin, factor, u_bias, base_acc, kin.c)
    base_acc = -_abi_apply(factor.base_abi_inv_aba, base_bias)
    return _forward_sweep(model, kin, factor, u_bias, base_acc, kin.c, base_qdd=base_acc + spatial_gravity)


def minv_mul(model: MultiBodyModel, kin: KinLinks, factor: AbaFactor, x):
    """M(q)^-1 x in O(n): the ABA sweeps at zero velocity and gravity with
    generalized force ``x`` (*extra, B, dof_qd); extra leading axes (for
    example many right-hand sides) broadcast against the state batch."""
    nl = model.num_links
    p_a = [None] * nl  # None stands for a zero force
    base_p = None
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
        if pa is not None and (parent >= 0 or model.is_floating):
            delta = kin.x_parent[i].force_to_parent(pa)
            if parent >= 0:
                p_a[parent] = delta if p_a[parent] is None else p_a[parent] + delta
            else:
                base_p = delta if base_p is None else base_p + delta
    if not model.is_floating:
        return _forward_sweep(model, kin, factor, u_bias, x.new_zeros(x.shape[:-1] + (6,)), None)
    f0 = x[..., 0:6] if base_p is None else x[..., 0:6] - base_p
    base_acc = _abi_apply(factor.base_abi_inv, f0)
    return _forward_sweep(model, kin, factor, u_bias, base_acc, None, base_qdd=base_acc)


def _forward_sweep(model, kin, factor, u_bias, base_acc, c, base_qdd=None):
    """Forward acceleration sweep shared by ABA (with the bias accelerations
    ``c``) and minv_mul (``c`` None); returns the stacked accelerations
    (..., dof_qd), a floating base's ``base_qdd`` first."""
    nl = model.num_links
    a = [None] * nl
    cols = [None] * model.dof_qd
    if model.is_floating:
        cols[0:6] = base_qdd.unbind(-1)
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


def _abi_apply(abi: ArticulatedBodyInertia, f):
    """[[I, H], [H^T, M]] [n; f] for the blocks of a (precomputed inverse)
    ABI."""
    n, lin = f[..., :3], f[..., 3:]
    return spatial.mv(matvec(abi.I, n) + matvec(abi.H, lin), matvec(abi.M, lin) + matTvec(abi.H, n))
