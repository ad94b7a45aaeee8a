"""Recursive Newton-Euler inverse dynamics, RNEA (counterpart of
tds_tpu/dynamics/inverse_dynamics.py).

tau = ID(model, q, qd, qdd): the actuated torques that produce the
accelerations qdd. The full algorithm, with gravity as a fictitious base
acceleration -g, so that

    forward_dynamics(model, q, qd, ID(model, q, qd, qdd), g) == qdd

for fixed and floating bases (a floating base's qdd[0:6] is its world
twist's rate; its wrench comes back with ``return_base_wrench``). Pass
``gravity=0`` and ``qdd=0`` for the Coriolis and centrifugal torques,
``qd=0, qdd=0`` for gravity compensation.
"""

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.algebra.spatial import matTvec, matvec
from tds_tpu_torch.dynamics.kinematics import base_pose_from_q
from tds_tpu_torch.model.joints import JointType, jcalc_transform, jcalc_velocity
from tds_tpu_torch.model.multibody import MultiBodyModel


def inverse_dynamics(model: MultiBodyModel, q, qd, qdd, gravity, f_ext=None, return_base_wrench: bool = False):
    """tau (B, dof_actuated); with ``return_base_wrench`` also the net base
    wrench (B, 6), the reaction a floating base would need. ``gravity`` is
    a (3,) tensor; ``f_ext`` a world-frame force (B, 6) on each link, as a
    sequence or a (B, num_links, 6) tensor."""
    nl = model.num_links
    gravity = torch.as_tensor(gravity, dtype=q.dtype, device=q.device)
    batch = q.shape[:-1]
    a_base = spatial.mv(torch.zeros_like(gravity), -gravity).expand(batch + (6,))
    base_x_world = base_pose_from_q(model, q)
    if model.is_floating:
        v_base = qd[..., 0:6]
        a_base = a_base + qdd[..., 0:6]
    else:
        v_base = q.new_zeros(batch + (6,))

    x_parent, v, a, f = [], [], [], []
    for i in range(nl):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        s = model.subspace(i)
        xp = jcalc_transform(jt, model.x_t(i), s, model.q_for_link(q, i))
        v_par = v[parent] if parent >= 0 else v_base
        a_par = a[parent] if parent >= 0 else a_base
        if jt == JointType.FIXED:
            v_j = torch.zeros_like(v_par)
            a_j = torch.zeros_like(v_par)
        else:
            v_j = jcalc_velocity(jt, s, model.qd_for_link(qd, i))
            qdd_l = model.qd_for_link(qdd, i)
            a_j = matvec(s, qdd_l) if jt == JointType.SPHERICAL else s * qdd_l[..., 0:1]
        vi = xp.motion_to_child(v_par) + v_j
        ai = xp.motion_to_child(a_par) + spatial.cross_mm(vi, v_j) + a_j
        abi = ArticulatedBodyInertia.from_rbi(model.rbi(i))
        fi = abi.mul_motion(ai) + spatial.cross_mf(vi, abi.mul_motion(vi))
        x_parent.append(xp)
        v.append(vi)
        a.append(ai)
        f.append(fi)

    if f_ext is not None:
        xw = []
        for i in range(nl):
            parent = model.parents[i]
            xw.append((xw[parent] if parent >= 0 else base_x_world).compose(x_parent[i]))
            fe = f_ext[i] if isinstance(f_ext, (list, tuple)) else f_ext[..., i, :]
            f[i] = f[i] - xw[i].force_to_child(fe)

    cols = [None] * model.dof_actuated
    base_wrench = q.new_zeros(batch + (6,))
    shift = 6 if model.is_floating else 0
    for i in reversed(range(nl)):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        s = model.subspace(i)
        off = model.qd_offsets[i] - shift
        if jt == JointType.SPHERICAL:
            cols[off : off + 3] = matTvec(s, f[i]).unbind(-1)
        elif jt != JointType.FIXED:
            cols[off] = spatial.dot(s, f[i])
        fp = x_parent[i].force_to_parent(f[i])
        if parent >= 0:
            f[parent] = f[parent] + fp
        else:
            base_wrench = base_wrench + fp
    zero = q.new_zeros(batch)
    tau = torch.stack([zero if c is None else c for c in cols], dim=-1) if cols else q.new_zeros(batch + (0,))

    if model.is_floating:
        abi0 = ArticulatedBodyInertia.from_rbi(model.base_rbi())
        base_wrench = base_wrench + abi0.mul_motion(a_base) + spatial.cross_mf(v_base, abi0.mul_motion(v_base))
    if return_base_wrench:
        return tau, base_wrench
    return tau


def bias_forces(model: MultiBodyModel, q, qd, gravity):
    """C(q, qd) + g(q): the torques at qdd = 0."""
    return inverse_dynamics(model, q, qd, torch.zeros_like(qd), gravity)
