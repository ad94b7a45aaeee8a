"""Forward kinematics, phase 1 of ABA (counterpart of
tds_tpu/dynamics/kinematics.py): joint transforms, world poses, link
spatial velocities, bias accelerations and bias forces, with the link loop
unrolled in Python over the static topology.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.model.joints import JointType, jcalc_transform, jcalc_velocity
from tds_tpu_torch.model.multibody import MultiBodyModel


class KinLinks(NamedTuple):
    """Per-link kinematics as tuples of per-link values."""

    x_parent: Tuple[Transform, ...]
    x_world: Tuple[Transform, ...]
    v: Tuple[torch.Tensor, ...]  # spatial velocity in the link frame
    c: Tuple[torch.Tensor, ...]  # velocity-product acceleration
    pA: Tuple[torch.Tensor, ...]  # bias force
    abi: Tuple[ArticulatedBodyInertia, ...]
    base_x_world: Transform
    base_velocity: torch.Tensor  # (..., 6)
    base_abi: Optional[ArticulatedBodyInertia]
    base_bias_force: Optional[torch.Tensor]


def fk_links(model: MultiBodyModel, q, qd) -> KinLinks:
    """Unrolled forward-kinematics pass for a fixed-base model; q and qd
    are (B, dof_q) and (B, dof_qd)."""
    if model.is_floating:
        raise NotImplementedError("floating bases are not ported to tds_tpu_torch yet")
    base_x_world = model.base_x_world()
    base_velocity = q.new_zeros(q.shape[:-1] + (6,))
    xp_list, xw_list, v_list, c_list, pa_list, abi_list = [], [], [], [], [], []
    for i in range(model.num_links):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        s = model.subspaces[i]
        x_parent = jcalc_transform(jt, model.x_t(i), s, model.q_for_link(q, i))
        if parent >= 0:
            x_world = xw_list[parent].compose(x_parent)
        else:
            x_world = base_x_world.compose(x_parent)
        abi = ArticulatedBodyInertia.from_rbi(model.rbi(i))
        if jt == JointType.FIXED:
            # vJ = 0, so c = v x vJ = 0 exactly
            v = x_parent.motion_to_child(v_list[parent]) if parent >= 0 else base_velocity
            c = torch.zeros_like(v)
        else:
            v_j = jcalc_velocity(jt, s, model.qd_for_link(qd, i))
            v = x_parent.motion_to_child(v_list[parent]) + v_j if parent >= 0 else v_j
            c = spatial.cross_mm(v, v_j)
        p_a = spatial.cross_mf(v, abi.mul_motion(v))

        xp_list.append(x_parent)
        xw_list.append(x_world)
        v_list.append(v)
        c_list.append(c)
        pa_list.append(p_a)
        abi_list.append(abi)

    return KinLinks(
        x_parent=tuple(xp_list),
        x_world=tuple(xw_list),
        v=tuple(v_list),
        c=tuple(c_list),
        pA=tuple(pa_list),
        abi=tuple(abi_list),
        base_x_world=base_x_world,
        base_velocity=base_velocity,
        base_abi=None,
        base_bias_force=None,
    )
