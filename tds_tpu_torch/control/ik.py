"""Inverse kinematics: Jacobian transpose, pseudo-inverse or damped
Levenberg-Marquardt (counterpart of tds_tpu/control/ik.py; the reference's
tiny_inverse_kinematics.h). All targets stack into one least-squares
system; a fixed number of iterations, on a batch of poses.

``torch.linalg.pinv`` and ``torch.linalg.solve_ex`` stand for
``jnp.linalg.pinv`` and ``jnp.linalg.solve``: they agree to rounding on
well-conditioned Jacobians (the CPU tests hold them at 1e-9).
"""

import enum
from typing import NamedTuple, Optional, Sequence

import torch

from tds_tpu_torch.dynamics.jacobian import point_jacobian
from tds_tpu_torch.dynamics.kinematics import forward_kinematics_q
from tds_tpu_torch.model.multibody import MultiBodyModel


class IKMethod(enum.IntEnum):
    JAC_TRANSPOSE = 0
    JAC_PINV = 1
    DAMPED_LM = 2


class IKTarget(NamedTuple):
    link_index: int  # static
    position: torch.Tensor  # (3,) or (B, 3) world target
    body_point: Optional[torch.Tensor] = None  # (3,) in the link frame; None is the origin


class IKResult(NamedTuple):
    q: torch.Tensor
    residual: torch.Tensor  # the final Euclidean error norm
    converged: torch.Tensor  # residual <= tolerance


def inverse_kinematics(
    model: MultiBodyModel,
    targets: Sequence[IKTarget],
    q0,
    method: IKMethod = IKMethod.DAMPED_LM,
    max_iterations: int = 20,
    alpha: float = 0.5,
    lambda_: float = 0.02,
    target_tolerance: float = 1e-3,
    q_reference=None,
    q_reference_weight: float = 0.0,
) -> IKResult:
    """Position targets on revolute and prismatic chains, q0 (B, dof_q);
    quaternion coordinates are not updated. With ``q_reference_weight`` > 0
    each iteration ends with q += w (q_reference - q), as the reference
    blends toward its reference pose."""
    dtype, device = q0.dtype, q0.device

    def residual_and_jac(q):
        _, lxw, _ = forward_kinematics_q(model, q)
        errs, jacs = [], []
        for t in targets:
            bp = torch.zeros(3, dtype=dtype, device=device) if t.body_point is None \
                else torch.as_tensor(t.body_point, dtype=dtype, device=device)
            world_pt = lxw[t.link_index].apply_point(bp)
            if world_pt.shape != q.shape[:-1] + (3,):
                world_pt = world_pt.expand(q.shape[:-1] + (3,))
            errs.append(torch.as_tensor(t.position, dtype=dtype, device=device) - world_pt)
            jacs.append(point_jacobian(model, q, t.link_index, world_pt))
        return torch.cat(errs, dim=-1), torch.cat(jacs, dim=-2)

    q = q0
    n = model.dof_qd
    for _ in range(max_iterations):
        e, jac = residual_and_jac(q)
        if method == IKMethod.JAC_TRANSPOSE:
            dq = alpha * (jac.transpose(-1, -2) @ e[..., None])[..., 0]
        elif method == IKMethod.JAC_PINV:
            dq = (torch.linalg.pinv(jac) @ e[..., None])[..., 0]
        else:
            jt = jac.transpose(-1, -2)
            a = jt @ jac + (lambda_**2) * torch.eye(n, dtype=dtype, device=device)
            dq = torch.linalg.solve_ex(a, jt @ e[..., None])[0][..., 0]
        q = q + dq
        if q_reference is not None and q_reference_weight > 0:
            q = q + q_reference_weight * (torch.as_tensor(q_reference, dtype=dtype, device=device) - q)
    e_final, _ = residual_and_jac(q)
    res = torch.linalg.vector_norm(e_final, dim=-1)
    return IKResult(q=q, residual=res, converged=res <= target_tolerance)
