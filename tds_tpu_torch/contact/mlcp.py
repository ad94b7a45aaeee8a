"""Impulse-level contact resolution: MLCP assembly and projected
Gauss-Seidel (counterpart of tds_tpu/contact/mlcp.py).

- rows [normals(k) | friction1(k) | friction2(k)] over the k candidates;
- b_i = -(1+restitution)*vn - erp*d/dt, rows masked by collision = (d < 0);
- A = J M^-1 J^T + cfm*I, with M^-1 J^T from the O(n) ABA factor
  (``minv_method="aba"``) or from the CRBA mass matrix factored by
  :func:`~tds_tpu_torch.algebra.linalg.cholesky_unrolled` in reversed DoF
  order under the tree's fill pattern (``"crba"``, kept for
  cross-validation); ``delassus_dtype="bf16"`` rounds J and M^-1 J^T to
  bfloat16 for the product and multiplies them in the working dtype (the
  JAX package's bf16 operands with an f32 result: products of two bf16
  values are exact there, so only the summation order differs);
- ``top_k`` compaction: only the top_k deepest candidates of each env go
  into the MLCP, back in candidate order (ties go to the lower index, as
  ``jax.lax.top_k`` breaks them);
- PGS with friction bounds scaled by the current normal impulse, through
  :func:`tds_tpu_torch.contact.pgs.solve_pgs` (the CUDA kernel on the card,
  the plain version on the CPU) from x = 0; :func:`solve_pgs` is the JAX
  package's public PGS, from a warm start;
- impulse qd_a += M_a^-1 J_a^T p, qd_b -= M_b^-1 J_b^T p.

The friction plane-space vectors are normalized, as in the JAX package.
The JAX package's ``pgs_impl`` switch is dropped: the device of the
operands picks the PGS path.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.algebra.linalg import cho_solve_unrolled, cholesky_unrolled, symbolic_cholesky_fill
from tds_tpu_torch.collision.narrowphase import Contact
from tds_tpu_torch.contact import pgs
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, minv_mul
from tds_tpu_torch.dynamics.jacobian import point_jacobian_kin
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix_from_kin
from tds_tpu_torch.model.multibody import MultiBodyModel


class ContactSolverParams(NamedTuple):
    """Solver knobs, with the JAX package's defaults."""

    pgs_iterations: int = 1
    erp: float = 0.2
    cfm: float = 1e-5
    num_friction_dir: int = 2
    friction: float = 0.5  # world default
    restitution: float = 0.0
    minv_method: str = "aba"
    top_k: int = 0
    delassus_dtype: str = "f32"


def solve_pgs(a_mat, b, lo, hi, limit_dependency, x0, iterations: int):
    """Projected Gauss-Seidel from the warm start ``x0``, with
    impulse-coupled bounds (``limit_dependency[i] >= 0`` scales row i's
    bounds by max(x[dep], 0)): the JAX package's signature. a_mat
    (..., n, n), b/lo/hi/x0 (..., n), the leading dims folded into one
    batch for :func:`tds_tpu_torch.contact.pgs.solve_pgs` (K1's warm-start
    instances on the card, the plain sweep on the CPU)."""
    n = b.shape[-1]
    lead = b.shape[:-1]
    flat = [t.reshape(-1, n).contiguous() for t in (b, lo, hi, x0)]
    x = pgs.solve_pgs(a_mat.reshape(-1, n, n).contiguous(), *flat[:3], limit_dependency, iterations, x0=flat[3])
    return x.reshape(lead + (n,))


def plane_space(n):
    """Two unit tangent vectors orthogonal to n (the normalized variant),
    branchless."""
    n_sqr = n[..., 2] * n[..., 2]
    mostly_z = n_sqr > 0.5
    a = n[..., 1] * n[..., 1] + torch.where(mostly_z, n_sqr, n[..., 0] * n[..., 0])
    k = 1.0 / a.clamp_min(1e-30).sqrt()
    zero = torch.zeros_like(k)
    p = torch.stack(
        [
            torch.where(mostly_z, zero, -n[..., 1] * k),
            torch.where(mostly_z, -n[..., 2] * k, n[..., 0] * k),
            torch.where(mostly_z, n[..., 1] * k, zero),
        ],
        dim=-1,
    )
    return p, torch.linalg.cross(n, p, dim=-1)


class ContactBatch(NamedTuple):
    """Candidate contacts between one pair of bodies, with static link ids."""

    contact: Contact  # fields (B, k, 3) / (B, k)
    link_a: Tuple[int, ...]  # static, len k
    link_b: Tuple[int, ...]
    friction: torch.Tensor  # (k,) or (B, k)
    restitution: torch.Tensor


MINV_METHODS = ("aba", "crba")
DELASSUS_DTYPES = ("f32", "bf16")


def check_params(params: ContactSolverParams):
    """Raises ValueError on a solver option that names no method."""
    if params.minv_method not in MINV_METHODS:
        raise ValueError(f"minv_method must be one of {MINV_METHODS}, got {params.minv_method!r}")
    if params.delassus_dtype not in DELASSUS_DTYPES:
        raise ValueError(f"delassus_dtype must be one of {DELASSUS_DTYPES}, got {params.delassus_dtype!r}")


def crba_solver(model: MultiBodyModel, kin, q):
    """rows -> rows M^-1 through the CRBA mass matrix: M is factored in
    reversed DoF order (leaves first, where the tree's coupling is
    fill-free) under :func:`symbolic_cholesky_fill`'s pattern, and the
    solve flips back."""
    pattern = symbolic_cholesky_fill(model.dof_coupling_mask()[::-1, ::-1])
    chol = cholesky_unrolled(mass_matrix_from_kin(model, kin, q).flip(-1, -2), pattern)

    def minv_rows(rows):  # (B, R, n) -> (B, R, n)
        rhs = rows.transpose(-1, -2).flip(-2)
        return cho_solve_unrolled(chol, rhs, pattern).flip(-2).transpose(-1, -2)

    return minv_rows


def delassus(j, jminv, delassus_dtype: str):
    """J (M^-1 J^T): (B, R, n) x (B, R, n) -> (B, R, R); under ``"bf16"``
    both operands rounded to bfloat16 first."""
    if delassus_dtype == "bf16":
        j, jminv = (t.to(torch.bfloat16).to(j.dtype) for t in (j, jminv))
    return j @ jminv.transpose(-1, -2)


def top_k_indices(distance, k: int):
    """(B, k) indices of the k deepest candidates of each env (least
    ``distance``), in candidate order. A stable sort keeps the lower index
    among equal distances, as ``jax.lax.top_k`` does (``torch.topk`` does
    not), on the CPU and the card alike."""
    return torch.argsort(distance, dim=-1, stable=True)[..., :k].sort(dim=-1).values


def resolve_collision(
    model_a: MultiBodyModel,
    q_a,
    qd_a,
    model_b: MultiBodyModel,
    q_b,
    qd_b,
    batch: ContactBatch,
    dt,
    params: ContactSolverParams = ContactSolverParams(),
    kin_a=None,
    kin_b=None,
    factor_a=None,
    factor_b=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Returns (qd_a', qd_b', impulses) after resolving the contact batch.
    Either body may have zero DoF (a static ground plane). ``kin_*`` and
    ``factor_*`` share the step's FK pass and ABA factor."""
    n_a, n_b = model_a.dof_qd, model_b.dof_qd
    cp = batch.contact
    n_c = cp.count
    if n_c == 0 or (n_a == 0 and n_b == 0):
        return qd_a, qd_b, None
    check_params(params)
    dtype = cp.distance.dtype
    collision = (cp.distance < 0.0).to(dtype)  # (B, k)
    col3 = collision[..., None]

    def body(model, q, qd, kin, factor, links, points):
        """Per-candidate Jacobians (B, k, 3, n) and the M^-1 row solver."""
        if kin is None:
            kin = fk_links(model, q, torch.zeros_like(qd))
        jac = torch.stack(
            [
                point_jacobian_kin(model, kin.base_x_world, kin.x_world, None, links[i], points[..., i, :])
                for i in range(n_c)
            ],
            dim=-3,
        )

        if params.minv_method == "crba":
            return jac, crba_solver(model, kin, q)
        if factor is None:
            factor = aba_factor(model, kin)

        def minv_rows(rows):  # (B, R, n) -> (B, R, n) = rows M^-1
            return minv_mul(model, kin, factor, rows.movedim(-2, 0)).movedim(0, -2)

        return jac, minv_rows

    rel_vel = 0.0
    if n_a:
        jac_a, solve_a = body(model_a, q_a, qd_a, kin_a, factor_a, batch.link_a, cp.point_a)
        rel_vel = rel_vel + (jac_a @ qd_a[..., None, :, None]).squeeze(-1)
    if n_b:
        jac_b, solve_b = body(model_b, q_b, qd_b, kin_b, factor_b, batch.link_b, cp.point_b)
        rel_vel = rel_vel - (jac_b @ qd_b[..., None, :, None]).squeeze(-1)

    vn = (cp.normal_on_b * rel_vel).sum(-1)
    baumgarte = params.erp * cp.distance / dt
    b_n = (-(1.0 + batch.restitution) * vn - baumgarte) * collision
    fr1, fr2 = plane_space(cp.normal_on_b)
    dirs = [cp.normal_on_b * col3, fr1 * col3, fr2 * col3][: 1 + params.num_friction_dir]
    rhs_blocks = [b_n] + [-(d * rel_vel).sum(-1) for d in dirs[1:]]  # each (B, k)
    bshape = cp.distance.shape[:-1]
    fric = batch.friction.expand(bshape + (n_c,))

    if 0 < params.top_k < n_c:
        # the Jacobians of every candidate were computed above: the
        # selection differs per env
        idx = top_k_indices(cp.distance, params.top_k)
        dirs = [d.take_along_dim(idx[..., None], dim=-2) for d in dirs]
        rhs_blocks = [r.gather(-1, idx) for r in rhs_blocks]
        fric = fric.gather(-1, idx)
        if n_a:
            jac_a = jac_a.take_along_dim(idx[..., None, None], dim=-3)
        if n_b:
            jac_b = jac_b.take_along_dim(idx[..., None, None], dim=-3)
        n_c = params.top_k
    rhs = torch.cat(rhs_blocks, dim=-1)  # (B, R)
    n_rows = rhs.shape[-1]

    def rows(jac):  # J^T d per candidate and direction -> (B, R, n)
        return torch.cat([torch.einsum("...kdn,...kd->...kn", jac, d) for d in dirs], dim=-2)

    blocks = []  # J (M^-1 J^T) of each dynamic body
    if n_a:
        j_a = rows(jac_a)
        jminv_a = solve_a(j_a)
        blocks.append(delassus(j_a, jminv_a, params.delassus_dtype))
    if n_b:
        j_b = rows(jac_b)
        jminv_b = solve_b(j_b)
        blocks.append(delassus(j_b, jminv_b, params.delassus_dtype))
    a_mat = sum(blocks[1:], blocks[0]) + params.cfm * torch.eye(n_rows, dtype=dtype, device=rhs.device)

    nfd = params.num_friction_dir
    lo = torch.cat([torch.zeros_like(fric)] + [-fric] * nfd, dim=-1)
    hi = torch.cat([torch.full_like(fric, 1e5)] + [fric] * nfd, dim=-1)
    limit_dependency = [-1] * n_c + list(range(n_c)) * nfd

    p = pgs.solve_pgs(a_mat.contiguous(), rhs, lo, hi, limit_dependency, params.pgs_iterations)
    if n_a:
        qd_a = qd_a + (p[..., None, :] @ jminv_a).squeeze(-2)
    if n_b:
        qd_b = qd_b - (p[..., None, :] @ jminv_b).squeeze(-2)
    return qd_a, qd_b, p
