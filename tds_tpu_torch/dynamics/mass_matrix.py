"""Composite Rigid Body Algorithm: the joint-space inertia matrix M(q)
(counterpart of tds_tpu/dynamics/mass_matrix.py), with a spherical joint's
3-wide blocks and a floating base's 6 x 6 corner and 6-wide rows. The
ancestor walk is unrolled in Python over the static topology; the entries
collect in a dict of batched scalars and the matrix is stacked once."""

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia
from tds_tpu_torch.algebra.spatial import matTvec
from tds_tpu_torch.dynamics.kinematics import KinLinks, fk_links
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyModel


def mass_matrix(model: MultiBodyModel, q):
    """M(q), (B, dof_qd, dof_qd), symmetric and positive definite for a
    well-posed model."""
    return mass_matrix_from_kin(model, fk_links(model, q, q.new_zeros(q.shape[:-1] + (model.dof_qd,))), q)


def mass_matrix_from_kin(model: MultiBodyModel, kin: KinLinks, q):
    """CRBA over a precomputed FK pass (it reads the q-dependent transforms
    and the rigid-body inertias only, not the velocities)."""
    nl, n = model.num_links, model.dof_qd
    ic = list(kin.abi)  # composite inertias, seeded with the links' own
    base_ic = ArticulatedBodyInertia.from_rbi(model.base_rbi()) if model.is_floating else None
    entries = {}  # (row, col) -> batched scalar

    def put(r, c, value):
        entries[(r, c)] = entries[(c, r)] = value

    for i in reversed(range(nl)):
        jt = JointType(model.joint_types[i])
        parent = model.parents[i]
        delta = kin.x_parent[i].abi_to_parent(ic[i])
        if parent >= 0:
            ic[parent] = ic[parent] + delta
        elif model.is_floating:
            base_ic = base_ic + delta
        if jt == JointType.FIXED:
            continue
        qi = model.qd_offsets[i]
        spherical = jt == JointType.SPHERICAL
        s = model.subspace(i)
        # F = Ic S: (..., 6, 3) for a spherical joint, else (..., 6)
        f = ic[i].mul_matrix63(s) if spherical else ic[i].mul_motion(s)
        width = 3 if spherical else 1
        if spherical:
            block = s.transpose(-1, -2) @ f
            for r in range(3):
                for c in range(3):
                    entries[(qi + r, qi + c)] = block[..., r, c]
        else:
            entries[(qi, qi)] = spatial.dot(s, f)
        j = i
        while model.parents[j] != -1:
            f = kin.x_parent[j].force_matrix_to_parent(f) if spherical else kin.x_parent[j].force_to_parent(f)
            j = model.parents[j]
            if model.joint_types[j] == JointType.FIXED:
                continue
            qj = model.qd_offsets[j]
            sj = model.subspace(j)
            if model.joint_types[j] == JointType.SPHERICAL:
                # (..., width, 3): F^T S_j
                h = f.transpose(-1, -2) @ sj if spherical else matTvec(sj, f)[..., None, :]
                for r in range(width):
                    for c in range(3):
                        put(qi + r, qj + c, h[..., r, c])
            else:
                h = matTvec(f, sj) if spherical else spatial.dot(f, sj)[..., None]
                for r in range(width):
                    put(qi + r, qj, h[..., r])
        if model.is_floating:
            f = kin.x_parent[j].force_matrix_to_parent(f) if spherical else kin.x_parent[j].force_to_parent(f)[..., None]
            for r in range(6):
                for c in range(width):
                    put(r, qi + c, f[..., r, c])
    if model.is_floating:
        corner = base_ic.matrix()
        for r in range(6):
            for c in range(6):
                entries[(r, c)] = corner[..., r, c]
    batch = q.shape[:-1]
    zero = q.new_zeros(batch)
    rows = [torch.stack([entries.get((r, c), zero).expand(batch) for c in range(n)], dim=-1) for r in range(n)]
    return torch.stack(rows, dim=-2)
