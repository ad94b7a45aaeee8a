"""Rigid-body and articulated-body inertias (counterpart of
tds_tpu/algebra/inertia.py).

``RigidBodyInertia`` stores (mass m, first moment h = m*com, inertia about
the body origin). ``ArticulatedBodyInertia`` is the 6x6 block matrix
[[I, H], [H^T, M]] kept as three 3x3 blocks. Both broadcast over leading
batch dims.
"""

from typing import NamedTuple

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.linalg import inv3
from tds_tpu_torch.algebra.spatial import cross, matTvec, matvec


class RigidBodyInertia(NamedTuple):
    mass: torch.Tensor  # (...,)
    h: torch.Tensor  # (..., 3) first moment of mass m*com
    inertia: torch.Tensor  # (..., 3, 3) about the body-frame origin

    @staticmethod
    def from_mass_com_inertia(mass, com, inertia_about_com):
        """From the mass, the centre of mass and the inertia about it, by the
        parallel-axis rule: I_origin = I_com + m cx cx^T, h = m com."""
        mass, com, inertia = (torch.as_tensor(t) for t in (mass, com, inertia_about_com))
        cx = spatial.cross_matrix(com)
        i_o = inertia + mass[..., None, None] * (cx @ cx.transpose(-1, -2))
        return RigidBodyInertia(mass=mass, h=mass[..., None] * com, inertia=i_o)

    def mul_motion(self, m):
        """Spatial momentum I v = [I w + h x v, m v - h x w]."""
        w, v = m[..., :3], m[..., 3:]
        n = matvec(self.inertia, w) + cross(self.h, v)
        f = self.mass[..., None] * v - cross(self.h, w)
        return spatial.fv(n, f)


class ArticulatedBodyInertia(NamedTuple):
    I: torch.Tensor  # (..., 3, 3)
    H: torch.Tensor  # (..., 3, 3)
    M: torch.Tensor  # (..., 3, 3)

    @staticmethod
    def from_rbi(rbi: RigidBodyInertia):
        eye = torch.eye(3, dtype=rbi.inertia.dtype, device=rbi.inertia.device)
        return ArticulatedBodyInertia(
            I=rbi.inertia,
            H=spatial.cross_matrix(rbi.h),
            M=rbi.mass[..., None, None] * eye,
        )

    @staticmethod
    def zero(dtype=None, batch_shape=(), device=None):
        z = torch.zeros(tuple(batch_shape) + (3, 3), dtype=dtype, device=device)
        return ArticulatedBodyInertia(z, z, z)

    def __add__(self, other):
        return ArticulatedBodyInertia(
            self.I + other.I, self.H + other.H, self.M + other.M
        )

    def __sub__(self, other):
        return ArticulatedBodyInertia(
            self.I - other.I, self.H - other.H, self.M - other.M
        )

    def matrix(self):
        """Dense (..., 6, 6) form [[I, H], [H^T, M]]."""
        top = torch.cat([self.I, self.H], dim=-1)
        bot = torch.cat([self.H.transpose(-1, -2), self.M], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def mul_motion(self, v):
        """Ia*v = [I w + H v, M v + H^T w]."""
        w, lin = v[..., :3], v[..., 3:]
        n = matvec(self.I, w) + matvec(self.H, lin)
        f = matvec(self.M, lin) + matTvec(self.H, w)
        return spatial.fv(n, f)

    def mul_matrix63(self, s):
        """ABI @ S for a (..., 6, 3) motion-subspace matrix -> (..., 6, 3)."""
        st, sb = s[..., :3, :], s[..., 3:, :]
        return torch.cat([self.I @ st + self.H @ sb, self.H.transpose(-1, -2) @ st + self.M @ sb], dim=-2)

    def inverse(self):
        """Block (Schur-complement) inverse with the correct lower-left
        block C = H^T (the JAX package's ``inverse``, not its reference
        quirk)."""
        a_inv = inv3(self.I)
        h = self.H
        ht = h.transpose(-1, -2)
        s_inv = inv3(self.M - ht @ (a_inv @ h))
        ainv_h_sinv = a_inv @ h @ s_inv
        return ArticulatedBodyInertia(
            I=a_inv + ainv_h_sinv @ (ht @ a_inv), H=-ainv_h_sinv, M=s_inv
        )

    def inverse_reference_quirk(self):
        """The C++ reference's block inverse as it ships, with C = -H for the
        lower-left block where the true block is H^T: right while H is skew
        (a rigid body's), wrong for a floating base's accumulated
        articulated inertia. Kept to replay the reference's floating-base
        trajectories (``forward_dynamics.reference_base_abi_quirk``)."""
        a_inv = inv3(self.I)
        h = self.H
        s_inv = inv3(self.M + h @ (a_inv @ h))
        ainv_h_sinv = a_inv @ h @ s_inv
        return ArticulatedBodyInertia(
            I=a_inv - ainv_h_sinv @ (h @ a_inv), H=-ainv_h_sinv, M=s_inv
        )

    def inv_mul(self, f):
        """The motion vector a with Ia a = f."""
        inv = self.inverse()
        n, lin = f[..., :3], f[..., 3:]
        return spatial.mv(matvec(inv.I, n) + matvec(inv.H, lin), matvec(inv.M, lin) + matTvec(inv.H, n))

    @staticmethod
    def outer_ff(a, b):
        """a b^T for force vectors, as ABI blocks."""
        at, ab = a[..., :3], a[..., 3:]
        bt, bb = b[..., :3], b[..., 3:]
        return ArticulatedBodyInertia(
            I=at[..., :, None] * bt[..., None, :],
            H=at[..., :, None] * bb[..., None, :],
            M=ab[..., :, None] * bb[..., None, :],
        )

    @staticmethod
    def outer_63(a, b):
        """a b^T for (..., 6, 3) matrices, as ABI blocks."""
        at, ab = a[..., :3, :], a[..., 3:, :]
        bt, bb = b[..., :3, :], b[..., 3:, :]
        return ArticulatedBodyInertia(
            I=at @ bt.transpose(-1, -2), H=at @ bb.transpose(-1, -2), M=ab @ bb.transpose(-1, -2)
        )
