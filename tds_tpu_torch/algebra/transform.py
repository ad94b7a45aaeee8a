"""Plücker coordinate transforms (counterpart of
tds_tpu/algebra/transform.py).

``Transform(pos, rot)`` places a child frame in its parent: ``rot`` maps
child coordinates to parent coordinates and ``pos`` is the child origin in
the parent. All ops broadcast over leading batch dims.
"""

from typing import NamedTuple

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia
from tds_tpu_torch.algebra.spatial import cross, matTvec, matvec


class Transform(NamedTuple):
    pos: torch.Tensor  # (..., 3)
    rot: torch.Tensor  # (..., 3, 3), child -> parent

    @staticmethod
    def identity(dtype=None, batch_shape=(), device=None):
        batch_shape = tuple(batch_shape)
        return Transform(
            pos=torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
            rot=torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3)),
        )

    @staticmethod
    def from_pos(pos):
        pos = torch.as_tensor(pos)
        return Transform(pos=pos, rot=torch.eye(3, dtype=pos.dtype, device=pos.device).expand(pos.shape + (3,)))

    @staticmethod
    def from_rot(rot):
        rot = torch.as_tensor(rot)
        return Transform(pos=rot.new_zeros(rot.shape[:-1]), rot=rot)

    def compose(self, other: "Transform") -> "Transform":
        """X1 * X2: the child-of-child placed in this transform's parent."""
        return Transform(
            pos=self.pos + matvec(self.rot, other.pos), rot=self.rot @ other.rot
        )

    def inverse(self) -> "Transform":
        rt = self.rot.transpose(-1, -2)
        return Transform(pos=matvec(rt, -self.pos), rot=rt)

    def apply_point(self, p):
        """Child-frame point -> parent frame."""
        return matvec(self.rot, p) + self.pos

    def apply_inverse_point(self, p):
        """Parent-frame point -> child frame."""
        return matTvec(self.rot, p - self.pos)

    def motion_to_child(self, m):
        """[w, v] -> [R^T w, R^T (v - r x w)]."""
        w, v = m[..., :3], m[..., 3:]
        return spatial.mv(
            matTvec(self.rot, w), matTvec(self.rot, v - cross(self.pos, w))
        )

    def motion_to_parent(self, m):
        """[w, v] -> [R w, R v + r x (R w)]."""
        w, v = m[..., :3], m[..., 3:]
        wt = matvec(self.rot, w)
        return spatial.mv(wt, matvec(self.rot, v) + cross(self.pos, wt))

    def motion_matrix_to_child(self, s):
        """Columnwise motion_to_child of a (..., 6, 3) matrix."""
        per_column = Transform(pos=self.pos[..., None, :], rot=self.rot[..., None, :, :])
        return per_column.motion_to_child(s.transpose(-1, -2)).transpose(-1, -2)

    def motion_matrix_to_parent(self, s):
        """Columnwise motion_to_parent of a (..., 6, 3) matrix; the columns
        get an axis of their own, so a batched transform broadcasts."""
        per_column = Transform(pos=self.pos[..., None, :], rot=self.rot[..., None, :, :])
        return per_column.motion_to_parent(s.transpose(-1, -2)).transpose(-1, -2)

    def force_matrix_to_parent(self, s):
        """Columnwise force_to_parent of a (..., 6, 3) force matrix."""
        per_column = Transform(pos=self.pos[..., None, :], rot=self.rot[..., None, :, :])
        return per_column.force_to_parent(s.transpose(-1, -2)).transpose(-1, -2)

    def force_to_parent(self, f):
        """[n, f] -> [R n + r x (R f), R f]."""
        n, lin = f[..., :3], f[..., 3:]
        fb = matvec(self.rot, lin)
        return spatial.fv(matvec(self.rot, n) + cross(self.pos, fb), fb)

    def force_to_child(self, f):
        """[n, f] -> [R^T (n - r x f), R^T f]."""
        n, lin = f[..., :3], f[..., 3:]
        return spatial.fv(
            matTvec(self.rot, n - cross(self.pos, lin)), matTvec(self.rot, lin)
        )

    def matrix(self):
        """The 6x6 motion transform [[E, 0], [-E rx, E]], E = R^T."""
        e = self.rot.transpose(-1, -2)
        rx = spatial.cross_matrix(self.pos)
        top = torch.cat([e, torch.zeros_like(e)], dim=-1)
        bot = torch.cat([-(e @ rx), e], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def rbi_to_parent(self, rbi: RigidBodyInertia) -> RigidBodyInertia:
        """X^T I X: a child's rigid-body inertia in the parent frame."""
        r = self.rot
        e_t_h = matvec(r, rbi.h)
        h_new = e_t_h + rbi.mass[..., None] * self.pos
        rx = spatial.cross_matrix(self.pos)
        inertia = (r @ rbi.inertia @ r.transpose(-1, -2) - rx @ spatial.cross_matrix(e_t_h)
                   - spatial.cross_matrix(h_new) @ rx)
        return RigidBodyInertia(mass=rbi.mass, h=h_new, inertia=inertia)

    def abi_to_parent(self, abi: ArticulatedBodyInertia) -> ArticulatedBodyInertia:
        """X^T I^A X blockwise, with X = [[E, 0], [-E rx, E]] and E = R^T:
          M' = R M R^T
          H' = R H R^T + rx M'
          I' = R I R^T - (R H R^T) rx + rx (R H^T R^T) - rx M' rx
        """
        r = self.rot
        rt = r.transpose(-1, -2)
        rx = spatial.cross_matrix(self.pos)
        mp = r @ abi.M @ rt
        hp = r @ abi.H @ rt
        hpt = r @ abi.H.transpose(-1, -2) @ rt
        return ArticulatedBodyInertia(
            I=r @ abi.I @ rt - hp @ rx + rx @ hpt - rx @ mp @ rx,
            H=hp + rx @ mp,
            M=mp,
        )
