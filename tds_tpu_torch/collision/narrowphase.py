"""Analytic narrowphase with static contact counts (counterpart of
tds_tpu/collision/narrowphase.py: the plane-sphere pair, which the laikago
slice collides, and the plane-capsule pair, which the ant and the hopper
collide). Every pair function emits its fixed number of candidate points
(1 for plane-sphere, 2 for plane-capsule); the ``distance`` field decides
activity downstream by masking.

Contacts are ``Contact`` tuples with fields shaped (B, k, 3) / (B, k). The
other shape pairs of the JAX package are not ported yet; the port's
geometry has planes, spheres, capsules and boxes, and sphere-sphere,
capsule-sphere and every box pair raise NotImplementedError in
:func:`compute_contacts`.
"""

from typing import NamedTuple

import torch

from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.model.geometry import Box, Capsule, Plane, Sphere
from tds_tpu_torch.utils.tensors import constant


class Contact(NamedTuple):
    """Candidate contact points (k per pair, stacked on axis -2)."""

    normal_on_b: torch.Tensor  # (B, k, 3) world normal on body b
    point_a: torch.Tensor  # (B, k, 3) world point on a
    point_b: torch.Tensor  # (B, k, 3) world point on b
    distance: torch.Tensor  # (B, k) signed distance, negative when penetrating

    @property
    def count(self):
        return self.normal_on_b.shape[-2]

    @staticmethod
    def concatenate(contacts):
        return Contact(
            normal_on_b=torch.cat([c.normal_on_b for c in contacts], dim=-2),
            point_a=torch.cat([c.point_a for c in contacts], dim=-2),
            point_b=torch.cat([c.point_b for c in contacts], dim=-2),
            distance=torch.cat([c.distance for c in contacts], dim=-1),
        )


def plane_sphere(pa: Plane, xa: Transform, sb: Sphere, xb: Transform) -> Contact:
    """Sphere against an infinite plane; the normal on b is -plane normal."""
    n = constant(tuple(pa.normal), xb.pos.dtype, xb.pos.device)
    t = (xb.pos * n).sum(-1) - pa.constant
    point_a = xb.pos - t[..., None] * n
    distance = t - sb.radius
    point_b = xb.pos - sb.radius * n
    normal = (-n).expand(point_b.shape)
    return Contact(
        normal_on_b=normal[..., None, :],
        point_a=point_a[..., None, :],
        point_b=point_b[..., None, :],
        distance=distance[..., None],
    )


def plane_capsule(pa: Plane, xa: Transform, cb: Capsule, xb: Transform) -> Contact:
    """Two sphere probes at the capsule's axis endpoints, +length/2 first
    (the capsule's axis is its local Z)."""
    half = 0.5 * cb.length
    sphere = Sphere(cb.radius)
    probes = []
    for sz in (half, -half):
        center = xb.apply_point(constant((0.0, 0.0, sz), xb.pos.dtype, xb.pos.device))
        probes.append(plane_sphere(pa, xa, sphere, Transform(pos=center, rot=xb.rot)))
    return Contact.concatenate(probes)


def flip(contact: Contact) -> Contact:
    """Swap the roles of a and b."""
    return Contact(
        normal_on_b=-contact.normal_on_b,
        point_a=contact.point_b,
        point_b=contact.point_a,
        distance=contact.distance,
    )


_PAIR_TABLE = {
    (Plane, Sphere): (plane_sphere, False),
    (Sphere, Plane): (plane_sphere, True),
    (Plane, Capsule): (plane_capsule, False),
    (Capsule, Plane): (plane_capsule, True),
}


# pairs of ported shapes that the JAX package collides and the port does
# not yet: compute_contacts raises for them rather than skipping the pair
_UNPORTED_PAIRS = {
    (Sphere, Sphere), (Capsule, Sphere), (Sphere, Capsule),
    (Plane, Box), (Box, Plane), (Sphere, Box), (Box, Sphere),
}


def supported(shape_a, shape_b) -> bool:
    key = (type(shape_a), type(shape_b))
    return key in _PAIR_TABLE or key in _UNPORTED_PAIRS


def compute_contacts(shape_a, xa: Transform, shape_b, xb: Transform) -> Contact:
    """Dispatch on the static shape types; a and b keep the argument order."""
    key = (type(shape_a), type(shape_b))
    if key not in _PAIR_TABLE:
        raise NotImplementedError(f"collision pair {key} is not ported to tds_tpu_torch yet")
    fn, reversed_ = _PAIR_TABLE[key]
    if reversed_:
        return flip(fn(shape_b, xb, shape_a, xa))
    return fn(shape_a, xa, shape_b, xb)
