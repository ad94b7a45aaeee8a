"""World: bodies, collision geometry and contact resolution (counterpart of
tds_tpu/world.py, MLCP contact only).

The world is a static description; :func:`resolve_contacts` is a function
over the tuple of body states. Pairs are enumerated in Python from the
static geometry lists, producing fixed-size masked contact batches. A
terrain (``Heightfield`` or ``Mesh``) hangs on the zero-DoF ground body
like the plane. The spring contact model is not ported yet and raises.

``friction_mode`` picks each candidate's friction and restitution:
``"geom_min"`` (the default) the lesser friction and the greater
restitution of the pair's two geoms, ``"world_default"`` the solver's
``friction`` and ``restitution`` (the reference's semantics), which may be
tensors that require grad: friction system identification differentiates
through them.
"""

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.collision import narrowphase
from tds_tpu_torch.collision.narrowphase import Contact
from tds_tpu_torch.contact.mlcp import ContactBatch, ContactSolverParams, resolve_collision
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.model.geometry import GeomAttachment, Plane
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel, np_rpy
from tds_tpu_torch.utils.tensors import constant


FRICTION_MODES = ("geom_min", "world_default")


@dataclasses.dataclass(frozen=True)
class World:
    bodies: Tuple[MultiBodyModel, ...]
    geoms: Tuple[Tuple[GeomAttachment, ...], ...]
    solver: ContactSolverParams = ContactSolverParams()
    contact_model: str = "mlcp"
    friction_mode: str = "geom_min"

    def __post_init__(self):
        if self.friction_mode not in FRICTION_MODES:
            raise ValueError(f"friction_mode must be one of {FRICTION_MODES}, got {self.friction_mode!r}")

    @property
    def num_bodies(self):
        return len(self.bodies)


def make_ground_plane(normal=(0.0, 0.0, 1.0), constant=0.0, dtype=torch.float64, device=None):
    """A zero-DoF body carrying an infinite plane."""
    model = MultiBodyBuilder(name="ground").finalize(dtype=dtype, device=device)
    geom = GeomAttachment(link_index=-1, shape=Plane(tuple(normal), constant))
    return model, (geom,)


def build_world(
    bodies_and_geoms: Sequence[Tuple[MultiBodyModel, Sequence[GeomAttachment]]],
    solver: ContactSolverParams = ContactSolverParams(),
    contact_model: str = "mlcp",
    friction_mode: str = "geom_min",
) -> World:
    """The world of the given bodies. Raises NotImplementedError on a pair of
    geoms that :func:`resolve_contacts` would collide and the port cannot
    yet, here rather than at the first step."""
    if contact_model != "mlcp":
        raise NotImplementedError(f"contact_model={contact_model!r} is not ported to tds_tpu_torch yet")
    for i, (body_a, geoms_a) in enumerate(bodies_and_geoms):
        for body_b, geoms_b in bodies_and_geoms[i + 1 :]:
            if body_a.dof_qd == 0 and body_b.dof_qd == 0:
                continue
            for ga in geoms_a:
                for gb in geoms_b:
                    if narrowphase.supported(ga.shape, gb.shape) and not narrowphase.ported(ga.shape, gb.shape):
                        raise NotImplementedError(
                            f"collision pair {type(ga.shape).__name__}-{type(gb.shape).__name__} is not ported to "
                            "tds_tpu_torch yet"
                        )
    return World(
        bodies=tuple(b for b, _ in bodies_and_geoms),
        geoms=tuple(tuple(g) for _, g in bodies_and_geoms),
        solver=solver,
        contact_model=contact_model,
        friction_mode=friction_mode,
    )


@functools.lru_cache(maxsize=None)
def _offset(attachment: GeomAttachment, dtype, device) -> Transform:
    """The attachment's static offset in its link frame, built once."""
    rot = tuple(map(tuple, np_rpy(*attachment.rpy).tolist()))
    return Transform(pos=constant(tuple(attachment.pos), dtype, device), rot=constant(rot, dtype, device))


def _geom_world_transform(kin, attachment: GeomAttachment, like: torch.Tensor) -> Transform:
    frame = kin.base_x_world if attachment.link_index < 0 else kin.x_world[attachment.link_index]
    return frame.compose(_offset(attachment, like.dtype, like.device))


def gather_pair_contacts(world: World, kin_list, pair_a: int, pair_b: int, like: torch.Tensor) -> Optional[ContactBatch]:
    """All candidate contacts between every geom of body a and of body b,
    concatenated with static link ids; ``like`` sets dtype and device. A
    pair's friction is the lesser of its two geoms' and its restitution the
    greater under ``friction_mode="geom_min"``, the solver's under
    ``"world_default"``."""
    contacts: List[Contact] = []
    link_a: List[int] = []
    link_b: List[int] = []
    frictions: List[float] = []
    restitutions: List[float] = []
    for ga in world.geoms[pair_a]:
        xa = _geom_world_transform(kin_list[pair_a], ga, like)
        for gb in world.geoms[pair_b]:
            if not narrowphase.supported(ga.shape, gb.shape):
                continue
            xb = _geom_world_transform(kin_list[pair_b], gb, like)
            c = narrowphase.compute_contacts(ga.shape, xa, gb.shape, xb)
            contacts.append(c)
            link_a += [ga.link_index] * c.count
            link_b += [gb.link_index] * c.count
            frictions += [min(ga.friction, gb.friction)] * c.count
            restitutions += [max(ga.restitution, gb.restitution)] * c.count
    if not contacts:
        return None
    if world.friction_mode == "world_default":
        friction = _broadcast(world.solver.friction, len(link_a), like)
        restitution = _broadcast(world.solver.restitution, len(link_a), like)
    else:
        friction = constant(tuple(frictions), like.dtype, like.device)
        restitution = constant(tuple(restitutions), like.dtype, like.device)
    return ContactBatch(
        contact=Contact.concatenate(contacts),
        link_a=tuple(link_a),
        link_b=tuple(link_b),
        friction=friction,
        restitution=restitution,
    )


def _broadcast(value, count: int, like: torch.Tensor) -> torch.Tensor:
    """A solver coefficient for ``count`` candidates: a tensor (which may
    require grad) broadcast as it is, a number as a cached constant."""
    if isinstance(value, torch.Tensor):
        return value.to(like.device, like.dtype).expand(count)
    return constant((float(value),) * count, like.dtype, like.device)


def resolve_contacts(world: World, qs, qds, dt, kins=None, factors=None):
    """One contact-resolution pass over all body pairs; returns new qds.

    qs/qds are tuples with one (B, dof) entry per body (zero-DoF bodies
    hold (B, 0) tensors). ``kins``/``factors``: optional per-body
    :class:`KinLinks` / :class:`AbaFactor` shared with the step's ABA."""
    like = next((q for q in qs if q.shape[-1]), None)
    if like is None:
        return qds
    kin_list = [
        kins[i]
        if kins is not None and kins[i] is not None
        else fk_links(world.bodies[i], qs[i], torch.zeros_like(qds[i]))
        for i in range(world.num_bodies)
    ]
    qds = list(qds)
    for i in range(world.num_bodies):
        for j in range(i + 1, world.num_bodies):
            if not world.geoms[i] or not world.geoms[j]:
                continue
            if world.bodies[i].dof_qd == 0 and world.bodies[j].dof_qd == 0:
                continue
            batch = gather_pair_contacts(world, kin_list, i, j, like)
            if batch is None:
                continue
            qds[i], qds[j], _ = resolve_collision(
                world.bodies[i], qs[i], qds[i],
                world.bodies[j], qs[j], qds[j],
                batch, dt, world.solver,
                kin_a=kin_list[i], kin_b=kin_list[j],
                factor_a=factors[i] if factors is not None else None,
                factor_b=factors[j] if factors is not None else None,
            )
    return tuple(qds)
