"""World: bodies, collision geometry and contact resolution (counterpart of
tds_tpu/world.py).

The world is a static description; :func:`resolve_contacts` and
:func:`world_step` are functions over the tuple of body states, and
:func:`world_rollout` runs many steps as one ``graphs.scan``. Pairs are enumerated in Python from the
static geometry lists, producing fixed-size masked contact batches. A
terrain (``Heightfield`` or ``Mesh``) hangs on the zero-DoF ground body
like the plane. ``contact_model`` picks the impulse-level MLCP (``"mlcp"``,
the reference's default, through K1 on the card) or the force-level
spring-damper (``"spring"``, ``World.spring``'s parameters; no LCP).

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
from tds_tpu_torch.contact.spring import SpringContactParams, resolve_collision_spring
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics_from_kin
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.model.geometry import GeomAttachment, Plane
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel, np_rpy
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant


FRICTION_MODES = ("geom_min", "world_default")
CONTACT_MODELS = ("mlcp", "spring")


@dataclasses.dataclass(frozen=True, eq=False)
class World:
    """Compared and hashed by identity (its tensors have no value equality),
    so that it can name a scan's graphs."""

    bodies: Tuple[MultiBodyModel, ...]
    geoms: Tuple[Tuple[GeomAttachment, ...], ...]
    solver: ContactSolverParams = ContactSolverParams()
    contact_model: str = "mlcp"
    friction_mode: str = "geom_min"
    spring: SpringContactParams = SpringContactParams()

    def __post_init__(self):
        if self.friction_mode not in FRICTION_MODES:
            raise ValueError(f"friction_mode must be one of {FRICTION_MODES}, got {self.friction_mode!r}")
        if self.contact_model not in CONTACT_MODELS:
            raise ValueError(f"contact_model must be one of {CONTACT_MODELS}, got {self.contact_model!r}")

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
    spring: SpringContactParams = SpringContactParams(),
    friction_mode: str = "geom_min",
) -> World:
    """The world of the given bodies, each with its collision geoms."""
    return World(
        bodies=tuple(b for b, _ in bodies_and_geoms),
        geoms=tuple(tuple(g) for _, g in bodies_and_geoms),
        solver=solver,
        contact_model=contact_model,
        friction_mode=friction_mode,
        spring=spring,
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
            spring = world.contact_model == "spring"
            qds[i], qds[j], _ = (resolve_collision_spring if spring else resolve_collision)(
                world.bodies[i], qs[i], qds[i],
                world.bodies[j], qs[j], qds[j],
                batch, dt, world.spring if spring else world.solver,
                kin_a=kin_list[i], kin_b=kin_list[j],
                factor_a=factors[i] if factors is not None else None,
                factor_b=factors[j] if factors is not None else None,
            )
    return tuple(qds)


def world_step(world: World, qs, qds, taus, gravity, dt, f_exts=None):
    """One step of every body: ABA, the velocity update, the contact
    impulses, the position update. ``qs``, ``qds`` and ``taus`` are tuples
    with one (B, width) tensor per body (a zero-DoF body's pass through
    unchanged); ``taus`` or an entry of it None is no torque; ``f_exts`` an
    optional tuple of per-body world-frame link forces (see
    :func:`~tds_tpu_torch.dynamics.kinematics.fk_links`). Returns
    (qs, qds)."""
    new_qds, kins, factors = [], [], []
    for i, model in enumerate(world.bodies):
        if model.dof_qd == 0:
            new_qds.append(qds[i])
            kins.append(None)
            factors.append(None)
            continue
        kin = fk_links(model, qs[i], qds[i], f_ext=f_exts[i] if f_exts is not None else None)
        factor = aba_factor(model, kin)
        tau = taus[i] if taus is not None and taus[i] is not None else qs[i].new_zeros(qs[i].shape[:-1] + (model.dof_actuated,))
        qdd = forward_dynamics_from_kin(model, kin, qs[i], qds[i], tau, gravity, factor=factor)
        new_qds.append(integrate_euler_qdd(model, qs[i], qds[i], qdd, dt))
        kins.append(kin)
        factors.append(factor)
    new_qds = resolve_contacts(world, tuple(qs), tuple(new_qds), dt, kins=kins, factors=factors)
    out_qs, out_qds = [], []
    for i, model in enumerate(world.bodies):
        if model.dof_qd == 0:
            out_qs.append(qs[i])
            out_qds.append(new_qds[i])
            continue
        q, qd = integrate_q(model, qs[i], new_qds[i], dt)
        out_qs.append(q)
        out_qds.append(qd)
    return tuple(out_qs), tuple(out_qds)


def world_rollout(world: World, qs, qds, gravity, dt, steps: int, taus=None):
    """``steps`` :func:`world_step`s as one
    :func:`~tds_tpu_torch.utils.graphs.scan` (replayed CUDA graphs on the
    card, a Python loop on the CPU, differentiable in the states, gravity
    and the torques): every body's q and qd, the zero-DoF bodies' (B, 0)
    ones included, are the carry; ``gravity`` (3,) and ``taus`` (a tuple of
    per-body (B, dof_actuated) torques, None for none) the consts. Returns
    (qs, qds)."""
    n = world.num_bodies
    if taus is None:
        taus = tuple(q.new_zeros(q.shape[:-1] + (m.dof_actuated,)) for q, m in zip(qs, world.bodies))

    def body(carry, consts):
        new_qs, new_qds = world_step(world, carry[:n], carry[n:], consts[1:], consts[0], dt)
        return new_qs + new_qds

    out = scan(body, tuple(qs) + tuple(qds), (gravity, *taus), steps, key=("world_rollout", world, dt))
    return out[:n], out[n:]
