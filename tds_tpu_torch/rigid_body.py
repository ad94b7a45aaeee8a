"""Single 6-DoF rigid bodies and the per-contact sequential impulse
solver (counterpart of tds_tpu/rigid_body.py; the reference's
rigid_body.hpp and the branchless rb_constraint_solver.hpp).

As in the reference, a dynamic body's world inverse inertia is the
identity unless one is given (the reference never computes it from the
geometry), and a static body's (mass 0) is zero.
"""

from typing import NamedTuple

import torch

from tds_tpu_torch.algebra import quaternion
from tds_tpu_torch.algebra.spatial import cross, matvec
from tds_tpu_torch.collision.narrowphase import safe_norm


class RigidBodyState(NamedTuple):
    position: torch.Tensor  # (..., 3)
    orientation: torch.Tensor  # (..., 4) xyzw
    linear_velocity: torch.Tensor
    angular_velocity: torch.Tensor
    total_force: torch.Tensor
    total_torque: torch.Tensor

    @staticmethod
    def create(position=None, orientation=None, dtype=torch.float32, device=None):
        z = torch.zeros(3, dtype=dtype, device=device)
        return RigidBodyState(
            position=z if position is None else torch.as_tensor(position, dtype=dtype, device=device),
            orientation=quaternion.identity(dtype, device) if orientation is None
            else torch.as_tensor(orientation, dtype=dtype, device=device),
            linear_velocity=z,
            angular_velocity=z,
            total_force=z,
            total_torque=z,
        )


class RigidBodyParams(NamedTuple):
    mass: torch.Tensor  # (); 0 is static
    inv_inertia_world: torch.Tensor  # (3, 3)

    @staticmethod
    def create(mass, inv_inertia_world=None, dtype=torch.float32, device=None):
        mass = torch.as_tensor(mass, dtype=dtype, device=device)
        if inv_inertia_world is None:
            eye = torch.eye(3, dtype=dtype, device=device)
            inv_inertia_world = torch.where(mass == 0.0, torch.zeros_like(eye), eye)
        return RigidBodyParams(mass, torch.as_tensor(inv_inertia_world, dtype=dtype, device=device))

    @property
    def inv_mass(self):
        return torch.where(self.mass == 0.0, torch.zeros_like(self.mass), 1.0 / self.mass.clamp_min(1e-30))


def apply_gravity(state: RigidBodyState, params: RigidBodyParams, gravity) -> RigidBodyState:
    gravity = torch.as_tensor(gravity, dtype=state.total_force.dtype, device=state.total_force.device)
    return state._replace(total_force=state.total_force + params.mass * gravity)


def apply_central_force(state: RigidBodyState, force) -> RigidBodyState:
    return state._replace(total_force=state.total_force + force)


def apply_force_impulse(state: RigidBodyState, params: RigidBodyParams, dt) -> RigidBodyState:
    """The accumulated force and torque integrated into the velocities."""
    return state._replace(
        linear_velocity=state.linear_velocity + state.total_force * params.inv_mass * dt,
        angular_velocity=state.angular_velocity + matvec(params.inv_inertia_world, state.total_torque) * dt,
    )


def point_velocity(state: RigidBodyState, rel_pos):
    return state.linear_velocity + cross(state.angular_velocity, rel_pos)


def apply_impulse(state: RigidBodyState, params: RigidBodyParams, impulse, rel_pos) -> RigidBodyState:
    """An impulse at a point relative to the centre of mass."""
    return state._replace(
        linear_velocity=state.linear_velocity + params.inv_mass * impulse,
        angular_velocity=state.angular_velocity + matvec(params.inv_inertia_world, cross(rel_pos, impulse)),
    )


def clear_forces(state: RigidBodyState) -> RigidBodyState:
    z = torch.zeros_like(state.total_force)
    return state._replace(total_force=z, total_torque=z)


def integrate(state: RigidBodyState, dt) -> RigidBodyState:
    """Explicit Euler, the orientation by its world-frame quaternion
    increment."""
    return state._replace(
        position=state.position + state.linear_velocity * dt,
        orientation=quaternion.integrate_world(state.orientation, state.angular_velocity, dt),
    )


def resolve_contact_sequential_impulse(
    state_a: RigidBodyState,
    params_a: RigidBodyParams,
    state_b: RigidBodyState,
    params_b: RigidBodyParams,
    normal_on_b,
    point_a,
    point_b,
    distance,
    dt,
    friction=0.5,
    restitution=0.0,
    erp: float = 0.1,
):
    """One contact's normal and Coulomb friction impulse, branchless.
    Returns (state_a', state_b')."""
    rel_pos_a = point_a - state_a.position
    rel_pos_b = point_b - state_b.position
    active = (distance < 0.0).to(distance.dtype)
    baumgarte = erp * distance / dt
    rel_vel = point_velocity(state_a, rel_pos_a) - point_velocity(state_b, rel_pos_b)
    vn = (normal_on_b * rel_vel).sum(-1)
    approaching = (vn < 0.0).to(distance.dtype)
    t1 = matvec(params_a.inv_inertia_world, cross(rel_pos_a, normal_on_b))
    t2 = matvec(params_b.inv_inertia_world, cross(rel_pos_b, normal_on_b))
    ang = (normal_on_b * (cross(t1, rel_pos_a) + cross(t2, rel_pos_b))).sum(-1)
    denom = params_a.inv_mass + params_b.inv_mass + ang
    impulse = (-(1.0 + restitution) * vn - baumgarte) / denom
    impulse = impulse * active * approaching
    impulse_vec = impulse[..., None] * normal_on_b

    lateral = rel_vel - vn[..., None] * normal_on_b
    lat_norm = safe_norm(lateral)
    friction_impulse = torch.minimum(lat_norm / denom, friction * impulse)
    inv = torch.where(lat_norm > 0.0, 1.0 / lat_norm.clamp_min(1e-30), torch.zeros_like(lat_norm))
    impulse_vec = impulse_vec - friction_impulse[..., None] * (lateral * inv[..., None])
    return (
        apply_impulse(state_a, params_a, impulse_vec, rel_pos_a),
        apply_impulse(state_b, params_b, -impulse_vec, rel_pos_b),
    )
