"""A ball's shot on the plane and the gradient of where it stops, through
``world_step``'s MLCP contact: one ball of ``examples/billiard_optimization.py``
(radius 6 cm, 0.17 kg, friction 0.2, restitution 0.9, 4 PGS sweeps, dt 2.5
ms) rolling on the ground; the example's second ball, the target it hits,
is left out of this loss.

    python -m tds_tpu_torch.tools.ball_loss [--steps 100] [--device cpu]

The loss is the example's: the squared distance of the ball's final (x, y)
from the goal (0.9, 0.2), a function of its initial (x, y) velocity. The
rollout is :func:`tds_tpu_torch.world.world_rollout`, one ``graphs.scan``:
on the card its backward replays the step's VJP graph, K1's backward at 3
rows inside. The command prints the gradient, central differences of the
same loss and the seconds each took, in float64.
"""

import argparse
import time

import numpy as np
import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.model.geometry import GeomAttachment, Sphere
from tds_tpu_torch.model.multibody import MultiBodyBuilder
from tds_tpu_torch.utils.tensors import constant, resolve_device
from tds_tpu_torch.world import build_world, make_ground_plane, world_rollout

RADIUS, MASS = 0.06, 0.17
GOAL, DT, GRAVITY = (0.9, 0.2), 2.5e-3, (0.0, 0.0, -9.81)
VELOCITY, FD_EPS = (2.0, 0.3), 1e-6  # the example's starting shot, and a central-difference step


def ball_world(dtype=torch.float64, device=None):
    """The ground plane and one floating ball (no links: q is 7 wide, qd 6)."""
    device = resolve_device(device)
    b = MultiBodyBuilder(is_floating=True, name="ball")
    b.set_base_inertia(MASS, (0.0, 0.0, 0.0), np.diag([0.4 * MASS * RADIUS**2] * 3))
    ball = b.finalize(dtype=dtype, device=device)
    geom = (GeomAttachment(link_index=-1, shape=Sphere(RADIUS), friction=0.2, restitution=0.9),)
    solver = ContactSolverParams(restitution=0.9, friction=0.2, pgs_iterations=4)
    return build_world([make_ground_plane(dtype=dtype, device=device), (ball, geom)], solver=solver)


def final_xy(world, velocity, steps: int):
    """(B, 2) final (x, y) of balls started at rest on the plane at the
    origin with (x, y) velocity ``velocity`` (B, 2)."""
    ball = world.bodies[1]
    batch = velocity.shape[:-1]
    q0 = ball.zero_q(batch)
    q0[..., 6] = RADIUS
    qd0 = torch.cat([velocity.new_zeros(batch + (3,)), velocity, velocity.new_zeros(batch + (1,))], dim=-1)
    ground = velocity.new_zeros(batch + (0,))
    gravity = constant(GRAVITY, velocity.dtype, velocity.device)
    qs, _ = world_rollout(world, (ground, q0), (ground, qd0), gravity, DT, steps)
    return qs[1][..., 4:6]


def loss(world, velocity, steps: int):
    """(B,) squared distance of each ball's final (x, y) from GOAL."""
    goal = constant(GOAL, velocity.dtype, velocity.device)
    return ((final_xy(world, velocity, steps) - goal) ** 2).sum(-1)


def gradient(world, velocity, steps: int):
    """(loss (B,), d loss / d velocity (B, 2))."""
    v = velocity.detach().clone().requires_grad_()
    with torch.enable_grad():
        value = loss(world, v, steps)
        (grad,) = torch.autograd.grad(value.sum(), v)
    return value.detach(), grad


def central_differences(world, velocity, steps: int, eps: float = FD_EPS):
    """(B, 2) central differences of the loss in each velocity component."""
    cols = []
    with torch.no_grad():
        for k in range(2):
            step = torch.zeros_like(velocity)
            step[..., k] = eps
            cols.append((loss(world, velocity + step, steps) - loss(world, velocity - step, steps)) / (2 * eps))
    return torch.stack(cols, dim=-1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    world = ball_world(device=args.device)
    velocity = torch.tensor([VELOCITY], dtype=torch.float64, device=world.bodies[1].device)
    t0 = time.perf_counter()
    value, grad = gradient(world, velocity, args.steps)
    t1 = time.perf_counter()
    fd = central_differences(world, velocity, args.steps)
    t2 = time.perf_counter()
    print(f"loss {float(value[0]):.12g} over {args.steps} steps on {velocity.device}")
    for name, g, f in zip(("vx", "vy"), grad[0].tolist(), fd[0].tolist()):
        print(f"d/d {name}: {g:.10e} (central differences {f:.10e}, relative {abs(g - f) / max(abs(f), 1e-300):.2e})")
    print(f"gradient {t1 - t0:.2f} s, central differences {t2 - t1:.2f} s")


if __name__ == "__main__":
    main()
