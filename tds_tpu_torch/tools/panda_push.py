"""A Franka Panda pushes a box across the ground, B scenes at once: the
counterpart of ``examples/panda_push.py``, batched.

    python -m tds_tpu_torch.tools.panda_push [--batch 4096] [--seed 0] [--dtype float32] [--device cpu]

The scene is the example's: ``franka_panda/panda.urdf`` (9 DoF, a fixed
base) with a 2.5 cm sphere on ``panda_grasptarget`` as its end effector, a
floating 6 cm box of 0.2 kg and a ground plane; friction 0.3, 10 PGS
sweeps. Damped Levenberg-Marquardt IK (200 iterations, the second waypoint
started from the first) puts the end effector at the start and the end of
the stroke, (0.45, 0, 0.05) to (0.68, 0, 0.05); PD (kp 200, kd 10, 87 N m
at most) tracks the line between them over 700 of the 1000 steps of 1 ms.
``world.world_step`` resolves the contacts pair by pair (plane-arm: 3 MLCP
rows, plane-box: 24, arm-box: 3), each through K1 on the card.

Scene 0 starts the box at the example's x = 0.56; the others at 0.56 +
U(-5 mm, +5 mm), drawn from ``--seed`` with a ``torch.Generator``. The
steps run as one ``graphs.scan`` (replayed CUDA graphs on the card, the
Python loop on the CPU). The command prints scene 0's box x and z at the
example's five times, how far each box went, and env-steps/s.
"""

import argparse
import time

import numpy as np
import torch

from tds_tpu_torch.contact.mlcp import ContactSolverParams
from tds_tpu_torch.control.ik import IKMethod, IKTarget, inverse_kinematics
from tds_tpu_torch.control.pd import pd_tau
from tds_tpu_torch.model.geometry import Box, GeomAttachment, Sphere
from tds_tpu_torch.model.multibody import MultiBodyBuilder
from tds_tpu_torch.urdf.cache import construct
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant, resolve_device
from tds_tpu_torch.world import build_world, make_ground_plane, world_step

# the example's constants: the Panda's "home" pose (7 arm joints, 2
# fingers), the end effector's link (panda_grasptarget), the stroke, the box
HOME_Q = (0.0, 0.2, 0.0, -2.0, 0.0, 2.2, 0.79, 0.02, 0.02)
EE_LINK = 11
PUSH_START = (0.45, 0.0, 0.05)
PUSH_END = (0.68, 0.0, 0.05)
BOX_EXTENTS = (0.06, 0.06, 0.06)
BOX_START_X = 0.56
BOX_MASS = 0.2
STEPS, STROKE_STEPS, DT = 1000, 700, 1e-3
KP, KD, MAX_FORCE = 200.0, 10.0, 87.0
GRAVITY = (0.0, 0.0, -9.81)
START_JITTER = 5e-3  # scenes past the first start the box at BOX_START_X + U(-5 mm, +5 mm)
PUSHED = 0.04  # the example's criterion: the box went more than 4 cm
REPORT_STEPS = (0, 200, 400, 600, 800)  # the example prints the box after these steps (0-based)


def build_scene(dtype=torch.float64, device=None):
    """(world, arm, box): the ground, the Panda with its end-effector
    sphere, and the box, on ``device`` (the card by default)."""
    device = resolve_device(device)
    arm, _ = construct("franka_panda/panda.urdf", dtype=dtype)
    arm = arm.to(device, dtype)
    b = MultiBodyBuilder(is_floating=True, name="box")
    b.set_base_inertia(BOX_MASS, (0, 0, 0), np.diag(Box(BOX_EXTENTS).local_inertia(BOX_MASS)))
    box = b.finalize(dtype=dtype, device=device)
    world = build_world(
        [
            make_ground_plane(dtype=dtype, device=device),
            (arm, (GeomAttachment(link_index=EE_LINK, shape=Sphere(0.025), friction=0.3),)),
            (box, (GeomAttachment(link_index=-1, shape=Box(BOX_EXTENTS), friction=0.3),)),
        ],
        solver=ContactSolverParams(pgs_iterations=10),
    )
    return world, arm, box


def ik_waypoints(arm):
    """The joint targets (9,) for the start and the end of the stroke, in
    the arm's dtype and on its device; raises if IK does not converge."""
    dtype, device = arm.mass.dtype, arm.mass.device
    q0 = torch.tensor(HOME_Q, dtype=dtype, device=device)
    qs = []
    for target in (PUSH_START, PUSH_END):
        res = inverse_kinematics(
            arm, [IKTarget(link_index=EE_LINK, position=torch.tensor(target, dtype=dtype, device=device))], q0,
            method=IKMethod.DAMPED_LM, max_iterations=200,
        )
        if not bool(res.converged):
            raise RuntimeError(f"IK did not converge for {target}: residual {float(res.residual)}")
        qs.append(res.q)
        q0 = res.q  # the next waypoint starts from this one
    return qs


def box_starts(batch: int, seed: int, dtype=torch.float64, device=None):
    """(B,) box start x: BOX_START_X for scene 0, BOX_START_X + U(-5 mm, +5
    mm) for the others, drawn on the CPU from a ``torch.Generator`` seeded
    with ``seed`` (the same draws on every device)."""
    gen = torch.Generator().manual_seed(seed)
    jitter = (torch.rand(batch, generator=gen, dtype=torch.float64) * 2.0 - 1.0) * START_JITTER
    jitter[0] = 0.0
    return (BOX_START_X + jitter).to(device=device, dtype=dtype)


def initial_state(world, q_ik0, box_x):
    """(qs, qds) of every body at the stroke's start: the ground's (B, 0),
    the arm at rest at ``q_ik0`` (9,), the box at rest on the ground at x =
    ``box_x`` (B,), 0.1 mm into it."""
    _, arm, box = world.bodies
    batch = box_x.shape[0]
    ground = box_x.new_zeros(batch, 0)
    box_q = box.zero_q((batch,))
    box_q[:, 4] = box_x
    box_q[:, 6] = BOX_EXTENTS[2] / 2 - 1e-4
    qs = (ground, q_ik0.expand(batch, -1).clone(), box_q)
    qds = (ground, arm.zero_qd((batch,)), box.zero_qd((batch,)))
    return qs, qds


def make_step(world):
    """The body of one step for ``graphs.scan``: carry (the three bodies'
    q, their qd, the step index (B,)), consts (q_ik0 (9,), q_ik1 (9,),
    gravity (3,)). The PD target runs from q_ik0 to q_ik1 over STROKE_STEPS
    steps and holds there."""
    _, arm, box = world.bodies

    def step(carry, consts):
        q_ik0, q_ik1, gravity = consts
        qs, qds, i = carry[0:3], carry[3:6], carry[6]
        frac = torch.clamp(i / STROKE_STEPS, 0.0, 1.0)[:, None]
        q_target = q_ik0 + frac * (q_ik1 - q_ik0)
        tau = pd_tau(arm, qs[1], qds[1], q_target, kp=KP, kd=KD, max_force=MAX_FORCE)
        taus = (None, tau, None)
        qs, qds = world_step(world, qs, qds, taus, gravity, DT)
        return (*qs, *qds, i + 1)

    return step


def push(world, q_ik0, q_ik1, box_x, steps=STEPS, report=REPORT_STEPS):
    """Every scene's push from the stroke's start: (final qs, final qds, the
    box's (x, z) (B, 2) after each step of ``report``, 0-based). Runs as
    ``graphs.scan`` calls between the reported steps, one graph for all of
    them on the card."""
    qs, qds = initial_state(world, q_ik0, box_x)
    carry = (*qs, *qds, box_x.new_zeros(box_x.shape))
    gravity = constant(GRAVITY, box_x.dtype, box_x.device)
    step = make_step(world)
    seen, done = [], 0
    for end in sorted({r + 1 for r in report} | {steps}):
        carry = scan(step, carry, (q_ik0, q_ik1, gravity), end - done, key=("panda push", world))
        done = end
        if end - 1 in report:
            seen.append(torch.stack([carry[2][:, 4], carry[2][:, 6]], dim=-1))
    return carry[0:3], carry[3:6], seen


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--steps", type=int, default=STEPS)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dtype = getattr(torch, args.dtype)
    world, arm, _ = build_scene(dtype=dtype, device=args.device)
    q_ik0, q_ik1 = ik_waypoints(arm)
    print(f"IK waypoints solved: stroke {PUSH_START} -> {PUSH_END}")
    box_x = box_starts(args.batch, args.seed, dtype, q_ik0.device)
    t0 = time.perf_counter()
    push(world, q_ik0, q_ik1, box_x, steps=2, report=())  # the card captures its graph here
    if q_ik0.device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qs, _, seen = push(world, q_ik0, q_ik1, box_x, steps=args.steps, report=[r for r in REPORT_STEPS if r < args.steps])
    moved = (qs[2][:, 4] - box_x).cpu()  # synchronises
    seconds = time.perf_counter() - t0
    print(f"{args.batch} scenes x {args.steps} steps in {seconds:.2f} s ({args.batch * args.steps / seconds:.1f} env-steps/s, "
          f"{seconds * 1e3 / args.steps:.3f} ms/step) on {q_ik0.device}, {args.dtype}; the 2-step call before it {first_s:.2f} s")
    for r, xz in zip(REPORT_STEPS, seen):
        print(f"  t={r / 1000:.1f}s  box x={xz[0, 0].item():+.3f} m  z={xz[0, 1].item():.3f} m")
    ok = moved > PUSHED
    print(f"final: scene 0's box pushed {moved[0].item() * 100:.1f} cm ({'ok' if ok[0] else 'TOO SHORT'}), "
          f"z={qs[2][0, 6].item():.3f} m; {int(ok.sum())} of {args.batch} boxes pushed more than {PUSHED * 100:.0f} cm")
    return qs, moved


if __name__ == "__main__":
    main()
