"""Laikago trot walking under the whole-body MPC stack (the port's copy
of examples/laikago_mpc_walk.py): gait generator -> Raibert swing legs
(IK, joint PD) -> convex-MPC stance forces -> hybrid torques -> 5 physics
substeps a control tick, on a batch of envs.

    python -m tds_tpu_torch.tools.mpc_walk [--seconds 4] [--speed 0.4] [--batch 1] [--device cpu]

Each tick is one ``graphs.scan`` step: on the card a replayed CUDA graph
of the controller and the substeps, whose contact solves run K1 at 12
rows. It prints env 0's base x, z, up and forward velocity every 40
ticks, then how far and how fast it walked and whether it stayed upright.
"""

import argparse
import time

import torch

from tds_tpu_torch.control.mpc.convex_mpc import MpcConfig
from tds_tpu_torch.control.mpc.gait import GaitConfig
from tds_tpu_torch.control.mpc.locomotion import LocomotionMpcConfig, LocomotionMpcController, make_walk_step
from tds_tpu_torch.envs.laikago import LaikagoEnv

CONTROL_EVERY = 5


def build(desired_speed=(0.4, 0.0, 0.0), dtype=torch.float32, device=None):
    """(env, controller): the example's laikago and its controller (a
    horizon of 10 steps of 25 ms, 300 FISTA iterations, alpha 1e-6, the
    reference's active MPC weights)."""
    env = LaikagoEnv(dtype=dtype, device=device)
    model = env.model
    toe_links = [g.link_index for g in env.world.geoms[1]]
    total_mass = float(model.mass.sum() + model.base_mass)
    mpc_cfg = MpcConfig(
        mass=total_mass,
        inertia=((0.07, 0.0, 0.0), (0.0, 0.25, 0.0), (0.0, 0.0, 0.25)),
        planning_horizon=10,
        timestep=0.025,
        solver_iterations=300,
        alpha=1e-6,
        qp_weights=(5, 5, 0.2, 0, 0, 10, 0, 0, 1, 1, 1, 0, 0),
    )
    cfg = LocomotionMpcConfig(
        mpc=mpc_cfg,
        gait=GaitConfig.laikago_trotting(),
        desired_speed=tuple(desired_speed),
        desired_height=0.42,
    )
    return env, LocomotionMpcController(model, toe_links, cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--speed", type=float, default=0.4)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    env, controller = build(desired_speed=(args.speed, 0.0, 0.0), device=args.device)
    step = make_walk_step(env, controller, control_every=CONTROL_EVERY)
    generator = torch.Generator(device=env.device).manual_seed(args.seed)
    state, _ = env.reset(generator, batch_size=args.batch)
    q, qd = state.q, state.qd
    ctrl = controller.init_state(q)
    ticks = int(args.seconds / (env.dt * CONTROL_EVERY))
    t0 = time.perf_counter()
    done = 0
    while done < ticks:
        n = min(40, ticks - done)
        ctrl, q, qd = step((ctrl, q, qd), n)
        done += n
        pos, up = env.base_pose_xyz_rpy(q)
        print(f"t={done * CONTROL_EVERY * env.dt:5.2f}s x={float(pos[0, 0]):+.3f} z={float(pos[0, 2]):.3f} "
              f"up={float(up[0]):.3f} vx={float(qd[0, 0]):+.2f}")
    seconds = time.perf_counter() - t0
    pos, up = env.base_pose_xyz_rpy(q)
    print(f"final: x={float(pos[0, 0]):+.3f} m in {args.seconds}s ({float(pos[0, 0]) / args.seconds:.2f} m/s), "
          f"upright={float(up[0]) > 0.8}; {args.batch} envs x {ticks * CONTROL_EVERY} steps in {seconds:.2f} s")


if __name__ == "__main__":
    main()
