"""Where the fused step kernel K2 spends its time: ``csrc/megastep.cu`` cut
after each of its phases and timed on the card.

    python -m tds_tpu_torch.tools.megastep_phases [--batch 16384]

builds ``csrc/megastep_phases.cu``, K2 whose kernel returns after its k-th
``PHASE_END`` when ``tds_megastep_set_stop(k)`` has set k, and after the
last when k is 0. It then runs one float32 step at ``--batch`` envs, from
states 100 steps after a standing start (every toe down), and prints each
cut's device time beside the difference to the cut before it, which is
that phase's time. The uncut build is held to the package's kernel to the
bit. Importing this module builds and runs nothing.
"""

import argparse
import ctypes
import functools

import torch

# the kernel's phases, in order; PHASE_END(k) follows the k-th but the last
PHASES = (
    "load q, qd (and the launch)",
    "PD torques",
    "joint transforms X_parent(q)",
    "FK walk: X_world, v",
    "FK link terms: c, bias force, S world, spheres",
    "factor and bias sweeps, subtrees",
    "factor and bias sweeps, chain",
    "forward sweep, qd += qdd dt",
    "contact rows, J, M^-1 J^T",
    "Delassus rows and PGS",
    "impulse, q and qd out",
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16384)
    args = parser.parse_args(argv)
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.tools.megastep import timed_steps
    from tds_tpu_torch.utils import cuda_build
    from tds_tpu_torch.utils.timing import device_ms

    env = LaikagoEnv(dtype=torch.float32)
    params = fused_step.pack_step_params(env)
    gen = torch.Generator(device=env.device).manual_seed(5)
    q, qd = env.initial_state(gen, batch_size=args.batch)
    zero = torch.zeros(args.batch, env.action_dim, device=env.device)
    q, qd, _ = timed_steps(functools.partial(fused_step.mega_step, params), q, qd, zero, 100)
    action = (torch.rand(args.batch, env.action_dim, generator=gen, device=env.device) - 0.5) * 0.8

    lib = fused_step.bind(ctypes.CDLL(str(cuda_build.build("megastep_phases.cu"))))
    lib.tds_megastep_set_stop.argtypes = [ctypes.c_int]

    def stop_after(k):
        rc = lib.tds_megastep_set_stop(k)
        if rc != 0:
            raise RuntimeError(f"setting the cut failed with CUDA error {rc}")

    def step():
        return fused_step.launch(lib, params, q, qd, action)

    stop_after(0)
    expected = fused_step.mega_step(params, q, qd, action)
    for got, want in zip(step(), expected):
        if not torch.equal(got, want):
            raise AssertionError("the uncut build differs from the package's kernel")
    name = torch.cuda.get_device_name(0)
    print(f"K2 by phase on {name}: float32, batch {args.batch}, {fused_step.LANES_PER_ENV} lanes per env (device us per launch)")
    before = 0.0
    for k, phase in enumerate(PHASES, start=1):
        stop_after(k if k < len(PHASES) else 0)
        ms = device_ms(step, rounds=3, per_round=20)
        print(f"  {k:2d} {phase:48s} cut {ms * 1e3:8.2f}  phase {(ms - before) * 1e3:8.2f}")
        before = ms


if __name__ == "__main__":
    main()
