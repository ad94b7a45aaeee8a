"""The port's counterpart of the JAX package's
``tools/pallas_megastep_experiment.py``: the fused laikago step
(``tds_tpu_torch.envs.fused_step``, kernel K2) against the eager
``LaikagoEnv.sim_step``.

    python -m tds_tpu_torch.tools.megastep [--batch 16384] [--steps 100]

tiles one standing start over the batch, holds one fused step against one
eager step (max |dq| and |dqd|), then times ``--steps`` steps of each and
prints env-steps/s and the ratio. Importing this module builds and runs
nothing.
"""

import argparse
import functools
import time

import torch

from tds_tpu_torch.envs.fused_step import mega_step, pack_step_params


def timed_steps(step, q, qd, action, steps):
    """``steps`` calls of ``step(q, qd, action)`` from (q, qd); returns
    (q, qd, host seconds from synchronize to synchronize)."""
    _sync(q)
    t0 = time.perf_counter()
    for _ in range(steps):
        q, qd = step(q, qd, action)
    _sync(q)
    return q, qd, time.perf_counter() - t0


def _sync(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16384)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--device", default=None, help="default: the CUDA device")
    args = parser.parse_args(argv)
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    env = LaikagoEnv(dtype=torch.float32, device=args.device)
    fused = functools.partial(mega_step, pack_step_params(env))
    q0, qd0 = env.initial_state(torch.Generator(device=env.device).manual_seed(0))
    qs, qds = q0.expand(args.batch, -1).contiguous(), qd0.expand(args.batch, -1).contiguous()
    zero = qs.new_zeros(args.batch, env.action_dim)

    # correctness and first call (the kernel's build included)
    mq, mqd, mega_first = timed_steps(fused, qs, qds, zero, 1)
    xq, xqd, eager_first = timed_steps(env.sim_step, qs, qds, zero, 1)
    print(f"first call: mega={mega_first:.1f}s eager={eager_first:.1f}s")
    print(f"max|dq|={(mq - xq).abs().max().item():.3e} max|dqd|={(mqd - xqd).abs().max().item():.3e}")

    def rate(step):
        best = min(timed_steps(step, qs, qds, zero, args.steps)[2] for _ in range(3))
        return args.batch * args.steps / best

    mega_sps, eager_sps = rate(fused), rate(env.sim_step)
    print(
        f"batch={args.batch} on {env.device}: mega={mega_sps:.1f} env-steps/s, "
        f"eager={eager_sps:.1f} env-steps/s, ratio={mega_sps / eager_sps:.2f}x"
    )


if __name__ == "__main__":
    main()
