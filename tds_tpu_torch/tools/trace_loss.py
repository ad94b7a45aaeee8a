"""How often torch.profiler loses records from a trace of graph replays, on
the card:

    python -m tds_tpu_torch.tools.trace_loss [--traces 15] [--steps 20] [--batch 4096] [--busy 12]

The hopper's zero-policy rollout of ``--steps`` steps at ``--batch``, replayed
through its CUDA graphs, is traced ``--traces`` times in each of four
settings: ``utils.timing.device_trace`` with no padding and with its
default padding, each with the host idle and with ``--busy`` processes
spinning on the host's cores. For each setting the tool prints one JSON line:
how many traces held each (device events, K1 kernels) pair, and the seconds
the setting took. A replay runs the same work every time, so every count
below the most seen, and every K1 count below ``--steps``, is records lost.
The spinning processes are stopped before the tool exits.
"""

import argparse
import collections
import inspect
import json
import subprocess
import sys
import time

import torch

from tds_tpu_torch.envs.hopper import HopperEnv
from tds_tpu_torch.learn.nn import linear_policy
from tds_tpu_torch.rollout import rollout
from tds_tpu_torch.utils.timing import device_trace


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--traces", type=int, default=15)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--busy", type=int, default=12)
    args = parser.parse_args()

    env = HopperEnv(dtype=torch.float32)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    state, obs = env.reset(torch.Generator(device=env.device).manual_seed(1), batch_size=args.batch)

    def run():
        rollout(env, policy, None, state, obs, args.steps)

    run()  # captures the graphs
    torch.cuda.synchronize()
    padding = inspect.signature(device_trace).parameters["pad_s"].default
    spinning = []
    try:
        for busy in (0, args.busy):
            spinning += [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(busy)]
            for pad_s in (0.0, padding):
                seen = collections.Counter()
                t0 = time.perf_counter()
                for _ in range(args.traces):
                    events = device_trace(run, pad_s=pad_s)[0]
                    seen[(len(events), sum(1 for e in events if "pgs_kernel" in e.name))] += 1
                print(json.dumps({"busy_processes": busy, "pad_s": pad_s, "steps": args.steps, "batch": args.batch,
                                  "traces": [{"device_events": n, "k1": k, "count": c} for (n, k), c in sorted(seen.items())],
                                  "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        for p in spinning:
            p.kill()
            p.wait()


if __name__ == "__main__":
    main()
