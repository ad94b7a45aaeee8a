"""bench.py's ARS recipe on the laikago through K2 in this checkout against
another checkout's port, on the card, in processes that take turns:

    python -m tds_tpu_torch.tools.ars_ab --other DIR [--order otto] [--iterations 5] [--profile_steps 100]

``DIR`` is the root of another checkout (an earlier commit unpacked with
``git archive`` into an ignored directory). ``--order`` runs one process
per letter, ``o`` the other checkout and ``t`` this one. Each process
imports its checkout's ``tds_tpu_torch`` and runs the recipe (128
directions x 3000 steps, top 32, float32, from
``logs/laikago_ars/policy_r2b.pkl``): a warm-up iteration that captures the
graphs, then ``--iterations`` timed ones (host clock, each ending in a
synchronise); then one iteration at ``--profile_steps`` steps under
torch.profiler: device operations per env step (the reset's settle steps
counted), K2's kernels (one a step) and K2's share of the device-busy
time. Both checkouts build their kernels into one build directory, so
identical sources build once. Prints each process's JSON line and, last, a
summary by checkout (median s/iteration over all its timed iterations).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

THIS = Path(__file__).resolve().parents[2]
CHECKPOINT = THIS / "logs" / "laikago_ars" / "policy_r2b.pkl"
RECIPE = {"num_directions": 128, "rollout_length": 3000, "top_directions": 32}


def worker(root: str, iterations: int, profile_steps: int) -> dict:
    """The recipe in the checkout at ``root``; returns its numbers."""
    sys.path.insert(0, root)  # ahead of PYTHONPATH: this checkout's package is imported
    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.utils.timing import counted_trace

    env = LaikagoEnv(dtype=torch.float32, fused_step=True)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    saved, _ = load_checkpoint(str(CHECKPOINT))

    def start():
        return ars_state_from_numpy(saved["params"], saved["obs_stat"], seed=0, dtype=env.dtype)

    step = ars.make_train_step(env, policy, ars.ARSConfig(**RECIPE))
    state, _ = step(start())
    seconds = []
    for _ in range(iterations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    short = ars.make_train_step(env, policy, ars.ARSConfig(**{**RECIPE, "rollout_length": profile_steps}))
    short(start())
    per_step = env.settle_steps + profile_steps
    events, _, _, k2 = counted_trace(lambda: short(start()), "megastep_kernel", per_step)
    busy = sum(us for _, us in events)
    k2_us = sum(us for name, us in events if "megastep_kernel" in name)
    return {
        "root": root, "s_per_iteration": seconds, "g_hat_norm": metrics["g_hat_norm"].item(),
        "device_ops_per_step": len(events) / per_step if events else None, "k2_kernels": k2, "env_steps": per_step,
        "k2_share_of_device_time": k2_us / busy if busy else None,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="the root of the other checkout")
    parser.add_argument("--order", default="otto", help="o: the other checkout, t: this one, a process each")
    parser.add_argument("--iterations", type=int, default=5)
    parser.add_argument("--profile_steps", type=int, default=100)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.iterations, args.profile_steps)), flush=True)
        return 0
    if not args.other or set(args.order) - {"o", "t"}:
        parser.error("--other DIR is required; --order holds only o and t")
    roots = {"o": str(Path(args.other).resolve()), "t": str(THIS)}
    env = dict(os.environ)
    env.setdefault("TDS_TPU_TORCH_BUILD_DIR", str(THIS / "build"))
    runs = {"o": [], "t": []}
    for which in args.order:
        cmd = [sys.executable, __file__, "--worker", roots[which], "--iterations", str(args.iterations),
               "--profile_steps", str(args.profile_steps)]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, cwd=roots[which])
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        result = {"checkout": "other" if which == "o" else "this", **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(result), flush=True)
        runs[which].append(result)
    summary = {}
    for which, label in (("o", "other"), ("t", "this")):
        if runs[which]:
            ops = [r["device_ops_per_step"] for r in runs[which] if r["device_ops_per_step"] is not None]
            shares = [r["k2_share_of_device_time"] for r in runs[which] if r["k2_share_of_device_time"] is not None]
            summary[label] = {
                "median_s_per_iteration": statistics.median(s for r in runs[which] for s in r["s_per_iteration"]),
                "device_ops_per_step": ops, "k2_share_of_device_time": shares,
            }
    print(json.dumps({"device": torch.cuda.get_device_name(0), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
