"""Where the MPC walk's controller spends its device time, on the card:

    python -m tds_tpu_torch.tools.mpc_profile [--batch 4096] [--warm 40] [--ticks 2] [--top 10]

Builds ``tools/mpc_walk.py``'s walk in float32 at ``--batch`` envs and
walks ``--warm`` ticks through graphs. Then it replays a graph of the
controller alone (``controller.update``) for ``--ticks`` ticks under
torch.profiler (``utils.timing.device_trace``) and prints one JSON line for
each of the ``--top`` kernel names by device time (launches a tick, us a
launch, share of the controller's device time), then one line of cuBLAS's
share (the kernels named gemv or gemm). Last, it times with CUDA events
(``utils.timing.device_ms``) three forms of FISTA's batched product on a
(batch, 120, 120) P: the column forms baddbmm(q, P, y) and bmm(P, y), and
the row form baddbmm(q, y^T, P) that ``convex_mpc._symv`` runs, each with
the rate at which it reads P.
"""

import argparse
import collections
import json
import subprocess

import torch

from tds_tpu_torch.control.mpc.locomotion import LocomotionMpcState, make_walk_step
from tds_tpu_torch.tools.mpc_walk import CONTROL_EVERY, build
from tds_tpu_torch.utils import graphs
from tds_tpu_torch.utils.timing import device_ms, device_trace


def product_forms(batch, width, dtype=torch.float32):
    """{form: (us a product, TB/s reading P)} on random operands."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.rand(batch, width, width, generator=gen, device="cuda", dtype=dtype)
    y = torch.rand(batch, width, 1, generator=gen, device="cuda", dtype=dtype)
    q = torch.rand(batch, width, 1, generator=gen, device="cuda", dtype=dtype)
    y_row, q_row = y.transpose(-1, -2).contiguous(), q.transpose(-1, -2).contiguous()
    forms = {
        "baddbmm(q, P, y)": lambda: torch.baddbmm(q, p, y),
        "bmm(P, y)": lambda: torch.bmm(p, y),
        "baddbmm(q, y^T, P)": lambda: torch.baddbmm(q_row, y_row, p),
    }
    out = {}
    for name, fn in forms.items():
        ms = device_ms(fn, rounds=5, per_round=20)
        out[name] = (ms * 1e3, p.numel() * p.element_size() / (ms * 1e-3) / 1e12)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--warm", type=int, default=40)
    parser.add_argument("--ticks", type=int, default=2)
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    env, controller = build(dtype=torch.float32)
    step = make_walk_step(env, controller, CONTROL_EVERY)
    state, _ = env.reset(torch.Generator(device="cuda").manual_seed(0), batch_size=args.batch)
    ctrl, q, qd = step((controller.init_state(state.q), state.q, state.qd), args.warm)

    def controller_only(c, consts):
        new, _ = controller.update(LocomotionMpcState.unflat(c[:5]), c[5], c[6])
        return (*new.flat(), c[5], c[6])

    flat = (*ctrl.flat(), q, qd)
    key = ("mpc profile controller", env, controller)

    def run():
        graphs.scan(controller_only, flat, (), args.ticks, key=key)

    run()  # captures the graph
    events = device_trace(run)[0]
    total_us = sum(us for _, us in events)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, us in events:
        by_name[name][0] += 1
        by_name[name][1] += us
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]:
        print(json.dumps({"kernel": name[:120], "launches_per_tick": count / args.ticks, "us_per_launch": us / count,
                          "share": us / total_us}), flush=True)
    cublas = [(count, us) for name, (count, us) in by_name.items() if "gemv" in name or "gemm" in name]
    print(json.dumps({"batch": args.batch, "controller_device_ms_per_tick": total_us / 1e3 / args.ticks,
                      "device_ops_per_tick": len(events) / args.ticks,
                      "cublas_launches_per_tick": sum(c for c, _ in cublas) / args.ticks,
                      "cublas_share": sum(us for _, us in cublas) / total_us, "card": card}), flush=True)
    width = 12 * controller.config.mpc.planning_horizon
    for name, (us, rate) in product_forms(args.batch, width).items():
        print(json.dumps({"product": name, "shape": [args.batch, width, width], "us": us, "p_read_tb_per_s": rate}), flush=True)


if __name__ == "__main__":
    main()
