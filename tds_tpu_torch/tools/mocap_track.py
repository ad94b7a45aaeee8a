"""B laikagos track the sidestep-dance mocap clip with PD control through
contact, each at its own speed: the counterpart of
``examples/laikago_mocap_tracking.py``, batched.

    python -m tds_tpu_torch.tools.mocap_track [--batch 4096] [--steps 2500] [--speedup_range 0.8 1.2] \\
        [--seed 0] [--dtype float32] [--device cpu] [--fused | --eager]

The example's run: ``laikago_dance_sidestep0.txt`` (208 frames of 19
values: the root's position and quaternion, then 12 joint angles), blended
with ``Motion.calculate_frame`` at every 1 ms step; ``LaikagoEnv(
action_limit=1.2)`` PD-tracks the blended joint angles from its standing
start. Env i plays the clip at speed s_i: its target at step k is
``calculate_frame(k * dt * s_i)[7:19]`` and its action that target less
the initial poses. Env 0 runs at 1.0, the example's own run; the others
spread evenly over ``--speedup_range``. The start's joint noise is drawn
from ``--seed`` on the CPU (the same draws on every device).

``--fused`` (the default) steps through the fused step kernel K2
(``LaikagoEnv(fused_step=True)``); ``--eager`` through the eager step,
whose contact solve is the PGS kernel K1 at 12 rows. Each step is one
replayed CUDA graph on the card (the step index in the carry, so the
blend reads nothing from the host), the Python loop on the CPU.

The example's criterion, per env: the mean joint RMS after the first
fifth of the steps below 0.25 rad, the base's minimum height above 0.2 m
and its minimum up.z above 0.8. The command prints env 0's three numbers,
the share of the batch that meets the criterion and env-steps/s, and exits
0 when env 0 meets it ("tracking OK"), 1 otherwise ("tracking FAILED").
"""

import argparse
import time

import torch

from tds_tpu_torch.envs.laikago import LaikagoEnv
from tds_tpu_torch.utils.file_utils import find_file
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.motion_import import Motion

DANCE = "laikago_dance_sidestep0.txt"
STEPS = 2500
ACTION_LIMIT = 1.2  # the dance's targets swing wider than the RL action box
SPEEDUP_RANGE = (0.8, 1.2)
JOINTS = slice(7, 19)  # a frame's joint angles, after the root's position and quaternion
RMS_MAX, HEIGHT_MIN, UP_MIN = 0.25, 0.2, 0.8  # the example's criterion


def make_env(dtype=torch.float32, device=None, fused: bool = True):
    """The example's env (``action_limit`` 1.2), K2's step with ``fused``."""
    return LaikagoEnv(dtype=dtype, device=device, action_limit=ACTION_LIMIT, fused_step=fused)


def load_motion(dtype=torch.float32, device=None) -> Motion:
    return Motion.load_from_file(find_file(DANCE), dtype=dtype, device=device)


def speedups(batch: int, lo: float = SPEEDUP_RANGE[0], hi: float = SPEEDUP_RANGE[1], dtype=torch.float32, device=None):
    """(B,) clip speeds: evenly over [lo, hi], env 0 at 1.0."""
    s = torch.linspace(lo, hi, batch, dtype=torch.float64)
    s[0] = 1.0
    return s.to(device=device, dtype=dtype)


def start_state(env, batch: int, seed: int = 0):
    """The standing start with joint noise drawn on the CPU from ``seed``."""
    noise = env.draw_reset_noise(torch.Generator().manual_seed(seed), batch)
    return env.initial_state(noise=noise)


def track_step(env, motion: Motion, q, qd, k, speedup):
    """One step of the example's loop for every env: (q, qd, joint RMS
    error (B,), base height (B,), up.z (B,)) after it. ``k`` (B,) is the
    step index in q's dtype, ``speedup`` (B,) each env's clip speed."""
    t = k * env.dt * speedup
    target = motion.calculate_frame(t)[:, JOINTS]
    q, qd = env.sim_step(q, qd, target - env.initial_poses)
    err = q[:, 6:18] - target
    pos, up = env.base_pose_xyz_rpy(q)
    return q, qd, torch.sqrt((err**2).mean(-1)), pos[:, 2], up


def make_body(env, motion: Motion):
    """The body of one step for ``graphs.scan``: carry (q, qd, k, the RMS
    summed over the steps at or past ``settle``, the minimum height, the
    minimum up.z), consts (speedup (B,), settle ())."""

    def body(carry, consts):
        q, qd, k, rms_sum, height_min, up_min = carry
        speedup, settle = consts
        q, qd, rms, height, up = track_step(env, motion, q, qd, k, speedup)
        rms_sum = rms_sum + torch.where(k >= settle, rms, 0.0)
        return q, qd, k + 1.0, rms_sum, torch.minimum(height_min, height), torch.minimum(up_min, up)

    return body


@torch.no_grad()
def track(env, motion: Motion, speedup, steps: int = STEPS, seed: int = 0, start=None):
    """Every env's run of ``steps`` steps from the noisy standing start (or
    ``start`` = (q, qd)): a dict of the final q and qd and, per env, the
    mean RMS after the first fifth (``rms``), the minimum height and up.z,
    and whether the criterion holds (``ok``)."""
    batch = speedup.shape[0]
    q, qd = start_state(env, batch, seed) if start is None else start
    zero = q.new_zeros(batch)
    settle = steps // 5
    carry = (q, qd, zero, zero, torch.full_like(zero, float("inf")), torch.full_like(zero, float("inf")))
    consts = (speedup.to(q.device, q.dtype), q.new_full((), float(settle)))
    q, qd, _, rms_sum, height_min, up_min = scan(make_body(env, motion), carry, consts, steps, key=("mocap track", env, motion))
    rms = rms_sum / max(steps - settle, 1)
    ok = (rms < RMS_MAX) & (height_min > HEIGHT_MIN) & (up_min > UP_MIN)
    return {"q": q, "qd": qd, "rms": rms, "height_min": height_min, "up_min": up_min, "ok": ok}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--steps", type=int, default=STEPS, help="1 ms steps")
    p.add_argument("--speedup_range", type=float, nargs=2, default=SPEEDUP_RANGE)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--fused", dest="fused", action="store_true", default=True, help="step through K2 (the default)")
    mode.add_argument("--eager", dest="fused", action="store_false", help="step eagerly, the contact solve through K1")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dtype = getattr(torch, args.dtype)
    env = make_env(dtype, args.device, args.fused)
    motion = load_motion(dtype, env.device)
    print(f"motion: {motion.frames.shape[0]} frames x {motion.frames.shape[1]} values, {motion.total_duration:.2f} s, "
          f"frame_duration={motion.frame_duration * 1e3:.1f} ms")
    speed = speedups(args.batch, *args.speedup_range, dtype=dtype, device=env.device)
    t0 = time.perf_counter()
    track(env, motion, speed, steps=2, seed=args.seed)  # the card captures its graph here
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = track(env, motion, speed, steps=args.steps, seed=args.seed)
    ok = out["ok"].cpu()  # synchronises
    seconds = time.perf_counter() - t0
    step = "K2 (fused)" if args.fused else "the eager step (K1)"
    print(f"{args.batch} envs x {args.steps} steps ({args.steps * env.dt:.1f} s simulated) through {step} in {seconds:.2f} s "
          f"({args.batch * args.steps / seconds:.1f} env-steps/s) on {env.device}, {args.dtype}; the 2-step call before it "
          f"{first_s:.2f} s")
    rms, height, up = (out[k][0].item() for k in ("rms", "height_min", "up_min"))
    print(f"env 0 (speedup 1.0): joint tracking RMS (after the first fifth) {rms:.4f} rad (< {RMS_MAX}), base height min "
          f"{height:.3f} m (> {HEIGHT_MIN}), upright (up.z) min {up:.3f} (> {UP_MIN})")
    print(f"{int(ok.sum())} of {args.batch} envs ({100.0 * ok.double().mean().item():.1f}%) meet the criterion at speedups "
          f"{args.speedup_range[0]}-{args.speedup_range[1]}")
    print("tracking OK" if ok[0] else "tracking FAILED")
    return 0 if ok[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
