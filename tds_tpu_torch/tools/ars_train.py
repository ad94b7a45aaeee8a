"""ARS training on the laikago, ant, hopper, half-cheetah or humanoid env,
the port's counterpart of the JAX package's ``examples/laikago_ars_train.py``.

    python -m tds_tpu_torch.tools.ars_train [--env laikago|ant|hopper|halfcheetah|humanoid] \\
        [--num_directions 64] [--rollout_length 400] [--iterations 50] [--eval_interval 10] \\
        [--checkpoint PATH] [--resume PATH] [--device cpu] [--height_bonus 0] \\
        [--crouch_penalty 0] [--crouch_ref 1.2] [--z_damping 0] [--alive_bonus 0] \\
        [--terrain_bump 0] [--terrain_scan 0] [--reset_pool POOL.npz] [--reset_pool_prob 0.5] \
        [--log_root DIR]

Across processes, one device each:

    torchrun --standalone --nproc_per_node=N -m tds_tpu_torch.tools.ars_train ...

With ``WORLD_SIZE`` above 1 every rank joins the process group
(``parallel.distributed.initialize_distributed``: NCCL on cards, gloo on
the CPU), draws the same directions and rolls out its slice of them
(``learn.ars``'s ``mesh``); the update is the same on every rank. Only the
primary rank (rank 0) prints, writes checkpoints and logs.

Every env steps in float32, on the card unless ``--device`` names another.
Laikago steps through the fused step kernel K2
(``LaikagoEnv(fused_step=True)``); the other envs step eagerly, their
contact solve through the PGS kernel K1 (K2 is laikago's: it collides
spheres only with a plane, has no ``top_k`` compaction and no spherical
joint). The five shaping flags act on the humanoid's reward only
(``HumanoidEnv``'s knobs, off by default).

``--terrain_bump B`` (laikago only) trains on the sinusoidal heightfield of
amplitude B metres (:func:`make_terrain_env`: 13 x 7 vertices over
x in [-1, 5], y in [-1.5, 1.5], 3 candidates a toe, the 8 deepest of 12
kept), stepping eagerly through K1 at 24 rows; ``--terrain_scan S`` adds
the first S points of ``SCAN_GRID`` to the observation.
``--reset_pool POOL.npz`` (humanoid only) starts the training rollouts
from the pool's states (arrays ``q`` and ``qd``) with probability
``--reset_pool_prob``; the evals start from the standing start. The checkpoint
defaults to ``./logs/<env>_ars/policy_torch.pkl``, as the JAX trainer's
goes to ``./logs/<env>_ars/``. Metrics stay on the device between evals; every
``--eval_interval`` iterations an eval of 8 rollouts runs, the checkpoint
is written, and ``<checkpoint>.best`` too when the eval's
``eval_reward_min`` beats the best so far (an existing ``.best`` file's
included). ``--resume`` starts from the params and obs_stat of a
checkpoint of either package. Checkpoints are the JAX package's format.
Each run logs through ``utils.experiment.Experiment``: the flags in
``<stamp>/settings.json`` beside the checkpoint (or under
``<log_root>/<env>_ars/``) and every iteration's
metrics in ``metrics.jsonl`` beside it, written at each eval.
"""

import argparse
import os

import torch

ENVS = ("laikago", "ant", "hopper", "halfcheetah", "humanoid")
SHAPING = ("height_bonus", "crouch_penalty", "crouch_ref", "z_damping", "alive_bonus")
# 9 scan points ahead of the base, in its yawed frame: 3 rows at x 0.15,
# 0.35 and 0.55 m, each at y -0.15, 0 and 0.15 m (the next two footsteps
# at laikago's ~1.6 m/s gait)
SCAN_GRID = tuple((x, y) for x in (0.15, 0.35, 0.55) for y in (-0.15, 0.0, 0.15))


def make_terrain_env(bump: float, scan_points: int, dtype=torch.float32, device=None):
    """Laikago on the sinusoidal heightfield z = bump sin(pi x) cos(pi y)
    (13 x 7 vertices over x in [-1, 5], y in [-1.5, 1.5], max_contacts 3),
    with the first ``scan_points`` points of SCAN_GRID in the observation;
    the eager step (K2 takes no terrain)."""
    import math

    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.utils.terrain import make_heightfield

    terrain = make_heightfield(
        13, 7, (-1.0, 5.0), (-1.5, 1.5), lambda x, y: bump * math.sin(math.pi * x) * math.cos(math.pi * y), max_contacts=3
    )
    scan = SCAN_GRID[:scan_points] if scan_points else None
    return LaikagoEnv(dtype=dtype, device=device, terrain=terrain, height_scan=scan)


def make_env(name: str, device=None, **shaping):
    """The float32 training env ``name`` on ``device``; ``shaping`` holds
    the humanoid's reward knobs and, for the humanoid, ``reset_pool`` and
    ``reset_pool_prob``."""
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.envs.hopper import HalfCheetahEnv, HopperEnv
    from tds_tpu_torch.envs.humanoid import HumanoidEnv
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    if name == "laikago":
        return LaikagoEnv(dtype=torch.float32, device=device, fused_step=True)
    if name == "humanoid":
        return HumanoidEnv(dtype=torch.float32, device=device, **shaping)
    envs = {"ant": AntEnv, "hopper": HopperEnv, "halfcheetah": HalfCheetahEnv}
    if name not in envs:
        raise ValueError(f"--env {name}: the trainer's envs are {', '.join(ENVS)}")
    return envs[name](dtype=torch.float32, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", default="laikago", choices=ENVS)
    parser.add_argument("--num_directions", type=int, default=64)
    parser.add_argument("--rollout_length", type=int, default=400)
    parser.add_argument("--delta_std", type=float, default=0.03)
    parser.add_argument("--step_size", type=float, default=0.02)
    parser.add_argument("--top_directions", type=int, default=0)
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--eval_interval", type=int, default=10)
    parser.add_argument("--checkpoint", default=None, help="default: ./logs/<env>_ars/policy_torch.pkl")
    parser.add_argument("--resume", default="", help="checkpoint to warm-start params and obs_stat from")
    parser.add_argument("--seed", type=int, default=0, help="exploration and eval seed")
    parser.add_argument("--device", default=None, help="default: the CUDA device")
    # the humanoid's reward shaping (HumanoidEnv), off by default
    parser.add_argument("--height_bonus", type=float, default=0.0, help="humanoid: + height_bonus * (z - 1)")
    parser.add_argument("--crouch_penalty", type=float, default=0.0, help="humanoid: - crouch_penalty * max(crouch_ref - z, 0)")
    parser.add_argument("--crouch_ref", type=float, default=1.2)
    parser.add_argument("--z_damping", type=float, default=0.0, help="humanoid: - z_damping * vz^2")
    parser.add_argument("--alive_bonus", type=float, default=0.0, help="humanoid: + alive_bonus per live step")
    parser.add_argument("--terrain_bump", type=float, default=0.0, help="laikago: train on a heightfield of this amplitude (m)")
    parser.add_argument("--terrain_scan", type=int, default=0, help="laikago on terrain: height-scan points in the observation")
    parser.add_argument("--reset_pool", default="", help="humanoid: .npz of q and qd states to reset from")
    parser.add_argument("--reset_pool_prob", type=float, default=0.5, help="the probability of a pool reset")
    parser.add_argument("--log_root", default=None, help="the Experiment logs go to <log_root>/<env>_ars/<stamp>/ "
                        "(default: the checkpoint's directory, <dir>/<stamp>/)")
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        args.checkpoint = f"./logs/{args.env}_ars/policy_torch.pkl"
    return args


def join_ranks(args):
    """(mesh, device) under torchrun with WORLD_SIZE above 1: this rank in
    the process group on its device (``--device``, else cuda:LOCAL_RANK);
    (None, ``--device``) alone."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, args.device
    from tds_tpu_torch.parallel.distributed import initialize_distributed
    from tds_tpu_torch.parallel.mesh import make_mesh

    device = initialize_distributed(device=args.device)
    return make_mesh(device), device


def main(argv=None):
    import torch.distributed as dist

    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint, save_checkpoint
    from tds_tpu_torch.learn.ars import ARSConfig, train
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.utils.experiment import trainer_experiment

    args = parse_args(argv)
    mesh, args.device = join_ranks(args)
    primary = mesh is None or mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)  # only rank 0 reports
    shaping = {k: getattr(args, k) for k in SHAPING} if args.env == "humanoid" else {}
    if args.terrain_bump > 0.0:
        if args.env != "laikago":
            raise SystemExit("--terrain_bump is laikago-only for now")
        env = make_terrain_env(args.terrain_bump, args.terrain_scan, device=args.device)
        say(f"terrain mode: +-{args.terrain_bump * 100:.0f} cm heightfield, {args.terrain_scan} height-scan observations")
    else:
        env = make_env(args.env, args.device, **shaping)
    eval_env = env
    if args.reset_pool:
        import numpy as np

        if args.env != "humanoid":
            raise SystemExit("--reset_pool is humanoid-only for now")
        with np.load(args.reset_pool) as pool:
            pool = (pool["q"], pool["qd"])
        env = make_env(args.env, args.device, **shaping, reset_pool=pool, reset_pool_prob=args.reset_pool_prob)
        say(f"reset pool: {pool[0].shape[0]} brink states (p={args.reset_pool_prob})")
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ARSConfig(
        num_directions=args.num_directions,
        rollout_length=args.rollout_length,
        delta_std=args.delta_std,
        step_size=args.step_size,
        top_directions=args.top_directions,
        eval_interval=args.eval_interval,
    )
    if mesh is not None:
        say(f"{mesh.size} ranks ({dist.get_backend()}), {config.num_directions // mesh.size} directions each")
    exp = trainer_experiment(f"{args.env}_ars", vars(args), args.checkpoint, args.log_root).start() if primary else None
    state = None  # train starts from init_ars
    if args.resume:
        saved, meta = load_checkpoint(args.resume)
        state = ars_state_from_numpy(saved["params"], saved["obs_stat"], args.seed, env.dtype, env.device)
        say(f"resumed from {args.resume} (iteration {meta.get('iteration')})")

    # a crash-resume must not clobber an earlier peak: an existing .best
    # file sets the bar its first eval has to beat
    best_path = args.checkpoint + ".best"
    best_eval = -float("inf")
    if os.path.exists(best_path):
        previous = load_checkpoint(best_path)[1].get("eval_reward_min")
        if previous is not None:
            best_eval = float(previous)
            say(f"existing {best_path}: eval_reward_min={best_eval:.3f}")

    # metrics stay on the device until an eval: reading one back every
    # iteration would wait for the device each time
    buffered = []

    def flush():
        for it, metrics in buffered:
            metrics = {k: float(v) for k, v in metrics.items()}
            if exp is not None:
                exp.log_metrics(it, metrics)
            say(it, {k: round(v, 3) for k, v in metrics.items()}, flush=True)
        buffered.clear()

    def log(it, state, metrics):
        nonlocal best_eval
        buffered.append((it, metrics))
        if "eval_reward_min" in metrics and primary:
            saved = {"params": state.params, "obs_stat": state.obs_stat}
            save_checkpoint(args.checkpoint, saved, metadata={"iteration": it + 1})
            score = float(metrics["eval_reward_min"])
            if score > best_eval:
                best_eval = score
                save_checkpoint(best_path, saved, metadata={"iteration": it + 1, "eval_reward_min": score})
            flush()

    state, history = train(
        env, policy, config, args.iterations, args.seed, log, eval_fn_num_rollouts=8, state=state, eval_env=eval_env,
        mesh=mesh,
    )
    flush()
    if exp is not None:
        exp.finish()
    if mesh is not None:
        dist.destroy_process_group()
    return state, history


if __name__ == "__main__":
    main()
