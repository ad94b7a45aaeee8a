"""ARS training on the laikago, ant, hopper, half-cheetah or humanoid env,
the port's counterpart of the JAX package's ``examples/laikago_ars_train.py``.

    python -m tds_tpu_torch.tools.ars_train [--env laikago|ant|hopper|halfcheetah|humanoid] \\
        [--num_directions 64] [--rollout_length 400] [--iterations 50] [--eval_interval 10] \\
        [--checkpoint PATH] [--resume PATH] [--device cpu] [--height_bonus 0] \\
        [--crouch_penalty 0] [--crouch_ref 1.2] [--z_damping 0] [--alive_bonus 0]

Every env steps in float32, on the card unless ``--device`` names another.
Laikago steps through the fused step kernel K2
(``LaikagoEnv(fused_step=True)``); the other envs step eagerly, their
contact solve through the PGS kernel K1 (K2 is laikago's: it collides
spheres only, has no ``top_k`` compaction and no spherical joint). The
five shaping flags act on the humanoid's reward only (``HumanoidEnv``'s
knobs, off by default). The checkpoint
defaults to ``./logs/<env>_ars/policy_torch.pkl``, as the JAX trainer's
goes to ``./logs/<env>_ars/``. Metrics stay on the device between evals; every
``--eval_interval`` iterations an eval of 8 rollouts runs, the checkpoint
is written, and ``<checkpoint>.best`` too when the eval's
``eval_reward_min`` beats the best so far (an existing ``.best`` file's
included). ``--resume`` starts from the params and obs_stat of a
checkpoint of either package. Checkpoints are the JAX package's format.

Not ported: the terrain (``--terrain_bump``, ``--terrain_scan``) and
reset-pool (``--reset_pool``, ``--reset_pool_prob``) flags.
"""

import argparse
import os

import torch

ENVS = ("laikago", "ant", "hopper", "halfcheetah", "humanoid")
SHAPING = ("height_bonus", "crouch_penalty", "crouch_ref", "z_damping", "alive_bonus")


def make_env(name: str, device=None, **shaping):
    """The float32 training env ``name`` on ``device``; ``shaping`` holds
    the humanoid's reward knobs."""
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
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        args.checkpoint = f"./logs/{args.env}_ars/policy_torch.pkl"
    return args


def main(argv=None):
    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint, save_checkpoint
    from tds_tpu_torch.learn.ars import ARSConfig, train
    from tds_tpu_torch.learn.nn import MLPSpec

    args = parse_args(argv)
    shaping = {k: getattr(args, k) for k in SHAPING} if args.env == "humanoid" else {}
    env = make_env(args.env, args.device, **shaping)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ARSConfig(
        num_directions=args.num_directions,
        rollout_length=args.rollout_length,
        delta_std=args.delta_std,
        step_size=args.step_size,
        top_directions=args.top_directions,
        eval_interval=args.eval_interval,
    )
    state = None  # train starts from init_ars
    if args.resume:
        saved, meta = load_checkpoint(args.resume)
        state = ars_state_from_numpy(saved["params"], saved["obs_stat"], args.seed, env.dtype, env.device)
        print(f"resumed from {args.resume} (iteration {meta.get('iteration')})")

    # a crash-resume must not clobber an earlier peak: an existing .best
    # file sets the bar its first eval has to beat
    best_path = args.checkpoint + ".best"
    best_eval = -float("inf")
    if os.path.exists(best_path):
        previous = load_checkpoint(best_path)[1].get("eval_reward_min")
        if previous is not None:
            best_eval = float(previous)
            print(f"existing {best_path}: eval_reward_min={best_eval:.3f}")

    # metrics stay on the device until an eval: reading one back every
    # iteration would wait for the device each time
    buffered = []

    def flush():
        for it, metrics in buffered:
            print(it, {k: round(float(v), 3) for k, v in metrics.items()}, flush=True)
        buffered.clear()

    def log(it, state, metrics):
        nonlocal best_eval
        buffered.append((it, metrics))
        if "eval_reward_min" in metrics:
            saved = {"params": state.params, "obs_stat": state.obs_stat}
            save_checkpoint(args.checkpoint, saved, metadata={"iteration": it + 1})
            score = float(metrics["eval_reward_min"])
            if score > best_eval:
                best_eval = score
                save_checkpoint(best_path, saved, metadata={"iteration": it + 1, "eval_reward_min": score})
            flush()

    state, history = train(env, policy, config, args.iterations, args.seed, log, eval_fn_num_rollouts=8, state=state)
    flush()
    return state, history


if __name__ == "__main__":
    main()
