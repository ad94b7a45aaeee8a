"""ARS training on the laikago, ant or hopper env, the port's counterpart
of the JAX package's ``examples/laikago_ars_train.py``.

    python -m tds_tpu_torch.tools.ars_train [--env laikago|ant|hopper] [--num_directions 64] \\
        [--rollout_length 400] [--iterations 50] [--eval_interval 10] [--checkpoint PATH] \\
        [--resume PATH] [--device cpu]

Every env steps in float32, on the card unless ``--device`` names another.
Laikago steps through the fused step kernel K2
(``LaikagoEnv(fused_step=True)``); the ant and the hopper step eagerly,
their contact solve through the PGS kernel K1 (K2 is laikago's: it
collides spheres only and has no ``top_k`` compaction). The checkpoint
defaults to ``./logs/<env>_ars/policy_torch.pkl``, as the JAX trainer's
goes to ``./logs/<env>_ars/``. Metrics stay on the device between evals; every
``--eval_interval`` iterations an eval of 8 rollouts runs, the checkpoint
is written, and ``<checkpoint>.best`` too when the eval's
``eval_reward_min`` beats the best so far (an existing ``.best`` file's
included). ``--resume`` starts from the params and obs_stat of a
checkpoint of either package. Checkpoints are the JAX package's format.

Not ported: the humanoid and halfcheetah envs (not in the port yet), and
the terrain (``--terrain_bump``,
``--terrain_scan``), reset-pool (``--reset_pool``, ``--reset_pool_prob``)
and humanoid-shaping flags (``--height_bonus``, ``--crouch_penalty``,
``--crouch_ref``, ``--z_damping``, ``--alive_bonus``).
"""

import argparse
import os

import torch

UNPORTED_ENVS = ("humanoid", "halfcheetah")


def make_env(name: str, device=None):
    """The float32 training env ``name`` on ``device``."""
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.envs.hopper import HopperEnv
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    if name == "laikago":
        return LaikagoEnv(dtype=torch.float32, device=device, fused_step=True)
    if name == "ant":
        return AntEnv(dtype=torch.float32, device=device)
    if name == "hopper":
        return HopperEnv(dtype=torch.float32, device=device)
    raise NotImplementedError(
        f"--env {name}: the {', '.join(UNPORTED_ENVS)} envs are not ported to tds_tpu_torch yet; laikago, ant and hopper are"
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", default="laikago", choices=("laikago", "ant", "hopper") + UNPORTED_ENVS)
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
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        args.checkpoint = f"./logs/{args.env}_ars/policy_torch.pkl"
    return args


def main(argv=None):
    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint, save_checkpoint
    from tds_tpu_torch.learn.ars import ARSConfig, train
    from tds_tpu_torch.learn.nn import MLPSpec

    args = parse_args(argv)
    env = make_env(args.env, args.device)
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
