"""PPO training on the port's envs, the counterpart of the JAX package's
``examples/ppo_train.py``.

    python -m tds_tpu_torch.tools.ppo_train [--env ant|laikago|humanoid|hopper|halfcheetah|cartpole] \\
        [--num_envs 256] [--unroll 128] [--num_minibatches 8] [--num_epochs 4] [--learning_rate 3e-4] \\
        [--entropy_cost 1e-3] [--init_log_std -1] [--hidden 64] [--iterations 1500] [--lr_anneal 0] \\
        [--eval_interval 50] [--eval_length 1000] [--checkpoint PATH] [--seed 0] [--device cpu]

The env steps in float32 on the card unless ``--device`` names another
(``cartpole``, beside the JAX example's envs, trains at a tiny size on the
CPU);
the locomotion envs step eagerly, their contact solve through the PGS
kernel K1 (the ant at 24 rows). Each iteration collects ``--num_envs`` x
``--unroll`` steps through replayed CUDA graphs (``learn/ppo.py``); the
metrics stay on the device until an eval. Every ``--eval_interval``
iterations a deterministic eval runs the mean policy in 8 envs for
``--eval_length`` steps from resets drawn from a generator seeded
``1000 + iteration``, prints the iterations since the last eval, and
writes the checkpoint when the eval's ``eval_reward_mean`` beats the best
so far; at the end ``<checkpoint>.final`` holds the last policy. The
checkpoint (default ``./logs/<env>_ppo/policy_torch.pkl``) is the JAX
package's PPO format, ``{"params", "obs_stat", "hidden"}``. The JAX
example's multi-chip and ``Experiment`` logging are not ported.
"""

import argparse
import time

import torch

ENVS = ("ant", "laikago", "humanoid", "hopper", "halfcheetah", "cartpole")
EVAL_ENVS = 8


def make_env(name: str, dtype=torch.float32, device=None):
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.envs.cartpole import CartpoleEnv
    from tds_tpu_torch.envs.hopper import HalfCheetahEnv, HopperEnv
    from tds_tpu_torch.envs.humanoid import HumanoidEnv
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    envs = {"ant": AntEnv, "laikago": LaikagoEnv, "humanoid": HumanoidEnv, "hopper": HopperEnv,
            "halfcheetah": HalfCheetahEnv, "cartpole": CartpoleEnv}
    if name not in envs:
        raise SystemExit(f"--env must be one of {sorted(envs)}, got {name!r}")
    return envs[name](dtype=dtype, device=device)


def policy_rollout(env, nets, params, obs_stat, state, obs, steps: int):
    """The mean policy from (state, obs) for ``steps`` steps, one scan:
    (each env's reward and steps while alive, its base x when it was last
    alive (0 for an env without a base pose)), each (B,)."""
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.utils.graphs import scan

    base_pose = getattr(env, "base_pose_xyz_rpy", None)

    def body(carry, consts):
        q, qd, t, obs, total, alive, count, x = carry
        policy, mean, scale = consts
        action = nets.policy.apply(policy, (obs - mean) / scale)
        state, obs, reward, done = env.step(EnvState(q, qd, t), env.action_transform(action))
        total = total + reward * alive
        count = count + alive
        if base_pose is not None:
            x = torch.where(alive > 0, base_pose(state.q)[0][..., 0], x)
        alive = alive * (1.0 - done.to(obs.dtype))
        return state.q, state.qd, state.t, obs, total, alive, count, x

    z = obs.new_zeros(obs.shape[:-1])
    x0 = base_pose(state.q)[0][..., 0] if base_pose is not None else z
    carry = (state.q, state.qd, state.t, obs, z, torch.ones_like(z), z, x0)
    with torch.no_grad():
        out = scan(body, carry, (params["policy"], obs_stat.mean, obs_stat.scale()), steps,
                   key=("ppo_policy_rollout", env, nets.policy.layer_dims))
    return out[4], out[6], out[7]


def make_eval(env, nets, eval_length: int):
    """``run(params, obs_stat, generator) -> metrics``: the mean policy in
    EVAL_ENVS envs for ``eval_length`` steps from resets drawn from
    ``generator`` (:func:`policy_rollout`); the metrics are 0-dim tensors
    on the env's device."""

    def run(params, obs_stat, generator):
        state, obs = env.reset(generator, batch_size=EVAL_ENVS)
        totals, steps, xs = policy_rollout(env, nets, params, obs_stat, state, obs, eval_length)
        return {"eval_reward_mean": totals.mean(), "eval_reward_min": totals.min(), "eval_steps_mean": steps.mean(),
                "eval_x_mean": xs.mean()}

    return run


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", default="ant", choices=ENVS)
    parser.add_argument("--num_envs", type=int, default=256)
    parser.add_argument("--unroll", type=int, default=128)
    parser.add_argument("--num_minibatches", type=int, default=8)
    parser.add_argument("--num_epochs", type=int, default=4)
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--entropy_cost", type=float, default=1e-3)
    parser.add_argument("--init_log_std", type=float, default=-1.0)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--iterations", type=int, default=1500)
    parser.add_argument("--lr_anneal", type=int, default=0, help="anneal the learning rate to 0 over this many iterations")
    parser.add_argument("--eval_interval", type=int, default=50)
    parser.add_argument("--eval_length", type=int, default=1000)
    parser.add_argument("--checkpoint", default=None, help="default: ./logs/<env>_ppo/policy_torch.pkl")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the CUDA device")
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        args.checkpoint = f"./logs/{args.env}_ppo/policy_torch.pkl"
    return args


def main(argv=None):
    """Trains; returns (the last state, the metrics of every iteration)."""
    from tds_tpu_torch.convert import ppo_checkpoint
    from tds_tpu_torch.learn.ppo import PPOConfig, PPONetworks, make_ppo

    args = parse_args(argv)
    env = make_env(args.env, device=args.device)
    nets = PPONetworks(env.observation_dim, env.action_dim, hidden=(args.hidden, args.hidden))
    config = PPOConfig(
        num_envs=args.num_envs, unroll_length=args.unroll, num_minibatches=args.num_minibatches, num_epochs=args.num_epochs,
        learning_rate=args.learning_rate, entropy_cost=args.entropy_cost, init_log_std=args.init_log_std,
        lr_anneal_iterations=args.lr_anneal,
    )
    init_fn, step_fn = make_ppo(env, nets, config)
    eval_fn = make_eval(env, nets, args.eval_length)
    state = init_fn(args.seed)
    best = -float("inf")
    history, buffered = [], []
    t0 = time.perf_counter()
    for it in range(args.iterations):
        state, metrics = step_fn(state)
        history.append(metrics)
        buffered.append((it, metrics))
        if (it + 1) % args.eval_interval == 0:
            generator = torch.Generator(device=env.device).manual_seed(1000 + it)
            metrics.update(eval_fn(state.params, state.obs_stat, generator))
            score = float(metrics["eval_reward_mean"])
            if score > best:
                best = score
                ppo_checkpoint(args.checkpoint, state.params, state.obs_stat, args.hidden,
                               {"iteration": it + 1, "eval_reward_mean": score})
            for i, m in buffered:
                print(i, {k: round(float(v), 3) for k, v in m.items()}, flush=True)
            buffered.clear()
            print(f"{it + 1} iterations in {time.perf_counter() - t0:.1f} s", flush=True)
    ppo_checkpoint(args.checkpoint + ".final", state.params, state.obs_stat, args.hidden, {"iteration": args.iterations})
    return state, history


if __name__ == "__main__":
    main()
