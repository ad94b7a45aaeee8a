"""APG on the laikago through its contact step, the port's counterpart of
the JAX package's ``examples/laikago_apg.py``.

    python -m tds_tpu_torch.tools.apg_train [--horizon 50] [--batch 4] [--truncation 10] \\
        [--iterations 80] [--learning_rate 5e-3] [--seed 0] [--checkpoint PATH] [--device cpu]

The env steps in float32 on the card unless ``--device`` names another; the
policy is an MLP [32, 12] with tanh on both layers; the reward is the
smooth forward-progress term ``qd[0] + 0.5 up - 1e-3 |a|^2``. The gradient
goes through PD, ABA, the MLCP assembly, the PGS kernel K1 and its backward
kernel, and the integrator, through replayed CUDA graphs on the card
(``learn/apg.py``). The example's scaled recipe (which made
``logs/laikago_apg/policy_h100.pkl``) is ``--horizon 100 --truncation 20
--iterations 400``. The checkpoint (default ``./logs/laikago_apg/policy_torch.pkl``)
is a pickle of ``{"params": float32 array, "adam": (count, mu, nu)}``,
the layout of ``policy_h100.pkl`` (which the JAX package's test reads as
``pickle.load(f)["params"]``) with optax's Adam state beside it. After
training, a 300-step replay of the policy from one reset prints how far
the base moved and its least up.z.
"""

import argparse
import os
import pickle
import time

import torch


def make_policy(env):
    from tds_tpu_torch.learn.nn import Activation, MLPSpec

    return MLPSpec(env.observation_dim, [32, env.action_dim], [Activation.TANH, Activation.TANH])


def forward_reward(env):
    """The example's smooth reward: forward base velocity, uprightness,
    less the control effort."""

    def reward(q, qd, action):
        _, up = env.base_pose_xyz_rpy(q)
        return qd[..., 0] + 0.5 * up - 1e-3 * (action**2).sum(-1)

    return reward


def replay(env, policy, params, state, steps: int):
    """(dx, least up.z, any done) of ``steps`` env steps of ``policy`` from
    ``state``, one scan (replayed graphs on the card)."""
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.utils.graphs import scan

    def body(carry, consts):
        q, qd, t, up_min, done_any = carry
        (p,) = consts
        st, _, _, done = env.step(EnvState(q, qd, t), policy.apply(p, env.observation(q, qd)))
        _, up = env.base_pose_xyz_rpy(st.q)
        return st.q, st.qd, st.t, torch.minimum(up_min, up), torch.maximum(done_any, done.to(up.dtype))

    ones = state.q.new_ones(state.q.shape[:-1])
    with torch.no_grad():
        q, _, _, up_min, done_any = scan(body, (state.q, state.qd, state.t, ones, 0 * ones), (params,), steps, key=("apg_replay", env, policy))
    return q[..., 0] - state.q[..., 0], up_min, done_any > 0


def save(path, state):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    adam = state.opt_state
    payload = {
        "params": state.params.detach().float().cpu().numpy(),
        "adam": (adam.count, adam.mu.float().cpu().numpy(), adam.nu.float().cpu().numpy()),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def main(argv=None):
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn.apg import APGConfig, init_apg, make_apg_train_step

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--horizon", type=int, default=50)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--truncation", type=int, default=10)
    parser.add_argument("--iterations", type=int, default=80)
    parser.add_argument("--learning_rate", type=float, default=5e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint", default=os.path.join("logs", "laikago_apg", "policy_torch.pkl"))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    env = LaikagoEnv(dtype=torch.float32, device=args.device)
    policy = make_policy(env)
    cfg = APGConfig(horizon=args.horizon, batch=args.batch, learning_rate=args.learning_rate, truncation=args.truncation)
    state = init_apg(env, policy, args.seed, cfg)
    train = make_apg_train_step(env, policy, cfg, reward_fn=forward_reward(env))
    t0 = time.perf_counter()
    for it in range(args.iterations):
        state, metrics = train(state)
        if (it + 1) % 10 == 0 or it + 1 == args.iterations:
            print(f"iter {it + 1:4d}  return {float(metrics['mean_return']):9.4f}  |g| {float(metrics['grad_norm']):9.4g}  "
                  f"t={time.perf_counter() - t0:6.1f}s", flush=True)
    save(args.checkpoint, state)
    start, _ = env.reset(torch.Generator(device=env.device).manual_seed(args.seed + 5), batch_size=1)
    dx, up_min, done = replay(env, policy, state.params, start, 300)
    print(f"eval: 300 steps, moved {float(dx[0]):+.3f} m forward, up_min {float(up_min[0]):.3f}, done {bool(done[0])}; "
          f"checkpoint {args.checkpoint}")


if __name__ == "__main__":
    main()
