"""Batched policy rollout: the port's counterpart of the JAX package's
scanned rollouts (bench.py, tests/test_trained_policy.py), a Python loop
over steps."""

import torch


@torch.no_grad()
def rollout(env, policy, obs_stat, state, obs, steps: int):
    """Run ``steps`` env steps with ``action = policy(obs_stat.normalize(obs))``
    (no normalisation when ``obs_stat`` is None).

    Returns (state, obs, total_reward, alive), where total_reward (B,) sums
    each env's rewards while it is alive and alive (B,) is 0 from an env's
    first ``done`` on."""
    total = obs.new_zeros(obs.shape[:-1])
    alive = obs.new_ones(obs.shape[:-1])
    for _ in range(steps):
        x = obs if obs_stat is None else obs_stat.normalize(obs)
        action = env.action_transform(policy(x))
        state, obs, reward, done = env.step(state, action)
        total = total + reward * alive
        alive = alive * (1.0 - done.to(obs.dtype))
    return state, obs, total, alive
