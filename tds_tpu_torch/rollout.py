"""Batched policy rollout: the port's counterpart of the JAX package's
scanned rollouts (tds_tpu/envs/vectorized.py, bench.py,
tests/test_trained_policy.py), one :func:`tds_tpu_torch.utils.graphs.scan`
over the steps: replayed CUDA graphs on the card, a Python loop on the
CPU."""

import torch
import torch.nn.functional as F

from tds_tpu_torch.envs.base import EnvState
from tds_tpu_torch.utils.graphs import scan


@torch.no_grad()
def rollout(env, policy, obs_stat, state, obs, steps: int):
    """Run ``steps`` env steps with ``action = policy(obs_stat.normalize(obs))``
    (no normalisation when ``obs_stat`` is None); ``policy`` is a linear
    layer (``learn.nn.LinearPolicy``), whose weight and bias, with the
    statistics' mean and scale, each call reads anew.

    Returns (state, obs, total_reward, alive), where total_reward (B,) sums
    each env's rewards while it is alive and alive (B,) is 0 from an env's
    first ``done`` on."""
    if obs_stat is None:
        mean, scale = obs.new_zeros(obs.shape[-1]), obs.new_ones(obs.shape[-1])  # (obs - 0) / 1 is obs exactly
    else:
        mean, scale = obs_stat.mean, obs_stat.scale()

    def body(carry, consts):
        q, qd, t, obs, total, alive = carry
        weight, bias, mean, scale = consts
        action = env.action_transform(F.linear((obs - mean) / scale, weight, bias))
        state, obs, reward, done = env.step(EnvState(q, qd, t), action)
        return state.q, state.qd, state.t, obs, total + reward * alive, alive * (1.0 - done.to(obs.dtype))

    carry = (state.q, state.qd, state.t, obs, obs.new_zeros(obs.shape[:-1]), obs.new_ones(obs.shape[:-1]))
    consts = (policy.weight, policy.bias, mean, scale)
    q, qd, t, obs, total, alive = scan(body, carry, consts, steps, key=("rollout", env))
    return EnvState(q=q, qd=qd, t=t), obs, total, alive
