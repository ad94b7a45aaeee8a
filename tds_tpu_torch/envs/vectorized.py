"""Vectorized environments with auto-reset (counterpart of
tds_tpu/envs/vectorized.py).

The port's envs step a batch already (``envs/base.py``), so
:class:`VectorizedEnv` adds only the auto-reset: the envs that finished in
a step start again from a fresh reset, the others step on. Each finished
env's reset noise is drawn from the generator given to ``step`` (or
passed in as ``reset_noise``, one row an env, so that a test can hand it
another implementation's draws). :func:`rollout` runs a policy through one
:func:`~tds_tpu_torch.utils.graphs.scan` (replayed CUDA graphs on the card)
and returns each env's reward and steps while alive.
"""

from typing import Callable, Optional

import torch

from tds_tpu_torch.envs.base import Env, EnvState
from tds_tpu_torch.utils.graphs import scan


class VectorizedEnv:
    def __init__(self, env: Env, num_envs: int, auto_reset: bool = True):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset

    def reset(self, generator: Optional[torch.Generator] = None, noise=None):
        """(states, obs) of ``num_envs`` resets from ``generator``'s draws or
        the given (num_envs, ...) ``noise``."""
        return self.env.reset(generator, batch_size=self.num_envs, noise=noise)

    def step(self, states: EnvState, actions, generator: Optional[torch.Generator] = None, reset_noise=None):
        """(states, obs, reward, done): one step of every env; with
        ``auto_reset`` the finished envs are replaced by resets from
        ``reset_noise`` (num_envs, ...), whose rows of the envs that did
        not finish go unused, or from noise drawn from ``generator`` for
        every env. The reset runs on the finished envs alone."""
        states, obs, reward, done = self.env.step(states, actions)
        if not self.auto_reset:
            return states, obs, reward, done
        if reset_noise is None:
            reset_noise = self.env.draw_reset_noise(generator, self.num_envs)
        finished = done.nonzero()[:, 0]
        if finished.numel():
            fresh, fresh_obs = self.env.reset(noise=reset_noise.index_select(0, finished.to(reset_noise.device)))
            states = EnvState(*(x.index_copy(0, finished, f) for x, f in zip(states, fresh)))
            obs = obs.index_copy(0, finished, fresh_obs)
        return states, obs, reward, done


def rollout(env: Env, policy_fn: Callable, params, num_steps: int, generator: Optional[torch.Generator] = None,
            batch_size: int = 1, noise=None):
    """Rollouts of ``policy_fn(params, obs) -> action`` (through
    ``env.action_transform``) from resets drawn from ``generator`` (or the
    given (B, ...) ``noise``), one scan over ``num_steps``. Returns (total
    reward, steps alive), each (B,): an env's rewards and steps count until
    its first ``done``. ``params`` is a tensor, the scan's const, so that
    later calls with other params replay the same graphs."""
    state, obs = env.reset(generator, batch_size=batch_size, noise=noise)

    def body(carry, consts):
        q, qd, t, obs, total, alive, steps = carry
        (p,) = consts
        state, obs, reward, done = env.step(EnvState(q, qd, t), env.action_transform(policy_fn(p, obs)))
        total = total + reward * alive
        steps = steps + alive
        alive = alive * (1.0 - done.to(obs.dtype))
        return state.q, state.qd, state.t, obs, total, alive, steps

    batch = obs.shape[:-1]
    carry = (state.q, state.qd, state.t, obs, obs.new_zeros(batch), obs.new_ones(batch), obs.new_zeros(batch))
    with torch.no_grad():
        out = scan(body, carry, (params,), num_steps, key=("vectorized_rollout", env, policy_fn))
    return out[4], out[6]
