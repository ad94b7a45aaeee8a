"""Environment API over batched tensors (counterpart of tds_tpu/envs/base.py).

Each env is a static description object with

    reset(generator, batch_size, noise) -> (EnvState, obs)
    step(state, action)                 -> (EnvState, obs, reward, done)

on tensors with a leading batch dimension. Randomness comes from a
``torch.Generator`` passed to ``reset``, so the state carries no key; or a
caller draws the reset noise itself with ``draw_reset_noise`` (or makes it
elsewhere, as a test feeding another implementation's draws does) and
hands it to ``reset``.
"""

from typing import NamedTuple

import torch


class EnvState(NamedTuple):
    q: torch.Tensor  # (B, dof_q)
    qd: torch.Tensor  # (B, dof_qd)
    t: torch.Tensor  # (B,) int32 step counter


class Env:
    """Protocol; concrete envs implement these."""

    observation_dim: int
    action_dim: int

    def reset(self, generator=None, batch_size: int = 1, noise=None):
        raise NotImplementedError

    def draw_reset_noise(self, generator=None, batch_size: int = 1):
        """The (batch_size, n) uniform draws that ``reset`` starts from."""
        raise NotImplementedError

    def step(self, state: EnvState, action):
        raise NotImplementedError

    def action_transform(self, raw_action):
        """Map raw policy outputs to env actions (identity by default)."""
        return raw_action
