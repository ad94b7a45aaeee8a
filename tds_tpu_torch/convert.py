"""Carrying a trained policy over from the JAX package.

The model's own parameters need no conversion: the port builds them from
the same URDF. A policy is a flat parameter vector in the layout of
``tds_tpu.learn.nn.MLPSpec`` plus the observation statistics
(count, mean, m2); :func:`policy_from_numpy` turns those into the port's
:class:`LinearPolicy` and :class:`RunningStat` for a replay,
:func:`ars_state_from_numpy` into an :class:`ARSState` to train on from,
and :func:`load_checkpoint` reads the JAX package's checkpoints without
importing it (``save_checkpoint`` writes them).
"""

from typing import Tuple

import numpy as np
import torch

from tds_tpu_torch.learn.ars import ARSState
from tds_tpu_torch.learn.nn import LinearPolicy, linear_policy
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tds_tpu_torch.utils.tensors import resolve_device

__all__ = ["ars_state_from_numpy", "load_checkpoint", "policy_from_numpy", "save_checkpoint"]


def policy_from_numpy(params, obs_stat, dtype=torch.float64, device=None) -> Tuple[LinearPolicy, RunningStat]:
    """(LinearPolicy, RunningStat) in ``dtype``, on the card unless
    ``device`` names another.

    ``params`` is the flat (obs*act + act,) vector; ``obs_stat`` is
    (count, mean, m2) as numpy arrays, and its mean sets the observation
    width."""
    device = resolve_device(device)
    params = np.asarray(params, dtype=np.float64).reshape(-1)
    count, mean, m2 = (torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in obs_stat)
    stat = RunningStat(count=count, mean=mean, m2=m2).to(device, dtype)
    observation_dim = mean.shape[-1]
    action_dim, rest = divmod(params.size, observation_dim + 1)
    if rest or action_dim == 0:
        raise ValueError(f"{params.size} parameters do not form a ({observation_dim} -> n) linear layer with bias")
    policy = linear_policy(observation_dim, action_dim, dtype=dtype, device=device).load_flat(torch.from_numpy(params))
    return policy, stat


def ars_state_from_numpy(params, obs_stat, seed: int = 0, dtype=torch.float64, device=None) -> ARSState:
    """An :class:`ARSState` at iteration 0 that trains on from ``params``
    (flat) and ``obs_stat`` ((count, mean, m2) as numpy arrays), in
    ``dtype`` on the card unless ``device`` names another, its generator
    there seeded with ``seed``."""
    device = resolve_device(device)
    count, mean, m2 = (torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in obs_stat)
    return ARSState(
        params=torch.as_tensor(np.asarray(params, dtype=np.float64).reshape(-1)).to(device, dtype),
        obs_stat=RunningStat(count=count, mean=mean, m2=m2).to(device, dtype),
        generator=torch.Generator(device=device).manual_seed(seed),
        iteration=0,
        total_timesteps=torch.zeros((), dtype=torch.int64, device=device),
    )
