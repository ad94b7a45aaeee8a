"""Carrying a trained policy over from the JAX package.

The model's own parameters need no conversion: the port builds them from
the same URDF. A policy is a flat parameter vector in the layout of
``tds_tpu.learn.nn.MLPSpec`` plus the observation statistics
(count, mean, m2); :func:`policy_from_numpy` turns those into the port's
:class:`LinearPolicy` and :class:`RunningStat`, and :func:`load_checkpoint`
reads the JAX package's checkpoints without importing it.
"""

from typing import Tuple

import numpy as np
import torch

from tds_tpu_torch.learn.nn import LinearPolicy, linear_policy
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.utils.checkpoint import load_checkpoint
from tds_tpu_torch.utils.tensors import resolve_device

__all__ = ["load_checkpoint", "policy_from_numpy"]


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
