"""Carrying a trained policy over from the JAX package.

The model's own parameters need no conversion: the port builds them from
the same URDF. A policy is a flat parameter vector in the layout of
``tds_tpu.learn.nn.MLPSpec`` plus the observation statistics
(count, mean, m2); :func:`policy_from_numpy` turns those into the port's
:class:`LinearPolicy` and :class:`RunningStat` for a replay,
:func:`ars_state_from_numpy` into an :class:`ARSState` to train on from,
and :func:`load_checkpoint` reads the JAX package's checkpoints without
importing it (``save_checkpoint`` writes them). An APG policy is a flat
``MLPSpec`` vector alone (``logs/laikago_apg/policy_h100.pkl`` holds
``{"params": ...}``): :func:`mlp_params_from_numpy` moves it to a device,
and :func:`apg_state_from_numpy` makes an :class:`APGState` of it and,
optionally, of optax's Adam moments.
"""

from typing import Tuple

import numpy as np
import torch

from tds_tpu_torch.learn.apg import AdamState, APGState, adam_init
from tds_tpu_torch.learn.ars import ARSState
from tds_tpu_torch.learn.nn import LinearPolicy, linear_policy
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tds_tpu_torch.utils.tensors import resolve_device

__all__ = [
    "apg_state_from_numpy", "ars_state_from_numpy", "load_checkpoint", "mlp_params_from_numpy", "policy_from_numpy",
    "save_checkpoint",
]


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


def mlp_params_from_numpy(params, dtype=torch.float32, device=None) -> torch.Tensor:
    """A flat ``MLPSpec`` parameter vector (the JAX package's layout) as a
    ``dtype`` tensor on the card unless ``device`` names another."""
    return torch.from_numpy(np.array(params, dtype=np.float64).reshape(-1)).to(resolve_device(device), dtype)


def apg_state_from_numpy(params, adam=None, seed: int = 0, dtype=torch.float32, device=None) -> APGState:
    """An :class:`APGState` that trains on from ``params`` (flat), with
    optax's Adam state ``adam`` = (count, mu, nu) (the ``ScaleByAdamState``
    inside the JAX package's ``opt_state``) or a fresh one, in ``dtype`` on
    the card unless ``device`` names another; its generator there seeded
    with ``seed``."""
    device = resolve_device(device)
    p = mlp_params_from_numpy(params, dtype, device)
    if adam is None:
        opt_state = adam_init(p)
    else:
        count, mu, nu = adam
        if np.shape(mu) != tuple(p.shape) or np.shape(nu) != tuple(p.shape):
            raise ValueError(f"Adam moments of shapes {np.shape(mu)} and {np.shape(nu)} for {tuple(p.shape)} parameters")
        opt_state = AdamState(int(count), mlp_params_from_numpy(mu, dtype, device), mlp_params_from_numpy(nu, dtype, device))
    return APGState(params=p, opt_state=opt_state, generator=torch.Generator(device=device).manual_seed(seed))
