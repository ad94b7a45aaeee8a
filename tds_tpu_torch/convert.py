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
optionally, of optax's Adam moments. A PPO policy is a dict of flat
vectors {"policy", "value", "log_std"}: :func:`ppo_params_from_numpy`
moves one to a device, :func:`ppo_state_from_numpy` makes a
:class:`PPOState` of it with optax's Adam state, and
:func:`ppo_checkpoint` / :func:`ppo_from_checkpoint` write and read the
JAX package's PPO checkpoint, ``{"params", "obs_stat", "hidden"}``. An
MPC controller's state (``LocomotionMpcState``: the gait clock, the
swing-leg latch and the velocity window) crosses as numpy arrays with
:func:`mpc_state_from_numpy`, so that both controllers start from one
state; an ``ActuatorNetSpec``'s parameters are a flat ``MLPSpec`` vector.
"""

from typing import Tuple

import numpy as np
import torch

from tds_tpu_torch.envs.base import EnvState
from tds_tpu_torch.learn.apg import AdamState, APGState, adam_init
from tds_tpu_torch.learn.ars import ARSState
from tds_tpu_torch.learn.nn import LinearPolicy, linear_policy
from tds_tpu_torch.learn.ppo import PPOState
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tds_tpu_torch.utils.tensors import resolve_device

__all__ = [
    "apg_state_from_numpy", "ars_state_from_numpy", "load_checkpoint", "mlp_params_from_numpy", "mpc_state_from_numpy",
    "policy_from_numpy", "ppo_checkpoint", "ppo_from_checkpoint", "ppo_params_from_numpy", "ppo_state_from_numpy",
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


PPO_KEYS = ("policy", "value", "log_std")


def ppo_params_from_numpy(params, dtype=torch.float32, device=None):
    """A PPO parameter dict {"policy", "value", "log_std"} of flat vectors
    (the JAX package's ``PPONetworks`` layout) as ``dtype`` tensors on the
    card unless ``device`` names another."""
    missing = set(PPO_KEYS) - set(params)
    if missing:
        raise ValueError(f"PPO parameters lack {sorted(missing)}")
    return {k: mlp_params_from_numpy(params[k], dtype, device) for k in PPO_KEYS}


def _stat(obs_stat, dtype, device) -> RunningStat:
    count, mean, m2 = (torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in obs_stat)
    return RunningStat(count=count, mean=mean, m2=m2).to(resolve_device(device), dtype)


def ppo_state_from_numpy(params, obs_stat, env_state, obs, adam=None, iteration: int = 0, seed: int = 0,
                         dtype=torch.float32, device=None) -> PPOState:
    """A :class:`PPOState` that trains on from the JAX package's: ``params``
    (a dict of flat vectors), ``obs_stat`` (count, mean, m2), ``env_state``
    (q, qd, t) of the batch, ``obs``, and optax's Adam state ``adam`` =
    (count, mu, nu) with mu and nu dicts like ``params`` (the
    ``ScaleByAdamState`` inside the JAX package's ``opt_state``) or a fresh
    one; in ``dtype`` on the card unless ``device`` names another, its
    generator there seeded with ``seed``."""
    from tds_tpu_torch.learn.ppo import adam_init as ppo_adam_init

    device = resolve_device(device)
    p = ppo_params_from_numpy(params, dtype, device)
    if adam is None:
        opt_state = ppo_adam_init(p)
    else:
        count, mu, nu = adam
        opt_state = AdamState(int(count), ppo_params_from_numpy(mu, dtype, device), ppo_params_from_numpy(nu, dtype, device))
        for k in PPO_KEYS:
            if opt_state.mu[k].shape != p[k].shape or opt_state.nu[k].shape != p[k].shape:
                raise ValueError(f"Adam moments of {k} do not match its {tuple(p[k].shape)} parameters")
    q, qd, t = env_state
    state = EnvState(q=torch.as_tensor(np.asarray(q, dtype=np.float64)).to(device, dtype),
                     qd=torch.as_tensor(np.asarray(qd, dtype=np.float64)).to(device, dtype),
                     t=torch.as_tensor(np.asarray(t)).to(device, torch.int32))
    return PPOState(params=p, opt_state=opt_state, env_state=state,
                    obs=torch.as_tensor(np.asarray(obs, dtype=np.float64)).to(device, dtype),
                    obs_stat=_stat(obs_stat, dtype, device), generator=torch.Generator(device=device).manual_seed(seed),
                    iteration=iteration)


def ppo_checkpoint(path: str, params, obs_stat: RunningStat, hidden: int, metadata=None):
    """Writes the JAX package's PPO checkpoint, ``{"params": {...}, "obs_stat":
    (count, mean, m2), "hidden": hidden}``, which its loaders and
    ``tests/test_ppo_ant_policy.py`` read."""
    save_checkpoint(path, {"params": dict(params), "obs_stat": tuple(obs_stat), "hidden": int(hidden)}, metadata)


def ppo_from_checkpoint(path: str, dtype=torch.float32, device=None):
    """(params, obs_stat, hidden, metadata) of a PPO checkpoint of either
    package, in ``dtype`` on the card unless ``device`` names another."""
    saved, metadata = load_checkpoint(path)
    return (ppo_params_from_numpy(saved["params"], dtype, device), _stat(saved["obs_stat"], dtype, device),
            int(saved.get("hidden", 64)), metadata)


def mpc_state_from_numpy(time, last_leg_state, phase_switch_foot_position, buffer, count, dtype=torch.float64,
                         device=None):
    """A ``LocomotionMpcState`` from the JAX package's fields as numpy
    arrays, one row per env: time (B,), the swing latch's last leg states
    (B, legs) and take-off positions (B, legs, 3), the velocity window's
    buffer (B, W, 3) and count (B,); in ``dtype`` on the card unless
    ``device`` names another."""
    from tds_tpu_torch.control.mpc.gait import VelocityFilterState
    from tds_tpu_torch.control.mpc.locomotion import LocomotionMpcState
    from tds_tpu_torch.control.mpc.swing_leg import SwingLegState

    device = resolve_device(device)

    def real(x):
        return torch.from_numpy(np.array(x, dtype=np.float64)).to(device, dtype)

    return LocomotionMpcState(
        time=real(time),
        swing=SwingLegState(torch.from_numpy(np.array(last_leg_state, dtype=np.int64)).to(device), real(phase_switch_foot_position)),
        vel_filter=VelocityFilterState(real(buffer), torch.from_numpy(np.array(count, dtype=np.int32)).to(device)),
    )
