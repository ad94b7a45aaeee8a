"""Proximal policy optimisation over the port's batched envs (counterpart of
tds_tpu/learn/ppo.py): the clip objective, GAE, and minibatch Adam.

An iteration (:func:`ppo_iteration`) takes its draws as arguments
(:class:`PPODraws`: the action noise of every step, the reset noise of
each auto-reset, the permutation of every epoch), so a test can hand it the
JAX package's; ``make_ppo``'s ``step_fn`` draws them from the state's
``torch.Generator`` on the env's device.

- Collect: one :func:`~tds_tpu_torch.utils.graphs.scan` over the unroll
  (replayed CUDA graphs on the card, a Python loop on the CPU); each step
  samples the Gaussian policy on the normalised observation, steps the env
  (the ant's contact step runs K1 at 24 rows on the card), and writes the
  transition into the unroll's buffers, which ride in the scan's carry.
- Auto-reset: the JAX package computes ``env.reset`` for every env at
  every step and selects it where the env finished (``vmap`` of
  ``lax.cond``), 11 simulation steps a step for the ant (10 settle steps).
  Here the resets are made ahead of the unroll: env b's r-th reset of the
  unroll starts from ``reset_noise[r, b]``, and all R B of them settle in
  one batched ``reset`` before the scan; a finished env takes its next
  fresh state with ``torch.where``. That gives the JAX package's states
  (its per-env key advances only at a reset, so the r-th reset's draw is
  fixed before the unroll starts). An env that finishes more than R times
  raises :class:`ResetsExhausted`; ``step_fn`` then draws more reset slots
  and runs the iteration again from the same start. It draws R a power of
  two, at least the most the last iteration needed. With a reset pool
  (``LocomotionEnv(reset_pool=...)``) each slot also holds its pool draws
  (``env.draw_reset_pool``: whether the reset takes a pool state, and
  which), drawn beside its noise, so that a reset settles and then is
  replaced by its pool state, as the JAX package's ``env.reset`` does.
- GAE is a reverse loop over the unroll; the epochs and minibatches are
  plain torch operations (small MLP products), each minibatch's gradient
  from autograd, clipped by its global norm and applied with optax's Adam
  (``learn/apg.py``'s, per parameter group, one step count), the
  learning rate optax's ``linear_schedule`` over
  ``lr_anneal_iterations * num_epochs * num_minibatches`` updates when
  ``lr_anneal_iterations`` is set (in float32, as optax computes a
  schedule).
- The observation statistics merge the unroll's observations after the
  update, as the JAX package does; the policy reads the previous ones.
"""

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tds_tpu_torch.envs.base import EnvState
from tds_tpu_torch.learn.apg import AdamState, adam_update
from tds_tpu_torch.learn.nn import Activation, MLPSpec
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.utils.graphs import scan

# reset slots step_fn draws for its first iteration: an env may finish this
# many times in one unroll before step_fn draws more
RESET_SLOTS = 2


class PPOConfig(NamedTuple):
    """The JAX package's fields and defaults."""

    num_envs: int = 64
    unroll_length: int = 64
    num_minibatches: int = 8
    num_epochs: int = 4
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.2
    entropy_cost: float = 1e-3
    value_cost: float = 0.5
    max_grad_norm: float = 0.5
    init_log_std: float = -0.5
    lr_anneal_iterations: int = 0  # linear anneal to 0 over this many iterations (0: constant)


class PPONetworks:
    """A Gaussian policy with a state-independent log-std and a value net,
    tanh MLPs of ``hidden`` layers over flat parameter vectors; the
    parameters are a dict {"policy", "value", "log_std"}."""

    def __init__(self, observation_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64)):
        acts = [Activation.TANH] * len(hidden) + [Activation.IDENTITY]
        self.policy = MLPSpec(observation_dim, list(hidden) + [action_dim], acts)
        self.value = MLPSpec(observation_dim, list(hidden) + [1], acts)
        self.action_dim = action_dim

    def init(self, generator: torch.Generator, config: PPOConfig, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        """Xavier weights and zero biases drawn from ``generator``, the
        log-std at ``config.init_log_std``; on the card unless ``device``
        names another."""
        policy = self.policy.init(generator, dtype=dtype, device=device)
        return {
            "policy": policy,
            "value": self.value.init(generator, dtype=dtype, device=device),
            "log_std": torch.full((self.action_dim,), config.init_log_std, dtype=dtype, device=policy.device),
        }

    def dist(self, params, obs):
        return self.policy.apply(params["policy"], obs), params["log_std"].exp()

    def log_prob(self, params, obs, action):
        mean, std = self.dist(params, obs)
        return _log_prob(mean, std, action)

    def entropy(self, params):
        std = params["log_std"].exp()
        return (0.5 * math.log(2 * math.pi * math.e) + std.log()).sum()

    def sample(self, params, obs, generator: torch.Generator):
        """(action, log-prob): the Gaussian policy sampled on ``obs`` with
        eps drawn from ``generator`` (on its device, moved to the
        observation's)."""
        mean, std = self.dist(params, obs)
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=generator.device).to(mean.device)
        action = mean + std * eps
        return action, _log_prob(mean, std, action)


def _log_prob(mean, std, action):
    z = (action - mean) / std
    return (-0.5 * z**2 - std.log() - 0.5 * math.log(2 * math.pi)).sum(-1)


class PPOState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: AdamState  # count, and mu and nu as dicts like params
    env_state: EnvState
    obs: torch.Tensor
    obs_stat: RunningStat
    generator: torch.Generator  # the draws of every iteration; advanced in place
    iteration: int


class Transition(NamedTuple):
    """An unroll, each field (T, B, ...)."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    value: torch.Tensor


class PPODraws(NamedTuple):
    """An iteration's draws: ``action_noise`` (T, B, A) standard normal,
    ``reset_noise`` (R, B, ...) the noise of each env's r-th reset in the
    unroll (``env.draw_reset_noise``'s), ``permutations`` (E, T B) int64,
    and with a reset pool ``reset_pool`` = (use (R, B) bool, index (R, B)
    int64), each reset's ``env.draw_reset_pool`` draws (None without)."""

    action_noise: torch.Tensor
    reset_noise: torch.Tensor
    permutations: torch.Tensor
    reset_pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def to(self, device) -> "PPODraws":
        pool = None if self.reset_pool is None else tuple(t.to(device) for t in self.reset_pool)
        return PPODraws(*(t.to(device) for t in self[:3]), pool)


class ResetsExhausted(RuntimeError):
    """An env finished more times in the unroll than the draws hold resets;
    ``needed`` is the most any env needed."""

    def __init__(self, needed: int, slots: int):
        super().__init__(f"an env finished {needed} times in the unroll; the draws hold {slots} resets an env")
        self.needed = needed


def learning_rate(config: PPOConfig, count: int) -> float:
    """The rate of Adam's update number ``count`` (from 0): optax's
    ``linear_schedule(learning_rate, 0, lr_anneal_iterations * num_epochs *
    num_minibatches)`` as optax computes it, in float32 whatever the
    parameters' type (``1 - count / steps``, times the rate), or the
    constant rate."""
    if not config.lr_anneal_iterations:
        return config.learning_rate
    steps = config.lr_anneal_iterations * config.num_epochs * config.num_minibatches
    frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return float(np.float32(np.float32(config.learning_rate) * frac))


def _reset_slots(env, config: PPOConfig, generator: torch.Generator, slots: int):
    """``slots`` reset slots' draws from ``generator``: (noise (R, B, ...),
    pool draws ((R, B), (R, B)) or None without a reset pool), each slot's
    noise and pool draws in turn, on the env's device."""
    pooled = getattr(env, "reset_pool", None) is not None
    noise, use, index = [], [], []
    for _ in range(slots):
        noise.append(env.draw_reset_noise(generator, config.num_envs).to(env.device))
        if pooled:
            u, i = env.draw_reset_pool(generator, config.num_envs)
            use.append(u)
            index.append(i)
    pool = (torch.stack(use), torch.stack(index)) if pooled and slots else None
    return torch.stack(noise), pool


def draw_iteration(env, config: PPOConfig, generator: torch.Generator, dtype, reset_slots: int = RESET_SLOTS) -> PPODraws:
    """An iteration's draws from ``generator``, on the env's device."""
    shape = (config.unroll_length, config.num_envs, env.action_dim)
    noise = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    resets, pool = _reset_slots(env, config, generator, reset_slots)
    n = config.unroll_length * config.num_envs
    perms = torch.stack([torch.randperm(n, generator=generator, device=generator.device) for _ in range(config.num_epochs)])
    return PPODraws(noise.to(env.device), resets, perms.to(env.device), pool)


def more_resets(env, config: PPOConfig, draws: PPODraws, generator: torch.Generator, needed: int) -> PPODraws:
    """``draws`` with reset slots appended from ``generator`` up to
    ``needed`` (their noise and, with a reset pool, their pool draws)."""
    noise, pool = _reset_slots(env, config, generator, needed - draws.reset_noise.shape[0])
    if pool is not None:
        pool = tuple(torch.cat([old, new]) for old, new in zip(draws.reset_pool, pool))
    return draws._replace(reset_noise=torch.cat([draws.reset_noise, noise]), reset_pool=pool)


def fresh_resets(env, reset_noise, reset_pool=None):
    """(q, qd, obs) of the R B resets that ``reset_noise`` (R, B, ...)
    starts, each (R B, ...): one batched ``reset``, its settle steps one
    scan, then the pool states where ``reset_pool`` ((R, B) use and index)
    takes them."""
    noise = reset_noise.reshape((-1,) + tuple(reset_noise.shape[2:]))
    if reset_pool is None:
        state, obs = env.reset(noise=noise)
    else:
        state, obs = env.reset(noise=noise, pool_draws=tuple(t.reshape(-1) for t in reset_pool))
    return state.q, state.qd, obs


def _collect_step(env, networks: PPONetworks, carry, consts):
    """One step of the unroll: sample, step, auto-reset from the fresh
    states, and write the transition into the buffers at the step index."""
    q, qd, t, obs, resets, index, b_obs, b_action, b_logp, b_reward, b_done, b_value = carry
    policy, value, log_std, mean, scale, noise, slots, fresh_q, fresh_qd, fresh_obs = consts
    batch = obs.shape[0]
    obs_n = (obs - mean) / scale
    mu = networks.policy.apply(policy, obs_n)
    std = log_std.exp()
    action = mu + std * noise.index_select(0, index.reshape(1))[0]
    logp = _log_prob(mu, std, action)
    v = networks.value.apply(value, obs_n)[..., 0]
    state, next_obs, reward, done = env.step(EnvState(q, qd, t), env.action_transform(action))
    # env b's next fresh state: slot min(resets_b, R - 1) of the R filled
    # (past R the iteration raises ResetsExhausted after the scan)
    rows = torch.minimum(resets, slots - 1) * batch + torch.arange(batch, device=q.device)
    d = done[:, None]
    q = torch.where(d, fresh_q.index_select(0, rows), state.q)
    qd = torch.where(d, fresh_qd.index_select(0, rows), state.qd)
    next_obs = torch.where(d, fresh_obs.index_select(0, rows), next_obs)
    t = torch.where(done, torch.zeros_like(state.t), state.t)
    at = index.reshape(1)
    for buf, x in ((b_obs, obs), (b_action, action), (b_logp, logp), (b_reward, reward), (b_done, done.to(obs.dtype)), (b_value, v)):
        buf.index_copy_(0, at, x[None])
    return q, qd, t, next_obs, resets + done.to(resets.dtype), index + 1, b_obs, b_action, b_logp, b_reward, b_done, b_value


def collect(env, networks: PPONetworks, config: PPOConfig, state: PPOState, draws: PPODraws):
    """(env state, obs, transitions, resets per env (B,)): the unroll from
    ``state`` with the draws' action noise and fresh resets, one scan."""
    obs = state.obs
    steps, batch = config.unroll_length, config.num_envs
    # an env finishes at most T times in T steps: the fresh states ride in
    # buffers of T B rows, R B of them filled, so that one graph serves every R
    slots = draws.reset_noise.shape[0]
    fresh = [torch.cat([x, x.new_zeros((max(steps - slots, 0) * batch,) + tuple(x.shape[1:]))])
             for x in fresh_resets(env, draws.reset_noise, draws.reset_pool)]
    buffers = (
        obs.new_zeros((steps, batch, obs.shape[-1])),
        obs.new_zeros((steps, batch, env.action_dim)),
        *(obs.new_zeros((steps, batch)) for _ in range(4)),
    )
    index = torch.zeros((), dtype=torch.int64, device=obs.device)
    resets = torch.zeros(batch, dtype=torch.int64, device=obs.device)
    carry = (state.env_state.q, state.env_state.qd, state.env_state.t, obs, resets, index, *buffers)
    p = state.params
    consts = (p["policy"], p["value"], p["log_std"], state.obs_stat.mean, state.obs_stat.scale(), draws.action_noise,
              torch.tensor(slots, dtype=torch.int64, device=obs.device), *fresh)
    body = functools.partial(_collect_step, env, networks)
    key = ("ppo_collect", env, networks.policy.layer_dims)
    q, qd, t, obs, resets, _, *out = scan(body, carry, consts, steps, key=key)
    return EnvState(q, qd, t), obs, Transition(*out), resets


def gae(config: PPOConfig, traj: Transition, last_value):
    """(advantages, returns), each (T, B)."""
    advantages = torch.empty_like(traj.reward)
    next_value, next_adv = last_value, torch.zeros_like(last_value)
    for t in range(traj.reward.shape[0] - 1, -1, -1):
        live = 1 - traj.done[t]
        delta = traj.reward[t] + config.gamma * next_value * live - traj.value[t]
        next_adv = delta + config.gamma * config.gae_lambda * live * next_adv
        advantages[t] = next_adv
        next_value = traj.value[t]
    return advantages, advantages + traj.value


def loss_fn(networks: PPONetworks, config: PPOConfig, params, batch, obs_stat: RunningStat):
    """(total, (policy loss, value loss)) of a minibatch, as the JAX
    package computes it (its clip and minimum's ties included)."""
    obs, action, old_logp, advantage, ret = batch
    obs_n = obs_stat.normalize(obs)
    ratio = (networks.log_prob(params, obs_n, action) - old_logp).exp()
    adv = (advantage - advantage.mean()) / (advantage.std(correction=0) + 1e-8)
    eps = config.clip_epsilon
    clipped = torch.minimum(torch.maximum(ratio, torch.full_like(ratio, 1 - eps)), torch.full_like(ratio, 1 + eps))
    policy_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
    value_loss = ((networks.value.apply(params["value"], obs_n)[..., 0] - ret) ** 2).mean()
    total = policy_loss + config.value_cost * value_loss - config.entropy_cost * networks.entropy(params)
    return total, (policy_loss, value_loss)


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def _update(networks, config, params, opt_state: AdamState, batch, obs_stat):
    """One minibatch: the gradient, optax's clip_by_global_norm over every
    parameter, and Adam at the schedule's rate."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        total, _ = loss_fn(networks, config, leaves, batch, obs_stat)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    with torch.no_grad():
        # optax's global norm sums the leaves in the tree's (sorted key) order
        norm = torch.sqrt(sum((g**2).sum() for _, g in sorted(grads.items())))
        keep = norm < config.max_grad_norm
        rate = learning_rate(config, opt_state.count)
        new_params, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = torch.where(keep, g, (g / norm) * config.max_grad_norm)
            update, leaf = adam_update(g, AdamState(opt_state.count, opt_state.mu[k], opt_state.nu[k]), rate)
            new_params[k], mu[k], nu[k] = params[k] + update, leaf.mu, leaf.nu
    return new_params, AdamState(opt_state.count + 1, mu, nu)


def ppo_iteration(env, networks: PPONetworks, config: PPOConfig, state: PPOState, draws: PPODraws):
    """One PPO iteration from given draws: returns (new state, metrics), the
    metrics 0-dim tensors on the env's device (the JAX package's; the
    resets in the unroll, the most of one env, and the draws' reset slots);
    the state's generator is passed on untouched. Raises :class:`ResetsExhausted` (before any
    update) when an env finished more often than the draws hold resets."""
    steps, batch = config.unroll_length, config.num_envs
    with torch.no_grad():
        env_state, obs, traj, resets = collect(env, networks, config, state, draws)
        needed = int(resets.max())
        if needed > draws.reset_noise.shape[0]:
            raise ResetsExhausted(needed, draws.reset_noise.shape[0])
        last_value = networks.value.apply(state.params["value"], state.obs_stat.normalize(obs))[..., 0]
        advantages, returns = gae(config, traj, last_value)
    n = steps * batch
    flat = (traj.obs.reshape(n, -1), traj.action.reshape(n, -1), traj.log_prob.reshape(n), advantages.reshape(n),
            returns.reshape(n))
    params, opt_state = state.params, state.opt_state
    mb = n // config.num_minibatches
    for epoch in range(config.num_epochs):
        shuffled = tuple(x.index_select(0, draws.permutations[epoch]) for x in flat)
        for i in range(config.num_minibatches):
            minibatch = tuple(x[i * mb : (i + 1) * mb] for x in shuffled)
            params, opt_state = _update(networks, config, params, opt_state, minibatch, state.obs_stat)
    with torch.no_grad():
        obs_stat = state.obs_stat.update_batch(flat[0])
    new_state = PPOState(params=params, opt_state=opt_state, env_state=env_state, obs=obs, obs_stat=obs_stat,
                         generator=state.generator, iteration=state.iteration + 1)
    metrics = {"reward_mean": traj.reward.mean(), "episode_done_rate": traj.done.mean(), "value_mean": traj.value.mean(),
               "resets": resets.sum(), "env_resets_max": torch.tensor(needed, device=obs.device),
               "reset_slots": torch.tensor(draws.reset_noise.shape[0], device=obs.device)}
    if draws.reset_pool is not None:
        # the resets that took a pool state: slot r of env b ran where r < its resets
        used = torch.arange(draws.reset_noise.shape[0], device=obs.device)[:, None] < resets[None]
        metrics["pool_resets"] = (used & draws.reset_pool[0]).sum()
    return new_state, metrics


def _power_of_two(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def make_ppo(env, networks: PPONetworks, config: PPOConfig) -> Tuple[Callable, Callable]:
    """(init_fn(seed, dtype=None) -> PPOState, step_fn(state, draws=None) ->
    (state, metrics)). ``init_fn`` draws the parameters from a CPU
    generator seeded ``seed`` and the first resets from the state's
    generator, on the env's device, seeded ``seed + 1``; ``step_fn`` takes
    its draws from the state's generator unless ``draws`` are given."""

    def init_fn(seed: int = 0, dtype: Optional[torch.dtype] = None) -> PPOState:
        dtype = dtype or env.dtype
        params = networks.init(torch.Generator().manual_seed(seed), config, dtype=dtype, device=env.device)
        generator = torch.Generator(device=env.device).manual_seed(seed + 1)
        env_state, obs = env.reset(generator, batch_size=config.num_envs)
        return PPOState(params=params, opt_state=adam_init(params), env_state=env_state, obs=obs,
                        obs_stat=RunningStat.create(env.observation_dim, dtype, env.device), generator=generator,
                        iteration=0)

    # reset slots an iteration draws: a power of two, at least what the last
    # iteration needed (the early ant falls within ~20 steps, several times
    # an unroll), so that a retry, which collects again, stays rare and the
    # fresh resets' settle graphs few
    slots = RESET_SLOTS

    def step_fn(state: PPOState, draws: Optional[PPODraws] = None):
        nonlocal slots
        if draws is not None:
            return ppo_iteration(env, networks, config, state, draws)
        draws = draw_iteration(env, config, state.generator, state.obs.dtype, slots)
        while True:
            try:
                out = ppo_iteration(env, networks, config, state, draws)
                slots = _power_of_two(max(int(out[1]["env_resets_max"]), RESET_SLOTS))
                return out
            except ResetsExhausted as e:
                # past its slots an env replays its last one, so the count
                # it reached may be short of what it needs
                wanted = min(_power_of_two(max(e.needed, 2 * draws.reset_noise.shape[0])), config.unroll_length)
                draws = more_resets(env, config, draws, state.generator, wanted)

    return init_fn, step_fn
