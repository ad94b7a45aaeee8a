"""Augmented Random Search (counterpart of tds_tpu/learn/ars.py).

- The + and - rollouts of an iteration run as one batch of
  2 * num_directions envs, one ``utils.graphs.scan`` over the horizon
  (replayed CUDA graphs on the card, a Python loop on the CPU): with
  ``LocomotionEnv(fused_step=True)`` each step launches the fused step
  kernel K2 once for the whole batch. Direction i's two rollouts start from
  the same reset noise.
- The iteration takes its draws as arguments (:func:`ars_iteration`: the
  deltas, the reset noise and, for an env with a reset pool, the pool
  draws), so a test can hand it another implementation's;
  :func:`make_train_step` draws them from the state's ``torch.Generator``
  on the env's device.
- Evaluation may run on another env than training (``train``'s
  ``eval_env``): an env whose resets start from a pool trains, and the
  same env without the pool evaluates.
- Reward accumulation freezes at done; a rollout whose state turns
  non-finite is gated as terminated and its statistics stay finite.
- Observations push into the statistics during the rollouts, while the
  policy reads the previous iteration's frozen ones; the pos statistics
  merge before the neg ones.
- Update: w += step_size * g_hat, g_hat = mean((r+ - r-) / sigma_R * delta)
  * delta_std over all directions or the top_directions by max(r+, r-),
  sigma_R the population std of the rewards used (at least 1e-6).
- With a ``mesh`` (``tds_tpu_torch.parallel.mesh``) every rank draws the
  same deltas and reset noise, rolls out its contiguous slice of the
  directions (both signs) and gathers the rollouts' rewards, steps and
  observation sums back into direction order; the update that follows is
  the same on every rank, and equal to the one-process update whenever a
  rollout's results do not depend on the batch it ran in.
"""

from typing import Callable, NamedTuple, Optional

import torch

from tds_tpu_torch.envs.base import EnvState
from tds_tpu_torch.learn.nn import MLPSpec
from tds_tpu_torch.learn.running_stat import RunningStat
from tds_tpu_torch.parallel.mesh import batch_sharding, gather_batch
from tds_tpu_torch.utils.graphs import scan

# steps per CUDA graph of a rollout through the fused step (K2 and ~31
# small operations a step, so ~3,200 nodes a replay); a rollout through the
# eager contact step (~3,600 nodes a step) takes one step a graph. On the
# H100, ten alternating runs of the recipe's rollout at each (chip_smoke.py
# phase 9 (c)) set it (PERF.md)
FUSED_CHUNK = 100

class ARSConfig(NamedTuple):
    """The JAX package's fields and defaults."""

    num_directions: int = 128  # parallel +- rollout pairs
    rollout_length: int = 3000
    delta_std: float = 0.03
    step_size: float = 0.02
    shift: float = 0.0  # per-step reward shift
    eval_interval: int = 10
    scale_by_reward_std: bool = True  # divide the direction rewards by sigma_R
    top_directions: int = 0  # 0: update from every direction


class ARSState(NamedTuple):
    params: torch.Tensor  # (p,) flat policy parameters
    obs_stat: RunningStat
    generator: torch.Generator  # the draws of every iteration; advanced in place
    iteration: int
    total_timesteps: torch.Tensor  # () int64, env-steps while alive


def init_ars(env, policy: MLPSpec, seed: int = 0, dtype: Optional[torch.dtype] = None) -> ARSState:
    """Zero parameters and empty statistics on the env's device, in
    ``dtype`` (None: the env's), and a generator there seeded with ``seed``."""
    dtype = dtype or env.dtype
    return ARSState(
        params=torch.zeros((policy.num_parameters,), dtype=dtype, device=env.device),
        obs_stat=RunningStat.create(env.observation_dim, dtype, env.device),
        generator=torch.Generator(device=env.device).manual_seed(seed),
        iteration=0,
        total_timesteps=torch.zeros((), dtype=torch.int64, device=env.device),
    )


@torch.no_grad()
def _rollout_with_stats(env, policy: MLPSpec, params, obs_stat: RunningStat, noise, config: ARSConfig, chunk=None,
                        pool_draws=None):
    """Rollouts of (B, p) or (p,) parameters from the reset noise (B, ...)
    (and the reset pool's draws, for an env with a pool), one
    :func:`~tds_tpu_torch.utils.graphs.scan` over the horizon (replayed
    CUDA graphs of ``chunk`` steps on the card; None: FUSED_CHUNK through
    the fused step, else 1); returns (total reward, steps alive, (obs sum,
    obs sum of squares)), each per env."""
    if pool_draws is None:
        state, obs = env.reset(noise=noise)
    else:
        state, obs = env.reset(noise=noise, pool_draws=pool_draws)
    shift = config.shift

    def body(carry, consts):
        q, qd, t, obs, total, alive, steps, s1, s2 = carry
        params, mean, scale = consts
        # a diverged simulation (NaN/Inf state) must not poison the update:
        # gate the rollout as terminated and keep the statistics finite
        finite = torch.isfinite(obs)
        obs_safe = torch.where(finite, obs, 0.0)
        # a float times a bool, and a where below: alive (0 or 1) times
        # finite and times (1 - done) as floats, bit for bit, in 3 device
        # operations fewer
        alive = alive * finite.all(-1)
        weighted = obs_safe * alive[:, None]
        s1 = s1 + weighted
        s2 = s2 + obs_safe * weighted
        action = env.action_transform(policy.apply(params, (obs_safe - mean) / scale))
        state, obs, reward, done = env.step(EnvState(q, qd, t), action)
        reward = torch.nan_to_num(reward, nan=0.0, posinf=0.0, neginf=0.0)
        if shift:
            reward = reward - shift
        total = total + reward * alive
        steps = steps + alive
        alive = torch.where(done, 0.0, alive)
        return state.q, state.qd, state.t, obs, total, alive, steps, s1, s2

    batch = obs.shape[:-1]
    carry = (state.q, state.qd, state.t, obs, obs.new_zeros(batch), obs.new_ones(batch), obs.new_zeros(batch))
    carry += (torch.zeros_like(obs), torch.zeros_like(obs))
    # RunningStat.normalize's terms, frozen for the rollout
    consts = (params, obs_stat.mean, obs_stat.scale())
    key = ("ars_rollout", env, policy.input_dim, policy.layer_dims, shift)
    if chunk is None:
        chunk = FUSED_CHUNK if getattr(env, "step_params", None) is not None else 1
    _, _, _, _, total, _, steps, s1, s2 = scan(body, carry, consts, config.rollout_length, key=key, chunk=chunk)
    return total, steps, (s1, s2)


def _batch_stat(s1, s2, steps, count_dtype) -> RunningStat:
    """The statistics of a group of rollouts from their sums."""
    total = steps.sum()
    safe = total.clamp_min(1.0)
    mean = s1.sum(0) / safe
    m2 = s2.sum(0) - safe * mean**2
    return RunningStat(total.to(count_dtype), mean, m2)


@torch.no_grad()
def ars_iteration(env, policy: MLPSpec, config: ARSConfig, state: ARSState, deltas, noise, pool_draws=None, mesh=None):
    """One ARS iteration from given draws: ``deltas`` (n, p), the unit
    perturbations, ``noise`` (n, ...), the reset noise of direction i's
    two rollouts, and for an env with a reset pool ``pool_draws`` (use
    (n,), index (n,)), their pool draws. Returns (new state, metrics), the
    metrics 0-dim tensors on the env's device; the state's generator is
    passed on untouched. With a ``mesh`` of several ranks each rolls out
    its slice of the n directions (n must divide by the world size) and
    the results are gathered before the update."""
    n = config.num_directions
    if deltas.shape != (n, state.params.shape[0]) or noise.shape[0] != n:
        raise ValueError(f"deltas {tuple(deltas.shape)} and noise {tuple(noise.shape)} do not fit {n} directions")
    lo, hi = (0, n) if mesh is None else batch_sharding(mesh).bounds(n)
    local, local_noise = deltas[lo:hi], noise[lo:hi]
    w = torch.cat([state.params + config.delta_std * local, state.params - config.delta_std * local])
    if pool_draws is not None:
        pool_draws = tuple(torch.cat([d[lo:hi], d[lo:hi]]) for d in pool_draws)
    rewards, steps, (s1, s2) = _rollout_with_stats(
        env, policy, w, state.obs_stat, torch.cat([local_noise, local_noise]), config, pool_draws=pool_draws
    )
    if mesh is not None:
        # each rank's + and - halves back into direction order
        m = hi - lo
        parts = [(x[:m], x[m:]) for x in (rewards, steps, s1, s2)]
        gathered = gather_batch(parts, mesh)
        rewards, steps, s1, s2 = (torch.cat(pair) for pair in gathered)
    r_pos, r_neg = rewards[:n], rewards[n:]

    weights = r_pos - r_neg
    if config.top_directions and config.top_directions < n:
        b = int(config.top_directions)
        # only the selected set matters, not the order of ties
        idx = torch.topk(torch.maximum(r_pos, r_neg), b).indices
        sel = torch.zeros_like(weights).index_fill(0, idx, 1.0)
        if config.scale_by_reward_std:
            sigma_r = torch.cat([r_pos[idx], r_neg[idx]]).std(correction=0).clamp_min(1e-6)
            weights = weights / sigma_r
        g_hat = ((weights * sel)[:, None] * deltas).sum(0) / b * config.delta_std
    else:
        if config.scale_by_reward_std:
            weights = weights / rewards.std(correction=0).clamp_min(1e-6)
        g_hat = (weights[:, None] * deltas).mean(0) * config.delta_std
    params = state.params + config.step_size * g_hat

    count_dtype = state.obs_stat.count.dtype
    obs_stat = state.obs_stat.merge(_batch_stat(s1[:n], s2[:n], steps[:n], count_dtype)).merge(
        _batch_stat(s1[n:], s2[n:], steps[n:], count_dtype)
    )
    new_state = ARSState(
        params=params,
        obs_stat=obs_stat,
        generator=state.generator,
        iteration=state.iteration + 1,
        total_timesteps=state.total_timesteps + steps.sum().to(torch.int64),
    )
    metrics = {
        "reward_pos_mean": r_pos.mean(),
        "reward_neg_mean": r_neg.mean(),
        "reward_max": rewards.max(),
        "g_hat_norm": torch.linalg.vector_norm(g_hat),
    }
    return new_state, metrics


def draw_directions(env, state: ARSState, num_directions: int):
    """(deltas (n, p), reset noise (n, ...), pool draws: (use (n,), index
    (n,)) for an env with a reset pool, else None) from the state's
    generator, on the env's device."""
    gen = state.generator
    deltas = torch.randn(
        (num_directions, state.params.shape[0]), generator=gen, dtype=state.params.dtype, device=gen.device
    )
    noise = env.draw_reset_noise(gen, num_directions)
    pool = env.draw_reset_pool(gen, num_directions) if getattr(env, "reset_pool", None) is not None else None
    return deltas.to(env.device), noise, pool


def make_train_step(env, policy: MLPSpec, config: ARSConfig, mesh=None) -> Callable:
    """Returns state -> (state, metrics): one iteration with its draws
    taken from the state's generator. With ``mesh`` the directions are
    split over its ranks (:func:`ars_iteration`); every rank's state must
    start equal, its generator seeded alike."""
    if mesh is not None:
        batch_sharding(mesh).bounds(config.num_directions)  # raises when the directions do not split

    def step(state: ARSState):
        return ars_iteration(env, policy, config, state, *draw_directions(env, state, config.num_directions), mesh=mesh)

    return step


def make_eval(env, policy: MLPSpec, config: ARSConfig, num_rollouts: int = 16) -> Callable:
    """Returns (state, generator) -> metrics: ``num_rollouts`` rollouts of
    the unperturbed policy with no reward shift, their reset noise drawn
    from ``generator``; the metrics stay 0-dim tensors on the env's device."""
    eval_config = config._replace(shift=0.0)

    def evaluate(state: ARSState, generator: torch.Generator):
        noise = env.draw_reset_noise(generator, num_rollouts)
        rewards, steps, _ = _rollout_with_stats(env, policy, state.params, state.obs_stat, noise, eval_config)
        return {
            "eval_reward_mean": rewards.mean(),
            "eval_reward_min": rewards.min(),
            "eval_reward_max": rewards.max(),
            "eval_steps_mean": steps.mean(),
        }

    return evaluate


def train(
    env,
    policy: MLPSpec,
    config: ARSConfig,
    num_iterations: int,
    seed: int = 0,
    log_fn=None,
    eval_fn_num_rollouts: int = 16,
    state: Optional[ARSState] = None,
    eval_env=None,
    mesh=None,
):
    """The training loop: ``num_iterations`` iterations from ``state`` (None:
    :func:`init_ars` with ``seed``), and after every ``config.eval_interval``-th
    an eval on ``eval_env`` (None: ``env``) whose reset noise comes from a
    generator seeded ``1000 + 100000 * seed + it``, as the JAX package's
    laikago trainer seeds its evals. ``log_fn(it, state, metrics)`` runs after each
    iteration. The metrics stay 0-dim tensors on the env's device: nothing
    here waits for the device, so the iterations queue back to back.
    With ``mesh`` the iterations split their directions over its ranks;
    the evals run whole on every rank.
    Returns (state, history: the metrics of every iteration)."""
    state = init_ars(env, policy, seed) if state is None else state
    step_fn = make_train_step(env, policy, config, mesh)
    eval_env = env if eval_env is None else eval_env
    eval_fn = make_eval(eval_env, policy, config, eval_fn_num_rollouts)
    history = []
    for it in range(num_iterations):
        state, metrics = step_fn(state)
        if (it + 1) % config.eval_interval == 0:
            eval_generator = torch.Generator(device=eval_env.device).manual_seed(1000 + 100000 * seed + it)
            metrics.update(eval_fn(state, eval_generator))
        history.append(metrics)
        if log_fn:
            log_fn(it, state, metrics)
    return state, history
