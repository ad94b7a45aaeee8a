"""Analytic policy gradients (APG): a policy trained by differentiating the
simulator itself (counterpart of tds_tpu/learn/apg.py).

The JAX package takes ``jax.value_and_grad`` of a ``lax.scan`` rollout of
``jax.checkpoint(step)``. Here the rollout is
:func:`tds_tpu_torch.utils.graphs.scan` under autograd:

- on the CPU the Python loop, each step under ``torch.utils.checkpoint``
  when ``remat`` is set (the same values, less memory);
- on the card replayed CUDA graphs forward, and a one-step VJP graph
  replayed in reverse (which recomputes the step, so ``remat`` changes
  nothing there); K1's backward kernel carries the contact solve's
  gradient.

The carry is (q, qd, return so far, step index); the policy's flat
parameters are the scan's consts. ``truncation=k`` cuts the gradient chain
every k steps as the JAX package does: at a step whose index is a multiple
of k, (q, qd) enter as ``where(cut, q.detach(), q)``, inside the one scan,
so that the parameters' gradient sums its steps in one sequence on the
card and in the Python loop alike.

The update is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(learning_rate))`` written out: the clip scales by ``max_norm / norm``
when ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6``), and Adam keeps optax's moments and bias correction.
"""

import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from tds_tpu_torch.envs.base import EnvState
from tds_tpu_torch.utils.graphs import scan


class APGConfig(NamedTuple):
    horizon: int = 200
    batch: int = 32
    learning_rate: float = 1e-2
    remat: bool = True
    truncation: int = 0  # 0 = full backprop through time
    max_grad_norm: float = 10.0


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the step count and the two moments."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class APGState(NamedTuple):
    params: torch.Tensor
    opt_state: AdamState
    generator: torch.Generator  # draws the start states of each step's rollouts


def init_apg(env, policy, seed: int, cfg: APGConfig, dtype: Optional[torch.dtype] = None) -> APGState:
    """Xavier-initialised params (from a generator seeded with ``seed``) and
    a zero Adam state, on the env's device in its dtype (or ``dtype``); the
    state's generator, on the env's device, is seeded with ``seed + 1``."""
    dtype = dtype or env.dtype
    params = policy.init(torch.Generator().manual_seed(seed), dtype=dtype, device=env.device)
    generator = torch.Generator(device=env.device).manual_seed(seed + 1)
    return APGState(params=params, opt_state=adam_init(params), generator=generator)


def adam_init(params) -> AdamState:
    return AdamState(count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: ``grads`` as they are below ``max_norm``,
    else ``(grads / norm) * max_norm``."""
    norm = torch.linalg.vector_norm(grads)
    return torch.where(norm < max_norm, grads, (grads / norm) * max_norm)


def adam_update(grads, state: AdamState, learning_rate: float, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam's update and new state for ``grads``."""
    mu = (1 - b1) * grads + b1 * state.mu
    nu = (1 - b2) * grads**2 + b2 * state.nu
    count = state.count + 1
    mu_hat = mu / (1 - b1**count)
    nu_hat = nu / (1 - b2**count)
    updates = -learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return updates, AdamState(count=count, mu=mu, nu=nu)


def rollout_return(env, policy, cfg: APGConfig, params, q0, qd0, reward_fn: Optional[Callable] = None):
    """The mean over the batch of each env's summed reward over
    ``cfg.horizon`` steps of ``policy`` from (q0, qd0), differentiable in
    ``params``. ``reward_fn(q, qd, action)`` gives the per-env reward of the
    step's new state; without it the env's own step reward is used."""
    body = functools.partial(_step, env, policy, reward_fn, cfg.truncation)
    if cfg.remat and q0.device.type == "cpu":
        plain = body

        def body(carry, consts):
            return checkpoint(lambda *t: plain(t[:4], t[4:]), *carry, *consts, use_reentrant=False)

    index = torch.zeros((), dtype=torch.int64, device=q0.device)
    carry = (q0, qd0, q0.new_zeros(q0.shape[:-1]), index)
    _, _, ret, _ = scan(body, carry, (params,), cfg.horizon, key=("apg", env, policy, reward_fn, cfg.truncation))
    return ret.mean()


def _step(env, policy, reward_fn, truncation, carry, consts):
    q, qd, ret, index = carry
    (params,) = consts
    if truncation:
        # cut the gradient chain every `truncation` steps
        cut = index % truncation == 0
        q, qd = torch.where(cut, q.detach(), q), torch.where(cut, qd.detach(), qd)
    action = env.action_transform(policy.apply(params, env.observation(q, qd)))
    if reward_fn is None:
        t = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
        state, _, reward, _ = env.step(EnvState(q, qd, t), action)
        q2, qd2 = state.q, state.qd
    else:
        q2, qd2 = env.sim_step(q, qd, action)
        reward = reward_fn(q2, qd2, action)
    return q2, qd2, ret + reward, index + 1


def draw_starts(env, generator: torch.Generator, batch: int):
    """(q0, qd0) of ``batch`` env resets drawn from ``generator``."""
    state, _ = env.reset(generator, batch_size=batch)
    return state.q, state.qd


def make_apg_train_step(env, policy, cfg: APGConfig, reward_fn: Optional[Callable] = None):
    """Returns ``train_step(state, starts=None) -> (state, metrics)``: one
    rollout of ``cfg.batch`` envs, the gradient of minus its mean return,
    the clip and the Adam update. ``starts`` = (q0, qd0) replaces the
    states drawn from ``state.generator`` (a test feeds the JAX package's).
    ``metrics`` holds ``mean_return`` and ``grad_norm`` (the norm before
    the clip) as 0-dim tensors on the device."""

    def train_step(state: APGState, starts=None):
        q0, qd0 = draw_starts(env, state.generator, cfg.batch) if starts is None else starts
        params = state.params.detach().requires_grad_()
        with torch.enable_grad():
            ret = rollout_return(env, policy, cfg, params, q0, qd0, reward_fn)
            (grads,) = torch.autograd.grad(-ret, params)
        with torch.no_grad():
            grad_norm = torch.linalg.vector_norm(grads)
            updates, opt_state = adam_update(clip_by_global_norm(grads, cfg.max_grad_norm), state.opt_state, cfg.learning_rate)
            new_params = state.params + updates
        metrics = {"mean_return": ret.detach(), "grad_norm": grad_norm}
        return APGState(params=new_params, opt_state=opt_state, generator=state.generator), metrics

    return train_step
