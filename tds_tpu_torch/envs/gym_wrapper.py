"""Gymnasium-style wrappers (counterpart of tds_tpu/envs/gym_wrapper.py):
the stateful ``reset``/``step`` API with a numpy boundary, so the port's
envs drop into external RL libraries.

:class:`GymEnv` wraps one env, :class:`GymVectorEnv` a batch of them with
auto-reset (``envs/vectorized.py``). Neither needs ``gymnasium``: with it
installed the wrappers derive from ``gymnasium.Env`` and their spaces are
its ``Box``es; without it the spaces are :class:`Box`, a minimal box of
this module with ``sample``, ``contains``, ``shape``, ``low``, ``high`` and
``dtype``. Randomness comes from a ``torch.Generator`` seeded by ``seed``.
"""

from typing import Optional

import numpy as np
import torch

from tds_tpu_torch.envs.vectorized import VectorizedEnv

try:
    import gymnasium
    from gymnasium import spaces
except ImportError:
    gymnasium = None
    spaces = None


class Box:
    """A box of float32 values in [low, high], drawn from a numpy
    generator by :meth:`sample`."""

    def __init__(self, low: float, high: float, shape, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)
        self._rng = np.random.default_rng()

    def sample(self):
        finite = np.isfinite(self.low) & np.isfinite(self.high)
        out = np.where(finite, self._rng.uniform(np.where(finite, self.low, 0), np.where(finite, self.high, 1)),
                       self._rng.normal(size=self.shape))
        return out.astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low) and np.all(x <= self.high))


def _box(low, high, shape):
    if spaces is not None:
        return spaces.Box(low, high, shape=shape, dtype=np.float32)
    return Box(low, high, shape)


def _numpy(x):
    return x.detach().cpu().numpy()


class GymEnv(gymnasium.Env if gymnasium else object):
    """One env of ``env`` (a batch of one) behind Gymnasium's API: ``reset``
    returns (obs, info), ``step`` (obs, reward, terminated, truncated,
    info) with truncation after ``max_episode_steps``."""

    metadata = {"render_modes": []}

    def __init__(self, env, max_episode_steps: int = 1000, seed: int = 0, action_limit: float = 1.0):
        self._env = env
        self._max_steps = max_episode_steps
        self._generator = torch.Generator(device=env.device).manual_seed(seed)
        self._state = None
        self._steps = 0
        self.observation_space = _box(-np.inf, np.inf, (env.observation_dim,))
        self.action_space = _box(-action_limit, action_limit, (env.action_dim,))

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state, obs = self._env.reset(self._generator, batch_size=1)
        self._steps = 0
        return _numpy(obs[0]).astype(np.float32), {}

    def step(self, action):
        a = torch.as_tensor(np.asarray(action), dtype=self._env.dtype, device=self._env.device).reshape(1, -1)
        self._state, obs, reward, done = self._env.step(self._state, a)
        self._steps += 1
        return _numpy(obs[0]).astype(np.float32), float(reward[0]), bool(done[0]), self._steps >= self._max_steps, {}

    def render(self):
        raise NotImplementedError("use tds_tpu_torch.visualizer.renderer for offscreen frames")


class GymVectorEnv:
    """``num_envs`` envs stepped as one batch behind a numpy boundary, each
    finished env reset in the step that finished it (its obs the fresh
    reset's, as Gymnasium's same-step autoreset gives)."""

    def __init__(self, env, num_envs: int, seed: int = 0, action_limit: float = 1.0):
        self._vec = VectorizedEnv(env, num_envs)
        self._env = env
        self.num_envs = num_envs
        self._generator = torch.Generator(device=env.device).manual_seed(seed)
        self._state = None
        self.single_observation_space = _box(-np.inf, np.inf, (env.observation_dim,))
        self.single_action_space = _box(-action_limit, action_limit, (env.action_dim,))

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state, obs = self._vec.reset(self._generator)
        return _numpy(obs).astype(np.float32), {}

    def step(self, actions):
        a = torch.as_tensor(np.asarray(actions), dtype=self._env.dtype, device=self._env.device).reshape(self.num_envs, -1)
        self._state, obs, reward, done = self._vec.step(self._state, a, self._generator)
        n = self.num_envs
        return _numpy(obs).astype(np.float32), _numpy(reward).astype(np.float64), _numpy(done), np.zeros(n, bool), {}
