"""Parameter estimation (system identification), the counterpart of
tds_tpu/utils/estimation.py: named parameters with box bounds and L1/L2
regularisation, a problem that bundles them with a cost, and projected
gradient descent and Adam over reverse-mode gradients."""

import dataclasses
import math
from typing import Callable, Sequence

import torch

from tds_tpu_torch.utils.diff import gradient_reverse
from tds_tpu_torch.utils.tensors import resolve_device


@dataclasses.dataclass
class EstimationParameter:
    """A named scalar parameter with bounds and regularisation."""

    name: str
    value: float = 1.0
    minimum: float = -math.inf
    maximum: float = math.inf
    l1_regularization: float = 0.0
    l2_regularization: float = 0.0


class OptimizationProblem:
    """A cost over a flat parameter vector with box bounds and
    regularisation; ``fitness(x)`` and ``gradient(x)``. Vectors are
    float64 tensors on the card unless ``device`` names another."""

    dtype = torch.float64

    def __init__(self, cost_fn: Callable, parameters: Sequence[EstimationParameter], device=None):
        self.parameters = list(parameters)
        self.device = resolve_device(device)

        def vector(field):
            return torch.tensor([getattr(p, field) for p in self.parameters], dtype=self.dtype, device=self.device)

        self.lower, self.upper = vector("minimum"), vector("maximum")
        l1, l2 = vector("l1_regularization"), vector("l2_regularization")

        def full_cost(x):
            return cost_fn(x) + ((l1 * x.abs()).sum() + (l2 * x * x).sum())

        self._cost = full_cost
        self.gradient = gradient_reverse(full_cost)

    def fitness(self, x):
        with torch.no_grad():
            return self._cost(x)

    def initial_guess(self):
        return torch.tensor([p.value for p in self.parameters], dtype=self.dtype, device=self.device)

    def project(self, x):
        # jnp.clip: min(max(x, lower), upper)
        return torch.minimum(torch.maximum(x, self.lower), self.upper)


def _start(problem, x0):
    return problem.initial_guess() if x0 is None else torch.as_tensor(x0, dtype=problem.dtype, device=problem.device)


def gradient_descent(problem: OptimizationProblem, x0=None, learning_rate=1e-2, iterations: int = 100):
    """Projected gradient descent. Returns (best_x, best_cost, history)."""
    x = _start(problem, x0)
    best_x, best_c = x, float(problem.fitness(x))
    history = []
    for _ in range(iterations):
        x = problem.project(x - learning_rate * problem.gradient(x))
        c = float(problem.fitness(x))
        history.append(c)
        if c < best_c:
            best_x, best_c = x, c
    return best_x, best_c, history


def adam_estimate(problem: OptimizationProblem, x0=None, learning_rate=1e-2, iterations: int = 200, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with box projection, keeping the best parameters seen.
    Returns (best_x, best_cost, history)."""
    x = _start(problem, x0)
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    best_x, best_c = x, float(problem.fitness(x))
    history = []
    for t in range(1, iterations + 1):
        g = problem.gradient(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        x = problem.project(x - learning_rate * mh / (torch.sqrt(vh) + eps))
        c = float(problem.fitness(x))
        history.append(c)
        if c < best_c:
            best_x, best_c = x, c
    return best_x, best_c, history
