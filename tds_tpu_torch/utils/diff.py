"""Differentiation facade (counterpart of tds_tpu/utils/diff.py): the
reference's ``DiffMethod`` engines on one autograd.

==================  ==================================================
DiffMethod          here
==================  ==================================================
NUMERICAL           :func:`gradient_fd` (central differences)
FORWARD             ``torch.func.jacfwd`` (forward mode)
REVERSE             ``torch.autograd.grad`` (reverse mode)
==================  ==================================================

Reverse mode goes through ``torch.autograd`` rather than ``torch.func.grad``:
the port's hand-written kernels and ``graphs.scan`` on the card are
autograd functions whose backward launches kernels and replays graphs.
Forward mode is ``torch.func.jacfwd``, on the card too: K1's forward-mode
kernel carries the contact solve's tangents (``contact.pgs.PGSFunction``'s
JVP and vmap rules), and ``graphs.scan`` replays a JVP graph of the step
over the tangents, as ``jax.jacfwd`` runs through the JAX package's
contact solve. ``compile=True`` adds nothing to what the function does
itself: a rollout through ``graphs.scan`` replays CUDA graphs on the card,
the counterpart of ``jax.jit``.
"""

import enum
from typing import Callable

import numpy as np
import torch


class DiffMethod(enum.IntEnum):
    NUMERICAL = 0
    FORWARD = 1
    REVERSE = 2


def gradient_fd(f: Callable, eps: float = 1e-6):
    """Central-difference gradient of a scalar ``f`` of a flat vector."""

    def grad(x, *args):
        x = torch.as_tensor(x)
        basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return torch.stack([(f(x + eps * e, *args) - f(x - eps * e, *args)) / (2 * eps) for e in basis])

    return grad


def gradient_reverse(f: Callable):
    """Reverse-mode gradient of a scalar ``f`` of a flat vector."""

    def grad(x, *args):
        x = torch.as_tensor(x).detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(f(x, *args), x)
        return g

    return grad


class GradientFunctional:
    """value(x) / gradient(x) of a scalar function of a flat parameter
    vector (plus optional trailing args) by one :class:`DiffMethod`."""

    def __init__(self, f: Callable, method: DiffMethod = DiffMethod.REVERSE, compile: bool = True, fd_eps: float = 1e-6):
        self.method = DiffMethod(method)
        self._value = f
        if self.method == DiffMethod.NUMERICAL:
            self._grad = gradient_fd(f, fd_eps)
        elif self.method == DiffMethod.FORWARD:
            self._grad = torch.func.jacfwd(f)
        else:
            self._grad = gradient_reverse(f)

    def value(self, x, *args):
        return self._value(torch.as_tensor(x), *args)

    def gradient(self, x, *args):
        return self._grad(torch.as_tensor(x), *args)


def check_gradient(f: Callable, x, rtol: float = 1e-4, atol: float = 1e-6, eps: float = 1e-6):
    """Reverse mode against central differences; raises when they differ
    beyond ``rtol``/``atol``. Returns (ad, fd, max_abs_err)."""
    ad = gradient_reverse(f)(x)
    fd = gradient_fd(f, eps)(x)
    err = float((ad - fd).abs().max())
    np.testing.assert_allclose(ad.detach().cpu().numpy(), fd.detach().cpu().numpy(), rtol=rtol, atol=atol)
    return ad, fd, err
