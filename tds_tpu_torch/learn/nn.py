"""Fully-connected networks over flat parameter vectors (counterpart of
tds_tpu/learn/nn.py).

ARS perturbs flat parameter vectors and APG differentiates them, so the
flat layout [layer0 W (out, in) row-major, layer0 b, layer1 W, ...] is the
exchange format: :meth:`MLPSpec.apply` runs a network straight from a flat
vector, with the JAX package's eight activations and its bias-free layers,
and :meth:`MLPSpec.init` draws one (Xavier, He or zero) from a
``torch.Generator``. :class:`LinearPolicy` is the ARS policy as an
``nn.Module`` that loads and exports that layout.
"""

import enum
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from tds_tpu_torch.utils.tensors import resolve_device


class Activation(enum.IntEnum):
    IDENTITY = -1
    TANH = 0
    SIN = 1
    RELU = 2
    SOFT_RELU = 3
    ELU = 4
    SIGMOID = 5
    SOFTSIGN = 6


def _elu(x):
    # jax.nn.elu: x above 0, expm1(x) at and below 0 (alpha 1)
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, torch.zeros_like(x), x)))


_ACT_FNS = {
    Activation.IDENTITY: lambda x: x,
    Activation.TANH: torch.tanh,
    Activation.SIN: torch.sin,
    Activation.RELU: torch.relu,
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above its threshold
    Activation.SOFT_RELU: lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    Activation.ELU: _elu,
    Activation.SIGMOID: torch.sigmoid,
    Activation.SOFTSIGN: lambda x: x / (x.abs() + 1),
}


class MLPSpec:
    """Network shape: input_dim -> layer_dims..., each layer linear (with a
    bias unless ``use_bias`` is False) followed by its activation
    (identity when ``activations`` is None)."""

    def __init__(
        self,
        input_dim: int,
        layer_dims: Sequence[int],
        activations: Optional[Sequence[Activation]] = None,
        use_bias: bool = True,
    ):
        self.input_dim = input_dim
        self.layer_dims = tuple(layer_dims)
        if activations is None:
            activations = [Activation.IDENTITY] * len(self.layer_dims)
        self.activations = tuple(Activation(a) for a in activations)
        if len(self.activations) != len(self.layer_dims):
            raise ValueError(f"{len(self.activations)} activations for {len(self.layer_dims)} layers")
        self.use_bias = use_bias

    @property
    def num_parameters(self) -> int:
        dims = (self.input_dim,) + self.layer_dims
        return sum(a * b + (b if self.use_bias else 0) for a, b in zip(dims, dims[1:]))

    def unflatten(self, params) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """(W (..., out, in), b (..., out) or None) per layer."""
        layers, prev, off = [], self.input_dim, 0
        for d in self.layer_dims:
            w = params[..., off : off + prev * d].reshape(params.shape[:-1] + (d, prev))
            off += prev * d
            b = None
            if self.use_bias:
                b = params[..., off : off + d]
                off += d
            layers.append((w, b))
            prev = d
        return layers

    def apply(self, params, x):
        """Forward pass from a flat parameter vector; broadcasts over
        leading batch dims of params and x. With a weight matrix per env
        (ARS's perturbed params) each layer is a product and a sum over the
        inputs, whose roundings do not depend on the batch: a batched GEMM's
        do on the card (cuBLAS picks its kernel by the batch count), which
        would make an env's rollout depend on how many run beside it."""
        for (w, b), act in zip(self.unflatten(params), self.activations):
            if w.dim() > 2:
                x = (w * x[..., None, :]).sum(-1)
            else:
                x = torch.einsum("...ij,...j->...i", w, x)
            if b is not None:
                x = x + b
            x = _ACT_FNS[act](x)
        return x

    def init(self, generator: Optional[torch.Generator] = None, scheme: str = "xavier", dtype=torch.float32, device=None):
        """A flat parameter vector: weights Xavier-uniform (``"xavier"``),
        He-normal (``"he"``) or zero (``"zero"``), biases zero; drawn from
        ``generator`` on its device and moved to ``device`` (the card unless
        it names another)."""
        if scheme not in ("xavier", "he", "zero"):
            raise ValueError(f"unknown init scheme {scheme!r}")
        gen_device = generator.device if generator is not None else resolve_device(device)
        parts, prev = [], self.input_dim
        for d in self.layer_dims:
            if scheme == "zero":
                w = torch.zeros(d * prev, dtype=dtype, device=gen_device)
            elif scheme == "he":
                w = math.sqrt(2.0 / prev) * torch.randn(d * prev, generator=generator, dtype=dtype, device=gen_device)
            else:
                limit = math.sqrt(6.0 / (prev + d))
                w = torch.rand(d * prev, generator=generator, dtype=dtype, device=gen_device) * (2 * limit) - limit
            parts.append(w)
            if self.use_bias:
                parts.append(torch.zeros(d, dtype=dtype, device=gen_device))
            prev = d
        return torch.cat(parts).to(resolve_device(device))


class LinearPolicy(nn.Linear):
    """The ARS policy head: one linear layer with a bias, obs -> action."""

    def load_flat(self, params) -> "LinearPolicy":
        """Load a flat (obs*act + act,) vector in the MLPSpec layout."""
        params = torch.as_tensor(params)
        expected = self.in_features * self.out_features + self.out_features
        if params.shape != (expected,):
            raise ValueError(f"expected {expected} parameters, got {tuple(params.shape)}")
        w, b = MLPSpec(self.in_features, [self.out_features]).unflatten(params)[0]
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(b)
        return self

    def flat(self) -> torch.Tensor:
        return torch.cat([self.weight.detach().reshape(-1), self.bias.detach()])


def linear_policy(observation_dim: int, action_dim: int, dtype=torch.float64, device=None) -> LinearPolicy:
    """A zero-initialised linear policy, on the card unless ``device``
    names another."""
    policy = LinearPolicy(observation_dim, action_dim, dtype=dtype, device=resolve_device(device))
    nn.init.zeros_(policy.weight)
    nn.init.zeros_(policy.bias)
    return policy
