"""Linear policies (counterpart of tds_tpu/learn/nn.py).

ARS perturbs flat parameter vectors, so the flat layout
[layer0 W (out, in) row-major, layer0 b, layer1 W, ...] stays the exchange
format: :meth:`MLPSpec.apply` runs a network straight from a flat vector,
and :class:`LinearPolicy` is the one-layer policy as an ``nn.Module`` that
loads and exports that layout. Only the layout the ARS policy uses is
ported: identity activations, every layer with a bias. The JAX package's
other activations and bias-free layers wait for the slice that trains MLPs.
"""

from typing import List, Sequence, Tuple

import torch
from torch import nn

from tds_tpu_torch.utils.tensors import resolve_device


class MLPSpec:
    """Network shape: input_dim -> layer_dims..., each layer linear with a
    bias (the JAX package's identity activations, ``use_bias=True``)."""

    def __init__(self, input_dim: int, layer_dims: Sequence[int]):
        self.input_dim = input_dim
        self.layer_dims = tuple(layer_dims)

    @property
    def num_parameters(self) -> int:
        dims = (self.input_dim,) + self.layer_dims
        return sum(a * b + b for a, b in zip(dims, dims[1:]))

    def unflatten(self, params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        layers, prev, off = [], self.input_dim, 0
        for d in self.layer_dims:
            w = params[..., off : off + prev * d].reshape(params.shape[:-1] + (d, prev))
            off += prev * d
            b = params[..., off : off + d]
            off += d
            layers.append((w, b))
            prev = d
        return layers

    def apply(self, params, x):
        """Forward pass from a flat parameter vector; broadcasts over
        leading batch dims of params and x."""
        for w, b in self.unflatten(params):
            x = torch.einsum("...ij,...j->...i", w, x) + b
        return x


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
