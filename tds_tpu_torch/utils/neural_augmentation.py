"""Neural-augmented dynamics (counterpart of
tds_tpu/utils/neural_augmentation.py): NeuralSim-style hybrid simulation.

An :class:`AugmentationSpec` declares named wirings, output taps from input
taps, each an MLP over its slice of one flat parameter vector;
:meth:`AugmentationSpec.apply` gives ``value + net(inputs)`` (a residual)
or ``net(inputs)`` (a replacement) inside any dynamics function, and
autograd or ``torch.func`` differentiate it with the rest. The usual use, a
learned joint-space residual on top of the analytic engine, is
:func:`make_residual_dynamics`.
"""

from typing import Dict, Sequence

import torch

from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics
from tds_tpu_torch.learn.nn import Activation, MLPSpec


class Wiring:
    """One named augmentation: output taps from input taps through an MLP
    of ``hidden`` layers with ``activation`` and a linear output scaled by
    ``output_scale``."""

    def __init__(
        self,
        name: str,
        input_dim: int,
        output_dim: int,
        hidden: Sequence[int] = (16, 16),
        activation: Activation = Activation.TANH,
        residual: bool = True,
        output_scale: float = 1.0,
    ):
        self.name = name
        self.residual = residual
        self.output_scale = output_scale
        self.net = MLPSpec(input_dim, list(hidden) + [output_dim], [activation] * len(hidden) + [Activation.IDENTITY])

    @property
    def num_parameters(self) -> int:
        return self.net.num_parameters


class AugmentationSpec:
    """Wirings sharing one flat parameter vector, in the order they were
    added, with L1 and L2 weight regularisation."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.wirings: Dict[str, Wiring] = {}
        self._offsets: Dict[str, int] = {}
        self._total = 0
        self.l1 = l1
        self.l2 = l2

    def add_wiring(self, wiring: Wiring) -> "AugmentationSpec":
        self.wirings[wiring.name] = wiring
        self._offsets[wiring.name] = self._total
        self._total += wiring.num_parameters
        return self

    @property
    def num_parameters(self) -> int:
        return self._total

    def params_for(self, params, name: str):
        """The slice of ``params`` (..., num_parameters) that wiring
        ``name`` reads."""
        off = self._offsets[name]
        return params[..., off : off + self.wirings[name].num_parameters]

    def apply(self, params, name: str, inputs, value=None):
        """Wiring ``name`` on ``inputs``: ``value + net(inputs)`` for a
        residual wiring given a value, else ``net(inputs)``."""
        w = self.wirings[name]
        out = w.output_scale * w.net.apply(self.params_for(params, name), inputs)
        if w.residual and value is not None:
            return value + out
        return out

    def regularization(self, params):
        return self.l1 * params.abs().sum() + self.l2 * (params**2).sum()


def make_residual_dynamics(model, spec: AugmentationSpec, gravity, wiring_name: str = "tau_residual"):
    """``dynamics(params, q, qd, tau) = ABA(q, qd, tau + net([q, qd]))``: a
    learned joint-space residual on top of the analytic engine. The wiring
    maps dof_q + dof_qd inputs to dof_actuated torques."""

    def dynamics(params, q, qd, tau):
        tau_aug = spec.apply(params, wiring_name, torch.cat([q, qd], dim=-1), value=tau)
        return forward_dynamics(model, q, qd, tau_aug, gravity)

    return dynamics
