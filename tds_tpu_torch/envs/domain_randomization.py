"""Domain randomisation: a model per env under ``torch.func.vmap``
(counterpart of tds_tpu/envs/domain_randomization.py).

:class:`~tds_tpu_torch.model.multibody.MultiBodyModel` is a pytree whose
tensor parameters are its leaves (its topology is static), so a batch of
randomised models is one model whose leaves gain a leading axis, and
:func:`vmap_with_models` maps a ``step_fn(model, *state)`` over the models
and the states together with ``torch.func.vmap``. On the card a contact
step inside it runs K1 once for the whole batch: the vmap rule of
``contact.pgs.PGSFunction`` folds the mapped axis into K1's batch.
"""

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tds_tpu_torch.model.multibody import _TENSOR_FIELDS, MultiBodyModel


class RandomizationSpec(NamedTuple):
    """Multiplicative log-uniform ranges per link; 1.0 leaves a field as it is."""

    mass_range: Tuple[float, float] = (0.8, 1.2)
    damping_range: Tuple[float, float] = (1.0, 1.0)
    com_range: Tuple[float, float] = (1.0, 1.0)


def _scale(u, lo: float, hi: float):
    """exp(u (log hi - log lo) + log lo) of uniform draws u, or lo where the
    range is a point (no draw is read)."""
    if lo == hi:
        return torch.full_like(u, lo)
    lo_t, hi_t = torch.tensor(lo, dtype=u.dtype), torch.tensor(hi, dtype=u.dtype)
    return torch.exp(u * (hi_t.log() - lo_t.log()) + lo_t.log())


def draw_uniforms(model: MultiBodyModel, num: int, generator: Optional[torch.Generator] = None):
    """(num, 3, num_links) uniform draws in [0, 1): the mass, damping and
    com draws of each randomised model, from ``generator`` on its device,
    moved to the model's."""
    device = generator.device if generator is not None else model.device
    u = torch.rand((num, 3, model.num_links), generator=generator, dtype=model.dtype, device=device)
    return u.to(model.device)


def randomize_model(model: MultiBodyModel, uniforms, spec: RandomizationSpec = RandomizationSpec()) -> MultiBodyModel:
    """One randomised model from (3, num_links) uniform draws (a row each
    for the mass, damping and com scales); batched (..., 3, num_links)
    draws give a model whose changed leaves carry the leading axes."""
    m_scale = _scale(uniforms[..., 0, :], *spec.mass_range)
    d_scale = _scale(uniforms[..., 1, :], *spec.damping_range)
    c_scale = _scale(uniforms[..., 2, :], *spec.com_range)
    return dataclasses.replace(
        model,
        mass=model.mass * m_scale,
        com=model.com * (m_scale * c_scale)[..., None],
        inertia=model.inertia * m_scale[..., None, None],
        damping=model.damping * d_scale,
    )


def randomize_batch(model: MultiBodyModel, num: int, spec: RandomizationSpec = RandomizationSpec(),
                    generator: Optional[torch.Generator] = None, uniforms=None) -> MultiBodyModel:
    """``num`` randomised models as one model whose every tensor leaf gains
    a leading axis of ``num`` (the topology shared), from ``uniforms``
    (num, 3, num_links) or draws from ``generator``."""
    if uniforms is None:
        uniforms = draw_uniforms(model, num, generator)
    batch = randomize_model(model, uniforms.to(model.device, model.dtype), spec)
    return dataclasses.replace(batch, **{f: _leading(getattr(batch, f), getattr(model, f), num) for f in _TENSOR_FIELDS})


def _leading(leaf, base, num):
    """``leaf`` with a leading axis of ``num``: as it is when randomised,
    else the model's own leaf expanded (a view, as jax.vmap broadcasts an
    unmapped output)."""
    if leaf.dim() == base.dim() + 1:
        return leaf
    return base.expand((num,) + tuple(base.shape))


def vmap_with_models(step_fn: Callable) -> Callable:
    """``step_fn(model, *state)`` mapped over a batch of models (leading
    axis on every leaf, as :func:`randomize_batch` makes) and of states."""
    return torch.func.vmap(step_fn, in_dims=0)
