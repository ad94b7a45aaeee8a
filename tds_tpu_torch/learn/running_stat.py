"""Welford running observation statistics (counterpart of
tds_tpu/learn/running_stat.py): the normalisation a trained policy reads,
and the batch updates and the associative merge that ARS training
accumulates them with."""

from typing import NamedTuple

import torch

from tds_tpu_torch.utils.tensors import resolve_device


class RunningStat(NamedTuple):
    count: torch.Tensor  # ()
    mean: torch.Tensor  # (dim,)
    m2: torch.Tensor  # (dim,)

    @staticmethod
    def create(dim: int, dtype=torch.float32, device=None) -> "RunningStat":
        """Empty statistics, on the card unless ``device`` names another."""
        device = resolve_device(device)
        return RunningStat(
            count=torch.zeros((), dtype=dtype, device=device),
            mean=torch.zeros((dim,), dtype=dtype, device=device),
            m2=torch.zeros((dim,), dtype=dtype, device=device),
        )

    def to(self, device=None, dtype=None) -> "RunningStat":
        return RunningStat(*(torch.as_tensor(x).to(device=device, dtype=dtype) for x in self))

    @property
    def std(self):
        var = torch.where(self.count > 1, self.m2 / self.count.clamp_min(1), 0.0)
        return var.sqrt()

    def update_batch(self, obs) -> "RunningStat":
        """Merge a batch of observations (..., dim) flattened over leading dims."""
        flat = obs.reshape(-1, obs.shape[-1])
        n_b = torch.tensor(flat.shape[0], dtype=self.count.dtype, device=self.count.device)
        mean_b = flat.mean(0)
        m2_b = ((flat - mean_b) ** 2).sum(0)
        return self.merge(RunningStat(n_b, mean_b, m2_b))

    def merge(self, other: "RunningStat") -> "RunningStat":
        """Chan et al.'s parallel merge: associative, so statistics gathered
        apart combine in any grouping."""
        n = self.count + other.count
        safe_n = n.clamp_min(1)
        delta = other.mean - self.mean
        mean = self.mean + delta * (other.count / safe_n)
        m2 = self.m2 + other.m2 + delta**2 * (self.count * other.count / safe_n)
        return RunningStat(n, mean, m2)

    def scale(self, eps: float = 1e-7):
        """What :meth:`normalize` divides by: the std, with std <= eps read
        as 1."""
        std = self.std
        return torch.where(std > eps, std, 1.0)

    def normalize(self, obs, eps: float = 1e-7):
        """(obs - mean) / std, with std <= eps read as 1."""
        return (obs - self.mean) / self.scale(eps)
