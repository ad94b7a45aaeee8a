"""Running observation statistics (counterpart of
tds_tpu/learn/running_stat.py): the normalisation a trained policy reads.
The Welford updates that training needs come with the ARS slice."""

from typing import NamedTuple

import torch


class RunningStat(NamedTuple):
    count: torch.Tensor  # ()
    mean: torch.Tensor  # (dim,)
    m2: torch.Tensor  # (dim,)

    def to(self, device=None, dtype=None) -> "RunningStat":
        return RunningStat(*(torch.as_tensor(x).to(device=device, dtype=dtype) for x in self))

    @property
    def std(self):
        var = torch.where(self.count > 1, self.m2 / self.count.clamp_min(1), 0.0)
        return var.sqrt()

    def normalize(self, obs, eps: float = 1e-7):
        """(obs - mean) / std, with std <= eps read as 1."""
        std = self.std
        safe = torch.where(std > eps, std, 1.0)
        return (obs - self.mean) / safe
