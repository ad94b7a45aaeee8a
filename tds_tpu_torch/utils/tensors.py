"""Device selection and cached constant tensors."""

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for and there is none; nothing
    carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tds_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of static values (a tuple, possibly nested), built once per
    (values, dtype, device). Building it anew inside a step would copy from
    the host and synchronise the stream on every call. Never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
