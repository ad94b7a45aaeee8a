"""Device selection, cached constant tensors, and a hand-written kernel's
refusal of gradients it cannot carry."""

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


def refuse_grad(kernel: str, tensors) -> None:
    """Raise when autograd would record a graph through ``kernel``: grad is
    enabled and one of ``tensors`` requires grad. K2 writes its outputs
    through raw pointers and has no backward yet (ROADMAP Queue 1 item 5),
    so its results would carry no gradient; under ``torch.no_grad()`` it
    runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward yet (ROADMAP Queue 1 item 5) and would drop the gradient of its "
            "operands: call it under torch.no_grad(), or differentiate its plain version on CPU tensors"
        )
