"""Numerical-health guards (counterpart of tds_tpu/utils/debug.py).

- :func:`activate_nan_trap`: every floating output of every operation is
  checked, and the first that holds a NaN raises (a ``TorchDispatchMode``,
  the counterpart of ``jax_debug_nans``; debug runs only: each check
  waits for the device);
- :func:`check_finite`: raises on a non-finite tensor. A CUDA graph's
  capture cannot run a host check, so there it raises at capture: check
  the scan's result instead, or guard with :func:`where_finite`;
- :func:`where_finite`: replaces non-finite entries;
- :func:`assert_finite_tree`: a sweep of a nested structure's floating
  tensors, naming the non-finite ones.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten_with_path, keystr, tree_leaves


class NanTrap(TorchDispatchMode):
    """Raises FloatingPointError at the first operation whose floating
    output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


_trap = None


def activate_nan_trap(enable: bool = True):
    """Raise on the first NaN any operation produces (``enable=False`` turns
    the trap off again)."""
    global _trap
    if enable and _trap is None:
        _trap = NanTrap()
        _trap.__enter__()
    elif not enable and _trap is not None:
        _trap.__exit__(None, None, None)
        _trap = None


def check_finite(x, name: str = "value"):
    """``x``, after checking that every entry is finite (FloatingPointError
    otherwise). Inside a CUDA graph's capture the check cannot run and
    raises RuntimeError at capture rather than pass unchecked."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"check_finite({name!r}) inside a CUDA graph capture cannot read the device: check the scan's result "
            "after it returns, or guard the value with where_finite"
        )
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite {name} detected")
    return x


def where_finite(x, fallback=0.0):
    """Non-finite entries replaced by ``fallback``."""
    return torch.where(torch.isfinite(x), x, fallback)


def assert_finite_tree(tree, name: str = "pytree"):
    """Raises FloatingPointError naming every floating tensor of ``tree``
    (nested tuples, lists, dicts, NamedTuples) that holds a NaN or an Inf."""
    bad = []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            bad.append(keystr(path))
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")
