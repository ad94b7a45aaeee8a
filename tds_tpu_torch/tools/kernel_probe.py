"""The probe kernels K3 and K4, counterparts of the JAX package's
``tools/mosaic_probe.py``: a minor-dimension reshape with a sum,
``x.reshape(256, 4, 2).sum(-1)`` on (256, 8), and a minor-dimension
transpose, ``x.swapaxes(-1, -2)`` on (8, 128, 8).

:func:`reshape_sum` and :func:`transpose_minor` launch the hand-written
kernels of ``csrc/probes.cu`` on CUDA tensors and run their plain versions
on CPU tensors; anything else raises. ``launches`` counts each kernel's
launches; a caller may reset the counts to 0.

    python -m tds_tpu_torch.tools.kernel_probe

runs both kernels on the card at the probe shapes and exits 0 when both
match their plain versions exactly (1 otherwise), the exit-code contract of
``tools/mosaic_probe.py``. Importing this module builds nothing.
"""

import ctypes
import functools
import sys

import torch

from tds_tpu_torch.utils import cuda_build
from tds_tpu_torch.utils.tensors import resolve_device

PROBE_SHAPES = {"reshape_sum": (256, 8), "transpose_minor": (8, 128, 8)}

launches = {"reshape_sum": 0, "transpose_minor": 0}


def reshape_sum_reference(x):
    """(..., n) -> (..., n / 2): the sums of adjacent pairs."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2).sum(-1)


def transpose_minor_reference(x):
    """(..., r, c) -> (..., c, r), contiguous."""
    return x.transpose(-1, -2).contiguous()


def _uses_kernel(x, name) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} implementation for device {x.device}")
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes a contiguous tensor")
    return x.device.type == "cuda"


def reshape_sum(x):
    """Sums of adjacent pairs along the last axis: the kernel on a CUDA
    device, the plain version on the CPU."""
    if x.dim() < 1 or x.shape[-1] % 2:
        raise ValueError(f"reshape_sum needs an even last axis, got {tuple(x.shape)}")
    if not _uses_kernel(x, "reshape_sum"):
        return reshape_sum_reference(x)
    out = torch.empty(*x.shape[:-1], x.shape[-1] // 2, dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("reshape_sum", _library().tds_reshape_sum, x, x.data_ptr(), out.data_ptr(), out.numel())
    return out


def transpose_minor(x):
    """The two minor axes swapped, contiguous: the kernel on a CUDA device,
    the plain version on the CPU."""
    if x.dim() < 2:
        raise ValueError(f"transpose_minor needs two axes, got {tuple(x.shape)}")
    if not _uses_kernel(x, "transpose_minor"):
        return transpose_minor_reference(x)
    rows, cols = x.shape[-2:]
    out = torch.empty(*x.shape[:-2], cols, rows, dtype=x.dtype, device=x.device)
    if out.numel():
        batch = x.numel() // (rows * cols)
        _launch("transpose_minor", _library().tds_transpose_minor, x, x.data_ptr(), out.data_ptr(), batch, rows, cols)
    return out


def _launch(name, fn, x, *args):
    with torch.cuda.device(x.device):
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    launches[name] += 1


def build():
    """Compile ``csrc/probes.cu`` unless a build of these sources exists;
    returns the shared library's path (``build.log`` beside it)."""
    return cuda_build.build("probes.cu")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.tds_reshape_sum.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.tds_transpose_minor.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tds_reshape_sum.restype = lib.tds_transpose_minor.restype = ctypes.c_int
    return lib


PROBES = {
    "reshape_sum": (reshape_sum, reshape_sum_reference),
    "transpose_minor": (transpose_minor, transpose_minor_reference),
}


def run_probes(device=None, seed=0):
    """Each probe on seeded normal float32 input at its probe shape;
    returns {name: max |kernel - plain|}."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    errors = {}
    for name, (fn, plain) in PROBES.items():
        x = torch.randn(PROBE_SHAPES[name], generator=gen, device=device)
        got, expected = fn(x), plain(x)
        if got.shape != expected.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected {tuple(expected.shape)}")
        errors[name] = (got - expected).abs().max().item()
    return errors


def main():
    errors = run_probes()
    for name, err in errors.items():
        print(f"{name}: {'PASS' if err == 0 else f'FAIL (max |kernel - plain| = {err:.3e})'}")
    sys.exit(0 if all(err == 0 for err in errors.values()) else 1)


if __name__ == "__main__":
    main()
