"""Batched projected Gauss-Seidel for the contact MLCP.

:func:`solve_pgs` is the only PGS entry point of the port:

- on CUDA tensors it launches the hand-written kernel ``csrc/pgs.cu``,
  which replaces the TPU kernel ``tds_tpu/contact/pallas_pgs.py::_pgs_kernel``,
  for any number of rows n >= 1: a group of lanes per env, row i on lane
  i, for n <= 32 (instances of N = 8, 12, 16, 24 and 32 rows, an n in
  between padded to the next), one warp per env streaming A for n > 32;
- on CPU tensors it runs :func:`solve_pgs_reference`, the plain version;
- anything else raises. No switch sends a CUDA tensor to the plain version.

The kernel has no backward yet: on the card it raises when grad is enabled
and an operand requires grad (``utils.tensors.refuse_grad``), and runs
under ``torch.no_grad()``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first launch
(or by :func:`build`) into ``build/kernels/pgs-<hash>/`` through
:func:`tds_tpu_torch.utils.cuda_build.build`, and loaded with ctypes.
Importing this module builds nothing. :func:`launch_shape` reports the
kernel's lanes per env, envs per block and resident warps per SM on the
card for any n.

``launches`` counts the kernel launches; a caller may reset it to 0.
"""

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import torch

from tds_tpu_torch.utils import cuda_build
from tds_tpu_torch.utils.tensors import constant, refuse_grad

launches = 0


def solve_pgs_reference(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int):
    """Plain PyTorch PGS from x = 0 (a straight port of
    tds_tpu.contact.mlcp.solve_pgs): a_mat (..., n, n), b/lo/hi (..., n).
    ``limit_dependency[i] >= 0`` scales row i's bounds by max(x[dep], 0)."""
    n = len(limit_dependency)
    x = torch.zeros_like(b)
    for _ in range(iterations):
        for i in range(n):
            delta = (a_mat[..., i, :] * x).sum(-1) - a_mat[..., i, i] * x[..., i]
            xi = (b[..., i] - delta) / a_mat[..., i, i]
            dep = limit_dependency[i]
            s = x[..., dep].clamp_min(0.0) if dep >= 0 else torch.ones_like(xi)
            xi = torch.clamp(xi, lo[..., i] * s, hi[..., i] * s)
            x = x.clone()
            x[..., i] = xi
    return x


def solve_pgs(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int):
    """PGS on a batch: a_mat (B, n, n), b/lo/hi (B, n) -> x (B, n). The
    kernel on a CUDA device, the plain version on the CPU."""
    devices = {t.device for t in (a_mat, b, lo, hi)}
    if len(devices) != 1:
        raise ValueError(f"PGS operands lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return solve_pgs_reference(a_mat, b, lo, hi, limit_dependency, iterations)
    if device.type != "cuda":
        raise ValueError(f"no PGS implementation for device {device}")
    return _solve_pgs_cuda(a_mat, b, lo, hi, tuple(int(d) for d in limit_dependency), int(iterations))


def _solve_pgs_cuda(a_mat, b, lo, hi, dep, iterations):
    global launches
    if b.dim() != 2:
        raise ValueError(f"b must be (B, n), got {tuple(b.shape)}")
    bsz, n = b.shape
    if n < 1:
        raise ValueError("the PGS kernel needs at least one row")
    if len(dep) != n:
        raise ValueError(f"limit_dependency has {len(dep)} entries for {n} rows")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the PGS kernel takes float32 or float64, got {b.dtype}")
    for name, t, shape in (("a_mat", a_mat, (bsz, n, n)), ("lo", lo, (bsz, n)), ("hi", hi, (bsz, n)), ("b", b, (bsz, n))):
        if t.dtype != b.dtype:
            raise TypeError(f"{name} is {t.dtype}, b is {b.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    refuse_grad("PGS", (a_mat, b, lo, hi))
    x = torch.empty_like(b)
    if bsz == 0:
        return x
    fn = _library().tds_pgs_solve_f32 if b.dtype == torch.float32 else _library().tds_pgs_solve_f64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = fn(
            a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            dep_t.data_ptr(), x.data_ptr(), bsz, n, iterations, stream,
        )
    if rc != 0:
        raise RuntimeError(f"PGS kernel launch failed with CUDA error {rc}")
    launches += 1
    return x


def launch_shape(dtype: torch.dtype, n: int, batch: int, device="cuda") -> dict:
    """How the kernel launches for n rows in ``dtype`` at ``batch`` envs on
    ``device``: ``cuda_build.launch_shape``'s fields, resident warps per SM
    and waves among them."""
    if n < 1 or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no PGS kernel for n = {n} in {dtype}")
    return cuda_build.launch_shape(_library().tds_pgs_launch_shape, (int(dtype == torch.float64), n), batch, device)


def build() -> Path:
    """Compile ``csrc/pgs.cu`` unless a build of these sources exists;
    returns the shared library's path (``build.log`` beside it)."""
    return cuda_build.build("pgs.cu")


@functools.lru_cache(maxsize=None)
def _library():
    return bind(ctypes.CDLL(str(build())))


def bind(lib):
    """Declares the C functions of a library built from csrc/pgs.cu."""
    for fn in (lib.tds_pgs_solve_f32, lib.tds_pgs_solve_f64):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tds_pgs_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.tds_pgs_launch_shape.restype = ctypes.c_int
    return lib
