"""Batched projected Gauss-Seidel for the contact MLCP.

:func:`solve_pgs` is the only PGS entry point of the port:

- on CUDA tensors it launches the hand-written kernel ``csrc/pgs.cu``,
  which replaces the TPU kernel ``tds_tpu/contact/pallas_pgs.py::_pgs_kernel``,
  for any number of rows n >= 1, in one of three forms by n (:data:`FORMS`):
  "row per lane" for n <= 32 (a group of lanes per env, row i on lane i,
  instances of N = 8, 12, 16, 24 and 32 rows, an n in between padded to
  the next), "blocked" above (one warp per env, the rows in blocks of 32,
  A's lower triangle staged in shared memory), and "streaming" where an
  env's staging does not fit a block (n > 335 in float32, > 236 in
  float64); through :class:`PGSFunction`, whose backward is the kernel's
  backward in the same file (``tds_pgs_backward_*``: "linearised", or
  "streaming" past n = 328 in float32 and 229 in float64), so gradients
  reach A, b, lo and hi on the card as ``jax.grad`` of the unrolled sweep
  gives them;
- on CPU tensors it runs :func:`solve_pgs_reference`, the plain version,
  which autograd differentiates;
- anything else raises. No switch sends a CUDA tensor to the plain version,
  in the forward or in the backward.

A second derivative through the kernel raises (``once_differentiable``),
and so do forward mode (forward AD's ``jvp``) and ``torch.func`` transforms
(``jacfwd``) with ``NotImplementedError``: they wait for ROADMAP Queue 1
item 5.

Ties follow the JAX package's subgradients: ``s = max(x_dep, 0)`` and the
clip ``min(max(x_i, lo s), hi s)`` give each side half at a tie, as
``jnp.maximum`` and ``jnp.clip`` do (``torch.clamp`` and ``clamp_min``
would pass the whole gradient to x).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at their first launch
(or by :func:`build`) into ``build/kernels/pgs-<hash>/`` through
:func:`tds_tpu_torch.utils.cuda_build.build`, and loaded with ctypes.
Importing this module builds nothing. :func:`launch_shape` reports a
kernel's form, lanes per env, envs per block and resident warps per SM on
the card for any n.

``launches`` counts the forward kernel's launches and ``backward_launches``
the backward kernel's; a caller may reset either to 0.
"""

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import torch

from torch.autograd.function import once_differentiable

from tds_tpu_torch.utils import cuda_build
from tds_tpu_torch.utils.tensors import constant

launches = 0
backward_launches = 0
# the kernels' forms, by the code tds_pgs_form returns
FORMS = ("row per lane", "blocked", "streaming", "linearised")
FORWARD_MODE = (
    "forward-mode differentiation and torch.func transforms through the PGS kernel on the card are not ported yet "
    "(ROADMAP Queue 1 item 5: forward mode through K1); use torch.autograd (reverse mode), or the plain version on "
    "CPU tensors"
)


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
            # jnp.maximum and jnp.clip's subgradients: half to each side of a tie
            s = torch.maximum(x[..., dep], torch.zeros_like(xi)) if dep >= 0 else torch.ones_like(xi)
            xi = torch.minimum(torch.maximum(xi, lo[..., i] * s), hi[..., i] * s)
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
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in (a_mat, b, lo, hi)):
        raise NotImplementedError(FORWARD_MODE)
    dep = tuple(int(d) for d in limit_dependency)
    _check_operands(a_mat, b, lo, hi, dep, int(iterations))
    return PGSFunction.apply(a_mat, b, lo, hi, dep, int(iterations))


class PGSFunction(torch.autograd.Function):
    """The kernel as an autograd function: the forward launches K1 and
    saves A, b, lo, hi and x; the backward launches K1's backward kernel
    (for ``iterations`` > 1 after relaunching the forward at 1 ..
    iterations - 1 sweeps, to recover x after each sweep). Takes checked
    operands (:func:`solve_pgs` checks them)."""

    @staticmethod
    def forward(a_mat, b, lo, hi, dep, iterations):
        return _launch(a_mat, b, lo, hi, dep, iterations)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a_mat, b, lo, hi, dep, iterations = inputs
        ctx.save_for_backward(a_mat, b, lo, hi, output)
        ctx.dep, ctx.iterations = dep, iterations

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar):
        a_mat, b, lo, hi, x = ctx.saved_tensors
        return (*_launch_backward(a_mat, b, lo, hi, ctx.dep, ctx.iterations, x, x_bar.contiguous()), None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(FORWARD_MODE)


def _check_operands(a_mat, b, lo, hi, dep, iterations):
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


def _launch(a_mat, b, lo, hi, dep, iterations):
    global launches
    bsz, n = b.shape
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


def _launch_backward(a_mat, b, lo, hi, dep, iterations, x, x_bar):
    """(A-bar, b-bar, lo-bar, hi-bar) for the adjoint ``x_bar`` of the
    forward's output ``x``: one launch of the backward kernel on the
    forward's operands and x after each sweep."""
    global backward_launches
    bsz, n = b.shape
    if x_bar.shape != x.shape or x_bar.dtype != x.dtype or x_bar.device != x.device:
        raise ValueError(f"x_bar is {tuple(x_bar.shape)} {x_bar.dtype} on {x_bar.device}, x {tuple(x.shape)} {x.dtype}")
    grads = (torch.empty_like(a_mat), torch.empty_like(b), torch.empty_like(lo), torch.empty_like(hi))
    if bsz == 0:
        return grads
    # x after sweeps 1 .. iterations: the forward recomputes the earlier
    # ones bit for bit (each launch starts from x = 0)
    xs = torch.stack([_launch(a_mat, b, lo, hi, dep, t) for t in range(1, iterations)] + [x]) if iterations else x[None]
    fn = _library().tds_pgs_backward_f32 if b.dtype == torch.float32 else _library().tds_pgs_backward_f64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = fn(
            a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(), xs.data_ptr(),
            x_bar.data_ptr(), *(g.data_ptr() for g in grads), bsz, n, iterations, stream,
        )
    if rc != 0:
        raise RuntimeError(f"PGS backward kernel launch failed with CUDA error {rc}")
    backward_launches += 1
    return grads


def form(dtype: torch.dtype, n: int, backward: bool = False) -> str:
    """The form of the kernel (with ``backward``, of its backward) that
    runs for n rows in ``dtype``: one of :data:`FORMS`."""
    if n < 1 or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no PGS kernel for n = {n} in {dtype}")
    return FORMS[_library().tds_pgs_form(int(dtype == torch.float64), n, int(backward))]


def launch_shape(dtype: torch.dtype, n: int, batch: int, device="cuda", backward: bool = False) -> dict:
    """How the kernel (with ``backward``, its backward) launches for n rows
    in ``dtype`` at ``batch`` envs on ``device``: its ``form`` and
    ``cuda_build.launch_shape``'s fields, resident warps per SM and waves
    among them."""
    name = form(dtype, n, backward)
    lib = _library()
    fn = lib.tds_pgs_backward_launch_shape if backward else lib.tds_pgs_launch_shape
    return {"form": name, **cuda_build.launch_shape(fn, (int(dtype == torch.float64), n), batch, device)}


def build() -> Path:
    """Compile ``csrc/pgs.cu`` unless a build of these sources exists;
    returns the shared library's path (``build.log`` beside it)."""
    return cuda_build.build("pgs.cu")


@functools.lru_cache(maxsize=None)
def _library():
    lib = bind(ctypes.CDLL(str(build())))
    lib.tds_pgs_form.argtypes = [ctypes.c_int] * 3
    lib.tds_pgs_form.restype = ctypes.c_int
    return lib


def bind(lib):
    """Declares the C functions that every library built from csrc/pgs.cu
    has (an earlier commit's too: ``tools/pgs_ab.py`` binds one)."""
    for fn in (lib.tds_pgs_solve_f32, lib.tds_pgs_solve_f64):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.tds_pgs_backward_f32, lib.tds_pgs_backward_f64):
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.tds_pgs_launch_shape, lib.tds_pgs_backward_launch_shape):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib
