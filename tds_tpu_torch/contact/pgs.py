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
  backward in the same file (``tds_pgs_backward_*``: "linearised" for one
  sweep, from x = 0 or a warm start; for two sweeps or more "linearised
  sweeps", with A's part above the diagonal streamed from L2 or, where
  that keeps as many envs resident, "linearised sweeps, A whole" in shared
  memory; "streaming" past the staged forms' limits, n = 328 in float32
  and 229 in float64 for one sweep), so gradients reach A, b, lo and hi
  on the card as ``jax.grad`` of the unrolled sweep gives them;
- on CPU tensors it runs :func:`solve_pgs_reference`, the plain version,
  which autograd differentiates;
- anything else raises. No switch sends a CUDA tensor to the plain version,
  in the forward or in the backward.

A warm start ``x0`` (B, n) (:func:`solve_pgs`'s keyword; the JAX
package's ``mlcp.solve_pgs`` always takes one) reaches the kernels
themselves: each of K1's forms, its backward and its JVP has instances
that start the sweeps from x0 (``tds_pgs_*_warm_*``), so that the gradient
and the tangent reach x0 too. ``x0=None`` launches the zero start's
instances, which are as they were.

Forward mode runs through the kernel's JVP in the same file
(``tds_pgs_jvp_*``: x and its tangent computed sweep by sweep, in the
forward's three forms, "linearised": each sweep's primal chain fixes the
clip's factors, A' enters off the chain, and the tangent chain is linear):
``PGSFunction.jvp`` launches it, for
forward AD (``torch.autograd.forward_ad``) and ``torch.func.jvp``. Its
``vmap`` rule folds a vmapped dimension into the batch B (K1 is batched
over B already, so ``vmap`` of K1 is K1 on T B rows), and so do the rules
of the JVP's and the backward's own functions; so ``torch.func.jacfwd``
(a vmap of jvp), ``torch.func.jacrev`` and ``torch.func.vmap`` launch the
kernels on the card too. A second derivative (reverse over reverse, or a
derivative of the JVP) raises.

Ties follow the JAX package's subgradients: ``s = max(x_dep, 0)`` and the
clip ``min(max(x_i, lo s), hi s)`` give each side half at a tie, as
``jnp.maximum`` and ``jnp.clip`` do (``torch.clamp`` and ``clamp_min``
would pass the whole gradient to x).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at their first launch
(or by :func:`build`) into ``build/kernels/pgs-<hash>/`` through
:func:`tds_tpu_torch.utils.cuda_build.build`, and loaded with ctypes.
Importing this module builds nothing. :func:`launch_shape` reports a
kernel's form, lanes per env, envs per block and resident warps per SM on
the card for any n, start and sweep count.

``launches`` counts the forward kernel's launches, ``backward_launches``
the backward kernel's and ``jvp_launches`` the forward mode's, from the
zero start; ``warm_launches``, ``warm_backward_launches`` and
``warm_jvp_launches`` count the warm-start instances' launches; a caller
may reset any of them to 0.
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
jvp_launches = 0
warm_launches = 0
warm_backward_launches = 0
warm_jvp_launches = 0
# the kernels' forms, by the code tds_pgs_instance_form returns
FORMS = ("row per lane", "blocked", "streaming", "linearised", "linearised sweeps", "linearised sweeps, A whole")
# the kernels tds_pgs_instance_form and launch_shape name: K1, its backward, its JVP
_WHICH = {"forward": 0, "backward": 1, "jvp": 2}


def solve_pgs_reference(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int, x0=None):
    """Plain PyTorch PGS from x = 0, or from ``x0`` (a straight port of
    tds_tpu.contact.mlcp.solve_pgs): a_mat (..., n, n), b/lo/hi/x0 (..., n).
    ``limit_dependency[i] >= 0`` scales row i's bounds by max(x[dep], 0)."""
    n = len(limit_dependency)
    x = torch.zeros_like(b) if x0 is None else x0
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


def solve_pgs(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int, x0=None):
    """PGS on a batch: a_mat (B, n, n), b/lo/hi (B, n) -> x (B, n), from
    x = 0 or from the warm start ``x0`` (B, n). The kernel on a CUDA
    device, the plain version on the CPU."""
    operands = (a_mat, b, lo, hi) if x0 is None else (a_mat, b, lo, hi, x0)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"PGS operands lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return solve_pgs_reference(a_mat, b, lo, hi, limit_dependency, iterations, x0)
    if device.type != "cuda":
        raise ValueError(f"no PGS implementation for device {device}")
    dep = tuple(int(d) for d in limit_dependency)
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in operands):
        # under a torch.func transform: the rules below see the plain tensors
        a_mat, b, lo, hi = (t.contiguous() for t in (a_mat, b, lo, hi))
        x0 = None if x0 is None else x0.contiguous()
    _check_operands(a_mat, b, lo, hi, dep, int(iterations), x0)
    return PGSFunction.apply(a_mat, b, lo, hi, dep, int(iterations), x0)


def _fold(info, in_dims, tensors):
    """A vmap rule's operands with the vmapped dimension folded into the
    batch: each (T, B, ...) with T = ``info.batch_size`` (an unbatched
    operand expanded to it) as a contiguous (T B, ...); an absent operand
    (no warm start) stays None."""
    size = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        if t is None:
            out.append(None)
            continue
        t = t.expand(size, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(size * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold(t, size):
    return t.reshape(size, -1, *t.shape[1:])


class PGSFunction(torch.autograd.Function):
    """The kernel as an autograd function: the forward launches K1 (from
    the warm start x0 when it is given, else from 0) and saves A, b, lo,
    hi, x0 and x; the backward launches K1's backward kernel (for
    ``iterations`` > 1 after relaunching the forward at 1 .. iterations - 1
    sweeps from the same start, to recover x after each sweep), which with
    x0 also gives x0-bar; the JVP launches K1's forward-mode kernel on the
    saved operands and the tangents (zeros for an operand without one); the
    vmap rule folds the vmapped dimension into B. Takes checked operands
    (:func:`solve_pgs` checks them); x0 is the last argument and may be
    left out."""

    @staticmethod
    def forward(a_mat, b, lo, hi, dep, iterations, x0=None):
        return _launch(a_mat, b, lo, hi, dep, iterations, x0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a_mat, b, lo, hi, dep, iterations, *warm = inputs
        x0 = warm[0] if warm else None
        ctx.save_for_backward(a_mat, b, lo, hi, x0, output)
        ctx.save_for_forward(a_mat, b, lo, hi, x0)
        ctx.dep, ctx.iterations, ctx.inputs = dep, iterations, len(inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar):
        a_mat, b, lo, hi, x0, x = ctx.saved_tensors
        grads = PGSBackward.apply(a_mat, b, lo, hi, ctx.dep, ctx.iterations, x, x_bar.contiguous(), x0)
        return (*grads[:4], None, None, grads[4] if x0 is not None else None)[: ctx.inputs]

    @staticmethod
    def jvp(ctx, a_dot, b_dot, lo_dot, hi_dot, _dep, _iterations, x0_dot=None):
        operands = ctx.saved_tensors[:5]
        dots = [None if p is None else torch.zeros_like(p) if d is None else d.contiguous()
                for p, d in zip(operands, (a_dot, b_dot, lo_dot, hi_dot, x0_dot))]
        return PGSJVP.apply(*operands[:4], *dots[:4], ctx.dep, ctx.iterations, operands[4], dots[4])[1]

    @staticmethod
    def vmap(info, in_dims, a_mat, b, lo, hi, dep, iterations, x0=None):
        operands = _fold(info, in_dims[:4] + (in_dims[6] if len(in_dims) > 6 else None,), (a_mat, b, lo, hi, x0))
        x = PGSFunction.apply(*operands[:4], dep, iterations, operands[4])
        return _unfold(x, info.batch_size), 0


class PGSJVP(torch.autograd.Function):
    """K1's forward mode: (x, x_dot) from the operands and their tangents,
    and from a warm start x0 and its tangent when they are given (the last
    two arguments), one launch of the JVP kernel; the vmap rule folds the
    vmapped dimension into B (``torch.func.jacfwd`` vmaps the tangents)."""

    @staticmethod
    def forward(a_mat, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, iterations, x0=None, x0_dot=None):
        return _launch_jvp(a_mat, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, iterations, x0, x0_dot)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        tensors = _fold(info, in_dims[:8] + in_dims[10:], args[:8] + args[10:])
        x, x_dot = PGSJVP.apply(*tensors[:8], *args[8:10], *tensors[8:])
        return (_unfold(x, info.batch_size), _unfold(x_dot, info.batch_size)), (0, 0)


class PGSBackward(torch.autograd.Function):
    """K1's backward: (A-bar, b-bar, lo-bar, hi-bar), and x0-bar after them
    when a warm start x0 is given (the last argument), from the forward's
    operands, its x and x-bar, one launch of the backward kernel; the vmap
    rule folds the vmapped dimension into B (``torch.func.jacrev`` vmaps
    the cotangents)."""

    @staticmethod
    def forward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0=None):
        return _launch_backward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        tensors = _fold(info, in_dims[:4] + in_dims[6:], args[:4] + args[6:])
        grads = PGSBackward.apply(*tensors[:4], *args[4:6], *tensors[4:])
        return tuple(_unfold(g, info.batch_size) for g in grads), (0,) * len(grads)


def _check_operands(a_mat, b, lo, hi, dep, iterations, x0=None):
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
    checked = (("a_mat", a_mat, (bsz, n, n)), ("lo", lo, (bsz, n)), ("hi", hi, (bsz, n)), ("b", b, (bsz, n)))
    for name, t, shape in checked + ((("x0", x0, (bsz, n)),) if x0 is not None else ()):
        if t.dtype != b.dtype:
            raise TypeError(f"{name} is {t.dtype}, b is {b.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(a_mat, b, lo, hi, dep, iterations, x0=None):
    """x after ``iterations`` sweeps: one launch of K1, of its zero start's
    instances, or of its warm-start instances from ``x0``."""
    global launches, warm_launches
    bsz, n = b.shape
    x = torch.empty_like(b)
    if bsz == 0:
        return x
    f64 = b.dtype == torch.float64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if x0 is None:
            fn = _library().tds_pgs_solve_f64 if f64 else _library().tds_pgs_solve_f32
            rc = fn(
                a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                dep_t.data_ptr(), x.data_ptr(), bsz, n, iterations, stream,
            )
        else:
            fn = _library().tds_pgs_solve_warm_f64 if f64 else _library().tds_pgs_solve_warm_f32
            rc = fn(
                a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(),
                x0.data_ptr(), x.data_ptr(), bsz, n, iterations, stream,
            )
    if rc != 0:
        raise RuntimeError(f"PGS kernel launch failed with CUDA error {rc}")
    if x0 is None:
        launches += 1
    else:
        warm_launches += 1
    return x


def _launch_backward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0=None):
    """(A-bar, b-bar, lo-bar, hi-bar), and x0-bar after them from a warm
    start ``x0``, for the adjoint ``x_bar`` of the forward's output ``x``:
    one launch of the backward kernel on the forward's operands and x after
    each sweep."""
    global backward_launches, warm_backward_launches
    bsz, n = b.shape
    if x_bar.shape != x.shape or x_bar.dtype != x.dtype or x_bar.device != x.device:
        raise ValueError(f"x_bar is {tuple(x_bar.shape)} {x_bar.dtype} on {x_bar.device}, x {tuple(x.shape)} {x.dtype}")
    grads = (torch.empty_like(a_mat), torch.empty_like(b), torch.empty_like(lo), torch.empty_like(hi))
    if x0 is not None:
        grads += (torch.empty_like(x0),)
    if bsz == 0:
        return grads
    # x after sweeps 1 .. iterations: the forward recomputes the earlier
    # ones bit for bit (each launch starts from x = 0, or from x0)
    xs = torch.stack([_launch(a_mat, b, lo, hi, dep, t, x0) for t in range(1, iterations)] + [x]) if iterations else x[None]
    f64 = b.dtype == torch.float64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        operands = (a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(), xs.data_ptr(),
                    x_bar.data_ptr())
        if x0 is None:
            fn = _library().tds_pgs_backward_f64 if f64 else _library().tds_pgs_backward_f32
            rc = fn(*operands, *(g.data_ptr() for g in grads), bsz, n, iterations, stream)
        else:
            fn = _library().tds_pgs_backward_warm_f64 if f64 else _library().tds_pgs_backward_warm_f32
            rc = fn(*operands, x0.data_ptr(), *(g.data_ptr() for g in grads), bsz, n, iterations, stream)
    if rc != 0:
        raise RuntimeError(f"PGS backward kernel launch failed with CUDA error {rc}")
    if x0 is None:
        backward_launches += 1
    else:
        warm_backward_launches += 1
    return grads


def _launch_jvp(a_mat, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, iterations, x0=None, x0_dot=None):
    """(x, x_dot): one launch of the forward-mode kernel on the operands
    and their tangents (each of its operand's shape, dtype and device),
    from x = 0 and x' = 0, or from the warm start ``x0`` and its tangent
    ``x0_dot``."""
    global jvp_launches, warm_jvp_launches
    bsz, n = b.shape
    rows = 4 if x0 is None else 5
    pairs = zip(("a_dot", "b_dot", "lo_dot", "hi_dot", "x0_dot")[:rows], (a_dot, b_dot, lo_dot, hi_dot, x0_dot),
                (a_mat, b, lo, hi, x0))
    for name, t, p in pairs:
        if t.shape != p.shape or t.dtype != p.dtype or t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, its operand {tuple(p.shape)} {p.dtype}")
    x, x_dot = torch.empty_like(b), torch.empty_like(b)
    if bsz == 0:
        return x, x_dot
    f64 = b.dtype == torch.float64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if x0 is None:
            fn = _library().tds_pgs_jvp_f64 if f64 else _library().tds_pgs_jvp_f32
            rc = fn(
                *(t.data_ptr() for t in (a_mat, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot)), dep_t.data_ptr(),
                x.data_ptr(), x_dot.data_ptr(), bsz, n, iterations, stream,
            )
        else:
            fn = _library().tds_pgs_jvp_warm_f64 if f64 else _library().tds_pgs_jvp_warm_f32
            rc = fn(
                *(t.data_ptr() for t in (a_mat, b, lo, hi, x0, a_dot, b_dot, lo_dot, hi_dot, x0_dot)),
                dep_t.data_ptr(), x.data_ptr(), x_dot.data_ptr(), bsz, n, iterations, stream,
            )
    if rc != 0:
        raise RuntimeError(f"PGS forward-mode kernel launch failed with CUDA error {rc}")
    if x0 is None:
        jvp_launches += 1
    else:
        warm_jvp_launches += 1
    return x, x_dot


def solve_pgs_jvp_reference(a_mat, b, lo, hi, tangents, limit_dependency: Sequence[int], iterations: int, x0=None):
    """The plain version of K1's forward mode: (x, x_dot), ``torch.func.jvp``
    of :func:`solve_pgs_reference` for ``tangents`` = (A', b', lo', hi'),
    and x0' after them with a warm start ``x0``."""
    if x0 is None:
        return torch.func.jvp(
            lambda *t: solve_pgs_reference(*t, limit_dependency, iterations), (a_mat, b, lo, hi), tuple(tangents)
        )
    return torch.func.jvp(
        lambda a, b, lo, hi, x0: solve_pgs_reference(a, b, lo, hi, limit_dependency, iterations, x0),
        (a_mat, b, lo, hi, x0), tuple(tangents),
    )


def form(dtype: torch.dtype, n: int, backward: bool = False, jvp: bool = False, warm: bool = False,
         iterations: int = 1) -> str:
    """The form of the kernel (with ``backward``, of its backward; with
    ``jvp``, of its forward mode) that runs for n rows in ``dtype``, from a
    warm start with ``warm``, at ``iterations`` sweeps: one of
    :data:`FORMS`."""
    if n < 1 or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no PGS kernel for n = {n} in {dtype}")
    f64, which = int(dtype == torch.float64), _WHICH[_which(backward, jvp)]
    return FORMS[_library().tds_pgs_instance_form(f64, n, which, int(warm), iterations)]


def launch_shape(dtype: torch.dtype, n: int, batch: int, device="cuda", backward: bool = False, jvp: bool = False,
                 warm: bool = False, iterations: int = 1) -> dict:
    """How the kernel (with ``backward``, its backward; with ``jvp``, its
    forward mode) launches for n rows in ``dtype`` at ``batch`` envs on
    ``device``, from a warm start with ``warm``, at ``iterations`` sweeps
    (the forward from x = 0 has instances for one sweep and for more, the
    backward likewise): its ``form`` and ``cuda_build.launch_shape``'s
    fields, resident warps per SM and waves among them."""
    name = form(dtype, n, backward, jvp, warm, iterations)
    args = (int(dtype == torch.float64), n, _WHICH[_which(backward, jvp)], int(warm), iterations)
    return {"form": name, **cuda_build.launch_shape(_library().tds_pgs_instance_launch_shape, args, batch, device)}


def _which(backward: bool, jvp: bool) -> str:
    if backward and jvp:
        raise ValueError("backward and jvp name different kernels")
    return "backward" if backward else "jvp" if jvp else "forward"


def build() -> Path:
    """Compile ``csrc/pgs.cu`` unless a build of these sources exists;
    returns the shared library's path (``build.log`` beside it)."""
    return cuda_build.build("pgs.cu")


@functools.lru_cache(maxsize=None)
def _library():
    lib = bind(ctypes.CDLL(str(build())))
    lib.tds_pgs_instance_form.argtypes = [ctypes.c_int] * 5
    lib.tds_pgs_instance_form.restype = ctypes.c_int
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
    if hasattr(lib, "tds_pgs_jvp_f32"):  # an earlier commit's library may have no forward mode
        for fn in (lib.tds_pgs_jvp_f32, lib.tds_pgs_jvp_f64):
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    if hasattr(lib, "tds_pgs_solve_warm_f32"):  # nor a warm start
        for fns, pointers in (((lib.tds_pgs_solve_warm_f32, lib.tds_pgs_solve_warm_f64), 7),
                              ((lib.tds_pgs_backward_warm_f32, lib.tds_pgs_backward_warm_f64), 13),
                              ((lib.tds_pgs_jvp_warm_f32, lib.tds_pgs_jvp_warm_f64), 13)):
            for fn in fns:
                fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
    if hasattr(lib, "tds_pgs_instance_launch_shape"):  # nor each instance's launch shape
        lib.tds_pgs_instance_launch_shape.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.tds_pgs_instance_launch_shape.restype = ctypes.c_int
    return lib
