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
  on the card as ``jax.grad`` of the unrolled sweep gives them. Past one
  sweep the backward reads x after each sweep as the forward computed it:
  when a backward can follow (:func:`saves_sweeps`) the forward's launch
  also stores x after each sweep but the last (``tds_pgs_solve_saving_*``),
  so that a gradient costs one forward launch and one backward launch;
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

``launches`` counts the forward kernel's launches (saving its sweeps or
not), ``backward_launches`` the backward kernel's and ``jvp_launches`` the
forward mode's, from the zero start; ``warm_launches``, ``warm_backward_launches`` and
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
# the kernels tds_pgs_instance_form and launch_shape name: K1, its backward,
# its JVP, K1 saving its sweeps for the backward
_WHICH = {"forward": 0, "backward": 1, "jvp": 2, "saving": 3}


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


def solve_pgs_sweeps_reference(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int, x0=None):
    """The plain version of K1's saving forward: x after each of the
    ``iterations`` sweeps, (iterations, ..., n), the last what
    :func:`solve_pgs_reference` returns; the kernel returns that one as x
    and the others as its saved sweeps."""
    sweeps, x = [], x0
    for _ in range(iterations):
        x = solve_pgs_reference(a_mat, b, lo, hi, limit_dependency, 1, x)
        sweeps.append(x)
    return torch.stack(sweeps) if sweeps else b.new_zeros((0,) + tuple(b.shape))


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
    return _solve_kernel(a_mat, b, lo, hi, limit_dependency, iterations, x0)


def _solve_kernel(a_mat, b, lo, hi, limit_dependency: Sequence[int], iterations: int, x0=None):
    """:func:`solve_pgs`'s card path: :class:`PGSFunction`, its forward
    saving its sweeps when a backward can follow (:func:`saves_sweeps`)."""
    dep = tuple(int(d) for d in limit_dependency)
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in (a_mat, b, lo, hi, x0) if t is not None):
        # under a torch.func transform: the rules below see the plain tensors
        a_mat, b, lo, hi = (t.contiguous() for t in (a_mat, b, lo, hi))
        x0 = None if x0 is None else x0.contiguous()
    _check_operands(a_mat, b, lo, hi, dep, int(iterations), x0)
    save = saves_sweeps((a_mat, b, lo, hi, x0), int(iterations))
    out = PGSFunction.apply(a_mat, b, lo, hi, dep, int(iterations), x0, save)
    return out[0] if save else out


def saves_sweeps(operands, iterations: int) -> bool:
    """Whether K1's forward on ``operands`` (A, b, lo, hi and x0 or None)
    saves x after each sweep for its backward: past one sweep, when a
    backward can follow, that is when grad is enabled and an operand
    requires grad or is wrapped by a ``torch.func`` transform that
    differentiates in reverse (``grad``, ``vjp``, ``jacrev``). Under
    ``torch.no_grad()``, with operands without grad, and under
    ``torch.func.jvp``, ``jacfwd`` or ``vmap`` alone it does not."""
    tensors = [t for t in operands if t is not None]
    if iterations < 2 or not torch.is_grad_enabled():
        return False
    if any(t.requires_grad for t in tensors):
        return True
    if not any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors):
        return False
    from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

    grad = torch._C._functorch.TransformType.Grad
    return any(i.key() == grad for i in retrieve_all_functorch_interpreters())


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


def _fold_sweeps(info, in_dim, xs):
    """A vmap rule's saved sweeps (iterations - 1, B, n) with the vmapped
    dimension folded into B, as :func:`_fold` folds the operands: a
    contiguous (iterations - 1, T B, n); None stays None."""
    if xs is None:
        return None
    size = info.batch_size
    xs = xs.unsqueeze(1).expand(xs.shape[0], size, *xs.shape[1:]) if in_dim is None else xs.movedim(in_dim, 1)
    return xs.reshape(xs.shape[0], size * xs.shape[2], *xs.shape[3:]).contiguous()


class PGSFunction(torch.autograd.Function):
    """The kernel as an autograd function: the forward launches K1 (from
    the warm start x0 when it is given, else from 0) and saves A, b, lo,
    hi, x0 and x; with ``save`` (:func:`saves_sweeps`) the same launch also
    stores x after each sweep but the last, returned after x as a tensor
    without gradient (iterations - 1, B, n) and saved beside it. The
    backward launches K1's backward kernel on those sweeps (one launch, no
    forward relaunched), which with x0 also gives x0-bar; the JVP launches
    K1's forward-mode kernel on the saved operands and the tangents (zeros
    for an operand without one); the vmap rule folds the vmapped dimension
    into B (into the sweeps' second). Takes checked operands
    (:func:`solve_pgs` checks them); x0 and ``save`` are the last arguments
    and may be left out."""

    @staticmethod
    def forward(a_mat, b, lo, hi, dep, iterations, x0=None, save=False):
        return _launch(a_mat, b, lo, hi, dep, iterations, x0, save=save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a_mat, b, lo, hi, dep, iterations, *rest = inputs
        x0 = rest[0] if rest else None
        ctx.save = len(rest) > 1 and bool(rest[1])
        x, xs = output if ctx.save else (output, None)
        if ctx.save:
            ctx.mark_non_differentiable(xs)
            ctx.set_materialize_grads(False)  # the sweeps' gradient is never used: no zeros of their size
        ctx.save_for_backward(a_mat, b, lo, hi, x0, x, xs)
        ctx.save_for_forward(a_mat, b, lo, hi, x0)
        ctx.dep, ctx.iterations, ctx.inputs = dep, iterations, len(inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, x_bar, *_):
        a_mat, b, lo, hi, x0, x, xs = ctx.saved_tensors
        grads = PGSBackward.apply(a_mat, b, lo, hi, ctx.dep, ctx.iterations, x, x_bar.contiguous(), x0, xs)
        return (*grads[:4], None, None, grads[4] if x0 is not None else None, None)[: ctx.inputs]

    @staticmethod
    def jvp(ctx, a_dot, b_dot, lo_dot, hi_dot, _dep, _iterations, x0_dot=None, _save=None):
        operands = ctx.saved_tensors[:5]
        dots = [None if p is None else torch.zeros_like(p) if d is None else d.contiguous()
                for p, d in zip(operands, (a_dot, b_dot, lo_dot, hi_dot, x0_dot))]
        x_dot = PGSJVP.apply(*operands[:4], *dots[:4], ctx.dep, ctx.iterations, operands[4], dots[4])[1]
        return (x_dot, None) if ctx.save else x_dot

    @staticmethod
    def vmap(info, in_dims, a_mat, b, lo, hi, dep, iterations, x0=None, save=False):
        operands = _fold(info, in_dims[:4] + (in_dims[6] if len(in_dims) > 6 else None,), (a_mat, b, lo, hi, x0))
        out = PGSFunction.apply(*operands[:4], dep, iterations, operands[4], save)
        if not save:
            return _unfold(out, info.batch_size), 0
        x, xs = out
        return (_unfold(x, info.batch_size), xs.reshape(xs.shape[0], info.batch_size, -1, *xs.shape[2:])), (0, 1)


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
    when a warm start x0 is given, from the forward's operands, its x, its
    saved sweeps xs (past one sweep) and x-bar, one launch of the backward
    kernel; the vmap rule folds the vmapped dimension into B (into the
    sweeps' second; ``torch.func.jacrev`` vmaps the cotangents)."""

    @staticmethod
    def forward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0=None, xs=None):
        return _launch_backward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0, xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, a_mat, b, lo, hi, dep, iterations, x, x_bar, x0=None, xs=None):
        dims = tuple(in_dims) + (None,) * (10 - len(in_dims))
        tensors = _fold(info, dims[:4] + dims[6:9], (a_mat, b, lo, hi, x, x_bar, x0))
        grads = PGSBackward.apply(*tensors[:4], dep, iterations, *tensors[4:], _fold_sweeps(info, dims[9], xs))
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


def _launch(a_mat, b, lo, hi, dep, iterations, x0=None, save=False):
    """x after ``iterations`` sweeps: one launch of K1, of its zero start's
    instances, or of its warm-start instances from ``x0``. With ``save``,
    (x, xs): the same launch also stores xs (iterations - 1, B, n), x after
    each sweep but the last, the backward's saved state."""
    global launches, warm_launches
    bsz, n = b.shape
    x = torch.empty_like(b)
    xs = b.new_empty((max(iterations - 1, 0), bsz, n)) if save else None
    if bsz == 0:
        return (x, xs) if save else x
    f64 = b.dtype == torch.float64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if save:
            fn = _library().tds_pgs_solve_saving_f64 if f64 else _library().tds_pgs_solve_saving_f32
            rc = fn(
                a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(),
                None if x0 is None else x0.data_ptr(), x.data_ptr(), xs.data_ptr() if xs.numel() else None,
                bsz, n, iterations, stream,
            )
        elif x0 is None:
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
    return (x, xs) if save else x


def _launch_backward(a_mat, b, lo, hi, dep, iterations, x, x_bar, x0=None, xs=None):
    """(A-bar, b-bar, lo-bar, hi-bar), and x0-bar after them from a warm
    start ``x0``, for the adjoint ``x_bar`` of the forward's output ``x``:
    one launch of the backward kernel on the forward's operands and x after
    each sweep, the forward's own: ``xs`` (iterations - 1, B, n), what the
    forward saved (``_launch(..., save=True)``), and x. Raises past one
    sweep without them (no forward is relaunched)."""
    global backward_launches, warm_backward_launches
    bsz, n = b.shape
    if x_bar.shape != x.shape or x_bar.dtype != x.dtype or x_bar.device != x.device:
        raise ValueError(f"x_bar is {tuple(x_bar.shape)} {x_bar.dtype} on {x_bar.device}, x {tuple(x.shape)} {x.dtype}")
    if iterations > 1 and (xs is None or tuple(xs.shape) != (iterations - 1, bsz, n) or xs.dtype != x.dtype
                           or xs.device != x.device or not xs.is_contiguous()):
        got = None if xs is None else (tuple(xs.shape), xs.dtype, str(xs.device))
        raise ValueError(f"the backward through {iterations} sweeps takes the forward's saved sweeps, contiguous "
                         f"({iterations - 1}, {bsz}, {n}) {x.dtype} on {x.device}; got {got}")
    grads = (torch.empty_like(a_mat), torch.empty_like(b), torch.empty_like(lo), torch.empty_like(hi))
    if x0 is not None:
        grads += (torch.empty_like(x0),)
    if bsz == 0:
        return grads
    f64 = b.dtype == torch.float64
    dep_t = constant(dep, torch.int32, b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        saved = xs.data_ptr() if iterations > 1 else None
        operands = (a_mat.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(), saved,
                    x.data_ptr(), x_bar.data_ptr())
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
         iterations: int = 1, saving: bool = False) -> str:
    """The form of the kernel (with ``backward``, of its backward; with
    ``jvp``, of its forward mode; with ``saving``, of the forward that
    saves its sweeps for the backward) that runs for n rows in ``dtype``,
    from a warm start with ``warm``, at ``iterations`` sweeps: one of
    :data:`FORMS`."""
    if n < 1 or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no PGS kernel for n = {n} in {dtype}")
    f64, which = int(dtype == torch.float64), _WHICH[_which(backward, jvp, saving)]
    return FORMS[_library().tds_pgs_instance_form(f64, n, which, int(warm), iterations)]


def launch_shape(dtype: torch.dtype, n: int, batch: int, device="cuda", backward: bool = False, jvp: bool = False,
                 warm: bool = False, iterations: int = 1, saving: bool = False) -> dict:
    """How the kernel (with ``backward``, its backward; with ``jvp``, its
    forward mode; with ``saving``, the forward that saves its sweeps)
    launches for n rows in ``dtype`` at ``batch`` envs on ``device``, from
    a warm start with ``warm``, at ``iterations`` sweeps (the forward from
    x = 0 has instances for one sweep and for more, the backward likewise):
    its ``form`` and ``cuda_build.launch_shape``'s fields, resident warps
    per SM and waves among them."""
    name = form(dtype, n, backward, jvp, warm, iterations, saving)
    args = (int(dtype == torch.float64), n, _WHICH[_which(backward, jvp, saving)], int(warm), iterations)
    return {"form": name, **cuda_build.launch_shape(_library().tds_pgs_instance_launch_shape, args, batch, device)}


def _which(backward: bool, jvp: bool, saving: bool = False) -> str:
    if backward + jvp + saving > 1:
        raise ValueError("backward, jvp and saving name different kernels")
    return "backward" if backward else "jvp" if jvp else "saving" if saving else "forward"


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
    """Declares the C functions of a library built from csrc/pgs.cu."""
    for fns, pointers in (((lib.tds_pgs_solve_f32, lib.tds_pgs_solve_f64), 6),
                          ((lib.tds_pgs_solve_saving_f32, lib.tds_pgs_solve_saving_f64), 8),
                          ((lib.tds_pgs_backward_f32, lib.tds_pgs_backward_f64), 12),
                          ((lib.tds_pgs_jvp_f32, lib.tds_pgs_jvp_f64), 11),
                          ((lib.tds_pgs_solve_warm_f32, lib.tds_pgs_solve_warm_f64), 7),
                          ((lib.tds_pgs_backward_warm_f32, lib.tds_pgs_backward_warm_f64), 14),
                          ((lib.tds_pgs_jvp_warm_f32, lib.tds_pgs_jvp_warm_f64), 13)):
        for fn in fns:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.tds_pgs_instance_launch_shape.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.tds_pgs_instance_launch_shape.restype = ctypes.c_int
    return lib
