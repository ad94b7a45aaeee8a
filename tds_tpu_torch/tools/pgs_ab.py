"""K1 (``csrc/pgs.cu``), its backward or its forward mode, from x = 0 or from a
warm start, of this checkout against the same kernel built from another copy
of ``csrc/`` (an earlier commit's), on the card:

    python -m tds_tpu_torch.tools.pgs_ab --other PATH/TO/tds_tpu_torch/csrc [--backward | --jvp] [--warm]
        [--iterations 1] [--rows 12 24 48 105] [--batch B] [--panda]
    python -m tds_tpu_torch.tools.pgs_ab --other PATH/TO/tds_tpu_torch/csrc --first-sweep
    python -m tds_tpu_torch.tools.pgs_ab --other PATH/TO/tds_tpu_torch/csrc --gradient [--other-wrapper PATH/TO/pgs.py]

Each row count runs at its path's batch (4096; the humanoid's 105 rows at
1024) unless ``--batch`` names one (``--batch 2``: the ball loss's). Both
libraries solve the same random
problems (``chip_smoke.py``'s layout; with ``--warm`` an x0 of normal draws
and, for the forward mode, its tangent) in float32 and float64, at
``--iterations`` sweeps. ``--panda`` takes instead the operands of the
three solves of a Panda push step mid-stroke (``tools/panda_push.py``,
4096 scenes in float32, step 401, after 400 replayed steps: n = 3, 24, 3 at
their own 10 sweeps; with ``--warm`` an x0 of normal draws beside them).
Where the design promises the same bits (the zero
start's first sweep, forward and backward, every n) the tool holds the
two libraries to each other bit for bit; elsewhere it holds each to the
plain version (``chip_smoke.py``'s tolerances: the forward's ``pgs_tol``,
the backward's rtol 1e-4 and atol 1e-5 max|grad| in float32, 1e-12
relative in float64, the forward mode's rtol 1e-5 and atol 1e-6 max|x'|
in float32; from a warm start the float32 cases against the plain
version in float64, and past the first sweep every float32 case so; a
float32 backward against :func:`plain_backward_along`, the plain version
in float64 along each library's own sweeps, on the envs with no clip
near a tie) and prints each one's largest difference and verdict, beside
the float32 plain version's own difference from the float64 one (and
for a float32 backward each library's difference from the plain version
in float64 over every env, which a clip decided the other way near a tie
moves, and its envs near a tie). It then
times both on the float32 problem in turns (other, this, this, other),
each turn the median of 100 CUDA-event-timed launches, and the same
launch with 0 sweeps (the forward: A staged or loaded and x written; the
backward: the gradients zeroed), beside each library's launch shape and
the case's bound (the bytes the function must move over 3.35 TB/s or its
flops over 67 TFLOP/s, an H100's peaks: ``chip_smoke.py``'s counts). It
prints one JSON line per problem and exits 1 when a pair differs in a bit
or a library lies past its tolerance. Both libraries are built with nvcc
into ``build/kernels/``.

A backward takes x after each sweep as each library's wrapper gives it:
this tree's forward saves its own (``tds_pgs_solve_saving_*``), an earlier
commit's library without that entry point gets the forward relaunched at
1 .. T sweeps, as its wrapper did. ``--first-sweep`` holds the forward's
own first sweep from x = 0 (a forward past one sweep runs the Split
instances) against that relaunch's (the instance without Split) in both
libraries at FIRST_SWEEP_ROWS, float32 and float64: the elements that
differ, whether this tree's saved sweeps are the forward's own bit for
bit, and how far each library's backward lies from the plain version
along the forward's own sweeps. ``--gradient`` takes the other tree's
wrapper too (its ``contact/pgs.py``, beside ``--other`` by default) and
times ``torch.autograd.grad`` of each tree's ``solve_pgs`` at
GRADIENT_CASES, in turns, beside the forward alone, this tree's saving
forward and the backward alone, each with its bound (the saving forward's:
the forward's bytes and (T - 1) B n values written), with each tree's K1
launches a gradient and whether the two trees' gradients agree bit for
bit.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from tds_tpu_torch.contact import pgs
from tds_tpu_torch.utils import cuda_build
from tds_tpu_torch.utils.timing import device_ms, wall_ms

PATH_BATCH = {105: 1024}  # the humanoid's; every other row count's path runs 4096 envs
PANDA_BATCH, PANDA_STEP = 4096, 400
# an H100's memory rate (bytes/s) and float32 and float64 rates outside the
# tensor cores (flop/s), NVIDIA's data sheet: chip_smoke.py's peaks
PEAKS = (3.35e12, 67e12, 34e12)
# --first-sweep: the row counts (every row-per-lane instance N but 8 and 16,
# the streaming form past 335 rows) at batch 4096 and the sweeps of the
# forward whose first sweep is compared; the gradient's effect is taken on
# the first FIRST_SWEEP_GRAD_ENVS envs past 32 rows (the plain version keeps
# a copy of x a row)
FIRST_SWEEP_ROWS, FIRST_SWEEP_BATCH, FIRST_SWEEP_ITERATIONS, FIRST_SWEEP_GRAD_ENVS = (3, 12, 24, 32, 340), 4096, 4, 512
# --gradient: (rows, batch, sweeps, start, dtype) of each case, the start
# False (x = 0, the zero start's instances), True (a random x0) or "zeros"
# (x0 = 0 through the warm-start instances, as mlcp.solve_pgs from zero):
# the ball loss's n = 3 at 4 sweeps (B = 4096 and its own 2), the paths'
# row counts at their batches at 3, 10 and the bindings' default 50 sweeps
# from x = 0 and x0 in float32 (and n = 24 at 50 from x0 = 0: chip_smoke.py
# phase 21 (b)'s case), float64 at n = 3 and 24
GRADIENT_CASES = (
    [(3, 4096, 4, False, torch.float32), (3, 2, 4, False, torch.float32)]
    + [(n, 1024 if n == 105 else 4096, it, warm, torch.float32)
       for n in (12, 24, 48, 105) for it in (3, 10, 50) for warm in (False, True)]
    + [(24, 4096, 50, "zeros", torch.float32)]
    + [(n, 4096, it, warm, torch.float64) for n, it in ((3, 4), (24, 10)) for warm in (False, True)]
)


def saves_own_sweeps(lib) -> bool:
    """Whether a library built from csrc/pgs.cu has the saving forward
    (``tds_pgs_solve_saving_*``), and so a backward that takes the saved
    sweeps and x as two pointers; an earlier commit's backward takes x
    after every sweep (iterations, B, n) as one."""
    return hasattr(lib, "tds_pgs_solve_saving_f32")


def bind(lib):
    """Declares the C functions of a library built from some commit's
    csrc/pgs.cu: this tree's ABI through ``pgs.bind``; an earlier one's
    (no saving forward, a backward with one pointer to x after every
    sweep, and perhaps no forward mode, warm start or instance query)
    here."""
    if saves_own_sweeps(lib):
        return pgs.bind(lib)
    for name, pointers in (("solve", 6), ("backward", 11), ("jvp", 11), ("solve_warm", 7), ("backward_warm", 13),
                           ("jvp_warm", 13)):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tds_pgs_{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
    if hasattr(lib, "tds_pgs_instance_launch_shape"):
        lib.tds_pgs_instance_launch_shape.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.tds_pgs_instance_launch_shape.restype = ctypes.c_int
    return lib


def problem(batch, n, dtype, generator, warm):
    """chip_smoke.py's random_rows_problem: SPD A = J J^T + 1e-3 I, normal
    rows then friction rows bounded by +-0.5 times their normal's impulse;
    with ``warm`` an x0 of normal draws after them."""
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    dev = generator.device
    j = torch.randn(batch, n, 8, generator=generator, dtype=torch.float64, device=dev)
    a = j @ j.transpose(-1, -2) + 1e-3 * torch.eye(n, dtype=torch.float64, device=dev)
    b = torch.randn(batch, n, generator=generator, dtype=torch.float64, device=dev)
    lo = torch.cat([torch.zeros(batch, n_c, device=dev), torch.full((batch, n - n_c), -0.5, device=dev)], -1)
    hi = torch.cat([torch.full((batch, n_c), 1e5, device=dev), torch.full((batch, n - n_c), 0.5, device=dev)], -1)
    ops = [a, b, lo, hi] + ([torch.randn(batch, n, generator=generator, dtype=torch.float64, device=dev)] if warm else [])
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    return [t.to(dtype).contiguous() for t in ops], dep


def bound_us(kind, warm, iterations, b, saving=False):
    """The least time (us) of K1's ``kind`` (forward, backward or jvp) at
    ``iterations`` sweeps on operands whose b is ``b``, and what bounds it:
    chip_smoke.py's counts (``pgs_bound``, ``k1_backward_bound``,
    ``k1_jvp_bound``; from x0, ``warm_bounds``: every column from the first
    sweep, x0 read and its adjoint or tangent moved too) over PEAKS. With
    ``saving``, the forward that also writes x after each sweep but the
    last: (iterations - 1) B n more values written."""
    bsz, n = b.shape
    size = b.element_size()
    a_values = n * n if warm or iterations > 1 else n * (n + 1) // 2
    per_column, per_row = {"forward": (2, 4), "backward": (5, 20), "jvp": (6, 30)}[kind]
    # the first sweep from x = 0 takes row i's i columns before it, every other sweep n - 1
    first = sum(per_column * (n - 1 if warm else i) + per_row for i in range(n))
    later = max(iterations - 1, 0) * n * (per_column * (n - 1) + per_row)
    vectors = {"forward": 4, "backward": 7 + max(iterations - 1, 0), "jvp": 8}[kind] + (warm and (2 if kind == "jvp" else 1))
    vectors += max(iterations - 1, 0) if saving else 0
    values = {"forward": a_values, "backward": a_values + n * n, "jvp": 2 * a_values}[kind]
    n_bytes = size * bsz * (values + vectors * n) + 4 * n
    n_ops = bsz * (first + later) if iterations else 0
    t_bytes, t_ops = n_bytes / PEAKS[0] * 1e6, n_ops / PEAKS[1 if size == 4 else 2] * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tie_margin(n, double_sums=None):
    """How near its bound (relative to the size of its row's terms) a clip
    lies when a float32 forward's own rounding of the row's update may
    decide it the other way: 32 float32 ulps where an instance sums in
    float32, 4 where the sums run in double and the update is rounded
    once. ``double_sums`` None takes the zero start's one-sweep instances:
    row per lane in float32 (n <= 32), blocked or streaming in double."""
    return 2.4e-7 if (n > 32 if double_sums is None else double_sums) else 4e-6


def plain_forward_along(operands, dep, xs, double_sums):
    """How far a kernel's forward lies from the plain version in float64
    along its own sweeps: each row's update computed in float64 from the
    kernel's x so far (this sweep's x before the row, the previous sweep's
    after it; x0 or 0 before the first), against the kernel's x after it in
    ``xs`` (T, B, n), on ``operands`` (a, b, lo, hi[, x0]). ``double_sums``:
    whether the forward sums a row in double and rounds its update once
    (every saving instance, and every one past 32 rows) or sums in float32
    (the zero start's one-sweep row-per-lane instances, the plain version
    in float32). Returns (the largest difference, the most it passes
    1e-5 |x| + 1e-6 + tie_margin(n, double_sums) times the row's size, |b_i|
    and |A_ij x_j| over j != i, over |A_ii|): each row's own rounding,
    which over many sweeps A's conditioning may amplify into a larger
    distance from the plain forward's x."""
    a, b, lo, hi = (t.double() for t in operands[:4])
    bsz, n = b.shape
    eps = tie_margin(n, double_sums)
    x = operands[4].double().clone() if len(operands) > 4 else torch.zeros_like(b)
    worst, over = 0.0, -float("inf")
    for t in range(xs.shape[0]):
        for i in range(n):
            terms = a[:, i, :] * x
            u = (b[:, i] - (terms.sum(-1) - terms[:, i])) / a[:, i, i]
            s = torch.maximum(x[:, dep[i]], torch.zeros_like(u)) if dep[i] >= 0 else torch.ones_like(u)
            want = torch.minimum(torch.maximum(u, lo[:, i] * s), hi[:, i] * s)
            size = (b[:, i].abs() + terms.abs().sum(-1) - terms[:, i].abs()) / a[:, i, i].abs()
            got = xs[t, :, i].double()
            err = (got - want).abs()
            worst = max(worst, err.max().item())
            over = max(over, (err - (1e-5 * want.abs() + 1e-6 + eps * size)).max().item())
            x[:, i] = got
    return worst, over


def plain_backward_along(operands, dep, xs, x_bar):
    """The plain version's gradients (autograd, float64; x0-bar last with
    x0) along a kernel's own sweeps: ``xs`` (T, B, n), x after each sweep of
    the kernel's forward on ``operands`` (a, b, lo, hi[, x0]), the state its
    backward reads. Each row's update is computed in float64 from the
    kernel's x so far and then takes the kernel's value, its derivative
    unchanged: every clip is decided on the kernel's trajectory, so the
    comparison holds the backward's arithmetic and not the forward's
    rounding, which near a tie decides a clip the other way and moves a
    gradient by a whole term. Also returns, for each env, whether one of
    its clips lies within ``tie_margin(n)`` of its bound but not on it: the
    kernel's own rounding of that update may have decided it the other
    way."""
    inputs = [t.double().clone().requires_grad_() for t in operands]
    a, b, lo, hi = inputs[:4]
    bsz, n = b.shape
    eps = tie_margin(n)
    near = torch.zeros(bsz, dtype=torch.bool, device=b.device)
    with torch.enable_grad():
        x = inputs[4] if len(inputs) > 4 else torch.zeros_like(b)
        for t in range(xs.shape[0]):
            for i in range(n):
                terms = a[:, i, :] * x
                u = (b[:, i] - (terms.sum(-1) - terms[:, i])) / a[:, i, i]
                s = torch.maximum(x[:, dep[i]], torch.zeros_like(u)) if dep[i] >= 0 else torch.ones_like(u)
                lo_i, hi_i = lo[:, i] * s, hi[:, i] * s
                with torch.no_grad():
                    size = (b[:, i].abs() + terms.abs().sum(-1) - terms[:, i].abs()) / a[:, i, i].abs()
                    gap = torch.minimum((u - lo_i).abs(), (u - hi_i).abs())
                    near |= (gap > 0) & (gap < eps * size)
                xi = torch.minimum(torch.maximum(u, lo_i), hi_i)
                x = x.clone()
                x[:, i] = xi + (xs[t, :, i].double() - xi).detach()
        grads = torch.autograd.grad(x, inputs, x_bar.double(), allow_unused=True, materialize_grads=True)
    return list(grads), near


def panda_problems():
    """The operands of the PGS solves of a Panda push step mid-stroke:
    [(operands, dep, iterations)] of tools/panda_push.py's float32 scene
    at PANDA_BATCH scenes, step PANDA_STEP + 1."""
    from tds_tpu_torch.tools import panda_push

    world, arm, _ = panda_push.build_scene(dtype=torch.float32)
    q0, q1 = panda_push.ik_waypoints(arm)
    box_x = panda_push.box_starts(PANDA_BATCH, 0, torch.float32, "cuda")
    qs, qds, _ = panda_push.push(world, q0, q1, box_x, steps=PANDA_STEP, report=())
    step = panda_push.make_step(world)
    calls, solve = [], pgs.solve_pgs

    def recording_solve(*args):
        calls.append(args)
        return solve(*args)

    pgs.solve_pgs = recording_solve
    try:
        step((*qs, *qds, torch.full_like(box_x, float(PANDA_STEP))), (q0, q1, torch.tensor(panda_push.GRAVITY, device="cuda")))
    finally:
        pgs.solve_pgs = solve
    return [([t.contiguous() for t in c[:4]], list(c[4]), int(c[5])) for c in calls]


class Kernel:
    """One of K1's kernels (``kind``: forward, backward or jvp; ``warm``:
    the warm-start instance) of a library, on one problem: its operands,
    and for the backward the cotangent, for the forward mode the
    tangents."""

    def __init__(self, kind, warm, operands, dep, generator):
        self.kind, self.warm = kind, warm
        self.operands, self.dep = operands, dep
        b = operands[1]
        self.dep_t = torch.tensor(dep, dtype=torch.int32, device=b.device)
        self.x_bar = torch.randn(b.shape, generator=generator, dtype=b.dtype, device=b.device)
        self.tangents = [torch.randn(t.shape, generator=generator, dtype=t.dtype, device=t.device) for t in operands]
        self.saved = {}

    def _sizes(self, iterations):
        b = self.operands[1]
        return b.shape[0], b.shape[1], iterations, torch.cuda.current_stream().cuda_stream

    def solve_saving(self, lib, iterations):
        """(x, xs) of ``lib``'s saving forward (``tds_pgs_solve_saving_*``):
        x after ``iterations`` sweeps and after each sweep but the last."""
        a, b, lo, hi, *warm = self.operands
        x = torch.empty_like(b)
        xs = b.new_empty((max(iterations - 1, 0),) + tuple(b.shape))
        suffix = "f32" if b.dtype == torch.float32 else "f64"
        rc = getattr(lib, f"tds_pgs_solve_saving_{suffix}")(
            a.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), self.dep_t.data_ptr(),
            warm[0].data_ptr() if warm else None, x.data_ptr(), xs.data_ptr() if xs.numel() else None,
            *self._sizes(iterations))
        if rc != 0:
            raise RuntimeError(f"PGS saving kernel launch failed with CUDA error {rc}")
        return x, xs

    def solve(self, lib, iterations):
        """x after ``iterations`` sweeps of ``lib``'s forward."""
        a, b, lo, hi, *warm = self.operands
        x = torch.empty_like(b)
        suffix = "f32" if b.dtype == torch.float32 else "f64"
        if warm:
            rc = getattr(lib, f"tds_pgs_solve_warm_{suffix}")(
                a.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), self.dep_t.data_ptr(), warm[0].data_ptr(),
                x.data_ptr(), *self._sizes(iterations))
        else:
            rc = getattr(lib, f"tds_pgs_solve_{suffix}")(
                a.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), self.dep_t.data_ptr(), x.data_ptr(),
                *self._sizes(iterations))
        if rc != 0:
            raise RuntimeError(f"PGS kernel launch failed with CUDA error {rc}")
        return x

    def sweeps(self, lib, iterations):
        """x after each of ``iterations`` sweeps as ``lib``'s backward reads
        them ((1, B, n) of zeros for 0 sweeps), kept: the forward's own, as
        its saving launch stores them, for a library that has one; else
        what an earlier commit's wrapper gave its backward, the forward
        relaunched at 1 .. ``iterations`` sweeps."""
        key = (id(lib), iterations)
        if key not in self.saved:
            if iterations == 0:
                self.saved[key] = torch.zeros_like(self.operands[1])[None]
            elif saves_own_sweeps(lib):
                x, xs = self.solve_saving(lib, iterations)
                self.saved[key] = torch.cat([xs, x[None]])
            else:
                self.saved[key] = torch.stack([self.solve(lib, t) for t in range(1, iterations + 1)])
        return self.saved[key]

    def run(self, lib, iterations):
        """One launch of the kernel: x, the gradients, or (x, x')."""
        if self.kind == "forward":
            return [self.solve(lib, iterations)]
        a, b, lo, hi, *warm = self.operands
        suffix = ("warm_" if warm else "") + ("f32" if b.dtype == torch.float32 else "f64")
        if self.kind == "backward":
            grads = [torch.empty_like(t) for t in self.operands]
            xs = self.sweeps(lib, iterations)
            # a library with the saving forward takes its saved sweeps and x apart
            states = [xs[:-1] if iterations > 1 else None, xs[-1]] if saves_own_sweeps(lib) else [xs]
            head = [a, b, lo, hi, self.dep_t, *states, self.x_bar] + warm
            rc = getattr(lib, f"tds_pgs_backward_{suffix}")(*(None if t is None else t.data_ptr() for t in head + grads),
                                                            *self._sizes(iterations))
            out = grads
        else:
            x, x_dot = torch.empty_like(b), torch.empty_like(b)
            primal = [a, b, lo, hi] + warm
            rc = getattr(lib, f"tds_pgs_jvp_{suffix}")(
                *(t.data_ptr() for t in primal + self.tangents), self.dep_t.data_ptr(), x.data_ptr(), x_dot.data_ptr(),
                *self._sizes(iterations))
            out = [x, x_dot]
        if rc != 0:
            raise RuntimeError(f"PGS {self.kind} kernel launch failed with CUDA error {rc}")
        return out

    def plain(self, iterations, dtype=None):
        """The plain version's results on the same operands, in ``dtype``:
        by default float64 for more than one sweep or from a warm start
        (where the float32 plain sweep's own rounding strays past the
        float32 tolerances, as the card tests find), else the operands'."""
        if dtype is None:
            dtype = torch.float64 if iterations > 1 or self.warm else self.operands[1].dtype
        ops = [t.to(dtype) for t in self.operands]
        x0 = ops[4] if self.warm else None
        if self.kind == "forward":
            return [pgs.solve_pgs_reference(*ops[:4], self.dep, iterations, x0)]
        if self.kind == "backward":
            inputs = [t.clone().requires_grad_() for t in ops]
            x = pgs.solve_pgs_reference(*inputs[:4], self.dep, iterations, inputs[4] if self.warm else None)
            return list(torch.autograd.grad(x, inputs, self.x_bar.to(dtype), allow_unused=True, materialize_grads=True))
        tangents = [t.to(dtype) for t in self.tangents]
        return list(pgs.solve_pgs_jvp_reference(*ops[:4], tangents, self.dep, iterations, x0))

    def plain_along(self, lib, iterations):
        """The backward's plain gradients along ``lib``'s own sweeps and the
        envs near a tie (:func:`plain_backward_along`)."""
        return plain_backward_along(self.operands, self.dep, self.sweeps(lib, iterations), self.x_bar)

    def tolerance(self, n, index, want):
        """(rtol, atol) of result ``index`` (``want`` its plain value)."""
        f32 = self.operands[1].dtype == torch.float32
        if self.kind == "backward":
            scale = want.abs().max().item()
            return (1e-4, 1e-5 * scale) if f32 else (1e-12, 1e-12 * scale)
        if self.kind == "jvp" and index == 1:
            scale = max(1.0, want.abs().max().item())
            return (1e-5, 1e-6 * scale) if f32 else (1e-12, 1e-12 * scale)
        return pgs_tol(self.operands[1].dtype, n) if f32 or not self.warm else (1e-12, 1e-12)


def pgs_tol(dtype, n):
    """chip_smoke.py's (rtol, atol) of K1 against its plain version."""
    if dtype == torch.float32:
        return 1e-5, 1e-6
    return (0.0, 1e-12) if n <= 32 else (1e-12, 1e-12)


def excess(got, want, rtol, atol):
    """(max |got - want|, the most it passes atol + rtol |want| by)."""
    err = (got.to(want.dtype) - want).abs()
    return err.max().item(), (err - (atol + rtol * want.abs())).max().item()


def agreement(libs, kernels, iterations):
    """The libraries' agreement on each kernel: bit for bit where the design
    promises it (the zero start's first sweep of the forward and the
    backward), else each library's largest difference from the plain
    version and whether it lies within the tolerance (a float32 backward:
    along the library's own sweeps, on the envs with no clip near a tie);
    where a float32 kernel is held to the plain version in float64, the
    float32 plain version's own largest difference from it and its verdict
    beside them, and for a float32 backward each library's difference from
    it over every env and its envs near a tie. Returns (the report, whether
    it passes)."""
    same, errs, within = {}, {name: 0.0 for name in libs}, {name: True for name in libs}
    own_err, own_within, checked, forward_bits = 0.0, True, False, {}
    all_envs, near_tie = {name: 0.0 for name in libs}, {name: 0 for name in libs}
    for kernel in kernels:
        got = {name: kernel.run(lib, iterations) for name, lib in libs.items()}
        b = kernel.operands[1]
        n = b.shape[1]
        if iterations == 1 and not kernel.warm and kernel.kind != "jvp":
            same[str(b.dtype)[6:]] = all(torch.equal(g, o) for g, o in zip(got["this"], got["other"]))
            continue
        if kernel.kind == "forward":  # reported, not held: two commits' forwards may differ by design
            forward_bits[str(b.dtype)[6:]] = torch.equal(got["this"][0], got["other"][0])
        want = kernel.plain(iterations)
        along = kernel.kind == "backward" and b.dtype == torch.float32
        for name, lib in libs.items():
            ref, keep = want, slice(None)
            if along:
                ref, near = kernel.plain_along(lib, iterations)
                keep = ~near
                near_tie[name] += int(near.sum())
                all_envs[name] = max([all_envs[name]] + [excess(g, w, 0.0, 0.0)[0] for g, w in zip(got[name], want)])
            for index, (g, w) in enumerate(zip(got[name], ref)):
                err, over = excess(g[keep], w[keep], *kernel.tolerance(n, index, w))
                errs[name] = max(errs[name], err)
                within[name] = within[name] and over <= 0 and bool(torch.isfinite(g).all())
        if b.dtype == torch.float32 and want[0].dtype == torch.float64:
            checked = True
            for index, (g, w) in enumerate(zip(kernel.plain(iterations, torch.float32), want)):
                err, over = excess(g, w, *kernel.tolerance(n, index, w))
                own_err, own_within = max(own_err, err), own_within and over <= 0
    report, ok = {}, all(same.values())
    if same:
        report["bit_for_bit"] = same
    if len(same) < len(kernels):
        report["max_abs_err_vs_plain"] = errs
        report["within_tolerance"] = within
        ok = ok and all(within.values())
    if forward_bits:
        report["forward_bit_for_bit_with_other"] = forward_bits
    if checked:
        report["plain_float32_vs_float64"] = {"max_abs_err": own_err, "within_tolerance": own_within}
    if any(near_tie.values()) or any(all_envs.values()):
        report["float32_backward_vs_plain_float64_every_env"] = all_envs
        report["float32_backward_envs_near_a_tie"] = near_tie
    return report, ok


def shapes(libs, kernel, n, batch, iterations):
    """Each library's launch shape of the kernel (an earlier commit's
    library without the instance query reports the zero start's only)."""
    f64 = int(kernel.operands[1].dtype == torch.float64)
    which = {"forward": 0, "backward": 1, "jvp": 2}[kernel.kind]
    out = {}
    for name, lib in libs.items():
        if hasattr(lib, "tds_pgs_instance_launch_shape"):
            fn, args = lib.tds_pgs_instance_launch_shape, (f64, n, which, int(kernel.warm), iterations)
        elif kernel.warm:
            continue
        else:
            fn = (lib.tds_pgs_launch_shape, lib.tds_pgs_backward_launch_shape, lib.tds_pgs_jvp_launch_shape)[which]
            fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
            args = (f64, n)
        shape = cuda_build.launch_shape(fn, args, batch, "cuda")
        out[f"{name}_shape"] = {k: shape[k] for k in ("registers", "local_bytes", "resident_warps_per_sm", "waves",
                                                      "smem_per_block")}
    return out


def timed(libs, kernel, iterations):
    """Both libraries' times on the kernel in turns (other, this, this,
    other), at ``iterations`` sweeps and at 0."""
    times = {(name, it): [] for name in libs for it in (iterations, 0)}
    for name in ("other", "this", "this", "other"):
        for it in (iterations, 0):
            times[name, it].append(device_ms(lambda: kernel.run(libs[name], it), rounds=5, per_round=20))
    return {"this_ms": times["this", iterations], "other_ms": times["other", iterations],
            "this_0_sweeps_ms": times["this", 0], "other_0_sweeps_ms": times["other", 0]}


def random_cases(kind, rows, batch, iterations, warm, generator):
    """[(n, batch, iterations, kernels, "random")] as ``main`` runs them:
    each row count's float32 and float64 problem drawn from ``generator``
    in turn, then each case's kernels (their cotangents and tangents drawn
    in turn), so that a seed gives every case the same operands run after
    run (a test can rebuild a case of a run from it)."""
    problems = [(n, batch or PATH_BATCH.get(n, 4096)) for n in rows]
    problems = [(n, bsz, [problem(bsz, n, dtype, generator, warm) for dtype in (torch.float32, torch.float64)])
                for n, bsz in problems]
    return [(n, bsz, iterations, [Kernel(kind, warm, ops, dep, generator) for ops, dep in probs], "random")
            for n, bsz, probs in problems]


def other_wrapper(path, lib):
    """Another tree's wrapper (its ``contact/pgs.py``), loaded under a name
    of its own and bound to ``lib``, that tree's library: its
    ``solve_pgs`` as a user calls it, with its own launch counts."""
    spec = importlib.util.spec_from_file_location("tds_tpu_torch_other_pgs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._library = lambda: lib
    return module


def first_sweep(libs, n, dtype, gen):
    """(0) of the saved sweeps: x after the first sweep of a forward of
    FIRST_SWEEP_ITERATIONS sweeps from x = 0, as that forward computes it
    (its Split instance: the warm instance from x0 = 0 for one sweep, which
    sums and rounds as the forward's first sweep does), against the
    one-sweep relaunch an earlier wrapper gave the backward in its place
    (the instance without Split) on FIRST_SWEEP_BATCH random envs: the
    elements that differ and the largest difference; for a library with
    the saving forward whether its saved first sweep is the forward's own
    bit for bit; and the largest difference of the library's backward, on
    the sweeps its wrapper gives it, from the plain version in float64
    along the forward's own sweeps, over every env and on the envs with
    no clip near a tie, against the backward's tolerance."""
    iterations, batch = FIRST_SWEEP_ITERATIONS, FIRST_SWEEP_BATCH
    ops, dep = problem(batch, n, dtype, gen, False)
    kernel = Kernel("backward", False, ops, dep, gen)
    from_zero = Kernel("forward", True, ops + [torch.zeros_like(ops[1])], dep, gen)
    envs = slice(None) if n <= 32 else slice(0, FIRST_SWEEP_GRAD_ENVS)
    out = {}
    for name, lib in libs.items():
        own = from_zero.solve(lib, 1)
        relaunch = kernel.solve(lib, 1)
        row = {"relaunch_elements_differing": int((relaunch != own).sum()), "elements": own.numel(),
               "relaunch_max_abs_diff": (relaunch.double() - own.double()).abs().max().item()}
        if saves_own_sweeps(lib):
            saved = kernel.sweeps(lib, iterations)
            row["saved_sweep_1_is_the_forwards_own"] = torch.equal(saved[0], own)
            row["saved_sweeps_are_the_forwards_own"] = row["saved_sweep_1_is_the_forwards_own"] and all(
                torch.equal(saved[t - 1], kernel.solve(lib, t)) for t in range(2, iterations + 1))
        grads = kernel.run(lib, iterations)
        own_sweeps = torch.stack([own] + [kernel.solve(lib, t) for t in range(2, iterations + 1)])
        want, near = plain_backward_along([t[envs] for t in ops], dep, own_sweeps[:, envs], kernel.x_bar[envs])
        worst, every_env, within = 0.0, 0.0, True
        for g, w in zip(grads, want):
            scale = w.abs().max().item()
            g = g[envs]
            every_env = max(every_env, excess(g, w, 0.0, 0.0)[0])
            tol = (1e-4, 1e-5 * scale) if dtype == torch.float32 else (1e-12, 1e-12 * scale)
            err, over = excess(g[~near], w[~near], *tol)
            worst, within = max(worst, err), within and over <= 0
        row.update(grad_max_abs_err_vs_plain_along_own_sweeps=worst, grad_within_tolerance=within,
                   grad_max_abs_err_every_env=every_env, grad_envs=own[envs].shape[0], envs_near_a_tie=int(near.sum()))
        out[name] = row
    return {"mode": "first_sweep", "rows": n, "batch": batch, "iterations": iterations, "dtype": str(dtype)[6:],
            "form": pgs.form(dtype, n, iterations=iterations), **out}


def _timed_calls(fn):
    """Device time (ms, median) of ``fn`` with as many calls a round as
    keep the launch queue and the host's enqueueing inside the sleep that
    hides it, and its host wall time (ms, enqueue and run)."""
    wall = wall_ms(fn, 3)
    per_round = max(2, min(20, int(20 / max(wall, 1e-3))))
    return device_ms(fn, rounds=5, per_round=per_round, backlog_ms=20 + 2 * per_round * wall), wall


def gradient_case(libs, wrappers, n, batch, iterations, start, dtype, gen):
    """A gradient as a user takes it, ``torch.autograd.grad`` of each
    tree's ``solve_pgs`` (forward and backward, from x0 with ``warm``) for
    a random cotangent: each tree's K1 launches a gradient (the wrapper's
    counts), whether the two trees' gradients agree bit for bit, this
    tree's against the plain version (float64: its autograd; float32:
    along this tree's own sweeps, on the envs with no clip near a tie),
    then the times in turns (other, this, this, other): the gradient
    through the wrapper (device, and the host's wall time), the forward
    alone without saves, this tree's saving forward, and the backward
    alone on the sweeps each tree's wrapper gives it, each with its
    bound. ``start``: GRADIENT_CASES'."""
    warm = bool(start)
    ops, dep = problem(batch, n, dtype, gen, warm)
    if start == "zeros":
        ops[4] = torch.zeros_like(ops[4])
    kernel = Kernel("backward", warm, ops, dep, gen)
    inputs = [t.clone().requires_grad_() for t in ops]

    def gradient(module):
        x = module.solve_pgs(*inputs[:4], dep, iterations, inputs[4] if warm else None)
        return torch.autograd.grad(x, inputs, kernel.x_bar)

    line = {"mode": "gradient", "rows": n, "batch": batch, "iterations": iterations, "start": start,
            "dtype": str(dtype)[6:], "form": pgs.form(dtype, n, warm=warm, iterations=iterations),
            "backward_form": pgs.form(dtype, n, backward=True, warm=warm, iterations=iterations)}
    got = {}
    for name, module in wrappers.items():
        counts = ("launches", "warm_launches", "backward_launches", "warm_backward_launches")
        for c in counts:
            setattr(module, c, 0)
        got[name] = gradient(module)
        torch.cuda.synchronize()
        line[f"{name}_launches_per_gradient"] = {c: getattr(module, c) for c in counts}
    line["gradients_bit_for_bit_with_other"] = all(torch.equal(g, o) for g, o in zip(got["this"], got["other"]))
    f64 = int(dtype == torch.float64)
    for name, kind, which in (("this", "saving_forward", 3), ("this", "forward", 0), ("other", "forward", 0)):
        shape = cuda_build.launch_shape(libs[name].tds_pgs_instance_launch_shape, (f64, n, which, int(warm), iterations),
                                        batch, "cuda")
        line[f"{name}_{kind}_shape"] = {k: shape[k] for k in ("registers", "local_bytes", "resident_warps_per_sm", "waves")}
    if dtype == torch.float64:
        want, near = kernel.plain(iterations, torch.float64), torch.zeros(batch, dtype=torch.bool, device=ops[1].device)
    else:
        want, near = kernel.plain_along(libs["this"], iterations)
    worst, within = 0.0, True
    for index, (g, w) in enumerate(zip(got["this"], want)):
        err, over = excess(g[~near], w[~near], *kernel.tolerance(n, index, w))
        worst, within = max(worst, err), within and over <= 0 and bool(torch.isfinite(g).all())
    line.update(max_abs_err_vs_plain=worst, within_tolerance=within, envs_near_a_tie=int(near.sum()))
    items = {"gradient": lambda name: gradient(wrappers[name]),
             "forward": lambda name: kernel.solve(libs[name], iterations),
             "saving_forward": lambda name: kernel.solve_saving(libs[name], iterations),
             "backward": lambda name: kernel.run(libs[name], iterations)}
    times = {}
    for name in ("other", "this", "this", "other"):
        for item, fn in items.items():
            if item == "saving_forward" and not saves_own_sweeps(libs[name]):
                continue
            device, wall = _timed_calls(lambda: fn(name))
            times.setdefault(f"{name}_{item}_ms", []).append(device)
            if item == "gradient":
                times.setdefault(f"{name}_gradient_wall_ms", []).append(wall)
    b = ops[1]
    bounds = {"forward": bound_us("forward", warm, iterations, b), "backward": bound_us("backward", warm, iterations, b),
              "saving_forward": bound_us("forward", warm, iterations, b, saving=True)}
    bounds["gradient"] = (bounds["saving_forward"][0] + bounds["backward"][0], "the saving forward's and the backward's")
    line.update(times, **{f"{k}_bound_us": v[0] for k, v in bounds.items()}, **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
                ok=within)
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another copy of tds_tpu_torch/csrc")
    kind = parser.add_mutually_exclusive_group()
    kind.add_argument("--backward", action="store_true", help="the backward kernel instead of the forward")
    kind.add_argument("--jvp", action="store_true", help="the forward-mode kernel instead of the forward")
    parser.add_argument("--warm", action="store_true", help="the warm-start instances, from a random x0")
    parser.add_argument("--iterations", type=int, default=1, help="sweeps (default 1)")
    parser.add_argument("--rows", type=int, nargs="+", default=[12, 24, 48, 105])
    parser.add_argument("--batch", type=int, default=None, help="one batch for every row count (default: the path's)")
    parser.add_argument("--panda", action="store_true", help="the Panda push's operands instead of random problems")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--first-sweep", action="store_true",
                      help="the forward's own first sweep against the one-sweep relaunch, and the backward's gradients")
    mode.add_argument("--gradient", action="store_true",
                      help="torch.autograd.grad of each tree's solve_pgs (forward and backward) at GRADIENT_CASES")
    parser.add_argument("--other-wrapper", default=None,
                        help="the other tree's contact/pgs.py for --gradient (default: beside --other's csrc)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pgs_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = {"this": pgs.bind(ctypes.CDLL(str(cuda_build.build("pgs.cu")))),
            "other": bind(ctypes.CDLL(str(cuda_build.build("pgs.cu", Path(args.other)))))}
    name = "backward" if args.backward else "jvp" if args.jvp else "forward"
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.first_sweep or args.gradient:
        lines = []
        if args.first_sweep:
            lines = (first_sweep(libs, n, dtype, gen) for dtype in (torch.float32, torch.float64) for n in FIRST_SWEEP_ROWS)
        else:
            path = Path(args.other_wrapper) if args.other_wrapper else Path(args.other).parent / "contact" / "pgs.py"
            wrappers = {"this": pgs, "other": other_wrapper(path, libs["other"])}
            lines = (gradient_case(libs, wrappers, *case, gen) for case in GRADIENT_CASES)
        failed = False
        for line in lines:
            failed = failed or not line.get("ok", True) or not line.get("this", {}).get("saved_sweeps_are_the_forwards_own", True)
            print(json.dumps({**line, "card": card}), flush=True)
        return 1 if failed else 0
    if args.panda:
        cases = []
        for k, (ops, dep, it) in enumerate(panda_problems()):
            if args.warm:
                ops = ops + [torch.randn(ops[1].shape, generator=gen, dtype=ops[1].dtype, device=ops[1].device)]
            cases.append((ops[1].shape[1], ops[1].shape[0], it, [Kernel(name, args.warm, ops, dep, gen)], f"panda solve {k}"))
    else:
        cases = random_cases(name, args.rows, args.batch, args.iterations, args.warm, gen)
    failed = False
    for n, batch, iterations, kernels, operands in cases:
        report, ok = agreement(libs, kernels, iterations)
        failed = failed or not ok
        bound, bound_by = bound_us(name, args.warm, iterations, kernels[0].operands[1])
        line = {"kernel": name, "warm": args.warm, "operands": operands, "iterations": iterations, "rows": n,
                "batch": batch, "form": pgs.form(torch.float32, n, args.backward, args.jvp, args.warm, iterations),
                **report, "ok": ok, **timed(libs, kernels[0], iterations), "bound_us": bound, "bound_by": bound_by,
                **shapes(libs, kernels[0], n, batch, iterations), "card": card}
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
