"""K1 (``csrc/pgs.cu``), or with ``--backward`` its backward kernel, of this
checkout against the same kernel built from another copy of ``csrc/`` (an
earlier commit's), on the card:

    python -m tds_tpu_torch.tools.pgs_ab --other PATH/TO/tds_tpu_torch/csrc [--backward] [--rows 12 24 48 105] [--batch B]

Each row count runs at its path's batch (4096; the humanoid's 105 rows at
1024) unless ``--batch`` names one. Both libraries solve the same random
problems (``chip_smoke.py``'s layout) in float32 and float64, one and two
sweeps. Where the form that runs has the same source in both (the forward
at n <= 32, row per lane) the tool holds the two to each other bit for bit;
elsewhere it holds each library to the plain version (``chip_smoke.py``'s
tolerances: the forward's ``pgs_tol``, the backward's rtol 1e-4 and atol
1e-5 max|grad| in float32, 1e-12 relative in float64) and reports each
one's largest difference. It then times both on the one-sweep float32
problem in turns (other, this, this, other), each turn the median of 100
CUDA-event-timed launches, and the same launch with 0 sweeps (the forward:
A staged or loaded and x written; the backward: the gradients zeroed). It
prints one JSON line per row count and exits 1 when a pair differs in a bit
or a library lies past its tolerance. Both libraries are built with nvcc
into ``build/kernels/``.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from tds_tpu_torch.contact import pgs
from tds_tpu_torch.utils import cuda_build
from tds_tpu_torch.utils.timing import device_ms

PATH_BATCH = {105: 1024}  # the humanoid's; every other row count's path runs 4096 envs


def problem(batch, n, dtype, generator):
    """chip_smoke.py's random_rows_problem: SPD A = J J^T + 1e-3 I, normal
    rows then friction rows bounded by +-0.5 times their normal's impulse."""
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    dev = generator.device
    j = torch.randn(batch, n, 8, generator=generator, dtype=torch.float64, device=dev)
    a = j @ j.transpose(-1, -2) + 1e-3 * torch.eye(n, dtype=torch.float64, device=dev)
    b = torch.randn(batch, n, generator=generator, dtype=torch.float64, device=dev)
    lo = torch.cat([torch.zeros(batch, n_c, device=dev), torch.full((batch, n - n_c), -0.5, device=dev)], -1)
    hi = torch.cat([torch.full((batch, n_c), 1e5, device=dev), torch.full((batch, n - n_c), 0.5, device=dev)], -1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    return [t.to(dtype).contiguous() for t in (a, b, lo, hi)], dep


def solve(lib, operands, dep_t, iterations):
    """One launch of ``lib``'s K1 on the current stream; ``dep_t`` is the
    (n,) int32 dependency table on the card."""
    a, b, lo, hi = operands
    x = torch.empty_like(b)
    fn = lib.tds_pgs_solve_f32 if b.dtype == torch.float32 else lib.tds_pgs_solve_f64
    rc = fn(a.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(), x.data_ptr(),
            b.shape[0], b.shape[1], iterations, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PGS kernel launch failed with CUDA error {rc}")
    return x


def sweeps(lib, operands, dep_t, iterations):
    """x after each of ``iterations`` sweeps from ``lib``'s K1, the saved
    state of its backward ((1, B, n) of zeros for 0 sweeps)."""
    if iterations == 0:
        return torch.zeros_like(operands[1])[None]
    return torch.stack([solve(lib, operands, dep_t, t) for t in range(1, iterations + 1)])


def backward(lib, operands, dep_t, iterations, xs, x_bar):
    """One launch of ``lib``'s backward kernel: (A-bar, b-bar, lo-bar, hi-bar)."""
    a, b, lo, hi = operands
    grads = [torch.empty_like(t) for t in operands]
    fn = lib.tds_pgs_backward_f32 if b.dtype == torch.float32 else lib.tds_pgs_backward_f64
    rc = fn(a.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(), dep_t.data_ptr(), xs.data_ptr(), x_bar.data_ptr(),
            *(g.data_ptr() for g in grads), b.shape[0], b.shape[1], iterations, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PGS backward kernel launch failed with CUDA error {rc}")
    return grads


def pgs_tol(dtype, n):
    """chip_smoke.py's (rtol, atol) of K1 against its plain version."""
    if dtype == torch.float32:
        return 1e-5, 1e-6
    return (0.0, 1e-12) if n <= 32 else (1e-12, 1e-12)


def excess(got, want, rtol, atol):
    """(max |got - want|, the most it passes atol + rtol |want| by)."""
    err = (got - want).abs()
    return err.max().item(), (err - (atol + rtol * want.abs())).max().item()


def forward_case(libs, n, batch, gen):
    """The forward's agreement: bit for bit between the libraries for
    n <= 32, else each library's largest difference from the plain version.
    Returns (the report, whether it passes)."""
    same, errs, ok = {}, {name: 0.0 for name in libs}, True
    for dtype in (torch.float32, torch.float64):
        for iterations in (1, 2):
            operands, dep = problem(batch, n, dtype, gen)
            dep_t = torch.tensor(dep, dtype=torch.int32, device=gen.device)
            x = {name: solve(lib, operands, dep_t, iterations) for name, lib in libs.items()}
            if n <= 32:
                same[f"{str(dtype)[6:]} it={iterations}"] = bool(torch.equal(x["this"], x["other"]))
                continue
            ref = pgs.solve_pgs_reference(*operands, dep, iterations)
            for name in libs:
                err, over = excess(x[name], ref, *pgs_tol(dtype, n))
                errs[name] = max(errs[name], err)
                ok = ok and over <= 0 and bool(torch.isfinite(x[name]).all())
    if n <= 32:
        return {"bit_for_bit": same}, all(same.values())
    return {"max_abs_err_vs_plain": errs}, ok


def backward_case(libs, n, batch, gen):
    """Each library's backward against the plain version's autograd: the
    largest difference over A, b, lo and hi. Returns (the report, whether
    it passes)."""
    errs, ok = {name: 0.0 for name in libs}, True
    for dtype in (torch.float32, torch.float64):
        for iterations in (1, 2):
            operands, dep = problem(batch, n, dtype, gen)
            dep_t = torch.tensor(dep, dtype=torch.int32, device=gen.device)
            x_bar = torch.randn(operands[1].shape, generator=gen, dtype=dtype, device=gen.device)
            inputs = [t.clone().requires_grad_() for t in operands]
            want = torch.autograd.grad(pgs.solve_pgs_reference(*inputs, dep, iterations), inputs, x_bar)
            for name, lib in libs.items():
                got = backward(lib, operands, dep_t, iterations, sweeps(lib, operands, dep_t, iterations), x_bar)
                for g, w in zip(got, want):
                    scale = w.abs().max().item()
                    rtol, atol = (1e-4, 1e-5 * scale) if dtype == torch.float32 else (1e-12, 1e-12 * scale)
                    err, over = excess(g, w, rtol, atol)
                    errs[name] = max(errs[name], err)
                    ok = ok and over <= 0 and bool(torch.isfinite(g).all())
    return {"max_abs_err_vs_plain": errs}, ok


def timed(libs, n, batch, gen, is_backward):
    """Both libraries' times on the one-sweep float32 problem in turns
    (other, this, this, other), and with 0 sweeps."""
    operands, dep = problem(batch, n, torch.float32, gen)
    dep_t = torch.tensor(dep, dtype=torch.int32, device=gen.device)
    if is_backward:
        x_bar = torch.randn(operands[1].shape, generator=gen, device=gen.device)
        saved = {(name, it): sweeps(lib, operands, dep_t, it) for name, lib in libs.items() for it in (0, 1)}

        def call(name, iterations):
            return lambda: backward(libs[name], operands, dep_t, iterations, saved[name, iterations], x_bar)
    else:
        def call(name, iterations):
            return lambda: solve(libs[name], operands, dep_t, iterations)
    times = {"other": [], "this": []}
    floor = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        times[name].append(device_ms(call(name, 1), rounds=5, per_round=20))
        floor[name].append(device_ms(call(name, 0), rounds=5, per_round=20))
    return {"this_ms": times["this"], "other_ms": times["other"], "this_0_sweeps_ms": floor["this"],
            "other_0_sweeps_ms": floor["other"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another copy of tds_tpu_torch/csrc")
    parser.add_argument("--backward", action="store_true", help="the backward kernel instead of the forward")
    parser.add_argument("--rows", type=int, nargs="+", default=[12, 24, 48, 105])
    parser.add_argument("--batch", type=int, default=None, help="one batch for every row count (default: the path's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pgs_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = {"this": pgs.bind(ctypes.CDLL(str(cuda_build.build("pgs.cu")))),
            "other": pgs.bind(ctypes.CDLL(str(cuda_build.build("pgs.cu", Path(args.other)))))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    for n in args.rows:
        batch = args.batch or PATH_BATCH.get(n, 4096)
        report, ok = (backward_case if args.backward else forward_case)(libs, n, batch, gen)
        failed = failed or not ok
        dtype = torch.float32
        line = {"kernel": "backward" if args.backward else "forward", "rows": n, "batch": batch,
                "form": pgs.form(dtype, n, args.backward), **report, "ok": ok,
                **timed(libs, n, batch, gen, args.backward), "card": card}
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
