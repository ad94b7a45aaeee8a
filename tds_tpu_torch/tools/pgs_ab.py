"""K1 (``csrc/pgs.cu``) of this checkout against K1 built from another copy
of ``csrc/`` (an earlier commit's), on the card:

    python -m tds_tpu_torch.tools.pgs_ab --other PATH/TO/tds_tpu_torch/csrc [--rows 12 24] [--batch 4096]

For each row count, in float32 and float64, both libraries solve the same
random problems (``chip_smoke.py``'s layout, one and two sweeps); the tool
reports whether the two agree bit for bit, and times both on the one-sweep
float32 problem in turns (other, this, this, other), each turn the median of
100 CUDA-event-timed launches. It prints one JSON line per row count and
exits 1 when any pair of results differs in a bit. Both libraries are built
with nvcc into ``build/kernels/``.
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another copy of tds_tpu_torch/csrc")
    parser.add_argument("--rows", type=int, nargs="+", default=[12, 24])
    parser.add_argument("--batch", type=int, default=4096)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pgs_ab needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    libs = {"this": pgs.bind(ctypes.CDLL(str(cuda_build.build("pgs.cu")))),
            "other": pgs.bind(ctypes.CDLL(str(cuda_build.build("pgs.cu", Path(args.other)))))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    differs = False
    for n in args.rows:
        same = {}
        for dtype in (torch.float32, torch.float64):
            for iterations in (1, 2):
                operands, dep = problem(args.batch, n, dtype, gen)
                dep_t = torch.tensor(dep, dtype=torch.int32, device="cuda")
                x = {name: solve(lib, operands, dep_t, iterations) for name, lib in libs.items()}
                same[f"{str(dtype)[6:]} it={iterations}"] = bool(torch.equal(x["this"], x["other"]))
        operands, dep = problem(args.batch, n, torch.float32, gen)
        dep_t = torch.tensor(dep, dtype=torch.int32, device="cuda")
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            times[name].append(device_ms(lambda: solve(libs[name], operands, dep_t, 1), rounds=5, per_round=20))
        differs = differs or not all(same.values())
        print(json.dumps({"rows": n, "batch": args.batch, "bit_for_bit": same, "this_ms": times["this"],
                          "other_ms": times["other"], "card": card}), flush=True)
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main())
