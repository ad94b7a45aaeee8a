"""nvcc builds of the port's CUDA sources into shared libraries with a plain
C interface, loaded with ctypes by the kernels' wrappers.

:func:`build` compiles ``csrc/<source>`` for ``sm_90a`` into
``build/kernels/<name>-<hash>/lib<name>.so`` (``<name>`` the source's
stem) at the root of the checkout
(``TDS_TPU_TORCH_BUILD_DIR`` overrides the root), keyed by a hash of the
sources in ``csrc/`` (so that a change to a shared header rebuilds every
library) and of the flags. nvcc's output (with ``-Xptxas -v``: each
kernel's registers, stack frame and spills) lands in ``build.log`` beside
the library. A wrapper builds at its first launch; importing this module
builds nothing.
"""

import os
import shutil
import subprocess
import time
from hashlib import sha256
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels cannot be built")
    return found


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``lib<name>.so`` unless a build of
    these sources and flags exists; returns the library's path. Raises when
    nvcc is missing or fails."""
    name = Path(source).stem
    digest = sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + path.read_bytes())
    root = Path(os.environ.get("TDS_TPU_TORCH_BUILD_DIR") or Path(__file__).resolve().parents[2] / "build")
    out_dir = root / "kernels" / f"{name}-{digest.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(f"{' '.join(cmd)}\n# nvcc took {seconds:.1f} s\n{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
