"""The PGS kernel (csrc/pgs.cu) on a CUDA device against the port's plain
version: float32 at rtol 1e-5 / atol 1e-6 (tests/test_pallas_pgs.py's
tolerance), float64 at atol 1e-12 for the row-per-lane kernel (n <= 32) and
at 1e-12 relative for the warp per env (n > 32, whose sums run in another
order), at batches that fill no whole block of groups and at every row
count of chip_smoke.py's phase 12 (a); and its launch shape on the card. Every test here needs the card and skips
without one. The file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pgs_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import pgs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    return torch.device("cuda")


def _problem(bsz, n_c, seed):
    """Numpy (a, b, lo, hi, dep) as in tests/test_pallas_pgs.py: n = 3 n_c
    rows, n_c normal rows, then two friction rows per contact."""
    return _rows_problem(bsz, 3 * n_c, seed)


def _rows_problem(bsz, n, seed, dtype=np.float64):
    """Numpy (a, b, lo, hi, dep) with n rows of any count: the layout of
    _problem (normal rows, then friction rows bounded by +-0.5 times their
    normal row's impulse) with n / 3 contacts when 3 divides n, else n / 2
    normal rows and one friction direction (n = 8: laikago with
    num_friction_dir = 1), at least one normal row."""
    rng = np.random.default_rng(seed)
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n)
    b = rng.normal(size=(bsz, n))
    lo = np.concatenate([np.zeros((bsz, n_c)), np.full((bsz, n - n_c), -0.5)], axis=-1)
    hi = np.concatenate([np.full((bsz, n_c), 1e5), np.full((bsz, n - n_c), 0.5)], axis=-1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    return [x.astype(dtype) for x in (a, b, lo, hi)] + [dep]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bsz,n_c,iterations", [(300, 4, 3), (21, 2 * 2, 2), (130, 8, 1), (130, 4, 1), (21, 8, 2)])
def test_cuda_tensor_never_reaches_the_plain_path(cuda_device, monkeypatch, dtype, bsz, n_c, iterations):
    a, b, lo, hi, dep = _problem(bsz, n_c, seed=bsz)
    expected = pgs.solve_pgs_reference(*(torch.from_numpy(x) for x in (a, b, lo, hi)), dep, iterations).to(dtype)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain PGS ran on a CUDA tensor")

    monkeypatch.setattr(pgs, "solve_pgs_reference", refuse)
    before = pgs.launches
    got = pgs.solve_pgs(*(torch.from_numpy(x).to(cuda_device, dtype) for x in (a, b, lo, hi)), dep, iterations)
    torch.cuda.synchronize()
    assert pgs.launches == before + 1
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=0, atol=1e-12)
    torch.testing.assert_close(got.cpu(), expected, **tol)


# the row counts of chip_smoke.py's phase 12 (a): laikago with top_k 1-3 or
# one friction direction (3-9), laikago (12), the ant and the hopper (24),
# the half-cheetah (48), the ant without compaction (51), the humanoid (105)
ROWS = (3, 6, 8, 9, 12, 24, 48, 51, 105)


def _tolerance(dtype, n):
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-6)
    return dict(rtol=0, atol=1e-12) if n <= 32 else dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ROWS)
def test_every_instance_has_a_block_resident_per_sm(cuda_device, dtype, n):
    """A row per lane for n <= 32, a warp per env above; no local memory."""
    shape = pgs.launch_shape(dtype, n, 4096)
    assert shape["blocks_per_sm"] >= 1 and shape["local_bytes"] == 0
    assert shape["lanes_per_env"] >= n if n <= 32 else shape["lanes_per_env"] == 32
    assert shape["envs_per_block"] * shape["lanes_per_env"] == shape["threads_per_block"]


def test_cuda_kernel_refuses_unbuilt_row_counts(cuda_device):
    """Every row count runs on the card now (n = 9 had no instance before
    the padded instances and the warp per env): n = 9, 1, 33 and 200, each
    against the plain version."""
    for n_rows in (9, 1, 33, 200):
        a, b, lo, hi, dep = _rows_problem(5, n_rows, seed=n_rows)
        expected = pgs.solve_pgs_reference(*(torch.from_numpy(x) for x in (a, b, lo, hi)), dep, 2)
        got = pgs.solve_pgs(*(torch.from_numpy(x).to(cuda_device) for x in (a, b, lo, hi)), dep, 2)
        torch.testing.assert_close(got.cpu(), expected, **_tolerance(torch.float64, n_rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,bsz", [(n, bsz) for n in ROWS for bsz in (1, 37, 4096)] + [(105, 1024)])
def test_kernel_matches_plain_at_every_row_count(cuda_device, dtype, n, bsz):
    """Two sweeps of a random problem of n rows in the kernel and the plain
    version, on the same operands in ``dtype``."""
    a, b, lo, hi, dep = _rows_problem(bsz, n, seed=n * bsz, dtype=np.float32 if dtype == torch.float32 else np.float64)
    expected = pgs.solve_pgs_reference(*(torch.from_numpy(x) for x in (a, b, lo, hi)), dep, 2)
    before = pgs.launches
    got = pgs.solve_pgs(*(torch.from_numpy(x).to(cuda_device) for x in (a, b, lo, hi)), dep, 2)
    torch.cuda.synchronize()
    assert pgs.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.cpu(), expected, **_tolerance(dtype, n))


def test_cuda_kernel_refuses_mixed_dtypes_and_strides(cuda_device):
    a, b, lo, hi, dep = (torch.from_numpy(x).to(cuda_device) if isinstance(x, np.ndarray) else x for x in _problem(8, 4, seed=1))
    with pytest.raises(TypeError):
        pgs.solve_pgs(a.float(), b, lo, hi, dep, 1)
    with pytest.raises(ValueError):
        pgs.solve_pgs(a.transpose(-1, -2), b, lo, hi, dep, 1)


def test_cuda_kernel_refuses_gradients_it_would_drop(cuda_device):
    """K1 has no backward: under grad, an operand that requires grad is
    refused; under torch.no_grad() the same call returns what it returns
    without one."""
    a, b, lo, hi = (torch.from_numpy(x).to(cuda_device) for x in _problem(21, 4, seed=2)[:4])
    dep = _problem(21, 4, seed=2)[4]
    expected = pgs.solve_pgs(a, b, lo, hi, dep, 2)
    before = pgs.launches
    with pytest.raises(RuntimeError, match="no backward"):
        pgs.solve_pgs(a, b.clone().requires_grad_(), lo, hi, dep, 2)
    assert pgs.launches == before
    with torch.no_grad():
        got = pgs.solve_pgs(a.clone().requires_grad_(), b.clone().requires_grad_(), lo, hi, dep, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, expected) and not got.requires_grad
