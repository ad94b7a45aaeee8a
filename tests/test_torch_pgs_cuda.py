"""The PGS kernel (csrc/pgs.cu) on a CUDA device against the port's plain
version: float32 at rtol 1e-5 / atol 1e-6 (tests/test_pallas_pgs.py's
tolerance), float64 at atol 1e-12, at batches that fill no whole block of
groups; and its launch shape on the card. Every test here needs the card and skips
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
    """Numpy (a, b, lo, hi, dep) as in tests/test_pallas_pgs.py."""
    rng = np.random.default_rng(seed)
    n = 3 * n_c
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n)
    b = rng.normal(size=(bsz, n))
    lo = np.concatenate([np.zeros((bsz, n_c))] + [np.full((bsz, n_c), -0.5)] * 2, axis=-1)
    hi = np.concatenate([np.full((bsz, n_c), 1e5)] + [np.full((bsz, n_c), 0.5)] * 2, axis=-1)
    dep = [-1] * n_c + list(range(n_c)) * 2
    return a, b, lo, hi, dep


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", pgs.SUPPORTED_ROWS)
def test_every_instance_has_a_block_resident_per_sm(cuda_device, dtype, n):
    shape = pgs.launch_shape(dtype, n, 4096)
    assert shape["blocks_per_sm"] >= 1 and shape["lanes_per_env"] >= n
    assert shape["envs_per_block"] * shape["lanes_per_env"] == shape["threads_per_block"]


def test_cuda_kernel_refuses_unbuilt_row_counts(cuda_device):
    a, b, lo, hi, dep = _problem(4, 3, seed=0)  # n = 9: no template instance
    with pytest.raises(ValueError):
        pgs.solve_pgs(*(torch.from_numpy(x).to(cuda_device) for x in (a, b, lo, hi)), dep, 1)


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
