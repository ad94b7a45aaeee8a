"""K1's warm-start instances (``csrc/pgs.cu`` ``tds_pgs_*_warm_*``) on a CUDA
device against the port's plain versions: the forward, the backward
(x0-bar among its gradients) and the JVP (x0' among its tangents), in all
three forms of each (row per lane, blocked or linearised, streaming: n = 3,
12, 24, 33, 48, 105 and 340), float32 and float64, 0, 1 and 3 sweeps, on
random problems with x0 nonzero and some of its entries outside their
rows' bounds, at batches that fill no whole block. Float64 within 1e-12
relative; float32 within rtol 1e-5 / atol 1e-6 (x), rtol 1e-4 / atol 1e-5
max|grad| (the backward), rtol 1e-5 / atol 1e-6 max|x'| (the JVP), held to
the plain versions run in float64 on the same float32 operands (from a
warm start the float32 plain sweep's own rounding exceeds those
tolerances at n >= 48, where the blocked kernels sum in double). Then the
public path: ``mlcp.solve_pgs`` under ``torch.autograd`` and
``torch.func.jvp`` launches the warm-start kernels (the zero start's
counters do not move), and ``x0=None`` keeps the zero start's kernels,
which agree with the warm ones from x0 = 0. Every test
here needs the card and skips without one; no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pgs_warm_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.contact import mlcp, pgs  # noqa: E402

pytestmark = pytest.mark.cuda

ROWS = ((3, 37), (12, 37), (24, 37), (33, 9), (48, 9), (105, 5), (340, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PGS kernel has no CPU mode")
    return torch.device("cuda")


def _problem(batch, n, dtype, seed, device):
    """SPD A = J J^T + 1e-3 I, n / 3 contacts (normal rows, then friction rows
    bounded by +-0.5 times their normal's impulse; n / 2 normal rows when 3
    does not divide n), and x0 of standard normal draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    j = torch.randn(batch, n, 8, generator=gen, dtype=torch.float64, device=device)
    a = j @ j.transpose(-1, -2) + 1e-3 * torch.eye(n, dtype=torch.float64, device=device)
    b = torch.randn(batch, n, generator=gen, dtype=torch.float64, device=device)
    lo = torch.cat([torch.zeros(batch, n_c, device=device), torch.full((batch, n - n_c), -0.5, device=device)], -1)
    hi = torch.cat([torch.full((batch, n_c), 1e5, device=device), torch.full((batch, n - n_c), 0.5, device=device)], -1)
    x0 = torch.randn(batch, n, generator=gen, dtype=torch.float64, device=device)
    dep = tuple([-1] * n_c + [k % n_c for k in range(n - n_c)])
    return [t.to(dtype).contiguous() for t in (a, b, lo, hi, x0)], dep, gen


def _assert_within(got, want, rtol, atol, label):
    err = (got.double() - want).abs()
    assert bool(torch.isfinite(got).all()), label
    assert (err - (atol + rtol * want.abs())).max().item() <= 0, f"{label}: max |kernel - plain| {err.max().item():.3e}"


@pytest.mark.parametrize("iterations", (0, 1, 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("n,batch", ROWS)
def test_warm_kernels_match_the_plain_versions(cuda_device, n, batch, dtype, iterations):
    ops, dep, gen = _problem(batch, n, dtype, 1000 * n + iterations, cuda_device)
    a, b, lo, hi, x0 = ops
    plain = [t.double() for t in ops]
    f32 = dtype == torch.float32
    x = pgs._launch(a, b, lo, hi, dep, iterations, x0)
    _assert_within(x, pgs.solve_pgs_reference(*plain[:4], dep, iterations, plain[4]),
                   *((1e-5, 1e-6) if f32 else (1e-12, 1e-12)), "x")
    if iterations == 0:
        assert torch.equal(x, x0)
    x_bar = torch.randn(b.shape, generator=gen, dtype=dtype, device=cuda_device)
    grads = pgs._launch_backward(a, b, lo, hi, dep, iterations, x, x_bar, x0)
    inputs = [t.clone().requires_grad_() for t in plain]
    want = torch.autograd.grad(pgs.solve_pgs_reference(*inputs[:4], dep, iterations, inputs[4]), inputs, x_bar.double(),
                               allow_unused=True, materialize_grads=True)
    for name, g, w in zip(("A", "b", "lo", "hi", "x0"), grads, want):
        scale = w.abs().max().item()
        _assert_within(g, w, *((1e-4, 1e-5 * scale) if f32 else (1e-12, 1e-12 * scale)), f"{name}-bar")
    tangents = [torch.randn(t.shape, generator=gen, dtype=dtype, device=cuda_device) for t in ops]
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, iterations, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, iterations, x0, tangents[4])
    scale = max(1.0, want_dot.abs().max().item())
    _assert_within(got_x, want_x, *((1e-5, 1e-6) if f32 else (1e-12, 1e-12)), "jvp x")
    _assert_within(got_dot, want_dot, *((1e-5, 1e-6 * scale) if f32 else (1e-12, 1e-12 * scale)), "x'")


def test_the_public_path_launches_the_warm_kernels(cuda_device):
    ops, dep, _ = _problem(64, 105, torch.float32, 7, cuda_device)
    a, b, lo, hi, x0 = ops
    before = (pgs.launches, pgs.backward_launches, pgs.jvp_launches)
    pgs.warm_launches = pgs.warm_backward_launches = pgs.warm_jvp_launches = 0
    start = x0.clone().requires_grad_()
    x = mlcp.solve_pgs(a, b, lo, hi, dep, start, 2)
    (g,) = torch.autograd.grad(x.sum(), start)
    _, x_dot = torch.func.jvp(lambda s: mlcp.solve_pgs(a, b, lo, hi, dep, s, 2), (x0,), (torch.ones_like(x0),))
    torch.cuda.synchronize()
    # the backward relaunches the forward at 1 sweep to recover x after it
    assert pgs.warm_launches >= 2 and pgs.warm_backward_launches == 1 and pgs.warm_jvp_launches == 1
    assert (pgs.launches, pgs.backward_launches, pgs.jvp_launches) == before
    plain = x0.double().requires_grad_()
    want = torch.autograd.grad(pgs.solve_pgs_reference(*(t.double() for t in (a, b, lo, hi)), dep, 2, plain).sum(), plain)[0]
    _assert_within(g, want, 1e-4, 1e-5 * want.abs().max().item(), "x0-bar")
    assert bool(torch.isfinite(x_dot).all())


def test_the_zero_start_is_unchanged(cuda_device):
    """x0=None runs the zero start's instances (an x0 of zeros the warm
    ones): each form equal to the warm instances from x0 = 0, the zero
    start's counter moved."""
    for n, batch in ROWS:
        for dtype in (torch.float32, torch.float64):
            (a, b, lo, hi, _), dep, _ = _problem(batch, n, dtype, n, cuda_device)
            before = pgs.launches
            cold = pgs.solve_pgs(a, b, lo, hi, dep, 2)
            assert pgs.launches == before + 1
            warm = pgs.solve_pgs(a, b, lo, hi, dep, 2, x0=torch.zeros_like(b))
            rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (1e-12, 1e-12)
            _assert_within(warm, cold.double(), rtol, atol, f"n={n} {dtype}")
