"""K1's warm-start instances (``csrc/pgs.cu`` ``tds_pgs_*_warm_*``) on a CUDA
device against the port's plain versions: the forward, the backward
(x0-bar among its gradients, on the sweeps the saving forward stored) and
the JVP (x0' among its tangents), in all
three forms of each (row per lane, blocked or linearised, streaming: n = 3,
12, 24, 33, 48, 105 and 340), float32 and float64, 0, 1, 3, 4 and 10 sweeps,
on random problems with x0 nonzero and some of its entries outside their
rows' bounds, at batches that fill no whole block; the forward and the JVP
again with envs at the kinks (every normal impulse pulled to 0, and b =
x0 = 0), and the float32 row per lane form at n = 24 on 4096 envs, on
its own problem and on ``tools/pgs_ab.py --warm``'s (where its float32
instances lay past the tolerance until their sums ran in double).
Float64 within 1e-12
relative; float32 within rtol 1e-5 / atol 1e-6 (x), rtol 1e-4 / atol 1e-5
max|grad| (the backward), rtol 1e-5 / atol 1e-6 max|x'| (the JVP), held to
the plain versions run in float64 on the same float32 operands (from a
warm start the float32 plain sweep's own rounding exceeds those
tolerances at n >= 48, where the blocked kernels sum in double). Then the
public path: ``mlcp.solve_pgs`` under ``torch.autograd`` and
``torch.func.jvp`` launches the warm-start kernels (one forward for the
gradient, which saves its sweep, and one for the JVP's x; the zero start's
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


@pytest.mark.parametrize("iterations", (0, 1, 3, 4, 10))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("n,batch", ROWS)
def test_warm_kernels_match_the_plain_versions(cuda_device, n, batch, dtype, iterations):
    ops, dep, gen = _problem(batch, n, dtype, 1000 * n + iterations, cuda_device)
    a, b, lo, hi, x0 = ops
    plain = [t.double() for t in ops]
    f32 = dtype == torch.float32
    x, xs = pgs._launch(a, b, lo, hi, dep, iterations, x0, save=True)
    _assert_within(x, pgs.solve_pgs_reference(*plain[:4], dep, iterations, plain[4]),
                   *((1e-5, 1e-6) if f32 else (1e-12, 1e-12)), "x")
    if iterations == 0:
        assert torch.equal(x, x0)
    x_bar = torch.randn(b.shape, generator=gen, dtype=dtype, device=cuda_device)
    grads = pgs._launch_backward(a, b, lo, hi, dep, iterations, x, x_bar, x0, xs)
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


@pytest.mark.parametrize("iterations", (1, 3, 10))
@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("n,batch", ROWS)
def test_warm_forward_and_jvp_at_the_kinks(cuda_device, n, batch, dtype, iterations):
    """The warm forward and JVP with env 1's normal rows pulled apart (its
    normal impulses 0 after the first sweep, its friction rows then at
    s = max(0, 0) and lo s = hi s = 0) and env 2 at b = x0 = 0 (every row
    on its bound from the start), against the plain versions in float64 at
    the tolerances above."""
    ops, dep, gen = _problem(batch, n, dtype, 2000 * n + iterations, cuda_device)
    a, b, lo, hi, x0 = ops
    normals = [i for i, d in enumerate(dep) if d < 0]
    b[1, normals] = -10.0 * b[1, normals].abs() - 50.0 * a[1][normals][:, normals].abs().sum(-1) - 1.0
    b[2] = 0.0
    x0[2] = 0.0
    plain = [t.double() for t in ops]
    f32 = dtype == torch.float32
    x = pgs._launch(a, b, lo, hi, dep, iterations, x0)
    want = pgs.solve_pgs_reference(*plain[:4], dep, iterations, plain[4])
    _assert_within(x, want, *((1e-5, 1e-6) if f32 else (1e-12, 1e-12)), "x")
    assert bool((want[2] == 0).all()) and bool((want[1, normals] == 0).all())
    tangents = [torch.randn(t.shape, generator=gen, dtype=dtype, device=cuda_device) for t in ops]
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, iterations, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, iterations, x0, tangents[4])
    scale = max(1.0, want_dot.abs().max().item())
    _assert_within(got_x, want_x, *((1e-5, 1e-6) if f32 else (1e-12, 1e-12)), "jvp x")
    _assert_within(got_dot, want_dot, *((1e-5, 1e-6 * scale) if f32 else (1e-12, 1e-12 * scale)), "x'")


def test_warm_row_per_lane_float32_at_a_paths_batch(cuda_device):
    """The float32 warm forward and JVP at n = 24 on 4096 envs (the row per
    lane form at a path's batch, whose tail of rounding errors B = 37 does
    not reach), one sweep, against the plain versions in float64 at the
    tolerances above."""
    ops, dep, gen = _problem(4096, 24, torch.float32, 24_4096, cuda_device)
    a, b, lo, hi, x0 = ops
    plain = [t.double() for t in ops]
    _assert_within(pgs._launch(a, b, lo, hi, dep, 1, x0), pgs.solve_pgs_reference(*plain[:4], dep, 1, plain[4]),
                   1e-5, 1e-6, "x")
    tangents = [torch.randn(t.shape, generator=gen, dtype=torch.float32, device=cuda_device) for t in ops]
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, 1, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, 1, x0, tangents[4])
    _assert_within(got_x, want_x, 1e-5, 1e-6, "jvp x")
    _assert_within(got_dot, want_dot, 1e-5, 1e-6 * max(1.0, want_dot.abs().max().item()), "x'")


def test_the_float32_warm_fault_problem(cuda_device):
    """tools/pgs_ab.py --warm's and --jvp --warm's problem at n = 24, B =
    4096 (its random cases from seed 0, the float32 one at n = 24), where
    the float32 row-per-lane warm forward lay 1.94e-6 from the plain
    version in float64 in x and its JVP 3.2e-6 in x', past the tolerances
    (float sums from x0): within rtol 1e-5, atol 1e-6 (max|x'|) now."""
    from tds_tpu_torch.tools import pgs_ab

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    kernel = next(c for c in pgs_ab.random_cases("jvp", (12, 24, 48, 105), None, 1, True, gen) if c[0] == 24)[3][0]
    (a, b, lo, hi, x0), dep, tangents = kernel.operands, tuple(kernel.dep), kernel.tangents
    assert b.shape == (4096, 24) and b.dtype == torch.float32 and pgs.form(b.dtype, 24, warm=True) == "row per lane"
    plain = [t.double() for t in kernel.operands]
    _assert_within(pgs._launch(a, b, lo, hi, dep, 1, x0), pgs.solve_pgs_reference(*plain[:4], dep, 1, plain[4]),
                   1e-5, 1e-6, "x")
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, 1, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, 1, x0, tangents[4])
    _assert_within(got_x, want_x, 1e-5, 1e-6, "jvp x")
    _assert_within(got_dot, want_dot, 1e-5, 1e-6 * max(1.0, want_dot.abs().max().item()), "x'")


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
    # the gradient's forward saves its sweep for the backward (no relaunch); the JVP's primal is a forward too
    assert pgs.warm_launches == 2 and pgs.warm_backward_launches == 1 and pgs.warm_jvp_launches == 1
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
