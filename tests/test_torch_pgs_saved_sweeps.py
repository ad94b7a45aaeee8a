"""K1's saved sweeps on the CPU: what the card's forward stores for its
backward, and when the wrapper asks for it.

- The plain version of the saving forward
  (``contact.pgs.solve_pgs_sweeps_reference``: x after each sweep) against
  the JAX package's x after sweep t (its ``tds_tpu.contact.mlcp.solve_pgs``
  for one sweep from x after sweep t - 1), at every t = 1 .. T, float64
  within 1e-12 relative, from x = 0 and from a
  warm start x0, n = 3, 12 and 40, T = 1, 2, 4 and 10, on a batch with a
  random env, an env at zero normal impulse and an env with b = 0.
- The wrapper's decision to save (``contact.pgs.saves_sweeps``, which
  ``solve_pgs`` takes on the card) on CPU tensors: not for one sweep, not
  under ``torch.no_grad()``, not for operands without grad, not under
  ``torch.func.jvp``, ``jacfwd`` or ``vmap``; yes under autograd and under
  ``torch.func.grad``, ``vjp``, ``jacrev`` and ``vmap`` of ``grad``.
- Through ``PGSFunction`` (``solve_pgs``'s card path) with CPU stand-ins for
  the launches: a gradient past one sweep launches the forward once, saving,
  and the backward once on the sweeps it saved, the sweeps folded into the
  batch under ``vmap`` of ``grad`` as the operands are, the gradients equal
  to the plain version's autograd; the backward past one sweep refuses to
  run without saved sweeps.
- ``tools/pgs_ab.py``'s ``plain_forward_along``, which holds a float32
  forward's sweeps row by row along its own trajectory: the plain sweeps
  lie on it, the float32 plain ones (sums in float32) within their
  rounding, a forward that sums in double as the saving instances do
  within its 4-ulp margin, a moved one past either.

Small batches on one thread: a few seconds in all.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread, and the JAX package's sweep compiled without
    XLA's optimisation passes (its compile is most of this file's time;
    its results agree to rounding)."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)


def _problem(n, seed):
    """Numpy (a, b, lo, hi, x0, dep) of 3 envs with n rows, n // 3 normal
    rows (at least one) then friction rows bounded by +-0.5 times their
    normal's impulse: env 0 random, env 1 with every normal row pulled
    below its bound (x_n = 0, the friction rows at s = 0), env 2 with
    b = 0; x0 of normal draws, some outside their rows' bounds."""
    rng = np.random.default_rng(seed)
    bsz, n_c = 3, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))
    b = rng.normal(size=(bsz, n))
    b[1, :n_c] = -10.0 * np.abs(b[1, :n_c]) - 50.0 * np.abs(a[1, :n_c, :n_c]).sum(-1) - 1.0
    b[2] = 0.0
    lo = np.broadcast_to(np.where(np.arange(n) < n_c, 0.0, -0.5), (bsz, n)).copy()
    hi = np.broadcast_to(np.where(np.arange(n) < n_c, 1e5, 0.5), (bsz, n)).copy()
    x0 = rng.normal(size=(bsz, n))
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    return a, b, lo, hi, x0, dep


@functools.lru_cache(maxsize=None)
def _jax_sweeps(n, warm):
    """The JAX package's x after each of 10 sweeps: its solve_pgs for one
    sweep from x0 (or 0), then from each sweep's x (the unrolled sweep's
    loop body, jitted once for the row count)."""
    a, b, lo, hi, x0, dep = _problem(n, n)
    sweep = jax.jit(lambda a, b, lo, hi, x: j_solve_pgs(a, b, lo, hi, dep, x, 1))
    x, out = jnp.asarray(x0 if warm else np.zeros_like(b)), []
    for _ in range(10):
        x = sweep(*(jnp.asarray(v) for v in (a, b, lo, hi)), x)
        out.append(np.asarray(x))
    return out


@pytest.mark.parametrize("warm", [False, True], ids=["zero start", "from x0"])
@pytest.mark.parametrize("iterations", [1, 2, 4, 10])
@pytest.mark.parametrize("n", [3, 12, 40])
def test_plain_saved_sweeps_match_the_jax_package_at_every_sweep(n, iterations, warm):
    a, b, lo, hi, x0, dep = _problem(n, n)
    operands = [torch.from_numpy(v) for v in (a, b, lo, hi)]
    sweeps = pgs.solve_pgs_sweeps_reference(*operands, dep, iterations, torch.from_numpy(x0) if warm else None)
    assert sweeps.shape == (iterations, 3, n)
    for t in range(1, iterations + 1):
        want = _jax_sweeps(n, warm)[t - 1]
        np.testing.assert_allclose(sweeps[t - 1].numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    # the last is what the plain forward returns, bit for bit
    assert torch.equal(sweeps[-1], pgs.solve_pgs_reference(*operands, dep, iterations,
                                                           torch.from_numpy(x0) if warm else None))


def _operands(n=6, warm=False):
    a, b, lo, hi, x0, dep = _problem(n, 7)
    ops = [torch.from_numpy(v) for v in (a, b, lo, hi)] + [torch.from_numpy(x0) if warm else None]
    return ops, dep


def _decisions(fn, iterations=3):
    """What saves_sweeps decides on the operands ``fn`` hands it."""
    seen = []

    def probe(*ops):
        seen.append(pgs.saves_sweeps(ops, iterations))
        return ops[1].sum() * 0 + (ops[1] ** 2).sum()

    fn(probe)
    return seen


def test_the_wrapper_saves_only_when_a_backward_can_follow():
    (a, b, lo, hi, _), _ = _operands()
    grad_b = b.clone().requires_grad_()
    assert _decisions(lambda f: f(a, grad_b, lo, hi, None)) == [True]
    assert _decisions(lambda f: f(a, grad_b, lo, hi, None), iterations=1) == [False]
    assert _decisions(lambda f: f(a, b, lo, hi, None)) == [False]
    with torch.no_grad():
        assert _decisions(lambda f: f(a, grad_b, lo, hi, None)) == [False]
    assert _decisions(lambda f: torch.func.grad(lambda bb: f(a, bb, lo, hi, None))(b)) == [True]
    assert _decisions(lambda f: torch.func.grad(lambda x0: f(a, b, lo, hi, x0))(b)) == [True]
    assert _decisions(lambda f: torch.func.vjp(lambda bb: f(a, bb, lo, hi, None), b)) == [True]
    assert _decisions(lambda f: torch.func.jacrev(lambda bb: f(a, bb, lo, hi, None))(b)) == [True]
    assert _decisions(lambda f: torch.func.vmap(torch.func.grad(lambda bb: f(a, bb, lo, hi, None)))(b[None].repeat(2, 1, 1))) == [True]
    assert _decisions(lambda f: torch.func.grad(lambda bb: torch.func.vmap(lambda c: f(a, c, lo, hi, None))(bb).sum())(b[None].repeat(2, 1, 1))) == [True]
    assert _decisions(lambda f: torch.func.jvp(lambda bb: f(a, bb, lo, hi, None), (b,), (torch.ones_like(b),))) == [False]
    assert _decisions(lambda f: torch.func.jacfwd(lambda bb: f(a, bb, lo, hi, None))(b)) == [False]
    assert _decisions(lambda f: torch.func.vmap(lambda bb: f(a, bb, lo, hi, None))(b[None].repeat(2, 1, 1))) == [False]


class _Kernels:
    """CPU stand-ins for K1's launches (the plain versions), recording each
    forward's start and whether it saved, and each backward's sweeps."""

    def __init__(self):
        self.calls = []

    def forward(self, a, b, lo, hi, dep, it, x0=None, save=False):
        self.calls.append(("forward", b.shape[0], save))
        sweeps = pgs.solve_pgs_sweeps_reference(a, b, lo, hi, dep, it, x0)
        return (sweeps[-1], sweeps[:-1].contiguous()) if save else sweeps[-1]

    def jvp(self, a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, it, x0=None, x0_dot=None):
        self.calls.append(("jvp", b.shape[0], False))
        tangents = (a_dot, b_dot, lo_dot, hi_dot) + (() if x0 is None else (x0_dot,))
        return pgs.solve_pgs_jvp_reference(a, b, lo, hi, tangents, dep, it, x0)

    def backward(self, a, b, lo, hi, dep, it, x, x_bar, x0=None, xs=None):
        # the saved sweeps are the forward's on the same envs, in the same order
        assert torch.equal(torch.cat([xs, x[None]]), pgs.solve_pgs_sweeps_reference(a, b, lo, hi, dep, it, x0))
        self.calls.append(("backward", b.shape[0], True))
        inputs = [t.detach().requires_grad_() for t in (a, b, lo, hi) + (() if x0 is None else (x0,))]
        with torch.enable_grad():
            out = pgs.solve_pgs_reference(*inputs[:4], dep, it, inputs[4] if x0 is not None else None)
            return torch.autograd.grad(out, inputs, x_bar)


@pytest.fixture
def kernels(monkeypatch):
    k = _Kernels()
    monkeypatch.setattr(pgs, "_launch", k.forward)
    monkeypatch.setattr(pgs, "_launch_jvp", k.jvp)
    monkeypatch.setattr(pgs, "_launch_backward", k.backward)
    yield k.calls


@pytest.mark.parametrize("warm", [False, True], ids=["zero start", "from x0"])
def test_a_gradient_launches_one_saving_forward_and_one_backward(kernels, warm):
    (a, b, lo, hi, x0), dep = _operands(warm=warm)
    dep = tuple(dep)

    def kernel(bb, start):
        return pgs._solve_kernel(a, bb, lo, hi, dep, 4, start)

    def plain(bb, start):
        return pgs.solve_pgs_reference(a, bb, lo, hi, dep, 4, start)

    def close(got, want):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * want.abs().max().item())

    x_bar = torch.from_numpy(np.random.default_rng(3).normal(size=b.shape))
    inputs = [b.clone().requires_grad_()] + ([x0.clone().requires_grad_()] if warm else [])
    got = torch.autograd.grad(kernel(inputs[0], inputs[1] if warm else None), inputs, x_bar)
    ref = [t.detach().clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(plain(ref[0], ref[1] if warm else None), ref, x_bar)
    for g, w in zip(got, want):
        close(g, w)
    assert kernels == [("forward", 3, True), ("backward", 3, True)]
    kernels.clear()
    start = x0 if warm else None
    close(torch.func.grad(lambda bb: (kernel(bb, start) * x_bar).sum())(b),
          torch.func.grad(lambda bb: (plain(bb, start) * x_bar).sum())(b))
    assert kernels == [("forward", 3, True), ("backward", 3, True)]
    # per-sample gradients: the saved sweeps unfolded from the batch and folded back with the operands
    kernels.clear()
    batch = b + torch.from_numpy(np.random.default_rng(4).normal(size=(2,) + tuple(b.shape)))
    close(torch.func.vmap(torch.func.grad(lambda bb: (kernel(bb, start) * x_bar).sum()))(batch),
          torch.stack([torch.func.grad(lambda bb: (plain(bb, start) * x_bar).sum())(c) for c in batch]))
    assert kernels == [("forward", 6, True), ("backward", 6, True)]
    kernels.clear()
    with torch.no_grad():
        kernel(inputs[0], inputs[1] if warm else None)
    torch.func.jvp(lambda bb: kernel(bb, start), (b,), (x_bar,))
    assert kernels == [("forward", 3, False), ("forward", 3, False), ("jvp", 3, False)]


def test_the_backward_past_one_sweep_needs_the_saved_sweeps():
    (a, b, lo, hi, _), dep = _operands()
    x = pgs.solve_pgs_reference(a, b, lo, hi, dep, 3)
    with pytest.raises(ValueError, match="saved sweeps"):
        pgs._launch_backward(a, b, lo, hi, tuple(dep), 3, x, torch.ones_like(x))
    with pytest.raises(ValueError, match="saved sweeps"):
        pgs._launch_backward(a, b, lo, hi, tuple(dep), 3, x, torch.ones_like(x), xs=x[None])


@pytest.mark.parametrize("n", [12, 24])
def test_plain_forward_along_holds_each_rows_rounding(n):
    """tools/pgs_ab.py's plain_forward_along (the check of a float32
    forward's saved sweeps row by row along its own trajectory): the plain
    version's own sweeps lie on it, the float32 plain version's (sums in
    float32) within their rounding, and a sweep moved by 1e-3 in one
    element past it."""
    from tds_tpu_torch.tools import pgs_ab

    a, b, lo, hi, x0, dep = _problem(n, 11)
    ops = [torch.from_numpy(v) for v in (a, b, lo, hi, x0)]
    sweeps = pgs.solve_pgs_sweeps_reference(*ops[:4], dep, 4, ops[4])
    err, over = pgs_ab.plain_forward_along(ops, dep, sweeps, double_sums=True)
    assert err < 1e-12 and over < 0
    f32 = pgs.solve_pgs_sweeps_reference(*(t.float() for t in ops[:4]), dep, 4, ops[4].float())
    assert pgs_ab.plain_forward_along(ops, dep, f32, double_sums=False)[1] < 0
    moved = sweeps.clone()
    moved[2, 0, n // 2] += 1e-3
    assert pgs_ab.plain_forward_along(ops, dep, moved, double_sums=False)[1] > 0


def _double_summed_sweeps(ops, dep, iterations):
    """x after each sweep of a float32 forward that sums each row in double
    and rounds its update once, as K1's saving instances do: the row's
    remainder b_i - sum_{j != i} A_ij x_j in float64 from float32 x,
    rounded to float32 and times 1 / A_ii in float32, then clipped to its
    bounds in float32."""
    a, b, lo, hi, x0 = ops
    a32, lo32, hi32 = a.float(), lo.float(), hi.float()
    x, out = x0.float().clone(), []
    for _ in range(iterations):
        for i in range(b.shape[1]):
            terms = a32[:, i, :].double() * x.double()
            rem = (b.float()[:, i].double() - (terms.sum(-1) - terms[:, i])).float()
            u = rem * (1.0 / a32[:, i, i])
            s = torch.clamp(x[:, dep[i]], min=0.0) if dep[i] >= 0 else torch.ones_like(u)
            x[:, i] = torch.minimum(torch.maximum(u, lo32[:, i] * s), hi32[:, i] * s)
        out.append(x.clone())
    return torch.stack(out)


@pytest.mark.parametrize("n", [12, 24, 40])
def test_plain_forward_along_holds_a_double_summed_forward_to_4_ulps(n):
    """plain_forward_along with ``double_sums`` (the saving instances'
    margin, 4 float32 ulps of the row's size): a float32 forward that sums
    in double lies within it on float32 operands, and the same sweeps with
    one element moved by 1e-3 past it."""
    from tds_tpu_torch.tools import pgs_ab

    a, b, lo, hi, x0, dep = _problem(n, 12)
    ops = [torch.from_numpy(v).float().double() for v in (a, b, lo, hi, x0)]
    sweeps = _double_summed_sweeps(ops, dep, 4)
    assert torch.isfinite(sweeps).all()
    assert pgs_ab.plain_forward_along(ops, dep, sweeps, double_sums=True)[1] < 0
    moved = sweeps.clone()
    moved[1, 0, n // 2] += 1e-3
    assert pgs_ab.plain_forward_along(ops, dep, moved, double_sums=True)[1] > 0
