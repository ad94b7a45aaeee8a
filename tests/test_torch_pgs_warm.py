"""PGS from a warm start on the CPU, float64, against the JAX package's
``tds_tpu.contact.mlcp.solve_pgs`` (which always takes one), within 1e-12
relative:

- ``tds_tpu_torch.contact.mlcp.solve_pgs(a, b, lo, hi, dep, x0, iterations)``
  at n = 3, 12, 24 and 48 rows, 1 and 3 sweeps: its values, its
  vector-Jacobian product with respect to all five operands (``jax.vjp``,
  so ``jax.grad`` of any loss) and its Jacobian-vector product (``jax.jvp``)
  with tangents of all five; x0 nonzero, some of its entries outside their
  rows' bounds, on the problems of tests/test_torch_pgs_grad.py (random
  envs, envs at zero normal impulse, envs with b = 0);
- the card path's plumbing (``PGSFunction``, ``PGSJVP``, ``PGSBackward``
  and their vmap rules) with CPU stand-ins for K1's warm-start launches:
  x0-bar reaches x0, x0' enters the JVP, ``jacfwd``, ``jacrev`` and
  ``vmap`` over x0 give the plain version's;
- ``x0=None`` is the zero start, and a zero x0 gives the same x.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu_torch.contact import mlcp, pgs  # noqa: E402

RTOL = 1e-12
ROWS, SWEEPS = (3, 12, 24, 48), (1, 3)


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread, and the JAX package's eager operations compiled
    without XLA's optimisation passes (their compiles are most of this
    file's time; the results agree to rounding)."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # the caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)


def _problem(n, seed, kind):
    """tests/test_torch_pgs_grad.py's problems: a batch of 4 envs, n / 3
    contacts (normal rows, then two friction rows each, bounded by +-0.5
    times the normal impulse), A not symmetric; with 'ties' env 1 at zero
    normal impulse and env 2 with b = 0."""
    rng = np.random.default_rng(seed)
    bsz, n_c = 4, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))
    b = rng.normal(size=(bsz, n))
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    is_normal = np.arange(n) < n_c
    lo = np.broadcast_to(np.where(is_normal, 0.0, -0.5), (bsz, n)).copy()
    hi = np.broadcast_to(np.where(is_normal, 1e5, 0.5), (bsz, n)).copy()
    if kind == "ties":
        b[1, :n_c] = -10.0 * np.abs(b[1, :n_c]) - 1.0 - 50.0 * np.abs(a[1, :n_c, :n_c]).sum(-1)
        b[2] = 0.0
    return a, b, lo, hi, dep


def _warm_problem(n, kind):
    """The operands of tests/test_torch_pgs_grad.py's problem, the
    cotangent and tangents, and x0: normal draws of scale 2, so that some
    entries lie below a normal row's 0 or outside a friction row's
    +-0.5 x_n."""
    a, b, lo, hi, dep = _problem(n, n + 1, kind)
    rng = np.random.default_rng(100 + n)
    x0 = 2.0 * rng.normal(size=b.shape)
    x_bar = rng.normal(size=b.shape)
    tangents = [rng.normal(size=v.shape) for v in (a, b, lo, hi, x0)]
    return (a, b, lo, hi, x0), dep, x_bar, tangents


@functools.lru_cache(maxsize=None)
def _jax_case(n, kind, iterations):
    """x, the VJP's five gradients and the JVP's x' of the JAX package,
    eagerly (a jit of the unrolled rows compiles longer than its eager ops
    take)."""
    operands, dep, x_bar, tangents = _warm_problem(n, kind)

    def solve(a, b, lo, hi, x0):
        return j_solve_pgs(a, b, lo, hi, dep, x0, iterations)

    args = tuple(jnp.asarray(v) for v in operands)
    x, vjp = jax.vjp(solve, *args)
    _, x_dot = jax.jvp(solve, args, tuple(jnp.asarray(t) for t in tangents))
    return np.asarray(x), [np.asarray(g) for g in vjp(jnp.asarray(x_bar))], np.asarray(x_dot)


def _close(got, want, label):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=label)


@pytest.mark.parametrize("iterations", SWEEPS)
@pytest.mark.parametrize("n", ROWS)
def test_mlcp_solve_pgs_matches_jax(n, iterations):
    """Values, the VJP in all five operands and the JVP with tangents of all
    five against the JAX package's, on a batch with a random env and the
    tie envs."""
    operands, dep, x_bar, tangents = _warm_problem(n, "ties")
    want_x, want_grads, want_dot = _jax_case(n, "ties", iterations)
    outside = (operands[4] < operands[2]) | (operands[4] > np.abs(operands[3]).min())
    assert outside.any() and (operands[4] != 0).all()
    inputs = [torch.tensor(v, requires_grad=True) for v in operands]
    x = mlcp.solve_pgs(*inputs[:4], dep, inputs[4], iterations)
    _close(x, want_x, "x")
    grads = torch.autograd.grad(x, inputs, torch.from_numpy(x_bar))
    for name, g, w in zip(("A", "b", "lo", "hi", "x0"), grads, want_grads):
        _close(g, w, f"{name}-bar")
    assert np.abs(want_grads[4]).max() > 0
    _, x_dot = torch.func.jvp(lambda *t: mlcp.solve_pgs(*t[:4], dep, t[4], iterations),
                              tuple(torch.from_numpy(v) for v in operands), tuple(torch.from_numpy(t) for t in tangents))
    _close(x_dot, want_dot, "x'")


def test_mlcp_solve_pgs_keeps_leading_dims():
    """The JAX package's leading dims: the batch of 4 as (2, 2), folded into
    one batch and back, gives the JAX package's x."""
    operands, dep, _, _ = _warm_problem(12, "ties")
    t = [torch.from_numpy(v).reshape((2, 2) + v.shape[1:]) for v in operands]
    x = mlcp.solve_pgs(*t[:4], dep, t[4], 1)
    assert x.shape == (2, 2, 12)
    _close(x.reshape(4, 12), _jax_case(12, "ties", 1)[0], "x")


def test_zero_start_is_x0_none():
    """x0=None runs the zero start; an x0 of zeros gives the same x bit for
    bit, and a nonzero one another."""
    (a, b, lo, hi, x0), dep, _, _ = _warm_problem(12, "random")
    t = [torch.from_numpy(v) for v in (a, b, lo, hi, x0)]
    cold = pgs.solve_pgs(*t[:4], dep, 2)
    assert torch.equal(cold, pgs.solve_pgs(*t[:4], dep, 2, x0=torch.zeros_like(t[1])))
    assert not torch.equal(cold, pgs.solve_pgs(*t[:4], dep, 2, x0=t[4]))


# -- the card path's rules with CPU stand-ins for the warm launches ---------
class _WarmKernels:
    """K1's launches as the plain versions on plain tensors, counted by
    kind, each with the warm start the rules pass on."""

    def __init__(self):
        self.calls = []

    def forward(self, a, b, lo, hi, dep, it, x0=None):
        self.calls.append(("forward", b.shape[0], x0 is not None))
        return pgs.solve_pgs_reference(a, b, lo, hi, dep, it, x0)

    def jvp(self, a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, it, x0=None, x0_dot=None):
        self.calls.append(("jvp", b.shape[0], x0 is not None))
        tangents = (a_dot, b_dot, lo_dot, hi_dot) + (() if x0 is None else (x0_dot,))
        return pgs.solve_pgs_jvp_reference(a, b, lo, hi, tangents, dep, it, x0)

    def backward(self, a, b, lo, hi, dep, it, x, x_bar, x0=None):
        self.calls.append(("backward", b.shape[0], x0 is not None))
        inputs = [t.detach().requires_grad_() for t in (a, b, lo, hi) + (() if x0 is None else (x0,))]
        with torch.enable_grad():
            x = pgs.solve_pgs_reference(*inputs[:4], dep, it, inputs[4] if x0 is not None else None)
            return torch.autograd.grad(x, inputs, x_bar)


@pytest.fixture
def warm_kernels(monkeypatch):
    kernels = _WarmKernels()
    monkeypatch.setattr(pgs, "_launch", kernels.forward)
    monkeypatch.setattr(pgs, "_launch_jvp", kernels.jvp)
    monkeypatch.setattr(pgs, "_launch_backward", kernels.backward)
    yield kernels.calls


def test_pgs_function_carries_the_warm_start(warm_kernels):
    """Through PGSFunction (what solve_pgs runs on the card): x0-bar from
    the backward, x0' in the JVP, jacfwd and jacrev in x0 (the basis folded
    into the batch by the vmap rules), vmap over x0; each launch takes the
    warm start."""
    (a, b, lo, hi, x0), dep, x_bar, tangents = _warm_problem(12, "ties")
    a, b, lo, hi, x0 = (torch.from_numpy(v) for v in (a, b, lo, hi, x0))
    dep = tuple(dep)

    def kernel(x0, bb):
        return pgs.PGSFunction.apply(a, bb, lo, hi, dep, 2, x0)

    def plain(x0, bb):
        return pgs.solve_pgs_reference(a, bb, lo, hi, dep, 2, x0)

    inputs = [x0.clone().requires_grad_(), b.clone().requires_grad_()]
    got = torch.autograd.grad(kernel(*inputs), inputs, torch.from_numpy(x_bar))
    ref = [x0.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(plain(*ref), ref, torch.from_numpy(x_bar))
    for g, w in zip(got, want):
        _close(g, w.numpy(), "grad")
    assert warm_kernels == [("forward", 4, True), ("backward", 4, True)]
    t = (torch.from_numpy(tangents[4]), torch.from_numpy(tangents[1]))
    _close(torch.func.jvp(kernel, (x0, b), t)[1], torch.func.jvp(plain, (x0, b), t)[1].numpy(), "x'")
    warm_kernels.clear()
    jac = torch.func.jacfwd(kernel, argnums=(0, 1))(x0, b)
    assert warm_kernels == [("forward", 4, True), ("jvp", 4 * 2 * 48, True)]
    want = torch.func.jacfwd(plain, argnums=(0, 1))(x0, b)
    for g, w in zip(jac, want):
        _close(g, w.numpy(), "jacfwd")
    assert want[0].abs().max() > 0
    warm_kernels.clear()
    for g, w in zip(torch.func.jacrev(kernel, argnums=(0, 1))(x0, b), want):
        _close(g, w.numpy(), "jacrev")
    assert warm_kernels == [("forward", 4, True), ("backward", 4 * 48, True)]
    starts = x0 + torch.from_numpy(np.random.default_rng(0).normal(size=(3,) + x0.shape))
    _close(torch.func.vmap(kernel, in_dims=(0, None))(starts, b), torch.stack([plain(s, b) for s in starts]).numpy(), "vmap")
