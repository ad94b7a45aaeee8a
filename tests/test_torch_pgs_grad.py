"""Gradients of the port's PGS (``contact/pgs.py``) against ``jax.grad`` of
the JAX package's unrolled sweep (``tds_tpu.contact.mlcp.solve_pgs``),
float64 on the CPU, within 1e-12 relative.

Both take the vector-Jacobian product with the same cotangent of x, so
every entry of the gradients of A, b, lo and hi is compared. The problems
are tests/test_pallas_pgs.py's (normal rows, then two friction rows per
contact bounded by +-0.5 times the normal impulse), at n = 3, 12, 24 and
48 rows, one and two sweeps, and at n = 3 and 12 with 4 and 10 sweeps (the
ball loss's 4, the Panda push's 10), in batches that hold:

- random envs, away from every tie;
- envs whose normal impulses are all exactly 0 (b pushes them below their
  bound), so each friction row's s = max(x_n, 0) sits at its kink and its
  bounds at lo s = hi s = 0;
- envs with x = b = 0 everywhere (no toe on the ground), where every row's
  value sits on its bound.

At a tie ``jnp.maximum`` and ``jnp.clip`` pass half the gradient to each
side; ``torch.clamp`` and ``clamp_min``, which the plain version used
before, pass all of it to x, and fail the tie cases. On problems away from
the kinks ``torch.autograd.gradcheck`` holds the plain version's gradient
against its own finite differences.

The plain backward along a kernel's own sweeps (``tools/pgs_ab.py``'s
``plain_backward_along``, which the card's checks hold a float32 backward
to) is held to the same JAX results on the plain version's own sweeps, and
its flag of the clips near a tie to a problem built with one.

Plain models of the order in which ``csrc/pgs.cu`` computes (the blocked
forward of n > 32 and the linearised backward of every n, rows in blocks
of 32) are held to the same JAX results at n = 3 to 65 (65 crosses two
block edges), with a third kind of problem whose dependencies lie after
their rows and inside their blocks.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.tools import pgs_ab  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread: its many small operations gain nothing from
    more, and the test workers' threads would contend for the cores. The
    JAX package's reference compiled without XLA's optimisation passes:
    its compiles are most of these tests' time, and its results agree to
    rounding."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)

RTOL = 1e-12


def _problem(n, seed, kind):
    """Numpy (a, b, lo, hi, dep) of a batch of 4 envs with n = 3 n_c rows
    (n = 3: one contact): 'random', or with env 1 at zero normal impulse
    and env 2 at x = b = 0 ('ties'); 'deps' is 'ties' with each contact's
    rows in the order friction, normal, friction (one row's dependency
    after it and one before it, both inside its block of 32), any rows past
    3 n_c friction rows of contact 0, and row 0 depending on the last
    contact's normal row (after it, in a later block once n > 32)."""
    rng = np.random.default_rng(seed)
    bsz, n_c = 4, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))  # not symmetric
    b = rng.normal(size=(bsz, n))
    if kind == "deps":
        normals = [3 * k + 1 for k in range(n_c)]
        dep = [3 * (i // 3) + 1 if i < 3 * n_c else 1 for i in range(n)]
        for i in normals:
            dep[i] = -1
        dep[0] = normals[-1]
    else:
        normals = list(range(n_c))
        dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    is_normal = np.isin(np.arange(n), normals)
    lo = np.broadcast_to(np.where(is_normal, 0.0, -0.5), (bsz, n)).copy()
    hi = np.broadcast_to(np.where(is_normal, 1e5, 0.5), (bsz, n)).copy()
    if kind in ("ties", "deps"):
        # env 1: every normal row pulled apart (x_n = 0 < p_n); the friction
        # rows then have s = 0 and lo s = hi s = 0
        b[1, normals] = -10.0 * np.abs(b[1, normals]) - 1.0
        b[1, normals] -= 50.0 * np.abs(a[1][np.ix_(normals, normals)]).sum(-1)
        # env 2: nothing on the ground
        b[2] = 0.0
    return a, b, lo, hi, dep


@functools.lru_cache(maxsize=None)
def _jax_case(n, seed, kind, iterations):
    """(x, [A-bar, b-bar, lo-bar, hi-bar]) of the JAX package for the case,
    shared by both port entry points. Eager: a jit of the unrolled rows
    compiles for longer than the eager ops take."""
    a, b, lo, hi, dep = _problem(n, seed, kind)
    x, vjp = jax.vjp(lambda *t: j_solve_pgs(*t, dep, jnp.zeros_like(t[1]), iterations), *(jnp.asarray(v) for v in (a, b, lo, hi)))
    return np.asarray(x), [np.asarray(g) for g in vjp(jnp.asarray(_cotangent(n, b.shape)))]


def _cotangent(n, shape):
    return np.random.default_rng(n).normal(size=shape)


def _torch_vjp(solve, a, b, lo, hi, dep, iterations, x_bar):
    inputs = [torch.tensor(v, requires_grad=True) for v in (a, b, lo, hi)]
    x = solve(*inputs, dep, iterations)
    grads = torch.autograd.grad(x, inputs, torch.from_numpy(x_bar))
    return x.detach().numpy(), [g.numpy() for g in grads]


def _assert_close(got, want, label):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=label)


# (n, sweeps): the paths' row counts at one and two sweeps, then the sweeps
# past the first that the kernels' backward takes (the ball loss's 4, the
# Panda push's 10)
SWEEP_CASES = [(n, it) for n in (3, 12, 24, 48) for it in (1, 2)] + [(n, it) for n in (3, 12) for it in (4, 10)]


@pytest.mark.parametrize("n,iterations", SWEEP_CASES)
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("solve", [pgs.solve_pgs_reference, pgs.solve_pgs], ids=["reference", "solve_pgs"])
def test_gradients_match_jax(solve, kind, n, iterations):
    seed = n + 100 * iterations
    a, b, lo, hi, dep = _problem(n, seed, kind)
    want_x, want = _jax_case(n, seed, kind, iterations)
    got_x, got = _torch_vjp(solve, a, b, lo, hi, dep, iterations, _cotangent(n, b.shape))
    _assert_close(got_x, want_x, "x")
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        _assert_close(g, w, name)


def test_the_tie_cases_hit_their_ties():
    """Env 1's normal impulses are exactly 0 after one sweep and env 2's
    whole x is 0: the cases above reach the kinks they are built for."""
    a, b, lo, hi, dep = _problem(12, seed=112, kind="ties")
    x = pgs.solve_pgs_reference(*(torch.from_numpy(v) for v in (a, b, lo, hi)), dep, 1)
    assert torch.all(x[1, :4] == 0) and torch.all(x[1, 4:] == 0)
    assert torch.all(x[2] == 0)
    assert torch.any(x[0] != 0)


def test_ties_take_half_the_gradient_like_jax():
    """One row at x = b = 0 with bounds [0, 0]: clip(0, 0, 0) passes 1/4
    to x, 1/4 to lo and 1/2 to hi, as jax.grad of jnp.clip does."""
    a, b, lo, hi = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in ([[[2.0]]], [[0.0]], [[0.0]], [[0.0]]))
    x = pgs.solve_pgs_reference(a, b, lo, hi, [-1], 1)
    ga, gb, glo, ghi = torch.autograd.grad(x.sum(), (a, b, lo, hi))
    want = jax.grad(lambda a, b, lo, hi: j_solve_pgs(a, b, lo, hi, [-1], jnp.zeros_like(b), 1).sum(), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.detach().numpy()) for t in (a, b, lo, hi))
    )
    assert [float(g) for g in (gb, glo, ghi)] == [0.125, 0.25, 0.5] == [float(w.reshape(())) for w in want[1:]]
    assert float(ga) == float(want[0].reshape(())) == 0.0


@pytest.mark.parametrize("n,iterations", [(3, 1), (6, 2), (9, 1)])
def test_gradcheck_away_from_the_kinks(n, iterations):
    """Normal impulses well above 0 and friction rows well inside their
    cone: the plain version is smooth there, and its gradient matches its
    finite differences."""
    rng = np.random.default_rng(n)
    n_c = n // 3
    j = rng.normal(size=(2, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + np.eye(n)
    b = np.concatenate([rng.uniform(5.0, 6.0, size=(2, n_c)), 0.01 * rng.normal(size=(2, n - n_c))], axis=-1)
    lo = np.concatenate([np.zeros((2, n_c)), np.full((2, n - n_c), -10.0)], axis=-1)
    hi = np.concatenate([np.full((2, n_c), 1e5), np.full((2, n - n_c), 10.0)], axis=-1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    inputs = tuple(torch.tensor(v, requires_grad=True) for v in (a, b, lo, hi))
    x = pgs.solve_pgs_reference(*inputs, dep, iterations).detach()
    assert torch.all(x[:, :n_c] > 0.1) and torch.all(x[:, n_c:].abs() < 9.0 * x[:, dep[n_c:]])  # inside the cone
    assert torch.autograd.gradcheck(lambda *t: pgs.solve_pgs_reference(*t, dep, iterations), inputs)


# -- the orders of K1's kernels for n > 32 and of its backward ---------------
# Plain models of the arithmetic that csrc/pgs.cu's warp-per-env forward and
# its backward run, in their order, held to the JAX package: the rows in
# blocks of BLOCK (a warp's lanes, lane l owning row BLOCK K + l).

BLOCK = 32


def _relu_slope(v):
    """d max(v, 0) / dv with jnp.maximum's tie rule."""
    return torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0)).to(v.dtype)


def blocked_forward(a, b, lo, hi, dep, iterations):
    """The blocked forward: for each block, each row first sums A_rj x_j
    over the columns outside the block's triangle (this sweep's x_j before
    the block, the previous sweep's after the row), then the block's rows in
    order: row r's x_r = clip((b_r - sum_r) / A_rr) is broadcast and every
    later row of the block adds A_r'r x_r. The bounds' s = max(x_dep, 0)
    reads x_dep as it stands when the row is clipped."""
    bsz, n = b.shape
    x = torch.zeros_like(b)
    inv = 1.0 / torch.diagonal(a, dim1=-2, dim2=-1)
    for _ in range(iterations):
        for k0 in range(0, n, BLOCK):
            k1 = min(k0 + BLOCK, n)
            sums = [(a[:, r, :k0] * x[:, :k0]).sum(-1) + (a[:, r, r + 1:] * x[:, r + 1:]).sum(-1) for r in range(k0, k1)]
            for r in range(k0, k1):
                p = (b[:, r] - sums[r - k0]) * inv[:, r]
                s = x[:, dep[r]].clamp_min(0.0) if dep[r] >= 0 else torch.ones_like(p)
                x[:, r] = torch.minimum(torch.maximum(p, lo[:, r] * s), hi[:, r] * s)
                for r2 in range(r + 1, k1):
                    sums[r2 - k0] = sums[r2 - k0] + a[:, r2, r] * x[:, r]
    return x


def _clip_factors(p, l, h):
    """clip(p, l, h) = min(max(p, l), h)'s adjoints of p, l and h for an
    adjoint 1 of the result, with jnp.maximum's and jnp.minimum's tie rule:
    each in {0, 1/4, 1/2, 1}."""
    m = torch.maximum(p, l)
    m_bar = torch.where(m < h, 1.0, torch.where(m > h, 0.0, 0.5)).to(p.dtype)
    h_bar = torch.where(m < h, 0.0, torch.where(m > h, 1.0, 0.5)).to(p.dtype)
    split = torch.where(p > l, 1.0, torch.where(p < l, 0.0, 0.5)).to(p.dtype)
    return m_bar * split, m_bar * (1.0 - split), h_bar


def linearised_backward(a, b, lo, hi, dep, iterations, x_bar):
    """K1's backward: for each sweep t in reverse, (a) every row's p_i, s_i
    and clip factors from x after sweeps t and t - 1 (which fix them),
    (b) the chain in reverse, blocked as the forward: g_i = x-bar_i + the
    sum over the rows i' > i of c_i' A_i'i and of the dependency terms of
    the rows whose dep is i, with c_i = -m_i g_i / A_ii, (c) A-bar's row i
    as c_i times the x that row i read (A-bar_ii = c_i p_i), b-bar, lo-bar,
    hi-bar, and the previous sweep's x-bar: the sum over i < j of c_i A_ij
    and the dependency terms of the rows whose dep is at or after them."""
    bsz, n = b.shape
    xs = [pgs.solve_pgs_reference(a, b, lo, hi, dep, t) for t in range(iterations + 1)]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    a_bar, b_bar, lo_bar, hi_bar = torch.zeros_like(a), torch.zeros_like(b), torch.zeros_like(lo), torch.zeros_like(hi)
    earlier = torch.ones(n, n, dtype=torch.bool).tril(-1)  # [i, j]: j < i, the columns row i reads from this sweep
    dep_t = torch.tensor(dep)
    has_dep = dep_t >= 0
    dep_idx = dep_t.clamp_min(0)
    for t in reversed(range(iterations)):
        x_read = torch.where(earlier, xs[t + 1][:, None, :], xs[t][:, None, :])  # (B, i, j): x_j as row i read it
        # (a)
        p = (b - (a * x_read).sum(-1) + diag * torch.diagonal(x_read, dim1=-2, dim2=-1)) / diag
        xd = torch.gather(x_read, 2, dep_idx.expand(bsz, n)[:, :, None])[:, :, 0]
        s = torch.where(has_dep, xd.clamp_min(0.0), torch.ones_like(xd))
        m, ml, mh = _clip_factors(p, lo * s, hi * s)
        f = -m / diag
        e = torch.where(has_dep, (ml * lo + mh * hi) * _relu_slope(xd), torch.zeros_like(xd))
        in_sweep = has_dep & (dep_t < torch.arange(n))
        # (b)
        g = torch.zeros_like(b)
        for k0 in reversed(range(0, n, BLOCK)):
            k1 = min(k0 + BLOCK, n)
            later = slice(k1, n)
            c_later, d_later = f[:, later] * g[:, later], e[:, later] * g[:, later]
            acc = x_bar[:, k0:k1] + (c_later[:, :, None] * a[:, later, k0:k1]).sum(1)
            for i in range(k1, n):
                if in_sweep[i] and k0 <= dep[i] < k1:
                    acc[:, dep[i] - k0] += d_later[:, i - k1]
            for r in reversed(range(k0, k1)):
                g[:, r] = acc[:, r - k0]
                w = f[:, r, None] * a[:, r, k0:r]
                if in_sweep[r] and dep[r] >= k0:
                    w[:, dep[r] - k0] += e[:, r]
                acc[:, : r - k0] += w * g[:, r, None]
        # (c)
        c, d = f * g, e * g
        rows = c[:, :, None] * x_read
        rows.diagonal(dim1=-2, dim2=-1).copy_(c * p)
        a_bar += rows
        b_bar -= c
        lo_bar += ml * g * s
        hi_bar += mh * g * s
        x_bar = (c[:, :, None] * a * earlier.T).sum(1)  # sum over i < j of c_i A_ij
        for i in range(n):
            if has_dep[i] and not in_sweep[i]:
                x_bar[:, dep[i]] += d[:, i]
    return a_bar, b_bar, lo_bar, hi_bar


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("n", [3, 12, 24, 33, 48, 65])
@pytest.mark.parametrize("kind", ["random", "ties", "deps"])
def test_kernel_orders_match_jax(kind, n, iterations):
    """The blocked forward's x and the linearised backward's gradients of A,
    b, lo and hi against the JAX package's solve_pgs and its jax.vjp, in
    float64 within 1e-12 relative: n = 65 crosses two block edges; 'deps'
    puts dependencies after their rows and inside their blocks."""
    seed = n + 100 * iterations
    a, b, lo, hi, dep = (torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in _problem(n, seed, kind))
    want_x, want = _jax_case(n, seed, kind, iterations)
    _assert_close(blocked_forward(a, b, lo, hi, dep, iterations).numpy(), want_x, "x")
    got = linearised_backward(a, b, lo, hi, dep, iterations, torch.from_numpy(_cotangent(n, b.shape)))
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        _assert_close(g.numpy(), w, name)


def test_deps_problems_reach_both_sides_and_the_ties():
    """The 'deps' problems hold dependencies after their rows (in the row's
    block and, at n = 65, in a later block) and before them in the block,
    and their tie envs reach the kinks: env 1's normal impulses are 0 and
    env 2's whole x is 0."""
    a, b, lo, hi, dep = _problem(65, 1, "deps")
    assert dep[0] == 61 and dep[3] == 4 and dep[5] == 4 and dep[64] == 1
    x = pgs.solve_pgs_reference(*(torch.from_numpy(v) for v in (a, b, lo, hi)), dep, 1)
    assert torch.all(x[1, 1:63:3] == 0) and torch.all(x[2] == 0) and torch.any(x[0] != 0)


# -- the plain backward along a kernel's own sweeps --------------------------


@pytest.mark.parametrize("n,iterations", SWEEP_CASES)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_plain_backward_along_its_own_sweeps_matches_jax(kind, n, iterations):
    """``pgs_ab.plain_backward_along`` on the plain version's own sweeps in
    float64 is the plain backward: jax.vjp's gradients of A, b, lo and hi
    within 1e-12 relative, the tie envs' exact ties among them, and no env
    near a tie."""
    seed = n + 100 * iterations
    a, b, lo, hi, dep = _problem(n, seed, kind)
    ops = [torch.from_numpy(v) for v in (a, b, lo, hi)]
    xs = torch.stack([pgs.solve_pgs_reference(*ops, dep, t) for t in range(1, iterations + 1)])
    got, near = pgs_ab.plain_backward_along(ops, dep, xs, torch.from_numpy(_cotangent(n, b.shape)))
    _, want = _jax_case(n, seed, kind, iterations)
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        _assert_close(g.numpy(), w, name)
    assert near.shape == (4,) and not near.any()


def test_plain_backward_along_flags_a_clip_near_its_bound():
    """From x0 = (0, 2) on two normal rows, row 0's first update is
    b_0 - 1: 1e-7 in env 0 (near its bound 0 next to terms of size 2, where
    a float32 rounding can decide the clip), 0.5 in env 1, exactly 0 in
    env 2 (a tie, the same in every precision): only env 0 is flagged.
    Each later row reads the sweeps given: with env 0's x_0 taken as 0,
    row 1's gradient of A_10 (-x_0 c_1 / A_11) is 0."""
    a = torch.tensor([[1.0, 0.5], [0.5, 1.0]], dtype=torch.float64).expand(3, 2, 2)
    b = torch.tensor([[1.0 + 1e-7, 2.0], [1.5, 2.0], [1.0, 2.0]], dtype=torch.float64)
    lo, hi = torch.zeros(3, 2, dtype=torch.float64), torch.full((3, 2), 1e5, dtype=torch.float64)
    x0 = torch.tensor([[0.0, 2.0]] * 3, dtype=torch.float64)
    xs = pgs.solve_pgs_reference(a, b, lo, hi, [-1, -1], 1, x0)[None]
    x_bar = torch.tensor([[0.0, 1.0]] * 3, dtype=torch.float64)
    grads, near = pgs_ab.plain_backward_along([a, b, lo, hi, x0], [-1, -1], xs, x_bar)
    assert near.tolist() == [True, False, False]
    assert grads[0][0, 1, 0].item() == -xs[0, 0, 0].item() != 0.0
    along = xs.clone()
    along[0, 0, 0] = 0.0
    grads, _ = pgs_ab.plain_backward_along([a, b, lo, hi, x0], [-1, -1], along, x_bar)
    assert grads[0][0, 1, 0].item() == 0.0
