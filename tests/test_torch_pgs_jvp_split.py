"""The split of K1's forward mode (``csrc/pgs.cu``, ``tds_pgs_jvp_*``), written
as a float64 torch recurrence, against ``jax.jvp`` of the JAX package's
unrolled sweep (``tds_tpu.contact.mlcp.solve_pgs``) on the CPU, within
1e-12 relative.

Per sweep t the kernel runs (1) the primal chain over A alone, which
fixes each row's unclipped value u_i, its bound scale s_i = max(x_dep, 0)
with max'(x_dep), and the clip's factors (mp, ml, mh) with JAX's tie
rule (half to each side of a tie of ``lax.max`` or ``lax.min``); (2) off
the chain, c_i = sum_{j < i} A'_ij x_j(t) + sum_{j > i} A'_ij x_j(t - 1)
+ u_i A'_ii; (3) the tangent chain over A,
x'_i = mp (b'_i - c_i - sum_{j != i} A_ij x'_j) / A_ii + ml l'_i + mh h'_i
with l'_i = lo'_i s_i + lo_i s'_i, h'_i likewise, s'_i = x'_dep max'(x_dep),
x'_j this sweep's before the row and the previous sweep's after it. This
file holds that algebra, and JAX's tie rule under the fixed factors, to
the JAX package at n = 3, 12 and 40, 1 and 3 sweeps, from x = 0 and from
a warm start x0 (tangents of all five operands), on problems whose
friction rows depend on a normal row before them and after them, with
envs at the clip's and the bound scale's kinks. The card's kernels are
held to the plain version in ``tests/test_torch_pgs_cuda.py`` and
``tests/test_torch_pgs_warm_cuda.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread, and the JAX package's sweep compiled without
    XLA's optimisation passes (its compiles are most of this file's time;
    the results agree to rounding)."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # the caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)


def _problem(n, start):
    """Numpy operands (a, b, lo, hi, x0), tangents of all five and dep for
    a batch of 4 envs: each contact's rows in the order friction, normal,
    friction (one friction row's dependency after it, one before it), A not
    symmetric; env 1 with every normal impulse 0 (its friction rows at
    s = max(0, 0) and lo s = hi s = 0), env 2 with b = 0 (every row on a
    bound); x0 of zeros ('zero') or normal draws of scale 2 ('warm')."""
    rng = np.random.default_rng(n + (0 if start == "zero" else 1000))
    bsz, n_c = 4, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))
    b = rng.normal(size=(bsz, n))
    normals = [3 * k + 1 for k in range(n_c)]
    dep = [-1 if i in normals else (3 * (i // 3) + 1 if i < 3 * n_c else 1) for i in range(n)]
    is_normal = np.isin(np.arange(n), normals)
    lo = np.broadcast_to(np.where(is_normal, 0.0, -0.5), (bsz, n)).copy()
    hi = np.broadcast_to(np.where(is_normal, 1e5, 0.5), (bsz, n)).copy()
    b[1, normals] = -10.0 * np.abs(b[1, normals]) - 1.0 - 50.0 * np.abs(a[1][np.ix_(normals, normals)]).sum(-1)
    b[2] = 0.0
    x0 = np.zeros((bsz, n)) if start == "zero" else 2.0 * rng.normal(size=(bsz, n))
    tangents = [rng.normal(size=v.shape) for v in (a, b, lo, hi, x0)]
    if start == "zero":
        tangents[4] = np.zeros((bsz, n))
    return (a, b, lo, hi, x0), tangents, dep


def _relu_slope(v):
    """d max(v, 0) / dv with jnp.maximum's tie rule."""
    return torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0)).to(v.dtype)


def _clip_factors(p, l, h):
    """d clip(p, l, h) / d(p, l, h) for clip = min(max(p, l), h), with
    jnp.maximum's and jnp.minimum's tie rule: each in {0, 1/4, 1/2, 1}."""
    m = torch.maximum(p, l)
    mm = torch.where(m < h, 1.0, torch.where(m > h, 0.0, 0.5)).to(p.dtype)
    mh = torch.where(m < h, 0.0, torch.where(m > h, 1.0, 0.5)).to(p.dtype)
    split = torch.where(p > l, 1.0, torch.where(p < l, 0.0, 0.5)).to(p.dtype)
    return mm * split, mm * (1.0 - split), mh


def split_jvp(a, b, lo, hi, dep, iterations, x0, tangents):
    """(x, x', the fixed factors of the last sweep) by the kernel's split."""
    a_dot, b_dot, lo_dot, hi_dot, x0_dot = tangents
    n = b.shape[-1]
    x, xd = x0.clone(), x0_dot.clone()
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    has_dep = torch.tensor([d >= 0 for d in dep])
    factors = None
    for _ in range(iterations):
        x_prev, xd_prev = x.clone(), xd.clone()
        # (1) the primal chain over A; u and x_dep as each row saw them
        u, dep_at = torch.zeros_like(b), torch.zeros_like(b)
        for i in range(n):
            total = (a[:, i, :i] * x[:, :i]).sum(-1) + (a[:, i, i + 1:] * x_prev[:, i + 1:]).sum(-1)
            u[:, i] = (b[:, i] - total) / diag[:, i]
            s_i = x[:, dep[i]].clamp_min(0.0) if dep[i] >= 0 else torch.ones_like(u[:, i])
            if dep[i] >= 0:
                dep_at[:, i] = x[:, dep[i]]
            x[:, i] = torch.minimum(torch.maximum(u[:, i], lo[:, i] * s_i), hi[:, i] * s_i)
        # (2) off the chain: the fixed factors and c
        s = torch.where(has_dep, dep_at.clamp_min(0.0), torch.ones_like(dep_at))
        slope = torch.where(has_dep, _relu_slope(dep_at), torch.zeros_like(dep_at))
        mp, ml, mh = _clip_factors(u, lo * s, hi * s)
        factors = (mp, ml, mh, slope)
        earlier = torch.ones(n, n, dtype=torch.bool).tril(-1)  # [i, j]: j < i
        z = torch.where(earlier, x[:, None, :], x_prev[:, None, :])
        z.diagonal(dim1=-2, dim2=-1).copy_(u)
        c = (a_dot * z).sum(-1)
        # (3) the tangent chain over A
        for i in range(n):
            total = (a[:, i, :i] * xd[:, :i]).sum(-1) + (a[:, i, i + 1:] * xd_prev[:, i + 1:]).sum(-1)
            sd = xd[:, dep[i]] * slope[:, i] if dep[i] >= 0 else torch.zeros_like(total)
            ld = lo_dot[:, i] * s[:, i] + lo[:, i] * sd
            hd = hi_dot[:, i] * s[:, i] + hi[:, i] * sd
            xd[:, i] = mp[:, i] * (b_dot[:, i] - c[:, i] - total) / diag[:, i] + ml[:, i] * ld + mh[:, i] * hd
    return x, xd, factors


@functools.lru_cache(maxsize=None)
def _jax_sweep(n):
    """jax.jvp of one sweep of the JAX package's solve_pgs at n rows,
    jitted once for both starts (their dep is the same)."""
    dep = _problem(n, "zero")[2]
    return jax.jit(lambda args, dots: jax.jvp(lambda a, b, lo, hi, x0: j_solve_pgs(a, b, lo, hi, dep, x0, 1), args, dots))


@functools.lru_cache(maxsize=None)
def _jax_sweeps(n, start):
    """x and x' after 1, 2 and 3 sweeps of jax.jvp of the JAX package's
    solve_pgs: one sweep at a time, each from the last one's x and x',
    which is what solve_pgs's loop over 3 sweeps computes, op for op."""
    operands, tangents, _ = _problem(n, start)
    args, dots = tuple(jnp.asarray(v) for v in operands), tuple(jnp.asarray(t) for t in tangents)
    out = []
    for _ in range(3):
        x, x_dot = _jax_sweep(n)(args, dots)
        args, dots = args[:4] + (x,), dots[:4] + (x_dot,)
        out.append((np.asarray(x), np.asarray(x_dot)))
    return out


def _close(got, want, label):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * scale, err_msg=label)


@pytest.mark.parametrize("start", ["zero", "warm"])
@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("n", [3, 12, 40])
def test_split_matches_jax_jvp(n, iterations, start):
    operands, tangents, dep = _problem(n, start)
    want_x, want_dot = _jax_sweeps(n, start)[iterations - 1]
    x, x_dot, _ = split_jvp(*(torch.from_numpy(v) for v in operands[:4]), dep, iterations, torch.from_numpy(operands[4]),
                            [torch.from_numpy(t) for t in tangents])
    _close(x, want_x, "x")
    _close(x_dot, want_dot, "x'")


def test_the_problems_reach_the_kinks():
    """The fixed factors take the tie values: env 1's friction rows at
    lo s = hi s = 0 with s at max's kink (max'(0) = 1/2), env 2's rows on a
    bound (1/4 and 1/2 factors); a friction row depends on a normal row
    after it (row 0 on row 1) and one on a row before it (row 2)."""
    operands, tangents, dep = _problem(12, "zero")
    assert dep[0] == 1 and dep[2] == 1 and dep[1] == -1
    _, _, (mp, ml, mh, slope) = split_jvp(*(torch.from_numpy(v) for v in operands[:4]), dep, 1,
                                          torch.from_numpy(operands[4]), [torch.from_numpy(t) for t in tangents])
    friction = torch.tensor([d >= 0 for d in dep])
    assert torch.all(slope[1, friction] == 0.5) and torch.all(slope[2, friction] == 0.5)
    assert torch.any(mp[1:3] == 0.25) and torch.any(mh[1:3] == 0.5) and torch.any(ml[1:3] == 0.25)
    assert torch.all(mp[0] + ml[0] + mh[0] == 1.0) and torch.any(mp[0] == 1.0)
