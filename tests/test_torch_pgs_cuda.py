"""The PGS kernel (csrc/pgs.cu) on a CUDA device against the port's plain
version: float32 at rtol 1e-5 / atol 1e-6 (tests/test_pallas_pgs.py's
tolerance), float64 at atol 1e-12 for the row-per-lane kernel (n <= 32) and
at 1e-12 relative for the warp-per-env forms (n > 32, whose sums run in
another order), at batches that fill no whole block of groups, at every row
count of chip_smoke.py's phase 12 (a) and at the edges of the blocked
form's blocks of 32 rows (33, 47, 48, 64, 65, 96, 97), 0 to 3 sweeps, with
dependencies before and after their rows, and on both sides of the row
count past which an env's staging no longer fits a block; and its launch
shape on the card. K1's backward kernel against the plain version's
autograd on the same CUDA tensors at the same edges, 0 to 3 sweeps, ties
included: float64 within 1e-12 relative, float32 within rtol 1e-4 and atol
1e-5 max|grad|; a double backward raises. K1's forward-mode kernel
against ``torch.func.jvp`` of the plain version at every row count of
``ROWS`` and both sides of its staged form's limit, 0 to 3 sweeps, ties
included: float64 within 1e-12 relative, float32 within rtol 1e-5 and atol
1e-6 max|x'|; ``torch.func.jvp``, ``jacfwd``, ``jacrev``, ``vmap`` and
forward AD through ``solve_pgs`` launch the kernels (the vmap rules fold
the vmapped dimension into the batch), equal to the plain version's.
Every test here needs the card and skips without one. The file imports neither JAX nor the JAX package, so on a
machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pgs_cuda.py -q
"""

import functools

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


def _rows_problem(bsz, n, seed, dtype=np.float64, layout="normals first"):
    """Numpy (a, b, lo, hi, dep) with n rows of any count: the layout of
    _problem (normal rows, then friction rows bounded by +-0.5 times their
    normal row's impulse) with n / 3 contacts when 3 divides n, else n / 2
    normal rows and one friction direction (n = 8: laikago with
    num_friction_dir = 1), at least one normal row. ``layout="interleaved"``
    orders each of the n // 3 contacts' rows friction, normal, friction
    (one dependency after its row, one before, inside a block of 32), makes
    any rows past them friction rows of contact 0, and row 0 depend on the
    last contact's normal row (a later block once n > 32)."""
    rng = np.random.default_rng(seed)
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n)
    b = rng.normal(size=(bsz, n))
    if layout == "interleaved":
        n_c = max(1, n // 3)
        normals = [3 * k + 1 for k in range(n_c)]
        dep = [-1 if i in normals else (3 * (i // 3) + 1 if i < 3 * n_c else 1) for i in range(n)]
        dep[0] = normals[-1]
    else:
        normals = list(range(n_c))
        dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
    is_normal = np.isin(np.arange(n), normals)
    lo = np.broadcast_to(np.where(is_normal, 0.0, -0.5), (bsz, n)).copy()
    hi = np.broadcast_to(np.where(is_normal, 1e5, 0.5), (bsz, n)).copy()
    return [x.astype(dtype) for x in (a, b, lo, hi)] + [dep]


@functools.lru_cache(maxsize=8)
def _cached_problem(bsz, n, seed, dtype, layout):
    """_rows_problem's operands as CPU tensors in ``dtype``, and dep, kept
    for the sweep counts that share them."""
    *operands, dep = _rows_problem(bsz, n, seed, layout=layout)
    return [torch.from_numpy(x).to(dtype) for x in operands], dep


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
# the half-cheetah (48), the ant without compaction (51), the humanoid
# (105); and the edges of the blocked form's blocks of 32 rows (33, 47, 64,
# 65, 96, 97; the odd ones misalign each env's base in float32)
ROWS = (3, 6, 8, 9, 12, 24, 33, 47, 48, 51, 64, 65, 96, 97, 105)
LAYOUTS = ("normals first", "interleaved")


def _tolerance(dtype, n):
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-6)
    return dict(rtol=0, atol=1e-12) if n <= 32 else dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ROWS)
def test_every_instance_has_a_block_resident_per_sm(cuda_device, dtype, n):
    """A row per lane for n <= 32, a warp per env above (blocked); no local
    memory; the paths' n > 32 in float32 (the half-cheetah's 48 rows at
    B = 4096, the humanoid's 105 at 1024) in at most one wave."""
    shape = pgs.launch_shape(dtype, n, 4096)
    assert shape["blocks_per_sm"] >= 1 and shape["local_bytes"] == 0
    assert shape["lanes_per_env"] >= n if n <= 32 else shape["lanes_per_env"] == 32
    assert shape["envs_per_block"] * shape["lanes_per_env"] == shape["threads_per_block"]
    assert shape["form"] == ("row per lane" if n <= 32 else "blocked")
    path_batch = {48: 4096, 105: 1024}.get(n)
    if dtype == torch.float32 and path_batch:
        assert pgs.launch_shape(dtype, n, path_batch)["waves"] <= 1.0, shape


def test_cuda_kernel_refuses_unbuilt_row_counts(cuda_device):
    """Every row count runs on the card now (n = 9 had no instance before
    the padded instances and the warp per env): n = 9, 1, 33 and 200, each
    against the plain version."""
    for n_rows in (9, 1, 33, 200):
        a, b, lo, hi, dep = _rows_problem(5, n_rows, seed=n_rows)
        expected = pgs.solve_pgs_reference(*(torch.from_numpy(x) for x in (a, b, lo, hi)), dep, 2)
        got = pgs.solve_pgs(*(torch.from_numpy(x).to(cuda_device) for x in (a, b, lo, hi)), dep, 2)
        torch.testing.assert_close(got.cpu(), expected, **_tolerance(torch.float64, n_rows))


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,bsz", [(n, bsz) for n in ROWS for bsz in (1, 37, 4096)] + [(105, 1024)])
def test_kernel_matches_plain_at_every_row_count(cuda_device, dtype, n, bsz, layout, iterations):
    """0 to 3 sweeps of a random problem of n rows in the kernel and the
    plain version, on the same operands in ``dtype``, with dependencies
    after their rows in the interleaved layout."""
    operands, dep = _cached_problem(bsz, n, n * bsz, dtype, layout)
    expected = pgs.solve_pgs_reference(*operands, dep, iterations)
    before = pgs.launches
    got = pgs.solve_pgs(*(t.to(cuda_device) for t in operands), dep, iterations)
    torch.cuda.synchronize()
    assert pgs.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.cpu(), expected, **_tolerance(dtype, n))


def _threshold(dtype, backward):
    """The largest n whose staging fits a block (the blocked forward, the
    linearised backward): the streaming form runs past it."""
    staged = "linearised" if backward else "blocked"
    return max(n for n in range(33, 400) if pgs.form(dtype, n, backward) == staged)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_sides_of_the_large_n_threshold(cuda_device, dtype, backward):
    """The last n whose env's staging fits a block's 227 KB runs the staged
    form, the next the streaming form, both without local memory and both
    against the plain version (two sweeps forward, one backward, B = 5)."""
    last = _threshold(dtype, backward)
    for n, form in ((last, "linearised" if backward else "blocked"), (last + 1, "streaming")):
        shape = pgs.launch_shape(dtype, n, 5, backward=backward)
        assert shape["form"] == form and shape["local_bytes"] == 0 and shape["blocks_per_sm"] >= 1, (n, shape)
        operands, dep = _cached_problem(5, n, n, dtype, "interleaved")
        if not backward:
            expected = pgs.solve_pgs_reference(*operands, dep, 2)
            got = pgs.solve_pgs(*(t.to(cuda_device) for t in operands), dep, 2)
            torch.testing.assert_close(got.cpu(), expected, **_tolerance(dtype, n))
            continue
        x_bar = torch.ones(5, n, dtype=dtype)
        ref = [t.clone().requires_grad_() for t in operands]
        want = torch.autograd.grad(pgs.solve_pgs_reference(*ref, dep, 1), ref, x_bar)
        inputs = [t.to(cuda_device).requires_grad_() for t in operands]
        got = torch.autograd.grad(pgs.solve_pgs(*inputs, dep, 1), inputs, x_bar.to(cuda_device))
        _assert_grads_close(got, want, dtype)


def test_cuda_kernel_refuses_mixed_dtypes_and_strides(cuda_device):
    a, b, lo, hi, dep = (torch.from_numpy(x).to(cuda_device) if isinstance(x, np.ndarray) else x for x in _problem(8, 4, seed=1))
    with pytest.raises(TypeError):
        pgs.solve_pgs(a.float(), b, lo, hi, dep, 1)
    with pytest.raises(ValueError):
        pgs.solve_pgs(a.transpose(-1, -2), b, lo, hi, dep, 1)


def test_cuda_kernel_refuses_gradients_it_would_drop(cuda_device):
    """K1 drops no gradient now: under grad, an operand that requires grad
    gets its gradient from the backward kernel (one launch), equal to the
    plain version's autograd on the same CUDA tensors; under
    torch.no_grad() the same call returns what it returns without grad."""
    a, b, lo, hi = (torch.from_numpy(x).to(cuda_device) for x in _problem(21, 4, seed=2)[:4])
    dep = _problem(21, 4, seed=2)[4]
    expected = pgs.solve_pgs(a, b, lo, hi, dep, 2)
    b_grad = b.clone().requires_grad_()
    before = pgs.backward_launches
    x = pgs.solve_pgs(a, b_grad, lo, hi, dep, 2)
    assert torch.equal(x.detach(), expected) and x.requires_grad
    (got,) = torch.autograd.grad(x.sum(), b_grad)
    assert pgs.backward_launches == before + 1
    b_ref = b.clone().requires_grad_()
    (want,) = torch.autograd.grad(pgs.solve_pgs_reference(a, b_ref, lo, hi, dep, 2).sum(), b_ref)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * want.abs().max().item())
    with torch.no_grad():
        got = pgs.solve_pgs(a.clone().requires_grad_(), b.clone().requires_grad_(), lo, hi, dep, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, expected) and not got.requires_grad


# K1's backward: the row counts of the paths (12, 24, 48, 105), groups of
# 16 lanes and of 32 (3, 8, 16, 17), and the edges of the blocks of 32
GRAD_ROWS = (3, 8, 12, 16, 17, 24, 33, 47, 48, 64, 65, 96, 97, 105)


def _assert_grads_close(got, want, dtype):
    """Float64 within 1e-12 relative, float32 within rtol 1e-4 and atol
    1e-5 max|grad|, each of A, b, lo and hi."""
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        g = g.cpu()
        scale = w.abs().max().item()
        if dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * scale, msg=lambda m: f"{name}: {m}")
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale, msg=lambda m: f"{name}: {m}")


def _ties(a, b, dep):
    """Env 1 with every normal impulse at exactly 0 (its friction rows at
    s = 0) and env 2 with b = 0 (x = 0 everywhere): the kinks. The normal
    rows are those without a dependency."""
    normals = [i for i, d in enumerate(dep) if d < 0]
    b[1, normals] = -10.0 * np.abs(b[1, normals]) - 50.0 * np.abs(a[1][np.ix_(normals, normals)]).sum(-1) - 1.0
    b[2] = 0.0


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bsz", [1, 37, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", GRAD_ROWS)
def test_backward_kernel_matches_plain_autograd(cuda_device, monkeypatch, n, dtype, bsz, layout, iterations):
    """The gradients of A, b, lo and hi for a random cotangent: the
    backward kernel against the plain version's autograd on the same CUDA
    tensors, at batches that fill no whole block (and 4096), ties included
    where the batch holds them, dependencies after their rows in the
    interleaved layout; float64 within 1e-12 relative, float32 within rtol
    1e-4 and atol 1e-5 max|grad|; 0 sweeps give zeros. The plain version is
    never reached through the wrapper."""
    a, b, lo, hi, dep = _rows_problem(bsz, n, seed=n + iterations, layout=layout)
    if bsz >= 3:
        _ties(a, b, dep)
    x_bar = torch.from_numpy(np.random.default_rng(n).normal(size=b.shape)).to(cuda_device, dtype)
    operands = [torch.from_numpy(x).to(cuda_device, dtype) for x in (a, b, lo, hi)]
    ref_inputs = [t.clone().requires_grad_() for t in operands]
    if iterations:
        want = torch.autograd.grad(pgs.solve_pgs_reference(*ref_inputs, dep, iterations), ref_inputs, x_bar)
    else:
        want = [torch.zeros_like(t) for t in operands]
    inputs = [t.clone().requires_grad_() for t in operands]

    def refuse(*args, **kwargs):
        raise AssertionError("the plain PGS ran on a CUDA tensor")

    monkeypatch.setattr(pgs, "solve_pgs_reference", refuse)
    before = pgs.backward_launches
    got = torch.autograd.grad(pgs.solve_pgs(*inputs, dep, iterations), inputs, x_bar)
    torch.cuda.synchronize()
    assert pgs.backward_launches == before + 1
    _assert_grads_close(got, [w.cpu() for w in want], dtype)


def test_backward_has_a_launch_shape_without_local_memory(cuda_device):
    for dtype in (torch.float32, torch.float64):
        for n in GRAD_ROWS:
            shape = pgs.launch_shape(dtype, n, 4096, backward=True)
            assert shape["blocks_per_sm"] >= 1 and shape["local_bytes"] == 0, (dtype, n, shape)
            assert shape["form"] == "linearised" and shape["lanes_per_env"] == (16 if n <= 16 else 32), (dtype, n, shape)


def test_second_derivative_raises(cuda_device):
    """once_differentiable: a double backward raises."""
    a, b, lo, hi, dep = (torch.from_numpy(x).to(cuda_device) if isinstance(x, np.ndarray) else x for x in _rows_problem(5, 12, seed=3))
    b = b.clone().requires_grad_()
    x = pgs.solve_pgs(a, b, lo, hi, dep, 1)
    (g,) = torch.autograd.grad((x**2).sum(), b, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), b)


def _jvp_problem(bsz, n, seed, dtype, layout, device):
    """Operands of _rows_problem with the ties of _ties where the batch
    holds them, and random tangents of each, on ``device`` in ``dtype``."""
    a, b, lo, hi, dep = _rows_problem(bsz, n, seed=seed, layout=layout)
    if bsz >= 3:
        _ties(a, b, dep)
    rng = np.random.default_rng(seed + 1)
    operands = [torch.from_numpy(x).to(device, dtype) for x in (a, b, lo, hi)]
    tangents = [torch.from_numpy(rng.normal(size=x.shape)).to(device, dtype) for x in (a, b, lo, hi)]
    return operands, tangents, dep


def _assert_tangent_close(got, want, dtype):
    """Float64 within 1e-12 relative, float32 within rtol 1e-5 and atol
    1e-6 max|x'|."""
    got, want = got.cpu(), want.cpu()
    scale = max(1.0, want.abs().max().item())
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,bsz", [(n, bsz) for n in ROWS for bsz in (1, 37)] + [(12, 4096), (24, 4096), (48, 4096), (105, 1024)])
def test_jvp_kernel_matches_plain_at_every_row_count(cuda_device, monkeypatch, dtype, n, bsz, layout, iterations):
    """x and x' for random tangents of A, b, lo and hi: the forward-mode
    kernel (one launch) against torch.func.jvp of the plain version on the
    same CUDA tensors, ties included where the batch holds them; through
    torch.func.jvp of solve_pgs the kernels alone run, to the same x'."""
    operands, tangents, dep = _jvp_problem(bsz, n, n * bsz + iterations, dtype, layout, cuda_device)
    want_x, want = pgs.solve_pgs_jvp_reference(*operands, tangents, dep, iterations)
    before = pgs.jvp_launches
    got_x, got = pgs._launch_jvp(*operands, *tangents, tuple(dep), iterations)
    torch.cuda.synchronize()
    assert pgs.jvp_launches == before + 1
    torch.testing.assert_close(got_x.cpu(), want_x.cpu(), **_tolerance(dtype, n))
    _assert_tangent_close(got, want, dtype)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain PGS ran on a CUDA tensor")

    monkeypatch.setattr(pgs, "solve_pgs_reference", refuse)
    _, x_dot = torch.func.jvp(lambda *t: pgs.solve_pgs(*t, dep, iterations), tuple(operands), tuple(tangents))
    assert pgs.jvp_launches == before + 2
    torch.testing.assert_close(x_dot, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ROWS)
def test_jvp_kernel_forms(cuda_device, dtype, n):
    """The forward's forms: a row per lane for n <= 32, blocked above, with
    a block resident per SM."""
    shape = pgs.launch_shape(dtype, n, 4096, jvp=True)
    assert shape["blocks_per_sm"] >= 1, shape
    assert shape["form"] == ("row per lane" if n <= 32 else "blocked"), shape
    assert shape["envs_per_block"] * shape["lanes_per_env"] == shape["threads_per_block"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jvp_both_sides_of_the_large_n_threshold(cuda_device, dtype):
    """The last n whose env's two staged triangles fit a block runs the
    blocked form, the next the streaming form, each against the plain
    version (two sweeps, B = 5, ties in envs 1 and 2)."""
    last = max(n for n in range(33, 400) if pgs.form(dtype, n, jvp=True) == "blocked")
    for n, form in ((last, "blocked"), (last + 1, "streaming")):
        assert pgs.launch_shape(dtype, n, 5, jvp=True)["form"] == form
        operands, tangents, dep = _jvp_problem(5, n, n, dtype, "interleaved", cuda_device)
        want_x, want = pgs.solve_pgs_jvp_reference(*operands, tangents, dep, 2)
        got_x, got = pgs._launch_jvp(*operands, *tangents, tuple(dep), 2)
        torch.testing.assert_close(got_x.cpu(), want_x.cpu(), **_tolerance(dtype, n))
        _assert_tangent_close(got, want, dtype)


def test_torch_func_transforms_launch_the_kernels(cuda_device):
    """jacfwd (one forward and one JVP launch: the basis folded into the
    batch), jacrev (one backward launch, and a forward launch for each
    sweep count the backward recovers x after: 1 and 2), vmap (one forward
    launch over T B rows) and forward AD through solve_pgs on the card,
    each equal to the same transform of the plain version in float64
    within 1e-12 relative."""
    import torch.autograd.forward_ad as fwAD

    operands, tangents, dep = _jvp_problem(5, 12, 7, torch.float64, "normals first", cuda_device)
    a, b, lo, hi = operands

    def kernel(bb, aa):
        return pgs.solve_pgs(aa, bb, lo, hi, dep, 2)

    def plain(bb, aa):
        return pgs.solve_pgs_reference(aa, bb, lo, hi, dep, 2)

    def close(got, want):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * max(1.0, w.abs().max().item()))

    def counts():
        return pgs.launches, pgs.jvp_launches, pgs.backward_launches

    before = counts()
    got = torch.func.jacfwd(kernel, argnums=(0, 1))(b, a)
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    want = torch.func.jacfwd(plain, argnums=(0, 1))(b, a)
    close(got, want)
    before = counts()
    close(torch.func.jacrev(kernel, argnums=(0, 1))(b, a), want)
    assert counts() == (before[0] + 2, before[1], before[2] + 1)
    batch = b + torch.randn((4,) + b.shape, dtype=b.dtype, device=b.device)
    before = counts()
    close([torch.func.vmap(kernel, in_dims=(0, None))(batch, a)], [torch.stack([plain(x, a) for x in batch])])
    assert counts() == (before[0] + 1, before[1], before[2])
    with fwAD.dual_level():
        x_dot = fwAD.unpack_dual(kernel(fwAD.make_dual(b, tangents[1]), a)).tangent
    close([x_dot], [torch.func.jvp(lambda bb: plain(bb, a), (b,), (tangents[1],))[1]])
