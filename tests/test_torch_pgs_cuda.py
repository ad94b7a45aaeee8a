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
The sweeps past the first (the forward's columns after each row summed
off the chain) and the linearised forward mode at every form, on both
sides of the row-per-lane and the staged forms' limits, 1, 3 and 10
sweeps, ties included, at the same tolerances; no forward or forward-mode
instance, zero start or warm, has local memory, and the blocked forward
mode keeps at least the blocked forward's resident warps at n = 105.
The forward's saved sweeps (what it stores for its backward past one
sweep): its saved first sweep from x = 0 is its own (the Split instance's,
not the one-sweep relaunch's, whose differing elements each case records),
the saving forward's x is the forward's without saves and its saved sweeps
are the launches of fewer sweeps from the same start, bit for bit in every
form, start and type; a gradient past one sweep launches the forward once
and the backward once.
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
    batch), jacrev (one forward launch, which saves its first sweep, and
    one backward launch), vmap (one forward
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
    assert counts() == (before[0] + 1, before[1], before[2] + 1)
    batch = b + torch.randn((4,) + b.shape, dtype=b.dtype, device=b.device)
    before = counts()
    close([torch.func.vmap(kernel, in_dims=(0, None))(batch, a)], [torch.stack([plain(x, a) for x in batch])])
    assert counts() == (before[0] + 1, before[1], before[2])
    with fwAD.dual_level():
        x_dot = fwAD.unpack_dual(kernel(fwAD.make_dual(b, tangents[1]), a)).tangent
    close([x_dot], [torch.func.jvp(lambda bb: plain(bb, a), (b,), (tangents[1],))[1]])


# the row-per-lane forms (3, 12, 24, 32: N = 8, 12, 24, 32), both sides of
# n = 32, the paths' blocked n (48, 105) and a block edge (65)
SPLIT_ROWS = (3, 12, 24, 32, 33, 48, 65, 105)


def _staged_limit(dtype, jvp):
    """The largest n whose staging fits a block in the forward's blocked
    form (with ``jvp``, the forward mode's)."""
    return max(n for n in range(33, 400) if pgs.form(dtype, n, jvp=jvp) == "blocked")


@pytest.mark.parametrize("iterations", [1, 3, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SPLIT_ROWS)
def test_later_sweeps_and_forward_mode_match_plain(cuda_device, n, dtype, iterations):
    """K1 and its forward mode from x = 0 through 1, 3 and 10 sweeps (the
    sweeps after the first sum each row's columns after it off the chain;
    the forward mode's primal chain fixes the clip's factors and its
    tangent chain is linear) against the plain version and torch.func.jvp
    of it, on the interleaved layout (dependencies before and after their
    rows) with ties in envs 1 and 2, at the tolerances above. The float32
    kernels are held to the plain versions run in float64 on the same
    float32 operands, as tests/test_torch_pgs_warm_cuda.py holds the warm
    ones: after the first sweep every row sums all its columns, and the
    float32 plain sweep's own rounding then strays past those tolerances."""
    operands, tangents, dep = _jvp_problem(37, n, 7 * n + iterations, dtype, "interleaved", cuda_device)
    plain, plain_tangents = [t.double() for t in operands], [t.double() for t in tangents]
    want = pgs.solve_pgs_reference(*plain, dep, iterations)
    got = pgs._launch(*operands, tuple(dep), iterations)
    torch.testing.assert_close(got.cpu().double(), want.cpu(), **_tolerance(dtype, n))
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain, plain_tangents, dep, iterations)
    got_x, got_dot = pgs._launch_jvp(*operands, *tangents, tuple(dep), iterations)
    torch.testing.assert_close(got_x.cpu().double(), want_x.cpu(), **_tolerance(dtype, n))
    _assert_tangent_close(got_dot.double(), want_dot, dtype)


@pytest.mark.parametrize("iterations", [1, 3, 10])
@pytest.mark.parametrize("jvp", [False, True], ids=["forward", "jvp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_both_sides_of_the_staged_limit_through_many_sweeps(cuda_device, dtype, jvp, iterations):
    """The last n whose staging fits a block (blocked) and the next
    (streaming), 1, 3 and 10 sweeps, B = 5 with ties in envs 1 and 2,
    against the plain version (with ``jvp``, torch.func.jvp of it) in
    float64, as above."""
    last = _staged_limit(dtype, jvp)
    for n, form in ((last, "blocked"), (last + 1, "streaming")):
        assert pgs.form(dtype, n, jvp=jvp) == form
        operands, tangents, dep = _jvp_problem(5, n, n + iterations, dtype, "interleaved", cuda_device)
        plain, plain_tangents = [t.double() for t in operands], [t.double() for t in tangents]
        if not jvp:
            want = pgs.solve_pgs_reference(*plain, dep, iterations)
            torch.testing.assert_close(pgs._launch(*operands, tuple(dep), iterations).cpu().double(), want.cpu(),
                                       **_tolerance(dtype, n))
            continue
        want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain, plain_tangents, dep, iterations)
        got_x, got_dot = pgs._launch_jvp(*operands, *tangents, tuple(dep), iterations)
        torch.testing.assert_close(got_x.cpu().double(), want_x.cpu(), **_tolerance(dtype, n))
        _assert_tangent_close(got_dot.double(), want_dot, dtype)


# the forward's zero-start instances for one sweep compile as they did
# before the sweeps after the first were split off the chain, and two of
# them spill a little (the float32 N = 16 padded instance, n = 13 to 15,
# and the float32 N = 32 one at n = 32): bytes of local memory a thread
ONE_SWEEP_SPILLS = {(torch.float32, 14): 8, (torch.float32, 32): 16}


def test_no_forward_or_forward_mode_instance_has_local_memory(cuda_device):
    """Every instance of the forward and the forward mode, zero start (one
    sweep and more) and warm, float32 and float64 (each row-per-lane N,
    exact and padded, the
    blocked form on both sides of a block edge, both sides of each staged
    limit) has 0 bytes of local memory, but for ONE_SWEEP_SPILLS; the
    blocked forward mode keeps at
    least the blocked forward's resident warps per SM at n = 105 in float32
    (the humanoid's), and at least 8."""
    for dtype in (torch.float32, torch.float64):
        for jvp in (False, True):
            last = _staged_limit(dtype, jvp)
            for n in (3, 8, 9, 12, 14, 16, 20, 24, 28, 32, 33, 48, 65, 105, last, last + 1):
                for warm, iterations in ((False, 1), (False, 3), (True, 1)):
                    shape = pgs.launch_shape(dtype, n, 4096, jvp=jvp, warm=warm, iterations=iterations)
                    local = ONE_SWEEP_SPILLS.get((dtype, n), 0) if not (jvp or warm) and iterations == 1 else 0
                    assert shape["local_bytes"] == local and shape["blocks_per_sm"] >= 1, (dtype, n, jvp, warm, shape)
    forward = pgs.launch_shape(torch.float32, 105, 1024)
    for warm in (False, True):
        jvp = pgs.launch_shape(torch.float32, 105, 1024, jvp=True, warm=warm)
        assert jvp["form"] == "blocked" and jvp["resident_warps_per_sm"] >= max(8, forward["resident_warps_per_sm"]), jvp


# -- K1's backward past its first sweep, and the blocked forward's limit
# from x0 ------------------------------------------------------------------
# groups of 16 lanes (3, 12, 16), of 32 (17-32), the blocked n (33-105)
SWEEPS_ROWS = (3, 12, 16, 17, 24, 32, 33, 48, 65, 105)
WHOLE, STREAMED = "linearised sweeps, A whole", "linearised sweeps"


def _plain_grads(operands, dep, iterations, x_bar, x0=None):
    """The plain version's autograd gradients (x0-bar last with x0) in
    float64 on the same operands."""
    plain = [t.double().clone().requires_grad_() for t in operands + ([x0] if x0 is not None else [])]
    x = pgs.solve_pgs_reference(*plain[:4], dep, iterations, plain[4] if x0 is not None else None)
    return [g.cpu() for g in torch.autograd.grad(x, plain, x_bar.double())]


@pytest.mark.parametrize("iterations", [3, 4, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SWEEPS_ROWS)
def test_backward_past_the_first_sweep_matches_plain(cuda_device, n, dtype, iterations):
    """K1's backward at 3, 4 and 10 sweeps from x = 0 ("linearised sweeps":
    x before each sweep staged once, A-bar written once after the last sweep
    visited; A's upper part staged whole in shared memory or streamed from
    L2, as the plan picks for n: whole at n <= 16) against the plain
    version's autograd in float64 on the same operands, on the interleaved
    layout with ties in envs 1 and 2: float64 within 1e-12 relative,
    float32 within rtol 1e-4 and atol 1e-5 max|grad|."""
    operands, _, dep = _jvp_problem(37, n, 5 * n + iterations, dtype, "interleaved", cuda_device)
    x_bar = torch.from_numpy(np.random.default_rng(n).normal(size=(37, n))).to(cuda_device, dtype)
    want = _plain_grads(operands, dep, iterations, x_bar)
    form = pgs.form(dtype, n, backward=True, iterations=iterations)
    assert form == WHOLE if n <= 16 else form in (WHOLE, STREAMED), form
    x, xs = pgs._launch(*operands, tuple(dep), iterations, save=True)
    got = pgs._launch_backward(*operands, tuple(dep), iterations, x, x_bar, xs=xs)
    _assert_grads_close([g.double() for g in got], want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_plan_picks_each_sweeps_form_on_the_paths_row_counts(cuda_device, dtype):
    """Both ways of holding A's upper part run on the row counts the tests
    above take, from x = 0 at 3 and 10 sweeps and from x0 at 3: "A whole"
    at the fewest rows (n = 3), "upper streamed" at the humanoid's 105."""
    for warm, iterations in ((False, 3), (False, 10), (True, 3)):
        forms = [pgs.form(dtype, n, backward=True, warm=warm, iterations=iterations) for n in SWEEPS_ROWS]
        assert forms[0] == WHOLE and forms[-1] == STREAMED, (warm, iterations, forms)


def _last_n(dtype, forms, **kwargs):
    """The largest n < 500 whose kernel (``pgs.form``'s ``kwargs``) takes one
    of ``forms``."""
    return max(n for n in range(1, 500) if pgs.form(dtype, n, **kwargs) in forms)


@pytest.mark.parametrize("iterations", [3, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_sweeps_both_sides_of_their_limits(cuda_device, dtype, iterations):
    """The limits the backward past one sweep brings, each n against the
    plain version's autograd in float64 at B = 3 (a random problem), from
    x = 0 and from x0 (at two sweeps; one sweep from x0 runs "linearised"):
    the last n at which the plan holds A whole and the next ("upper
    streamed"), the last n whose "upper streamed" staging fits and the
    next ("streaming"); n = 16 and 17 (groups of 16 lanes, then 32)."""
    assert pgs.form(dtype, 105, backward=True, warm=True) == "linearised"
    cases = []
    for warm, it in ((False, iterations), (True, 2)):
        whole = _last_n(dtype, (WHOLE,), backward=True, warm=warm, iterations=it)
        staged = _last_n(dtype, (WHOLE, STREAMED), backward=True, warm=warm, iterations=it)
        cases += [(whole, it, warm, WHOLE), (whole + 1, it, warm, STREAMED), (staged, it, warm, STREAMED),
                  (staged + 1, it, warm, "streaming"), (16, it, warm, WHOLE)]
        cases.append((17, it, warm, pgs.form(dtype, 17, backward=True, warm=warm, iterations=it)))
    for n, it, warm, form in cases:
        assert pgs.form(dtype, n, backward=True, warm=warm, iterations=it) == form, (n, it, warm)
        operands, _, dep = _jvp_problem(3, n, n, dtype, "normals first", cuda_device)
        x0 = torch.randn(3, n, dtype=dtype, device=cuda_device) if warm else None
        x_bar = torch.ones(3, n, dtype=dtype, device=cuda_device)
        want = _plain_grads(operands, dep, it, x_bar, x0)
        x, xs = pgs._launch(*operands, tuple(dep), it, x0, save=True)
        got = pgs._launch_backward(*operands, tuple(dep), it, x, x_bar, x0, xs)
        _assert_grads_close([g.double() for g in got], want, dtype)
        if warm:
            scale = want[4].abs().max().item()
            tol = dict(rtol=1e-4, atol=1e-5 * scale) if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12 * scale)
            torch.testing.assert_close(got[4].double().cpu(), want[4], **tol)


# (rows, batch, sweeps, from x0): the ball loss's n = 3 at 4 sweeps, the
# Panda push's n = 24 at 10 and at the bindings' default 50
# (TinyMultiBodyConstraintSolver), the humanoid's n = 105 from x0 at 3 (the
# "upper streamed" form's public path) and at 10
PATH_CASES = ((3, 4096, 4, False), (24, 4096, 10, False), (24, 4096, 50, False), (105, 1024, 3, True),
              (105, 1024, 10, False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch,iterations,warm", PATH_CASES)
def test_backward_sweeps_at_the_paths_batches(cuda_device, n, batch, iterations, warm, dtype):
    """The backward past one sweep at the paths' batches on the interleaved
    layout with ties in envs 1 and 2, on the sweeps the forward saved:
    float64 against the plain version's
    autograd within 1e-12 relative over every env; float32 against the
    plain version in float64 along the forward's own sweeps, those it saved
    (``tools/pgs_ab.py``'s ``plain_backward_along``) within rtol 1e-4 and
    atol 1e-5 max|grad| on the envs with no clip near a tie, at most 5% of
    them (where the float32 forward's rounding may decide a clip the other
    way; against the plain autograd a whole term of a gradient moves)."""
    from tds_tpu_torch.tools import pgs_ab

    operands, _, dep = _jvp_problem(batch, n, 7 * n + iterations, dtype, "interleaved", cuda_device)
    x0 = torch.from_numpy(np.random.default_rng(n).normal(size=(batch, n))).to(cuda_device, dtype) if warm else None
    x_bar = torch.from_numpy(np.random.default_rng(n + 1).normal(size=(batch, n))).to(cuda_device, dtype)
    x, xs = pgs._launch(*operands, tuple(dep), iterations, x0, save=True)
    got = [g.double() for g in pgs._launch_backward(*operands, tuple(dep), iterations, x, x_bar, x0, xs)]
    ops = operands + ([x0] if warm else [])
    if dtype == torch.float64:
        want, keep = [w.to(cuda_device) for w in _plain_grads(operands, dep, iterations, x_bar, x0)], slice(None)
    else:
        want, near = pgs_ab.plain_backward_along(ops, dep, torch.cat([xs, x[None]]), x_bar)
        assert int(near.sum()) <= 0.05 * batch, int(near.sum())
        keep = ~near
    for name, g, w in zip(("A", "b", "lo", "hi", "x0"), got, want):
        scale = w.abs().max().item()
        tol = dict(rtol=1e-12, atol=1e-12 * scale) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-5 * scale)
        torch.testing.assert_close(g[keep], w[keep], **tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_forward_from_x0_both_sides_of_its_limit(cuda_device, dtype):
    """The last n whose blocked forward from x0 and past one sweep fits a
    block and the next (streaming): from x0 at 1 sweep and from x = 0 at 3,
    against the plain version in float64 at B = 3."""
    last = _last_n(dtype, ("blocked",), warm=True)
    assert last == _last_n(dtype, ("blocked",), iterations=3) == _last_n(dtype, ("blocked",))
    for n, form in ((last, "blocked"), (last + 1, "streaming")):
        operands, _, dep = _jvp_problem(3, n, n, dtype, "normals first", cuda_device)
        x0 = torch.randn(3, n, dtype=dtype, device=cuda_device)
        plain = [t.double() for t in operands]
        for it, start in ((1, x0), (3, None)):
            assert pgs.form(dtype, n, warm=start is not None, iterations=it) == form
            want = pgs.solve_pgs_reference(*plain, dep, it, None if start is None else start.double())
            got = pgs._launch(*operands, tuple(dep), it, start)
            torch.testing.assert_close(got.double().cpu(), want.cpu(), **_tolerance(dtype, n))


def test_new_instances_have_no_local_memory_and_a_block_resident(cuda_device):
    """Every instance of the backward past one sweep that the plan launches
    (from x0 at 1, 2 and 3 sweeps, from x = 0 at 3 and 10), and of the
    blocked forward past one sweep, float32 and float64, at the paths' row
    counts, the edges of the groups and blocks and both sides of the staged
    limits: 0 bytes of local memory, at least one block resident an SM;
    among them each "linearised sweeps" instance (A whole with groups of 16
    and of 32 lanes, upper streamed; from x = 0 and from x0)."""
    for dtype in (torch.float32, torch.float64):
        staged = _last_n(dtype, (WHOLE, STREAMED), backward=True, warm=True, iterations=2)
        whole = _last_n(dtype, (WHOLE,), backward=True, warm=True, iterations=2)
        blocked = _last_n(dtype, ("blocked",), warm=True)
        seen = set()
        for n in (3, 8, 12, 16, 17, 24, 32, 33, 48, 65, 97, 105, whole, whole + 1, staged, staged + 1, blocked, blocked + 1):
            for warm, it in ((True, 1), (True, 2), (True, 3), (False, 3), (False, 10)):
                shape = pgs.launch_shape(dtype, n, 4096, backward=True, warm=warm, iterations=it)
                assert shape["local_bytes"] == 0 and shape["blocks_per_sm"] >= 1, (dtype, n, warm, it, shape)
                seen.add((shape["form"], shape["lanes_per_env"], warm))
                if n > 32:
                    shape = pgs.launch_shape(dtype, n, 4096, warm=warm, iterations=it)
                    assert shape["local_bytes"] == 0 and shape["blocks_per_sm"] >= 1, (dtype, n, warm, it, shape)
        for warm in (False, True):
            assert {(WHOLE, 16, warm), (WHOLE, 32, warm), (STREAMED, 32, warm)} <= seen, (dtype, seen)


# -- the forward's saved sweeps ----------------------------------------------
# the row-per-lane instances past one sweep (N = 8, 12, 24, 32), the blocked
# form (48, 105) and the streaming one (340: past 335 rows in float32, 236 in
# float64)
SAVED_ROWS = (3, 12, 24, 32, 48, 105, 340)


def _saved_problem(n, batch, dtype, seed, device):
    """_rows_problem's interleaved operands with _ties' envs, dep and an x0
    of normal draws, on ``device`` in ``dtype``."""
    a, b, lo, hi, dep = _rows_problem(batch, n, seed=seed, layout="interleaved")
    _ties(a, b, dep)
    x0 = np.random.default_rng(seed).normal(size=(batch, n))
    return [torch.from_numpy(v).to(device, dtype) for v in (a, b, lo, hi)], tuple(dep), torch.from_numpy(x0).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", (3, 12, 24, 32, 340))
def test_the_saved_first_sweep_is_the_forwards_own(cuda_device, record_property, n, dtype):
    """x after the first sweep as a forward of 4 sweeps from x = 0 saves it
    is that forward's own: bit for bit what its Split instance computes in
    one sweep (the warm instance from x0 = 0). Until the forward saved its
    sweeps the backward got the one-sweep relaunch in its place, the
    instance without Split, whose sums run in float in float32: the
    elements where that relaunch differs are recorded
    (``relaunch_elements_differing``), at B = 4096."""
    operands, dep, _ = _saved_problem(n, 4096, dtype, 3 * n, cuda_device)
    x, xs = pgs._launch(*operands, dep, 4, save=True)
    own = pgs._launch(*operands, dep, 1, torch.zeros_like(x))
    assert torch.equal(xs[0], own)
    assert torch.equal(x, pgs._launch(*operands, dep, 4))
    relaunch = pgs._launch(*operands, dep, 1)
    differing = int((relaunch != own).sum())
    record_property("relaunch_elements_differing", differing)
    record_property("relaunch_max_abs_diff", (relaunch.double() - own.double()).abs().max().item())
    print(f"n={n} {dtype}: the one-sweep relaunch differs from the forward's own first sweep in {differing} of "
          f"{own.numel()} elements")


@pytest.mark.parametrize("warm", [False, True], ids=["zero start", "from x0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", SAVED_ROWS)
def test_saved_sweeps_equal_the_relaunches(cuda_device, n, dtype, warm):
    """In every form and both types the saving forward's x is the forward
    without saves' bit for bit, and its saved sweeps are what a launch of
    t sweeps from the same start gives, t = 1 .. T - 1 (from x = 0, t >= 2
    and the blocked form's t = 1: the instances the forward runs; from x0,
    the warm relaunches an earlier wrapper gave the backward), at 10
    sweeps, at a batch that fills no whole block."""
    operands, dep, x0 = _saved_problem(n, 37, dtype, n + 1, cuda_device)
    start = x0 if warm else None
    x, xs = pgs._launch(*operands, dep, 10, start, save=True)
    assert xs.shape == (9, 37, n) and torch.equal(x, pgs._launch(*operands, dep, 10, start))
    blocked = pgs.form(dtype, n, iterations=10) == "blocked"
    for t in range(1 if warm or blocked else 2, 10):
        assert torch.equal(xs[t - 1], pgs._launch(*operands, dep, t, start)), t


@pytest.mark.parametrize("iterations", [2, 4, 10, 50])
@pytest.mark.parametrize("warm", [False, True], ids=["zero start", "from x0"])
@pytest.mark.parametrize("n", (3, 24, 48))
def test_a_gradient_launches_the_forward_once_and_the_backward_once(cuda_device, n, warm, iterations):
    """torch.autograd.grad of solve_pgs past one sweep: one forward launch
    (it saves its sweeps) and one backward launch, each of its start's
    counter by one and the other start's not at all, and the gradients the
    backward kernel's on the forward's saved sweeps, bit for bit."""
    operands, dep, x0 = _saved_problem(n, 64, torch.float32, n, cuda_device)
    inputs = [t.clone().requires_grad_() for t in operands + ([x0] if warm else [])]
    counters = ("launches", "warm_launches", "backward_launches", "warm_backward_launches")
    before = {c: getattr(pgs, c) for c in counters}
    x = pgs.solve_pgs(*inputs[:4], dep, iterations, inputs[4] if warm else None)
    x_bar = torch.ones_like(x)
    got = torch.autograd.grad(x, inputs, x_bar)
    torch.cuda.synchronize()
    moved = {c: getattr(pgs, c) - before[c] for c in counters}
    want = {"launches": 0, "warm_launches": 0, "backward_launches": 0, "warm_backward_launches": 0}
    want.update({"warm_launches": 1, "warm_backward_launches": 1} if warm else {"launches": 1, "backward_launches": 1})
    assert moved == want
    y, xs = pgs._launch(*operands, dep, iterations, x0 if warm else None, save=True)
    kernel = pgs._launch_backward(*operands, dep, iterations, y, x_bar, x0 if warm else None, xs)
    assert torch.equal(x.detach(), y) and all(torch.equal(g, k) for g, k in zip(got, kernel))


def test_saving_instances_have_no_local_memory(cuda_device):
    """The saving forward's instances (past one sweep, from x = 0 and from
    x0, every form, both types) have no local memory and a block resident
    an SM, in the form of the forward without saves at the same n."""
    for dtype in (torch.float32, torch.float64):
        for n in SAVED_ROWS + (8, 16, 20, 65):
            for warm in (False, True):
                saving = pgs.launch_shape(dtype, n, 4096, warm=warm, iterations=3, saving=True)
                plain = pgs.launch_shape(dtype, n, 4096, warm=warm, iterations=3)
                assert saving["local_bytes"] == 0 and saving["blocks_per_sm"] >= 1, (dtype, n, warm, saving)
                assert saving["form"] == plain["form"], (dtype, n, warm, saving, plain)
