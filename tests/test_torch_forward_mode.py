"""Forward mode through the port on the CPU, float64, against the JAX
package:

- K1's plain JVP (``contact.pgs.solve_pgs_jvp_reference``, what the CPU
  runs and what the card's forward-mode kernel is held to) against
  ``jax.jvp`` of ``tds_tpu.contact.mlcp.solve_pgs`` within 1e-12 relative,
  on tests/test_torch_pgs_grad.py's random, ties and deps problems at
  n = 3, 12, 24 and 33 rows, one and two sweeps;
- ``DiffMethod.FORWARD`` (``torch.func.jacfwd``) through one laikago
  ``sim_step`` with contact rows active against ``jax.jacfwd`` within 1e-9;
- forward mode against reverse mode through a 20-step laikago contact
  rollout (``tools/contact_loss.py``'s loss) within 1e-9;
- the card path's plumbing, run here with CPU stand-ins for the graphs and
  the kernels (each asserts that it is handed plain tensors, as a kernel's
  launch is): ``torch.func.jvp``, ``jacfwd``, ``jacrev`` and ``vmap``
  through ``PGSFunction`` and through ``graphs.scan``'s transform rules
  give what the same transforms of the plain versions give, jacfwd with one
  forward and one JVP launch; forward AD through the card's scan raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.contact.mlcp import solve_pgs as j_solve_pgs  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.tools import contact_loss  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402
from tds_tpu_torch.utils.diff import DiffMethod, GradientFunctional  # noqa: E402


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
    """tests/test_torch_pgs_grad.py's problems: a batch of 4 envs, n = 3 n_c
    rows, 'random'; 'ties' with env 1 at zero normal impulse and env 2 at
    x = b = 0; 'deps' as 'ties' with each contact's rows ordered friction,
    normal, friction and row 0 depending on the last normal row."""
    rng = np.random.default_rng(seed)
    bsz, n_c = 4, max(1, n // 3)
    j = rng.normal(size=(bsz, n, 8))
    a = j @ np.swapaxes(j, -1, -2) + 1e-3 * np.eye(n) + 0.01 * rng.normal(size=(bsz, n, n))
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
        b[1, normals] = -10.0 * np.abs(b[1, normals]) - 1.0
        b[1, normals] -= 50.0 * np.abs(a[1][np.ix_(normals, normals)]).sum(-1)
        b[2] = 0.0
    tangents = [rng.normal(size=x.shape) for x in (a, b, lo, hi)]
    return (a, b, lo, hi), tangents, dep


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("n", [3, 12, 24, 33])
@pytest.mark.parametrize("kind", ["random", "ties", "deps"])
def test_plain_jvp_matches_jax(kind, n, iterations):
    operands, tangents, dep = _problem(n, n + 10 * iterations, kind)
    want_x, want = jax.jvp(
        lambda *t: j_solve_pgs(*t, dep, jnp.zeros_like(t[1]), iterations),
        tuple(jnp.asarray(x) for x in operands), tuple(jnp.asarray(t) for t in tangents),
    )
    got_x, got = pgs.solve_pgs_jvp_reference(
        *(torch.from_numpy(x) for x in operands), [torch.from_numpy(t) for t in tangents], dep, iterations
    )
    _close(got_x.numpy(), want_x, RTOL)
    _close(got.numpy(), want, RTOL)


def test_the_ties_reach_the_kinks():
    """The ties problems put env 1's normal impulses at exactly 0 and env
    2's whole x at 0, where jax.jvp gives each side of a max half."""
    operands, _, dep = _problem(12, 22, "ties")
    x = pgs.solve_pgs_reference(*(torch.from_numpy(v) for v in operands), dep, 1)
    assert torch.all(x[1, :4] == 0) and torch.all(x[2] == 0) and torch.any(x[0] != 0)


# -- laikago ---------------------------------------------------------------
def _contact_state(rng):
    """A laikago state 1 cm into the ground (z = 0.43; it stands at 0.44)
    with small seeded joint offsets and velocities, and a seeded action."""
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    q0, qd0, _ = contact_loss.sliding_start(env)
    q = q0[0].numpy().copy()
    q[2] = 0.43
    q[6:] += 0.02 * rng.normal(size=q.size - 6)
    qd = 0.05 * rng.normal(size=qd0.shape[-1])
    action = 0.1 * rng.normal(size=env.action_dim)
    return env, q, qd, action


def test_forward_method_through_a_laikago_step_matches_jax_jacfwd():
    """d (w . [q', qd']) / d [q, qd] through one contact step with rows
    active: DiffMethod.FORWARD (torch.func.jacfwd) against jax.jacfwd of the
    JAX package's sim_step, within 1e-9 relative."""
    rng = np.random.default_rng(5)
    env, q, qd, action = _contact_state(rng)
    dq = q.size
    w = rng.normal(size=dq + qd.size)
    jenv = JaxLaikago(dtype=jnp.float64)

    def j_f(x):
        q2, qd2 = jenv.sim_step(x[:dq], x[dq:], jnp.asarray(action))
        return jnp.dot(jnp.asarray(w), jnp.concatenate([q2, qd2]))

    def f(x):
        q2, qd2 = env.sim_step(x[None, :dq], x[None, dq:], torch.from_numpy(action)[None])
        return (torch.from_numpy(w) * torch.cat([q2, qd2], -1)[0]).sum()

    x = np.concatenate([q, qd])
    with torch.no_grad():
        state = torch.from_numpy(x)
        calls = []
        solve = pgs.solve_pgs
        pgs.solve_pgs = lambda *args: calls.append(args) or solve(*args)
        try:
            f(state)
        finally:
            pgs.solve_pgs = solve
    assert len(calls) == 1 and int((calls[0][1] != 0).sum()) > 0, "no contact row is active"
    want = jax.jit(jax.jacfwd(j_f))(jnp.asarray(x))
    got = GradientFunctional(f, method=DiffMethod.FORWARD).gradient(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-9)


def test_forward_and_reverse_agree_through_a_contact_rollout():
    """tools/contact_loss.py's loss over 20 steps on the CPU, touching down
    at the first step: jacfwd and jacrev of (kp, mass scale, friction)
    agree within 1e-9 relative."""
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    q0, qd0, link = contact_loss.sliding_start(env, height=0.44)
    loss = contact_loss.make_loss(env, q0, qd0, link, 20)
    fwd = contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cpu")
    rev = contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cpu", forward=False)
    assert torch.all(fwd != 0)
    _close(fwd.numpy(), rev.numpy(), 1e-9)


# -- the card path's plumbing with CPU stand-ins ----------------------------
def _plain(*tensors):
    assert not any(isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors), \
        "a kernel launch was handed a transformed tensor"


class _Kernels:
    """CPU stand-ins for K1's launches: the plain versions on plain tensors,
    counted."""

    def __init__(self):
        self.calls = []

    def forward(self, a, b, lo, hi, dep, it, x0=None):
        assert x0 is None, "these rules run from the zero start"
        _plain(a, b, lo, hi)
        self.calls.append(("forward", b.shape[0]))
        return pgs.solve_pgs_reference(a, b, lo, hi, dep, it)

    def jvp(self, a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot, dep, it, x0=None, x0_dot=None):
        assert x0 is None and x0_dot is None, "these rules run from the zero start"
        _plain(a, b, lo, hi, a_dot, b_dot, lo_dot, hi_dot)
        self.calls.append(("jvp", b.shape[0]))
        return pgs.solve_pgs_jvp_reference(a, b, lo, hi, (a_dot, b_dot, lo_dot, hi_dot), dep, it)

    def backward(self, a, b, lo, hi, dep, it, x, x_bar, x0=None):
        assert x0 is None, "these rules run from the zero start"
        _plain(a, b, lo, hi, x, x_bar)
        self.calls.append(("backward", b.shape[0]))
        inputs = [t.detach().requires_grad_() for t in (a, b, lo, hi)]
        with torch.enable_grad():
            return torch.autograd.grad(pgs.solve_pgs_reference(*inputs, dep, it), inputs, x_bar)


class _Entry:
    """A stand-in for a body's graphs: scan_reference on plain tensors."""

    def __init__(self, calls, key):
        self.calls, self.key = calls, key

    def run(self, body, carry, consts, length):
        _plain(*carry, *consts)
        self.calls.append(("graphs", self.key[0] if isinstance(self.key, tuple) else self.key))
        with torch.no_grad():
            return tuple(t.clone() for t in graphs.scan_reference(body, carry, consts, length))

    def run_keeping(self, body, carry, consts, length):
        _plain(*carry, *consts)
        inputs = []
        with torch.no_grad():
            for _ in range(length):
                inputs.append(tuple(t.clone() for t in carry))
                carry = body(carry, consts)
        return inputs, carry


class _VJP:
    """A stand-in for the one-step VJP graph: autograd of each step."""

    def __init__(self, body):
        self.body = body

    def run(self, inputs, consts, carry_bar):
        consts_bar = [torch.zeros_like(k) if k.is_floating_point() else None for k in consts]
        for step in reversed(inputs):
            with torch.enable_grad():
                c = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in step)
                k = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in consts)
                out = self.body(c, k)
                pairs = [(o, g) for o, g in zip(out, carry_bar) if g is not None and o.requires_grad]
                leaves = [t for t in c + k if t.requires_grad]
                grads = iter(torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs], allow_unused=True))
            carry_bar = tuple(_zero_none(next(grads), t) if t.is_floating_point() else None for t in step)
            for i, t in enumerate(k):
                if t.requires_grad:
                    g = next(grads)
                    consts_bar[i] = consts_bar[i] + (0 if g is None else g)
        return carry_bar, tuple(consts_bar)


def _zero_none(g, t):
    return torch.zeros_like(t) if g is None else g


@pytest.fixture
def card_path(monkeypatch):
    """solve_pgs through PGSFunction and scan through the card's dispatch,
    with the stand-ins above in place of the kernels and the graphs; yields
    the list of their calls."""
    kernels = _Kernels()
    monkeypatch.setattr(pgs, "_launch", kernels.forward)
    monkeypatch.setattr(pgs, "_launch_jvp", kernels.jvp)
    monkeypatch.setattr(pgs, "_launch_backward", kernels.backward)
    monkeypatch.setattr(pgs, "solve_pgs", lambda a, b, lo, hi, dep, it: pgs.PGSFunction.apply(a, b, lo, hi, tuple(dep), it))
    monkeypatch.setattr(graphs, "_entry", lambda body, carry, consts, key, device, chunk: _Entry(kernels.calls, key))
    monkeypatch.setattr(graphs, "_vjp_entry", lambda body, carry, consts, key, device: _VJP(body))
    monkeypatch.setattr(contact_loss, "scan", lambda body, carry, consts, length, key: graphs._card_scan(
        body, tuple(carry), tuple(consts), length, key, 1, torch.device("cpu")))
    yield kernels.calls


def test_pgs_function_rules(card_path):
    """jvp, jacfwd, jacrev and vmap through PGSFunction on stand-in kernels
    give the plain version's; jacfwd launches one forward and one JVP over
    the basis folded into the batch, jacrev one forward and one backward."""
    operands, tangents, dep = _problem(12, 3, "ties")
    a, b, lo, hi = (torch.from_numpy(x) for x in operands)

    def kernel(bb, aa):
        return pgs.solve_pgs(aa, bb, lo, hi, dep, 2)

    def plain(bb, aa):
        return pgs.solve_pgs_reference(aa, bb, lo, hi, dep, 2)

    t = (torch.from_numpy(tangents[1]), torch.from_numpy(tangents[0]))
    _close(torch.func.jvp(kernel, (b, a), t)[1], torch.func.jvp(plain, (b, a), t)[1], RTOL)
    card_path.clear()
    got = torch.func.jacfwd(kernel, argnums=(0, 1))(b, a)
    assert card_path == [("forward", 4), ("jvp", 4 * (48 + 4 * 144))]
    want = torch.func.jacfwd(plain, argnums=(0, 1))(b, a)
    for g, w in zip(got, want):
        _close(g, w, RTOL)
    card_path.clear()
    for g, w in zip(torch.func.jacrev(kernel, argnums=(0, 1))(b, a), want):
        _close(g, w, RTOL)
    assert card_path == [("forward", 4), ("backward", 4 * 48)]
    batch = b + torch.from_numpy(np.random.default_rng(0).normal(size=(3,) + b.shape))
    _close(torch.func.vmap(kernel, in_dims=(0, None))(batch, a), torch.stack([plain(x, a) for x in batch]), RTOL)


def test_scan_rules_through_a_contact_rollout(card_path):
    """jacfwd and jacrev of contact_loss's 5-step loss through the card's
    scan dispatch (the JVP body under vmap, the VJP replays) against jacfwd
    of the Python loop; jvp alone; vmap over the points; forward AD raises."""
    import torch.autograd.forward_ad as fwAD

    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    q0, qd0, link = contact_loss.sliding_start(env, height=0.44)
    loss = contact_loss.make_loss(env, q0, qd0, link, 5)
    point = torch.tensor(contact_loss.POINT, dtype=torch.float64)
    with torch.no_grad():
        value = loss(*point.unbind())
    card_path.clear()
    fwd = contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cpu")
    assert ("graphs", "vmap") in card_path and ("jvp", 3 * 1) in card_path
    rev = contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cpu", forward=False)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(contact_loss, "scan", lambda body, carry, consts, length, key: graphs.scan_reference(body, carry, consts, length))
        m.setattr(pgs, "solve_pgs", pgs.solve_pgs_reference)
        want = contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cpu")
        want_value = loss(*point.unbind())
    assert torch.all(want != 0)
    _close(fwd, want, 1e-10)
    _close(rev, want, 1e-10)
    direction = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    v, dot = torch.func.jvp(lambda p: loss(*p.unbind()), (point,), (direction,))
    _close(v, want_value, RTOL)
    _close(dot, want @ direction, 1e-10)
    points = point + torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.1, -0.1]], dtype=torch.float64)
    _close(torch.func.vmap(lambda p: loss(*p.unbind()))(points)[0], value, RTOL)
    with fwAD.dual_level(), pytest.raises(NotImplementedError, match="forward AD"):
        loss(fwAD.make_dual(point[0], torch.ones(())), point[1], point[2])
