"""Neural augmentation in the port (``tds_tpu_torch.utils.neural_augmentation``)
against the JAX package's, float64 on the CPU: ``Wiring``,
``AugmentationSpec`` (``params_for``, ``apply`` with and without a value,
``regularization``) and ``make_residual_dynamics`` on a two-link pendulum
from the same flat parameters within 1e-12; and the port learning the
unmodeled constant torque of tests/test_rigid_body.py's
``test_neural_augmentation_learns_gravity_residual`` (loss below 1e-3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tds_tpu.model.pendulum import compound_pendulum as j_compound_pendulum  # noqa: E402
from tds_tpu.utils import neural_augmentation as j_na  # noqa: E402
from tds_tpu.learn.nn import Activation as JActivation  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics  # noqa: E402
from tds_tpu_torch.learn.nn import Activation  # noqa: E402
from tds_tpu_torch.model.pendulum import compound_pendulum  # noqa: E402
from tds_tpu_torch.utils import neural_augmentation as na  # noqa: E402
from tds_tpu_torch.utils.neural_augmentation import AugmentationSpec, Wiring, make_residual_dynamics  # noqa: E402


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

TOL = 1e-12
GRAVITY = (0.0, 0.0, -9.81)


def _specs():
    """The same two wirings in both packages: a residual tanh net (4 -> 2,
    hidden 8, 8) and a replacement sin net (3 -> 1, hidden 5) with an
    output scale, L1 and L2 set."""
    def build(module, act):
        spec = module.AugmentationSpec(l1=1e-3, l2=2e-3)
        spec.add_wiring(module.Wiring("tau_residual", 4, 2, hidden=(8, 8)))
        spec.add_wiring(module.Wiring("friction", 3, 1, hidden=(5,), activation=act.SIN, residual=False, output_scale=0.5))
        return spec

    return build(j_na, JActivation), build(na, Activation)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * max(1.0, float(np.abs(want).max())))


def test_spec_matches_jax():
    j_spec, spec = _specs()
    assert spec.num_parameters == j_spec.num_parameters == (4 * 8 + 8 + 8 * 8 + 8 + 8 * 2 + 2) + (3 * 5 + 5 + 5 + 1)
    rng = np.random.default_rng(0)
    params = rng.normal(size=spec.num_parameters)
    x4, x3, value = rng.normal(size=(6, 4)), rng.normal(size=(6, 3)), rng.normal(size=(6, 2))
    p = torch.from_numpy(params)
    for name in ("tau_residual", "friction"):
        _close(spec.params_for(p, name), j_spec.params_for(jnp.asarray(params), name))
    _close(spec.apply(p, "tau_residual", torch.from_numpy(x4), value=torch.from_numpy(value)),
           j_spec.apply(jnp.asarray(params), "tau_residual", jnp.asarray(x4), value=jnp.asarray(value)))
    _close(spec.apply(p, "tau_residual", torch.from_numpy(x4)), j_spec.apply(jnp.asarray(params), "tau_residual", jnp.asarray(x4)))
    # a replacement wiring ignores the value
    _close(spec.apply(p, "friction", torch.from_numpy(x3), value=torch.ones(6, 1, dtype=torch.float64)),
           j_spec.apply(jnp.asarray(params), "friction", jnp.asarray(x3), value=jnp.ones((6, 1))))
    _close(spec.regularization(p), j_spec.regularization(jnp.asarray(params)))


def test_residual_dynamics_matches_jax():
    """qdd of a two-link pendulum with a learned torque residual, batched
    over 5 states, and its gradient in the parameters."""
    spec = AugmentationSpec().add_wiring(Wiring("tau_residual", 4, 2, hidden=(6,)))
    j_spec = j_na.AugmentationSpec().add_wiring(j_na.Wiring("tau_residual", 4, 2, hidden=(6,)))
    rng = np.random.default_rng(1)
    params = 0.3 * rng.normal(size=spec.num_parameters)
    q, qd, tau = rng.normal(size=(5, 2)), rng.normal(size=(5, 2)), rng.normal(size=(5, 2))
    dyn = make_residual_dynamics(compound_pendulum(2), spec, torch.tensor(GRAVITY, dtype=torch.float64))
    j_dyn = j_na.make_residual_dynamics(j_compound_pendulum(2), j_spec, jnp.asarray(GRAVITY))
    p = torch.from_numpy(params).requires_grad_()
    got = dyn(p, *(torch.from_numpy(x) for x in (q, qd, tau)))
    want = jax.vmap(lambda a, b, c: j_dyn(jnp.asarray(params), a, b, c))(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau))
    _close(got, want)
    (grad,) = torch.autograd.grad(got.sum(), p)
    j_grad = jax.grad(lambda w: jax.vmap(lambda a, b, c: j_dyn(w, a, b, c))(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(tau)).sum())(
        jnp.asarray(params))
    _close(grad, j_grad)


def test_learns_gravity_residual():
    """The port's counterpart of tests/test_rigid_body.py's test: an
    augmentation net (2 -> 8 -> 1, L2 1e-6) learns to cancel an unmodeled
    constant torque of 0.7 on a one-link pendulum, 300 gradient steps at
    0.05 on 64 states, loss below 1e-3."""
    model = compound_pendulum(1)
    g = torch.tensor(GRAVITY, dtype=torch.float64)
    spec = AugmentationSpec(l2=1e-6).add_wiring(Wiring("tau_residual", input_dim=2, output_dim=1, hidden=(8,)))
    rng = np.random.default_rng(0)
    qs = torch.from_numpy(rng.uniform(-1, 1, size=(64, 1)))
    qds = torch.from_numpy(rng.uniform(-1, 1, size=(64, 1)))
    targets = forward_dynamics(model, qs, qds, torch.full((64, 1), 0.7, dtype=torch.float64), g)

    def loss(params):
        tau = spec.apply(params, "tau_residual", torch.cat([qs, qds], -1), value=torch.zeros(64, 1, dtype=torch.float64))
        return ((forward_dynamics(model, qs, qds, tau, g) - targets) ** 2).mean() + spec.regularization(params)

    params = 0.01 * torch.from_numpy(rng.normal(size=spec.num_parameters))
    for _ in range(300):
        p = params.detach().requires_grad_()
        (grad,) = torch.autograd.grad(loss(p), p)
        params = params - 0.05 * grad
    assert float(loss(params)) < 1e-3
