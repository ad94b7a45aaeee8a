"""The port's dynamics on the laikago model against the JAX package's, on 8
random states with random torques (float64 on the CPU, tolerance 1e-10)."""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.control.pd import pd_tau as j_pd_tau  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_q as j_integrate_q  # noqa: E402
from tds_tpu.dynamics.jacobian import point_jacobian_kin as j_jac  # noqa: E402
from tds_tpu.dynamics.kinematics import fk_links as j_fk  # noqa: E402
from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch.control.pd import pd_tau as t_pd_tau  # noqa: E402
t_fd = importlib.import_module("tds_tpu_torch.dynamics.forward_dynamics")  # the module: the package's name is its function
from tds_tpu_torch.dynamics.integrator import integrate_q as t_integrate_q  # noqa: E402
from tds_tpu_torch.dynamics.jacobian import point_jacobian_kin as t_jac  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links as t_fk  # noqa: E402
from tds_tpu_torch.urdf.cache import construct as t_construct  # noqa: E402


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

# tds_tpu.dynamics re-exports a function of this module's name
j_fd = importlib.import_module("tds_tpu.dynamics.forward_dynamics")

URDF = "laikago/laikago_toes_zup_xyz_xyzrot.urdf"
TOL = 1e-10
B = 8
GRAVITY = (0.0, 0.0, -9.81)


def _close(got, expected):
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1234)
    j_model, _ = j_construct(URDF, dtype=jnp.float64)
    t_model, _ = t_construct(URDF)
    q = rng.uniform(-0.6, 0.6, size=(B, t_model.dof_q))
    qd = rng.normal(size=(B, t_model.dof_qd))
    tau = 10.0 * rng.normal(size=(B, t_model.dof_actuated))
    j_kin = j_fk(j_model, jnp.asarray(q), jnp.asarray(qd))
    t_kin = t_fk(t_model, torch.from_numpy(q), torch.from_numpy(qd))
    return dict(
        rng=rng, q=q, qd=qd, tau=tau, j_model=j_model, t_model=t_model,
        j_kin=j_kin, t_kin=t_kin,
        j_factor=j_fd.aba_factor(j_model, j_kin), t_factor=t_fd.aba_factor(t_model, t_kin),
    )


@pytest.mark.parametrize("field", ["x_world", "x_parent"])
def test_fk_link_poses(setup, field):
    for t, j in zip(getattr(setup["t_kin"], field), getattr(setup["j_kin"], field)):
        _close(t.pos.expand(j.pos.shape), j.pos)
        _close(t.rot.expand(j.rot.shape), j.rot)


@pytest.mark.parametrize("field", ["v", "c", "pA"])
def test_fk_link_velocities_and_bias(setup, field):
    for t, j in zip(getattr(setup["t_kin"], field), getattr(setup["j_kin"], field)):
        _close(t.expand(j.shape), j)


def test_aba_factor(setup):
    t_f, j_f = setup["t_factor"], setup["j_factor"]
    for i in range(setup["t_model"].num_links):
        _close(t_f.u[i], j_f.u[i])
        _close(t_f.d_inv[i], j_f.d_inv[i])
        for t, j in zip(t_f.ia[i], j_f.ia[i]):
            _close(t.expand(j.shape), j)


def test_forward_dynamics_qdd(setup):
    s = setup
    expected = j_fd.forward_dynamics_from_kin(
        s["j_model"], s["j_kin"], jnp.asarray(s["q"]), jnp.asarray(s["qd"]), jnp.asarray(s["tau"]),
        jnp.asarray(GRAVITY), factor=s["j_factor"],
    )
    got = t_fd.forward_dynamics_from_kin(
        s["t_model"], s["t_kin"], torch.from_numpy(s["q"]), torch.from_numpy(s["qd"]), torch.from_numpy(s["tau"]),
        torch.tensor(GRAVITY, dtype=torch.float64), factor=s["t_factor"],
    )
    _close(got, expected)


def test_minv_mul_multi_rhs(setup):
    s = setup
    x = np.random.default_rng(5).normal(size=(5, B, s["t_model"].dof_qd))
    expected = j_fd.minv_mul(s["j_model"], s["j_kin"], s["j_factor"], jnp.asarray(x))
    got = t_fd.minv_mul(s["t_model"], s["t_kin"], s["t_factor"], torch.from_numpy(x))
    _close(got, expected)


@pytest.mark.parametrize("link", [8, 13, 17, 21])
def test_point_jacobian_kin(setup, link):
    s = setup
    point = np.random.default_rng(link).normal(size=(B, 3))
    expected = j_jac(
        s["j_model"], s["j_kin"].base_x_world, s["j_kin"].x_world, None, link, jnp.asarray(point),
        batch=(B,), dtype=jnp.float64,
    )
    got = t_jac(s["t_model"], s["t_kin"].base_x_world, s["t_kin"].x_world, None, link, torch.from_numpy(point))
    _close(got, expected)


@pytest.mark.parametrize("skip_links", [0, 6])
def test_pd_tau(setup, skip_links):
    s = setup
    n_pd = 18 - skip_links
    targets = np.random.default_rng(skip_links).uniform(-0.5, 0.5, size=(B, n_pd))
    args = (100.0, 2.0, 50.0)
    expected = j_pd_tau(s["j_model"], jnp.asarray(s["q"]), jnp.asarray(s["qd"]), jnp.asarray(targets), *args, skip_links=skip_links)
    got = t_pd_tau(s["t_model"], torch.from_numpy(s["q"]), torch.from_numpy(s["qd"]), torch.from_numpy(targets), *args, skip_links=skip_links)
    _close(got, expected)


def test_integrate_q(setup):
    s = setup
    j_q, j_qd = j_integrate_q(s["j_model"], jnp.asarray(s["q"]), jnp.asarray(s["qd"]), 1e-3)
    t_q, t_qd = t_integrate_q(s["t_model"], torch.from_numpy(s["q"]), torch.from_numpy(s["qd"]), 1e-3)
    _close(t_q, j_q)
    _close(t_qd, j_qd)
