"""The rest of dynamics in the port against the JAX package, float64 on
the CPU, on inputs drawn from a numpy seed:

- ``symbolic_cholesky_fill``, ``cholesky_unrolled`` / ``cho_solve_unrolled``
  (with and without the tree's fill pattern), ``solve_pd``, ``inv_pd`` and
  ``dof_coupling_mask`` at 1e-12;
- RNEA, ``inverse_dynamics`` (with the base wrench) and ``bias_forces``,
  on 4 random states of the fixed laikago and the floating ant at 1e-12,
  and the ABA-RNEA round trip;
- one contact resolution under ``minv_method="crba"`` on both robots at
  1e-12, and against ``"aba"`` at 1e-10;
- ``delassus_dtype="bf16"``: one contact step's Delassus matrix and
  impulses against the JAX package's at 1e-5 relative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tds_tpu.contact.mlcp as jax_mlcp  # noqa: E402
from tds_tpu.algebra import linalg as jax_linalg  # noqa: E402
from tds_tpu.contact.mlcp import ContactSolverParams as JaxSolverParams  # noqa: E402
from tds_tpu.dynamics.inverse_dynamics import bias_forces as jax_bias_forces  # noqa: E402
from tds_tpu.dynamics.inverse_dynamics import inverse_dynamics as jax_inverse_dynamics  # noqa: E402
from tds_tpu.urdf.cache import construct as jax_construct  # noqa: E402
from tds_tpu.world import build_world as jax_build_world  # noqa: E402
from tds_tpu.world import make_ground_plane as jax_ground  # noqa: E402
from tds_tpu.world import resolve_contacts as jax_resolve_contacts  # noqa: E402
from tds_tpu_torch.algebra import linalg  # noqa: E402
from tds_tpu_torch.contact import pgs  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics  # noqa: E402
from tds_tpu_torch.dynamics.inverse_dynamics import bias_forces, inverse_dynamics  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402
from tds_tpu_torch.world import build_world, make_ground_plane, resolve_contacts  # noqa: E402

TOL = 1e-12
GRAVITY = (0.0, 0.0, -9.81)
ROBOTS = [("laikago/laikago_toes_zup_xyz_xyzrot.urdf", False), ("gym/ant_org.urdf", True)]
IDS = ["laikago", "floating ant"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small operations, run no faster on more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def unoptimized_jax():
    """The JAX package's reference compiled without XLA's optimisation
    passes: its compiles are most of this file's time, and its results
    agree to rounding."""
    optimized = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables


def models(urdf, floating):
    (j_model, j_geoms), (t_model, t_geoms) = jax_construct(urdf, is_floating=floating), construct(urdf, is_floating=floating)
    return j_model, j_geoms, t_model, t_geoms


def random_states(model, seed, batch=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, 0.4, (batch, model.dof_q))
    if model.is_floating:
        q[:, :4] /= np.linalg.norm(q[:, :4], axis=1, keepdims=True)
    return q, rng.normal(size=(batch, model.dof_qd)), rng.normal(size=(batch, model.dof_qd))


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


# -- linear algebra -----------------------------------------------------------
@pytest.mark.parametrize("urdf, floating", ROBOTS, ids=IDS)
def test_coupling_mask_and_fill(urdf, floating):
    j_model, _, t_model, _ = models(urdf, floating)
    mask = t_model.dof_coupling_mask()
    np.testing.assert_array_equal(mask, np.asarray(j_model.dof_coupling_mask()))
    for m in (mask, mask[::-1, ::-1]):
        np.testing.assert_array_equal(linalg.symbolic_cholesky_fill(m), jax_linalg.symbolic_cholesky_fill(m))
    # reversed (leaves first) the tree's coupling is fill-free
    assert (linalg.symbolic_cholesky_fill(mask[::-1, ::-1]) == np.tril(mask[::-1, ::-1])).all()


@pytest.mark.parametrize("pattern", [False, True], ids=["dense", "tree pattern"])
def test_cholesky_and_solves(pattern):
    rng = np.random.default_rng(1)
    _, _, model, _ = models(*ROBOTS[0])
    mask = model.dof_coupling_mask()[::-1, ::-1]
    n = mask.shape[0]
    patt = linalg.symbolic_cholesky_fill(mask) if pattern else None
    # SPD: L L^T + n I, with L lower-triangular on the tree's fill pattern
    # (fill-free reversed, so A has the tree's zeros) or dense
    lower = np.tril(rng.normal(size=(3, n, n))) * (linalg.symbolic_cholesky_fill(mask) if pattern else 1.0)
    a = lower @ np.swapaxes(lower, -1, -2) + n * np.eye(n)
    b = rng.normal(size=(3, n, 5))
    l_t = linalg.cholesky_unrolled(torch.from_numpy(a), patt)
    l_j = jax_linalg.cholesky_unrolled(jnp.asarray(a), patt)
    close(l_t, l_j, what="factor")
    close(linalg.cho_solve_unrolled(l_t, torch.from_numpy(b), patt), jax_linalg.cho_solve_unrolled(l_j, jnp.asarray(b), patt))
    close(linalg.cho_solve_unrolled(l_t, torch.from_numpy(b[..., 0]), patt),
          jax_linalg.cho_solve_unrolled(l_j, jnp.asarray(b[..., 0]), patt))
    close(linalg.solve_pd(torch.from_numpy(a), torch.from_numpy(b)), jax_linalg.solve_pd(jnp.asarray(a), jnp.asarray(b)))
    close(linalg.inv_pd(torch.from_numpy(a)), jax_linalg.inv_pd(jnp.asarray(a)))
    close(linalg.inv_pd(torch.from_numpy(a)) @ torch.from_numpy(a), np.broadcast_to(np.eye(n), a.shape), tol=1e-10)


# -- RNEA ------------------------------------------------------------------------
@pytest.mark.parametrize("urdf, floating", ROBOTS, ids=IDS)
def test_inverse_dynamics_matches_jax(urdf, floating):
    j_model, _, t_model, _ = models(urdf, floating)
    q, qd, qdd = random_states(t_model, 3)
    f_ext = np.random.default_rng(4).normal(size=(4, t_model.num_links, 6))
    g = np.asarray(GRAVITY)

    def jax_id(q, qd, qdd, f):
        tau, wrench = jax_inverse_dynamics(j_model, q, qd, qdd, jnp.asarray(g), f_ext=f, return_base_wrench=True)
        return tau, wrench, jax_bias_forces(j_model, q, qd, jnp.asarray(g))

    j_tau, j_wrench, j_bias = jax.jit(jax.vmap(jax_id))(*(jnp.asarray(x) for x in (q, qd, qdd, f_ext)))
    tq, tqd, tqdd, tf = (torch.from_numpy(x) for x in (q, qd, qdd, f_ext))
    t_tau, t_wrench = inverse_dynamics(t_model, tq, tqd, tqdd, torch.tensor(GRAVITY, dtype=torch.float64), f_ext=tf,
                                       return_base_wrench=True)
    close(t_tau, j_tau, what="tau")
    close(t_wrench, j_wrench, what="base wrench")
    close(bias_forces(t_model, tq, tqd, torch.tensor(GRAVITY, dtype=torch.float64)), j_bias, what="bias forces")


@pytest.mark.parametrize("urdf, floating", ROBOTS, ids=IDS)
def test_aba_rnea_round_trip(urdf, floating):
    _, _, model, _ = models(urdf, floating)
    q, qd, _ = random_states(model, 5)
    if floating:
        # the JAX package's floating round trip: identity orientation, no base
        # spin (FD's base qdd is the world-frame rate of the base's twist)
        q[:, :4], qd[:, :3] = (0.0, 0.0, 0.0, 1.0), 0.0
    tau = torch.from_numpy(np.random.default_rng(6).normal(size=(4, model.dof_actuated)))
    gravity = torch.tensor(GRAVITY, dtype=torch.float64)
    qdd = forward_dynamics(model, torch.from_numpy(q), torch.from_numpy(qd), tau, gravity)
    back, wrench = inverse_dynamics(model, torch.from_numpy(q), torch.from_numpy(qd), qdd, gravity, return_base_wrench=True)
    close(back, tau, tol=1e-9, what="ID(q, qd, FD(q, qd, tau)) against tau")
    if floating:
        close(wrench, np.zeros((4, 6)), tol=1e-9, what="an unforced base needs no wrench")


# -- CRBA and bf16 contact options --------------------------------------------
def contact_worlds(urdf, floating, solver):
    j_model, j_geoms, t_model, t_geoms = models(urdf, floating)
    j_world = jax_build_world([jax_ground(dtype=jnp.float64), (j_model, j_geoms)], solver=JaxSolverParams(**solver._asdict()))
    t_world = build_world([make_ground_plane(dtype=torch.float64, device="cpu"), (t_model, t_geoms)], solver=solver)
    return j_world, t_world


def touching_states(model, seed):
    """States whose toes (the ant's capsules) reach below the ground, moving."""
    rng = np.random.default_rng(seed)
    q = np.zeros((3, model.dof_q))
    if model.is_floating:
        q[:, 3], q[:, 6] = 1.0, 0.12
        q[:, 7:] = rng.normal(0.0, 0.2, (3, model.dof_q - 7))
    else:
        q[:, 2] = 0.4
        q[:, 6:] = np.tile((0.2, 0.0, -0.7), 4) + rng.normal(0.0, 0.05, (3, 12))
    return q, rng.normal(0.0, 0.3, (3, model.dof_qd))


def resolved(j_world, t_world, q, qd, monkeypatch):
    """(port (qd, A, p), JAX (qd, A, p)) of one contact resolution."""
    recorded = []

    def recording(a_mat, b, lo, hi, dep, x0, iterations):
        x = solve(a_mat, b, lo, hi, dep, x0, iterations)
        recorded.append((a_mat, x))
        return x

    solve = jax_mlcp.solve_pgs
    monkeypatch.setattr(jax_mlcp, "solve_pgs", recording)

    def jax_fn(q, qd):
        qd2 = jax_resolve_contacts(j_world, (jnp.zeros((q.shape[0], 0)), q), (jnp.zeros((q.shape[0], 0)), qd), 1e-3)[1]
        return (qd2, *recorded[-1])

    j_out = jax.jit(jax_fn)(jnp.asarray(q), jnp.asarray(qd))
    t_calls = []
    t_solve = pgs.solve_pgs
    monkeypatch.setattr(pgs, "solve_pgs", lambda *args: t_calls.append((args[0], t_solve(*args))) or t_calls[-1][1])
    zero = torch.zeros(q.shape[0], 0, dtype=torch.float64)
    t_qd = resolve_contacts(t_world, (zero, torch.from_numpy(q)), (zero, torch.from_numpy(qd)), 1e-3)[1]
    return (t_qd, *t_calls[-1]), j_out


@pytest.mark.parametrize("urdf, floating", ROBOTS, ids=IDS)
def test_crba_contact_matches_jax(urdf, floating, monkeypatch):
    j_world, t_world = contact_worlds(urdf, floating, ContactSolverParams(minv_method="crba"))
    q, qd = touching_states(t_world.bodies[1], 7)
    (t_qd, t_a, t_p), (j_qd, j_a, j_p) = resolved(j_world, t_world, q, qd, monkeypatch)
    assert (t_p != 0).any()
    for name, got, want in (("qd", t_qd, j_qd), ("A", t_a, j_a), ("impulses", t_p, j_p)):
        close(got, want, what=name)
    _, aba_world = contact_worlds(urdf, floating, ContactSolverParams())
    zero = torch.zeros(q.shape[0], 0, dtype=torch.float64)
    aba_qd = resolve_contacts(aba_world, (zero, torch.from_numpy(q)), (zero, torch.from_numpy(qd)), 1e-3)[1]
    close(t_qd, aba_qd, tol=1e-10, what="crba against aba")


def test_bf16_delassus_matches_jax(monkeypatch):
    j_world, t_world = contact_worlds(*ROBOTS[0], ContactSolverParams(delassus_dtype="bf16"))
    q, qd = touching_states(t_world.bodies[1], 8)
    (t_qd, t_a, t_p), (j_qd, j_a, j_p) = resolved(j_world, t_world, q, qd, monkeypatch)
    assert (t_p != 0).any()
    for name, got, want in (("A", t_a, j_a), ("impulses", t_p, j_p), ("qd", t_qd, j_qd)):
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale, err_msg=name)
    # the rounding is real: the f32 Delassus differs from the bf16 one
    _, f32_world = contact_worlds(*ROBOTS[0], ContactSolverParams())
    (_, f32_a, _), _ = resolved(j_world, f32_world, q, qd, monkeypatch)
    assert (f32_a - t_a).abs().max() > 1e-6 * t_a.abs().max()
