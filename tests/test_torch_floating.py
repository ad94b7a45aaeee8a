"""Floating (quaternion) bases in the port, against the JAX package and the
C++ goldens, float64 on the CPU.

- the dynamics functions on 8 random states of the floating
  ``laikago_toes_zup.urdf`` and ``gym/ant_org.urdf``: FK with ``f_ext`` and
  ``base_applied_force``, ``aba_factor``, ``forward_dynamics`` (correct and
  under ``reference_base_abi_quirk``), ``minv_mul``, ``mass_matrix``, the
  point Jacobian and ``integrate_q``, at 1e-12 (abs + rel); the JAX side is
  one jitted call per model;
- ``tests/golden/laikago_floating_random_sweep.json`` in all three of its
  parts, and the mass matrices of ``ant_dynamics.json`` and
  ``ant_random_sweep.json``, at ``tests/test_golden_reference.py``'s
  tolerances;
- the floating laikago env: 50 ``sim_step``s at batch 4 from a lowered
  start (the toes touch at once) at 1e-8, the reset (no noise), the
  observation and reward/done; ``laikago_floating_contact_trajectory.json``
  replayed by the port alone under the quirk for 500 steps;
- what the quirk switch does to graphs: it is part of a scan's signature.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.dynamics.forward_dynamics import aba_factor as jax_aba_factor  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import forward_dynamics_from_kin as jax_aba  # noqa: E402
from tds_tpu.dynamics.forward_dynamics import minv_mul as jax_minv_mul  # noqa: E402
from tds_tpu.dynamics.integrator import integrate_q as jax_integrate_q  # noqa: E402
from tds_tpu.dynamics.jacobian import point_jacobian as jax_point_jacobian  # noqa: E402
from tds_tpu.dynamics.kinematics import fk_links as jax_fk_links  # noqa: E402
from tds_tpu.dynamics.mass_matrix import mass_matrix as jax_mass_matrix  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.urdf.cache import construct as jax_construct  # noqa: E402
from tds_tpu_torch.algebra import quaternion  # noqa: E402
from tds_tpu_torch.dynamics.forward_dynamics import (  # noqa: E402
    aba_factor,
    forward_dynamics,
    forward_dynamics_from_kin,
    minv_mul,
    reference_base_abi_quirk,
)
from tds_tpu_torch.dynamics.integrator import integrate_q  # noqa: E402
from tds_tpu_torch.dynamics.jacobian import point_jacobian  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links, forward_kinematics  # noqa: E402
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402
from tds_tpu_torch.utils import graphs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LAIKAGO = "laikago/laikago_toes_zup.urdf"
URDFS = (LAIKAGO, "gym/ant_org.urdf")
TOL = 1e-12
GRAVITY = np.array([0.0, 0.0, -9.81])
BATCH, DT = 8, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small operations: torch's intra-op threads only contend with the
    other test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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


def _inputs(model, seed):
    """Random states of the floating model (unit base quaternions), torques,
    link and base forces, 3 right-hand sides for M^-1 and a point."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BATCH, model.dof_q))
    q[:, :4] /= np.linalg.norm(q[:, :4], axis=1, keepdims=True)
    return dict(
        q=q,
        qd=rng.normal(size=(BATCH, model.dof_qd)),
        tau=rng.normal(size=(BATCH, model.dof_actuated)),
        f_ext=rng.normal(size=(BATCH, model.num_links, 6)),
        base_force=rng.normal(size=(BATCH, 6)),
        rhs=rng.normal(size=(3, BATCH, model.dof_qd)),
        point=rng.normal(size=(BATCH, 3)),
    )


def _jax_outputs(model, x):
    """Every function's output from the JAX package, in one jitted call."""
    g = jnp.asarray(GRAVITY)

    def one(q, qd, tau, f_ext, base_force, rhs, point):
        kin = jax_fk_links(model, q, qd, f_ext=f_ext, base_applied_force=base_force)
        factor = jax_aba_factor(model, kin)
        quirk = factor._replace(base_abi_inv_aba=factor.base_abi.inverse_reference_quirk())
        return dict(
            x_world_pos=jnp.stack([t.pos for t in kin.x_world]),
            x_world_rot=jnp.stack([t.rot for t in kin.x_world]),
            v=jnp.stack(kin.v),
            c=jnp.stack(kin.c),
            pA=jnp.stack(kin.pA),
            base_bias=kin.base_bias_force,
            ia=jnp.stack([a.matrix() for a in factor.ia]),
            base_abi=factor.base_abi.matrix(),
            base_abi_inv=factor.base_abi_inv.matrix(),
            qdd=jax_aba(model, kin, q, qd, tau, g, factor=factor),
            qdd_quirk=jax_aba(model, kin, q, qd, tau, g, factor=quirk),
            minv=jax_minv_mul(model, kin, factor, rhs),
            mass_matrix=jax_mass_matrix(model, q),
            jacobian=jax_point_jacobian(model, q, model.num_links - 1, point),
            jacobian_base=jax_point_jacobian(model, q, -1, point),
            integrate_q=jnp.concatenate(jax_integrate_q(model, q, qd, DT), axis=-1),
        )

    keys = ("q", "qd", "tau", "f_ext", "base_force", "rhs", "point")
    axes = tuple(1 if k == "rhs" else 0 for k in keys)
    out = jax.jit(jax.vmap(one, in_axes=axes))(*(jnp.asarray(x[k]) for k in keys))
    out["minv"] = jnp.moveaxis(out["minv"], 0, 1)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_outputs(model, x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    g = torch.from_numpy(GRAVITY)
    kin = fk_links(model, t["q"], t["qd"], f_ext=t["f_ext"], base_applied_force=t["base_force"])
    factor = aba_factor(model, kin)
    with reference_base_abi_quirk():
        quirk = aba_factor(model, kin)
    out = dict(
        x_world_pos=torch.stack([tr.pos for tr in kin.x_world], dim=1),
        x_world_rot=torch.stack([tr.rot for tr in kin.x_world], dim=1),
        v=torch.stack(kin.v, dim=1),
        c=torch.stack(kin.c, dim=1),
        pA=torch.stack(kin.pA, dim=1),
        base_bias=kin.base_bias_force,
        ia=torch.stack([a.matrix().expand(BATCH, 6, 6) for a in factor.ia], dim=1),
        base_abi=factor.base_abi.matrix(),
        base_abi_inv=factor.base_abi_inv.matrix(),
        qdd=forward_dynamics_from_kin(model, kin, t["q"], t["qd"], t["tau"], g, factor=factor),
        qdd_quirk=forward_dynamics_from_kin(model, kin, t["q"], t["qd"], t["tau"], g, factor=quirk),
        minv=minv_mul(model, kin, factor, t["rhs"]),
        mass_matrix=mass_matrix(model, t["q"]),
        jacobian=point_jacobian(model, t["q"], model.num_links - 1, t["point"]),
        jacobian_base=point_jacobian(model, t["q"], -1, t["point"]),
        integrate_q=torch.cat(integrate_q(model, t["q"], t["qd"], DT), dim=-1),
    )
    x_world, v = forward_kinematics(model, t["q"], t["qd"])
    out.update(fk_pos=x_world.pos.transpose(0, 1), fk_rot=x_world.rot.transpose(0, 1), fk_v=v.transpose(0, 1))
    # the public entry point, with f_ext and base_applied_force, is ABA over the same FK
    out["forward_dynamics"] = forward_dynamics(
        model, t["q"], t["qd"], t["tau"], g, f_ext=t["f_ext"], base_applied_force=t["base_force"]
    )
    with reference_base_abi_quirk():
        out["forward_dynamics_quirk"] = forward_dynamics(
            model, t["q"], t["qd"], t["tau"], g, f_ext=t["f_ext"], base_applied_force=t["base_force"]
        )
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module", params=URDFS, ids=["laikago", "ant"])
def outputs(request):
    jax_model, _ = jax_construct(request.param, is_floating=True)
    model, _ = construct(request.param, is_floating=True)
    assert (model.dof_q, model.dof_qd, model.dof_actuated) == (jax_model.dof_q, jax_model.dof_qd, jax_model.dof_actuated)
    x = _inputs(model, seed=len(request.param))
    jax_out = _jax_outputs(jax_model, x)
    jax_out["forward_dynamics"], jax_out["forward_dynamics_quirk"] = jax_out["qdd"], jax_out["qdd_quirk"]
    jax_out["fk_pos"], jax_out["fk_rot"], jax_out["fk_v"] = jax_out["x_world_pos"], jax_out["x_world_rot"], jax_out["v"]
    return _port_outputs(model, x), jax_out, x


@pytest.mark.parametrize(
    "names",
    [
        ("x_world_pos", "x_world_rot", "v", "c", "pA", "base_bias", "fk_pos", "fk_rot", "fk_v"),
        ("ia", "base_abi", "base_abi_inv"),
        ("qdd", "forward_dynamics"),
        ("qdd_quirk", "forward_dynamics_quirk"),
        ("minv",),
        ("mass_matrix",),
        ("jacobian", "jacobian_base"),
        ("integrate_q",),
    ],
    ids=["fk", "aba_factor", "forward_dynamics", "forward_dynamics_quirk", "minv_mul", "mass_matrix", "jacobian", "integrate_q"],
)
def test_dynamics_match_jax(outputs, names):
    port, expected, _ = outputs
    for name in names:
        np.testing.assert_allclose(port[name], expected[name], rtol=TOL, atol=TOL, err_msg=name)


def test_the_quirk_changes_aba_only(outputs):
    """The quirk moves ABA's accelerations; the contact solver's minv_mul
    keeps the correct inverse (both held to the JAX package above)."""
    port = outputs[0]
    assert np.abs(port["qdd_quirk"] - port["qdd"]).max() > 1e-6


def test_mass_matrix_inverts_minv_mul(outputs):
    """M(q) (M^-1 x) = x on the random states: CRBA's floating corner and
    rows against ABA's O(n) factor."""
    port, _, x = outputs
    np.testing.assert_allclose(np.einsum("bij,rbj->rbi", port["mass_matrix"], port["minv"]), x["rhs"], rtol=1e-9, atol=1e-9)


# -- goldens -------------------------------------------------------------------
@pytest.fixture(scope="module")
def sweep():
    with open(os.path.join(GOLDEN, "laikago_floating_random_sweep.json")) as f:
        golden = json.load(f)
    model, _ = construct(LAIKAGO, is_floating=True)
    assert (model.dof_q, model.dof_qd) == (golden["dof"], golden["dof_qd"])
    return model, golden["cases"]


def _sweep_qdd(model, cases):
    q, qd, tau = (torch.tensor([c[k] for c in cases], dtype=torch.float64) for k in ("q", "qd", "tau"))
    return forward_dynamics(model, q, qd, tau, torch.from_numpy(GRAVITY)).numpy()


def test_golden_sweep_correct_aba(sweep):
    """The corrected ABA against the reference's correct-math branch
    (qdd_rbdl, brought back from RBDL's hybrid convention)."""
    model, cases = sweep
    got = _sweep_qdd(model, cases)
    for c, qdd in zip(cases, got):
        q, qd, rb = (np.asarray(c[k]) for k in ("q", "qd", "qdd_rbdl"))
        r = quaternion.to_matrix(torch.tensor(q[:4])).numpy()
        want = rb.copy()
        want[3:6] = r.T @ (rb[3:6] - GRAVITY) - np.cross(qd[0:3], qd[3:6]) + GRAVITY
        np.testing.assert_allclose(qdd, want, rtol=1e-9, atol=1e-9)


def test_golden_sweep_quirk_aba(sweep):
    """Under the quirk, the reference's default ABA."""
    model, cases = sweep
    with reference_base_abi_quirk():
        got = _sweep_qdd(model, cases)
    np.testing.assert_allclose(got, np.asarray([c["qdd"] for c in cases]), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize(
    "golden, urdf, is_floating",
    [
        ("laikago_floating_random_sweep.json", LAIKAGO, True),
        ("ant_dynamics.json", "gym/ant_org_xyz_xyzrot.urdf", False),
        ("ant_random_sweep.json", "gym/ant_org_xyz_xyzrot.urdf", False),
    ],
    ids=["laikago_floating", "ant_dynamics", "ant_random_sweep"],
)
def test_golden_mass_matrices(golden, urdf, is_floating):
    with open(os.path.join(GOLDEN, golden)) as f:
        cases = [c for c in json.load(f)["cases"] if "mass_matrix" in c]
    model, _ = construct(urdf, is_floating=is_floating)
    m = mass_matrix(model, torch.tensor([c["q"] for c in cases], dtype=torch.float64))
    np.testing.assert_allclose(m.numpy(), np.asarray([c["mass_matrix"] for c in cases]), rtol=1e-10, atol=1e-12)


def test_spherical_mass_matrix_inverts_minv_mul():
    """The spherical blocks (the humanoid's base joint, fixed base): M(q)
    times minv_mul's M^-1 x is x."""
    model, _ = construct("humanoid_xyz_spherical.urdf")
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, model.dof_q))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q = torch.from_numpy(q)
    x = torch.from_numpy(rng.normal(size=(2, 2, model.dof_qd)))
    kin = fk_links(model, q, torch.zeros(2, model.dof_qd, dtype=torch.float64))
    y = minv_mul(model, kin, aba_factor(model, kin), x)
    np.testing.assert_allclose((mass_matrix(model, q) @ y[..., None])[..., 0].numpy(), x.numpy(), rtol=1e-9, atol=1e-9)


# -- the floating laikago env -----------------------------------------------------
START = (0.0, 0.0, 0.45)  # lowered 3 cm: the toes touch from the first steps


@pytest.fixture(scope="module")
def envs():
    return (
        JaxLaikago(urdf=LAIKAGO, is_floating=True, dtype=jnp.float64, start_base_position=START),
        LaikagoEnv(urdf=LAIKAGO, is_floating=True, dtype=torch.float64, device="cpu", start_base_position=START),
    )


@pytest.fixture(scope="module")
def jax_step(envs):
    return jax.jit(jax.vmap(envs[0].sim_step))


def test_sim_step_matches_jax_for_50_steps(envs, jax_step, monkeypatch):
    from tds_tpu_torch.contact import pgs

    j_env, t_env = envs
    active, solve = [], pgs.solve_pgs

    def recording(a, b, *args):
        active.append(int((b != 0).sum()))
        return solve(a, b, *args)

    monkeypatch.setattr(pgs, "solve_pgs", recording)
    assert t_env.skip_links == 0 and t_env.observation_dim == 19 + 18
    q, qd = t_env.initial_state(batch_size=4)
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    rng = np.random.default_rng(50)
    for t in range(1, 51):
        action = rng.uniform(-0.4, 0.4, size=(4, t_env.action_dim))
        jq, jqd = jax_step(jq, jqd, jnp.asarray(action))
        q, qd = t_env.sim_step(q, qd, torch.from_numpy(action))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-8, atol=1e-8, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=1e-8, atol=1e-8, err_msg=f"qd at step {t}")
    assert len(active) == 50 and min(active[:5]) > 0  # the toes touch from the first steps


def test_reset_observation_reward_done(envs, jax_step):
    """The floating start draws no noise (the JAX package's ignores its
    key); the reset's 10 settle steps, the observation, a step and
    reward/done match the JAX package's."""
    j_env, t_env = envs
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jq, jqd = jax.vmap(j_env.initial_state)(keys)
    q1, _ = t_env.initial_state(torch.Generator().manual_seed(1), batch_size=2)
    q2, _ = t_env.initial_state(torch.Generator().manual_seed(2), batch_size=2)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q1[:, 4:7].numpy(), [START] * 2)
    zero = jnp.zeros((2, j_env.action_dim))
    for _ in range(j_env.settle_steps):
        jq, jqd = jax_step(jq, jqd, zero)
    state, obs = t_env.reset(torch.Generator().manual_seed(9), batch_size=2)
    np.testing.assert_allclose(state.q.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(state.qd.numpy(), np.asarray(jqd), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(obs.numpy(), np.asarray(j_env.observation(jq, jqd)), rtol=1e-10, atol=1e-10)
    q, qd = state.q.numpy().copy(), state.qd.numpy()
    q[1, 6] = 0.1  # base too low
    tilted = q.copy()
    tilted[:, 0:4] = (np.sin(0.6), 0.0, 0.0, np.cos(0.6))  # rolled 69 degrees: up.z < 0.6
    for qq, done in ((q, [False, True]), (tilted, [True, True])):
        j_reward, j_done = jax.vmap(j_env.reward_done)(*(jnp.asarray(a) for a in (q, qd, qq, qd)))
        t_reward, t_done = t_env.reward_done(*(torch.from_numpy(a) for a in (q, qd, qq, qd)))
        assert t_done.tolist() == done == np.asarray(j_done).tolist()
        np.testing.assert_allclose(t_reward.numpy(), np.asarray(j_reward), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_env._base_yaw(torch.from_numpy(tilted)).numpy(), np.asarray(j_env._base_yaw(jnp.asarray(tilted))),
                               rtol=1e-12, atol=1e-12)


def test_reset_pool_zeroes_the_base_x(envs):
    """Pool resets translate a floating base back to x = 0 at q[4]."""
    _, t_env = envs
    q, qd = t_env.initial_state(batch_size=2)
    q[:, 4] = 3.0
    env = LaikagoEnv(urdf=LAIKAGO, is_floating=True, dtype=torch.float64, device="cpu", settle_steps=0,
                     reset_pool=(q.numpy(), qd.numpy()), reset_pool_prob=1.0)
    state, _ = env.reset(batch_size=2, pool_draws=(torch.tensor([True, False]), torch.tensor([0, 1])))
    assert state.q[0, 4] == 0.0 and state.q[1, 4] == 0.0 and state.q[0, 5] == q[0, 5]


def test_golden_floating_contact_trajectory_under_the_quirk():
    """The C++ reference's 500-step floating laikago (zero action), made by
    its default floating ABA: replayed under the quirk at 1e-8 to step 100
    and 1e-6 after, as tests/test_golden_reference.py holds the JAX
    package."""
    env = LaikagoEnv(urdf=LAIKAGO, is_floating=True, dtype=torch.float64, device="cpu")
    with open(os.path.join(GOLDEN, "laikago_floating_contact_trajectory.json")) as f:
        golden = json.load(f)
    snaps = golden["snapshots"]
    assert abs(golden["dt"] - env.dt) < 1e-15
    q = torch.tensor([snaps["0"]["q"]], dtype=torch.float64)
    qd = torch.tensor([snaps["0"]["qd"]], dtype=torch.float64)
    zero = torch.zeros(1, env.action_dim, dtype=torch.float64)
    checked = 0
    with reference_base_abi_quirk():
        for t in range(1, 501):
            q, qd = env.sim_step(q, qd, zero)
            if str(t) in snaps:
                tol = 1e-8 if t <= 100 else 1e-6
                np.testing.assert_allclose(q[0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
                np.testing.assert_allclose(qd[0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
                checked += 1
    assert checked >= 10


def test_the_quirk_is_a_graph_switch():
    """The quirk is read through graphs.switched, so it enters every scan
    signature; outside the block it is off again."""
    import importlib

    fd = importlib.import_module("tds_tpu_torch.dynamics.forward_dynamics")  # the module, not the package's function

    assert not graphs.switched(fd.QUIRK)
    with reference_base_abi_quirk():
        assert graphs.switched(fd.QUIRK)
        with graphs.switch(fd.QUIRK, False):
            assert not graphs.switched(fd.QUIRK)
        assert graphs.switched(fd.QUIRK)
    assert not graphs.switched(fd.QUIRK) and fd.QUIRK not in graphs._switches


def test_floating_ant_steps_like_jax():
    """The ant's ``is_floating=True`` (on ``gym/ant_org.urdf``): every joint
    PD-controlled, 5 CPU steps from the standing start at batch 2 matching
    the JAX package's at 1e-10."""
    from tds_tpu.envs.ant import AntEnv as JaxAnt
    from tds_tpu_torch.envs.ant import AntEnv

    env = AntEnv(urdf="gym/ant_org.urdf", is_floating=True, dtype=torch.float64, device="cpu")
    j_env = JaxAnt(urdf="gym/ant_org.urdf", is_floating=True, dtype=jnp.float64)
    assert env.skip_links == 0 and env.action_dim == j_env.action_dim == 8
    q, qd = env.initial_state(batch_size=2)
    jq, jqd = jax.vmap(j_env.initial_state)(jax.random.split(jax.random.PRNGKey(0), 2))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    step = jax.jit(jax.vmap(j_env.sim_step))
    action = np.random.default_rng(4).uniform(-0.3, 0.3, size=(2, env.action_dim))
    for _ in range(5):
        q, qd = env.sim_step(q, qd, torch.from_numpy(action))
        jq, jqd = step(jq, jqd, jnp.asarray(action))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=1e-10, atol=1e-10)


def test_floating_humanoid_constructs_like_jax():
    """The humanoid's ``is_floating=True`` (on ``humanoid.urdf``): no base
    links (``n_base_links`` 0), every 1-DoF joint PD-controlled, the JAX
    package's layout and standing start; a CPU step stays finite. (A JAX
    step of the 105-row humanoid costs tens of seconds to compile, so its
    dynamics are held in tests/test_torch_humanoid.py's fixed-base form.)"""
    from tds_tpu.envs.humanoid import HumanoidEnv as JaxHumanoid
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    env = HumanoidEnv(urdf="humanoid.urdf", is_floating=True, dtype=torch.float64, device="cpu")
    j_env = JaxHumanoid(urdf="humanoid.urdf", is_floating=True, dtype=jnp.float64)
    assert env.skip_links == j_env.skip_links == 0 and env.model.is_floating
    assert (env.action_dim, env.observation_dim) == (j_env.action_dim, j_env.observation_dim)
    q, qd = env.initial_state(batch_size=1)
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(j_env.initial_state(jax.random.PRNGKey(0))[0]))
    q, qd = env.sim_step(q, qd, torch.zeros(1, env.action_dim, dtype=torch.float64))
    assert torch.isfinite(q).all() and torch.isfinite(qd).all()
