"""The fused laikago step (tds_tpu_torch.envs.fused_step, driven by
tds_tpu_torch.tools.megastep) on the CPU: its plain version against the JAX
package's step, the C++ golden trajectory and the JAX package's own
fused-step kernel, the packing's schedule tables and refusals, the count of
the operations it needs, and the device dispatch. Inputs are made from numpy seeds. The laikago toes
reach the ground about 65 steps after a standing start at z = 0.48, so the
checks start 3 cm lower or after 100 steps, where the contact rows are
active."""

import dataclasses
import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from tds_tpu.dynamics.jacobian import point_jacobian  # noqa: E402
from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu_torch.contact.mlcp import ContactSolverParams  # noqa: E402
from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import GeomAttachment, Plane, Sphere  # noqa: E402
from tds_tpu_torch.model.joints import JointType  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402
from tds_tpu_torch.tools import megastep, megastep_phases  # noqa: E402
from tds_tpu_torch.utils import cuda_build  # noqa: E402
from tds_tpu_torch.utils import op_count  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "laikago_pd_contact_trajectory.json")
LOWERED_START = (0.0, 0.0, 0.45)  # 3 cm below the standing start: the toes touch at once


@pytest.fixture(scope="module")
def env64():
    return LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=LOWERED_START)


@pytest.fixture(scope="module")
def params64(env64):
    return fused_step.pack_step_params(env64)


def _step_tol(t):
    return 1e-8 if t <= 100 else 1e-6


def test_reference_matches_jax_sim_step_for_200_steps(env64, params64):
    """float64, batch 4, from the lowered start with seeded actions in
    +-0.4: 1e-8 abs + rel to step 100, 1e-6 after (the tolerances of
    tests/test_torch_laikago.py)."""
    batch, rng = 4, np.random.default_rng(2025)
    q, qd = env64.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (batch, env64.action_dim))))
    j_step = jax.jit(jax.vmap(JaxLaikago(dtype=jnp.float64).sim_step))
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    active = []
    for t in range(1, 201):
        active.append(int((fused_step.sphere_distances(params64, q) < 0).sum()))
        action = rng.uniform(-0.4, 0.4, size=(batch, env64.action_dim))
        jq, jqd = j_step(jq, jqd, jnp.asarray(action))
        q, qd = fused_step.mega_step_reference(params64, q, qd, torch.from_numpy(action))
        tol = _step_tol(t)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=tol, atol=tol, err_msg=f"q at step {t}")
        np.testing.assert_allclose(qd.numpy(), np.asarray(jqd), rtol=tol, atol=tol, err_msg=f"qd at step {t}")
    assert min(active[:10]) > 0 and sum(active) > 200


def test_reference_matches_the_golden_pd_contact_trajectory(params64):
    """The C++ reference's 500-step PD contact trajectory with zero action,
    at the tolerances of tests/test_golden_reference.py."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    snaps = golden["snapshots"]
    assert abs(golden["dt"] - params64.dt.item()) < 1e-15
    q = torch.tensor([snaps["0"]["q"]], dtype=torch.float64)
    qd = torch.tensor([snaps["0"]["qd"]], dtype=torch.float64)
    zero = torch.zeros(1, params64.pd_q.numel(), dtype=torch.float64)
    checked = 0
    for t in range(1, 501):
        q, qd = fused_step.mega_step_reference(params64, q, qd, zero)
        if str(t) in snaps:
            tol = _step_tol(t)
            np.testing.assert_allclose(q[0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
            np.testing.assert_allclose(qd[0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
            checked += 1
    assert checked >= 5


def _jax_fused_step(batch):
    """The JAX package's fused-step kernel, built as
    tools/pallas_megastep_experiment.py builds it (one (batch, dof) block,
    zero action), in interpret mode."""
    env = JaxLaikago(dtype=jnp.float32)
    dof_q, dof_qd = env.model.dof_q, env.model.dof_qd

    def step_body(q, qd):
        action = jnp.zeros(q.shape[:-1] + (env.action_dim,), q.dtype)
        return env.sim_step(q, qd, action)

    closed_jaxpr = jax.make_jaxpr(step_body)(jnp.zeros((batch, dof_q), jnp.float32), jnp.zeros((batch, dof_qd), jnp.float32))
    consts = [jnp.asarray(c) for c in closed_jaxpr.consts]
    const_shapes = [c.shape for c in consts]
    consts2d = [jnp.reshape(c, (1, max(1, c.size))) for c in consts]

    def kernel(q_ref, qd_ref, *refs):
        const_refs = refs[: len(consts2d)]
        qo_ref, qdo_ref = refs[len(consts2d) :]
        cs = [jnp.reshape(r[...], shp) for r, shp in zip(const_refs, const_shapes)]
        out = jax.core.eval_jaxpr(closed_jaxpr.jaxpr, cs, q_ref[...], qd_ref[...])
        qo_ref[...] = out[0]
        qdo_ref[...] = out[1]

    raw = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec((batch, dof_q), lambda i: (i, 0)), pl.BlockSpec((batch, dof_qd), lambda i: (i, 0))]
        + [pl.BlockSpec(c.shape, lambda i: (0, 0)) for c in consts2d],
        out_specs=[pl.BlockSpec((batch, dof_q), lambda i: (i, 0)), pl.BlockSpec((batch, dof_qd), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((batch, dof_q), jnp.float32), jax.ShapeDtypeStruct((batch, dof_qd), jnp.float32)],
        interpret=True,
    )
    return jax.jit(lambda q, qd: raw(q, qd, *consts2d))


def test_reference_matches_the_jax_fused_step_kernel():
    """float32, batch 8, one step from a state 100 steps after a standing
    start (every env on the ground): 1e-4 abs + rel on qd and 1e-6 on q.
    That is the size of float32 rounding in this step, through the 12
    M^-1 sweeps over links of 0.1 to 13.7 kg and the cfm = 1e-5 diagonal
    of the contact matrix: the float32 plain step is held to the float64
    one from the same state at the same tolerance."""
    batch = 8
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    params = fused_step.pack_step_params(env)
    noise = np.random.default_rng(5).uniform(-0.05, 0.05, (batch, env.action_dim))
    q, qd = env.initial_state(noise=torch.from_numpy(noise))
    zero = torch.zeros(batch, env.action_dim, dtype=torch.float64)
    for _ in range(100):
        q, qd = fused_step.mega_step_reference(params, q, qd, zero)
    assert bool(((fused_step.sphere_distances(params, q) < 0).sum(-1) > 0).all())
    q32, qd32 = q.float().numpy(), qd.float().numpy()

    jq, jqd = _jax_fused_step(batch)(jnp.asarray(q32), jnp.asarray(qd32))
    params32 = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float32, device="cpu"))
    tq, tqd = fused_step.mega_step_reference(params32, torch.from_numpy(q32), torch.from_numpy(qd32), zero.float())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tqd.numpy(), np.asarray(jqd), rtol=1e-4, atol=1e-4)
    assert np.abs(tqd.numpy() - qd32).max() > 1e-3  # the step moved the state
    q64, qd64 = fused_step.mega_step_reference(params, torch.from_numpy(q32).double(), torch.from_numpy(qd32).double(), zero)
    np.testing.assert_allclose(tq.numpy(), q64.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tqd.numpy(), qd64.numpy(), rtol=1e-4, atol=1e-4)


def _floating(env):
    env.model = dataclasses.replace(env.model, is_floating=True)


def _spherical(env):
    jt = list(env.model.joint_types)
    jt[3] = int(JointType.SPHERICAL)
    env.model = dataclasses.replace(env.model, joint_types=tuple(jt))


def _box_on_the_robot(env):
    ground, robot = env.world.geoms
    env.world = dataclasses.replace(env.world, geoms=(ground, robot + (GeomAttachment(9, Plane()),)))


def _sphere_on_the_ground(env):
    ground, robot = env.world.geoms
    env.world = dataclasses.replace(env.world, geoms=(ground + (GeomAttachment(-1, Sphere(0.1)),), robot))


def _top_k(env):
    env.world = dataclasses.replace(env.world, solver=ContactSolverParams(top_k=2))


@pytest.mark.parametrize(
    "change", [_floating, _spherical, _box_on_the_robot, _sphere_on_the_ground, _top_k],
    ids=["floating", "spherical", "non-sphere-geom", "non-plane-ground", "top_k"],
)
def test_pack_refuses_what_the_kernel_does_not_handle(change):
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    change(env)
    with pytest.raises(NotImplementedError):
        fused_step.pack_step_params(env)


def test_pack_writes_out_the_env(env64, params64):
    p = params64
    assert p.joint_types.dtype == torch.int32 and p.joint_types.tolist() == list(env64.model.joint_types)
    assert p.pd_q.tolist() == list(env64.pd_q_indices())
    assert p.sphere_links.tolist() == [9, 13, 17, 21]
    assert p.friction.tolist() == [0.5] * 4 and p.restitution.tolist() == [0.0] * 4
    assert (p.pgs_iterations, p.num_friction_dir) == (1, 2)
    assert all(getattr(p, f).is_contiguous() and getattr(p, f).device.type == "cpu" for f in fused_step.POINTER_FIELDS)
    assert {getattr(p, f).dtype for f in fused_step.POINTER_FIELDS} == {torch.int32, torch.float64}


def test_schedule_covers_every_link_once_parents_first(env64, params64):
    """The chain and the subtrees hanging from its last link cover the 22
    links once, each subtree a chain, and walking them in order visits every
    parent before its children (the order of the kernel's forward sweeps)."""
    parents = list(env64.model.parents)
    chain, subtrees = params64.chain.tolist(), params64.subtrees.tolist()
    assert chain == [0, 1, 2, 3, 4, 5] and subtrees == [[6, 10], [10, 14], [14, 18], [18, 22]]
    order = chain + [i for start, end in subtrees for i in range(start, end)]
    assert sorted(order) == list(range(len(parents)))
    seen = set()
    for i in order:
        assert parents[i] < 0 or parents[i] in seen
        seen.add(i)
    assert all(parents[start] == chain[-1] for start, _ in subtrees)
    assert all(parents[i] == i - 1 for start, end in subtrees for i in range(start + 1, end))
    assert all(parents[b] == a for a, b in zip(chain, chain[1:]))


def test_sphere_paths_hold_the_point_jacobian_columns(env64, params64):
    """Each sphere's path runs from its link through its parents to the
    root, and its non-fixed links are exactly the columns that the JAX
    package's point Jacobian fills, at a random pose."""
    model = JaxLaikago(dtype=jnp.float64).model
    q = jnp.asarray(np.random.default_rng(3).uniform(-0.5, 0.5, model.dof_q))
    parents, joint_types = list(env64.model.parents), list(env64.model.joint_types)
    qd_offsets = list(env64.model.qd_offsets)
    for link, padded in zip(params64.sphere_links.tolist(), params64.sphere_paths.tolist()):
        path = [i for i in padded if i >= 0]
        assert padded == path + [-1] * (len(padded) - len(path))
        assert path[0] == link and parents[path[-1]] == -1
        assert all(parents[a] == b for a, b in zip(path, path[1:]))
        jac = np.asarray(point_jacobian(model, q, link, jnp.asarray([0.3, -0.2, 0.1])))
        filled = set(np.flatnonzero(np.abs(jac).sum(0) > 1e-12).tolist())
        assert filled == {qd_offsets[i] for i in path if joint_types[i] != int(JointType.FIXED)}


@pytest.mark.parametrize(
    "parents",
    [[-1, 0, 1, 1, 3, 3], [-1, 0, 0, 2, 1], [-1, -1, 0], [-1, 2, 0]],
    ids=["subtree-branches", "subtrees-not-contiguous", "two-roots", "child-before-parent"],
)
def test_schedule_refuses_trees_the_lanes_cannot_walk(parents):
    with pytest.raises(NotImplementedError):
        fused_step.link_schedule(parents)


def test_schedule_of_a_pure_chain_has_no_subtrees():
    assert fused_step.link_schedule([-1, 0, 1, 2]) == ([0, 1, 2, 3], [])
    assert fused_step.sphere_paths([-1, 0, 1, 2], [3, 1]) == [[3, 2, 1, 0], [1, 0, -1, -1]]


def test_phase_cuts_follow_the_kernel_phases():
    """tools/megastep_phases.py cuts the kernel after each phase but the
    last: csrc/megastep.cu marks them PHASE_END(1) ... in order, one for
    each of the tool's phases but the last, and csrc/megastep_phases.cu
    turns the marks into cuts."""
    text = (cuda_build.CSRC / "megastep.cu").read_text()
    kernel = text[text.index("megastep_kernel(const Model<T> m") :]
    marks = re.findall(r"^  PHASE_END\((\d+)\);$", kernel, flags=re.M)
    assert marks == [str(k) for k in range(1, len(megastep_phases.PHASES))]
    assert len(re.findall(r"PHASE_END\(\d+\)", kernel)) == len(marks)
    cuts = (cuda_build.CSRC / "megastep_phases.cu").read_text()
    assert "#define MEGASTEP_PHASE_CUTS" in cuts and '#include "megastep.cu"' in cuts


def test_needed_flops_follow_the_active_contacts(env64, params64):
    """The operations the plain step needs (utils/op_count.py, the work
    term of K2's bound in chip_smoke.py) from the lowered start, where all
    four toes touch, and a standing start in the air: the M^-1 sweeps of
    the 12 contact rows and the contact matrix are most of the first and
    absent from the second."""
    q, qd = env64.initial_state(noise=torch.zeros(1, env64.action_dim, dtype=torch.float64))
    action = torch.full((1, env64.action_dim), 0.1, dtype=torch.float64)
    q, qd = fused_step.mega_step_reference(params64, q, qd, action)
    assert int((fused_step.sphere_distances(params64, q) < 0).sum()) == 4
    touching = op_count.needed_flops(fused_step.mega_step_reference, params64, q, qd, action)
    air = LaikagoEnv(dtype=torch.float64, device="cpu")
    qa, qda = air.initial_state(noise=torch.zeros(1, air.action_dim, dtype=torch.float64))
    qa, qda = fused_step.mega_step_reference(params64, qa, qda, action)
    assert int((fused_step.sphere_distances(params64, qa) < 0).sum()) == 0
    flying = op_count.needed_flops(fused_step.mega_step_reference, params64, qa, qda, action)
    assert 1.5e4 < touching < 3e4 and flying < touching / 2, (touching, flying)


def test_mega_step_runs_the_plain_version_on_the_cpu_and_raises_elsewhere(env64, params64, monkeypatch):
    q, qd = env64.initial_state(noise=torch.zeros(2, env64.action_dim, dtype=torch.float64))
    action = torch.full((2, env64.action_dim), 0.1, dtype=torch.float64)
    expected = env64.sim_step(q, qd, action)
    got = fused_step.mega_step(params64, q, qd, action)
    for a, b in zip(got, expected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    calls = []
    monkeypatch.setattr(fused_step, "mega_step_reference", lambda *args: calls.append(args) or args[1:3])
    before = fused_step.launches
    fused_step.mega_step(params64, q, qd, action)
    assert len(calls) == 1 and fused_step.launches == before

    meta = fused_step.StepParams(*(t.to("meta") if isinstance(t, torch.Tensor) else t for t in params64))
    with pytest.raises(ValueError, match="no mega_step implementation"):
        fused_step.mega_step(meta, q.to("meta"), qd.to("meta"), action.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        fused_step.mega_step(params64, q.to("meta"), qd, action)


def test_experiment_runs_end_to_end_on_the_cpu(capsys):
    """The command line at a tiny size: on CPU tensors the fused step is
    the plain version, which repeats the eager step's arithmetic."""
    megastep.main(["--batch", "2", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "max|dq|=0.000e+00 max|dqd|=0.000e+00" in out
    assert "batch=2 on cpu" in out and "ratio=" in out
