"""The port's terrain laikago against the JAX package's, float64 on the CPU:
``LaikagoEnv`` on bench.py's terrain (the +-2 cm sinusoid on 13 x 7
vertices, max_contacts 3, the 8 deepest of 12 candidates kept) with its 9
scan points and a reset pool made from a numpy seed.

- ``reset`` from the JAX package's draws for two keys, one whose reset
  keeps the settled state and one whose reset takes a pool state, at 1e-12;
- 200 ``sim_step``s from those states under a fixed sinusoid of amplitude
  0.3, q, qd and the observation (scan columns included): 1e-8 to step
  100, 1e-6 to step 200, the laikago slice's tolerances; the toes cross
  triangles of the grid on the way;
- the ``Mesh`` form of the same terrain, 50 steps at 1e-8.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.model import geometry as j_geometry  # noqa: E402
from tds_tpu.utils import terrain as j_terrain  # noqa: E402
from tds_tpu_torch.collision import narrowphase  # noqa: E402
from tds_tpu_torch.dynamics.kinematics import fk_links  # noqa: E402
from tds_tpu_torch.envs.laikago import LAIKAGO_INITIAL_POSES, LaikagoEnv  # noqa: E402
from tds_tpu_torch.model.geometry import Mesh  # noqa: E402
from tds_tpu_torch.tools.ars_train import SCAN_GRID  # noqa: E402
from tds_tpu_torch.utils import terrain  # noqa: E402


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

GRID = (13, 7, (-1.0, 5.0), (-1.5, 1.5))
POOL_SIZE, PROB = 5, 0.5


def bump(x, y):
    return 0.02 * math.sin(math.pi * x) * math.cos(math.pi * y)


def step_tol(t):
    return 1e-8 if t <= 100 else 1e-6


def action(t, batch):
    """The driven action at step t: 0.3 sin(0.05 t + 0.5 j) on joint j."""
    return np.tile(0.3 * np.sin(0.05 * t + 0.5 * np.arange(12)), (batch, 1))


def make_pool():
    """Standing poses with base y in [0.2, 0.3] (toes near the y = 0 cell
    border), x anywhere (a pool reset sets it to 0), small tilts and
    joint offsets, and random velocities, from a numpy seed."""
    rng = np.random.default_rng(8)
    q = np.zeros((POOL_SIZE, 18))
    q[:, 0] = rng.uniform(0.5, 2.0, POOL_SIZE)
    q[:, 1] = rng.uniform(0.2, 0.3, POOL_SIZE)
    q[:, 2] = rng.uniform(0.44, 0.47, POOL_SIZE)
    q[:, 3:6] = rng.uniform(-0.05, 0.05, (POOL_SIZE, 3))
    q[:, 6:] = np.asarray(LAIKAGO_INITIAL_POSES) + rng.uniform(-0.1, 0.1, (POOL_SIZE, 12))
    return q, rng.normal(0.0, 0.2, (POOL_SIZE, 18))


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """(JAX env, port env) on the heightfield with the pool, and (JAX env,
    port env) on the mesh of the same grid."""
    pool = make_pool()
    path = terrain.write_heightfield(str(tmp_path_factory.mktemp("terrain") / "bench.obj"), *GRID, bump)
    j_hf = j_terrain.make_heightfield(*GRID, bump, max_contacts=3)
    hf = terrain.make_heightfield(*GRID, bump, max_contacts=3)
    return (
        JaxLaikago(dtype=jnp.float64, terrain=j_hf, height_scan=SCAN_GRID, reset_pool=pool, reset_pool_prob=PROB),
        LaikagoEnv(dtype=torch.float64, device="cpu", terrain=hf, height_scan=SCAN_GRID, reset_pool=pool,
                   reset_pool_prob=PROB),
        JaxLaikago(dtype=jnp.float64, terrain=j_geometry.Mesh(file_name=path, max_contacts=3), height_scan=SCAN_GRID),
        LaikagoEnv(dtype=torch.float64, device="cpu", terrain=Mesh(file_name=path, max_contacts=3), height_scan=SCAN_GRID),
    )


def jax_draws(key):
    """The JAX reset's draws for ``key`` (tds_tpu/envs/locomotion.py:234-263):
    the joint noise, and after the settle steps the pool's use and index."""
    key, sub = jax.random.split(key)
    noise = jax.random.uniform(sub, (12,), minval=-0.05, maxval=0.05, dtype=jnp.float64)
    _, k_use, k_idx = jax.random.split(key, 3)
    return np.asarray(noise), bool(jax.random.bernoulli(k_use, PROB)), int(jax.random.randint(k_idx, (), 0, POOL_SIZE))


@pytest.fixture(scope="module")
def resets(envs):
    """The JAX reset of two keys, the first keeping its settled state and
    the second taking a pool state, and the port's reset from their draws."""
    j_env, t_env = envs[:2]
    by_use = {}
    for seed in range(50):
        by_use.setdefault(jax_draws(jax.random.PRNGKey(seed))[1], jax.random.PRNGKey(seed))
    keys = jnp.stack([by_use[False], by_use[True]])
    noise, use, idx = (np.stack(x) for x in zip(*(jax_draws(k) for k in keys)))
    assert use.tolist() == [False, True]
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    t_state, t_obs = t_env.reset(noise=torch.from_numpy(noise), pool_draws=(torch.from_numpy(use), torch.from_numpy(idx)))
    return j_state, j_obs, t_state, t_obs, idx


def test_reset_with_a_pool_matches_jax(envs, resets):
    j_state, j_obs, t_state, t_obs, idx = resets
    for got, want, what in ((t_state.q, j_state.q, "q"), (t_state.qd, j_state.qd, "qd"), (t_obs, j_obs, "obs")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12, err_msg=what)
    # the second env starts from its pool state, translated to x = 0
    pool_q, pool_qd = make_pool()
    expected = pool_q[idx[1]].copy()
    expected[0] = 0.0
    np.testing.assert_array_equal(t_state.q[1].numpy(), expected)
    np.testing.assert_array_equal(t_state.qd[1].numpy(), pool_qd[idx[1]])
    assert t_obs.shape == (2, 36 + len(SCAN_GRID))


def triangle_ids(env, q):
    """(B, 4) the grid triangle under each toe: cell i, j and the side of
    the cell's diagonal, as one integer."""
    kin = fk_links(env.model, q, q.new_zeros(q.shape[0], env.model.dof_qd))
    toes = torch.stack([kin.x_world[g.link_index].pos for g in env.world.geoms[1]], 1)
    hf = env.terrain
    i, j = narrowphase._cell_index(hf, toes[..., 0], toes[..., 1])
    x0, y0, dx, dy = narrowphase._grid(hf)
    upper = (toes[..., 1] - y0) / dy - j > (toes[..., 0] - x0) / dx - i
    return (j * hf.nx + i) * 2 + upper.long()


def test_200_steps_match_jax(envs, resets):
    j_env, t_env = envs[:2]
    j_state, _, t_state, _, _ = resets
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    j_observation = jax.jit(jax.vmap(j_env.observation))
    q, qd = j_state.q, j_state.qd
    tq, tqd = t_state.q, t_state.qd
    tri, crossings = triangle_ids(t_env, tq), 0
    for t in range(1, 201):
        a = action(t, 2)
        q, qd = j_step(q, qd, jnp.asarray(a))
        tq, tqd = t_env.sim_step(tq, tqd, torch.from_numpy(a))
        tol = step_tol(t)
        for got, want, what in ((tq, q, "q"), (tqd, qd, "qd"), (t_env.observation(tq, tqd), j_observation(q, qd), "obs")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=f"{what} at step {t}")
        tri, before = triangle_ids(t_env, tq), tri
        crossings += int((tri != before).sum())
    assert crossings >= 2, f"the toes crossed {crossings} triangle borders of the grid"
    assert np.isfinite(np.asarray(q)).all()


def test_mesh_terrain_50_steps_match_jax(envs, resets):
    j_env, t_env = envs[2:]
    j_state, _, t_state, _, _ = resets
    j_step = jax.jit(jax.vmap(j_env.sim_step))
    j_observation = jax.jit(jax.vmap(j_env.observation))
    q, qd = j_state.q, j_state.qd
    tq, tqd = t_state.q, t_state.qd
    for t in range(1, 51):
        a = action(t, 2)
        q, qd = j_step(q, qd, jnp.asarray(a))
        tq, tqd = t_env.sim_step(tq, tqd, torch.from_numpy(a))
        for got, want, what in ((tq, q, "q"), (tqd, qd, "qd"), (t_env.observation(tq, tqd), j_observation(q, qd), "obs")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-8, err_msg=f"{what} at step {t}")
