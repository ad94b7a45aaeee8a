"""ARS split over processes in the port (tds_tpu_torch.parallel and
learn/ars.py's ``mesh``) on the CPU: two ranks under gloo, joined through a
FileStore in the test's directory (no TCP port), each rolling out half of
cartpole's 8 directions for 200 steps in float64. Both ranks' updates
equal each other and the one-process update bit for bit, and agree with
the JAX package's sharded iteration on its 8 virtual CPU devices
(tests/conftest.py) within 1e-12, from the draws its key makes.

The ranks run this file as a script (``python test_torch_distributed.py
RANK WORLD STORE DRAWS OUT``), which imports torch and the port only. The
trainer (tools/ars_train.py) runs under torchrun with two gloo ranks on
the CPU, where only rank 0 may print, checkpoint and log.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tds_tpu_torch.envs.cartpole import CartpoleEnv  # noqa: E402
from tds_tpu_torch.learn import ars  # noqa: E402
from tds_tpu_torch.learn.nn import MLPSpec  # noqa: E402
from tds_tpu_torch.parallel.mesh import Mesh, batch_sharding, gather_batch, make_mesh, replicated, shard_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DIRECTIONS, ROLLOUT_LENGTH, WORLD = 8, 200, 2
CONFIG = dict(num_directions=N_DIRECTIONS, rollout_length=ROLLOUT_LENGTH, delta_std=0.1, step_size=0.1)
JAX_TOL = 1e-12  # float64: the cartpole's ABA and Euler over 200 steps (test_torch_cartpole.py holds 1e-12)


def port_iteration(deltas, noise, mesh=None):
    """The port's iteration from the zero policy on the given draws:
    (params, (count, mean, m2), total_timesteps, metrics) as numpy."""
    env = CartpoleEnv(dtype=torch.float64, device="cpu")
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    config = ars.ARSConfig(**CONFIG)
    state = ars.init_ars(env, policy, seed=0)
    new, metrics = ars.ars_iteration(env, policy, config, state, torch.from_numpy(deltas), torch.from_numpy(noise), mesh=mesh)
    stat = tuple(np.asarray(x) for x in new.obs_stat)
    return new.params.numpy(), stat, int(new.total_timesteps), {k: float(v) for k, v in metrics.items()}


def rank_main(rank, world, store, draws_path, out_path):
    """One rank: join the group, check the shard and gather round trips,
    run the split iteration and save what it computed."""
    import torch.distributed as dist

    from tds_tpu_torch.parallel.distributed import initialize_distributed, is_primary, local_batch_size

    torch.set_num_threads(1)
    device = initialize_distributed(f"file://{store}", world, rank, device="cpu")
    mesh = make_mesh(device)
    assert (mesh.rank, mesh.size) == (rank, world) and is_primary() == (rank == 0)
    assert local_batch_size(N_DIRECTIONS) == N_DIRECTIONS // world
    tree = {"x": torch.arange(24, dtype=torch.float64).reshape(8, 3), "alive": torch.arange(8) % 3 == 0,
            "steps": torch.arange(8, dtype=torch.int64)}
    local = shard_batch(tree, mesh)
    assert local["x"][0, 0].item() == 12.0 * rank and local["alive"].shape == (4,)
    back = gather_batch(local, mesh)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    draws = np.load(draws_path)
    params, stat, steps, metrics = port_iteration(draws["deltas"], draws["noise"], mesh)
    np.savez(out_path, params=params, count=stat[0], mean=stat[1], m2=stat[2], steps=steps,
             metrics=np.array([metrics[k] for k in sorted(metrics)]))
    dist.destroy_process_group()


def jax_sharded_iteration():
    """The JAX package's make_train_step(..., mesh=make_mesh()) iteration on
    cartpole in float64 from PRNGKey(0), and its draws recreated from the
    key (tests/test_torch_ars.py's jax_iteration does the same for laikago)."""
    import jax
    import jax.numpy as jnp

    from tds_tpu.envs.cartpole import CartpoleEnv as JaxCartpole
    from tds_tpu.learn import ars as j_ars
    from tds_tpu.learn.nn import linear_policy
    from tds_tpu.parallel.mesh import make_mesh as jax_make_mesh

    env = JaxCartpole(dtype=jnp.float64)
    policy = linear_policy(env.observation_dim, env.action_dim)
    state = j_ars.init_ars(env, policy, jax.random.PRNGKey(0), dtype=jnp.float64)
    new, metrics = j_ars.make_train_step(env, policy, j_ars.ARSConfig(**CONFIG), mesh=jax_make_mesh())(state)
    _, k_delta, k_env = jax.random.split(state.key, 3)
    deltas = jax.random.normal(k_delta, (N_DIRECTIONS, policy.num_parameters), jnp.float64)
    noise = [jax.random.uniform(jax.random.split(k)[1], (4,), minval=-0.05, maxval=0.05)
             for k in jax.random.split(k_env, N_DIRECTIONS)]
    return new, metrics, np.array(deltas), np.stack([np.asarray(x) for x in noise])


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread; the JAX reference compiled without XLA's
    optimisation passes."""
    import jax

    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()
    torch.set_num_threads(threads)


def test_two_ranks_match_one_process_and_jax(tmp_path):
    """Two gloo ranks (processes) against the one-process port iteration
    (bit for bit) and the JAX package's 8-device sharded one (1e-12)."""
    import jax

    assert len(jax.devices()) == 8, "tests/conftest.py gives JAX 8 virtual CPU devices"
    j_state, j_metrics, deltas, noise = jax_sharded_iteration()
    draws = tmp_path / "draws.npz"
    np.savez(draws, deltas=deltas, noise=noise)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    env.pop("MASTER_ADDR", None), env.pop("MASTER_PORT", None)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(WORLD), str(tmp_path / "store"), str(draws),
                          str(tmp_path / f"rank{r}.npz")], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        for r in range(WORLD)
    ]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, f"rank {r}:\n{out.decode()}"
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]

    params, stat, steps, metrics = port_iteration(deltas, noise)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["params"], params, err_msg=f"rank {r}")
        for name, want in zip(("count", "mean", "m2"), stat):
            np.testing.assert_array_equal(got[name], want, err_msg=f"rank {r} {name}")
        assert int(got["steps"]) == steps
        np.testing.assert_array_equal(got["metrics"], [metrics[k] for k in sorted(metrics)])
    assert np.abs(params).max() > 0 and 0 < steps < 2 * N_DIRECTIONS * ROLLOUT_LENGTH

    np.testing.assert_allclose(params, np.asarray(j_state.params), rtol=JAX_TOL, atol=JAX_TOL)
    for name, got in zip(("count", "mean", "m2"), stat):
        np.testing.assert_allclose(got, np.asarray(getattr(j_state.obs_stat, name)), rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)
    assert steps == int(j_state.total_timesteps)
    for k in j_metrics:
        np.testing.assert_allclose(metrics[k], float(j_metrics[k]), rtol=JAX_TOL, atol=JAX_TOL, err_msg=k)


def test_trainer_under_torchrun_two_ranks(tmp_path):
    """``torchrun --standalone --nproc_per_node=2 -m tds_tpu_torch.tools.ars_train``
    on the CPU (gloo): both ranks exit 0, and rank 0 alone prints each
    iteration, writes the checkpoint and its .best, and makes the one
    Experiment run beside them."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep),
               OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    folder = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
           "tds_tpu_torch.tools.ars_train", "--device", "cpu", "--num_directions", "2", "--rollout_length", "10",
           "--iterations", "2", "--eval_interval", "2", "--checkpoint", str(folder / "policy.pkl")]
    proc = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, timeout=180)
    out = proc.stdout.decode()
    assert proc.returncode == 0, out + proc.stderr.decode()
    lines = out.splitlines()
    assert sum(line.startswith("2 ranks (gloo), 1 directions each") for line in lines) == 1, out
    assert [line.split(" ", 1)[0] for line in lines if line.startswith(("0 {", "1 {"))] == ["0", "1"], out
    runs = [p for p in folder.iterdir() if p.is_dir()]
    assert sorted(p.name for p in folder.iterdir() if p.is_file()) == ["policy.pkl", "policy.pkl.best"]
    assert len(runs) == 1 and (runs[0] / "settings.json").exists(), runs
    rows = (runs[0] / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["step"] for r in rows] == [0, 1]


def test_directions_must_split_over_the_ranks():
    """A direction count that the world size does not divide raises, at
    make_train_step and in the iteration; shardings' bounds."""
    env = CartpoleEnv(dtype=torch.float64, device="cpu")
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    three = Mesh(None, 1, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        ars.make_train_step(env, policy, ars.ARSConfig(**CONFIG), mesh=three)
    state = ars.init_ars(env, policy, seed=0)
    deltas, noise, _ = ars.draw_directions(env, state, N_DIRECTIONS)
    with pytest.raises(ValueError, match="does not split"):
        ars.ars_iteration(env, policy, ars.ARSConfig(**CONFIG), state, deltas, noise, mesh=three)
    assert batch_sharding(Mesh(None, 1, 4, torch.device("cpu"))).bounds(8) == (2, 4)
    assert replicated(three).bounds(9) == (0, 9)
    # a mesh of one rank without a process group: the iteration is the plain one
    alone = make_mesh("cpu")
    assert (alone.rank, alone.size) == (0, 1)
    x = torch.arange(6.0)
    assert torch.equal(gather_batch(shard_batch(x, alone), alone), x)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        gather_batch(x, three)


def test_rank_without_a_card_raises(monkeypatch):
    """A rank whose LOCAL_RANK names no card raises unless its device is
    named; no configuration at all stays single-process."""
    from tds_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_device", None)
    monkeypatch.setenv("LOCAL_RANK", "7")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    if torch.cuda.device_count() <= 7:
        with pytest.raises(RuntimeError, match="no CUDA device of its own"):
            distributed.initialize_distributed()
    assert distributed.initialize_distributed(device="cpu") == torch.device("cpu")
    assert distributed.world_size() == 1 and distributed.is_primary()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
