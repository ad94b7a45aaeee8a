"""Mocap tracking in the port on the CPU: the motion blend
(tds_tpu_torch.utils.motion_import) against the JAX package's, the
batched tracking loop of tools/mocap_track.py against
examples/laikago_mocap_tracking.py's step in float64, and the tool's
command line at a tiny size."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.envs.laikago import LaikagoEnv as JaxLaikago  # noqa: E402
from tds_tpu.utils.file_utils import find_file  # noqa: E402
from tds_tpu.utils.motion_import import LOOP_CLAMP, LOOP_WRAP  # noqa: E402
from tds_tpu.utils.motion_import import Motion as JaxMotion  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402
from tds_tpu_torch.tools import mocap_track  # noqa: E402
from tds_tpu_torch.utils.motion_import import Motion  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread; the JAX reference compiled without XLA's
    optimisation passes (one compile of the batched step, ~15 s)."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()
    torch.set_num_threads(threads)


BLEND_TOL = 1e-12  # float64, the same blend arithmetic
TRACK_TOL = 1e-9  # float64, 20 laikago steps (1e-8 holds over 100, tests/test_torch_laikago.py)
SPEEDUPS = (0.8, 1.0, 1.2)


@pytest.fixture(scope="module")
def dance():
    path = find_file("laikago_dance_sidestep0.txt")
    return JaxMotion.load_from_file(path), Motion.load_from_file(path, device="cpu")


def check_blend(j_motion, motion, times):
    want = np.stack([np.asarray(j_motion.calculate_frame(t)) for t in times])
    np.testing.assert_allclose(motion.calculate_frame(torch.tensor(times)).numpy(), want, rtol=BLEND_TOL, atol=BLEND_TOL)
    for t, w in zip(times, want):  # scalar times
        np.testing.assert_allclose(motion.calculate_frame(float(t)).numpy(), w, rtol=BLEND_TOL, atol=BLEND_TOL)


def test_calculate_frame_matches_jax(dance):
    """The dance clip in both loop modes: random times over 1.5 clips,
    frame hits, negative times (wrapped by a floor modulo, clamped to the
    first frame) and the clamp's end (the final frame held)."""
    j_motion, motion = dance
    assert motion.frames.shape == (208, 19) and motion.loop_mode == LOOP_WRAP
    assert motion.frame_duration == j_motion.frame_duration and motion.total_duration == j_motion.total_duration
    np.testing.assert_array_equal(motion.frames.numpy(), np.asarray(j_motion.frames))
    fd, total = motion.frame_duration, motion.total_duration
    rng = np.random.RandomState(0)
    times = np.concatenate([
        rng.uniform(0.0, total * 1.5, size=32),
        [0.0, fd, 2.5 * fd, total - fd / 2, total, total + 0.3 * fd],
        -rng.uniform(0.0, total * 1.5, size=8), [-fd, -0.5 * fd, -1e-4],
    ])
    for mode in (LOOP_WRAP, LOOP_CLAMP):
        check_blend(JaxMotion(j_motion.frames, fd, mode), Motion(motion.frames, fd, mode, device="cpu"), times)
    clamp = Motion(motion.frames, fd, LOOP_CLAMP, device="cpu")
    np.testing.assert_array_equal(clamp.calculate_frame(total * 2).numpy(), motion.frames[-1].numpy())
    # tests/test_motion_import.py's small clip: midpoints past the end, frame hits
    frames = np.arange(8.0).reshape(4, 2) * np.array([1.0, 10.0])
    for mode in (LOOP_WRAP, LOOP_CLAMP):
        check_blend(JaxMotion(frames, 0.5, mode), Motion(frames, 0.5, mode, device="cpu"),
                    np.array([0.0, 0.5, 1.0, 1.5, 1.75, 2.1, -0.25, -2.3]))
    # batched over a (2, 3) time tensor
    grid = torch.linspace(-1.0, 9.0, 6, dtype=torch.float64).reshape(2, 3)
    assert motion.calculate_frame(grid).shape == (2, 3, 19)


def jax_example_steps(q0, qd0, steps, speedups):
    """examples/laikago_mocap_tracking.py's step on the JAX package's
    LaikagoEnv(action_limit=1.2) and Motion in float64, batched with
    jax.vmap over envs with their own speedups; per step (q, qd, rms,
    height, up.z). The blend, the step and the base pose are compiled
    apart: one program of all three takes 5 s longer to compile."""
    env = JaxLaikago(dtype=jnp.float64, action_limit=mocap_track.ACTION_LIMIT)
    motion = JaxMotion.load_from_file(find_file(mocap_track.DANCE))
    frame = jax.jit(jax.vmap(lambda t: motion.calculate_frame(t)[7:19]))
    sim_step = jax.jit(jax.vmap(env.sim_step))
    pose = jax.jit(jax.vmap(env.base_pose_xyz_rpy))
    q, qd, out = jnp.asarray(q0), jnp.asarray(qd0), []
    speedups = jnp.asarray(speedups)
    for i in range(steps):
        target = frame(i * env.dt * speedups)
        q, qd = sim_step(q, qd, target - env.initial_poses)
        err = q[..., 6:18] - target
        pos, up = pose(q)
        out.append([np.asarray(x) for x in (q, qd, jnp.sqrt(jnp.mean(err**2, -1)), pos[:, 2], up)])
    return out


@pytest.fixture(scope="module")
def starts():
    """Batch 3 from the tool's noisy standing start (the example's, toes in
    the air for the first ~65 steps) and the same lowered by 2.5 cm (toes
    in contact from the first steps)."""
    env = mocap_track.make_env(torch.float64, "cpu", fused=False)
    q0, qd0 = mocap_track.start_state(env, 3, seed=0)
    low = q0.clone()
    low[:, 2] -= 0.025
    return {"standing": (q0, qd0), "touching": (low, qd0)}


@pytest.fixture(scope="module")
def jax_runs(starts):
    """The example's 20 steps from both starts, one batch of 6 (one compile)."""
    names = list(starts)
    q = np.concatenate([starts[n][0].numpy() for n in names])
    qd = np.concatenate([starts[n][1].numpy() for n in names])
    steps = jax_example_steps(q, qd, 20, SPEEDUPS * len(names))
    return {n: [[x[3 * i : 3 * i + 3] for x in step] for step in steps] for i, n in enumerate(names)}


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("start", ["standing", "touching"])
def test_tracking_steps_match_the_example(starts, jax_runs, start, fused):
    """20 steps of the tool's step at speedups 0.8, 1.0, 1.2 (the eager
    step, and K2's plain version) against the example's, every step's
    state, RMS, height and up.z within 1e-9; from the lowered start the
    contact rows are active."""
    env = mocap_track.make_env(torch.float64, "cpu", fused=fused)
    motion = mocap_track.load_motion(torch.float64, "cpu")
    q, qd = starts[start]
    speedup = torch.tensor(SPEEDUPS, dtype=torch.float64)
    active = 0
    for i, want in enumerate(jax_runs[start]):
        k = torch.full((3,), float(i), dtype=torch.float64)
        q, qd, rms, height, up = mocap_track.track_step(env, motion, q, qd, k, speedup)
        for name, got, w in zip(("q", "qd", "rms", "height", "up"), (q, qd, rms, height, up), want):
            np.testing.assert_allclose(got.numpy(), w, rtol=TRACK_TOL, atol=TRACK_TOL, err_msg=f"{name} at step {i + 1}")
        active += int((fused_step.sphere_distances(fused_step.pack_step_params(env), q) < 0).sum())
    assert (active > 0) == (start == "touching")


def test_track_accumulates_the_example_numbers(starts):
    """track's carry (through graphs.scan's Python loop on the CPU) gives
    the example's three numbers from the per-step values."""
    env = mocap_track.make_env(torch.float64, "cpu", fused=False)
    motion = mocap_track.load_motion(torch.float64, "cpu")
    speedup = torch.tensor(SPEEDUPS, dtype=torch.float64)
    steps = 15
    out = mocap_track.track(env, motion, speedup, steps=steps, start=starts["touching"])
    q, qd = starts["touching"]
    rms_all, heights, ups = [], [], []
    for i in range(steps):
        q, qd, rms, height, up = mocap_track.track_step(env, motion, q, qd, torch.full((3,), float(i), dtype=torch.float64),
                                                       speedup)
        rms_all.append(rms), heights.append(height), ups.append(up)
    settle = steps // 5
    torch.testing.assert_close(out["rms"], torch.stack(rms_all[settle:]).mean(0), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out["height_min"], torch.stack(heights).amin(0), rtol=0, atol=0)
    torch.testing.assert_close(out["up_min"], torch.stack(ups).amin(0), rtol=0, atol=0)
    torch.testing.assert_close(out["q"], q, rtol=0, atol=0)
    assert mocap_track.speedups(5).tolist() == pytest.approx([1.0, 0.9, 1.0, 1.1, 1.2])


def test_command_line(capsys):
    """python -m tds_tpu_torch.tools.mocap_track --batch 2 --steps 50
    --device cpu: the example's report for env 0, the batch's share, and
    its exit code."""
    code = mocap_track.main(["--batch", "2", "--steps", "50", "--device", "cpu", "--dtype", "float64"])
    out = capsys.readouterr().out
    assert "motion: 208 frames x 19 values" in out and "env 0 (speedup 1.0)" in out and "of 2 envs" in out
    assert code == 0 and out.strip().endswith("tracking OK")
