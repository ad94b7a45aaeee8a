#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, ``tds_tpu_torch``, on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's kernels from the sources in this checkout and drives
the laikago contact rollout, the fused step and the probes through them.
Phases, each of which raises on failure, so that the run exits non-zero and
prints no final line:

1. device: a CUDA device, its name and power limit, TF32 off;
2. build: the kernels of ``tds_tpu_torch/csrc/`` with nvcc for sm_90a, one
   nvcc per source, all started together: K1 ``pgs.cu``, K2
   ``megastep.cu``, K3 and K4 ``probes.cu``;
3. kernel: the PGS kernel against its plain PyTorch version on the card, on
   random problems and on the operands of one laikago step at batch 4096,
   and both versions' times at the main path's shape (the kernel's also
   with 0 sweeps: the launch, the loads and the stores), with its launch shape
   there (lanes per env, envs per block, shared memory per block, resident
   warps per SM from the CUDA occupancy calculator, waves);
4. device against CPU: 50 float64 ``sim_step``s at batch 8 on the card
   (through the kernel) against the same on the CPU (plain version);
5. main path: ``LaikagoEnv`` in float32 on the card, ``reset`` at batch 4096
   and a 100-step ``rollout`` of the zero linear policy (the shape that
   ``bench.py`` times), with the kernel's launches counted;
6. trained policy: ``logs/laikago_ars/policy_r2b.pkl`` replayed in float32
   for 2000 steps at batch 8, held to the thresholds of
   ``tests/test_trained_policy.py``, with the kernel's launches counted;
7. mega step: the fused step kernel K2 (``tds_tpu_torch/envs/fused_step.py``)
   against its plain version, 50 float64 steps at batch 8 on the card
   against the CPU and one float32 step at batch 16384 against the plain
   version and the eager ``sim_step`` on the card, all from states with
   active contact rows, with the margin left under each tolerance and both
   float32 steps' distance from the float64 plain step; then the loop of
   ``python -m tds_tpu_torch.tools.megastep`` at batch 16384 for 100
   float32 steps, with K2's launches counted, and K2's device time, wall
   time, bound and launch shape beside the eager step's;
8. probes: the probe kernels K3 and K4 (``tds_tpu_torch/tools/kernel_probe.py``)
   through the probe command's path, with their launches counted, then
   timed against their plain versions and the one PyTorch call each
   replaces.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``tds_tpu``.
"""

import contextlib
import functools
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tds_tpu_torch.utils.timing import device_ms, wall_ms

REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "logs" / "laikago_ars" / "policy_r2b.pkl"
MAIN_BATCH = 4096
ROLLOUT_STEPS = 100
REPLAY_BATCH, REPLAY_STEPS, REPLAY_SEED = 8, 2000, 0
MEGA_BATCH, MEGA_STEPS = 16384, 100  # the experiment's defaults
# (memory bytes/s, float32 FLOP/s, float64 FLOP/s outside the tensor cores),
# NVIDIA's data sheets; the first key found in the device name applies
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H100": (3.35e12, 67e12, 34e12),
}
# |kernel - plain| <= atol + rtol * |plain|, as tests/test_pallas_pgs.py
# holds its kernel in float32; float64 differs only by summation order
PGS_TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (0.0, 1e-12)}
# |K2 - plain| <= tol * (1 + |plain|) in float32 after one contact step:
# the size of float32 rounding there (tests/test_torch_megastep.py holds
# the float32 plain step to the float64 one at this tolerance, and phase 7
# prints both float32 steps' distance from the float64 one); q moves by
# qd dt
MEGA_TOL = {"q": 1e-6, "qd": 1e-4}


def log(msg):
    print(msg, flush=True)


def card_peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no peak rates known for {name!r}; add them to PEAKS")


# -- phase 1 ---------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device and torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("TF32 is off for matmul and cuDNN: float32 products run in full float32")
    return name


# -- phase 2 ---------------------------------------------------------------
def phase_build():
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.tools import kernel_probe

    kernels = {"K1 pgs.cu": pgs.build, "K2 megastep.cu": fused_step.build, "K3/K4 probes.cu": kernel_probe.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        futures = {label: pool.submit(build) for label, build in kernels.items()}
        libs = {label: future.result() for label, future in futures.items()}
    log(f"build: {len(libs)} nvcc builds in parallel in {time.perf_counter() - t0:.1f} s")
    for label, lib in libs.items():
        log(f"build: {label} -> {lib.relative_to(REPO) if lib.is_relative_to(REPO) else lib}")
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "nvcc took" in line or "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


# -- phase 3 ---------------------------------------------------------------
def random_pgs_problem(batch, n_c, dtype, generator):
    """SPD A = J J^T + 1e-3 I with J (n, 8), as tests/test_pallas_pgs.py."""
    n = 3 * n_c
    dev = generator.device
    j = torch.randn(batch, n, 8, generator=generator, dtype=torch.float64, device=dev)
    a = j @ j.transpose(-1, -2) + 1e-3 * torch.eye(n, dtype=torch.float64, device=dev)
    b = torch.randn(batch, n, generator=generator, dtype=torch.float64, device=dev)
    lo = torch.cat([torch.zeros(batch, n_c, device=dev)] + [torch.full((batch, n_c), -0.5, device=dev)] * 2, -1)
    hi = torch.cat([torch.full((batch, n_c), 1e5, device=dev)] + [torch.full((batch, n_c), 0.5, device=dev)] * 2, -1)
    dep = [-1] * n_c + list(range(n_c)) * 2
    return [t.to(dtype).contiguous() for t in (a, b, lo, hi)], dep


@contextlib.contextmanager
def recorded_pgs_calls():
    """Records the operands of every PGS call made inside the block."""
    from tds_tpu_torch.contact import pgs

    calls = []
    solve = pgs.solve_pgs

    def recording_solve(*args):
        calls.append(args)
        return solve(*args)

    pgs.solve_pgs = recording_solve
    try:
        yield calls
    finally:
        pgs.solve_pgs = solve


def log_launch_shape(label, shape):
    log(f"{label}: {shape['lanes_per_env']} lanes per env, {shape['envs_per_block']} envs per block of "
        f"{shape['threads_per_block']} threads, {shape['smem_per_block']} B shared memory per block, "
        f"{shape['registers']} registers and {shape['local_bytes']} B local memory per thread; "
        f"{shape['resident_warps_per_sm']} resident warps per SM ({shape['blocks_per_sm']} blocks), "
        f"{shape['blocks']} blocks = {shape['waves']:.2f} waves")


def launch_fields(shape):
    """The launch-shape keys of a kernel's entry in the ``kernels`` line."""
    return {
        "lanes_per_env": shape["lanes_per_env"],
        "resident_warps_per_sm": shape["resident_warps_per_sm"],
        "stack_bytes": shape["local_bytes"],
        "envs_per_block": shape["envs_per_block"],
        "smem_per_block": shape["smem_per_block"],
        "registers": shape["registers"],
        "waves": shape["waves"],
    }


def phase_kernel(env, card):
    from tds_tpu_torch.contact import pgs

    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    # the toes reach the ground about 65 steps after the reset: harvest the
    # operands of a step with the contacts active
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, obs = env.reset(gen, batch_size=MAIN_BATCH)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    state = rollout(env, policy, None, state, obs, ROLLOUT_STEPS)[0]
    with recorded_pgs_calls() as calls:
        env.step(state, torch.zeros(MAIN_BATCH, env.action_dim, dtype=env.dtype, device=env.device))
    if len(calls) != 1:
        raise AssertionError(f"expected one PGS call in a laikago step, saw {len(calls)}")
    main_args = calls[0]
    active = int((main_args[1] != 0).sum())
    if active == 0:
        raise AssertionError("no contact row is active in the harvested laikago step")
    log(f"kernel: harvested the PGS operands of laikago step {ROLLOUT_STEPS + env.settle_steps + 1} "
        f"at batch {MAIN_BATCH}: {active} of {main_args[1].numel()} rows active")
    cases = [
        (f"random B={b} n={3 * nc} it={it} {str(dt)[6:]}", *random_pgs_problem(b, nc, dt, gen), it)
        for b, nc, it in ((4096, 4, 1), (4096, 8, 1), (1000, 4, 3))
        for dt in (torch.float32, torch.float64)
    ]
    a, b, lo, hi, dep, it = main_args
    cases.append((f"laikago step B={b.shape[0]} n={b.shape[1]} it={it} {str(b.dtype)[6:]}", [a, b, lo, hi], dep, it))
    results = []
    for label, operands, dep, it in cases:
        x = pgs.solve_pgs(*operands, dep, it)
        ref = pgs.solve_pgs_reference(*operands, dep, it)
        torch.cuda.synchronize()
        rtol, atol = PGS_TOL[x.dtype]
        err = (x - ref).abs()
        excess = (err - (atol + rtol * ref.abs())).max().item()
        log(f"kernel: {label}: max |kernel - plain| = {err.max().item():.3e} (|plain| <= {ref.abs().max().item():.3g}; rtol {rtol}, atol {atol})")
        if not torch.isfinite(x).all() or excess > 0:
            raise AssertionError(f"PGS kernel disagrees with its plain version on {label}")
        results.append({"case": label, "max_abs_err": err.max().item()})

    # time both versions on the main path's own operands (A stays in L2, as
    # in the step, where the previous op just wrote it)
    a, b, lo, hi, dep, it = main_args
    ms = device_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, it), rounds=5, per_round=20)
    # the same launch with no sweep: the launch, the loads and the stores
    sweepless_ms = device_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, 0), rounds=5, per_round=20)
    plain_ms = device_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, it), rounds=10, per_round=4, backlog_ms=50)
    kernel_wall = wall_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, it), reps=200)
    plain_wall = wall_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, it), reps=20)
    bsz, n = b.shape
    elt = b.element_size()
    n_bytes = elt * (bsz * n * n + 4 * bsz * n) + 4 * n  # A, b, lo, hi, x, dep
    n_ops = it * bsz * n * (2 * n + 3)  # per row: n-1 products and sums, b - delta, a divide, two bound scales
    bandwidth, f32_rate, f64_rate = card
    t_bytes = n_bytes / bandwidth * 1e3
    t_ops = n_ops / (f32_rate if b.dtype == torch.float32 else f64_rate) * 1e3
    log(f"kernel: main-path shape B={bsz} n={n} it={it} {b.dtype}: kernel {ms * 1e3:.2f} us on the device "
        f"({kernel_wall * 1e3:.2f} us wall per call), plain {plain_ms * 1e3:.1f} us on the device ({plain_wall * 1e3:.1f} us wall), bound {max(t_bytes, t_ops) * 1e3:.3f} us "
        f"({n_bytes} bytes, {n_ops} flops)")
    log(f"kernel: the same launch with 0 sweeps (launch, loads and stores): {sweepless_ms * 1e3:.2f} us on the device")
    shape = pgs.launch_shape(b.dtype, n, bsz)
    log_launch_shape(f"kernel: B={bsz} n={n} {b.dtype}", shape)
    return {
        "name": "pgs",
        "route": "cuda",
        "source": "tds_tpu_torch/csrc/pgs.cu",
        "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in results),
        "ms": ms,
        "kernel_ms": ms,
        "wall_ms": kernel_wall,
        "plain_ms": plain_ms,
        "plain_wall_ms": plain_wall,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={bsz} n={n} iterations={it} {str(b.dtype)[6:]}",
        "ms_0_sweeps": sweepless_ms,
        **launch_fields(shape),
        "cases": results,
    }


# -- phase 4 ---------------------------------------------------------------
def phase_device_vs_cpu():
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    batch, steps, tol = 8, 50, 1e-9
    # started 3 cm lower than the env's default, so that the toes touch the
    # ground from the first step and every step runs a contact solve
    start = (0.0, 0.0, 0.45)
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=start)
    gpu_env = LaikagoEnv(dtype=torch.float64, start_base_position=start)
    gen = torch.Generator(device="cpu").manual_seed(4)
    noise = (torch.rand(batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.1
    actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qc, qdc = cpu_env.initial_state(noise=noise)
    qg, qdg = gpu_env.initial_state(noise=noise)
    before = pgs.launches
    worst = 0.0
    active = []
    for t in range(steps):
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
        with recorded_pgs_calls() as calls:
            qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].cuda())
        active.append(int((calls[0][1] != 0).sum()))
        for got, expected in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            excess = ((got - expected).abs() - tol * (1 + expected.abs())).max().item()
            worst = max(worst, (got - expected).abs().max().item())
            if excess > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"device and CPU sim_step differ beyond {tol} at step {t + 1}")
    if pgs.launches - before != steps:
        raise AssertionError(f"{steps} steps on the card launched the PGS kernel {pgs.launches - before} times")
    if min(active) == 0:
        raise AssertionError("a step of the device-against-CPU run had no active contact row")
    log(f"device vs CPU: {steps} float64 sim_steps at batch {batch}: max |cuda - cpu| = {worst:.3e} "
        f"(tolerance {tol} abs + rel), {steps} kernel launches, {min(active)} to {max(active)} "
        f"of {calls[0][1].numel()} contact rows active per step")


# -- phase 5 ---------------------------------------------------------------
# the functions a laikago step calls, by the module whose namespace it
# calls them through; stage_breakdown wraps each to time it
STAGES = (
    ("tds_tpu_torch.envs.locomotion", "pd_tau"),
    ("tds_tpu_torch.envs.locomotion", "fk_links"),
    ("tds_tpu_torch.envs.locomotion", "aba_factor"),
    ("tds_tpu_torch.envs.locomotion", "forward_dynamics_from_kin"),
    ("tds_tpu_torch.envs.locomotion", "integrate_euler_qdd"),
    ("tds_tpu_torch.envs.locomotion", "resolve_contacts"),
    ("tds_tpu_torch.world", "gather_pair_contacts"),
    ("tds_tpu_torch.world", "resolve_collision"),
    ("tds_tpu_torch.contact.mlcp", "point_jacobian_kin"),
    ("tds_tpu_torch.contact.mlcp", "minv_mul"),
    ("tds_tpu_torch.contact.pgs", "solve_pgs"),
    ("tds_tpu_torch.envs.locomotion", "integrate_q"),
)


@contextlib.contextmanager
def timed_stages():
    """Wraps every function of STAGES so that each call adds its host time
    to ``host_s[name]`` and runs inside a profiler range ``stage:name``."""
    import importlib

    from torch.profiler import record_function

    host_s = dict.fromkeys((name for _, name in STAGES), 0.0)
    saved = []

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(f"stage:{name}"):
                out = fn(*args, **kwargs)
            host_s[name] += time.perf_counter() - t0
            return out

        return timed

    try:
        for module_name, name in STAGES:
            module = importlib.import_module(module_name)
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, wrap(name, getattr(module, name)))
        yield host_s
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def stage_breakdown(env, policy, state, obs, steps):
    """Per step: device operations and device-busy ms in all, and host ms,
    device operations and device ms of each stage of STAGES, over ``steps``
    rollout steps. Host times come from a run without the profiler; device
    numbers from torch.profiler (None when it saw no device activity). The
    profiler ties a kernel to a stage through the PyTorch operation that
    launched it, so the PGS kernel, launched through ctypes, is counted in
    the totals and in ``pgs_kernel_ms`` but in no stage."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tds_tpu_torch.rollout import rollout

    rollout(env, policy, None, state, obs, 1)
    torch.cuda.synchronize()
    with timed_stages() as host_s:
        t0 = time.perf_counter()
        rollout(env, policy, None, state, obs, steps)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        host_s = dict(host_s)  # before the profiled run adds to it
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rollout(env, policy, None, state, obs, steps)
            torch.cuda.synchronize()
    events = prof.events()
    # the stage ranges also appear on the device's timeline: leave them out
    device_events = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")]
    if not device_events:
        return None
    stages = {name: {"host_ms": host_s[name] * 1e3 / steps, "device_ops": 0, "device_ms": 0.0} for name in host_s}

    def kernels_under(event):
        return list(event.kernels) + [k for child in event.cpu_children for k in kernels_under(child)]

    for e in events:
        if e.name.startswith("stage:"):
            kernels = kernels_under(e)
            row = stages[e.name[len("stage:"):]]
            row["device_ops"] += len(kernels) / steps
            row["device_ms"] += sum(k.duration for k in kernels) / 1e3 / steps
    return {
        "step_ms_with_stage_timers": step_s * 1e3 / steps,
        "device_ops": len(device_events) / steps,
        "device_ms": sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / steps,
        "pgs_kernel_ms": sum(e.time_range.elapsed_us() for e in device_events if "pgs_kernel" in e.name) / 1e3 / steps,
        "stages": stages,
    }


def phase_main_path(env):
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    gen = torch.Generator(device=env.device).manual_seed(1)
    torch.cuda.synchronize()
    pgs.launches = 0
    t0 = time.perf_counter()
    state, obs = env.reset(gen, batch_size=MAIN_BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, obs, total, alive = rollout(env, policy, None, state, obs, ROLLOUT_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = pgs.launches
    expected = ROLLOUT_STEPS + env.settle_steps
    if launches != expected:
        raise AssertionError(f"the main path launched the PGS kernel {launches} times, expected {expected}")
    for name, t in (("q", state.q), ("qd", state.qd), ("obs", obs), ("total reward", total)):
        if t.shape[0] != MAIN_BATCH or not torch.isfinite(t).all():
            raise AssertionError(f"{name} is not finite or has shape {tuple(t.shape)}")
    z = state.q[:, 2]
    if not bool(alive.all()) or not bool(((z > 0.3) & (z < 0.6)).all()):
        raise AssertionError(f"the zero policy should stand: {int(alive.sum())}/{MAIN_BATCH} alive, z in [{z.min():.3f}, {z.max():.3f}]")
    step_ms = (t2 - t1) * 1e3 / ROLLOUT_STEPS
    log(f"main path: reset (10 settle steps) at batch {MAIN_BATCH} in {(t1 - t0) * 1e3:.1f} ms; "
        f"{ROLLOUT_STEPS}-step rollout {step_ms:.3f} ms/step = {MAIN_BATCH / step_ms * 1e3:.1f} env-steps/s; "
        f"PGS kernel launches {launches}; z in [{z.min():.3f}, {z.max():.3f}]")
    breakdown = stage_breakdown(env, policy, state, obs, steps=5)
    if breakdown is None:
        log("main path: device operations per step not measured (the profiler saw no device activity)")
    else:
        log(f"main path: {breakdown['device_ops']:.0f} device operations per step (torch.profiler), device busy "
            f"{breakdown['device_ms']:.3f} ms/step of {step_ms:.3f} ms ({100 * (1 - breakdown['device_ms'] / step_ms):.1f}% idle), "
            f"PGS kernel {breakdown['pgs_kernel_ms'] * 1e3:.2f} us/step")
        log(f"main path: stages per step (host ms timed without the profiler, {breakdown['step_ms_with_stage_timers']:.3f} ms/step "
            "with the stage timers; device operations and ms from the profiler; gather_pair_contacts to "
            "solve_pgs are parts of resolve_contacts):")
        for name, row in breakdown["stages"].items():
            log(f"  {name:26s} host {row['host_ms']:8.3f} ms  device ops {row['device_ops']:6.0f}  device {row['device_ms']:7.3f} ms")
    return launches


# -- phase 6 ---------------------------------------------------------------
def phase_trained_policy(env):
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
    from tds_tpu_torch.rollout import rollout

    saved, _ = load_checkpoint(str(CHECKPOINT))
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=env.dtype)
    gen = torch.Generator(device="cpu").manual_seed(REPLAY_SEED)
    u = torch.rand((REPLAY_BATCH, env.action_dim), generator=gen, dtype=env.dtype)
    torch.cuda.synchronize()
    pgs.launches = 0
    state, obs = env.reset(noise=-env.reset_noise + 2.0 * env.reset_noise * u)
    t0 = time.perf_counter()
    state, obs, total, alive = rollout(env, policy, stat, state, obs, REPLAY_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pgs.launches
    expected = REPLAY_STEPS + env.settle_steps
    if launches != expected:
        raise AssertionError(f"the trained-policy replay launched the PGS kernel {launches} times, expected {expected}")
    x, z = state.q[:, 0].cpu(), state.q[:, 2].cpu()
    total, alive = total.cpu(), alive.cpu()
    failed = []
    for i in range(REPLAY_BATCH):
        ok = alive[i] == 1.0 and x[i] > 1.6 and 0.3 < z[i] < 0.6 and total[i] > 1100.0
        log(f"trained policy: env {i}: alive {alive[i]:.0f} x {x[i]:.3f} z {z[i]:.3f} total {total[i]:.1f} {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(i)
    if failed:
        raise AssertionError(f"the trained policy failed the thresholds in envs {failed}")
    log(f"trained policy: {REPLAY_STEPS} steps at batch {REPLAY_BATCH} in {seconds:.1f} s; all envs walk; "
        f"PGS kernel launches {launches}")


# -- phase 7 ---------------------------------------------------------------
def device_profile(fn, calls):
    """(device operations, device-busy ms) per call of ``fn``, from
    torch.profiler over ``calls`` calls; None when it saw no device
    activity. Unlike device_ms, this allows ``fn`` to synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_events:
        return None
    return len(device_events) / calls, sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / calls


def excess(got, expected, tol):
    """max(|got - expected| - tol (1 + |expected|)): > 0 fails; below 0,
    minus the margin left under the tolerance."""
    return ((got - expected).abs() - tol * (1 + expected.abs())).max().item()


def phase_mega_step(card):
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.tools import megastep
    from tds_tpu_torch.utils import op_count

    # float64, card against CPU, from phase 4's lowered start and actions
    batch, steps, tol = 8, 50, 1e-9
    start = (0.0, 0.0, 0.45)
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=start)
    cpu_params = fused_step.pack_step_params(cpu_env)
    gpu_params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, start_base_position=start))
    gen = torch.Generator(device="cpu").manual_seed(4)
    noise = (torch.rand(batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.1
    actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qc, qdc = cpu_env.initial_state(noise=noise)
    qg, qdg = qc.cuda(), qdc.cuda()
    before = fused_step.launches
    worst, worst_excess = 0.0, -float("inf")
    active = []
    for t in range(steps):
        active.append(int((fused_step.sphere_distances(cpu_params, qc) < 0).sum()))
        qc, qdc = fused_step.mega_step(cpu_params, qc, qdc, actions[t])
        qg, qdg = fused_step.mega_step(gpu_params, qg, qdg, actions[t].cuda())
        for got, expected in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            worst = max(worst, (got - expected).abs().max().item())
            worst_excess = max(worst_excess, excess(got, expected, tol))
            if worst_excess > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"K2 on the card and the plain step on the CPU differ beyond {tol} at step {t + 1}")
    if fused_step.launches - before != steps:
        raise AssertionError(f"{steps} float64 steps on the card launched K2 {fused_step.launches - before} times")
    if min(active) == 0:
        raise AssertionError("a step of the float64 run had no active contact row")
    log(f"mega step: {steps} float64 steps at batch {batch}, K2 on the card against the plain step on the CPU: "
        f"max |cuda - cpu| = {worst:.3e} (tolerance {tol} abs + rel, margin left {-worst_excess:.3e}); {min(active)} to {max(active)} of "
        f"{batch * 4} contacts active per step")

    # float32 at the experiment's batch, one step from a state where every
    # env touches the ground: the toes land about 65 steps after the start
    env = LaikagoEnv(dtype=torch.float32)
    params = fused_step.pack_step_params(env)
    fused = functools.partial(fused_step.mega_step, params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, qd = env.initial_state(gen, batch_size=MEGA_BATCH)
    zero = torch.zeros(MEGA_BATCH, env.action_dim, device=env.device)
    q, qd, _ = megastep.timed_steps(fused, q, qd, zero, 100)
    contacts = (fused_step.sphere_distances(params, q) < 0).sum(-1)
    if not bool((contacts > 0).all()) or not bool(torch.isfinite(qd).all()):
        raise AssertionError(f"after 100 steps {int((contacts == 0).sum())} of {MEGA_BATCH} envs have no contact")
    action = (torch.rand(MEGA_BATCH, env.action_dim, generator=gen, device=env.device) - 0.5) * 0.8
    got = fused_step.mega_step(params, q, qd, action)
    plain = fused_step.mega_step_reference(params, q, qd, action)
    eager = env.sim_step(q, qd, action)
    errors = {}
    for other_name, other in (("plain", plain), ("eager sim_step", eager)):
        for name, g, e in (("q", got[0], other[0]), ("qd", got[1], other[1])):
            err = (g - e).abs().max().item()
            errors[(other_name, name)] = err
            over = excess(g, e, MEGA_TOL[name])
            log(f"mega step: float32 B={MEGA_BATCH}: max |K2 - {other_name}| on {name} = {err:.3e} "
                f"(|{name}| <= {e.abs().max().item():.3g}; tolerance {MEGA_TOL[name]} abs + rel, margin left {-over:.3e})")
            if over > 0 or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"K2 and the {other_name} step differ beyond {MEGA_TOL[name]} on {name}")
    # a reading, not a check: how far each float32 step lies from the
    # float64 plain step on the same states, against the same tolerance
    params64 = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64))
    exact = fused_step.mega_step_reference(params64, q.double(), qd.double(), action.double())
    for label, step in (("K2", got), ("float32 plain", plain)):
        for name, g, e in (("q", step[0], exact[0]), ("qd", step[1], exact[1])):
            log(f"mega step: float32 B={MEGA_BATCH}: max |{label} - float64 plain| on {name} = "
                f"{(g.double() - e).abs().max().item():.3e} (margin left under {MEGA_TOL[name]} abs + rel: "
                f"{-excess(g.double(), e, MEGA_TOL[name]):.3e})")
    log(f"mega step: {int(contacts.sum())} of {4 * MEGA_BATCH} contacts active, {int(contacts.min())} to "
        f"{int(contacts.max())} per env")

    # the experiment's loop: the tiled standing start, zero action
    q0, qd0 = env.initial_state(torch.Generator(device=env.device).manual_seed(0))
    qs, qds = q0.expand(MEGA_BATCH, -1).contiguous(), qd0.expand(MEGA_BATCH, -1).contiguous()
    megastep.timed_steps(fused, qs, qds, zero, 1)
    fused_step.launches = 0
    _, _, mega_s = megastep.timed_steps(fused, qs, qds, zero, MEGA_STEPS)
    launches = fused_step.launches
    if launches != MEGA_STEPS:
        raise AssertionError(f"{MEGA_STEPS} fused steps launched K2 {launches} times")
    _, _, eager_s = megastep.timed_steps(env.sim_step, qs, qds, zero, MEGA_STEPS)
    mega_rate, eager_rate = MEGA_BATCH * MEGA_STEPS / mega_s, MEGA_BATCH * MEGA_STEPS / eager_s
    log(f"mega step: experiment loop, {MEGA_STEPS} float32 steps at batch {MEGA_BATCH}: K2 {mega_s * 1e3 / MEGA_STEPS:.3f} ms/step "
        f"= {mega_rate:.1f} env-steps/s, eager sim_step {eager_s * 1e3 / MEGA_STEPS:.3f} ms/step = {eager_rate:.1f} env-steps/s, "
        f"ratio {mega_rate / eager_rate:.2f}x; K2 launches {launches}")

    ms = device_ms(lambda: fused(q, qd, action), rounds=5, per_round=20)
    wall = wall_ms(lambda: fused(q, qd, action), reps=100)
    shape = fused_step.launch_shape(params, MEGA_BATCH)
    eager_profile = device_profile(lambda: env.sim_step(q, qd, action), calls=2)
    plain_profile = device_profile(lambda: fused_step.mega_step_reference(params, q, qd, action), calls=1)
    elt = q.element_size()
    n_pd = params.pd_q.numel()
    n_bytes = MEGA_BATCH * elt * (4 * q.shape[1] + n_pd) + sum(
        getattr(params, f).numel() * getattr(params, f).element_size() for f in fused_step.POINTER_FIELDS
    )
    # the operations the step needs on these states (utils/op_count.py)
    n_ops = op_count.needed_flops(fused_step.mega_step_reference, params, q, qd, action)
    bandwidth, f32_rate, _ = card
    t_bytes, t_ops = n_bytes / bandwidth * 1e3, n_ops / f32_rate * 1e3
    if eager_profile is None or plain_profile is None:
        log("mega step: device operations of the eager and plain steps not measured (the profiler saw no device activity)")
        eager_ops = eager_busy = plain_ms = None
    else:
        (eager_ops, eager_busy), (_, plain_ms) = eager_profile, plain_profile
        log(f"mega step: eager sim_step at batch {MEGA_BATCH}: {eager_ops:.0f} device operations per step, device busy "
            f"{eager_busy:.3f} ms/step (torch.profiler); plain fused step {plain_ms:.3f} ms of device time per call")
    log(f"mega step: K2 at B={MEGA_BATCH} float32: {ms * 1e3:.2f} us on the device per launch ({wall * 1e3:.2f} us wall per call), "
        f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({n_ops} flops needed = {n_ops / MEGA_BATCH:.1f} per env, {n_bytes} bytes)")
    log_launch_shape(f"mega step: K2 B={MEGA_BATCH} float32", shape)
    return {
        "name": "megastep",
        "route": "cuda",
        "source": "tds_tpu_torch/csrc/megastep.cu",
        "replaces": "tools/pallas_megastep_experiment.py:76 (main.<locals>.kernel)",
        "launches": launches,
        "max_abs_err": max(errors.values()),
        "ms": ms,
        "wall_ms": wall,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": f"B={MEGA_BATCH} links=22 dof=18 spheres=4 float32",
        "flops_needed_per_env": n_ops / MEGA_BATCH,
        "max_abs_err_float64_50_steps": worst,
        "mega_env_steps_per_s": mega_rate,
        "eager_env_steps_per_s": eager_rate,
        "eager_device_ops_per_step": eager_ops,
        "eager_device_busy_ms_per_step": eager_busy,
        **launch_fields(shape),
    }


# -- phase 8 ---------------------------------------------------------------
def phase_probes(card):
    from tds_tpu_torch.tools import kernel_probe

    for name in kernel_probe.launches:
        kernel_probe.launches[name] = 0
    errors = kernel_probe.run_probes(seed=0)  # the path of ``python -m tds_tpu_torch.tools.kernel_probe``
    launches = dict(kernel_probe.launches)
    for name, err in errors.items():
        if launches[name] < 1 or err != 0:
            raise AssertionError(f"probe {name}: {launches[name]} launches, max |kernel - plain| = {err}")
    library = {
        "reshape_sum": lambda x: x.reshape(256, 4, 2).sum(-1),
        "transpose_minor": lambda x: x.transpose(-1, -2).contiguous(),
    }
    replaces = {
        "reshape_sum": "tools/mosaic_probe.py:26 (minor_dim_reshape)",
        "transpose_minor": "tools/mosaic_probe.py:36 (minor_dim_transpose)",
    }
    bandwidth, f32_rate, _ = card
    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = []
    for name, (fn, plain) in kernel_probe.PROBES.items():
        x = torch.randn(kernel_probe.PROBE_SHAPES[name], generator=gen, device="cuda")
        out = fn(x)
        if not torch.equal(out, library[name](x)):
            raise AssertionError(f"probe {name} differs from the PyTorch call it replaces")
        ms = device_ms(lambda: fn(x), rounds=5, per_round=50)
        plain_ms = device_ms(lambda: plain(x), rounds=5, per_round=50)
        library_ms = device_ms(lambda: library[name](x), rounds=5, per_round=50)
        wall = wall_ms(lambda: fn(x), reps=200)
        n_bytes = 4 * (x.numel() + out.numel())
        n_ops = out.numel() if name == "reshape_sum" else 0
        t_bytes, t_ops = n_bytes / bandwidth * 1e3, n_ops / f32_rate * 1e3
        log(f"probes: {name} {tuple(x.shape)} -> {tuple(out.shape)}: kernel {ms * 1e3:.2f} us on the device "
            f"({wall * 1e3:.2f} us wall), plain {plain_ms * 1e3:.2f} us, PyTorch call {library_ms * 1e3:.2f} us, "
            f"bound {max(t_bytes, t_ops) * 1e3:.4f} us ({n_bytes} bytes); launches on the probe path {launches[name]}")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "tds_tpu_torch/csrc/probes.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": ms,
            "wall_ms": wall,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": f"{tuple(x.shape)} float32",
        })
    return entries


def timed(phase, *args):
    """``phase(*args)``, with a line of the seconds it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    name = phase_device()
    card = card_peaks(name)
    timed(phase_build)
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    env = LaikagoEnv(dtype=torch.float32)
    kernel = timed(phase_kernel, env, card)
    timed(phase_device_vs_cpu)
    kernel["launches"] = timed(phase_main_path, env)
    timed(phase_trained_policy, env)
    mega = timed(phase_mega_step, card)
    probes = timed(phase_probes, card)
    print(json.dumps({"kernels": [kernel, mega, *probes]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
