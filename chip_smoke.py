#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, ``tds_tpu_torch``, on one NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's kernels from the sources in this checkout and drives
the laikago contact rollout, the fused step, the probes, ARS, the ant and
hopper rollouts, the humanoid and half-cheetah rollouts, the terrain
laikago's rollout, replays and trainer, and gradients (the contact loss
and APG through K1's backward kernel) through them.
On the card the rollouts, the resets' settle steps and ARS's rollouts
replay CUDA graphs (``tds_tpu_torch.utils.graphs.scan``); where a phase says "eager" it runs
the same loop inside ``graphs.eager()``, as ``scan_reference``, the Python
loop, on the card. A kernel wrapper counts its launches where it makes
them: in a graph's warm-up and capture, not in a replay, which calls no
Python. So a phase that runs through graphs checks the wrapper's count
against the graphs it captured, and phases 5, 9 (c), 10 (b), 12 (b),
(f) and 13 (b) count the kernels of replayed steps in a torch.profiler
trace: one a step.
Phases, each of which raises on failure, so that the run exits non-zero and
prints no final line (each phase and sub-phase prints its seconds):

1. device: a CUDA device, its name and power limit, TF32 off;
2. build: the kernels of ``tds_tpu_torch/csrc/`` with nvcc for sm_90a, one
   nvcc per source, all started together: K1 ``pgs.cu``, K2
   ``megastep.cu``, K3 and K4 ``probes.cu``;
3. kernel: the PGS kernel against its plain PyTorch version on the card, on
   random problems and on the operands of one laikago step at batch 4096,
   the gradient it carries to an operand that requires grad (its backward
   kernel against the plain version's autograd; the same x with and
   without grad), and both versions' times at the main path's shape
   (the kernel's also with 0 sweeps: the launch, the loads and the
   stores), with its launch shape there (lanes per env, envs per block,
   shared memory per block, resident warps per SM from the CUDA occupancy
   calculator, waves);
4. device against CPU: 50 float64 ``sim_step``s at batch 8 on the card
   (through the kernel) against the same on the CPU (plain version);
5. main path: ``LaikagoEnv`` in float32 on the card, ``reset`` at batch 4096
   and a 100-step ``rollout`` of the zero linear policy through graphs,
   with the kernel's wrapper launches counted; the same rollout eager
   beside it, equal bit for bit, the graphs' nodes and capture seconds,
   the replays' device operations, K1 kernels (one a step) and idle share
   (``torch.profiler``), ``bench.py``'s
   ``laikago_scan_rollout_env_steps_per_s`` (1000 steps, one timed run) and an
   eager stage breakdown (this main path's only);
6. trained policy: ``logs/laikago_ars/policy_r2b.pkl`` replayed in float32
   for 2000 steps at batch 8 through graphs, held to the thresholds of
   ``tests/test_trained_policy.py``, with the kernel's wrapper launches
   counted;
7. mega step: the fused step kernel K2 (``tds_tpu_torch/envs/fused_step.py``)
   against its plain version, 50 float64 steps at batch 8 on the card
   against the CPU and one float32 step at batch 16384 against the plain
   version and the eager ``sim_step`` on the card, all from states with
   active contact rows, with the margin left under each tolerance and both
   float32 steps' distance from the float64 plain step, and K2's refusal of
   an operand that requires grad; then the loop of
   ``python -m tds_tpu_torch.tools.megastep`` at batch 16384 for 100
   float32 steps, with K2's launches counted, and K2's device time, wall
   time, bound and launch shape beside the eager step's (20 eager steps);
8. probes: the probe kernels K3 and K4 (``tds_tpu_torch/tools/kernel_probe.py``)
   through the probe command's path, with their launches counted, then
   timed against their plain versions and the one PyTorch call each
   replaces;
9. ARS (``tds_tpu_torch/learn/ars.py`` on ``LaikagoEnv(fused_step=True)``,
   every step one K2 launch for the 2 x num_directions rollouts, through
   graphs): (a) one float64 iteration, 8 directions x 100 steps from
   ``policy.pkl``, on the card against the CPU from the same draws; (b)
   ``policy_r2b.pkl`` in float32, evaluated (16 rollouts x 2000 steps, held
   to the replay's reward threshold), K2 against its plain version on the
   batch-256 operands of an eager recipe rollout (after the reset and at
   step 1500), then 1 warm-up and 3 timed iterations at ``bench.py``'s
   recipe (128 directions x 3000 steps, top 32) with K2's wrapper launches
   counted per iteration (the warm-up's captures, then none) and
   ``bench.py``'s ``ars_laikago_iterations_per_s`` and
   ``ars_laikago_env_steps_per_s``, then evaluated again; (c) one
   iteration of 100 steps through graphs and eager from the same draws,
   equal bit for bit, and under ``torch.profiler``: device operations per
   step, idle share, K2's kernels (one a step), its time per launch and
   its launch shape at batch 256; the recipe's rollout through graphs of
   one step and of ``ars.FUSED_CHUNK`` steps, 2 alternating timed runs
   each; (d) the trainer
   ``python -m tds_tpu_torch.tools.ars_train`` resumed from the policy for
   2 iterations, its checkpoint read back;
10. ant and hopper (``tds_tpu_torch/envs/{ant,hopper}.py``: capsule
   contacts, and the ant's ``top_k=8`` compaction, so that K1 solves 24
   rows for both): (a) K1 on the float32 batch-4096 PGS operands of an ant
   step and of a hopper step with contacts active, against its plain
   version, timed against its bound, and an ant without compaction (51
   rows) stepping on the card through K1's warp per env, never reaching
   the plain version there, K1 on its operands against the plain
   version; (b) the ant's main path as phase 5's, with
   ``bench.py``'s ``ant_scan_rollout_env_steps_per_s`` (500 steps), then a
   50-step hopper rollout; (c) 50 float64 ant steps at batch 16 on the
   card against the CPU, half the envs started with the torso on the
   ground, where the compaction drops candidates; (d)
   ``logs/ant_ars/policy.pkl`` replayed in float32 through ``rollout``
   for 1000 steps at batch 4, held to the thresholds of
   ``tests/test_ant_policy.py`` (alive at the last step, so for all of
   them, and more than 9.0 m forward); (e) ``python -m
   tds_tpu_torch.tools.ars_train --env ant`` resumed from that policy for
   2 iterations;
12. humanoid and half-cheetah (``tds_tpu_torch/envs/humanoid.py``: a
   spherical base joint, 35 plane candidates and 105 MLCP rows, K1's
   blocked form; ``HalfCheetahEnv``, 48 rows), run before phase 11 so that its
   graphs count there: (a) K1 against its plain version at n = 3, 6, 8, 9,
   12, 24, 48, 51, 105 and B = 1, 37, 4096 (and 1024 at n = 105), float32
   and float64, two sweeps of random problems, and on the float32 operands
   of a humanoid step (B = 1024) and a half-cheetah step (B = 4096) with
   contacts active; each n's form (row per lane, blocked), its time
   (median of 100 CUDA-event-timed launches) with one sweep and with 0, the
   plain version's, the bound and the launch shape; (b) the
   humanoid's main path as phase 5's at batch 1024 for 200 steps, with
   ``bench.py``'s ``humanoid_scan_rollout_env_steps_per_s`` (200 steps,
   the timed replay), and the same number at ``top_k=8`` (24 rows, 50
   steps, one timed run) as a measurement; (c) 50 float64 humanoid steps at batch 8 on the card
   against the CPU, the feet in the ground, within 1e-9 abs + rel; (d)
   ``logs/humanoid_ars/policy_curr2.pkl`` replayed in float32 through
   graphs for 3000 steps from the 4 starts of
   ``tests/test_humanoid_policy.py`` (the JAX package's reset draws for its
   seeds 0, 7, 123 and 42, recorded in
   ``tests/golden/humanoid_policy_reset_noise.json``), each held to its
   thresholds (:84-90: x > 0.65 m, at least 1100 steps alive, total reward
   > 600), beside 4 envs reset from ``torch.Generator`` seeds of the same
   numbers, whose outcome is printed as a measurement; (e) ``python -m
   tds_tpu_torch.tools.ars_train --env humanoid`` resumed from that policy
   for 2 iterations, its checkpoint read back; (f) a 50-step half-cheetah
   rollout at batch 4096 as phase 5's, K1 at n = 48 one a replayed step;
13. terrain (``tools/ars_train.make_terrain_env``: laikago on bench.py's
   heightfield, 13 x 7 vertices over x in [-1, 5], y in [-1.5, 1.5], 3
   candidates a toe of which the solver keeps the 8 deepest of 12, so K1
   at 24 rows, and 9 scan points in the observation), run before phase 11:
   (a) K1 against its plain version on the float32 operands of a terrain
   step at batch 4096 with the toes in contact, its time (median of 100
   launches), the plain version's, the bound and the launch shape; (b) the
   main path as phase 5's on the +-2 cm bump with ``bench.py``'s
   ``laikago_terrain_scan_rollout_env_steps_per_s`` (500 steps, one timed
   run) and its eager counterpart, device operations, busy ms and idle share
   per step, one K1 a replayed step, then 50 steps on the ``Mesh`` form of
   the terrain as a measurement; (c) 50 float64 steps at batch 8 on the
   card against the CPU on the heightfield and the mesh, q, qd and the
   observation within 1e-9 abs + rel; (d) ``policy_b4c.pkl`` and
   ``policy_r2b.pkl`` in float32 through graphs for 3000 steps on the +-4
   cm heightfield from the 4 starts of ``tests/test_terrain_policy.py``
   (the JAX package's reset draws, recorded in
   ``tests/golden/laikago_terrain_policy_reset_noise.json``), held to its
   thresholds (:92-100: policy_b4c's least distance over 4.4 m, its mean
   more than 0.4 m past policy_r2b's), and ``policy_r2b.pkl`` on the +-2 cm
   mesh for 1500 steps from ``tests/test_terrain.py``'s start, alive with
   x > 1.0 m and 0.3 < z < 0.6 (:89-96), each beside 4 ``torch.Generator``
   starts printed as a measurement; (e) ``python -m
   tds_tpu_torch.tools.ars_train --env laikago --terrain_bump 0.04
   --terrain_scan 0 --resume policy_b4c.pkl`` for 2 iterations and ``--env
   humanoid --reset_pool logs/humanoid_ars/pool_r5.npz`` for 1, their
   checkpoints read back;
14. gradients, run before phase 11: (a) K1's backward kernel
   (``csrc/pgs.cu``, through ``contact.pgs.PGSFunction``) against the
   plain version's autograd at n = 12, 24, 48 (B = 4096) and 105 (B =
   1024), float32 and float64, one and two sweeps, ties included, and on
   the operands of a laikago step; its form (linearised), its time (median
   of 100 launches) with one sweep and with 0 (the gradients zeroed), the
   plain backward's, the bound and the launch shape; (b)
   ``tests/test_contact_gradients.py``'s loss (``tools/contact_loss.py``)
   over 500 float64 steps through graphs against central differences on
   the card (rtol 2e-4), and over 100 steps within 1e-9 of the CPU's
   gradient, with one backward kernel a replayed VJP step in a trace; (c)
   APG (``learn/apg.py``): one float64 laikago train_step through graphs
   equal bit for bit to ``graphs.eager()``'s, then the scaled recipe
   (horizon 100, truncation 20, float32) at batch 4 and 4096 with K1's
   forward and backward launches counted, ``apg_laikago_iterations_per_s``
   and ``apg_laikago_env_steps_per_s`` (one timed iteration after the
   captures), the VJP graph's nodes, capture
   seconds and memory, and one backward kernel a replayed step in a trace;
   (d) ``logs/laikago_apg/policy_h100.pkl`` replayed for 500 steps from the
   JAX package's reset (``tests/golden/laikago_apg_reset.json``) at
   ``test_committed_apg_policy_walks``'s thresholds; (e) 25 APG
   iterations of ``test_apg_through_laikago_contact``'s setup: finite
   grad norms, the last 5 returns' mean above the first;
11. graphs: every graph left alive by the run (nodes, capture and
   instantiate seconds), the VJP graphs, the card's peak and reserved
   memory with all of them, and the script's seconds against its 1200 s
   limit.

The line before the last is the ``kernels`` JSON object (K1 once for each
row count a main path runs, 12, 24, 48 and 105, the other row counts of
phase 12 (a) and the terrain's n = 24 (``terrain_*``) inside the first;
K1's backward at n = 12, the other row counts inside it; K2, K3, K4); the
last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``tds_tpu``.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tds_tpu_torch.utils.timing import counted_trace, device_ms, device_trace, wall_ms

REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "logs" / "laikago_ars" / "policy_r2b.pkl"
# a laikago policy whose obs_stat has a finite m2 (policy_r2b.pkl's is NaN,
# read as std 1): phase 9 (a) starts from it
STAT_CHECKPOINT = REPO / "logs" / "laikago_ars" / "policy.pkl"
MAIN_BATCH = 4096
ROLLOUT_STEPS = 100
REPLAY_BATCH, REPLAY_STEPS, REPLAY_SEED = 8, 2000, 0
MEGA_BATCH, MEGA_STEPS = 16384, 100  # the experiment's defaults
ANT_CHECKPOINT = REPO / "logs" / "ant_ars" / "policy.pkl"
# tests/test_ant_policy.py's replay: 4 envs, 1000 steps, each alive for at
# least 900 of them and more than 9.0 m forward
ANT_REPLAY_BATCH, ANT_REPLAY_STEPS = 4, 1000
HOPPER_STEPS = 50
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
# bench.py's ARS recipe: 128 directions x 3000 steps, top 32, 768,000
# env-steps per iteration
ARS_RECIPE = {"num_directions": 128, "rollout_length": 3000, "top_directions": 32}
ARS_EVAL_ROLLOUTS, ARS_EVAL_STEPS = 16, 2000
ARS_MID_STEP = 1500  # halfway through a recipe rollout
# float64, card against CPU after one iteration, abs + rel: K2 float64
# agrees with the CPU to 3.9e-13 over 50 steps (phase 7)
ARS_TOL = 1e-9
# bench.py's rollout metrics: laikago's 1000-step and the ant's 500-step
# rollout of the zero linear policy at batch 4096, env-steps over the best
# of BENCH_REPEATS timed calls; vs_baseline over the reference's 2.0e5
# laikago env-steps/s (BASELINE.md)
LAIKAGO_BENCH_STEPS, ANT_BENCH_STEPS, BENCH_REPEATS, BASELINE = 1000, 500, 1, 2.0e5
HUMANOID_CHECKPOINT = REPO / "logs" / "humanoid_ars" / "policy_curr2.pkl"
# bench.py's humanoid rollout: batch min(4096 // 4, 2048), 200 steps
HUMANOID_BATCH, HUMANOID_STEPS = 1024, 200
# tests/test_humanoid_policy.py's replay: its seeds, its starts (the JAX
# package's reset draws for them, recorded in the JSON file), 3000 steps
HUMANOID_SEEDS, HUMANOID_REPLAY_STEPS = (0, 7, 123, 42), 3000
HUMANOID_RESET_NOISE = REPO / "tests" / "golden" / "humanoid_policy_reset_noise.json"
CHEETAH_BATCH, CHEETAH_STEPS = 4096, 50
# phase 13: bench.py's terrain rollout (500 steps at batch 4096), its +-2
# cm bump; tests/test_terrain_policy.py's replay (3000 steps on +-4 cm,
# policy_b4c.pkl against policy_r2b.pkl) and tests/test_terrain.py's
# (policy_r2b.pkl, 1500 steps on the +-2 cm mesh), from the JAX package's
# reset draws for their keys, recorded in the JSON file
TERRAIN_BUMP, TERRAIN_BENCH_STEPS, MESH_STEPS = 0.02, 500, 50  # the mesh's rollout a measurement (100 steps before)
TERRAIN_CHECKPOINT = REPO / "logs" / "laikago_terrain" / "policy_b4c.pkl"
TERRAIN_RESET_NOISE = REPO / "tests" / "golden" / "laikago_terrain_policy_reset_noise.json"
TERRAIN_REPLAY_BUMP, TERRAIN_REPLAY_STEPS, MESH_REPLAY_STEPS = 0.04, 3000, 1500
TERRAIN_SEEDS = (0, 1, 2, 3)  # the torch.Generator starts printed beside the JAX test's
POOL = REPO / "logs" / "humanoid_ars" / "pool_r5.npz"
# K1's row counts in phase 12 (a): laikago with top_k 1-3 or one friction
# direction (3, 6, 8, 9), laikago (12), the ant and the hopper (24), the
# half-cheetah (48), the ant without compaction (51), the humanoid (105)
K1_ROWS, K1_BATCHES = (3, 6, 8, 9, 12, 24, 48, 51, 105), (1, 37, 4096)
# phase 14: K1's backward at the paths' row counts and batches (laikago 12,
# the ant, hopper and terrain 24, the half-cheetah 48, the humanoid 105 at
# its batch 1024); tests/test_contact_gradients.py's 500-step loss and the
# CPU test's 100 steps; examples/laikago_apg.py's scaled recipe (horizon
# 100, truncation 20) at batch 4 and 4096, test_learn.py's laikago setup
# (horizon 30, batch 2, truncation 10), and test_committed_apg_policy_walks's
# replay of policy_h100.pkl (500 steps from the JAX package's reset)
GRAD_ROWS = ((12, 4096), (24, 4096), (48, 4096), (105, 1024))
CONTACT_LOSS_STEPS, CONTACT_LOSS_CPU_STEPS = 500, 100
APG_RECIPE = {"horizon": 100, "truncation": 20}
APG_BATCHES, APG_TIMED_ITERATIONS = (4, 4096), 1
APG_TEST = {"horizon": 30, "batch": 2, "truncation": 10}
APG_LEARN_ITERATIONS, APG_REPLAY_STEPS = 25, 500
APG_CHECKPOINT = REPO / "logs" / "laikago_apg" / "policy_h100.pkl"
APG_RESET = REPO / "tests" / "golden" / "laikago_apg_reset.json"
PROFILE_STEPS = 20  # graph-replayed steps under torch.profiler
# measurements only, cut to keep the script inside 700 s, under 60% of its
# limit: eager steps of the stage breakdown, now of the laikago's main path
# only (5 steps on every main path before), alternating timed runs of each
# graph length of ARS's rollout (10 before), the humanoid's top_k = 8
# rollout (200 steps, best of 3 before) and the eager steps timed beside
# K2 (MEGA_STEPS before); BENCH_REPEATS and APG_TIMED_ITERATIONS were 3
BREAKDOWN_STEPS, CHUNK_RUNS, TOP_K_STEPS, TOP_K_REPEATS, MEGA_EAGER_STEPS = 1, 2, 50, 1, 20


def log(msg):
    print(msg, flush=True)


def captured_launches(before):
    """What a kernel wrapper counts while ``scan`` builds the graphs that are
    new since ``before`` (``utils.graphs.stats()`` then), for bodies that
    launch the kernel once a step: a warm-up step for each new (key, batch)
    and every step a capture records. A replay calls no wrapper; what it ran
    is read from a trace (``device_profile``)."""
    from tds_tpu_torch.utils import graphs

    new = [g for g in graphs.stats() if g not in before]
    return sum(g.steps for g in new) + len({(g.key, g.batch) for g in new} - {(g.key, g.batch) for g in before})


def check_wrapper_launches(label, kernel, launches, before):
    """Raises unless the run launched ``kernel`` through its wrapper, as
    many times as the graphs it captured account for."""
    expected = captured_launches(before)
    if launches == 0 or launches != expected:
        raise AssertionError(f"{label}: the {kernel} wrapper launched {launches} times, expected {expected} (the warm-ups "
                             "and the steps captured in this run)")


def bench_line(metric, value, unit, card_line, **extra):
    """A metric line in bench.py's format (its metric names), with the
    card's name and power limit as nvidia-smi gives them beside the number."""
    log(json.dumps({"metric": metric, "value": value, "unit": unit, **extra, "card": card_line}))


def grad_guard(label, fn, args, mark, launches):
    """A kernel without a backward: ``fn(*args)`` with ``args[mark]``
    requiring grad must raise under grad, without a launch, and return under
    torch.no_grad() what it returns without one; ``launches()`` reads the
    kernel's counter."""
    expected = fn(*args)
    marked = list(args)
    marked[mark] = args[mark].clone().requires_grad_()
    before = launches()
    try:
        fn(*marked)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError(f"{label} ran under grad on an operand that requires grad")
    with torch.no_grad():
        got = fn(*marked)
    torch.cuda.synchronize()
    pairs = zip(got, expected) if isinstance(got, tuple) else [(got, expected)]
    if launches() != before + 1 or not all(torch.equal(g, e) for g, e in pairs):
        raise AssertionError(f"{label} under torch.no_grad(): {launches() - before} launches, or another result")
    log(f"{label}: refused under grad an operand that requires grad ({message.split(' (')[0]}); under "
        "torch.no_grad() the same call launched once and returned the same result bit for bit")


def k1_grad_check(label, a, b, lo, hi, dep, it):
    """K1 under grad with b requiring grad: the same x as without grad, one
    forward and one backward launch, and b's gradient (for a cotangent of
    ones) within rtol 1e-4 and atol 1e-5 max|grad| of the plain version's
    autograd on the same tensors in float32 (1e-12 relative in float64);
    under torch.no_grad() the same x again, carrying no grad."""
    from tds_tpu_torch.contact import pgs

    with torch.no_grad():
        expected = pgs.solve_pgs(a, b, lo, hi, dep, it)
    b_grad, b_ref = b.clone().requires_grad_(), b.clone().requires_grad_()
    before = (pgs.launches, pgs.backward_launches)
    x = pgs.solve_pgs(a, b_grad, lo, hi, dep, it)
    (got,) = torch.autograd.grad(x.sum(), b_grad)
    after = (pgs.launches, pgs.backward_launches)
    (want,) = torch.autograd.grad(pgs.solve_pgs_reference(a, b_ref, lo, hi, dep, it).sum(), b_ref)
    with torch.no_grad():
        again = pgs.solve_pgs(a, b_grad, lo, hi, dep, it)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    rtol, atol = (1e-4, 1e-5 * scale) if b.dtype == torch.float32 else (1e-12, 1e-12 * scale)
    err = (got - want).abs()
    if after != (before[0] + 1, before[1] + 1) or not torch.equal(x.detach(), expected) or not torch.equal(again, expected) \
            or again.requires_grad or (err - (atol + rtol * want.abs())).max().item() > 0:
        raise AssertionError(f"{label} under grad: launches {before} -> {after}, or another x, or a gradient "
                             f"{err.max().item():.3e} from the plain version's autograd")
    log(f"{label}: carried the gradient of an operand that requires grad through its backward kernel (one forward and one "
        f"backward launch): max |kernel - plain autograd| {err.max().item():.3e} (max |grad| {scale:.3g}); the same x "
        "with and without grad, bit for bit")


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
    return name, smi


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
    """SPD A = J J^T + 1e-3 I with J (n, 8), as tests/test_pallas_pgs.py,
    n = 3 n_c rows: n_c normal rows, then two friction rows per contact."""
    return random_rows_problem(batch, 3 * n_c, dtype, generator)


def random_rows_problem(batch, n, dtype, generator):
    """random_pgs_problem's layout for any n rows: n / 3 contacts when 3
    divides n, else n / 2 normal rows and one friction direction (n = 8:
    laikago with num_friction_dir = 1); friction rows bounded by +-0.5 times
    their normal row's impulse."""
    n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
    dev = generator.device
    j = torch.randn(batch, n, 8, generator=generator, dtype=torch.float64, device=dev)
    a = j @ j.transpose(-1, -2) + 1e-3 * torch.eye(n, dtype=torch.float64, device=dev)
    b = torch.randn(batch, n, generator=generator, dtype=torch.float64, device=dev)
    lo = torch.cat([torch.zeros(batch, n_c, device=dev), torch.full((batch, n - n_c), -0.5, device=dev)], -1)
    hi = torch.cat([torch.full((batch, n_c), 1e5, device=dev), torch.full((batch, n - n_c), 0.5, device=dev)], -1)
    dep = [-1] * n_c + [k % n_c for k in range(n - n_c)]
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


def pgs_bound(b, iterations, card):
    """(ms for K1's bytes, ms for its flops, bytes, flops) on the PGS
    operands whose b is ``b``: what the function needs of them read once, x
    written once. From x = 0 the first sweep's row i reads only A_ij for
    j <= i (x_j = 0 for j > i), so one sweep needs A's lower triangle and
    later sweeps all of A; b, lo, hi and dep read once. Per row: 2 flops for
    each off-diagonal product and sum it takes (i in the first sweep, n - 1
    after), b - delta, a divide and two bound scales."""
    bsz, n = b.shape
    a_values = n * (n + 1) // 2 if iterations <= 1 else n * n
    n_bytes = b.element_size() * (bsz * a_values + 4 * bsz * n) + 4 * n
    first = n * (n - 1) + 4 * n if iterations >= 1 else 0
    n_ops = bsz * (first + max(iterations - 1, 0) * n * (2 * (n - 1) + 4))
    bandwidth, f32_rate, f64_rate = card
    rate = f32_rate if b.dtype == torch.float32 else f64_rate
    return n_bytes / bandwidth * 1e3, n_ops / rate * 1e3, n_bytes, n_ops


def harvest_pgs_operands(env, gen, warm_steps, label, prefix, batch=MAIN_BATCH):
    """The PGS operands of one step at ``batch``, after ``reset`` from
    ``gen`` and ``warm_steps`` zero-policy steps, with contact rows active."""
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    state, obs = env.reset(gen, batch_size=batch)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    state = rollout(env, policy, None, state, obs, warm_steps)[0]
    with recorded_pgs_calls() as calls:
        env.step(state, torch.zeros(batch, env.action_dim, dtype=env.dtype, device=env.device))
    if len(calls) != 1:
        raise AssertionError(f"expected one PGS call in a {label} step, saw {len(calls)}")
    active = int((calls[0][1] != 0).sum())
    if active == 0:
        raise AssertionError(f"no contact row is active in the harvested {label} step")
    log(f"{prefix}: harvested the PGS operands of {label} step {env.settle_steps + warm_steps + 1} at batch "
        f"{batch}: {active} of {calls[0][1].numel()} rows active")
    return calls[0]


def phase_kernel(env, card):
    from tds_tpu_torch.contact import pgs

    # the toes reach the ground about 65 steps after the reset: harvest the
    # operands of a step with the contacts active
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_args = harvest_pgs_operands(env, gen, ROLLOUT_STEPS, "laikago", "kernel")
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

    a, b, lo, hi, dep, it = main_args
    k1_grad_check("kernel: K1", a, b, lo, hi, dep, it)

    # time both versions on the main path's own operands (A stays in L2, as
    # in the step, where the previous op just wrote it)
    ms = device_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, it), rounds=5, per_round=20)
    # the same launch with no sweep: the launch, the loads and the stores
    sweepless_ms = device_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, 0), rounds=5, per_round=20)
    plain_ms = device_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, it), rounds=10, per_round=4, backlog_ms=50)
    kernel_wall = wall_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, it), reps=200)
    plain_wall = wall_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, it), reps=20)
    bsz, n = b.shape
    t_bytes, t_ops, n_bytes, n_ops = pgs_bound(b, it, card)
    log(f"kernel: main-path shape B={bsz} n={n} it={it} {b.dtype}: kernel {ms * 1e3:.2f} us on the device "
        f"({kernel_wall * 1e3:.2f} us wall per call), plain {plain_ms * 1e3:.1f} us on the device ({plain_wall * 1e3:.1f} us wall), bound {max(t_bytes, t_ops) * 1e3:.3f} us "
        f"({n_bytes} bytes, {n_ops} flops)")
    log(f"kernel: the same launch with 0 sweeps (launch, loads and stores): {sweepless_ms * 1e3:.2f} us on the device")
    shape = pgs.launch_shape(b.dtype, n, bsz)
    log_launch_shape(f"kernel: B={bsz} n={n} {b.dtype} ({shape['form']})", shape)
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
        "design": shape["form"],
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
    ("tds_tpu_torch.contact.mlcp", "top_k_indices"),
    ("tds_tpu_torch.contact.pgs", "solve_pgs"),
    ("tds_tpu_torch.envs.locomotion", "integrate_q"),
    # the terrain's height scan (phase 13; no call on a flat ground)
    ("tds_tpu_torch.envs.locomotion", "heightfield_height"),
    ("tds_tpu_torch.envs.locomotion", "ray_mesh"),
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
    from tds_tpu_torch.utils import graphs

    with graphs.eager(), timed_stages() as host_s:
        rollout(env, policy, None, state, obs, 1)
        torch.cuda.synchronize()
        host_s.update(dict.fromkeys(host_s, 0.0))
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


def graph_lines(prefix, *key_parts):
    """Logs every cached graph whose scan key holds all of ``key_parts``:
    steps per replay, nodes, capture and instantiate seconds."""
    from tds_tpu_torch.utils import graphs

    found = [g for g in graphs.stats() if isinstance(g.key, tuple) and all(any(p is k or p == k for k in g.key) for p in key_parts)]
    for g in found:
        log(f"{prefix}: graph {g.key[0]} at batch {g.batch}: {g.steps} step(s) per replay, {g.nodes} nodes, captured in "
            f"{g.capture_s:.3f} s, instantiated in {g.instantiate_s:.3f} s")
    return found


def timed_call(fn):
    """(result, seconds) of ``fn()``, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_main_path(env, label, steps, z_index, z_range, card_line, bench=None, batch=MAIN_BATCH, stages=False):
    """``reset`` at ``batch`` and a ``steps``-step rollout of the zero
    linear policy through graphs, the first use of ``env``, with K1's
    wrapper launches counted from 0 just before and read just after (the
    warm-ups and the captures); every env must be alive with q[:, z_index]
    in ``z_range``. Then: the same rollout replayed again (graph ms/step)
    and run eagerly (``graphs.eager()``, eager ms/step), which must agree
    bit for bit; PROFILE_STEPS replayed steps under torch.profiler (device
    operations, busy ms, and K1 kernels, exactly one a step); the graphs'
    statistics; with ``stages``, BREAKDOWN_STEPS eager steps' stage
    breakdown; and with
    ``bench = (metric, steps)`` bench.py's rollout metric: the best of
    BENCH_REPEATS rollouts of that many steps (the timed replay one of them
    when it has that many; bench.py itself takes the best of 3). Returns a
    dict of the numbers; device
    numbers None when the profiler saw no device activity."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout
    from tds_tpu_torch.utils import graphs

    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    gen = torch.Generator(device=env.device).manual_seed(1)
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    (state0, obs0), reset_s = timed_call(lambda: env.reset(gen, batch_size=batch))
    (state, obs, total, alive), first_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, steps))
    launches = pgs.launches
    check_wrapper_launches(label, "PGS", launches, cached)
    for name, t in (("q", state.q), ("qd", state.qd), ("obs", obs), ("total reward", total)):
        if t.shape[0] != batch or not torch.isfinite(t).all():
            raise AssertionError(f"{label}: {name} is not finite or has shape {tuple(t.shape)}")
    z = state.q[:, z_index]
    if not bool(alive.all()) or not bool(((z > z_range[0]) & (z < z_range[1])).all()):
        raise AssertionError(f"{label}: the zero policy should stand: {int(alive.sum())}/{batch} alive, "
                             f"q[:, {z_index}] in [{z.min():.3f}, {z.max():.3f}]")
    again, graph_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, steps))
    with graphs.eager():
        eager, eager_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, steps))
    log(f"{label} seconds: reset {reset_s:.1f} s, first rollout {first_s:.1f} s, replay {graph_s:.1f} s, eager {eager_s:.1f} s")
    # the same kernels on the same inputs in the same order: bit for bit
    worst = max((g.double() - e.double()).abs().max().item() for g, e in zip((*again[0], *again[1:]), (*eager[0], *eager[1:])))
    if worst != 0:
        raise AssertionError(f"{label}: the graph rollout differs from the eager one by up to {worst:.3e}")
    step_ms, eager_ms = graph_s * 1e3 / steps, eager_s * 1e3 / steps
    log(f"{label}: reset ({env.settle_steps} settle steps, graphs) at batch {batch} in {reset_s * 1e3:.1f} ms; "
        f"{steps}-step rollout through graphs: first call {first_s:.3f} s (with the captures), then "
        f"{step_ms:.3f} ms/step = {batch / step_ms * 1e3:.1f} env-steps/s; eager (graphs.eager()) "
        f"{eager_ms:.3f} ms/step = {batch / eager_ms * 1e3:.1f} env-steps/s, graph {eager_ms / step_ms:.2f}x; "
        f"|graph - eager| = 0 over every output; PGS wrapper launches {launches} (warm-ups and captures); "
        f"q[:, {z_index}] in [{z.min():.3f}, {z.max():.3f}]")
    found = graph_lines(label, env, "rollout")
    with sub_phase(f"{label} seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: rollout(env, policy, None, state0, obs0, PROFILE_STEPS), calls=1,
                                 kernel="pgs_kernel", expected=PROFILE_STEPS)
    out = {"launches": launches, "ms_per_step": step_ms, "eager_ms_per_step": eager_ms, "first_call_s": first_s,
           "graph_nodes": [g.nodes for g in found], "graph_vs_eager_max_abs": worst,
           "device_ops": None, "device_ms": None, "idle": None, "replayed_launches_per_step": None}
    if profile is None:
        log(f"{label}: device operations per step not measured (the profiler saw no device activity)")
    else:
        # the idle share within the profiled window itself: under the
        # profiler each replayed kernel's span grows, so the busy time can
        # exceed the unprofiled wall time
        ops, busy, profiled_ms, k1 = profile
        if k1 != PROFILE_STEPS:
            raise AssertionError(f"{label}: {PROFILE_STEPS} replayed steps ran the PGS kernel {k1} times in the fullest "
                                 f"trace, of {ops:.0f} device operations")
        ops, busy, profiled_ms = (x / PROFILE_STEPS for x in (ops, busy, profiled_ms))
        out.update(device_ops=ops, device_ms=busy, idle=1 - busy / profiled_ms, replayed_launches_per_step=k1 / PROFILE_STEPS)
        log(f"{label}: graph replays: {ops:.0f} device operations per step, {k1} PGS kernels in {PROFILE_STEPS} replayed "
            f"steps (torch.profiler), device busy {busy:.3f} ms/step of {profiled_ms:.3f} ms wall under the profiler "
            f"({100 * (1 - busy / profiled_ms):.1f}% idle; {step_ms:.3f} ms/step without it)")
    if bench is not None:
        metric, bench_steps = bench
        bench_s = time.perf_counter()
        # the timed replay above is one of the repeats when it has the bench's steps
        times = [graph_s] if bench_steps == steps else []
        times += [timed_call(lambda: rollout(env, policy, None, state0, obs0, bench_steps))[1]
                  for _ in range(BENCH_REPEATS - len(times))]
        best = min(times)
        rate = batch * bench_steps / best
        out[metric] = rate
        bench_line(metric, rate, "steps/s", card_line, vs_baseline=rate / BASELINE, batch=batch, steps=bench_steps,
                   best_s=best, eager_env_steps_per_s=batch / eager_ms * 1e3)
        log(f"{label} seconds: the bench rollouts: {time.perf_counter() - bench_s:.1f} s")
    if not stages:
        return out
    with sub_phase(f"{label} seconds: the stage breakdown"):
        breakdown = stage_breakdown(env, policy, state, obs, steps=BREAKDOWN_STEPS)
    if breakdown is None:
        log(f"{label}: stage breakdown not measured (the profiler saw no device activity)")
        return out
    log(f"{label}: eager: {breakdown['device_ops']:.0f} device operations per step (torch.profiler), device busy "
        f"{breakdown['device_ms']:.3f} ms/step of {eager_ms:.3f} ms ({100 * (1 - breakdown['device_ms'] / eager_ms):.1f}% idle), "
        f"PGS kernel {breakdown['pgs_kernel_ms'] * 1e3:.2f} us/step")
    out.update(eager_device_ops=breakdown["device_ops"], eager_idle=1 - breakdown["device_ms"] / eager_ms)
    log(f"{label}: eager stages per step (host ms timed without the profiler, {breakdown['step_ms_with_stage_timers']:.3f} ms/step "
        "with the stage timers; device operations and ms from the profiler; gather_pair_contacts to "
        "solve_pgs are parts of resolve_contacts):")
    for name, row in breakdown["stages"].items():
        log(f"  {name:26s} host {row['host_ms']:8.3f} ms  device ops {row['device_ops']:6.0f}  device {row['device_ms']:7.3f} ms")
    return out


def phase_main_path(env, card_line):
    bench = ("laikago_scan_rollout_env_steps_per_s", LAIKAGO_BENCH_STEPS)
    return drive_main_path(env, "main path", ROLLOUT_STEPS, 2, (0.3, 0.6), card_line, bench, stages=True)


# -- phase 6 ---------------------------------------------------------------
def phase_trained_policy(env):
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
    from tds_tpu_torch.rollout import rollout
    from tds_tpu_torch.utils import graphs

    saved, _ = load_checkpoint(str(CHECKPOINT))
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=env.dtype)
    gen = torch.Generator(device="cpu").manual_seed(REPLAY_SEED)
    u = torch.rand((REPLAY_BATCH, env.action_dim), generator=gen, dtype=env.dtype)
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    state, obs = env.reset(noise=-env.reset_noise + 2.0 * env.reset_noise * u)
    t0 = time.perf_counter()
    state, obs, total, alive = rollout(env, policy, stat, state, obs, REPLAY_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pgs.launches
    check_wrapper_launches("trained policy", "PGS", launches, cached)
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
    log(f"trained policy: {REPLAY_STEPS} steps at batch {REPLAY_BATCH} through graphs in {seconds:.1f} s (capture "
        f"included); all envs walk; PGS wrapper launches {launches} (warm-ups and captures)")
    graph_lines("trained policy", env, "rollout")


# -- phase 7 ---------------------------------------------------------------
def device_profile(fn, calls, kernel=None, expected=None):
    """(device operations, device-busy ms, wall ms, kernels whose name holds
    ``kernel``) per call of ``fn``, from torch.profiler over ``calls``
    calls, the wall time taken around the profiled calls themselves; None
    when it saw no device activity. With ``kernel``, the trace is
    counted_trace's for ``expected`` such kernels in all. Unlike device_ms,
    this allows ``fn`` to synchronise."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    if kernel is None:
        (device_events, _, seconds), named = device_trace(run), 0
    else:
        device_events, _, seconds, named = counted_trace(run, kernel, expected)
    wall_ms = seconds * 1e3 / calls
    if not device_events:
        return None
    return len(device_events) / calls, sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / calls, wall_ms, named / calls


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
    grad_guard("mega step: K2", fused, (q, qd, action), 2, lambda: fused_step.launches)
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
    _, _, eager_s = megastep.timed_steps(env.sim_step, qs, qds, zero, MEGA_EAGER_STEPS)
    mega_rate, eager_rate = MEGA_BATCH * MEGA_STEPS / mega_s, MEGA_BATCH * MEGA_EAGER_STEPS / eager_s
    log(f"mega step: experiment loop, {MEGA_STEPS} float32 steps at batch {MEGA_BATCH}: K2 {mega_s * 1e3 / MEGA_STEPS:.3f} ms/step "
        f"= {mega_rate:.1f} env-steps/s, eager sim_step ({MEGA_EAGER_STEPS} steps) {eager_s * 1e3 / MEGA_EAGER_STEPS:.3f} ms/step "
        f"= {eager_rate:.1f} env-steps/s, ratio {mega_rate / eager_rate:.2f}x; K2 launches {launches}")

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
        (eager_ops, eager_busy, _, _), (_, plain_ms, _, _) = eager_profile, plain_profile
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


# -- phase 9 ---------------------------------------------------------------
def ars_card_against_cpu():
    """(a): one float64 iteration, 8 directions x 100 steps, top 4, from
    the params and observation statistics of ``policy.pkl`` (finite stds,
    so the normalisation divides by them), on the card (K2) and on the CPU
    (its plain version) from the same draws; returns the largest
    difference."""
    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.utils import graphs

    config = ars.ARSConfig(num_directions=8, rollout_length=100, top_directions=4)
    policy = MLPSpec(36, [12])
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", fused_step=True)
    gpu_env = LaikagoEnv(dtype=torch.float64, fused_step=True)
    saved, _ = load_checkpoint(str(STAT_CHECKPOINT))
    cpu_start, gpu_start = (
        ars_state_from_numpy(saved["params"], saved["obs_stat"], dtype=torch.float64, device=d) for d in ("cpu", "cuda")
    )
    if not bool((cpu_start.obs_stat.scale() != 1).all()):
        raise AssertionError(f"{STAT_CHECKPOINT.name}'s statistics leave the normalisation dividing by 1")
    gen = torch.Generator(device="cpu").manual_seed(9)
    deltas = torch.randn(config.num_directions, policy.num_parameters, generator=gen, dtype=torch.float64)
    noise = cpu_env.draw_reset_noise(gen, config.num_directions)
    cpu = ars.ars_iteration(cpu_env, policy, config, cpu_start, deltas, noise)
    cached = graphs.stats()
    before = fused_step.launches
    gpu = ars.ars_iteration(gpu_env, policy, config, gpu_start, deltas.cuda(), noise.cuda())
    torch.cuda.synchronize()
    launches = fused_step.launches - before
    check_wrapper_launches("ARS (a)", "K2", launches, cached)
    pairs = [("params", gpu[0].params, cpu[0].params), ("total_timesteps", gpu[0].total_timesteps, cpu[0].total_timesteps)]
    pairs += [(f"obs_stat.{f}", getattr(gpu[0].obs_stat, f), getattr(cpu[0].obs_stat, f)) for f in ("count", "mean", "m2")]
    pairs += [(k, gpu[1][k], cpu[1][k]) for k in cpu[1]]
    worst, worst_scaled, worst_name = 0.0, 0.0, None
    for name, got, expected in pairs:
        got, expected = got.cpu().double(), expected.double()
        diff = (got - expected).abs()
        if diff.max().item() > worst:
            worst, worst_name = diff.max().item(), name
        worst_scaled = max(worst_scaled, (diff / (1 + expected.abs())).max().item())
        if not bool(torch.isfinite(got).all()) or excess(got, expected, ARS_TOL) > 0:
            raise AssertionError(f"ARS on the card and on the CPU differ beyond {ARS_TOL} in {name}")
    log(f"ARS (a): one float64 iteration from {STAT_CHECKPOINT.name}, {config.num_directions} directions x "
        f"{config.rollout_length} steps, top {config.top_directions}, card (K2 through graphs, {launches} wrapper launches in the warm-ups and captures) against CPU, over "
        f"params, obs_stat and metrics: "
        f"max |cuda - cpu| = {worst:.3e} (in {worst_name}), max |cuda - cpu| / (1 + |cpu|) = {worst_scaled:.3e} "
        f"(tolerance {ARS_TOL}); reward_max {cpu[1]['reward_max'].item():.4f}")
    return worst_scaled


@contextlib.contextmanager
def recorded_k2_calls(wanted):
    """Records the operands and results of the K2 calls that a
    ``LocomotionEnv(fused_step=True)`` makes inside the block, for the calls
    whose index, counted from 0, is in ``wanted``."""
    from tds_tpu_torch.envs import locomotion

    calls, seen = {}, [0]
    step = locomotion.mega_step

    def recording_step(params, q, qd, action):
        out = step(params, q, qd, action)
        if seen[0] in wanted:
            calls[seen[0]] = (q.clone(), qd.clone(), action.clone(), out)
        seen[0] += 1
        return out

    locomotion.mega_step = recording_step
    try:
        yield calls
    finally:
        locomotion.mega_step = step


def ars_k2_against_plain(env, policy, state):
    """(b): K2 against its plain version on the float32 batch-256 operands
    that a recipe rollout from ``state`` hands it: the first step after the
    reset and step ARS_MID_STEP, mid-gait with contact rows active. K2's
    results are the rollout's own; the plain version runs on the CPU on the
    same operands, held at MEGA_TOL over the envs whose operands are
    finite. Returns the largest |K2 - plain|."""
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.utils import graphs

    first, mid = env.settle_steps, env.settle_steps + ARS_MID_STEP - 1
    with graphs.eager(), recorded_k2_calls({first, mid}) as calls:
        ars.make_train_step(env, policy, ars.ARSConfig(**{**ARS_RECIPE, "rollout_length": ARS_MID_STEP}))(state)
    cpu_params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float32, device="cpu"))
    exact_params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, device="cpu"))
    worst = 0.0
    for label, index in (("after the reset", first), (f"at step {ARS_MID_STEP}", mid)):
        q, qd, action = (t.cpu() for t in calls[index][:3])
        ok = torch.isfinite(torch.cat([q, qd, action], -1)).all(-1)
        if not bool(ok.any()):
            raise AssertionError(f"no rollout's K2 operands are finite {label}")
        q, qd, action, got = q[ok], qd[ok], action[ok], [t.cpu()[ok] for t in calls[index][3]]
        plain = fused_step.mega_step_reference(cpu_params, q, qd, action)
        exact = fused_step.mega_step_reference(exact_params, q.double(), qd.double(), action.double())
        contacts = int((fused_step.sphere_distances(cpu_params, q) < 0).sum())
        if index == mid and contacts == 0:
            raise AssertionError(f"no contact row was active at step {ARS_MID_STEP} of the recipe rollout")
        for name, g, e, x in (("q", got[0], plain[0], exact[0]), ("qd", got[1], plain[1], exact[1])):
            err = (g - e).abs().max().item()
            over = excess(g, e, MEGA_TOL[name])
            worst = max(worst, err)
            log(f"ARS (b): K2 float32 B={q.shape[0]} ({len(ok)} rollouts, {q.shape[0]} with finite operands) {label}, "
                f"{contacts} contacts active: max |K2 - plain on the CPU| on {name} = {err:.3e} (tolerance {MEGA_TOL[name]} "
                f"abs + rel, margin left {-over:.3e}); max |K2 - float64 plain| {(g.double() - x).abs().max().item():.3e}")
            if over > 0 or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"K2 at batch {len(ok)} {label} differs from its plain version beyond {MEGA_TOL[name]} on {name}")
    return worst


def ars_eval(eval_fn, state, label):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = {k: v.item() for k, v in eval_fn(state, torch.Generator(device="cuda").manual_seed(123)).items()}
    seconds = time.perf_counter() - t0
    log(f"ARS (b): eval {label}: {ARS_EVAL_ROLLOUTS} rollouts x {ARS_EVAL_STEPS} steps in {seconds:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in metrics.items()))
    if not metrics["eval_reward_min"] > 1100.0:
        raise AssertionError(f"the policy {label} fails eval_reward_min > 1100")
    return metrics


def stat_finite(stat, start):
    """Whether the statistics ``stat`` grown from ``start`` are finite:
    count and mean everywhere, m2 wherever start's was. (policy_r2b.pkl's
    m2 is NaN in every entry, and a merge keeps it so; the std guard then
    reads its std as 1.)"""
    count, mean, m2 = (torch.as_tensor(x) for x in stat)
    m2_ok = torch.isfinite(m2) | ~torch.isfinite(torch.as_tensor(start[2]))
    return bool(m2_ok.all() and torch.isfinite(count).all() and torch.isfinite(mean).all())


def ars_recipe(env, policy, state):
    """(b): the recipe's iterations from ``state``: 1 warm-up, which
    captures the graphs (K2's wrapper counts its warm-ups and captures), and
    3 timed, which only replay them (the wrapper counts nothing); returns
    (the last state, seconds of each timed iteration, K2 wrapper launches
    of each iteration)."""
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.utils import graphs

    config = ars.ARSConfig(**ARS_RECIPE)
    step_fn = ars.make_train_step(env, policy, config)
    env_steps = 2 * config.num_directions * config.rollout_length
    seconds, launches = [], []
    for it in range(4):
        torch.cuda.synchronize()
        cached = graphs.stats()
        fused_step.launches = 0
        t0 = time.perf_counter()
        new_state, metrics = step_fn(state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(fused_step.launches)
        steps = (new_state.total_timesteps - state.total_timesteps).item()
        finite = stat_finite(new_state.obs_stat, state.obs_stat) and all(
            bool(torch.isfinite(t).all()) for t in (new_state.params, metrics["g_hat_norm"])
        )
        log(f"ARS (b): recipe iteration {it} ({'warm-up' if it == 0 else 'timed'}): {seconds[-1]:.3f} s, K2 wrapper "
            f"launches {launches[-1]}, {steps} env-steps alive of {env_steps}, "
            + ", ".join(f"{k} {v.item():.4f}" for k, v in metrics.items()))
        if it == 0:
            check_wrapper_launches("ARS (b) warm-up iteration", "K2", launches[-1], cached)
        elif launches[-1] != 0:
            raise AssertionError(f"timed recipe iteration {it} called the K2 wrapper {launches[-1]} times: it should only replay graphs")
        if not finite or not 0 < steps <= env_steps:
            raise AssertionError(f"recipe iteration {it}: finite {finite}, {steps} env-steps")
        state = new_state
    return state, seconds[1:], launches


def ars_profile(env, policy, state, steps):
    """(c): one iteration of the recipe at ``steps`` steps: wall ms through
    graphs and eagerly (``graphs.eager()``) without the profiler, from the
    same draws, whose new states and metrics must agree bit for bit; then,
    through graphs, device operations, device-busy ms, K2's kernels (one a
    step) and its time per launch from torch.profiler (None when it saw no
    device activity)."""
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.utils import graphs

    step_fn = ars.make_train_step(env, policy, ars.ARSConfig(**{**ARS_RECIPE, "rollout_length": steps}))
    draws = state.generator.get_state()

    def iteration():
        state.generator.set_state(draws)
        return step_fn(state)

    iteration()
    graph_out, wall_s = timed_call(iteration)
    with graphs.eager():
        iteration()
        eager_out, eager_s = timed_call(iteration)
    pairs = [("params", graph_out[0].params, eager_out[0].params)]
    pairs += [(f"obs_stat.{f}", getattr(graph_out[0].obs_stat, f), getattr(eager_out[0].obs_stat, f)) for f in ("count", "mean", "m2")]
    pairs += [(k, graph_out[1][k], eager_out[1][k]) for k in eager_out[1]]
    for name, g, e in pairs:
        # policy_r2b.pkl's m2 is NaN, and a merge keeps it so
        if g.shape != e.shape or not bool(((g == e) | (g.isnan() & e.isnan())).all()):
            raise AssertionError(f"ARS (c): the graph iteration and the eager one differ in {name}")
    log(f"ARS (c): one recipe iteration at {steps} steps through graphs and eagerly from the same draws: params, obs_stat "
        "and metrics agree bit for bit")
    device_events, _, profiled_s, _ = counted_trace(iteration, "megastep_kernel", env.settle_steps + steps)
    if not device_events:
        return wall_s * 1e3, eager_s * 1e3, None
    k2 = [e.time_range.elapsed_us() for e in device_events if "megastep_kernel" in e.name]
    if len(k2) != env.settle_steps + steps:
        raise AssertionError(f"ARS (c): {env.settle_steps + steps} replayed steps ran K2 {len(k2)} times in the trace")
    return wall_s * 1e3, eager_s * 1e3, {
        "device_ops": len(device_events),
        "device_ms": sum(e.time_range.elapsed_us() for e in device_events) / 1e3,
        "profiled_ms": profiled_s * 1e3,
        "k2_launches": len(k2),
        "k2_us": sum(k2) / len(k2),
    }


def ars_chunks(env, policy, state):
    """(c): the recipe's rollout (2 x 128 directions x 3000 steps) from
    ``state``'s params, through graphs of one step and of ``ars.FUSED_CHUNK``
    steps, CHUNK_RUNS timed runs of each, alternating, after a first call of
    each that captures; returns {chunk: [seconds of each run]}."""
    from tds_tpu_torch.learn import ars

    config = ars.ARSConfig(**ARS_RECIPE)
    batch = 2 * config.num_directions
    params = state.params[None].repeat(batch, 1)
    noise = env.draw_reset_noise(torch.Generator(device=env.device).manual_seed(11), batch)
    chunks = (1, ars.FUSED_CHUNK)
    runs = {c: [] for c in chunks}
    for c in chunks:
        ars._rollout_with_stats(env, policy, params, state.obs_stat, noise, config, chunk=c)
    for _ in range(CHUNK_RUNS):
        for c in chunks:
            runs[c].append(timed_call(lambda: ars._rollout_with_stats(env, policy, params, state.obs_stat, noise, config, chunk=c))[1])
    for c in chunks:
        t = sorted(runs[c])
        log(f"ARS (c): recipe rollout at batch {batch}, {config.rollout_length} steps, {c} step(s) a graph: median "
            f"{t[len(t) // 2] * 1e3 / config.rollout_length:.4f} ms/step, min {t[0] * 1e3 / config.rollout_length:.4f}, "
            f"max {t[-1] * 1e3 / config.rollout_length:.4f} over {CHUNK_RUNS} runs, alternating (s: "
            + ", ".join(f"{x:.4f}" for x in runs[c]) + ")")
    one, chunked = (sorted(runs[c]) for c in chunks)
    log(f"ARS (c): chunks of {ars.FUSED_CHUNK} steps against one step a graph: median {one[len(one) // 2] / chunked[len(chunked) // 2]:.3f}x; "
        f"slowest chunked run {chunked[-1]:.4f} s against fastest one-step run {one[0]:.4f} s")
    return runs


def phase_ars(card, mega, card_line):
    import tempfile

    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.tools import ars_train

    with sub_phase("ARS (a) seconds"):
        worst = ars_card_against_cpu()

    # (b) the recipe in float32 from the trained policy
    b_start = time.perf_counter()
    env = LaikagoEnv(dtype=torch.float32, fused_step=True)
    policy = MLPSpec(env.observation_dim, [env.action_dim])
    saved, _ = load_checkpoint(str(CHECKPOINT))
    state = ars_state_from_numpy(saved["params"], saved["obs_stat"], seed=0, dtype=env.dtype)
    eval_config = ars.ARSConfig(**{**ARS_RECIPE, "rollout_length": ARS_EVAL_STEPS})
    eval_fn = ars.make_eval(env, policy, eval_config, num_rollouts=ARS_EVAL_ROLLOUTS)
    before = ars_eval(eval_fn, state, "of policy_r2b.pkl")
    k2_err = ars_k2_against_plain(env, policy, state)
    trained, seconds, launches = ars_recipe(env, policy, state)
    after = ars_eval(eval_fn, trained, "after the 4 recipe iterations")
    s_per_it = sum(seconds) / len(seconds)
    env_steps = 2 * ARS_RECIPE["num_directions"] * ARS_RECIPE["rollout_length"]
    log(f"ARS (b): recipe {ARS_RECIPE}, float32, batch {2 * ARS_RECIPE['num_directions']}: {s_per_it:.3f} s/iteration "
        f"(timed {', '.join(f'{s:.3f}' for s in seconds)}) = {1 / s_per_it:.4f} iterations/s = "
        f"{env_steps / s_per_it:.1f} env-steps/s; K2 wrapper launches per iteration {launches} (the warm-up's captures, "
        "then replays only)")

    bench_line("ars_laikago_iterations_per_s", 1 / s_per_it, "iterations/s", card_line, config=ARS_RECIPE,
               s_per_iteration=seconds)
    bench_line("ars_laikago_env_steps_per_s", env_steps / s_per_it, "steps/s", card_line, config=ARS_RECIPE)
    graph_lines("ARS (b)", env, "ars_rollout")
    graph_lines("ARS (b)", env, "settle")
    log(f"ARS (b) seconds: {time.perf_counter() - b_start:.1f} s")

    # (c) where the time goes
    c_start = time.perf_counter()
    steps = 100
    wall_ms, eager_ms, prof = ars_profile(env, policy, trained, steps)
    chunk_runs = ars_chunks(env, policy, trained)
    batch = 2 * ARS_RECIPE["num_directions"]
    shape = fused_step.launch_shape(env.step_params, batch)
    _, f32_rate, _ = card
    bound_us = mega["flops_needed_per_env"] * batch / f32_rate * 1e6
    per_step = env.settle_steps + steps
    if prof is None:
        log("ARS (c): device operations and device time not measured (the profiler saw no device activity)")
        k2_us = None
    else:
        k2_us = prof["k2_us"]
        log(f"ARS (c): one recipe iteration at {steps} steps ({per_step} env steps with the reset's settle steps): "
            f"{wall_ms:.1f} ms wall through graphs without the profiler (eager: {eager_ms:.1f} ms, graph "
            f"{eager_ms / wall_ms:.2f}x); {prof['device_ops']} device operations = "
            f"{prof['device_ops'] / per_step:.1f} per step (torch.profiler), device busy {prof['device_ms']:.2f} ms of "
            f"{prof['profiled_ms']:.1f} ms wall under the profiler ({100 * (1 - prof['device_ms'] / prof['profiled_ms']):.1f}% "
            f"idle); K2 {prof['k2_launches']} kernels in the trace, one a step, at "
            f"{k2_us:.2f} us each on the device ({prof['k2_launches'] * k2_us / 1e3:.2f} ms), bound {bound_us:.4f} us "
            f"({mega['flops_needed_per_env']:.0f} flops per env x {batch})")
    log_launch_shape(f"ARS (c): K2 B={batch} float32", shape)
    log(f"ARS (c) seconds: {time.perf_counter() - c_start:.1f} s")

    # (d) the trainer as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "policy.pkl")
        t0 = time.perf_counter()
        ars_train.main(["--resume", str(CHECKPOINT), "--iterations", "2", "--eval_interval", "2", "--rollout_length", "400",
                        "--checkpoint", path])
        trainer_s = time.perf_counter() - t0
        written, meta = load_checkpoint(path)
        params = torch.as_tensor(written["params"])
        moved = (params.double() - torch.as_tensor(saved["params"]).double()).abs().max().item()
        finite = bool(torch.isfinite(params).all()) and stat_finite(written["obs_stat"], saved["obs_stat"])
        if not finite or moved == 0.0 or meta.get("iteration") != 2 or not os.path.exists(path + ".best"):
            raise AssertionError(f"the trainer's checkpoint: finite {finite}, moved {moved}, metadata {meta}")
    log(f"ARS (d): python -m tds_tpu_torch.tools.ars_train --resume policy_r2b.pkl --iterations 2 --eval_interval 2 "
        f"--rollout_length 400 in {trainer_s:.1f} s; its checkpoint reads back finite, params moved by up to {moved:.3e}")
    log(f"ARS (d) seconds: {trainer_s:.1f} s")
    return {
        "ars_wrapper_launches_per_iteration": launches,
        "ars_replayed_launches_100_step_iteration": None if prof is None else prof["k2_launches"],
        "ars_rollout_s_by_steps_per_graph": {str(c): t for c, t in chunk_runs.items()},
        "ars_device_us_per_launch": k2_us,
        "ars_bound_us_per_launch": bound_us,
        "ars_s_per_iteration": s_per_it,
        "ars_env_steps_per_s": env_steps / s_per_it,
        "ars_device_ops_per_step": None if prof is None else prof["device_ops"] / per_step,
        "ars_idle_share": None if prof is None else 1 - prof["device_ms"] / prof["profiled_ms"],
        "ars_100_step_iteration_ms": wall_ms,
        "ars_100_step_iteration_eager_ms": eager_ms,
        "ars_launch_shape_batch_256": launch_fields(shape),
        "ars_float64_card_against_cpu": worst,
        "ars_max_abs_err_batch_256": k2_err,
        "ars_eval_reward_min": [before["eval_reward_min"], after["eval_reward_min"]],
    }


# -- phase 10 --------------------------------------------------------------
def ant_kernel(card, ant, hopper):
    """(a): K1 on the ant's and the hopper's own operands (24 rows each)
    against its plain version, and timed; the ant without compaction (51
    rows) steps on the card through K1 without running the plain version,
    and K1 on its operands matches the plain version."""
    from tds_tpu_torch.contact import mlcp, pgs
    from tds_tpu_torch.envs.ant import AntEnv

    fields = {}
    # the ant stands on its feet 20 steps after its reset; the hopper
    # lands about 36 steps after its reset
    for label, env, warm_steps in (("ant", ant, 20), ("hopper", hopper, 50)):
        gen = torch.Generator(device="cuda").manual_seed(2)
        a, b, lo, hi, dep, it = harvest_pgs_operands(env, gen, warm_steps, label, "ant (a)")
        if tuple(b.shape) != (MAIN_BATCH, 24):
            raise AssertionError(f"the {label}'s MLCP has shape {tuple(b.shape)}, expected ({MAIN_BATCH}, 24)")
        x = pgs.solve_pgs(a, b, lo, hi, dep, it)
        ref = pgs.solve_pgs_reference(a, b, lo, hi, dep, it)
        torch.cuda.synchronize()
        rtol, atol = PGS_TOL[x.dtype]
        err = (x - ref).abs()
        over = (err - (atol + rtol * ref.abs())).max().item()
        log(f"ant (a): K1 on the {label} step B={MAIN_BATCH} n=24: max |kernel - plain| = {err.max().item():.3e} "
            f"(|plain| <= {ref.abs().max().item():.3g}; rtol {rtol}, atol {atol}, margin left {-over:.3e})")
        if not bool(torch.isfinite(x).all()) or over > 0:
            raise AssertionError(f"the PGS kernel disagrees with its plain version on the {label} step")
        ms = device_ms(lambda: pgs.solve_pgs(a, b, lo, hi, dep, it), rounds=5, per_round=20)
        plain_ms = device_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, it), rounds=10, per_round=2, backlog_ms=50)
        t_bytes, t_ops, n_bytes, n_ops = pgs_bound(b, it, card)
        log(f"ant (a): K1 at the {label}'s shape B={MAIN_BATCH} n=24 it={it} {b.dtype}: {ms * 1e3:.2f} us on the device "
            f"(median of 100 launches), plain {plain_ms * 1e3:.1f} us, bound {max(t_bytes, t_ops) * 1e3:.3f} us "
            f"({n_bytes} bytes, {n_ops} flops)")
        fields[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations", "max_abs_err": err.max().item()}
    log_launch_shape(f"ant (a): K1 B={MAIN_BATCH} n=24 float32", pgs.launch_shape(torch.float32, 24, MAIN_BATCH))

    # without compaction the ant's MLCP has 51 rows: K1's warp per env, and
    # the step must not reach the plain version on the card
    full = AntEnv(dtype=torch.float32, solver=mlcp.ContactSolverParams(top_k=0))
    q, qd = full.initial_state(torch.Generator(device="cuda").manual_seed(3), batch_size=8)
    q[:, 2] = 0.3
    plain, before = pgs.solve_pgs_reference, pgs.launches

    def refuse(*args):
        raise AssertionError("the plain PGS ran on the card")

    pgs.solve_pgs_reference = refuse
    try:
        with recorded_pgs_calls() as calls:
            q_next, _ = full.sim_step(q, qd, torch.zeros(8, full.action_dim, device="cuda"))
    finally:
        pgs.solve_pgs_reference = plain
    a, b, lo, hi, dep, it = calls[0]
    x = pgs.solve_pgs(a, b, lo, hi, dep, it)
    ref = pgs.solve_pgs_reference(a, b, lo, hi, dep, it)
    torch.cuda.synchronize()
    rtol, atol = PGS_TOL[x.dtype]
    err = (x - ref).abs()
    if (pgs.launches - before != 2 or tuple(b.shape) != (8, 51) or not bool(torch.isfinite(q_next).all())
            or (err - (atol + rtol * ref.abs())).max().item() > 0):
        raise AssertionError(f"the ant with top_k=0 on the card: {pgs.launches - before} K1 launches, MLCP "
                             f"{tuple(b.shape)}, max |kernel - plain| {err.max().item():.3e}")
    log(f"ant (a): the ant with top_k=0 (51 rows) steps on the card through K1 (no plain version there): "
        f"{int((b != 0).sum())} of {b.numel()} rows active, max |kernel - plain| = {err.max().item():.3e}")
    return fields


def penetrating(env, q):
    """(B,) count of the env's plane candidates with distance < 0."""
    from tds_tpu_torch import world
    from tds_tpu_torch.dynamics.kinematics import fk_links

    zero = q.new_zeros(q.shape[0], 0)
    kins = [fk_links(env.world.bodies[0], zero, zero), fk_links(env.model, q, q.new_zeros(q.shape[0], env.model.dof_qd))]
    return (world.gather_pair_contacts(env.world, kins, 0, 1, q).contact.distance < 0).sum(-1)


def ant_device_vs_cpu():
    """(c): 50 float64 ant steps at batch 16, K1 on the card against the
    plain PGS on the CPU, within 1e-9 abs + rel. Half the envs start with
    the torso on the ground, where all 17 candidates penetrate and the
    compaction drops 9; the other half stand on their feet. The joint
    noise keeps exact ties of distance out (across devices a tie could
    flip on the last bit). Returns the largest difference."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.ant import AntEnv

    batch, steps, tol = 16, 50, 1e-9
    cpu_env = AntEnv(dtype=torch.float64, device="cpu")
    gpu_env = AntEnv(dtype=torch.float64)
    gen = torch.Generator(device="cpu").manual_seed(10)
    noise = cpu_env.draw_reset_noise(gen, batch)
    actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qc, qdc = cpu_env.initial_state(noise=noise)
    qc[: batch // 2, 2] = 0.05
    qc[batch // 2 :, 2] = 0.35
    qg, qdg = qc.cuda(), qdc.cuda()
    before = pgs.launches
    worst, worst_excess = 0.0, -float("inf")
    counts = []
    for t in range(steps):
        counts.append(penetrating(cpu_env, qc))
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
        qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].cuda())
        for got, expected in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            worst = max(worst, (got - expected).abs().max().item())
            worst_excess = max(worst_excess, excess(got, expected, tol))
            if worst_excess > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"the ant on the card and on the CPU differ beyond {tol} at step {t + 1}")
    if pgs.launches - before != steps:
        raise AssertionError(f"{steps} ant steps on the card launched K1 {pgs.launches - before} times")
    counts = torch.stack(counts)
    dropping = int((counts > 8).sum())
    if dropping == 0 or not bool((counts > 0).any(-1).all()):
        raise AssertionError(f"the ant's card-against-CPU run needs steps where the compaction drops candidates "
                             f"({dropping} env-steps) and a contact in every step")
    log(f"ant (c): {steps} float64 steps at batch {batch}, card against CPU: max |cuda - cpu| = {worst:.3e} (tolerance "
        f"{tol} abs + rel, margin left {-worst_excess:.3e}); {dropping} env-steps with more than 8 of 17 candidates "
        f"penetrating (the compaction dropped some), {int((counts > 0).sum())} of {batch * steps} env-steps in contact, "
        f"{steps} K1 launches")
    return worst


def ant_replay():
    """(d): logs/ant_ars/policy.pkl in float32 on the card through
    ``rollout`` (graphs), held to tests/test_ant_policy.py's thresholds in a
    form that implies them: alive at the last of the 1000 steps (so for all
    of them, >= 900) and more than 9.0 m forward there. Returns K1's
    wrapper launches (the warm-ups and the captures)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.rollout import rollout
    from tds_tpu_torch.utils import graphs

    saved, _ = load_checkpoint(str(ANT_CHECKPOINT))
    env = AntEnv(dtype=torch.float32)
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=env.dtype)
    noise = env.draw_reset_noise(torch.Generator(device="cpu").manual_seed(REPLAY_SEED), ANT_REPLAY_BATCH)
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    t0 = time.perf_counter()
    state, obs = env.reset(noise=noise)
    x0 = state.q[:, 0].clone()
    state, obs, _, alive = rollout(env, policy, stat, state, obs, ANT_REPLAY_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pgs.launches
    check_wrapper_launches("ant (d)", "PGS", launches, cached)
    alive, forward = alive.cpu(), (state.q[:, 0] - x0).cpu()
    failed = []
    for i in range(ANT_REPLAY_BATCH):
        ok = bool(torch.isfinite(state.q[i]).all()) and alive[i] == 1.0 and forward[i] > 9.0
        log(f"ant (d): env {i}: alive at step {ANT_REPLAY_STEPS} {alive[i]:.0f}, {forward[i]:.3f} m forward {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(i)
    if failed:
        raise AssertionError(f"the trained ant policy failed the thresholds in envs {failed}")
    log(f"ant (d): {ANT_CHECKPOINT.name} replayed through graphs for {ANT_REPLAY_STEPS} steps at batch {ANT_REPLAY_BATCH} "
        f"in {seconds:.1f} s (capture included); every env walks; K1 wrapper launches {launches} (warm-ups and captures)")
    graph_lines("ant (d)", env, "rollout")
    return launches


def ant_trainer():
    """(e): the trainer on the ant as a user runs it, resumed from
    logs/ant_ars/policy.pkl; returns the last eval's eval_reward_min."""
    import tempfile

    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint
    from tds_tpu_torch.tools import ars_train
    from tds_tpu_torch.utils import graphs

    iterations, rollout_length = 2, 200
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ant.pkl")
        cached = graphs.stats()
        pgs.launches = 0
        t0 = time.perf_counter()
        _, history = ars_train.main(
            ["--env", "ant", "--resume", str(ANT_CHECKPOINT), "--iterations", str(iterations), "--eval_interval", "2",
             "--rollout_length", str(rollout_length), "--num_directions", "8", "--checkpoint", path]
        )
        seconds = time.perf_counter() - t0
        launches = pgs.launches
        written, meta = load_checkpoint(path)
    finite = all(bool(torch.isfinite(v)) for metrics in history for v in metrics.values())
    finite = finite and bool(torch.isfinite(torch.as_tensor(written["params"])).all())
    if not finite or "eval_reward_min" not in history[-1] or meta.get("iteration") != iterations:
        raise AssertionError(f"the ant trainer: finite {finite}, last metrics {history[-1]}, metadata {meta}")
    check_wrapper_launches("ant (e)", "PGS", launches, cached)
    reward_min = history[-1]["eval_reward_min"].item()
    log(f"ant (e): python -m tds_tpu_torch.tools.ars_train --env ant --resume {ANT_CHECKPOINT.name} --iterations "
        f"{iterations} --eval_interval 2 --rollout_length {rollout_length} --num_directions 8 in {seconds:.1f} s: metrics "
        f"finite, eval_reward_min {reward_min:.2f}, K1 wrapper launches {launches} (warm-ups and captures)")
    return reward_min


def phase_ant(card, card_line):
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.envs.hopper import HopperEnv

    ant, hopper = AntEnv(dtype=torch.float32), HopperEnv(dtype=torch.float32)
    with sub_phase("ant (a) seconds"):
        kernel = ant_kernel(card, ant, hopper)
    # new envs, so that the main paths capture graphs of their own
    with sub_phase("ant (b) seconds"):
        ant_path = drive_main_path(AntEnv(dtype=torch.float32), "ant (b)", ROLLOUT_STEPS, 2, (0.26, 0.48), card_line,
                                   ("ant_scan_rollout_env_steps_per_s", ANT_BENCH_STEPS))
        hop = drive_main_path(HopperEnv(dtype=torch.float32), "hopper (b)", HOPPER_STEPS, 1, (-0.35, 0.1), card_line)
    launches, step_ms = ant_path["launches"], ant_path["ms_per_step"]
    with sub_phase("ant (c) seconds"):
        worst = ant_device_vs_cpu()
    with sub_phase("ant (d) seconds"):
        replay_launches = ant_replay()
    with sub_phase("ant (e) seconds"):
        reward_min = ant_trainer()
    return {
        "ant_shape": f"B={MAIN_BATCH} n=24 iterations=1 float32",
        "ant_ms": kernel["ant"]["ms"],
        "ant_plain_ms": kernel["ant"]["plain_ms"],
        "ant_bound_ms": kernel["ant"]["bound_ms"],
        "ant_bound_by": kernel["ant"]["bound_by"],
        "ant_max_abs_err": kernel["ant"]["max_abs_err"],
        "ant_launches": launches,
        "ant_replayed_launches_per_step": ant_path["replayed_launches_per_step"],
        "ant_ms_per_step": step_ms,
        "ant_env_steps_per_s": MAIN_BATCH / step_ms * 1e3,
        "ant_eager_ms_per_step": ant_path["eager_ms_per_step"],
        "ant_scan_rollout_env_steps_per_s": ant_path["ant_scan_rollout_env_steps_per_s"],
        "ant_graph_nodes": ant_path["graph_nodes"],
        "ant_device_ops_per_step": ant_path["device_ops"],
        "ant_idle_share": ant_path["idle"],
        "ant_eager_device_ops_per_step": ant_path.get("eager_device_ops"),
        "ant_eager_idle_share": ant_path.get("eager_idle"),
        "ant_float64_card_against_cpu": worst,
        "ant_replay_launches": replay_launches,
        "ant_trainer_eval_reward_min": reward_min,
        "hopper_ms": kernel["hopper"]["ms"],
        "hopper_plain_ms": kernel["hopper"]["plain_ms"],
        "hopper_max_abs_err": kernel["hopper"]["max_abs_err"],
        "hopper_launches": hop["launches"],
        "hopper_ms_per_step": hop["ms_per_step"],
        "hopper_eager_ms_per_step": hop["eager_ms_per_step"],
        "hopper_device_ops_per_step": hop["device_ops"],
        "hopper_idle_share": hop["idle"],
    }


# -- phase 12 --------------------------------------------------------------
def pgs_tol(dtype, n):
    """(rtol, atol) of K1 against its plain version: PGS_TOL, and 1e-12
    relative in float64 for the warp per env (n > 32), whose row sums run in
    another order than the plain sweep's."""
    if dtype == torch.float64 and n > 32:
        return 1e-12, 1e-12
    return PGS_TOL[dtype]


def span_ms(fn, reps):
    """Median of CUDA-event spans around single calls of ``fn``, each after
    a synchronise: device time with the host's pace in it, for a plain
    version whose call enqueues more operations than ``device_ms``'s rounds
    may hold (about a thousand)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def k1_against_plain(label, operands, dep, it):
    """K1 against its plain version on the same operands; returns the
    largest difference, raising past pgs_tol."""
    from tds_tpu_torch.contact import pgs

    x = pgs.solve_pgs(*operands, dep, it)
    ref = pgs.solve_pgs_reference(*operands, dep, it)
    torch.cuda.synchronize()
    rtol, atol = pgs_tol(x.dtype, x.shape[-1])
    err = (x - ref).abs()
    over = (err - (atol + rtol * ref.abs())).max().item()
    if not bool(torch.isfinite(x).all()) or over > 0:
        raise AssertionError(f"K1 disagrees with its plain version on {label}: max |kernel - plain| {err.max().item():.3e}")
    return err.max().item(), -over


def k1_timing(label, operands, dep, it, card, prefix="humanoid (a)"):
    """K1's device time (median of 100 CUDA-event-timed launches), the
    plain version's, the bound and the launch shape on ``operands``, logged
    under ``prefix``."""
    from tds_tpu_torch.contact import pgs

    b = operands[1]
    bsz, n = b.shape
    ms = device_ms(lambda: pgs.solve_pgs(*operands, dep, it), rounds=5, per_round=20)
    plain_ops = 12 * n * it  # operations the plain sweep enqueues, about
    if plain_ops <= 400:
        plain_ms = device_ms(lambda: pgs.solve_pgs_reference(*operands, dep, it), rounds=10, per_round=2, backlog_ms=50)
        plain_how = "device time"
    else:
        plain_ms = span_ms(lambda: pgs.solve_pgs_reference(*operands, dep, it), reps=5)
        plain_how = "event span, host-paced"
    sweepless_ms = device_ms(lambda: pgs.solve_pgs(*operands, dep, 0), rounds=5, per_round=20)
    t_bytes, t_ops, n_bytes, n_ops = pgs_bound(b, it, card)
    shape = pgs.launch_shape(b.dtype, n, bsz)
    log(f"{prefix}: K1 {label} B={bsz} n={n} it={it} {str(b.dtype)[6:]} ({shape['form']}): {ms * 1e3:.2f} us on the device, "
        f"{sweepless_ms * 1e3:.2f} us with 0 sweeps, plain {plain_ms * 1e3:.1f} us ({plain_how}), bound "
        f"{max(t_bytes, t_ops) * 1e3:.3f} us ({n_bytes} bytes, {n_ops} flops), {ms / max(t_bytes, t_ops):.1f}x the bound")
    log_launch_shape(f"{prefix}: K1 B={bsz} n={n} {str(b.dtype)[6:]}", shape)
    return {"ms": ms, "ms_0_sweeps": sweepless_ms, "plain_ms": plain_ms, "plain_timing": plain_how, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "shape": f"B={bsz} n={n} iterations={it} {str(b.dtype)[6:]}",
            "design": shape["form"], **launch_fields(shape)}


def humanoid_kernel(card):
    """(a): K1 against its plain version at every n of K1_ROWS and B of
    K1_BATCHES (and B = 1024 at n = 105), float32 and float64, two sweeps
    of random problems; then on the float32 operands of a humanoid step at
    B = 1024 (105 rows) and a half-cheetah step at B = 4096 (48 rows) with
    contacts active; each n timed on its path's operands where it has a
    path in this phase, else on a random float32 problem at B = 4096 with
    one sweep. Returns {n: the kernel entry's numbers}."""
    from tds_tpu_torch.envs.hopper import HalfCheetahEnv
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {}
    cases = [(n, bsz) for n in K1_ROWS for bsz in K1_BATCHES] + [(105, HUMANOID_BATCH)]
    for n, bsz in cases:
        for dtype in (torch.float32, torch.float64):
            operands, dep = random_rows_problem(bsz, n, dtype, gen)
            err, margin = k1_against_plain(f"random B={bsz} n={n} {dtype}", operands, dep, 2)
            worst[n] = max(worst.get(n, 0.0), err)
            log(f"humanoid (a): K1 random B={bsz} n={n} it=2 {str(dtype)[6:]}: max |kernel - plain| = {err:.3e} "
                f"(rtol, atol {pgs_tol(dtype, n)}; margin left {margin:.3e})")
    # the humanoid's feet rest 7.45 cm above the ground at its start: start
    # it 9 cm lower, so that the settle steps end in contact
    humanoid = HumanoidEnv(dtype=torch.float32, start_base_position=(0.0, 0.0, 1.31))
    real = {
        105: ("humanoid step", harvest_pgs_operands(humanoid, gen, 0, "humanoid", "humanoid (a)", batch=HUMANOID_BATCH)),
        # the half-cheetah lands about 60 steps after its reset
        48: ("half-cheetah step", harvest_pgs_operands(HalfCheetahEnv(dtype=torch.float32), gen, 70, "half-cheetah",
                                                        "humanoid (a)", batch=CHEETAH_BATCH)),
    }
    entries = {}
    for n in K1_ROWS:
        if n in real:
            label, (a, b, lo, hi, dep, it) = real[n]
            operands = [a, b, lo, hi]
            if tuple(b.shape) != ((HUMANOID_BATCH if n == 105 else CHEETAH_BATCH), n):
                raise AssertionError(f"the {label}'s MLCP has shape {tuple(b.shape)}")
            err, margin = k1_against_plain(label, operands, dep, it)
            worst[n] = max(worst[n], err)
            log(f"humanoid (a): K1 on the {label} B={b.shape[0]} n={n}: max |kernel - plain| = {err:.3e} (margin left {margin:.3e})")
        else:
            label = "random"
            operands, dep = random_rows_problem(MAIN_BATCH, n, torch.float32, gen)
            it = 1
        entries[n] = {**k1_timing(label, operands, dep, it, card), "max_abs_err": worst[n]}
    return entries


def humanoid_device_vs_cpu():
    """(c): 50 float64 humanoid steps at batch 8, K1 (n = 105) on the card
    against the plain PGS on the CPU, within 1e-9 abs + rel, from states 8 to
    10 cm below the standing start (the feet in the ground) with seeded
    actions. Returns the largest difference."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    batch, steps, tol = 8, 50, 1e-9
    cpu_env = HumanoidEnv(dtype=torch.float64, device="cpu")
    gpu_env = HumanoidEnv(dtype=torch.float64)
    gen = torch.Generator(device="cpu").manual_seed(14)
    qc, qdc = cpu_env.initial_state(noise=cpu_env.draw_reset_noise(gen, batch))
    qc[:, 2] = 1.3 + 0.02 * torch.rand(batch, generator=gen, dtype=torch.float64)
    actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qg, qdg = qc.cuda(), qdc.cuda()
    before = pgs.launches
    worst, worst_excess, in_contact = 0.0, -float("inf"), []
    for t in range(steps):
        in_contact.append(penetrating(cpu_env, qc))
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
        qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].cuda())
        for got, expected in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            worst = max(worst, (got - expected).abs().max().item())
            worst_excess = max(worst_excess, excess(got, expected, tol))
            if worst_excess > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"the humanoid on the card and on the CPU differ beyond {tol} at step {t + 1}")
    if pgs.launches - before != steps:
        raise AssertionError(f"{steps} humanoid steps on the card launched K1 {pgs.launches - before} times")
    counts = torch.stack(in_contact)
    if not bool((counts[:10] > 0).all()):
        raise AssertionError("the humanoid's card-against-CPU run needs contacts in every env over its first 10 steps")
    log(f"humanoid (c): {steps} float64 steps at batch {batch}, card against CPU: max |cuda - cpu| = {worst:.3e} "
        f"(tolerance {tol} abs + rel, margin left {-worst_excess:.3e}); {int((counts > 0).sum())} of {batch * steps} "
        f"env-steps in contact, up to {int(counts.max())} of 35 candidates penetrating; {steps} K1 launches")
    return worst


def humanoid_replay():
    """(d): logs/humanoid_ars/policy_curr2.pkl in float32 on the card for
    HUMANOID_REPLAY_STEPS steps through graphs (``utils.graphs.scan``), 8
    envs: 4 from the starts of tests/test_humanoid_policy.py (the JAX
    package's reset draws for its seeds 0, 7, 123 and 42, read from
    tests/golden/humanoid_policy_reset_noise.json), each held to its
    thresholds (:84-90): x at its last live step > 0.65 m, at least 1100
    steps alive, total reward > 600; and 4 from ``torch.Generator`` seeds of
    the same numbers, whose outcome is printed as a measurement of the
    policy from other starts. Returns K1's wrapper launches (the warm-ups
    and the captures)."""
    import torch.nn.functional as F

    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.envs.humanoid import HumanoidEnv
    from tds_tpu_torch.utils import graphs

    saved, _ = load_checkpoint(str(HUMANOID_CHECKPOINT))
    env = HumanoidEnv(dtype=torch.float32)
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=env.dtype)
    recorded = json.loads(HUMANOID_RESET_NOISE.read_text())
    if tuple(recorded["seeds"]) != HUMANOID_SEEDS:
        raise AssertionError(f"{HUMANOID_RESET_NOISE.name} holds seeds {recorded['seeds']}")
    jax_starts = torch.tensor(recorded["noise"], dtype=env.dtype)
    generator_starts = torch.cat([env.draw_reset_noise(torch.Generator(device="cuda").manual_seed(s), 1) for s in HUMANOID_SEEDS])
    noise = torch.cat([jax_starts.to(env.device), generator_starts])

    def body(carry, consts):
        q, qd, t, obs, total, alive, steps, x = carry
        weight, bias, mean, scale = consts
        action = env.action_transform(F.linear((obs - mean) / scale, weight, bias))
        state, obs, reward, done = env.step(EnvState(q, qd, t), action)
        x = torch.where(alive > 0, state.q[:, 0], x)
        return (state.q, state.qd, state.t, obs, total + reward * alive, alive * (1.0 - done.to(obs.dtype)),
                steps + alive, x)

    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    t0 = time.perf_counter()
    state, obs = env.reset(noise=noise)
    zero = obs.new_zeros(noise.shape[0])
    with torch.no_grad():
        carry = (state.q, state.qd, state.t, obs, zero, zero + 1.0, zero, zero)
        consts = (policy.weight, policy.bias, stat.mean, stat.scale())
        _, _, _, _, total, alive, steps, x = graphs.scan(body, carry, consts, HUMANOID_REPLAY_STEPS, key=("humanoid replay", env))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = pgs.launches
    check_wrapper_launches("humanoid (d)", "PGS", launches, cached)
    total, steps, x = total.cpu(), steps.cpu(), x.cpu()
    failed = []
    for i, seed in enumerate(HUMANOID_SEEDS * 2):
        gated = i < len(HUMANOID_SEEDS)
        ok = bool(torch.isfinite(total[i])) and x[i] > 0.65 and steps[i] >= 1100 and total[i] > 600.0
        start = "the JAX test's start" if gated else "torch.Generator start"
        log(f"humanoid (d): seed {seed}, {start}: x {x[i]:.3f} m, alive {steps[i]:.0f} steps, total reward "
            f"{total[i]:.1f}: {'past' if ok else 'short of'} the thresholds{'' if gated else ' (a measurement)'}")
        if gated and not ok:
            failed.append(seed)
    if failed or not bool(torch.isfinite(total).all()):
        raise AssertionError(f"the trained humanoid policy failed tests/test_humanoid_policy.py's thresholds for seeds {failed}")
    log(f"humanoid (d): {HUMANOID_CHECKPOINT.name} replayed through graphs for {HUMANOID_REPLAY_STEPS} steps at batch "
        f"{noise.shape[0]} in {seconds:.1f} s (the reset and the captures included); the JAX test's 4 starts walk past all "
        f"three thresholds; K1 wrapper launches {launches} (warm-ups and captures)")
    graph_lines("humanoid (d)", env, "humanoid replay")
    return launches


def humanoid_trainer():
    """(e): the trainer on the humanoid as a user runs it, resumed from
    policy_curr2.pkl; returns the last eval's eval_reward_min."""
    import tempfile

    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint
    from tds_tpu_torch.tools import ars_train
    from tds_tpu_torch.utils import graphs

    iterations, rollout_length = 2, 200
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "humanoid.pkl")
        cached = graphs.stats()
        pgs.launches = 0
        t0 = time.perf_counter()
        _, history = ars_train.main(
            ["--env", "humanoid", "--resume", str(HUMANOID_CHECKPOINT), "--iterations", str(iterations), "--eval_interval",
             "2", "--rollout_length", str(rollout_length), "--num_directions", "8", "--checkpoint", path]
        )
        seconds = time.perf_counter() - t0
        launches = pgs.launches
        written, meta = load_checkpoint(path)
    finite = all(bool(torch.isfinite(v)) for metrics in history for v in metrics.values())
    finite = finite and bool(torch.isfinite(torch.as_tensor(written["params"])).all())
    if not finite or "eval_reward_min" not in history[-1] or meta.get("iteration") != iterations:
        raise AssertionError(f"the humanoid trainer: finite {finite}, last metrics {history[-1]}, metadata {meta}")
    check_wrapper_launches("humanoid (e)", "PGS", launches, cached)
    reward_min = history[-1]["eval_reward_min"].item()
    log(f"humanoid (e): python -m tds_tpu_torch.tools.ars_train --env humanoid --resume {HUMANOID_CHECKPOINT.name} "
        f"--iterations {iterations} --eval_interval 2 --rollout_length {rollout_length} --num_directions 8 in {seconds:.1f} s: "
        f"metrics finite, checkpoint read back, eval_reward_min {reward_min:.2f}, K1 wrapper launches {launches}")
    return reward_min


def humanoid_top_k(card_line):
    """(b), a measurement only: humanoid_scan_rollout_env_steps_per_s with
    the solver keeping the 8 deepest candidates (24 rows), the JAX package's
    other choice (tds_tpu/envs/humanoid.py:79-88); the default stays
    top_k = 0."""
    from tds_tpu_torch.contact.mlcp import ContactSolverParams
    from tds_tpu_torch.envs.humanoid import HumanoidEnv
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    env = HumanoidEnv(dtype=torch.float32, solver=ContactSolverParams(top_k=8))
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    state, obs = env.reset(torch.Generator(device="cuda").manual_seed(1), batch_size=HUMANOID_BATCH)
    (_, _, _, alive), first_s = timed_call(lambda: rollout(env, policy, None, state, obs, TOP_K_STEPS))
    best = min(timed_call(lambda: rollout(env, policy, None, state, obs, TOP_K_STEPS))[1] for _ in range(TOP_K_REPEATS))
    rate = HUMANOID_BATCH * TOP_K_STEPS / best
    bench_line("humanoid_scan_rollout_env_steps_per_s", rate, "steps/s", card_line, batch=HUMANOID_BATCH,
               steps=TOP_K_STEPS, best_s=best, top_k=8, rows=24, alive=int(alive.sum()))
    return rate


def phase_humanoid(card, card_line):
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.hopper import HalfCheetahEnv
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    with sub_phase("humanoid (a) seconds"):
        entries = humanoid_kernel(card)
    with sub_phase("humanoid (b) seconds, top_k = 0"):
        path = drive_main_path(HumanoidEnv(dtype=torch.float32), "humanoid (b)", HUMANOID_STEPS, 2, (0.8, 1.45), card_line,
                               ("humanoid_scan_rollout_env_steps_per_s", HUMANOID_STEPS), batch=HUMANOID_BATCH)
    with sub_phase("humanoid (b) seconds, top_k = 8"):
        top_k_rate = humanoid_top_k(card_line)
    log(f"humanoid (b): humanoid_scan_rollout_env_steps_per_s {path['humanoid_scan_rollout_env_steps_per_s']:.1f} at "
        f"top_k=0 (105 rows, the default) against {top_k_rate:.1f} at top_k=8 (24 rows)")
    with sub_phase("humanoid (c) seconds"):
        worst = humanoid_device_vs_cpu()
    with sub_phase("humanoid (d) seconds"):
        replay_launches = humanoid_replay()
    with sub_phase("humanoid (e) seconds"):
        reward_min = humanoid_trainer()
    with sub_phase("halfcheetah (f) seconds"):
        cheetah = drive_main_path(HalfCheetahEnv(dtype=torch.float32), "halfcheetah (f)", CHEETAH_STEPS, 1, (-0.3, 0.1),
                                  card_line, batch=CHEETAH_BATCH)
    entries[105].update(launches=path["launches"], replayed_launches_per_step=path["replayed_launches_per_step"],
                        main_path="humanoid (b)")
    entries[48].update(launches=cheetah["launches"], replayed_launches_per_step=cheetah["replayed_launches_per_step"],
                       main_path="halfcheetah (f)")
    summary = {
        "humanoid_ms_per_step": path["ms_per_step"],
        "humanoid_eager_ms_per_step": path["eager_ms_per_step"],
        "humanoid_scan_rollout_env_steps_per_s": path["humanoid_scan_rollout_env_steps_per_s"],
        "humanoid_top_k8_env_steps_per_s": top_k_rate,
        "humanoid_graph_nodes": path["graph_nodes"],
        "humanoid_device_ops_per_step": path["device_ops"],
        "humanoid_idle_share": path["idle"],
        "humanoid_first_call_s": path["first_call_s"],
        "humanoid_float64_card_against_cpu": worst,
        "humanoid_replay_launches": replay_launches,
        "humanoid_trainer_eval_reward_min": reward_min,
        "halfcheetah_ms_per_step": cheetah["ms_per_step"],
        "halfcheetah_idle_share": cheetah["idle"],
        "halfcheetah_graph_nodes": cheetah["graph_nodes"],
    }
    log(f"humanoid: {json.dumps(summary)}")
    return entries, summary


# -- phase 13 --------------------------------------------------------------
def terrain_env(bump, scan_points, kind="heightfield", obj_dir=None, dtype=torch.float32, device=None):
    """``tools.ars_train.make_terrain_env``'s laikago; with ``kind="mesh"``
    the same grid as a ``Mesh`` read from an OBJ file written in
    ``obj_dir``."""
    import math

    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.model.geometry import Mesh
    from tds_tpu_torch.tools.ars_train import SCAN_GRID, make_terrain_env
    from tds_tpu_torch.utils.terrain import write_heightfield

    if kind == "heightfield":
        return make_terrain_env(bump, scan_points, dtype=dtype, device=device)
    path = write_heightfield(os.path.join(obj_dir, f"terrain_{bump}.obj"), 13, 7, (-1.0, 5.0), (-1.5, 1.5),
                             lambda x, y: bump * math.sin(math.pi * x) * math.cos(math.pi * y))
    scan = SCAN_GRID[:scan_points] if scan_points else None
    return LaikagoEnv(dtype=dtype, device=device, terrain=Mesh(file_name=path, max_contacts=3), height_scan=scan)


def terrain_kernel(card):
    """(a): K1 on the float32 PGS operands of a terrain step at batch 4096
    with toes in contact (24 rows: 12 candidates, the 8 deepest kept),
    against its plain version, and timed: median of 100 launches, the
    plain version's time, the bound and the launch shape."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    # the toes reach the ground about 65 steps after the reset
    a, b, lo, hi, dep, it = harvest_pgs_operands(terrain_env(TERRAIN_BUMP, 9), gen, ROLLOUT_STEPS, "terrain", "terrain (a)")
    if tuple(b.shape) != (MAIN_BATCH, 24):
        raise AssertionError(f"the terrain's MLCP has shape {tuple(b.shape)}, expected ({MAIN_BATCH}, 24)")
    err, margin = k1_against_plain("terrain step", [a, b, lo, hi], dep, it)
    log(f"terrain (a): K1 on the terrain step B={MAIN_BATCH} n=24: max |kernel - plain| = {err:.3e} (rtol, atol "
        f"{pgs_tol(b.dtype, 24)}; margin left {margin:.3e})")
    return {**k1_timing("terrain step", [a, b, lo, hi], dep, it, card, prefix="terrain (a)"), "max_abs_err": err}


def mesh_rollout(obj_dir):
    """(b), a measurement: a MESH_STEPS-step rollout of the zero policy at
    batch 4096 on the mesh form of the terrain through graphs; returns its
    ms/step."""
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    env = terrain_env(TERRAIN_BUMP, 9, "mesh", obj_dir)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    state, obs = env.reset(torch.Generator(device="cuda").manual_seed(1), batch_size=MAIN_BATCH)
    (_, _, _, alive), first_s = timed_call(lambda: rollout(env, policy, None, state, obs, MESH_STEPS))
    _, seconds = timed_call(lambda: rollout(env, policy, None, state, obs, MESH_STEPS))
    step_ms = seconds * 1e3 / MESH_STEPS
    log(f"terrain (b): the mesh form (144 triangles against each toe), {MESH_STEPS} steps at batch {MAIN_BATCH} through "
        f"graphs: first call {first_s:.3f} s (with the captures), then {step_ms:.3f} ms/step = "
        f"{MAIN_BATCH / step_ms * 1e3:.1f} env-steps/s (a measurement); {int(alive.sum())} of {MAIN_BATCH} alive")
    return step_ms


def terrain_device_vs_cpu(obj_dir):
    """(c): 50 float64 steps at batch 8 on the heightfield and on the mesh,
    K1 on the card against the plain PGS on the CPU, within 1e-9 abs + rel
    (q, qd and the observation with its 9 scan columns), from a base 5 cm
    below the standing start (the toes in the ground). Returns the largest
    difference."""
    from tds_tpu_torch.contact import pgs

    batch, steps, tol = 8, 50, 1e-9
    worst = 0.0
    for kind in ("heightfield", "mesh"):
        cpu_env = terrain_env(TERRAIN_BUMP, 9, kind, obj_dir, torch.float64, "cpu")
        gpu_env = terrain_env(TERRAIN_BUMP, 9, kind, obj_dir, torch.float64)
        gen = torch.Generator(device="cpu").manual_seed(13)
        qc, qdc = cpu_env.initial_state(noise=cpu_env.draw_reset_noise(gen, batch))
        qc[:, 2] = 0.43
        actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
        qg, qdg = qc.cuda(), qdc.cuda()
        before, kind_worst, worst_excess, in_contact = pgs.launches, 0.0, -float("inf"), []
        for t in range(steps):
            in_contact.append(penetrating(cpu_env, qc))
            qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
            qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].cuda())
            pairs = ((qg.cpu(), qc), (qdg.cpu(), qdc), (gpu_env.observation(qg, qdg).cpu(), cpu_env.observation(qc, qdc)))
            for got, expected in pairs:
                kind_worst = max(kind_worst, (got - expected).abs().max().item())
                worst_excess = max(worst_excess, excess(got, expected, tol))
                if worst_excess > 0 or not torch.isfinite(got).all():
                    raise AssertionError(f"the terrain ({kind}) on the card and on the CPU differ beyond {tol} at step {t + 1}")
        if pgs.launches - before != steps:
            raise AssertionError(f"{steps} terrain ({kind}) steps on the card launched K1 {pgs.launches - before} times")
        counts = torch.stack(in_contact)
        if not bool((counts[:10] > 0).all()):
            raise AssertionError(f"the terrain ({kind}) card-against-CPU run needs contacts in every env over its first 10 steps")
        log(f"terrain (c): {kind}, {steps} float64 steps at batch {batch}, card against CPU: max |cuda - cpu| = "
            f"{kind_worst:.3e} over q, qd and the observation (tolerance {tol} abs + rel, margin left {-worst_excess:.3e}); "
            f"{int((counts > 0).sum())} of {batch * steps} env-steps in contact, up to {int(counts.max())} of 12 candidates "
            f"penetrating; {steps} K1 launches")
        worst = max(worst, kind_worst)
    return worst


def terrain_policy_run(env, path, noise, steps, key):
    """``path``'s policy replayed in float32 on ``env`` for ``steps`` steps
    through graphs from the reset noise ``noise``; returns (distance: x at
    the last live step less x after the reset, steps alive, the last q),
    each per env, on the CPU, as tests/test_terrain_policy.py:68-83 counts
    them."""
    import torch.nn.functional as F

    from tds_tpu_torch.convert import load_checkpoint, policy_from_numpy
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.utils import graphs

    saved, _ = load_checkpoint(str(path))
    policy, stat = policy_from_numpy(saved["params"], saved["obs_stat"], dtype=env.dtype, device=env.device)

    def body(carry, consts):
        q, qd, t, obs, alive, steps, x = carry
        weight, bias, mean, scale = consts
        action = env.action_transform(F.linear((obs - mean) / scale, weight, bias))
        state, obs, _, done = env.step(EnvState(q, qd, t), action)
        x = torch.where(alive > 0, state.q[:, 0], x)
        return state.q, state.qd, state.t, obs, alive * (1.0 - done.to(obs.dtype)), steps + alive, x

    state, obs = env.reset(noise=noise)
    x0 = state.q[:, 0].clone()
    zero = obs.new_zeros(noise.shape[0])
    with torch.no_grad():
        carry = (state.q, state.qd, state.t, obs, zero + 1.0, zero, x0)
        q, _, _, _, alive, alive_steps, x = graphs.scan(body, carry, (policy.weight, policy.bias, stat.mean, stat.scale()),
                                                         steps, key=key)
    return (x - x0).cpu(), alive_steps.cpu(), q.cpu()


def terrain_replay(obj_dir):
    """(d): policy_b4c.pkl and policy_r2b.pkl in float32 through graphs for
    3000 steps on the +-4 cm heightfield from the 4 starts of
    tests/test_terrain_policy.py (the JAX package's reset draws for
    split(PRNGKey(0), 4)), held to its thresholds (:92-100): policy_b4c's
    least distance above 4.4 m and its mean more than 0.4 m past
    policy_r2b's; then policy_r2b.pkl on the +-2 cm mesh for 1500 steps
    from tests/test_terrain.py's start (PRNGKey(0)), held to :89-96: alive,
    x > 1.0 m, 0.3 < z < 0.6. Beside each, the same from 4 torch.Generator
    starts (seeds TERRAIN_SEEDS), printed as a measurement. Returns the
    numbers and K1's wrapper launches (the warm-ups and the captures)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.utils import graphs

    recorded = json.loads(TERRAIN_RESET_NOISE.read_text())
    env = terrain_env(TERRAIN_REPLAY_BUMP, 0)
    generator_noise = torch.cat([env.draw_reset_noise(torch.Generator(device="cuda").manual_seed(s), 1) for s in TERRAIN_SEEDS])
    noise = torch.cat([torch.tensor(recorded["policy"], dtype=env.dtype, device=env.device), generator_noise])
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    t0 = time.perf_counter()
    runs = {}
    for name, path in (("policy_b4c.pkl", TERRAIN_CHECKPOINT), ("policy_r2b.pkl", CHECKPOINT)):
        runs[name] = terrain_policy_run(env, path, noise, TERRAIN_REPLAY_STEPS, ("terrain replay", env))
        distance, alive_steps, _ = runs[name]
        for i, d in enumerate(distance.tolist()):
            start = "the JAX test's start" if i < 4 else f"torch.Generator seed {TERRAIN_SEEDS[i - 4]} (a measurement)"
            log(f"terrain (d): {name} on +-4 cm, {start}: {d:.3f} m in {alive_steps[i]:.0f} live steps of {TERRAIN_REPLAY_STEPS}")
    b4c, r2b = runs["policy_b4c.pkl"][0], runs["policy_r2b.pkl"][0]
    out = {"b4c_min_m": b4c[:4].min().item(), "b4c_mean_m": b4c[:4].mean().item(), "r2b_mean_m": r2b[:4].mean().item(),
           "b4c_generator_min_m": b4c[4:].min().item(), "b4c_generator_mean_m": b4c[4:].mean().item(),
           "r2b_generator_mean_m": r2b[4:].mean().item()}
    log(f"terrain (d): from the JAX test's starts policy_b4c.pkl min {out['b4c_min_m']:.3f} m (threshold 4.4), mean "
        f"{out['b4c_mean_m']:.3f} m against policy_r2b.pkl's {out['r2b_mean_m']:.3f} m (threshold: 0.4 m past); from the "
        f"generator starts min {out['b4c_generator_min_m']:.3f}, mean {out['b4c_generator_mean_m']:.3f} against "
        f"{out['r2b_generator_mean_m']:.3f} m (a measurement)")
    if not (out["b4c_min_m"] > 4.4 and out["b4c_mean_m"] > out["r2b_mean_m"] + 0.4) or not bool(torch.isfinite(b4c).all()):
        raise AssertionError("the terrain-trained policy failed tests/test_terrain_policy.py's thresholds: "
                             f"min {out['b4c_min_m']:.3f} m, mean {out['b4c_mean_m']:.3f} against {out['r2b_mean_m']:.3f} m")

    mesh = terrain_env(TERRAIN_BUMP, 0, "mesh", obj_dir)
    mesh_noise = torch.cat([torch.tensor(recorded["mesh"], dtype=mesh.dtype, device=mesh.device), generator_noise])
    _, alive_steps, q = terrain_policy_run(mesh, CHECKPOINT, mesh_noise, MESH_REPLAY_STEPS, ("mesh replay", mesh))
    for i in range(mesh_noise.shape[0]):
        ok = bool(torch.isfinite(q[i]).all()) and alive_steps[i] == MESH_REPLAY_STEPS and q[i, 0] > 1.0 and 0.3 < q[i, 2] < 0.6
        start = "the JAX test's start" if i == 0 else f"torch.Generator seed {TERRAIN_SEEDS[i - 1]} (a measurement)"
        log(f"terrain (d): policy_r2b.pkl on the +-2 cm mesh, {start}: alive {alive_steps[i]:.0f} of {MESH_REPLAY_STEPS} "
            f"steps, x {q[i, 0]:.3f} m, z {q[i, 2]:.3f} m: {'past' if ok else 'short of'} tests/test_terrain.py's thresholds")
        if i == 0 and not ok:
            raise AssertionError("policy_r2b.pkl failed tests/test_terrain.py's mesh-terrain thresholds")
    seconds = time.perf_counter() - t0
    launches = pgs.launches
    check_wrapper_launches("terrain (d)", "PGS", launches, cached)
    log(f"terrain (d): 2 x {TERRAIN_REPLAY_STEPS} heightfield steps and {MESH_REPLAY_STEPS} mesh steps at batch "
        f"{noise.shape[0]} through graphs in {seconds:.1f} s (resets and captures included); K1 wrapper launches {launches}")
    out.update(mesh_x_m=q[0, 0].item(), mesh_z_m=q[0, 2].item(), replay_launches=launches)
    return out


def terrain_trainer():
    """(e): the trainer as a user runs it: laikago on the +-4 cm heightfield
    resumed from policy_b4c.pkl for 2 iterations, its checkpoint read back;
    the humanoid with the reset pool logs/humanoid_ars/pool_r5.npz for 1
    iteration. Returns the laikago run's last eval_reward_min."""
    import tempfile

    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.convert import load_checkpoint
    from tds_tpu_torch.tools import ars_train
    from tds_tpu_torch.utils import graphs

    runs = (
        ("laikago", ["--env", "laikago", "--terrain_bump", "0.04", "--terrain_scan", "0", "--resume", str(TERRAIN_CHECKPOINT),
                     "--iterations", "2", "--eval_interval", "2", "--rollout_length", "200", "--num_directions", "8"]),
        ("humanoid", ["--env", "humanoid", "--reset_pool", str(POOL), "--iterations", "1", "--eval_interval", "1",
                      "--rollout_length", "100", "--num_directions", "8"]),
    )
    out = {}
    for name, argv in runs:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}.pkl")
            cached = graphs.stats()
            pgs.launches = 0
            t0 = time.perf_counter()
            _, history = ars_train.main([*argv, "--checkpoint", path])
            seconds = time.perf_counter() - t0
            launches = pgs.launches
            written, meta = load_checkpoint(path)
        iterations = int(argv[argv.index("--iterations") + 1])
        finite = all(bool(torch.isfinite(v)) for metrics in history for v in metrics.values())
        finite = finite and bool(torch.isfinite(torch.as_tensor(written["params"])).all())
        if not finite or "eval_reward_min" not in history[-1] or meta.get("iteration") != iterations:
            raise AssertionError(f"the {name} trainer: finite {finite}, last metrics {history[-1]}, metadata {meta}")
        check_wrapper_launches(f"terrain (e) {name}", "PGS", launches, cached)
        out[name] = history[-1]["eval_reward_min"].item()
        command = " ".join(os.path.basename(a) if os.sep in a else a for a in argv)
        log(f"terrain (e): python -m tds_tpu_torch.tools.ars_train {command} in {seconds:.1f} s: metrics finite, checkpoint read back, eval_reward_min {out[name]:.2f}, K1 wrapper launches {launches}")
    return out["laikago"]


def phase_terrain(card, card_line):
    import tempfile

    with sub_phase("terrain (a) seconds"):
        entry = terrain_kernel(card)
    with tempfile.TemporaryDirectory() as obj_dir:
        with sub_phase("terrain (b) seconds, heightfield"):
            path = drive_main_path(terrain_env(TERRAIN_BUMP, 9), "terrain (b)", ROLLOUT_STEPS, 2, (0.3, 0.6), card_line,
                                   ("laikago_terrain_scan_rollout_env_steps_per_s", TERRAIN_BENCH_STEPS))
        with sub_phase("terrain (b) seconds, mesh"):
            mesh_ms = mesh_rollout(obj_dir)
        with sub_phase("terrain (c) seconds"):
            worst = terrain_device_vs_cpu(obj_dir)
        with sub_phase("terrain (d) seconds"):
            replay = terrain_replay(obj_dir)
    with sub_phase("terrain (e) seconds"):
        reward_min = terrain_trainer()
    summary = {
        "terrain_shape": entry["shape"],
        "terrain_ms": entry["ms"],
        "terrain_plain_ms": entry["plain_ms"],
        "terrain_bound_ms": entry["bound_ms"],
        "terrain_bound_by": entry["bound_by"],
        "terrain_max_abs_err": entry["max_abs_err"],
        "terrain_launches": path["launches"],
        "terrain_replayed_launches_per_step": path["replayed_launches_per_step"],
        "terrain_ms_per_step": path["ms_per_step"],
        "terrain_eager_ms_per_step": path["eager_ms_per_step"],
        "laikago_terrain_scan_rollout_env_steps_per_s": path["laikago_terrain_scan_rollout_env_steps_per_s"],
        "terrain_graph_nodes": path["graph_nodes"],
        "terrain_device_ops_per_step": path["device_ops"],
        "terrain_device_ms_per_step": path["device_ms"],
        "terrain_idle_share": path["idle"],
        "terrain_eager_device_ops_per_step": path.get("eager_device_ops"),
        "terrain_eager_idle_share": path.get("eager_idle"),
        "terrain_mesh_ms_per_step": mesh_ms,
        "terrain_float64_card_against_cpu": worst,
        **{f"terrain_replay_{k}": v for k, v in replay.items()},
        "terrain_trainer_eval_reward_min": reward_min,
    }
    log(f"terrain: {json.dumps(summary)}")
    return summary


# -- phase 14 --------------------------------------------------------------
def k1_backward_bound(b, iterations, card):
    """(ms for the bytes, ms for the flops, bytes, flops) of K1's backward
    on operands whose b is ``b``: A's lower triangle read (all of A after
    the first sweep), b, lo, hi, x after each sweep and x-bar read, A-bar
    written whole (n * n), b-bar, lo-bar and hi-bar written, dep read once.
    Per row of a sweep: 2 flops for each product and sum of p's row sum,
    one for each A-bar entry and 2 for each x-bar update over the columns
    it reads (i in the first sweep, n - 1 after), and about 20 for p, the
    clip's adjoints and the bound and dependency terms."""
    bsz, n = b.shape
    a_values = n * (n + 1) // 2 if iterations <= 1 else n * n
    size = b.element_size()
    n_bytes = size * bsz * (a_values + n * n + 7 * n + (iterations - 1) * n) + 4 * n
    first = sum(5 * i + 20 for i in range(n))
    n_ops = bsz * (first + max(iterations - 1, 0) * n * (5 * (n - 1) + 20))
    bandwidth, f32_rate, f64_rate = card
    rate = f32_rate if b.dtype == torch.float32 else f64_rate
    return n_bytes / bandwidth * 1e3, n_ops / rate * 1e3, n_bytes, n_ops


def k1_backward_case(label, operands, dep, it, card, gen, timing=True):
    """K1's backward kernel against the plain version's autograd on the
    same operands and cotangent: the largest difference (raising past
    rtol 1e-4 and atol 1e-5 max|grad| in float32, 1e-12 relative in
    float64), and with ``timing`` the kernel's device time (median of 100
    launches), the plain backward's (event spans around single calls, the
    host's pace in them), the bound and the launch shape."""
    from tds_tpu_torch.contact import pgs

    a, b, lo, hi = operands
    bsz, n = b.shape
    dep = tuple(dep)
    with torch.no_grad():
        x = pgs.solve_pgs(a, b, lo, hi, dep, it)
    x_bar = torch.randn(b.shape, generator=gen, dtype=b.dtype, device=b.device)
    got = pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar)
    inputs = [t.clone().requires_grad_() for t in operands]
    with torch.enable_grad():
        ref_x = pgs.solve_pgs_reference(*inputs, dep, it)
        want = torch.autograd.grad(ref_x, inputs, x_bar, retain_graph=True)
    torch.cuda.synchronize()
    worst, margin = 0.0, float("inf")
    for name, g, w in zip(("A", "b", "lo", "hi"), got, want):
        scale = w.abs().max().item()
        rtol, atol = (1e-4, 1e-5 * scale) if b.dtype == torch.float32 else (1e-12, 1e-12 * scale)
        err = (g - w).abs()
        over = (err - (atol + rtol * w.abs())).max().item()
        if not bool(torch.isfinite(g).all()) or over > 0:
            raise AssertionError(f"K1's backward disagrees with the plain version's autograd on {label} in {name}: "
                                 f"max |kernel - plain| {err.max().item():.3e} (max |grad| {scale:.3e})")
        worst, margin = max(worst, err.max().item()), min(margin, -over)
    out = {"max_abs_err": worst, "margin": margin}
    if not timing:
        return out
    ms = device_ms(lambda: pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar), rounds=5, per_round=20)
    # 0 sweeps: the gradients zeroed, the floor of the stores
    sweepless_ms = device_ms(lambda: pgs._launch_backward(a, b, lo, hi, dep, 0, x, x_bar), rounds=5, per_round=20)
    plain_ms = span_ms(lambda: torch.autograd.grad(ref_x, inputs, x_bar, retain_graph=True), reps=5)
    t_bytes, t_ops, n_bytes, n_ops = k1_backward_bound(b, it, card)
    shape = pgs.launch_shape(b.dtype, n, bsz, backward=True)
    log(f"gradients (a): K1 backward {label} B={bsz} n={n} it={it} {str(b.dtype)[6:]} ({shape['form']}): {ms * 1e3:.2f} us "
        f"on the device, {sweepless_ms * 1e3:.2f} us with 0 sweeps, plain backward {plain_ms * 1e3:.1f} us (event span, "
        f"host-paced), bound {max(t_bytes, t_ops) * 1e3:.3f} us ({n_bytes} bytes, {n_ops} flops), "
        f"{ms / max(t_bytes, t_ops):.1f}x the bound; max |kernel - plain| {worst:.3e}")
    log_launch_shape(f"gradients (a): K1 backward B={bsz} n={n} {str(b.dtype)[6:]}", shape)
    out.update(ms=ms, ms_0_sweeps=sweepless_ms, plain_ms=plain_ms, plain_timing="event span, host-paced",
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               shape=f"B={bsz} n={n} iterations={it} {str(b.dtype)[6:]}", design=shape["form"], **launch_fields(shape))
    return out


def gradients_kernel(card):
    """(a): K1's backward against the plain version's autograd at the row
    counts and batches of the paths (12 and 24 at B = 4096, 48 at 4096, 105
    at 1024), float32 and float64, one sweep and two, on random problems
    with the ties of tests/test_torch_pgs_grad.py in them; then on the
    float32 operands of a laikago step at B = 4096 with contacts active;
    timed in float32 at one sweep."""
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = {}
    for n, batch in GRAD_ROWS:
        for dtype in (torch.float64, torch.float32):
            for it in (2, 1):
                operands, dep = random_rows_problem(batch, n, dtype, gen)
                n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
                a, b = operands[0], operands[1]
                # env 1 with every normal impulse at 0, env 2 with b = 0
                b[1, :n_c] = -10.0 * b[1, :n_c].abs() - 50.0 * a[1, :n_c, :n_c].abs().sum(-1) - 1.0
                b[2] = 0.0
                timing = dtype == torch.float32 and it == 1
                case = k1_backward_case(f"random {'(timed)' if timing else ''}".strip(), operands, dep, it, card, gen, timing)
                if timing:
                    rows[n] = case
                else:
                    log(f"gradients (a): K1 backward random B={batch} n={n} it={it} {str(dtype)[6:]}: max |kernel - plain| "
                        f"{case['max_abs_err']:.3e}, margin {case['margin']:.3e} under the tolerance")
    env = LaikagoEnv(dtype=torch.float32)
    a, b, lo, hi, dep, it = harvest_pgs_operands(env, gen, ROLLOUT_STEPS, "laikago", "gradients (a)")
    rows[12].update({f"laikago_{k}": v for k, v in k1_backward_case("laikago step", [a, b, lo, hi], dep, it, card, gen).items()
                     if k in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    return rows


def gradients_contact_loss(card_line):
    """(b): tools/contact_loss.py's loss, tests/test_contact_gradients.py's,
    over 500 float64 steps on the card through graphs: its gradient against
    central differences on the card (rtol 2e-4, the test's eps); then over
    the CPU test's 100 steps, the card's gradient within 1e-9 relative of
    the CPU's; K1's backward kernels in a trace of a replayed 20-step
    gradient (one a step)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.tools import contact_loss

    out = {}
    env = LaikagoEnv(dtype=torch.float64)
    q0, qd0, link = contact_loss.sliding_start(env)
    loss = contact_loss.make_loss(env, q0, qd0, link, CONTACT_LOSS_STEPS)
    # the first call, the graphs' captures included (a second, timed call
    # was a measurement only)
    (value, grad), grad_s = timed_call(lambda: contact_loss.gradient(loss, contact_loss.POINT, torch.float64, "cuda"))
    fd, fd_s = timed_call(lambda: contact_loss.central_differences(loss, contact_loss.POINT, contact_loss.FD_EPS, torch.float64, "cuda"))
    rel = ((grad - fd).abs() / fd.abs()).max().item()
    log(f"gradients (b): the {CONTACT_LOSS_STEPS}-step contact loss {value.item():.12g} on the card (float64): gradient "
        f"(kp, mass scale, friction) {[f'{v:.10e}' for v in grad.tolist()]} in {grad_s:.2f} s wall with the captures, central differences "
        f"{[f'{v:.10e}' for v in fd.tolist()]} in {fd_s:.2f} s; largest relative difference {rel:.2e} (rtol 2e-4)")
    if not bool(torch.isfinite(grad).all()) or rel > 2e-4 or grad.abs().min().item() == 0:
        raise AssertionError(f"gradients (b): the card's gradient {grad.tolist()} disagrees with central differences {fd.tolist()}")
    out.update(contact_loss_grad_s=grad_s, contact_loss_fd_s=fd_s, contact_loss_fd_rel=rel)
    log(f"gradients (b) seconds: the {CONTACT_LOSS_STEPS}-step gradient {grad_s:.1f} s, central differences {fd_s:.1f} s")
    # the CPU test's horizon: the card against the CPU
    short = contact_loss.make_loss(env, q0, qd0, link, CONTACT_LOSS_CPU_STEPS)
    card = contact_loss.gradient(short, contact_loss.POINT, torch.float64, "cuda")[1].cpu()
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu")
    cq0, cqd0, _ = contact_loss.sliding_start(cpu_env)
    (_, cpu), cpu_s = timed_call(lambda: contact_loss.gradient(contact_loss.make_loss(cpu_env, cq0, cqd0, link, CONTACT_LOSS_CPU_STEPS),
                                                               contact_loss.POINT, torch.float64, "cpu"))
    rel_cpu = ((card - cpu).abs() / cpu.abs()).max().item()
    log(f"gradients (b): over {CONTACT_LOSS_CPU_STEPS} steps the card's gradient {[f'{v:.12e}' for v in card.tolist()]} against "
        f"the CPU's {[f'{v:.12e}' for v in cpu.tolist()]} ({cpu_s:.1f} s): largest relative difference {rel_cpu:.2e} (1e-9)")
    if rel_cpu > 1e-9:
        raise AssertionError(f"gradients (b): the card's gradient differs from the CPU's by {rel_cpu:.2e} relative")
    out["contact_loss_card_vs_cpu_rel"] = rel_cpu
    traced = contact_loss.make_loss(env, q0, qd0, link, PROFILE_STEPS)
    with sub_phase(f"gradients (b) seconds: the {PROFILE_STEPS}-step trace"):
        contact_loss.gradient(traced, contact_loss.POINT, torch.float64, "cuda")
        _, _, _, count = counted_trace(lambda: contact_loss.gradient(traced, contact_loss.POINT, torch.float64, "cuda"),
                                       "pgs_backward", PROFILE_STEPS)
    log(f"gradients (b): a replayed {PROFILE_STEPS}-step gradient ran K1's backward kernel {count} times (torch.profiler)")
    if count != PROFILE_STEPS:
        raise AssertionError(f"gradients (b): {count} backward kernels in {PROFILE_STEPS} replayed VJP steps")
    return out


def apg_setup(dtype, batch, horizon, truncation, learning_rate=5e-3):
    """(env, policy, reward, config, train_step) of examples/laikago_apg.py's
    APG: an MLP [32, 12] with tanh, the forward-progress reward, on a new
    env (so that its graphs are captured in the caller's count)."""
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import apg
    from tds_tpu_torch.tools.apg_train import forward_reward, make_policy

    env = LaikagoEnv(dtype=dtype)
    policy, reward = make_policy(env), forward_reward(env)
    cfg = apg.APGConfig(horizon=horizon, batch=batch, learning_rate=learning_rate, truncation=truncation)
    return env, policy, reward, cfg, apg.make_apg_train_step(env, policy, cfg, reward_fn=reward)


def apg_recipe(batch, card_line):
    """The scaled recipe (horizon 100, truncation 20, float32) at ``batch``:
    one iteration (the captures), then APG_TIMED_ITERATIONS timed ones,
    K1's forward and backward wrapper launches counted from 0 just before
    them and read just after; the VJP graph's nodes, capture seconds and
    memory; the bench lines."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.learn import apg
    from tds_tpu_torch.utils import graphs

    env, policy, reward, cfg, train = apg_setup(torch.float32, batch, APG_RECIPE["horizon"], APG_RECIPE["truncation"])
    state = apg.init_apg(env, policy, 0, cfg)
    cached = graphs.stats()
    pgs.launches = pgs.backward_launches = 0
    (state, metrics), first_s = timed_call(lambda: train(state))
    launches, backward_launches = pgs.launches, pgs.backward_launches
    timed = []
    for _ in range(APG_TIMED_ITERATIONS):
        (state, metrics), s = timed_call(lambda: train(state))
        timed.append(s)
    if (pgs.launches, pgs.backward_launches) != (launches, backward_launches) or backward_launches != 2:
        raise AssertionError(f"APG at batch {batch}: K1 launched {pgs.launches} and its backward {pgs.backward_launches} "
                             f"times, {launches} and {backward_launches} in the first iteration; the VJP graph's warm-up "
                             "and capture launch the backward twice, a replay never")
    # the VJP graph's warm-up and capture run the step, and K1, too
    check_wrapper_launches(f"APG at batch {batch}", "PGS", launches - backward_launches, cached)
    best = min(timed)
    its = 1 / best
    steps = its * batch * cfg.horizon
    # the forward alone: the rollout's return through the one-step graph, no grad
    starts = apg.draw_starts(env, state.generator, batch)
    with torch.no_grad():
        forward_s = min(timed_call(lambda: apg.rollout_return(env, policy, cfg, state.params, *starts, reward))[1]
                        for _ in range(APG_TIMED_ITERATIONS))
    vjp = [s for s in graphs.vjp_stats() if s.key[0] == "apg" and s.key[1] is env]
    if len(vjp) != 1 or not bool(torch.isfinite(state.params).all()) or not bool(torch.isfinite(metrics["grad_norm"])):
        raise AssertionError(f"APG at batch {batch}: {len(vjp)} VJP graphs, or a non-finite result")
    g = vjp[0]
    log(f"gradients (c): APG scaled recipe (horizon {cfg.horizon}, truncation {cfg.truncation}, float32) at batch {batch}: "
        f"first iteration {first_s:.2f} s (with the captures), then {[round(s, 4) for s in timed]} s; best {best:.4f} s = "
        f"{its:.3f} iterations/s = {steps:.1f} env-steps/s; the forward alone (no grad) {forward_s:.4f} s = "
        f"{forward_s * 1e3 / cfg.horizon:.3f} ms/step; return {metrics['mean_return'].item():.4f}, |g| "
        f"{metrics['grad_norm'].item():.4g}; K1 launches {launches} and backward launches {backward_launches} (warm-ups and "
        f"captures); VJP graph {g.nodes} nodes, captured in {g.capture_s:.3f} s, instantiated in {g.instantiate_s:.3f} s, "
        f"{g.reserved_bytes / 2**20:.1f} MiB reserved for it")
    bench_line("apg_laikago_iterations_per_s", its, "iterations/s", card_line, batch=batch, horizon=cfg.horizon,
               truncation=cfg.truncation, best_s=best)
    bench_line("apg_laikago_env_steps_per_s", steps, "steps/s", card_line, batch=batch, horizon=cfg.horizon,
               truncation=cfg.truncation, best_s=best)
    numbers = {"iterations_per_s": its, "env_steps_per_s": steps, "first_s": first_s, "timed_s": timed, "forward_s": forward_s,
               "vjp_nodes": g.nodes, "vjp_capture_s": g.capture_s, "vjp_reserved_bytes": g.reserved_bytes,
               "launches": launches, "backward_launches": backward_launches}
    return {f"apg_b{batch}_{k}": v for k, v in numbers.items()}, (env, policy, reward, cfg, state)


def gradients_apg(card_line):
    """(c): one float64 laikago train_step (test_learn.py's setup) through
    graphs against the same inside graphs.eager(), bit for bit; the scaled
    recipe at batch 4 (the main path: its K1 launches feed the kernels
    line) and 4096; K1's backward kernels in a trace of a replayed
    PROFILE_STEPS-step train_step at batch 4 (one a step)."""
    from tds_tpu_torch.learn import apg
    from tds_tpu_torch.utils import graphs

    check_s = time.perf_counter()
    env, policy, _, cfg, train = apg_setup(torch.float64, APG_TEST["batch"], APG_TEST["horizon"], APG_TEST["truncation"])
    state = apg.init_apg(env, policy, 0, cfg)
    starts = apg.draw_starts(env, torch.Generator(device="cuda").manual_seed(3), cfg.batch)
    got, metrics = train(state, starts=starts)
    with graphs.eager():
        want, want_metrics = train(state, starts=starts)
    log(f"gradients (c) seconds: the float64 train_step through graphs and eager: {time.perf_counter() - check_s:.1f} s")
    pairs = [(got.params, want.params), (got.opt_state.mu, want.opt_state.mu), (got.opt_state.nu, want.opt_state.nu),
             (metrics["mean_return"], want_metrics["mean_return"]), (metrics["grad_norm"], want_metrics["grad_norm"])]
    worst = max((g - w).abs().max().item() for g, w in pairs)
    log(f"gradients (c): one float64 laikago train_step (horizon {cfg.horizon}, batch {cfg.batch}, truncation "
        f"{cfg.truncation}) through graphs against graphs.eager(): max |graph - eager| = {worst} over params, Adam moments, "
        f"return and |g| (return {metrics['mean_return'].item():.12g}, |g| {metrics['grad_norm'].item():.12g})")
    if worst != 0:
        raise AssertionError(f"gradients (c): the graph train_step differs from the eager one by {worst:.3e}")
    out = {"apg_graph_vs_eager_max_abs": worst}
    main = None
    for batch in APG_BATCHES:
        with sub_phase(f"gradients (c) seconds: the recipe at batch {batch}"):
            numbers, objects = apg_recipe(batch, card_line)
        out.update(numbers)
        main = main or objects
    env, policy, reward, cfg, state = main
    short = apg.make_apg_train_step(env, policy, cfg._replace(horizon=PROFILE_STEPS), reward_fn=reward)
    with sub_phase(f"gradients (c) seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: short(state), calls=1, kernel="pgs_backward", expected=PROFILE_STEPS)
    if profile is None:
        raise AssertionError("gradients (c): the profiler saw no device activity in a train_step")
    ops, busy, wall, count = profile
    log(f"gradients (c): a replayed {PROFILE_STEPS}-step train_step at batch {cfg.batch} (with its reset's "
        f"{env.settle_steps} settle steps): {ops:.0f} device operations, device busy {busy:.3f} of {wall:.3f} ms wall under "
        f"torch.profiler ({100 * (1 - busy / wall):.1f}% idle), K1's backward kernel {count:.0f} times")
    if count != PROFILE_STEPS:
        raise AssertionError(f"gradients (c): {count} backward kernels in {PROFILE_STEPS} replayed VJP steps")
    out.update(backward_replayed_launches_per_step=count / PROFILE_STEPS, apg_train_step_device_ops=ops,
               apg_train_step_idle=1 - busy / wall)
    return out


def gradients_apg_policy():
    """(d): logs/laikago_apg/policy_h100.pkl replayed in float32 through
    graphs for 500 steps from the JAX package's reset(PRNGKey(5))
    (tests/golden/laikago_apg_reset.json), held to
    test_committed_apg_policy_walks's thresholds: no done, dx > 0.25 m,
    up.z above 0.8 throughout."""
    import pickle

    from tds_tpu_torch.convert import mlp_params_from_numpy
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.tools.apg_train import make_policy, replay

    env = LaikagoEnv(dtype=torch.float32)
    with open(APG_CHECKPOINT, "rb") as f:
        params = mlp_params_from_numpy(pickle.load(f)["params"], dtype=torch.float32)
    golden = json.loads(APG_RESET.read_text())
    q, qd = (torch.tensor([golden[k]], dtype=torch.float32, device="cuda") for k in ("q", "qd"))
    start = EnvState(q, qd, torch.zeros(1, dtype=torch.int32, device="cuda"))
    (dx, up_min, done), seconds = timed_call(lambda: replay(env, make_policy(env), params, start, APG_REPLAY_STEPS))
    dx, up_min, done = float(dx[0]), float(up_min[0]), bool(done[0])
    log(f"gradients (d): policy_h100.pkl, {APG_REPLAY_STEPS} steps from the JAX package's reset(PRNGKey(5)) through graphs "
        f"in {seconds:.2f} s: dx {dx:.4f} m (> 0.25), up_min {up_min:.4f} (> 0.8), done {done}")
    if done or not dx > 0.25 or not up_min > 0.8:
        raise AssertionError(f"gradients (d): policy_h100.pkl fails its thresholds on the card: dx {dx}, up_min {up_min}, done {done}")
    return {"apg_policy_dx": dx, "apg_policy_up_min": up_min}


def gradients_apg_learning():
    """(e): 25 APG iterations of test_learn.py's
    test_apg_through_laikago_contact setup (float32, horizon 30, batch 2,
    truncation 10, learning rate 5e-3) on the card: every grad norm
    finite, the mean of the last 5 returns above the first."""
    from tds_tpu_torch.learn import apg

    env, policy, _, cfg, train = apg_setup(torch.float32, APG_TEST["batch"], APG_TEST["horizon"], APG_TEST["truncation"])
    state = apg.init_apg(env, policy, 0, cfg)
    returns, norms = [], []
    t0 = time.perf_counter()
    for _ in range(APG_LEARN_ITERATIONS):
        state, metrics = train(state)
        returns.append(metrics["mean_return"].item())
        norms.append(metrics["grad_norm"].item())
    seconds = time.perf_counter() - t0
    late = sum(returns[-5:]) / 5
    log(f"gradients (e): {APG_LEARN_ITERATIONS} APG iterations (horizon {cfg.horizon}, batch {cfg.batch}, truncation "
        f"{cfg.truncation}) in {seconds:.2f} s: returns {[round(r, 4) for r in returns]}; last 5 mean {late:.4f} against the "
        f"first {returns[0]:.4f}; |g| in [{min(norms):.4g}, {max(norms):.4g}]")
    if not all(math.isfinite(g) for g in norms) or not late > returns[0]:
        raise AssertionError("gradients (e): a grad norm is not finite, or the late returns do not beat the first")
    return {"apg_learn_first_return": returns[0], "apg_learn_last5_mean": late, "apg_learn_s": seconds}


def phase_gradients(card, card_line):
    """Phase 14: gradients through the port on the card. Returns K1's
    backward entry of the kernels line."""
    with sub_phase("gradients (a) seconds"):
        rows = gradients_kernel(card)
    with sub_phase("gradients (b) seconds"):
        out = gradients_contact_loss(card_line)
    with sub_phase("gradients (c) seconds"):
        out.update(gradients_apg(card_line))
    with sub_phase("gradients (d) seconds"):
        out.update(gradients_apg_policy())
    with sub_phase("gradients (e) seconds"):
        out.update(gradients_apg_learning())
    main = rows[12]
    entry = {
        "name": "pgs backward",
        "route": "cuda",
        "source": "tds_tpu_torch/csrc/pgs.cu",
        "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel; its gradient is jax.grad of tds_tpu/contact/mlcp.py:94 solve_pgs)",
        "launches": out[f"apg_b{APG_BATCHES[0]}_backward_launches"],
        "library_ms": None,
        "main_path": f"APG scaled recipe at batch {APG_BATCHES[0]} (c)",
        **{k: v for k, v in main.items() if k != "margin"},
        "row_counts": [{"rows": n, **{k: v for k, v in case.items() if k != "margin"}} for n, case in sorted(rows.items()) if n != 12],
        **out,
    }
    log(f"gradients: {json.dumps({k: v for k, v in entry.items() if k != 'row_counts'})}")
    return entry


@contextlib.contextmanager
def sub_phase(label):
    """A line of the seconds the block took, under ``label``."""
    t0 = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - t0:.1f} s")


def timed(phase, *args):
    """``phase(*args)``, with a line of the seconds it took."""
    with sub_phase(phase.__name__):
        return phase(*args)


def phase_graphs(start_s):
    """Every graph the run left in the cache (they all stay alive), the
    card's memory with all of them, and the script's seconds so far."""
    from tds_tpu_torch.utils import graphs

    cached = graphs.stats()
    for g in cached:
        key = g.key if isinstance(g.key, str) else (g.key[0], type(g.key[1]).__name__, *g.key[2:])
        log(f"graphs: {key} at batch {g.batch}: {g.steps} step(s) per replay, {g.nodes} nodes, capture "
            f"{g.capture_s:.3f} s, instantiate {g.instantiate_s:.3f} s")
    vjp = graphs.vjp_stats()
    for g in vjp:
        key = (g.key[0], type(g.key[1]).__name__)
        log(f"graphs: VJP graph {key} at batch {g.batch}: {g.nodes} nodes, capture {g.capture_s:.3f} s, instantiate "
            f"{g.instantiate_s:.3f} s, {g.reserved_bytes / 2**20:.1f} MiB reserved at its capture")
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    log(f"graphs: {len(vjp)} VJP graphs alive, {sum(g.nodes for g in vjp)} nodes")
    log(f"graphs: {len(cached)} graphs alive, {sum(g.nodes for g in cached)} nodes, captured in "
        f"{sum(g.capture_s for g in cached):.1f} s and instantiated in {sum(g.instantiate_s for g in cached):.1f} s; "
        f"torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB over the run, memory_reserved {reserved / 2**20:.1f} MiB "
        f"with every graph's pool alive")
    log(f"chip_smoke.py: {time.perf_counter() - start_s:.1f} s of its 1200 s limit")
    return {"graphs": len(cached), "graph_nodes": sum(g.nodes for g in cached), "max_memory_allocated": peak,
            "memory_reserved": reserved}


def k1_instances(kernel, rows):
    """The ``kernels`` line's entries of K1 at the row counts of phase 12
    (a) that a main path runs, beside laikago's 12, which is ``kernel``: 24
    (the ant's path, timed on its operands in phase 10 (a)), 48 (the
    half-cheetah's) and 105 (the humanoid's), each with the wrapper's
    launches on that path. The row counts no main path runs (3, 6, 8, 9,
    51) go into ``kernel["other_row_counts"]``, timed on random problems."""
    out = []
    kernel["other_row_counts"] = []
    for n, entry in sorted(rows.items()):
        if n == 12:
            continue
        if n == 24:
            entry = {**entry, "ms": kernel["ant_ms"], "plain_ms": kernel["ant_plain_ms"], "bound_ms": kernel["ant_bound_ms"],
                     "bound_by": kernel["ant_bound_by"], "shape": kernel["ant_shape"], "launches": kernel["ant_launches"],
                     "replayed_launches_per_step": kernel["ant_replayed_launches_per_step"], "main_path": "ant (b)"}
        if "main_path" not in entry:
            kernel["other_row_counts"].append({"rows": n, **entry})
            continue
        out.append({"name": f"pgs n={n}", "route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu",
                    "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", "library_ms": None, **entry})
    return out


def main():
    start_s = time.perf_counter()
    name, card_line = phase_device()
    card = card_peaks(name)
    timed(phase_build)
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    env = LaikagoEnv(dtype=torch.float32)
    kernel = timed(phase_kernel, env, card)
    timed(phase_device_vs_cpu)
    # a new env, so that the main path captures graphs of its own
    main_path = timed(phase_main_path, LaikagoEnv(dtype=torch.float32), card_line)
    kernel["launches"] = main_path["launches"]
    timed(phase_trained_policy, env)
    mega = timed(phase_mega_step, card)
    probes = timed(phase_probes, card)
    mega.update(timed(phase_ars, card, mega, card_line))
    kernel.update(timed(phase_ant, card, card_line))
    k1_rows, humanoid = timed(phase_humanoid, card, card_line)
    terrain = timed(phase_terrain, card, card_line)
    backward = timed(phase_gradients, card, card_line)
    kernel.update({f"main_path_{k}": v for k, v in main_path.items() if k != "launches"})
    kernel.update(humanoid)
    kernel.update(terrain)
    kernel.update(timed(phase_graphs, start_s))
    print(json.dumps({"kernels": [kernel, *k1_instances(kernel, k1_rows), backward, mega, *probes]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
