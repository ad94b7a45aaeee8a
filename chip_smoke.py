#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, ``tds_tpu_torch``, on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --rest-only    # phases 1, 2 and 19 alone, no result lines
    python3 chip_smoke.py --api-only     # phases 1, 2 and 20 alone, no result lines
    python3 chip_smoke.py --sweeps-only  # phases 1, 2 and 21 alone, no result lines

It builds the port's kernels from the sources in this checkout and drives
the laikago contact rollout, the fused step, the probes, ARS, the ant and
hopper rollouts, the humanoid and half-cheetah rollouts, the terrain
laikago's rollout, replays and trainer, gradients (the contact loss
and APG through K1's backward kernel), forward mode (jacfwd through K1's
JVP kernel), PPO on the ant, floating bases (the floating laikago,
balls through ``world_step`` and a ball's gradient), control and the
rest of dynamics (the MPC trot walk of 4096 laikagos, spring contact, the
CRBA and bf16 contact options), the rest of collision (4096 Pandas
pushing boxes, the mesh-cube stack, raycasts), the rest of the port
(4096 laikagos tracking the mocap dance through K2 and through K1, ARS
split over ranks under NCCL and gloo and the trainer under torchrun, a
pytinydiffsim-style script through the compat shim, a rendered frame),
and the rest of the API (K1 from a warm start, PPO on 256 humanoids from
their reset pool) through them.
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
15. forward mode and PPO, run before phase 11: (a) K1's forward-mode
   kernel (``csrc/pgs.cu`` ``tds_pgs_jvp_*``, through
   ``contact.pgs.PGSJVP``) against ``torch.func.jvp`` of the plain version
   at n = 12, 24, 48 (B = 4096) and 105 (B = 1024), all three forms,
   float32 (rtol 1e-5, atol 1e-6 max|x'|) and float64 (1e-12 relative),
   one to three sweeps, ties included; its time (median of 100 launches),
   the plain JVP's, the bound and the launch shape in float32 at one
   sweep; (b) ``torch.func.jacfwd`` of ``tools/contact_loss.py``'s loss
   over a 20-step laikago contact rollout through ``graphs.scan`` (float64,
   batch 1): a JVP graph of three tangents, K1's JVP wrapper launches
   counted (its warm-up and capture), the graph's nodes and capture
   seconds, within 1e-9 of the CPU's jacfwd and of ``torch.func.jacrev`` on
   the card, one JVP kernel a replayed step in a trace; (c) PPO
   (``learn/ppo.py``) at ``examples/ppo_train.py``'s ant recipe (256 envs x
   128 steps, 8 minibatches x 4 epochs, 64 x 64 tanh MLPs, float32), two
   iterations from seed 0: each iteration's seconds, its collect's and its
   fresh resets', env-steps/s, K1's wrapper launches counted, and K1 once a
   collect step and once a settle step in a trace of an 8-step collect; (d)
   ``logs/ant_ppo/policy.pkl`` and ``policy_anneal.pkl.final`` replayed for
   1000 steps through graphs from the JAX test's starts
   (``tests/golden/ant_ppo_policy_reset_noise.json``) at
   ``tests/test_ppo_ant_policy.py``'s thresholds, and from four
   ``torch.Generator`` starts in the same batch, reported; (e) one float64
   PPO iteration on the ant on the card against the CPU's from the same
   draws, within 1e-9, an env reset inside the unroll;
16. floating bases, run before phase 11: (a) the floating laikago
   (``LaikagoEnv(urdf="laikago/laikago_toes_zup.urdf", is_floating=True)``,
   q 19 wide with the base's quaternion and position, 12 MLCP rows) for 50
   float64 contact steps at batch 8 on the card against the CPU within
   1e-9 abs + rel, then ``tests/golden/laikago_floating_contact_trajectory.json``
   replayed on the card under ``reference_base_abi_quirk`` for 500 steps
   in ``graphs.scan`` (1e-8 to step 100, 1e-6 after), and 100 steps of the
   same scan without the quirk, a graph of its own; (b) its 1000-step
   zero-policy rollout at batch 4096 in float32 through graphs,
   ``laikago_floating_scan_rollout_env_steps_per_s`` beside phase 5's
   fixed-base figure and the card's name and power limit, the graph's
   nodes, K1's wrapper launches and its count in a trace of 20 replayed
   steps, and K1 against its plain version on the operands of a step of
   this rollout (n = 12), timed; (c) ``tests/golden/sphere_contact_trajectory.json``
   through ``world.world_rollout`` (``world_step`` in ``graphs.scan``, the
   ground's (B, 0) state in the carry) in float64 at the golden's
   tolerances, then 4096 balls of ``tools/ball_loss.py`` dropped for 500
   float32 steps through graphs, K1 at n = 3 once a replayed step, against
   its plain version on a step's operands and timed; (d) the gradient of
   ``tools/ball_loss.py``'s 100-step loss with respect to the initial
   velocity on the card through the scan's VJP graph (K1's backward at n =
   3) within 1e-9 of the CPU's, one backward kernel a replayed step in a
   trace, K1's backward against the plain version's autograd on (c)'s
   operands, timed;
17. control and the rest of dynamics, run before phase 11: (a) float64,
   card against CPU within 1e-9 abs + rel: the MPC walk
   (``tds_tpu_torch.tools.mpc_walk``'s build) at batch 8 over 10 ticks of
   5 substeps through graphs (q, qd, and the controller's torques at the
   start and the end), the spring laikago and the laikago under
   ``minv_method="crba"`` over 50 seeded steps, and one CRBA step against
   ABA's within 1e-10; (b) the MPC walk at full width: batch 4096, float32,
   400 ticks x 5 substeps at a 0.4 m/s command, a tick a replayed graph,
   env 0 from ``tests/test_mpc_walk.py``'s start
   (``tests/golden/laikago_mpc_walk_start.json``) held to that test's
   three thresholds and the share of the batch that meets them printed,
   env-steps/s with the card's name and power limit, the graph's nodes a
   tick, the controller's share of a tick's device time, K1's wrapper
   launches (counted from 0 just before the walk) and its count in a trace
   of 20 replayed substeps, K1 against its plain version on a substep's
   operands, timed; (c) the spring laikago's 1000-step zero-policy rollout
   at batch 4096 (``laikago_spring_scan_rollout_env_steps_per_s``, beside
   phase 5's MLCP figure; no PGS launch) and
   ``tests/test_spring_contact.py``'s ball: d(final z)/d(z0) over 400
   steps through the scan's VJP graph, within 1e-9 of the CPU's and at
   rtol 1e-3 of central differences; (d) the laikago at batch 4096 for 100
   replayed steps under "aba", "crba" and "bf16" (ms/step each), K1
   against its plain version on the bf16 and the CRBA operands, timed, and
   the humanoid under "aba" and "crba" at batch 1024 (ms/step);
18. the rest of collision, run before phase 11: (a) ``tools/panda_push.py``'s
   scene (a 9-DoF Panda with a sphere on its end effector, a floating box,
   the ground: 3 contact solves a step, K1 at 3, 24 and 3 rows with 10
   sweeps each) in float64 at batch 8 for 20 steps, the box against the
   end effector from the start, through graphs on the card against the
   CPU within 1e-9 abs + rel; then the tool as a user runs it: the IK
   waypoints in float32 on the card and 1000 steps of 4096 scenes through a
   replayed graph, env 0 from the example's box start held to the
   example's criterion (pushed more than 4 cm) and within 5 mm of its
   rest height, the share of the batch that meets both, env-steps/s,
   ms/step and the graph's nodes, K1's wrapper launches counted from 0
   just before and read just after (3 a captured step) and K1 in a trace
   of 20 replayed steps (60), K1 against its plain version on the three
   solves of a step mid-stroke, timed; (b) tests/test_mesh_contact.py's
   mesh-cube stack (mesh-mesh, 8 candidates, 24 rows): 20 float64 steps of
   8 envs in contact on the card against the CPU within 1e-10, then 4096
   cubes dropped from 1.35 m (env 0 at the test's pose, the others moved
   by U(-5 cm, +5 cm) in x and y) for 1200 steps through world_rollout in
   float32, printed as a measurement (it does not settle in float32, in
   the JAX package either), and in float64, held: env 0 at the test's
   thresholds (z within 0.03 of 1.3, |qd| < 0.1), the share of the batch,
   K1's wrapper launches and its count in a trace, K1 against its plain
   version on a step's operands, timed; (c) ``cast_rays`` over
   examples/raycast_example.py's sphere, box and plane and the unit mesh
   cube, 1024 x 1024 rays, float64 on the card against the CPU: fractions
   within 1e-12, ``geom_index`` identical, and its time;
19. the rest of the port, run before phase 11: (a) ``tools/mocap_track.py``
   as a user runs it, 4096 laikagos x
   2500 float32 steps of ``laikago_dance_sidestep0.txt``, each at its own
   speed in [0.8, 1.2] (env 0 at 1.0), a step a replayed graph, once
   through K2 and once through the eager step (K1 at 12 rows): the
   kernel's wrapper launches counted from 0 just before and read just
   after, env-steps/s, the graph's nodes, env 0 held to the example's
   criterion (joint RMS after the first fifth < 0.25 rad, base height >
   0.2 m, up.z > 0.8) and the share of the batch that meets it, the
   kernel in a trace of 20 replayed steps (20), and the kernel against its
   plain version on the operands of a step from the final states, timed
   (K2 held over every env but the ties: a toe within K2_TIE of the
   plane and the float64 step nearer K2 or between the two); then 20
   float64 steps of the tracking at batch 8 through the eager step (K1,
   the toes touching) and graphs on the card against the CPU within 1e-9
   abs + rel; (b) bench.py's ARS recipe with its directions split over
   ranks, after a check that ARS's policy of per-env weights gives each
   env the same bits at batch 256 as at 128 (einsum's difference
   printed): (i) world size 1 under NCCL, joined in this process from the variables torchrun
   sets, equal to the one-process iteration bit for bit; (ii) two
   processes on the one card under gloo (this script with ``--ars-rank``),
   64 directions each, in float32 and float64: both ranks equal bit for
   bit, and within 1e-5 (float32) and 1e-12 (float64) abs + rel of one
   process; (iii) ``torchrun --standalone --nproc_per_node=1 -m
   tds_tpu_torch.tools.ars_train`` for 2 iterations writes its checkpoint
   and its Experiment logs; s/iteration of (i) and (ii); (c) a
   pytinydiffsim-style script through ``tds_tpu_torch.compat``: the
   laikago through ``UrdfParser`` and ``TinyWorld`` (K1 at n = 12, B = 1 in
   each ``world.step``), 100 float64 steps of tests/test_compat.py's loop
   on the card within 1e-9 of the CPU, K1's launches (one a step) and its
   count in a trace, K1 against its plain version, timed; then env 0 of
   the mocap run rendered by ``visualizer.renderer`` from the card's state
   and on the CPU, at most 0.1% of the pixels differing. A CPU process
   beside (a) runs (a)'s float64 check on the CPU, (c)'s CPU run and the
   frame's rasterisation; (ii)'s ranks start beside (a), use the card once
   (i) is done, and run with (iii)'s trainer beside (c);
20. the rest of the JAX package's API, run before phase 11: (a) K1 from a
   warm start (``contact.mlcp.solve_pgs``, the JAX package's public PGS,
   and ``contact.pgs.solve_pgs(..., x0=)``): the warm-start instances of
   the forward, the backward (with x0-bar) and the JVP (with x0') against
   their plain versions at n = 3, 12, 24, 48, 105 and 340 (every form;
   340 past the streaming thresholds), float32 and float64, 1 and 3
   sweeps, x0 nonzero with entries outside their bounds (float32 held to
   the plain versions run in float64 on the same operands); the public
   path at B = 1024, n = 105 under grad and ``torch.func.jvp`` with the
   warm-start counters set to 0 just before and read just after; K1 with
   and without x0 at n = 12 (B = 4096) and n = 105 (B = 1024), the zero
   start beside PERF.md's times; (b) PPO on the humanoid from
   ``logs/humanoid_ars/pool_r5.npz`` (p = 0.5) at the ant recipe's shape
   (256 envs x 128 steps, float32), 3 iterations through the graphs, K1 at
   105 rows in its blocked form: s/iteration, env-steps/s, K1's wrapper
   launches and a trace of a short collect, the auto-resets' pool share
   against 0.5 (within 4 sigma), K1 on a collect step's operands against
   its plain version, timed; one float64 iteration at 4 envs x 8 steps on
   the card against the CPU's (a process of its own beside the phase)
   within 1e-9, one reset from the pool and one not;
21. K1 past its first sweep, run before phase 11: (a) K1's backward for
   two sweeps or more ("linearised sweeps": A's upper part staged whole or
   streamed from L2) at n = 3 (4 sweeps), 12, 48 and 105 (from x0 at 1
   and 3 sweeps, from zero at 10) at the paths' batches, on the operands
   it is timed on: float64 against the plain version's autograd, float32
   against the plain version in float64 along the forward's own sweeps,
   those it saved (``tools/pgs_ab.py``'s ``plain_backward_along``), on the
   envs with no clip near a tie; timed in float32 alone, through the
   wrapper, beside the forward with and without its saves and a gradient
   through ``solve_pgs``; and on the Panda push's three solves of phase 18
   (10 sweeps); (b) the public paths, each wrapper's count set to 0 just
   before and read just after: the ball loss's gradient (one forward, which
   saves its sweeps, a replayed VJP step, by the wrapper's count and in a
   trace) and ``mlcp.solve_pgs`` from x0 at 3 sweeps (n = 24 and 105)
   under grad (one forward and one backward launch a gradient), its saved
   sweeps held row by row against the plain version in float64 along
   them (``tools/pgs_ab.py``'s ``plain_forward_along``), its gradients
   held as in (a), and ``torch.func.jvp``; ``mlcp.solve_pgs``
   under grad at the bindings' default 50 sweeps (n = 24, B = 4096,
   float32, from x0 = 0): one forward and one backward launch, held along
   its own sweeps, timed (the parent tree's times stand in PERF.md, from
   ``tools/pgs_ab.py --gradient``); (c) the float32 warm
   row-per-lane forward and JVP on ``tools/pgs_ab.py --warm``'s n = 24,
   B = 4096 problem within rtol 1e-5, atol 1e-6 of float64, and the
   blocked forward from x0 and at 10 sweeps, timed;
11. graphs: every graph left alive by the run (nodes, capture and
   instantiate seconds), the VJP graphs, the card's peak and reserved
   memory with all of them, and the script's seconds against its 1200 s
   limit.

The line before the last is the ``kernels`` JSON object (K1 once for each
row count a main path runs, 12, 24, 48 and 105, the other row counts of
phase 12 (a) and the terrain's n = 24 (``terrain_*``) inside the first;
K1's backward at n = 12, the other row counts inside it; K1's forward
mode at n = 12, the other row counts inside it; K1 on the floating
laikago (n = 12) and on the balls (n = 3) and K1's backward under the
ball loss (n = 3); K1 on the MPC walk and on the bf16 Delassus operands
(n = 12); K1 on the Panda push's three solves (n = 3, 24, 3, 10 sweeps)
and on the mesh stack (n = 24); K2 and K1 on the mocap dance and K1 on the
compat script (n = 12, B = 1); K1's warm-start forward, backward and JVP
and K1 on the humanoid PPO path (n = 105, B = 256); K1's backward past one
sweep in both forms, K1's saving forward at 50 sweeps and the float32
warm row-per-lane forward and JVP of phase 21; K2, K3, K4); the last
line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``tds_tpu``.
"""

import contextlib
import functools
import json
import math
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
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
# phase 15: jacfwd through a 20-step laikago contact rollout; PPO at
# examples/ppo_train.py's ant recipe (256 envs x 128 steps), two iterations;
# the committed ant checkpoints' replays at tests/test_ppo_ant_policy.py's
# 1000 steps from its starts (the JAX package's reset draws for them,
# recorded in the JSON file)
# the jacfwd trace a measurement: 20 replayed steps took 40 s under the
# profiler on an H100 80GB HBM3 at 700 W
FORWARD_STEPS, FORWARD_TRACE_STEPS = 20, 5
PPO_RECIPE, PPO_ITERATIONS, PPO_TRACE_STEPS = {"num_envs": 256, "unroll": 128}, 2, 8
ANT_PPO_STEPS = 1000
ANT_PPO_RESET_NOISE = REPO / "tests" / "golden" / "ant_ppo_policy_reset_noise.json"
# phase 16: the floating laikago (tests/test_golden_reference.py's URDF and
# golden), the golden sphere, a batch of tools/ball_loss.py's balls dropped
# at the main path's batch, and that tool's loss over the CPU test's steps
FLOATING_URDF = "laikago/laikago_toes_zup.urdf"
FLOATING_GOLDEN = REPO / "tests" / "golden" / "laikago_floating_contact_trajectory.json"
SPHERE_GOLDEN = REPO / "tests" / "golden" / "sphere_contact_trajectory.json"
BALL_BATCH, BALL_STEPS, BALL_LOSS_STEPS = 4096, 500, 100
PROFILE_STEPS = 20  # graph-replayed steps under torch.profiler
# the gradient paths' traces (phase 14 (b), (c)): 20 replayed VJP steps took
# 26.2 and 36.1 s under the profiler on an H100 80GB HBM3 at 700 W; 5 keep
# the count
GRAD_PROFILE_STEPS = 5
# measurements only, cut to keep the script inside 700 s, under 60% of its
# limit: eager steps of the stage breakdown, now of the laikago's main path
# only (5 steps on every main path before), alternating timed runs of each
# graph length of ARS's rollout (10 before), the humanoid's top_k = 8
# rollout (200 steps, best of 3 before) and the eager steps timed beside
# K2 (MEGA_STEPS before); BENCH_REPEATS and APG_TIMED_ITERATIONS were 3
BREAKDOWN_STEPS, CHUNK_RUNS, TOP_K_STEPS, TOP_K_REPEATS, MEGA_EAGER_STEPS = 1, 2, 50, 1, 20
# cut to make room for phase 17: the eager rollout each main path holds its
# graphs to, bit for bit (the path's whole rollout before: 100 steps, 200
# on the humanoid's)
EAGER_STEPS = 20
# the main paths' eager comparisons (cut to 10 steps for phase 19, back to
# 20 since phase 20), and the humanoid replay stops once every env is done
# (checked every HUMANOID_REPLAY_CHUNK steps; 3000 steps always before)
MAIN_EAGER_STEPS, HUMANOID_REPLAY_CHUNK = 20, 250
# the float64 card-against-CPU comparisons' depth, whose CPU side runs the
# plain versions eagerly: cut to 20 steps for phase 19 (the contact loss's
# CPU gradient to 50 steps, the MPC walk's check to 4 ticks, APG's learning
# check to 15 iterations), all back since phase 20
CARD_CPU_STEPS = 50
# phase 17: examples/laikago_mpc_walk.py's walk at tests/test_mpc_walk.py's
# 400 ticks x 5 substeps, env 0 from that test's start (the JAX package's
# reset draws for its key, recorded in the JSON file); the card against the
# CPU over 10 ticks at batch 8; the spring laikago's rollout and
# tests/test_spring_contact.py's ball gradient (400 steps); the CRBA and
# bf16 options over 100 replayed steps (200 before phase 19), the humanoid
# under CRBA over 50
MPC_START = REPO / "tests" / "golden" / "laikago_mpc_walk_start.json"
MPC_BATCH, MPC_TICKS, MPC_CONTROL_EVERY, MPC_CHECK_BATCH, MPC_CHECK_TICKS, MPC_TIMED_TICKS = 4096, 400, 5, 8, 10, 4
SPRING_BALL_STEPS, OPTION_STEPS, HUMANOID_CRBA_STEPS = 400, 100, 50
# phase 18: tools/panda_push.py's 1000 steps at batch 4096 (float64 card
# against CPU at batch 8), tests/test_mesh_contact.py's mesh-cube stack
# (1200 steps at batch 4096), cast_rays over a 1024 x 1024 grid
PANDA_BATCH, PANDA_CHECK_BATCH, STACK_BATCH, STACK_STEPS, RAY_GRID = 4096, 8, 4096, 1200, 1024
# phase 19: tools/mocap_track.py's 4096 laikagos x 2500 steps of the dance
# through K2 and through the eager step (K1), float64 card against CPU at
# batch 8; bench.py's ARS recipe split over ranks (2 processes on the one
# card under gloo), all drawing from a generator seeded ARS_SHARD_SEED; a
# pytinydiffsim-style script through compat (100 steps, B = 1); a rendered
# frame. ARS_SHARD_TOL_*: abs + rel against one process: float32 per-env
# results may differ in the last bit where a batched product runs at
# another batch size
MOCAP_BATCH, MOCAP_CHECK_BATCH = 4096, 8
ARS_RANKS, ARS_SHARD_SEED, ARS_SHARD_TOL_F32, ARS_SHARD_TOL_F64 = 2, 19, 1e-5, 1e-12
# K2_TIE: a contact sphere this close to the plane (m) may be a tie for
# float32: the K2 and plain versions' roundings of its distance (their FK
# sums in other orders) may decide its row differently, and the step then
# differs by the contact impulse. An env with such a sphere that differs
# beyond MEGA_TOL is a tie only where the float64 step sides with K2 (nearer
# it than the plain step) or lies between the two (within MEGA_TOL); every
# other env is held at MEGA_TOL (on the dance's final states, resting feet
# put 426 of 4096 envs within 1e-6 m; 4 of them differed, the worst at
# -1.3e-8 m by 2.0e-3 in q, K2 nearer the float64 step than the plain one)
K2_TIE = 1e-6
TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
COMPAT_URDF, COMPAT_STEPS, COMPAT_TRACE_STEPS, RENDER_TOL = "laikago/laikago_toes_zup_xyz_xyzrot.urdf", 100, 5, 1e-3
# phase 20: K1's warm start against its plain versions at these (rows,
# batch), 340 past the streaming forms' thresholds (335 forward, 328
# backward, 236 JVP in float32); timed with and without x0 at WARM_TIMED,
# the zero start beside its times in PERF.md (us, float32, one sweep); the
# public path (mlcp.solve_pgs) at WARM_PATH; PPO on the humanoid from
# pool_r5.npz at the ant recipe's shape, its pool share against POOL_PROB
WARM_ROWS = ((3, 37), (12, 37), (24, 37), (48, 37), (105, 9), (340, 5))
WARM_TIMED, WARM_PATH = ((12, 4096), (105, 1024)), (105, 1024)
ZERO_START_US = {12: (6.88, 7.42), 105: (29.09, 29.12)}
POOL_PROB, HUMANOID_PPO_ITERATIONS, HUMANOID_PPO_TRACE_STEPS = 0.5, 3, 2
# phase 21: K1's backward past its first sweep ("linearised sweeps"; one
# sweep from x0 keeps the first design) against the plain version's
# autograd: (rows, batch, sweeps, from x0) of each case, float32 (timed)
# and float64 at the paths' batches, float32 on the envs with no clip near
# a tie, of which at most SWEEPS_NEAR_TIE of the envs may be; the Panda push's
# solves at their 10 sweeps on phase 18's operands; the blocked forward
# from x0 and at 10 sweeps; the float32 warm row-per-lane instances on
# tools/pgs_ab.py --warm's n = 24 problem; the public paths those
# instances run on: the ball loss's gradient (n = 3, 4 sweeps) and
# mlcp.solve_pgs from x0 at SWEEPS_PATHS, SWEEPS_PATH_SWEEPS sweeps
SWEEPS_CASES = ((3, 4096, 4, False), (3, 2, 4, False), (12, 4096, 1, True), (48, 4096, 1, True), (105, 1024, 1, True),
                (12, 4096, 3, True), (48, 4096, 3, True), (105, 1024, 3, True), (12, 4096, 10, False),
                (48, 4096, 10, False), (105, 1024, 10, False))
SWEEPS_NEAR_TIE, SWEEPS_PATHS, SWEEPS_PATH_SWEEPS = 0.05, ((24, 4096), (105, 1024)), 3
# phase 21 (b): mlcp.solve_pgs under grad at the bindings' default sweeps
# (compat.TinyMultiBodyConstraintSolver's pgs_iterations_), n = 24, B = 4096,
# float32, from x0 = 0
BINDINGS_SWEEPS = 50
BLOCKED_CASES = ((48, 4096, 1, True), (105, 1024, 1, True), (48, 4096, 10, False), (105, 1024, 10, False))


# PGS calls an earlier phase recorded for a later one (phase 18's Panda push
# step for phase 21)
RECORDED = {}


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

    batch, steps, tol = 8, CARD_CPU_STEPS, 1e-9
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
    in ``z_range``. Then: the same rollout replayed again (graph ms/step),
    and its first MAIN_EAGER_STEPS steps replayed and run eagerly
    (``graphs.eager()``, eager ms/step), which must agree bit for bit; PROFILE_STEPS replayed steps under torch.profiler (device
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
    _, graph_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, steps))
    eager_steps = min(steps, MAIN_EAGER_STEPS)
    again = rollout(env, policy, None, state0, obs0, eager_steps)
    with graphs.eager():
        eager, eager_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, eager_steps))
    log(f"{label} seconds: reset {reset_s:.1f} s, first rollout {first_s:.1f} s, replay {graph_s:.1f} s, eager "
        f"({eager_steps} steps) {eager_s:.1f} s")
    # the same kernels on the same inputs in the same order: bit for bit
    worst = max((g.double() - e.double()).abs().max().item() for g, e in zip((*again[0], *again[1:]), (*eager[0], *eager[1:])))
    if worst != 0:
        raise AssertionError(f"{label}: the graph rollout differs from the eager one by up to {worst:.3e}")
    step_ms, eager_ms = graph_s * 1e3 / steps, eager_s * 1e3 / eager_steps
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
    return len(device_events) / calls, sum(us for _, us in device_events) / 1e3 / calls, wall_ms, named / calls


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
    batch, steps, tol = 8, CARD_CPU_STEPS, 1e-9
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
    k2 = [us for name, us in device_events if "megastep_kernel" in name]
    if len(k2) != env.settle_steps + steps:
        raise AssertionError(f"ARS (c): {env.settle_steps + steps} replayed steps ran K2 {len(k2)} times in the trace")
    return wall_s * 1e3, eager_s * 1e3, {
        "device_ops": len(device_events),
        "device_ms": sum(us for _, us in device_events) / 1e3,
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
    """(c): CARD_CPU_STEPS float64 ant steps at batch 16, K1 on the card against the
    plain PGS on the CPU, within 1e-9 abs + rel. Half the envs start with
    the torso on the ground, where all 17 candidates penetrate and the
    compaction drops 9; the other half stand on their feet. The joint
    noise keeps exact ties of distance out (across devices a tie could
    flip on the last bit). Returns the largest difference."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.ant import AntEnv

    batch, steps, tol = 16, CARD_CPU_STEPS, 1e-9
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
    shape = pgs.launch_shape(b.dtype, n, bsz, iterations=it)  # the instance these sweeps launch
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
    """(c): CARD_CPU_STEPS float64 humanoid steps at batch 8, K1 (n = 105) on the card
    against the plain PGS on the CPU, within 1e-9 abs + rel, from states 8 to
    10 cm below the standing start (the feet in the ground) with seeded
    actions. Returns the largest difference."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    batch, steps, tol = 8, CARD_CPU_STEPS, 1e-9
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
    HUMANOID_REPLAY_STEPS steps through graphs (``utils.graphs.scan``; in
    chunks of HUMANOID_REPLAY_CHUNK, stopping when every env is done), 8
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
        # in chunks, stopping once every env is done: the sums freeze at
        # done, so the rest of the HUMANOID_REPLAY_STEPS steps change nothing
        replayed = 0
        while replayed < HUMANOID_REPLAY_STEPS and bool(carry[5].any()):
            length = min(HUMANOID_REPLAY_CHUNK, HUMANOID_REPLAY_STEPS - replayed)
            carry = graphs.scan(body, carry, consts, length, key=("humanoid replay", env))
            replayed += length
        total, alive, steps, x = carry[4:]
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
    log(f"humanoid (d): {HUMANOID_CHECKPOINT.name} replayed through graphs for {replayed} of {HUMANOID_REPLAY_STEPS} steps "
        f"(every env done by then) at batch "
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
    """(c): CARD_CPU_STEPS float64 steps at batch 8 on the heightfield and on the mesh,
    K1 on the card against the plain PGS on the CPU, within 1e-9 abs + rel
    (q, qd and the observation with its 9 scan columns), from a base 5 cm
    below the standing start (the toes in the ground). Returns the largest
    difference."""
    from tds_tpu_torch.contact import pgs

    batch, steps, tol = 8, CARD_CPU_STEPS, 1e-9
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


def k1_backward_case(label, operands, dep, it, card, gen, timing=True, prefix="gradients (a)"):
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
    x, xs = pgs._launch(a, b, lo, hi, dep, it, save=True)  # x and the sweeps the backward reads
    x_bar = torch.randn(b.shape, generator=gen, dtype=b.dtype, device=b.device)
    got = pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar, xs=xs)
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
    ms = device_ms(lambda: pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar, xs=xs), rounds=5, per_round=20)
    # 0 sweeps: the gradients zeroed, the floor of the stores
    sweepless_ms = device_ms(lambda: pgs._launch_backward(a, b, lo, hi, dep, 0, x, x_bar), rounds=5, per_round=20)
    plain_ms = span_ms(lambda: torch.autograd.grad(ref_x, inputs, x_bar, retain_graph=True), reps=5)
    t_bytes, t_ops, n_bytes, n_ops = k1_backward_bound(b, it, card)
    shape = pgs.launch_shape(b.dtype, n, bsz, backward=True, iterations=it)
    log(f"{prefix}: K1 backward {label} B={bsz} n={n} it={it} {str(b.dtype)[6:]} ({shape['form']}): {ms * 1e3:.2f} us "
        f"on the device, {sweepless_ms * 1e3:.2f} us with 0 sweeps, plain backward {plain_ms * 1e3:.1f} us (event span, "
        f"host-paced), bound {max(t_bytes, t_ops) * 1e3:.3f} us ({n_bytes} bytes, {n_ops} flops), "
        f"{ms / max(t_bytes, t_ops):.1f}x the bound; max |kernel - plain| {worst:.3e}")
    log_launch_shape(f"{prefix}: K1 backward B={bsz} n={n} {str(b.dtype)[6:]}", shape)
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
    CONTACT_LOSS_CPU_STEPS steps, the card's gradient within 1e-9 relative of
    the CPU's; K1's backward kernels in a trace of a replayed 5-step
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
    traced = contact_loss.make_loss(env, q0, qd0, link, GRAD_PROFILE_STEPS)
    with sub_phase(f"gradients (b) seconds: the {GRAD_PROFILE_STEPS}-step trace"):
        contact_loss.gradient(traced, contact_loss.POINT, torch.float64, "cuda")
        _, _, _, count = counted_trace(lambda: contact_loss.gradient(traced, contact_loss.POINT, torch.float64, "cuda"),
                                       "pgs_backward", GRAD_PROFILE_STEPS)
    log(f"gradients (b): a replayed {GRAD_PROFILE_STEPS}-step gradient ran K1's backward kernel {count} times (torch.profiler)")
    if count != GRAD_PROFILE_STEPS:
        raise AssertionError(f"gradients (b): {count} backward kernels in {GRAD_PROFILE_STEPS} replayed VJP steps")
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
    GRAD_PROFILE_STEPS-step train_step at batch 4 (one a step)."""
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
    short = apg.make_apg_train_step(env, policy, cfg._replace(horizon=GRAD_PROFILE_STEPS), reward_fn=reward)
    with sub_phase(f"gradients (c) seconds: the {GRAD_PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: short(state), calls=1, kernel="pgs_backward", expected=GRAD_PROFILE_STEPS)
    if profile is None:
        raise AssertionError("gradients (c): the profiler saw no device activity in a train_step")
    ops, busy, wall, count = profile
    log(f"gradients (c): a replayed {GRAD_PROFILE_STEPS}-step train_step at batch {cfg.batch} (with its reset's "
        f"{env.settle_steps} settle steps): {ops:.0f} device operations, device busy {busy:.3f} of {wall:.3f} ms wall under "
        f"torch.profiler ({100 * (1 - busy / wall):.1f}% idle), K1's backward kernel {count:.0f} times")
    if count != GRAD_PROFILE_STEPS:
        raise AssertionError(f"gradients (c): {count} backward kernels in {GRAD_PROFILE_STEPS} replayed VJP steps")
    out.update(backward_replayed_launches_per_step=count / GRAD_PROFILE_STEPS, apg_train_step_device_ops=ops,
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
    """(e): APG_LEARN_ITERATIONS APG iterations of test_learn.py's
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


# -- phase 15 --------------------------------------------------------------
def k1_jvp_bound(b, iterations, card):
    """(ms for the bytes, ms for the flops, bytes, flops) of K1's forward
    mode on operands whose b is ``b``: A's and A''s lower triangles read
    (all of both after the first sweep), b, lo, hi and their tangents read,
    x and x' written, dep read once. Per row of a sweep: 6 flops for each
    column it sums (A_ij x_j, A'_ij x_j and A_ij x'_j, and their sums: i in
    the first sweep, n - 1 after), and about 30 for u, u', the bound scale
    and the clip's factors."""
    bsz, n = b.shape
    a_values = n * (n + 1) // 2 if iterations <= 1 else n * n
    n_bytes = b.element_size() * bsz * (2 * a_values + 8 * n) + 4 * n
    first = sum(6 * i + 30 for i in range(n))
    n_ops = bsz * (first + max(iterations - 1, 0) * n * (6 * (n - 1) + 30))
    bandwidth, f32_rate, f64_rate = card
    rate = f32_rate if b.dtype == torch.float32 else f64_rate
    return n_bytes / bandwidth * 1e3, n_ops / rate * 1e3, n_bytes, n_ops


def k1_jvp_case(operands, dep, it, card, gen, timing):
    """K1's forward-mode kernel against torch.func.jvp of the plain version
    on the same operands and random tangents (x and x'): raises past rtol
    1e-5 and atol 1e-6 max|x'| in float32, 1e-12 relative in float64; with
    ``timing`` its device time (median of 100 launches), the plain JVP's
    (event spans around single calls, the host's pace in them), the bound
    and the launch shape."""
    from tds_tpu_torch.contact import pgs

    b = operands[1]
    bsz, n = b.shape
    dep = tuple(dep)
    tangents = [torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device) for t in operands]
    want_x, want = pgs.solve_pgs_jvp_reference(*operands, tangents, dep, it)
    before = pgs.jvp_launches
    got_x, got = pgs._launch_jvp(*operands, *tangents, dep, it)
    torch.cuda.synchronize()
    if pgs.jvp_launches != before + 1:
        raise AssertionError("K1's JVP wrapper did not count its launch")
    rtol, atol = pgs_tol(b.dtype, n)
    x_over = ((got_x - want_x).abs() - (atol + rtol * want_x.abs())).max().item()
    scale = max(1.0, want.abs().max().item())
    rtol, atol = (1e-5, 1e-6 * scale) if b.dtype == torch.float32 else (1e-12, 1e-12 * scale)
    err = (got - want).abs()
    over = (err - (atol + rtol * want.abs())).max().item()
    if not bool(torch.isfinite(got).all()) or over > 0 or x_over > 0:
        raise AssertionError(f"K1's JVP disagrees with torch.func.jvp of the plain version at n={n} it={it} {b.dtype}: "
                             f"max |kernel - plain| {err.max().item():.3e} in x' (max |x'| {scale:.3e}), x over its "
                             f"tolerance by {x_over:.3e}")
    out = {"max_abs_err": err.max().item(), "margin": -over}
    if not timing:
        return out
    ms = device_ms(lambda: pgs._launch_jvp(*operands, *tangents, dep, it), rounds=5, per_round=20)
    plain_ms = span_ms(lambda: pgs.solve_pgs_jvp_reference(*operands, tangents, dep, it), reps=3)
    t_bytes, t_ops, n_bytes, n_ops = k1_jvp_bound(b, it, card)
    shape = pgs.launch_shape(b.dtype, n, bsz, jvp=True)
    log(f"forward mode (a): K1 JVP B={bsz} n={n} it={it} {str(b.dtype)[6:]} ({shape['form']}): {ms * 1e3:.2f} us on the "
        f"device, plain JVP (torch.func.jvp) {plain_ms * 1e3:.1f} us (event span, host-paced), bound "
        f"{max(t_bytes, t_ops) * 1e3:.3f} us ({n_bytes} bytes, {n_ops} flops), {ms / max(t_bytes, t_ops):.1f}x the bound; "
        f"max |kernel - plain| {err.max().item():.3e}")
    log_launch_shape(f"forward mode (a): K1 JVP B={bsz} n={n} {str(b.dtype)[6:]}", shape)
    out.update(ms=ms, plain_ms=plain_ms, plain_timing="event span, host-paced", bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", shape=f"B={bsz} n={n} iterations={it} {str(b.dtype)[6:]}",
               design=shape["form"], **launch_fields(shape))
    return out


def forward_mode_kernel(card):
    """(a): K1's forward-mode kernel against torch.func.jvp of the plain
    version at the paths' row counts and batches (GRAD_ROWS: all three
    forms), float32 and float64, 1 to 3 sweeps, with the ties of
    tests/test_torch_pgs_grad.py in envs 1 and 2; timed in float32 at one
    sweep."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    for n, batch in GRAD_ROWS:
        for dtype in (torch.float64, torch.float32):
            for it in (3, 2, 1):
                operands, dep = random_rows_problem(batch, n, dtype, gen)
                n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
                a, b = operands[0], operands[1]
                b[1, :n_c] = -10.0 * b[1, :n_c].abs() - 50.0 * a[1, :n_c, :n_c].abs().sum(-1) - 1.0
                b[2] = 0.0
                timing = dtype == torch.float32 and it == 1
                case = k1_jvp_case(operands, dep, it, card, gen, timing)
                if timing:
                    rows[n] = case
                else:
                    log(f"forward mode (a): K1 JVP random B={batch} n={n} it={it} {str(dtype)[6:]}: max |kernel - plain| "
                        f"{case['max_abs_err']:.3e}, margin {case['margin']:.3e} under the tolerance")
    return rows


def forward_mode_scan(card_line):
    """(b): torch.func.jacfwd of tools/contact_loss.py's loss over a 20-step
    laikago contact rollout (float64, batch 1, touching down at the first
    step) through graphs.scan on the card: a JVP graph of three tangents
    (K1's JVP kernel inside), its wrapper launches counted from 0 just
    before and read just after (the warm-up and the capture), the graph's
    nodes and capture seconds; equal within 1e-9 relative to the CPU's
    jacfwd and to jacrev on the card; K1's JVP kernels in a trace of a
    replayed call (one a step)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.tools import contact_loss
    from tds_tpu_torch.utils import graphs

    def loss_on(device):
        env = LaikagoEnv(dtype=torch.float64, device=device)
        q0, qd0, link = contact_loss.sliding_start(env, height=0.44)
        return contact_loss.make_loss(env, q0, qd0, link, FORWARD_STEPS), (env, q0, qd0, link)

    loss, (env, q0, qd0, link) = loss_on("cuda")
    cached = graphs.stats()
    pgs.launches = pgs.jvp_launches = 0
    card, first_s = timed_call(lambda: contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cuda"))
    launches, jvp_launches = pgs.launches, pgs.jvp_launches
    again, replay_s = timed_call(lambda: contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cuda"))
    if (pgs.launches, pgs.jvp_launches) != (launches, jvp_launches) or jvp_launches != 2 or not torch.equal(card, again):
        raise AssertionError(f"forward mode (b): K1's JVP launched {jvp_launches} times in the first jacfwd (expected the "
                             f"warm-up and the capture), {pgs.jvp_launches - jvp_launches} in a replay, or the replay differs")
    new = [g for g in graphs.stats() if g not in cached]
    jvp = [g for g in new if isinstance(g.key, tuple) and g.key[0] == "vmap" and g.key[1][0] == "jvp"]
    if len(jvp) != 1:
        raise AssertionError(f"forward mode (b): {len(jvp)} JVP graphs under vmap captured, expected one")
    g = jvp[0]
    rev, rev_s = timed_call(lambda: contact_loss.jacobian(loss, contact_loss.POINT, torch.float64, "cuda", forward=False))
    cpu, cpu_s = timed_call(lambda: contact_loss.jacobian(loss_on("cpu")[0], contact_loss.POINT, torch.float64, "cpu"))
    rel_cpu = ((card.cpu() - cpu).abs() / cpu.abs()).max().item()
    rel_rev = ((card - rev).abs() / rev.abs()).max().item()
    log(f"forward mode (b): jacfwd of the {FORWARD_STEPS}-step contact loss through graphs on the card (float64) "
        f"{[f'{v:.12e}' for v in card.tolist()]}: first call {first_s:.2f} s with the captures, replay {replay_s:.3f} s; "
        f"the JVP graph (3 tangents under vmap) {g.nodes} nodes, captured in {g.capture_s:.3f} s, instantiated in "
        f"{g.instantiate_s:.3f} s; K1 wrapper launches {launches}, K1 JVP wrapper launches {jvp_launches} (warm-up and "
        f"capture); against the CPU's jacfwd {[f'{v:.12e}' for v in cpu.tolist()]} ({cpu_s:.1f} s) largest relative "
        f"difference {rel_cpu:.2e}, against jacrev on the card ({rev_s:.2f} s) {rel_rev:.2e} (1e-9 each)")
    if not bool(torch.isfinite(card).all()) or rel_cpu > 1e-9 or rel_rev > 1e-9 or card.abs().min().item() == 0:
        raise AssertionError(f"forward mode (b): jacfwd {card.tolist()} against the CPU {cpu.tolist()} and jacrev {rev.tolist()}")
    # the same env's loss over fewer steps replays the same one-step graphs
    traced = contact_loss.make_loss(env, q0, qd0, link, FORWARD_TRACE_STEPS)
    with sub_phase(f"forward mode (b) seconds: the {FORWARD_TRACE_STEPS}-step trace"):
        _, _, _, count = counted_trace(lambda: contact_loss.jacobian(traced, contact_loss.POINT, torch.float64, "cuda"),
                                       "pgs_jvp", FORWARD_TRACE_STEPS)
    log(f"forward mode (b): a replayed {FORWARD_TRACE_STEPS}-step jacfwd ran K1's JVP kernel {count} times (torch.profiler)")
    if count != FORWARD_TRACE_STEPS:
        raise AssertionError(f"forward mode (b): {count} JVP kernels in {FORWARD_TRACE_STEPS} replayed JVP steps")
    return {"launches": jvp_launches, "jacfwd_card_vs_cpu_rel": rel_cpu, "jacfwd_vs_jacrev_rel": rel_rev,
            "jacfwd_first_s": first_s, "jacfwd_replay_s": replay_s, "jvp_graph_nodes": g.nodes,
            "jvp_graph_capture_s": g.capture_s, "jvp_graph_instantiate_s": g.instantiate_s,
            "replayed_launches_per_step": count / FORWARD_TRACE_STEPS}


@contextlib.contextmanager
def timed_stage(module, name, seconds):
    """Inside the block, ``module.name`` is wrapped to add the seconds each
    call takes (synchronised before and after) to ``seconds[name]``."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def ppo_recipe(card_line):
    """(c): examples/ppo_train.py's recipe on the ant in float32 (256 envs x
    128-step unrolls, 8 minibatches x 4 epochs, 64 x 64 tanh MLPs):
    PPO_ITERATIONS iterations from seed 0 with K1's wrapper launches
    counted from 0 just before and read just after, each iteration's
    seconds, its collect's (the scan of the unroll) and its fresh resets'
    (the auto-reset's R B envs settled ahead of the unroll); env-steps/s;
    K1 kernels in a trace of a PPO_TRACE_STEPS-step collect at the recipe's
    batch (one a collect step and one a settle step)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.learn import ppo

    env = AntEnv(dtype=torch.float32)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(64, 64))
    cfg = ppo.PPOConfig(num_envs=PPO_RECIPE["num_envs"], unroll_length=PPO_RECIPE["unroll"], num_minibatches=8, num_epochs=4,
                        init_log_std=-1.0)
    init_fn, step_fn = ppo.make_ppo(env, nets, cfg)
    state = init_fn(0)
    torch.cuda.synchronize()
    from tds_tpu_torch.utils import graphs

    cached = graphs.stats()
    pgs.launches = 0
    rows = []
    for _ in range(PPO_ITERATIONS):
        stages = {}
        with timed_stage(ppo, "collect", stages), timed_stage(ppo, "fresh_resets", stages):
            (state, metrics), seconds = timed_call(lambda: step_fn(state))
        rows.append((seconds, stages["collect"], stages["fresh_resets"], {k: v.item() for k, v in metrics.items()}))
    launches = pgs.launches
    check_wrapper_launches("PPO (c)", "PGS", launches, cached)
    for p in state.params.values():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("PPO (c): a parameter is not finite")
    steps = cfg.num_envs * cfg.unroll_length
    for i, (seconds, collect_s, reset_s, m) in enumerate(rows):
        log(f"PPO (c): iteration {i + 1} at the ant recipe (float32, {cfg.num_envs} envs x {cfg.unroll_length} steps): "
            f"{seconds:.3f} s{' with the captures' if i == 0 else ''}, collect {collect_s:.3f} s "
            f"({100 * collect_s / seconds:.1f}%, the fresh resets' {reset_s:.3f} s of it: {m['resets']:.0f} resets in the "
            f"unroll, at most {m['env_resets_max']:.0f} of one env, {m['reset_slots']:.0f} slots x {cfg.num_envs} envs "
            f"settled ahead), {steps / seconds:.1f} env-steps/s; "
            f"reward_mean "
            f"{m['reward_mean']:.4f}, episode_done_rate {m['episode_done_rate']:.4f}, value_mean {m['value_mean']:.4f}")
    seconds, collect_s, reset_s, _ = rows[-1]
    # the trace: a collect of PPO_TRACE_STEPS steps at the recipe's batch,
    # from draws with a reset slot for each step (no env can run out, and
    # so no retry collects twice), so that its K1 count is known: a trace of
    # the whole iteration (513,256 device operations) took 47.3 s on an H100
    short = cfg._replace(unroll_length=PPO_TRACE_STEPS)
    draws = ppo.draw_iteration(env, short, state.generator, torch.float32, reset_slots=PPO_TRACE_STEPS)
    with sub_phase("PPO (c) seconds: the traced collect"):
        profile = device_profile(lambda: ppo.collect(env, nets, short, state, draws), calls=1, kernel="pgs_kernel",
                                 expected=PPO_TRACE_STEPS + env.settle_steps)
    if profile is None:
        raise AssertionError("PPO (c): the profiler saw no device activity in a collect")
    ops, busy, wall, count = profile
    log(f"PPO (c): a traced {PPO_TRACE_STEPS}-step collect at batch {cfg.num_envs} (with its fresh resets' "
        f"{env.settle_steps} settle steps): {ops:.0f} device operations, device busy {busy:.3f} of {wall:.3f} ms wall "
        f"({100 * (1 - busy / wall):.1f}% idle), K1 {count:.0f} times; K1 wrapper launches over {PPO_ITERATIONS} "
        f"iterations {launches} (warm-ups and captures)")
    if count != PPO_TRACE_STEPS + env.settle_steps:
        raise AssertionError(f"PPO (c): {count} K1 kernels in a collect of {PPO_TRACE_STEPS} steps and "
                             f"{env.settle_steps} settle steps")
    bench_line("ppo_ant_env_steps_per_s", steps / seconds, "steps/s", card_line, num_envs=cfg.num_envs,
               unroll=cfg.unroll_length, iteration_s=seconds)
    return {"ppo_iteration_s": [r[0] for r in rows], "ppo_collect_s": [r[1] for r in rows],
            "ppo_fresh_resets_s": [r[2] for r in rows], "ppo_env_steps_per_s": steps / seconds, "ppo_launches": launches,
            "ppo_collect_device_ops": ops, "ppo_collect_idle_share": 1 - busy / wall, "ppo_collect_trace_k1": count}


def ppo_checkpoints_walk():
    """(d): logs/ant_ppo/policy.pkl and policy_anneal.pkl.final replayed on
    the card in float32 for 1000 steps through graphs, in one batch of 8:
    the JAX test's four starts (tests/golden/ant_ppo_policy_reset_noise.json),
    held to tests/test_ppo_ant_policy.py's thresholds, and four starts
    drawn from torch.Generators seeded 0, 7, 123 and 42, reported."""
    from tds_tpu_torch.convert import ppo_from_checkpoint
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.learn.ppo import PPONetworks
    from tds_tpu_torch.tools.ppo_train import policy_rollout

    env = AntEnv(dtype=torch.float32)
    golden = torch.tensor(json.loads(ANT_PPO_RESET_NOISE.read_text())["noise"], dtype=torch.float32, device="cuda")
    drawn = torch.cat([env.draw_reset_noise(torch.Generator(device="cuda").manual_seed(s), 1) for s in (0, 7, 123, 42)])
    out = {}
    for name, x_min, mean_min, survivors in (("policy.pkl", 4.0, 8.0, 2), ("policy_anneal.pkl.final", 8.0, 0.0, 4)):
        params, stat, hidden, _ = ppo_from_checkpoint(REPO / "logs" / "ant_ppo" / name, device="cuda")
        nets = PPONetworks(env.observation_dim, env.action_dim, hidden=(hidden, hidden))
        state, obs = env.reset(noise=torch.cat([golden, drawn]))
        (_, steps, x), seconds = timed_call(lambda: policy_rollout(env, nets, params, stat, state, obs, ANT_PPO_STEPS))
        dx, steps = (x - state.q[:, 0]).tolist(), steps.tolist()
        jax_dx, jax_steps = dx[:4], steps[:4]
        passed = min(jax_dx) > x_min and sum(jax_dx) / 4 > mean_min and sum(s >= 900 for s in jax_steps) >= survivors
        drawn_ok = min(dx[4:]) > x_min and sum(s >= 900 for s in steps[4:]) >= survivors
        log(f"PPO (d): {name}, {ANT_PPO_STEPS} steps through graphs in {seconds:.2f} s: from the JAX test's starts dx "
            f"{[round(v, 3) for v in jax_dx]} m, steps {[int(s) for s in jax_steps]} (each > {x_min} m, mean > {mean_min} m, "
            f">= {survivors} of 4 alive 900 steps); from torch.Generator starts 0, 7, 123, 42 dx {[round(v, 3) for v in dx[4:]]} m, "
            f"steps {[int(s) for s in steps[4:]]} ({'within' if drawn_ok else 'NOT within'} the same thresholds, reported)")
        if not passed:
            raise AssertionError(f"PPO (d): {name} fails tests/test_ppo_ant_policy.py's thresholds on the card")
        out[name] = {"jax_starts_dx": jax_dx, "jax_starts_steps": jax_steps, "generator_starts_dx": dx[4:],
                     "generator_starts_steps": steps[4:]}
    return out


def ppo_card_against_cpu():
    """(e): one float64 PPO iteration on the ant (4 envs, 8-step unroll, 2
    epochs of 2 minibatches, the anneal on, env 0 started below the done
    height so that it resets in the unroll) on the card through graphs and
    K1, against the CPU's from the same draws: params, Adam's moments, the
    envs' states, the statistics and the metrics within 1e-9 relative."""
    from tds_tpu_torch.envs.ant import AntEnv
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.learn import ppo

    cfg = ppo.PPOConfig(num_envs=4, unroll_length=8, num_minibatches=2, num_epochs=2, learning_rate=1e-3,
                        lr_anneal_iterations=5, init_log_std=-1.0)
    cpu_env = AntEnv(dtype=torch.float64, device="cpu")
    start, _ = cpu_env.reset(torch.Generator().manual_seed(1), batch_size=cfg.num_envs)
    q = start.q.clone()
    q[0, 2] = 0.2
    draws = ppo.draw_iteration(cpu_env, cfg, torch.Generator().manual_seed(2), torch.float64)
    results = []
    for device in ("cuda", "cpu"):
        env = AntEnv(dtype=torch.float64, device=device)
        nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(16, 16))
        state = ppo.make_ppo(env, nets, cfg)[0](0)
        state = state._replace(env_state=EnvState(q.to(device), start.qd.to(device), start.t.to(device)),
                               obs=cpu_env.observation(q, start.qd).to(device))
        new, metrics = ppo.ppo_iteration(env, nets, cfg, state, draws.to(device))
        flat = [new.params[k] for k in ("policy", "value", "log_std")] + [new.opt_state.mu[k] for k in ("policy", "value")]
        flat += [new.env_state.q, new.env_state.qd, new.obs, *new.obs_stat, *metrics.values()]
        results.append([t.cpu() for t in flat])
    worst = max(((g - w).abs() / w.abs().clamp_min(1.0)).max().item() for g, w in zip(*results))
    resets = int(results[1][-1])
    log(f"PPO (e): one float64 ant iteration ({cfg.num_envs} envs x {cfg.unroll_length} steps, {resets} auto-resets in the "
        f"unroll) on the card against the CPU from the same draws: largest difference {worst:.3e} relative (abs below 1) "
        f"over params, Adam's moments, states, statistics and metrics (1e-9)")
    if worst > 1e-9 or resets < 1:
        raise AssertionError(f"PPO (e): the card's iteration differs from the CPU's by {worst:.3e}, or no env reset")
    return {"ppo_float64_card_against_cpu": worst}


def phase_forward_and_ppo(card, card_line):
    """Phase 15: forward mode and PPO on the card. Returns K1's JVP entry of
    the kernels line and PPO's numbers."""
    with sub_phase("forward mode (a) seconds"):
        rows = forward_mode_kernel(card)
    with sub_phase("forward mode (b) seconds"):
        path = forward_mode_scan(card_line)
    with sub_phase("PPO (c) seconds"):
        numbers = ppo_recipe(card_line)
    with sub_phase("PPO (d) seconds"):
        numbers["ppo_checkpoints"] = ppo_checkpoints_walk()
    with sub_phase("PPO (e) seconds"):
        numbers.update(ppo_card_against_cpu())
    main = rows[12]
    entry = {
        "name": "pgs jvp",
        "route": "cuda",
        "source": "tds_tpu_torch/csrc/pgs.cu",
        "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel; its forward mode is jax.jvp of tds_tpu/contact/mlcp.py:94 solve_pgs)",
        "launches": path["launches"],
        "library_ms": None,
        "main_path": f"jacfwd of the {FORWARD_STEPS}-step laikago contact loss through graphs (b)",
        **{k: v for k, v in main.items() if k != "margin"},
        "row_counts": [{"rows": n, **{k: v for k, v in case.items() if k != "margin"}} for n, case in sorted(rows.items()) if n != 12],
        **{f"path_{k}": v for k, v in path.items() if k != "launches"},
    }
    log(f"forward mode: {json.dumps({k: v for k, v in entry.items() if k != 'row_counts'})}")
    log(f"PPO: {json.dumps(numbers)}")
    return entry, numbers


# -- phase 16 --------------------------------------------------------------
def floating_device_vs_cpu():
    """(a): CARD_CPU_STEPS float64 steps of the floating laikago at batch 8 on the card
    (K1, n = 12) against the CPU from a start 3 cm lower than the env's
    (the toes touch from the first steps), with seeded actions, within 1e-9
    abs + rel; one K1 launch a step. Returns the largest difference."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    batch, steps, tol, start = 8, CARD_CPU_STEPS, 1e-9, (0.0, 0.0, 0.45)
    cpu_env = LaikagoEnv(urdf=FLOATING_URDF, is_floating=True, dtype=torch.float64, device="cpu", start_base_position=start)
    gpu_env = LaikagoEnv(urdf=FLOATING_URDF, is_floating=True, dtype=torch.float64, start_base_position=start)
    gen = torch.Generator(device="cpu").manual_seed(16)
    actions = (torch.rand(steps, batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qc, qdc = cpu_env.initial_state(batch_size=batch)
    qg, qdg = gpu_env.initial_state(batch_size=batch)
    before, worst, active = pgs.launches, 0.0, []
    for t in range(steps):
        qc, qdc = cpu_env.sim_step(qc, qdc, actions[t])
        with recorded_pgs_calls() as calls:
            qg, qdg = gpu_env.sim_step(qg, qdg, actions[t].cuda())
        active.append(int((calls[0][1] != 0).sum()))
        for got, expected in ((qg.cpu(), qc), (qdg.cpu(), qdc)):
            worst = max(worst, (got - expected).abs().max().item())
            if ((got - expected).abs() - tol * (1 + expected.abs())).max().item() > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"floating (a): the card and the CPU differ beyond {tol} at step {t + 1}")
    if pgs.launches - before != steps or active[0] == 0:
        raise AssertionError(f"floating (a): {pgs.launches - before} K1 launches in {steps} steps, {active[0]} rows active "
                             "in the first")
    log(f"floating (a): {steps} float64 floating-laikago sim_steps at batch {batch}: max |cuda - cpu| = {worst:.3e} (tolerance "
        f"{tol} abs + rel), {steps} K1 launches, {min(active)} to {max(active)} of {calls[0][1].numel()} contact rows active "
        "per step")
    return worst


def floating_golden():
    """(a): tests/golden/laikago_floating_contact_trajectory.json on the card
    in float64 under ``reference_base_abi_quirk``: 500 steps of the zero
    action in ``graphs.scan`` between the snapshots, 1e-8 to step 100 and
    1e-6 after (tests/test_golden_reference.py's); then 100 steps of the
    same scan outside the quirk, a graph of its own (the switch is in the
    signature), whose distance from the golden is printed."""
    from tds_tpu_torch.dynamics.forward_dynamics import reference_base_abi_quirk
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.utils import graphs

    env = LaikagoEnv(urdf=FLOATING_URDF, is_floating=True, dtype=torch.float64)
    golden = json.loads(FLOATING_GOLDEN.read_text())
    snaps = golden["snapshots"]
    start = tuple(torch.tensor([snaps["0"][k]], dtype=torch.float64, device="cuda") for k in ("q", "qd"))
    zero = (torch.zeros(1, env.action_dim, dtype=torch.float64, device="cuda"),)

    def body(carry, consts):
        return env.sim_step(*carry, *consts)

    key = ("floating golden", env)
    worst, carry, done = 0.0, start, 0
    with reference_base_abi_quirk():
        for t in sorted(int(k) for k in snaps if k != "0"):
            carry = graphs.scan(body, carry, zero, t - done, key=key)
            done = t
            tol = 1e-8 if t <= 100 else 1e-6
            for got, name in zip(carry, ("q", "qd")):
                want = torch.tensor(snaps[str(t)][name], dtype=torch.float64)
                err = (got[0].cpu() - want).abs()
                worst = max(worst, err.max().item())
                if (err - tol * (1 + want.abs())).max().item() > 0:
                    raise AssertionError(f"floating (a): the golden's {name} differs by {err.max().item():.3e} at step {t}")
    plain = graphs.scan(body, start, zero, 100, key=key)
    off = max((got[0].cpu() - torch.tensor(snaps["100"][n], dtype=torch.float64)).abs().max().item()
              for got, n in zip(plain, ("q", "qd")))
    entries = [g for g in graphs.stats() if g.key == key]
    if len(entries) != 2:
        raise AssertionError(f"floating (a): {len(entries)} graphs for the golden's scan, expected one with the quirk and one without")
    log(f"floating (a): laikago_floating_contact_trajectory.json, {done} steps through graphs under the quirk on the card: "
        f"max |card - golden| {worst:.3e} over the snapshots (1e-8 to step 100, 1e-6 after); without the quirk (a graph of "
        f"its own, {entries[1].nodes} nodes) step 100 lies {off:.3e} from the golden")
    return worst, off


def floating_rollout(card, card_line, fixed_rate):
    """(b): the floating laikago in float32 at batch 4096: reset and a
    ROLLOUT_STEPS-step rollout of the zero linear policy through graphs with
    K1's wrapper launches counted from 0 just before and read just after
    (the warm-ups and captures), every env alive at 0.3 < z < 0.6; bench.py's
    1000-step rollout timed once (``laikago_floating_scan_rollout_env_steps_per_s``,
    beside phase 5's fixed-base figure), K1 in a trace of PROFILE_STEPS
    replayed steps (one a step), and K1 against its plain version on the
    operands of a step of this rollout (n = 12), timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout
    from tds_tpu_torch.utils import graphs

    env = LaikagoEnv(urdf=FLOATING_URDF, is_floating=True, dtype=torch.float32)
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    (state0, obs0), reset_s = timed_call(lambda: env.reset(gen, batch_size=MAIN_BATCH))
    (state, _, _, alive), first_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, ROLLOUT_STEPS))
    launches = pgs.launches
    check_wrapper_launches("floating (b)", "PGS", launches, cached)
    z = state.q[:, 6]
    if not bool(alive.all()) or not bool(((z > 0.3) & (z < 0.6)).all()) or not bool(torch.isfinite(state.q).all()):
        raise AssertionError(f"floating (b): the zero policy should stand: {int(alive.sum())}/{MAIN_BATCH} alive, z in "
                             f"[{z.min():.3f}, {z.max():.3f}]")
    (final, _, _, alive), bench_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, LAIKAGO_BENCH_STEPS))
    if not bool(alive.all()) or not bool(torch.isfinite(final.q).all()):
        raise AssertionError(f"floating (b): {int(alive.sum())}/{MAIN_BATCH} alive after {LAIKAGO_BENCH_STEPS} steps")
    rate = MAIN_BATCH * LAIKAGO_BENCH_STEPS / bench_s
    bench_line("laikago_floating_scan_rollout_env_steps_per_s", rate, "steps/s", card_line, batch=MAIN_BATCH,
               steps=LAIKAGO_BENCH_STEPS, seconds=bench_s, fixed_base_env_steps_per_s=fixed_rate)
    found = graph_lines("floating (b)", env, "rollout")
    log(f"floating (b): reset ({env.settle_steps} settle steps, graphs) in {reset_s * 1e3:.1f} ms; {ROLLOUT_STEPS} steps "
        f"through graphs {first_s:.3f} s with the captures; the {LAIKAGO_BENCH_STEPS}-step rollout {bench_s:.3f} s = "
        f"{bench_s * 1e3 / LAIKAGO_BENCH_STEPS:.3f} ms/step, {rate:.1f} env-steps/s against the fixed base's {fixed_rate:.1f} "
        f"(phase 5), {card_line}; K1 wrapper launches {launches} (warm-ups and captures); z after {LAIKAGO_BENCH_STEPS} "
        f"steps in [{final.q[:, 6].min():.3f}, {final.q[:, 6].max():.3f}]")
    with sub_phase(f"floating (b) seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: rollout(env, policy, None, state0, obs0, PROFILE_STEPS), calls=1,
                                 kernel="pgs_kernel", expected=PROFILE_STEPS)
    if profile is None:
        raise AssertionError("floating (b): the profiler saw no device activity in the replayed rollout")
    ops, busy, wall, k1 = profile
    if k1 != PROFILE_STEPS:
        raise AssertionError(f"floating (b): {k1} K1 kernels in {PROFILE_STEPS} replayed steps")
    log(f"floating (b): graph replays: {ops / PROFILE_STEPS:.0f} device operations per step, K1 {k1:.0f} times in "
        f"{PROFILE_STEPS} replayed steps (torch.profiler), device busy {busy / PROFILE_STEPS:.3f} of {wall / PROFILE_STEPS:.3f} "
        f"ms/step under the profiler ({100 * (1 - busy / wall):.1f}% idle)")
    a, b, lo, hi, dep, it = harvest_pgs_operands(env, gen, ROLLOUT_STEPS, "floating laikago", "floating (b)")
    if tuple(b.shape) != (MAIN_BATCH, 12):
        raise AssertionError(f"floating (b): the floating laikago's MLCP has shape {tuple(b.shape)}")
    err, margin = k1_against_plain("the floating laikago step", [a, b, lo, hi], dep, it)
    log(f"floating (b): K1 on the floating laikago step B={b.shape[0]} n=12: max |kernel - plain| = {err:.3e} (margin left "
        f"{margin:.3e})")
    timing = k1_timing("floating laikago step", [a, b, lo, hi], dep, it, card, prefix="floating (b)")
    return {"launches": launches, "max_abs_err": err, **timing, "replayed_launches_per_step": k1 / PROFILE_STEPS,
            "laikago_floating_scan_rollout_env_steps_per_s": rate, "ms_per_step": bench_s * 1e3 / LAIKAGO_BENCH_STEPS,
            "graph_nodes": [g.nodes for g in found], "device_ops": ops / PROFILE_STEPS, "idle": 1 - busy / wall,
            "main_path": "the floating laikago's rollout (phase 16 (b))"}


def sphere_world(dtype, device):
    """tests/test_golden_reference.py's sphere: a floating ball of 1.5 kg,
    inertia 0.024, radius 0.2, on the plane with the default solver."""
    import numpy as np

    from tds_tpu_torch.model.geometry import GeomAttachment, Sphere
    from tds_tpu_torch.model.multibody import MultiBodyBuilder
    from tds_tpu_torch.world import build_world, make_ground_plane

    b = MultiBodyBuilder(is_floating=True, name="golden_sphere")
    b.set_base_inertia(1.5, (0, 0, 0), np.diag([0.024] * 3))
    ball = b.finalize(dtype=dtype, device=device)
    return build_world([make_ground_plane(dtype=dtype, device=device), (ball, (GeomAttachment(link_index=-1, shape=Sphere(0.2)),))])


def balls(card):
    """(c): sphere_contact_trajectory.json through ``world_rollout`` (world_step
    in graphs.scan) on the card in float64, at the golden's tolerances; then
    BALL_BATCH balls of tools/ball_loss.py's world (4 PGS sweeps) dropped
    from 0.1-0.5 m with random spins and slides, BALL_STEPS float32 steps
    through graphs with K1's wrapper launches counted from 0 just before and
    read just after, none through the floor, K1 (n = 3) once a replayed
    step in a trace, and K1 against its plain version on the operands of a
    step of this drop, timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import ball_loss
    from tds_tpu_torch.utils import graphs
    from tds_tpu_torch.world import world_rollout, world_step

    world = sphere_world(torch.float64, "cuda")
    golden = json.loads(SPHERE_GOLDEN.read_text())
    snaps, dt = golden["snapshots"], golden["dt"]
    ground = torch.zeros(1, 0, dtype=torch.float64, device="cuda")
    qs = (ground, torch.tensor([snaps["0"]["q"]], dtype=torch.float64, device="cuda"))
    qds = (ground, torch.tensor([snaps["0"]["qd"]], dtype=torch.float64, device="cuda"))
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=torch.float64, device="cuda")
    worst, done = 0.0, 0
    for t in sorted(int(k) for k in snaps if k != "0"):
        qs, qds = world_rollout(world, qs, qds, gravity, dt, t - done)
        done = t
        tol = 1e-8 if t <= 100 else 1e-6
        for got, name in ((qs[1], "q"), (qds[1], "qd")):
            want = torch.tensor(snaps[str(t)][name], dtype=torch.float64)
            err = (got[0].cpu() - want).abs()
            worst = max(worst, err.max().item())
            if (err - tol * (1 + want.abs())).max().item() > 0:
                raise AssertionError(f"balls (c): the sphere golden's {name} differs by {err.max().item():.3e} at step {t}")
    if qs[0].shape != (1, 0) or qds[0].shape != (1, 0):
        raise AssertionError("balls (c): the ground's (B, 0) state changed shape in the scan")
    log(f"balls (c): sphere_contact_trajectory.json, {done} float64 steps of world_step through graphs on the card: max "
        f"|card - golden| {worst:.3e} (1e-8 to step 100, 1e-6 after); the ground's (1, 0) q and qd carried through")
    world = ball_loss.ball_world(dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ball = world.bodies[1]
    q0 = ball.zero_q((BALL_BATCH,))
    q0[:, 6] = 0.1 + 0.4 * torch.rand(BALL_BATCH, generator=gen, device="cuda")
    qd0 = torch.randn(BALL_BATCH, 6, generator=gen, device="cuda")
    qd0[:, 5] = 0.0
    ground = torch.zeros(BALL_BATCH, 0, device="cuda")
    gravity = torch.tensor((0.0, 0.0, -9.81), device="cuda")
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    (qs, qds), first_s = timed_call(lambda: world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, BALL_STEPS))
    launches = pgs.launches
    check_wrapper_launches("balls (c)", "PGS", launches, cached)
    z = qs[1][:, 6]
    if not bool(torch.isfinite(qs[1]).all()) or z.min().item() < ball_loss.RADIUS - 0.01:
        raise AssertionError(f"balls (c): a ball is not finite or fell through the floor: z >= {z.min().item():.4f}")
    _, replay_s = timed_call(lambda: world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, BALL_STEPS))
    found = [g for g in graphs.stats() if isinstance(g.key, tuple) and g.key[0] == "world_rollout" and g.key[1] is world]
    with sub_phase(f"balls (c) seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, PROFILE_STEPS),
                                 calls=1, kernel="pgs_kernel", expected=PROFILE_STEPS)
    if profile is None or profile[3] != PROFILE_STEPS:
        raise AssertionError(f"balls (c): K1 ran {None if profile is None else profile[3]} times in {PROFILE_STEPS} replayed steps")
    ops, busy, wall, k1 = profile
    log(f"balls (c): {BALL_BATCH} balls dropped for {BALL_STEPS} float32 steps through graphs: {first_s:.3f} s with the "
        f"captures, replayed {replay_s * 1e3 / BALL_STEPS:.3f} ms/step = {BALL_BATCH * BALL_STEPS / replay_s:.1f} ball-steps/s; "
        f"graph {[g.nodes for g in found]} nodes, {ops / PROFILE_STEPS:.0f} device operations and K1 {k1 / PROFILE_STEPS:.0f} "
        f"a replayed step, {100 * (1 - busy / wall):.1f}% idle under the profiler; K1 wrapper launches {launches} (warm-ups "
        f"and captures); z in [{z.min():.4f}, {z.max():.4f}]")
    # the operands of one eager step of the drop, 200 steps in
    mid = world_rollout(world, (ground, q0), (ground, qd0), gravity, ball_loss.DT, 200)
    with recorded_pgs_calls() as calls:
        world_step(world, *mid, None, gravity, ball_loss.DT)
    a, b, lo, hi, dep, it = calls[0]
    active = int((b != 0).sum())
    if tuple(b.shape) != (BALL_BATCH, 3) or active == 0:
        raise AssertionError(f"balls (c): the drop's MLCP has shape {tuple(b.shape)}, {active} rows active")
    err, margin = k1_against_plain("the ball drop", [a, b, lo, hi], dep, it)
    log(f"balls (c): K1 on the ball drop's step 201 B={BALL_BATCH} n=3 it={it}: {active} of {b.numel()} rows active, max "
        f"|kernel - plain| = {err:.3e} (margin left {margin:.3e})")
    timing = k1_timing("ball drop step", [a, b, lo, hi], dep, it, card, prefix="balls (c)")
    return {"launches": launches, "max_abs_err": err, **timing, "replayed_launches_per_step": k1 / PROFILE_STEPS,
            "ms_per_step": replay_s * 1e3 / BALL_STEPS, "graph_nodes": [g.nodes for g in found],
            "sphere_golden_max_abs": worst, "main_path": f"{BALL_BATCH} balls through world_rollout (phase 16 (c))"}, (a, b, lo, hi, dep, it)


def ball_gradient(card, operands):
    """(d): tools/ball_loss.py's BALL_LOSS_STEPS-step loss on the card in
    float64 through ``world_rollout``: its gradient with respect to the
    initial velocity, the scan's VJP graph replayed (K1's backward at n = 3
    inside), K1's backward wrapper launches counted from 0 just before and
    read just after (the VJP graph's warm-up and capture), within 1e-9
    abs + rel of the CPU's; one backward kernel a replayed VJP step in a
    trace of a GRAD_PROFILE_STEPS-step gradient; K1's backward against the
    plain version's autograd on (c)'s float32 operands, timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import ball_loss

    shots = torch.tensor([ball_loss.VELOCITY, (1.2, -0.6)], dtype=torch.float64)
    world = ball_loss.ball_world()
    torch.cuda.synchronize()
    pgs.backward_launches = 0
    (value, grad), grad_s = timed_call(lambda: ball_loss.gradient(world, shots.cuda(), BALL_LOSS_STEPS))
    launches = pgs.backward_launches
    cpu_value, cpu_grad = ball_loss.gradient(ball_loss.ball_world(device="cpu"), shots, BALL_LOSS_STEPS)
    err = max((value.cpu() - cpu_value).abs().max().item(), (grad.cpu() - cpu_grad).abs().max().item())
    over = max(((value.cpu() - cpu_value).abs() - 1e-9 * (1 + cpu_value.abs())).max().item(),
               ((grad.cpu() - cpu_grad).abs() - 1e-9 * (1 + cpu_grad.abs())).max().item())
    if over > 0 or launches != 2 or grad.abs().min().item() == 0:
        raise AssertionError(f"ball (d): the card's gradient {grad.tolist()} against the CPU's {cpu_grad.tolist()}, or "
                             f"{launches} backward launches (2 expected: the VJP graph's warm-up and capture)")
    log(f"ball (d): the {BALL_LOSS_STEPS}-step ball loss {value.tolist()} on the card (float64, 2 shots): d loss / d (vx, vy) "
        f"{[[f'{v:.12e}' for v in row] for row in grad.tolist()]} in {grad_s:.2f} s with the captures, the CPU's "
        f"{[[f'{v:.12e}' for v in row] for row in cpu_grad.tolist()]}: max |card - cpu| {err:.3e} (1e-9 abs + rel); K1 "
        f"backward wrapper launches {launches} (the VJP graph's warm-up and capture)")
    with sub_phase(f"ball (d) seconds: the {GRAD_PROFILE_STEPS}-step trace"):
        ball_loss.gradient(world, shots.cuda(), GRAD_PROFILE_STEPS)
        _, _, _, count = counted_trace(lambda: ball_loss.gradient(world, shots.cuda(), GRAD_PROFILE_STEPS), "pgs_backward",
                                       GRAD_PROFILE_STEPS)
    if count != GRAD_PROFILE_STEPS:
        raise AssertionError(f"ball (d): {count} backward kernels in {GRAD_PROFILE_STEPS} replayed VJP steps")
    log(f"ball (d): a replayed {GRAD_PROFILE_STEPS}-step gradient ran K1's backward kernel {count} times (torch.profiler)")
    a, b, lo, hi, dep, it = operands
    case = k1_backward_case("ball drop step", [a, b, lo, hi], dep, it, card, torch.Generator(device="cuda").manual_seed(16),
                            prefix="ball (d)")
    return {"launches": launches, **{k: v for k, v in case.items() if k != "margin"}, "replayed_launches_per_step": count / GRAD_PROFILE_STEPS,
            "card_vs_cpu_max_abs": err, "gradient_s": grad_s,
            "main_path": f"the {BALL_LOSS_STEPS}-step ball loss's gradient through world_rollout's VJP graph (phase 16 (d))"}


def phase_floating(card, card_line, fixed_rate):
    """Phase 16: floating bases on the card. Returns the kernels line's
    entries of K1 on the floating laikago (n = 12), on the balls (n = 3)
    and K1's backward under the ball loss (n = 3), and the numbers."""
    numbers = {}
    with sub_phase("floating (a) seconds"):
        numbers["floating_float64_card_vs_cpu"] = floating_device_vs_cpu()
        numbers["floating_golden_max_abs"], numbers["floating_golden_without_quirk_step100"] = floating_golden()
    with sub_phase("floating (b) seconds"):
        laikago = floating_rollout(card, card_line, fixed_rate)
    with sub_phase("balls (c) seconds"):
        drop, operands = balls(card)
    with sub_phase("ball (d) seconds"):
        backward = ball_gradient(card, operands)
    common = {"route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu", "library_ms": None}
    entries = [
        {"name": "pgs n=12 floating", **common, "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", **laikago},
        {"name": "pgs n=3", **common, "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", **drop},
        {"name": "pgs backward n=3", **common,
         "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel; its gradient is jax.grad of tds_tpu/contact/mlcp.py:94 solve_pgs)",
         **backward},
    ]
    for entry in entries:
        log(f"floating: {json.dumps(entry)}")
    log(f"floating: {json.dumps(numbers)}")
    return entries, numbers


# -- phase 17 --------------------------------------------------------------
def mpc_device_vs_cpu():
    """(a): the MPC walk (tools/mpc_walk.py's build) in float64 at batch
    MPC_CHECK_BATCH for MPC_CHECK_TICKS ticks through graphs on the card
    against the same ticks on the CPU, from the CPU's reset, within 1e-9 abs
    + rel on q and qd after every tick and on the controller's torques at
    the start and the end. Returns the largest difference."""
    from tds_tpu_torch.control.mpc.locomotion import make_walk_step
    from tds_tpu_torch.tools.mpc_walk import build

    tol = 1e-9
    cpu_env, cpu_ctrl = build(dtype=torch.float64, device="cpu")
    gpu_env, gpu_ctrl = build(dtype=torch.float64)
    step_c, step_g = make_walk_step(cpu_env, cpu_ctrl, MPC_CONTROL_EVERY), make_walk_step(gpu_env, gpu_ctrl, MPC_CONTROL_EVERY)
    state, _ = cpu_env.reset(torch.Generator().manual_seed(17), batch_size=MPC_CHECK_BATCH)
    carry_c = (cpu_ctrl.init_state(state.q), state.q, state.qd)
    carry_g = (gpu_ctrl.init_state(state.q.cuda()), state.q.cuda(), state.qd.cuda())
    worst = {"q": 0.0, "qd": 0.0, "tau": 0.0}

    def check(name, got, want, when):
        err = (got.cpu() - want).abs()
        worst[name] = max(worst[name], err.max().item())
        if (err - tol * (1 + want.abs())).max().item() > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"mpc (a): the card's {name} differs from the CPU's by {err.max().item():.3e} {when}")

    def torques(when):
        tau_c = cpu_ctrl.update(*carry_c)[1]
        tau_g = gpu_ctrl.update(*carry_g)[1]
        check("tau", tau_g, tau_c, when)
        return tau_c

    tau0 = torques("at the start")
    for t in range(MPC_CHECK_TICKS):
        carry_g = step_g(carry_g)  # the card's replay runs while the CPU steps
        carry_c = step_c(carry_c)
        for name, got, want in (("q", carry_g[1], carry_c[1]), ("qd", carry_g[2], carry_c[2])):
            check(name, got, want, f"after tick {t + 1}")
    tau1 = torques(f"after {MPC_CHECK_TICKS} ticks")
    log(f"mpc (a): the MPC walk in float64 at batch {MPC_CHECK_BATCH}, {MPC_CHECK_TICKS} ticks x {MPC_CONTROL_EVERY} substeps "
        f"through graphs on the card against the CPU: max |cuda - cpu| q {worst['q']:.3e}, qd {worst['qd']:.3e}, tau "
        f"{worst['tau']:.3e} (|tau| up to {max(tau0.abs().max().item(), tau1.abs().max().item()):.1f}; tolerance {tol} abs + rel)")
    return max(worst.values())


def env_device_vs_cpu(label, steps=CARD_CPU_STEPS, **kwargs):
    """(a): ``steps`` float64 laikago sim_steps at batch 8 under a seeded
    action held through the run, from a start 3 cm lower than the env's
    (the toes touch from the first step): on the card through
    ``graphs.scan``, 10 steps a call, against the CPU's loop, within 1e-9
    abs + rel after every 10; ``kwargs`` pick the contact option. Returns
    the largest difference."""
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.utils import graphs

    batch, tol, start, chunk = 8, 1e-9, (0.0, 0.0, 0.45), 10
    cpu_env = LaikagoEnv(dtype=torch.float64, device="cpu", start_base_position=start, **kwargs)
    gpu_env = LaikagoEnv(dtype=torch.float64, start_base_position=start, **kwargs)
    gen = torch.Generator(device="cpu").manual_seed(170)
    action = (torch.rand(batch, cpu_env.action_dim, generator=gen, dtype=torch.float64) - 0.5) * 0.8
    qc, qdc = cpu_env.initial_state(gen, batch_size=batch)
    carry = (qc.cuda(), qdc.cuda())

    def body(c, consts):
        return gpu_env.sim_step(*c, *consts)

    worst = 0.0
    for t in range(chunk, steps + 1, chunk):
        carry = graphs.scan(body, carry, (action.cuda(),), chunk, key=("card against cpu", gpu_env))
        for _ in range(chunk):
            qc, qdc = cpu_env.sim_step(qc, qdc, action)
        for got, expected in ((carry[0].cpu(), qc), (carry[1].cpu(), qdc)):
            worst = max(worst, (got - expected).abs().max().item())
            if ((got - expected).abs() - tol * (1 + expected.abs())).max().item() > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"{label}: the card and the CPU differ beyond {tol} at step {t}")
    log(f"{label}: {steps} float64 laikago sim_steps at batch {batch} ({kwargs}) through graphs on the card against the CPU: "
        f"max |cuda - cpu| = {worst:.3e} (tolerance {tol} abs + rel)")
    return worst


def crba_against_aba():
    """(a): one float64 contact step of the laikago at batch 8 on the card
    under minv_method="crba" against "aba" (the same M^-1 by other means)
    within 1e-10 abs + rel, from a state with its toes on the ground."""
    from tds_tpu_torch.contact.mlcp import ContactSolverParams
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    start = (0.0, 0.0, 0.45)
    aba = LaikagoEnv(dtype=torch.float64, start_base_position=start)
    crba = LaikagoEnv(dtype=torch.float64, start_base_position=start, solver=ContactSolverParams(minv_method="crba"))
    q, qd = aba.initial_state(torch.Generator(device="cuda").manual_seed(171), batch_size=8)
    zero = torch.zeros(8, aba.action_dim, dtype=torch.float64, device="cuda")
    for _ in range(5):
        q, qd = aba.sim_step(q, qd, zero)
    with recorded_pgs_calls() as calls:
        qa, qda = aba.sim_step(q, qd, zero)
        qc, qdc = crba.sim_step(q, qd, zero)
    active = int((calls[0][1] != 0).sum())
    err = max((qa - qc).abs().max().item(), (qda - qdc).abs().max().item())
    over = max(((qc - qa).abs() - 1e-10 * (1 + qa.abs())).max().item(), ((qdc - qda).abs() - 1e-10 * (1 + qda.abs())).max().item())
    if over > 0 or active == 0:
        raise AssertionError(f"crba (a): one step under crba differs from aba's by {err:.3e}, {active} rows active")
    log(f"crba (a): one float64 contact step ({active} of {calls[0][1].numel()} rows active) under minv_method='crba' against "
        f"'aba' on the card: max difference {err:.3e} (tolerance 1e-10 abs + rel)")
    return err


def mpc_walk(card, card_line):
    """(b): the MPC walk at full width: tools/mpc_walk.py's build in float32,
    batch MPC_BATCH, MPC_TICKS ticks x MPC_CONTROL_EVERY substeps at a 0.4
    m/s command, a tick a replayed graph (controller and substeps); env 0
    from tests/test_mpc_walk.py's start (tests/golden/laikago_mpc_walk_start.json),
    the others from the port's reset draws. K1's wrapper launches counted
    from 0 just before the walk and read just after; env 0 held to the
    test's three thresholds, the share of the batch that meets them
    printed; env-steps/s, the graph's nodes a tick, the controller's share
    of a tick's device time (CUDA events around replays of the whole tick
    and of the controller alone), K1 in a trace of 20 replayed substeps,
    and K1 against its plain version on a substep's operands, timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.control.mpc.locomotion import LocomotionMpcState, make_walk_step
    from tds_tpu_torch.tools.mpc_walk import build
    from tds_tpu_torch.utils import graphs

    env, controller = build(desired_speed=(0.4, 0.0, 0.0), dtype=torch.float32)
    step = make_walk_step(env, controller, MPC_CONTROL_EVERY)
    start = json.loads(MPC_START.read_text())
    state, _ = env.reset(torch.Generator(device="cuda").manual_seed(0), batch_size=MPC_BATCH)
    q, qd = state.q.clone(), state.qd.clone()
    q[0] = torch.tensor(start["q"], dtype=torch.float32, device="cuda")
    qd[0] = torch.tensor(start["qd"], dtype=torch.float32, device="cuda")
    carry = (controller.init_state(q), q, qd)
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    xs, zs, ups = [], [], []

    def tick(carry):
        carry = step(carry, 1)
        pos, up = env.base_pose_xyz_rpy(carry[1])
        xs.append(pos[:, 0])
        zs.append(pos[:, 2])
        ups.append(up)
        return carry

    carry, first_s = timed_call(lambda: tick(carry))
    t1 = time.perf_counter()
    for _ in range(MPC_TICKS - 1):
        carry = tick(carry)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t1
    launches = pgs.launches
    new = [g for g in graphs.stats() if g not in cached]
    expected = MPC_CONTROL_EVERY * (sum(g.steps for g in new) + len(new))
    if launches == 0 or launches != expected:
        raise AssertionError(f"mpc (b): the PGS wrapper launched {launches} times, expected {expected} (the warm-up and the "
                             f"capture of a tick's {MPC_CONTROL_EVERY} substeps)")
    xs, zs, ups = torch.stack(xs), torch.stack(zs), torch.stack(ups)  # (ticks, B)
    half = MPC_TICKS // 2
    v_avg = (xs[-1] - xs[half]) / (env.dt * MPC_CONTROL_EVERY * (MPC_TICKS - half))
    meets = ((xs[-1] > 0.4) & (ups.min(0).values > 0.85) & (zs.min(0).values > 0.30) & (zs.max(0).values < 0.55)
             & (v_avg > 0.2) & (v_avg < 0.6) & torch.isfinite(carry[1]).all(-1))
    env0 = (xs[-1, 0].item(), ups[:, 0].min().item(), zs[:, 0].min().item(), zs[:, 0].max().item(), v_avg[0].item())
    share = meets.double().mean().item()
    steady = MPC_TICKS - 1
    rate = MPC_BATCH * MPC_CONTROL_EVERY * steady / walk_s
    found = graph_lines("mpc (b)", env, "mpc walk")
    log(f"mpc (b): {MPC_BATCH} laikagos walked {MPC_TICKS} ticks x {MPC_CONTROL_EVERY} substeps at 0.4 m/s through graphs: the "
        f"first tick {first_s:.2f} s with the warm-up and capture, the other {steady} {walk_s:.2f} s = "
        f"{walk_s * 1e3 / steady:.2f} ms/tick, {rate:.1f} env-steps/s, {card_line}; K1 wrapper launches {launches} (the warm-up and "
        f"the capture of a tick's substeps); graph {[g.nodes for g in found]} nodes a tick")
    log(f"mpc (b): env 0 (the JAX test's start): x_final {env0[0]:.3f} m (> 0.4), min up {env0[1]:.3f} (> 0.85), z in "
        f"[{env0[2]:.3f}, {env0[3]:.3f}] (0.30, 0.55), v_avg over the second half {env0[4]:.3f} m/s (0.2, 0.6); "
        f"{int(meets.sum())} of {MPC_BATCH} envs ({100 * share:.1f}%) meet all three thresholds")
    if not bool(meets[0]):
        raise AssertionError(f"mpc (b): env 0 misses tests/test_mpc_walk.py's thresholds: {env0}")

    # the controller's share: CUDA events around replays of the tick's graph and of a graph of the controller alone
    def controller_only(c, consts):
        state, _ = controller.update(LocomotionMpcState.unflat(c[:5]), c[5], c[6])
        return (*state.flat(), c[5], c[6])

    flat = (*carry[0].flat(), carry[1], carry[2])
    ctrl_key = ("mpc controller", env, controller)

    def replay_ms(fn):
        fn()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start_ev.record()
        fn()
        end_ev.record()
        torch.cuda.synchronize()
        return start_ev.elapsed_time(end_ev) / MPC_TIMED_TICKS

    tick_ms = replay_ms(lambda: step(carry, MPC_TIMED_TICKS))
    ctrl_ms = replay_ms(lambda: graphs.scan(controller_only, flat, (), MPC_TIMED_TICKS, key=ctrl_key))
    ctrl_nodes = [g.nodes for g in graphs.stats() if g.key == ctrl_key]
    log(f"mpc (b): device time a replayed tick {tick_ms:.3f} ms, the controller alone {ctrl_ms:.3f} ms ({ctrl_nodes} nodes): "
        f"{100 * ctrl_ms / tick_ms:.1f}% of a tick; the {MPC_CONTROL_EVERY} substeps about {tick_ms - ctrl_ms:.3f} ms")
    with sub_phase(f"mpc (b) seconds: the {PROFILE_STEPS // MPC_CONTROL_EVERY}-tick trace"):
        profile = device_profile(lambda: step(carry, PROFILE_STEPS // MPC_CONTROL_EVERY), calls=1, kernel="pgs_kernel",
                                 expected=PROFILE_STEPS)
    if profile is None or profile[3] != PROFILE_STEPS:
        raise AssertionError(f"mpc (b): K1 ran {None if profile is None else profile[3]} times in {PROFILE_STEPS} replayed substeps")
    ops, busy, wall, k1 = profile
    log(f"mpc (b): {PROFILE_STEPS // MPC_CONTROL_EVERY} replayed ticks: K1 {k1:.0f} times in {PROFILE_STEPS} substeps "
        f"(torch.profiler), {ops * MPC_CONTROL_EVERY / PROFILE_STEPS:.0f} device operations a tick, "
        f"{100 * (1 - busy / wall):.1f}% idle under the profiler")
    with graphs.eager(), recorded_pgs_calls() as calls:
        step(carry, 1)
    if len(calls) != MPC_CONTROL_EVERY:
        raise AssertionError(f"mpc (b): {len(calls)} PGS calls in an eager tick, expected {MPC_CONTROL_EVERY}")
    a, b, lo, hi, dep, it = calls[-1]
    active = int((b != 0).sum())
    if tuple(b.shape) != (MPC_BATCH, 12) or active == 0:
        raise AssertionError(f"mpc (b): the walk's MLCP has shape {tuple(b.shape)}, {active} rows active")
    err, margin = k1_against_plain("the MPC walk's substep", [a, b, lo, hi], dep, it)
    log(f"mpc (b): K1 on the last substep of an eager tick from the walk's end B={MPC_BATCH} n=12: {active} of {b.numel()} rows "
        f"active, max |kernel - plain| = {err:.3e} (margin left {margin:.3e})")
    timing = k1_timing("MPC walk substep", [a, b, lo, hi], dep, it, card, prefix="mpc (b)")
    return {"launches": launches, "max_abs_err": err, **timing, "replayed_launches_per_step": k1 / PROFILE_STEPS,
            "mpc_walk_env_steps_per_s": rate, "ms_per_tick": walk_s * 1e3 / steady, "graph_nodes": [g.nodes for g in found],
            "controller_share": ctrl_ms / tick_ms, "env0": env0, "share_meeting_thresholds": share,
            "main_path": f"the MPC walk, {MPC_BATCH} laikagos x {MPC_TICKS} ticks (phase 17 (b))"}


def spring_rollout(card_line, mlcp_rate):
    """(c): the spring laikago (contact_model="spring") in float32 at batch
    MAIN_BATCH: reset and a LAIKAGO_BENCH_STEPS-step zero-policy rollout
    through graphs, timed once after a 2-step call that captures the
    graph, beside phase 5's MLCP figure; no PGS launch on this path."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout

    env = LaikagoEnv(dtype=torch.float32, contact_model="spring")
    policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
    launches = pgs.launches
    state0, obs0 = env.reset(torch.Generator(device="cuda").manual_seed(2), batch_size=MAIN_BATCH)
    rollout(env, policy, None, state0, obs0, 2)  # captures the one-step graph
    (final, _, _, alive), bench_s = timed_call(lambda: rollout(env, policy, None, state0, obs0, LAIKAGO_BENCH_STEPS))
    z = final.q[:, 2]
    if pgs.launches != launches or not bool(torch.isfinite(final.q).all()) or not bool(alive.all()):
        raise AssertionError(f"spring (c): {pgs.launches - launches} PGS launches, or {int(alive.sum())}/{MAIN_BATCH} alive")
    rate = MAIN_BATCH * LAIKAGO_BENCH_STEPS / bench_s
    found = graph_lines("spring (c)", env, "rollout")
    bench_line("laikago_spring_scan_rollout_env_steps_per_s", rate, "steps/s", card_line, batch=MAIN_BATCH,
               steps=LAIKAGO_BENCH_STEPS, seconds=bench_s, mlcp_env_steps_per_s=mlcp_rate)
    log(f"spring (c): the spring laikago's {LAIKAGO_BENCH_STEPS}-step rollout at batch {MAIN_BATCH} through graphs "
        f"{bench_s * 1e3 / LAIKAGO_BENCH_STEPS:.3f} ms/step, {rate:.1f} env-steps/s against the MLCP's {mlcp_rate:.1f} (phase "
        f"5), {card_line}; graph {[g.nodes for g in found]} nodes; 0 PGS launches; z in [{z.min():.3f}, {z.max():.3f}]")
    return rate


def spring_ball(device, dtype=torch.float64):
    """tests/test_spring_contact.py's ball: 1 kg, inertia 0.1, radius 0.5,
    spring_k 2000, damper_d 50."""
    import numpy as np

    from tds_tpu_torch.contact.spring import SpringContactParams
    from tds_tpu_torch.model.geometry import GeomAttachment, Sphere
    from tds_tpu_torch.model.multibody import MultiBodyBuilder
    from tds_tpu_torch.world import build_world, make_ground_plane

    b = MultiBodyBuilder(is_floating=True, name="ball")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.1] * 3))
    ball = b.finalize(dtype=dtype, device=device)
    return build_world([make_ground_plane(dtype=dtype, device=device), (ball, (GeomAttachment(link_index=-1, shape=Sphere(0.5)),))],
                       contact_model="spring", spring=SpringContactParams(spring_k=2000.0, damper_d=50.0))


def spring_final_z(world, z0):
    """The ball's z after SPRING_BALL_STEPS steps of world_rollout from rest
    at height ``z0`` (a (1,) tensor)."""
    from tds_tpu_torch.world import world_rollout

    ball = world.bodies[1]
    ground = z0.new_zeros(1, 0)
    q0 = torch.cat([ball.zero_q((1,))[:, :6], z0[:, None]], dim=-1)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=z0.dtype, device=z0.device)
    qs, _ = world_rollout(world, (ground, q0), (ground, ball.zero_qd((1,))), gravity, 1e-3, SPRING_BALL_STEPS)
    return qs[1][0, 6]


def spring_ball_gradient():
    """(c): d(final z)/d(z0) of tests/test_spring_contact.py's ball over
    SPRING_BALL_STEPS steps from z0 = 0.9, float64, through graphs.scan's
    VJP graph on the card, within 1e-9 abs + rel of the CPU's and at that
    test's rtol 1e-3 (atol 1e-5) of central differences (eps 1e-5)."""
    world = spring_ball("cuda")
    z0 = torch.tensor([0.9], dtype=torch.float64, device="cuda", requires_grad=True)
    (grad,), grad_s = timed_call(lambda: torch.autograd.grad(spring_final_z(world, z0), z0))
    cpu_z0 = z0.detach().cpu().requires_grad_()
    (cpu_grad,) = torch.autograd.grad(spring_final_z(spring_ball("cpu"), cpu_z0), cpu_z0)
    eps = 1e-5
    with torch.no_grad():
        fd = (spring_final_z(world, z0 + eps) - spring_final_z(world, z0 - eps)) / (2 * eps)
    g, c, f = grad.item(), cpu_grad.item(), fd.item()
    if abs(g - c) > 1e-9 * (1 + abs(c)) or abs(g - f) > 1e-5 + 1e-3 * abs(f):
        raise AssertionError(f"spring (c): the ball's gradient {g!r} on the card, {c!r} on the CPU, {f!r} by central differences")
    log(f"spring (c): d(final z)/d(z0) of the spring ball over {SPRING_BALL_STEPS} steps through the scan's VJP graph on the "
        f"card {g:.12e} in {grad_s:.2f} s with the captures; the CPU's {c:.12e} (|card - cpu| {abs(g - c):.3e}, 1e-9); central "
        f"differences {f:.12e} (relative {abs(g - f) / abs(f):.2e}, rtol 1e-3)")
    return abs(g - c)


def option_rates(card, card_line):
    """(d): the laikago at batch MAIN_BATCH in float32, OPTION_STEPS replayed
    zero-policy steps each under "aba"/f32, minv_method="crba" and
    delassus_dtype="bf16" (ms/step after a 2-step call that captures the
    graph), and the humanoid at batch HUMANOID_BATCH for HUMANOID_CRBA_STEPS
    steps under "aba" and "crba". Each env's K1 wrapper launches are counted
    from 0 just before its reset and read just after its rollouts (the
    warm-ups and captures); for the CRBA and bf16 laikagos, K1 in a trace of
    PROFILE_STEPS replayed steps (one a step). Only then K1 against its
    plain version on the operands of an eager step after the CRBA and the
    bf16 rollouts, timed. Returns the kernels line's entries for the CRBA
    and bf16 operands, and the numbers."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.contact.mlcp import ContactSolverParams
    from tds_tpu_torch.envs.humanoid import HumanoidEnv
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn.nn import linear_policy
    from tds_tpu_torch.rollout import rollout
    from tds_tpu_torch.utils import graphs

    def timed_rollout(name, env, batch, steps, trace=False):
        """(ms/step, the final state, the wrapper's launches, K1 kernels a
        replayed step in the trace or None)."""
        policy = linear_policy(env.observation_dim, env.action_dim, dtype=env.dtype)
        torch.cuda.synchronize()
        cached = graphs.stats()
        pgs.launches = 0
        state, obs = env.reset(torch.Generator(device="cuda").manual_seed(3), batch_size=batch)
        rollout(env, policy, None, state, obs, 2)
        (final, _, _, _), seconds = timed_call(lambda: rollout(env, policy, None, state, obs, steps))
        launches = pgs.launches
        check_wrapper_launches(f"options (d) {name}", "PGS", launches, cached)
        if not bool(torch.isfinite(final.q).all()):
            raise AssertionError(f"options (d): the {name} rollout went non-finite")
        per_step = None
        if trace:
            with sub_phase(f"options (d) seconds: the {name} {PROFILE_STEPS}-step trace"):
                profile = device_profile(lambda: rollout(env, policy, None, state, obs, PROFILE_STEPS), calls=1,
                                         kernel="pgs_kernel", expected=PROFILE_STEPS)
            if profile is None or profile[3] != PROFILE_STEPS:
                raise AssertionError(f"options (d): K1 ran {None if profile is None else profile[3]} times in {PROFILE_STEPS} "
                                     f"replayed {name} steps")
            per_step = profile[3] / PROFILE_STEPS
            log(f"options (d): the {name} rollout: K1 wrapper launches {launches} (warm-ups and captures), K1 {profile[3]:.0f} "
                f"times in {PROFILE_STEPS} replayed steps (torch.profiler)")
        return seconds * 1e3 / steps, final, launches, per_step

    def k1_on_step(name, env, state):
        with recorded_pgs_calls() as calls:
            env.step(state, torch.zeros(state.q.shape[0], env.action_dim, device="cuda"))
        a, b, lo, hi, dep, it = calls[0]
        active = int((b != 0).sum())
        if active == 0:
            raise AssertionError(f"options (d): no contact row active in the {name} step")
        err, margin = k1_against_plain(f"the {name} operands", [a, b, lo, hi], dep, it)
        log(f"options (d): K1 on the {name} operands (step {env.settle_steps + OPTION_STEPS + 1}, {active} of {b.numel()} rows "
            f"active) B={b.shape[0]} n={b.shape[1]}: max |kernel - plain| = {err:.3e} (margin left {margin:.3e})")
        return {"max_abs_err": err, **k1_timing(f"{name} laikago step", [a, b, lo, hi], dep, it, card, prefix="options (d)")}

    numbers, finals, counts = {}, {}, {}
    envs = {"aba": LaikagoEnv(dtype=torch.float32), "crba": LaikagoEnv(dtype=torch.float32, solver=ContactSolverParams(minv_method="crba")),
            "bf16": LaikagoEnv(dtype=torch.float32, solver=ContactSolverParams(delassus_dtype="bf16"))}
    for name, env in envs.items():
        ms, finals[name], launches, per_step = timed_rollout(name, env, MAIN_BATCH, OPTION_STEPS, trace=name != "aba")
        numbers[f"laikago_{name}_ms_per_step"] = ms
        counts[name] = {"launches": launches, "replayed_launches_per_step": per_step}
    log(f"options (d): the laikago at batch {MAIN_BATCH}, {OPTION_STEPS} replayed steps: "
        + ", ".join(f"{k} {numbers[f'laikago_{k}_ms_per_step']:.3f} ms/step" for k in envs) + f", {card_line}")
    for name, solver in (("aba", ContactSolverParams(top_k=0)), ("crba", ContactSolverParams(top_k=0, minv_method="crba"))):
        numbers[f"humanoid_{name}_ms_per_step"] = timed_rollout(f"humanoid {name}", HumanoidEnv(dtype=torch.float32, solver=solver),
                                                                HUMANOID_BATCH, HUMANOID_CRBA_STEPS)[0]
    log(f"options (d): the humanoid at batch {HUMANOID_BATCH}, {HUMANOID_CRBA_STEPS} replayed steps: aba "
        f"{numbers['humanoid_aba_ms_per_step']:.3f} ms/step, crba {numbers['humanoid_crba_ms_per_step']:.3f} ms/step (a "
        "measurement, not a claim)")
    common = {"route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu", "library_ms": None,
              "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)"}
    entries = []
    for name, label, option in (("crba", "CRBA", "minv_method='crba'"), ("bf16", "bf16 Delassus", "delassus_dtype='bf16'")):
        entries.append({"name": f"pgs n=12 {label.lower()}", **common, **k1_on_step(label, envs[name], finals[name]),
                        **counts[name], "main_path": f"the laikago's rollout under {option} (phase 17 (d))"})
    return entries, numbers


def phase_mpc(card, card_line, mlcp_rate):
    """Phase 17: control and the rest of dynamics on the card. Returns the
    kernels line's entries of K1 on the MPC walk, on the CRBA operands and
    on the bf16 Delassus operands (n = 12 each), and the numbers."""
    from tds_tpu_torch.contact.mlcp import ContactSolverParams

    numbers = {}
    with sub_phase("mpc (a) seconds"):
        with sub_phase("mpc (a) seconds: the walk"):
            numbers["mpc_float64_card_vs_cpu"] = mpc_device_vs_cpu()
        with sub_phase("spring (a) seconds"):
            numbers["spring_float64_card_vs_cpu"] = env_device_vs_cpu("spring (a)", contact_model="spring")
        with sub_phase("crba (a) seconds"):
            numbers["crba_float64_card_vs_cpu"] = env_device_vs_cpu("crba (a)", solver=ContactSolverParams(minv_method="crba"))
            numbers["crba_against_aba"] = crba_against_aba()
    with sub_phase("mpc (b) seconds"):
        walk = mpc_walk(card, card_line)
    with sub_phase("spring (c) seconds"):
        numbers["laikago_spring_scan_rollout_env_steps_per_s"] = spring_rollout(card_line, mlcp_rate)
        with sub_phase("spring (c) seconds: the ball's gradient"):
            numbers["spring_ball_gradient_card_vs_cpu"] = spring_ball_gradient()
    with sub_phase("options (d) seconds"):
        options, option_numbers = option_rates(card, card_line)
    numbers.update(option_numbers)
    entries = [{"name": "pgs n=12 mpc walk", "route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu", "library_ms": None,
                "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", **walk}, *options]
    for entry in entries:
        log(f"mpc: {json.dumps(entry)}")
    log(f"mpc: {json.dumps(numbers)}")
    return entries, numbers


# -- phase 18 --------------------------------------------------------------
def k1_launches_trace(label, fn, per_step):
    """K1 kernels in a trace of PROFILE_STEPS replayed steps of ``fn`` (which
    replays them), ``per_step`` a step; raises on another count."""
    expected = per_step * PROFILE_STEPS
    with sub_phase(f"{label} seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(fn, calls=1, kernel="pgs_kernel", expected=expected)
    if profile is None or profile[3] != expected:
        raise AssertionError(f"{label}: K1 ran {None if profile is None else profile[3]} times in {PROFILE_STEPS} replayed "
                             f"steps, {expected} expected")
    return profile


def k1_on_calls(label, calls, card, prefix):
    """K1 against its plain version and timed on each recorded PGS call;
    returns their entries' numbers, keyed by the call's index."""
    out = []
    for k, (a, b, lo, hi, dep, it) in enumerate(calls):
        active = int((b != 0).sum())
        err, margin = k1_against_plain(f"{label} solve {k}", [a, b, lo, hi], dep, it)
        log(f"{prefix}: K1 on {label}'s solve {k} B={b.shape[0]} n={b.shape[1]} it={it}: {active} of {b.numel()} rows active, "
            f"max |kernel - plain| = {err:.3e} (margin left {margin:.3e})")
        out.append({"max_abs_err": err, "rows_active": active,
                    **k1_timing(f"{label} solve {k}", [a, b, lo, hi], dep, it, card, prefix=prefix)})
    return out


def panda_device_vs_cpu():
    """(a): tools/panda_push.py's scene in float64 at batch PANDA_CHECK_BATCH
    for EAGER_STEPS steps, the box pressed into the end effector from the
    start (all three pairs in contact), through graphs on the card against
    the CPU's loop, the IK waypoints the CPU's; within 1e-9 abs + rel."""
    from tds_tpu_torch.tools import panda_push

    cpu_world, cpu_arm, _ = panda_push.build_scene(dtype=torch.float64, device="cpu")
    gpu_world, _, _ = panda_push.build_scene(dtype=torch.float64)
    q0, q1 = panda_push.ik_waypoints(cpu_arm)
    box_x = panda_push.box_starts(PANDA_CHECK_BATCH, 1, torch.float64) - 0.057  # the box against the end effector's sphere
    got = panda_push.push(gpu_world, q0.cuda(), q1.cuda(), box_x.cuda(), steps=EAGER_STEPS, report=())
    want = panda_push.push(cpu_world, q0, q1, box_x, steps=EAGER_STEPS, report=())
    worst = 0.0
    for g_part, w_part in zip(got[:2], want[:2]):
        for g, w in zip(g_part, w_part):
            worst = max(worst, (g.cpu() - w).abs().max().item() if w.numel() else 0.0)
            if w.numel() and excess(g.cpu(), w, 1e-9) > 0:
                raise AssertionError(f"panda (a): the card and the CPU differ by {(g.cpu() - w).abs().max().item():.3e}")
    log(f"panda (a): {EAGER_STEPS} float64 steps of the Panda push at batch {PANDA_CHECK_BATCH}, the box against the end "
        f"effector from the start, through graphs on the card against the CPU: max |cuda - cpu| = {worst:.3e} (1e-9 abs + rel); "
        f"the boxes' x moved by up to {(want[0][2][:, 4] - box_x).abs().max().item() * 1e3:.3f} mm")
    return worst


def panda_push_path(card, card_line):
    """(a): tools/panda_push.py as a user runs it: the scene in float32 on the
    card, the IK waypoints there, PANDA_BATCH scenes x 1000 steps through a
    replayed graph, env 0 from the example's box start; K1's wrapper
    launches counted from 0 just before and read just after (3 a captured
    step), env 0 held to the example's criterion (pushed more than 4 cm)
    and to z within 5 mm of its rest height, the share of the batch that
    meets both, env-steps/s, ms/step and the graph's nodes a step; K1 in a
    trace of PROFILE_STEPS replayed steps (3 a step); K1 against its plain
    version on the three solves of an eager step mid-stroke, timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import panda_push
    from tds_tpu_torch.utils import graphs

    world, arm, _ = panda_push.build_scene(dtype=torch.float32)
    (q0, q1), ik_s = timed_call(lambda: panda_push.ik_waypoints(arm))
    box_x = panda_push.box_starts(PANDA_BATCH, 0, torch.float32, "cuda")
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    _, first_s = timed_call(lambda: panda_push.push(world, q0, q1, box_x, steps=2, report=()))
    (qs, qds, seen), push_s = timed_call(lambda: panda_push.push(world, q0, q1, box_x))
    launches = pgs.launches
    expected = 3 * captured_launches(cached)
    if launches == 0 or launches != expected:
        raise AssertionError(f"panda (a): the PGS wrapper launched {launches} times, expected {expected} (3 solves in the "
                             "warm-up and the capture)")
    moved, z = qs[2][:, 4] - box_x, qs[2][:, 6]
    rest = panda_push.BOX_EXTENTS[2] / 2
    meets = (moved > panda_push.PUSHED) & ((z - rest).abs() < 5e-3) & torch.isfinite(qs[2]).all(-1)
    share = meets.double().mean().item()
    rate = PANDA_BATCH * panda_push.STEPS / push_s
    found = graph_lines("panda (a)", "panda push", world)
    nodes = [g.nodes for g in found if g.batch == PANDA_BATCH]
    trail = ", ".join(f"t={r / 1000:.1f}s x={xz[0, 0].item():+.3f} z={xz[0, 1].item():.3f}" for r, xz in zip(panda_push.REPORT_STEPS, seen))
    log(f"panda (a): IK waypoints in float32 on the card in {ik_s:.2f} s; {PANDA_BATCH} Pandas pushed their boxes for "
        f"{panda_push.STEPS} float32 steps through a replayed graph in {push_s:.2f} s = {push_s * 1e3 / panda_push.STEPS:.3f} "
        f"ms/step, {rate:.1f} env-steps/s, {card_line} (the 2-step call that captures the graph {first_s:.2f} s); graph "
        f"{nodes} nodes a step; K1 wrapper launches {launches} (3 a captured step)")
    log(f"panda (a): env 0 (the example's start): {trail}; pushed {moved[0].item() * 100:.2f} cm (> 4), final z "
        f"{z[0].item():.4f} m (rest {rest}); {int(meets.sum())} of {PANDA_BATCH} scenes ({100 * share:.1f}%) pushed more than 4 "
        f"cm and upright; pushed {moved.min().item() * 100:.2f}-{moved.max().item() * 100:.2f} cm")
    if not bool(meets[0]):
        raise AssertionError(f"panda (a): env 0 pushed {moved[0].item():.4f} m, z {z[0].item():.4f}")
    ops, busy, wall, k1 = k1_launches_trace("panda (a)", lambda: panda_push.push(world, q0, q1, box_x, steps=PROFILE_STEPS,
                                                                                    report=()), 3)
    log(f"panda (a): {PROFILE_STEPS} replayed steps: K1 {k1:.0f} times (torch.profiler), {ops / PROFILE_STEPS:.0f} device "
        f"operations a step, {100 * (1 - busy / wall):.1f}% idle under the profiler")
    # the operands of an eager step mid-stroke, after 400 replayed steps
    mid_qs, mid_qds, _ = panda_push.push(world, q0, q1, box_x, steps=400, report=())
    step = panda_push.make_step(world)
    i = torch.full_like(box_x, 400.0)
    gravity = torch.tensor(panda_push.GRAVITY, device="cuda")
    with recorded_pgs_calls() as calls:
        step((*mid_qs, *mid_qds, i), (q0, q1, gravity))
    if [c[1].shape[-1] for c in calls] != [3, 24, 3]:
        raise AssertionError(f"panda (a): the step's PGS calls have {[c[1].shape[-1] for c in calls]} rows, not [3, 24, 3]")
    solves = k1_on_calls("the Panda push", calls, card, "panda (a)")
    RECORDED["panda_calls"] = calls
    common = {"launches": launches, "replayed_launches_per_step": k1 / PROFILE_STEPS,
              "main_path": f"the Panda push, {PANDA_BATCH} scenes x {panda_push.STEPS} steps (phase 18 (a))"}
    numbers = {"panda_push_env_steps_per_s": rate, "panda_push_ms_per_step": push_s * 1e3 / panda_push.STEPS,
               "panda_push_graph_nodes": nodes, "panda_push_env0_cm": moved[0].item() * 100, "panda_push_env0_z": z[0].item(),
               "panda_push_share": share, "panda_push_ik_s": ik_s}
    names = ("plane-arm", "plane-box", "arm-box")
    return [{"name": f"pgs n={c['shape'].split()[1][2:]} panda {name}", **common, **c} for name, c in zip(names, solves)], numbers


CUBE_OBJ = "\n".join(
    f"v {sx} {sy} {sz}" for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)
) + "\n" + "\n".join(
    f"f {a} {b} {c}"
    for a, b, c in [(1, 3, 7), (1, 7, 5), (2, 6, 8), (2, 8, 4), (1, 2, 4), (1, 4, 3),
                    (5, 7, 8), (5, 8, 6), (1, 5, 6), (1, 6, 2), (3, 4, 8), (3, 8, 7)]
) + "\n"  # tests/test_mesh_contact.py's unit cube, wound outward


def cube_obj():
    """The unit cube's OBJ file, written under build/ in this checkout."""
    path = REPO / "build" / "mesh" / "cube.obj"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(CUBE_OBJ)
    return str(path)


def stack_world(dtype, device):
    """tests/test_mesh_contact.py's stack: a static unit mesh cube (4
    candidates) at z = 0.5 and a 0.6-scale mesh cube of 1 kg over it."""
    import dataclasses

    import numpy as np

    from tds_tpu_torch.contact.mlcp import ContactSolverParams
    from tds_tpu_torch.model.geometry import GeomAttachment, Mesh
    from tds_tpu_torch.model.multibody import MultiBodyBuilder
    from tds_tpu_torch.world import build_world

    m = Mesh(file_name=cube_obj(), max_contacts=4)
    b = MultiBodyBuilder(is_floating=True, name="mesh_cube_dyn")
    b.set_base_inertia(1.0, (0, 0, 0), np.diag([0.36 / 6.0] * 3))
    cube = b.finalize(dtype=dtype, device=device)
    static = MultiBodyBuilder(name="mesh_cube_static").finalize(dtype=dtype, device=device)
    return build_world(
        [(static, (GeomAttachment(link_index=-1, shape=m, pos=(0.0, 0.0, 0.5), friction=0.8),)),
         (cube, (GeomAttachment(link_index=-1, shape=dataclasses.replace(m, scale=(0.6, 0.6, 0.6)), friction=0.8),))],
        solver=ContactSolverParams(friction=0.8, restitution=0.0),
    )


def stack_start(world, batch, z, dtype, device, seed):
    """(qs, qds): the cube at rest at height ``z``, env 0 at x = y = 0, the
    others offset by U(-5 cm, +5 cm) in x and y from a seeded generator."""
    cube = world.bodies[1]
    q = cube.zero_q((batch,))
    offsets = (torch.rand(batch, 2, generator=torch.Generator().manual_seed(seed), dtype=torch.float64) - 0.5) * 0.1
    offsets[0] = 0.0
    q[:, 4:6] = offsets.to(device, dtype)
    q[:, 6] = z
    ground = q.new_zeros(batch, 0)
    return (ground, q), (ground, cube.zero_qd((batch,)))


def stack_drop(dtype, label):
    """STACK_BATCH cubes dropped from 1.35 m onto the static cube for
    STACK_STEPS steps of world_rollout's graph in ``dtype``: (world, start,
    final qs and qds, K1's wrapper launches counted from 0 just before and
    read just after, the seconds of a replay, the share of the batch at
    test_mesh_contact.py's thresholds and the mask of those that meet
    them)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.utils import graphs
    from tds_tpu_torch.world import world_rollout

    world = stack_world(dtype, "cuda")
    qs, qds = stack_start(world, STACK_BATCH, 1.35, dtype, "cuda", 6)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    (fq, fqd), drop_s = timed_call(lambda: world_rollout(world, qs, qds, gravity, 1e-3, STACK_STEPS))
    launches = pgs.launches
    check_wrapper_launches(label, "PGS", launches, cached)
    _, replay_s = timed_call(lambda: world_rollout(world, qs, qds, gravity, 1e-3, STACK_STEPS))
    z, speed = fq[1][:, 6], fqd[1].abs().amax(-1)
    meets = ((z - 1.3).abs() < 0.03) & (speed < 0.1) & torch.isfinite(fq[1]).all(-1)
    nodes = [g.nodes for g in graph_lines(label, "world_rollout", world)]
    log(f"{label}: {STACK_BATCH} mesh cubes dropped on the static one for {STACK_STEPS} {str(dtype)[6:]} steps through graphs: "
        f"{drop_s:.2f} s with the capture, replayed {replay_s * 1e3 / STACK_STEPS:.3f} ms/step = "
        f"{STACK_BATCH * STACK_STEPS / replay_s:.1f} env-steps/s; graph {nodes} nodes; K1 wrapper launches {launches}; env 0: "
        f"z {z[0].item():.4f} (1.3 +- 0.03), max |qd| {speed[0].item():.2e} (< 0.1); {int(meets.sum())} of {STACK_BATCH} "
        f"({100 * meets.double().mean().item():.1f}%) meet both")
    return world, (qs, qds, gravity), launches, replay_s, nodes, meets, z


def mesh_stack(card):
    """(b): the mesh-cube stack: float64 card against CPU over EAGER_STEPS
    steps of 8 envs in contact from the start (1 mm in, some tilted),
    within 1e-10 abs + rel; then the drop of STACK_BATCH cubes (stack_drop)
    in float32, printed as a measurement (it does not settle: the JAX
    package's float32 stack fails the same way), and in float64, held: env
    0 at test_mesh_contact.py's thresholds, the share of the batch, K1 (n =
    24) once a replayed step in a trace, K1 against its plain version on a
    step's operands, timed."""
    from tds_tpu_torch.world import world_rollout, world_step

    cpu_world, gpu_world = stack_world(torch.float64, "cpu"), stack_world(torch.float64, "cuda")
    qs, qds = stack_start(cpu_world, 8, 1.299, torch.float64, "cpu", 5)
    qs[1][1::2, :4] = torch.tensor([0.02, -0.03, 0.01, 1.0], dtype=torch.float64) / math.sqrt(1 + 0.02**2 + 0.03**2 + 0.01**2)
    gravity = torch.tensor((0.0, 0.0, -9.81), dtype=torch.float64)
    got = world_rollout(gpu_world, tuple(q.cuda() for q in qs), tuple(q.cuda() for q in qds), gravity.cuda(), 1e-3, EAGER_STEPS)
    want = world_rollout(cpu_world, qs, qds, gravity, 1e-3, EAGER_STEPS)
    worst = max((g[1].cpu() - w[1]).abs().max().item() for g, w in zip(got, want))
    if max(excess(g[1].cpu(), w[1], 1e-10) for g, w in zip(got, want)) > 0:
        raise AssertionError(f"stack (b): the card and the CPU differ by {worst:.3e}")
    log(f"stack (b): {EAGER_STEPS} float64 steps of the mesh-cube stack at batch 8 in contact through graphs on the card against "
        f"the CPU: max |cuda - cpu| = {worst:.3e} (1e-10 abs + rel)")
    *_, meets32, z32 = stack_drop(torch.float32, "stack (b) float32, a measurement")
    world, (qs, qds, g64), launches, replay_s, nodes, meets, z = stack_drop(torch.float64, "stack (b) float64")
    if not bool(meets[0]):
        raise AssertionError(f"stack (b): env 0 ends at z {z[0].item():.4f}")
    ops, busy, wall, k1 = k1_launches_trace("stack (b)", lambda: world_rollout(world, qs, qds, g64, 1e-3, PROFILE_STEPS), 1)
    mid = world_rollout(world, qs, qds, g64, 1e-3, 300)
    with recorded_pgs_calls() as calls:
        world_step(world, *mid, None, g64, 1e-3)
    if [c[1].shape[-1] for c in calls] != [24]:
        raise AssertionError(f"stack (b): the step's PGS calls have {[c[1].shape[-1] for c in calls]} rows, not [24]")
    (solve,) = k1_on_calls("the mesh stack", calls, card, "stack (b)")
    numbers = {"stack_float64_card_vs_cpu": worst, "stack_ms_per_step": replay_s * 1e3 / STACK_STEPS, "stack_graph_nodes": nodes,
               "stack_env0_z": z[0].item(), "stack_share": meets.double().mean().item(),
               "stack_float32_share": meets32.double().mean().item(), "stack_float32_env0_z": z32[0].item()}
    return {"name": "pgs n=24 mesh stack", "launches": launches, "replayed_launches_per_step": k1 / PROFILE_STEPS, **solve,
            "main_path": f"the mesh-cube stack, {STACK_BATCH} cubes x {STACK_STEPS} float64 steps (phase 18 (b))"}, numbers


def raycasts():
    """(c): cast_rays over examples/raycast_example.py's sphere, box and
    plane and the unit mesh cube, a RAY_GRID x RAY_GRID grid of downward
    rays, float64 on the card against the CPU: fractions within 1e-12,
    geom_index identical; the card's time (median of 5 event spans)."""
    from tds_tpu_torch.algebra.transform import Transform
    from tds_tpu_torch.collision.raycast import cast_rays
    from tds_tpu_torch.model.geometry import Box, Mesh, Plane, Sphere

    shapes = [Sphere(0.5), Box((0.8, 0.8, 0.8)), Plane((0.0, 0.0, 1.0), 0.0), Mesh(file_name=cube_obj())]

    def placed(device):
        eye = torch.eye(3, dtype=torch.float64, device=device)
        return [Transform(pos=torch.tensor(p, dtype=torch.float64, device=device), rot=eye)
                for p in ((-0.8, 0.0, 0.5), (0.8, 0.0, 0.4), (0.0, 0.0, 0.0), (0.0, -1.2, 0.5))]

    xs = torch.linspace(-2.0, 2.0, RAY_GRID, dtype=torch.float64)
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    origins = torch.stack([gx, gy, torch.full_like(gx, 3.0)], -1).reshape(-1, 3)
    targets = torch.stack([gx, gy, torch.full_like(gx, -1.0)], -1).reshape(-1, 3)
    o, t, xf = origins.cuda(), targets.cuda(), placed("cuda")
    got = cast_rays(o, t, shapes, xf)
    want = cast_rays(origins, targets, shapes, placed("cpu"))
    err = (got.fraction.cpu() - want.fraction).abs().max().item()
    if err > 1e-12 or not torch.equal(got.geom_index.cpu(), want.geom_index):
        raise AssertionError(f"raycast (c): the card's fractions differ by {err:.3e} or its geom_index differs")
    ms = span_ms(lambda: cast_rays(o, t, shapes, xf), reps=5)
    counts = torch.bincount(want.geom_index.long() + 1, minlength=5).tolist()
    log(f"raycast (c): cast_rays of {RAY_GRID}x{RAY_GRID} rays over a sphere, a box, a plane and a mesh cube, float64: max "
        f"|cuda - cpu| fraction {err:.3e} (1e-12), geom_index identical (misses, sphere, box, plane, mesh: {counts}); "
        f"{ms:.3f} ms on the card (event span)")
    return {"raycast_max_abs": err, "raycast_ms": ms, "raycast_counts": counts}


def phase_collision(card, card_line):
    """Phase 18: the rest of collision on the card. Returns the kernels
    line's entries of K1 on the Panda push's three solves (n = 3, 24, 3)
    and on the mesh stack (n = 24), and the numbers."""
    numbers = {}
    with sub_phase("panda (a) seconds"):
        numbers["panda_float64_card_vs_cpu"] = panda_device_vs_cpu()
        panda, panda_numbers = panda_push_path(card, card_line)
    numbers.update(panda_numbers)
    with sub_phase("stack (b) seconds"):
        stack, stack_numbers = mesh_stack(card)
    numbers.update(stack_numbers)
    with sub_phase("raycast (c) seconds"):
        numbers.update(raycasts())
    common = {"route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu", "library_ms": None,
              "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)"}
    entries = [{**entry, **common} for entry in (*panda, stack)]
    for entry in entries:
        log(f"collision: {json.dumps(entry)}")
    log(f"collision: {json.dumps(numbers)}")
    return entries, numbers


# -- phase 19 --------------------------------------------------------------
def k2_on_operands(label, params, operands, got, card, prefix):
    """K2 against its plain version on the card on the operands (q, qd,
    action) that a path handed it and the results it gave there, held at
    MEGA_TOL over every env but the ties (K2_TIE: a sphere within K2_TIE of
    the plane, and the float64 step nearer K2 than the plain step or between
    the two; their number and difference are printed); K2's device time,
    the plain version's and the bound (bytes, and the operations the step
    needs on these states by ``utils/op_count.py``). Returns the numbers of
    a kernels-line entry."""
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.utils import op_count

    q, qd, action = operands
    plain = fused_step.mega_step_reference(params, q, qd, action)
    params64 = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, action_limit=float(params.action_limit)))
    exact = fused_step.mega_step_reference(params64, q.double(), qd.double(), action.double())
    near = (fused_step.sphere_distances(params, q).abs() < K2_TIE).any(-1)
    pairs = [(name, g.double(), e.double(), x) for name, g, e, x in (("q", got[0], plain[0], exact[0]),
                                                                   ("qd", got[1], plain[1], exact[1]))]
    bad = torch.zeros_like(near)
    sides = torch.ones_like(near)  # the float64 step nearer K2 than the plain step, or between the two
    for name, g, e, x in pairs:
        tol = MEGA_TOL[name] * (1 + e.abs())
        bad |= ((g - e).abs() - tol).amax(-1) > 0
        nearer = (g - x).abs().amax(-1) <= (e - x).abs().amax(-1)
        between = ((x >= torch.minimum(g, e) - tol) & (x <= torch.maximum(g, e) + tol)).all(-1)
        sides &= nearer | between
    tie = bad & near & sides
    worst = 0.0
    for name, g, e, x in pairs:
        err = (g - e).abs()
        worst = max(worst, err[~tie].max().item())
        log(f"{prefix}: K2 on {label}: max |K2 - plain| on {name} {err[~tie].max().item():.3e} over {int((~tie).sum())} "
            f"envs (tolerance {MEGA_TOL[name]} abs + rel; {int(near.sum())} of them with a sphere within {K2_TIE} m of the "
            f"plane), {err[tie].max().item() if bool(tie.any()) else 0.0:.3e} over the {int(tie.sum())} ties; max |K2 - "
            f"float64 plain| {(g - x).abs().max().item():.3e}, max |plain - float64 plain| {(e - x).abs().max().item():.3e}")
    if bool((bad & ~tie).any()) or not bool(torch.isfinite(got[0]).all() & torch.isfinite(got[1]).all()):
        raise AssertionError(f"{prefix}: K2 on {label} differs from its plain version beyond MEGA_TOL in "
                             f"{int((bad & ~tie).sum())} envs that are not ties ({int((bad & ~near).sum())} with no sphere "
                             f"within {K2_TIE} m of the plane)")
    batch = q.shape[0]
    ms = device_ms(lambda: fused_step.mega_step(params, q, qd, action), rounds=5, per_round=20)
    profile = device_profile(lambda: fused_step.mega_step_reference(params, q, qd, action), calls=1)
    plain_ms = None if profile is None else profile[1]
    n_bytes = batch * q.element_size() * (4 * q.shape[1] + params.pd_q.numel()) + sum(
        getattr(params, f).numel() * getattr(params, f).element_size() for f in fused_step.POINTER_FIELDS
    )
    n_ops = op_count.needed_flops(fused_step.mega_step_reference, params, q, qd, action)
    bandwidth, f32_rate, f64_rate = card
    t_bytes, t_ops = n_bytes / bandwidth * 1e3, n_ops / (f32_rate if q.dtype == torch.float32 else f64_rate) * 1e3
    contacts = int((fused_step.sphere_distances(params, q) < 0).sum())
    shape = fused_step.launch_shape(params, batch)
    log(f"{prefix}: K2 on {label} B={batch} {str(q.dtype)[6:]}, {contacts} contacts active: max |K2 - plain| {worst:.3e} "
        f"(tolerance {MEGA_TOL['q']} on q, {MEGA_TOL['qd']} on qd, abs + rel); {ms * 1e3:.2f} us on the device, plain "
        f"{'not measured' if plain_ms is None else f'{plain_ms * 1e3:.1f} us of device time'}, bound "
        f"{max(t_bytes, t_ops) * 1e3:.3f} us ({n_bytes} bytes, {n_ops} flops), {ms / max(t_bytes, t_ops):.1f}x the bound")
    log_launch_shape(f"{prefix}: K2 B={batch}", shape)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, "contacts_active": contacts,
            "shape": f"B={batch} links=22 dof=18 spheres=4 {str(q.dtype)[6:]}", **launch_fields(shape)}


def mocap_check_run(device):
    """EAGER_STEPS float64 steps of the mocap tracking at batch
    MOCAP_CHECK_BATCH through the eager step (K1) on ``device`` (None: the
    card, through graphs), from the tool's start lowered 2.5 cm so that the
    toes touch; the tool's outputs on the CPU."""
    from tds_tpu_torch.tools import mocap_track

    env = mocap_track.make_env(torch.float64, device, fused=False)
    q0, qd0 = mocap_track.start_state(mocap_track.make_env(torch.float64, "cpu", fused=False), MOCAP_CHECK_BATCH, seed=1)
    q0[:, 2] -= 0.025
    speed = mocap_track.speedups(MOCAP_CHECK_BATCH, dtype=torch.float64)
    out = mocap_track.track(env, mocap_track.load_motion(torch.float64, env.device), speed.to(env.device), steps=EAGER_STEPS,
                            start=(q0.to(env.device), qd0.to(env.device)))
    return {key: out[key].cpu() for key in ("q", "qd", "rms", "height_min", "up_min")}


def mocap_device_vs_cpu(tmp):
    """(a): :func:`mocap_check_run` on the card against the CPU process's
    run; within 1e-9 abs + rel."""
    got_all = mocap_check_run(None)
    wait_for(os.path.join(tmp, "mocap_cpu.pt"))
    want_all = torch.load(os.path.join(tmp, "mocap_cpu.pt"))
    worst = 0.0
    for key, want in want_all.items():
        got = got_all[key]
        worst = max(worst, (got - want).abs().max().item())
        if excess(got, want, 1e-9) > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"mocap (a): the card and the CPU differ beyond 1e-9 in {key}")
    log(f"mocap (a): {EAGER_STEPS} float64 steps of the tracking at batch {MOCAP_CHECK_BATCH} (K1, toes in contact) through "
        f"graphs on the card against the CPU process's: max |cuda - cpu| = {worst:.3e} over q, qd and the three criterion "
        "numbers (1e-9 abs + rel)")
    return worst


def mocap_path(card, card_line, fused):
    """(a): tools/mocap_track.py as a user runs it: MOCAP_BATCH laikagos x
    2500 float32 steps of the dance, each at its own speed (env 0 at 1.0),
    a step a replayed graph, through K2 (``fused``) or the eager step (K1);
    the kernel's wrapper launches counted from 0 just before and read just
    after (the warm-up and the capture), env 0 held to the example's
    criterion, the share of the batch that meets it, env-steps/s, the
    graph's nodes, a trace of PROFILE_STEPS replayed steps (device
    operations, the kernel once a step); then the kernel against its plain
    version on the operands of a step from the final states, timed.
    Returns (the kernels-line entry, numbers, the final q)."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.tools import mocap_track
    from tds_tpu_torch.utils import graphs

    kind = "K2" if fused else "eager"
    prefix = f"mocap (a) {kind}"
    env = mocap_track.make_env(torch.float32, None, fused)
    motion = mocap_track.load_motion(torch.float32, env.device)
    speed = mocap_track.speedups(MOCAP_BATCH, dtype=torch.float32, device=env.device)
    counter = fused_step if fused else pgs
    torch.cuda.synchronize()
    cached = graphs.stats()
    counter.launches = 0
    _, first_s = timed_call(lambda: mocap_track.track(env, motion, speed, steps=2))
    out, run_s = timed_call(lambda: mocap_track.track(env, motion, speed))
    launches = counter.launches
    check_wrapper_launches(prefix, "K2" if fused else "K1", launches, cached)
    steps = mocap_track.STEPS
    rate = MOCAP_BATCH * steps / run_s
    rms, height, up, ok = (out[k].cpu() for k in ("rms", "height_min", "up_min", "ok"))
    share = ok.double().mean().item()
    nodes = [g.nodes for g in graph_lines(prefix, "mocap track", env) if g.batch == MOCAP_BATCH]
    log(f"{prefix}: {MOCAP_BATCH} laikagos x {steps} float32 steps of the dance at speedups {mocap_track.SPEEDUP_RANGE} "
        f"through {'K2' if fused else 'the eager step (K1 at 12 rows)'} in {run_s:.2f} s = {run_s * 1e3 / steps:.3f} ms/step, "
        f"{rate:.1f} env-steps/s, {card_line} (the 2-step call that captures the graph {first_s:.2f} s); graph {nodes} nodes a "
        f"step; {'K2' if fused else 'K1'} wrapper launches {launches} (the warm-up and the capture)")
    log(f"{prefix}: env 0 (speedup 1.0): joint RMS after the first fifth {rms[0]:.4f} rad (< {mocap_track.RMS_MAX}), base "
        f"height min {height[0]:.3f} m (> {mocap_track.HEIGHT_MIN}), up.z min {up[0]:.3f} (> {mocap_track.UP_MIN}): "
        f"{'tracking OK' if ok[0] else 'tracking FAILED'}; {int(ok.sum())} of {MOCAP_BATCH} envs ({100 * share:.1f}%) meet "
        f"the criterion; RMS {rms.min():.4f}-{rms.max():.4f}, height min {height.min():.3f}, up.z min {up.min():.3f}")
    if not bool(ok[0]):
        raise AssertionError(f"{prefix}: env 0 fails the example's criterion")
    kernel = "megastep_kernel" if fused else "pgs_kernel"
    with sub_phase(f"{prefix} seconds: the {PROFILE_STEPS}-step trace"):
        profile = device_profile(lambda: mocap_track.track(env, motion, speed, steps=PROFILE_STEPS), calls=1, kernel=kernel,
                                 expected=PROFILE_STEPS)
    if profile is None or profile[3] != PROFILE_STEPS:
        raise AssertionError(f"{prefix}: {kernel} ran {None if profile is None else profile[3]} times in {PROFILE_STEPS} "
                             "replayed steps")
    ops, busy, wall, count = profile
    log(f"{prefix}: {PROFILE_STEPS} replayed steps: {kernel} {count:.0f} times (torch.profiler), {ops / PROFILE_STEPS:.0f} "
        f"device operations a step, {100 * (1 - busy / wall):.1f}% idle under the profiler")
    k = torch.full_like(speed, float(steps))
    common = {"route": "cuda", "launches": launches, "replayed_launches_per_step": count / PROFILE_STEPS,
              "main_path": f"the mocap dance through {'K2' if fused else 'the eager step'}, {MOCAP_BATCH} envs x {steps} "
                           "steps (phase 19 (a))", "library_ms": None}
    if fused:
        with recorded_k2_calls({0}) as calls:
            mocap_track.track_step(env, motion, out["q"], out["qd"], k, speed)
        q, qd, action, got = calls[0]
        entry = {"name": "megastep mocap", "source": "tds_tpu_torch/csrc/megastep.cu",
                 "replaces": "tools/pallas_megastep_experiment.py:76 (main.<locals>.kernel)", **common,
                 **k2_on_operands("the mocap step", env.step_params, (q, qd, action), got, card, prefix)}
    else:
        with graphs.eager(), recorded_pgs_calls() as calls:
            mocap_track.track_step(env, motion, out["q"], out["qd"], k, speed)
        (solve,) = k1_on_calls("the mocap step", calls, card, prefix)
        entry = {"name": "pgs n=12 mocap", "source": "tds_tpu_torch/csrc/pgs.cu",
                 "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", **common, **solve}
    numbers = {f"mocap_{kind}_env_steps_per_s": rate, f"mocap_{kind}_ms_per_step": run_s * 1e3 / steps,
               f"mocap_{kind}_graph_nodes": nodes, f"mocap_{kind}_env0": [rms[0].item(), height[0].item(), up[0].item()],
               f"mocap_{kind}_share": share, f"mocap_{kind}_device_ops_per_step": ops / PROFILE_STEPS}
    return entry, numbers, out["q"]


def ars_state(dtype, device="cuda"):
    """policy_r2b.pkl's params and statistics in ``dtype``, the generator
    seeded ARS_SHARD_SEED: every rank and the one-process run draw alike."""
    from tds_tpu_torch.convert import ars_state_from_numpy, load_checkpoint

    saved, _ = load_checkpoint(str(CHECKPOINT))
    return ars_state_from_numpy(saved["params"], saved["obs_stat"], ARS_SHARD_SEED, dtype, device)


def ars_results(state, metrics):
    """An iteration's outputs as a flat dict of CPU tensors."""
    out = {"params": state.params, "total_timesteps": state.total_timesteps}
    out.update({f"obs_stat.{f}": getattr(state.obs_stat, f) for f in ("count", "mean", "m2")})
    out.update(metrics)
    return {k: torch.as_tensor(v).detach().cpu() for k, v in out.items()}


def ars_rank(rank, world, store, out_dir):
    """(b) (ii)'s rank: joins a gloo group on the one card through the file
    store, waits for (b)'s go file, then per dtype an iteration of the
    recipe split over the ranks that captures the graphs and a timed one
    from the same start, and saves the timed one's results and seconds."""
    import torch.distributed as dist

    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.parallel.distributed import initialize_distributed
    from tds_tpu_torch.parallel.mesh import make_mesh

    device = initialize_distributed(f"file://{store}", world, rank, backend="gloo", device="cuda:0")
    mesh = make_mesh(device)
    wait_for(os.path.join(out_dir, "go"))
    saved = {}
    for dtype in (torch.float32, torch.float64):
        env = LaikagoEnv(dtype=dtype, fused_step=True)
        step = ars.make_train_step(env, MLPSpec(36, [12]), ars.ARSConfig(**ARS_RECIPE), mesh=mesh)
        step(ars_state(dtype))
        dist.barrier()
        (new, metrics), seconds = timed_call(lambda: step(ars_state(dtype)))
        saved[str(dtype)] = {**ars_results(new, metrics), "seconds": seconds}
    torch.save(saved, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def compare_results(label, got, want, tol):
    """Raises where ``got`` and ``want`` differ beyond tol (1 + |want|) (0:
    bit for bit), or hold NaN in other places (policy_r2b.pkl's m2 is NaN
    throughout); returns the largest difference elsewhere."""
    worst = 0.0
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        nan = w.isnan()
        if not torch.equal(g.isnan(), nan):
            raise AssertionError(f"{label}: {key} holds NaN in other places")
        g, w = g[~nan], w[~nan]
        if not w.numel():
            continue
        worst = max(worst, (g - w).abs().max().item())
        if excess(g, w, tol) > 0 or (tol == 0 and not torch.equal(g, w)):
            raise AssertionError(f"{label}: {key} differs by {(g - w).abs().max().item():.3e}")
    return worst


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def policy_batch_check():
    """(b): ARS's policy with a weight matrix per env (``MLPSpec.apply``, a
    product and a sum) gives each env the same bits at batch 256 as in its
    half computed alone, in both dtypes, which (ii)'s bit-equality needs;
    ``einsum`` (cuBLAS's batched product) does not, and its difference is
    printed. Returns {dtype: einsum's largest difference}."""
    from tds_tpu_torch.learn.nn import MLPSpec

    policy, out = MLPSpec(36, [12]), {}
    for dtype in (torch.float32, torch.float64):
        g = torch.Generator(device="cuda").manual_seed(0)
        params = torch.randn(2 * ARS_RECIPE["num_directions"], policy.num_parameters, generator=g, device="cuda", dtype=dtype)
        x = torch.randn(params.shape[0], 36, generator=g, device="cuda", dtype=dtype)
        half = params.shape[0] // ARS_RANKS
        if not torch.equal(policy.apply(params, x)[:half], policy.apply(params[:half], x[:half])):
            raise AssertionError(f"ARS ranks (b): MLPSpec.apply of per-env weights depends on the batch in {dtype}")
        w = policy.unflatten(params)[0][0]
        einsum = torch.einsum("...ij,...j->...i", w, x)
        out[str(dtype)[6:]] = (einsum[:half] - torch.einsum("...ij,...j->...i", w[:half], x[:half])).abs().max().item()
    log(f"ARS ranks (b): the policy of per-env weights at batch {params.shape[0]} equals its first {half} envs computed "
        f"alone bit for bit in float32 and float64; einsum there differs by {out['float32']:.3e} (float32) and "
        f"{out['float64']:.3e} (float64)")
    return out


def ars_one_card(card_line):
    """(b) (i): bench.py's ARS recipe (ARS_RECIPE, float32, from
    policy_r2b.pkl) at world size 1 under NCCL, joined in this process from
    the variables torchrun sets: the split iteration equals the one-process
    iteration on the same draws bit for bit; s/iteration of both. Then the
    one-process float64 iteration that (ii) is held to. Returns (numbers,
    the one-process results by dtype)."""
    import torch.distributed as dist

    from tds_tpu_torch.envs.laikago import LaikagoEnv
    from tds_tpu_torch.learn import ars
    from tds_tpu_torch.learn.nn import MLPSpec
    from tds_tpu_torch.parallel.distributed import initialize_distributed
    from tds_tpu_torch.parallel.mesh import make_mesh

    policy, config = MLPSpec(36, [12]), ars.ARSConfig(**ARS_RECIPE)
    saved_env = {k: os.environ.get(k) for k in TORCHRUN_VARIABLES}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    try:
        mesh = make_mesh(initialize_distributed())
        backend = dist.get_backend()
        env = LaikagoEnv(dtype=torch.float32, fused_step=True)
        one = ars.make_train_step(env, policy, config)
        split = ars.make_train_step(env, policy, config, mesh=mesh)
        one(ars_state(torch.float32))  # captures the graphs
        split(ars_state(torch.float32))  # and NCCL's communicator at its first all_reduce
        results, seconds = {}, {}
        for label, fn in (("one process", one), ("world size 1", split)):
            (new, metrics), seconds[label] = timed_call(lambda: fn(ars_state(torch.float32)))
            results[label] = ars_results(new, metrics)
        dist.destroy_process_group()
    finally:
        for key, value in saved_env.items():
            os.environ.pop(key, None) if value is None else os.environ.__setitem__(key, value)
    compare_results("ARS ranks (b) (i)", results["world size 1"], results["one process"], 0.0)
    log(f"ARS ranks (b) (i): the recipe ({config.num_directions} directions x {config.rollout_length} steps, top "
        f"{config.top_directions}, float32) at world size 1 under {backend} (joined from MASTER_ADDR/MASTER_PORT/"
        f"WORLD_SIZE/RANK/LOCAL_RANK as torchrun sets them) equals the one-process iteration on the same draws bit for bit "
        f"over params, obs_stat and metrics; {seconds['world size 1']:.3f} s an iteration split, "
        f"{seconds['one process']:.3f} s one process, {card_line}")
    env64 = LaikagoEnv(dtype=torch.float64, fused_step=True)
    one64 = ars.make_train_step(env64, policy, config)
    one64(ars_state(torch.float64))
    (new, metrics), seconds64 = timed_call(lambda: one64(ars_state(torch.float64)))
    numbers = {"ars_world1_s_per_iteration": seconds["world size 1"], "ars_one_process_s_per_iteration": seconds["one process"],
               "ars_one_process_float64_s_per_iteration": seconds64}
    return numbers, {"torch.float32": results["one process"], "torch.float64": ars_results(new, metrics)}


def wait_for(path, timeout_s=600):
    """Returns once ``path`` exists; raises after ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)


def child_env():
    """This process's environment for a process of this script or of the
    port: the checkout on PYTHONPATH, no torchrun variables."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    for key in TORCHRUN_VARIABLES:
        env.pop(key, None)
    return env


def ars_ranks_start(tmp):
    """Starts (b) (ii)'s ARS_RANKS rank processes: they import and join
    their group beside (a), and wait for :func:`ars_go` before they use the
    card; returns them."""
    return [subprocess.Popen([sys.executable, __file__, "--ars-rank", str(r), str(ARS_RANKS), os.path.join(tmp, "store"), tmp],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO), env=child_env())
            for r in range(ARS_RANKS)]


def ars_go(tmp):
    """Lets (b) (ii)'s ranks use the card and starts (iii)'s torchrun of the
    trainer (``torchrun --standalone --nproc_per_node=1 -m
    tds_tpu_torch.tools.ars_train``, 2 iterations from policy_r2b.pkl, its
    checkpoint and Experiment logs under ``tmp``); returns the trainer."""
    with open(os.path.join(tmp, "go"), "w"):
        pass
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
                             "tds_tpu_torch.tools.ars_train", "--resume", str(CHECKPOINT), "--iterations", "2",
                             "--eval_interval", "2", "--rollout_length", "400", "--checkpoint",
                             os.path.join(tmp, "trainer", "policy.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO), env=child_env())


def ars_jobs_finish(tmp, ranks, trainer, want, card_line):
    """(b) (ii): both ranks' results equal bit for bit, and within
    ARS_SHARD_TOL_* of the one-process iteration (``want``); (iii): the
    trainer's checkpoint at iteration 2 and its Experiment run (settings
    and 2 metrics rows). Returns the numbers."""
    from tds_tpu_torch.convert import load_checkpoint

    numbers = {}
    for r, proc in enumerate(ranks):
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"ARS ranks (b) (ii): rank {r} exited {proc.returncode}:\n{out.decode()[-4000:]}")
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(ARS_RANKS)]
    for dtype, tol in (("torch.float32", ARS_SHARD_TOL_F32), ("torch.float64", ARS_SHARD_TOL_F64)):
        per_rank = [{k: v for k, v in g[dtype].items() if k != "seconds"} for g in got]
        compare_results(f"ARS ranks (b) (ii) {dtype} ranks", per_rank[1], per_rank[0], 0.0)
        worst = compare_results(f"ARS ranks (b) (ii) {dtype}", per_rank[0], want[dtype], tol)
        ranks_s = [g[dtype]["seconds"] for g in got]
        log(f"ARS ranks (b) (ii): {dtype[6:]}: {ARS_RANKS} processes on the one card under gloo, "
            f"{ARS_RECIPE['num_directions'] // ARS_RANKS} directions each: both ranks' params, obs_stat and metrics equal "
            f"bit for bit; against one process max |diff| {worst:.3e} ({tol} abs + rel); {max(ranks_s):.3f} s an iteration "
            f"(ranks {', '.join(f'{s:.3f}' for s in ranks_s)}; beside (c) and (iii), which share the card and the host), "
            f"{card_line}")
        numbers[f"ars_{ARS_RANKS}_ranks_{dtype[6:]}_s_per_iteration"] = max(ranks_s)
        numbers[f"ars_{ARS_RANKS}_ranks_{dtype[6:]}_max_diff"] = worst
    out, _ = trainer.communicate(timeout=300)
    if trainer.returncode != 0:
        raise AssertionError(f"ARS ranks (b) (iii): torchrun exited {trainer.returncode}:\n{out.decode()[-4000:]}")
    folder = os.path.join(tmp, "trainer")
    saved, meta = load_checkpoint(os.path.join(folder, "policy.pkl"))
    runs = [d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d))]
    rows = []
    if len(runs) == 1 and os.path.exists(os.path.join(folder, runs[0], "settings.json")):
        with open(os.path.join(folder, runs[0], "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    if meta.get("iteration") != 2 or [r["step"] for r in rows] != [0, 1] or \
            not all(math.isfinite(float(x)) for x in saved["params"].reshape(-1)):
        raise AssertionError(f"ARS ranks (b) (iii): checkpoint {meta}, runs {runs}, logged steps {[r['step'] for r in rows]}")
    log(f"ARS ranks (b) (iii): torchrun --standalone --nproc_per_node=1 -m tds_tpu_torch.tools.ars_train --resume "
        f"policy_r2b.pkl --iterations 2: checkpoint at iteration {meta['iteration']}, Experiment run {runs[0]} with "
        f"settings.json and {len(rows)} metrics rows (eval_reward_min {rows[-1].get('eval_reward_min', float('nan')):.2f})")
    return numbers


def compat_run(device, steps, record=None):
    """The pytinydiffsim-style script on ``device`` in float64: the laikago
    through compat.UrdfParser and a TinyWorld, its 12 leg joints servoed
    (TinyServoActuator: kp 100, kd 2, 50 N m) to the initial poses from a
    base lowered to 0.45 m, ``steps`` steps of tests/test_compat.py's loop
    (forward_dynamics, the velocity update, the world's contact pass, the
    position update); every step's (q, qd)."""
    from tds_tpu_torch import compat
    from tds_tpu_torch.dynamics.integrator import integrate_q
    from tds_tpu_torch.envs.laikago import LAIKAGO_INITIAL_POSES

    mb = compat.UrdfParser.load_urdf(COMPAT_URDF, device=device)
    world = compat.TinyWorld(device=device)
    world.bodies.append(mb)
    targets = compat.VectorX(LAIKAGO_INITIAL_POSES, device=device)
    q = mb.q.clone()
    q[2], q[6:] = 0.45, targets
    mb.set_q(q)
    servo = compat.TinyServoActuator(12, kp=100.0, kd=2.0, min_force=-50.0, max_force=50.0)
    base = mb.q.new_zeros(6)
    out = []
    for _ in range(steps):
        mb.set_tau(torch.cat([base, servo.compute_torques(mb.q[6:], mb.qd[6:], targets)]))
        compat.forward_dynamics(mb, world.gravity)
        mb.qd = mb.qd + mb.qdd * 1e-3
        mb.qdd = torch.zeros_like(mb.qdd)
        world.step(1e-3)
        q, qd = integrate_q(mb.model, mb.q[None], mb.qd[None], 1e-3)
        mb.q, mb.qd = q[0], qd[0]
        out.append((mb.q, mb.qd))
    return out, (mb, world)


def compat_cpu_start(tmp):
    """Starts phase 19's CPU process (this script with ``--compat-cpu``):
    (a)'s float64 check and compat_run on the CPU, then both renders of
    :func:`render_check`. It runs beside (a), whose replays leave the host
    idle."""
    return subprocess.Popen([sys.executable, __file__, "--compat-cpu", tmp], cwd=str(REPO), env=child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def compat_cpu(tmp):
    """Phase 19's CPU process: (a)'s float64 check on the CPU and (c)'s
    compat script on the CPU, saved; then, once
    (a) has saved the poses of the mocap's env 0 from the card, that frame
    rasterised from them and from the same state's poses on the CPU."""
    torch.set_num_threads(1)
    torch.save(mocap_check_run("cpu"), os.path.join(tmp, "mocap_cpu.pt.part"))
    os.replace(os.path.join(tmp, "mocap_cpu.pt.part"), os.path.join(tmp, "mocap_cpu.pt"))  # whole when it appears
    torch.save([(q, qd) for q, qd in compat_run("cpu", COMPAT_STEPS)[0]], os.path.join(tmp, "compat_cpu.pt"))
    wait_for(os.path.join(tmp, "render_card.pkl"))
    with open(os.path.join(tmp, "render_card.pkl"), "rb") as f:
        q, card_instances = pickle.load(f)
    images, seconds = [], []
    for instances in (card_instances, render_instances(q, "cpu")[0]):
        t0 = time.perf_counter()
        images.append(render_frame(q, instances))
        seconds.append(time.perf_counter() - t0)
    np.savez(os.path.join(tmp, "render.npz"), card=images[0], cpu=images[1], seconds=np.array(seconds))


def compat_path(card, reference):
    """(c): the compat script on the card (K1 at n = 12, B = 1 in each
    world.step) against the CPU in float64 over COMPAT_STEPS steps within
    1e-9 abs + rel, K1's wrapper launches (one a step) and its count in a
    trace of COMPAT_TRACE_STEPS steps (a B = 1 step is ~150 ms of host
    dispatch), K1 against its plain version on a step's
    operands, timed. Returns (the entry, numbers)."""
    from tds_tpu_torch import compat
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.envs import fused_step
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    proc, path = reference
    out, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"compat (c): the CPU run exited {proc.returncode}:\n{out.decode()[-4000:]}")
    want = torch.load(path)
    pgs.launches = 0
    (got, (mb, world)), seconds = timed_call(lambda: compat_run(None, COMPAT_STEPS))
    launches = pgs.launches
    if launches != COMPAT_STEPS:
        raise AssertionError(f"compat (c): {COMPAT_STEPS} card steps launched K1 {launches} times")
    worst = 0.0
    for k, ((gq, gqd), (wq, wqd)) in enumerate(zip(got, want)):
        for g, w in ((gq, wq), (gqd, wqd)):
            worst = max(worst, (g.cpu() - w).abs().max().item())
            if excess(g.cpu(), w, 1e-9) > 0 or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"compat (c): the card and the CPU differ beyond 1e-9 at step {k + 1}")
    params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, device="cpu"))
    touching = sum(int((fused_step.sphere_distances(params, w[0][None]) < 0).sum()) for w in want)
    if touching == 0:
        raise AssertionError("compat (c): no toe touched the ground")

    def steps(n):
        for _ in range(n):
            compat.forward_dynamics(mb, world.gravity)
            world.step(1e-3)

    profile = device_profile(lambda: steps(COMPAT_TRACE_STEPS), calls=1, kernel="pgs_kernel", expected=COMPAT_TRACE_STEPS)
    if profile is None or profile[3] != COMPAT_TRACE_STEPS:
        raise AssertionError(f"compat (c): K1 ran {None if profile is None else profile[3]} times in {COMPAT_TRACE_STEPS} steps")
    with recorded_pgs_calls() as calls:
        world.step(1e-3)
    (solve,) = k1_on_calls("the compat world's step", calls, card, "compat (c)")
    log(f"compat (c): the laikago through compat.UrdfParser and TinyWorld, {COMPAT_STEPS} float64 steps of the "
        f"pytinydiffsim loop on the card in {seconds:.2f} s ({seconds * 1e3 / COMPAT_STEPS:.1f} ms/step, B = 1, host-paced) "
        f"against the CPU: max |cuda - cpu| = {worst:.3e} (1e-9 abs + rel), {touching} toe-steps in contact; K1 wrapper "
        f"launches {launches} (one a world.step), {profile[3]:.0f} K1 kernels in a trace of {COMPAT_TRACE_STEPS} steps")
    entry = {"name": "pgs n=12 compat", "route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu",
             "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", "library_ms": None, "launches": launches,
             "main_path": f"the compat script, the laikago at B = 1 for {COMPAT_STEPS} steps (phase 19 (c))", **solve}
    return entry, {"compat_float64_card_vs_cpu": worst, "compat_ms_per_step": seconds * 1e3 / COMPAT_STEPS}


RENDER_URDF = "laikago/laikago_toes_zup_xyz_xyzrot.urdf"


def render_instances(q, device):
    """The laikago's renderer instances at ``q`` from ``device``'s
    kinematics (the card's in float32, the CPU's in float64) and the
    seconds it took."""
    from tds_tpu_torch.urdf.cache import construct, load_document
    from tds_tpu_torch.utils.file_utils import find_file
    from tds_tpu_torch.visualizer import renderer

    t0 = time.perf_counter()
    model = construct(RENDER_URDF)[0]
    if device != "cpu":
        model, q = model.to(device, torch.float32), q.to(device, torch.float32)
    instances = renderer.scene_instances_from_urdf(load_document(RENDER_URDF), model, q, os.path.dirname(find_file(RENDER_URDF)))
    return instances, time.perf_counter() - t0


def render_frame(q, instances):
    """The 320x240 frame of ``instances`` and the plane, the camera beside
    the base at ``q``."""
    from tds_tpu_torch.visualizer import renderer

    base = q[:3].double().cpu().numpy()
    cam = renderer.Camera.look_at(eye=base + (0.9, -0.8, 0.3), target=base + (0.0, 0.0, -0.1), width=320, height=240)
    pv, pf = renderer.plane_mesh()
    return renderer.render_scene(cam, [*instances, renderer.Instance(pv, pf, np.zeros(3), np.eye(3), (0.5, 0.5, 0.55))])


def render_poses(q_card, tmp):
    """(c), first half: the mocap's env 0 after its run, its instances
    from the card's float32 kinematics, saved with the state for the CPU
    process to rasterise; returns the seconds."""
    instances, seconds = render_instances(q_card, "cuda")
    with open(os.path.join(tmp, "render_card.pkl.part"), "wb") as f:
        pickle.dump((q_card.double().cpu(), instances), f)
    os.replace(os.path.join(tmp, "render_card.pkl.part"), os.path.join(tmp, "render_card.pkl"))  # whole when it appears
    return seconds


def render_check(tmp, pose_s):
    """(c), second half: the frame rasterised from the card's poses and
    from the CPU's (float64) for the same state, by the CPU process: at
    most RENDER_TOL of the pixels may differ."""
    with np.load(os.path.join(tmp, "render.npz")) as saved:
        card, cpu, seconds = saved["card"], saved["cpu"], saved["seconds"]
    differ = (card != cpu).any(-1).mean()
    robot = (cpu != cpu[0, 0]).any(-1).mean()
    log(f"render (c): env 0 of the mocap run rendered at 320x240 from the card's float32 poses ({pose_s:.2f} s on the card) "
        f"and from the CPU's float64 ones, rasterised by the CPU process beside (a) ({seconds[0]:.2f} and {seconds[1]:.2f} "
        f"s): {100 * differ:.3f}% of the pixels differ (at most {100 * RENDER_TOL}%), {100 * robot:.1f}% of the frame not "
        "background")
    if differ > RENDER_TOL or robot < 0.02:
        raise AssertionError(f"render (c): {differ:.4f} of the pixels differ, {robot:.4f} of the frame drawn")
    return {"render_pixels_differing": differ, "render_s": [pose_s, *seconds.tolist()]}


def phase_rest(card, card_line):
    """Phase 19: the rest of the port on the card. The CPU process ((a)'s
    float64 check and the compat script on the CPU, then the frame's two
    renders) and (b) (ii)'s ranks start first and run beside (a) (the ranks wait to use the card
    until (b) (i) is done); (iii)'s trainer and the ranks run beside (c).
    Returns the kernels line's entries (K2 and K1 on the mocap dance, K1 on
    the compat script) and the numbers."""
    import shutil
    import tempfile

    numbers = {}
    tmp = tempfile.mkdtemp(prefix="rest_")
    procs = [compat_cpu_start(tmp)]
    try:
        ranks = ars_ranks_start(tmp)
        procs += ranks
        with sub_phase("mocap (a) seconds"):
            fused, fused_numbers, q_final = mocap_path(card, card_line, fused=True)
            pose_s = render_poses(q_final[0], tmp)
            eager, eager_numbers = mocap_path(card, card_line, fused=False)[:2]
            numbers["mocap_float64_card_vs_cpu"] = mocap_device_vs_cpu(tmp)
        numbers.update(fused_numbers)
        numbers.update(eager_numbers)
        with sub_phase("ARS ranks (b) (i) seconds"):
            numbers["ars_einsum_batch_dependence"] = policy_batch_check()
            one_numbers, want = ars_one_card(card_line)
        numbers.update(one_numbers)
        trainer = ars_go(tmp)
        procs.append(trainer)
        with sub_phase("compat (c) seconds"):
            compat_entry, compat_numbers = compat_path(card, (procs[0], os.path.join(tmp, "compat_cpu.pt")))
            numbers.update(compat_numbers)
            numbers.update(render_check(tmp, pose_s))
        with sub_phase("ARS ranks (b) (ii), (iii) seconds, after (c)"):
            numbers.update(ars_jobs_finish(tmp, ranks, trainer, want, card_line))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    entries = [fused, eager, compat_entry]
    for entry in entries:
        log(f"rest: {json.dumps(entry)}")
    log(f"rest: {json.dumps(numbers)}")
    return entries, numbers


# -- phase 20 --------------------------------------------------------------
def warm_bounds(b, iterations, card):
    """(ms for the bytes, ms for the flops) of K1's forward, backward and
    JVP from a warm start, on operands whose b is ``b``: each as its zero
    start's bound (``pgs_bound``, ``k1_backward_bound``, ``k1_jvp_bound``)
    with the first sweep taking every column, as the later sweeps do (A and
    A' read whole; 2 flops for each off-diagonal product and sum, 6 in the
    JVP, 5 in the backward), and x0 (and x0', and x0-bar) read or written
    once."""
    bsz, n = b.shape
    size = b.element_size()
    bandwidth, f32_rate, f64_rate = card
    rate = f32_rate if b.dtype == torch.float32 else f64_rate
    forward = (size * (bsz * n * n + 5 * bsz * n) + 4 * n, bsz * iterations * n * (2 * (n - 1) + 4))
    backward = (size * bsz * (2 * n * n + 8 * n + (iterations - 1) * n) + 4 * n, bsz * iterations * n * (5 * (n - 1) + 20))
    jvp = (size * bsz * (2 * n * n + 10 * n) + 4 * n, bsz * iterations * n * (6 * (n - 1) + 30))
    return {k: (v[0] / bandwidth * 1e3, v[1] / rate * 1e3) for k, v in
            (("forward", forward), ("backward", backward), ("jvp", jvp))}


def warm_problem(batch, n, dtype, gen):
    """random_rows_problem's operands, its dependencies and a warm start x0
    of standard normal draws: some entries below a normal row's 0 and
    some outside a friction row's +-0.5 x_n."""
    operands, dep = random_rows_problem(batch, n, dtype, gen)
    x0 = torch.randn(batch, n, generator=gen, dtype=torch.float64, device=gen.device)
    return operands, dep, x0.to(dtype)


def over_tol(got, want, rtol, atol):
    """(max |got - want|, how far the worst entry lies past atol + rtol
    |want|: negative inside)."""
    err = (got - want).abs()
    return err.max().item(), (err - (atol + rtol * want.abs())).max().item()


def k1_warm_case(label, operands, dep, x0, it, gen):
    """K1's forward, backward and JVP from the warm start x0 against their
    plain versions on the same operands: x within pgs_tol (float64 1e-12
    relative), the five gradients (x0-bar among them) of a random
    cotangent within rtol 1e-4, atol 1e-5 max|grad| in float32 (1e-12 in
    float64), x and x' for random tangents of all five within rtol 1e-5,
    atol 1e-6 max|x'| (1e-12); raises past any. Returns the largest
    difference of each. In float32 the plain versions run in float64 on
    the same float32 operands: from a warm start the first sweep sums every
    column, and the float32 plain sweep's own rounding (a row's sum of all
    its products less the diagonal's, in float32) then exceeds the float32
    tolerance at n >= 48 (5.7e-6 from float64 at n = 48, 3 sweeps, x0 of
    scale 2, on the CPU), where the blocked kernels sum in double."""
    from tds_tpu_torch.contact import pgs

    a, b, lo, hi = operands
    n = b.shape[-1]
    f32 = b.dtype == torch.float32
    dep = tuple(dep)
    plain = [t.double() for t in (a, b, lo, hi, x0)]
    x, xs = pgs._launch(a, b, lo, hi, dep, it, x0, save=True)
    ref = pgs.solve_pgs_reference(*plain[:4], dep, it, plain[4])
    rtol, atol = pgs_tol(b.dtype, n) if f32 else (1e-12, 1e-12)
    worst = {"forward": over_tol(x.double(), ref, rtol, atol)}
    x_bar = torch.randn(b.shape, generator=gen, dtype=b.dtype, device=b.device)
    got = pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar, x0, xs)
    inputs = [t.clone().requires_grad_() for t in plain]
    with torch.enable_grad():
        want = torch.autograd.grad(pgs.solve_pgs_reference(*inputs[:4], dep, it, inputs[4]), inputs, x_bar.double())
    errs = []
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        errs.append(over_tol(g.double(), w, *((1e-4, 1e-5 * scale) if f32 else (1e-12, 1e-12 * scale))))
    worst["backward"] = (max(e[0] for e in errs), max(e[1] for e in errs))
    worst["x0_bar"] = errs[4]
    tangents = [torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device) for t in (a, b, lo, hi, x0)]
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, it, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, it, x0, tangents[4])
    scale = max(1.0, want_dot.abs().max().item())
    x_err = over_tol(got_x.double(), want_x, rtol, atol)
    dot_err = over_tol(got_dot.double(), want_dot, *((1e-5, 1e-6 * scale) if f32 else (1e-12, 1e-12 * scale)))
    worst["jvp"] = (max(x_err[0], dot_err[0]), max(x_err[1], dot_err[1]))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in (x, *got, got_x, got_dot))
    bad = [k for k, (_, over) in worst.items() if over > 0]
    if bad or not finite:
        raise AssertionError(f"K1 from a warm start disagrees with its plain version on {label} in {bad or 'finiteness'}: "
                             f"{ {k: v[0] for k, v in worst.items()} }")
    return {k: v[0] for k, v in worst.items()}


def warm_timing(card):
    """K1 with and without the warm start at WARM_TIMED (float32, one
    sweep, random problems): forward, backward and JVP device times (median
    of 100 launches), the plain versions' (event spans, host-paced), the
    bounds, and the zero start's time beside PERF.md's figures."""
    from tds_tpu_torch.contact import pgs

    gen = torch.Generator(device="cuda").manual_seed(201)
    rows = {}
    for n, batch in WARM_TIMED:
        (a, b, lo, hi), dep, x0 = warm_problem(batch, n, torch.float32, gen)
        dep = tuple(dep)
        x = pgs._launch(a, b, lo, hi, dep, 1, x0)
        x_bar = torch.randn(b.shape, generator=gen, dtype=b.dtype, device=b.device)
        tangents = [torch.randn(t.shape, generator=gen, dtype=t.dtype, device=t.device) for t in (a, b, lo, hi, x0)]
        times = {
            "zero_start": lambda: pgs._launch(a, b, lo, hi, dep, 1),
            "forward": lambda: pgs._launch(a, b, lo, hi, dep, 1, x0),
            "backward": lambda: pgs._launch_backward(a, b, lo, hi, dep, 1, x, x_bar, x0),
            "jvp": lambda: pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, 1, x0, tangents[4]),
        }
        ms = {k: device_ms(fn, rounds=5, per_round=20) for k, fn in times.items()}
        inputs = [t.clone().requires_grad_() for t in (a, b, lo, hi, x0)]
        with torch.enable_grad():
            ref_x = pgs.solve_pgs_reference(*inputs[:4], dep, 1, inputs[4])
        plain = {
            "forward": span_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, 1, x0), reps=3),
            "backward": span_ms(lambda: torch.autograd.grad(ref_x, inputs, x_bar, retain_graph=True), reps=3),
            "jvp": span_ms(lambda: pgs.solve_pgs_jvp_reference(a, b, lo, hi, tangents, dep, 1, x0), reps=3),
        }
        bounds = warm_bounds(b, 1, card)
        low, high = ZERO_START_US[n]
        moved = ms["zero_start"] * 1e3 / high - 1 if ms["zero_start"] * 1e3 > high else (
            ms["zero_start"] * 1e3 / low - 1 if ms["zero_start"] * 1e3 < low else 0.0)
        log(f"rest of the API (a): K1 B={batch} n={n} it=1 float32 ({pgs.form(torch.float32, n)}): zero start "
            f"{ms['zero_start'] * 1e3:.2f} us (PERF.md {low}-{high} us: {100 * moved:+.1f}% outside that band, 5% allowed); "
            f"warm start forward {ms['forward'] * 1e3:.2f} us, backward {ms['backward'] * 1e3:.2f} us, JVP "
            f"{ms['jvp'] * 1e3:.2f} us; plain {plain['forward'] * 1e3:.1f}, {plain['backward'] * 1e3:.1f}, "
            f"{plain['jvp'] * 1e3:.1f} us (event spans, host-paced); bounds "
            + ", ".join(f"{k} {max(v) * 1e3:.3f} us ({'bytes' if v[0] >= v[1] else 'operations'})" for k, v in bounds.items()))
        rows[n] = {"ms": ms, "plain_ms": plain, "bounds": bounds, "zero_start_outside_band": moved,
                   "shape": f"B={batch} n={n} iterations=1 float32"}
    return rows


def warm_public_path():
    """mlcp.solve_pgs, the JAX package's public PGS, as a user calls it on
    the card at WARM_PATH (float32, one sweep, x0 and b requiring grad):
    its value, torch.autograd.grad of a loss and torch.func.jvp with
    tangents of x0 and b, with the warm-start counters set to 0 just before
    and read just after: one launch of each kernel. Returns the counts."""
    from tds_tpu_torch.contact import mlcp, pgs

    gen = torch.Generator(device="cuda").manual_seed(202)
    n, batch = WARM_PATH
    (a, b, lo, hi), dep, x0 = warm_problem(batch, n, torch.float32, gen)
    x0_grad, b_grad = x0.clone().requires_grad_(), b.clone().requires_grad_()
    pgs.warm_launches = pgs.warm_backward_launches = pgs.warm_jvp_launches = 0
    x = mlcp.solve_pgs(a, b_grad, lo, hi, dep, x0_grad, 1)
    grads = torch.autograd.grad((x * x).sum(), (x0_grad, b_grad))
    _, x_dot = torch.func.jvp(lambda s, bb: mlcp.solve_pgs(a, bb, lo, hi, dep, s, 1), (x0, b),
                              (torch.ones_like(x0), torch.zeros_like(b)))
    torch.cuda.synchronize()
    counts = {"forward": pgs.warm_launches, "backward": pgs.warm_backward_launches, "jvp": pgs.warm_jvp_launches}
    with torch.enable_grad():
        inputs = (x0.clone().requires_grad_(), b.clone().requires_grad_())
        ref = pgs.solve_pgs_reference(a, inputs[1], lo, hi, dep, 1, inputs[0])
        want = torch.autograd.grad((ref * ref).sum(), inputs)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item()) for g, w in zip(grads, want))
    log(f"rest of the API (a): mlcp.solve_pgs B={batch} n={n} float32 from x0 under grad and torch.func.jvp: warm-start "
        f"launches {counts} (forward, backward, JVP); its gradient in x0 and b {err:.3e} from the plain version's "
        f"(relative to max |grad|); x' finite {bool(torch.isfinite(x_dot).all())}")
    if counts["forward"] < 1 or counts["backward"] != 1 or counts["jvp"] != 1 or err > 1e-4 \
            or not bool(torch.isfinite(x_dot).all()):
        raise AssertionError(f"rest of the API (a): mlcp.solve_pgs launched the warm-start kernels {counts} times (at least "
                             f"1, 1, 1 expected: the forward, the backward, the JVP), or its gradient is {err:.3e} off")
    return counts


def warm_kernels(card):
    """(a): K1's warm-start instances against their plain versions at
    WARM_ROWS, float32 and float64, 1 and 3 sweeps, all three forms of
    each; the public path's launches; the times. Returns the kernels
    line's three entries."""
    gen = torch.Generator(device="cuda").manual_seed(200)
    worst = {"forward": 0.0, "backward": 0.0, "x0_bar": 0.0, "jvp": 0.0}
    for n, batch in WARM_ROWS:
        for dtype in (torch.float32, torch.float64):
            for it in (1, 3):
                operands, dep, x0 = warm_problem(batch, n, dtype, gen)
                errs = k1_warm_case(f"random B={batch} n={n} it={it} {dtype}", operands, dep, x0, it, gen)
                worst = {k: max(v, errs[k]) for k, v in worst.items()}
                log(f"rest of the API (a): K1 from x0, random B={batch} n={n} it={it} {str(dtype)[6:]} (forms "
                    f"{pgs_forms(dtype, n)}): max |kernel - plain| forward {errs['forward']:.3e}, backward "
                    f"{errs['backward']:.3e} (x0-bar {errs['x0_bar']:.3e}), JVP {errs['jvp']:.3e}")
    counts = warm_public_path()
    rows = warm_timing(card)
    n = WARM_PATH[0]
    row = rows[n]
    entries = []
    for kind, name in (("forward", "pgs warm start"), ("backward", "pgs warm start backward"), ("jvp", "pgs warm start jvp")):
        t_bytes, t_ops = row["bounds"][kind]
        entries.append({
            "name": name, "route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu",
            "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel from x0: tds_tpu/contact/mlcp.py:94 solve_pgs"
                        + ("" if kind == "forward" else f", its {'VJP' if kind == 'backward' else 'JVP'}") + ")",
            "launches": counts[kind], "max_abs_err": worst[kind], "ms": row["ms"][kind], "plain_ms": row["plain_ms"][kind],
            "plain_timing": "event span, host-paced", "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None, "shape": row["shape"],
            "main_path": f"mlcp.solve_pgs at B={WARM_PATH[1]} n={n}, under grad and torch.func.jvp (a)",
            "zero_start_ms": row["ms"]["zero_start"],
            "other_row_counts": [{"rows": m, "ms": r["ms"][kind], "zero_start_ms": r["ms"]["zero_start"],
                                  "plain_ms": r["plain_ms"][kind], "bound_ms": max(r["bounds"][kind]),
                                  "zero_start_outside_band": r["zero_start_outside_band"]}
                                 for m, r in sorted(rows.items()) if m != n],
        })
        if kind == "backward":
            entries[-1]["x0_bar_max_abs_err"] = worst["x0_bar"]
    return entries


def pgs_forms(dtype, n):
    from tds_tpu_torch.contact import pgs

    return "/".join(pgs.form(dtype, n, **kw) for kw in ({}, {"backward": True}, {"jvp": True}))


def humanoid_pool_env(dtype, device=None):
    from tds_tpu_torch.envs.humanoid import HumanoidEnv

    with np.load(POOL) as pool:
        return HumanoidEnv(dtype=dtype, device=device, reset_pool=(pool["q"], pool["qd"]), reset_pool_prob=POOL_PROB)


def humanoid_ppo(card, card_line, cpu):
    """(b): PPO on the humanoid from logs/humanoid_ars/pool_r5.npz (p =
    POOL_PROB) at the ant recipe's shape (float32, PPO_RECIPE),
    HUMANOID_PPO_ITERATIONS iterations from seed 0 through the graphs, K1
    at n = 105 in its blocked form; K1's wrapper launches counted from 0
    just before and read just after, the auto-resets' pool share against
    POOL_PROB (binomial bounds), s/iteration and env-steps/s; K1 in a
    trace of a short collect; K1 on a collect step's operands against its
    plain version, timed; a float64 iteration against the CPU process's
    (``cpu``). Returns the kernels line's entry and numbers."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.learn import ppo
    from tds_tpu_torch.utils import graphs

    env = humanoid_pool_env(torch.float32)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(64, 64))
    cfg = ppo.PPOConfig(num_envs=PPO_RECIPE["num_envs"], unroll_length=PPO_RECIPE["unroll"], num_minibatches=8, num_epochs=4,
                        init_log_std=-1.0)
    init_fn, step_fn = ppo.make_ppo(env, nets, cfg)
    state = init_fn(0)
    if pgs.form(torch.float32, 105) != "blocked":
        raise AssertionError("humanoid PPO (b): K1 would not run its blocked form at 105 rows")
    torch.cuda.synchronize()
    cached = graphs.stats()
    pgs.launches = 0
    rows = []
    for _ in range(HUMANOID_PPO_ITERATIONS):
        (state, metrics), seconds = timed_call(lambda: step_fn(state))
        rows.append((seconds, {k: v.item() for k, v in metrics.items()}))
    launches = pgs.launches
    check_wrapper_launches("humanoid PPO (b)", "PGS", launches, cached)
    if not all(bool(torch.isfinite(p).all()) for p in state.params.values()):
        raise AssertionError("humanoid PPO (b): a parameter is not finite")
    steps = cfg.num_envs * cfg.unroll_length
    resets = sum(m["resets"] for _, m in rows)
    pooled = sum(m["pool_resets"] for _, m in rows)
    share = pooled / max(resets, 1)
    sigma = math.sqrt(POOL_PROB * (1 - POOL_PROB) / max(resets, 1))
    for i, (seconds, m) in enumerate(rows):
        log(f"humanoid PPO (b): iteration {i + 1} ({cfg.num_envs} envs x {cfg.unroll_length} steps, float32, K1 at 105 rows, "
            f"blocked): {seconds:.3f} s{' with the captures' if i == 0 else ''}, {steps / seconds:.1f} env-steps/s; "
            f"{m['resets']:.0f} auto-resets, {m['pool_resets']:.0f} from the pool, at most {m['env_resets_max']:.0f} of one "
            f"env, {m['reset_slots']:.0f} slots; reward_mean {m['reward_mean']:.4f}, episode_done_rate "
            f"{m['episode_done_rate']:.4f} ({card_line})")
    log(f"humanoid PPO (b): {pooled:.0f} of {resets:.0f} auto-resets took a pool state: {share:.3f} against p = {POOL_PROB} "
        f"(binomial sigma {sigma:.3f}); K1 wrapper launches over {HUMANOID_PPO_ITERATIONS} iterations {launches} "
        "(warm-ups and captures)")
    if resets < 20 or abs(share - POOL_PROB) > 4 * sigma:
        raise AssertionError(f"humanoid PPO (b): {pooled} of {resets} auto-resets from the pool, outside 4 sigma of "
                             f"{POOL_PROB} (or fewer than 20 resets)")
    seconds = rows[-1][0]
    bench_line("ppo_humanoid_pool_env_steps_per_s", steps / seconds, "steps/s", card_line, num_envs=cfg.num_envs,
               unroll=cfg.unroll_length, iteration_s=seconds, pool_share=share)
    # the trace: a collect of HUMANOID_PPO_TRACE_STEPS steps with one reset
    # slot, K1 once a collect step and once a settle step of its resets
    short = cfg._replace(unroll_length=HUMANOID_PPO_TRACE_STEPS)
    draws = ppo.draw_iteration(env, short, state.generator, torch.float32, reset_slots=1)
    profile = device_profile(lambda: ppo.collect(env, nets, short, state, draws), calls=1, kernel="pgs_kernel",
                             expected=HUMANOID_PPO_TRACE_STEPS + env.settle_steps)
    if profile is None or profile[3] != HUMANOID_PPO_TRACE_STEPS + env.settle_steps:
        raise AssertionError(f"humanoid PPO (b): {None if profile is None else profile[3]} K1 kernels in a traced collect of "
                             f"{HUMANOID_PPO_TRACE_STEPS} steps and {env.settle_steps} settle steps")
    ops, busy, wall, count = profile
    log(f"humanoid PPO (b): a traced {HUMANOID_PPO_TRACE_STEPS}-step collect with {env.settle_steps} settle steps: "
        f"{ops:.0f} device operations, busy {busy:.3f} of {wall:.3f} ms ({100 * (1 - busy / wall):.1f}% idle), K1 "
        f"{count:.0f} times")
    # K1 on the operands of a collect step at the recipe's batch
    gen = torch.Generator(device="cuda").manual_seed(203)
    with graphs.eager(), recorded_pgs_calls() as calls:
        env.step(state.env_state, torch.zeros(cfg.num_envs, env.action_dim, device="cuda"))
    a, b, lo, hi, dep, it = calls[0]
    if tuple(b.shape) != (cfg.num_envs, 105):
        raise AssertionError(f"humanoid PPO (b): the step's MLCP has shape {tuple(b.shape)}, not ({cfg.num_envs}, 105)")
    err, _ = k1_against_plain("the humanoid PPO step", [a, b, lo, hi], dep, it)
    timing = k1_timing("humanoid PPO step", [a, b, lo, hi], dep, it, card, prefix="humanoid PPO (b)")
    entry = {"name": "pgs n=105 humanoid PPO", "route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu",
             "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel)", "library_ms": None, "launches": launches,
             "replayed_launches_per_step": count / (HUMANOID_PPO_TRACE_STEPS + env.settle_steps), "max_abs_err": err,
             "main_path": "PPO on the humanoid from pool_r5.npz (b)", **timing}
    numbers = {"humanoid_ppo_iteration_s": [r[0] for r in rows], "humanoid_ppo_env_steps_per_s": steps / seconds,
               "humanoid_ppo_resets": resets, "humanoid_ppo_pool_resets": pooled, "humanoid_ppo_pool_share": share,
               "humanoid_ppo_launches": launches, "humanoid_ppo_collect_device_ops": ops,
               "humanoid_ppo_collect_idle_share": 1 - busy / wall}
    numbers["humanoid_ppo_float64_card_against_cpu"] = humanoid_ppo_card_against_cpu(cpu)
    return entry, numbers


def humanoid_ppo_run(device):
    """One float64 PPO iteration on the pool humanoid on ``device`` (4 envs x
    8 steps, 2 minibatches, 1 epoch, the torso of envs 0 and 1 dropped below
    the done height so that they reset in the unroll, env 0 from the pool
    and env 1 not): (the params, Adam's moments, the envs' states, the
    statistics and the metrics on the CPU, resets, pool resets)."""
    from tds_tpu_torch.envs.base import EnvState
    from tds_tpu_torch.learn import ppo

    cfg = ppo.PPOConfig(num_envs=4, unroll_length=8, num_minibatches=2, num_epochs=1, learning_rate=1e-3, init_log_std=-1.0)
    cpu_env = humanoid_pool_env(torch.float64, "cpu")
    start, _ = cpu_env.reset(torch.Generator().manual_seed(1), batch_size=cfg.num_envs,
                             pool_draws=(torch.zeros(cfg.num_envs, dtype=torch.bool), torch.zeros(cfg.num_envs, dtype=torch.int64)))
    q = start.q.clone()
    q[:2, 2] = 0.5  # below the torso's done height of 0.8 m
    draws = ppo.draw_iteration(cpu_env, cfg, torch.Generator().manual_seed(2), torch.float64, reset_slots=cfg.unroll_length)
    draws = draws._replace(reset_pool=(torch.tensor([[True, False, True, False]] * draws.reset_noise.shape[0]),
                                       draws.reset_pool[1]))
    env = cpu_env if device == "cpu" else humanoid_pool_env(torch.float64, device)
    nets = ppo.PPONetworks(env.observation_dim, env.action_dim, hidden=(16, 16))
    state = ppo.make_ppo(env, nets, cfg)[0](0)
    state = state._replace(env_state=EnvState(q.to(device), start.qd.to(device), start.t.to(device)),
                           obs=cpu_env.observation(q, start.qd).to(device))
    new, metrics = ppo.ppo_iteration(env, nets, cfg, state, draws.to(device))
    flat = [new.params[k] for k in ("policy", "value", "log_std")] + [new.opt_state.mu[k] for k in ("policy", "value")]
    flat += [new.env_state.q, new.env_state.qd, new.obs, *new.obs_stat, *metrics.values()]
    return [t.cpu() for t in flat], int(metrics["resets"]), int(metrics["pool_resets"])


def api_cpu_start(tmp):
    """Starts phase 20's CPU process (this script with ``--api-cpu``): (b)'s
    float64 iteration on the CPU, beside (a) and (b) on the card."""
    return subprocess.Popen([sys.executable, __file__, "--api-cpu", tmp], cwd=str(REPO), env=child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def api_cpu(tmp):
    """Phase 20's CPU process: humanoid_ppo_run on the CPU, saved."""
    torch.set_num_threads(1)
    torch.save(humanoid_ppo_run("cpu"), os.path.join(tmp, "ppo_cpu.pt.part"))
    os.replace(os.path.join(tmp, "ppo_cpu.pt.part"), os.path.join(tmp, "ppo_cpu.pt"))  # whole when it appears


def humanoid_ppo_card_against_cpu(cpu):
    """humanoid_ppo_run on the card against the CPU's (``cpu``: the CPU
    process and its results' path), from the same draws, within 1e-9
    relative (abs below 1); both branches of the reset taken."""
    card, resets, pooled = humanoid_ppo_run("cuda")
    proc, path = cpu
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            raise AssertionError(f"humanoid PPO (b): the CPU process ended without its results:\n{proc.stdout.read().decode()}")
        time.sleep(0.05)
    want, cpu_resets, cpu_pooled = torch.load(path)
    worst = max(((g - w).abs() / w.abs().clamp_min(1.0)).max().item() for g, w in zip(card, want))
    log(f"humanoid PPO (b): one float64 iteration (4 envs x 8 steps, {resets} auto-resets, {pooled} from the pool) on the "
        "card against the CPU's (its own process) from the same draws: largest difference "
        f"{worst:.3e} relative (abs below 1; 1e-9)")
    if worst > 1e-9 or not 0 < pooled < resets or (resets, pooled) != (cpu_resets, cpu_pooled):
        raise AssertionError(f"humanoid PPO (b): the card's float64 iteration differs from the CPU's by {worst:.3e}, or its "
                             f"{resets} resets did not take both branches ({pooled} from the pool)")
    return worst


def phase_api(card, card_line):
    """Phase 20: the rest of the JAX package's API on the card: (a) K1's
    warm-start instances, (b) PPO on the humanoid from its reset pool. A
    CPU process beside them runs (b)'s float64 iteration on the CPU.
    Returns the kernels line's entries and the numbers."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="api_")
    proc = api_cpu_start(tmp)
    try:
        with sub_phase("rest of the API (a) seconds"):
            entries = warm_kernels(card)
        with sub_phase("humanoid PPO (b) seconds"):
            entry, numbers = humanoid_ppo(card, card_line, (proc, os.path.join(tmp, "ppo_cpu.pt")))
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    entries.append(entry)
    for e in entries:
        log(f"rest of the API: {json.dumps({k: v for k, v in e.items() if k != 'other_row_counts'})}")
    log(f"rest of the API: {json.dumps(numbers)}")
    return entries, numbers


# -- phase 21 --------------------------------------------------------------
def backward_against_plain(label, operands, dep, it, x0, x, x_bar, got, xs):
    """K1's backward ``got`` (the gradients, x0-bar last from x0, for the
    cotangent ``x_bar`` of x = the forward's output on ``operands``, ``xs``
    its saved sweeps) against
    the plain version in float64 on the same operands. Float64: its
    autograd, 1e-12 relative, every env. Float32: along the forward's own
    sweeps (those it saved for the backward; tools/pgs_ab.py's
    plain_backward_along), rtol 1e-4 and atol 1e-5 max|grad|, on the envs
    with no clip near a tie (where the float32 forward's rounding may
    decide a clip the other way and move a gradient by a whole term), of
    which at most SWEEPS_NEAR_TIE of the envs may be. Raises past any.
    Returns the largest difference, the envs near a tie and (float32) the
    largest difference from the plain autograd in float64 over every env."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import pgs_ab

    a, b, lo, hi = operands
    ops = list(operands) + ([x0] if x0 is not None else [])
    plain = [t.double().clone().requires_grad_() for t in ops]
    with torch.enable_grad():
        ref = pgs.solve_pgs_reference(*plain[:4], dep, it, plain[4] if x0 is not None else None)
        want = torch.autograd.grad(ref, plain, x_bar.double())
    keep, near, every_env = slice(None), 0, None
    if b.dtype == torch.float32:
        every_env = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        want, near_envs = pgs_ab.plain_backward_along(ops, dep, torch.cat([xs, x[None]]) if it > 1 else x[None], x_bar)
        keep, near = ~near_envs, int(near_envs.sum())
        if near > SWEEPS_NEAR_TIE * b.shape[0]:
            raise AssertionError(f"sweeps: {label}: {near} of {b.shape[0]} envs have a clip near a tie")
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("A", "b", "lo", "hi", "x0"), got, want):
        scale = w.abs().max().item()
        err, over = over_tol(g.double()[keep], w[keep], *((1e-4, 1e-5 * scale) if every_env is not None else (1e-12, 1e-12 * scale)))
        if over > 0 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"sweeps: K1's backward disagrees with the plain version on {label} in {name}-bar: max "
                                 f"|kernel - plain| {err:.3e} (max |grad| {scale:.3e}; {near} envs near a tie left out)")
        worst = max(worst, err)
    return worst, near, every_env


def sweeps_against_plain(label, operands, dep, it, x0, gen):
    """K1's backward on these operands (from x0 when it is given) for a
    random cotangent, held by backward_against_plain."""
    from tds_tpu_torch.contact import pgs

    a, b, lo, hi = operands
    x, xs = pgs._launch(a, b, lo, hi, dep, it, x0, save=True)
    x_bar = torch.randn(b.shape, generator=gen, dtype=b.dtype, device=b.device)
    got = pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar, x0, xs)
    return backward_against_plain(label, operands, dep, it, x0, x, x_bar, got, xs)


def sweeps_timing(label, operands, dep, it, x0, gen):
    """The backward's device time alone (median of 100 launches on the
    sweeps the forward saved, tools/pgs_ab.py's Kernel), through its wrapper
    (``_launch_backward`` on those sweeps: no forward relaunched), the
    forward alone without and with its saves, a gradient as a user takes
    it (``torch.autograd.grad`` of ``solve_pgs``: the saving forward and
    the backward), the plain version's autograd (event span, host-paced),
    the bounds and the launch shape."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import pgs_ab

    a, b, lo, hi = operands
    bsz, n = b.shape
    warm = x0 is not None
    kernel = pgs_ab.Kernel("backward", warm, list(operands) + ([x0] if warm else []), list(dep), gen)
    x_bar = kernel.x_bar
    lib = pgs._library()
    ms = device_ms(lambda: kernel.run(lib, it), rounds=5, per_round=20)
    x, xs = pgs._launch(a, b, lo, hi, dep, it, x0, save=True)
    wrapper_ms = device_ms(lambda: pgs._launch_backward(a, b, lo, hi, dep, it, x, x_bar, x0, xs), rounds=5, per_round=20)
    forward_ms = device_ms(lambda: kernel.solve(lib, it), rounds=5, per_round=20)
    saving_ms = device_ms(lambda: kernel.solve_saving(lib, it), rounds=5, per_round=20)
    inputs = [t.clone().requires_grad_() for t in list(operands) + ([x0] if warm else [])]

    def gradient():
        return torch.autograd.grad(pgs.solve_pgs(*inputs[:4], dep, it, inputs[4] if warm else None), inputs, x_bar)

    gradient_ms = device_ms(gradient, rounds=5, per_round=10, backlog_ms=40)
    with torch.enable_grad():
        ref = pgs.solve_pgs_reference(*inputs[:4], dep, it, inputs[4] if warm else None)
    plain_ms = span_ms(lambda: torch.autograd.grad(ref, inputs, x_bar, retain_graph=True), reps=3)
    bound_us, bound_by = pgs_ab.bound_us("backward", warm, it, b)
    saving_bound_us = pgs_ab.bound_us("forward", warm, it, b, saving=True)[0]
    shape = pgs.launch_shape(b.dtype, n, bsz, backward=True, warm=warm, iterations=it)
    log(f"sweeps (a): K1 backward {label} ({shape['form']}): {ms * 1e3:.2f} us on the device alone, {wrapper_ms * 1e3:.2f} "
        f"us through the wrapper (on the saved sweeps), plain {plain_ms * 1e3:.1f} us (event span, host-paced), bound "
        f"{bound_us:.3f} us ({bound_by}), {ms * 1e3 / bound_us:.1f}x the bound; the forward {forward_ms * 1e3:.2f} us, "
        f"saving its {max(it - 1, 0)} sweeps {saving_ms * 1e3:.2f} us (bound {saving_bound_us:.3f} us); a gradient "
        f"through solve_pgs {gradient_ms * 1e3:.2f} us (bound {saving_bound_us + bound_us:.3f} us)")
    log_launch_shape(f"sweeps (a): K1 backward {label}", shape)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "forward_ms": forward_ms, "saving_forward_ms": saving_ms,
            "gradient_ms": gradient_ms, "saving_forward_bound_ms": saving_bound_us / 1e3,
            "gradient_bound_ms": (saving_bound_us + bound_us) / 1e3, "plain_ms": plain_ms,
            "plain_timing": "event span, host-paced", "bound_ms": bound_us / 1e3, "bound_by": bound_by,
            "design": shape["form"], **launch_fields(shape)}


def sweeps_kernels(card):
    """(a): K1's backward past one sweep and from x0 at SWEEPS_CASES, float32
    and float64 at the case's batch on random problems with the ties of
    tests/test_torch_pgs_grad.py in envs 1 and 2, held by
    backward_against_plain, the float32 one timed on its operands; on the
    Panda push's three solves of a step mid-stroke (phase 18's, 10 sweeps),
    timed at n = 24. Returns the timed rows by (rows, batch, sweeps, from
    x0) and the largest difference by form."""
    from tds_tpu_torch.contact import pgs

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows, worst = {}, {}
    for n, batch, it, warm in SWEEPS_CASES:
        for dtype in (torch.float32, torch.float64):
            operands, dep, x0 = warm_problem(batch, n, dtype, gen)
            if batch >= 3:
                n_c = n // 3 if n % 3 == 0 else max(1, n // 2)
                operands[1][1, :n_c] = -10.0 * operands[1][1, :n_c].abs() - 50.0 * operands[0][1, :n_c, :n_c].abs().sum(-1) - 1.0
                operands[1][2] = 0.0
            start = x0 if warm else None
            label = f"random B={batch} n={n} it={it} {'from x0 ' if warm else ''}{str(dtype)[6:]}"
            err, near, every_env = sweeps_against_plain(label, operands, tuple(dep), it, start, gen)
            form = pgs.form(dtype, n, backward=True, warm=warm, iterations=it)
            worst[form] = max(worst.get(form, 0.0), err)
            log(f"sweeps (a): K1 backward {label} ({form}): max |kernel - plain| {err:.3e}"
                + (f" on {batch - near} envs ({near} near a tie), {every_env:.3e} against the plain autograd over every env"
                   if every_env is not None else ""))
            if dtype == torch.float32:
                rows[n, batch, it, warm] = {"max_abs_err": err, "envs_near_a_tie": near,
                                            "max_abs_err_every_env_vs_plain_autograd": every_env,
                                            **sweeps_timing(label, operands, tuple(dep), it, start, gen)}
            else:
                rows[n, batch, it, warm]["float64_max_abs_err"] = err
    calls = RECORDED.get("panda_calls")
    if calls is None:  # phase 21 alone: the Panda push's step 401 as tools/pgs_ab.py --panda takes it
        from tds_tpu_torch.tools import pgs_ab

        calls = [(*ops, dep, it) for ops, dep, it in pgs_ab.panda_problems()]
    for k, (a, b, lo, hi, dep, it) in enumerate(calls):
        label = f"the Panda push's solve {k} B={b.shape[0]} n={b.shape[1]} it={it} float32"
        err, near, every_env = sweeps_against_plain(label, [a, b, lo, hi], tuple(dep), it, None, gen)
        form = pgs.form(b.dtype, b.shape[1], backward=True, iterations=it)
        worst[form] = max(worst.get(form, 0.0), err)
        log(f"sweeps (a): K1 backward on {label} ({form}): max |kernel - plain| {err:.3e} on {b.shape[0] - near} envs "
            f"({near} near a tie), {every_env:.3e} against the plain autograd over every env")
        if b.shape[1] == 24:
            rows["panda"] = {"max_abs_err": err, "envs_near_a_tie": near,
                             **sweeps_timing(label, [a, b, lo, hi], tuple(dep), it, None, gen)}
    return rows, worst


def traced_k1(fn, forward_expected):
    """(forward kernels, backward kernels) of K1 in a torch.profiler trace
    of ``fn()``: kernel names holding "pgs_kernel" (every forward instance)
    and "pgs_backward" (every backward one); the trace is taken again while
    the forward's count differs from ``forward_expected`` (counted_trace)."""
    events, _, _, forward = counted_trace(fn, "pgs_kernel", forward_expected)
    return forward, sum(1 for name, _ in events if "pgs_backward" in name)


def sweeps_paths():
    """(b): the public paths the saving forward and the new backward
    instances run on, each instance's wrapper count set to 0 just before
    and read just after:
    - the ball loss's gradient (tools/ball_loss.py, float64, a new world so
      that its graphs are captured: in the VJP graph's warm-up and capture
      K1's forward at n = 3 and 4 sweeps saves its sweeps and its backward
      runs once each; the forward graph's warm-up and capture launch the
      forward without saves), and a trace of a replayed GRAD_PROFILE_STEPS-
      step gradient: one forward kernel a VJP step beside the forward
      graph's one a step, one backward kernel a VJP step;
    - mlcp.solve_pgs from x0 at SWEEPS_PATHS (float32, SWEEPS_PATH_SWEEPS
      sweeps) under torch.autograd.grad (one forward and one backward launch
      by the wrapper's counts and in a trace of one gradient) and
      torch.func.jvp, each path's saved sweeps and x held row by row
      against the plain version in float64 along them (tools/pgs_ab.py's
      plain_forward_along at the 4-ulp margin of an instance that sums in
      double) and its gradients by backward_against_plain on them;
    - bindings_case's 50 sweeps.
    Returns {(path, kernel): (form, launches)} and bindings_case's rows."""
    from tds_tpu_torch.contact import mlcp, pgs
    from tds_tpu_torch.tools import ball_loss, pgs_ab

    out = {}
    shots = torch.tensor([ball_loss.VELOCITY, (1.2, -0.6)], dtype=torch.float64, device="cuda")
    world = ball_loss.ball_world()
    it = world.solver.pgs_iterations
    pgs.launches = pgs.backward_launches = 0
    _, grad = ball_loss.gradient(world, shots, BALL_LOSS_STEPS)
    torch.cuda.synchronize()
    out["ball loss", "forward"] = (pgs.form(torch.float64, 3, iterations=it), pgs.launches)
    out["ball loss", "backward"] = (pgs.form(torch.float64, 3, backward=True, iterations=it), pgs.backward_launches)
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError("sweeps (b): the ball loss's gradient is not finite")
    if (pgs.launches, pgs.backward_launches) != (4, 2):
        raise AssertionError(f"sweeps (b): the ball loss's graphs launched K1's forward {pgs.launches} and its backward "
                             f"{pgs.backward_launches} times (4 and 2: one forward without saves in the forward graph's "
                             "warm-up and capture, one saving forward and one backward in the VJP graph's)")
    ball_loss.gradient(world, shots, GRAD_PROFILE_STEPS)
    forward, backward = traced_k1(lambda: ball_loss.gradient(world, shots, GRAD_PROFILE_STEPS), 2 * GRAD_PROFILE_STEPS)
    out["ball loss", "replayed"] = (forward, backward)
    log(f"sweeps (b): a replayed {GRAD_PROFILE_STEPS}-step ball loss gradient ran K1's forward {forward} times (the "
        f"forward graph's {GRAD_PROFILE_STEPS} and the VJP graph's) and its backward {backward} times (torch.profiler): "
        f"{(forward - GRAD_PROFILE_STEPS) / GRAD_PROFILE_STEPS:.0f} forward launch a replayed VJP step")
    if (forward, backward) != (2 * GRAD_PROFILE_STEPS, GRAD_PROFILE_STEPS):
        raise AssertionError(f"sweeps (b): {forward} forward and {backward} backward kernels in a replayed "
                             f"{GRAD_PROFILE_STEPS}-step gradient")
    gen = torch.Generator(device="cuda").manual_seed(212)
    for n, batch in SWEEPS_PATHS:
        (a, b, lo, hi), dep, x0 = warm_problem(batch, n, torch.float32, gen)
        start = x0.clone().requires_grad_()
        it = SWEEPS_PATH_SWEEPS
        pgs.warm_launches = pgs.warm_backward_launches = pgs.warm_jvp_launches = 0

        def gradient():
            return torch.autograd.grad((mlcp.solve_pgs(a, b, lo, hi, dep, start, it) ** 2).sum(), start)

        x = mlcp.solve_pgs(a, b, lo, hi, dep, start, it)
        (g,) = torch.autograd.grad((x * x).sum(), start)
        torch.cuda.synchronize()
        counts = (pgs.warm_launches, pgs.warm_backward_launches)
        _, x_dot = torch.func.jvp(lambda s: mlcp.solve_pgs(a, b, lo, hi, dep, s, it), (x0,), (torch.ones_like(x0),))
        torch.cuda.synchronize()
        path = f"mlcp.solve_pgs B={batch} n={n}"
        out[path, "forward"] = (pgs.form(torch.float32, n, warm=True, iterations=it), counts[0])
        out[path, "backward"] = (pgs.form(torch.float32, n, backward=True, warm=True, iterations=it), counts[1])
        out[path, "jvp"] = (pgs.form(torch.float32, n, jvp=True, warm=True, iterations=it), pgs.warm_jvp_launches)
        out[path, "replayed"] = traced_k1(gradient, 1)
        if not (bool(torch.isfinite(g).all()) and bool(torch.isfinite(x_dot).all())):
            raise AssertionError(f"sweeps (b): {path}: its gradient or tangent is not finite")
        if counts != (1, 1) or out[path, "replayed"] != (1, 1):
            raise AssertionError(f"sweeps (b): {path}: a gradient launched K1's forward and backward {counts} times by the "
                                 f"wrapper's counts, {out[path, 'replayed']} in a trace (1 and 1)")
        # the x0-bar of the loss sum(x^2) the path took, against the plain version (all five gradients' rows)
        x = x.detach()
        y, xs = pgs._launch(a, b, lo, hi, tuple(dep), it, x0, save=True)
        got = pgs._launch_backward(a, b, lo, hi, tuple(dep), it, y, 2 * y, x0, xs)
        if not (torch.equal(y, x) and torch.equal(got[4], g)):
            raise AssertionError(f"sweeps (b): {path}: its x or x0-bar differs from the kernels' on the same operands")
        # the saving instance's own sweeps and x, row by row against the plain version in float64 along them
        x_err, x_over = pgs_ab.plain_forward_along([a, b, lo, hi, x0], dep, torch.cat([xs, x[None]]), double_sums=True)
        if x_over > 0:
            raise AssertionError(f"sweeps (b): {path}: a row's update lies {x_err:.3e} from the plain one in float64 "
                                 "from the kernel's x before it, past its rounding")
        err, near, _ = backward_against_plain(path, [a, b, lo, hi], tuple(dep), it, x0, x, 2 * x, got, xs)
        log(f"sweeps (b): {path}: each row's update within {x_err:.3e} of the plain one in float64 along the forward's "
            f"own sweeps; the backward's gradients against the plain version: max |kernel - plain| {err:.3e} on "
            f"{batch - near} envs ({near} near a tie)")
    bindings, bindings_counts = bindings_case(gen)
    out.update(bindings_counts)
    for (path, kind), (form, count) in out.items():
        if kind == "replayed":  # (forward, backward) kernels in a trace
            log(f"sweeps (b): {path}: K1's forward {form} and backward {count} times in a trace of a gradient")
            continue
        log(f"sweeps (b): {path}: K1 {kind} ({form}) wrapper launches {count}")
        if count < 1:
            raise AssertionError(f"sweeps (b): {path} launched K1's {kind} ({form}) no time")
    return out, bindings


def bindings_case(gen):
    """(b): mlcp.solve_pgs under torch.autograd.grad at the bindings'
    default BINDINGS_SWEEPS sweeps (compat.TinyMultiBodyConstraintSolver),
    n = 24, B = 4096, float32, from x0 = 0 (random operands, the gradients
    of sum(x^2) in all five): one forward launch, saving its 49 sweeps, and
    one backward launch by the wrapper's counts and in a trace; x and the
    saved sweeps against the plain version in float64 along the forward's
    own sweeps (tools/pgs_ab.py's plain_forward_along: each row's rounding,
    at the 4-ulp margin of an instance that sums in double; over 50 sweeps
    A's conditioning amplifies it), and x's distance from the plain forward
    in float64 no larger than the float32 plain forward's own; the
    gradients held along the forward's own sweeps by
    backward_against_plain; timed: the gradient through the wrapper
    (device), the saving forward and the forward without saves alone, the
    backward alone, the plain version's forward, each with its bound.
    Returns its rows and counts."""
    from tds_tpu_torch.contact import mlcp, pgs
    from tds_tpu_torch.tools import pgs_ab

    n, batch, it = 24, 4096, BINDINGS_SWEEPS
    (a, b, lo, hi), dep, _ = warm_problem(batch, n, torch.float32, gen)
    x0 = torch.zeros_like(b)
    inputs = [t.clone().requires_grad_() for t in (a, b, lo, hi, x0)]

    def gradient():
        x = mlcp.solve_pgs(*inputs[:4], dep, inputs[4], it)
        return x, torch.autograd.grad((x * x).sum(), inputs)

    pgs.warm_launches = pgs.warm_backward_launches = 0
    x, grads = gradient()
    torch.cuda.synchronize()
    counts = (pgs.warm_launches, pgs.warm_backward_launches)
    replayed = traced_k1(gradient, 1)
    path = f"mlcp.solve_pgs B={batch} n={n} {it} sweeps from x0 = 0"
    if counts != (1, 1) or replayed != (1, 1):
        raise AssertionError(f"sweeps (b): {path}: a gradient launched K1's forward and backward {counts} times by the "
                             f"wrapper's counts, {replayed} in a trace (1 and 1)")
    x = x.detach()
    y, xs = pgs._launch(a, b, lo, hi, tuple(dep), it, x0, save=True)
    got = pgs._launch_backward(a, b, lo, hi, tuple(dep), it, y, 2 * y, x0, xs)
    if not (torch.equal(y, x) and all(torch.equal(g, k) for g, k in zip(grads, got))):
        raise AssertionError(f"sweeps (b): {path}: its x or gradients differ from the kernels' on the same operands")
    # the forward against the plain version in float64 along its own sweeps, each row's update from the
    # kernel's x before it; over 50 sweeps A's conditioning amplifies each float32 version's rounding, so
    # x end to end is held to the float32 plain forward's own distance from the plain one in float64
    x_err, x_over = pgs_ab.plain_forward_along([a, b, lo, hi, x0], dep, torch.cat([xs, x[None]]), double_sums=True)
    if x_over > 0:
        raise AssertionError(f"sweeps (b): {path}: a row's update lies {x_err:.3e} from the plain one in float64 "
                             "from the kernel's x before it, past its rounding")
    plain64 = pgs.solve_pgs_reference(*(t.double() for t in (a, b, lo, hi, x0)[:4]), dep, it, x0.double())
    end_err = (x.double() - plain64).abs().max().item()
    plain32_err = (pgs.solve_pgs_reference(a, b, lo, hi, dep, it, x0).double() - plain64).abs().max().item()
    if not end_err <= plain32_err:
        raise AssertionError(f"sweeps (b): {path}: x lies {end_err:.3e} from the plain forward in float64, farther than "
                             f"the float32 plain forward's {plain32_err:.3e}")
    err, near, every_env = backward_against_plain(path, [a, b, lo, hi], tuple(dep), it, x0, x, 2 * x, got, xs)
    kernel = pgs_ab.Kernel("backward", True, [a, b, lo, hi, x0], list(dep), gen)
    lib = pgs._library()
    gradient_ms = device_ms(gradient, rounds=5, per_round=10, backlog_ms=40)
    forward_ms = device_ms(lambda: kernel.solve(lib, it), rounds=5, per_round=20)
    saving_ms = device_ms(lambda: kernel.solve_saving(lib, it), rounds=5, per_round=20)
    backward_ms = device_ms(lambda: kernel.run(lib, it), rounds=5, per_round=20)
    plain_ms = span_ms(lambda: pgs.solve_pgs_sweeps_reference(a, b, lo, hi, dep, it, x0), reps=1)
    bound_us = {k: pgs_ab.bound_us(kind, True, it, b, saving=saving) for k, kind, saving in
                (("forward", "forward", False), ("saving", "forward", True), ("backward", "backward", False))}
    log(f"sweeps (b): {path}: each row's update within {x_err:.3e} of the plain one in float64 along its own sweeps (x "
        f"{end_err:.3e} from the plain forward in float64, the float32 plain forward {plain32_err:.3e}); its gradients "
        f"max |kernel - plain| {err:.3e} on {batch - near} envs ({near} near a tie), {every_env:.3e} against the plain "
        f"autograd over every env; a gradient through the wrapper {gradient_ms * 1e3:.2f} us on the device (bound "
        f"{bound_us['saving'][0] + bound_us['backward'][0]:.3f} us), the saving forward {saving_ms * 1e3:.2f} us (bound {bound_us['saving'][0]:.3f} us), "
        f"without saves {forward_ms * 1e3:.2f} us, the backward alone {backward_ms * 1e3:.2f} us (bound "
        f"{bound_us['backward'][0]:.3f} us), the plain forward {plain_ms:.1f} ms (event span, host-paced)")
    rows = {"max_abs_err": x_err, "x_vs_plain_float64": end_err, "plain_float32_vs_float64": plain32_err,
            "gradient_max_abs_err": err, "envs_near_a_tie": near,
            "max_abs_err_every_env_vs_plain_autograd": every_env, "gradient_ms": gradient_ms,
            "ms": saving_ms, "forward_ms": forward_ms, "backward_ms": backward_ms,
            "plain_ms": plain_ms, "plain_timing": "event span, host-paced", "bound_ms": bound_us["saving"][0] / 1e3,
            "bound_by": bound_us["saving"][1], "backward_bound_ms": bound_us["backward"][0] / 1e3,
            "gradient_bound_ms": (bound_us["saving"][0] + bound_us["backward"][0]) / 1e3}
    counts_out = {(path, "forward"): (pgs.form(torch.float32, n, warm=True, iterations=it), counts[0]),
                  (path, "backward"): (pgs.form(torch.float32, n, backward=True, warm=True, iterations=it), counts[1]),
                  (path, "replayed"): replayed}
    return rows, counts_out


def warm_fault_case(card):
    """(c): the float32 row-per-lane warm forward and JVP on tools/pgs_ab.py
    --warm's and --jvp --warm's n = 24, B = 4096 problem (its random cases
    from seed 0), where they lay past the float32 tolerance until their
    sums ran in double: within rtol 1e-5, atol 1e-6 (max|x'|) of the plain
    versions in float64, timed. The blocked forward from x0 and at 10
    sweeps at BLOCKED_CASES against the plain version in float64, timed."""
    from tds_tpu_torch.contact import pgs
    from tds_tpu_torch.tools import pgs_ab

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel = next(c for c in pgs_ab.random_cases("jvp", (12, 24, 48, 105), None, 1, True, gen) if c[0] == 24)[3][0]
    (a, b, lo, hi, x0), dep, tangents = kernel.operands, tuple(kernel.dep), kernel.tangents
    plain = [t.double() for t in kernel.operands]
    x = pgs._launch(a, b, lo, hi, dep, 1, x0)
    x_err, x_over = over_tol(x.double(), pgs.solve_pgs_reference(*plain[:4], dep, 1, plain[4]), 1e-5, 1e-6)
    want_x, want_dot = pgs.solve_pgs_jvp_reference(*plain[:4], [t.double() for t in tangents], dep, 1, plain[4])
    got_x, got_dot = pgs._launch_jvp(a, b, lo, hi, *tangents[:4], dep, 1, x0, tangents[4])
    dot_err, dot_over = over_tol(got_dot.double(), want_dot, 1e-5, 1e-6 * max(1.0, want_dot.abs().max().item()))
    if x_over > 0 or dot_over > 0 or over_tol(got_x.double(), want_x, 1e-5, 1e-6)[1] > 0:
        raise AssertionError(f"warm fault (c): the float32 warm row-per-lane instances lie {x_err:.3e} (x) and {dot_err:.3e} "
                             "(x') from the plain versions in float64, past rtol 1e-5, atol 1e-6")
    lib = pgs._library()
    out = {"forward": {"max_abs_err": x_err, "ms": device_ms(lambda: kernel.solve(lib, 1), rounds=5, per_round=20),
                       "plain_ms": span_ms(lambda: pgs.solve_pgs_reference(a, b, lo, hi, dep, 1, x0), reps=3)},
           "jvp": {"max_abs_err": dot_err, "ms": device_ms(lambda: kernel.run(lib, 1), rounds=5, per_round=20),
                   "plain_ms": span_ms(lambda: pgs.solve_pgs_jvp_reference(a, b, lo, hi, tangents, dep, 1, x0), reps=3)}}
    for kind in ("forward", "jvp"):
        out[kind]["plain_timing"] = "event span, host-paced"
        bound_us, bound_by = pgs_ab.bound_us(kind, True, 1, b)
        out[kind].update(bound_ms=bound_us / 1e3, bound_by=bound_by)
        log(f"warm fault (c): K1 {kind} from x0 on pgs_ab --warm's B=4096 n=24 float32 problem (row per lane): max |kernel - "
            f"plain float64| {out[kind]['max_abs_err']:.3e} (rtol 1e-5, atol 1e-6{' max|x' + chr(39) + '|' if kind == 'jvp' else ''}), "
            f"{out[kind]['ms'] * 1e3:.2f} us, bound {bound_us:.3f} us ({bound_by})")
    for n, batch, it, warm in BLOCKED_CASES:
        operands, dep, x0 = warm_problem(batch, n, torch.float32, gen)
        start = x0 if warm else None
        got = pgs._launch(*operands, tuple(dep), it, start)
        want = pgs.solve_pgs_reference(*(t.double() for t in operands), dep, it, None if start is None else start.double())
        err, over = over_tol(got.double(), want, 1e-5, 1e-6)
        if over > 0:
            raise AssertionError(f"warm fault (c): the blocked forward B={batch} n={n} it={it} lies {err:.3e} from the plain "
                                 "version in float64")
        ms = device_ms(lambda: pgs._launch(*operands, tuple(dep), it, start), rounds=5, per_round=20)
        bound_us, bound_by = pgs_ab.bound_us("forward", warm, it, operands[1])
        out[f"blocked n={n} it={it}{' from x0' if warm else ''}"] = {"max_abs_err": err, "ms": ms, "bound_ms": bound_us / 1e3}
        log(f"warm fault (c): K1 blocked forward B={batch} n={n} it={it}{' from x0' if warm else ''} float32: max |kernel - "
            f"plain float64| {err:.3e}, {ms * 1e3:.2f} us, bound {bound_us:.3f} us ({bound_by})")
    return out


def phase_sweeps(card):
    """Phase 21: K1's backward past one sweep and from x0 (the "linearised
    sweeps" instances, A's upper part staged whole or streamed from L2),
    the blocked forward past one sweep, and the repaired float32 warm
    instances. Returns the kernels line's entries and the numbers."""
    from tds_tpu_torch.contact import pgs

    with sub_phase("sweeps (a) seconds"):
        rows, worst = sweeps_kernels(card)
    with sub_phase("sweeps (b) seconds"):
        paths, bindings = sweeps_paths()
    with sub_phase("warm fault (c) seconds"):
        fault = warm_fault_case(card)
    common = {"route": "cuda", "source": "tds_tpu_torch/csrc/pgs.cu", "library_ms": None,
              "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel; its gradient is jax.grad of "
                          "tds_tpu/contact/mlcp.py:94 solve_pgs)"}
    whole, streamed = pgs.FORMS[5], pgs.FORMS[4]
    ball = paths["ball loss", "backward"]
    public = paths[f"mlcp.solve_pgs B={SWEEPS_PATHS[1][1]} n={SWEEPS_PATHS[1][0]}", "backward"]
    if ball[0] != whole or public[0] != streamed:
        raise AssertionError(f"sweeps: the ball loss's backward ran {ball[0]}, mlcp.solve_pgs at n = 105 {public[0]}")
    main_whole, main_streamed = rows[3, 4096, 4, False], rows[105, 1024, SWEEPS_PATH_SWEEPS, True]
    bindings_path = f"mlcp.solve_pgs B=4096 n=24 {BINDINGS_SWEEPS} sweeps from x0 = 0"
    others = [{"rows": n, "batch": batch, "iterations": it, "from_x0": warm, **row}
              for (n, batch, it, warm), row in ((k, v) for k, v in rows.items() if k != "panda")]
    entries = [
        {"name": "pgs backward sweeps, A whole", **common, "launches": ball[1], **main_whole,
         "max_abs_err_every_case": worst.get(whole, 0.0), "shape": "B=4096 n=3 iterations=4 float32",
         "main_path": f"the {BALL_LOSS_STEPS}-step ball loss's gradient (n = 3, 4 sweeps), phase 21 (b)",
         "replayed_forward_and_backward_in_a_gradient": paths["ball loss", "replayed"],
         "bindings_n24_it50": {"launches": paths[bindings_path, "backward"][1], "ms": bindings["backward_ms"],
                               "bound_ms": bindings["backward_bound_ms"], "max_abs_err": bindings["gradient_max_abs_err"],
                               "envs_near_a_tie": bindings["envs_near_a_tie"]},
         "panda_n24_it10": rows.get("panda"),
         "other_cases": [r for r in others if r["design"] == whole]},
        {"name": "pgs backward sweeps, upper streamed", **common, "launches": public[1], **main_streamed,
         "max_abs_err_every_case": worst.get(streamed, 0.0),
         "shape": f"B=1024 n=105 iterations={SWEEPS_PATH_SWEEPS} from x0 float32",
         "main_path": f"mlcp.solve_pgs from x0 at B=1024 n=105, {SWEEPS_PATH_SWEEPS} sweeps, under grad, phase 21 (b)",
         "other_cases": [r for r in others if r["design"] == streamed]},
    ]
    entries.append({"name": "pgs saving forward, row per lane", **common, "source": "tds_tpu_torch/csrc/pgs_sweep.cuh",
                    "launches": paths[bindings_path, "forward"][1], **bindings,
                    "shape": f"B=4096 n=24 iterations={BINDINGS_SWEEPS} from x0 = 0 float32",
                    "main_path": f"{bindings_path} under grad (the bindings' default sweeps), phase 21 (b)"})
    n24 = f"mlcp.solve_pgs B={SWEEPS_PATHS[0][1]} n={SWEEPS_PATHS[0][0]}"
    for kind, name in (("forward", "pgs warm start row per lane (double sums)"), ("jvp", "pgs warm start jvp row per lane (double sums)")):
        entries.append({"name": name, "route": "cuda", "source": "tds_tpu_torch/csrc/pgs_sweep.cuh", "library_ms": None,
                        "replaces": "tds_tpu/contact/pallas_pgs.py:52 (_pgs_kernel from x0: tds_tpu/contact/mlcp.py:94 solve_pgs"
                                    + (", its JVP)" if kind == "jvp" else ")"),
                        "launches": paths[n24, kind][1], "shape": "B=4096 n=24 iterations=1 from x0 float32",
                        "launches_at": f"{SWEEPS_PATH_SWEEPS} sweeps",
                        "main_path": f"{n24} from x0 under grad and torch.func.jvp, phase 21 (b)", **fault[kind]})
    numbers = {f"k1_{k.replace(' ', '_').replace('=', '')}_us": v["ms"] * 1e3 for k, v in fault.items() if k.startswith("blocked")}
    for e in entries:
        log(f"sweeps: {json.dumps(e)}")
    return entries, numbers




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
    kernel["replayed_launches_per_step"] = main_path["replayed_launches_per_step"]
    timed(phase_trained_policy, env)
    mega = timed(phase_mega_step, card)
    probes = timed(phase_probes, card)
    mega.update(timed(phase_ars, card, mega, card_line))
    kernel.update(timed(phase_ant, card, card_line))
    k1_rows, humanoid = timed(phase_humanoid, card, card_line)
    terrain = timed(phase_terrain, card, card_line)
    backward = timed(phase_gradients, card, card_line)
    jvp, ppo_numbers = timed(phase_forward_and_ppo, card, card_line)
    floating, floating_numbers = timed(phase_floating, card, card_line, main_path["laikago_scan_rollout_env_steps_per_s"])
    mpc, mpc_numbers = timed(phase_mpc, card, card_line, main_path["laikago_scan_rollout_env_steps_per_s"])
    collision, collision_numbers = timed(phase_collision, card, card_line)
    rest, rest_numbers = timed(phase_rest, card, card_line)
    api, api_numbers = timed(phase_api, card, card_line)
    sweeps, sweeps_numbers = timed(phase_sweeps, card)
    # the paths' numbers on a line of their own, so that the kernels line stays short
    numbers = {f"main_path_{k}": v for k, v in main_path.items() if k != "launches"}
    for part in (humanoid, terrain, ppo_numbers, floating_numbers, mpc_numbers, collision_numbers, rest_numbers,
                 api_numbers, sweeps_numbers, timed(phase_graphs, start_s)):
        numbers.update(part)
    print(json.dumps({"numbers": numbers}))
    print(json.dumps({"kernels": [kernel, *k1_instances(kernel, k1_rows), backward, jvp, *floating, *mpc, *collision, *rest,
                                  *api, *sweeps, mega, *probes]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ars-rank"]:  # a rank of phase 19 (b) (ii), started by ars_ranks_start
        ars_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--compat-cpu"]:  # phase 19's CPU process, started by compat_cpu_start
        compat_cpu(sys.argv[2])
    elif sys.argv[1:2] == ["--api-cpu"]:  # phase 20's CPU process, started by api_cpu_start
        api_cpu(sys.argv[2])
    elif sys.argv[1:2] == ["--rest-only"]:  # phase 19 alone, after phases 1 and 2; prints no result line
        card_name, card_text = phase_device()
        timed(phase_build)
        timed(phase_rest, card_peaks(card_name), card_text)
    elif sys.argv[1:2] == ["--api-only"]:  # phase 20 alone, after phases 1 and 2; prints no result line
        card_name, card_text = phase_device()
        timed(phase_build)
        timed(phase_api, card_peaks(card_name), card_text)
    elif sys.argv[1:2] == ["--sweeps-only"]:  # phase 21 alone, after phases 1 and 2; prints no result line
        card_name, card_text = phase_device()
        timed(phase_build)
        timed(phase_sweeps, card_peaks(card_name))
    else:
        main()
