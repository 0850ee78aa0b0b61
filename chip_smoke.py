#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (iterativelqr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and nvcc.
Phases, each of which raises (non-zero exit) when it fails:

1. identity: card name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the port's kernels from csrc/ (one nvcc per source, all
   at once; timed), then the recursion's libraries at the registered
   models' dims (4, 1), (3, 2), (2, 1) and (12, 4) in f32 and f64 (one
   translation unit each, written by ops/packed_backward.py, all nvcc runs
   at once; timed), and prints ptxas's registers and spills per kernel;
3. K1 (csrc/riccati_backward.cuh) against its plain PyTorch version on the
   card at the main path's shapes (acrobot n=4, m=1, T=101, B=4096), and K2
   (csrc/riccati_backward_wide.cuh) at the quadrotor's (n=12, m=4, T=41,
   B=4096), in f64 and f32, each plus a batch with indefinite Quu on some
   lanes (ok = 0); median times of both, the bounds and the kernel's share
   of its bound, and K1's ring of step tiles (tiles, dynamic shared memory
   a block);
3b. K3 and K4 (csrc/sl_forward.cu) against their plain versions on the
   card: acrobot T=101, car T=51 and quadrotor T=41, B=4096, f64 and f32,
   K3 for the 8-candidate head (j0=0) and the 9-candidate tail (j0=8), K4
   at per-lane step sizes alpha = 2^-j, and K4's J equal to K3's J of
   candidate j on every lane; random non-converged gains from a numpy seed,
   car and quadrotor with inactive (c < 0, lam = 0) and active inequality
   rows; median times of both, the byte and operation bounds and the
   share of the bound, and the model's ring (or its direct loads);
3c. K5, K6a and K6b against their plain versions at B=4096, f64 and f32:
   on K1's template (csrc/riccati_backward.cuh) at (4, 1), T=101, and for
   K6a/K6b also (3, 2) with the last action masked and its derivative
   entries nonzero; on K2's template (csrc/riccati_backward_wide.cuh) at the
   quadrotor's (12, 4), T=41, the last action masked too; a per-lane
   regularizer; each with a batch whose Quu is indefinite on every 61st
   lane; the kernel's median time, its batch-leading entry's (with the
   transposes or packing; K5's launches are those of this entry), the plain
   version's, the bound and its share, and the template's ring;
4. the slice end to end: make_batched_solve_fn + batch_stats on acrobot
   T=101, f32, under the bench.py presets "tuned" and "parity", with
   bench.py's initial-guess protocol, each with the loop rollouts
   (forward_kernel="scan") and the rollout kernels ("pallas") on the same
   lanes in one run (tuned B=B_LOOP_TUNED=16, parity B=B_LOOP=4, both at
   T=T_LOOP=51), and
   both presets' kernels at B=4096; then car T=51 and quadrotor T=41
   (benchmarks/measure_all.py's protocol), B=4096, f32, under both; solved
   fraction from batch_stats and recomputed from the returned trajectories
   with constraint_values; K1 (acrobot, car) or K2 (quadrotor), K3 and K4
   launches counted over each timed solve; the per-iteration split of
   each into its phases' spans (utils/profiling.py) in each;
4c. the per-instance solver's vmap route at acrobot, f32 (bench.py's
   initial guess): the literal make_batched_solve_fn(spec, Options())
   (traces on, the "auto" backward = the reverse scan, loop rollouts) at
   B=B_VMAP_LOOP=14, T=T_VMAP_LOOP=41, and at B=B_VMAP_K6=16,
   T=T_LOOP=51 the tuned preset with
   traces through
   make_solve_fn(..., backward_impl=make_backward_dispatch(variant="v1" |
   "v2")).vmap() (K6a, K6b); then the same two dispatches on the quadrotor
   at T=41, B=4096 (the wide K6a, K6b on K2's template); solved fraction
   from batch_stats and recomputed, iterations, wall, K6 launches (equal to
   the backward attempts, the regularization loop's tests), loop trips
   and host syncs, every iteration's trace write
   (trace_mask's count plus the slots a truncated round's successor wrote
   again = iterations), and a per-iteration split of derive, backward and
   line search;
5. reference checks on small inputs: the card's "pallas" path against the
   port's plain CPU "scan" path (acrobot T=9, car and quadrotor T=8, B=4,
   f64: equal iterates); the vmap route on the card against the CPU
   (acrobot T=9, car T=8, B=4, f64) for Options(), the K6a and K6b
   dispatches and backward_pass="packed"; the committed golden acrobot
   T=101, car, quadrotor, particle and cartpole solutions
   (tests/fixtures/golden_*.npz) solved on the card through "pallas" in
   f64, and through the per-instance solver the golden car with
   backward_pass="scan" and the golden quadrotor with the default "auto"
   (on one instance the associative scan).  The CPU half of the first two
   checks runs in a worker process that needs no card, from phase 1 on
   (beside phases 2-4);
6a. the associative backward scan (ops/assoc.py) against the port's reverse
   scan on the card at (4, 1), (3, 2) T=101 and (12, 4) T=41, B=64 and one
   instance, f64 and f32; both timed (CUDA events, f32, acrobot's dims)
   unbatched and at B in {1, 14, 64, 512, 4096} x T in {101, 501}, with
   where the associative scan stops winning beside the JAX package's
   _assoc_wins rule (measured on a TPU v5e, kept);
6b. straggler compaction (core/solve_compact.py) on the kernel path on
   phase 4's B=4096 inputs, tuned at GRAIN 128, 256 and 1024 and parity at
   the module's GRAIN, each against phase 4's single-shot solution of the
   same preset and lanes: the batch shapes visited with their trips, the
   repacks, the rescues, K1/K3/K4 launches (in all and by shape), the wall
   against the single-shot wall, the recomputed solved fraction (>= 0.99)
   and the lanes whose iterations, xs and us equal the single-shot's
   bitwise; then the capped-rescue scenario of
   tests/test_torch_solve_compact.py (car T=8, B=16, f64, kernels): a lane
   fails without the rescue, every lane is feasible with it;
6c. the Solver shell on car T=51 in f64 (solve, warm_solve, reset_duals and
   warm_solve, each feasible), and parameter_gradient on
   tests/test_sensitivity.py's tracking problem at T=9 in f64 against
   central finite differences of the re-solved optimal value;
7a. K1, K5, K6a and K6b at particle's and pendulum's (n, m) = (2, 1), and
   K3/K4 for particle T=11, pendulum T=51 and cartpole T=101, against their
   plain versions at B=4096 in f64 and f32 as in phases 3, 3c and 3b, with
   their times and bounds;
7b. the SL solver ("auto": K1 and K3/K4 on the card), f32,
   Options(record_traces=False), B=4096 on particle T=11, pendulum T=51
   and cartpole T=101 (swingup_controls), x0 = x1 + 0.02 N(0,1): the
   recomputed solved fraction (>= 0.99), trips and launches;
7c. full DDP per instance in f64 (no kernel): particle T=11 equal to
   Gauss-Newton, and acrobot T=T_DDP from golden_acrobot.npz's first
   controls feasible within 1.05 of a Gauss-Newton solve's objective in the
   same run;
7d. make_mpc_controller on particle T=11 through tests/test_mpc.py's
   disturbance scenario (f64, per instance), and a farm of 4096 particle
   controllers (T=11, f32): one cold SL solve, then 12 warm steps of
   shift, closed-loop re-roll over the lanes and warm SL solve with the
   kernels, every plan feasible at every step; plans/s;
8a. generated device models (ops/device_functions.py) for three user
   problems written as torch lambdas and closures
   (tests/torch_user_problems.py): the acrobot's functions in lambdas,
   examples/mpc_farm.py's problem and examples/sensitivity_demo.py's (a
   target path in the per-step parameters w), and phase 8e's two; their
   nvcc runs started together, the build's seconds and ptxas's registers
   and spills in f32 and f64;
8b. their K3 (head j0=0, tail j0=8) and K4 against the plain versions at
   B=4096 in f64 and f32 (acrobot T=101, the farm and the demo T=11, the
   demo with a different target ramp on every lane), K4's J = K3's J, and
   the generated acrobot's J against the hand-written kernel's on the same
   inputs; times beside the hand-written acrobot's, bounds from the scalar
   program's operation count, shares;
8c. the SL solver on the generated models, B=4096, f32: tuned acrobot
   T=101 (bench.py's initial guess; trips against phase 4's), the farm of
   7d with the example's own tracking costs (plans/s against 7d's), and the
   demo with a target ramp a lane in w; solved fractions recomputed (>=
   0.99) and the generated symbols' K3/K4 launches (> 0);
8d. refusals: a stage cost with a data-dependent branch and one with an op
   outside the whitelist (a matrix decomposition) refuse under
   forward_kernel="pallas", naming it, and take the loops under "auto"
   with no K3/K4 launch;
8e. two problems as users write them (tests/torch_user_problems.py):
   models/quadrotor.py's at (12, 4), T=41, with a rotation matrix built
   with stack and used through @, the inertia a diagonal matrix with
   linalg.cross, quadratic-form costs; models/car.py's at T=51 with
   constant indexing, a vector_norm obstacle row and d @ Q @ d costs.  Their
   generated K3 (head, tail) and K4 against the plain versions at B=4096
   in f64 and f32, K4's J = K3's J, K3's J against the registered
   hand-written model's on the same inputs; times beside the hand-written
   kernels', bounds, shares; then B=4096 f32 SL solves with
   forward_kernel="pallas" from phase 4's inputs (K1 for the car, K2 for
   the quadrotor, the generated K3/K4): the recomputed solved fraction >=
   0.99 and within 0.01 of the registered model's phase 4 solve; and the
   generated K3/K4 of a problem using every elementwise function and
   reduction the generator lowers against their plain versions (f64,
   f32);
9a. iterativelqr_tpu_torch/examples/pod_sweep.py at its default size: 65,536
   instances at T=51, f32 (acrobot 32,768 and car 32,768 lanes) over
   default_mesh() (every visible card), "auto" rollouts: per family the
   wall, solves/s, the solved fraction recomputed from the returned
   trajectories (>= 0.99), iterations and K1/K3/K4 launches (K1, K3 > 0);
9b. make_sharded_solve_fn over [cuda:0, cuda:0] (two shards on one card,
   advanced trip by trip in turns) on phase 4's tuned kernel inputs: every
   lane's iterations, xs and us bitwise equal to phase 4's single-shot
   solve, the stats reduced across shards equal to its batch_stats (counts
   and maxima bitwise, means to f32 rounding); no speed is read;
9c. per-device compaction (make_compacted_solve_fn(devices=[cuda:0,
   cuda:0])) on phase 4's tuned kernel inputs, every lane bitwise equal to
   phase 4's single-shot tuned solve;
9d. the sharded solve across processes (tests/torch_distributed_worker.py):
   two gloo ranks on cuda:0 and one NCCL rank at world size 1 (NCCL refuses
   two ranks on one card), particle T=11, B=4096, f32, K1/K3/K4 in every
   rank; each rank's global xs and stats equal the other's and a
   one-process solve's bitwise; the gloo ranks also run the time-sharded
   recursion across the two processes (pendulum linearizations, f64),
   equal on both ranks and within 1e-12 of the one-process recursion; each
   process has a timeout; the processes run while phases 9b and 9c run;
9e. make_horizon_sharded_backward over [cuda:0] x 4 and x 8 against the
   associative scan (1e-10 relative) and the reverse scan (1e-8) on a
   pendulum T=1025 linearization in f64, then the long-horizon example's
   solve (pendulum T=T_LONG=33, four chunks on the card);
9f. utils/profiling.trace around a tuned solve on phase 4's kernel inputs,
   cut to PROFILE_TRIPS=2 trips, after an untraced call and a timed one,
   read from the exported trace: without Python frames, the ten device
   operations with the most device time, the share of the solve's window
   in which the card ran any device operation, and that share trip by
   trip (a trip ends with its K4 launch); with Python frames, the three
   longest idle gaps with the host operations and the port's Python
   frames recorded over each; device time over the untraced wall;
9g. utils/checkpoint save and load on the card of phase 9b's Solution and
   phase 7d's MPCState: bitwise, device and dtype kept;
9h. entry.dryrun_multichip(2) on [cuda:0, cuda:0]: the vmap, SL and
   per-device compaction routes, iterations equal, xs within 2e-3,
   reported violations equal to recomputed ones.

10. the recursion at any user problem's (n, m) (ops/packed_backward.py::
   riccati_plan picks K1's or K2's template and its parameters; each
   (n, m, dtype) is a library built at first use): (d, run first) the
   planar quadrotor of tests/torch_user_problems.py at (6, 2), its
   recursion's library and generated K3/K4 built together (seconds), then
   B=4096, T=101, f32, the tuned preset's options on the SL route with the
   kernels ("pallas") and with the loop rollouts ("scan") on the same
   lanes: trips, walls, K1/K2 and generated K3/K4 launches (> 0), the
   recomputed solved fraction (>= 0.99, within 0.01 of each other) and the
   objectives lane by lane; (a) the libraries of the grid (3, 1), (4, 2),
   (5, 1), (5, 2), (6, 2), (7, 3), (13, 4), (14, 7), (24, 8) in f32 and
   f64, and of both templates at the dims where the rule chooses between
   them, built together: seconds, each plan's parameters against its
   library's ring entry, registers and spills; (b) K1 or K2, K5, K6a and
   K6b at every grid dims against their plain versions, f64 and f32,
   B=1000, T=41, phase 3c's case and tolerances (the f32 kernels against
   the f64 plain versions); (c) K1/K2 at (6, 2) and (13, 4), f32, B=4096,
   T=101, against the bound and the plain version, and both templates in
   turns at the dims of the rule's choice.
11. the recursion past n + m = 32 (the tall template,
   csrc/riccati_backward_tall.cuh) and a team of three quadrotors at
   (36, 12): (d, run first) tests/torch_user_problems.py::quadrotor_team,
   its recursion's library and generated K3/K4 built together in the
   background beside phase 5's golden half (seconds, registers and
   spills), the team's K3/K4 against their plain versions in f64 and f32
   at B=4096, T=41 (timed in f32) and their ring against the rule's; then
   B=4096, T=41, f32, the tuned preset's options on the SL route with the
   kernels, and on the first B_TEAM_LOOP=16 lanes with the loop rollouts:
   trips, walls, launches (K2 on the tall template and generated K3/K4 > 0
   on the kernel path), the recomputed solved fraction (>= 0.99 with the
   kernels; on the loop cell's lanes within 0.01 of the kernel solve's
   there), the least separation and the objectives lane by lane; (a)
   the libraries of the tall grid (20, 13), (24, 12), (36, 12), (48, 16),
   (62, 2), (2, 62) and, past n + m = 64, (70, 4), (4, 70) in f32 and f64,
   built in the background: seconds, each plan against its library's ring
   entry, registers and spills; (b) K2, K5, K6a and K6b there against
   their plain versions as in 10b (stacks drawn on the card; an f32 output
   past 1e-4 held to F32_OWN times the f32 plain version's own distance
   from f64); (c) K2 at every grid dims, f32, B=4096, T=41, against the
   bound and the plain version (timed on its check's run), the share of a
   step's cycles in each phase at (36, 12) and (48, 16) (a build with the
   phase clocks, for measuring only), and K5, K6a, K6b at (36, 12).

Budget: the whole run stays under 800 s (1200 s limit).  For that,
parity's loop cell runs on 4 lanes, tuned's loop cell on 16, phase 4c's
cell (a) on 14 and its acrobot cells (b) and (c) on 16 (each was 4096),
the first two and 4c's cells (b) and (c)
(and the kernel cells paired with them) at T=T_LOOP=51 and cell (a) at
T=T_VMAP_LOOP=41, phase 5's
per-instance reverse-scan golden is the car's and its "auto" golden the
quadrotor's, phase 6b's tuned compaction at one grain, phase 7c's acrobot
DDP at T=T_DDP (was 51), phase 9e's long-horizon solve at T=T_LONG and
phase 9f's trace over PROFILE_TRIPS trips, the splits time 5 iterations
(were 20) and a plain version's time is one run after its check
(PLAIN_REPS), phase 9c compacts the tuned preset (was parity) and phase
9f traces 2 trips (was 8), and phase 5's CPU half runs in a worker process
beside phases 2-4: the reasons and trip counts stand beside B_LOOP,
run_compacted_devices and PROFILE_TRIPS.

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

T_MAIN, B_MAIN = 101, 4096
# Cuts that keep the whole run inside its time.  Each cuts the lanes of a
# launch-bound loop-rollout cell (its time is its slowest lane's trips times
# a per-trip host cost that also falls with fewer lanes); each loop cell is
# paired with the rollout kernels on the same lanes, and the kernel cells
# also run at B=4096:
# - B_LOOP (was 4096): parity's loop cell, 213 trips at B=4096, 204 at
#   1024, 140 at 64, 117 at 12, then cut to 4 for phase 6;
# - B_LOOP_TUNED (was 4096: 86 trips, 79-102 s of the run): tuned's loop
#   cell, 84 trips at B=64, then cut to 16 for phase 6;
# - B_VMAP_LOOP (was 4096: 208 trips, 141-250 s of the run): phase 4c's
#   cell (a), the literal Options() on the loop rollouts, 134 trips and 84
#   s at B=64 (NVIDIA H100 80GB HBM3, 700 W), then cut to 14 for phase 6.
# - T_LOOP (was T_MAIN=101): the horizon of these three loop cells
#   and of the kernel cells paired with them on the same lanes.  Fewer
#   lanes barely cut their trips (the slowest lane's: tuned 83 at B=16,
#   parity 115 at B=4, cell (a) 125 at B=14, T=101) while a trip's loops
#   cost about 0.6-0.8 s whatever B, so the horizon is what cuts their
#   time: at T=51 a trip's rollout loops take half the launches (trips on
#   the port's CPU path, f32: tuned 92, parity 84).  At T=51 cell (a)'s
#   "auto" backward takes the reverse scan (B=14 > T // 7 = 7), as it did
#   at B=64, T=101.  The kernel cells also run at B=4096, T=101.
# - T_LOOP also for phase 4c's cells (b) and (c) (were T=101: 55.4 and
#   51.1 s of a 760 s run, loop rollouts on 4096 lanes, 86 trips); K6a and
#   K6b stay held and timed at B=4096, T=101 in phase 3c, and the
#   quadrotor cells (d) and (e) keep T=41.
# - tuned's loop cell keeps T=51: at T=41 it took 106 trips on the card
#   against 87 (37.3 s on a host that ran the whole script in 841.7 s), and
#   parity's 140 on the port's CPU path against 84.
# - phase 5's per-instance golden with backward_pass="scan" solves the
#   golden car (T=51, 13 iterations, about 4 s), not acrobot T=101 (69.3
#   s): the reverse scan per instance is still held to a golden on the
#   card.
# - phase 5's per-instance golden with the default "auto" (on one
#   instance the associative scan) solves the golden quadrotor (T=41, (12,
#   4), 8 iterations, about 4 s on the CPU), not acrobot T=101 (108
#   iterations, 56.5 s of a 654.6 s run): the associative scan per
#   instance is still held to a golden on the card, at the widest dims,
#   and phase 9e holds the time-sharded recursion, made of the same
#   elements, against it at T=1025.
# - T_VMAP_LOOP (was T_LOOP=51: 148 trips, 48.2 s of a 654.6 s run):
#   phase 4c's cell (a) at T=41, 140 trips on the port's CPU path (f32,
#   solved 1.0; T=31 took 328 trips, and cells (b) and (c) solve only
#   0.941-0.988 of the lanes at T=21-31 there, so they keep T=51).  At
#   B=14 > 41 // 7 = 5 "auto" still takes the reverse scan.
# - B_VMAP_K6 (was 4096: 140 trips, timed solves of 43.9 and 50.5 s in a 789.5 s run on
#   an NVIDIA H100 80GB HBM3 at 700 W): phase 4c's acrobot cells (b) and
#   (c), tuned + K6a / K6b on the loop rollouts at T=51.  Their trips are
#   the slowest lane's: on the port's CPU path (f32) 118 at B=256 and 108
#   on its first 64 lanes, solved 1.0; T=41 took 164 trips (solved
#   0.996).  K6a and K6b stay held and timed at B=4096, T=101 in phase
#   3c, and the quadrotor cells (d) and (e) keep B=4096.  Cut from 64 to
#   16 lanes (109 trips, 39.8 and 40.4 s in an 832.7 s stretch of a run,
#   NVIDIA H100 80GB HBM3, 700 W): a lane's iterations do not depend on
#   the others (on the CPU path the first 16 lanes took the same 78, 92,
#   53, ... at B=16 as at B=64, 92 at most against 108).
# - COMPACT_GRAINS (was 128, 256 and 1024: 24.0 s of the run): phase 6b's
#   tuned compaction runs at the module's GRAIN only, the best of the
#   three on the card (PR 7-9).
# - T_DDP (was 51, golden_acrobot.npz's horizon: 137 iterations, 87.4 s
#   of a 683.8 s run): phase 7c's acrobot DDP per instance runs from the
#   golden's first T_DDP - 1 controls (all 0.05) and is held to a
#   Gauss-Newton solve of the same problem in the same run (both feasible,
#   DDP's objective within 1.05 x), not to the golden's objective.  A DDP
#   iteration costs about 0.42 s on the card whatever the horizon (this
#   check at T=11: 90 iterations, 37.8 s; T=15: 152, 63.9 s; T=21: 112,
#   50.3 s; NVIDIA H100 80GB HBM3, 700 W), so the iterations set the time:
#   T=8 took 57 iterations, 22.8 s, the cheapest horizon tried.
# Every split times the first SPLIT_ITERATIONS.
T_DDP = 8
B_LOOP = 4
B_LOOP_TUNED = 16
B_VMAP_LOOP = 14
B_VMAP_K6 = 16
T_LOOP = 51
T_VMAP_LOOP = 41
SEED = 0
SPLIT_ITERATIONS = 5

T_CAR = 51
T_QUAD = 41
TUNED = dict(verbose=False, record_traces=False,
             initial_constraint_penalty=1000.0, min_step_size=4.0e-3,
             early_round_iteration_cap=20)
PARITY = dict(verbose=False, record_traces=False)

# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per rollout step and candidate, counted from the device
# functions (csrc/sl_model_*.cuh and the control and AL code of
# csrc/sl_forward.cu): each addition, multiplication or division one, each
# sin or cos 20 (an estimate of the precise routine's fast path: range
# reduction plus a polynomial).  Acrobot: 2 x 43 for the two dynamics
# evaluations, 16 for the RK2 updates, 15 control, 8 cost, 8 sin/cos.  Car:
# 2 x 2 dynamics, 12 RK2, 21 control, 13 cost, 10 constraints, 30 AL terms,
# 2 accumulations, 4 sin/cos.  Quadrotor: 2 x 58 dynamics, 48 RK2, 120
# control, 55 cost, 8 constraints, 48 AL terms, 2 accumulations, 14 sin, cos
# or tan.  Particle: 6 dynamics (A x + B u, no RK2), 9 control, 7 cost, 1
# accumulation.  Pendulum: 2 x 5 dynamics, 8 RK2, 9 control, 5 cost, 1
# accumulation, 2 sin.  Cartpole: 2 x 18 dynamics, 16 RK2, 15 control, 13
# cost, 3 constraints, 12 AL terms, 2 accumulations, 5 sin or cos.
OPS_PER_STEP = {"acrobot": 2 * 43 + 16 + 15 + 8 + 8 * 20,
                "car": 2 * 2 + 12 + 21 + 13 + 10 + 30 + 2 + 4 * 20,
                "quadrotor": 2 * 58 + 48 + 120 + 55 + 8 + 48 + 2 + 14 * 20,
                "particle": 6 + 9 + 7 + 1,
                "pendulum": 2 * 5 + 8 + 9 + 5 + 1 + 2 * 20,
                "cartpole": 2 * 18 + 16 + 15 + 13 + 3 + 12 + 2 + 5 * 20}


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def bound_ms(nbytes, ops):
    """(least time in ms, what bounds it) at the card's peaks, f32."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ring_line(ring):
    if ring[0] == 0:
        return "; no ring: the step inputs are loaded in the step"
    return f"; ring of {ring[0]} step tiles, {ring[1]} B of dynamic shared memory a block"


# the plain versions take 0.1-0.4 s a call: timed over fewer runs
# a plain version runs once for its check just before it is timed, so its
# time is one run with no further warm-up (3 runs after one warm-up took
# about 55 s of an 811.9 s run; 2 runs, an estimated 27 s, left a whole
# run of 789.5 s only 10 s under the budget)
PLAIN_REPS = dict(reps=1, warmup=0)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` on the card, each run bracketed by
    synchronisation."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def within_own(name, outs, refs32, refs64):
    """max |kernel - plain f32| over the outputs, where each output of an
    f32 kernel is within F32_OWN times the f32 plain version's own distance
    from the f64 plain version (``refs64``) on the same inputs, its
    non-finite positions those of the f64 one; raises otherwise."""
    worst = 0.0
    for a, b, c in zip(outs, refs32, refs64):
        fin = torch.isfinite(c)
        if not torch.equal(torch.isfinite(a), fin):
            raise AssertionError(f"{name}: non-finite positions differ from the f64 plain version")
        if not fin.any():
            continue
        e, e32 = float((a[fin] - c[fin]).abs().max()), float((b[fin] - c[fin]).abs().max())
        if not e <= F32_OWN * e32:
            raise AssertionError(f"{name}: max |kernel - plain f64| {e:.3e} > {F32_OWN} x the f32 "
                                 f"plain version's {e32:.3e}")
        worst = max(worst, float((a[fin] - b[fin]).abs().max()))
    log(f"[tall] {name}: past 1e-4 of the f32 plain version, within {F32_OWN} x its own "
        f"distance from f64 (11b's rule)")
    return worst


def timed_once(fn):
    """(fn(), its milliseconds on the card): one run bracketed by
    synchronisation, as cuda_ms(fn, **PLAIN_REPS) times it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---------------------------------------------------------------------------
# phase 3: K1 and K2 against their plain version
# ---------------------------------------------------------------------------


def _fresh(make):
    """``make``, its results kept (phases 3, 3c, 7a and 10 draw the same
    stacks for each case and dtype: numpy's einsum takes seconds at
    B=4096), handed out as copies the caller may write."""
    kept = functools.lru_cache(maxsize=4)(make)

    @functools.wraps(make)
    def fresh(*args):
        return [a.copy() for a in kept(*args)]

    return fresh


@_fresh
def random_stacks(seed, B, Tm1, n, m):
    """Well-conditioned batch-last derivative stacks for m=1 (numpy, f64)."""
    rng = np.random.default_rng(seed)
    T = Tm1 + 1
    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.1 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))
    A = rng.standard_normal((T, n, n, B))
    gxx = np.einsum("tikb,tjkb->tijb", A, A) / n + 0.1 * np.eye(n)[None, :, :, None]
    guu = 0.1 + np.abs(rng.standard_normal((Tm1, m, m, B)))
    gux = 0.05 * rng.standard_normal((Tm1, m, n, B))
    return [fx, fu, gx, gu, gxx, guu, gux]


@_fresh
def wide_stacks(seed, B, Tm1, n, m):
    """Well-conditioned batch-last derivative stacks for m > 1 (numpy, f64):
    the scheme of tests/test_packed_pipeline.py's streamed-output test,
    symmetric positive definite gxx and guu."""
    rng = np.random.default_rng(seed)
    T = Tm1 + 1
    fx = 0.1 * rng.standard_normal((Tm1, n, n, B)) + np.eye(n)[None, :, :, None]
    fu = 0.5 * rng.standard_normal((Tm1, n, m, B))
    gx = rng.standard_normal((T, n, B))
    gu = rng.standard_normal((Tm1, m, B))

    def spd(rows, d, scale):
        A = rng.standard_normal((rows, d, d, B))
        return (scale * np.einsum("tikb,tjkb->tijb", A, A) / d
                + 2.0 * np.eye(d)[None, :, :, None])

    gxx = spd(T, n, 0.5)
    guu = spd(Tm1, m, 1.0)
    gux = 0.2 * rng.standard_normal((Tm1, m, n, B))
    return [fx, fu, gx, gu, gxx, guu, gux]


def riccati_ops(n, m):
    """Operations a step and lane of the recursion (each multiplication,
    addition, division or square root one): Qx, Qu, fx^T P, fu^T P, Qxx,
    Quu, Qux, the Cholesky and its n+1 solves, Quu K, the P and p updates
    and the symmetrization."""
    return (2 * n * n + 2 * n * m + 2 * n ** 3 + 2 * n * n * m
            + 2 * n ** 3 + n * n + 2 * n * m * m + m * m + 2 * n * n * m + n * m
            + (m ** 3) // 3 + m * m + (n + 1) * 2 * m * m + 2 * m * m * n
            + 6 * m * n * n + 3 * n * n + 2 * n * n + 6 * m * n + 3 * n)


# label -> (launch counter name, n, m, T, stacks, step made indefinite)
RICCATI_CASES = {
    "K1": ("riccati_backward", 4, 1, T_MAIN, random_stacks, 50),
    "K2": ("riccati_backward_wide", 12, 4, T_QUAD, wide_stacks, 20),
    # particle's and pendulum's dims (phase 7a)
    "K1 (2, 1)": ("riccati_backward", 2, 1, T_MAIN, random_stacks, 50),
}


def check_riccati(pk, label):
    """K1 or K2 = plain within tolerance, ok equal, in f64 and f32; returns
    the f32 record at its path's shapes."""
    kname, n, m, T, make, bad_t = RICCATI_CASES[label]
    B, Tm1 = B_MAIN, T - 1
    # f64: both sides are IEEE f64 summing the same products in other orders
    # (the kernel also contracts to FMA): 1e-10 relative.  f32: the same
    # differences at f32 rounding, carried through the recursion (f32
    # against f64 of the plain version differs by ~1e-6 relative on these
    # stacks): 1e-4 relative.
    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    record = {}
    for case in ("well_conditioned", "indefinite_lanes"):
        st = make(SEED, B, Tm1, n, m)
        bad = np.zeros(B, bool)
        if case == "indefinite_lanes":
            bad[::61] = True
            st[5][bad_t, 0, 0, bad] = -1.0e3
        for dtype, tol in tols.items():
            dev = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in st]
            kin = pk.prepare_stacks(*dev, torch.ones((Tm1, m), dtype=torch.bool))
            kin = [a.contiguous() for a in kin]
            reg = torch.zeros(B, dtype=dtype, device="cuda")
            counter = counters()[kname]
            before = counter.launches
            out = pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
            ref = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise AssertionError(f"{label}: backward_pass_multiref did not launch {kname}")
            max_abs = 0.0
            for name, a, b in zip(("K", "k", "Qx", "Qu", "p", "ok"), out, ref):
                nan_a, nan_b = torch.isnan(a), torch.isnan(b)
                if not torch.equal(nan_a, nan_b):
                    raise AssertionError(f"{label} {case} {dtype} {name}: NaN positions differ")
                fa, fb = a[~nan_b], b[~nan_b]
                scale = float(fb.abs().max()) if fb.numel() else 0.0
                err = float((fa - fb).abs().max()) if fb.numel() else 0.0
                if not err <= tol * max(scale, 1.0):
                    raise AssertionError(
                        f"{label} {case} {dtype} {name}: max |kernel - plain| {err:.3e} "
                        f"> {tol:g} * max(|plain|, 1) = {tol * max(scale, 1.0):.3e}")
                max_abs = max(max_abs, err)
            ok = out[-1].cpu().numpy()
            if not np.array_equal(ok, ref[-1].cpu().numpy()):
                raise AssertionError(f"{label} {case} {dtype}: ok differs")
            if not np.array_equal(ok == 0, bad):
                raise AssertionError(f"{label} {case} {dtype}: ok=0 lanes are not the indefinite ones")
            line = (f"[{label.lower()}] {kname} n={n} m={m} T={T} B={B} {case} {str(dtype).split('.')[-1]}: "
                    f"max |kernel - plain| {max_abs:.3e} (tol {tol:g} relative), ok equal, "
                    f"{int((ok == 0).sum())} lanes ok=0")
            if case == "well_conditioned":
                k_ms = cuda_ms(lambda: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg))
                p_ms = cuda_ms(lambda: pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg),
                               **PLAIN_REPS)
                line += f"; kernel {k_ms:.4f} ms (median of 10), plain {p_ms:.3f} ms (one run)"
                if dtype == torch.float32:
                    # each input read once, each output written once
                    nbytes = sum(a.numel() * a.element_size()
                                 for a in (*kin, reg, *out))
                    ops = riccati_ops(n, m) * Tm1 * B
                    b_ms, b_by = bound_ms(nbytes, ops)
                    line += (f"; bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
                             f"{ops / 1e9:.3f} G operations)")
                    line += f"; {b_ms / k_ms:.1%} of the bound"
                    record = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                  bound_ms=b_ms, bound_by=b_by)
                line += ring_line(pk.riccati_ring(n, m, dtype, False))
            log(line)
    return record


# ---------------------------------------------------------------------------
# phase 3c: K5, K6a and K6b against their plain versions
# ---------------------------------------------------------------------------


def masked_case(seed, B, Tm1, n, m, case, dtype):
    """Batch-last stacks on the card for K5/K6: (4, 1) from random_stacks;
    (3, 2) from wide_stacks with the last action dim masked off and its
    derivative entries left nonzero, so the mask is what zeroes its gains.
    ``indefinite_lanes`` makes Quu indefinite at one step on every 61st lane.
    The regularizer is per lane, drawn from [1e-3, 1], so K5's reg on the
    whole diagonal and K6's reg * um (in K6b's order: added, then taken back)
    are held against the plain versions.  Returns (stacks, um [Tm1, m]
    float, reg [B], the indefinite lanes)."""
    make = random_stacks if m == 1 else wide_stacks
    st = make(seed, B, Tm1, n, m)
    um = np.ones((Tm1, m))
    if m > 1:
        um[:, -1] = 0.0
    bad = np.zeros(B, bool)
    if case == "indefinite_lanes":
        bad[::61] = True
        st[5][Tm1 // 2, 0, 0, bad] = -1.0e3
    reg = np.random.default_rng(seed + 1).uniform(1e-3, 1.0, B)
    dev = [torch.as_tensor(a, dtype=dtype, device="cuda").contiguous() for a in st]
    return (dev, torch.as_tensor(um, dtype=dtype, device="cuda"),
            torch.as_tensor(reg, dtype=dtype, device="cuda"), bad)


# label -> (launch counter name, (n, m, T) cases); a wide (n, m) runs on K2's
# template and counts on "<name>_wide"
PACKED_MASKED_CASES = {"K5": ("riccati_packed", ((4, 1, T_MAIN), (12, 4, T_QUAD))),
                       "K6a": ("riccati_masked", ((4, 1, T_MAIN), (3, 2, T_MAIN), (12, 4, T_QUAD))),
                       "K6b": ("riccati_masked_packed",
                               ((4, 1, T_MAIN), (3, 2, T_MAIN), (12, 4, T_QUAD)))}
WIDE = (12, 4)


def packed_masked_runs(pk, pb, label, st, um, reg):
    """(kernel alone, its plain version, the batch-leading entry, the
    kernel's inputs) of K5, K6a or K6b on batch-last stacks ``st``."""
    fx, fu, gx, gu, gxx, guu, gux = st
    lead = [a.movedim(-1, 0).contiguous() for a in st]
    umask = um > 0.5
    if label == "K5":
        packed, gxxT, gxT, meta = pk.pack_stacks_bt(*st, umask)
        return (lambda: pk.backward_pass_packed(packed, gxxT, gxT, reg, meta),
                lambda: pk.backward_pass_packed_reference(packed, gxxT, gxT, reg, meta),
                lambda: pk.backward_pass_batched_pallas_v3(*lead, umask, reg),
                (packed, gxxT, gxT, reg))
    if label == "K6a":
        return (lambda: pb.backward_pass_masked(*st, um, reg),
                lambda: pb.backward_pass_masked_reference(*st, um, reg),
                lambda: pb.backward_pass_batched_pallas(*lead, umask, reg),
                (*st, um, reg))
    n, m = fx.shape[1], fu.shape[2]
    packed = pk.pack_slots((fx, fu, gx[:-1], gu, gxx[:-1], guu, gux))
    gxxT, gxT, meta = gxx[-1].contiguous(), gx[-1].contiguous(), dict(n=n, m=m)
    return (lambda: pb.backward_pass_masked_packed(packed, gxxT, gxT, um, reg, meta),
            lambda: pb.backward_pass_masked_packed_reference(packed, gxxT, gxT, um, reg, meta),
            lambda: pb.backward_pass_batched_pallas_v2(*lead, umask, reg),
            (packed, gxxT, gxT, um, reg))


def check_packed_masked(pk, pb, label, dims=None):
    """K5, K6a or K6b = plain within K1's tolerances, NaN positions and ok
    equal, ok = 0 exactly on the indefinite lanes, masked gains exactly 0;
    f64 and f32 at B=4096, T=101 on K1's template and T=41 on K2's.  Every
    call of the batch-leading entry runs with the launch counts set to 0
    just before and read just after: it must launch its kernel once and
    nothing else.  Returns the f32 records of (4, 1) and (12, 4), keyed by
    counter name; K5's hold the launches of its entry at those shapes (K5
    runs in no solve of the JAX package: this call is its path).  With
    ``dims`` (phase 7a: [(2, 1, T)]) those cases run instead, and their
    records, keyed "<counter>/n<n>m<m>", hold their entry's launches (no
    solve runs K5, K6a or K6b at (2, 1))."""
    base, all_dims = PACKED_MASKED_CASES[label]
    extra = dims is not None
    dims = all_dims if dims is None else dims
    B = B_MAIN
    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    records = {}
    for n, m, T in dims:
        Tm1 = T - 1
        kname = base + ("_wide" if (n, m) == WIDE else "")
        for case in ("well_conditioned", "indefinite_lanes"):
            for dtype, tol in tols.items():
                st, um, reg, bad = masked_case(SEED, B, Tm1, n, m, case, dtype)
                kern, plain, entry, kin = packed_masked_runs(pk, pb, label, st, um, reg)
                counter = counters()[kname]
                before = counter.launches
                out = kern()
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"{label}: its wrapper did not launch {kname}")
                ref = plain()
                max_abs = 0.0
                for name, a, b in zip(("K", "k", "Qx", "Qu", "p", "ok"), out, ref):
                    if not torch.equal(torch.isnan(a), torch.isnan(b)):
                        raise AssertionError(f"{label} {case} {dtype} {name}: NaN positions differ")
                    keep = ~torch.isnan(b)
                    fa, fb = a[keep], b[keep]
                    scale = float(fb.abs().max()) if fb.numel() else 0.0
                    err = float((fa - fb).abs().max()) if fb.numel() else 0.0
                    if not err <= tol * max(scale, 1.0):
                        raise AssertionError(
                            f"{label} {case} {dtype} {name}: max |kernel - plain| {err:.3e} "
                            f"> {tol:g} * max(|plain|, 1)")
                    max_abs = max(max_abs, err)
                ok = out[-1].cpu().numpy()
                if not np.array_equal(ok, ref[-1].cpu().numpy()) or not np.array_equal(ok == 0, bad):
                    raise AssertionError(f"{label} {case} {dtype}: ok differs or is not 0 exactly on the indefinite lanes")
                if m > 1 and label != "K5":
                    good = torch.as_tensor(~bad, device="cuda")
                    if not (bool((out[0][:, -1][..., good] == 0).all())
                            and bool((out[1][:, -1][..., good] == 0).all())):
                        raise AssertionError(f"{label} {case} {dtype}: gains of the masked action are not 0")
                for c in counters().values():
                    c.reset()
                ent = entry()
                torch.cuda.synchronize()
                path = {k: c.launches for k, c in counters().items() if c.launches}
                if path != {kname: 1}:
                    raise AssertionError(f"{label} {case} {dtype}: its entry launched {path}, not {kname} once")
                for name, a, b in zip(("K", "k", "Qx", "Qu", "p"), ent, out):
                    a = a.movedim(0, -1)
                    if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
                        raise AssertionError(f"{label} {case} {dtype}: the entry's {name} differs from the kernel's")
                dn = str(dtype).split(".")[-1]
                line = (f"[{label.lower()}] {kname} n={n} m={m} T={T} B={B} {case} {dn}: "
                        f"max |kernel - plain| {max_abs:.3e} (tol {tol:g} relative), ok equal, "
                        f"{int((ok == 0).sum())} lanes ok=0" + ("; masked gains 0" if m > 1 and label != "K5" else ""))
                if case == "well_conditioned":
                    k_ms = cuda_ms(kern)
                    e_ms = cuda_ms(entry)
                    p_ms = cuda_ms(plain, **PLAIN_REPS)
                    line += (f"; kernel {k_ms:.4f} ms, entry with layout {e_ms:.4f} ms, "
                             f"plain {p_ms:.3f} ms (one run)")
                    if dtype == torch.float32:
                        nbytes = sum(a.numel() * a.element_size() for a in (*kin, *out))
                        ops = riccati_ops(n, m) * Tm1 * B
                        b_ms, b_by = bound_ms(nbytes, ops)
                        line += (f"; bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.4f} MB, "
                                 f"{ops / 1e9:.3f} G operations); {b_ms / k_ms:.1%} of the bound")
                        if (n, m) in ((4, 1), WIDE) or extra:
                            key = f"{kname}/n{n}m{m}" if extra else kname
                            records[key] = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                                                bound_ms=b_ms, bound_by=b_by, entry_ms=e_ms)
                            if label == "K5" or extra:
                                records[key]["launches"] = path[kname]
                    line += ring_line(pk.riccati_ring(n, m, dtype, label != "K5"))
                log(line)
    return records


# ---------------------------------------------------------------------------
# phase 3b: K3 and K4 against their plain versions
# ---------------------------------------------------------------------------


def rollout_case(fk, name, T, B, dtype, seed, spec=None):
    """Live line-search arrays on the card, from a numpy seed: states
    rolled out from noisy controls, random non-converged gains, duals with
    lam = 0 on half the lanes (there an inequality row with c < 0 is
    inactive) and, for car and the quadrotor, lanes that head through the
    obstacle or push a control past its bound (active rows).  ``spec``: a
    user problem's spec in place of the library model ``name``'s; where it
    has per-step parameters, a target ramp in w, different on every lane."""
    from iterativelqr_tpu_torch import build_spec, models

    mod = getattr(models, name, None)
    if spec is None:
        spec = build_spec(*mod.problem(T)[:3])
    r = fk.Rollouts(spec, "cuda")
    rng = np.random.default_rng(seed)
    nx, nu, nc, Tm1 = spec.nx, spec.nu, spec.nc, T - 1
    x0 = 0.05 * rng.standard_normal((nx, B))
    ubar = 0.1 * rng.standard_normal((Tm1, nu, B))
    if name == "car":
        ubar[:, 0] += 0.7
        x0[2, ::3] += np.pi / 4
        ubar[:, 0, 1::5] = 6.0
    if name in ("quadrotor", "team"):
        # thrusts near hover; some lanes hold every rotor past its upper or
        # lower bound (active rows, no torque); the team's starts apart
        ubar = models.quadrotor.HOVER + 0.1 * ubar
        ubar[:, :, 1::5] = 6.5
        ubar[:, :, 3::7] = -0.2
    if name == "cartpole":
        # near theta = pi: a pole released near theta = 0 falls along the
        # separatrix, where a 100-step rollout magnifies rounding about
        # 1e5-fold (the plain f32 rollout is 5e-3 off the f64 one there,
        # 2e-6 here); the last two controls past the limit on some lanes
        # (active rows)
        x0[1] += np.pi
        ubar[-2:, 0, 1::5] = 10.5
        ubar[-2:, 0, 2::7] = -10.5
    K = 0.1 * rng.standard_normal((Tm1, nu, nx, B))
    k = 0.1 * rng.standard_normal((Tm1, nu, B))
    if name == "team":
        for i, p in enumerate(user_problems().team_starts()):
            x0[12 * i:12 * i + 3] += np.asarray(p)[:, None]
    if name in ("quadrotor", "team"):
        # gentler gains: larger random ones tip the attitude past 90 degrees
        # within the horizon (tan and 1/cos of pitch overflow) or make the
        # alpha = 1 rollouts chaotic
        K, k = 0.2 * K, 0.2 * k
    duals = np.abs(0.5 * rng.standard_normal((T, nc, B))) * (rng.uniform(size=B) < 0.5)
    penalty = 10.0 * rng.uniform(0.5, 2.0, (T, nc, B))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
    ws = np.zeros((T, spec.npar, B))
    if spec.npar:
        ws[:, 0] = np.linspace(0.0, 1.0, T)[:, None] * rng.uniform(0.5, 1.5, B)
        ws[:, 1:] = rng.uniform(-0.2, 0.2, (spec.npar - 1, B))
    ws = t(ws)
    xbar0 = torch.zeros((T, nx, B), dtype=dtype, device="cuda")
    xbar0[0] = t(x0)
    # zero gains: the plain re-roll is the open-loop rollout of ubar
    xbar = fk.winner_reroll_reference(
        r, torch.zeros(B, dtype=dtype, device="cuda"), xbar0, t(ubar), ws,
        t(0 * K), t(0 * k), t(duals), t(penalty))[0].contiguous()
    alpha = t(0.5 ** rng.integers(0, 17, B))
    return r, (xbar, t(ubar), ws, t(K), t(k), t(duals), t(penalty)), alpha


def max_err(name, outs, refs, tol):
    """(max |kernel - plain|, max |plain|) over the outputs; raises beyond
    tol * max(|plain|, 1) of an output or where finiteness differs."""
    worst, top = 0.0, 0.0
    for a, b in zip(outs, refs):
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            raise AssertionError(f"{name}: non-finite positions differ")
        if not fin.any():
            continue
        scale = float(b[fin].abs().max())
        err = float((a[fin] - b[fin]).abs().max())
        if not err <= tol * max(scale, 1.0):
            raise AssertionError(
                f"{name}: max |kernel - plain| {err:.3e} > {tol:g} * "
                f"max(|plain|, 1) = {tol * max(scale, 1.0):.3e}")
        worst, top = max(worst, err), max(top, scale)
    return worst, top


def rollout_bytes(spec, B, size, nb=None):
    """Bytes K3 (``nb`` candidates) or K4 (``nb`` None) must move: each
    input read once, each output written once."""
    T, nx, nu, nc, npar = spec.T, spec.nx, spec.nu, spec.nc, spec.npar
    Tm1 = T - 1
    ncs, nct = int(spec.c_dims[0]), int(spec.c_dims[-1])
    per_lane = Tm1 * (nx + nu + npar + nu * nx + nu + 2 * ncs) + npar + 2 * nct
    if nb is not None:
        per_lane += nb                                      # J
    else:
        per_lane += 1 + T * nx + Tm1 * nu + T * nc + 1      # alpha, xs, us, c, J
    return per_lane * B * size


ROLLOUT_MODELS = (("acrobot", T_MAIN), ("car", T_CAR), ("quadrotor", T_QUAD))
# phase 7a: the models whose device functions came with M16
NEW_ROLLOUT_MODELS = (("particle", 11), ("pendulum", 51), ("cartpole", 101))


def check_rollouts(fk, models=ROLLOUT_MODELS):
    """K3 and K4 = plain within tolerance, acrobot T=101, car T=51 and
    quadrotor T=41 (or ``models``), B=4096, f64 and f32; returns the f32
    records for the JSON line (K3's head block and K4), keyed
    "<kernel>/<model>"."""
    # f64: IEEE f64 on both sides, sums in other orders and FMA contraction
    # in the kernel, through T-1 dependent steps: 1e-10 relative.  f32: the
    # same at f32 rounding: 1e-4 relative (K1's tolerances and reasons).
    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    records = {}
    for name, T in models:
        for dtype, tol in tols.items():
            r, live, alpha = rollout_case(fk, name, T, B_MAIN, dtype, SEED)
            spec, size = r.spec, torch.finfo(dtype).bits // 8
            dn = str(dtype).split(".")[-1]
            runs = (
                ("sl_score_rollout", "head j0=0 nb=8",
                 lambda: (fk.score_rollout(r, 0, 8, *live),),
                 lambda: (fk.score_rollout_reference(r, 0, 8, *live),), 8),
                ("sl_score_rollout", "tail j0=8 nb=9",
                 lambda: (fk.score_rollout(r, 8, 9, *live),),
                 lambda: (fk.score_rollout_reference(r, 8, 9, *live),), 9),
                ("sl_winner_reroll", "per-lane alpha",
                 lambda: fk.winner_reroll(r, alpha, *live),
                 lambda: fk.winner_reroll_reference(r, alpha, *live), None),
            )
            # K4 at alpha = 2^-j on each lane: its J must be K3's J of candidate j
            j = torch.round(-torch.log2(alpha)).long()
            J3 = fk.score_rollout(r, 0, 17, *live)[j, torch.arange(B_MAIN, device="cuda")]
            J4 = fk.winner_reroll(r, alpha, *live)[2]
            same = (J4 == J3) | (torch.isnan(J4) & torch.isnan(J3))
            if not bool(same.all()):
                raise AssertionError(f"K4's J differs from K3's at the same alpha on "
                                     f"{int((~same).sum())} lanes ({name} {dn})")
            log(f"[rollout] {name} T={T} B={B_MAIN} {dn}: K4's J equals K3's J at the same alpha "
                f"on every lane")
            for kname, what, kern, plain, nb in runs:
                outs = kern()
                torch.cuda.synchronize()
                err, top = max_err(f"{kname} {name} {dn} {what}", outs, plain(), tol)
                k_ms = cuda_ms(kern)
                p_ms = cuda_ms(plain, **PLAIN_REPS)
                nbytes = rollout_bytes(spec, B_MAIN, size, nb)
                ops = OPS_PER_STEP[name] * (T - 1) * B_MAIN * (nb or 1)
                line = (f"[rollout] {kname} {name} T={T} B={B_MAIN} {dn} {what}: "
                        f"max |kernel - plain| {err:.3e}, max |plain| {top:.3e} (tol {tol:g} relative); "
                        f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms (one run)")
                if dtype == torch.float32:
                    b_ms, b_by = bound_ms(nbytes, ops)
                    line += (f"; bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB, "
                             f"{ops / 1e9:.3f} G operations); {b_ms / k_ms:.1%} of the bound")
                    if what != "tail j0=8 nb=9":
                        records[f"{kname}/{name}"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                                          bound_ms=b_ms, bound_by=b_by)
                line += ring_line(fk.rollout_ring(r.model, dtype))
                log(line)
    return records


# ---------------------------------------------------------------------------
# phase 4: the slice end to end
# ---------------------------------------------------------------------------


PHASES = ("derive", "augment", "backward", "slope", "line_search", "al_update")


def phase_ms(run, tag):
    """``run()`` under utils/profiling.trace (its Chrome trace lands in
    SCRATCH/phases_<tag>/); returns (its result, host ms and device ms, the
    stream time between each span's CUDA events, summed by span name).  The
    spans inside a solve's ``finish`` are left out."""
    from iterativelqr_tpu_torch.utils import profiling

    profiling.drain()
    with profiling.trace(os.path.join(SCRATCH, f"phases_{tag}")):
        out = run()
        torch.cuda.synchronize()
    recs = profiling.drain()
    by_id = {r["id"]: r for r in recs}

    def in_finish(r):
        while r is not None:
            if r["name"] == "finish":
                return True
            r = by_id.get(r["parent"])
        return False

    host, dev = collections.Counter(), collections.Counter()
    for r in recs:
        if not in_finish(r):
            host[r["name"]] += (r["host_end_ns"] - r["host_start_ns"]) / 1e6
            dev[r["name"]] += r["device_ms"]
    return out, host, dev


def bench_inputs(B, T, dtype, device):
    """bench.py's protocol: x0 = 0.05 N(0,1) spliced into zero states,
    controls 0.05 (bench.py:281-284), from a numpy seed."""
    rng = np.random.default_rng(SEED)
    xs = np.zeros((B, T, 4))
    xs[:, 0] = 0.05 * rng.standard_normal((B, 4))
    us = np.full((B, T - 1, 1), 0.05)
    ws = np.zeros((B, T, 0))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in (xs, us, ws)]


def recomputed_solved_fraction(spec, sol, ws, tol):
    from iterativelqr_tpu_torch.ops.derivatives import constraint_values

    c = constraint_values(spec, sol.xs, sol.us, ws)
    ineq = torch.as_tensor(spec.ineq_mask, device=c.device)
    cmask = torch.as_tensor(spec.c_mask, device=c.device)
    v = torch.where(ineq, torch.clamp(c, min=0.0), torch.abs(c))
    v = torch.where(cmask, v, torch.zeros_like(v)).amax(dim=(1, 2))
    return float((v <= tol).to(torch.float32).mean())


LAUNCH_NAMES = ("riccati_backward", "riccati_backward_wide", "sl_score_rollout",
                "sl_winner_reroll", "riccati_packed", "riccati_masked",
                "riccati_masked_packed", "riccati_packed_wide", "riccati_masked_wide",
                "riccati_masked_packed_wide", "sl_score_rollout_generated",
                "sl_winner_reroll_generated", "riccati_backward_tall", "riccati_packed_tall",
                "riccati_masked_tall", "riccati_masked_packed_tall")


def counters():
    """The port's launch counters (utils/profiling.py's registry) by kernel
    family, in LAUNCH_NAMES's order."""
    from iterativelqr_tpu_torch.ops import pallas_backward, sl_forward_kernel  # noqa: F401
    from iterativelqr_tpu_torch.utils import profiling

    found = profiling.launch_counters()
    return {k: found[k] for k in LAUNCH_NAMES}


def counted_solve(P, solve, args):
    """One timed solve of the main path (the user entry point and
    batch_stats, no instrumentation) with every launch count set to 0 just
    before and read just after; returns (solution, stats, wall s, counts)."""
    for c in counters().values():
        c.reset()
    t0 = time.perf_counter()
    sol = solve(*args)
    stats = P.batch_stats(sol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sol, stats, wall, {k: c.launches for k, c in counters().items()}


def check_launches(name, fkm, counts, model):
    """The model's backward kernel (K2 for the quadrotor, K1 for acrobot and
    car) was launched and the other was not; K3/K4 launched on the kernel
    path and not on the loop path."""
    k1, k2 = counts["riccati_backward"], counts["riccati_backward_wide"]
    if model == "quadrotor":
        if k2 <= 0 or k1 != 0:
            raise AssertionError(f"{name}: expected K2 and not K1 on the main path (K1 {k1}, K2 {k2})")
    elif k1 <= 0 or k2 != 0:
        raise AssertionError(f"{name}: expected K1 and not K2 on the main path (K1 {k1}, K2 {k2})")
    rollouts = counts["sl_score_rollout"], counts["sl_winner_reroll"]
    if fkm in ("pallas", "auto") and min(rollouts) <= 0:
        raise AssertionError(f"{name}: K3/K4 were not launched on the main path {rollouts}")
    if fkm == "scan" and max(rollouts) > 0:
        raise AssertionError(f"{name}: the loop path launched K3/K4 {rollouts}")


def integrity(name, spec, sol, stats, ws, tol, B, T, nx, nu):
    """Shapes, finiteness, and the solved fraction recomputed fresh from the
    returned trajectories; returns (batch_stats fraction, recomputed)."""
    if tuple(sol.xs.shape) != (B, T, nx) or tuple(sol.us.shape) != (B, T - 1, nu):
        raise AssertionError(f"{name}: bad shapes {tuple(sol.xs.shape)} {tuple(sol.us.shape)}")
    for f in ("xs", "us", "K", "k", "objective", "max_violation"):
        if not bool(torch.isfinite(getattr(sol, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    frac = float(stats.solved_fraction)
    frac_true = recomputed_solved_fraction(spec, sol, ws, tol)
    if abs(frac_true - frac) > 0.01:
        raise AssertionError(f"{name}: batch_stats solved {frac} vs recomputed {frac_true}")
    return frac, frac_true


def report(name, sol, stats, frac, frac_true, wall, counts, na, B):
    its = sol.iterations
    trips = int(its.max())                  # loop iterations of the batch
    k1, k2 = counts["riccati_backward"], counts["riccati_backward_wide"]
    tail_gates = trips if na > 8 else 0
    syncs = (trips + 1) + k1 + k2 + tail_gates
    log(f"[slice] {name}: solved_fraction batch_stats {frac:.4f} recomputed {frac_true:.4f}; "
        f"iterations mean {float(its.float().mean()):.2f} max {trips}; "
        f"mean objective {float(stats.mean_objective):.4f}; max violation {float(stats.max_violation):.3e}")
    log(f"[slice] {name}: wall {wall:.3f} s after a warm-up ({B * frac_true / wall:.1f} solved/s); "
        f"launches K1 {k1}, K2 {k2}, K3 {counts['sl_score_rollout']}, K4 {counts['sl_winner_reroll']}; "
        f"host syncs {syncs} (loop tests {trips + 1}, reg-retry tests {k1 + k2}, tail gates {tail_gates})")


def per_iteration_split(name, spec, opts, xs, us, ws):
    """The same solve traced, cut to its first
    SPLIT_ITERATIONS iterations (on acrobot every lane is still live then):
    host and device-event ms per iteration of each phase's span (traced)."""
    from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl

    timed = make_batched_solve_sl(
        spec, dataclasses.replace(opts, max_total_iterations=SPLIT_ITERATIONS),
        device=xs.device, dtype=xs.dtype)
    sol, host, dev = phase_ms(lambda: timed(xs, us, ws), name.replace("/", "_"))
    trips = int(sol.iterations.max())
    log(f"[slice] {name}: per iteration (first {trips}, traced) " + ", ".join(
        f"{k} {host[k] / trips:.2f} ms host / {dev[k] / trips:.2f} ms device-events"
        for k in PHASES))


def run_preset(P, name, kw, fkm, B, T=T_MAIN, spec=None):
    """Acrobot at horizon T, f32, on the first B lanes of the protocol batch
    under one bench.py preset with the rollouts of ``fkm``; returns (the
    main path's launch counts, wall s, the solution, its inputs).  ``spec``:
    the acrobot written otherwise (phase 8c: its functions in lambdas)."""
    from iterativelqr_tpu_torch.models import acrobot

    name = (f"{name}/{fkm}" + ("" if B == B_MAIN else f"/B={B}")
            + ("" if T == T_MAIN else f"/T={T}") + ("" if spec is None else "/generated"))
    dtype, device = torch.float32, torch.device("cuda")
    spec = P.build_spec(*acrobot.problem(T)[:3]) if spec is None else spec
    opts = P.Options(**kw, forward_kernel=fkm)
    xs, us, ws = bench_inputs(B, T, dtype, device)

    # warm-up: the same program, cut to three iterations
    warm = P.make_batched_solve_fn(
        spec, dataclasses.replace(opts, max_total_iterations=3),
        device=device, dtype=dtype)
    warm(xs, us, ws)
    torch.cuda.synchronize()

    solve = P.make_batched_solve_fn(spec, opts, device=device, dtype=dtype)
    sol, stats, wall, counts = counted_solve(P, solve, (xs, us, ws))

    frac, frac_true = integrity(name, spec, sol, stats, ws, opts.constraint_tolerance,
                                B, T, 4, 1)
    if frac_true < 0.99:
        raise AssertionError(f"{name}: recomputed solved fraction {frac_true} < 0.99")
    check_launches(name, fkm, counts, "acrobot")
    log(f"[slice] {name}: B={B} T={T} f32 candidates={opts.num_step_sizes}")
    report(name, sol, stats, frac, frac_true, wall, counts, opts.num_step_sizes, B)
    per_iteration_split(name, spec, opts, xs, us, ws)
    return counts, wall, sol, (xs, us, ws)


# model -> (T of its cell, scale of the x0 noise, its initial controls: a
# function of the model's module, or a constant)
MODEL_CELLS = {"car": (T_CAR, 0.02, "initial_controls"),
               "quadrotor": (T_QUAD, 0.05, "hover_controls")}
# phase 7b: particle with tests/test_ddp.py's controls, pendulum with
# tests/test_models_extra.py's, cartpole with its swing-up controls
NEW_MODEL_CELLS = {"particle": (11, 0.02, 0.05), "pendulum": (51, 0.02, 0.1),
                   "cartpole": (101, 0.02, "swingup_controls")}


def model_inputs(model, B, T, dtype, device):
    """x0 = x1 + scale N(0,1) on every state from a numpy seed, the model's
    initial controls (car: the reference's; quadrotor: hover, with 0.05 the
    protocol of benchmarks/measure_all.py), states rolled out open loop."""
    from torch.func import vmap

    from iterativelqr_tpu_torch import models

    mod = getattr(models, model)
    _, scale, controls = {**MODEL_CELLS, **NEW_MODEL_CELLS}[model]
    dyn, _, _, x1, _ = mod.problem(T)
    nx = x1.shape[0]
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(x1.cpu().numpy() + scale * rng.standard_normal((B, nx)),
                        dtype=dtype, device=device)
    if isinstance(controls, str):
        us = getattr(mod, controls)(T)
        us = torch.stack(us) if isinstance(us, list) else torch.as_tensor(us)
    else:
        us = torch.full((T - 1, dyn[0].num_action), controls)
    us = us.to(device, dtype)
    us = us[None].expand(B, *us.shape).contiguous()
    xs = [x]
    for t in range(T - 1):
        x = vmap(dyn[t])(x, us[:, t])
        xs.append(x)
    ws = torch.zeros((B, T, 0), dtype=dtype, device=device)
    return torch.stack(xs, dim=1).contiguous(), us, ws


def run_model(P, model, fkm, spec=None, label=None):
    """Car T=51 or quadrotor T=41 (phase 7b: particle T=11, pendulum T=51
    or cartpole T=101), B=4096, f32, ``Options(record_traces=False)``,
    with the rollouts of ``fkm``; returns (recomputed solved fraction,
    launch counts, wall s).  ``spec``: the model's problem as a user
    writes it (phase 8e), on the SL route by name, under ``label``."""
    from iterativelqr_tpu_torch import models

    T = {**MODEL_CELLS, **NEW_MODEL_CELLS}[model][0]
    name = f"{label or model}/{fkm}"
    dtype, device = torch.float32, torch.device("cuda")
    if spec is None:
        spec = P.build_spec(*getattr(models, model).problem(T)[:3])
        opts = P.Options(record_traces=False, forward_kernel=fkm)
    else:
        opts = P.Options(record_traces=False, forward_kernel=fkm, batched_solver="sl")
    xs, us, ws = model_inputs(model, B_MAIN, T, dtype, device)
    P.make_batched_solve_fn(spec, dataclasses.replace(opts, max_total_iterations=3),
                            device=device, dtype=dtype)(xs, us, ws)
    torch.cuda.synchronize()
    solve = P.make_batched_solve_fn(spec, opts, device=device, dtype=dtype)
    sol, stats, wall, counts = counted_solve(P, solve, (xs, us, ws))
    frac, frac_true = integrity(name, spec, sol, stats, ws, opts.constraint_tolerance,
                                B_MAIN, T, spec.nx, spec.nu)
    check_launches(name, fkm, counts, model)
    log(f"[slice] {name}: B={B_MAIN} T={T} f32 candidates={opts.num_step_sizes}")
    report(name, sol, stats, frac, frac_true, wall, counts, opts.num_step_sizes, B_MAIN)
    per_iteration_split(name, spec, opts, xs, us, ws)
    return frac_true, counts, wall


# ---------------------------------------------------------------------------
# phase 4c: the per-instance solver's vmap route end to end
# ---------------------------------------------------------------------------

SPLIT_ITERATIONS_VMAP = 3


def vmap_solver(P, spec, variant, device, **kw):
    """The batched solve of one phase 4c cell: "auto" is the literal
    make_batched_solve_fn(spec, Options()); "v1"/"v2" the tuned preset
    with traces through make_solve_fn(..., backward_impl=
    make_backward_dispatch(variant=...)).vmap().  ``kw`` are further
    options."""
    from iterativelqr_tpu_torch.ops.pallas_backward import make_backward_dispatch

    if variant == "auto":
        return P.make_batched_solve_fn(spec, P.Options(**kw), device=device,
                                       dtype=torch.float32)
    opts = P.Options(**dict(TUNED, record_traces=True, backward_pass="scan", **kw))
    return P.make_solve_fn(spec, opts, backward_impl=make_backward_dispatch(variant=variant),
                           device=device).vmap()


@contextlib.contextmanager
def trace_writes(tally):
    """Observes the fused solve loop of core/solve.py: at each test of its
    predicate, adds per lane (on the card, no host sync) to ``tally``:
    "writes", the trips that write a trace slot (the lane is live, so its
    body writes slot (al_it, inner_it) of the carry); "rewrites", those whose
    slot a trip before had already marked; "dropped", slots out of range
    (JAX drops such writes); and "truncated", round ends that kept al_it (a
    truncated round: the next round writes the same row again)."""
    from iterativelqr_tpu_torch.core import solve as solve_mod

    plain = solve_mod.while_lanes

    def observed(cond, body, carry, name):
        if name != "solve" or not hasattr(carry, "inner_it"):
            return plain(cond, body, carry, name)
        prev = {}

        def cond_observed(s):
            active = cond(s)
            if prev:
                tally["truncated"] += (prev["active"] & (s.inner_it == 0)
                                       & (s.al_it == prev["al_it"]) & ~s.stop).long()
            n_al, n_tr = s.trace_mask.shape[1:]
            fits = (s.al_it < n_al) & (s.inner_it < n_tr)
            slot = s.trace_mask[torch.arange(len(active), device=active.device),
                                s.al_it.clamp(max=n_al - 1).long(),
                                s.inner_it.clamp(max=n_tr - 1).long()]
            tally["writes"] += (active & fits).long()
            tally["rewrites"] += (active & fits & slot).long()
            tally["dropped"] += (active & ~fits).long()
            prev.update(active=active, al_it=s.al_it)
            return active

        return plain(cond_observed, body, carry, name)

    solve_mod.while_lanes = observed
    try:
        yield
    finally:
        solve_mod.while_lanes = plain


def run_vmap_cell(P, variant, B, model="acrobot"):
    """One phase 4c cell on the first B lanes, f32: acrobot (T=T_LOOP)
    with bench.py's initial guess, or
    the quadrotor T=41 with phase 4's inputs
    (model_inputs); a warm-up cut to one iteration, the timed solve with
    every count set to 0 just before, the checks, and a split of the first
    SPLIT_ITERATIONS_VMAP iterations.  The timed solve runs under
    ``trace_writes`` (a few element-wise ops a trip on the card): every
    iteration must write one trace slot, and trace_mask's count plus the
    slots written again must equal the iterations, per lane.  A dispatch
    cell's K6 launches must equal its backward attempts (the regularization
    loop's tests: one for each attempt).  Returns (solution, launch
    counts)."""
    from iterativelqr_tpu_torch import models
    from iterativelqr_tpu_torch.ops.batching import LOOP_TESTS

    name = {"auto": "vmap/Options()", "v1": "vmap/tuned+K6a", "v2": "vmap/tuned+K6b"}[variant]
    device = torch.device("cuda")
    T = ((T_VMAP_LOOP if variant == "auto" else T_LOOP) if model == "acrobot"
         else MODEL_CELLS[model][0])
    spec = P.build_spec(*getattr(models, model).problem(T)[:3])
    if model == "acrobot":
        xs, us, ws = bench_inputs(B, T, torch.float32, device)
    else:
        name = f"{name} {model}"
        xs, us, ws = model_inputs(model, B, T, torch.float32, device)
    vmap_solver(P, spec, variant, device, max_total_iterations=1)(xs, us, ws)
    torch.cuda.synchronize()
    solve = vmap_solver(P, spec, variant, device)
    LOOP_TESTS.clear()
    tally = collections.defaultdict(lambda: torch.zeros(B, dtype=torch.long, device=device))
    with trace_writes(tally):
        sol, stats, wall, counts = counted_solve(P, solve, (xs, us, ws))
    tests = dict(LOOP_TESTS)
    frac, frac_true = integrity(name, spec, sol, stats, ws, P.Options().constraint_tolerance,
                                B, T, spec.nx, spec.nu)
    if frac_true != frac:
        raise AssertionError(f"{name}: batch_stats solved {frac} != recomputed {frac_true}")
    if frac_true < 0.99:
        raise AssertionError(f"{name}: recomputed solved fraction {frac_true} < 0.99")
    k6 = {"auto": None, "v1": "riccati_masked", "v2": "riccati_masked_packed"}[variant]
    if k6 is not None and (spec.nx, spec.nu) == WIDE:
        k6 += "_wide"
    others = {k: v for k, v in counts.items() if k != k6 and v}
    if (k6 is not None and counts[k6] <= 0) or others:
        raise AssertionError(f"{name}: launches {counts}, expected only {k6}")
    if k6 is not None and counts[k6] != tests.get("regularization", 0):
        raise AssertionError(f"{name}: {counts[k6]} K6 launches, "
                             f"{tests.get('regularization', 0)} backward attempts")
    its = sol.iterations.long()
    marks = sol.trace_mask.sum(dim=(1, 2)).long()
    if not torch.equal(tally["writes"], its):
        raise AssertionError(f"{name}: trace writes differ from iterations on "
                             f"{int((tally['writes'] != its).sum())} lanes")
    if not torch.equal(marks + tally["rewrites"] + tally["dropped"], its):
        raise AssertionError(f"{name}: trace_mask count + slots written again + dropped "
                             f"!= iterations on {int((marks + tally['rewrites'] + tally['dropped'] != its).sum())} lanes")
    if bool(((tally["rewrites"] > 0) & (tally["truncated"] == 0)).any()):
        raise AssertionError(f"{name}: trace slots written again on a lane with no truncated round")
    trips = int(its.max())
    log(f"[vmap] {name}: B={B} T={T} f32 candidates "
        f"{P.Options(**(TUNED if variant != 'auto' else {})).num_step_sizes}: solved_fraction batch_stats {frac:.4f} "
        f"recomputed {frac_true:.4f}; iterations mean {float(its.float().mean()):.2f} max {trips}; "
        f"mean objective {float(stats.mean_objective):.4f}; max violation {float(stats.max_violation):.3e}")
    log(f"[vmap] {name}: wall {wall:.3f} s after a warm-up ({B * frac_true / wall:.1f} solved/s); "
        f"launches {k6 or 'none (plain backward)'} {counts.get(k6, 0) if k6 else 0}; loop tests (host syncs) "
        f"{sum(tests.values())}: solve loop {tests.get('solve', 0)} (trips {trips}), "
        f"regularization (backward attempts) {tests.get('regularization', 0)}; trace_mask count = iterations on "
        f"{int((marks == its).sum())} of {B} lanes; truncated rounds {int(tally['truncated'].sum())} "
        f"on {int((tally['truncated'] > 0).sum())} lanes, trace slots written again "
        f"{int(tally['rewrites'].sum())}, dropped {int(tally['dropped'].sum())}: "
        f"count + written again + dropped = iterations on every lane")
    timed = vmap_solver(P, spec, variant, device, max_total_iterations=SPLIT_ITERATIONS_VMAP)
    part, host, dev = phase_ms(lambda: timed(xs, us, ws), f"vmap_{variant}_{model}")
    n_it = int(part.iterations.max())
    log(f"[vmap] {name}: per iteration (first {n_it}, traced) " + ", ".join(
        f"{k} {host[k] / n_it:.2f} ms host / {dev[k] / n_it:.2f} ms device-events"
        for k in PHASES))
    return sol, counts


# ---------------------------------------------------------------------------
# phase 6a: the associative backward scan (ops/assoc.py) on the card
# ---------------------------------------------------------------------------

# (n, m, T): acrobot's and car's K1 dims at T=101, the quadrotor's at T=41
ASSOC_DIMS = ((4, 1, T_MAIN), (3, 2, T_MAIN), (12, 4, T_QUAD))
ASSOC_GRID_B = (1, 14, 64, 512, 4096)
ASSOC_GRID_T = (101, 501)


def assoc_stacks(seed, B, T, n, m, dtype, device):
    """Batch-leading derivative stacks [B, T-1, ...] (``wide_stacks``'
    scheme: symmetric positive definite gxx and guu)."""
    return [torch.as_tensor(np.moveaxis(a, -1, 0), dtype=dtype, device=device)
            for a in wide_stacks(seed, B, T - 1, n, m)]


def check_assoc():
    """backward_pass_associative on the card, B=64 and one instance (no lane
    axis), at ASSOC_DIMS, against the port's backward_pass_scan in f64 on
    the same stacks.  f64: the same value functions composed in another
    order (the port's CPU runs differ by about 1e-13 on these stacks):
    1e-10 relative.  f32: the composition's solves with I + C_i J_j
    amplify f32 rounding on an ill-conditioned lane, where the reverse scan
    does not (on the CPU at (12, 4), lane 53: 4.0e-4 relative against the
    reverse scan's 4.9e-7 in f32): 1e-3 relative."""
    from iterativelqr_tpu_torch.ops import assoc, backward

    dev = torch.device("cuda")
    for n, m, T in ASSOC_DIMS:
        um = torch.ones((T - 1, m), dtype=torch.bool, device=dev)
        ref = backward.backward_pass_scan(*assoc_stacks(11, 64, T, n, m, torch.float64, dev), um,
                                          torch.zeros(64, dtype=torch.float64, device=dev))
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
            st = assoc_stacks(11, 64, T, n, m, dtype, dev)
            reg = torch.zeros(64, dtype=dtype, device=dev)
            out = assoc.backward_pass_associative(*st, um, reg)
            one = assoc.backward_pass_associative(*(a[0] for a in st), um, reg[0])
            scan = backward.backward_pass_scan(*st, um, reg)
            rel = lambda xs, lane=slice(None): max(
                float((a.double() - b[lane]).abs().max() / b[lane].abs().max().clamp(min=1.0))
                for a, b in zip(xs[:5], ref[:5]))
            err, err_one, err_scan = rel(out), rel(one, 0), rel(scan)
            ok = bool(out[5].all()) and bool(ref[5].all()) and bool(one[5])
            log(f"[assoc] backward_pass_associative against backward_pass_scan in f64, (n, m)=({n}, "
                f"{m}) T={T} B=64 {str(dtype)[6:]}: max relative difference {err:.2e} (one instance "
                f"{err_one:.2e}; the reverse scan in {str(dtype)[6:]} {err_scan:.2e}), tolerance "
                f"{tol:.0e}; PD flags all set {ok}")
            if not (ok and err <= tol and err_one <= tol):
                raise AssertionError(f"associative scan at ({n}, {m}) T={T} {dtype}: "
                                     f"{err:.2e} / {err_one:.2e} > {tol}, or a PD flag unset")


def time_assoc_grid():
    """CUDA-event ms of the associative scan and the reverse scan, f32,
    acrobot's (4, 1), over ASSOC_GRID_B x ASSOC_GRID_T, unbatched (one
    instance, no lane axis) and batched; where the associative scan stops
    winning, beside the JAX package's rule (measured on a TPU v5e)."""
    from iterativelqr_tpu_torch.ops import assoc, backward

    dev = torch.device("cuda")
    n, m = 4, 1
    for T in ASSOC_GRID_T:
        full = assoc_stacks(13, max(ASSOC_GRID_B), T, n, m, torch.float32, dev)
        um = torch.ones((T - 1, m), dtype=torch.bool, device=dev)
        rows = []
        for B in (None,) + ASSOC_GRID_B:
            st = [a[0] for a in full] if B is None else [a[:B] for a in full]
            reg = torch.zeros(() if B is None else (B,), dtype=torch.float32, device=dev)
            # at T=501 one run after a warm-up (the reverse scan takes 0.6-0.9
            # s a run there: 3 runs took about 17 s of an 861.2 s run)
            reps = 3 if T < 501 else 1
            t_a = cuda_ms(lambda: assoc.backward_pass_associative(*st, um, reg), reps=reps, warmup=1)
            t_s = cuda_ms(lambda: backward.backward_pass_scan(*st, um, reg), reps=reps, warmup=1)
            rows.append((B, t_a, t_s))
            log(f"[assoc] T={T} {'unbatched' if B is None else f'B={B}'}: associative "
                f"{t_a:.3f} ms, reverse scan {t_s:.3f} ms ({t_s / t_a:.2f} x)")
        wins = [B for B, t_a, t_s in rows if B is not None and t_a < t_s]
        below = [B for B in ASSOC_GRID_B if all(b in wins for b in ASSOC_GRID_B if b <= B)]
        log(f"[assoc] T={T}: the associative scan wins at B in {wins}"
            f"{' and unbatched' if rows[0][1] < rows[0][2] else ''}; it wins at every B up to "
            f"{max(below) if below else 'none of the grid'}; the JAX package's _assoc_wins "
            f"(a TPU v5e rule, kept): B <= {max(1, T // 7)}")


# ---------------------------------------------------------------------------
# phase 6b: straggler compaction (core/solve_compact.py) on the kernel path
# ---------------------------------------------------------------------------

COMPACT_GRAINS = (128,)


@contextlib.contextmanager
def launches_by_shape(tally):
    """Observes core/solve_compact.py's host loop: each solver trip adds its
    K1/K3/K4 launches (host counters, no sync) to ``tally[B]`` by the
    carry's batch shape."""
    from iterativelqr_tpu_torch.core import solve_compact as sc

    plain = sc.make_sl_parts

    def observed(*a, **kw):
        parts = plain(*a, **kw)

        def body(ws):
            step = parts.body(ws)

            def counted(carry):
                before = {k: c.launches for k, c in counters().items()}
                out = step(carry)
                for k, c in counters().items():
                    tally[carry.stop.shape[-1]][k] += c.launches - before[k]
                return out

            return counted

        return parts._replace(body=body)

    sc.make_sl_parts = observed
    try:
        yield
    finally:
        sc.make_sl_parts = plain


def run_compacted(P, name, kw, ref, grain):
    """make_compacted_solve_fn on phase 4's B_MAIN inputs of one preset on
    the kernel path, at ``grain``, against phase 4's single-shot solution of
    the same preset and lanes (``ref``: solution, wall, inputs); returns
    the main path's launch counts."""
    from iterativelqr_tpu_torch.core import solve_compact as sc
    from iterativelqr_tpu_torch.models import acrobot

    ref_sol, ref_wall, (xs, us, ws) = ref
    label = f"compacted {name} GRAIN={grain}"
    dev = torch.device("cuda")
    spec = P.build_spec(*acrobot.problem(T_MAIN)[:3])
    opts = P.Options(**kw, forward_kernel="pallas")
    default_grain = sc.GRAIN
    sc.GRAIN = grain
    try:
        tally = collections.defaultdict(collections.Counter)
        with launches_by_shape(tally):
            solve = sc.make_compacted_solve_fn(spec, opts, device=dev, dtype=torch.float32)
            sol, stats, wall, counts = counted_solve(P, solve, (xs, us, ws))
    finally:
        sc.GRAIN = default_grain
    run = solve.last_run
    frac, frac_true = integrity(label, spec, sol, stats, ws, opts.constraint_tolerance,
                                B_MAIN, T_MAIN, 4, 1)
    if frac_true < 0.99:
        raise AssertionError(f"{label}: recomputed solved fraction {frac_true} < 0.99")
    check_launches(label, "pallas", counts, "acrobot")
    same_its = sol.iterations == ref_sol.iterations
    same = (same_its & (sol.xs == ref_sol.xs).all(dim=(1, 2))
            & (sol.us == ref_sol.us).all(dim=(1, 2)))
    n_same = int(same.sum())
    dx = float((sol.xs - ref_sol.xs).abs().max())
    du = float((sol.us - ref_sol.us).abs().max())
    log(f"[compact] {label}: shapes visited (B, trips) {run.shapes}; repacks {run.repacks}; "
        f"rescues fired {run.rescued}; launches K1 {counts['riccati_backward']}, K3 "
        f"{counts['sl_score_rollout']}, K4 {counts['sl_winner_reroll']}")
    log(f"[compact] {label}: launches by shape " + "; ".join(
        f"B={B}: K1 {c['riccati_backward']}, K3 {c['sl_score_rollout']}, K4 {c['sl_winner_reroll']}"
        for B, c in sorted(tally.items(), reverse=True)))
    log(f"[compact] {label}: wall {wall:.3f} s against single-shot {ref_wall:.3f} s "
        f"({ref_wall / wall:.2f} x); solved_fraction recomputed {frac_true:.4f}; lanes equal to "
        f"the single-shot solve bitwise (iterations, xs, us) {n_same} of {B_MAIN}; max |dxs| "
        f"{dx:.3e}, max |dus| {du:.3e}")
    if n_same != B_MAIN:
        # a batch-shape-dependent op on the card: iterations must still be
        # equal on every lane, trajectories within K1's f32 tolerance
        scale = float(ref_sol.xs.abs().max())
        if not bool(same_its.all()) or dx > 1e-4 * scale:
            raise AssertionError(f"{label}: {int((~same_its).sum())} lanes differ in iterations, "
                                 f"max |dxs| {dx:.3e}")
    return counts


def check_capped_rescue(P):
    """The capped-rescue scenario of tests/test_torch_solve_compact.py on
    the card (car T=8, B=16, f64, rollout kernels): a weak frozen penalty,
    cap 1, the progress gate and the limiter off; at least one lane fails
    without the rescue and every lane is feasible with it."""
    from torch.func import vmap

    from iterativelqr_tpu_torch.core.solve_compact import make_compacted_solve_fn
    from iterativelqr_tpu_torch.models import car

    T, B, dev, dtype = 8, 16, torch.device("cuda"), torch.float64
    dyn, cost, con, x1, _ = car.problem(T)
    spec = P.build_spec(dyn, cost, con)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(x1.numpy() + 0.1 * rng.standard_normal((B, 3)), dtype=dtype, device=dev)
    us = torch.full((B, T - 1, 2), 0.01, dtype=dtype, device=dev)
    xs = [x]
    for t in range(T - 1):
        x = vmap(dyn[t])(x, us[:, t])
        xs.append(x)
    args = (torch.stack(xs, dim=1), us, torch.zeros((B, T, 0), dtype=dtype, device=dev))
    opts = P.Options(
        record_traces=False, backward_pass="packed", max_iterations=4, max_dual_updates=25,
        batched_solver="sl", scaling_penalty=1.0, adaptive_penalty=False,
        initial_constraint_penalty=0.1, objective_tolerance=1e-8,
        lagrangian_gradient_tolerance=1e-8, early_round_iteration_cap=1,
        max_consecutive_truncations=999, truncation_requires_progress=False,
        forward_kernel="pallas")
    tol = opts.constraint_tolerance
    bare = make_compacted_solve_fn(spec, opts, rescue=False, device=dev, dtype=dtype)(*args)
    failed = int((~(bare.max_violation <= tol)).sum())
    solve = make_compacted_solve_fn(spec, opts, device=dev, dtype=dtype)
    out = solve(*args)
    worst = float(out.max_violation.max())
    log(f"[compact] capped rescue (car T={T}, B={B}, f64, cap 1): {failed} lanes infeasible "
        f"without the rescue; with it rescues fired {solve.last_run.rescued}, max violation "
        f"{worst:.3e} (tolerance {tol})")
    if failed < 1 or not bool((out.max_violation <= tol).all()):
        raise AssertionError("capped rescue: the scenario left no failed lane, or the rescue "
                             "left a lane infeasible")


# ---------------------------------------------------------------------------
# phase 6c: the Solver shell and parameter sensitivities
# ---------------------------------------------------------------------------


def check_solver(P):
    """Solver on car T=51 on the card, f64: solve, warm_solve, then
    reset_duals and warm_solve (a cold AL state); each feasible."""
    from iterativelqr_tpu_torch.models import car

    T = T_CAR
    d, o, c, x1, _ = car.problem(T)
    solver = P.Solver(d, o, c, options=P.Options(verbose=False), device="cuda")
    us = car.initial_controls(T)
    solver.initialize_controls(us).initialize_states(P.rollout(d, x1.to(torch.float64), us))
    for step in ("solve", "warm_solve", "reset_duals, warm_solve"):
        if step.startswith("reset"):
            solver.reset_duals()
        t0 = time.perf_counter()
        sol = solver.warm_solve() if "warm" in step else solver.solve()
        wall = time.perf_counter() - t0
        viol = float(sol.max_violation)
        log(f"[solver] car T={T} f64 on the card, {step}: iterations {int(sol.iterations)}, "
            f"AL iterations {int(sol.al_iterations)}, violation {viol:.3e}, objective "
            f"{float(sol.objective):.6f}, {wall:.1f} s")
        if not viol <= sol.tol_constraint:
            raise AssertionError(f"Solver {step}: violation {viol} above the tolerance")


def tracking_problem(P, T):
    """tests/test_sensitivity.py::_setup as torch functions: stage cost
    0.1 ||x - w||^2 + 0.1 u^2 with a 2-vector parameter w per timestep,
    terminal equality x = w."""
    from iterativelqr_tpu_torch.models._const import const_like

    def dyn_f(x, u, w):
        return const_like(((1.0, 0.2), (0.0, 1.0)), x) @ x + const_like((0.0, 0.2), x) * u[0]

    dyn = P.Dynamics(dyn_f, 2, 1, num_parameter=2)
    stage = P.Cost(lambda x, u, w: 0.1 * torch.sum((x - w) ** 2) + 0.1 * torch.sum(u ** 2),
                   2, 1, num_parameter=2)
    term = P.Cost(lambda x, u, w: 0.1 * torch.sum((x - w) ** 2), 2, 0, num_parameter=2)
    goal = P.Constraint(lambda x, u, w: x - w, 2, 0, num_parameter=2)
    return P.build_spec([dyn] * (T - 1), [stage] * (T - 1) + [term],
                        [P.Constraint() for _ in range(T - 1)] + [goal])


def check_sensitivity(P):
    """parameter_gradient on the tracking problem at T=9, f64, on the
    card, against central finite differences of the re-solved optimal value
    (tests/test_sensitivity.py's tolerances: rtol 2e-3, atol 2e-5)."""
    from iterativelqr_tpu_torch.ops.derivatives import total_cost

    T, dev = 9, torch.device("cuda")
    spec = tracking_problem(P, T)
    opts = P.Options(verbose=False, objective_tolerance=1e-10,
                     lagrangian_gradient_tolerance=1e-10, constraint_tolerance=1e-8,
                     max_dual_updates=14)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    ws = 0.3 * np.random.default_rng(3).standard_normal((T, 2))
    xs0 = np.zeros((T, 2))
    xs0[0] = [0.5, -0.2]
    us0 = np.zeros((T - 1, 1))
    solve = P.make_solve_fn(spec, opts, device=dev)
    t0 = time.perf_counter()
    sol = solve(t(xs0), t(us0), t(ws))
    g = P.solution_parameter_gradient(spec, opts, sol, t(ws))
    wall = time.perf_counter() - t0
    if not float(sol.max_violation) <= 1e-8:
        raise AssertionError(f"sensitivity: the solve is not feasible ({float(sol.max_violation)})")

    def value(w):
        s = solve(t(xs0), t(us0), t(w))
        return float(total_cost(spec, s.xs, s.us, t(w)))

    eps, worst = 1e-5, 0.0
    pick = np.random.default_rng(0)
    for _ in range(4):
        i, j = int(pick.integers(0, T)), int(pick.integers(0, 2))
        e = np.zeros_like(ws)
        e[i, j] = eps
        fd = (value(ws + e) - value(ws - e)) / (2 * eps)
        gij = float(g[i, j])
        worst = max(worst, abs(gij - fd))
        if not np.isclose(gij, fd, rtol=2e-3, atol=2e-5):
            raise AssertionError(f"sensitivity: dJ*/dw[{i}, {j}] {gij:.8f} against fd {fd:.8f}")
    log(f"[solver] parameter_gradient, tracking problem T={T} f64 on the card: iterations "
        f"{int(sol.iterations)}, solve and gradient {wall:.1f} s; 4 entries against central "
        f"differences, max |adjoint - fd| {worst:.2e} (rtol 2e-3, atol 2e-5)")


# ---------------------------------------------------------------------------
# phase 7: the other models (M16), full DDP (M12), MPC and its farm (M14)
# ---------------------------------------------------------------------------


def run_new_models(P):
    """Phase 7b: the SL solver with "auto" rollouts (K1 and K3/K4 on the
    card), f32, B=4096, on particle, pendulum and cartpole; each solved
    fraction recomputed from the trajectories must be >= 0.99.  Returns the
    launch counts of each model's timed solve."""
    counts = {}
    for model in NEW_MODEL_CELLS:
        frac, counts[model], _ = run_model(P, model, "auto")
        if frac < 0.99:
            raise AssertionError(f"{model}: recomputed solved fraction {frac} < 0.99")
    return counts


def check_ddp(P):
    """Phase 7c: full DDP per instance on the card in f64 (the reverse scan
    with the dynamics second derivatives; no kernel).  Particle T=11 from
    tests/test_ddp.py's guess: the DDP solve takes the Gauss-Newton
    solve's iterations and iterates (xs within 1e-8).  Acrobot T=T_DDP
    from golden_acrobot.npz's first controls: both solves feasible, and
    DDP's objective at most 1.05 times the Gauss-Newton solve's of the
    same run, as tests/test_ddp.py asks of JAX's DDP."""
    from iterativelqr_tpu_torch.models import acrobot, particle

    dev, dtype = torch.device("cuda"), torch.float64
    T = 11
    dyn, cost, con, x1, _ = particle.problem(T)
    spec = P.build_spec(dyn, cost, con)
    xs = torch.zeros((T, 2), dtype=dtype, device=dev)
    xs[0] = x1
    us = torch.full((T - 1, 1), 0.05, dtype=dtype, device=dev)
    ws = torch.zeros((T, 0), dtype=dtype, device=dev)
    for c in counters().values():
        c.reset()
    gn = P.make_solve_fn(spec, P.Options(), device=dev)(xs, us, ws)
    ddp = P.make_solve_fn(spec, P.Options(ddp=True), device=dev)(xs, us, ws)
    launched = {k: c.launches for k, c in counters().items() if c.launches}
    dx = float((ddp.xs - gn.xs).abs().max())
    log(f"[ddp] particle T={T} f64 per instance: DDP {int(ddp.iterations)} iterations, "
        f"Gauss-Newton {int(gn.iterations)}; max |dxs| {dx:.3e}; objective {float(ddp.objective):.6f} "
        f"vs {float(gn.objective):.6f}")
    if int(ddp.iterations) != int(gn.iterations) or dx > 1e-8 or launched:
        raise AssertionError(f"ddp particle: not equal to Gauss-Newton (or launched {launched})")

    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "fixtures", "golden_acrobot.npz"))
    T = T_DDP
    dyn, cost, con, x1, _ = acrobot.problem(T)
    spec = P.build_spec(dyn, cost, con)
    us = torch.as_tensor(data["us0"][: T - 1], dtype=dtype, device=dev)
    xs = torch.stack(P.rollout(dyn, x1.to(dev, dtype), us))
    ws = torch.zeros((T, 0), dtype=dtype, device=dev)
    t0 = time.perf_counter()
    gn = P.make_solve_fn(spec, P.Options(), device=dev)(xs, us, ws)
    gn_wall = time.perf_counter() - t0
    opts = P.Options(ddp=True)
    t0 = time.perf_counter()
    sol = P.make_solve_fn(spec, opts, device=dev)(xs, us, ws)
    wall = time.perf_counter() - t0
    viol, obj, ref = float(sol.max_violation), float(sol.objective), float(gn.objective)
    log(f"[ddp] acrobot T={T} f64 per instance from golden_acrobot's first {T - 1} controls: "
        f"violation {viol:.3e}, objective {obj:.4f} (Gauss-Newton in this run {ref:.4f}, "
        f"{int(gn.iterations)} iterations, {gn_wall:.1f} s; ratio {obj / ref:.4f}), iterations "
        f"{int(sol.iterations)}, AL rounds {int(sol.al_iterations)}, {wall:.1f} s")
    if not (viol <= opts.constraint_tolerance and float(gn.max_violation) <= opts.constraint_tolerance
            and obj <= 1.05 * ref):
        raise AssertionError("ddp acrobot: infeasible or objective above 1.05 x Gauss-Newton's")


def check_mpc(P):
    """Phase 7d, one controller: tests/test_mpc.py's disturbance scenario
    on the card (particle T=11, f64, per instance, constraint-aware
    acceptance on the loop rollouts): 12 steps from (-0.5, 0.3), noise
    0.02 N(0,1) from numpy seed 0 on the first 6; the final plan reaches
    the goal within 5e-3."""
    from iterativelqr_tpu_torch.core.mpc import make_mpc_controller
    from iterativelqr_tpu_torch.models import particle

    dev, dtype = torch.device("cuda"), torch.float64
    T = 11
    dyn, cost, con, _, xT = particle.problem(T)
    spec = P.build_spec(dyn, cost, con)
    init, step = make_mpc_controller(spec, P.Options(verbose=False, record_traces=False),
                                     device=dev)
    ws = torch.zeros((T, 0), dtype=dtype, device=dev)
    state = init(torch.zeros((T, 2), dtype=dtype, device=dev),
                 torch.zeros((T - 1, 1), dtype=dtype, device=dev))
    rng = np.random.default_rng(0)
    x = torch.tensor([-0.5, 0.3], dtype=dtype, device=dev)
    its = []
    t0 = time.perf_counter()
    for i in range(12):
        out = step(state, x, ws)
        state = out.state
        its.append(int(out.solution.iterations))
        noise = 0.02 * rng.standard_normal(2) if i < 6 else np.zeros(2)
        x = dyn[0](x, out.action) + torch.as_tensor(noise, dtype=dtype, device=dev)
    wall = time.perf_counter() - t0
    sol = out.solution
    err = float((sol.xs[-1] - xT.to(dtype)).abs().max())
    log(f"[mpc] controller, particle T={T} f64 on the card: 12 steps in {wall:.1f} s, iterations "
        f"a step {its}; final plan violation {float(sol.max_violation):.3e}, |x_T - goal| {err:.3e}")
    if not (bool(torch.isfinite(sol.xs).all()) and float(sol.max_violation) <= 5e-3 and err <= 5e-3):
        raise AssertionError("mpc: the final plan does not reach the goal within 5e-3")
    return state


FARM_B, FARM_T, FARM_STEPS = B_MAIN, 11, 12


def run_farm(P, spec=None, label="farm"):
    """Phase 7d, the farm (examples/mpc_farm.py's loop from the port's
    public pieces, on the library's particle problem, whose terminal goal
    equality carries every plan to the goal; phase 8c: ``spec``, the
    example's own tracking costs, on a generated model, whose K3/K4 must
    launch in every warm solve too): 4096 controllers, T=11, f32;
    initial states N(0, 0.3) from numpy seed 0, plant noise 0.005 N(0,1);
    one cold SL solve, then 12 warm steps of shift, closed-loop re-roll
    over the lanes and warm SL solve (duals carried, penalties capped at
    1e4), all with the kernels ("auto" rollouts).  Every plan must be
    feasible at every step (max violation < 5e-3), and K1, K3 and K4 must
    launch in every warm solve (counts set to 0 just before and read just
    after each).  Reports
    plans/s (B x steps / wall of the warm steps), trips a step, and a split
    of one more warm step into re-roll and the solve's phases (spans),
    host against device-event time.  Returns (plans/s, the warm solves'
    launch counts)."""
    from iterativelqr_tpu_torch.core.solve_sl import make_batched_solve_sl
    from iterativelqr_tpu_torch.models import particle
    from iterativelqr_tpu_torch.ops.batching import lane_eval
    from iterativelqr_tpu_torch.ops.rollout import closed_loop_rollout, open_loop_rollout

    dev, dtype = torch.device("cuda"), torch.float32
    B, T = FARM_B, FARM_T
    generated = spec is not None
    spec = P.build_spec(*particle.problem(T)[:3]) if spec is None else spec
    launched = ("riccati_backward", "sl_score_rollout", "sl_winner_reroll") + (
        ("sl_score_rollout_generated", "sl_winner_reroll_generated") if generated else ())
    # examples/mpc_farm.py's options, with the rollout kernels where the
    # card can run them (the default "scan" keeps the loops)
    opts = P.Options(verbose=False, record_traces=False, objective_tolerance=1.0e-8,
                     max_penalty=1.0e6, forward_kernel="auto")
    ws = torch.zeros((B, T, 0), dtype=dtype, device=dev)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0.0, 0.3, (B, 2)), dtype=dtype, device=dev)
    us = torch.zeros((B, T - 1, 1), dtype=dtype, device=dev)
    solve_cold = P.make_batched_solve_fn(spec, opts, device=dev, dtype=dtype)
    solve_warm = P.make_batched_solve_fn(spec, opts, dual_warm_start=True, device=dev, dtype=dtype)
    shift = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)

    def reroll(x_meas, sol):
        """The warm solve's (xs, us, ws, duals, penalty): every plan shifted
        and re-rolled closed-loop from its measured state, the duals
        shifted, the penalties shifted and capped."""
        xs0, us0 = closed_loop_rollout(spec, shift(sol.xs), shift(sol.us), ws, shift(sol.K),
                                       torch.zeros_like(sol.k), 0.0, x0=x_meas)
        return xs0, us0, ws, shift(sol.duals), torch.clamp(shift(sol.penalty), max=1.0e4)

    def plant(x, action):
        return (lane_eval(spec.dyn_eval[0], x, action, ws[:, 0])
                + torch.as_tensor(rng.normal(0.0, 0.005, (B, 2)), dtype=dtype, device=dev))

    t0 = time.perf_counter()
    sol = solve_cold(open_loop_rollout(spec, x, us, ws), us, ws)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    viol = float(sol.max_violation.max())
    log(f"[{label}] cold SL solve B={B} T={T} f32: {cold_wall:.3f} s (first call), trips "
        f"{int(sol.iterations.max())}, max violation {viol:.3e}")
    if viol >= 5e-3:
        raise AssertionError(f"{label}: cold plans infeasible ({viol:.3e})")
    total = collections.Counter()
    trips, walls = [], []
    for k in range(FARM_STEPS):
        for c in counters().values():
            c.reset()
        t0 = time.perf_counter()
        sol = solve_warm(*reroll(x, sol))
        action = sol.us[:, 0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = {k_: c.launches for k_, c in counters().items()}
        total.update(counts)
        trips.append(int(sol.iterations.max()))
        for kname in launched:
            if counts[kname] <= 0:
                raise AssertionError(f"{label} step {k}: {kname} was not launched "
                                     f"({trips[-1]} trips)")
        viol = float(sol.max_violation.max())
        if not viol < 5e-3:
            raise AssertionError(f"{label} step {k}: a plan is infeasible (max violation {viol:.3e})")
        x = plant(x, action)
    wall = sum(walls)
    dist = float((x - torch.tensor([1.0, 0.0], dtype=dtype, device=dev)).norm(dim=1).mean())
    log(f"[{label}] {FARM_STEPS} warm steps of B={B} controllers: {wall:.3f} s, "
        f"{B * FARM_STEPS / wall:.1f} plans/s; s a step {[round(w, 3) for w in walls]}; warm trips "
        f"a step {trips}; every plan feasible at every step (last max violation {viol:.3e}); "
        f"launches over the warm solves K1 {total['riccati_backward']}, K3 "
        f"{total['sl_score_rollout']}, K4 {total['sl_winner_reroll']}; mean distance to the goal "
        f"{dist:.3f}")
    # one more warm step, split: the re-roll (host loop) and the solve's
    # phases, host wall against device-event time (traced)
    from iterativelqr_tpu_torch.utils import profiling

    timed = make_batched_solve_sl(spec, opts, device=dev, dtype=dtype, dual_warm_start=True)

    def step():
        with profiling.annotate("reroll"):
            args = reroll(x, sol)
        return timed(*args)

    part, host, dev_ms = phase_ms(step, label.replace("/", "_"))
    log(f"[{label}] one more warm step ({int(part.iterations.max())} trips, traced), host / "
        "device-event ms: " + ", ".join(f"{k} {host[k]:.2f} / {dev_ms[k]:.2f}"
                                       for k in ("reroll",) + PHASES))
    return B * FARM_STEPS / wall, total


# ---------------------------------------------------------------------------
# phase 9: batch sharding, time sharding, profiling, checkpoint, dry run
# ---------------------------------------------------------------------------

POD_TOTAL, POD_T = 65536, 51
DIST_T, DIST_B = 11, 4096
T_LONG_CHECK = 1025
# the long-horizon example's solve (pendulum, per instance, four chunks on
# the card) at T_LONG, not its default T=1025: at 1025 it took 108
# iterations and 208.9 s (NVIDIA H100 80GB HBM3, 700 W), about 1.9 s an
# iteration of per-instance loop rollouts over 1,024 steps; the port's CPU
# path takes the same 108 iterations at T=257, 385 and 1025, and the time
# an iteration scales with T: T=257 took 69.6 s in a whole run and T=129
# 46.9 s, which keeps the run inside its budget; the recursion is still
# held at T=1025.  Then cut to T=65 for the run's budget (T=129: 33.5 s
# of a 726.7 s run and 46.2 s of an 811.9 s one on a slower host, NVIDIA
# H100 80GB HBM3, 700 W); the CPU path takes the same 108 iterations at
# T=65 (violation 1.8e-4).  Then cut to T=33 for phase 10's time (T=65:
# 29.9 s of phase 9e in an 867.3 s run, NVIDIA H100 80GB HBM3, 700 W): the
# CPU path solves it in 39 iterations (violation 7.4e-4), still four chunks
T_LONG = 33
# phase 9f traces a tuned solve cut to PROFILE_TRIPS trips, after an
# untraced call of the same solver: the whole solve (86 trips, traced with
# Python frames) took 307 s with the profiler and the analysis of its
# 187,023 device operations (NVIDIA H100 80GB HBM3, 700 W); traced from
# the solver's first call its first 4 trips read busy 0.0444, its first 6
# 0.0624 and all 86 0.0646; after an untraced call, 8 trips read 0.0531 to
# 0.0616 trip by trip, and the Python tracer stretched a trip from about
# 80 to 265 ms, hence the second trace without it.  Then cut to 4 trips
# for phase 11's time (8 trips: 37.7 s of phase 9f in an 843.2 s run,
# NVIDIA H100 80GB HBM3, 700 W): the trips after the warm-up read the same
# busy share one by one (0.0754-0.0918 at 8 trips), so 4 show it; then
# to 2 (4 trips: 17.6 s of phase 9f in an 832.7 s stretch of a run, NVIDIA
# H100 80GB HBM3, 700 W), the busy share of two warmed trips
PROFILE_TRIPS = 2
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_scratch")


def main_path(P, label, fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before and read
    just after (and the card synchronised); returns (its value, wall s,
    counts)."""
    for c in counters().values():
        c.reset()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters().items()}
    log(f"[{label}] launches K1 {counts['riccati_backward']}, K3 {counts['sl_score_rollout']}, "
        f"K4 {counts['sl_winner_reroll']}")
    return out, wall, counts


def run_pod_sweep(P):
    """Phase 9a: iterativelqr_tpu_torch/examples/pod_sweep.py at its default
    size (65,536 instances, T=51, f32: acrobot 32,768 and car 32,768 lanes)
    over default_mesh() (every visible card), one family after the other;
    per family the wall, solves/s, the solved fraction recomputed from the
    returned trajectories, the iterations and the K1/K3/K4 launches."""
    from iterativelqr_tpu_torch.examples import pod_sweep
    from iterativelqr_tpu_torch.parallel import default_mesh

    mesh = default_mesh()
    opts = P.Options(verbose=False, record_traces=False, forward_kernel="auto")
    total = collections.Counter()
    for name, spec, scale, us0 in pod_sweep.families(POD_T):
        (sol, stats, wall), _, counts = main_path(
            P, f"pod_sweep {name}", pod_sweep.sweep, name, spec, scale, us0, POD_T,
            POD_TOTAL // 2, mesh, opts)
        total.update(counts)
        B = POD_TOTAL // 2
        ws = torch.zeros((B, POD_T, 0), device=sol.xs.device)
        frac_true = recomputed_solved_fraction(spec, sol, ws, opts.constraint_tolerance)
        log(f"[pod_sweep] {name}: {B} lanes T={POD_T} f32 over {mesh}: wall {wall:.3f} s, "
            f"{B / wall:.1f} solves/s ({B * frac_true / wall:.1f} solved/s); solved fraction "
            f"batch_stats {float(stats.solved_fraction):.4f} recomputed {frac_true:.4f}; "
            f"iterations mean {float(sol.iterations.float().mean()):.2f} max "
            f"{int(sol.iterations.max())}")
        if counts["riccati_backward"] <= 0 or counts["sl_score_rollout"] <= 0:
            raise AssertionError(f"pod_sweep {name}: K1 or K3 was not launched {counts}")
        if frac_true < 0.99:
            raise AssertionError(f"pod_sweep {name}: recomputed solved fraction {frac_true} < 0.99")
    return total


def lanes_equal(label, sol, ref, fields=("iterations", "xs", "us")):
    """Every lane of ``sol`` bitwise equal to ``ref`` in ``fields``."""
    for f in fields:
        a, b = getattr(sol, f), getattr(ref, f)
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"{label}: {f} differs from the single-shot solve on {bad} lanes")


def stats_equal(label, stats, want):
    """Counts and maxima bitwise; the two means to f32 rounding (summed in
    another order)."""
    for f in ("solved_fraction", "mean_iterations", "max_violation", "line_search_failures"):
        if not torch.equal(getattr(stats, f), getattr(want, f)):
            raise AssertionError(f"{label}: stats {f} {getattr(stats, f)} != {getattr(want, f)}")
    for f in ("mean_violation", "mean_objective"):
        a, b = float(getattr(stats, f)), float(getattr(want, f))
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{label}: stats {f} {a} against {b}")


def run_sharded(P, ref):
    """Phase 9b: make_sharded_solve_fn over default_mesh([cuda:0, cuda:0])
    (two shards on one card, advanced trip by trip in turns) on phase 4's
    tuned kernel inputs (acrobot T=101, B=4096, forward_kernel="pallas"):
    every lane bitwise equal to phase 4's single-shot solve, the stats
    reduced across the shards equal to its batch_stats.  Two shards share
    the card, so no speed is read from the wall.  Returns (Solution,
    counts)."""
    from iterativelqr_tpu_torch.models import acrobot
    from iterativelqr_tpu_torch.parallel import default_mesh, make_sharded_solve_fn

    ref_sol, ref_wall, inputs = ref
    mesh = default_mesh([torch.device("cuda", 0)] * 2)
    spec = P.build_spec(*acrobot.problem(T_MAIN)[:3])
    solve = make_sharded_solve_fn(spec, P.Options(**TUNED, forward_kernel="pallas"), mesh=mesh)
    (sol, stats), wall, counts = main_path(P, "sharded", solve, *inputs)
    lanes_equal("sharded", sol, ref_sol)
    stats_equal("sharded", stats, P.batch_stats(ref_sol))
    log(f"[sharded] tuned acrobot T={T_MAIN} B={B_MAIN} over {mesh}: every lane's iterations, "
        f"xs and us bitwise equal to the single-shot solve; reduced stats equal to its "
        f"batch_stats (solved {float(stats.solved_fraction):.4f}); wall {wall:.3f} s "
        f"(single-shot {ref_wall:.3f} s; one card, no speed read)")
    check_launches("sharded", "pallas", counts, "acrobot")
    return sol, counts


def run_compacted_devices(P, ref):
    """Phase 9c: per-device compaction (make_compacted_solve_fn with
    devices=[cuda:0, cuda:0]) on phase 4's tuned kernel inputs, every lane
    bitwise equal to phase 4's single-shot tuned solve.  (Parity's until
    phase 11: 45.7 s of an 843.2 s run, NVIDIA H100 80GB HBM3, 700 W, for
    its 224 trips against tuned's 86; phase 6b still compacts parity on
    one device.)"""
    from iterativelqr_tpu_torch.core.solve_compact import make_compacted_solve_fn
    from iterativelqr_tpu_torch.models import acrobot

    ref_sol, ref_wall, inputs = ref
    spec = P.build_spec(*acrobot.problem(T_MAIN)[:3])
    devices = [torch.device("cuda", 0)] * 2
    solve = make_compacted_solve_fn(spec, P.Options(**TUNED, forward_kernel="pallas"),
                                    devices=devices, device="cuda", dtype=torch.float32)
    sol, wall, counts = main_path(P, "compacted devices", solve, *inputs)
    lanes_equal("compacted devices", sol, ref_sol)
    log(f"[compacted devices] tuned acrobot T={T_MAIN} B={B_MAIN} on {[str(d) for d in devices]}: "
        f"sub-batches (shapes visited, repacks) "
        f"{[(r.shapes, r.repacks) for r in solve.last_run]}; every lane's iterations, xs and us "
        f"bitwise equal to the single-shot solve; wall {wall:.3f} s (single-shot {ref_wall:.3f} s)")
    check_launches("compacted devices", "pallas", counts, "acrobot")
    return counts


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world, backend, outdir, routes):
    """Start ``world`` ranks of tests/torch_distributed_worker.py on the
    card (particle T=DIST_T, B=DIST_B, the SL route with the kernels; the
    route "horizon": the time-sharded recursion across the ranks)."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "torch_distributed_worker.py")
    init = f"tcp://127.0.0.1:{free_port()}"
    return [subprocess.Popen([sys.executable, worker, init, str(world), str(r), outdir, "cuda",
                              backend, str(DIST_T), str(DIST_B), routes],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish_ranks(procs, backend, outdir):
    """Wait for the ranks, each with a timeout (a rank still running then
    is killed); a failed rank fails the run.  Returns each rank's
    results."""
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{backend} rank {r} of {len(procs)} failed ({p.returncode}):\n"
                                 f"{out[-3000:]}")
    return [np.load(os.path.join(outdir, f"rank{r}.npz")) for r in range(len(procs))]


def start_distributed():
    """Phase 9d, started: two gloo ranks sharing cuda:0 (NCCL refuses two
    ranks on one card) and one NCCL rank at world size 1, started together
    (two process groups, each on its own port); they run while phases 9b
    and 9c run, whose walls are not read for speed.  Returns what
    ``finish_distributed`` takes."""
    import tempfile

    os.makedirs(SCRATCH, exist_ok=True)
    outdir = tempfile.mkdtemp(dir=SCRATCH)
    runs = {}
    for world, backend, routes in ((2, "gloo", "sl,horizon"), (1, "nccl", "sl")):
        os.makedirs(os.path.join(outdir, backend))
        runs[world, backend] = start_ranks(world, backend, os.path.join(outdir, backend), routes)
    return outdir, runs, time.perf_counter()


def finish_distributed(P, started):
    """Phase 9d: the sharded solve across processes on the card; each rank
    solves its rows through K1/K3/K4 (particle T=11, B=4096, f32).  Both
    gloo ranks report the same global xs and stats, and those and the NCCL
    rank's equal a one-process solve of the batch bitwise.  The gloo ranks
    also run the time-sharded recursion across the two processes (one
    "time" entry a rank, cuda:0 both) on the worker's pendulum
    linearizations in f64: both return the same global results, within
    1e-12 of the one-process recursion over [cuda:0] x 2."""
    import shutil

    from iterativelqr_tpu_torch.models import particle

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_distributed_worker as worker

    outdir, runs, t0 = started
    try:
        results = {key: finish_ranks(procs, key[1], os.path.join(outdir, key[1]))
                   for key, procs in runs.items()}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    wall = time.perf_counter() - t0
    spec = P.build_spec(*particle.problem(DIST_T, device="cuda")[:3])
    opts = P.Options(**worker.ROUTES["sl"], forward_kernel="pallas")
    args = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in worker.global_batch(spec, DIST_T, DIST_B)]
    ref = P.make_batched_solve_fn(spec, opts, device="cuda", dtype=torch.float32)(*args)
    want = P.batch_stats(ref)
    for (world, backend), ranks in results.items():
        for r, d in enumerate(ranks):
            for f in ("xs", "us", "iterations", "max_violation", "objective"):
                if not np.array_equal(d[f"sl_{f}"], getattr(ref, f).cpu().numpy()):
                    raise AssertionError(f"{backend} rank {r}: global {f} differs from the "
                                         "one-process solve")
            for f in ("solved_fraction", "mean_iterations", "max_violation",
                      "line_search_failures"):
                if float(d[f"sl_stats_{f}"]) != float(getattr(want, f)):
                    raise AssertionError(f"{backend} rank {r}: stats {f} differs")
            for f in ranks[0].files:
                if not np.array_equal(d[f], ranks[0][f]):
                    raise AssertionError(f"{backend}: ranks 0 and {r} differ in {f}")
            k1, k3, k4 = (int(v) for v in d["sl_launches"])
            if min(k1, k3, k4) <= 0:
                raise AssertionError(f"{backend} rank {r}: K1/K3/K4 launches {k1}/{k3}/{k4}")
        log(f"[distributed] {backend}, {world} rank(s) on cuda:0, particle T={DIST_T} B={DIST_B} "
            f"f32 (mesh of {int(ranks[0]['mesh_size'])} entries): every rank's global xs, us, "
            f"iterations and stats equal, and equal to the one-process solve bitwise (solved "
            f"{float(ranks[0]['sl_stats_solved_fraction']):.4f}); K1/K3/K4 launches by rank "
            f"{[d['sl_launches'].tolist() for d in ranks]}")
    from iterativelqr_tpu_torch.parallel import default_mesh, make_horizon_sharded_backward

    ranks = results[2, "gloo"]
    one = make_horizon_sharded_backward(default_mesh([torch.device("cuda", 0)] * 2, "time"),
                                        "time")
    errs = []
    for T_h, lanes in worker.HORIZON:
        stacks, um, reg = worker.horizon_case(P, T_h, lanes, "cuda")
        for name, want in zip(worker.HORIZON_NAMES, one(*stacks, um, reg)):
            want = want.cpu().numpy()
            for r, d in enumerate(ranks):
                got = d[f"horizon_T{T_h}_{name}"]
                if got.shape != want.shape:
                    raise AssertionError(f"horizon T={T_h} {name}: rank {r} shape {got.shape}")
                if name == "ok":
                    if not (got.all() and want.all()):
                        raise AssertionError(f"horizon T={T_h}: ok flags {got}, {want}")
                    continue
                err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))
                if not err <= 1e-12:
                    raise AssertionError(f"horizon T={T_h} {name}: rank {r} {err:.2e} from the "
                                         "one-process recursion")
                errs.append(err)
    log(f"[distributed] gloo, 2 ranks on cuda:0: the time-sharded recursion across the "
        f"processes (mesh of {int(ranks[0]['horizon_mesh_size'])} entries; pendulum T="
        f"{', '.join(str(t) for t, _ in worker.HORIZON)} f64) equals the one-process recursion "
        f"over [cuda:0] x 2 on both ranks: max relative diff {max(errs):.1e}")
    log(f"[distributed] both groups' processes, started before phase 9b: {wall:.1f} s to "
        "their end")


def check_horizon(P):
    """Phase 9e: make_horizon_sharded_backward over [cuda:0] x 4 and x 8
    against backward_pass_associative (1e-10 relative) and the reverse scan
    on one linearization of pendulum T=1025 in f64 (controls 0.01 + 0.01
    N(0,1), rolled out from x1); then the long-horizon example's solve."""
    from iterativelqr_tpu_torch.examples import long_horizon
    from iterativelqr_tpu_torch.models import pendulum
    from iterativelqr_tpu_torch.ops import derivatives as dv
    from iterativelqr_tpu_torch.ops.assoc import backward_pass_associative
    from iterativelqr_tpu_torch.ops.backward import backward_pass_scan
    from iterativelqr_tpu_torch.ops.rollout import open_loop_rollout
    from iterativelqr_tpu_torch.parallel import default_mesh, make_horizon_sharded_backward

    dev, T = torch.device("cuda"), T_LONG_CHECK
    dyn, cost, con, x1, _ = pendulum.problem(T, device=dev)
    spec = P.build_spec(dyn, cost, con)
    rng = np.random.default_rng(SEED)
    us = torch.as_tensor(0.01 + 0.01 * rng.standard_normal((T - 1, 1)), device=dev)
    ws = torch.zeros((T, 0), dtype=torch.float64, device=dev)
    xs = open_loop_rollout(spec, x1, us, ws)
    stacks = (*dv.dynamics_jacobians(spec, xs, us, ws), *dv.cost_gradients(spec, xs, us, ws),
              *dv.cost_hessians(spec, xs, us, ws))
    um = torch.as_tensor(spec.u_mask, device=dev)
    reg = torch.zeros((), dtype=torch.float64, device=dev)
    assoc = backward_pass_associative(*stacks, um, reg)
    scan = backward_pass_scan(*stacks, um, reg)
    for n in (4, 8):
        mesh = default_mesh([torch.device("cuda", 0)] * n, "time")
        bp = make_horizon_sharded_backward(mesh, "time")
        out = bp(*stacks, um, reg)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: bp(*stacks, um, reg), reps=3, warmup=1)
        errs = {}
        for name, a, b, c in zip(("K", "k", "Qx", "Qu", "p"), out[:5], assoc[:5], scan[:5]):
            ra = float((a - b).abs().max() / b.abs().max())
            rs = float((a - c).abs().max() / c.abs().max())
            errs[name] = (ra, rs)
            if not ra <= 1e-10 or not rs <= 1e-8:
                raise AssertionError(f"horizon x{n}: {name} {ra:.2e} from the associative scan, "
                                     f"{rs:.2e} from the reverse scan")
        if not (bool(out[5]) and bool(assoc[5])):
            raise AssertionError(f"horizon x{n}: ok flags {bool(out[5])}, {bool(assoc[5])}")
        log(f"[horizon] pendulum T={T} f64, {n} chunks on cuda:0: relative to the associative "
            f"scan / the reverse scan " + ", ".join(f"{k} {a:.1e} / {b:.1e}" for k, (a, b) in
                                                     errs.items()) + f"; {ms:.2f} ms a call")
    sol, wall = long_horizon.main(["--horizon", str(T_LONG), "--device", "cuda"])
    log(f"[horizon] long_horizon example: pendulum T={T_LONG}, 4 chunks on cuda:0: "
        f"{int(sol.iterations)} iterations, objective {float(sol.objective):.6f}, violation "
        f"{float(sol.max_violation):.3e}, wall {wall:.1f} s")
    if not float(sol.max_violation) <= 5e-3:
        raise AssertionError("long_horizon: the solve is infeasible")


def busy_and_gaps(spans, t0, t1):
    """(busy share of [t0, t1] under the union of the (start, end)
    ``spans``, the three longest idle gaps as (start, end))."""
    spans = sorted((max(a, t0), min(b, t1)) for a, b in spans if b > t0 and a < t1)
    busy, gaps, cursor = 0.0, [], t0
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if t1 > cursor:
        gaps.append((cursor, t1))
    return busy / (t1 - t0), sorted(gaps, key=lambda g: g[0] - g[1])[:3]


def profile_tuned(P, ref):
    """Phase 9f: utils/profiling.trace (CPU and CUDA activities) around a
    tuned solve on phase 4's kernel inputs (acrobot T=101, B=4096), cut to
    PROFILE_TRIPS trips, after one untraced call of the same solver and
    one timed untraced call, read from the exported Chrome trace (one
    clock for host, device and Python events).  A trace without Python
    frames gives the ten device operations with the most device time, the
    share of the solve's window in which the card ran any device operation
    and that share trip by trip (a trip ends where its K4 re-roll ends); a
    second trace with Python frames (``with_stack``) gives its own share,
    and the three longest idle gaps with the host operations and the
    port's innermost Python frames recorded over each.  The profiler
    stretches the host, so device time over the untraced wall is printed
    beside the traced shares."""
    import glob
    import shutil

    from iterativelqr_tpu_torch.models import acrobot
    from iterativelqr_tpu_torch.utils import profiling

    _, _, inputs = ref
    spec = P.build_spec(*acrobot.problem(T_MAIN)[:3])
    solve = P.make_batched_solve_fn(
        spec, P.Options(**TUNED, forward_kernel="pallas", max_total_iterations=PROFILE_TRIPS),
        device="cuda", dtype=torch.float32)
    solve(*inputs)      # the solver's first call stays out of the windows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve(*inputs)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))

    def traced(with_stack):
        logdir = os.path.join(SCRATCH, "profile" + ("_stack" if with_stack else ""))
        shutil.rmtree(logdir, ignore_errors=True)
        t0 = time.perf_counter()
        with profiling.trace(logdir, with_stack=with_stack):
            with profiling.annotate("tuned_solve"):
                sol = solve(*inputs)
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(logdir, "*.json"))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        window = max((e for e in events if e.get("cat") == "user_annotation"
                      and e.get("name") == profiling.PREFIX + "tuned_solve"),
                     key=lambda e: float(e.get("dur", 0.0)))
        device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not device:
            raise AssertionError("profile: the trace holds no device operation")
        w0, w1 = span(window)
        spans = [span(e) for e in device]
        busy, gaps = busy_and_gaps(spans, w0, w1)
        dev_total = sum(float(e.get("dur", 0.0)) for e in device)
        log(f"[profile] tuned acrobot T={T_MAIN} B={B_MAIN} f32, {int(sol.iterations.max())} "
            f"trips after an untraced call, {'with' if with_stack else 'without'} Python "
            f"frames: traced window {(w1 - w0) / 1e3:.1f} ms (wall with the profiler "
            f"{wall:.2f} s, untraced {plain_wall * 1e3:.1f} ms), device operations "
            f"{len(device)}, device busy {busy:.4f} of the window (idle {1 - busy:.4f}), "
            f"device time {dev_total / 1e3:.1f} ms, {dev_total / 1e6 / plain_wall:.4f} of "
            f"the untraced wall; trace {os.path.getsize(path) / 1e6:.1f} MB")
        return events, device, spans, (w0, w1), gaps

    events, device, spans, (w0, w1), _ = traced(with_stack=False)
    ends = sorted(span(e)[1] for e in device
                  if "sl_rollout_kernel" in e["name"] and "Reroll" in e["name"])
    if not ends:
        raise AssertionError("profile: the trace holds no K4 launch")
    trips = [busy_and_gaps(spans, a, b)[0] for a, b in zip([w0] + ends[:-1], ends)]
    rest = busy_and_gaps(spans, ends[0], ends[-1])[0] if len(ends) > 1 else float("nan")
    log(f"[profile] busy share trip by trip ({len(ends)} K4 launches): "
        f"{[round(b, 4) for b in trips]}; trips 2 to {len(trips)}: {rest:.4f}; after the "
        f"last K4 {(w1 - ends[-1]) / 1e3:.1f} ms")
    by_name, count = collections.Counter(), collections.Counter()
    for e in device:
        by_name[e["name"]] += float(e.get("dur", 0.0))
        count[e["name"]] += 1
    dev_total = sum(by_name.values())
    for name, us_ in by_name.most_common(10):
        log(f"[profile] top device op: {us_ / 1e3:9.2f} ms {count[name]:7d} x "
            f"{us_ / dev_total:.3f} of device time  {name[:110]}")

    events, _, _, (w0, _), gaps = traced(with_stack=True)
    frames = [e for e in events if e.get("cat") == "python_function"]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    for a, b in gaps:
        over = lambda e: span(e)[0] < b and span(e)[1] > a
        ops = collections.Counter(e["name"] for e in host if over(e))
        # innermost (shortest) first
        mine = sorted((e for e in frames if over(e) and "iterativelqr_tpu_torch/" in e["name"]),
                      key=lambda e: float(e.get("dur", 0.0)))
        names = list(dict.fromkeys(e["name"].split("iterativelqr_tpu_torch/")[-1] for e in mine))
        log(f"[profile] idle gap {(b - a) / 1e3:.2f} ms at +{(a - w0) / 1e3:.1f} ms: host ops "
            f"{dict(ops.most_common(6))}; innermost Python frames of the port {names[:4]}; "
            f"{len(frames)} frames recorded")


def check_checkpoint(P, sol, mpc_state):
    """Phase 9g: a Solution (phase 9b) and an MPCState (phase 7d) through
    utils/checkpoint save and load on the card: bitwise, device and dtype
    kept."""
    import dataclasses as dc

    from iterativelqr_tpu_torch.utils import checkpoint

    os.makedirs(SCRATCH, exist_ok=True)
    for name, state in (("solution", sol), ("mpc_state", mpc_state)):
        path = checkpoint.save(os.path.join(SCRATCH, f"ckpt_{name}"), state)
        like = type(state)(**{f.name: torch.zeros_like(getattr(state, f.name))
                              for f in dc.fields(state)})
        back = checkpoint.load(path, like)
        for a, b in zip(checkpoint.tree_leaves(back), checkpoint.tree_leaves(state)):
            if not (torch.equal(a, b) and a.device == b.device and a.dtype == b.dtype):
                raise AssertionError(f"checkpoint {name}: a leaf came back changed")
        os.remove(path)
        log(f"[checkpoint] {name}: {len(checkpoint.tree_leaves(state))} leaves saved and "
            f"loaded on {b.device}, bitwise, dtypes kept")


# ---------------------------------------------------------------------------
# phase 8: K3/K4 for user problems (generated device functions, w)
# ---------------------------------------------------------------------------


def user_problems():
    """The user problems of phase 8 (tests/torch_user_problems.py: plain
    torch lambdas and closures, none a registered model)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_user_problems

    return torch_user_problems


# label -> T of its kernel cell (8b)
GENERATED_CASES = {"acrobot (lambdas)": T_MAIN, "farm": FARM_T, "demo (w)": FARM_T}
# phase 8e: label -> (the registered model with the same math, T)
MATRIX_CASES = {"quadrotor (matrices)": ("quadrotor", T_QUAD), "car (user)": ("car", T_CAR)}


# phase 8e: every elementwise function and reduction the generator lowers,
# in one problem (tests/torch_user_problems.py::math_problem), at this T
MATH_LABEL, MATH_T = "math (every function)", 51


def matrix_spec(label):
    """A phase 8e problem: models/quadrotor.py's written with matrices, or
    models/car.py's with constant indices, a norm and quadratic forms
    (tests/torch_user_problems.py), its constants on the card."""
    up = user_problems()
    model, T = MATRIX_CASES[label]
    return (up.quadrotor_matrix if model == "quadrotor" else up.car_user)(T, "cuda")


def generated_spec(P, label, T):
    up = user_problems()
    if label == "acrobot (lambdas)":
        return up.acrobot_lambdas(T)
    return (up.farm_problem if label == "farm" else up.demo_problem)(T, "cuda")


def start_generated_build(P, fk, pool):
    """Phase 8a's build, queued in the background beside phase 5's golden
    half (it took 8.7 s of phase 8a in an 861.2 s run, NVIDIA H100 80GB
    HBM3, 700 W): the generated models of the three user problems and of
    phase 8e's two, generated here (tracing stays on this thread), their
    nvcc runs started together.  Returns (models, the pending build's
    seconds and paths)."""
    from iterativelqr_tpu_torch import _build

    models = {}
    cases = [(label, generated_spec(P, label, T)) for label, T in GENERATED_CASES.items()]
    cases += [(label, matrix_spec(label)) for label in MATRIX_CASES]
    cases.append((MATH_LABEL, user_problems().math_problem(MATH_T, "cuda")))
    for label, spec in cases:
        m = fk.device_model(spec, "cuda")
        if m is None or m.generated is None:
            raise AssertionError(f"{label}: no generated model ({fk.model_reason(spec, 'cuda')})")
        models[label] = m
        g = m.generated
        log(f"[generated] {label}: {m.name}, nx={g.nx} nu={g.nu} nw={g.nw} nc={g.nc} "
            f"(stage rows {g.nc_stage}, terminal {g.nc_term}); {g.ops_per_step()} operations a "
            f"step and candidate; kStream {g.stream}; "
            f"ops a program {[None if p is None else len(p.ops) for p in g.programs]}")
    sources = [m.generated.translation_unit() for m in models.values()]

    def run():
        t0 = time.perf_counter()
        paths = _build.build_generated(*sources)
        return time.perf_counter() - t0, paths

    return models, pool.submit(run)


def build_generated(pending):
    """Phase 8a: the generated models' libraries (``start_generated_build``):
    the build's seconds and ptxas's registers and spills in f32 and f64."""
    from iterativelqr_tpu_torch import _build

    models, build = pending
    seconds, paths = build.result()
    log(f"[build] {len(paths)} generated models built together in {seconds:.2f} s, in the "
        f"background")
    for label, path in zip(models, paths):
        for line in _build.ptxas_report(path.with_suffix(".log")):
            log(f"[build] {label}: {line}")
    return models


def check_generated_rollouts(P, fk, cases):
    """Phases 8b and 8e, kernels: K3 (head j0=0 and tail j0=8) and K4 of each
    generated model against their plain versions at B=4096 in f64 and f32
    (phase 3b's inputs and tolerances for the model named; the demo with a
    different target ramp in w on every lane), K4's J equal to K3's, and,
    where a registered model computes the same math, K3's J over 17
    candidates against its hand-written kernel's on the same inputs; in
    the dtypes ``timed`` names, times beside the hand-written kernels',
    bounds from the scalar program's operation count and shares; where a
    registered model computes the same math in fewer operations (a
    matrix written by hand keeps products by its literal zeros, which the
    program must do: 0 * inf is NaN), also the bound and share from the
    count of that model's own generated program, the function's
    arithmetic.  ``cases``: (label, the model whose
    inputs it takes, T, its spec in a dtype-free maker, the registered
    model or None, J tolerances against it by dtype, the dtypes timed).
    Returns the f32 records (K3's head block and K4) keyed
    "<kernel>/<label>"."""
    from iterativelqr_tpu_torch import models
    from iterativelqr_tpu_torch.ops import device_functions

    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    records = {}
    for label, name, T, make, hand_model, hand_tols, timed in cases:
        hand, hand_ops = None, None
        if hand_model is not None:
            hand_spec = P.build_spec(*getattr(models, hand_model).problem(T)[:3])
            hand = fk.Rollouts(hand_spec, "cuda")
            hand_ops = device_functions.generate(hand_spec).ops_per_step()
        for dtype, tol in tols.items():
            spec = make()
            r, live, alpha = rollout_case(fk, name, T, B_MAIN, dtype, SEED, spec=spec)
            gen = r.model.generated
            if gen is None:
                raise AssertionError(f"{label}: no generated model ({r.model_reason})")
            size = torch.finfo(dtype).bits // 8
            dn = str(dtype).split(".")[-1]
            j = torch.round(-torch.log2(alpha)).long()
            J3 = fk.score_rollout(r, 0, 17, *live)
            J4 = fk.winner_reroll(r, alpha, *live)[2]
            J3j = J3[j, torch.arange(B_MAIN, device="cuda")]
            same = (J4 == J3j) | (torch.isnan(J4) & torch.isnan(J3j))
            if not bool(same.all()):
                raise AssertionError(f"{label} {dn}: K4's J differs from K3's at the same alpha "
                                     f"on {int((~same).sum())} lanes")
            if hand is not None:
                err, top = max_err(f"{label} {dn}: generated vs hand-written {hand_model}", (J3,),
                                   (fk.score_rollout(hand, 0, 17, *live),), hand_tols[dtype])
                log(f"[generated] {label} T={T} B={B_MAIN} {dn}: K3's J of the generated model "
                    f"against the hand-written {hand_model} kernel's, 17 candidates: max diff "
                    f"{err:.3e} of max |J| {top:.3e} (tol {hand_tols[dtype]:g} relative)")
            runs = (
                ("sl_score_rollout", "head j0=0 nb=8",
                 lambda r=r: (fk.score_rollout(r, 0, 8, *live),),
                 lambda: (fk.score_rollout_reference(r, 0, 8, *live),), 8),
                ("sl_score_rollout", "tail j0=8 nb=9",
                 lambda r=r: (fk.score_rollout(r, 8, 9, *live),),
                 lambda: (fk.score_rollout_reference(r, 8, 9, *live),), 9),
                ("sl_winner_reroll", "per-lane alpha",
                 lambda r=r: fk.winner_reroll(r, alpha, *live),
                 lambda: fk.winner_reroll_reference(r, alpha, *live), None),
            )
            for kname, what, kern, plain, nb in runs:
                outs = kern()
                torch.cuda.synchronize()
                err, top = max_err(f"{kname} {label} {dn} {what}", outs, plain(), tol)
                if dtype not in timed:
                    log(f"[generated] {kname} {label} T={T} B={B_MAIN} {dn} {what}: max |kernel "
                        f"- plain| {err:.3e}, max |plain| {top:.3e} (tol {tol:g} relative)")
                    continue
                k_ms = cuda_ms(kern)
                beside = ""
                if hand is not None:
                    h_ms = cuda_ms(lambda: kern(hand))
                    beside = f", the hand-written {hand_model} kernel {h_ms:.4f} ms ({k_ms / h_ms:.3f} x)"
                p_ms = cuda_ms(plain, **PLAIN_REPS)
                nbytes = rollout_bytes(spec, B_MAIN, size, nb)
                steps = (T - 1) * B_MAIN * (nb or 1)
                ops = gen.ops_per_step() * steps
                b_ms, b_by = bound_ms(nbytes, ops)
                rec = dict(ops_per_step=gen.ops_per_step())
                arith = ""
                if hand_ops is not None and hand_ops < gen.ops_per_step():
                    a_ms, a_by = bound_ms(nbytes, hand_ops * steps)
                    rec.update(arithmetic_ops_per_step=hand_ops, arithmetic_bound_ms=a_ms)
                    arith = (f"; against the function's arithmetic (the registered "
                             f"{hand_model}'s generated {hand_ops} a step) {a_ms:.4f} ms "
                             f"({a_by}), {a_ms / k_ms:.1%}")
                log(f"[generated] {kname} {label} T={T} B={B_MAIN} {dn} {what}: max |kernel - "
                    f"plain| {err:.3e}, max |plain| {top:.3e} (tol {tol:g} relative); kernel "
                    f"{k_ms:.4f} ms{beside}, plain {p_ms:.3f} ms (one run); bound {b_ms:.4f} ms "
                    f"({b_by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} G operations from the "
                    f"program's {gen.ops_per_step()} a step); {b_ms / k_ms:.1%} of the bound"
                    + arith + ring_line(fk.rollout_ring(r.model, dtype)))
                if dtype == torch.float32 and what != "tail j0=8 nb=9":
                    records[f"{kname}/{label}"] = dict(
                        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                        **rec)
    return records


# the same operations from two sources: apart only by the compiler's
# contractions (tests/test_torch_cuda.py's tolerances)
SAME_OPS_TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}
# the same math in another order of operations: the plain versions'
PLAIN_TOLS = {torch.float64: 1e-10, torch.float32: 1e-4}


def phase_8b_cases(P):
    """Phase 8b's cases for check_generated_rollouts."""
    return [(label, "acrobot" if "acrobot" in label else label, T,
             functools.partial(generated_spec, P, label, T),
             "acrobot" if "acrobot" in label else None, SAME_OPS_TOLS,
             (torch.float64, torch.float32))
            for label, T in GENERATED_CASES.items()]


def phase_8e_cases():
    """Phase 8e's cases for check_generated_rollouts: the two problems
    against their registered models, timed in f32 (the dtype of their
    solves), and the problem of every elementwise function and reduction
    the generator lowers against its plain version (torch's CUDA
    functions) alone, untimed (it runs in no solve)."""
    math = functools.partial(user_problems().math_problem, MATH_T, "cuda")
    return [(label, model, T, functools.partial(matrix_spec, label), model, PLAIN_TOLS,
             (torch.float32,))
            for label, (model, T) in MATRIX_CASES.items()] + [
        (MATH_LABEL, "math", MATH_T, math, None, None, ())]


def demo_inputs(B, T, dtype, device):
    """examples/sensitivity_demo.py's start (zero states and controls) for
    B lanes, each with its own target ramp to (s, c) in w: s from [0.5,
    1.5], c from [-0.3, 0.3] (numpy seed)."""
    rng = np.random.default_rng(SEED)
    ws = np.zeros((B, T, 2))
    ws[:, :, 0] = np.linspace(0.0, 1.0, T)[None, :] * rng.uniform(0.5, 1.5, (B, 1))
    ws[:, :, 1] = rng.uniform(-0.3, 0.3, (B, 1))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(np.zeros((B, T, 2))), t(np.zeros((B, T - 1, 1))), t(ws)


def run_demo(P):
    """Phase 8c: a B=4096 SL solve of examples/sensitivity_demo.py's
    problem (T=11, f32, "auto" rollouts: K1 and the generated K3/K4), each
    lane with its own target ramp in w; the solved fraction recomputed from
    the trajectories must be >= 0.99.  Returns the launch counts."""
    dev, dtype, T = torch.device("cuda"), torch.float32, FARM_T
    spec = generated_spec(P, "demo (w)", T)
    opts = P.Options(record_traces=False, forward_kernel="auto")
    xs, us, ws = demo_inputs(B_MAIN, T, dtype, dev)
    P.make_batched_solve_fn(spec, dataclasses.replace(opts, max_total_iterations=3),
                            device=dev, dtype=dtype)(xs, us, ws)
    torch.cuda.synchronize()
    solve = P.make_batched_solve_fn(spec, opts, device=dev, dtype=dtype)
    sol, stats, wall, counts = counted_solve(P, solve, (xs, us, ws))
    name = "demo (w)/auto"
    frac, frac_true = integrity(name, spec, sol, stats, ws, opts.constraint_tolerance, B_MAIN, T,
                                2, 1)
    check_launches(name, "auto", counts, "demo")
    if min(counts["sl_score_rollout_generated"], counts["sl_winner_reroll_generated"]) <= 0:
        raise AssertionError(f"{name}: the generated K3/K4 were not launched")
    if frac_true < 0.99:
        raise AssertionError(f"{name}: recomputed solved fraction {frac_true} < 0.99")
    # the plans follow their lanes' targets: x_T = w_T within the tolerance
    err = float((sol.xs[:, -1] - ws[:, -1]).abs().max())
    log(f"[slice] {name}: B={B_MAIN} T={T} f32, a target ramp a lane; max |x_T - w_T| {err:.3e}")
    report(name, sol, stats, frac, frac_true, wall, counts, opts.num_step_sizes, B_MAIN)
    return counts


def check_refusals(P, fk):
    """Phase 8d: a stage cost with a data-dependent branch and one with an
    op outside the whitelist (acrobot T=9, B=4, f32 on the card): under
    forward_kernel="pallas" the solver refuses, naming the branch or the op;
    under "auto" it picks the loops.  The whitelist case then solves on the
    loops with no K3/K4 launch; the branch runs on no route (torch.func's
    vmap refuses data-dependent control flow, as jax.vmap does), so there
    only the choice is checked."""
    from iterativelqr_tpu_torch.models import acrobot
    from iterativelqr_tpu_torch.ops.sl_ops import SLOps

    T, B, dev = 9, 4, torch.device("cuda")
    dyn, cost, con, *_ = acrobot.problem(T)
    cases = (("a data-dependent branch", "data-dependent branch", False,
              P.Cost(lambda x, u: x[2] * x[2] if x[2] > 0 else u[0] * u[0], 4, 1)),
             ("an op outside the whitelist (a matrix decomposition)", "aten.linalg_inv_ex", True,
              P.Cost(lambda x, u: 0.1 * torch.linalg.inv((1.0 + u * u).reshape(1, 1))[0, 0],
                     4, 1)))
    xs, us, ws = bench_inputs(B, T, torch.float32, dev)
    base = dict(record_traces=False, max_iterations=6, max_dual_updates=2)
    for what, named, solvable, g in cases:
        spec = P.build_spec(dyn, [g] * (T - 1) + cost[-1:], con)
        try:
            SLOps(spec, P.Options(**base, forward_kernel="pallas"), dev, torch.float32)
        except ValueError as e:
            if named not in str(e):
                raise AssertionError(f"refusal of {what}: the message does not name "
                                     f"{named!r}: {e}") from None
            reason = str(e).split("this spec: ", 1)[-1]
        else:
            raise AssertionError(f'forward_kernel="pallas" did not refuse {what}')
        auto = P.Options(**base, forward_kernel="auto")
        if SLOps(spec, auto, dev, torch.float32).use_kernels:
            raise AssertionError(f'"auto" picked the kernels for {what}')
        line = f'[refusal] {what}: "pallas" refused ({reason[:160]}); "auto" picked the loops'
        if solvable:
            for c in counters().values():
                c.reset()
            sol = P.make_batched_solve_fn(spec, auto, device=dev, dtype=torch.float32)(xs, us, ws)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters().items()}
            k34 = (counts["sl_score_rollout"], counts["sl_winner_reroll"])
            if max(k34) != 0 or counts["riccati_backward"] <= 0 or not bool(
                    torch.isfinite(sol.xs).all()):
                raise AssertionError(f'"auto" with {what}: K3/K4 {k34}, K1 '
                                     f"{counts['riccati_backward']}")
            line += (f" and solved there: K3/K4 launches {k34}, K1 {counts['riccati_backward']}, "
                     f"{int(sol.iterations.max())} trips")
        log(line)


def run_matrix_solves(P, model_fracs, walls):
    """Phase 8e, solves: each user problem at B=4096 in f32 on the SL route
    with forward_kernel="pallas" (the generated K3/K4; the car's backward
    K1, the quadrotor's K2), from phase 4's inputs for the registered model
    with the same math; the solved fraction recomputed from the
    trajectories must be >= 0.99 and within 0.01 of the registered model's
    phase 4 solve.  Returns the launch counts keyed by label."""
    counts = {}
    for label, (model, T) in MATRIX_CASES.items():
        frac, counts[label], wall = run_model(P, model, "pallas", spec=matrix_spec(label),
                                              label=label)
        k34 = (counts[label]["sl_score_rollout_generated"],
               counts[label]["sl_winner_reroll_generated"])
        if min(k34) <= 0:
            raise AssertionError(f"{label}: the generated K3/K4 were not launched {k34}")
        ref = model_fracs[model]["pallas"]
        if frac < 0.99 or abs(frac - ref) > 0.01:
            raise AssertionError(f"{label}: recomputed solved fraction {frac} (the registered "
                                 f"{model}'s {ref})")
        log(f"[generated] {label} B={B_MAIN} T={T} f32: solved {frac:.4f} recomputed, the "
            f"registered {model}'s {ref:.4f}; wall {wall:.3f} s, the registered {model}'s "
            f"{walls[model, 'pallas']:.3f} s ({wall / walls[model, 'pallas']:.3f} x); generated "
            f"K3/K4 launches {k34}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: reference checks on small inputs
# ---------------------------------------------------------------------------


def card_vs_cpu_cases():
    """Phase 5's card-against-CPU cases: (name, model module, T, inputs) of
    the SL route's check, and the vmap route's models and configurations
    (label, options, K6 variant, the kernel the card's run launches)."""
    from iterativelqr_tpu_torch.models import acrobot, car, quadrotor

    sl = (("acrobot", acrobot, 9, bench_inputs),
          ("car", car, 8, functools.partial(model_inputs, "car")),
          ("quadrotor", quadrotor, 8, functools.partial(model_inputs, "quadrotor")))
    configs = (("Options()", {}, None, None),
               ("K6a dispatch", dict(backward_pass="scan"), "v1", "riccati_masked"),
               ("K6b dispatch", dict(backward_pass="scan"), "v2", "riccati_masked_packed"),
               ('backward_pass="packed"', dict(backward_pass="packed"), None, "riccati_backward"))
    return sl, sl[:2], configs


CARD_VS_CPU_FIELDS = ("iterations", "al_iterations", "status", "xs", "us", "objective",
                      "max_violation")


def card_vs_cpu_solve(P, mod, T, make, dev, fkm):
    """Phase 5's SL-route solve (acrobot T=9, car and quadrotor T=8, B=4,
    f64, 12 iterations x 3 rounds) on ``dev`` with ``fkm`` rollouts."""
    spec = P.build_spec(*mod.problem(T)[:3])
    xs, us, ws = make(4, T, torch.float64, dev)
    opts = P.Options(record_traces=False, max_iterations=12, max_dual_updates=3,
                     forward_kernel=fkm)
    return P.make_batched_solve_fn(spec, opts, device=dev, dtype=torch.float64)(xs, us, ws)


def vmap_card_vs_cpu_solve(P, mod, T, make, dev, kw, variant):
    """Phase 5's vmap-route solve (B=4, f64, 12 iterations x 3 rounds) on
    ``dev`` with options ``kw`` and the K6 dispatch ``variant`` (or none)."""
    from iterativelqr_tpu_torch.ops.pallas_backward import make_backward_dispatch

    spec = P.build_spec(*mod.problem(T)[:3])
    xs, us, ws = make(4, T, torch.float64, dev)
    impl = None if variant is None else make_backward_dispatch(variant=variant)
    opts = P.Options(max_iterations=12, max_dual_updates=3, **kw)
    return P.make_solve_fn(spec, opts, backward_impl=impl, device=dev).vmap()(xs, us, ws)


def card_vs_cpu_cpu_half():
    """Phase 5's CPU solves, the plain loop path of each card-against-CPU
    check, in a worker process that needs no card (started beside phase
    4, ``main``): {case: {field: CPU tensor}}."""
    import iterativelqr_tpu_torch as P

    sl, vmap_models, configs = card_vs_cpu_cases()
    res = {}
    for name, mod, T, make in sl:
        sol = card_vs_cpu_solve(P, mod, T, make, "cpu", "scan")
        res["sl", name] = {f: getattr(sol, f) for f in CARD_VS_CPU_FIELDS}
    for name, mod, T, make in vmap_models:
        for label, kw, variant, _ in configs:
            sol = vmap_card_vs_cpu_solve(P, mod, T, make, "cpu", kw, variant)
            res["vmap", name, label] = {f: getattr(sol, f)
                                        for f in CARD_VS_CPU_FIELDS + ("trace_mask",)}
    return res


def check_card_vs_cpu(P, cpu):
    """The card's kernel path (forward_kernel="pallas") against the port's
    plain CPU loop path ("scan", ``cpu``: card_vs_cpu_cpu_half's), acrobot
    T=9, car and quadrotor T=8, B=4, f64: equal iterates, trajectories
    within 1e-8."""
    for name, mod, T, make in card_vs_cpu_cases()[0]:
        for c in counters().values():
            c.reset()
        b = card_vs_cpu_solve(P, mod, T, make, "cuda", "pallas")
        check_launches(f"card vs cpu {name}", "pallas",
                       {k: c.launches for k, c in counters().items()}, name)
        a = cpu["sl", name]
        for f in ("iterations", "al_iterations", "status"):
            if not torch.equal(a[f], getattr(b, f).cpu()):
                raise AssertionError(f"card vs cpu {name}: {f} differ")
        for f in ("xs", "us", "objective", "max_violation"):
            torch.testing.assert_close(getattr(b, f).cpu(), a[f], rtol=1e-8, atol=1e-8)
        log(f"[check] card pallas vs plain CPU scan, {name} (T={T}, B=4, f64): "
            f"iterations {a['iterations'].tolist()} equal; max |dxs| "
            f"{float((a['xs'] - b.xs.cpu()).abs().max()):.3e}")


def check_vmap_card_vs_cpu(P, cpu):
    """The vmap route on the card against the port's plain CPU path
    (``cpu``: card_vs_cpu_cpu_half's), acrobot T=9 and car T=8, B=4, f64,
    with equal iterates: Options() (the "auto" backward, here the reverse
    scan), the K6a and K6b dispatches (backward_pass="scan" plus
    backward_impl) and backward_pass="packed" (K1 through
    make_derive_backward), each cut to 12 iterations x 3 rounds as the SL
    check above."""
    _, vmap_models, configs = card_vs_cpu_cases()
    for name, mod, T, make in vmap_models:
        for label, kw, variant, kname in configs:
            for c in counters().values():
                c.reset()
            b = vmap_card_vs_cpu_solve(P, mod, T, make, "cuda", kw, variant)
            launched = {k: c.launches for k, c in counters().items() if c.launches}
            if set(launched) != ({kname} if kname else set()):
                raise AssertionError(f"vmap card vs cpu {name} {label}: launches {launched}")
            a = cpu["vmap", name, label]
            for f in ("iterations", "al_iterations", "status", "trace_mask"):
                if not torch.equal(a[f], getattr(b, f).cpu()):
                    raise AssertionError(f"vmap card vs cpu {name} {label}: {f} differ")
            for f in ("xs", "us", "objective", "max_violation"):
                torch.testing.assert_close(getattr(b, f).cpu(), a[f], rtol=1e-8, atol=1e-8)
            log(f"[check] vmap route card vs plain CPU, {name} {label} (T={T}, B=4, f64): "
                f"iterations {a['iterations'].tolist()} equal; max |dxs| "
                f"{float((a['xs'] - b.xs.cpu()).abs().max()):.3e}")


def check_golden_per_instance(P, backward_pass, fixture):
    """A golden solution (``fixture``: car, quadrotor) through the
    per-instance solver on the card (make_solve_fn(spec,
    Options(adaptive_penalty=False)), one instance, f64) with
    ``backward_pass`` "scan" or the default "auto" (on one instance the
    associative scan), within tests/test_golden.py's gates."""
    from iterativelqr_tpu_torch import models

    name, x_atol, u_atol = GOLDEN[fixture]
    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "fixtures", f"golden_{fixture}.npz"))
    T = data["xs"].shape[0]
    dev, dtype = torch.device("cuda"), torch.float64
    dyn, cost, con, x1, _ = getattr(models, name).problem(T)
    spec = P.build_spec(dyn, cost, con)
    us = torch.as_tensor(data["us0"], dtype=dtype, device=dev)
    xs = torch.stack(P.rollout(dyn, x1.to(dev, dtype), us))
    ws = torch.zeros((T, 0), dtype=dtype, device=dev)
    t0 = time.perf_counter()
    kw = {} if backward_pass == "auto" else {"backward_pass": backward_pass}
    sol = P.make_solve_fn(spec, P.Options(adaptive_penalty=False, **kw), device=dev)(xs, us, ws)
    wall = time.perf_counter() - t0
    viol = float(sol.max_violation)
    dx = float(np.abs(sol.xs.cpu().numpy() - data["xs"]).max())
    du = float(np.abs(sol.us.cpu().numpy() - data["us"]).max())
    log(f"[check] golden {fixture} through the per-instance solver, backward_pass="
        f"{backward_pass!r} (f64 on the card): "
        f"violation {viol:.3e}, objective {float(sol.objective):.4f} (golden "
        f"{float(data['objective']):.4f}), max |dxs| {dx:.3e}, max |dus| {du:.3e}, "
        f"iterations {int(sol.iterations)}, {wall:.1f} s")
    if not (viol <= 5e-3 and dx <= x_atol and du <= u_atol):
        raise AssertionError(f"golden {fixture} per instance ({backward_pass}): outside "
                             "tests/test_golden.py's gates")


# tests/test_golden.py's gates: (x_atol, u_atol), violation <= 5e-3
GOLDEN = {"acrobot_T101": ("acrobot", 1e-2, 5e-2), "car": ("car", 1e-3, 5e-3),
          "quadrotor": ("quadrotor", 1e-2, 5e-2), "particle": ("particle", 1e-6, 1e-6),
          "cartpole": ("cartpole", 1e-2, 5e-2)}


def check_golden(P, fixture):
    """A committed golden solution (reference-exact AL schedule, initial
    states rolled out from us0), solved on the card through the rollout
    kernels in f64."""
    from iterativelqr_tpu_torch import models

    name, x_atol, u_atol = GOLDEN[fixture]
    mod = getattr(models, name)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", f"golden_{fixture}.npz")
    data = np.load(path)
    T = data["xs"].shape[0]
    dev, dtype = torch.device("cuda"), torch.float64
    dyn, cost, con, x1, _ = mod.problem(T)
    spec = P.build_spec(dyn, cost, con)
    us = torch.as_tensor(data["us0"], dtype=dtype, device=dev)
    x = x1.to(dtype=dtype, device=dev)
    xs = [x]
    for t in range(T - 1):
        x = dyn[t](x, us[t])
        xs.append(x)
    xs = torch.stack(xs)[None]
    ws = torch.zeros((1, T, 0), dtype=dtype, device=dev)
    opts = P.Options(record_traces=False, adaptive_penalty=False,
                     forward_kernel="pallas")
    for c in counters().values():
        c.reset()
    sol = P.make_batched_solve_fn(spec, opts, device=dev, dtype=dtype)(xs, us[None], ws)
    check_launches(f"golden {fixture}", "pallas",
                   {k: c.launches for k, c in counters().items()}, name)
    viol = float(sol.max_violation[0])
    dx = float(np.abs(sol.xs[0].cpu().numpy() - data["xs"]).max())
    du = float(np.abs(sol.us[0].cpu().numpy() - data["us"]).max())
    log(f"[check] golden {fixture} T={T} (f64 on the card, rollout kernels): violation {viol:.3e}, "
        f"objective {float(sol.objective[0]):.4f} (golden {float(data['objective']):.4f}), "
        f"max |dxs| {dx:.3e}, max |dus| {du:.3e}, iterations {int(sol.iterations[0])}")
    if not (viol <= 5e-3 and dx <= x_atol and du <= u_atol):
        raise AssertionError(f"golden {fixture}: outside tests/test_golden.py's gates")


# ---------------------------------------------------------------------------
# phase 10: the recursion at any user problem's (n, m), built at first use
# ---------------------------------------------------------------------------

# the registered models' dims: acrobot and cartpole, car, particle and
# pendulum (K1's template), the quadrotor (K2's)
REGISTERED_DIMS = ((4, 1), (3, 2), (2, 1), (12, 4))
RICCATI_GRID = ((3, 1), (4, 2), (5, 1), (5, 2), (6, 2), (7, 3), (13, 4), (14, 7), (24, 8))
# dims at which both templates are built and timed: the evidence of the
# rule's choice between K1's and K2's (ops/packed_backward.py::riccati_plan)
TEMPLATE_CHOICE = ((5, 1), (5, 2), (6, 1), (6, 2))
B_GRID, T_GRID = 1000, 41       # 10b: not a multiple of 4 lanes, T = 41
TIMED_DIMS = ((6, 2), (13, 4))  # 10c, f32, B=4096, T=101
PQ_T = 101                      # 10d, the planar quadrotor
DTYPES = (torch.float32, torch.float64)


def grid_plans(pk):
    """10a's plans: the rule's at every grid dims in f32 and f64, and the
    template the rule passes over at TEMPLATE_CHOICE (f32)."""
    plans = [pk.riccati_plan(n, m, d) for n, m in RICCATI_GRID for d in DTYPES]
    for n, m in TEMPLATE_CHOICE:
        for t in ("K1", "K2"):
            plan = pk.riccati_plan(n, m, torch.float32, template=t)
            if plan not in plans:
                plans.append(plan)
    return plans


def start_riccati_grid(pk, pool):
    """Phase 10a's build, started in the background beside phase 5's golden
    half (whose checks report no time) so that its nvcc runs use the host's
    idle cores:
    the grid's libraries but the planar quadrotor's (6, 2) f32, which
    phase 10d builds with its generated K3/K4 as a user's first solve
    would.  Returns (plans, the pending build's seconds)."""
    from iterativelqr_tpu_torch import _build

    plans = grid_plans(pk)
    pq = pk.riccati_plan(6, 2, torch.float32)

    def run():
        t0 = time.perf_counter()
        _build.build_generated(*(p.source() for p in plans if p != pq))
        return time.perf_counter() - t0

    return plans, pool.submit(run)


def build_riccati_grid(pk, plans, pending):
    """Phase 10a: the libraries of the grid, built together (in the
    background, ``start_riccati_grid``); seconds, each plan's parameters
    against its library's ring entry, and ptxas's registers, spills and
    shared memory a kernel."""
    from iterativelqr_tpu_torch import _build

    seconds = pending.result()
    paths = _build.build_generated(*(p.source() for p in plans))
    log(f"[riccati] {len(paths) - 1} libraries (the grid in f32 and f64, and both templates at "
        f"{list(TEMPLATE_CHOICE)} in f32, but 10d's) built together in {seconds:.2f} s, beside "
        f"phase 5's golden half")
    report_plans(pk, plans, paths, "riccati")


def report_plans(pk, plans, paths, tag):
    """Each plan's parameters against its library's ring entry, and
    ptxas's registers, spills and shared memory a kernel."""
    from iterativelqr_tpu_torch import _build

    for plan, path in zip(plans, paths):
        rings = tuple(pk.riccati_ring(plan.n, plan.m, None, masked, plan=plan)
                      for masked in (False, True))
        if tuple(r[0] for r in rings) != plan.depth or tuple(r[1] for r in rings) != plan.shared:
            raise AssertionError(f"(n, m) = ({plan.n}, {plan.m}) {plan.dtype}: the library's ring "
                                 f"{rings} is not the plan's {plan.depth}, {plan.shared}")
        if max(plan.shared) > pk.SHARED_MAX:
            raise AssertionError(f"{plan}: more shared memory than a block may take")
        head = (f"[{tag}] n={plan.n} m={plan.m} {plan.dtype} {plan.template}'s template: "
                f"{plan.rows} row(s) of P a thread, {plan.lanes} lanes and {plan.threads} threads "
                f"a block, ring {plan.depth[0]} tiles, {plan.shared[0]} B shared "
                f"({plan.shared[1]} B masked)")
        log(head)
        for line in _build.ptxas_report(path.with_suffix(".log")):
            log(f"[{tag}]   {line}")


def _grid_runs(pk, pb, plan, st, um, reg):
    """{counter name: (kernel, plain version)} of K1 or K2, K5, K6a and K6b
    on one case; K1/K2 and K5 share a plain version (the same inputs)."""
    kin = [a.contiguous() for a in pk.prepare_stacks(*st, um > 0.5)]
    ref = {}

    def plain_k1():
        if "k1" not in ref:
            ref["k1"] = pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        return ref["k1"]

    runs = {plan.main: (lambda: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg), plain_k1)}
    for label, base in (("K5", "riccati_packed"), ("K6a", "riccati_masked"),
                        ("K6b", "riccati_masked_packed")):
        kern, plain, _, _ = packed_masked_runs(pk, pb, label, st, um, reg)
        runs[base + plan.suffix] = (kern, plain_k1 if label == "K5" else plain)
    return runs


def check_riccati_grid(pk, pb, grid=RICCATI_GRID, tag="riccati"):
    """Phase 10b (11b: ``grid`` TALL_GRID): K1 or K2, K5, K6a and K6b at
    every grid dims against their plain versions, B=B_GRID, T=T_GRID,
    phase 3c's case (the last action masked where m > 1, a per-lane
    regularizer from [1e-3, 1], Quu indefinite at one step on every 61st
    lane) and phases 3/3c's tolerances: the f64 kernels and the f32
    kernels (on the same numbers rounded to f32) against the plain versions
    in f64, run once a dims; each wrapper launches its kernel once, on the
    counter of the template the rule picks.  On the tall template only
    (11b), where an f32 output misses the tolerance, the f32 kernel is held
    to F32_OWN times the distance of the plain version, run in f32 on the
    same inputs, from f64 on that output (its own rounding: at (62, 2),
    where P reaches 500 and Quu 1,600, the plain f32 version is
    0.99-1.24e-4 relative from f64), and both are printed; 10b's templates
    are held to the tolerance alone, as before."""
    tols = {torch.float64: 1e-10, torch.float32: 1e-4}
    B, Tm1 = B_GRID, T_GRID - 1
    for n, m in grid:
        refs = None
        for dtype, tol in tols.items():
            plan = pk.riccati_plan(n, m, dtype)
            if n + m <= 32:
                st, um, reg, bad = masked_case(SEED, B, Tm1, n, m, "indefinite_lanes", dtype)
            else:
                # past n + m = 32 the stacks are drawn on the card, and fu^T P
                # fu reaches thousands ((62, 2): 1,400 in Quu), past the -1e3
                # that makes Quu indefinite below
                st, um, reg, bad = device_case(SEED, B, Tm1, n, m, dtype, -1.0e6)
            runs = _grid_runs(pk, pb, plan, st, um, reg)
            if refs is None:   # f64 first: its plain versions are the references
                refs = {k.removesuffix(plan.suffix): plain() for k, (_, plain) in runs.items()}
            errs, own_notes = {}, []
            for kname, (kern, plain) in runs.items():
                counter = counters()[kname]
                before = counter.launches
                out = kern()
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"({n}, {m}) {dtype}: {kname} was not launched once")
                err, own = 0.0, None
                names = ("K", "k", "Qx", "Qu", "p", "ok")
                for i, (name, a, b) in enumerate(zip(names, out,
                                                     refs[kname.removesuffix(plan.suffix)])):
                    a = a.double()
                    if not torch.equal(torch.isnan(a), torch.isnan(b)):
                        raise AssertionError(f"({n}, {m}) {dtype} {kname} {name}: NaN positions differ")
                    keep = ~torch.isnan(b)
                    fa, fb = a[keep], b[keep]
                    scale = float(fb.abs().max()) if fb.numel() else 0.0
                    e = float((fa - fb).abs().max()) if fb.numel() else 0.0
                    if not e <= tol * max(scale, 1.0):
                        lenient = dtype == torch.float32 and plan.tall
                        if lenient:
                            own = plain() if own is None else own
                            e32 = float((own[i].double()[keep] - fb).abs().max())
                        if not (lenient and e <= F32_OWN * e32):
                            raise AssertionError(f"({n}, {m}) {dtype} {kname} {name}: max |kernel - "
                                                 f"plain| {e:.3e} > {tol:g} * max(|plain|, 1)")
                        own_notes.append(f"{kname} {name} {e:.3e} against the f32 plain version's "
                                         f"{e32:.3e} (max |plain| {scale:.3e})")
                    err = max(err, e)
                ok = out[-1].cpu().numpy()
                if not np.array_equal(ok == 0, bad):
                    raise AssertionError(f"({n}, {m}) {dtype} {kname}: ok is not 0 exactly on the "
                                         "indefinite lanes")
                errs[kname] = err
            log(f"[{tag}] n={n} m={m} {str(dtype).split('.')[-1]} B={B} T={T_GRID} on "
                f"{plan.template}'s template: max |kernel - plain f64| "
                + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f" (tol {tol:g} relative), ok = 0 exactly on the {int(bad.sum())} indefinite lanes"
                + (f"; past the tolerance, within {F32_OWN} x the f32 plain version's own distance: "
                   + "; ".join(own_notes) if own_notes else ""))


def _time_case(pk, n, m, T, B):
    """Phase 10c's inputs at (n, m), f32: the prepared stacks, reg, and the
    bytes and operations of one sweep."""
    Tm1 = T - 1
    make = random_stacks if m == 1 else wide_stacks
    dev = [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in make(SEED, B, Tm1, n, m)]
    kin = [a.contiguous() for a in pk.prepare_stacks(*dev, torch.ones((Tm1, m), dtype=torch.bool))]
    reg = torch.zeros(B, dtype=torch.float32, device="cuda")
    outs = pk.new_outputs(Tm1, n, m, B, torch.float32, "cuda")
    nbytes = sum(a.numel() * a.element_size() for a in (*kin, reg, *outs))
    return kin, reg, nbytes, riccati_ops(n, m) * Tm1 * B


def time_riccati_grid(pk):
    """Phase 10c: K1/K2 at TIMED_DIMS, f32, B=4096, T=101, against the bound
    (bytes at 3.35 TB/s or operations at 67 TFLOP/s, the larger) and the
    plain version (one run after a check: each output within 1e-4 of
    max(|plain|, 1)); then, at TEMPLATE_CHOICE, both
    templates on the same inputs, timed in turns (K1's, K2's, K2's, K1's)
    and held to each other.  Returns {(n, m): record} of TIMED_DIMS, its
    launches those of one call of the entry with the counts set to 0."""
    B, T = B_MAIN, T_MAIN
    records = {}
    for n, m in TIMED_DIMS:
        kin, reg, nbytes, ops = _time_case(pk, n, m, T, B)
        plan = pk.riccati_plan(n, m, torch.float32)
        run = lambda: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        plain = lambda: pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        for c in counters().values():
            c.reset()
        out = run()
        torch.cuda.synchronize()
        launches = counters()[plan.main].launches
        err, _ = max_err(f"{plan.main} ({n}, {m}) B={B} f32", [a.double() for a in out],
                         [b.double() for b in plain()], PLAIN_TOLS[torch.float32])
        k_ms = cuda_ms(run)
        p_ms = cuda_ms(plain, **PLAIN_REPS)
        b_ms, b_by = bound_ms(nbytes, ops)
        log(f"[riccati] {plan.main} n={n} m={m} T={T} B={B} f32 on {plan.template}'s template "
            f"({plan.lanes} lanes, ring {plan.depth[0]}): kernel {k_ms:.4f} ms (median of 10), "
            f"plain {p_ms:.3f} ms (one run), max |kernel - plain| {err:.3e}; bound {b_ms:.4f} ms "
            f"({b_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations); "
            f"{b_ms / k_ms:.1%} of the bound")
        records[n, m] = dict(launches=launches, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, kernel=plan.main)
    scratch = pk.LaunchCounter()
    for n, m in TEMPLATE_CHOICE:
        kin, reg, nbytes, ops = _time_case(pk, n, m, T, B)
        args = (*kin, reg)
        plans = {t: pk.riccati_plan(n, m, torch.float32, template=t) for t in ("K1", "K2")}
        runs = {t: (lambda p=p: pk.launch(p, p.main, scratch, args,
                                          pk.new_outputs(T - 1, n, m, B, torch.float32, "cuda"),
                                          T - 1, B)) for t, p in plans.items()}
        o1, o2 = runs["K1"](), runs["K2"]()
        torch.cuda.synchronize()
        diff = max(float((a - b).abs().max()) for a, b in zip(o1, o2))
        scale = max(float(a.abs().max()) for a in o2)
        if not diff <= 1e-4 * max(scale, 1.0):
            raise AssertionError(f"({n}, {m}): the two templates differ by {diff:.3e}")
        times = {"K1": [], "K2": []}
        for t in ("K1", "K2", "K2", "K1"):
            times[t].append(cuda_ms(runs[t]))
        k1, k2 = (statistics.mean(times[t]) for t in ("K1", "K2"))
        b_ms, b_by = bound_ms(nbytes, ops)
        log(f"[riccati] template choice n={n} m={m} T={T} B={B} f32, in turns: K1's template "
            f"{k1:.4f} ms ({plans['K1'].rows} rows a thread), K2's {k2:.4f} ms "
            f"({plans['K2'].lanes} lanes, ring {plans['K2'].depth[0]}); K2/K1 {k2 / k1:.3f}; "
            f"the rule takes {pk.riccati_plan(n, m, torch.float32).template}'s; bound {b_ms:.4f} ms "
            f"({b_by}); outputs agree to {diff:.2e}")
    return records


def run_planar_quadrotor(P, pk, fk):
    """Phase 10d: tests/torch_user_problems.py's planar quadrotor (6, 2) as
    a user writes it, B=4096, T=PQ_T, f32, the tuned preset's options on the
    SL route with forward_kernel="pallas" (the Riccati family at (6, 2) and
    generated K3/K4), and the same lanes with the loop rollouts ("scan"):
    build seconds (the recursion's library and the generated model's
    together), trips, walls, launches (K1/K2 and generated K3/K4, each >
    0 on the kernel path), the recomputed solved fraction (>= 0.99 on
    both, within 0.01 of each other) and the objectives lane by lane.
    Returns the kernel path's launch counts."""
    from iterativelqr_tpu_torch.core.solve_sl import build_kernels

    up = user_problems()
    B, T, dtype = B_MAIN, PQ_T, torch.float32
    spec = up.planar_quadrotor(P, torch, T)
    model = fk.device_model(spec, "cuda")
    if model is None or model.generated is None:
        raise AssertionError(f"planar quadrotor: no generated model ({fk.model_reason(spec, 'cuda')})")
    t0 = time.perf_counter()
    paths = build_kernels(spec, True, dtype)
    log(f"[pq] the recursion's library at (6, 2) f32 ({pk.riccati_plan(6, 2, dtype).template}'s "
        f"template) and the generated K3/K4 ({model.name}, {model.generated.ops_per_step()} "
        f"operations a step) built together in {time.perf_counter() - t0:.2f} s")
    from iterativelqr_tpu_torch import _build

    for line in _build.ptxas_report(paths[-1].with_suffix(".log")):
        log(f"[pq]   {line}")
    inputs = [torch.as_tensor(a, dtype=dtype, device="cuda")
              for a in up.planar_quadrotor_inputs(B, T, SEED)]
    sols, fracs, counts = {}, {}, {}
    for fkm in ("pallas", "scan"):
        opts = P.Options(**TUNED, batched_solver="sl", forward_kernel=fkm)
        P.make_batched_solve_fn(spec, dataclasses.replace(opts, max_total_iterations=2),
                                device="cuda", dtype=dtype)(*inputs)
        torch.cuda.synchronize()
        solve = P.make_batched_solve_fn(spec, opts, device="cuda", dtype=dtype)
        sol, stats, wall, counts[fkm] = counted_solve(P, solve, inputs)
        _, frac_true = integrity(f"planar quadrotor/{fkm}", spec, sol, stats, inputs[2],
                                 opts.constraint_tolerance, B, T, 6, 2)
        fracs[fkm] = frac_true
        sols[fkm] = sol
        c = counts[fkm]
        k12 = c["riccati_backward"] + c["riccati_backward_wide"]
        k34 = c["sl_score_rollout_generated"], c["sl_winner_reroll_generated"]
        log(f"[pq] {fkm}: B={B} T={T} f32, {int(sol.iterations.max())} trips, {wall:.3f} s, "
            f"recomputed solved fraction {frac_true:.4f}, mean objective "
            f"{float(sol.objective.mean()):.6f}; launches K1/K2 {k12} (K2's template "
            f"{c['riccati_backward_wide']}), generated K3 {k34[0]}, K4 {k34[1]}")
        if k12 <= 0:
            raise AssertionError(f"planar quadrotor/{fkm}: the recursion's kernel was not launched")
        if fkm == "pallas" and min(k34) <= 0:
            raise AssertionError(f"planar quadrotor: generated K3/K4 were not launched {k34}")
        if fkm == "scan" and max(k34) > 0:
            raise AssertionError(f"planar quadrotor: the loop path launched K3/K4 {k34}")
        if frac_true < 0.99:
            raise AssertionError(f"planar quadrotor/{fkm}: recomputed solved fraction {frac_true} < 0.99")
    if abs(fracs["pallas"] - fracs["scan"]) > 0.01:
        raise AssertionError(f"planar quadrotor: kernel and loop solved fractions differ: {fracs}")
    Jk, Js = sols["pallas"].objective, sols["scan"].objective
    rel = (Jk - Js).abs() / Js.abs().clamp(min=1.0)
    log(f"[pq] objective, kernels against loops on the same lanes: mean {float(Jk.mean()):.6f} "
        f"against {float(Js.mean()):.6f}; lane by lane max relative difference "
        f"{float(rel.max()):.3e}, median {float(rel.median()):.3e}; iterations equal on "
        f"{int((sols['pallas'].iterations == sols['scan'].iterations).sum())} of {B} lanes")
    return counts["pallas"]


# ---------------------------------------------------------------------------
# phase 11: the recursion past n + m = 32 (the tall template), and a team of
# three quadrotors at (36, 12) solved end to end
# ---------------------------------------------------------------------------

# past n + m = 64 at (70, 4) and (4, 70): the fit rule's range (riccati_plan)
TALL_GRID = ((20, 13), (24, 12), (36, 12), (48, 16), (62, 2), (2, 62), (70, 4), (4, 70))
SHARES_DIMS = ((36, 12), (48, 16))   # 11c prints the phase shares of a step here
# phase 11b (the tall template only): where an f32 kernel's output misses
# the f32 tolerance against f64, it is held to this many times the f32 plain
# version's own distance from f64 (the kernel's sums run in another order)
F32_OWN = 4.0
TEAM = (36, 12)                     # 11d: tests/torch_user_problems.py::quadrotor_team
# the ring of step tiles the team's K3/K4 take (tiles, bytes a block): 546
# slots of 32 lanes a tile; two f64 tiles (279,584 B) pass a block's 232,448
# (csrc/sl_rollout.cuh's rule, tests/test_torch_quadrotor_team.py)
TEAM_RINGS = {torch.float32: (2, 139808), torch.float64: (1, 139792)}
TEAM_T = 41
# the team's loop-rollout cell: its time is its slowest lane's trips times
# a launch-bound trip (1.26 s at T=41), so it runs on fewer lanes, paired
# with the same lanes of the kernels' B_MAIN solve.  Cut from 64 lanes (32
# trips on both paths, 40.2 and 11.4 s of an 861.2 s run, NVIDIA H100 80GB
# HBM3, 700 W); the kernel cell of its own on these 16 lanes went next (20
# trips, 6.6 s and its warm-up of an 880.7 s run)
B_TEAM_LOOP = 16


def start_team_build(P, pk, fk, pool):
    """Phase 11d's build, started first in the background beside phase 5's
    golden half: the team's device model generated here (tracing stays on
    this thread), then the recursion's library at (36, 12) f32 and the
    generated K3/K4 built together, as a user's first solve builds them
    (``core/solve_sl.py::build_kernels``).  Returns (spec, device model,
    the pending build's seconds)."""
    from iterativelqr_tpu_torch import _build

    spec = user_problems().quadrotor_team(P, torch, TEAM_T)
    model = fk.device_model(spec, "cuda")
    if model is None or model.generated is None:
        raise AssertionError(f"team: no generated model ({fk.model_reason(spec, 'cuda')})")
    sources = (pk.riccati_plan(*TEAM, torch.float32).source(), model.generated.translation_unit())

    def run():
        t0 = time.perf_counter()
        _build.build_generated(*sources)
        return time.perf_counter() - t0

    return spec, model, pool.submit(run)


def clocked_plan(pk, n, m, dtype=torch.float32):
    """The rule's plan at (n, m, dtype) with the tall template's phase
    clocks built in (``RiccatiPlan.clocks``, a build for measuring only)."""
    return dataclasses.replace(pk.riccati_plan(n, m, dtype), clocks=True)


def start_tall_grid(pk, pool):
    """Phase 11a's build, queued in the background behind the team's and
    10a's: the tall grid's libraries in f32 and f64 but the team's
    (36, 12) f32 (``start_team_build``), and 11c's clocked builds at
    SHARES_DIMS in f32.  Returns (plans, the pending build's seconds)."""
    from iterativelqr_tpu_torch import _build

    plans = [pk.riccati_plan(n, m, d) for n, m in TALL_GRID for d in DTYPES]
    team = pk.riccati_plan(*TEAM, torch.float32)
    clocked = [clocked_plan(pk, n, m) for n, m in SHARES_DIMS]

    def run():
        t0 = time.perf_counter()
        _build.build_generated(*(p.source() for p in plans + clocked if p != team))
        return time.perf_counter() - t0

    return plans, pool.submit(run)


def build_tall_grid(pk, plans, pending):
    """Phase 11a: the tall grid's libraries (``start_tall_grid``): seconds,
    each plan against its library's ring entry, registers and spills."""
    from iterativelqr_tpu_torch import _build

    seconds = pending.result()
    paths = _build.build_generated(*(p.source() for p in plans))
    if any(not p.tall for p in plans):
        raise AssertionError("the rule takes another template than the tall one past n + m = 32")
    log(f"[tall] {len(paths) - 1} libraries (the tall grid {list(TALL_GRID)} in f32 and f64, "
        f"but 11d's) built together in {seconds:.2f} s, in the background")
    report_plans(pk, plans, paths, "tall")


@functools.lru_cache(maxsize=1)
def device_stacks(seed, B, Tm1, n, m):
    """wide_stacks' distribution drawn on the card (torch's generator, f64;
    kept for the next call, which must not write them): numpy's einsum
    took 3-22 s a tall dims at B=1000, and its stacks at (48, 16) and
    B=4096 take 10 GB."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64, device="cuda")
    T = Tm1 + 1

    def spd(rows, d, scale):
        A = rand(rows, d, d, B)
        eye = torch.eye(d, dtype=torch.float64, device="cuda")[None, :, :, None]
        return scale * torch.einsum("tikb,tjkb->tijb", A, A) / d + 2.0 * eye

    eye = torch.eye(n, dtype=torch.float64, device="cuda")[None, :, :, None]
    return (0.1 * rand(Tm1, n, n, B) + eye, 0.5 * rand(Tm1, n, m, B), rand(T, n, B),
            rand(Tm1, m, B), spd(T, n, 0.5), spd(Tm1, m, 1.0), 0.2 * rand(Tm1, m, n, B))


def device_case(seed, B, Tm1, n, m, dtype, poison):
    """masked_case's "indefinite_lanes" on ``device_stacks``: the last
    action masked where m > 1, Quu made indefinite (``poison``) at one step
    on every 61st lane, a per-lane regularizer from [1e-3, 1]."""
    st = [a.clone() for a in device_stacks(seed, B, Tm1, n, m)]
    bad = np.zeros(B, bool)
    bad[::61] = True
    st[5][Tm1 // 2, 0, 0, torch.as_tensor(bad, device="cuda")] = poison
    um = torch.ones((Tm1, m), dtype=dtype, device="cuda")
    if m > 1:
        um[:, -1] = 0.0
    reg = torch.as_tensor(np.random.default_rng(seed + 1).uniform(1e-3, 1.0, B), dtype=dtype,
                          device="cuda")
    return [a.to(dtype).contiguous() for a in st], um, reg, bad


def time_tall(pk, pb):
    """Phase 11c: K2 on the tall template at every TALL_GRID dims, f32,
    B=4096, T=TEAM_T, on stacks drawn on the card (``device_stacks``),
    against the bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s, the
    larger) and the plain version's time (the one run of its check), with
    the bytes of the sectors its copies touch beside the
    bytes it must read, and the share of a step's cycles in each phase
    (``tall_phase_shares``, the clocked builds of 11a) at SHARES_DIMS; and
    K5, K6a and K6b
    at the team's (36, 12) on the same stacks with the last action masked,
    each through its wrapper with the counts set to 0 just before and read
    just after.  Each kernel's every output is held to its plain version in
    f32 on the same inputs at 11b's f32 tolerance, 1e-4 of max(|plain|,
    1), or, past it, by 11b's F32_OWN rule against the plain version in f64
    (``within_own``: at (62, 2) the f32 plain version is itself about 1e-4
    from f64).  Returns ({kernel name: record} of (36, 12), {(n, m): K2's record}
    of the other dims); K2's launches are its wrapper's (the team's solve
    sets (36, 12)'s later)."""
    B, T = B_MAIN, TEAM_T
    records, grid = {}, {}
    for n, m in TALL_GRID:
        st = [a.float() for a in device_stacks(SEED, B, T - 1, n, m)]
        kin = [a.contiguous() for a in pk.prepare_stacks(*st, torch.ones((T - 1, m), dtype=torch.bool))]
        del st
        reg = torch.zeros(B, dtype=torch.float32, device="cuda")
        inputs = sum(a.numel() * a.element_size() for a in kin)
        nbytes = inputs + sum(a.numel() * a.element_size() for a in (
            reg, *pk.new_outputs(T - 1, n, m, B, torch.float32, "cuda")))
        ops = riccati_ops(n, m) * (T - 1) * B
        plan = pk.riccati_plan(n, m, torch.float32)
        run = lambda: pk.backward_pass_multiref(kin[:7], kin[7], kin[8], reg)
        plain = lambda: pk.backward_pass_multiref_reference(kin[:7], kin[7], kin[8], reg)
        for c in counters().values():
            c.reset()
        out = run()
        torch.cuda.synchronize()
        launches = counters()[plan.main].launches
        ref, p_ms = timed_once(plain)   # the plain version timed on its check's run
        name = f"{plan.main} ({n}, {m}) B={B} f32"
        outs, refs = [a.double() for a in out], [b.double() for b in ref]
        try:
            err, _ = max_err(name, outs, refs, PLAIN_TOLS[torch.float32])
        except AssertionError:
            # 11b's rule on the tall template: an f32 output past the
            # tolerance is held to F32_OWN times the f32 plain version's
            # own distance from the plain version in f64 on the same inputs
            ref64 = pk.backward_pass_multiref_reference(
                [a.double() for a in kin[:7]], kin[7].double(), kin[8].double(), reg.double())
            err = within_own(name, outs, refs, ref64)
        del out, ref, outs, refs
        k_ms = cuda_ms(run)
        b_ms, b_by = bound_ms(nbytes, ops)
        # the tiles' copies read every input once, in runs of a block's
        # lanes: 16 B (4 lanes f32) or 8 B (2 lanes) of each 32-B sector,
        # whose rest only a neighbouring block's copies (through L2) use
        run_bytes = plan.lanes * 4
        sectors = inputs * 32 // min(run_bytes, 32)
        log(f"[tall] {plan.main} n={n} m={m} T={T} B={B} f32 on the tall template ({plan.lanes} "
            f"lanes, {plan.threads} threads, ring {plan.depth[0]}): kernel {k_ms:.4f} ms (median "
            f"of 10), plain {p_ms:.3f} ms (its check's run), max |kernel - plain| {err:.3e}; "
            f"bound {b_ms:.4f} ms ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations); {b_ms / k_ms:.1%} of the "
            f"bound; its copies read {run_bytes}-B runs: the sectors they touch hold "
            f"{sectors / 1e6:.1f} MB against the inputs' {inputs / 1e6:.1f} MB "
            f"({sectors / inputs:.0f} x without reuse across blocks in L2)")
        del kin
        if (n, m) in SHARES_DIMS:
            tall_phase_shares(pk, n, m)
        rec = dict(launches=launches, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by)
        if (n, m) == TEAM:
            records[plan.main] = rec
        else:
            grid[n, m] = rec
    n, m = TEAM
    st = [a.float().contiguous() for a in device_stacks(SEED, B, T - 1, n, m)]
    um = torch.ones((T - 1, m), dtype=torch.float32, device="cuda")
    um[:, -1] = 0.0
    reg = torch.as_tensor(np.random.default_rng(SEED + 1).uniform(1e-3, 1.0, B),
                          dtype=torch.float32, device="cuda")
    for label, base in (("K5", "riccati_packed"), ("K6a", "riccati_masked"),
                        ("K6b", "riccati_masked_packed")):
        kern, plain, _, kin = packed_masked_runs(pk, pb, label, st, um, reg)
        kname = base + pk.riccati_plan(n, m, torch.float32).suffix
        for c in counters().values():
            c.reset()
        out = kern()
        torch.cuda.synchronize()
        path = {k: c.launches for k, c in counters().items() if c.launches}
        if path != {kname: 1}:
            raise AssertionError(f"{label} at {TEAM}: its wrapper launched {path}, not {kname} once")
        err, _ = max_err(f"{kname} {TEAM} B={B} f32", [a.double() for a in out],
                         [b.double() for b in plain()], PLAIN_TOLS[torch.float32])
        k_ms = cuda_ms(kern)
        p_ms = cuda_ms(plain, **PLAIN_REPS)
        nbytes = sum(a.numel() * a.element_size() for a in (*kin, *out))
        b_ms, b_by = bound_ms(nbytes, riccati_ops(n, m) * (T - 1) * B)
        log(f"[tall] {kname} n={n} m={m} T={T} B={B} f32: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms (one run), max |kernel - plain| {err:.3e}; bound {b_ms:.4f} ms "
            f"({b_by}); {b_ms / k_ms:.1%} of the bound")
        records[kname] = dict(launches=1, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by)
    device_stacks.cache_clear()
    return records, grid


def tall_phase_shares(pk, n, m, dtype=torch.float32, B=B_MAIN, T=TEAM_T, reps=3):
    """The share of a step's cycles in each phase of the tall template
    (``pk.PHASES``: the copy wait, A1, A2, B, C and its Quu_eff K, D, E) at (n, m), on
    ``device_stacks``: a library of the rule's plan built with the phase
    clocks (``RiccatiPlan.clocks``, for measuring only), launched once to
    warm up and then ``reps`` times, the clocks read after.  Logs and
    returns ({phase: share}, cycles a step a block, ms a launch of the
    clocked build)."""
    from iterativelqr_tpu_torch import _build

    plan = clocked_plan(pk, n, m, dtype)
    _build.build_generated(plan.source())
    st = [a.to(dtype) for a in device_stacks(SEED, B, T - 1, n, m)]
    kin = [a.contiguous() for a in pk.prepare_stacks(*st, torch.ones((T - 1, m), dtype=torch.bool))]
    reg = torch.zeros(B, dtype=dtype, device="cuda")
    scratch = pk.LaunchCounter()
    run = lambda: pk.launch(plan, plan.main, scratch, (*kin, reg),
                            pk.new_outputs(T - 1, n, m, B, dtype, "cuda"), T - 1, B)
    run()
    torch.cuda.synchronize()
    pk.phase_clocks(plan)
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    clocks = pk.phase_clocks(plan)
    total = sum(clocks.values())
    shares = {k: v / total for k, v in clocks.items()}
    blocks = -(-B // plan.lanes)
    per_step = total / (reps * blocks * (T - 1))
    ms = cuda_ms(run, reps=5, warmup=1)
    log(f"[tall] phase shares n={n} m={m} {str(dtype).split('.')[-1]} B={B} T={T} ({plan.lanes} "
        f"lanes, {plan.threads} threads; clocked build {ms:.4f} ms): "
        + ", ".join(f"{k} {v:.1%}" for k, v in shares.items())
        + f"; {per_step:.0f} cycles a step a block")
    return shares, per_step, ms


def team_cases(P):
    """Phase 11d's K3/K4 case (``check_generated_rollouts``): the team's
    generated model on rollout_case's quadrotor inputs (thrusts about hover,
    some lanes past a bound, gentle gains), f64 and f32, timed in f32."""
    up = user_problems()
    return [("team", "team", TEAM_T, lambda: up.quadrotor_team(P, torch, TEAM_T), None, None,
             (torch.float32,))]


def run_team(P, pk, fk, team):
    """Phase 11d: tests/torch_user_problems.py's team of three quadrotors
    at (36, 12) as a user writes it, f32, the tuned preset's options on the
    SL route: its recursion's library (the tall template) and generated
    K3/K4 built together in the background (``start_team_build``: seconds,
    the generated model's registers and spills; the solver's own
    build_kernels then finds them); the team's K3/K4 against their plain
    versions in f64 and f32
    (``check_generated_rollouts``); B=4096 with the kernels, and on the
    first B_TEAM_LOOP lanes with the loop rollouts: trips, walls, launches
    (K2 on the tall template and generated K3/K4 > 0 on the kernel path),
    the recomputed solved fraction (>= 0.99 on the kernel path; the loop
    cell's within 0.01 of the kernel solve's on its lanes), the separation
    rows' least margin, the objectives lane by lane on the loop cell's
    lanes, and a trip's seconds on each path.
    Returns (the B=4096 kernel path's launch counts, the K3/K4 records)."""
    from iterativelqr_tpu_torch import _build
    from iterativelqr_tpu_torch.core.solve_sl import build_kernels

    up = user_problems()
    dtype = torch.float32
    spec, model, pending = team
    plan = pk.riccati_plan(*TEAM, dtype)
    seconds = pending.result()
    t0 = time.perf_counter()
    paths = build_kernels(spec, True, dtype)
    log(f"[team] the recursion's library at {TEAM} f32 ({plan.template} template, {plan.lanes} "
        f"lanes, ring {plan.depth[0]}) and the generated K3/K4 ({model.name}, "
        f"{model.generated.ops_per_step()} operations a step, kStream {model.generated.stream}) "
        f"built together in {seconds:.2f} s, in the background beside phase 5's golden half "
        f"(the solver's build_kernels then {time.perf_counter() - t0:.2f} s)")
    for path in paths:
        for line in _build.ptxas_report(path.with_suffix(".log")):
            log(f"[team]   {line}")
    records = check_generated_rollouts(P, fk, team_cases(P))
    for d in DTYPES:
        ring = fk.rollout_ring(model, d)
        if ring != TEAM_RINGS[d]:
            raise AssertionError(f"team: the library's K3/K4 ring {ring} is not {TEAM_RINGS[d]}")
        log(f"[team] K3/K4 ring in {str(d).split('.')[-1]}: {ring[0]} tiles, {ring[1]} B a block "
            f"(the rule's)")
    inputs = [torch.as_tensor(a, dtype=dtype, device="cuda")
              for a in up.quadrotor_team_inputs(B_MAIN, TEAM_T, SEED)]
    sols, fracs, counts, walls = {}, {}, {}, {}
    for fkm, B in (("pallas", B_MAIN), ("scan", B_TEAM_LOOP)):
        opts = P.Options(**TUNED, batched_solver="sl", forward_kernel=fkm)
        args = [a[:B].contiguous() for a in inputs]
        P.make_batched_solve_fn(spec, dataclasses.replace(opts, max_total_iterations=2),
                                device="cuda", dtype=dtype)(*args)
        torch.cuda.synchronize()
        solve = P.make_batched_solve_fn(spec, opts, device="cuda", dtype=dtype)
        sol, stats, wall, c = counted_solve(P, solve, args)
        _, frac = integrity(f"team/{fkm}", spec, sol, stats, args[2], opts.constraint_tolerance,
                            B, TEAM_T, *TEAM)
        sols[fkm], fracs[fkm], counts[fkm], walls[fkm] = sol, frac, c, wall
        k2 = c[plan.main]
        k34 = c["sl_score_rollout_generated"], c["sl_winner_reroll_generated"]
        xs = sol.xs
        sep = min(float(((xs[:, :, 12 * i:12 * i + 3] - xs[:, :, 12 * j:12 * j + 3]) ** 2)
                        .sum(-1).min()) for i, j in up.TEAM_PAIRS)
        near = torch.stack([((xs[:, :, 12 * i:12 * i + 3] - xs[:, :, 12 * j:12 * j + 3]) ** 2)
                            .sum(-1).min(dim=1).values for i, j in up.TEAM_PAIRS]).min(0).values
        binding = float((near < 1.05 * up.TEAM_SEP ** 2).float().mean())
        log(f"[team] {fkm}: B={B} T={TEAM_T} f32, {int(sol.iterations.max())} trips, {wall:.3f} s, "
            f"recomputed solved fraction {frac:.4f}, mean objective "
            f"{float(sol.objective.mean()):.6f}; least squared separation {sep:.5f} "
            f"({up.TEAM_SEP ** 2:g} the bound), within 5% of it on {binding:.3f} of the lanes; "
            f"launches K2 (tall template) {k2}, generated K3 {k34[0]}, K4 {k34[1]}")
        if k2 <= 0:
            raise AssertionError(f"team/{fkm}: the recursion's kernel was not launched")
        if fkm == "pallas" and min(k34) <= 0:
            raise AssertionError(f"team: generated K3/K4 were not launched {k34}")
        if fkm == "scan" and max(k34) > 0:
            raise AssertionError(f"team: the loop path launched K3/K4 {k34}")
        if fkm == "pallas" and frac < 0.99:
            raise AssertionError(f"team/{fkm} B={B}: recomputed solved fraction {frac} < 0.99")
    # the loop cell against the kernel solve's first B_TEAM_LOOP lanes (a
    # lane's solve does not depend on the others: phase 6b)
    L, kern, loop = B_TEAM_LOOP, sols["pallas"], sols["scan"]
    head = types.SimpleNamespace(xs=kern.xs[:L], us=kern.us[:L])
    pair = [recomputed_solved_fraction(spec, head, inputs[2][:L], opts.constraint_tolerance),
            fracs["scan"]]
    if abs(pair[0] - pair[1]) > 0.01:
        raise AssertionError(f"team: kernel and loop solved fractions differ on the same lanes: {pair}")
    Jk, Js = kern.objective[:L], loop.objective
    rel = (Jk - Js).abs() / Js.abs().clamp(min=1.0)
    its = kern.iterations[:L] == loop.iterations
    trips = int(kern.iterations.max()), int(loop.iterations.max())
    log(f"[team] kernels (B={B_MAIN}) against loops (B={L}) on the same {L} lanes: solved "
        f"fraction recomputed {pair[0]:.4f} against {pair[1]:.4f}; objective mean "
        f"{float(Jk.mean()):.6f} against {float(Js.mean()):.6f}; lane by lane max relative "
        f"difference {float(rel.max()):.3e}, median {float(rel.median()):.3e}; iterations equal "
        f"on {int(its.sum())} of {L} lanes (the most {int(kern.iterations[:L].max())} against "
        f"{trips[1]}); a trip {walls['pallas'] / trips[0]:.3f} s with the kernels on {B_MAIN} "
        f"lanes, {walls['scan'] / trips[1]:.3f} s with the loops on {L}")
    return counts["pallas"], records


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false")
    t_start = time.perf_counter()

    def at(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    import iterativelqr_tpu_torch as P
    from iterativelqr_tpu_torch import _build
    from iterativelqr_tpu_torch.ops import packed_backward as pk
    from iterativelqr_tpu_torch.ops import pallas_backward as pb
    from iterativelqr_tpu_torch.ops import sl_forward_kernel as fk

    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[id] {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}; nvcc: {nvcc}; "
        f"device count {torch.cuda.device_count()}")
    # phase 5's CPU half in a worker process that needs no card, from now
    # until phase 5 (beside phases 2-4, which wait on the card and nvcc)
    cpu_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cpu_worker = cpu_pool.submit(card_vs_cpu_cpu_half)

    # the kernel library (K3/K4) and the recursion's libraries at the
    # registered models' dims (otherwise each built at its first use), their
    # nvcc runs all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        riccati = pool.submit(pk.build, *REGISTERED_DIMS, dtypes=DTYPES)
        _build.load_library()
        paths = riccati.result()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name}), with the recursion's libraries at "
        f"{list(REGISTERED_DIMS)} in f32 and f64")
    for line in _build.ptxas_report():
        log(f"[build] {line}")
    for path in paths:
        for line in _build.ptxas_report(path.with_suffix(".log")):
            log(f"[build] {line}")
    at("build")

    records = {"riccati_backward": check_riccati(pk, "K1"),
               "riccati_backward_wide": check_riccati(pk, "K2")}
    for label in PACKED_MASKED_CASES:
        records.update(check_packed_masked(pk, pb, label))
    at("phases 3, 3c")
    rollouts = check_rollouts(fk)
    for kname in ("sl_score_rollout", "sl_winner_reroll"):
        records[kname] = rollouts[f"{kname}/acrobot"]   # the main path's shapes
    at("phase 3b")

    launches = collections.Counter()
    pairs = collections.defaultdict(dict)
    single_shot = {}
    for name, kw, fkm, B, T in (("tuned", TUNED, "scan", B_LOOP_TUNED, T_LOOP),
                                ("tuned", TUNED, "pallas", B_LOOP_TUNED, T_LOOP),
                                ("tuned", TUNED, "pallas", B_MAIN, T_MAIN),
                                ("parity", PARITY, "scan", B_LOOP, T_LOOP),
                                ("parity", PARITY, "pallas", B_LOOP, T_LOOP),
                                ("parity", PARITY, "pallas", B_MAIN, T_MAIN)):
        counts, wall, sol, inputs = run_preset(P, name, kw, fkm, B, T)
        launches.update(counts)
        pairs[name, B][fkm] = (wall, int(sol.iterations.max()))
        if fkm == "pallas" and B == B_MAIN:
            single_shot[name] = (sol, wall, inputs)
        at(f"phase 4 {name}/{fkm} B={B} T={T}")
    for (name, B), pair in pairs.items():
        if len(pair) == 2:
            (w_s, t_s), (w_p, t_p) = pair["scan"], pair["pallas"]
            log(f"[slice] {name} B={B} T={T_LOOP if B != B_MAIN else T_MAIN}, same lanes: loops {w_s:.3f} s ({t_s} trips), kernels "
                f"{w_p:.3f} s ({t_p} trips); {w_s / w_p:.2f} x")
    model_fracs, walls = {}, {}
    for model in MODEL_CELLS:
        fracs = model_fracs[model] = {}
        for fkm in ("scan", "pallas"):
            fracs[fkm], counts, walls[model, fkm] = run_model(P, model, fkm)
            launches.update(counts)
        log(f"[slice] {model}: recomputed solved fraction scan {fracs['scan']:.4f}, "
            f"pallas {fracs['pallas']:.4f}")
        if abs(fracs["scan"] - fracs["pallas"]) > 0.01:
            raise AssertionError(f"{model}: scan and pallas solved fractions differ by more than 0.01: {fracs}")
        if model == "quadrotor" and min(fracs.values()) < 0.99:
            raise AssertionError(f"quadrotor: recomputed solved fraction below 0.99: {fracs}")
        at(f"phase 4 {model}")

    sols = {}
    for variant, B, model in (("auto", B_VMAP_LOOP, "acrobot"), ("v1", B_VMAP_K6, "acrobot"),
                              ("v2", B_VMAP_K6, "acrobot"), ("v1", B_MAIN, "quadrotor"),
                              ("v2", B_MAIN, "quadrotor")):
        sols[variant, model], counts = run_vmap_cell(P, variant, B, model)
        launches.update(counts)
        at(f"phase 4c {variant} {model}")
    for model in ("acrobot", "quadrotor"):
        its_a, its_b = sols["v1", model].iterations, sols["v2", model].iterations
        differ = torch.nonzero(its_a != its_b).flatten().tolist()
        log(f"[vmap] {model} tuned+K6a vs tuned+K6b (same lanes, f32): iterations differ on "
            f"{len(differ)} lanes" + (f" (first {differ[:8]}: {its_a[differ[:8]].tolist()} vs "
                                      f"{its_b[differ[:8]].tolist()})" if differ else ""))

    cpu_half = cpu_worker.result()
    cpu_pool.shutdown()
    check_card_vs_cpu(P, cpu_half)
    check_vmap_card_vs_cpu(P, cpu_half)
    at("phase 5 card vs cpu")
    # phases 8a's, 11d's, 10a's and 11a's builds in the background, from
    # phase 5's golden half on (beside its CPU-bound half they slowed it by
    # a third).  Their thread runs at nice 10 (on Linux a thread's own), and
    # the nvcc processes it starts inherit it: up to 22 of them at once on 8
    # cores took most of the host from the phases beside them
    background = concurrent.futures.ThreadPoolExecutor(1, initializer=os.nice, initargs=(10,))
    gen_build = start_generated_build(P, fk, background)
    team = start_team_build(P, pk, fk, background)
    grid_plans_, grid_build = start_riccati_grid(pk, background)
    tall_plans_, tall_build = start_tall_grid(pk, background)
    for fixture in GOLDEN:
        check_golden(P, fixture)
    for backward_pass, fixture in (("scan", "car"), ("auto", "quadrotor")):
        check_golden_per_instance(P, backward_pass, fixture)
    at("phase 5 golden")

    check_assoc()
    time_assoc_grid()
    at("phase 6a")
    from iterativelqr_tpu_torch.core import solve_compact

    for name, kw in (("tuned", TUNED), ("parity", PARITY)):
        grains = COMPACT_GRAINS if name == "tuned" else (solve_compact.GRAIN,)
        for grain in grains:
            counts = run_compacted(P, name, kw, single_shot[name], grain)
            if grain == solve_compact.GRAIN:
                launches.update(counts)
        at(f"phase 6b {name}")
    check_capped_rescue(P)
    at("phase 6b capped rescue")
    check_solver(P)
    check_sensitivity(P)
    at("phase 6c")

    # phase 7a: the (2, 1) instantiations and the new device models'
    # rollout kernels, each with its own record (its "instance")
    extra = [("riccati_backward", "n=2 m=1", check_riccati(pk, "K1 (2, 1)"))]
    for label in PACKED_MASKED_CASES:
        for key, rec in check_packed_masked(pk, pb, label, dims=[(2, 1, T_MAIN)]).items():
            extra.append((key.split("/")[0], "n=2 m=1", rec))
    for key, rec in check_rollouts(fk, NEW_ROLLOUT_MODELS).items():
        kname, model = key.split("/")
        extra.append((kname, f"model={model}", rec))
    at("phase 7a")
    new_counts = run_new_models(P)
    for kname, instance, rec in extra:
        if "launches" not in rec:
            # the launches of the path that runs this instantiation: K1 at
            # (2, 1) in the particle and pendulum solves, K3/K4 in their
            # model's solve
            models = (("particle", "pendulum") if instance == "n=2 m=1"
                      else (instance.split("=")[1],))
            rec["launches"] = sum(new_counts[m][kname] for m in models)
    at("phase 7b")
    check_ddp(P)
    at("phase 7c")
    mpc_state = check_mpc(P)
    farm_rate, _ = run_farm(P)
    at("phase 7d")

    # phase 8: K3/K4 for user problems, through generated device functions
    build_generated(gen_build)
    at("phase 8a")
    gen_records = check_generated_rollouts(P, fk, phase_8b_cases(P))
    at("phase 8b")
    gen_counts = {}
    tuned_trips = pairs["tuned", B_MAIN]["pallas"][1]
    gen_counts["acrobot (lambdas)"], wall, sol, _ = run_preset(
        P, "tuned", TUNED, "pallas", B_MAIN, T_MAIN,
        spec=generated_spec(P, "acrobot (lambdas)", T_MAIN))
    for kname in ("sl_score_rollout_generated", "sl_winner_reroll_generated"):
        if gen_counts["acrobot (lambdas)"][kname] <= 0:
            raise AssertionError(f"tuned/generated: {kname} was not launched")
    log(f"[generated] tuned acrobot T={T_MAIN} B={B_MAIN} f32 on the generated model: "
        f"{int(sol.iterations.max())} trips, {wall:.3f} s; the hand-written model's (phase 4) "
        f"{tuned_trips} trips, {pairs['tuned', B_MAIN]['pallas'][0]:.3f} s")
    at("phase 8c tuned")
    rate, gen_counts["farm"] = run_farm(P, generated_spec(P, "farm", FARM_T),
                                        label="farm (example's costs)")
    log(f"[generated] farm with examples/mpc_farm.py's own costs: {rate:.1f} plans/s; the "
        f"library particle's (phase 7d) {farm_rate:.1f} plans/s ({rate / farm_rate:.3f} x)")
    gen_counts["demo (w)"] = run_demo(P)
    at("phase 8c")
    check_refusals(P, fk)
    at("phase 8d")
    gen_records.update(check_generated_rollouts(P, fk, phase_8e_cases()))
    gen_counts.update(run_matrix_solves(P, model_fracs, walls))
    at("phase 8e")
    for key, rec in gen_records.items():
        kname, label = key.split("/")
        if label in gen_counts:     # the math problem runs in no solve
            rec["launches"] = gen_counts[label][f"{kname}_generated"]
            extra.append((kname, f"generated model={label}", rec))

    # phase 9: the batch-sharded, time-sharded and multi-process routes
    launches.update(run_pod_sweep(P))
    at("phase 9a")
    started = start_distributed()
    sharded_sol, counts = run_sharded(P, single_shot["tuned"])
    launches.update(counts)
    at("phase 9b")
    launches.update(run_compacted_devices(P, single_shot["tuned"]))
    at("phase 9c")
    finish_distributed(P, started)
    at("phase 9d")
    check_horizon(P)
    at("phase 9e")
    profile_tuned(P, single_shot["tuned"])
    at("phase 9f")
    check_checkpoint(P, sharded_sol, mpc_state)
    at("phase 9g")
    from iterativelqr_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2)
    log("[entry] dryrun_multichip(2) on [cuda:0, cuda:0]: the vmap, SL and per-device "
        "compaction routes agree (iterations, xs within 2e-3, reported violations recomputed)")
    at("phase 9h")

    # phase 10: the recursion at any (n, m), and a user problem at (6, 2)
    pq_counts = run_planar_quadrotor(P, pk, fk)
    at("phase 10d")
    build_riccati_grid(pk, grid_plans_, grid_build)
    at("phase 10a")
    check_riccati_grid(pk, pb)
    at("phase 10b")
    for (n, m), rec in time_riccati_grid(pk).items():
        kname = rec.pop("kernel")
        if (n, m) == (6, 2):   # the launches of the planar quadrotor's solve
            rec["launches"] = pq_counts[kname]
        extra.append((kname, f"n={n} m={m}", rec))
    at("phase 10c")

    # phase 11: the recursion past n + m = 32, and the team at (36, 12)
    team_counts, team_records = run_team(P, pk, fk, team)
    at("phase 11d")
    build_tall_grid(pk, tall_plans_, tall_build)
    background.shutdown()
    at("phase 11a")
    check_riccati_grid(pk, pb, TALL_GRID, "tall")
    at("phase 11b")
    tall_records, tall_grid = time_tall(pk, pb)
    records.update(tall_records)
    records["riccati_backward_tall"].pop("launches")   # its wrapper's; the team's solve's:
    launches["riccati_backward_tall"] = team_counts["riccati_backward_tall"]
    for (n, m), rec in tall_grid.items():   # no solve runs these dims: their wrapper's launch
        extra.append(("riccati_backward_tall", f"n={n} m={m}", rec))
    for kname in ("riccati_packed_tall", "riccati_masked_tall", "riccati_masked_packed_tall"):
        # no solve of the JAX package runs K5, and no SL solve K6a/K6b:
        # their launches are those of one call of their wrapper (11c)
        launches[kname] = records[kname].pop("launches")
    for key, rec in team_records.items():
        kname = key.split("/")[0]
        rec["launches"] = team_counts[f"{kname}_generated"]
        extra.append((kname, "generated model=team", rec))
    at("phase 11c")

    sources = {"riccati_backward": ("riccati_backward.cuh", "iterativelqr_tpu/ops/packed_backward.py:509"),
               "riccati_backward_wide": ("riccati_backward_wide.cuh", "iterativelqr_tpu/ops/packed_backward.py:574"),
               "sl_score_rollout": ("sl_forward.cu", "iterativelqr_tpu/ops/sl_forward_kernel.py:327"),
               "sl_winner_reroll": ("sl_forward.cu", "iterativelqr_tpu/ops/sl_forward_kernel.py:426"),
               "riccati_packed": ("riccati_backward.cuh", "iterativelqr_tpu/ops/packed_backward.py:102"),
               "riccati_masked": ("riccati_backward.cuh", "iterativelqr_tpu/ops/pallas_backward.py:109"),
               "riccati_masked_packed": ("riccati_backward.cuh", "iterativelqr_tpu/ops/pallas_backward.py:343"),
               "riccati_packed_wide": ("riccati_backward_wide.cuh", "iterativelqr_tpu/ops/packed_backward.py:102"),
               "riccati_masked_wide": ("riccati_backward_wide.cuh", "iterativelqr_tpu/ops/pallas_backward.py:109"),
               "riccati_masked_packed_wide": ("riccati_backward_wide.cuh",
                                              "iterativelqr_tpu/ops/pallas_backward.py:343"),
               "riccati_backward_tall": ("riccati_backward_tall.cuh", "iterativelqr_tpu/ops/packed_backward.py:574"),
               "riccati_packed_tall": ("riccati_backward_tall.cuh", "iterativelqr_tpu/ops/packed_backward.py:102"),
               "riccati_masked_tall": ("riccati_backward_tall.cuh", "iterativelqr_tpu/ops/pallas_backward.py:109"),
               "riccati_masked_packed_tall": ("riccati_backward_tall.cuh",
                                              "iterativelqr_tpu/ops/pallas_backward.py:343")}
    # K5 runs in no solve of the JAX package: its launches are those of its
    # batch-leading entry at the main shapes (phase 3c)
    for kname in ("riccati_packed", "riccati_packed_wide"):
        launches[kname] = records[kname].pop("launches")
    log(f"[done] whole run {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(
        name=name,
        route="cuda",
        source=f"iterativelqr_tpu_torch/csrc/{src}",
        replaces=replaces,
        launches=launches[name],
        library_ms=None,   # no single PyTorch call computes the recursion or a rollout
        **records[name],
    ) for name, (src, replaces) in sources.items()]
    kernels += [dict(
        name=name,
        instance=instance,
        route="cuda",
        # a generated model's kernels: the rollout body of sl_rollout.cuh
        # in a translation unit of its own (ops/device_functions.py)
        source="iterativelqr_tpu_torch/csrc/" + (
            "sl_rollout.cuh" if instance.startswith("generated") else sources[name][0]),
        replaces=sources[name][1],
        library_ms=None,
        **rec,
    ) for name, instance, rec in extra]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
