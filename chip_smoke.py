"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. checks for the card and prints its name and power limit;
2. builds every kernel (ops/csrc/*.cu, one library) and prints the seconds;
3. holds each kernel against its plain PyTorch version, both scored
   against a float64 plain run on the card: the solve kernel
   (cg_solve_fused) on the minirat's batched forward at B=2048 and B=2047,
   without and with joint damping and converged, on the elliptic minirat's
   (the elliptic block) likewise, and on a chunk of the Newton dispatch
   (warmstart, stall exit); the dense-input solve kernel (cg_solve_batched)
   on the dense qM and J of the minirat and the elliptic minirat; the SPD
   inverse, the paired inverse, the SPD solve, the Cholesky factor and the
   solve from it on seeded SPD matrices at nv = 7, 73 and 146 (B=2048 and
   B=2047) and on the ballmuscle's own mass matrices, all five also at
   the widths on either side of each of their design edges, and the three
   Cholesky kernels with NaN below the diagonal (which they must not read);
   and the solve kernel's wide instances (one env per block of several
   warps, ops/cg.py::kernel_layout): in layout 2 (J in device memory) on
   the two-rat stand-in at rodent_pair's sizes (assets/ratpair*.xml, nv
   146, 590 rows) at B=1024 and B=1023 and converged, on its elliptic file
   and on a chunk of its Newton dispatch, the dense-input kernel on its
   dense qM and J, on a seeded pair-size case at B=1024 and B=1023; in
   layout 1 on the one-rat file (assets/rat.xml, nv 73, the rodent's width)
   at B=2048 and B=2047 and on the seeded rodent-like case; on the rodent
   stand-in (assets/rodent_standin.xml as configs/dataset/rodent.yaml
   freezes it: nv 73, its own joint damping, so the damped Euler tail) at
   B=2048 and B=2047 and converged; bitwise against the one-warp core on
   the same inputs on the one rat (undamped and with a seeded damping), the
   rodent stand-in and the rodent-like case; the one-warp instance (b)
   (the elliptic block) on the fly stand-in (assets/fly_standin.xml as the
   fly configs freeze it: nv 42 with the free root, nv 36 tethered, 12
   elliptic contacts, the fluid model) at B=2048 and B=2047 and converged,
   both files; the wide layout 1 on the rodent stand-in's terrain
   (assets/rodent_standin_terrain.xml: 367 rows, damped) and on the props
   (assets/props.xml: nv 48, 288 rows, 8 roots) at B=2048 and B=2047 and
   converged; and at the
   design edges at 590 rows (the widest one-warp env and the first wide
   one, the widest env of layout 1, the first past it, the widest of
   layout 2); the one-warp instance on the planar minirat's slide joints
   (assets/minirat_planar.xml); the one-warp instance on the minirat and
   the damped wide layout 1 on the rodent stand-in with a per-env armature
   ((B, nv), B=2048 and B=2047), and with the model's armature repeated
   per env bitwise its shared (stride 0) run; spd_inverse on the ball-coxa
   fly stand-in's own mass matrices (nv 42); then the narrowphase's 20 box, cylinder, mesh and
   height-field pair types on those two scenes at 2048 seeded poses
   against the CPU in float64 (phase_pair_gates);
4. rolls out 2048 tracking envs (GenericSingleClip + EpisodeWrapper +
   AutoResetWrapperTracking, 10 substeps) for 20 control steps, on the
   minirat (the main path) and on the elliptic minirat, counts the kernel
   launches of each run and checks its first step on 8 envs against the
   same step run on the CPU in float64; then holds the elliptic minirat's
   constraint rows and one converged substep at seeded contact states
   against the CPU in float64; then rolls out 1024 envs of the rodent_pair
   env on the stand-in (configs/dataset/rodent_pair.yaml, 5 substeps) for
   10 control steps, exactly 5 launches per control step, and checks its
   first step on 8 envs against the CPU in float64; then rolls out 2048
   envs of the flagship rodent_single_clip env (configs/dataset/rodent.yaml,
   5 substeps, sensors every substep) on the rodent stand-in for 10 control
   steps: exactly 5 launches per control step and no other kernel, finite
   sensordata, and its first step (obs, reward, sensordata) on 8 envs
   against the CPU in float64; then 2048 envs of each fly env
   (fly_single_clip_freejnt and fly_single_clip, configs/dataset/
   fly_freejnt.yaml and fly.yaml, 5 substeps) on the fly stand-in, its clip
   from the committed stac export, for 10 control steps: exactly 5
   launches per control step and no other kernel, and its first step on 8
   envs against the CPU in float64; then 2048 envs of the flagship env on
   the rodent stand-in's terrain (every terrain pair type active from the
   first substep) for 10 control steps, exactly 5 launches per control
   step, its first step (solve converged) against the CPU in float64; then
   10 substeps of 2048 props envs through physics/step.py::step, one
   launch per substep; then 2048 envs of fly_single_clip_freejnt on the
   ball-coxa fly stand-in (assets/fly_standin_ball.xml: limited ball
   joints beside elliptic contacts, off the kernel layout) for 3 control
   steps on the array CG path, exactly one spd_inverse launch per substep
   and no other kernel, its first step (solve converged) against the CPU
   in float64; then 2048 of its envs with every coxa turned past its limit
   and further into it: one converged CG substep (one spd_inverse) and 5
   substeps of its Newton copy on the array Newton path (one spd_solve per
   substep and per Newton iteration), each with ball-limit forces in half
   the envs or more after the first substep, that substep against the CPU
   in float64; 10
   substeps of 2048 planar-minirat envs (slide joints), one solve-kernel
   launch per substep, the first (converged) against the CPU in float64;
5. steps 2048 ballmuscle envs (ball-joint limits, a fixed tendon, muscles)
   20 substeps under CG (the XLA-CG path: spd_inverse2 once per substep)
   and under Newton (spd_solve 2 + iterations per substep), counts the
   launches of each run and checks its first substep on 8 envs against the
   CPU in float64;
6. steps 2048 Newton minirat envs (Newton/100 on the kernel layout: chunks
   of the solve kernel) 20 substeps, holds the solve kernel's launches to
   the chunks the solver reports, and checks the first substep on 8 envs
   against the CPU in float64;
7. runs the smooth dynamics (dense qM, factor_m, solve_m) on 2048 minirat
   states: one launch each of the factor and the solve kernel;
8. trains PPO (agents/ppo/train.py::train) on the minirat tracking env at
   the flagship's widths (MLPs 256 x 256, 2048 envs, batch 2048, unroll
   16) for one training step with an eval before and after, the counts set
   to 0 just before: exact cg_solve_fused launches (10 per control step and
   one per reset) and no other kernel, finite metrics, the env steps asked
   for, training/sps against the host clock, a bitwise checkpoint round
   trip; then an eval episode that must roll done envs back, and the first
   minibatch's loss and gradients against the CPU in float64; it prints
   the collect and learn rates, ms per control step and per minibatch
   update, and eval/sps; then per-env randomized models on the flagship
   rodent env on its stand-in: train() at the same widths unrandomized,
   with every randomized leaf batched at its shared values (params,
   normalizer and eval reward bitwise the
   unrandomized run's) and with each env's leaves drawn per env, each with
   exactly the unrandomized launches, and the drawn model's first control
   step of 8 envs against the CPU in float64 with their values; then data
   parallel (distributed/mesh.py): (a) the minirat train() again through a
   process group of one rank (NCCL): exactly its launches and every tensor
   of its final checkpoint (params, normalizer, Adam's moments and step)
   bitwise the first run's; (b) two processes that share the one card over
   gloo (NCCL refuses two ranks on one device), each with 1024 of the rodent
   stand-in's 2048 envs at the same widths, after a stale _build/lock is
   planted: both build the kernels at once through the build's flock (one
   of them logs and removes the lock), each launches exactly its count
   (rank 0's with the two evals, rank 1's without) and no other kernel,
   evals on rank 0 only, the final training state bitwise equal on both;
   it prints each rank's training/sps beside the single-rank run's;
9. runs the driver (harness/driver.py::main, the main path) twice at the
   same widths, each in a temporary base_dir, the counts set to 0 just
   before: (i) one clip, read from the committed data/Minirat/clips/0.p
   (nothing may be written there), one training step; (ii) four clips,
   built and cached as .npz, one training step: exact cg_solve_fused
   launches and no other kernel, every artifact, finite logged numbers, the
   run config read back as written, (ii) every clip drawn, per-clip rewards
   logged and one control step of 8 envs on clips 0-3 against the CPU in
   float64; it prints each run's seconds, training/sps, eval/sps and the
   callback's seconds per rollout; the kernels line's cg_solve_fused
   launches are the two runs'; then once more with train=train_pair
   dataset=rodent_pair on the stand-in at train_pair's widths (1024 envs),
   cut the same way, its clip cut to 24 frames: exact launches, all of them
   in layout 2 (the kernels line's layout-2 row); and once more as the
   flagship's command, train=train_rodent dataset=rodent on the rodent
   stand-in at train_rodent's widths (2048 envs), cut the same way: exact
   launches, all of them in the wide layout 1 with the damped tail (the
   kernels line's rodent stand-in row); and once more as train=train_fly
   dataset=fly on the tethered fly stand-in at train_fly's widths (1024
   envs), cut the same way: exact launches, all of them the one-warp (b)
   (the kernels line's tethered fly row); the rodent and fly runs also
   write their eval videos (train.render_video on the stand-ins' render
   scenes, RENDER_SCENES) with the same launches, a video of the T frames
   the callback's rollout gives, the render's seconds printed, and the
   card's render-scene poses and the frames rasterized from them held
   against the CPU float64 ones (RENDER_LIMITS); then
   examples/policy_replay.py replays the rodent run with --video: exactly
   one reset and 38 control steps of one env's launches and no other
   kernel, its per-frame table bitwise the callback's; and once more as
   the flagship's command on the terrain stand-in
   (dataset.env_args.mjcf_path=builtin:rodent_standin_terrain.xml, its
   training step cut to unrolls of 4 control steps) with
   its video of the terrain render scene (visual meshes and the terrain
   drawn): exact launches, every narrowphase call recorded and every
   terrain pair type active in one, the render gate; and once more as
   train=train_fly_freejnt dataset=fly_freejnt on the ball-coxa fly
   stand-in, cut as the terrain's run: exactly one spd_inverse launch per
   substep and reset and no other kernel (the kernels line's spd_inverse
   row); then the last modules: both committed JAX orbax fixtures
   (assets/jax_checkpoints: a TrainingState at train_rodent's widths and
   the rodent stand-in's sizes, and the reference's (normalizer, params)
   tuple) restored without orbax, every tensor bitwise the fixture's .npz,
   the restore's seconds printed, and the flagship's rodent run once more
   with checkpoint= the full fixture: resumed at its env_steps, exactly the
   unresumed run's launches; debug_nans on 2048 minirat envs: a 20-step
   rollout bitwise with the mode on and off (200 launches each), a NaN
   policy bias named by its aten op, NaN solve-kernel and spd_inverse
   inputs named by their kernels; bfloat16 policy and value MLPs against
   float32 with their device times, and train() through bfloat16 networks
   with phase_ppo's launches; the targetbody and targetbodycom cameras of
   assets/minirat_cameras.xml against the CPU in float64;
10. times every kernel, its plain version and a PyTorch library call
   computing the same function with CUDA events (the solve kernels', the
   SPD and Cholesky kernels' and their library calls' device time by
   torch.profiler), and the rollouts and substeps on the host clock; the
   kernels line holds every solve-kernel instance with its layout and
   warps per env.

It needs nothing beyond the checkout (the models are the frozen
``assets/*.npz``; weights and states come from seeds), exits non-zero if
any phase fails, and ends with one JSON line for the caller.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_MAIN = 2048
# the minirat files: pyramidal CG 4/4 (the main path), elliptic CG 4/4,
# Newton/100 on the kernel layout
MODELS = ("minirat", "minirat_elliptic", "minirat_newton")
N_STEPS = 20
N_SUBSTEPS = 10
N_CPU_ENVS = 8
# control steps of each rollout's timed run (after a warm-up step)
TIMED_STEPS = 10

# Solve outputs the kernel is scored on, and its tolerances. A float64 plain
# run on the same inputs is the yardstick. The main path's solve (4 CG
# iterations, 4 line-search steps) is far from converged, and in float32 its
# result moves by ~5% (qacc) to ~25% (efc_force) of an env's scale against
# float64 at the median env, for the JAX package's own array path as much as
# for this port (input perturbations of 1e-7 move the float64 result by
# ~1e-6 only: the float32 error is rounding inside the iteration). So at the
# main path's settings the kernel is held to the float32 plain version's own
# error: max and median per-env relative error each within KERNEL_FACTOR of
# it (plus FLOOR_REL of the scale). A converged solve (CONVERGED_ITERS) on
# the same inputs then holds the kernel to an absolute bound: median per-env
# relative error within CONVERGED_MEDIAN (the float32 plain version's is
# ~2e-4 on qacc and ~2e-3 on the damped qvel_new). The median cannot see a
# kernel that is wrong on a few envs, so the converged run also holds the
# tail: the envs whose relative error is above TAIL_REL may be at most
# TAIL_FACTOR times as many as the float32 plain version's, plus TAIL_ENVS,
# and the kernel's 99th percentile is within TAIL_FACTOR of the plain
# version's (plus FLOOR_REL). Even converged, ~5% of envs are above TAIL_REL
# in float32, and a one-ulp change of the inputs moves which envs they are
# (two such float32 runs: 119 and 109 envs of 2048 above 1e-2 on qacc, 70
# of them in one run only), so the tail is held by its count, not per env.
SCORED = ("qacc", "efc_force", "qvel_new")
KERNEL_FACTOR = 4.0
FLOOR_REL = 1e-6
CONVERGED_ITERS = 64
CONVERGED_MEDIAN = 5e-3
TAIL_REL = 1e-2
TAIL_FACTOR = 1.5
TAIL_ENVS = 8
# The convergence flag tests a cost improvement against a tolerance at the
# edge of float32 rounding, so float32 runs flip it for envs that converge
# at rounding level. The kernel's flags may disagree with the float64 run's
# on at most KERNEL_FACTOR times as many envs as the float32 plain
# version's do, plus DONE_MISMATCH_MAX of the batch.
DONE_MISMATCH_MAX = 0.01
# first control step, card (float32) against CPU (float64): 10 substeps of
# the fall from the clip pose; obs and reward agree to this absolute
# tolerance. A CPU float32 rehearsal of that step (64 envs) is off float64 by
# 8.1e-6 (obs) and 2.9e-6 (reward) for both minirat files; the limit leaves
# ~37x the larger. The first step touches no floor, and the steps that do
# are far from float64 in float32 at 4/4 iterations (ROADMAP section C), so
# the elliptic rows meet float64 in a converged contact-state substep
# (ELL_ROW_RTOL below), and each rollout must have touched the floor
# (contact forces in at least ROLLOUT_MIN_CONTACT of the envs at its last
# step).
STEP_ATOL = {"minirat": 3e-4, "minirat_elliptic": 3e-4}
ROLLOUT_MIN_CONTACT = 0.5

# SPD kernels (spd_inverse, spd_inverse2, spd_solve). Seeded float32 SPD
# matrices Q diag(lam) Q^T with lam log-uniform in [1, SPD_COND] (condition
# number at most 1e3), at the widths of the ballmuscle (7), the rodent (73)
# and rodent_pair (146). Each kernel and the float32 plain version are
# scored by their float64 residuals, ||M X - I||_max for an inverse and
# ||M x - b|| / ||b|| for a solve (a CPU float32 rehearsal of the plain
# versions at B=33: max 1.1e-5 to 1.9e-5, median 1.3e-6 to 1.1e-5 at nv
# 7 and 73). Gate: the kernel's max and median residual within SPD_FACTOR
# of the plain version's own (plus SPD_FLOOR), and its max under SPD_ABS.
# The ballmuscle's own mass matrices (condition number up to 7.5e3 at the
# posed states) get the same factor gate and SPD_ABS_BM (the rehearsal's
# float32 plain residuals there: max 1.2e-6).
SPD_SIZES = (7, 73, 146)
SPD_COND = 1e3
SPD_FACTOR = 4.0
SPD_FLOOR = 1e-7
SPD_ABS = 1e-3
SPD_ABS_BM = 1e-4
SPD_KERNELS = ("spd_inverse", "spd_inverse2", "spd_solve")
CHOL_KERNELS = ("factor_batched", "solve_batched")
# The Cholesky kernels (spd_solve, factor_batched, solve_batched) change
# design at nv = 32 (registers below, panels of 16 rows in shared memory
# above), their register paths at 8 and 16 (and the solves' lanes per
# matrix with them), the blocked paths at every multiple of 16 (a partial
# last panel), the shared-memory row padding at multiples of 4 and the
# factor's 128 / 256 threads at 144: they are also held, by the same gates,
# on seeded SPD matrices at the widths on either side of each edge. They
# read only the upper triangle of their matrix: with NaN in the strict lower
# triangle every output must be finite and bitwise the clean input's.
CHOL_EDGE_KERNELS = ("spd_solve",) + CHOL_KERNELS
CHOL_EDGE_SIZES = (8, 9, 16, 17, 31, 32, 33, 47, 48, 49, 84, 85, 144, 145)
# The inverses (spd_inverse, spd_inverse2) change design at the same widths
# up to 49 (their register sweep's segments at 8 and 16, the blocked sweep's
# panels of 16 pivots above 32, its row padding at multiples of 4); 144 /
# 145 add a full and a one-pivot last panel on 256 threads. They read the
# whole matrix, so they have no NaN-below-the-diagonal gate.
INV_EDGE_KERNELS = ("spd_inverse", "spd_inverse2")
INV_EDGE_SIZES = tuple(n for n in CHOL_EDGE_SIZES if n <= 49) + (144, 145)
# The dense solve kernel at a rodent-like size (rodent_like_case): nv = 73
# (the rodent's dofs), 296 rows of which 4 are scalar limits, ~140 KB of
# shared memory per env, seeded; its J^T f runs five 16-column chunks where
# the minirat's runs one. Scored like the minirat's cases.
RODENT_LIKE = {"nv": 73, "nefc": 296, "nlim": 4}

# rodent_pair: the two-rat stand-in (assets/ratpair*.xml: nv 146, 114 contact
# slots, 590 rows pyramidal, 476 elliptic) runs the solve kernel's layout 2
# (J in device memory), at the pair config's 1024 envs and 5 substeps per
# control step. The same cases as the minirat's hold layout 2: (a) at B_PAIR
# and B_PAIR - 1 and converged, (b) on the elliptic file, (c) a Newton chunk.
# The dense kernel is held at the pair's size (PAIR_LIKE: its 134 limit
# rows) and at layout 2's design edges (l2_edges): at the pair's 590 rows,
# the widest env layout 1 holds, the first past it, and the widest layout 2
# holds. The first control step of the pair env on the card against the
# CPU in float64: like the minirat's it is a fall that touches no floor (the
# stand-in's feet hover 5 mm above it at qpos0). A CPU float32 rehearsal of
# that step (first_step_gaps on a float32 CPU env, 8 envs, seeds 0-2) is
# off float64 by at most 9.66e-6 (obs) and 2.05e-6 (reward); the limits
# leave ~35x.
B_PAIR = 1024
PAIR_MODELS = ("ratpair", "ratpair_elliptic", "ratpair_newton")
PAIR_LIKE = {"nv": 146, "nefc": 590, "nlim": 134}
PAIR_ROWS = 590
PAIR_STEP_ATOL = {"obs": 3.4e-4, "reward": 7.2e-5}
# the pair env as a user builds it: configs/dataset/rodent_pair.yaml (CG 4/4,
# 5 substeps per control step) with the stand-in, and train_pair's widths
PAIR_ARGV = ["train=train_pair", "dataset=rodent_pair",
             "dataset.env_args.mjcf_path=builtin:ratpair.xml"]
PAIR_SUBSTEPS = 5
PAIR_STEPS = 10
# the flagship rodent on its stand-in (assets/rodent_standin.xml: nv 73, 17
# contact slots, 135 rows, joint damping, sensors), frozen as
# configs/dataset/rodent.yaml freezes it (CG 4/4, scale_factor 0.9): the
# solve kernel's wide layout 1 with its damped Euler tail. The solve at
# B_MAIN and B_MAIN - 1 and converged, and bitwise against the one-warp core
# on the same inputs; a rollout of B_MAIN envs of rodent.yaml's env (5
# substeps per control step) built by the driver's own builder from
# RODENT_ARGV; its first control step of N_CPU_ENVS envs against the CPU in
# float64 (obs, reward and sensordata). That step is a fall that touches no
# floor (the stand-in's feet and hands hover 4-7 mm above it at qpos0). A CPU
# float32 rehearsal of it (first_step_gaps on a float32 CPU env, 8 envs,
# seeds 0-2) is off float64 by at most 1.98e-6 (obs), 1.69e-6 (reward) and
# 9.56e-6 (sensordata, of scale ~1); the limits leave ~35x.
RODENT_ARGV = ["train=train_rodent", "dataset=rodent",
               "dataset.env_args.mjcf_path=builtin:rodent_standin.xml"]
RODENT_SUBSTEPS = 5
RODENT_STEPS = 10
RODENT_STEP_ATOL = {"obs": 7e-5, "reward": 6e-5, "sensordata": 3.4e-4}
# the fly on its stand-in (assets/fly_standin.xml: nv 42 with the free
# root, nv 36 tethered; 12 elliptic contacts, 72 rows; the fluid model),
# frozen as configs/dataset/fly_freejnt.yaml and fly.yaml freeze it (CG
# 4/4): the solve kernel's one-warp (b), its elliptic block. The solve at
# B_MAIN and B_MAIN - 1 and converged on both files; a rollout of B_MAIN
# envs of each config's env (5 substeps per control step) made by
# harness/driver.py's build_env_from_cfg from FLY_ARGVS, the clip from the
# committed stac export of its width. At qpos0 the claws touch the floor, so the first
# control step presses the legs on it, and at the configs' CG 4/4 float32
# is far from float64 there (ROADMAP C; a CPU float32 rehearsal, 8 envs,
# seeds 0-2: obs 11.2 / 7.7, reward 1.05 / 1.85, a done flag apart; printed,
# not gated). So the first control step of N_CPU_ENVS envs is held against
# the CPU in float64 with the solve run to convergence on both sides
# (``converged``, phase_converged_first_step): a CPU float32 rehearsal of that
# (8 envs, seeds 0-2) is off float64 by at most 2.06e-2 / 1.47e-2 (obs, of
# scale ~13 / ~7) and 1.36e-3 / 2.42e-3 (reward, of scale ~52), free /
# tethered; the limits leave ~35x.
FLY_MODELS = ("fly_standin", "fly_standin_tethered")
_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "brax_tracking_tpu_torch",
                       "assets")
FLY_ARGVS = {
    "fly_standin": ["train=train_fly_freejnt", "dataset=fly_freejnt",
                    "dataset.env_args.mjcf_path=builtin:fly_standin.xml",
                    "dataset.stac_path=" + os.path.join(_ASSETS, "fly_standin_stac.p")],
    "fly_standin_tethered": ["train=train_fly", "dataset=fly",
                             "dataset.env_args.mjcf_path=builtin:fly_standin.xml",
                             "dataset.stac_path=" + os.path.join(
                                 _ASSETS, "fly_standin_tethered_stac.p")],
}
FLY_SUBSTEPS = 5
FLY_STEPS = 10
FLY_STEP_ATOL = {"fly_standin": {"obs": 0.72, "reward": 0.048},
                 "fly_standin_tethered": {"obs": 0.51, "reward": 0.085}}
# the ball-coxa fly stand-in (assets/fly_standin_ball.xml: the shape of the
# fly's _ball variant, nq 49 / nv 42 / njnt 25, limited ball coxae beside
# 12 elliptic claw contacts; 60 rows), off the solve kernel's layout: under
# fly_freejnt.yaml's CG 4/4 it runs the array CG path (_solve_xla), whose
# M^-1 is one spd_inverse launch per forward (each substep and reset), and
# its Newton copy the array Newton path (one spd_solve for qacc_smooth and
# one per Newton iteration). Its rollout of B_MAIN envs for FLY_BALL_STEPS
# control steps of fly_freejnt.yaml's env (FLY_BALL_ARGV, the clip from its
# committed stac export) and its first control step, solve converged, of
# N_CPU_ENVS envs against the CPU in float64 (FLY_BALL_STEP_ATOL leaves
# ~35x over a CPU float32 rehearsal, first_step_gaps on make_env("cpu",
# torch.float32, "fly_standin_ball") with both models converged: obs
# 1.58e-2 and reward 2.17e-3). The env's clip keeps the coxae near their
# rest pose, where no ball-limit row is instantiated; the posed phases
# below put them at their limits. spd_inverse on the ball fly's own mass
# matrices (nv 42, condition number up to 941) gets SPD_FACTOR's gate and
# SPD_ABS_FLY, ~35x the CPU float32 plain residual there (max 1.55e-6).
FLY_BALL_ARGV = ["train=train_fly_freejnt", "dataset=fly_freejnt",
                 "dataset.env_args.mjcf_path=builtin:fly_standin_ball.xml",
                 "dataset.stac_path=" + os.path.join(_ASSETS, "fly_standin_ball_stac.p")]
FLY_BALL_STEPS = 3
# The ball-limit rows beside the contact rows, on both array paths: B_MAIN
# of random_states' envs of the ball fly (CG with its solve converged, one
# substep; the Newton copy, BALL_POSED_SUBSTEPS) with every coxa ball
# turned about the world's vertical through it to an angle uniform in
# BALL_POSE_ANGLES (the limit is 40 degrees, 0.698 rad), turning further
# at a rate uniform in BALL_POSE_SPEEDS (rad/s). The coxa springs
# (stiffness 1 against armature 1e-5) pull back harder than the limit's
# reference acceleration asks for unless the ball turns this fast: from
# the angles alone no env of the stand-in gets a limit force (the same in
# MuJoCo C), at these rates 0.97-0.98 of them do (CPU float32, 64 envs,
# seeds 0-2). At least BALL_MIN_LIMIT_FORCE of the envs must end the
# first substep with a ball-limit force, and that substep of N_CPU_ENVS of
# them is held against the CPU in float64 within BALL_POSED_ATOL, ~35x a
# CPU float32 rehearsal (ball_posed_gaps on a float32 CPU run of 64 envs,
# seeds 0-2): CG converged off by up to 9.17e-4 (qpos) and 0.624 (qvel, of
# ball rates up to 3000), the Newton copy by 3.76e-7 and 2.90e-4.
BALL_POSE_ANGLES = (0.6, 0.8)
BALL_POSE_SPEEDS = (1500.0, 3000.0)
BALL_MIN_LIMIT_FORCE = 0.5
BALL_POSED_SUBSTEPS = {"fly_standin_ball": 1, "fly_standin_ball_newton": 5}
FLY_BALL_STEP_ATOL = {"obs": 0.55, "reward": 0.076}
BALL_POSED_ATOL = {"fly_standin_ball": {"qpos": 3.2e-2, "qvel": 22.0},
                   "fly_standin_ball_newton": {"qpos": 1.3e-5, "qvel": 1.0e-2}}
SPD_ABS_FLY = 5.4e-5
# the planar minirat on slide joints (assets/minirat_planar.xml: the slides
# rootx, with a spring and a motor, and rootz, limited, and the hinge rooty)
# on the one-warp solve kernel: the solve against its plain version, and
# SLIDE_SUBSTEPS substeps of B_MAIN envs through physics/step.py::step, one
# launch per substep, the first substep of N_CPU_ENVS envs against the CPU
# in float64 with the solve converged on both sides (at CG 4/4 a CPU
# float32 run is off float64 by up to 0.40 in qvel on these contact
# states). A CPU float32 rehearsal of the converged substep (slide_gaps on a
# float32 CPU run of 64 envs, 8 compared, seeds 0-2) is off float64 by at
# most 1.57e-6 (qpos) and 7.85e-4 (qvel); the limits leave ~35x.
SLIDE_SUBSTEPS = 10
SLIDE_STEP_ATOL = {"qpos": 5.5e-5, "qvel": 2.7e-2}
# per-env randomized models (envs/wrappers.py DomainRandomizationVmapWrapper)
# on the flagship rodent env on its stand-in (RODENT_ARGV): train() at
# train_rodent's widths (PPO_ARGS: 2048 envs, batch 2048, unroll 16, 128
# eval envs, MLPs 256 x 256, cut as the PPO phase is) three times from the
# same seed, the counts set to 0 just before each: without a
# randomization_fn, with every RAND_LEAVES leaf batched at the shared
# values (bitwise the first run: params, normalizer, eval reward), and
# with each env's leaves scaled by its own draw in 1 +- RAND_SPREAD; each
# exactly ppo_expected_launches. Then the scaled model's first control step
# of N_CPU_ENVS envs against the CPU in float64 with those envs' values.
# A CPU float32 rehearsal (randomized_first_step_gaps with a float32 CPU
# env of 16 envs, 8 compared, seeds 0-2) is off float64 by at most 1.75e-6
# (obs), 1.87e-6 (reward) and 9.73e-6 (sensordata); the limits leave ~35x.
RAND_LEAVES = ("body_mass", "body_inertia", "dof_armature", "jnt_stiffness", "geom_size",
               "actuator_gainprm", "actuator_biasprm", "opt.gravity", "pairs.solref")
RAND_SPREAD = 0.1
# the solve kernel with a per-env armature: the one-warp (a) and the wide
# layout 1 with the damped tail
ARMATURE_MODELS = ("minirat", "rodent_standin")
RAND_STEP_ATOL = {"obs": 6.1e-5, "reward": 6.5e-5, "sensordata": 3.4e-4}
# ROADMAP A.12's narrowphase on two scenes that between them hold every one
# of the 20 box, cylinder, mesh and height-field pair types: the rodent
# stand-in on a terrain (assets/rodent_standin_terrain.xml, frozen as
# rodent.yaml freezes the stand-in: its limbs on a height field, a box step,
# a cylinder and two convex mesh rocks from the first substep; 75 contact
# slots, 367 rows, the wide layout 1, damped) and the props
# (assets/props.xml: 8 free props on a plane, a height field and each
# other; 72 slots, 288 rows, the wide layout 1 with 8 roots).
TERRAIN_ARGV = ["train=train_rodent", "dataset=rodent",
                "dataset.env_args.mjcf_path=builtin:rodent_standin_terrain.xml"]
TERRAIN_STEPS = 10
PROPS_SUBSTEPS = 10
# The terrain rollout's first control step against the CPU in float64, with
# the solve run to convergence on both sides (phase_converged_first_step,
# as the fly's). The limbs start 2.5-3.5 mm inside the terrain and the
# convex pairs' contact point jumps with the normal, which float32 resolves
# to ~1e-2 rad, so the step is chaotic: one float64 run moves by ~1e-3 when
# its qposes move by 1e-15 of themselves, and a CPU float32 rehearsal (8
# envs, seeds 0-2) is off float64 by up to 5.35 (obs), 1.05 (reward) and
# 6.92 (sensordata) at CG 4/4 (printed, not gated) and 0.520, 0.0483 and
# 1.57 converged. The limits leave 3x the converged rehearsal: a gate on
# gross faults (a pair type or a sign wrong moves these by 10-100), not on
# rounding.
TERRAIN_STEP_ATOL = {"obs": 1.6, "reward": 0.15, "sensordata": 4.7}
PAIR_GATE_SCENES = ("rodent_standin_terrain", "props")
GEOM_NAMES = ("plane", "hfield", "sphere", "capsule", "ellipsoid", "cylinder", "box", "mesh")
# each pair type's slots on the card (float32, B_MAIN seeded poses: the
# terrain stand-in's hinges turned and its root moved in z, the props
# anywhere in their cluster) against the port's CPU float64 on the same
# poses: dist, pos and the normal within the limit plus twice the float64
# run's own spread (its runs again on the qposes scaled by 1 +- PAIR_SPREAD,
# float32's rounding of a pose: the convex pairs' normal and pos jump
# where a support witness changes vertex), and the active set (dist <
# margin) equal wherever the float64 dist lies farther from the margin than
# PAIR_ACTIVE_BAND plus twice its spread.
# The limits leave ~35x over the larger of a CPU float32 rehearsal
# (pair_gaps("cpu", scene, 512, seed), seeds 0-2, both scenes) and the
# card's first runs (B_MAIN, seeds 0-1), past twice the spread: dist 2.7e-7
# (plane-cylinder); pos 3.8e-7 and the normal 3.1e-6 (box-box, sphere-box).
# Closer to float32's resolution: a capsule end just off a box face (the
# exit direction of a tiny offset: pos 1.8e-6, normal 1.1e-3 on the card),
# and the height field's closest triangle near ties on its concave folds
# (hfield-sphere pos 1.2e-5, normal 9.5e-4; hfield-capsule 3.5e-5, 3.5e-3).
# Capsule-cylinder's deepest segment point is not unique where the distance
# is flat along the segment (its normal moved by 1.0 on the card at a dist
# 3e-7 off): its pos and normal are held by ``self`` instead, the sphere
# centre the card's contact implies against the capsule's segment and the
# cylinder in float64 (rehearsal 3.4e-7).
PAIR_SPREAD = 1e-6
PAIR_ACTIVE_BAND = 1e-5
PAIR_GATE_LIMITS = {"dist": 1e-5, "pos": 1.3e-5, "normal": 1.1e-4}
PAIR_GATE_TYPE_LIMITS = {"capsule-box": {"pos": 6.4e-5, "normal": 3.7e-2},
                         "capsule-cylinder": {"self": 1.2e-5},
                         "hfield-sphere": {"pos": 4.2e-4, "normal": 3.3e-2},
                         "hfield-capsule": {"pos": 1.2e-3, "normal": 1.24e-1}}
# A duplicate test at 1e-9 cannot hold in float32 (capsule-box's second
# end at the first's closest point, box-box's reference corners at a
# clamped incident corner): a candidate off on one side and live on the
# other must repeat another slot of its pair live on that side (pos within
# PAIR_DUP_POS, dist within PAIR_GATE_LIMITS["dist"]).
PAIR_DUP_POS = 5.6e-6
# box-box's face manifold also keeps or drops a candidate by tests at 1e-7
# and 1e-6 (a clamped incident corner inside the reference face, a reference
# corner inside the incident face), which float32 can tip: the rehearsal
# tipped 1 of 12,288 box-box candidates, the card 1 of 16,384 (no other
# type's); the gate allows 35x that share of a type's candidates to switch.
PAIR_SWITCHED_SHARE = {"box-box": 2.9e-3}
# The ten convex pair types: the card's dist against the gap at its own
# normal evaluated in float64 (``self``; rehearsal and the card 1.7e-7,
# 35x) and the shortfall of that gap from the float64 run's dist
# (``dual``: the ascent's resolution, not float32's: rehearsal 1.8e-3,
# ellipsoid-box, the card 8.1e-4; ~3x); the active set outside CONVEX_DUAL
# of the margin.
CONVEX_TYPES = ("ellipsoid-cylinder", "ellipsoid-box", "cylinder-cylinder", "cylinder-box",
                "sphere-mesh", "capsule-mesh", "ellipsoid-mesh", "cylinder-mesh", "box-mesh",
                "mesh-mesh")
CONVEX_SELF = 6e-6
CONVEX_DUAL = 5e-3
# ballmuscle slice: 20 substeps of 2048 envs per solver; its first substep
# of 8 envs on the card (float32) against the CPU (float64). A CPU float32
# rehearsal of that substep (64 envs, both solvers) is off float64 by
# 2.6e-7 (qpos), 2.6e-4 (qvel) and 3.8e-8 (act): qacc (~1e4) moves by
# ~0.35 in float32 through qM's condition number (up to 7.5e3), and one
# substep scales that by dt = 2e-3. BM_STEP_ATOL leaves ~30-40x room for
# the card's other summation order.
BM_SUBSTEPS = 20
BM_STEP_ATOL = {"qpos": 1e-5, "qvel": 1e-2, "act": 1e-6}

# Newton minirat (Newton/100 on the kernel layout, chunks of the solve
# kernel): NEWTON_SUBSTEPS substeps of 2048 envs from seeded contact states;
# its first substep of 8 envs on the card (float32) against the CPU
# (float64). A CPU float32 rehearsal of that substep (64 envs, 9 chunks) is
# off float64 by 6.9e-8 (qpos) and 2.4e-5 (qvel); the limits leave ~30-40x.
NEWTON_SUBSTEPS = 20
NEWTON_STEP_ATOL = {"qpos": 2e-6, "qvel": 1e-3}
# elliptic minirat at contact states (random_states with faster joints),
# card (float32) against the CPU (float64): the rollouts' first control step
# is a fall that touches no floor, so this is where the card's elliptic rows
# meet float64. One substep of B_MAIN envs on the card (one cg_solve_fused
# launch, no other kernel), with the solve converged (CONVERGED_ITERS CG
# iterations, ELL_LS_ITERS line-search steps: at the file's 4/4 a float32
# substep of these states is off float64 by up to 0.8 in qvel, rounding
# inside the iteration), against the same substep of the first ELL_ROW_ENVS
# envs on the CPU: make_constraint's rows (efc_D, efc_aref and efc_pos over
# the active rows, each relative to its largest value there; con_A) within
# ELL_ROW_RTOL, the quadratic rows' and the elliptic contacts' activations
# equal, and qpos and qvel of the first N_CPU_ENVS envs within ELL_STEP_ATOL.
# The float64 solution must leave active elliptic contacts in each zone of
# the cone (bottom, middle, top). A CPU float32 rehearsal (seeds 0-2, 256
# envs): rows at most 1.8e-6 relative (efc_pos), no activation flipped (every
# row lies at least 4.9e-3 from its threshold); the substep of 8 envs off by
# 4.4e-6 (qpos) and 2.2e-3 (qvel); the limits leave ~34x.
ELL_ROW_ENVS = 64
ELL_LS_ITERS = 50
ELL_ROW_RTOL = 6e-5
ELL_STEP_ATOL = {"qpos": 1.5e-4, "qvel": 7.5e-2}
# smooth dynamics: float64 residual ||qM x - f|| / ||f|| of solve_m from the
# factor on 2048 minirat states (a CPU float32 rehearsal: 2.8e-7)
SMOOTH_RESIDUAL = 1e-5

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def load(model, device, dtype=None):
    """One of the port's frozen files: the minirat's (pyramidal CG 4/4, the
    main path; elliptic CG 4/4; Newton/100 with 50 line-search steps), the
    two-rat stand-in's at rodent_pair's sizes, frozen the same three ways
    ("ratpair", "ratpair_elliptic", "ratpair_newton"), one of its rats
    alone ("rat", CG 4/4: nv 73, the rodent's width), the rodent
    stand-in as configs/dataset/rodent.yaml freezes it ("rodent_standin":
    CG 4/4, rescaled by 0.9, damped, with sensors), or the fly stand-in as
    the fly configs freeze it ("fly_standin" with the free root,
    "fly_standin_tethered" without: CG 4/4, elliptic, the fluid model),
    the rodent stand-in on its terrain frozen as the rodent stand-in
    ("rodent_standin_terrain") or the props ("props", CG 4/4), the planar
    minirat on slide joints ("minirat_planar", CG 4/4), or the ball-coxa
    fly stand-in as fly_freejnt.yaml freezes it ("fly_standin_ball", CG 4/4
    off the kernel layout) and its Newton copy ("fly_standin_ball_newton")."""
    from brax_tracking_tpu_torch.physics import spec

    npz, options = {
        "minirat": (spec.MINIRAT_NPZ, {}),
        "minirat_elliptic": (spec.MINIRAT_ELLIPTIC_NPZ, {}),
        "minirat_newton": (spec.MINIRAT_NEWTON_NPZ, spec.MINIRAT_NEWTON_OPTIONS),
        "ratpair": (spec.RATPAIR_NPZ, {}),
        "ratpair_elliptic": (spec.RATPAIR_ELLIPTIC_NPZ, {}),
        "ratpair_newton": (spec.RATPAIR_NEWTON_NPZ, spec.MINIRAT_NEWTON_OPTIONS),
        "rat": (spec.RAT_NPZ, {}),
        "rodent_standin": (spec.RODENT_STANDIN_NPZ, spec.RODENT_OPTIONS),
        "fly_standin": (spec.FLY_STANDIN_NPZ, dict(free_jnt=True)),
        "fly_standin_tethered": (spec.FLY_STANDIN_TETHERED_NPZ, dict(free_jnt=False)),
        "rodent_standin_terrain": (spec.RODENT_STANDIN_TERRAIN_NPZ, spec.RODENT_OPTIONS),
        "props": (spec.PROPS_NPZ, {}),
        "minirat_planar": (spec.MINIRAT_PLANAR_NPZ, {}),
        "fly_standin_ball": (spec.FLY_STANDIN_BALL_NPZ, dict(free_jnt=True)),
        "fly_standin_ball_newton": (spec.FLY_STANDIN_BALL_NEWTON_NPZ,
                                    dict(free_jnt=True, **spec.FLY_BALL_NEWTON_OPTIONS)),
    }[model]
    return spec.load_model(npz, device=device, dtype=dtype, **options)


def random_states(m, B, seed, drop=0.01, vel=0.5):
    """Seeded states with every free root pushed into the floor (contacts)
    and the hinges perturbed, as the JAX package's fused-kernel tests build
    them (one root: the root's z and qpos[7:])."""
    from brax_tracking_tpu_torch.physics import step as pstep

    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy().astype(np.float64)[None], (B, 1))
    jt, qadr = np.asarray(m.jnt_type), np.asarray(m.jnt_qposadr)
    free = qadr[jt == 0]
    hinge = np.setdiff1d(np.arange(m.nq), (free[:, None] + np.arange(7)).ravel())
    qpos[:, free + 2] -= drop
    qpos[:, hinge] += rng.uniform(-0.05, 0.05, (B, hinge.size))
    t = lambda a: torch.as_tensor(a, dtype=m.dtype, device=m.device)
    d = pstep.make_data(m, B, device=m.device)
    return d.replace(
        qpos=t(qpos),
        qvel=t(rng.uniform(-vel, vel, (B, m.nv))),
        ctrl=t(rng.uniform(-0.3, 0.3, (B, m.nu))),
    )


def solve_case(device, model, B, seed, damped=False, iters=None):
    """The solve kernel's arguments as the solver passes them, at seeded
    float32 states of ``model``: the one cg_solve_fused call of a CG file
    (with an optional seeded damping, or ``iters`` CG iterations), or for
    a Newton file one chunk of the Newton dispatch (K = 4, 16
    line-search steps, the stall exit) warmstarted from the qacc of a
    substep run just before on the card (its launches are set back).
    Elliptic states (the elliptic files and the flies) get faster joints
    (contacts in all three cone zones)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load(model, device, torch.float32)
    elliptic = model.endswith("elliptic") or model in FLY_MODELS
    d = random_states(m, B, seed, vel=1.0 if elliptic else 0.5)
    newton = model.endswith("newton")
    if newton:
        launches = ops_cg.cg_solve_fused.launches
        d = pstep.step(m, d, device=device)
        ops_cg.cg_solve_fused.launches = launches
    d = pstep.forward_to_constraint(m, d)
    args, kw = S._kernel_args(m, d, Cn.efc_layout(m))
    args, kw = list(args), dict(kw)
    if newton:
        kw.update(iters=4, ls_iters=min(kw["ls_iters"], 16), has_damping=False,
                  stall_tol=S.STALL_TOL_F32, warmstart=d.qacc_warmstart.contiguous())
    if damped:
        rng = np.random.RandomState(seed + 100)
        args[10] = torch.as_tensor(float(m.opt.timestep) * rng.uniform(0.005, 0.02, m.nv),
                                   dtype=m.dtype, device=m.device)
        kw["has_damping"] = True
    if iters is not None:
        kw["iters"] = iters
    return m, [a.contiguous() for a in args], kw


def dense_case(args, kw):
    """cg_solve_batched's arguments from cg_solve_fused's: qM and J
    assembled densely by the plain version."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0])
    qM, J = ops_cg.assemble_qM_J(f, cdof, Bm, jsign, md, arm, row_slot=kw["row_slot"],
                                 sz=kw["sz"], root_bounds=kw["root_bounds"],
                                 limit_dadr=kw["limit_dadr"])
    keep = ("iters", "ls_iters", "tol", "dt", "has_damping", "ell0", "ell_mu", "ell_scale",
            "warmstart", "stall_tol")
    return ([t.contiguous() for t in (qM, J, D, aref, exists, econ, qfs, qvel, damp)],
            {k: v for k, v in kw.items() if k in keep})


def rodent_like_case(device, B, seed, iters=None, size=None):
    """cg_solve_batched's arguments (float32) and keywords for a seeded
    dense problem at a rodent-like size (RODENT_LIKE, or ``size``, one of
    seeded_dense()'s): qM = Q diag(lam) Q^T
    with lam log-uniform in [1, SPD_COND]; the first nlim rows of J one-hot
    +-1 at distinct dofs (scalar limits), the others with half their dofs in
    the support, N(0, 2 / nv) there; D in [0.5, 2]; aref = J qacc_smooth
    plus noise of the same spread, so that about half of the rows start
    active; 5% of the rows absent. CG 4/4 as the minirat (or ``iters``),
    tolerance 1e-8 x mean diag(qM) x nv (MuJoCo's scaling), undamped."""
    size = size or RODENT_LIKE
    nv, nefc, nlim = size["nv"], size["nefc"], size["nlim"]
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=g, device=device, dtype=torch.float64)
    Q, _ = torch.linalg.qr(torch.randn(B, nv, nv, **f64))
    lam = SPD_COND ** torch.rand(B, nv, **f64)
    qM = (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    qM = 0.5 * (qM + qM.transpose(-1, -2))
    a0 = torch.randn(B, nv, **f64)
    J = torch.randn(B, nefc, nv, **f64) * (torch.rand(B, nefc, nv, **f64) < 0.5) * (2.0 / nv) ** 0.5
    dadr = torch.randperm(nv, generator=g, device=device)[:nlim]
    J[:, :nlim] = 0.0
    J[:, torch.arange(nlim, device=device), dadr] = 1.0 - 2.0 * (torch.rand(B, nlim, **f64) < 0.5).double()
    jar0 = (J @ a0[..., None])[..., 0]
    aref = jar0 + jar0.std(-1, keepdim=True) * torch.randn(B, nefc, **f64)
    D = 0.5 + 1.5 * torch.rand(B, nefc, **f64)
    exists = torch.rand(B, nefc, **f64) > 0.05
    qfs = (qM @ a0[..., None])[..., 0]
    qvel = torch.randn(B, nv, **f64)
    tol = 1e-8 * float(qM.diagonal(dim1=-2, dim2=-1).mean()) * nv
    f32 = lambda t: t.float().contiguous()
    args = [f32(qM), f32(J), f32(D), f32(aref), exists.contiguous(),
            torch.zeros(B, 0, dtype=torch.bool, device=device), f32(qfs), f32(qvel),
            torch.zeros(nv, device=device)]
    kw = {"iters": 4 if iters is None else iters, "ls_iters": 4, "tol": tol, "dt": 0.002,
          "has_damping": False, "ell0": 0, "ell_mu": (), "ell_scale": (), "stall_tol": 0.0}
    return args, kw


def l2_edges(nefc=PAIR_ROWS):
    """At ``nefc`` rows (no elliptic block, no fused staging): the widest nv
    in layout 1, the first past it and the widest in layout 2
    (ops/cg.py::kernel_layout)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    def layout(nv):
        try:
            return ops_cg.kernel_layout(nv, nefc)[0]
        except NotImplementedError:
            return 3

    nvs = range(1, 512)
    last1 = max(nv for nv in nvs if layout(nv) == 1)
    last2 = max(nv for nv in nvs if layout(nv) == 2)
    return last1, last1 + 1, last2


def wide_edges(nefc=PAIR_ROWS):
    """At ``nefc`` rows (no elliptic block, no fused staging): the widest nv
    that runs on one warp and the first on the wide core
    (ops/cg.py::kernel_layout)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    nv = 1
    while ops_cg.kernel_layout(nv + 1, nefc)[2] == 1:
        nv += 1
    return nv, nv + 1


# dense one-warp cases past nv 16 (nv, rows): the one-warp core's panel
# sweep at every odd width of its last 8-pivot panel (1, 3, 5, 7) and a full
# one, at the pair's rows and, wider, at 128 rows (ONE_WARP_DENSE)
ONE_WARP_DENSE = ((17, PAIR_ROWS), (19, PAIR_ROWS), (21, PAIR_ROWS), (33, 128), (47, 128),
                  (61, 128), (64, 128))


def seeded_dense():
    """The seeded dense cases of cg_solve_batched by name: RODENT_LIKE,
    PAIR_LIKE, at the pair's rows the one-warp / wide edge and layout 2's
    design edges, and ONE_WARP_DENSE as "one_warp_<nv>"."""
    last1, first2, last2 = l2_edges()
    narrow, wide = wide_edges()
    edge = lambda nv, nefc=PAIR_ROWS: {"nv": nv, "nefc": nefc, "nlim": 4}
    return {"rodent_like": RODENT_LIKE, "pair_like": PAIR_LIKE, "narrow_last": edge(narrow),
            "wide_first": edge(wide), "l1_last": edge(last1), "l2_first": edge(first2),
            "l2_last": edge(last2)} | {f"one_warp_{nv}": edge(nv, nefc)
                                       for nv, nefc in ONE_WARP_DENSE}


def cast(args, dtype):
    return [a.to(dtype) if a.is_floating_point() else a for a in args]


def cast_kw(kw, dtype):
    return {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}


def outputs(out):
    return dict(zip(("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new", "done"), out))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _errors(out, ref):
    """Max abs error, and the median, 99th percentile and count above
    TAIL_REL of the per-env relative error (max abs error of the env over
    the env's max abs value)."""
    e = (out.double() - ref).abs().reshape(ref.shape[0], -1)
    scale = ref.abs().reshape(ref.shape[0], -1).amax(-1).clamp(min=1e-30)
    rel = e.amax(-1) / scale
    return {"max": float(e.max()), "median_rel": float(rel.median()),
            "p99_rel": float(torch.quantile(rel, 0.99)),
            "n_above_tail": int((rel > TAIL_REL).sum())}


def armature_draw(armature, B, seed):
    """A seeded per-env armature (B, nv): the model's scaled per env by
    U(0.5, 1.5), the draws of a randomization_fn."""
    g = torch.Generator(device=armature.device).manual_seed(seed + 200)
    scale = 0.5 + torch.rand(B, 1, generator=g, device=armature.device, dtype=armature.dtype)
    return (armature * scale).contiguous()


def phase_kernel_vs_plain(device, B, damped, seed, iters=None, model="minirat",
                          batched=False, per_env_armature=False):
    """Kernel and float32 plain version against a float64 plain run on the
    same inputs (the solve at state ``seed`` of ``model``, see solve_case;
    ``iters`` overrides the CG iteration count; ``batched`` runs
    cg_solve_batched on the dense qM and J of the same call; a ``model``
    named in seeded_dense(), e.g. "rodent_like", runs cg_solve_batched on
    rodent_like_case at that size; ``per_env_armature`` gives every env its
    own armature, armature_draw). Returns the error report and (model,
    args, kw, kernel outputs)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    kernel, plain_fn = ops_cg.cg_solve_fused, ops_cg.cg_solve_fused_reference
    dense = seeded_dense()
    if model in dense:
        m, (args, kw) = None, rodent_like_case(device, B, seed, iters, dense[model])
    else:
        m, args, kw = solve_case(device, model, B, seed, damped, iters)
        if per_env_armature:
            args[13] = armature_draw(args[13], B, seed)
        if batched:
            args, kw = dense_case(args, kw)
    if batched or m is None:
        kernel, plain_fn = ops_cg.cg_solve_batched, ops_cg.cg_solve_batched_reference
    ref = outputs(plain_fn(*cast(args, torch.float64), **cast_kw(kw, torch.float64)))
    plain = outputs(plain_fn(*args, **kw))
    launches = kernel.launches
    kern = outputs(kernel(*args, device=device, **kw))
    kernel.launches = launches  # comparison launches do not count
    if device == "cuda":
        torch.cuda.synchronize()

    damped = kw["has_damping"]  # seeded, or the model's own joint damping
    case = (f"{kernel.__name__}, {model}, B={B}, damped={damped}, iters={kw['iters']}, "
            f"warmstart={'warmstart' in kw}, per-env armature={per_env_armature}")
    report = {"kernel": kernel.__name__, "model": model, "B": B, "damped": damped,
              "iters": kw["iters"], "warmstart": "warmstart" in kw,
              "per_env_armature": per_env_armature}
    for name in ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new"):
        ek, ep = _errors(kern[name], ref[name]), _errors(plain[name], ref[name])
        report[name] = {"scale": float(ref[name].abs().max()),
                        **{f"kernel_{k}": v for k, v in ek.items()},
                        **{f"plain_{k}": v for k, v in ep.items()},
                        "finite": bool(torch.isfinite(kern[name]).all())}
    report["done_frac"] = {k: float(o["done"].float().mean()) for k, o in
                           (("kernel", kern), ("plain32", plain), ("plain64", ref))}
    report["done_mismatch"] = {
        "kernel_vs_plain32": int((kern["done"] != plain["done"]).sum()),
        "kernel_vs_plain64": int((kern["done"] != ref["done"]).sum()),
        "plain32_vs_plain64": int((plain["done"] != ref["done"]).sum()),
    }
    print("kernel_vs_plain " + json.dumps(report))

    for name in ("qacc", "efc_force", "qfrc_constraint", "qacc_smooth", "qvel_new"):
        r = report[name]
        if not r["finite"]:
            fail(f"kernel {name} not finite ({case})")
        if name not in SCORED:
            continue
        ek, ep, mk, mp, scale = (r[k] for k in ("kernel_max", "plain_max",
                                                "kernel_median_rel", "plain_median_rel", "scale"))
        if ek > KERNEL_FACTOR * ep + FLOOR_REL * scale:
            fail(f"kernel {name} max error {ek:.3e} > {KERNEL_FACTOR} x plain "
                 f"{ep:.3e} + {FLOOR_REL} x {scale:.3e} ({case})")
        if mk > KERNEL_FACTOR * mp + FLOOR_REL:
            fail(f"kernel {name} median relative error {mk:.3e} > {KERNEL_FACTOR} x "
                 f"plain {mp:.3e} ({case})")
        if iters is None:
            continue
        if mk > CONVERGED_MEDIAN:
            fail(f"converged kernel {name} median relative error {mk:.3e} > "
                 f"{CONVERGED_MEDIAN} ({case})")
        n_kern, n_plain = r["kernel_n_above_tail"], r["plain_n_above_tail"]
        if n_kern > TAIL_FACTOR * n_plain + TAIL_ENVS:
            fail(f"converged kernel {name}: {n_kern} envs above {TAIL_REL} relative "
                 f"error, > {TAIL_FACTOR} x plain {n_plain} + {TAIL_ENVS} ({case})")
        if r["kernel_p99_rel"] > TAIL_FACTOR * r["plain_p99_rel"] + FLOOR_REL:
            fail(f"converged kernel {name} 99th percentile relative error "
                 f"{r['kernel_p99_rel']:.3e} > {TAIL_FACTOR} x plain "
                 f"{r['plain_p99_rel']:.3e} ({case})")
    dm = report["done_mismatch"]
    if dm["kernel_vs_plain64"] > KERNEL_FACTOR * dm["plain32_vs_plain64"] + DONE_MISMATCH_MAX * B:
        fail(f"done flags: {dm} ({case})")
    return report, (m, args, kw, kern)


def phase_wide_vs_one_warp(device, B, model, damped=False):
    """The wide core against the one-warp core on the same inputs: the
    solve of ``model`` (see phase_kernel_vs_plain; ``damped`` adds a seeded
    damping, a damped model brings its own) launched once as
    kernel_layout dispatches it and once with the other core forced
    (ops/cg.py::WIDE_ABOVE_SMEM raised past a wide env, or 0 for a one-warp
    env such as the fly stand-in's; the env must fit layout 1). The wide
    core forms every value by the one-warp core's operations in its order
    (csrc/cg_fused.cu; past nv 16 both sweep M^-1 in sweep.cuh's 8-pivot
    panels), so at nv > 16 every output must be bitwise equal, the damped
    Euler tail's qvel_new included. Returns the number of envs compared and
    whether the solve was damped."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    dense = seeded_dense()
    if model in dense:
        (args, kw), batched = rodent_like_case(device, B, SEED, None, dense[model]), True
    else:
        (_, args, kw), batched = solve_case(device, model, B, SEED, damped), False
    nv = args[0].shape[-1]
    layout, _, warps = (ops_cg.kernel_layout(nv, args[1].shape[1]) if batched else
                        ops_cg.kernel_layout(nv, args[4].shape[1], args[7].shape[1],
                                             len(kw["root_bounds"]), args[12].shape[0]))
    if nv <= 16 or layout != 1:
        fail(f"wide against one-warp: {model} (nv={nv}) is not a layout-1 env past nv 16")
    ruled = kernel_launch(args, kw, batched)()
    above = ops_cg.WIDE_ABOVE_SMEM
    ops_cg.WIDE_ABOVE_SMEM = ops_cg.H100_SMEM_PER_SM if warps > 1 else 0
    try:
        forced = kernel_launch(args, kw, batched)()
    finally:
        ops_cg.WIDE_ABOVE_SMEM = above
    wide, one = (ruled, forced) if warps > 1 else (forced, ruled)
    torch.cuda.synchronize()
    for name in wide:
        if not torch.equal(wide[name], one[name]):
            diff = (wide[name].double() - one[name].double()).abs().max()
            fail(f"wide core against the one-warp core on {model} (B={B}, damped="
                 f"{kw['has_damping']}): {name} differs by up to {float(diff):.3e}, expected "
                 f"bitwise equal")
    return B, kw["has_damping"]


def synth_clip_qpos(qpos0, T=128, walk=0.1):
    """bench.py's synthetic clip: qpos0, lifted 1 cm, walking along x."""
    qpos = np.tile(np.asarray(qpos0, np.float64), (T, 1))
    qpos[:, 2] += 0.01
    qpos[:, 0] += np.linspace(0.0, walk, T)
    return qpos


def tracking_env(device, dtype=None, model="minirat"):
    """The tracking env of a CG minirat file (``minirat`` or
    ``minirat_elliptic``), unwrapped."""
    from brax_tracking_tpu_torch.data import clips
    from brax_tracking_tpu_torch.envs import tracking

    m = load(model, device, dtype)
    clip = clips.process_clip(m, torch.as_tensor(synth_clip_qpos(m.qpos0.cpu().numpy())))
    return tracking.GenericSingleClip(
        reference_clip=clip,
        mjcf_path=f"builtin:{model}.xml",
        device=device,
        dtype=dtype,
        physics_steps_per_control_step=N_SUBSTEPS,
        center_of_mass="torso",
        end_eff_names=["leg_FL", "leg_FR", "leg_BL", "leg_BR"],
        body_names=["torso", "leg_FL", "leg_FR", "leg_BL", "leg_BR"],
        joint_names=["hip_FL", "hip_FR", "hip_BL", "hip_BR"],
        healthy_z_range=(0.02, 0.5),
        pos_reward_weight=1.0,
        strict_name_lookup=True,
    )


# the envs chip_smoke.py builds from a config as the driver does: the
# rodent_pair env on the two-rat stand-in, the flagship rodent env on the
# rodent stand-in and on its terrain, the two fly envs on the fly stand-in
CONFIG_ENVS = {"ratpair": PAIR_ARGV, "rodent_standin": RODENT_ARGV,
               "rodent_standin_terrain": TERRAIN_ARGV, **FLY_ARGVS,
               "fly_standin_ball": FLY_BALL_ARGV}


def config_env(device, dtype, model):
    """The env of CONFIG_ENVS[model], unwrapped, made by harness/driver.py's
    build_env_from_cfg; its clip (synthetic, or the fly's from the committed
    stac export) is built through the frozen model and cached in a temporary
    data_dir (the committed data/RodentPair and data/Rodent clips are of
    the real models, not of the stand-ins)."""
    import tempfile

    from brax_tracking_tpu_torch.harness import config as hc
    from brax_tracking_tpu_torch.harness import driver

    with tempfile.TemporaryDirectory() as tmp:
        cfg = hc.load_config(CONFIG_ENVS[model] + [f"paths.data_dir={tmp}"])
        return driver.build_env_from_cfg(cfg, device, dtype)


def make_env(device, dtype=None, model="minirat"):
    """tracking_env, or config_env for a model of CONFIG_ENVS, under the
    training wrappers."""
    from brax_tracking_tpu_torch.envs import wrappers

    build = config_env if model in CONFIG_ENVS else tracking_env
    return wrappers.wrap(build(device, dtype, model), episode_length=1000)


def pose_balls(m, d, seed):
    """``d``'s qpos and qvel with every ball joint of ``m`` turned about the
    world's vertical through it by an angle uniform in +-BALL_POSE_ANGLES
    and turning further at a rate uniform in BALL_POSE_SPEEDS, per env."""
    from brax_tracking_tpu_torch.physics import kinematics as K

    xquat = K.kinematics(m, d).xquat
    g = torch.Generator(device=d.qpos.device).manual_seed(seed)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    B, dt = qpos.shape[0], qpos.dtype
    ball = np.nonzero(np.asarray(m.jnt_type) == 1)[0]
    for j in ball:
        body, adr, dof = (int(np.asarray(f)[j]) for f in (m.jnt_bodyid, m.jnt_qposadr,
                                                          m.jnt_dofadr))
        w, u = xquat[:, body, :1], -xquat[:, body, 1:]  # the body's world rotation, inverted
        up = torch.zeros(B, 3, device=qpos.device, dtype=dt)
        up[:, 2] = 1.0
        t = 2.0 * torch.cross(u, up, dim=-1)
        axis = up + w * t + torch.cross(u, t, dim=-1)  # world vertical in the joint's frame
        axis = axis / axis.norm(dim=-1, keepdim=True)
        r = torch.rand(B, 3, generator=g, device=qpos.device, dtype=dt)
        axis = axis * (2.0 * (r[:, :1] < 0.5) - 1.0)
        half = 0.5 * (BALL_POSE_ANGLES[0] + (BALL_POSE_ANGLES[1] - BALL_POSE_ANGLES[0]) * r[:, 1:2])
        qpos[:, adr:adr + 4] = torch.cat([half.cos(), axis * half.sin()], -1)
        qvel[:, dof:dof + 3] = axis * (
            BALL_POSE_SPEEDS[0] + (BALL_POSE_SPEEDS[1] - BALL_POSE_SPEEDS[0]) * r[:, 2:])
    return qpos, qvel


def ball_limit_share(m, d):
    """The share of envs of ``d`` with one of ``m``'s ball-limit rows
    instantiated (efc_pos below its margin) in the forward that computed
    ``d``."""
    from brax_tracking_tpu_torch.physics import constraint as Cn

    rows = torch.as_tensor(Cn.efc_layout(m).limit_ball_rows, device=d.efc_pos.device)
    return float((d.efc_pos[:, rows] < d.efc_margin[:, rows]).any(-1).float().mean())


def phase_rollout(device, B, seed, model="minirat", n_steps=N_STEPS):
    """Reset + ``n_steps`` control steps of B envs; returns the launch counts of
    the steps (every kernel, set to 0 just before), the first step's inputs
    and outputs, the final state and the share of envs with contact forces
    at the last step (which must reach ROLLOUT_MIN_CONTACT)."""
    from brax_tracking_tpu_torch.physics import constraint as Cn

    env = make_env(device, model=model)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = env.reset(gen, B)
    actions = [
        2.0 * torch.rand(B, env.action_size, generator=gen, device=device) - 1.0
        for _ in range(n_steps)
    ]
    first_in = state
    reset_counts()
    states = []
    for a in actions:
        state = env.step(state, a)
        states.append(state)
    launches = read_counts()
    for s in states:
        if not (torch.isfinite(s.obs).all() and torch.isfinite(s.reward).all()):
            fail(f"{model} rollout obs or reward not finite")
        if not torch.isfinite(s.pipeline_state.sensordata).all():
            fail(f"{model} rollout sensordata not finite")
    contact_rows = torch.as_tensor(Cn.efc_layout(env.unwrapped.model).row_con >= 0,
                                   device=state.obs.device)
    touching = float((state.pipeline_state.efc_force[:, contact_rows] != 0).any(-1).float().mean())
    if touching < ROLLOUT_MIN_CONTACT:
        fail(f"{model} rollout: contact forces in {touching:.3f} of the envs at the last "
             f"step, expected >= {ROLLOUT_MIN_CONTACT}")
    return env, launches, first_in, actions[0], states[0], state, touching


def phase_first_step_on_cpu(first_in, action, first_out, n, model="minirat"):
    """The first control step of ``n`` envs run again by the port on the CPU
    in float64; returns the max obs and reward gaps."""
    gaps = first_step_gaps(first_in, action, first_out, n, model)
    atol = {"ratpair": PAIR_STEP_ATOL, "rodent_standin": RODENT_STEP_ATOL}.get(
        model) or dict.fromkeys(("obs", "reward"), STEP_ATOL[model])
    if any(gaps[k] > atol[k] for k in atol) or gaps["done_mismatch"]:
        fail(f"{model}: first control step on the card differs from the CPU float64 "
             f"run: {gaps} (limits {atol})")
    return gaps


def phase_converged_first_step(env, first_in, action, model, atol):
    """A first control step with the solve run to convergence
    (``converged``): ``env``'s (the rollout's, its model swapped for the
    step) from the rollout's first state and action, against the same step
    of N_CPU_ENVS envs run by the port on the CPU in float64; returns the
    gaps, gated by ``atol`` (FLY_STEP_ATOL, TERRAIN_STEP_ATOL)."""
    inner = env.unwrapped
    own = inner._model
    inner._model = converged(own)
    try:
        out = env.step(first_in, action)
    finally:
        inner._model = own
    gaps = first_step_gaps(first_in, action, out, N_CPU_ENVS, model, solve=converged)
    if any(gaps[k] > atol[k] for k in atol) or gaps["done_mismatch"]:
        fail(f"{model}: first control step (converged) on the card differs from the CPU "
             f"float64 run: {gaps} (limits {atol})")
    return gaps


def first_step_gaps(first_in, action, first_out, n, model="minirat", solve=None):
    """The gaps of phase_first_step_on_cpu, ungated (the CPU float32
    rehearsal of a limit passes a float32 CPU run as the card's); ``solve``
    maps the CPU env's model first (phase_converged_first_step's converged)."""
    env = make_env("cpu", model=model)
    if solve is not None:
        env.unwrapped._model = solve(env.unwrapped.model)
    d = first_in.pipeline_state
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    s = env.init_state(first_in.info["cur_frame"][:n].cpu(), cpu(d.qpos), cpu(d.qvel))
    s = env.step(s, cpu(action))
    sensed = (s.pipeline_state.sensordata - cpu(first_out.pipeline_state.sensordata)).abs()
    return {
        "obs": float((s.obs - cpu(first_out.obs)).abs().max()),
        "reward": float((s.reward - cpu(first_out.reward)).abs().max()),
        "sensordata": float(sensed.max()) if sensed.numel() else 0.0,
        "done_mismatch": int((s.done != cpu(first_out.done)).sum()),
    }


def converged(m):
    """The model with its solve run to convergence: CONVERGED_ITERS CG
    iterations, ELL_LS_ITERS line-search steps (a fresh cache: the solve
    statics hold the counts)."""
    import dataclasses

    opt = dataclasses.replace(m.opt, iterations=CONVERGED_ITERS, ls_iterations=ELL_LS_ITERS)
    return dataclasses.replace(m, opt=opt, cache={})


def ell_zones(m, d):
    """(bottom, middle, top) counts of the active elliptic contacts at the
    solution d.qacc of the substep whose forward fields ``d`` holds."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S

    args, kw = S._kernel_args(m, d, Cn.efc_layout(m))
    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0])
    _, J = ops_cg.assemble_qM_J(f, cdof, Bm, jsign, md, arm, row_slot=kw["row_slot"],
                                sz=kw["sz"], root_bounds=kw["root_bounds"],
                                limit_dadr=kw["limit_dadr"])
    jar = (J @ d.qacc[..., None])[..., 0] - aref
    nell, ell0 = len(kw["ell_mu"]), kw["ell0"]
    je = jar[:, ell0 : ell0 + 3 * nell].reshape(-1, nell, 3)
    mu = torch.as_tensor(kw["ell_mu"], dtype=jar.dtype)
    sc = torch.as_tensor(kw["ell_scale"], dtype=jar.dtype)
    n, t = je[..., 0], (je[..., 1:] * sc).norm(dim=-1)
    bottom = econ & (mu * n + t <= 0)
    middle = econ & ~bottom & (n < mu * t)
    return int(bottom.sum()), int(middle.sum()), int((econ & ~bottom & ~middle).sum())


def phase_elliptic_contacts(device, B, seed):
    """One converged substep of B elliptic-minirat envs at seeded contact
    states on ``device`` (float32) against the first ELL_ROW_ENVS of them on
    the CPU in float64 (see ELL_ROW_RTOL); on the card it must launch
    cg_solve_fused once and nothing else. Returns the gaps, the zone counts
    and the launch counts."""
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    m = converged(load("minirat_elliptic", device, torch.float32))
    d = random_states(m, B, seed, vel=1.0)
    reset_counts()
    out = pstep.step(m, d, device=device)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": 1}
    if device == "cuda" and counts != expected:
        fail(f"minirat_elliptic contact substep launches {counts}, expected {expected}")
    if not all(bool(torch.isfinite(getattr(out, k)).all()) for k in ("qpos", "qvel")):
        fail("minirat_elliptic contact substep: state not finite")

    m64 = converged(load("minirat_elliptic", "cpu"))
    n = ELL_ROW_ENVS
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64 if t.is_floating_point() else t.dtype)
    d64 = pstep.make_data(m64, n, device="cpu").replace(
        **{k: cpu(getattr(d, k)) for k in ("qpos", "qvel", "ctrl")})
    ref = pstep.step(m64, d64, device="cpu")
    active = ref.efc_pos < ref.efc_margin
    gaps = {}
    for k in ("efc_D", "efc_aref", "efc_pos"):
        r = getattr(ref, k)[active]
        gaps[k] = float((cpu(getattr(out, k))[active] - r).abs().max() / r.abs().max())
    gaps["con_A"] = float((cpu(out.con_A) - ref.con_A).abs().max() / ref.con_A.abs().max())
    layout = Cn.efc_layout(m64)
    a32, _ = S._kernel_args(m, out, Cn.efc_layout(m))
    a64, _ = S._kernel_args(m64, ref, layout)
    gaps["exists_mismatch"] = int((cpu(a32[6]) != a64[6]).sum())
    gaps["exists_con_mismatch"] = int((cpu(a32[7]) != a64[7]).sum())
    for k in ELL_STEP_ATOL:
        gaps[k] = float((cpu(getattr(out, k))[:N_CPU_ENVS] - getattr(ref, k)[:N_CPU_ENVS])
                        .abs().max())
    zones = ell_zones(m64, ref)
    bad = [k for k in ("efc_D", "efc_aref", "efc_pos", "con_A") if gaps[k] > ELL_ROW_RTOL]
    bad += [k for k in ("exists_mismatch", "exists_con_mismatch") if gaps[k]]
    bad += [k for k in ELL_STEP_ATOL if gaps[k] > ELL_STEP_ATOL[k]]
    if bad:
        fail(f"minirat_elliptic contact substep on {device} differs from the CPU float64 run "
             f"in {bad}: {gaps} (limits {ELL_ROW_RTOL}, {ELL_STEP_ATOL})")
    if min(zones) == 0:
        fail(f"minirat_elliptic contact states: active elliptic contacts per zone (bottom, "
             f"middle, top) {zones}: every zone must be reached")
    return gaps, zones, counts


# ---------------------------------------------------------------------------
# the narrowphase: pair-type gates, the props rollout
# ---------------------------------------------------------------------------


def pair_type_of_slots(m):
    """The "geom-geom" name of each contact slot's pair type."""
    t = np.asarray(m.geom_type)
    slot_pair = np.repeat(np.arange(len(m.pairs.geom1)), m.pairs.npoint)
    return np.asarray([f"{GEOM_NAMES[t[m.pairs.geom1[p]]]}-{GEOM_NAMES[t[m.pairs.geom2[p]]]}"
                       for p in slot_pair])


def new_pair_types(m):
    """The pair types of ``m`` with a box, a cylinder, a mesh or a height
    field, in slot order."""
    names = pair_type_of_slots(m)
    keep = ("hfield", "box", "cylinder", "mesh")
    return list(dict.fromkeys(n for n in names if any(k in n for k in keep)))


def gate_qpos(m, scene, B, seed):
    """Seeded qposes (float64) of a pair-gate scene: the terrain stand-in at
    qpos0 with its hinges turned by up to 0.1 rad and its root moved by -5
    to +10 mm in z (limbs in, on and off the terrain), or the props anywhere
    in their cluster (assets/make_props.py::seeded_qpos)."""
    rng = np.random.RandomState(seed)
    q0 = m.qpos0.cpu().numpy().astype(np.float64)
    if scene == "props":
        from brax_tracking_tpu_torch.assets import make_props

        return make_props.seeded_qpos(q0, B, seed)
    qpos = np.tile(q0[None], (B, 1))
    qpos[:, 2] += rng.uniform(-0.005, 0.01, B)
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, m.nq - 7))
    return qpos


def narrowphase(m, qpos):
    """Kinematics and the narrowphase of ``m`` at a batch of qposes: (dist,
    pos, normal) of every slot."""
    from brax_tracking_tpu_torch.physics import collision, kinematics
    from brax_tracking_tpu_torch.physics import step as pstep

    d = pstep.make_data(m, qpos.shape[0], device=m.device).replace(
        qpos=torch.as_tensor(qpos, dtype=m.dtype, device=m.device))
    d = collision.collision(m, kinematics.kinematics(m, d))
    return d.contact_dist, d.contact_pos, d.contact_frame[..., 0, :]


def convex_at(m, qpos, kind, u):
    """The ascent's gap g(u) = u.(c2 - c1) - h1(u) - h2(-u) and contact
    point of the ``kind`` slots of ``m`` (a convex pair type) at the
    directions ``u`` (B, slots, 3), on ``m``'s device and dtype."""
    from brax_tracking_tpu_torch.physics import collision as C
    from brax_tracking_tpu_torch.physics import kinematics
    from brax_tracking_tpu_torch.physics import step as pstep

    ta, tb = (GEOM_NAMES.index(t) for t in kind.split("-"))
    slot_pair = np.repeat(np.arange(len(m.pairs.geom1)), m.pairs.npoint)
    p = slot_pair[pair_type_of_slots(m) == kind]
    ga, gb = m.idx(m.pairs.geom1[p]), m.idx(m.pairs.geom2[p])
    d = pstep.make_data(m, qpos.shape[0], device=m.device).replace(
        qpos=torch.as_tensor(qpos, dtype=m.dtype, device=m.device))
    d = kinematics.kinematics(m, d)
    verts = lambda g, t: (m.mesh_vert[m.idx(np.asarray(m.geom_meshidx)[g.cpu().numpy()])]
                          if t == 7 else None)
    c1, c2 = d.geom_xpos[:, ga], d.geom_xpos[:, gb]
    u = u.to(m.device, m.dtype)
    h1, w1 = C._support(ta, C._gmat(d, ga), m.geom_size[ga], u, verts(ga, ta))
    h2, w2 = C._support(tb, C._gmat(d, gb), m.geom_size[gb], -u, verts(gb, tb))
    return torch.sum(u * (c2 - c1), -1) - h1 - h2, 0.5 * ((c1 + w1) + (c2 + w2))


def capsule_cylinder_at(m, qpos, pos, normal, dist):
    """For the capsule-cylinder slots of ``m``: the sphere centre p = pos -
    (r + dist / 2) normal each contact implies, its distance from the
    capsule's segment, and the gap between ``dist`` and the signed distance
    from p to the cylinder less r, both computed on ``m``'s device and
    dtype at ``qpos``."""
    from brax_tracking_tpu_torch.physics import collision as C
    from brax_tracking_tpu_torch.physics import kinematics
    from brax_tracking_tpu_torch.physics import step as pstep

    slot_pair = np.repeat(np.arange(len(m.pairs.geom1)), m.pairs.npoint)
    p_ = slot_pair[pair_type_of_slots(m) == "capsule-cylinder"]
    ga, gb = m.idx(m.pairs.geom1[p_]), m.idx(m.pairs.geom2[p_])
    d = pstep.make_data(m, qpos.shape[0], device=m.device).replace(
        qpos=torch.as_tensor(qpos, dtype=m.dtype, device=m.device))
    d = kinematics.kinematics(m, d)
    r, half = m.geom_size[ga, 0], m.geom_size[ga, 1]
    centre = pos - (r + 0.5 * dist)[..., None] * normal
    on_seg = C._seg_closest(centre, d.geom_xpos[:, ga], C._gz(d, ga), half)
    off_segment = torch.linalg.norm(centre - on_seg, dim=-1)
    d0, _, _ = C._point_cylinder(C._rt(C._gmat(d, gb), centre - d.geom_xpos[:, gb]),
                                 m.geom_size[gb, 0], m.geom_size[gb, 1])
    return off_segment, (d0 - r - dist).abs()


def pair_gaps(device, scene, B, seed, dtype=torch.float32):
    """The narrowphase of ``scene`` on ``device`` in ``dtype`` at gate_qpos
    against the port's CPU float64 on the same (rounded) poses, per new pair
    type. The analytic types: the largest gap of dist, pos and normal past
    twice the float64 run's own spread (its runs on the qposes scaled by 1
    +- PAIR_SPREAD). The convex types (the support-function ascent, whose
    direction is resolved to its last angular step, 0.5 x 0.93^59 = 7e-3
    rad, and whose point is the midpoint of two support witnesses, a vertex
    that jumps with the direction): ``self``, the card's dist against the
    gap g(u) evaluated in float64 at the card's own normal u, and ``dual``,
    how far g(u) falls short of the float64 run's dist (the card's
    direction separates as well as float64's up to the ascent's
    resolution). Both: the largest raw gaps, the active slots of the
    float64 run, and the slots whose activation differs where the float64
    dist lies farther from the margin than the band (PAIR_ACTIVE_BAND plus
    twice the spread; for the convex types CONVEX_DUAL)."""
    m = load(scene, device, dtype)
    m64 = load(scene, "cpu")
    q = gate_qpos(m, scene, B, seed)
    got = [x.detach().cpu().double() for x in narrowphase(m, q)]
    q = torch.as_tensor(q, dtype=dtype).double().numpy()  # the poses the card saw
    runs = [narrowphase(m64, q * s) for s in (1.0, 1.0 + PAIR_SPREAD, 1.0 - PAIR_SPREAD)]
    want = runs[0]
    margin = m64.pairs.margin[torch.as_tensor(np.repeat(np.arange(len(m64.pairs.geom1)),
                                                        m64.pairs.npoint))]
    names = pair_type_of_slots(m64)
    slot_pair = np.repeat(np.arange(len(m64.pairs.geom1)), m64.pairs.npoint)
    out = {}
    for kind in new_pair_types(m64):
        idx = np.nonzero(names == kind)[0]
        cols = torch.as_tensor(idx)
        convex = kind in CONVEX_TYPES
        # capsule-cylinder's deepest segment point is not unique where the
        # distance is flat along the segment: its pos and normal are held by
        # the contact the card's own answer implies (``self``)
        own = convex or kind == "capsule-cylinder"
        rep = {"slots": int(cols.numel()), "convex": convex}
        off64, off = want[0][:, cols] > 1e9, got[0][:, cols] > 1e9  # switched-off candidates
        live = ~off64 & ~off
        # a candidate off on one side and live on the other: a repeat of
        # another slot of its pair live on that side (float32 cannot see a
        # duplicate at 1e-9, so either side may keep a near-repeat)
        extra = off64 != off
        dup = torch.zeros_like(extra)
        for j, c in enumerate(idx):
            for c2 in np.nonzero(slot_pair == slot_pair[c])[0]:
                if c2 == c:
                    continue
                for side, keep in ((got, ~off[:, j]), (want, ~off64[:, j])):
                    dup[:, j] |= (keep & (side[0][:, c2] < 1e9)
                                  & ((side[1][:, c] - side[1][:, c2]).abs().amax(-1) < PAIR_DUP_POS)
                                  & ((side[0][:, c] - side[0][:, c2]).abs()
                                     < PAIR_GATE_LIMITS["dist"]))
        rep["float32_duplicates"] = int((extra & dup).sum())
        rep["switched"] = int((extra & ~dup).sum())
        rep["switched_share"] = rep["switched"] / extra.numel()
        for k, field in enumerate(("dist", "pos", "normal")):
            w = want[k][:, cols]
            g = (got[k][:, cols] - w).abs()
            sp = torch.stack([(r[k][:, cols] - w).abs() for r in runs[1:]]).amax(0)
            if field != "dist":
                g, sp = g.amax(-1), sp.amax(-1)
            g = torch.where(live, g, torch.zeros_like(g))
            sp = torch.where(live, sp, torch.zeros_like(sp))
            rep[f"{field}_gap"] = float(g.max())
            if not own or field == "dist":
                rep[f"{field}_past_spread"] = float((g - 2.0 * sp).clamp(min=0).max())
        d64, dsp = want[0][:, cols], (runs[1][0][:, cols] - want[0][:, cols]).abs()
        band = PAIR_ACTIVE_BAND + 2.0 * dsp
        if convex:
            g_u, _ = convex_at(m64, q, kind, got[2][:, cols])
            rep["self"] = float(torch.where(live, (got[0][:, cols] - g_u).abs(), 0.0).max())
            rep["dual"] = float(torch.where(live, d64 - g_u, 0.0).max())
            band = CONVEX_DUAL + torch.zeros_like(d64)
        elif own:
            off_seg, gap = capsule_cylinder_at(m64, q, got[1][:, cols], got[2][:, cols],
                                               got[0][:, cols])
            rep["self"] = float(torch.where(live, torch.maximum(off_seg, gap), 0.0).max())
        act64 = d64 < margin[cols]
        act = got[0][:, cols] < margin[cols]
        clear = ((d64 - margin[cols]).abs() > band) & ~extra
        rep["active"] = int(act64.sum())
        rep["active_mismatch"] = int((clear & (act != act64)).sum())
        rep["active_mismatch_in_band"] = int((~clear & (act != act64)).sum())
        out[kind] = rep
    return out


def pair_gate_failures(kind, r):
    """What of a pair_gaps report breaks its limits."""
    if r["convex"]:
        bad = [f for f, lim in (("self", CONVEX_SELF), ("dual", CONVEX_DUAL)) if r[f] > lim]
    else:
        lim = dict(PAIR_GATE_LIMITS, **PAIR_GATE_TYPE_LIMITS.get(kind, {}))
        bad = [f for f in lim if f"{f}_past_spread" in r and r[f"{f}_past_spread"] > lim[f]]
        if "self" in r and r["self"] > lim["self"]:
            bad.append("self")
    if r["switched_share"] > PAIR_SWITCHED_SHARE.get(kind, 0.0):
        bad.append("switched")
    return bad + (["active_mismatch"] if r["active_mismatch"] else [])


def phase_pair_gates(B, seed):
    """pair_gaps on the card for both scenes, every new pair type gated
    (pair_gate_failures) and active in at least one scene; both scenes'
    reports are printed before a failure. Returns {scene: report}."""
    reports, bad = {}, []
    for scene in PAIR_GATE_SCENES:
        rep = pair_gaps("cuda", scene, B, seed)
        print(f"narrowphase_vs_cpu_f64 ({scene}, B={B}) " + json.dumps(
            {"limits": PAIR_GATE_LIMITS, "type_limits": PAIR_GATE_TYPE_LIMITS,
             "convex": {"self": CONVEX_SELF, "dual": CONVEX_DUAL}, "types": rep}))
        bad += [(scene, kind, pair_gate_failures(kind, r)) for kind, r in rep.items()
                if pair_gate_failures(kind, r)]
        reports[scene] = rep
    if bad:
        fail(f"narrowphase: the card differs from the CPU float64 run: {bad}")
    active = {}
    for rep in reports.values():
        for kind, r in rep.items():
            active[kind] = active.get(kind, 0) + r["active"]
    if len(active) != 20 or not all(active.values()):
        fail(f"the pair gates held {len(active)} new pair types, expected 20, each active "
             f"somewhere: {active}")
    return reports


def active_pair_types(m, dist):
    """{new pair type: envs with an active slot of it} at a (B, ncon) dist."""
    names = pair_type_of_slots(m)
    slot_pair = np.repeat(np.arange(len(m.pairs.geom1)), m.pairs.npoint)
    active = dist < m.pairs.margin[m.idx(slot_pair)]
    return {kind: int(active[:, m.idx(np.nonzero(names == kind)[0])].any(-1).sum())
            for kind in new_pair_types(m)}


def phase_props(device, B, seed, n=PROPS_SUBSTEPS):
    """n substeps (physics/step.py::step, CG 4/4) of B props envs from
    qpos0 with seeded velocities, the counts set to 0 just before: exactly
    one cg_solve_fused launch per substep and no other kernel (on the card),
    a finite state, the envs with an active slot of each new pair type over
    the run. Returns the counts, the active counts and the seconds."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("props", device)
    rng = np.random.RandomState(seed)
    d = pstep.make_data(m, B, device=device).replace(
        qvel=torch.as_tensor(rng.uniform(-0.5, 0.5, (B, m.nv)), dtype=m.dtype, device=device))
    seen = dict.fromkeys(new_pair_types(m), 0)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        d = pstep.step(m, d, device=device)
        for kind, k in active_pair_types(m, d.contact_dist).items():
            seen[kind] = max(seen[kind], k)
    synchronize = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: 0)
    synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": n}
    if torch.device(device).type == "cuda" and counts != expected:
        fail(f"props rollout launches {counts}, expected {expected}")
    if not (torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()):
        fail("props rollout: state not finite")
    return counts, seen, seconds


# ---------------------------------------------------------------------------
# SPD kernels and the ballmuscle slice
# ---------------------------------------------------------------------------


def phase_armature_stride(device, B, model):
    """The solve kernel with the model's (nv,) armature (stride 0) and with
    the same values repeated per env ((B, nv), stride nv): every output
    bitwise equal. Comparison launches do not count."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    _, args, kw = solve_case(device, model, B, SEED)
    launches = ops_cg.cg_solve_fused.launches
    shared = outputs(ops_cg.cg_solve_fused(*args, device=device, **kw))
    repeated = args[:13] + [args[13].expand(B, -1).contiguous()]
    per_env = outputs(ops_cg.cg_solve_fused(*repeated, device=device, **kw))
    ops_cg.cg_solve_fused.launches = launches
    differ = [k for k in shared if not torch.equal(shared[k], per_env[k])]
    if differ:
        fail(f"{model}: the solve kernel with a repeated per-env armature differs from the "
             f"shared one in {differ}")


def slide_gaps(device, B, seed, n_cpu, dtype=torch.float32, n=SLIDE_SUBSTEPS):
    """``n`` substeps of B planar-minirat envs (slide joints) on ``device``
    in ``dtype``, the counts set to 0 just before: (counts, the first
    substep's gaps of N_CPU_ENVS envs against the CPU in float64)."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_planar", device, dtype)
    d = d0 = random_states(m, B, seed)
    reset_counts()
    outs = []
    for _ in range(n):
        d = pstep.step(m, d, device=device)
        outs.append(d)
    counts = read_counts()
    for k, o in enumerate(outs):
        if not (torch.isfinite(o.qpos).all() and torch.isfinite(o.qvel).all()):
            fail(f"minirat_planar: the state is not finite at substep {k}")
    # the first substep again with the solve converged on both sides (at CG
    # 4/4 float32 is far from float64 on contact states: ROADMAP C)
    first = pstep.step(converged(m), d0, device=device)
    cpu_m = converged(load("minirat_planar", "cpu", torch.float64))
    cpu = lambda t: t[:n_cpu].detach().to("cpu", torch.float64)
    dc = pstep.make_data(cpu_m, n_cpu, device="cpu").replace(
        **{k: cpu(getattr(d0, k)) for k in ("qpos", "qvel", "ctrl")})
    dc = pstep.step(cpu_m, dc, device="cpu")
    gaps = {k: float((getattr(dc, k) - cpu(getattr(first, k))).abs().max())
            for k in SLIDE_STEP_ATOL}
    return counts, gaps


def phase_slide(device, B, seed):
    """slide_gaps on the card: exactly one solve-kernel launch per substep
    and no other kernel, the first substep within SLIDE_STEP_ATOL."""
    counts, gaps = slide_gaps(device, B, seed, N_CPU_ENVS)
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": SLIDE_SUBSTEPS}
    if counts != expected:
        fail(f"minirat_planar launches {counts}, expected {expected}")
    if any(gaps[k] > SLIDE_STEP_ATOL[k] for k in gaps):
        fail(f"minirat_planar: first substep on the card differs from the CPU float64 run: "
             f"{gaps} (limits {SLIDE_STEP_ATOL})")
    return counts, gaps


def ball_posed_gaps(device, B, seed, n_cpu, model, dtype=torch.float32):
    """BALL_POSED_SUBSTEPS[model] substeps of B ball-fly envs posed by
    pose_balls (``fly_standin_ball`` with its solve converged: the array CG
    path; ``fly_standin_ball_newton``: the array Newton path) on ``device``
    in ``dtype``, the counts set to 0 just before: (counts, the launches
    the path calls for: one spd_inverse per substep under CG, one spd_solve
    per substep for qacc_smooth and one per Newton iteration the batch ran
    under Newton; the share of envs with a ball-limit force after the first
    substep; the first substep's gaps, against the CPU in float64, of the
    first ``n_cpu`` envs with such a force)."""
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import model as M
    from brax_tracking_tpu_torch.physics import step as pstep

    def model_on(dev, dt):
        m = load(model, dev, dt)
        return m if m.opt.solver == M.SOLVER_NEWTON else converged(m)

    m = model_on(device, dtype)
    newton = m.opt.solver == M.SOLVER_NEWTON
    d = random_states(m, B, seed, vel=1.0)
    qpos, qvel = pose_balls(m, d, seed + 5)
    d = d0 = d.replace(qpos=qpos, qvel=qvel)
    reset_counts()
    outs, calls = [], 0
    for _ in range(BALL_POSED_SUBSTEPS[model]):
        d = pstep.step(m, d, device=device)
        calls += 1 + int(d.solver_niter.max()) if newton else 1
        outs.append(d)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"spd_solve" if newton else "spd_inverse": calls}
    for k, o in enumerate(outs):
        if not (torch.isfinite(o.qpos).all() and torch.isfinite(o.qvel).all()):
            fail(f"{model} (posed): the state is not finite at substep {k}")
    rows = torch.as_tensor(Cn.efc_layout(m).limit_ball_rows, device=d.qpos.device)
    hit = (outs[0].efc_force[:, rows] != 0).any(-1)
    pick = torch.nonzero(hit).flatten()[:n_cpu]
    cpu_m = model_on("cpu", torch.float64)
    cpu = lambda t: t[pick].detach().to("cpu", torch.float64)
    dc = pstep.make_data(cpu_m, pick.numel(), device="cpu").replace(
        **{k: cpu(getattr(d0, k)) for k in ("qpos", "qvel", "ctrl")})
    dc = pstep.step(cpu_m, dc, device="cpu")
    gaps = {k: float((getattr(dc, k) - cpu(getattr(outs[0], k))).abs().max())
            for k in ("qpos", "qvel")}
    return counts, expected, float(hit.float().mean()), gaps


def phase_ball_posed(device, B, seed, model):
    """ball_posed_gaps on the card: exactly the launches the path calls for
    and no other kernel, a ball-limit force in BALL_MIN_LIMIT_FORCE of the
    envs after the first substep, that substep within
    BALL_POSED_ATOL[model] on N_CPU_ENVS of those envs."""
    counts, expected, share, gaps = ball_posed_gaps(device, B, seed, N_CPU_ENVS, model)
    if counts != expected:
        fail(f"{model} (posed) launches {counts}, expected {expected}")
    if share < BALL_MIN_LIMIT_FORCE:
        fail(f"{model} (posed): ball-limit forces in {share:.4f} of the envs after the first "
             f"substep, expected >= {BALL_MIN_LIMIT_FORCE}")
    atol = BALL_POSED_ATOL[model]
    if any(gaps[k] > atol[k] for k in atol):
        fail(f"{model} (posed): first substep on the card differs from the CPU float64 run: "
             f"{gaps} (limits {atol})")
    return counts, share, gaps


def rodent_randomization(mode):
    """A randomization_fn of RAND_LEAVES: ``equal`` repeats each leaf's
    shared values per env, ``scaled`` scales each env's leaf by its own
    draw in 1 +- RAND_SPREAD from the trainer's randomization generator."""
    from brax_tracking_tpu_torch.physics import model as M

    def randomize(m, num_envs, generator):
        values = {}
        for name in RAND_LEAVES:
            x = m.leaf(name)
            shape = (num_envs,) + (1,) * x.dim()
            if mode == "equal":
                values[name] = x.expand(num_envs, *x.shape).contiguous()
                continue
            u = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)
            values[name] = x * (1.0 + RAND_SPREAD * (2.0 * u - 1.0))
        return M.replace_leaves(m, values), values.keys()

    return randomize


def randomized_first_step_gaps(device, seed, n_cpu, dtype=None, env=None, B=B_MAIN):
    """The first control step of B randomized rodent envs (``scaled``
    draws) on ``device`` against the same step of their first ``n_cpu``
    envs, with those envs' leaf values, run by the port on the CPU in
    float64; returns the gaps."""
    import functools

    from brax_tracking_tpu_torch.envs import wrappers
    from brax_tracking_tpu_torch.physics import model as M

    env = env or config_env(device, dtype, "rodent_standin")
    draws = torch.Generator(device=device).manual_seed(seed + 3)
    w = wrappers.wrap(env, episode_length=1000, randomization_fn=functools.partial(
        rodent_randomization("scaled"), num_envs=B, generator=draws))
    gen = torch.Generator(device=device).manual_seed(seed)
    first_in = w.reset(gen, B)
    action = 2.0 * torch.rand(B, w.action_size, generator=gen, device=device) - 1.0
    first_out = w.step(first_in, action)
    model_v = w.env._model_v
    cpu = lambda t: t[:n_cpu].detach().to("cpu", torch.float64)
    values = {n: cpu(model_v.leaf(n)) for n in model_v.env_leaves}
    wc = wrappers.wrap(config_env("cpu", torch.float64, "rodent_standin"), episode_length=1000,
                       randomization_fn=lambda m: (M.replace_leaves(m, values), values.keys()))
    d = first_in.pipeline_state
    s = wc.init_state(first_in.info["cur_frame"][:n_cpu].cpu(), cpu(d.qpos), cpu(d.qvel))
    s = wc.step(s, cpu(action))
    return {
        "obs": float((s.obs - cpu(first_out.obs)).abs().max()),
        "reward": float((s.reward - cpu(first_out.reward)).abs().max()),
        "sensordata": float((s.pipeline_state.sensordata
                             - cpu(first_out.pipeline_state.sensordata)).abs().max()),
        "done_mismatch": int((s.done != cpu(first_out.done)).sum()),
        "envs_apart": float((first_out.obs[0] - first_out.obs[1]).abs().max()),
    }


def phase_randomized_train(device, seed, args=None, hidden=None):
    """train() on the flagship rodent env on its stand-in three times from
    one seed (RAND_LEAVES): unrandomized, an equal-values batch and scaled
    draws, each exactly ppo_expected_launches cg_solve_fused launches (5
    substeps) and no other kernel, every metric finite; the equal-values
    run's params, normalizer and eval reward bitwise the unrandomized
    run's; then randomized_first_step_gaps within RAND_STEP_ATOL. Returns
    the runs' numbers and the gaps."""
    import functools

    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize

    args, hidden = args or PPO_ARGS, hidden or PPO_HIDDEN
    env = config_env(device, None, "rodent_standin")
    steps_per, _, _ = ppo_geometry(args)
    factory = functools.partial(pn.make_ppo_networks, policy_hidden_layer_sizes=hidden,
                                value_hidden_layer_sizes=hidden)
    expected = ppo_expected_launches(args, PPO_TRAIN_STEPS, RODENT_SUBSTEPS)
    runs = {}
    for mode in ("none", "equal", "scaled"):
        synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        _, (normalizer, policy), metrics = pt.train(
            env, PPO_TRAIN_STEPS * steps_per, network_factory=factory, seed=seed, device=device,
            randomization_fn=None if mode == "none" else rodent_randomization(mode), **args)
        synchronize(device)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        want = dict.fromkeys(counts, 0) | {"cg_solve_fused": expected}
        if torch.device(device).type == "cuda" and counts != want:
            fail(f"randomized train ({mode}) launches {counts}, expected {want}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            fail(f"randomized train ({mode}) metrics not finite: {bad}")
        tensors = {f"policy.{k}": v for k, v in policy.state_dict().items()}
        tensors.update({f"normalizer.{k}": getattr(normalizer, k)
                        for k in ("count", "mean", "summed_variance", "std")})
        runs[mode] = dict(seconds=seconds, counts=counts, metrics=metrics, tensors=tensors)
    a, b = runs["none"], runs["equal"]
    differ = [k for k in a["tensors"] if not torch.equal(a["tensors"][k], b["tensors"][k])]
    if differ or a["metrics"]["eval/episode_reward"] != b["metrics"]["eval/episode_reward"]:
        fail(f"randomized train: the equal-values batch differs from the unrandomized run in "
             f"{differ or 'eval/episode_reward'}")
    gaps = randomized_first_step_gaps(device, seed, N_CPU_ENVS, env=env)
    if any(gaps[k] > RAND_STEP_ATOL[k] for k in RAND_STEP_ATOL) or gaps["done_mismatch"]:
        fail(f"randomized rodent: first control step on the card differs from the CPU float64 "
             f"run: {gaps} (limits {RAND_STEP_ATOL})")
    return runs, expected, gaps


def counted():
    """Every kernel wrapper that counts its launches, by name."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    return {"cg_solve_fused": ops_cg.cg_solve_fused, "cg_solve_batched": ops_cg.cg_solve_batched,
            "spd_inverse": ops_chol.spd_inverse, "spd_inverse2": ops_chol.spd_inverse2,
            "spd_solve": ops_chol.spd_solve, "factor_batched": ops_chol.factor_batched,
            "solve_batched": ops_chol.solve_batched}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counted().items()}


def spd_inputs(device, nv, B, seed):
    """Seeded float32 SPD matrices (condition number <= SPD_COND), a
    right-hand side and a damping vector."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=g, device=device, dtype=torch.float64)
    Q, _ = torch.linalg.qr(torch.randn(B, nv, nv, **f64))
    lam = SPD_COND ** torch.rand(B, nv, **f64)
    M = (Q * lam[:, None, :]) @ Q.transpose(-1, -2)
    M = 0.5 * (M + M.transpose(-1, -2))
    b = torch.randn(B, nv, **f64)
    damp = 0.01 + 0.1 * torch.rand(nv, **f64)
    return M.float().contiguous(), b.float().contiguous(), damp.float().contiguous()


def chol_inputs(name, M, b, damp):
    """The inputs of ``name`` on the SPD matrices M: for solve_batched the
    first is the upper factor of M (float64 factor, stored in float32)."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if name == "solve_batched":
        M = ops_chol.cholesky_factor_reference(M.double()).float().contiguous()
    return M, b, damp


def spd_run(name, M, b, damp, fn_kind):
    """One of the SPD functions on (M, b, damp) (M is the factor U for
    solve_batched): fn_kind "kernel" (the wrapper on M's device), "plain"
    or "plain64"; returns a tuple of outputs."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if fn_kind == "plain64":
        M, b, damp = M.double(), b.double(), damp.double()
    if name in ("spd_solve", "solve_batched"):
        args = (M, b)
    elif name == "spd_inverse2":
        args = (M, damp)
    else:
        args = (M,)
    if fn_kind == "kernel":
        out = getattr(ops_chol, name)(*args, device=M.device)
    elif name == "spd_solve":
        out = ops_chol.spd_solve_reference(*args)
    elif name == "solve_batched":
        out = ops_chol.cholesky_solve_reference(*args)
    elif name == "factor_batched":
        out = ops_chol.cholesky_factor_reference(M)
    elif name == "spd_inverse2":
        out = (ops_chol.sweep_inverse_reference(M),
               ops_chol.sweep_inverse_reference(M + torch.diag(damp)))
    else:
        out = ops_chol.sweep_inverse_reference(M)
    return out if isinstance(out, tuple) else (out,)


def spd_residual(name, M, b, damp, outs):
    """Per-matrix float64 residual: ||M X - I||_max (for spd_inverse2 the
    larger of its two inverses'), ||M x - b|| / ||b|| (for solve_batched M
    = U^T U of its input factor U), ||U^T U - M||_max / ||M||_max for the
    factor."""
    Md, outs = M.double(), [o.double() for o in outs]
    if name == "factor_batched":
        U = outs[0]
        return (U.transpose(-1, -2) @ U - Md).abs().amax((-1, -2)) / Md.abs().amax((-1, -2))
    if name in ("spd_solve", "solve_batched"):
        if name == "solve_batched":
            Md = Md.transpose(-1, -2) @ Md
        bd = b.double()
        return ((Md @ outs[0][..., None])[..., 0] - bd).norm(dim=-1) / bd.norm(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=torch.float64, device=M.device)
    mats = [Md, Md + torch.diag(damp.double())][: len(outs)]
    return torch.stack([(A @ X - eye).abs().amax((-1, -2)) for A, X in zip(mats, outs)]).amax(0)


def phase_spd_vs_plain(name, M, b, damp, case, abs_bound):
    """A SPD kernel and its float32 plain version against a float64 plain
    run on the same inputs; fails unless the kernel's residuals are within
    SPD_FACTOR of the plain version's and under ``abs_bound``. Launches
    made here do not count. Returns the report."""
    fn = counted()[name]
    launches = fn.launches
    kern = spd_run(name, M, b, damp, "kernel")
    fn.launches = launches
    plain = spd_run(name, M, b, damp, "plain")
    ref = spd_run(name, M, b, damp, "plain64")
    if M.is_cuda:
        torch.cuda.synchronize()
    rk, rp, rr = (spd_residual(name, M, b, damp, o) for o in (kern, plain, ref))
    report = {
        "kernel": name, "case": case, "B": M.shape[0], "nv": M.shape[-1],
        "kernel_max": float(rk.max()), "kernel_median": float(rk.median()),
        "plain_max": float(rp.max()), "plain_median": float(rp.median()),
        "plain64_max": float(rr.max()),
        "max_abs_err": max(float((k.double() - r).abs().max()) for k, r in zip(kern, ref)),
        "finite": all(bool(torch.isfinite(k).all()) for k in kern),
    }
    print("spd_vs_plain " + json.dumps(report))
    where = f"{name}, {case}, B={report['B']}, nv={report['nv']}"
    if not report["finite"]:
        fail(f"{where}: kernel output not finite")
    for stat in ("max", "median"):
        k, pl = report["kernel_" + stat], report["plain_" + stat]
        if k > SPD_FACTOR * pl + SPD_FLOOR:
            fail(f"{where}: kernel {stat} residual {k:.3e} > {SPD_FACTOR} x plain {pl:.3e}")
    if report["kernel_max"] > abs_bound:
        fail(f"{where}: kernel max residual {report['kernel_max']:.3e} > {abs_bound}")
    return report


def phase_upper_only(name, M, b, damp):
    """A Cholesky kernel (spd_solve, factor_batched or solve_batched) on
    (M, b) and on M with NaN in its strict lower triangle (M is the factor
    U for solve_batched); fails unless every output of the second run is
    finite and bitwise equal to the first's. Launches made here do not
    count."""
    fn = counted()[name]
    launches = fn.launches
    clean = spd_run(name, M, b, damp, "kernel")
    lower = torch.ones(M.shape[-1], M.shape[-1], dtype=torch.bool, device=M.device).tril(-1)
    dirty = spd_run(name, M.masked_fill(lower, float("nan")), b, damp, "kernel")
    fn.launches = launches
    if not all(bool(torch.isfinite(d).all()) and torch.equal(c, d) for c, d in zip(clean, dirty)):
        fail(f"{name}, B={M.shape[0]}, nv={M.shape[-1]}: NaN below the diagonal changed the "
             f"output")


def bm_model(device, solver, dtype=None):
    from brax_tracking_tpu_torch.physics import spec

    return spec.load_model(spec.BALLMUSCLE_NPZ[solver], device=device, dtype=dtype, solver=solver)


def _axis_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def bm_posed(m, B, seed0=0):
    """The posed ballmuscle states of tests/test_physics_ball_muscle.py
    (shoulder rotated 0.58 rad, near its 0.6 rad ball limit; wrist 0.15
    rad), env i from RandomState(seed0 + i), built without mujoco."""
    from brax_tracking_tpu_torch.physics import step as pstep

    cols = {k: [] for k in ("qpos", "qvel", "ctrl", "act")}
    for i in range(B):
        rng = np.random.RandomState(seed0 + i)
        qpos = np.zeros(m.nq)
        qpos[0:4] = _axis_quat(rng.uniform(-1, 1, 3), 0.58)
        qpos[4] = rng.uniform(-1.3, 1.3)
        qpos[5:9] = _axis_quat(rng.uniform(-1, 1, 3), 0.15)
        cols["qpos"].append(qpos)
        cols["qvel"].append(rng.uniform(-0.5, 0.5, m.nv))
        cols["ctrl"].append(rng.uniform(-0.5, 1.0, m.nu))
        cols["act"].append(rng.uniform(0.1, 0.9, m.na))
    t = lambda a: torch.as_tensor(np.stack(a), dtype=m.dtype, device=m.device)
    return pstep.make_data(m, B, device=m.device).replace(**{k: t(v) for k, v in cols.items()})


def bm_ctrls(m, B, n, seed):
    """n seeded ctrl draws, uniform in [-0.5, 1] (the posed recipe's range)."""
    g = torch.Generator(device=m.device).manual_seed(seed)
    return [-0.5 + 1.5 * torch.rand(B, m.nu, generator=g, device=m.device, dtype=m.dtype)
            for _ in range(n)]


def phase_ballmuscle(device, solver, B, seed):
    """BM_SUBSTEPS substeps of B posed ballmuscle envs; the counts are set to
    0 just before and read just after. Fails on a non-finite state or a
    launch count other than the path's: CG one spd_inverse2 per substep,
    Newton 2 + (Newton iterations the batch ran) spd_solve per substep.
    Returns (counts, expected, per-substep Newton iterations, the first
    substep's input and output)."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model(device, solver)
    d = d0 = bm_posed(m, B)
    ctrls = bm_ctrls(m, B, BM_SUBSTEPS, seed)
    reset_counts()
    iters, outs = [], []
    for c in ctrls:
        d = pstep.step(m, d.replace(ctrl=c), device=device)
        iters.append(int(d.solver_niter.max()) if solver == "newton" else 0)
        outs.append(d)
    counts = read_counts()
    for k, o in enumerate(outs):
        for f in ("qpos", "qvel", "act"):
            if not bool(torch.isfinite(getattr(o, f)).all()):
                fail(f"ballmuscle {solver}: {f} not finite at substep {k}")
    expected = dict.fromkeys(counts, 0)
    if solver == "cg":
        expected["spd_inverse2"] = BM_SUBSTEPS
    else:
        expected["spd_solve"] = sum(2 + k for k in iters)
    if device == "cuda" and counts != expected:
        fail(f"ballmuscle {solver} launches {counts}, expected {expected}")
    return counts, expected, iters, d0.replace(ctrl=ctrls[0]), outs[0]


def phase_bm_first_substep_on_cpu(solver, first_in, first_out, n):
    """The first substep of ``n`` envs run again by the port on the CPU in
    float64; returns the max gaps of qpos, qvel and act."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model("cpu", solver)
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    d = pstep.make_data(m, n, device="cpu").replace(
        **{k: cpu(getattr(first_in, k)) for k in ("qpos", "qvel", "act", "ctrl")}
    )
    d = pstep.step(m, d, device="cpu")
    gaps = {k: float((getattr(d, k) - cpu(getattr(first_out, k))).abs().max()) for k in BM_STEP_ATOL}
    if any(gaps[k] > BM_STEP_ATOL[k] for k in gaps):
        fail(f"ballmuscle {solver}: first substep on the card differs from the CPU "
             f"float64 run: {gaps} (limits {BM_STEP_ATOL})")
    return gaps


# ---------------------------------------------------------------------------
# Newton on the kernel layout and the smooth dynamics
# ---------------------------------------------------------------------------


def newton_ctrls(m, B, n, seed):
    """n seeded ctrl draws, uniform in [-0.3, 0.3] (random_states' range)."""
    g = torch.Generator(device=m.device).manual_seed(seed)
    return [-0.3 + 0.6 * torch.rand(B, m.nu, generator=g, device=m.device, dtype=m.dtype)
            for _ in range(n)]


def phase_newton(device, B, seed, n=NEWTON_SUBSTEPS):
    """``n`` substeps of B Newton minirat envs (Newton/100 on the kernel
    layout: chunks of the solve kernel); the counts are set to 0 just before
    and read just after. Fails on a non-finite state, or unless the
    cg_solve_fused launches equal the chunks the solver reports and no other
    kernel ran. Returns (counts, chunks per substep, the first substep's
    input and output)."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", device)
    d = d0 = random_states(m, B, seed)
    ctrls = newton_ctrls(m, B, n, seed)
    reset_counts()
    chunks, outs = [], []
    for c in ctrls:
        d = pstep.step(m, d.replace(ctrl=c), device=device)
        chunks.append(d.solver_nchunk)
        outs.append(d)
    counts = read_counts()
    for k, o in enumerate(outs):
        for f in ("qpos", "qvel"):
            if not bool(torch.isfinite(getattr(o, f)).all()):
                fail(f"minirat_newton: {f} not finite at substep {k}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": sum(chunks)}
    if device == "cuda" and counts != expected:
        fail(f"minirat_newton launches {counts}, expected {expected} (chunks {chunks})")
    return counts, chunks, d0.replace(ctrl=ctrls[0]), outs[0]


def phase_newton_first_substep_on_cpu(first_in, first_out, n):
    """The first Newton substep of ``n`` envs run again by the port on the
    CPU in float64; returns the max gaps of qpos and qvel."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", "cpu")
    cpu = lambda t: t[:n].detach().to("cpu", torch.float64)
    d = pstep.make_data(m, n, device="cpu").replace(
        **{k: cpu(getattr(first_in, k)) for k in ("qpos", "qvel", "ctrl")}
    )
    d = pstep.step(m, d, device="cpu")
    gaps = {k: float((getattr(d, k) - cpu(getattr(first_out, k))).abs().max())
            for k in NEWTON_STEP_ATOL}
    if any(gaps[k] > NEWTON_STEP_ATOL[k] for k in gaps):
        fail(f"minirat_newton: first substep on the card differs from the CPU float64 "
             f"run: {gaps} (limits {NEWTON_STEP_ATOL})")
    return gaps


def phase_smooth(device, B, seed):
    """The smooth-dynamics entry points on B minirat states: crb with the
    dense qM, factor_m (factor_batched) and solve_m of qfrc_smooth from the
    factor (solve_batched); the counts are set to 0 just before the three
    calls and read just after. Fails unless each kernel launched exactly
    once and no other, or if the solve's float64 residual ||qM x - f|| /
    ||f|| exceeds SMOOTH_RESIDUAL. Returns (counts, residual, qM, qLD, rhs)."""
    from brax_tracking_tpu_torch.physics import dynamics as D
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat", device)
    d = pstep.forward_to_constraint(m, random_states(m, B, seed))
    reset_counts()
    d = D.crb(m, d, dense=True)
    d = D.factor_m(m, d)
    x = D.solve_m(m, d, d.qfrc_smooth)
    counts = read_counts()
    expected = dict.fromkeys(counts, 0) | {"factor_batched": 1, "solve_batched": 1}
    if device == "cuda" and counts != expected:
        fail(f"smooth dynamics launches {counts}, expected {expected}")
    f = d.qfrc_smooth.double()
    res = float(((d.qM.double() @ x.double()[..., None])[..., 0] - f).norm(dim=-1).div(
        f.norm(dim=-1)).max())
    if not bool(torch.isfinite(x).all()) or res > SMOOTH_RESIDUAL:
        fail(f"smooth dynamics: solve_m residual {res:.3e} > {SMOOTH_RESIDUAL}")
    return counts, res, d.qM.contiguous(), d.qLD.contiguous(), d.qfrc_smooth.contiguous()


# ---------------------------------------------------------------------------
# the PPO trainer
# ---------------------------------------------------------------------------

# train() on the minirat tracking env (tracking_env, unwrapped: train()
# wraps it), float32 on the card. Kept at the flagship's widths
# (configs/train/train_rodent.yaml): MLPs (256, 256), 2048 envs, batch 2048,
# unroll 16, lr 3e-4, entropy 1e-3, discount 0.99, clipping 0.3, normalized
# observations, 128 eval envs. Cut to the run's time (PPO_CUTS: the full
# value of each cut), one training step of 2 unrolls x 16 control steps
# (the driver's run (i) takes two at these widths).
PPO_HIDDEN = (256, 256)
PPO_ARGS = dict(num_envs=2048, batch_size=2048, unroll_length=16, learning_rate=3e-4,
                entropy_cost=1e-3, discounting=0.99, clipping_epsilon=0.3,
                normalize_observations=True, num_eval_envs=128, num_minibatches=2,
                num_updates_per_batch=2, episode_length=32, num_evals=2)
PPO_CUTS = {"num_minibatches": 32, "num_updates_per_batch": 16, "episode_length": 250,
            "num_evals": 300}
PPO_TRAIN_STEPS = 1
# The first minibatch (2048 rows x 16 steps) of a training step on the card
# against the port's CPU float64 run on the same rows, params, normalizer
# and draws: the loss's relative gap, and each gradient tensor's max abs gap
# over its float64 max abs. A CPU float32 rehearsal of the same comparison
# (ppo_first_minibatch("cpu", seed, ..., dtype=torch.float32) at these
# widths, seeds 0 and 1) is off float64 by 2.43e-7 / 2.50e-7 (loss) and
# 5.99e-6 / 4.99e-6 (gradients); the limits leave 36x and 33x the larger.
PPO_LOSS_REL = 9e-6
PPO_GRAD_REL = 2e-4
# training/sps against the host clock between the two progress reports,
# less the eval between them
PPO_SPS_REL = 0.05


def ppo_geometry(args):
    """(env steps per training step, unrolls per training step, rows)."""
    rows = args["batch_size"] * args["num_minibatches"]
    return rows * args["unroll_length"], rows // args["num_envs"], rows


def ppo_expected_launches(args, train_steps, substeps=N_SUBSTEPS, evals=True):
    """cg_solve_fused launches of one train() run: one per substep of every
    training and eval control step, and one per reset (its forward): the
    training envs' reset and each eval's (with num_evals > 1, one before
    training and one after each of num_evals - 1 epochs). Without ``evals``
    a rank other than 0's, which runs none."""
    _, n_unrolls, _ = ppo_geometry(args)
    evals = (max(args["num_evals"] - 1, 1) + (args["num_evals"] > 1)) if evals else 0
    control = train_steps * n_unrolls * args["unroll_length"] + evals * args["episode_length"]
    return substeps * control + 1 + evals


def ppo_state(env_obs, action_size, hidden, lr, device, dtype, seed):
    """A fresh TrainingState of the trainer's shape."""
    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.training import gradients, running_statistics

    net = pn.make_ppo_networks(env_obs, action_size, pn.normalize_preprocessor, hidden, hidden,
                               generator=torch.Generator(device=device).manual_seed(seed),
                               device=device, dtype=dtype)
    return pt.TrainingState(
        params=net, optimizer=gradients.make_optimizer(net.parameters(), lr),
        normalizer_params=running_statistics.init_state(
            torch.zeros(env_obs, dtype=net.policy.layers[0].weight.dtype, device=device)),
        env_steps=0)


def ppo_loss_fn(args):
    """compute_ppo_loss with train()'s hyperparameters for ``args``."""
    import functools

    from brax_tracking_tpu_torch.agents.ppo import losses as pl

    return functools.partial(pl.compute_ppo_loss, entropy_cost=args["entropy_cost"],
                             discounting=args["discounting"],
                             clipping_epsilon=args["clipping_epsilon"])


def checkpoint_tensors(path):
    """Every tensor of the checkpoint at ``path`` (training/checkpoint.py's
    file), by distributed/mesh.py::training_state_tensors' names, on the
    host."""
    from brax_tracking_tpu_torch.training import checkpoint as pc

    saved = torch.load(os.path.join(path, pc.STATE_FILE), map_location="cpu", weights_only=True)
    out = {f"params.{k}": v for k, v in saved["params"].items()}
    for i, st in saved["optimizer_state"]["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out.update({f"normalizer.{k}": v for k, v in saved["normalizer_params"].items()})
    return out


def phase_ppo(device, seed, args=PPO_ARGS, hidden=PPO_HIDDEN, train_steps=PPO_TRAIN_STEPS,
              dtype=None, compute_dtype=None):
    """train() once on the minirat tracking env (its MLPs computing in
    ``compute_dtype`` where one is given, as make_ppo_networks takes it),
    the counts set to 0 just
    before: exactly ppo_expected_launches cg_solve_fused launches and no
    other kernel (on the card), every metric finite, the env steps asked
    for, training/sps within PPO_SPS_REL of the host clock, params moved
    from their init, a bitwise checkpoint round trip (Adam step included)
    and eval/avg_episode_length in (0, episode_length]. Returns the run's
    numbers, the env, the trained (normalizer, policy), make_policy and the
    networks' init state dict."""
    import functools
    import tempfile

    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.distributed import mesh as dmesh
    from brax_tracking_tpu_torch.training import checkpoint as pc

    env = tracking_env(device, dtype)
    steps_per, _, _ = ppo_geometry(args)
    num_timesteps = train_steps * steps_per
    nets = []

    def factory(*a, **kw):
        net = pn.make_ppo_networks(*a, policy_hidden_layer_sizes=hidden,
                                   value_hidden_layer_sizes=hidden, compute_dtype=compute_dtype,
                                   **kw)
        nets.append((net, {k: v.detach().clone() for k, v in net.state_dict().items()}))
        return net

    reports, clock = [], []

    def progress(step, metrics):
        clock.append(time.perf_counter())
        reports.append((step, metrics))

    with tempfile.TemporaryDirectory() as ckpt:
        synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        make_policy, (normalizer, policy), metrics = pt.train(
            env, num_timesteps, network_factory=factory, progress_fn=progress,
            checkpoint_dir=ckpt, seed=seed, device=device, **args)
        synchronize(device)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        expected = dict.fromkeys(counts, 0) | {
            "cg_solve_fused": ppo_expected_launches(args, train_steps)}
        if torch.device(device).type == "cuda" and counts != expected:
            fail(f"ppo launches {counts}, expected {expected}")

        if [s for s, _ in reports] != [0, num_timesteps]:
            fail(f"ppo progress at steps {[s for s, _ in reports]}, expected [0, {num_timesteps}]")
        for step, m in reports:
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if bad:
                fail(f"ppo metrics not finite at step {step}: {bad}")
        sps = metrics["training/sps"]
        window = clock[1] - clock[0] - metrics["eval/epoch_eval_time"]
        host_sps = num_timesteps / window
        if abs(host_sps - sps) > PPO_SPS_REL * sps:
            fail(f"training/sps {sps:.1f} against {host_sps:.1f} on the host clock")
        avg_len = metrics["eval/avg_episode_length"]
        if not 0 < avg_len <= args["episode_length"]:
            fail(f"eval/avg_episode_length {avg_len} outside (0, {args['episode_length']}]")

        net, init = nets[0]
        for part in ("policy", "value"):
            if all(torch.equal(v, init[k]) for k, v in net.state_dict().items()
                   if k.startswith(part)):
                fail(f"ppo {part} params did not move from their init")

        path = pc.latest_checkpoint(ckpt)
        if path is None or os.path.basename(path) != str(num_timesteps):
            fail(f"ppo checkpoint {path}, expected one at step {num_timesteps}")
        obs_size, action_size = net.policy.layers[0].in_features, env.action_size
        make = functools.partial(ppo_state, obs_size, action_size, hidden,
                                 args["learning_rate"], device, dtype)
        restored = pc.restore_checkpoint(path, make(seed + 1))
        saved = torch.load(os.path.join(path, pc.STATE_FILE), map_location=device,
                           weights_only=True)
        live = {f"params.{k}": v for k, v in net.state_dict().items()}
        live.update({f"normalizer.{k}": getattr(normalizer, k)
                     for k in ("count", "mean", "summed_variance", "std")})
        for i, st in saved["optimizer_state"]["state"].items():
            live.update({f"adam.{i}.{k}": v for k, v in st.items()})
        back = dmesh.training_state_tensors(restored)
        updates = train_steps * args["num_minibatches"] * args["num_updates_per_batch"]
        steps = {int(v) for k, v in back.items() if k.endswith(".step")}
        if back.keys() != live.keys() or steps != {updates} or restored.env_steps != num_timesteps:
            fail(f"ppo checkpoint restore: Adam steps {steps} (expected {updates}), env_steps "
                 f"{restored.env_steps}")
        pc.save_checkpoint(os.path.join(ckpt, "again"), restored)
        again = dmesh.training_state_tensors(
            pc.restore_checkpoint(os.path.join(ckpt, "again"), make(seed + 2)))
        for k, v in live.items():
            v = v.cpu()  # Adam's step lives on the host
            if not (torch.equal(back[k].cpu(), v) and torch.equal(again[k].cpu(), v)):
                fail(f"ppo checkpoint round trip changed {k}")
        final = checkpoint_tensors(path)
    return dict(counts=counts, seconds=seconds, metrics=metrics, host_sps=host_sps,
                num_timesteps=num_timesteps, tensors=len(live), final=final), env, \
        (normalizer, policy), make_policy, init


def ppo_first_minibatch(device, seed, init, env=None, args=PPO_ARGS, hidden=PPO_HIDDEN,
                        dtype=None):
    """One training step's rollout_step and learn_step, timed (host clock to
    a synchronize), from the networks' init on fresh draws; the first
    minibatch's loss and gradients, before the learn step, against the
    port's CPU float64 run on the same rows, params, normalizer and draws.
    Returns (loss gap, gradient gap, collect s, learn s)."""
    import copy

    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.envs import wrappers
    from brax_tracking_tpu_torch.training import running_statistics

    env = tracking_env(device, dtype) if env is None else env
    wenv = wrappers.wrap(env, episode_length=args["episode_length"])
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    state = wenv.reset(gen, args["num_envs"])
    obs_size, action_size, fdtype = state.obs.shape[-1], wenv.action_size, state.obs.dtype
    ts = ppo_state(obs_size, action_size, hidden, args["learning_rate"], device, fdtype, seed)
    ts.params.load_state_dict(init)
    steps_per, n_unrolls, rows = ppo_geometry(args)
    T = args["unroll_length"]
    loss_fn = ppo_loss_fn(args)
    eps = pt.rollout_draws(gen, n_unrolls, T, args["num_envs"], action_size, fdtype)
    synchronize(device)
    t0 = time.perf_counter()
    _, data, normalizer = pt.rollout_step(wenv, pn.make_inference_fn(ts.params), ts, state, eps)
    synchronize(device)
    collect = time.perf_counter() - t0
    perms, ent = pt.learn_draws(gen, args["num_updates_per_batch"], args["num_minibatches"], rows,
                                T, action_size, fdtype)
    first = perms[0].reshape(args["num_minibatches"], -1)[0]
    mb = data.map(lambda x: x[first])

    def loss_grads(net, norm, mb, eps):
        net.zero_grad(set_to_none=True)
        loss, _ = loss_fn(net, norm, mb, eps)
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().to("cpu", torch.float64)
                             for k, p in net.named_parameters()}

    loss, grads = loss_grads(ts.params, normalizer, mb, ent[0, 0])
    to64 = lambda x: x.detach().to("cpu", torch.float64) if x.is_floating_point() else x.cpu()
    net64 = copy.deepcopy(ts.params).to("cpu", torch.float64)
    norm64 = running_statistics.RunningStatisticsState(
        **{k: to64(getattr(normalizer, k)) for k in ("count", "mean", "summed_variance", "std")})
    loss64, grads64 = loss_grads(net64, norm64, mb.map(to64), to64(ent[0, 0]))
    loss_gap = abs(loss - loss64) / abs(loss64)
    grad_gap = max(float((grads[k] - g).abs().max() / g.abs().max()) for k, g in grads64.items())

    synchronize(device)
    t0 = time.perf_counter()
    pt.learn_step(ts, data, normalizer, perms, ent, loss_fn, steps_per)
    synchronize(device)
    return loss_gap, grad_gap, collect, time.perf_counter() - t0


def phase_ppo_eval_rollback(env, make_policy, params, seed, args=PPO_ARGS):
    """One eval episode of the trained policy as the Evaluator runs it
    (training wrappers under EvalWrapper): every env done at a step is back
    at its reset-time observation after it, every env is done at the
    episode's last step, and the mean episode length is in (0,
    episode_length]. Returns (envs done before the last step, mean
    episode length)."""
    from brax_tracking_tpu_torch.envs import wrappers
    from brax_tracking_tpu_torch.training import acting

    eenv = acting.EvalWrapper(wrappers.wrap(env, episode_length=args["episode_length"]))
    gen = torch.Generator(device=env.device).manual_seed(seed + 4)
    state = eenv.reset(gen, args["num_eval_envs"])
    snap = state.info["autoreset_snapshot"]["obs"]
    policy = make_policy(params)
    early = 0
    with torch.no_grad():
        for t in range(args["episode_length"]):
            eps = torch.randn((args["num_eval_envs"], eenv.action_size), generator=gen,
                              dtype=state.obs.dtype, device=env.device)
            state = eenv.step(state, policy(state.obs, eps)[0])
            done = state.done.bool()
            if not torch.equal(state.obs[done], snap[done]):
                fail(f"eval envs done at step {t} are not back at their reset observation")
            if t < args["episode_length"] - 1:
                early += int(done.sum())
    if not state.done.bool().all():
        fail("eval envs not done at the episode's last step")
    avg = float(state.info["eval_metrics"].episode_steps.mean())
    if not 0 < avg <= args["episode_length"]:
        fail(f"eval mean episode length {avg} outside (0, {args['episode_length']}]")
    return early, avg


# ---------------------------------------------------------------------------
# the data-parallel trainer (distributed/mesh.py): train() over ranks
# ---------------------------------------------------------------------------

# (b): train() on the flagship rodent env on its stand-in at PPO_ARGS (MLPs
# 256 x 256, 2048 envs in all, batch 2048, 2 minibatches, 2 updates,
# episode_length 32, one training step) over DIST_RANKS processes that share
# the one card over gloo (NCCL refuses two ranks on one device): 1024 envs
# per rank
DIST_RANKS = 2
DIST_TIMEOUT_S = 600
STALE_BATON_LOG = "left by a build that did not finish"


def torchrun_env(rank, world_size, port, local_rank=0):
    """torchrun's environment for one rank (every rank on cuda:local_rank)."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(local_rank),
                MASTER_ADDR="localhost", MASTER_PORT=str(port))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_keeping_state(env, steps, hidden, **kwargs):
    """train() with the networks and the optimizer it makes kept; returns
    (metrics, every tensor of the final training state on the host, the
    steps progress_fn was called at, seconds to a synchronize)."""
    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.distributed import mesh as dmesh

    made, evals = {}, []
    make_optimizer = pt.gradients.make_optimizer

    def keep_optimizer(*a, **kw):
        made["opt"] = make_optimizer(*a, **kw)
        return made["opt"]

    def factory(*a, **kw):
        made["net"] = pn.make_ppo_networks(*a, policy_hidden_layer_sizes=hidden,
                                           value_hidden_layer_sizes=hidden, **kw)
        return made["net"]

    pt.gradients.make_optimizer = keep_optimizer
    try:
        synchronize(kwargs["device"])
        t0 = time.perf_counter()
        _, (normalizer, _), metrics = pt.train(
            env, steps, network_factory=factory,
            progress_fn=lambda step, m: evals.append(step), **kwargs)
        synchronize(kwargs["device"])
        seconds = time.perf_counter() - t0
    finally:
        pt.gradients.make_optimizer = make_optimizer
    state = pt.TrainingState(params=made["net"], optimizer=made["opt"],
                             normalizer_params=normalizer, env_steps=0)
    tensors = dmesh.training_state_tensors(state)
    return metrics, {k: v.detach().cpu() for k, v in tensors.items()}, evals, seconds


def phase_distributed_one(device, seed, reference, args=PPO_ARGS, hidden=PPO_HIDDEN):
    """(a) phase_ppo's train() again through a process group of one rank
    (make_train_mesh from torchrun's environment: NCCL on the card, gloo on
    the CPU), the counts set to 0 just before: exactly ppo_expected_launches
    cg_solve_fused launches and no other kernel (on the card), and every
    tensor of its final checkpoint (params, normalizer, Adam's moments and
    step) bitwise ``reference``'s, phase_ppo's undistributed run's. Returns
    the run's numbers."""
    import functools
    import tempfile

    import torch.distributed as dist

    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.distributed import mesh as dmesh
    from brax_tracking_tpu_torch.training import checkpoint as pc

    env = tracking_env(device)
    steps = PPO_TRAIN_STEPS * ppo_geometry(args)[0]
    os.environ.update(torchrun_env(0, 1, free_port()))
    try:
        mesh = dmesh.make_train_mesh(device)
    finally:
        for k in dmesh.TORCHRUN_ENV:
            del os.environ[k]
    backend = dist.get_backend(mesh.group)
    factory = functools.partial(pn.make_ppo_networks, policy_hidden_layer_sizes=hidden,
                                value_hidden_layer_sizes=hidden)
    with tempfile.TemporaryDirectory() as ckpt:
        synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        _, _, metrics = pt.train(env, steps, network_factory=factory, checkpoint_dir=ckpt,
                                 seed=seed, device=device, mesh=mesh, **args)
        synchronize(device)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        final = checkpoint_tensors(pc.latest_checkpoint(ckpt))
    mesh.close()
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": ppo_expected_launches(
        args, PPO_TRAIN_STEPS)}
    if torch.device(device).type == "cuda" and counts != expected:
        fail(f"distributed (a): launches {counts}, expected {expected}")
    differ = sorted(set(final) ^ set(reference)) or [
        k for k in reference if not torch.equal(final[k], reference[k])]
    if differ:
        fail(f"distributed (a): world size 1 through a {backend} group differs from the run "
             f"with no group in {differ[:5]}")
    return dict(counts=counts, expected=expected["cg_solve_fused"], backend=backend,
                seconds=seconds, metrics=metrics, tensors=len(final))


def distributed_rank(out, spec):
    """One rank of (b), started by phase_distributed_ranks with torchrun's
    environment and ``spec`` (JSON: device, seed, args, hidden): the mesh on
    gloo on this rank's card, the kernels' build (both ranks at once,
    through ops/library.py::build_lock; on the CPU the guard alone), then
    train() on the rodent stand-in with the counts set to 0 just before;
    pickles its numbers, its launches, the steps of its evals and every
    tensor of its final training state to ``out``."""
    import logging
    import pickle

    import torch.distributed as dist

    from brax_tracking_tpu_torch.distributed import mesh as dmesh
    from brax_tracking_tpu_torch.ops import library

    spec = json.loads(spec)
    device, args = spec["device"], spec["args"]
    if device == "cuda" and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    logging.basicConfig(level=logging.WARNING)
    mesh = dmesh.make_train_mesh(device, backend="gloo")
    t0 = time.perf_counter()
    if device == "cuda":
        library.build()
    else:
        with library.build_lock(library._BUILD_DIR):
            pass
    build_s = time.perf_counter() - t0
    env = config_env(device, None, "rodent_standin")
    reset_counts()
    metrics, tensors, evals, seconds = train_keeping_state(
        env, PPO_TRAIN_STEPS * ppo_geometry(args)[0], tuple(spec["hidden"]), seed=spec["seed"],
        device=device, mesh=mesh, **args)
    counts = read_counts()
    report = dict(rank=mesh.rank, world_size=mesh.world_size, device=str(mesh.device),
                  backend=dist.get_backend(mesh.group), build_s=build_s, counts=counts,
                  evals=evals, seconds=seconds, metrics=metrics, tensors=tensors)
    mesh.close()
    with open(out, "wb") as f:
        pickle.dump(report, f)
    return 0


def phase_distributed_ranks(seed, device="cuda", args=PPO_ARGS, hidden=PPO_HIDDEN):
    """(b) DIST_RANKS processes (this file with --distributed-rank), every
    one on cuda:0 over gloo, after a stale _build/lock is planted (a build
    killed mid-way leaves one): every rank exits 0 within DIST_TIMEOUT_S
    (else the others are killed and the phase fails), exactly one rank logs
    the stale lock's removal, each rank's cg_solve_fused launches are
    ppo_expected_launches (rank 0's with its two evals, the others' without)
    and no other kernel (on the card), evals on rank 0 only, every tensor of
    the final training state bitwise equal on every rank. Returns the ranks'
    reports and the rank that removed the lock."""
    import pickle
    import tempfile

    from brax_tracking_tpu_torch.ops import library

    baton = os.path.join(library._BUILD_DIR, "lock")
    with open(baton, "w"):
        pass
    port = free_port()
    spec = json.dumps(dict(device=device, seed=seed, args=args, hidden=hidden))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(DIST_RANKS):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            env = dict(os.environ, **torchrun_env(rank, DIST_RANKS, port))
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--distributed-rank",
                 os.path.join(tmp, f"rank{rank}.p"), spec], stdout=log,
                stderr=subprocess.STDOUT, env=env), log))
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while any(p.poll() is None for p, _ in procs):
                failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(1.0)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        logs = []
        for rank in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                logs.append(f.read())
        codes = [p.returncode for p, _ in procs]
        if any(codes):
            tails = "\n".join(f"--- rank {r} (exit {c}):\n{logs[r][-3000:]}"
                              for r, c in enumerate(codes))
            fail(f"distributed (b): ranks exited {codes}\n{tails}")
        reports = []
        for rank in range(DIST_RANKS):
            with open(os.path.join(tmp, f"rank{rank}.p"), "rb") as f:
                reports.append(pickle.load(f))
    removed = [r for r, text in enumerate(logs) if STALE_BATON_LOG in text]
    if len(removed) != 1 or os.path.exists(baton):
        fail(f"distributed (b): the planted stale {baton} was removed by ranks {removed}")
    steps = PPO_TRAIN_STEPS * ppo_geometry(args)[0]
    for r in reports:
        expected = dict.fromkeys(r["counts"], 0) | {"cg_solve_fused": ppo_expected_launches(
            args, PPO_TRAIN_STEPS, RODENT_SUBSTEPS, evals=r["rank"] == 0)}
        if device == "cuda" and r["counts"] != expected:
            fail(f"distributed (b): rank {r['rank']} launches {r['counts']}, expected {expected}")
        if r["evals"] != ([0, steps] if r["rank"] == 0 else []):
            fail(f"distributed (b): rank {r['rank']} ran evals at {r['evals']}")
        where = "cuda:0" if device == "cuda" else "cpu"
        if (r["world_size"], r["backend"], r["device"]) != (DIST_RANKS, "gloo", where):
            fail(f"distributed (b): rank {r['rank']} on {r['device']} over {r['backend']} of "
                 f"{r['world_size']}")
        bad = [k for k, v in r["metrics"].items() if not np.isfinite(v)]
        if bad:
            fail(f"distributed (b): rank {r['rank']} metrics not finite: {bad}")
        r["expected"] = expected["cg_solve_fused"]
    ref = reports[0]["tensors"]
    for r in reports[1:]:
        differ = sorted(set(r["tensors"]) ^ set(ref)) or [
            k for k in ref if not torch.equal(r["tensors"][k], ref[k])]
        if differ:
            fail(f"distributed (b): rank {r['rank']}'s training state differs from rank 0's in "
                 f"{differ[:5]}")
    for r in reports:
        r["tensors"] = len(r["tensors"])
    return reports, removed[0]


# ---------------------------------------------------------------------------
# the driver (harness/driver.py::main), the port's main path since slice 8
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# configs/train/train_rodent.yaml's widths (MLPs 256 x 256, 2048 envs,
# batch 2048, unroll 16, 128 eval envs) on the minirat, cut as PPO_ARGS is
# (PPO_CUTS): (i) single clip, one training step and evals at 0 and 65,536
# steps (two training steps up to PR 16: cut to keep the run's seconds as
# the last modules' phases were added); (ii) four clips, one training step
# and one eval
DRIVER_ARGV = ["train=train_rodent", "dataset=minirat", "train.env_name=single_clip_tracking",
               "train.num_minibatches=2", "train.num_updates_per_batch=2",
               "train.force_episode_length=true", "train.episode_length=32",
               "train.num_timesteps=65536", "train.eval_every=32768"]
DRIVER_MULTI = ["dataset.n_clips=4", "train.env_name=multi_clip_tracking",
                "train.num_timesteps=65536", "train.eval_every=65536"]
# the pair's driver run: configs/train/train_pair.yaml's widths (MLPs 256 x
# 256, 1024 envs, batch 1024, unroll 16, 128 eval envs) on the stand-in, cut
# as PPO_ARGS is (2 minibatches, 2 updates, episode_length 32): one training
# step (32,768 env steps) with evals before and after it; the clip cut to 24
# frames (2 control steps each), so the callback's B = 1 rollout takes 38
# control steps
PAIR_DRIVER_ARGV = PAIR_ARGV + [
    "train.num_minibatches=2", "train.num_updates_per_batch=2",
    "train.force_episode_length=true", "train.episode_length=32",
    "train.num_timesteps=32768", "train.eval_every=32768", "dataset.clip_length=24"]
# the flagship's driver run on the rodent stand-in: configs/train/
# train_rodent.yaml's widths (MLPs 256 x 256, 2048 envs, batch 2048, unroll
# 16, 128 eval envs) and rodent.yaml's env, cut as PPO_ARGS is (2
# minibatches, 2 updates, episode_length 32): one training step (65,536
# env steps) with evals before and after it; the clip cut to 24 frames (2
# control steps each), so the callback's B = 1 rollout takes 38 control
# steps
RODENT_DRIVER_ARGV = RODENT_ARGV + [
    "train.num_minibatches=2", "train.num_updates_per_batch=2",
    "train.force_episode_length=true", "train.episode_length=32",
    "train.num_timesteps=65536", "train.eval_every=65536", "dataset.clip_length=24"]
# the flagship's command on the rodent stand-in's terrain at train_rodent's
# widths, cut deeper than the rodent's run (its narrowphase is ~0.35 s of
# host dispatch per substep): one training step of 2 unrolls x 4 control
# steps (16,384 env steps; unroll 16 in train_rodent.yaml) with evals before
# and after it of episode_length 4, the clip cut to 8 frames, so the
# callback's B = 1 rollout takes 6 control steps; its video draws the visual
# meshes and the terrain
TERRAIN_DRIVER_ARGV = TERRAIN_ARGV + [
    "train.num_minibatches=2", "train.num_updates_per_batch=2", "train.unroll_length=4",
    "train.force_episode_length=true", "train.episode_length=4",
    "train.num_timesteps=16384", "train.eval_every=16384", "dataset.clip_length=8"]
# train=train_fly dataset=fly on the tethered fly stand-in: configs/train/
# train_fly.yaml's widths (MLPs 256 x 256, 1024 envs, batch 1024, unroll 16,
# 128 eval envs) and fly.yaml's env, cut as the pair's run is (2
# minibatches, 2 updates, episode_length 32): one training step (32,768 env
# steps) with evals before and after it; the clip the committed tethered
# stac export's first 24 frames (2 control steps each), so the callback's
# B = 1 rollout takes 38 control steps
# train=train_fly_freejnt dataset=fly_freejnt on the ball-coxa fly stand-in
# (the array CG path: spd_inverse once per substep and reset, a host read
# per CG iteration) at train_fly_freejnt's 2048 envs, cut deeper than the
# fly's run as the terrain's is: one training step of 2 unrolls x 4 control
# steps (16,384 env steps), evals of episode_length 8, the clip cut to 8
# frames (6 callback control steps)
FLY_BALL_DRIVER_ARGV = FLY_BALL_ARGV + [
    "train.num_minibatches=2", "train.num_updates_per_batch=2", "train.unroll_length=4",
    "train.force_episode_length=true", "train.episode_length=8",
    "train.num_timesteps=16384", "train.eval_every=16384", "dataset.clip_length=8"]
FLY_DRIVER_ARGV = FLY_ARGVS["fly_standin_tethered"] + [
    "train.num_minibatches=2", "train.num_updates_per_batch=2",
    "train.force_episode_length=true", "train.episode_length=32",
    "train.num_timesteps=32768", "train.eval_every=32768", "dataset.clip_length=24"]
# the eval video of the rodent and tethered fly driver runs: train.
# render_video on, each config's render scene on its stand-in (the
# reference clip's body and the rollout's, assets/make_ratpair.py and
# make_fly_standin.py), camera 1 (trackcom on the rollout body) as the
# configs ask; save_video's chain picks the encoder (an MJPEG AVI where
# Pillow imports, a GIF where it does not), and count_frames reads either
RENDER_SCENES = {"rodent": "builtin:rodent_standin_pair.xml",
                 "terrain": "builtin:rodent_standin_terrain_pair.xml",
                 "fly": "builtin:fly_standin_pair.xml"}
# The render scene's poses on the card (float32, one batched kinematics
# call) against the port's CPU float64 kinematics on the same qpos frames,
# max abs gap per array, and the frames rasterized from each by the share
# of pixels that differ. A CPU float32 rehearsal (render_gaps("cpu", capture,
# torch.float32) on the captures of phase_driver("cpu", ...) with the small
# widths below, 20 frames of 480 x 640 each) is off float64 by at most
# 9.41e-8 / 3.54e-8 (geom_xpos, rodent / fly), 5.43e-7 / 3.73e-7
# (geom_xmat), 2.96e-8 / 8.19e-8 (cam_xpos), 3.56e-8 / 4.25e-8 (cam_xmat),
# and 1.82e-5 / 7.49e-6 of the pixels differ (112 / 46 pixels in all, at
# edges); the limits leave ~35x over the larger of the two.
RENDER_LIMITS = {"geom_xpos": 3.3e-6, "geom_xmat": 1.9e-5, "cam_xpos": 2.9e-6,
                 "cam_xmat": 1.5e-6, "pixel_share": 6.4e-4}
MC_ENVS = 8
# One control step of MC_ENVS multi-clip envs (clips 0-3 twice) on the card
# against the port's CPU float64 run from the same state and action: the
# max abs gap of obs and of reward. A CPU float32 rehearsal
# (mc_step_vs_cpu("cpu", cfg, torch.float32) on (ii)'s config, seeds 0-2)
# is off float64 by at most 6.63e-6 (obs) and 1.71e-6 (reward); the limits
# leave 35x.
MC_STEP_ATOL = {"obs": 2.3e-4, "reward": 6e-5}


def driver_expected_launches(cfg, n_steps):
    """cg_solve_fused launches of one driver run: train()'s
    (ppo_expected_launches: 10 per control step of training and evals, one
    per reset) and the callback's after each of the max(num_evals - 1, 1)
    epochs: a reset and ``n_steps`` control steps of the deterministic
    rollout, and for a multi-clip env as many of the per-clip rollout.
    Building the clips runs kinematics only."""
    tr = cfg["train"]
    args = {k: int(tr[k]) for k in ("num_envs", "batch_size", "num_minibatches",
                                    "unroll_length", "episode_length")}
    args["num_evals"] = max(int(tr["num_timesteps"]) // int(tr["eval_every"]), 1)
    steps_per, _, _ = ppo_geometry(args)
    epochs = max(args["num_evals"] - 1, 1)
    train_steps = epochs * -(-int(tr["num_timesteps"]) // (epochs * steps_per))
    rollouts = 1 + (int(cfg["dataset"].get("n_clips", 1)) > 1)
    substeps = int(cfg["dataset"]["env_args"]["physics_steps_per_control_step"])
    return (ppo_expected_launches(args, train_steps, substeps)
            + epochs * rollouts * (1 + substeps * n_steps))


def _numbers(node, path=""):
    """(path, value) of every number in a JSON record."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _numbers(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield path, node


def _tree(root):
    """Every file under ``root`` with its size and modification time."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def mc_step_vs_cpu(device, cfg, dtype=None, seed=SEED):
    """One control step of MC_ENVS envs of (ii)'s multi-clip env, pinned to
    clips 0-3, on ``device`` (``dtype``), run again by the port on the CPU in
    float64 from the same state and action; returns the gaps."""
    from brax_tracking_tpu_torch.harness import driver

    env = driver.build_env_from_cfg(cfg, device, dtype)
    n_clips = int(cfg["dataset"]["n_clips"])
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    idx = torch.arange(MC_ENVS, device=device) % n_clips
    state = env.reset_to_clip(idx, gen)
    action = 2.0 * torch.rand(MC_ENVS, env.action_size, generator=gen, device=device,
                              dtype=state.obs.dtype) - 1.0
    out = env.step(state, action)
    cpu = lambda t: t.detach().to("cpu", torch.float64)
    env64 = driver.build_env_from_cfg(cfg, "cpu")
    d = state.pipeline_state
    s = env64.step(env64.init_state(state.info["cur_frame"].cpu(), cpu(d.qpos), cpu(d.qvel),
                                    idx.cpu()), cpu(action))
    return {"obs": float((s.obs - cpu(out.obs)).abs().max()),
            "reward": float((s.reward - cpu(out.reward)).abs().max()),
            "done_mismatch": int((s.done != cpu(out.done)).sum()),
            "clips": sorted(set(out.info["clip_idx"].tolist()))}


def phase_driver(device, multi, pair=False, rodent=False, fly=False, video=False, replay=False,
                 terrain=False, ball=False, resume=None):
    """harness.driver.main once, (i) single clip reading the committed
    data/Minirat/clips/0.p or (ii) four clips built and cached as .npz in a
    temporary data_dir, or with ``pair`` the rodent_pair run on the stand-in
    (PAIR_DRIVER_ARGV), or with ``rodent`` the flagship's run on the rodent
    stand-in (RODENT_DRIVER_ARGV), or with ``fly`` train=train_fly on the
    tethered fly stand-in (FLY_DRIVER_ARGV, its clip from the committed stac
    export), each with its clip built and cached in a
    temporary data_dir, in a temporary paths.base_dir, the counts set to 0
    just before: exactly driver_expected_launches cg_solve_fused launches and
    no other kernel (on the card), every artifact written, every logged
    number finite, the run config read back as written, (i) nothing written
    under data/Minirat, (ii) every clip drawn at the training reset,
    eval/episode_reward_clip0..3 logged and one control step held against
    the CPU in float64. With ``video`` (the rodent and fly runs) the run
    also renders its eval video (train.render_video, RENDER_SCENES): the
    launches stay the same, the video has the T frames of the callback's
    rollout against its clip, and the report holds the render's seconds
    and what was rendered (``capture``, for render_gaps); with ``replay``
    phase_replay then runs on the run's directory. With ``terrain`` (and
    without ``rodent``) the flagship's run is on the rodent stand-in's terrain
    (TERRAIN_DRIVER_ARGV): every narrowphase call of the run is recorded,
    and the report holds, per new pair type, the calls (substeps of
    training, evals and the callback's rollout, in order) with an active
    slot in some env. With ``ball`` the run is train=train_fly_freejnt on
    the ball-coxa fly stand-in (FLY_BALL_DRIVER_ARGV), off the kernel
    layout: exactly driver_expected_launches spd_inverse launches (one per
    forward) and no other kernel. With ``resume`` = (a checkpoint directory,
    its env_steps) the run gets ``checkpoint=<directory>`` (a JAX orbax
    checkpoint restores without orbax) and resumes at those env_steps: its
    callback at them plus num_timesteps, its launches those of the
    unresumed run. Returns the run's numbers."""
    import tempfile

    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.envs import registry, tracking
    from brax_tracking_tpu_torch.harness import config as hc
    from brax_tracking_tpu_torch.harness import driver, render
    from brax_tracking_tpu_torch.native import video as vid

    tag = ("ball fly" if ball else "fly" if fly else "terrain" if terrain else "rodent" if rodent
           else "pair" if pair else "multi-clip" if multi else "single clip")
    committed = not (multi or pair or rodent or fly or terrain or ball)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "run")
        data_dir = os.path.join(ROOT, "data", "Minirat") if committed else os.path.join(tmp, "data")
        argv = (FLY_BALL_DRIVER_ARGV if ball else FLY_DRIVER_ARGV if fly else
                TERRAIN_DRIVER_ARGV if terrain else
                RODENT_DRIVER_ARGV if rodent else PAIR_DRIVER_ARGV if pair else
                DRIVER_ARGV + (DRIVER_MULTI if multi else [])) + [
            f"paths.base_dir={base}", f"paths.data_dir={data_dir}"]
        if video:
            argv += ["train.render_video=true",
                     f"dataset.rendering_mjcf={RENDER_SCENES[tag]}"]
        if resume is not None:
            argv += [f"checkpoint={resume[0]}"]
        cfg = hc.load_config(argv)
        ds, tr = cfg["dataset"], cfg["train"]
        m = load("fly_standin_ball" if ball else "fly_standin_tethered" if fly else
                 "rodent_standin_terrain" if terrain else "rodent_standin" if rodent else
                 "ratpair" if pair else "minirat", "cpu")
        per_frame = round(1.0 / (ds["mocap_hz"] * float(m.opt.timestep)))
        n_steps = ((ds["clip_length"] - ds["ref_traj_length"])
                   * (per_frame // ds["env_args"]["physics_steps_per_control_step"]))
        before = _tree(data_dir) if committed else None
        drawn = []

        class Recording(tracking.GenericMultiClip):
            def reset(self, generator, batch_size):
                state = super().reset(generator, batch_size)
                drawn.append(state.info["clip_idx"])
                return state

        captured = []
        rendering = render.render_rollout_vs_reference

        def recording_render(scene, qposes, ref_traj, *args, **kw):
            captured.append(dict(scene=scene, qposes=qposes, ref_traj=ref_traj,
                                 free_jnt=kw["free_jnt"], camera=kw["camera"]))
            return rendering(scene, qposes, ref_traj, *args, **kw)

        from brax_tracking_tpu_torch.physics import collision

        narrow = collision.collision
        calls = []

        def recording_narrowphase(m_, d_):
            out = narrow(m_, d_)
            calls.append(active_pair_types(m_, out.contact_dist))
            return out

        if multi:
            registry.register_environment("multi_clip_tracking", Recording)
        render.render_rollout_vs_reference = recording_render
        if terrain:
            collision.collision = recording_narrowphase
        try:
            synchronize(device)
            reset_counts()
            t0 = time.perf_counter()
            metrics = driver.main(argv, device=device)
            synchronize(device)
            seconds = time.perf_counter() - t0
            counts = read_counts()
        finally:
            registry.register_environment("multi_clip_tracking", tracking.GenericMultiClip)
            render.render_rollout_vs_reference = rendering
            collision.collision = narrow
        kernel = "spd_inverse" if ball else "cg_solve_fused"
        expected = dict.fromkeys(counts, 0) | {kernel: driver_expected_launches(cfg, n_steps)}
        if torch.device(device).type == "cuda" and counts != expected:
            fail(f"driver ({tag}) launches {counts}, expected {expected}")

        run = f"{tr['env_name']}_{tr['task_name']}_{tr['version']}"
        with open(os.path.join(base, "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        steps = sorted({r["_step"] for r in records if "rollout/summed_pos_distance_mean" in r})
        final = (0 if resume is None else resume[1]) + int(tr["num_timesteps"])
        if steps != [final]:
            fail(f"driver ({tag}) callback at steps {steps}, expected [{final}]")
        need = ["run_config.yaml", "logs/metrics.jsonl", f"ckpt/{final}/training_state.pt",
                f"ckpt/{run}/{final}", f"ckpt/{run}/final", f"ckpt/{run}/rollout_{final}.p",
                f"figures/perframe_{final}.csv"]
        missing = [p for p in need if not os.path.isfile(os.path.join(base, p))]
        if missing:
            fail(f"driver ({tag}) wrote no {missing}")
        logged = {k for r in records for k in r}
        want = {"eval/episode_reward", "training/sps"} | (
            {f"eval/episode_reward_clip{j}" for j in range(ds["n_clips"])} if multi else set())
        if not want <= logged:
            fail(f"driver ({tag}) logged no {sorted(want - logged)}")
        bad = [p for r in records for p, v in _numbers(r) if not np.isfinite(v)]
        if bad:
            fail(f"driver ({tag}) logged numbers not finite: {bad}")
        back = hc.read_yaml(os.path.join(base, "run_config.yaml"))
        if not back == cfg == records[0]["_config"]:
            fail(f"driver ({tag}) run_config.yaml reads back other than the config")

        # the callback's seconds from the log's stamps: the eval's progress
        # record, then (ii) the per-clip record, then the rollout's stats
        at = [i for i, r in enumerate(records) if r.get("_step") == final
              and "eval/episode_reward" in r][-1]
        ts = [r["_ts"] for r in records[at:at + 3]]
        if multi:
            per_clip_s, rollout_s = ts[1] - ts[0], ts[2] - ts[1]
        else:
            per_clip_s, rollout_s = None, ts[1] - ts[0]
        report = dict(seconds=seconds, counts=counts, expected=expected[kernel],
                      metrics=metrics, n_steps=n_steps, rollout_s=rollout_s,
                      per_clip_s=per_clip_s, final=final)
        if multi:
            clips = torch.bincount(drawn[0].cpu().long(), minlength=ds["n_clips"]).tolist()
            if drawn[0].numel() != tr["num_envs"] or 0 in clips:
                fail(f"driver (multi-clip) training reset drew clips {clips}")
            built = sorted(os.listdir(os.path.join(data_dir, "clips")))
            if built != [f"{j}.npz" for j in range(ds["n_clips"])]:
                fail(f"driver (multi-clip) cached {built}")
            gaps = mc_step_vs_cpu(device, cfg)
            if (gaps["obs"] > MC_STEP_ATOL["obs"] or gaps["reward"] > MC_STEP_ATOL["reward"]
                    or gaps["done_mismatch"] or gaps["clips"] != list(range(ds["n_clips"]))):
                fail(f"driver (multi-clip): a control step on the card differs from the CPU "
                     f"float64 run: {gaps} (limits {MC_STEP_ATOL})")
            report.update(clips_drawn=clips, step_gaps=gaps)
        elif pair or rodent or fly or terrain or ball:
            built = sorted(os.listdir(os.path.join(data_dir, "clips")))
            if built != ["0.npz"]:
                fail(f"driver ({tag}) cached {built}")
        else:
            after = _tree(data_dir)
            if after != before or os.path.join(data_dir, "clips", "0.p") not in after:
                fail(f"driver (single clip) changed {data_dir}: {sorted(set(after) ^ set(before))}")
        if terrain:
            report["narrowphase_calls"] = len(calls)
            report["active_calls"] = {
                kind: [i for i, c in enumerate(calls) if c[kind]] for kind in calls[0]}
        if video:
            # the callback's n_steps + 1 qpos frames at the clip's rate
            clip_frames = int(ds["clip_length"])
            stride = max(1, round((n_steps + 1) / clip_frames))
            T = min(clip_frames, -(-(n_steps + 1) // stride))
            logged = [r for r in records if "rollout/video" in r]
            if len(captured) != 1 or [r["_step"] for r in logged] != [final]:
                fail(f"driver ({tag}) rendered {len(captured)} videos, logged at "
                     f"{[r['_step'] for r in logged]}, expected one at {final}")
            path = logged[0]["rollout/video"]
            name = os.path.basename(path)
            if (os.path.dirname(path) != os.path.join(base, "ckpt", run)
                    or name.rsplit(".", 1)[0] != f"rollout_{final}" or not os.path.isfile(path)):
                fail(f"driver ({tag}) logged the video {path}, which it did not write")
            frames = vid.count_frames(path)
            if frames != T or logged[0]["rollout/video_frames"] != T:
                fail(f"driver ({tag}) video of {frames} frames (logged "
                     f"{logged[0]['rollout/video_frames']}), expected {T}")
            report["video"] = dict(
                file=name, frames=frames, bytes=os.path.getsize(path),
                **{k[len("rollout/video_"):]: v for k, v in logged[0].items()
                   if k.startswith("rollout/video_") and k != "rollout/video_frames"})
            report["capture"] = captured[0]
        if replay:
            report["replay"] = phase_replay(device, base, cfg, n_steps, final, run,
                                            report["video"]["frames"])
    return report


def phase_replay(device, base, cfg, n_steps, step, run, frames):
    """examples/policy_replay.py on a driver run's directory with --video,
    on ``device``, the counts set to 0 just before: one reset and
    ``n_steps`` control steps of one env, so exactly 1 + n_steps x substeps
    cg_solve_fused launches (B = 1) and no other kernel (on the card); the
    per-frame table bitwise the callback's ``rollout_<step>.p`` for the same
    params (the same code on the same device and inputs); a video of
    ``frames`` frames. Returns its numbers."""
    import pickle

    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.examples import policy_replay
    from brax_tracking_tpu_torch.native import video as vid

    out = os.path.join(base, "replay")
    synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    policy_replay.main([base, "--video", "--device", str(device), "--out", out])
    synchronize(device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    substeps = int(cfg["dataset"]["env_args"]["physics_steps_per_control_step"])
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": 1 + substeps * n_steps}
    if torch.device(device).type == "cuda" and counts != expected:
        fail(f"replay launches {counts}, expected {expected}")
    with open(os.path.join(base, "ckpt", run, f"rollout_{step}.p"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(out, f"rollout_{step}.p"), "rb") as f:
        got = pickle.load(f)
    if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k]) for k in want):
        gaps = {k: float(np.max(np.abs(got[k] - want[k]))) for k in want if k in got}
        fail(f"replay's per-frame table differs from the callback's: {gaps}")
    videos = [p for p in os.listdir(out) if p.startswith(f"rollout_{step}.")
              and not p.endswith(".p")]
    if len(videos) != 1 or vid.count_frames(os.path.join(out, videos[0])) != frames:
        fail(f"replay wrote videos {videos}, expected one of {frames} frames")
    return dict(seconds=seconds, counts=counts, expected=expected["cg_solve_fused"],
                video=videos[0], rows=len(next(iter(got.values()))))


POSE_NAMES = ("geom_xpos", "geom_xmat", "cam_xpos", "cam_xmat")


def render_gaps(device, capture, dtype=None):
    """The render scene's poses of a driver run's video (``capture``:
    phase_driver's record of the call) computed on ``device`` in ``dtype``
    against the port's CPU float64 kinematics on the same qpos frames: the
    max abs gap of each pose array over all T frames, and the share of
    pixels that differ between the frames rasterized from each."""
    from brax_tracking_tpu_torch.harness import render

    scene, free = capture["scene"], capture["free_jnt"]
    m, r = render.load_scene(scene, free, device, dtype)
    qpos = render.scene_qpos(m, capture["qposes"].to(device, m.dtype),
                             capture["ref_traj"].to(device, m.dtype), free)
    poses = render.scene_poses(m, r, qpos)
    m64, _ = render.load_scene(scene, free, "cpu")
    want = render.scene_poses(m64, r, qpos.to("cpu", torch.float64))
    gaps = {k: float(np.abs(a - b).max()) for k, a, b in zip(POSE_NAMES, poses, want)}
    a = np.stack(render.render_frames(r, poses, capture["camera"]))
    b = np.stack(render.render_frames(r, want, capture["camera"]))
    gaps["pixel_share"] = float(np.any(a != b, axis=-1).mean())
    return gaps, len(qpos)


def phase_render_gate(capture, tag):
    """render_gaps on the card in float32 within RENDER_LIMITS."""
    gaps, T = render_gaps("cuda", capture)
    bad = {k: v for k, v in gaps.items() if v > RENDER_LIMITS[k]}
    if bad:
        fail(f"render ({tag}): the card's poses or frames differ from the CPU float64 ones "
             f"past the limits over {T} frames: {bad} (limits {RENDER_LIMITS})")
    return gaps, T


def encoder_version(module):
    """An optional video encoder's version, or "absent"."""
    import importlib

    try:
        return importlib.import_module(module).__version__
    except ImportError:
        return "absent"


# --- the last modules (ROADMAP A.13, A.15): a JAX orbax checkpoint on
# checkpoint=, debug_nans, bfloat16 MLPs, cameras that aim at a body ---------

# the JAX package's orbax checkpoints of a TrainingState at train_rodent's
# widths and the rodent stand-in's sizes (rodent/), of its bare
# (normalizer, params) tuple (rodent_reference/) and their arrays
# (rodent.npz), written by scripts/make_jax_checkpoint_fixture.py
JAX_CKPT_DIR = os.path.join(ROOT, "brax_tracking_tpu_torch", "assets", "jax_checkpoints")
# bfloat16 policy and value MLPs (256 x 256, 2048 observations of the rodent
# stand-in's 757) against float32 on the card: the max abs gap of the
# outputs. The CPU rehearsal (the same apply on the committed fixture's
# MLPs, bfloat16 against float32, 2048 seeded inputs, seeds 0-2) gaps at
# most 9.95e-3 (policy) and 6.6e-3 (value) at outputs up to 1.70; the limit
# leaves 3x
BF16_MLP_ATOL = 3e-2
BF16_OBS = 2048
# the cameras of assets/minirat_cameras.xml (targetbody, targetbodycom,
# track) at TARGET_CAM_FRAMES seeded poses on the card in float32 against
# the CPU in float64: the max abs gap of cam_xpos and cam_xmat. A float32
# CPU rehearsal of the same poses (target_camera_poses, seeds 0-2) is off
# float64 by at most 1.23e-7 (cam_xpos) and 1.17e-6 (cam_xmat); the limits
# leave 10x
TARGET_CAM_FRAMES = 64
TARGET_CAM_ATOL = {"cam_xpos": 1.3e-6, "cam_xmat": 1.2e-5}
# the debug_nans rollout: N_STEPS control steps of B_MAIN minirat envs
DEBUG_NANS_PLANT_STEPS = 2


def jax_fixture_arrays():
    """The committed JAX fixture's arrays by dotted orbax key."""
    with np.load(os.path.join(JAX_CKPT_DIR, "rodent.npz")) as z:
        return {k: z[k] for k in z.files}


def jax_fixture_mlp(arrays, name, device, dtype=torch.float32):
    """The fixture's ``name`` MLP (policy or value) as the port's MLP."""
    from brax_tracking_tpu_torch.agents.ppo import networks as pn

    n = len({k.split(".")[2] for k in arrays if k.startswith(f"params.{name}.")})
    return pn.params_from_numpy([{"kernel": arrays[f"params.{name}.{i}.kernel"],
                                  "bias": arrays[f"params.{name}.{i}.bias"]} for i in range(n)],
                                device=device, dtype=dtype)


def phase_jax_checkpoint(device, dtype=torch.float32):
    """training/checkpoint.py::restore_checkpoint (no orbax, tensorstore or
    zstandard on this machine) on both committed fixtures into a fresh
    training state on ``device``: every tensor bitwise the fixture's .npz:
    the params (each kernel transposed into its nn.Linear), the normalizer,
    and for the full state the Adam moments with optax's count as each
    parameter's step and env_steps; the reference tuple restores the
    params and normalizer only (no Adam state, env_steps 0). Returns the
    seconds of each restore and the tensors compared."""
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.training import checkpoint as pc

    arrays = jax_fixture_arrays()
    obs = arrays["params.policy.0.kernel"].shape[0]
    act = arrays["params.policy.2.bias"].shape[0] // 2
    report = {}
    for name in ("rodent", "rodent_reference"):
        full = name == "rodent"
        target = ppo_state(obs, act, PPO_HIDDEN, PPO_ARGS["learning_rate"], device, dtype, SEED)
        synchronize(device)
        t0 = time.perf_counter()
        got = pc.restore_checkpoint(os.path.join(JAX_CKPT_DIR, name), target)
        synchronize(device)
        seconds = time.perf_counter() - t0
        pairs = []
        for mlp in ("policy", "value"):
            for i, layer in enumerate(getattr(got.params, mlp).layers):
                for attr, key in (("weight", "kernel"), ("bias", "bias")):
                    p = getattr(layer, attr)
                    tr = (lambda a: a.T) if attr == "weight" else (lambda a: a)
                    k = f"params.{mlp}.{i}.{key}"
                    pairs.append((k, p, tr(arrays[k])))
                    if full:
                        st = got.optimizer.state[p]
                        for slot, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                            k = f"optimizer_state.0.{moment}.{mlp}.{i}.{key}"
                            pairs.append((k, st[slot], tr(arrays[k])))
                        pairs.append(("optimizer_state.0.count", st["step"],
                                      arrays["optimizer_state.0.count"].astype(np.float32)))
        for f in ("count", "mean", "summed_variance", "std"):
            pairs.append((f"normalizer_params.{f}", getattr(got.normalizer_params, f),
                          arrays[f"normalizer_params.{f}"]))
        bad = [k for k, t, a in pairs
               if not torch.equal(t.detach().cpu(), torch.as_tensor(np.array(a, order="C")))]
        if bad:
            fail(f"jax checkpoint ({name}): restored tensors differ from the fixture: {bad[:5]}")
        want_steps = int(arrays["env_steps"]) if full else 0
        if got.env_steps != want_steps or (not full and got.optimizer.state):
            fail(f"jax checkpoint ({name}): env_steps {got.env_steps} (expected {want_steps}), "
                 f"Adam state {'kept' if got.optimizer.state else 'empty'}")
        report[name] = dict(seconds=seconds, tensors=len(pairs))
    report["env_steps"] = int(arrays["env_steps"])
    report["bytes"] = {name: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                                 os.walk(os.path.join(JAX_CKPT_DIR, name)) for f in fs)
                       for name in ("rodent", "rodent_reference")}
    return report


def _tensors_of(x, out=None):
    """Every tensor reachable from ``x`` (dataclasses and containers)."""
    import dataclasses

    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors_of(getattr(x, f.name), out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors_of(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors_of(v, out)
    return out


def phase_debug_nans(device, B, seed, n_steps=N_STEPS):
    """training/debug_nans.py on the minirat tracking env (B envs, MLPs
    256 x 256): (a) rollout_step for ``n_steps`` control steps through
    debug_nans.call with the mode off and on, the counts set to 0 before
    each: every output tensor bitwise equal and N_SUBSTEPS launches per
    control step each; (b) a NaN planted in one policy bias, the mode on:
    FloatingPointError naming an aten op of agents/ppo/networks.py; (c) a
    NaN planted in a solve-kernel input (one env's qfrc_smooth), the
    kernels checked outside the dispatch mode (debug_nans.checking(ops=
    False)): FloatingPointError naming cg_solve_fused, and on a unit case
    (one SPD matrix with a NaN) naming spd_inverse. On the CPU (c) is not
    run: there the wrappers run the plain versions, which dispatch sees.
    Returns the two runs' counts and seconds and the messages."""
    import copy

    from brax_tracking_tpu_torch.agents.ppo import networks as pn
    from brax_tracking_tpu_torch.agents.ppo import train as pt
    from brax_tracking_tpu_torch.device import synchronize
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol
    from brax_tracking_tpu_torch.training import debug_nans

    env = make_env(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    first = env.reset(gen, B)
    obs, act = first.obs.shape[-1], env.action_size
    ts = ppo_state(obs, act, PPO_HIDDEN, PPO_ARGS["learning_rate"], device, first.obs.dtype, seed)
    eps = torch.randn((1, n_steps, B, act), generator=gen, dtype=first.obs.dtype, device=device)
    report, outs = {}, {}
    for on in (False, True):
        state = copy.deepcopy(first)
        synchronize(device)
        reset_counts()
        t0 = time.perf_counter()
        with debug_nans.debug_nans(on):
            outs[on] = debug_nans.call("rollout_step", pt.rollout_step, env,
                                       pn.make_inference_fn(ts.params), ts, state, eps)
        synchronize(device)
        report["on" if on else "off"] = dict(seconds=time.perf_counter() - t0,
                                             counts=read_counts())
    expected = dict.fromkeys(report["off"]["counts"], 0) | {"cg_solve_fused": N_SUBSTEPS * n_steps}
    if torch.device(device).type == "cuda" and any(
            report[k]["counts"] != expected for k in ("off", "on")):
        fail(f"debug_nans rollout launches {report['off']['counts']} (off), "
             f"{report['on']['counts']} (on), expected {expected}")
    a, b = _tensors_of(outs[False]), _tensors_of(outs[True])
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("debug_nans: the rollout with the mode on is not bitwise the rollout with it off")
    if debug_nans.has_nan(outs[True]):
        fail("debug_nans: the clean rollout's outputs hold a NaN")
    report["expected"], report["tensors"] = expected["cg_solve_fused"], len(a)

    bad = copy.deepcopy(ts)
    with torch.no_grad():
        bad.params.policy.layers[1].bias[3] = float("nan")
    try:
        with debug_nans.debug_nans():
            debug_nans.call("rollout_step", pt.rollout_step, env, pn.make_inference_fn(bad.params),
                            bad, copy.deepcopy(first), eps[:, :DEBUG_NANS_PLANT_STEPS])
        fail("debug_nans: a NaN policy bias raised nothing")
    except FloatingPointError as e:
        report["policy_bias"] = str(e)
        if "aten." not in str(e) or "agents/ppo/networks.py" not in str(e):
            fail(f"debug_nans: a NaN policy bias raised, naming no op of the policy: {e}")

    if torch.device(device).type == "cuda":
        _, args, kw = solve_case(device, "minirat", B, seed)
        args[8] = args[8].clone()
        args[8][0, 0] = float("nan")
        M = spd_inputs(device, 42, 8, seed)[0].clone()
        M[3, 1, 1] = float("nan")
        for name, launch in (("cg_solve_fused",
                              lambda: ops_cg.cg_solve_fused(*args, device=device, **kw)),
                             ("spd_inverse", lambda: ops_chol.spd_inverse(M, device=device))):
            try:
                with debug_nans.checking(f"a planted {name} case", ops=False):
                    launch()
                    synchronize(device)
                fail(f"debug_nans: a NaN input of {name} raised nothing")
            except FloatingPointError as e:
                report[name] = str(e)
                if f"the kernel {name}" not in str(e):
                    fail(f"debug_nans: a NaN input of {name} raised naming another: {e}")
    return report


def bf16_mlp_inputs(device, seed):
    """The committed JAX fixture's policy and value MLPs (256 x 256, trained
    widths) and BF16_OBS seeded observations on ``device``."""
    arrays = jax_fixture_arrays()
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(BF16_OBS, arrays["params.policy.0.kernel"].shape[0], generator=g,
                    device=device)
    return {name: jax_fixture_mlp(arrays, name, device) for name in ("policy", "value")}, x


def bf16_mlp_ms(seed):
    """Device ms per apply of each fixture MLP on the card in float32 and in
    bfloat16 (every kernel of the call, torch.profiler)."""
    from brax_tracking_tpu_torch.agents.ppo import networks as pn

    mlps, x = bf16_mlp_inputs("cuda", seed)
    with torch.no_grad():
        return {name: {"float32": library_device_ms(lambda: pn.apply_mlp(mlp, x)),
                       "bfloat16": library_device_ms(
                           lambda: pn.apply_mlp(mlp, x, torch.bfloat16))}
                for name, mlp in mlps.items()}


def phase_bf16_mlp(device, seed):
    """make_ppo_networks(compute_dtype=torch.bfloat16): the committed JAX
    fixture's policy and value MLPs on BF16_OBS seeded observations,
    bfloat16 against float32, within BF16_MLP_ATOL; then phase_ppo with
    bfloat16 networks (reached as the JAX package reaches it: a Python
    caller's network_factory): the same launches as phase_ppo, a finite
    state, params in float32. Returns the gaps and phase_ppo's report (the
    device times: bf16_mlp_ms)."""
    from brax_tracking_tpu_torch.agents.ppo import networks as pn

    mlps, x = bf16_mlp_inputs(device, seed)
    report = {"gaps": {}}
    for name, mlp in mlps.items():
        with torch.no_grad():
            f32 = pn.apply_mlp(mlp, x)
            bf16 = pn.apply_mlp(mlp, x, torch.bfloat16)
            gap = float((bf16 - f32).abs().max())
        report["gaps"][name] = gap
        if not gap <= BF16_MLP_ATOL or bf16.dtype != torch.float32:
            fail(f"bf16 {name} MLP: max |bf16 - f32| {gap:.3e} (limit {BF16_MLP_ATOL}), dtype "
                 f"{bf16.dtype}")
    ppo, _, (_, policy), _, _ = phase_ppo(device, seed, compute_dtype=torch.bfloat16)
    if {p.dtype for p in policy.parameters()} != {torch.float32} and \
            torch.device(device).type == "cuda":
        fail("bf16 train(): the policy's params left float32")
    report["ppo"] = ppo
    return report


def target_camera_poses(device, dtype, seed, n=TARGET_CAM_FRAMES):
    """scene_poses' cameras of assets/minirat_cameras.xml at ``n`` seeded
    poses (the free root's quaternion normalised), on ``device``."""
    from brax_tracking_tpu_torch.harness import render
    from brax_tracking_tpu_torch.physics import spec

    m = spec.load_model(spec.MINIRAT_CAMERAS_NPZ, device=device, dtype=dtype)
    r = spec.render_fields(spec.MINIRAT_CAMERAS_NPZ)
    rng = np.random.RandomState(seed)
    q0 = m.qpos0.cpu().numpy().astype(np.float64)
    qpos = np.tile(q0, (n, 1)) + rng.normal(0.0, 0.3, (n, q0.size))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    _, _, cam_xpos, cam_xmat = render.scene_poses(m, r, torch.as_tensor(qpos, device=m.device))
    return r, {"cam_xpos": cam_xpos, "cam_xmat": cam_xmat}


def phase_target_camera(device, seed, dtype=torch.float32):
    """The targetbody and targetbodycom cameras (and the track one) of
    assets/minirat_cameras.xml on ``device`` against the CPU in float64 at
    TARGET_CAM_FRAMES seeded poses: max abs gaps within TARGET_CAM_ATOL."""
    from brax_tracking_tpu_torch.physics import model as pm

    r, got = target_camera_poses(device, dtype, seed)
    _, want = target_camera_poses("cpu", torch.float64, seed)
    modes = sorted(int(c) for c in r.cam_mode)
    if modes != sorted([pm.CAM_TARGETBODY, pm.CAM_TARGETBODYCOM, pm.CAM_TRACK]):
        fail(f"target camera fixture: camera modes {modes}")
    gaps = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
    if any(gaps[k] > TARGET_CAM_ATOL[k] for k in gaps):
        fail(f"target cameras on the card against the CPU in float64: {gaps} (limits "
             f"{TARGET_CAM_ATOL})")
    return gaps


def print_video(tag, report, card):
    """The video's line: frames, file and the render's seconds."""
    v = report["video"]
    print(f"video ({tag}): {v['file']}, {v['frames']} frames of 480 x 640, {v['bytes']} bytes "
          f"from {RENDER_SCENES[tag]}: scene load {v['setup_s']:.3f} s, kinematics on the "
          f"device (one batch of {v['frames']} frames, with the copy to the host) "
          f"{v['kinematics_s']:.4f} s, rasterizing {v['raster_s_per_frame'] * 1e3:.2f} ms per "
          f"frame on the host, encoding {v['encode_s']:.3f} s on the host, {card}")


def spd_bound(name, B, nv):
    """Least time (ms) of one call on an H100 and what bounds it:
    max(bytes / HBM rate, FP32 operations / FP32 rate). Bytes: each input
    read once, each output written once; the Cholesky functions
    (spd_solve, factor_batched, solve_batched) need only the upper triangle
    of their matrix, nv (nv + 1) / 2 floats, and factor_batched writes all
    nv^2 of U. Operations, per matrix: nv^3 +
    2 nv^2 + nv per inverse (the symmetric sweep: per pivot a reciprocal,
    the pivot row scaled, one multiply-add on each entry of a triangle;
    Cholesky inversion, potrf + potri, also costs nv^3); the Cholesky
    nv^3 / 3 + nv^2 / 2 + nv (factor_batched), the two substitutions 2 nv^2
    (solve_batched), both for spd_solve."""
    mat = 4 * B * nv * nv
    tri = 4 * B * nv * (nv + 1) // 2
    if name == "spd_solve":
        nbytes = tri + 2 * 4 * B * nv
        flops = B * (nv**3 / 3 + 2.5 * nv * nv + nv)
    elif name == "factor_batched":
        nbytes = tri + mat
        flops = B * (nv**3 / 3 + 0.5 * nv * nv + nv)
    elif name == "solve_batched":
        nbytes = tri + 2 * 4 * B * nv
        flops = B * 2 * nv * nv
    else:
        ninv = 2 if name == "spd_inverse2" else 1
        nbytes = mat * (1 + ninv) + (4 * nv if ninv == 2 else 0)
        flops = ninv * B * (nv**3 + 2 * nv * nv + nv)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


# torch.profiler keeps only the device events that fall inside its window
# once their timestamps are moved to the host's clock, and on the H100 that
# move has put a launch a few milliseconds before its own host-side launch
# call, so a session with little idle time around the work lost some of
# them; idle time at both ends keeps them all
PROFILE_MARGIN_S = 0.05


def profile_device(fn, reps):
    """(name, device us) of every CUDA kernel and copy that ``reps`` calls
    of ``fn`` launch (after one warm call), from torch.profiler with
    PROFILE_MARGIN_S of idle time at both ends of the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, tag, reps=20):
    """Mean device time (ms) per call of ``fn`` of the CUDA kernels whose
    name holds ``tag`` (profile_device): at the ballmuscle's nv = 7 a launch
    takes less device time than the host needs to issue it, so CUDA events
    around a loop of launches time the host. A profile that does not see
    exactly ``reps`` launches is taken once more; a second miss fails."""
    for _ in range(2):
        ts = [t for name, t in profile_device(fn, reps) if tag in name]
        if len(ts) == reps:
            return sum(ts) / reps / 1e3
    fail(f"the profiler saw {len(ts)} launches of {tag} twice, expected {reps}")


def library_device_ms(fn, reps=20):
    """Mean device time (ms) per call of ``fn``: the sum of every CUDA
    kernel and copy that the calls launched (profile_device)."""
    ts = [t for _, t in profile_device(fn, reps)]
    if not ts:
        fail("the profiler saw no device time of the library call")
    return sum(ts) / reps / 1e3


def spd_calls(name, M, b, damp):
    """(kernel launch, library call, profiler tag of the kernel) of ``name``
    on (M, b, damp) (M is the factor for solve_batched): the launch alone,
    and the one PyTorch call computing the same function (torch.linalg.inv,
    twice for the pair, torch.linalg.solve, torch.linalg.cholesky or
    torch.cholesky_solve), which the port never calls."""
    from brax_tracking_tpu_torch.ops import cholesky as ops_chol

    if name == "spd_solve":
        kern = lambda: ops_chol._launch_solve(M, b)
        lib = lambda: torch.linalg.solve(M, b[..., None])
    elif name == "factor_batched":
        kern = lambda: ops_chol._launch_factor(M)
        lib = lambda: torch.linalg.cholesky(M)
    elif name == "solve_batched":  # M is the factor U
        kern = lambda: ops_chol._launch_solve_factor(M, b)
        lib = lambda: torch.cholesky_solve(b[..., None], M, upper=True)
    elif name == "spd_inverse2":
        kern = lambda: ops_chol._launch_inverse(M, damp, 2)
        lib = lambda: (torch.linalg.inv(M), torch.linalg.inv(M + torch.diag(damp)))
    else:
        kern = lambda: ops_chol._launch_inverse(M, None, 1)
        lib = lambda: torch.linalg.inv(M)
    tag = {"spd_solve": "spd_solve_kernel", "factor_batched": "factor_kernel",
           "solve_batched": "solve_kernel"}.get(name, "spd_inverse_kernel")
    return kern, lib, tag


def spd_times(name, M, b, damp):
    """(kernel device ms per launch, kernel host-clock ms per launch, plain
    ms, library host-clock ms, library device ms) on the same inputs
    (spd_calls)."""
    kern, lib, tag = spd_calls(name, M, b, damp)
    plain = lambda: spd_run(name, M, b, damp, "plain")
    reps = 50 if M.shape[-1] <= 73 else 10
    return (device_ms(kern, tag), time_cuda(kern, reps), time_cuda(plain, 3),
            time_cuda(lib, reps), library_device_ms(lib))


def bm_ms_per_substep(solver, B, n, seed):
    """Host-clock ms per substep of B ballmuscle envs, after one warm
    substep, ending in a synchronize."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = bm_model("cuda", solver)
    d = bm_posed(m, B)
    ctrls = bm_ctrls(m, B, n + 1, seed)
    d = pstep.step(m, d.replace(ctrl=ctrls[0]), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in ctrls[1:]:
        d = pstep.step(m, d.replace(ctrl=c), device="cuda")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def newton_ms_per_substep(B, n, seed):
    """Host-clock ms per substep of B Newton minirat envs, after one warm
    substep, ending in a synchronize."""
    from brax_tracking_tpu_torch.physics import step as pstep

    m = load("minirat_newton", "cuda")
    d = random_states(m, B, seed)
    ctrls = newton_ctrls(m, B, n + 1, seed)
    d = pstep.step(m, d.replace(ctrl=ctrls[0]), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in ctrls[1:]:
        d = pstep.step(m, d.replace(ctrl=c), device="cuda")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def time_cuda(fn, reps):
    """Mean ms per call over ``reps`` calls, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launch_statics(kw):
    return dict(ell0=kw["ell0"], iters=kw["iters"], ls_iters=kw["ls_iters"], tol=kw["tol"],
                dt=kw["dt"], has_damping=kw["has_damping"], stall_tol=kw.get("stall_tol", 0.0))


def kernel_launch(args, kw, batched=False):
    """The kernel launch alone (no P A einsum, no argument checks) on these
    inputs: what ``ms`` times. Launches made here do not count."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    ell = ops_cg._ell_table(kw["ell_mu"], kw["ell_scale"], torch.float32, args[0].device)
    ws, st = kw.get("warmstart"), _launch_statics(kw)
    if batched:
        return lambda: ops_cg._launch_batched(*args, ell, ws, **st)
    f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
    Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), md.shape[0]).contiguous()
    tables = ops_cg._int_tables(kw["row_slot"], kw["sz"], kw["root_bounds"],
                                kw["limit_dadr"], f.shape[-1], f.device)
    return lambda: ops_cg._launch(f, cdof, Bm, jsign, D, aref, exists, econ, qfs, qvel,
                                  damp, md, arm, ell, ws, tables, **st)


def iterations_run(args, kw, batched=False):
    """CG iterations each env runs (the kernel stops an env once it is
    done), from the float32 plain version's done flags after 1..iters-1
    iterations."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    B = args[0].shape[0]
    its = torch.ones(B, device=args[0].device)
    for k in range(1, kw["iters"]):
        done_k = plain(*args, **dict(kw, iters=k))[5]
        its += (~done_k).float()
    return its


def line_search_steps(args, kw, batched=False):
    """Line-search steps per CG iteration each env needs (the kernel leaves
    the line search at its first converged step, whose later steps would
    change nothing): the least k for which the float32 plain version with
    ls_iters = k gives the same qacc as with the full count, so every
    iteration of the env converged within k steps (an upper count)."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    full = plain(*args, **kw)[0]
    steps = torch.full((full.shape[0],), float(kw["ls_iters"]), device=full.device)
    same = torch.ones_like(steps, dtype=torch.bool)
    for k in range(kw["ls_iters"] - 1, 0, -1):
        same &= (plain(*args, **dict(kw, ls_iters=k))[0] == full).all(-1)
        steps[same] = float(k)
    return steps


def kernel_bound(args, kw, its, ls_steps, batched=False):
    """Least time of one call on an H100: max(bytes / HBM rate, FLOPs /
    FP32 rate), counting each input read once and each output written once,
    and the FLOPs of the CG iterations (``its``) and line-search steps per
    iteration (``ls_steps``) this data needs, per env. For cg_solve_fused qM
    is assembled only at its lower-triangle ancestor pairs (it is symmetric
    and zero elsewhere) and J only at its nonzeros (the md support of the
    contact rows, one entry per limit row); for cg_solve_batched the J
    products count the nonzeros of the J it is given. A phi' evaluation
    costs 6 FLOPs per quadratic row and 30 per elliptic contact; the
    warmstart adds its cost (qM (ws - a0), J ws) to the start."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    nell = len(kw["ell_mu"])
    ws = kw.get("warmstart")
    if batched:
        qM, J, D, aref, exists, econ, qfs, qvel, damp = args
        B, nefc, nv = J.shape
        j_nnz = float((J != 0).sum()) / B
        ins = list(args)
        build = 0
    else:
        f, cdof, A, jsign, D, aref, exists, econ, qfs, qvel, damp, P, md, arm = args
        B, _, nv = f.shape
        nefc, ncon = D.shape[1], md.shape[0]
        i = np.arange(nv)
        sz = np.asarray(kw["sz"])
        anc = int(((i[:, None] >= i[None, :]) & (i[:, None] < (i + sz)[None, :])).sum())
        rs = np.asarray(kw["row_slot"])
        j_con = int((md.cpu().numpy()[rs[rs >= 0]] != 0).sum())
        j_nnz = j_con + len(kw["limit_dadr"])
        Bm = ops_cg._bm(P, A, len(kw["root_bounds"]), ncon)
        ins = [f, cdof, Bm, jsign, D, aref, exists, econ, qfs, qvel, damp, md, arm]
        build = 12 * anc + nv + 12 * j_con  # qM (ancestor pairs, armature), contact rows of J
        # int tables
        ins.append(torch.empty(len(kw["row_slot"]) + 2 * nv + len(kw["limit_dadr"]),
                               dtype=torch.int32))
    if ws is not None:
        ins.append(ws)
    nbytes = sum(t.numel() * t.element_size() for t in ins) + 12 * nell  # ell table
    nbytes += B * (4 * (4 * nv + nefc) + 1)  # qacc qfrc a0 qvel_new, force, done
    nquad = nefc - 3 * nell
    cost = 6 * nquad + 30 * nell
    per_env = (
        build
        + nv**3 + 2 * nv * nv + nv + 2 * nv * nv  # SPD inverse (spd_bound), qacc_smooth
        + 4 * j_nnz + 2 * nv * nv + 2 * nefc + cost  # initial J x, J^T f, M^-1 grad, cost
        + (2 * nv * nv + 2 * j_nnz + cost + 4 * nv if ws is not None else 0)  # warmstart
        + 2 * j_nnz  # final J^T f
        + (nv**3 / 3 + 4 * nv * nv if kw["has_damping"] else 2 * nv)
    )
    per_iter = (
        4 * j_nnz + 4 * nv * nv + 20 * nv  # J p, J^T f, M p, M^-1 grad, dots
        + (6 * nquad + 30 * nell) * (1 + 13) + 4 * nefc + cost  # phi', step, cost
    )
    flops = float(B * per_env + its.sum().item() * per_iter
                  + (its * ls_steps).sum().item() * (6 * nquad + 30 * nell))  # line search
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def fused_times(args, kw, batched=False, reps=100):
    """(kernel device ms per launch, plain ms, bound ms, bound by, bytes,
    FLOPs, mean CG iterations) of cg_solve_fused, or cg_solve_batched, on
    these inputs. The kernel by torch.profiler over ``reps`` launches: the
    host's launch path takes about as long as a minirat launch, so CUDA
    events around a loop of launches would time the host."""
    from brax_tracking_tpu_torch.ops import cg as ops_cg

    plain = ops_cg.cg_solve_batched_reference if batched else ops_cg.cg_solve_fused_reference
    tag = "cg_batched_kernel" if batched else "cg_fused_kernel"
    k_ms = device_ms(kernel_launch(args, kw, batched), tag, reps)
    p_ms = time_cuda(lambda: plain(*args, **kw), 5)
    its = iterations_run(args, kw, batched)
    bound = kernel_bound(args, kw, its, line_search_steps(args, kw, batched), batched)
    return (k_ms, p_ms) + bound + (float(its.mean()),)


def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
          library_ms):
    return {"name": name, "route": "cuda",
            "source": f"brax_tracking_tpu_torch/ops/csrc/{source}",
            "replaces": f"brax_tracking_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    # the driver logs to wandb where it imports; a run here has no login, so
    # wandb runs as a no-op unless the caller set a mode
    os.environ.setdefault("WANDB_MODE", "disabled")
    t_start = time.perf_counter()
    from brax_tracking_tpu_torch.ops import cg as ops_cg
    from brax_tracking_tpu_torch.ops import library
    from brax_tracking_tpu_torch.physics import constraint as Cn
    from brax_tracking_tpu_torch.physics import solver as S
    from brax_tracking_tpu_torch.physics import step as pstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print("video encoders (native/video.py::save_video tries MP4, then AVI, then GIF): "
          + ", ".join(f"{mod} {encoder_version(mod)}" for mod in ("imageio", "PIL")))

    # 2. build
    secs = library.build()
    srcs = " ".join(os.path.basename(f) for f in library.SOURCES)
    print(f"build: {srcs} -> {secs:.1f} s")
    for model in (MODELS + PAIR_MODELS + ("rat", "rodent_standin") + FLY_MODELS
                  + PAIR_GATE_SCENES + ("minirat_planar",)):
        m = load(model, "cuda", torch.float32)
        layout = Cn.efc_layout(m)
        nell = int(S._cone_meta(m, layout).ell_con.size)
        nroots = len(S._fused_statics(m, layout)["root_bounds"])
        kl, smem, warps = ops_cg.kernel_layout(m.nv, layout.nefc, nell, nroots, m.ncon)
        print(f"{model}: kernel layout {kl}, {warps} warps and {smem} B of shared memory per env (nv={m.nv}, "
              f"nefc={layout.nefc}, elliptic contacts {nell}, roots {nroots}, contact slots "
              f"{m.ncon})")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    cases = {}
    for model, B, damped, iters in [
        ("minirat", B_MAIN, False, None), ("minirat", B_MAIN, True, None),
        ("minirat", B_MAIN - 1, False, None), ("minirat", B_MAIN - 1, True, None),
        ("minirat", B_MAIN, False, CONVERGED_ITERS), ("minirat", B_MAIN, True, CONVERGED_ITERS),
        ("minirat_elliptic", B_MAIN, False, None), ("minirat_elliptic", B_MAIN - 1, True, None),
        ("minirat_elliptic", B_MAIN, False, CONVERGED_ITERS),
        ("minirat_newton", B_MAIN, False, None), ("minirat_newton", B_MAIN - 1, False, None),
    ]:
        cases[model, B, damped, iters] = phase_kernel_vs_plain("cuda", B, damped, SEED, iters,
                                                               model)
    batched = {}
    for model, B in [("minirat", B_MAIN), ("minirat_elliptic", B_MAIN),
                     ("minirat_elliptic", B_MAIN - 1)]:
        batched[model, B] = phase_kernel_vs_plain("cuda", B, False, SEED, None, model,
                                                  batched=True)
    rodent = {}
    for B, iters in ((B_MAIN, None), (B_MAIN - 1, None), (B_MAIN, CONVERGED_ITERS)):
        rodent[B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, "rodent_like")
    # the wide core in layout 1 on the one-rat file (nv 73, the rodent's
    # width): cg_solve_fused's (a)
    rat = {B: phase_kernel_vs_plain("cuda", B, False, SEED, None, "rat")
           for B in (B_MAIN, B_MAIN - 1)}
    # the rodent stand-in (rodent.yaml's file, nv 73, its own joint damping):
    # the wide layout 1 with its damped Euler tail
    standin = {}
    for B, iters in ((B_MAIN, None), (B_MAIN - 1, None), (B_MAIN, CONVERGED_ITERS)):
        standin[B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, "rodent_standin")
        if not standin[B, iters][0]["damped"]:
            fail("the rodent stand-in's solve is not damped")
    # the fly stand-in, free and tethered (one root without a free joint):
    # the one-warp (b), the elliptic block, at the fly's widths
    flies = {}
    for model in FLY_MODELS:
        for B, iters in ((B_MAIN, None), (B_MAIN - 1, None), (B_MAIN, CONVERGED_ITERS)):
            flies[model, B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, model)
            _, args_f, kw_f, _ = flies[model, B, iters][1]
            if not kw_f["ell_mu"] or kw_f["has_damping"]:
                fail(f"the {model} solve is not the undamped elliptic instance (b)")
    # slide joints on the one-warp core (the planar minirat), and a per-env
    # armature ((B, nv), stride nv) in the one-warp and the wide layout 1
    # (damped) instances, each against its plain version; the stride-0
    # armature bitwise the same values repeated per env
    planar = phase_kernel_vs_plain("cuda", B_MAIN, False, SEED, None, "minirat_planar")
    armature = {}
    for model in ARMATURE_MODELS:
        for B in (B_MAIN, B_MAIN - 1):
            armature[model, B] = phase_kernel_vs_plain("cuda", B, False, SEED, None, model,
                                                       per_env_armature=True)
        phase_armature_stride("cuda", B_MAIN, model)
    print(f"solve kernel with a per-env armature: {ARMATURE_MODELS} at B={B_MAIN}, "
          f"{B_MAIN - 1}; stride 0 bitwise the repeated armature")
    # the narrowphase's scenes (the wide layout 1): the rodent stand-in on
    # its terrain (damped) and the props (8 roots)
    narrow = {}
    for model in PAIR_GATE_SCENES:
        for B, iters in ((B_MAIN, None), (B_MAIN - 1, None), (B_MAIN, CONVERGED_ITERS)):
            narrow[model, B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, model)
    if not narrow["rodent_standin_terrain", B_MAIN, None][0]["damped"]:
        fail("the terrain stand-in's solve is not damped")
    # the wide core against the one-warp core on the same inputs, bitwise,
    # where both take the same path (layout 1, nv > 16): undamped and with
    # the damped Euler tail; the fly stand-in's (b), free and tethered, and
    # the dense one-warp cases (the one-warp core by the rule; its panel
    # sweep at every odd width of the last panel), against the wide core
    # forced
    same = [(model, phase_wide_vs_one_warp("cuda", B, model, damped)) for model, B, damped in
            (("rat", B_MAIN, False), ("rat", B_MAIN - 1, False), ("rat", B_MAIN, True),
             ("rodent_standin", B_MAIN, False), ("rodent_standin", B_MAIN - 1, False),
             ("rodent_like", B_MAIN, False), ("l1_last", B_PAIR, False),
             ("fly_standin", B_MAIN, False), ("fly_standin_tethered", B_MAIN, False),
             ("narrow_last", B_PAIR, False))
            + tuple((f"one_warp_{nv}", B_PAIR, False) for nv, _ in ONE_WARP_DENSE)]
    print(f"wide core against the one-warp core: bitwise equal on (model, (B, damped)) {same}")
    # layout 2 (J in device memory): the stand-in's (a), (b), (c) and its
    # dense qM and J, the pair-size dense case and the design edges
    t_l2 = time.perf_counter()
    pair = {}
    for model, B, iters in [
        ("ratpair", B_PAIR, None), ("ratpair", B_PAIR - 1, None),
        ("ratpair", B_PAIR, CONVERGED_ITERS), ("ratpair_elliptic", B_PAIR, None),
        ("ratpair_newton", B_PAIR, None),
    ]:
        pair[model, B, iters] = phase_kernel_vs_plain("cuda", B, False, SEED, iters, model)
    pair["ratpair", "dense"] = phase_kernel_vs_plain("cuda", B_PAIR, False, SEED, None, "ratpair",
                                                     batched=True)
    for model, B in [("pair_like", B_PAIR), ("pair_like", B_PAIR - 1), ("narrow_last", B_PAIR),
                     ("wide_first", B_PAIR), ("l1_last", B_PAIR), ("l2_first", B_PAIR),
                     ("l2_last", B_PAIR)]:
        pair[model, B] = phase_kernel_vs_plain("cuda", B, False, SEED, None, model)
    print(f"layout 2 and the edges against the plain versions: {time.perf_counter() - t_l2:.1f} s "
          f"(at {PAIR_ROWS} rows: one warp / wide at nv {wide_edges()}, layout 1 / 2 / widest "
          f"at nv {l2_edges()})")
    spd_cases = {}
    for nv in SPD_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in SPD_KERNELS + CHOL_KERNELS:
                phase_spd_vs_plain(name, *chol_inputs(name, M, b, damp), "seeded", SPD_ABS)
            if B == B_MAIN:
                spd_cases[nv] = (M, b, damp)
    for nv in CHOL_EDGE_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in CHOL_EDGE_KERNELS:
                phase_spd_vs_plain(name, *chol_inputs(name, M, b, damp), "design edge", SPD_ABS)
    for nv in INV_EDGE_SIZES:
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in INV_EDGE_KERNELS:
                phase_spd_vs_plain(name, M, b, damp, "design edge", SPD_ABS)
    for nv in sorted(set(SPD_SIZES + CHOL_EDGE_SIZES + (10,))):
        for B in (B_MAIN, B_MAIN - 1):
            M, b, damp = spd_inputs("cuda", nv, B, SEED + nv)
            for name in CHOL_EDGE_KERNELS:
                phase_upper_only(name, *chol_inputs(name, M, b, damp))
    bm = bm_model("cuda", "newton")
    dbm = pstep.forward_to_constraint(bm, bm_posed(bm, B_MAIN))
    bm_inputs = (dbm.qM.contiguous(), dbm.qfrc_smooth.contiguous(),
                 (bm.dof_damping * bm.opt.timestep).contiguous())
    bm_reports = {name: phase_spd_vs_plain(name, *chol_inputs(name, *bm_inputs),
                                           "ballmuscle qM", SPD_ABS_BM)
                  for name in SPD_KERNELS + CHOL_KERNELS}
    # spd_inverse on the ball-coxa fly's own mass matrices (nv 42), its path
    bf = load("fly_standin_ball", "cuda")
    dbf = pstep.forward_to_constraint(bf, random_states(bf, B_MAIN, SEED, vel=1.0))
    fly_inputs = (dbf.qM.contiguous(), dbf.qfrc_smooth.contiguous(),
                  torch.zeros(bf.nv, device="cuda"))
    fly_report = phase_spd_vs_plain("spd_inverse", *fly_inputs, "ball fly qM", SPD_ABS_FLY)
    print(f"kernels against their plain versions: {time.perf_counter() - t0:.1f} s")

    # 3b. the 20 box, cylinder, mesh and height-field pair types on the card
    t0 = time.perf_counter()
    phase_pair_gates(B_MAIN, SEED)
    print(f"narrowphase pair gates: {time.perf_counter() - t0:.1f} s on {card}")

    # 4. the tracking rollouts: minirat (the main path) and elliptic minirat
    launches, envs = {}, {}
    for model in ("minirat", "minirat_elliptic"):
        t0 = time.perf_counter()
        env, counts, first_in, a0, first_out, last, touching = phase_rollout(
            "cuda", B_MAIN, SEED, model)
        torch.cuda.synchronize()
        envs[model] = env
        print(f"{model} rollout: {B_MAIN} envs x {N_STEPS} control steps x {N_SUBSTEPS} "
              f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
        expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": N_STEPS * N_SUBSTEPS}
        if counts != expected:
            fail(f"kernel launches in the {model} rollout: {counts}, expected {expected}")
        print(f"{model} rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
              f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
              f"{touching:.4f}")
        gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS, model)
        print(f"{model}_first_step_vs_cpu_f64 " + json.dumps(gaps))
    gaps, zones, counts = phase_elliptic_contacts("cuda", B_MAIN, SEED)
    print(f"minirat_elliptic contact substep: {B_MAIN} envs, converged, kernel launches "
          f"{counts}; active elliptic contacts per zone (bottom, middle, top) in the "
          f"float64 solution of {ELL_ROW_ENVS} envs {zones}")
    print("minirat_elliptic_contact_substep_vs_cpu_f64 " + json.dumps(gaps))
    # the rodent_pair env on the stand-in (layout 2), built from its config
    t0 = time.perf_counter()
    _, counts, first_in, a0, first_out, last, touching = phase_rollout(
        "cuda", B_PAIR, SEED, "ratpair", PAIR_STEPS)
    torch.cuda.synchronize()
    print(f"ratpair rollout: {B_PAIR} envs x {PAIR_STEPS} control steps x {PAIR_SUBSTEPS} "
          f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": PAIR_STEPS * PAIR_SUBSTEPS}
    if counts != expected:
        fail(f"kernel launches in the ratpair rollout: {counts}, expected {expected}")
    print(f"ratpair rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
          f"{touching:.4f}")
    gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS, "ratpair")
    print("ratpair_first_step_vs_cpu_f64 " + json.dumps(gaps))
    # the flagship rodent env on its stand-in (the wide layout 1, damped,
    # sensors every substep), built from its config
    t0 = time.perf_counter()
    env, counts, first_in, a0, first_out, last, touching = phase_rollout(
        "cuda", B_MAIN, SEED, "rodent_standin", RODENT_STEPS)
    torch.cuda.synchronize()
    envs["rodent_standin"] = env
    print(f"rodent_standin rollout: {B_MAIN} envs x {RODENT_STEPS} control steps x "
          f"{RODENT_SUBSTEPS} substeps, first run {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {counts}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": RODENT_STEPS * RODENT_SUBSTEPS}
    if counts != expected:
        fail(f"kernel launches in the rodent_standin rollout: {counts}, expected {expected}")
    sens = last.pipeline_state.sensordata
    print(f"rodent_standin rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
          f"{touching:.4f}, sensordata {tuple(sens.shape)} finite, envs with touch "
          f"{float((sens[:, 9:13] > 0).any(-1).float().mean()):.4f}")
    gaps = phase_first_step_on_cpu(first_in, a0, first_out, N_CPU_ENVS, "rodent_standin")
    print("rodent_standin_first_step_vs_cpu_f64 " + json.dumps(gaps))
    # the flagship rodent env on the terrain stand-in (the wide layout 1,
    # damped, every terrain pair type from the first substep)
    t0 = time.perf_counter()
    model = "rodent_standin_terrain"
    env, counts, first_in, a0, first_out, last, touching = phase_rollout(
        "cuda", B_MAIN, SEED, model, TERRAIN_STEPS)
    torch.cuda.synchronize()
    print(f"{model} rollout: {B_MAIN} envs x {TERRAIN_STEPS} control steps x {RODENT_SUBSTEPS} "
          f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
    expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": TERRAIN_STEPS * RODENT_SUBSTEPS}
    if counts != expected:
        fail(f"kernel launches in the {model} rollout: {counts}, expected {expected}")
    print(f"{model} rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
          f"{touching:.4f}, envs with an active slot per terrain pair type at the first step "
          f"{active_pair_types(env.unwrapped.model, first_out.pipeline_state.contact_dist)}")
    gaps = first_step_gaps(first_in, a0, first_out, N_CPU_ENVS, model)
    print(f"{model}_first_step_vs_cpu_f64 (CG 4/4, not gated) " + json.dumps(gaps))
    gaps = phase_converged_first_step(env, first_in, a0, model, TERRAIN_STEP_ATOL)
    print(f"{model}_first_step_converged_vs_cpu_f64 " + json.dumps(
        {"gaps": gaps, "limits": TERRAIN_STEP_ATOL}))
    # the props: physics/step.py::step on 2048 envs of 8 free props
    counts, seen, secs = phase_props("cuda", B_MAIN, SEED)
    launches["cg_solve_fused (props rollout)"] = counts["cg_solve_fused"]
    print(f"props rollout: {B_MAIN} envs x {PROPS_SUBSTEPS} substeps, {secs:.1f} s, kernel "
          f"launches {counts}; envs with an active slot per new pair type (most at a substep) "
          f"{seen} on {card}")
    # the fly envs on the fly stand-in (the one-warp (b), the fluid model),
    # free and tethered, built from their configs
    for model in FLY_MODELS:
        t0 = time.perf_counter()
        env, counts, first_in, a0, first_out, last, touching = phase_rollout(
            "cuda", B_MAIN, SEED, model, FLY_STEPS)
        torch.cuda.synchronize()
        envs[model] = env
        launches[f"cg_solve_fused ({model} rollout)"] = counts["cg_solve_fused"]
        print(f"{model} rollout: {B_MAIN} envs x {FLY_STEPS} control steps x {FLY_SUBSTEPS} "
              f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
        expected = dict.fromkeys(counts, 0) | {"cg_solve_fused": FLY_STEPS * FLY_SUBSTEPS}
        if counts != expected:
            fail(f"kernel launches in the {model} rollout: {counts}, expected {expected}")
        print(f"{model} rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
              f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
              f"{touching:.4f}, thorax height mean "
              f"{float(last.pipeline_state.xpos[:, env.unwrapped._thorax_idx, 2].mean()):.4f}")
        gaps = first_step_gaps(first_in, a0, first_out, N_CPU_ENVS, model)
        print(f"{model}_first_step_vs_cpu_f64 (CG 4/4, not gated) " + json.dumps(gaps))
        gaps = phase_converged_first_step(env, first_in, a0, model, FLY_STEP_ATOL[model])
        print(f"{model}_first_step_converged_vs_cpu_f64 " + json.dumps(gaps))
    # the ball-coxa fly stand-in off the kernel layout: fly_freejnt.yaml's env
    # on the array CG path (spd_inverse once per substep), then its Newton
    # copy on the array Newton path; the slide joints' planar minirat
    model = "fly_standin_ball"
    t0 = time.perf_counter()
    env, counts, first_in, a0, first_out, last, touching = phase_rollout(
        "cuda", B_MAIN, SEED, model, FLY_BALL_STEPS)
    torch.cuda.synchronize()
    print(f"{model} rollout: {B_MAIN} envs x {FLY_BALL_STEPS} control steps x {FLY_SUBSTEPS} "
          f"substeps, first run {time.perf_counter() - t0:.1f} s, kernel launches {counts}")
    expected = dict.fromkeys(counts, 0) | {"spd_inverse": FLY_BALL_STEPS * FLY_SUBSTEPS}
    if counts != expected:
        fail(f"kernel launches in the {model} rollout: {counts}, expected {expected}")
    print(f"{model} rollout done fraction at the last step: {float(last.done.mean()):.4f}, "
          f"mean reward {float(last.reward.mean()):.4f}, envs with contact forces "
          f"{touching:.4f}, envs with a ball-limit row in the first substep's solve "
          f"{ball_limit_share(env.unwrapped.model, first_in.pipeline_state):.4f} "
          f"(the posed phases below hold the limits' forces)")
    gaps = first_step_gaps(first_in, a0, first_out, N_CPU_ENVS, model)
    print(f"{model}_first_step_vs_cpu_f64 (CG 4/4, not gated) " + json.dumps(gaps))
    gaps = phase_converged_first_step(env, first_in, a0, model, FLY_BALL_STEP_ATOL)
    print(f"{model}_first_step_converged_vs_cpu_f64 " + json.dumps(
        {"gaps": gaps, "limits": FLY_BALL_STEP_ATOL}))
    envs[model] = env
    for posed in BALL_POSED_SUBSTEPS:
        t0 = time.perf_counter()
        counts, share, gaps = phase_ball_posed("cuda", B_MAIN, SEED, posed)
        print(f"{posed} (posed at its ball limits): {B_MAIN} envs x "
              f"{BALL_POSED_SUBSTEPS[posed]} substeps, {time.perf_counter() - t0:.1f} s, kernel "
              f"launches {counts}, envs with a ball-limit force after the first substep "
              f"{share:.4f}; first substep vs CPU float64 "
              + json.dumps({"gaps": gaps, "limits": BALL_POSED_ATOL[posed]}))
    t0 = time.perf_counter()
    counts, gaps = phase_slide("cuda", B_MAIN, SEED)
    launches["cg_solve_fused (slide)"] = counts["cg_solve_fused"]
    print(f"minirat_planar (slide joints): {B_MAIN} envs x {SLIDE_SUBSTEPS} substeps, "
          f"{time.perf_counter() - t0:.1f} s, kernel launches {counts}; first substep "
          f"(converged) vs CPU float64 " + json.dumps({"gaps": gaps, "limits": SLIDE_STEP_ATOL}))

    # 5. the ballmuscle slice, CG (i) and Newton (ii)
    for solver, kernel in (("cg", "spd_inverse2"), ("newton", "spd_solve")):
        t0 = time.perf_counter()
        counts, expected, iters, bm_in, bm_out = phase_ballmuscle("cuda", solver, B_MAIN, SEED)
        torch.cuda.synchronize()
        # the ballmuscle is damped: spd_inverse2 here, spd_inverse on the
        # ball fly's path (its driver run below)
        launches[kernel] = counts[kernel]
        print(f"ballmuscle {solver}: {B_MAIN} envs x {BM_SUBSTEPS} substeps, first run "
              f"{time.perf_counter() - t0:.1f} s, kernel launches {counts} (expected "
              f"{expected}; Newton iterations per substep {iters})")
        gaps = phase_bm_first_substep_on_cpu(solver, bm_in, bm_out, N_CPU_ENVS)
        print(f"ballmuscle_{solver}_first_substep_vs_cpu_f64 " + json.dumps(gaps))

    # 6. Newton on the kernel layout
    t0 = time.perf_counter()
    counts, chunks, nt_in, nt_out = phase_newton("cuda", B_MAIN, SEED)
    torch.cuda.synchronize()
    print(f"minirat_newton: {B_MAIN} envs x {NEWTON_SUBSTEPS} substeps, first run "
          f"{time.perf_counter() - t0:.1f} s, kernel launches {counts} (chunks per substep "
          f"{chunks})")
    gaps = phase_newton_first_substep_on_cpu(nt_in, nt_out, N_CPU_ENVS)
    print("minirat_newton_first_substep_vs_cpu_f64 " + json.dumps(gaps))

    # 7. the smooth dynamics: crb (dense) -> factor_m -> solve_m
    counts, res, qM, qLD, rhs = phase_smooth("cuda", B_MAIN, SEED)
    launches.update(factor_batched=counts["factor_batched"], solve_batched=counts["solve_batched"])
    print(f"smooth dynamics: {B_MAIN} minirat envs, kernel launches {counts}, solve_m "
          f"residual {res:.3e}")
    mr_damp = torch.zeros(qM.shape[-1], device="cuda")
    chol_reports = {name: phase_spd_vs_plain(name, *chol_inputs(name, qM, rhs, mr_damp),
                                             "minirat qM", SPD_ABS_BM)
                    for name in CHOL_KERNELS}

    # 8. the PPO trainer on the minirat tracking env (the main path)
    t_ppo = time.perf_counter()
    ppo, ppo_env, ppo_params, ppo_make_policy, ppo_init = phase_ppo("cuda", SEED)
    # cg_solve_batched lies on no step path (the JAX package has no caller
    # either): the main path's count of it is 0 (gated)
    launches.update(cg_solve_batched=ppo["counts"]["cg_solve_batched"])
    a, m = PPO_ARGS, ppo["metrics"]
    steps_per, n_unrolls, rows = ppo_geometry(a)
    print(f"ppo: kept at the flagship's widths: MLPs {PPO_HIDDEN}, " + ", ".join(
        f"{k} {a[k]}" for k in a if k not in PPO_CUTS))
    print("ppo: cut to the run's time: " + ", ".join(
        f"{k} {a[k]} (full {v})" for k, v in PPO_CUTS.items())
        + f"; {PPO_TRAIN_STEPS} training steps of {n_unrolls} unrolls, num_timesteps "
        f"{ppo['num_timesteps']}")
    print(f"ppo train(): {ppo['seconds']:.1f} s, kernel launches {ppo['counts']} (expected "
          f"cg_solve_fused {ppo_expected_launches(a, PPO_TRAIN_STEPS)}: 10 per control step and "
          f"one per reset), env_steps {ppo['num_timesteps']}, checkpoint round trip bitwise "
          f"({ppo['tensors']} tensors); training/sps {m['training/sps']:.1f} (host clock "
          f"{ppo['host_sps']:.1f}), eval/sps {m['eval/sps']:.1f}, eval/episode_reward "
          f"{m['eval/episode_reward']:.3f}, eval/avg_episode_length "
          f"{m['eval/avg_episode_length']:.3f} on {card}")
    early, avg_len = phase_ppo_eval_rollback(ppo_env, ppo_make_policy, ppo_params, SEED)
    print(f"ppo eval rollout: {a['num_eval_envs']} envs x {a['episode_length']} control steps, "
          f"{early} done (and rolled back) before the last step, mean episode length "
          f"{avg_len:.3f}")
    loss_gap, grad_gap, collect, learn = ppo_first_minibatch("cuda", SEED, ppo_init, ppo_env)
    print("ppo_first_minibatch_vs_cpu_f64 " + json.dumps({
        "loss_rel": loss_gap, "loss_limit": PPO_LOSS_REL, "grad_rel": grad_gap,
        "grad_limit": PPO_GRAD_REL}))
    if loss_gap > PPO_LOSS_REL or grad_gap > PPO_GRAD_REL:
        fail(f"ppo first minibatch on the card against the CPU in float64: loss {loss_gap:.3e} "
             f"(limit {PPO_LOSS_REL:.1e}), gradients {grad_gap:.3e} (limit {PPO_GRAD_REL:.1e})")
    T, U, M = a["unroll_length"], a["num_updates_per_batch"], a["num_minibatches"]
    print(f"ppo training step of {a['num_envs']} envs ({steps_per} env steps): collect "
          f"{steps_per / collect:.1f} env-steps/s, learn {steps_per / learn:.1f}, both "
          f"{steps_per / (collect + learn):.1f}; {collect / (n_unrolls * T) * 1e3:.2f} ms per "
          f"control step inside rollout_step; {learn / (U * M) * 1e3:.2f} ms per learner "
          f"minibatch update of {rows // M} rows x {T} steps on {card}")
    print(f"ppo eval/sps {m['eval/sps']:.1f} ({a['num_eval_envs']} envs) on {card}")
    print(f"ppo phase: {time.perf_counter() - t_ppo:.1f} s on {card}")

    # 8b. per-env randomized models: train() on the flagship rodent env on its
    # stand-in, unrandomized, equal-values and scaled (RAND_LEAVES)
    t_rand = time.perf_counter()
    runs, expected, gaps = phase_randomized_train("cuda", SEED)
    launches["cg_solve_fused (randomized rodent)"] = runs["scaled"]["counts"]["cg_solve_fused"]
    for mode, r in runs.items():
        print(f"randomized train ({mode}): {r['seconds']:.1f} s, kernel launches {r['counts']} "
              f"(expected cg_solve_fused {expected}), training/sps "
              f"{r['metrics']['training/sps']:.1f}, eval/episode_reward "
              f"{r['metrics']['eval/episode_reward']:.3f} on {card}")
    print("randomized train: the equal-values run's params, normalizer and eval reward bitwise "
          "the unrandomized run's")
    print("randomized_rodent_first_step_vs_cpu_f64 " + json.dumps(
        {"gaps": gaps, "limits": RAND_STEP_ATOL}))
    print(f"randomized phase: {time.perf_counter() - t_rand:.1f} s on {card}")

    # 8c. data parallel: (a) phase_ppo's train() through a process group of
    # one rank (NCCL), bitwise phase_ppo's; (b) two ranks on the one card
    # over gloo on the rodent stand-in, building the kernels at once
    t_dist = time.perf_counter()
    one = phase_distributed_one("cuda", SEED, ppo["final"])
    dist_launches = {f"world size 1 ({one['backend']})": one["counts"]["cg_solve_fused"]}
    print(f"distributed (a): train() through a {one['backend']} group of one rank: "
          f"{one['seconds']:.1f} s, kernel launches {one['counts']} (expected cg_solve_fused "
          f"{one['expected']}, as phase_ppo), every tensor of the final checkpoint "
          f"({one['tensors']}) bitwise phase_ppo's; training/sps "
          f"{one['metrics']['training/sps']:.1f} (phase_ppo's {ppo['metrics']['training/sps']:.1f})"
          f" on {card}")
    ranks, remover = phase_distributed_ranks(SEED)
    single_sps = runs["none"]["metrics"]["training/sps"]
    for r in ranks:
        dist_launches[f"rank {r['rank']} (gloo)"] = r["counts"]["cg_solve_fused"]
        print(f"distributed (b) rank {r['rank']} of {r['world_size']} on {r['device']} over "
              f"{r['backend']}: build {r['build_s']:.1f} s, train() {r['seconds']:.1f} s, kernel "
              f"launches {r['counts']} (expected cg_solve_fused {r['expected']}: "
              f"{'its two evals included' if r['rank'] == 0 else 'no evals'}), evals at "
              f"{r['evals']}, training/sps {r['metrics']['training/sps']:.1f} (all ranks' env "
              f"steps; the single-rank rodent train() above: {single_sps:.1f}) on {card}")
    print(f"distributed (b): {ranks[0]['tensors']} tensors of the final training state bitwise "
          f"equal on the {DIST_RANKS} ranks; the planted stale _build/lock removed by rank "
          f"{remover}, the other rank waited on the flock")
    print(f"distributed phase: {time.perf_counter() - t_dist:.1f} s on {card}")

    # 9. the driver, harness/driver.py::main (the main path): (i) single clip
    # from the committed clip cache, (ii) four clips
    t_drv = time.perf_counter()
    driver_launches = {}
    for multi in (False, True):
        r = phase_driver("cuda", multi)
        tag = "multi-clip" if multi else "single clip"
        driver_launches[tag] = r["counts"]["cg_solve_fused"]
        m = r["metrics"]
        per_clip = (f", per-clip rollout ({4 * 32} envs x {r['n_steps']} control steps) "
                    f"{r['per_clip_s']:.2f} s" if multi else "")
        print(f"driver ({tag}): main() {r['seconds']:.1f} s, kernel launches {r['counts']} "
              f"(expected cg_solve_fused {r['expected']}: train()'s and one reset and 10 per "
              f"control step of each callback rollout), training/sps "
              f"{m['training/sps']:.1f}, eval/sps {m['eval/sps']:.1f}, eval/episode_reward "
              f"{m['eval/episode_reward']:.3f}; training/walltime "
              f"{m['training/walltime']:.2f} s, eval/walltime {m['eval/walltime']:.2f} s; "
              f"callback: deterministic rollout (1 env x {r['n_steps']} control steps) "
              f"{r['rollout_s']:.2f} s{per_clip} on {card}")
        if multi:
            print(f"driver (multi-clip): training reset drew clips {r['clips_drawn']}")
            print("driver_multiclip_step_vs_cpu_f64 " + json.dumps(r["step_gaps"]))
    launches["cg_solve_fused"] = sum(driver_launches.values())
    print(f"driver phase: {time.perf_counter() - t_drv:.1f} s, cg_solve_fused launches "
          f"{driver_launches} on {card}")
    # the rodent_pair driver run on the stand-in: every solve in layout 2
    t_pair = time.perf_counter()
    r = phase_driver("cuda", False, pair=True)
    launches["cg_solve_fused (layout 2)"] = r["counts"]["cg_solve_fused"]
    m = r["metrics"]
    print(f"driver (pair): main() {r['seconds']:.1f} s, kernel launches {r['counts']} (expected "
          f"cg_solve_fused {r['expected']}: train()'s and one reset and 5 per control step of the "
          f"callback rollout), training/sps {m['training/sps']:.1f}, eval/sps "
          f"{m['eval/sps']:.1f}, eval/episode_reward {m['eval/episode_reward']:.3f}; "
          f"training/walltime {m['training/walltime']:.2f} s, eval/walltime "
          f"{m['eval/walltime']:.2f} s; callback: deterministic rollout (1 env x "
          f"{r['n_steps']} control steps) {r['rollout_s']:.2f} s on {card}")
    print(f"pair driver phase: {time.perf_counter() - t_pair:.1f} s on {card}")
    # the flagship's driver run on the rodent stand-in: every solve in the
    # wide layout 1, damped
    t_rod = time.perf_counter()
    r = phase_driver("cuda", False, rodent=True, video=True, replay=True)
    launches["cg_solve_fused (rodent stand-in)"] = r["counts"]["cg_solve_fused"]
    m = r["metrics"]
    print(f"driver (rodent): main() {r['seconds']:.1f} s, kernel launches {r['counts']} (expected "
          f"cg_solve_fused {r['expected']}: train()'s and one reset and 5 per control step of "
          f"the callback rollout), training/sps {m['training/sps']:.1f}, eval/sps "
          f"{m['eval/sps']:.1f}, eval/episode_reward {m['eval/episode_reward']:.3f}; "
          f"training/walltime {m['training/walltime']:.2f} s, eval/walltime "
          f"{m['eval/walltime']:.2f} s; callback: deterministic rollout (1 env x "
          f"{r['n_steps']} control steps) {r['rollout_s']:.2f} s on {card}")
    print_video("rodent", r, card)
    rp = r["replay"]
    print(f"replay (rodent): examples/policy_replay.py --video on the run's directory "
          f"{rp['seconds']:.1f} s, kernel launches {rp['counts']} (expected cg_solve_fused "
          f"{rp['expected']}: one reset and {RODENT_SUBSTEPS} per control step of 1 env), "
          f"per-frame table ({rp['rows']} rows) bitwise the callback's, video {rp['video']} "
          f"on {card}")
    gaps, T = phase_render_gate(r["capture"], "rodent")
    print(f"render_poses_and_frames_vs_cpu_f64 (rodent, {T} frames) "
          + json.dumps({"gaps": gaps, "limits": RENDER_LIMITS}))
    print(f"rodent driver phase: {time.perf_counter() - t_rod:.1f} s on {card}")
    # the flagship's command on the terrain stand-in, with its video
    t_ter = time.perf_counter()
    r = phase_driver("cuda", False, terrain=True, video=True)
    launches["cg_solve_fused (terrain stand-in)"] = r["counts"]["cg_solve_fused"]
    m = r["metrics"]
    print(f"driver (terrain): main() {r['seconds']:.1f} s, kernel launches {r['counts']} "
          f"(expected cg_solve_fused {r['expected']}: train()'s and one reset and 5 per control "
          f"step of the callback rollout), training/sps {m['training/sps']:.1f}, eval/sps "
          f"{m['eval/sps']:.1f}, eval/episode_reward {m['eval/episode_reward']:.3f}; "
          f"training/walltime {m['training/walltime']:.2f} s, eval/walltime "
          f"{m['eval/walltime']:.2f} s on {card}")
    steps = r["active_calls"]
    print(f"driver (terrain): narrowphase calls {r['narrowphase_calls']}; the calls with an "
          f"active slot of each terrain pair type (count, first, last): " + json.dumps(
              {k: [len(v), v[:1], v[-1:]] for k, v in steps.items()}))
    if len(steps) != 11 or not all(steps.values()):
        fail(f"driver (terrain): a terrain pair type never had an active slot: "
             f"{ {k: len(v) for k, v in steps.items()} }")
    print_video("terrain", r, card)
    from brax_tracking_tpu_torch.harness import render as hrender
    from brax_tracking_tpu_torch.native import softraster

    _, rf = hrender.load_scene(r["capture"]["scene"], r["capture"]["free_jnt"], "cpu")
    meshes = [g for g in range(rf.ngeom) if int(rf.geom_type[g]) == 7]
    drawn = [softraster.tessellate_geom(rf, g) is not None for g in meshes]
    if not meshes or not all(drawn):
        fail(f"render (terrain): mesh geoms {meshes} tessellated {drawn}")
    gaps, T = phase_render_gate(r["capture"], "terrain")
    print(f"render_poses_and_frames_vs_cpu_f64 (terrain, {T} frames, {len(meshes)} mesh geoms "
          f"drawn) " + json.dumps({"gaps": gaps, "limits": RENDER_LIMITS}))
    print(f"terrain driver phase: {time.perf_counter() - t_ter:.1f} s on {card}")
    # train=train_fly dataset=fly on the tethered fly stand-in: every solve
    # the one-warp (b)
    t_fly = time.perf_counter()
    r = phase_driver("cuda", False, fly=True, video=True)
    launches["cg_solve_fused (tethered fly)"] = r["counts"]["cg_solve_fused"]
    m = r["metrics"]
    print(f"driver (fly): main() {r['seconds']:.1f} s, kernel launches {r['counts']} (expected "
          f"cg_solve_fused {r['expected']}: train()'s and one reset and 5 per control step of "
          f"the callback rollout), training/sps {m['training/sps']:.1f}, eval/sps "
          f"{m['eval/sps']:.1f}, eval/episode_reward {m['eval/episode_reward']:.3f}; "
          f"training/walltime {m['training/walltime']:.2f} s, eval/walltime "
          f"{m['eval/walltime']:.2f} s; callback: deterministic rollout (1 env x "
          f"{r['n_steps']} control steps) {r['rollout_s']:.2f} s on {card}")
    print_video("fly", r, card)
    gaps, T = phase_render_gate(r["capture"], "tethered fly")
    print(f"render_poses_and_frames_vs_cpu_f64 (tethered fly, {T} frames) "
          + json.dumps({"gaps": gaps, "limits": RENDER_LIMITS}))
    print(f"fly driver phase: {time.perf_counter() - t_fly:.1f} s on {card}")
    # train=train_fly_freejnt on the ball-coxa fly stand-in: the array CG
    # path, spd_inverse once per substep and reset
    t_ball = time.perf_counter()
    r = phase_driver("cuda", False, ball=True)
    launches["spd_inverse"] = r["counts"]["spd_inverse"]
    m = r["metrics"]
    print(f"driver (ball fly): main() {r['seconds']:.1f} s, kernel launches {r['counts']} "
          f"(expected spd_inverse {r['expected']}: one per substep and reset), training/sps "
          f"{m['training/sps']:.1f}, eval/sps {m['eval/sps']:.1f}, eval/episode_reward "
          f"{m['eval/episode_reward']:.3f}; training/walltime {m['training/walltime']:.2f} s, "
          f"eval/walltime {m['eval/walltime']:.2f} s on {card}")
    print(f"ball fly driver phase: {time.perf_counter() - t_ball:.1f} s on {card}")

    # 9b. the last modules (ROADMAP A.13, A.15). (i) a JAX orbax checkpoint:
    # both committed fixtures restored without orbax, bitwise their .npz,
    # then the flagship's driver run on the rodent stand-in resumed from the
    # full one (checkpoint=), the damped wide layout 1 launched as in the
    # unresumed run
    t_ckpt = time.perf_counter()
    ck = phase_jax_checkpoint("cuda")
    for name in ("rodent", "rodent_reference"):
        print(f"jax checkpoint ({name}): restore_checkpoint {ck[name]['seconds']:.3f} s for "
              f"{ck['bytes'][name]} bytes of orbax OCDBT + zstd (the pure-Python reader on the "
              f"card's host), {ck[name]['tensors']} tensors bitwise the fixture's .npz on {card}")
    r = phase_driver("cuda", False, rodent=True, resume=(os.path.join(JAX_CKPT_DIR, "rodent"),
                                                         ck["env_steps"]))
    resumed = r["counts"]["cg_solve_fused"]
    if resumed != launches["cg_solve_fused (rodent stand-in)"]:
        fail(f"driver (rodent, resumed): {resumed} launches, the unresumed run "
             f"{launches['cg_solve_fused (rodent stand-in)']}")
    m = r["metrics"]
    print(f"driver (rodent, resumed from the JAX checkpoint at env_steps {ck['env_steps']}): "
          f"main() {r['seconds']:.1f} s, kernel launches {r['counts']} (the unresumed run's "
          f"{launches['cg_solve_fused (rodent stand-in)']}), callback and checkpoint at "
          f"env_steps {r['final']}, training/sps {m['training/sps']:.1f}, eval/sps "
          f"{m['eval/sps']:.1f}, "
          f"eval/episode_reward {m['eval/episode_reward']:.3f} on {card}")
    print(f"jax checkpoint phase: {time.perf_counter() - t_ckpt:.1f} s on {card}")
    # (ii) debug_nans on the minirat: a clean rollout bitwise with the mode
    # on and off, a NaN policy bias named by its op, NaN kernel inputs named
    # by their kernels
    t_nan = time.perf_counter()
    dn = phase_debug_nans("cuda", B_MAIN, SEED)
    print(f"debug_nans: rollout_step of {B_MAIN} minirat envs x {N_STEPS} control steps, mode "
          f"off {dn['off']['seconds']:.2f} s, on {dn['on']['seconds']:.2f} s (one clone of the "
          f"inputs, one host read of the outputs), {dn['tensors']} output tensors bitwise equal, "
          f"cg_solve_fused launches {dn['off']['counts']['cg_solve_fused']} / "
          f"{dn['on']['counts']['cg_solve_fused']} (expected {dn['expected']}) on {card}")
    for k in ("policy_bias", "cg_solve_fused", "spd_inverse"):
        print(f"debug_nans ({k} planted): FloatingPointError: {dn[k]}")
    print(f"debug_nans phase: {time.perf_counter() - t_nan:.1f} s on {card}")
    # (iii) bfloat16 MLPs: the apply against float32, its device time, and
    # train() through bfloat16 networks
    t_bf = time.perf_counter()
    b16 = phase_bf16_mlp("cuda", SEED)
    for name in ("policy", "value"):
        print(f"bf16 {name} MLP (256 x 256, {BF16_OBS} observations): max |bf16 - f32| "
              f"{b16['gaps'][name]:.3e} (limit {BF16_MLP_ATOL})")
    bp = b16["ppo"]
    print(f"bf16 train(): {bp['seconds']:.1f} s, kernel launches {bp['counts']} (phase_ppo's "
          f"{ppo['counts']}), training/sps {bp['metrics']['training/sps']:.1f} (phase_ppo's "
          f"{ppo['metrics']['training/sps']:.1f}), eval/episode_reward "
          f"{bp['metrics']['eval/episode_reward']:.3f} on {card}")
    if bp["counts"] != ppo["counts"]:
        fail(f"bf16 train(): launches {bp['counts']}, phase_ppo's {ppo['counts']}")
    print(f"bf16 phase: {time.perf_counter() - t_bf:.1f} s on {card}")
    # (iv) the cameras that aim at a body
    cam_gaps = phase_target_camera("cuda", SEED)
    print(f"target_cameras_vs_cpu_f64 ({TARGET_CAM_FRAMES} poses of assets/minirat_cameras.xml) "
          + json.dumps({"gaps": cam_gaps, "limits": TARGET_CAM_ATOL}))

    # 10. times. The solve kernels: every instance the gates held, with its
    # layout and warps per env (ops/cg.py::kernel_layout), each a row of the
    # kernels line. Launches are the main paths' counts: the one-warp fused
    # kernel's (a) in driver runs (i) and (ii), the wide layout 2's (a) in
    # the pair driver run, the wide layout 1's (a), damped, in the rodent
    # driver run, the one-warp (b) on the fly in the fly driver run
    # (tethered) and in the free fly's rollout; the other instances lie on
    # no path (0).
    entries = []
    solve_cases = [  # (gate's result, dense?, B, what, launches, profiled launches)
        (cases["minirat", B_MAIN, False, None], False, B_MAIN, "(a) minirat",
         launches["cg_solve_fused"], 100),
        (cases["minirat_elliptic", B_MAIN, False, None], False, B_MAIN, "(b) elliptic minirat",
         0, 100),
        (cases["minirat_newton", B_MAIN, False, None], False, B_MAIN, "(c) Newton minirat chunk",
         0, 100),
        (rat[B_MAIN], False, B_MAIN, "(a) one rat", 0, 20),
        (standin[B_MAIN, None], False, B_MAIN, "(a) rodent stand-in, damped",
         launches["cg_solve_fused (rodent stand-in)"], 20),
        (narrow["rodent_standin_terrain", B_MAIN, None], False, B_MAIN,
         "(a) rodent stand-in on the terrain, damped",
         launches["cg_solve_fused (terrain stand-in)"], 20),
        (narrow["props", B_MAIN, None], False, B_MAIN, "(a) props, 8 roots",
         launches["cg_solve_fused (props rollout)"], 20),
        (flies["fly_standin", B_MAIN, None], False, B_MAIN, "(b) fly stand-in, free root",
         launches["cg_solve_fused (fly_standin rollout)"], 100),
        (flies["fly_standin_tethered", B_MAIN, None], False, B_MAIN, "(b) fly stand-in, tethered",
         launches["cg_solve_fused (tethered fly)"], 100),
        (pair["ratpair", B_PAIR, None], False, B_PAIR, "(a) two-rat stand-in",
         launches["cg_solve_fused (layout 2)"], 10),
        (planar, False, B_MAIN, "(a) planar minirat, slide joints",
         launches["cg_solve_fused (slide)"], 100),
        (armature["minirat", B_MAIN], False, B_MAIN, "(a) minirat, per-env armature", 0, 100),
        (armature["rodent_standin", B_MAIN], False, B_MAIN,
         "(a) rodent stand-in, damped, per-env armature",
         launches["cg_solve_fused (randomized rodent)"], 20),
        (pair["ratpair_elliptic", B_PAIR, None], False, B_PAIR, "(b) two-rat stand-in elliptic",
         0, 10),
        (pair["ratpair_newton", B_PAIR, None], False, B_PAIR, "(c) two-rat stand-in Newton chunk",
         0, 10),
        (batched["minirat", B_MAIN], True, B_MAIN, "minirat", launches["cg_solve_batched"], 100),
        (batched["minirat_elliptic", B_MAIN], True, B_MAIN, "elliptic minirat",
         launches["cg_solve_batched"], 100),
        (rodent[B_MAIN, None], True, B_MAIN, "rodent-like", launches["cg_solve_batched"], 20),
        (pair["pair_like", B_PAIR], True, B_PAIR, "pair-like", launches["cg_solve_batched"], 10),
    ]
    for (report, (_, args, kw, _)), dense, B, what, n, reps in solve_cases:
        k_ms, p_ms, bound_ms, bound_by, nbytes, flops, its = fused_times(args, kw, dense, reps)
        if dense:
            kern, sizes = "cg_solve_batched", (args[1].shape[2], args[1].shape[1], args[5].shape[1])
        else:
            kern = "cg_solve_fused"
            sizes = (args[0].shape[2], args[4].shape[1], args[7].shape[1],
                     len(kw["root_bounds"]), args[12].shape[0])
        layout, _, warps = ops_cg.kernel_layout(*sizes)
        name = f"{kern} (layout {layout}, {warps} warp{'s' if warps > 1 else ''} per env, {what})"
        print(f"{name}: {k_ms * 1e3:.1f} us/launch at B={B} (plain {p_ms:.3f} ms; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by}: {nbytes} B, {flops:.3e} FLOP, mean CG "
              f"iterations {its:.2f}) on {card}")
        entries.append(entry(name, "cg_fused.cu", "cg.py:552" if dense else "cg.py:863", n,
                             max(report[nm]["kernel_max"] for nm in SCORED), k_ms, p_ms,
                             bound_ms, bound_by, None))
        # the data-parallel phase's launches: (a) on the minirat's one-warp
        # (a), (b)'s per rank on the rodent stand-in's damped wide layout 1
        if what == "(a) minirat":
            entries[-1]["distributed_launches"] = {
                k: v for k, v in dist_launches.items() if k.startswith("world")}
            entries[-1]["debug_nans_launches"] = {
                k: dn[k]["counts"]["cg_solve_fused"] for k in ("off", "on")}
            entries[-1]["bf16_train_launches"] = bp["counts"]["cg_solve_fused"]
        if what == "(a) rodent stand-in, damped":
            entries[-1]["distributed_launches"] = {
                k: v for k, v in dist_launches.items() if k.startswith("rank")}
            entries[-1]["resumed_driver_launches"] = resumed
        if what == "(a) minirat":
            w_ms = time_cuda(lambda: ops_cg.cg_solve_fused(*args, device="cuda", **kw), 100)
            print(f"cg_solve_fused wrapper with the P A einsum on minirat: {w_ms * 1e3:.1f} "
                  f"us/call on {card}")
    spd_meta = {
        "spd_inverse": ("spd_inverse.cu", 362),
        "spd_inverse2": ("spd_inverse.cu", 388),
        "spd_solve": ("cholesky.cu", 489),
        "factor_batched": ("cholesky.cu", 180),
        "solve_batched": ("cholesky.cu", 206),
    }
    # each kernel at nv = 7, 73 and 146 on seeded matrices, then at its
    # path's shape: the ballmuscle's own mass matrices (nv=7) for the SPD
    # kernels, the minirat's (nv=10) for the factor and the solve; B=2048.
    # The JSON line holds the path's shape.
    for name in SPD_KERNELS + CHOL_KERNELS:
        timed = [(nv, chol_inputs(name, *spd_cases[nv]), None) for nv in SPD_SIZES]
        if name in CHOL_KERNELS:
            timed.append((qM.shape[-1], chol_inputs(name, qM, rhs, mr_damp), "minirat"))
        elif name == "spd_inverse":
            timed.append((bf.nv, fly_inputs, "ball fly"))
        else:
            timed.append((bm.nv, chol_inputs(name, *bm_inputs), "ballmuscle"))
        for nv, ins, where in timed:
            t = spd_times(name, *ins)
            bnd = spd_bound(name, B_MAIN, nv)
            shape = (f"nv={nv} B={B_MAIN}" if where is None
                     else f"on the {where}'s qM (nv={nv}, B={B_MAIN})")
            print(f"{name} {shape}: kernel {t[0] * 1e3:.2f} us/launch on the device "
                  f"({t[1] * 1e3:.2f} us/launch on the host clock), plain {t[2]:.3f} ms, "
                  f"library {t[4] * 1e3:.2f} us on the device ({t[3] * 1e3:.2f} us on the "
                  f"host clock), bound {bnd[0] * 1e3:.3f} us by {bnd[1]} ({bnd[2]} B, "
                  f"{bnd[3]:.3e} FLOP) on {card}")
            if where is not None:
                rep = (chol_reports[name] if name in CHOL_KERNELS else fly_report
                       if name == "spd_inverse" else bm_reports[name])
                src, line = spd_meta[name]
                entries.append(entry(name, src, f"cholesky.py:{line}", launches[name],
                                     rep["max_abs_err"], t[0], t[2], bnd[0], bnd[1], t[4]))

    for model, env in envs.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        state = env.reset(gen, B_MAIN)
        acts = [2.0 * torch.rand(B_MAIN, env.action_size, generator=gen, device="cuda") - 1.0
                for _ in range(TIMED_STEPS)]
        state = env.step(state, acts[0])  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in acts:
            state = env.step(state, a)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{model} rollout: {B_MAIN * TIMED_STEPS / dt:.0f} env-steps/s "
              f"({dt / TIMED_STEPS * 1e3:.2f} "
              f"ms per control step of {B_MAIN} envs) on {card}")
    for solver in ("cg", "newton"):
        ms = bm_ms_per_substep(solver, B_MAIN, 10, SEED + 2)
        print(f"ballmuscle {solver}: {ms:.2f} ms per substep of {B_MAIN} envs on {card}")
    ms = newton_ms_per_substep(B_MAIN, 10, SEED + 2)
    print(f"minirat_newton: {ms:.2f} ms per substep of {B_MAIN} envs on {card}")
    for name, ms in bf16_mlp_ms(SEED).items():
        print(f"bf16 {name} MLP (256 x 256, {BF16_OBS} observations): device time per apply "
              f"{ms['bfloat16'] * 1e3:.2f} us in bfloat16, {ms['float32'] * 1e3:.2f} us in "
              f"float32 on {card}")

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-rank"]:
        sys.exit(distributed_rank(*sys.argv[2:4]))
    sys.exit(main())
