#!/usr/bin/env python3
"""Smoke run of ceres_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ceres_tpu_torch/csrc/ from the sources in this
checkout (into ceres_tpu_torch/_build/), and the native host library
(csrc/ceres_native.cpp, g++), then, on Snavely bundle
adjustment at the BAL-16-22106 shape (16 cameras, 22,106 points, 83,718
observations; the seeded synthetic problem at its perturbed start), on
two pose graphs (io/g2o.py's generators: SE3 with 2,000 poses, SE2 with
1,000; POSE_GRAPHS), on the JAX package's large-BA case (1,024
cameras, 200,000 points, 1,000,000 observations; IMPLICIT_SHAPE), on
the BAL-16-22106 problem with its cameras written as quaternions
(QUAT_PATHS), on the large case with its cameras written as
quaternions (QUAT_IMPLICIT_SCHUR), on the BAL-16-22106 problem with a
robust loss (ROBUST_PATHS), on the SE2 graph under Ceres's default
options (SE2_DEFAULT_PATHS), on pose graphs at the pose counts of
sphere2500 and M3500 (SPARSE_GRAPHS), on the BAL-16-22106 problem under
Ceres's bundle_adjuster options, f64 (BA_PATHS) and with quaternion
cameras on the product manifold (QUAT_BA_PATHS), on a problem of
Trafalgar's shape (257 cameras, 225,911 observations; TRAFALGAR), on
Trafalgar-126's shape (126 cameras, 40,037 points, 148,117
observations; FUSED_LARGE_M: nf 1,134, past the one-block K3 and K7),
on gradient problems and tiny least-squares batches (LINE_SEARCH_REF's
paths), on the BAL-16-22106 problem with 1% of its observations moved
30 px, filtered at ~4 px (COLMAP's default) between two solves
(OUTLIER), Problem.evaluate at Trafalgar's shape (EVALUATE), the seven
examples of slice 11 with every
More-Garbow-Hillstrom problem (EXAMPLE_RUNS, MGH_REF), the gradient
checker (GRADCHECK), slice 12's paths (`solver_options_paths`), slice
13's (`slice13_paths`: solve_batched in pipeline and batch mode, the C
API's curve_fitting.c, denoising, the libmv and NIST examples; its
comment block names each gate), slice 14's (`sharded_paths`: solves
sharded over torch.distributed ranks that parallel/launch.py spawns on
the card, NCCL at world 1 and gloo at worlds 4 and 2 with the ranks
sharing the card: bench.py's DENSE_SCHUR and ITERATIVE_SCHUR and the dry
run at BAL-16-22106, the large case in the implicit mode and the SE2
graph's sharded CGNR host loop, each rank's kernel and collective counts
read inside the rank; its comment block names each gate), slice 15's
(`slice15_paths`: the rest of batch mode, each part in batch and
pipeline mode on BA, pose-graph and curve-fit elements, held to the
JAX package's batched run, with a launch check of CGNR and
ITERATIVE_SCHUR at two batch sizes; its comment block names each gate)
and on tests/test_solver_e2e.py's helloworld, Powell and bounded
problems:

1. checks each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it: K1-K4 (slice 1, DENSE_SCHUR; K3 bit for
   bit, and its global-scratch variant on a seeded SPD system of
   K3_GLOBAL_M, past the shared-memory edge), K6 on the
   inverse of the first linearization at RADIUS, K7 on that reduced
   system with SCHUR_JACOBI and with IDENTITY blocks and on the first
   system of an ITERATIVE_SCHUR solve that runs past the refresh (every
   residual_reset_period iterations); K11 (slice 3) on
   each graph's main bucket (SE3 at the start and at a perturbed state,
   SE2 at the start), K8 on the scaled Jacobian of each graph's first
   linearization, K9 (slice 6) per row on each slot view of the SE3
   graph's scaled Jacobian and as its group kernel on each tangent-size
   group of both graphs (against its plain form within 1e-5, and its
   bits beside the unfused CUDA route's, reported); K10 (slice 4) on
   the scaled chunk tensors of the large case's first linearization at
   RADIUS and a seeded v, K11 on the large case's Snavely bucket (1M
   rows) at its start, K4 on the large case's start (1M rows, 1,024
   cameras); K5 (slice 5) on
   the quaternion problem's first linearization, with no loss and with
   HuberLoss(1.0), and K2, K6 and K3 (bit for bit) on its first
   linearization at RADIUS (nf 160), K7 on its ITERATIVE_SCHUR step's
   system there (m 160); K11's auto spec (slice 6) on the
   quaternion large case's bucket (1M rows) at its start, and K10 on that
   case's scaled
   chunk tensors (tf 10) as on the large case's; K1 with HuberLoss(1.0)
   and CauchyLoss(2.0) (its loss instances) on the main path's first
   linearization; K9's per-row form (slice 8) on each whole bucket of
   the SE3 graph's scaled first linearization, as the mixed
   SPARSE_NORMAL_CHOLESKY step forms its Grams; K1, K2, K6 and K4
   (slice 10) on Trafalgar-126's first linearization (K2 and K6 each
   output within F32_LIMIT or twice its plain version's own distance
   from the f64 run), and times the library Cholesky and the reduced CG
   on its first reduced systems; times each, its plain
   version
   and, where one PyTorch call computes the same function, that call,
   with CUDA events (median of 20 single calls; the kernel also as the
   mean of 100 back-to-back calls, "loop_ms"); times K3 against its
   library call, K2 and K6 against their plain versions and K9's group
   kernel against the per-slot route it replaced in turns (kernel,
   other, other, kernel; five rounds); and computes each
   kernel's bound from this run's inputs;
2. drives the paths, counting the launches of every kernel from zero
   before each solve: through ctt.solve on device="cuda", DENSE_SCHUR
   (slice 1), one warm-up and three timed solves; ITERATIVE_SCHUR with
   SCHUR_JACOBI (slice 2), one warm-up and two timed; CGNR with JACOBI on
   each pose graph (slice 3), one warm-up and two timed; ITERATIVE_SCHUR
   with SCHUR_JACOBI on the large case (slice 4, the implicit mode: nf =
   9,216 is past the explicit cap), one warm-up and two timed; and the
   implicit mode forced on BAL-16-22106 through the step and run_fused,
   one warm-up and one timed; the three quaternion paths (slice 5:
   DENSE_SCHUR, one warm-up and two timed; ITERATIVE_SCHUR with
   SCHUR_JACOBI, and DENSE_SCHUR with HuberLoss(1.0) and a cap of 100
   iterations, one warm-up and one timed each); ITERATIVE_SCHUR with
   SCHUR_JACOBI on the quaternion large case (slice 6, implicit: nf =
   10,240), one warm-up and one timed; DENSE_SCHUR on BAL-16-22106 with
   HuberLoss(1.0) and with CauchyLoss(2.0) (slice 7: K1's loss), one
   warm-up and one timed each; DENSE_SCHUR through the host-loop
   minimizer (fused_iterations=False, an IterationCallback recording each
   summary, minimizer_progress_to_stdout), one warm-up and two timed,
   its walls printed beside the fused DENSE_SCHUR solves'; the SE2 graph
   under SolverOptions() (LM, DENSE_QR, f64, the host loop), with
   DENSE_NORMAL_CHOLESKY and with SUBSPACE_DOGLEG, one warm-up and one
   timed each; slice 8 (`sparse_paths`), one warm-up and one timed each
   but the mixed SE3 one (two timed): SPARSE_NORMAL_CHOLESKY (f64, host
   loop, the native LDL^T) on SPARSE_GRAPHS' 2,500-pose SE3 and
   3,500-pose SE2 graphs, on the SE3 2,000 graph mixed and fused (K11,
   K9 per row), CGNR + SUBSET on the SE2 1,000 graph (mixed, fused), the
   SE2 1,000 graph f64 static, Covariance there (SPARSE_QR and
   DENSE_SVD, once each) and dynamic_sparsity; helloworld, Powell and
   the bounded problem, once each; slice 9 (`ba_paths`, the generic
   Schur step, the host loop): BA_PATHS (SPARSE_SCHUR + JACOBI, one
   warm-up and two timed; DENSE_SCHUR, ITERATIVE_SCHUR + SCHUR_JACOBI,
   DENSE_SCHUR with TRADITIONAL_DOGLEG, one warm-up and one timed each),
   QUAT_BA_PATHS (f64 SPARSE_SCHUR and mixed DENSE_SCHUR, one warm-up
   and one timed each), and examples/bundle_adjuster.run at Trafalgar's
   shape on its defaults (twice, the same state bits) and with
   --mixed_precision_solves (once); slice 10 (`fused_large_m_paths`):
   Trafalgar-126's shape with bench.py's DENSE_SCHUR and ITERATIVE_SCHUR
   + SCHUR_JACOBI, one warm-up and one timed each; and
   (`line_search_paths`) the tutorial's Rosenbrock, the extended
   Rosenbrock in EXT_ROSENBROCK_N parameters (one warm-up, one timed),
   bundle_adjuster --line_search on BAL-16-22106 and tiny_solve on
   TINY_BATCH problems (one warm-up, one timed, then the same batch on
   the CPU); slice 11 (`problem_api_paths`): OUTLIER (solve with
   bench.py's options, Problem.evaluate on the card, remove_outliers at
   OUTLIER_THRESHOLD with the points left bare, solve on the rebuilt
   program), EVALUATE (the full
   call with a CSR Jacobian twice, a subset, evaluate_residual_block on
   EVALUATE_BLOCKS blocks, each beside the same call on the CPU),
   EXAMPLE_RUNS and the 29 MGH solves, GRADCHECK (GradientChecker.probe
   on GRADCHECK_BLOCKS Snavely blocks at their start, at
   GRADCHECK_PRECISION, check_gradients solves of
   circle_fit and robot_pose_mle, GRADCHECK_WRONG); slice 16
   (`slice16_paths`, after slice 15's): K10's tiers bit for bit their
   plain version (K10_SEEDED's shapes past tier 0's bounds, and
   OPENCV_IMPLICIT's first linearization at (2, 3, 18)), registers and
   spills (cuobjdump -res-usage) and each launch's v staging printed, the
   general tier with its scratch in shared and in device memory;
   OPENCV_IMPLICIT (the large case with COLMAP's FULL_OPENCV camera) once
   through tier 1 and once through the general tier 2, which must
   repeat tier 1's counts and cost bits, each within twice the JAX runs'
   spread of the JAX final cost with K10 once a CG application; the
   LOSS_PATHS (ScaledLoss through K1's generated loss unit, per-row
   Huber through K1 with the lanes' scalars, quaternion per-row Cauchy
   with Ceres's quaternion functor through K5), K1 or K5 checked at the
   start within twice its plain version's own distance from its f64 run,
   one warm-up and one timed solve each in CONVERGENCE within
   LOSS_REL_TOL of the JAX cost with their kernels launched, K1 or K5
   once a linearization; DENOISING's K8 and K9 launches printed beside
   the 9-bucket grouping's;
3. fails unless every kernel agrees within its limit (K7 with the same CG
   iteration count, K10 bit for bit), every BAL-16-22106 solve ends in
   CONVERGENCE with a final cost within 1e-5 relative of 5.028773e+04,
   every kernel of a
   path (MAIN_PATH) launched at least once per LM iteration (K3 through
   its shared-memory variant on the DENSE paths, m 144 and 160), K2 and K3
   never on the ITERATIVE_SCHUR path, CG iterated more often than LM did;
   every pose-graph solve ends in CONVERGENCE within 1e-4 relative of the
   JAX package's final cost, cuts the mean position error below its share
   of the start, launches K11 once per linearization, K9's group kernel
   at least once per linearization per tangent-size group (printed) and
   K8 at least once per CG iteration, and no K1-K7, K10 or per-row K9;
   every implicit solve
   ends in CONVERGENCE (the large case within IMPLICIT_REF_REL_TOL of the
   JAX package's final cost), launches K10 at least once per CG iteration
   and K4 at least once per LM iteration, K11 once per linearization,
   and no K1-K3, K6-K9; every quaternion solve ends in CONVERGENCE
   within its tolerance of the JAX package's final cost, launches K5 at
   least once per accepted step and at most once per LM iteration plus
   one, K2 and K3 (DENSE) or K6 and K7 (ITERATIVE) at least once per LM
   iteration, and no K1, K4 or a kernel of another path; every
   quaternion large-case solve ends in CONVERGENCE within
   QUAT_IMPLICIT_REF_REL_TOL of the JAX package's final cost, launches
   K11's auto spec once per linearization and K10 at least once per CG
   iteration, and no other kernel; every robust-loss solve ends in
   CONVERGENCE within ROBUST_REF_REL_TOL of the JAX package's final
   cost with K1-K4 launched at least once per LM iteration; the host-loop
   solve takes HOST_LOOP_ITERATIONS LM iterations to 5.028773e+04 within
   1e-5, K1-K4 at least once per LM iteration, and its callback sees
   every iteration summary but the last (iteration 0 included); the SE2
   default-option solves end in CONVERGENCE within SE2_DEFAULT_REL_TOL of
   the JAX package's final cost, cut the position error below 0.5 of the
   start and launch no kernel (their LM counts are printed beside the JAX
   package's); the sparse paths end in CONVERGENCE within
   SPARSE_REL_TOL (f64) or POSE_REF_REL_TOL (mixed; SUBSET against the
   JAX f64 solve) of the JAX package's cost, cut the position error
   below their cut, run the native LDL^T (never a dense factor), launch
   no kernel in f64, and mixed K11 once a linearization, K9 per row at
   least once per LM iteration (and K8 once per CG iteration with
   SUBSET); dynamic_sparsity ends within 1e-8 of the static solve; the
   covariance blocks agree within COVARIANCE_AGREE_TOL between
   SPARSE_QR and DENSE_SVD and within COVARIANCE_REF_TOL of the JAX
   package's; the bundle_adjuster paths take the generic Schur step,
   end within their `tol` of the JAX package's cost on its generic route
   (f64 1e-9) in its LM count (but dogleg's, reported), launch no kernel
   in f64 and K11 at least once a linearization when mixed, and repeat
   their counts and cost (SPARSE_SCHUR the state's bits too); each
   Trafalgar run stops at 5 iterations within its `tol` of the JAX
   example's cost, every damped solve on the block-sparse S and no dense
   S formed; each Trafalgar-126 solve names its route past MAX_M,
   launches no K3 or K7, K1 once a linearization, K2 (DENSE) or K6
   (ITERATIVE) and K4 at least once an LM iteration and nothing else,
   stops at the JAX package's 50 iterations within its `tol` of the JAX
   cost and repeats its count and cost; the line-search paths launch no
   kernel, the Rosenbrocks keep the JAX package's iteration counts (the
   extended one its final cost within 10x), the BA line search ends
   within its `tol`, and the tiny batch matches the JAX package's count
   digest, converged flags and sum of x, and the port's CPU batch problem
   by problem; OUTLIER removes the JAX package's blocks (count and
   digest) and points, no error within OUTLIER_MARGIN of the threshold,
   leaves its counts, launches K2, K3 and K4 at least once an LM
   iteration and K1 once a linearization in both solves, and ends each
   within REF_REL_TOL of the JAX cost in its termination; EVALUATE's
   CSR structure is bit-equal to the CPU call's and its values, cost and
   gradient norm within EVALUATE_TOL of it and of the JAX package's;
   each example and MGH problem ends within its cost limit of the JAX
   run in its LM count (within twice the JAX runs' spread, MGH_REF, or
   LM_ROUNDING's allowance where it names the run), at LRE >= 4 where
   JAX is, launching no kernel; the probe's pass flags (and the sum of
   its largest errors within GRADCHECK_SUM_TOL), the checked solves and
   the wrong cost's message are the JAX package's; helloworld (45.125
   -> below 1e-12, x = 10), Powell (107.5 -> below 1e-12, |x_i| <
   2e-3; its LM count beside the 15 of Ceres's tutorial) and the
   bounded problem (clamped at (5, -4) within 1e-6)
   hold their tests' numbers and launch no kernel; the pose-graph,
   large-case and quaternion solves repeat the same LM and CG counts and
   final cost in every solve (the quaternion solves' counts are compared
   with the JAX package's in print only); and TF32 is off.

Prints the card's name and power limit, one line per check and solve, a
JSON line of the kernels (each kernel's launches from its MAIN_PATH solve
and from every path; K3's by variant too), and as its last line {"ok":
true, "device":
{...}}. Exits non-zero, with no ok line, when there is no CUDA device or
any phase fails.
"""

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

# the main path's problem: shape, generator seed and perturbation
SHAPE = dict(num_cameras=16, num_points=22106, num_observations=83718)
PERTURB = dict(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5)
REF_FINAL_COST = 50287.73       # the f64 DENSE_SCHUR final cost
REF_REL_TOL = 1e-5
F32_LIMIT = 1e-5                # K1, K2, K6: f32 kernels, other sum order
F64_LIMIT = 1e-12               # K4: f64 kernel
CG_LIMIT = 1e-3                 # the reduced CG past MAX_M (f32, on the
#   card) against the same CG in f64 on the CPU for as many iterations,
#   relative to the largest entry of y: on the CPU at nf 1,170 the f32 CG
#   is 1.5e-5 from the f64 one after its 2 iterations; a wrong product or
#   preconditioner block moves y by 1e-1 and more
# K3 and K10 round every product and sum apart in their plain versions'
# order, so the two give the same bits
K3_LIMIT = K10_LIMIT = 0.0
# K3's global-scratch variant (m past the shared-memory edge, 223) is
# checked on a seeded SPD system of this size
K3_GLOBAL_M = 512
# K7: y relative to the plain CG. Both run the f32 recurrence, but the
# kernel's warp and block reductions sum in another order than PyTorch's
# dots and matvec, and each CG iteration carries the difference on,
# amplified by the conditioning of S; 1e-4 leaves room for that over a few
# tens of iterations (the JAX package holds its Pallas kernel to 2e-5 at
# m = 144 on the CPU, where both sides sum alike).
PCG_LIMIT = 1e-4
RADIUS = 1e4                    # the initial trust-region radius
# slice 3: the pose graphs of io/g2o.py's generators, solved by LM with
# CGNR. `ref_cost` is the JAX package's final cost on the CPU with the
# same options (scripts/pose_graph_reference.py: 67 LM / 31,974 CG
# iterations in 3D, 17 / 4,139 in 2D); `error_cut` the share of the
# starting mean position error that the solve must get under. 2D takes
# tests/test_slam.py's 0.5 (the JAX solve reaches 0.082). In 3D the
# loop closures span 5 poses only, so the 2,000-pose chain keeps its
# drift: the JAX solve reaches 0.771 (14.394777 -> 11.098473), and the
# cut is 0.8, not test_slam.py's 0.65 for 30 poses.
POSE_GRAPHS = {
    "3d": dict(generator="synthetic_pose_graph_3d",
               args=dict(num_poses=2000, loop_every=5, seed=2),
               build="build_pose_graph_3d_problem",
               ref_cost=1114.9860075070787, error_cut=0.8),
    "2d": dict(generator="synthetic_pose_graph_2d",
               args=dict(num_poses=1000, loop_every=15, seed=1),
               build="build_pose_graph_2d_problem",
               ref_cost=98.97160674926891, error_cut=0.5),
}
POSE_REF_REL_TOL = 1e-4
# K11 relative limits on r and J (J: tests/test_pallas_linearize.py's)
K11_R_LIMIT, K11_J_LIMIT = 1e-5, 2e-4
# K11's dense-jet arithmetic per row, counted by hand from
# csrc/linearize.cu (a jet product 3N+1 flops, a sum N+1, N channels)
K11_FLOPS_PER_ROW = {"3d": 4984, "2d": 344, "snavely": 1991}
# slice 4: the JAX package's large-BA case
# (benchmarks/ba_scaling_benchmark.py --large), whose nf = 9,216 camera
# columns are past the explicit reduced-system cap, so ITERATIVE_SCHUR
# runs the matrix-free (implicit) step with K10 as its CG operator.
IMPLICIT_SHAPE = dict(num_cameras=1024, num_points=200000,
                      num_observations=1000000)
IMPLICIT_PERTURB = dict(rotation_sigma=0.01, translation_sigma=0.1,
                        point_sigma=0.05)


# The JAX package's final cost on the CPU with the same options
# (scripts/implicit_reference.py: 32 LM / 989 CG iterations). Its TPU
# trajectories ended between 694,240.006 and 694,297.702
# (benchmarks/hw_r5/ba_scaling_large*.log,
# benchmarks/hw_extra_20260819_091249/ba_scaling_large.log), 8e-5
# relative apart from f32 summation order alone; 2e-4 leaves room for the
# card's order as well.
IMPLICIT_REF_COST = 694294.6414661948
IMPLICIT_REF_REL_TOL = 2e-4
# slice 5: the main path's problem with its cameras written as w-first
# quaternions (Ceres's bundle_adjuster -use_quaternions, with its default
# -use_manifolds=false, so the quaternion is a plain Euclidean 4-block;
# the functor SnavelyReprojectionErrorWithQuaternions), solved through
# K5. `ref_cost` and `ref_iterations` are the JAX package's on the CPU
# with the same options (scripts/quaternion_reference.py); DENSE and
# ITERATIVE end 1.2e-5 apart there, so the gate `tol` cannot be tighter.
QUAT_PATHS = {
    "QUAT_DENSE_SCHUR": dict(
        solver="DENSE_SCHUR", huber=None, max_num_iterations=50,
        ref_cost=50279.85472566241, ref_iterations=16, tol=5e-5, trials=3),
    "QUAT_ITERATIVE_SCHUR": dict(
        solver="ITERATIVE_SCHUR", huber=None, max_num_iterations=50,
        ref_cost=50279.246067487875, ref_iterations=18, tol=5e-5, trials=2),
    "QUAT_DENSE_SCHUR_HUBER": dict(
        solver="DENSE_SCHUR", huber=1.0, max_num_iterations=100,
        ref_cost=42797.78733273453, ref_iterations=27, tol=1e-4, trials=2),
}


def quaternion_bal(bal_module):
    """The quaternion problem from package `bal_module` (ceres_tpu.io.bal
    or ceres_tpu_torch.io.bal; both build the same bits): the main path's
    problem, converted to quaternion cameras before the perturbation."""
    bal = bal_module.synthetic_bal_problem(**SHAPE, seed=7,
                                           pixel_noise=1.0).to_quaternions()
    bal.perturb(**PERTURB, seed=8)
    return bal


def quaternion_options(mod, path, **extra):
    """The options of QUAT_PATHS[path] in package `mod` (ceres_tpu or
    ceres_tpu_torch); `extra` adds or overrides options."""
    cfg = QUAT_PATHS[path]
    kw = dict(linear_solver_type=getattr(mod.LinearSolverType, cfg["solver"]),
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=cfg["max_num_iterations"],
              function_tolerance=1e-6, max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


# slice 6: the large case with its cameras written as w-first
# quaternions before IMPLICIT_PERTURB (bundle_adjuster -use_quaternions,
# Euclidean quaternion blocks): nf = 10,240 camera columns, past the
# explicit cap, so ITERATIVE_SCHUR runs the implicit step, its Jacobian
# from K11's auto spec (SnavelyReprojectionErrorWithQuaternions has no
# hand spec) and its CG operator K10 (te 3, tf 10, r 2). The reference is
# the JAX package's final cost on the CPU with large_options and a cap of
# QUAT_IMPLICIT_MAX_ITERATIONS (scripts/implicit_reference.py
# --quaternions: 44 LM / 862 CG iterations to 693780.9325983456, the
# same bits with one XLA thread). Quaternion trajectories are chaotic in
# f32 (ROADMAP.md section 3): the JAX package from the perturbed start
# scaled by 1 - 1e-7, 1 + 1e-7 and 1 + 2e-7 (--start-scale) takes 52 /
# 1,051, 83 / 2,962 and 88 / 2,635 to 693778.3902993316,
# 693589.9797274848 and 693607.4398342273; the port on the CPU (plain
# kernels) 51 / 1,008 to 693814.7147862421 with one thread and 86 /
# 3,035 to 693605.4250193927 with four. These CPU runs end 3.24e-4 of
# the reference apart, so the gate on the final cost is twice that
# spread, not the angle-axis case's 2e-4, and the LM and CG counts are
# reported, not gated. The cap is the largest LM count of those runs
# (88) with a quarter of headroom, not large_options' 45, at which the
# port on the CPU (one thread) and the card stop without converging.
QUAT_IMPLICIT_REF_COST = 693780.9325983456
QUAT_IMPLICIT_REF_ITERATIONS = (44, 862)
QUAT_IMPLICIT_REF_REL_TOL = 6.5e-4
QUAT_IMPLICIT_MAX_ITERATIONS = 110


# the default-Solve slice (the host-loop trust-region minimizer, the
# dense solvers, f64): the 1,000-pose SE2 graph of POSE_GRAPHS["2d"]
# under Ceres's default SolverOptions() (LM, DENSE_QR, f64, the host
# loop), then with DENSE_NORMAL_CHOLESKY and with SUBSPACE_DOGLEG. J is
# 3,198 x 2,997 f64, formed densely by DENSE_QR. `ref_cost` and
# `ref_iterations` (LM) are the JAX package's on the CPU with the same
# options (scripts/default_solve_reference.py); the gate is 1e-8 of the
# cost, the iteration counts are reported beside the JAX ones.
SE2_DEFAULT_PATHS = {
    "SE2_DENSE_QR": dict(options={}, ref_cost=98.97160651954493,
                         ref_iterations=10),
    "SE2_DENSE_NORMAL_CHOLESKY": dict(
        options=dict(linear_solver_type="DENSE_NORMAL_CHOLESKY"),
        ref_cost=98.97160651954493, ref_iterations=10),
    "SE2_SUBSPACE_DOGLEG": dict(
        options=dict(trust_region_strategy_type="DOGLEG",
                     dogleg_type="SUBSPACE_DOGLEG"),
        ref_cost=98.97160652093707, ref_iterations=6),
}
SE2_DEFAULT_REL_TOL = 1e-8
# slice 8: SPARSE_NORMAL_CHOLESKY on the port's native host LDL^T. Two
# pose graphs at the pose counts of the standard sphere2500 (SE3) and M3500
# (SE2) graphs, where CGNR + JACOBI hits the LM cap, solved with
# pose_graph_3d.cc's options (sparse_options: f64, the host loop). The
# references are the JAX package's on the CPU with the same options
# (scripts/sparse_reference.py): its final cost, LM count and mean
# position error after / before; the error cut is that share plus a
# margin, as POSE_GRAPHS' 0.8 for 0.771.
SPARSE_GRAPHS = {
    "SE3_2500_SNC": dict(generator="synthetic_pose_graph_3d",
                         args=dict(num_poses=2500, loop_every=5, seed=2),
                         build="build_pose_graph_3d_problem",
                         ref_cost=1427.9997044069296, ref_iterations=16,
                         ref_error_share=0.2170719355544472,
                         error_cut=0.25),
    "SE2_3500_SNC": dict(generator="synthetic_pose_graph_2d",
                         args=dict(num_poses=3500, loop_every=15, seed=1),
                         build="build_pose_graph_2d_problem",
                         ref_cost=319.7886355699033, ref_iterations=16,
                         ref_error_share=0.1968058469005025,
                         error_cut=0.23),
}
SPARSE_REL_TOL = 1e-8
# the 2,000-pose SE3 graph (POSE_GRAPHS["3d"]) with SPARSE_NORMAL_CHOLESKY
# in pose_graph_options (mixed, fused): its Grams from K9's per-row form;
# the JAX package's mixed final cost and LM count on the CPU
SNC_MIXED_REF = dict(ref_cost=1114.8318491297086, ref_iterations=13)
# the 1,000-pose SE2 graph (POSE_GRAPHS["2d"]) with CGNR + SUBSET, the
# odometry rows (the first SUBSET_ROWS residual blocks) as the subset,
# mixed, fused. The JAX package's mixed CGNR + SUBSET does not trace (its
# preconditioner returns f64 into the f32 CG loop), so the reference is
# its f64 solve, fused, with the same preconditioner.
SUBSET_ROWS = 999
SUBSET_REF = dict(ref_cost=98.9716073821834, ref_iterations=10,
                  ref_cg=39)
# the 1,000-pose SE2 graph with sparse_options (static) and with
# dynamic_sparsity; the JAX package's static final cost and LM count
SE2_SNC_REF = dict(ref_cost=98.97160651954495, ref_iterations=10)
# Covariance after the static solve: the blocks (p_k, p_k), (yaw_k, yaw_k)
# and (p_k, yaw_k) of COVARIANCE_POSES, by SPARSE_QR (2,997 effective
# parameters: the native path) and DENSE_SVD on the card; the JAX
# package's SPARSE_QR blocks on the CPU at its own solve's end.
COVARIANCE_POSES = (1, 250, 500, 750, 999)
COVARIANCE_REF = [
    # pose 1: (p, p), (yaw, yaw), (p, yaw)
    [[0.002343832481498142, -8.656766597867308e-10],
     [-8.656766597867308e-10, 0.002344323231589947]],
    [[0.00037485842057388274]],
    [[3.261936318945786e-06], [-3.3813774095666384e-06]],
    # pose 250: (p, p), (yaw, yaw), (p, yaw)
    [[0.11639693140775774, -0.0469690887894046],
     [-0.04696908878940458, 0.08316331451465896]],
    [[0.007495281420345086]],
    [[-0.018726833966395524], [0.011232226242663184]],
    # pose 500: (p, p), (yaw, yaw), (p, yaw)
    [[0.5624613540540548, 0.15210487563962127],
     [0.15210487563962102, 0.19240071264117897]],
    [[0.013737662031780921]],
    [[-0.06379193233376437], [-0.031016135435207464]],
    # pose 750: (p, p), (yaw, yaw), (p, yaw)
    [[0.3481789540678672, -0.06112374502219405],
     [-0.061123745022193546, 0.9754156538912786]],
    [[0.018740277854993128]],
    [[0.020180220070912726], [-0.11113076141131578]],
    # pose 999: (p, p), (yaw, yaw), (p, yaw)
    [[1.1097532572022526, -0.028770207690352868],
     [-0.0287702076903529, 0.4737123614739591]],
    [[0.02833724123230896]],
    [[0.12412206124847144], [-0.0016117719142837164]],
]
COVARIANCE_AGREE_TOL = 1e-8     # SPARSE_QR against DENSE_SVD, relative
COVARIANCE_REF_TOL = 1e-7       # against the JAX package, relative


def sparse_options(mod, **extra):
    """pose_graph_3d.cc's options in package `mod`: SPARSE_NORMAL_CHOLESKY,
    100 iterations, otherwise SolverOptions() (f64, the host loop)."""
    kw = dict(linear_solver_type=mod.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
              max_num_iterations=100)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def subset_options(mod, problem, **extra):
    """CGNR + SUBSET on `problem`'s first SUBSET_ROWS residual blocks, the
    rest of pose_graph_options."""
    return pose_graph_options(
        mod, preconditioner_type=mod.PreconditionerType.SUBSET,
        residual_blocks_for_subset_preconditioner=problem.residual_blocks()[
            :SUBSET_ROWS], **extra)


def covariance_pairs(positions, yaws):
    """The requested pairs of COVARIANCE_POSES, in order."""
    pairs = []
    for k in COVARIANCE_POSES:
        pairs += [(positions[k], positions[k]), (yaws[k], yaws[k]),
                  (positions[k], yaws[k])]
    return pairs
# BAL-16-22106 with HuberLoss(1.0) and with CauchyLoss(2.0) on
# DENSE_SCHUR (mixed, fused): K1 with its loss. `ref_cost` is the JAX
# package's final cost on the CPU (scripts/default_solve_reference.py
# --paths huber,cauchy: 48 and 38 LM iterations). Its own runs from the
# start scaled by 1 -+ 1e-7 end within 3.7e-9 (Huber) and 1.3e-8
# (Cauchy) of it, so the gate stays the main path's 1e-5 (ROADMAP.md
# section 3). CauchyLoss(1.0) would take ~175 LM iterations there, its
# runs 7.6e-6 apart.
# slice 9: Ceres's bundle_adjuster on its own defaults (f64,
# SPARSE_SCHUR + JACOBI, eta 1e-2, 500 CG iterations at most, the host
# loop) through the generic Schur step (solvers/schur.py
# SchurLinearSolver; no kernel runs in f64) on the main path's problem.
# `ref_cost` and `ref_iterations` (LM) are the JAX package's on the CPU
# with the same options on its generic route (CERES_TPU_NO_FUSED_SCHUR,
# the route the port takes; its fused f64 route gives the same LM counts
# and, but ITERATIVE's last bits, the same costs), by
# scripts/bundle_adjuster_reference.py --spread --fused. The paths run to
# convergence (BA_MAX_ITERATIONS) and hold the LM count and the cost
# within `tol`: BA_F64_REL_TOL, also for ITERATIVE, whose JAX runs from
# the start scaled by 1 -+ 1e-7 end 4.3e-16 apart with the same counts
# (6 LM, 77 CG; printed beside the card's), 4.4e-12 from the exact
# solvers' cost. Dogleg is chaotic here: each Gauss-Newton point is
# first tried with D = 1e-12, 1e-10, 1e-8, whose D^2 lies at the
# rounding level of the scaled S of a problem with a 7-dimensional gauge
# freedom, so whether the Cholesky there passes is decided by rounding:
# the JAX runs from the start scaled by 1 - 1e-7, 1 + 1e-7 and 1 - 2e-7
# take 9, 23 and 19 LM to 50461.79 (3.46e-3 above the unscaled run's 16
# LM to 50287.73; the port on the CPU 11 LM to 50461.7936). Its gate is
# twice that spread, its LM count reported.
BA_MAX_ITERATIONS = 100
BA_F64_REL_TOL = 1e-9
BA_PATHS = {
    "BA_SPARSE_SCHUR": dict(
        options=dict(linear_solver_type="SPARSE_SCHUR"),
        ref_cost=50287.7269104353, ref_iterations=6, tol=BA_F64_REL_TOL,
        trials=3),
    "BA_DENSE_SCHUR": dict(
        options=dict(linear_solver_type="DENSE_SCHUR"),
        ref_cost=50287.7269104353, ref_iterations=6, tol=BA_F64_REL_TOL,
        trials=2),
    "BA_ITERATIVE_SCHUR": dict(
        options=dict(linear_solver_type="ITERATIVE_SCHUR",
                     preconditioner_type="SCHUR_JACOBI"),
        ref_cost=50287.7269106568, ref_iterations=6, ref_cg=77,
        tol=BA_F64_REL_TOL, trials=2),
    "BA_DOGLEG": dict(
        options=dict(linear_solver_type="DENSE_SCHUR",
                     trust_region_strategy_type="DOGLEG"),
        ref_cost=50287.726941923705, ref_iterations=16, tol=7e-3,
        trials=2),
}
# quaternion cameras on the quaternion x Euclidean(6) product manifold
# (bundle_adjuster --use_quaternions --use_manifolds), quaternion_bal's
# problem: f64 SPARSE_SCHUR gated as BA_PATHS (the port on the CPU ends
# 1e-16 from JAX), and mixed DENSE_SCHUR, its Jacobian by K11's auto
# spec (the product manifold's Plus traced into its jets), gated as
# QUAT_PATHS are (f32 quaternion BA is chaotic; the JAX runs from the
# scaled starts end 6.0e-9 apart, the port on the CPU 1.2e-13 from JAX).
QUAT_BA_PATHS = {
    "QUAT_BA_SPARSE_SCHUR": dict(
        options=dict(linear_solver_type="SPARSE_SCHUR"),
        ref_cost=50287.72691043516, ref_iterations=6, tol=BA_F64_REL_TOL,
        trials=2),
    "QUAT_BA_DENSE_SCHUR_MIXED": dict(
        options=dict(linear_solver_type="DENSE_SCHUR",
                     use_mixed_precision_solves=True),
        ref_cost=50287.72691043548, ref_iterations=6, tol=5e-5, trials=2),
}
# Trafalgar's shape (BAL problem-257-65132-pre: 257 cameras, 65,132
# points, 225,911 observations), synthetic, through
# examples/bundle_adjuster.run on its defaults: f64, SPARSE_SCHUR +
# JACOBI, 5 iterations (so NO_CONVERGENCE). nf = 2,313 >
# SPARSE_SCHUR_DENSE_NF, so the reduced system is the block-sparse S on
# the native LDL^T, in both packages. The main path's seed and sigmas
# (the example perturbs with --random_seed). `ref_cost` is the JAX
# example's on the CPU after its 5 iterations (the port on the CPU
# 7.2e-13 from it); the mixed run's gate is twice the spread of the JAX
# runs from the start scaled by 1 -+ 1e-7 (1.906e-4 and 3.107e-4; the
# port on the CPU 1.25e-4).
TRAFALGAR_ARGS = ["--synthetic_cameras", "257", "--synthetic_points",
                  "65132", "--synthetic_observations", "225911",
                  "--random_seed", "7", "--rotation_sigma", "0.1",
                  "--translation_sigma", "1.0", "--point_sigma", "0.5"]
TRAFALGAR = {
    "TRAFALGAR_SPARSE_SCHUR": dict(
        args=[], ref_cost=126901.6880757548, ref_iterations=5,
        tol=BA_F64_REL_TOL, trials=2),
    "TRAFALGAR_SPARSE_SCHUR_MIXED": dict(
        args=["--mixed_precision_solves"], ref_cost=126909.97029166875,
        ref_iterations=5, tol=6.3e-4, trials=1),
}


def ba_options(mod, cfg, **extra):
    """bundle_adjuster's options (examples/bundle_adjuster.py
    build_options, without progress on stdout) in package `mod`, with
    cfg["options"] and `extra`, run to BA_MAX_ITERATIONS."""
    enums = {"linear_solver_type": mod.LinearSolverType,
             "preconditioner_type": mod.PreconditionerType,
             "trust_region_strategy_type": mod.TrustRegionStrategyType}
    kw = dict(max_num_iterations=BA_MAX_ITERATIONS, eta=1e-2,
              max_linear_solver_iterations=500,
              preconditioner_type=mod.PreconditionerType.JACOBI)
    kw.update({k: getattr(enums[k], v) if k in enums else v
               for k, v in cfg["options"].items()})
    kw.update(extra)
    return mod.SolverOptions(**kw)


# Trafalgar-126's published shape (BAL problem-126-40037-pre: 126
# cameras, 40,037 points, 148,117 observations), synthetic (the BAL files
# are not in the repository), the main path's seed and PERTURB, under
# bench.py's options (large_m_options): mixed DENSE_SCHUR and explicit
# ITERATIVE_SCHUR + SCHUR_JACOBI on the fused step. nf = 1,134 is past
# the one-block K3 and K7 (MAX_M = 1,024): the reduced solve is the
# library Cholesky or solvers/cg.py's CG on the dense S, and K1, K2 or
# K6, and K4 run at nf 1,134. The synthetic ring of cameras, each point
# seen by ~3.7 neighbours, is loosely tied: neither package converges in
# bench.py's 50 iterations, so each run stops at the cap. `ref_cost` is
# the JAX package's fused step on the CPU after them
# (scripts/slice10_reference.py --paths large_m --spread, run on the
# card's machine with the JAX package on its CPU); `tol` twice the
# spread of its runs from the start scaled by 1 -+ 1e-7: DENSE 33, 34
# and 33 accepted steps, 1.931e-3 and 7.488e-3 from the unscaled run;
# ITERATIVE 37, 34 and 37 accepted, 247, 1,104 and 181 CG iterations,
# 1.303e-1 and 8.429e-2 (an inexact CG step in a creeping trajectory).
LARGE_M_SHAPE = dict(num_cameras=126, num_points=40037,
                     num_observations=148117)
FUSED_LARGE_M = {
    "FUSED_LARGE_M_DENSE": dict(
        solver="DENSE_SCHUR", ref_cost=97989.776558559, ref_iterations=50,
        ref_termination="NO_CONVERGENCE", tol=1.5e-2, trials=2,
        kernels=("K1 lin", "K2 elim", "K4 cost")),
    "FUSED_LARGE_M_ITERATIVE": dict(
        solver="ITERATIVE_SCHUR", ref_cost=110964.85671244198,
        ref_iterations=50, ref_termination="NO_CONVERGENCE", tol=2.61e-1,
        trials=2, kernels=("K1 lin", "K6 elim_v1", "K4 cost")),
}


def large_m_options(mod, solver, **extra):
    """bench.py's options with linear solver `solver` (by name) in
    package `mod`."""
    kw = dict(linear_solver_type=getattr(mod.LinearSolverType, solver),
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=50, function_tolerance=1e-6,
              max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


# The line-search minimizer (slice 10), f64, its host loop, no kernel:
# the tutorial's Rosenbrock through GradientProblemSolver (L-BFGS; the
# JAX example's iteration count), the extended Rosenbrock function
# (More, Garbow and Hillstrom's problem 21 at its standard start) in
# EXT_ROSENBROCK_N parameters by AutoDiffFirstOrderFunction (L-BFGS,
# Wolfe; the JAX package's count and final cost), bundle_adjuster
# --line_search on BAL-16-22106 (BA_LS_ARGS: L-BFGS, Wolfe, 50
# iterations; the cost within twice the spread of the JAX example's runs
# from the start scaled by 1 -+ 1e-9, at least 1e-8), and tiny_solve on
# TINY_BATCH seeded Rosenbrock least-squares problems at once (against
# the JAX package's jax.vmap: the converged flags, the sum of the
# solutions, and each problem's iteration count where it is at most
# TINY_EXACT_MAX, by tiny_counts_digest; problem by problem against the
# port's own batch on the CPU). The ~3% of the problems that take more
# creep along the valley with a shrinking radius, and the last-bit
# differences of the two packages' arithmetic move the counts of 0.26%
# of them (all past 62 iterations), each still converging to its
# minimum: on the CPU the packages' x lie within 6.3e-11 of each other. References: scripts/slice10_reference.py
# --paths rosenbrock,extended,ba_ls,tiny --spread.
EXT_ROSENBROCK_N = 1_000_000
BA_LS_ARGS = ["--synthetic_cameras", "16", "--synthetic_points", "22106",
              "--synthetic_observations", "83718", "--random_seed", "7",
              "--rotation_sigma", "0.1", "--translation_sigma", "1.0",
              "--point_sigma", "0.5", "--line_search", "--num_iterations",
              "50"]
TINY_BATCH = 65536
TINY_EXACT_MAX = 50
# The BA line search stops at its cap mid-descent: the JAX runs from the
# scaled starts end 1.339e-1 and 1.287e-1 from the unscaled run (655,
# 662, 653 probes).
LINE_SEARCH_REF = dict(
    rosenbrock_iterations=17,
    extended=dict(iterations=17, final_cost=3.2274888082438e-22,
                  termination="CONVERGENCE"),
    ba_ls=dict(final_cost=116522.24427716131, iterations=50,
               termination="NO_CONVERGENCE", tol=2.68e-1),
    tiny=dict(counts_digest=("47f0ebd834d57b30", 2169), converged=65536,
              x_sum=196622.43696154346),
)


def extended_rosenbrock(T):
    """The extended Rosenbrock function in array module T (torch, or
    jax.numpy in the reference script): sum over the pairs of
    (1 - x_2i)^2 + 100 (x_2i+1 - x_2i^2)^2."""
    def f(x):
        a, b = x[0::2], x[1::2]
        return T.sum((1.0 - a) ** 2 + 100.0 * (b - a * a) ** 2)
    return f


def extended_rosenbrock_start(n):
    """The standard start, (-1.2, 1) in every pair (numpy)."""
    import numpy as np
    return np.tile([-1.2, 1.0], n // 2)


def tiny_problems(n, seed=0):
    """n Rosenbrock least-squares problems r = (10 (x1 - x0^2), a - x0),
    minimum (a, a^2), a in [0.5, 2), starts around (-1.2, 1): (a [n],
    x0 [n, 2]) as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, n)
    x0 = np.array([-1.2, 1.0]) + 0.5 * rng.standard_normal((n, 2))
    return a, x0


def tiny_residual(T):
    def f(x, a):
        return T.stack([10.0 * (x[1] - x[0] ** 2), a - x[0]])
    return f


TINY_OPTIONS = dict(max_num_iterations=200)


def tiny_counts_digest(counts):
    """(sha256 of the (index, count) pairs with count <= TINY_EXACT_MAX,
    the number of problems above it) of an int array of counts."""
    import hashlib
    import numpy as np
    counts = np.asarray(counts).astype(np.int32)
    idx = np.flatnonzero(counts <= TINY_EXACT_MAX).astype(np.int32)
    pairs = np.stack([idx, counts[idx]], axis=1)
    return (hashlib.sha256(pairs.tobytes()).hexdigest()[:16],
            int(counts.size - idx.size))


ROBUST_PATHS = {
    "DENSE_SCHUR_HUBER": dict(loss="HuberLoss", a=1.0,
                              ref_cost=42802.14119413595, ref_iterations=48),
    "DENSE_SCHUR_CAUCHY": dict(loss="CauchyLoss", a=2.0,
                               ref_cost=39197.00781186229,
                               ref_iterations=38),
}
ROBUST_REF_REL_TOL = 1e-5
# the main path through the host loop repeats the fused loop's LM count
HOST_LOOP_ITERATIONS = 6


def default_options(mod, cfg, **extra):
    """SE2_DEFAULT_PATHS[...] cfg's options in package `mod` (ceres_tpu or
    ceres_tpu_torch): SolverOptions() with cfg's changes and `extra`."""
    enums = {"linear_solver_type": mod.LinearSolverType,
             "trust_region_strategy_type": mod.TrustRegionStrategyType,
             "dogleg_type": mod.DoglegType}
    kw = {k: getattr(enums[k], v) for k, v in cfg["options"].items()}
    kw.update(extra)
    return mod.SolverOptions(**kw)


def huber_options(mod, **extra):
    """The main path's DENSE_SCHUR options in package `mod` (run on a
    problem with HuberLoss(1.0))."""
    kw = dict(linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=50, function_tolerance=1e-6,
              max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


# each kernel's main path: its "launches" in the kernels line are the
# counts of that path's last solve (K11 has three entries, the SE3 spec's
# and the Snavely spec's, each read from the counter of bucket_linearize,
# and the auto spec's, from bucket_linearize_auto's)
MAIN_PATH = {"K1 lin": "DENSE_SCHUR", "K2 elim": "DENSE_SCHUR",
             "K3 chol_solve": "DENSE_SCHUR", "K4 cost": "DENSE_SCHUR",
             "K6 elim_v1": "ITERATIVE_SCHUR",
             "K7 dense_pcg": "ITERATIVE_SCHUR",
             "K8 bucket_jtjv": "POSE_GRAPH_3D",
             "K9 group_gram_blocks": "POSE_GRAPH_3D",
             "K9 bucket_gram_blocks (per row)": "SE3_2000_SNC_MIXED",
             "K10 implicit_apply": "IMPLICIT_SCHUR",
             "K11 bucket_linearize": "POSE_GRAPH_3D",
             "K11 bucket_linearize (Snavely)": "IMPLICIT_SCHUR",
             "K11 bucket_linearize (auto)": "QUAT_IMPLICIT_SCHUR",
             "K5 lin_auto": "QUAT_DENSE_SCHUR",
             "K1 lin (HuberLoss(1.0))": "DENSE_SCHUR_HUBER",
             "K1 lin (CauchyLoss(2.0))": "DENSE_SCHUR_CAUCHY"}


def large_options(mod, **extra):
    """The large-BA case's options in package `mod` (ceres_tpu or
    ceres_tpu_torch); `extra` adds or overrides options."""
    kw = dict(linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              use_mixed_precision_solves=True, fused_iterations=True,
              function_tolerance=1e-6, max_linear_solver_iterations=100,
              max_num_iterations=45)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def pose_graph_options(mod, **extra):
    """Slice 3's options in package `mod` (ceres_tpu or ceres_tpu_torch);
    `extra` adds or overrides options."""
    kw = dict(linear_solver_type=mod.LinearSolverType.CGNR,
              preconditioner_type=mod.PreconditionerType.JACOBI,
              use_mixed_precision_solves=True, fused_iterations=True,
              max_num_iterations=100)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def position_error(positions, gt):
    """Mean distance of the positions {id: array} to the ground-truth
    poses (Pose2d or Pose3d), as tests/test_slam.py measures it."""
    import numpy as np
    return float(np.mean([
        np.linalg.norm(positions[i] - (g.p if hasattr(g, "p")
                                       else np.asarray([g.x, g.y])))
        for i, g in enumerate(gt)]))
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 and f64 flop/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def rel_err(a, b):
    """(max |a - b| / max |b|, max |a - b|) over matching tensors."""
    import torch
    a, b = a.double(), b.double()
    diff = float(torch.max(torch.abs(a - b)))
    scale = float(torch.max(torch.abs(b)))
    return diff / max(scale, 1e-300), diff


def median_ms(fn, reps=20):
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, calls=100):
    """Milliseconds a call of fn() in a run of `calls` back-to-back calls
    between two CUDA events: what a loop of calls (the CG loops) pays a
    call, host path included, where median_ms also counts the launch
    latency of one call on an idle card."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def interleaved(name, kernel, other, rounds=5, label="library"):
    """The kernel against `other` (its one-call library version, or with
    label "plain" its plain version) in turns (kernel, other, other,
    kernel) for `rounds` rounds, each time the median of median_ms;
    prints both medians over all rounds and which is faster."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(median_ms(kernel))
        ls.append(median_ms(other))
        ls.append(median_ms(other))
        ks.append(median_ms(kernel))
    k_med, l_med = statistics.median(ks), statistics.median(ls)
    print(f"{name} interleaved, {rounds} rounds (kernel, {label}, {label}, "
          f"kernel): kernel {k_med:.4f} ms (runs {[round(x, 4) for x in ks]})"
          f", {label} {l_med:.4f} ms (runs {[round(x, 4) for x in ls]}); "
          f"{'kernel' if k_med < l_med else label} faster; kernel faster in "
          f"{sum(k < o for k, o in zip(ks, ls))} of {len(ks)} turns",
          flush=True)
    return {"kernel_ms": k_med, f"{label}_ms": l_med,
            "kernel_runs": ks, f"{label}_runs": ls}


def nbytes(*objs):
    """Bytes of every tensor in objs (dicts, tuples and lists walked)."""
    import torch
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def bound(moved, flops, rate):
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate, whichever is larger (ms, which)."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, kernel, plain, compare, limit, source, replaces,
                 inputs, flops, rate, library=None, reference=None):
    """Run kernel and plain version on the same inputs, compare, time.
    `flops` is a number or a function of the kernel's output; `library`
    is (label, fn) of one PyTorch call that computes the function;
    `reference` is (label, fn) of a call that computes another function
    on the same inputs, timed as a yardstick only."""
    import torch
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    errs = compare(got, want)
    limits = limit if isinstance(limit, (list, tuple)) else [limit] * len(
        errs)
    ok = all(e[0] <= lim for e, lim in zip(errs, limits))
    rel = max(e[0] for e in errs)
    abs_err = max(e[1] for e in errs)
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    loop = loop_ms(kernel)
    lib_ms = median_ms(library[1]) if library else None
    ref_ms = median_ms(reference[1]) if reference else None
    n_flops = flops(got) if callable(flops) else flops
    bound_ms, bound_by = bound(nbytes(inputs, got), n_flops, rate)
    lib_txt = (f", {library[0]} {lib_ms:.4f} ms" if library else "")
    lib_txt += (f", {reference[0]} {ref_ms:.4f} ms" if reference else "")
    rel_txt = ", ".join(f"{e[0]:.3e}" for e in errs)
    lim_txt = ", ".join(f"{lim:.0e}" for lim in limits)
    print(f"{name}: max rel err {rel_txt} (limit {lim_txt}), max abs err "
          f"{abs_err:.3e}; kernel {ms:.4f} ms ({loop:.4f} ms a call in a "
          f"loop), plain PyTorch "
          f"{plain_ms:.4f} ms{lib_txt}; bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes(inputs, got)} B, {n_flops:.4g} flop)",
          flush=True)
    if not ok:
        raise SystemExit(f"{name}: kernel and plain version disagree")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": abs_err,
            "max_rel_err": rel, "limit": limit, "ms": ms, "loop_ms": loop,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
            "library_call": library[0] if library else None,
            "reference_ms": ref_ms,
            "reference_call": reference[0] if reference else None}


def scorr_gemm(A, inv):
    """(label, call) of the S_corr product Y^T A as one GEMM (cuBLAS),
    torch.mm(A^T, Y) over the [3 ne, nf] views, with Y = inv A formed
    here beforehand and not timed: the floor of K2's and K6's product,
    timed beside them as their reference. No one PyTorch call computes
    either kernel's function (K2 also forms inv and z, both also rhs),
    so their library_ms is null."""
    import torch
    A2 = A.reshape(-1, A.shape[2])
    Y2 = torch.einsum("nuv,nvf->nuf", inv, A).reshape(-1, A.shape[2])
    return ("torch.mm(A^T, Y): S_corr alone, Y = inv A given",
            lambda: torch.mm(A2.t(), Y2))


def pcg_flops(m, tf, iters, reset):
    """Operations of one K7 solve of `iters` iterations: per iteration the
    matvec (2 m^2), the block preconditioner (2 m tf; 0 for IDENTITY) and
    the dots and vector updates (13 m); a refresh's extra matvec every
    `reset` iterations; the start (preconditioner and one dot) and the
    final norm."""
    return (iters * (2 * m * m + 2 * m * tf + 13 * m)
            + (iters // reset) * 2 * m * m + 2 * m * tf + 4 * m)


def drive(label, options, problem, reset_state, counters, trials, gate,
          ref_cost=REF_FINAL_COST, ref_tol=REF_REL_TOL, solve=None,
          walls=None, summaries=None):
    """Solve `trials` times on the card (the first a warm-up) with
    `solve(options, problem)` (ctt.solve unless given), each with every
    launch count set to 0 just before and read just after; `gate` raises
    on a wrong summary; the timed solves' walls (s) are appended to
    `walls` and their summaries to `summaries` when given. Returns the
    last solve's launches."""
    import torch
    import ceres_tpu_torch as ctt
    solve = solve or ctt.solve
    launches = {}
    for trial in range(trials):
        reset_state()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        summary = solve(options, problem)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        kind = "warm-up solve" if trial == 0 else f"timed solve {trial}"
        if trial and walls is not None:
            walls.append(wall)
        if trial and summaries is not None:
            summaries.append(summary)
        print(f"{label} {kind}: {lm_iterations(summary)} LM iterations "
              f"({summary.num_successful_steps} accepted), "
              f"{summary.num_linear_solver_iterations} linear solver "
              f"iterations, initial cost {summary.initial_cost:.6e}, final "
              f"cost {summary.final_cost:.10e}, {summary.termination_type}, "
              f"wall {wall:.4f} s, launches {launches}", flush=True)
        if summary.termination_type != ctt.TerminationType.CONVERGENCE:
            raise SystemExit(f"{label}: solve did not converge")
        rel = abs(summary.final_cost - ref_cost) / ref_cost
        if not rel <= ref_tol:
            raise SystemExit(f"{label}: final cost {summary.final_cost} is "
                             f"{rel:.2e} from {ref_cost}")
        gate(summary, launches)
    return launches


# slice 11 (`problem_api_paths`). OUTLIER: the main path's problem with 1%
# of its observations moved OUTLIER_SHIFT_PX along a random unit
# direction (`shift_observations`, numpy.random.default_rng(OUTLIER_SEED):
# the indices without replacement, then the directions), solved with
# bench.py's options, evaluated, every observation whose reprojection
# error lies past OUTLIER_THRESHOLD removed with every point left without
# one (`remove_outliers`), and solved again. COLMAP's bundle adjustment
# filters its observations between solves in this way.
OUTLIER_FRACTION = 0.01
OUTLIER_SHIFT_PX = 30.0
OUTLIER_SEED = 11
# the threshold: the middle of the widest gap between the JAX run's
# errors in OUTLIER_WINDOW_PX, which starts at COLMAP's default
# filter_max_reproj_error (4 px)
OUTLIER_WINDOW_PX = (4.0, 5.0)


def shift_observations(observations, fraction=OUTLIER_FRACTION,
                       shift=OUTLIER_SHIFT_PX, seed=OUTLIER_SEED):
    """Move round(fraction n) of the [n, 2] observations, in place, by
    `shift` pixels each along a unit direction; returns their sorted
    indices."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = observations.shape[0]
    idx = rng.choice(n, int(round(fraction * n)), replace=False)
    d = rng.normal(size=(idx.size, 2))
    observations[idx] += shift * d / np.linalg.norm(d, axis=1,
                                                    keepdims=True)
    return np.sort(idx)


def remove_outliers(problem, residual_blocks, points, point_index,
                    residuals, threshold):
    """Remove from `problem` (either package's) the residual blocks whose
    2-vector of `residuals` (insertion order) is longer than `threshold`,
    then every point of `points` that no residual block names any more.
    Returns (removed block indices, removed point indices, the errors)."""
    import numpy as np
    err = np.hypot(residuals[0::2], residuals[1::2])
    removed = np.nonzero(err > threshold)[0]
    for i in removed:
        problem.remove_residual_block(residual_blocks[i])
    kept = np.ones(err.size, dtype=bool)
    kept[removed] = False
    emptied = np.nonzero(np.bincount(point_index[kept],
                                     minlength=len(points)) == 0)[0]
    for j in emptied:
        problem.remove_parameter_block(points[j])
    return removed, emptied, err


def removed_digest(removed):
    """sha256 of the sorted removed indices as int64 bytes."""
    import hashlib
    import numpy as np
    return hashlib.sha256(np.sort(np.asarray(removed, dtype=np.int64))
                          .tobytes()).hexdigest()


# OUTLIER_THRESHOLD: the middle of the widest gap between the JAX CPU
# run's errors after the first solve in OUTLIER_WINDOW_PX, 4.054505835 ..
# 4.090549759 px, its nearest error 4.42e-3 of it away. A shifted
# observation pulls its point (3.8 observations a point), so its
# neighbours' errors fill 0 to ~25 px densely: at shifts of 30, 60, 150
# and 400 px the only gaps with no block within 2% of a threshold lay in
# the tail and removed 1-6 blocks and no point (ROADMAP.md section 3).
# Near 4 px the errors of the JAX runs from starts scaled by 1 -+ 1e-14,
# 1e-10 and 1e-7 move by 1.15e-5 at most and remove the same set; the
# card's run must keep every error OUTLIER_MARGIN (87x that move) from
# the threshold. OUTLIER_REF: the JAX package on the CPU
# (scripts/problem_api_reference.py --parts outlier --spread): removed
# blocks (all 837 shifted among them), their digest (removed_digest),
# points left bare and removed, residual blocks and parameters left, and
# each solve's (LM iterations, final cost, termination).
OUTLIER_THRESHOLD = 4.0725
OUTLIER_MARGIN = 1e-3
OUTLIER_REF = dict(
    removed=2971, emptied=625, residual_blocks=80747, parameters=64587,
    digest="25a0bea7a0cf4a7ca798e1e37fa731df4e130008cccfeed3e83bbf9859a044ac",
    first=(6, 278981.62451052316, "CONVERGENCE"),
    second=(3, 48330.36224474064, "CONVERGENCE"))


def outlier_options(mod, **extra):
    """bench.py's options (the main path's: DENSE_SCHUR, mixed, fused)
    in package `mod`."""
    kw = dict(linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=50, function_tolerance=1e-6,
              max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


# EVALUATE: Problem.evaluate at Trafalgar's shape (ba_paths' problem:
# TRAFALGAR_ARGS' synthetic problem, normalized, perturbed with its
# sigmas and seed), at its start, f64: the full call with residuals,
# gradient and a CSR Jacobian, a subset (the first EVALUATE_SUBSET_ROWS
# residual blocks over the camera blocks alone) and
# evaluate_residual_block on EVALUATE_BLOCKS blocks.
EVALUATE_SHAPE = dict(num_cameras=257, num_points=65132,
                      num_observations=225911)
EVALUATE_SUBSET_ROWS = 1000
EVALUATE_BLOCKS = 100
EVALUATE_TOL = 1e-12
# the JAX package on the CPU (scripts/problem_api_reference.py --parts
# evaluate): the full call's cost, gradient norm and nonzeros
EVALUATE_REF = dict(cost=16310312.463707145,
                    gradient_norm=11962294.421871321, nnz=5421864)


def evaluate_problem(bal_io):
    """(problem, camera arrays, point arrays) of EVALUATE in the package
    of `bal_io` (its io.bal), as bundle_adjuster builds it from
    TRAFALGAR_ARGS."""
    bal = bal_io.synthetic_bal_problem(**EVALUATE_SHAPE, seed=7,
                                       pixel_noise=1.0)
    bal.normalize()
    bal.perturb(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5,
                seed=7)
    return bal_io.build_bal_ceres_problem(bal)


# EXAMPLES: the seven examples of slice 11 on their settings here, each
# held to the JAX package's LM count and final cost within 1e-9 (1e-20
# absolute for costs at zero) or, where the JAX runs from scaled starts
# spread (ROADMAP.md section 3), twice that spread.
EXAMPLE_COST_TOL = 1e-9
EXAMPLE_COST_FLOOR = 1e-20


def run_example(mod, name, scale=1.0, **kw):
    """Run example `name` of EXAMPLE_RUNS in package `mod` (kw: the
    port's device); returns (summary, what it solved). `scale` scales
    libmv_homography's second point set (its spread)."""
    ex = __import__(f"{mod.__name__}.examples", fromlist=["x"])
    import importlib
    if name in ("iteration_callback", "evaluation_callback"):
        m = importlib.import_module(f"{ex.__name__}.callbacks_example")
        out = getattr(m, f"{name}_demo")(**kw)
        return out[1], out[0]
    if name == "circle_fit":
        m = importlib.import_module(f"{ex.__name__}.circle_fit")
        pts = m.synthesize(num_points=60, outliers=4, cx=2.0, cy=3.0, r=5.0,
                           seed=1)
        x, y, r, s = m.fit_circle(pts, pts[0, 0], pts[0, 1], 1.0,
                                  robust_threshold=0.5, **kw)
        return s, (x, y, r)
    if name == "ellipse_approximation":
        m = importlib.import_module(f"{ex.__name__}.ellipse_approximation")
        X, t, s = m.solve_ellipse(m.synthesize_ellipse_points(212), 151,
                                  **kw)
        return s, X
    if name == "libmv_homography":
        m = importlib.import_module(f"{ex.__name__}.libmv_homography")
        H_true = [[1.243715, -0.461057, -111.964454],
                  [0.0, 0.617589, -192.379252], [0.0, -0.000983, 1.0]]
        import numpy as np
        x1 = np.array([[0.0, 0.0], [320.0, 0.0], [320.0, 240.0],
                       [0.0, 240.0], [160.0, 120.0], [80.0, 60.0]])
        v = np.asarray(H_true) @ np.concatenate(
            [x1, np.ones((6, 1))], axis=1).T
        H, s = m.estimate_homography(x1, (v[:2] / v[2]).T * scale, **kw)
        return s, H
    if name == "robot_pose_mle":
        m = importlib.import_module(f"{ex.__name__}.robot_pose_mle")
        odo, rng = m.simulate_robot()
        blocks, s = m.solve_robot_pose_mle(odo, rng, **kw)
        return s, blocks
    m = importlib.import_module(f"{ex.__name__}.sampled_function")
    out = getattr(m, name)(**kw)
    return out[1], out[0]


EXAMPLE_RUNS = ("iteration_callback", "evaluation_callback", "circle_fit",
                "ellipse_approximation", "libmv_homography",
                "robot_pose_mle", "sampled_function_1d", "bicubic_2d")
# the JAX package on the CPU (scripts/problem_api_reference.py --parts
# examples,mgh --spread), each (LM iterations, final cost, LM spread,
# cost spread, LRE): the spreads are the largest distances of the runs
# from starts scaled by 1 -+ 1e-14, 1e-10 and 1e-7. An LM count may move
# by twice the spread: the MGH runs go on to tolerances of 1e-18, so
# their last steps follow the rounding. LM_ROUNDING names the runs that
# part from JAX's by more from every start, because the rounding differs
# between XLA's fused multiply-adds and PyTorch (ROADMAP.md section 3),
# and the LM they may move: Box3D constrained ends at 115 LM in the
# port, on the CPU and on the card, and at 118 in JAX from every start,
# its cost 2e-14 from JAX's.
LM_ROUNDING = {"12C": 3}
EXAMPLE_REF = {
    "iteration_callback": (15, 3.2514887354881905e-17, 0, 0.0, None),
    "evaluation_callback": (38, 1.1850612001939757e-19, 0, 0.0, None),
    "circle_fit": (20, 7.757141680339189, 0, 0.0, None),
    "ellipse_approximation": (65, 0.02890343516382403, 0, 0.0, None),
    # its cost spread: the JAX runs with the second point set scaled as
    # the MGH starts are (the fit is exact, so its final cost, ~7e-13,
    # is the rounding's)
    "libmv_homography": (6, 6.777341999145453e-13, 0, 4.694545201e-18,
                         None),
    "robot_pose_mle": (3, 27.41104648996226, 0, 0.0, None),
    "sampled_function_1d": (14, 1.041892696315879e-15, 0, 0.0, None),
    "bicubic_2d": (6, 2.0065544817674289e-22, 0, 0.0, None),
}
MGH_REF = {
    "1U": (38, 0.0, 0, 0.0, float("inf")),
    "2U": (31, 24.492126839620013, 3, 1.4210854715202004e-14, -1.690),
    "3U": (68, 3.6147342626644028e-34, 1, 3.345361660009756e-33, 33.141),
    "4U": (22, 5.383621143800467e-26, 0, 1.3906016092266745e-28, 24.968),
    "5U": (16, 0.0, 8, 0.0, float("inf")),
    "6U": (45, 62.18109117780744, 11, 4.263256414560601e-14, 5.834),
    "7U": (15, 1.772578656316683e-39, 0, 3.481491926877265e-45, 38.450),
    "8U": (16, 0.004107438653289479, 7, 9.540979117872439e-18, 6.051),
    "9U": (11, 5.639663848095383e-09, 1, 1.6940658945086007e-21, 5.610),
    "10U": (152, 43.972927585381406, 8, 1.205506805490586e-10, 6.203),
    "11U": (86, 0.4034352777462066, 8, 1.1102230246251565e-16, 0.093),
    "12U": (20, 3.21612524848308e-33, 6, 4.783457533328304e-33, 32.192),
    "13U": (23, 1.6587765139400233e-26, 0, 6.569851222803693e-33, 25.479),
    "14U": (87, 0.0, 0, 0.0, float("inf")),
    "15U": (30, 0.00015375280192461843, 5, 2.168404344971009e-19, 5.707),
    "16U": (1000, 272230.49671078037, 0, 18565.592890974163, -0.728),
    "17U": (28, 2.7324473487413534e-05, 5, 9.0801931945661e-19, 6.066),
    "18U": (63, 6.162975822039155e-32, 7, 2.7733391199176196e-32, 30.909),
    "19U": (35, 0.02006886814677386, 6, 3.122502256758253e-17, 6.044),
    "3C": (146, 7.562970682951063e-11, 11, 1.6093832792984845e-22, 5.563),
    "4C": (13, 391.99999990427716, 0, 0.0, 9.612),
    "5C": (6, 0.0, 1, 0.0, float("inf")),
    "7C": (19, 2.0002112583202774, 0, 0.0, -0.483),
    "9C": (4, 5.639663848095383e-09, 3, 2.8512915714702864e-21, 5.610),
    "11C": (51, 4.166260702207117, 3, 7.830536219444184e-11, -5.155),
    "12C": (118, 5.317737334691197e-06, 0, 6.725441601199145e-19, -0.386),
    "14C": (113, 0.7784798543462605, 0, 5.261895141828177e-09, 3.779),
    "16C": (484, 44458.90290298396, 219, 21.97717233815638, 3.190),
    "18C": (123, 0.02075775025918615, 4, 1.878993589193856e-09, -1.887),
}


def GRADCHECK_WRONG(mod, T, **kw):
    """tests/test_aux_components.py's check_gradients solve of a wrong
    analytic cost (r = 2x, dr/dx given as 3) in package `mod` (T its
    array module); returns the summary."""
    import numpy as np

    class Bad(mod.SizedCostFunction):
        def residuals(self, x):
            return x * 2.0

        def jacobians(self, x):
            return [T.ones((1, 1)) * 3.0]

    x = np.array([1.0])
    problem = mod.Problem()
    problem.add_residual_block(Bad(1, [1]), None, x)
    return mod.solve(mod.SolverOptions(check_gradients=True, **kw), problem)


# the JAX package on the CPU (scripts/problem_api_reference.py --parts
# gradcheck): GRADCHECK_WRONG's message, and the probe of the first
# GRADCHECK_BLOCKS Snavely blocks at their start at GRADCHECK_PRECISION,
# the middle of the widest gap in the middle of the blocks' largest
# relative errors (0.01506 .. 0.02300; central differences hold some
# entries only to 1.4e-3 .. 1 of jacfwd's, and at 1e-8 no block
# passes): the passes, the flags' digest as chip_smoke.py computes it,
# and the sum of the 64 largest errors (the port's on the card and on
# the CPU gave each block's JAX's to 5 digits, the sum to 7e-16)
GRADCHECK_REF = dict(
    message="Gradient check failed for residual block 0:\nJacobian for "
            "parameter block 0 disagrees: max relative error 2.000000e-01 "
            "> 1.000000e-08",
    probe_pass=26, probe_digest="84de7161d1f50d8d",
    error_sum=10.096241210198368)
GRADCHECK_BLOCKS = 64
GRADCHECK_PRECISION = 0.018
GRADCHECK_SUM_TOL = 1e-9


def lm_iterations(summary):
    """LM iterations of a summary: the host loop's records iteration 0 as
    well (its num_iterations is one more), the fused loop's none."""
    return (len(summary.iterations) - 1 if summary.iterations
            else summary.num_iterations)


def sparse_paths(graphs, counters, by_path, cgnr_walls, device="cuda"):
    """Slice 8's paths (SPARSE_NORMAL_CHOLESKY on the native LDL^T,
    SUBSET, dynamic sparsity, Covariance) on `device`, each through drive
    with `counters`, into `by_path`: SPARSE_GRAPHS' two graphs, then, on
    `graphs` (main's pose graphs, with the CGNR solves' summaries under
    "cgnr" and `cgnr_walls`, their timed walls), the mixed SE3 2,000,
    SUBSET, static, Covariance and dynamic phases. Returns the timed
    walls of each path."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.program import CompiledProgram

    def reset_graph(key):
        def reset():
            for a, a0 in zip(graphs[key]["arrays"], graphs[key]["start"]):
                a[:] = a0
        return reset
    g2 = graphs["2d"]

    def gate_sparse(label, ref_iterations, runs=(), per_lin=(), cut=None,
                    g=None):
        """Launches: each kernel of `runs` at least once per LM iteration,
        of `per_lin` once per linearization, no other; the position error
        under `cut` of the start when given; every solve the same LM
        count, linear iterations and final cost."""
        seen = []

        def gate(summary, launches):
            n_lm = lm_iterations(summary)
            msg = (f"  {label}: {n_lm} LM iterations (JAX package on the "
                   f"CPU: {ref_iterations}), "
                   f"{summary.num_linear_solver_iterations} linear solver "
                   f"iterations, final cost {summary.final_cost!r}")
            if g is not None:
                err = position_error(g["positions"], g["gt"])
                msg += (f"; mean position error {g['error0']:.6f} -> "
                        f"{err:.6f} (share {err / g['error0']:.6f}, "
                        f"limit {cut})")
            print(msg, flush=True)
            if g is not None and not err < cut * g["error0"]:
                raise SystemExit(f"{label}: position error not cut")
            short = [n for n in runs if launches[n] < n_lm]
            n_lin = summary.num_linearizations_fused
            if per_lin and not n_lin:
                raise SystemExit(f"{label}: no linearization counted")
            short += [n for n in per_lin if launches[n] != n_lin]
            if short:
                raise SystemExit(f"{label}: kernels launched fewer times "
                                 f"than LM iterations or linearizations "
                                 f"({n_lm}, {n_lin}): "
                                 f"{[(n, launches[n]) for n in short]}")
            stray = [n for n, c in launches.items()
                     if c and n not in runs and n not in per_lin]
            if stray:
                raise SystemExit(f"{label}: kernels of another path "
                                 f"launched: {stray}")
            seen.append((n_lm, summary.num_linear_solver_iterations,
                         summary.final_cost))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: solves differ: {seen}")
        return gate

    def check_native(label, problem, options):
        """The step that the solves of the configuration ran (cached on
        their program) has the native LDL^T (or SUBSET on it) as its
        linear solver: no dense factorization."""
        step_ = CompiledProgram.get_cached(problem, options).__dict__[
            "_fused_steps"][options.cache_key()]
        if step_.linear.sparse is None and step_.linear.subset is None:
            raise SystemExit(f"{label}: not the native sparse path")

    sparse_walls = {}
    for path, spec in SPARSE_GRAPHS.items():
        t0 = time.time()
        poses, constraints, gt = getattr(g2o, spec["generator"])(
            **spec["args"])
        s_problem, positions, rotations = getattr(slam, spec["build"])(
            poses, constraints)
        arrays = list(positions.values()) + list(rotations.values())
        start = [a.copy() for a in arrays]
        sg = dict(positions=positions, gt=gt,
                  error0=position_error(positions, gt))
        s_options = sparse_options(ctt, device=device)
        print(f"{path}: {len(poses)} poses, {len(constraints)} edges, "
              f"{CompiledProgram.get_cached(s_problem, s_options).num_effective}"
              f" effective parameters; build {time.time() - t0:.1f} s",
              flush=True)

        def reset_sparse(arrays=arrays, start=start):
            for a, a0 in zip(arrays, start):
                a[:] = a0
        sparse_walls[path] = []
        by_path[path] = drive(
            f"{path} (SPARSE_NORMAL_CHOLESKY, f64, host loop)", s_options,
            s_problem, reset_sparse, counters, 2,
            gate_sparse(path, spec["ref_iterations"], cut=spec["error_cut"],
                        g=sg),
            ref_cost=spec["ref_cost"], ref_tol=SPARSE_REL_TOL,
            walls=sparse_walls[path])
        check_native(path, s_problem, s_options)
        del s_problem, arrays, start

    g3 = graphs["3d"]
    mixed_options = pose_graph_options(
        ctt, linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        device=device)
    sparse_walls["SE3_2000_SNC_MIXED"] = []
    by_path["SE3_2000_SNC_MIXED"] = drive(
        "SE3_2000_SNC_MIXED (SPARSE_NORMAL_CHOLESKY, mixed, fused)",
        mixed_options, g3["problem"], reset_graph("3d"), counters, 3,
        gate_sparse("SE3_2000_SNC_MIXED", SNC_MIXED_REF["ref_iterations"],
                    runs=("K9 bucket_gram_blocks (per row)",),
                    per_lin=("K11 bucket_linearize",),
                    cut=POSE_GRAPHS["3d"]["error_cut"], g=g3),
        ref_cost=SNC_MIXED_REF["ref_cost"], ref_tol=POSE_REF_REL_TOL,
        walls=sparse_walls["SE3_2000_SNC_MIXED"])
    check_native("SE3_2000_SNC_MIXED", g3["problem"], mixed_options)
    print(f"SE3 2,000 poses: SPARSE_NORMAL_CHOLESKY (mixed) walls "
          f"{[round(w, 4) for w in sparse_walls['SE3_2000_SNC_MIXED']]} s "
          f"beside CGNR + JACOBI's {[round(w, 4) for w in cgnr_walls['3d']]}"
          f" s in this run", flush=True)

    subset_opts = subset_options(ctt, g2["problem"], device=device)
    sparse_walls["SE2_1000_SUBSET"] = []
    subset_summaries = []
    by_path["SE2_1000_SUBSET"] = drive(
        "SE2_1000_SUBSET (CGNR + SUBSET, mixed, fused)", subset_opts,
        g2["problem"], reset_graph("2d"), counters, 2,
        gate_sparse("SE2_1000_SUBSET (the JAX reference is its f64 solve)",
                    SUBSET_REF["ref_iterations"],
                    runs=("K9 bucket_gram_blocks (per row)",
                          "K8 bucket_jtjv"),
                    per_lin=("K11 bucket_linearize",),
                    cut=POSE_GRAPHS["2d"]["error_cut"], g=g2),
        ref_cost=SUBSET_REF["ref_cost"], ref_tol=POSE_REF_REL_TOL,
        walls=sparse_walls["SE2_1000_SUBSET"], summaries=subset_summaries)
    check_native("SE2_1000_SUBSET", g2["problem"], subset_opts)
    s_sub, s_jac = subset_summaries[-1], graphs["2d"]["cgnr"][-1]
    w_sub, w_jac = sparse_walls["SE2_1000_SUBSET"][-1], cgnr_walls["2d"][-1]
    if s_sub.num_linear_solver_iterations < lm_iterations(s_sub) or \
            by_path["SE2_1000_SUBSET"]["K8 bucket_jtjv"] < \
            s_sub.num_linear_solver_iterations:
        raise SystemExit("SE2_1000_SUBSET: K8 launched fewer times than CG "
                         "iterated")
    print(f"SE2 1,000 poses: CGNR + SUBSET {lm_iterations(s_sub)} LM / "
          f"{s_sub.num_linear_solver_iterations} CG iterations in "
          f"{w_sub:.4f} s ({1e3 * w_sub / s_sub.num_linear_solver_iterations:.3f}"
          f" ms of wall a CG iteration); CGNR + JACOBI "
          f"{lm_iterations(s_jac)} / {s_jac.num_linear_solver_iterations} in "
          f"{w_jac:.4f} s ({1e3 * w_jac / s_jac.num_linear_solver_iterations:.3f}"
          f" ms) in this run; the JAX package's f64 SUBSET "
          f"{SUBSET_REF['ref_iterations']} / {SUBSET_REF['ref_cg']}",
          flush=True)

    static_options = sparse_options(ctt, device=device)
    static_summaries = []
    sparse_walls["SE2_1000_SNC"] = []
    by_path["SE2_1000_SNC"] = drive(
        "SE2_1000_SNC (SPARSE_NORMAL_CHOLESKY, f64, host loop)",
        static_options, g2["problem"], reset_graph("2d"), counters, 2,
        gate_sparse("SE2_1000_SNC", SE2_SNC_REF["ref_iterations"],
                    cut=POSE_GRAPHS["2d"]["error_cut"], g=g2),
        ref_cost=SE2_SNC_REF["ref_cost"], ref_tol=SPARSE_REL_TOL,
        walls=sparse_walls["SE2_1000_SNC"], summaries=static_summaries)
    check_native("SE2_1000_SNC", g2["problem"], static_options)
    static_cost = static_summaries[-1].final_cost

    # Covariance at the static solve's end (its arrays hold the solution)
    cov_pairs = covariance_pairs(g2["positions"], g2["rotations"])
    cov_blocks, cov_walls = {}, {}
    for algo in ("SPARSE_QR", "DENSE_SVD"):
        cov = ctt.Covariance(ctt.CovarianceOptions(
            algorithm_type=getattr(ctt.CovarianceAlgorithmType, algo),
            device=device))
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        if not cov.compute(cov_pairs, g2["problem"]):
            raise SystemExit(f"COVARIANCE_SE2_1000 {algo}: {cov.message}")
        cov_blocks[algo] = [np.asarray(cov.get_covariance_block(a, b))
                            for a, b in cov_pairs]
        torch.cuda.synchronize()
        cov_walls[algo] = time.time() - t0
        stray = [n for n, fn in counters.items() if fn.launches]
        if stray:
            raise SystemExit(f"COVARIANCE_SE2_1000 {algo}: kernels "
                             f"launched: {stray}")
        if algo == "SPARSE_QR" and cov._block_cov is None:
            raise SystemExit("COVARIANCE_SE2_1000: SPARSE_QR did not take "
                             "the native path")

    def block_rel(got, want):
        return float(np.max(np.abs(got - want))
                     / max(float(np.max(np.abs(want))), 1e-300))
    agree = max(block_rel(a, b) for a, b in zip(cov_blocks["SPARSE_QR"],
                                                cov_blocks["DENSE_SVD"]))
    vs_ref = max(block_rel(a, np.asarray(b)) for a, b in zip(
        cov_blocks["SPARSE_QR"], COVARIANCE_REF))
    vs_ref_svd = max(block_rel(a, np.asarray(b)) for a, b in zip(
        cov_blocks["DENSE_SVD"], COVARIANCE_REF))
    print(f"COVARIANCE_SE2_1000 ({len(cov_pairs)} blocks of poses "
          f"{list(COVARIANCE_POSES)}): SPARSE_QR (native LDL^T, "
          f"{cov_walls['SPARSE_QR']:.4f} s) against DENSE_SVD (cuSOLVER, "
          f"{cov_walls['DENSE_SVD']:.4f} s): max rel diff {agree:.3e} "
          f"(limit {COVARIANCE_AGREE_TOL:.0e}); against the JAX package: "
          f"SPARSE_QR {vs_ref:.3e}, DENSE_SVD {vs_ref_svd:.3e} (limit "
          f"{COVARIANCE_REF_TOL:.0e}); (p, p) of pose "
          f"{COVARIANCE_POSES[-1]}: {cov_blocks['SPARSE_QR'][-3].tolist()}",
          flush=True)
    if not (agree <= COVARIANCE_AGREE_TOL and vs_ref <= COVARIANCE_REF_TOL
            and vs_ref_svd <= COVARIANCE_REF_TOL):
        raise SystemExit("COVARIANCE_SE2_1000: blocks disagree")

    dyn_summaries = []
    by_path["SE2_1000_DYNAMIC"] = drive(
        "SE2_1000_DYNAMIC (SPARSE_NORMAL_CHOLESKY, dynamic_sparsity)",
        sparse_options(ctt, dynamic_sparsity=True, device=device),
        g2["problem"], reset_graph("2d"), counters, 2,
        gate_sparse("SE2_1000_DYNAMIC", SE2_SNC_REF["ref_iterations"],
                    cut=POSE_GRAPHS["2d"]["error_cut"], g=g2),
        ref_cost=static_cost, ref_tol=SPARSE_REL_TOL,
        walls=sparse_walls.setdefault("SE2_1000_DYNAMIC", []),
        summaries=dyn_summaries)
    check_native("SE2_1000_DYNAMIC", g2["problem"],
                 sparse_options(ctt, dynamic_sparsity=True, device=device))
    print(f"sparse paths' timed walls (s): "
          f"{ {k: [round(w, 4) for w in v] for k, v in sparse_walls.items()} }",
          flush=True)
    return sparse_walls


def ba_paths(problem, arrays, reset_state, counters, by_path,
             device="cuda"):
    """Slice 9's paths (bundle_adjuster on the generic Schur step) on
    `device`, each through drive with `counters` (but Trafalgar's, which stop
    at 5 iterations by design), into `by_path`: BA_PATHS on the main
    path's `problem` (its user `arrays`, reset by `reset_state`), the
    SPARSE_SCHUR solves repeating their bits; QUAT_BA_PATHS; TRAFALGAR
    through examples/bundle_adjuster.run, every damped solve served by
    the block-sparse S (the solve's SparseSchurContext counts them; the
    dense S is formed only on the branch that the context replaces), the
    f64 run twice with the same state bits. Returns the timed walls."""
    import hashlib
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import bundle_adjuster
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_sparse import get_sparse_schur_context

    def digest(arrs):
        h = hashlib.sha256()
        for a in arrs:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    def gate_ba(label, cfg, arrs, per_lin=(), bits=False):
        """The LM count (but dogleg's), the route, launches: `per_lin`
        at least once per linearization, no other kernel; with `bits`
        every solve's final state the same bits."""
        seen = []

        def gate(summary, launches):
            n_lm = lm_iterations(summary)
            n_lin = summary.num_jacobian_evaluations
            d = digest(arrs)
            cg = (f" (JAX {cfg['ref_cg']})" if "ref_cg" in cfg else "")
            rel = abs(summary.final_cost - cfg["ref_cost"]) / cfg["ref_cost"]
            print(f"  {label}: {n_lm} LM iterations (JAX package on the "
                  f"CPU: {cfg['ref_iterations']}), "
                  f"{summary.num_linear_solver_iterations} linear solver "
                  f"iterations{cg}, {n_lin} linearizations, final cost "
                  f"{summary.final_cost!r} ({rel:.3e} from JAX, limit "
                  f"{cfg['tol']:.1e}); state sha256 {d}; "
                  f"{summary.message.split('Schur step: ')[-1]}", flush=True)
            if "Schur step: generic" not in summary.message:
                raise SystemExit(f"{label}: not the generic Schur step")
            if "DOGLEG" not in label and n_lm != cfg["ref_iterations"]:
                raise SystemExit(f"{label}: {n_lm} LM iterations, the JAX "
                                 f"package {cfg['ref_iterations']}")
            short = [n for n in per_lin if launches[n] < n_lin]
            stray = [n for n, c in launches.items()
                     if c and n not in per_lin]
            if short or stray:
                raise SystemExit(f"{label}: kernels short of the "
                                 f"linearizations ({n_lin}): {short}; of "
                                 f"another path: {stray}")
            seen.append((n_lm, summary.num_linear_solver_iterations,
                         summary.final_cost, d if bits else None))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: solves differ: {seen}")
        return gate

    walls = {}
    for label, cfg in BA_PATHS.items():
        walls[label] = []
        by_path[label] = drive(
            f"{label} (bundle_adjuster options, f64, host loop)",
            ba_options(ctt, cfg, device=device), problem, reset_state,
            counters, cfg["trials"],
            gate_ba(label, cfg, arrays, bits=label == "BA_SPARSE_SCHUR"),
            ref_cost=cfg["ref_cost"], ref_tol=cfg["tol"],
            walls=walls[label])

    t0 = time.time()
    q_problem, q_cams, q_pts = bal_io.build_bal_ceres_problem(
        quaternion_bal(bal_io), use_quaternions=True, use_manifolds=True)
    q_start = [a.copy() for a in q_cams + q_pts]
    print(f"quaternion BAL-16 on the product manifold: build "
          f"{time.time() - t0:.1f} s", flush=True)

    def reset_quat():
        for a, a0 in zip(q_cams + q_pts, q_start):
            a[:] = a0
    for label, cfg in QUAT_BA_PATHS.items():
        walls[label] = []
        mixed = cfg["options"].get("use_mixed_precision_solves", False)
        by_path[label] = drive(
            f"{label} (product manifold, {'mixed' if mixed else 'f64'}, "
            f"host loop)", ba_options(ctt, cfg, device=device), q_problem,
            reset_quat, counters, cfg["trials"],
            gate_ba(label, cfg, q_cams + q_pts,
                    per_lin=("K11 bucket_linearize (auto)",) if mixed
                    else ()),
            ref_cost=cfg["ref_cost"], ref_tol=cfg["tol"], walls=walls[label])
    del q_problem

    for label, cfg in TRAFALGAR.items():
        walls[label], seen = [], []
        for _ in range(cfg["trials"]):
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            summary, t_problem, t_options, t_cams, t_pts = \
                bundle_adjuster.run(TRAFALGAR_ARGS + cfg["args"]
                                    + ["--device", device])
            torch.cuda.synchronize()
            wall = time.time() - t0
            walls[label].append(wall)
            launches = {n: fn.launches for n, fn in counters.items()}
            by_path[label] = launches
            program = CompiledProgram.get_cached(t_problem, t_options)
            ctx = get_sparse_schur_context(
                detect_schur_structure(program, t_options), program,
                t_options)
            d = digest(t_cams + t_pts)
            n_lm = lm_iterations(summary)
            n_lin = summary.num_jacobian_evaluations
            rel = abs(summary.final_cost - cfg["ref_cost"]) / cfg["ref_cost"]
            print(f"{label} (examples/bundle_adjuster.run "
                  f"{' '.join(cfg['args']) or 'defaults'}): {n_lm} LM "
                  f"iterations (JAX {cfg['ref_iterations']}), {n_lin} "
                  f"linearizations, initial cost {summary.initial_cost!r}, "
                  f"final cost {summary.final_cost!r} ({rel:.3e} from JAX "
                  f"{cfg['ref_cost']!r}, limit {cfg['tol']:.1e}), "
                  f"{summary.termination_type}; block-sparse solves "
                  f"{ctx.solves} of {summary.num_linear_solves} damped "
                  f"solves; state sha256 {d}; solve "
                  f"{summary.total_time_in_seconds:.3f} s (preprocessor "
                  f"{summary.preprocessor_time_in_seconds:.3f}, minimizer "
                  f"{summary.minimizer_time_in_seconds:.3f}), run() "
                  f"{wall:.3f} s (problem build included), launches "
                  f"{ {n: c for n, c in launches.items() if c} }", flush=True)
            mixed = bool(cfg["args"])
            k11 = "K11 bucket_linearize"
            stray = [n for n, c in launches.items()
                     if c and not (mixed and n == k11)]
            if not (n_lm == cfg["ref_iterations"] and rel <= cfg["tol"]
                    and summary.termination_type
                    == ctt.TerminationType.NO_CONVERGENCE
                    and summary.is_solution_usable()
                    and ctx.solves == summary.num_linear_solves > 0
                    and not stray
                    and (not mixed or launches[k11] >= max(n_lin, 5))
                    and "block-sparse S on the native LDL^T"
                    in summary.message):
                raise SystemExit(f"{label}: off its reference, route or "
                                 f"launches")
            seen.append((n_lm, summary.final_cost, d))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: runs differ: {seen}")
            del t_problem, t_cams, t_pts, program, ctx
    print(f"bundle_adjuster paths' walls (s): "
          f"{ {k: [round(w, 4) for w in v] for k, v in walls.items()} }",
          flush=True)
    return walls


def kernel_counters():
    """Every kernel wrapper by name (each counts its launches)."""
    from ceres_tpu_torch.ops import lin_auto as k5
    from ceres_tpu_torch.ops.cost import snavely_sq
    from ceres_tpu_torch.ops.implicit import implicit_apply
    from ceres_tpu_torch.ops.kernels import (
        CHOL_VARIANTS, bucket_gram_blocks, bucket_jtjv, chol_solve,
        group_gram_blocks)
    from ceres_tpu_torch.ops.lin import elim, elim_v1, lin
    from ceres_tpu_torch.ops.linearize import (bucket_linearize,
                                               bucket_linearize_auto)
    from ceres_tpu_torch.ops.pcg import dense_pcg
    return {"K1 lin": lin, "K2 elim": elim,
            "K3 chol_solve": chol_solve,
            "K3 chol_solve (shared)": CHOL_VARIANTS["shared"],
            "K3 chol_solve (global)": CHOL_VARIANTS["global"],
            "K4 cost": snavely_sq,
            "K6 elim_v1": elim_v1, "K7 dense_pcg": dense_pcg,
            "K8 bucket_jtjv": bucket_jtjv,
            "K9 group_gram_blocks": group_gram_blocks,
            "K9 bucket_gram_blocks (per row)": bucket_gram_blocks,
            "K10 implicit_apply": implicit_apply,
            "K11 bucket_linearize": bucket_linearize,
            "K11 bucket_linearize (auto)": bucket_linearize_auto,
            "K5 lin_auto": k5.lin_auto}


def scorr_flops(ne_, nf_, te=3):
    """K2's and K6's operations for point blocks of `te`: S_corr = sum
    A^T (inv A) with Y = inv A first, the upper triangle of S_corr
    (2 te nf (nf + 1) / 2 a point; the kernel forms it alone at nf <= 160
    and mirrors it, past that the upper tile pairs), Y itself (2 te^2 nf)
    and rhs (2 te nf); K2 adds INV_Z_FLOPS[te] a point. Every camera
    column of each point's A is walked, the zero blocks too."""
    return ne_ * (te * nf_ * (nf_ + 1) + 2 * te * te * nf_ + 2 * te * nf_)


# K2's operations a point for its damped inverse and z, by point size
# (csrc/elim.cuh damped_inverse, from the staged EtE and g): the damping
# (a division and a sum a diagonal entry), the closed form's products,
# sums and one reciprocal, the scaling of the inverse's distinct entries
# and z's te^2 products: te 1: 2 + 1 + 1; te 2: 4 + 3 (det) + 1 + 3 + 4;
# te 3: 6 + 18 (cofactors) + 5 (det) + 1 + 6 + 9
INV_Z_FLOPS = {1: 4, 2: 15, 3: 45}


def fused_large_m_paths(counters, by_path, kernels, device="cuda"):
    """Slice 10's FUSED_LARGE_M: Trafalgar-126's shape under bench.py's
    options. Checks K1, K2, K6 and K4 at its shapes (nf 1,134) against
    their plain versions and adds them to `kernels`; times the library
    Cholesky and the reduced CG on the first reduced systems; then drives
    each path (a warm-up and a timed solve), every count from 0 before
    each: the route past MAX_M named in the summary, K3 and K7 never
    launched, K1 once a linearization, K2 or K6 and K4 at least once an
    LM iteration, no other kernel; the JAX package's termination, the
    cost within `tol` of its reference (the LM count where it gates
    one)."""
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.ops.cost import snavely_sq, snavely_sq_plain
    from ceres_tpu_torch.ops.kernels import MAX_M
    from ceres_tpu_torch.ops.lin import (elim, elim_plain, elim_v1,
                                         elim_v1_plain, lin, lin_plain)
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.dense import cholesky_solve
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_fused import (FusedSchurStep,
                                                     explicit_cg)

    t0 = time.time()
    bal = synthetic_bal_problem(**LARGE_M_SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    problem, cams, pts = build_bal_ceres_problem(bal)
    arrays = cams + pts
    start = [a.copy() for a in arrays]

    def reset():
        for a, a0 in zip(arrays, start):
            a[:] = a0
    opts = {label: large_m_options(ctt, cfg["solver"], device=device)
            for label, cfg in FUSED_LARGE_M.items()}
    d_opts, i_opts = opts.values()
    program = CompiledProgram.get_cached(problem, d_opts)
    meta = detect_schur_structure(program, d_opts)
    step = FusedSchurStep(program, d_opts, meta)
    it_step = FusedSchurStep(program, i_opts, meta)
    ne, nf, kf = step.ne, step.nf, step.kf
    nobs = LARGE_M_SHAPE["num_observations"]
    print(f"FUSED_LARGE_M: problem and steps {time.time() - t0:.1f} s; "
          f"ne={ne} k={step.cam.shape[1]} kf={kf} nf={nf} (MAX_M {MAX_M}); "
          f"DENSE {step.mode}; ITERATIVE {it_step.mode}", flush=True)
    if not (step.library and it_step.library and nf > MAX_M):
        raise SystemExit("FUSED_LARGE_M: not the route past MAX_M")

    # ---- K1, K2, K6 and K4 at nf 1,134 against their plain versions ----
    x0 = program.initial_state()
    xe = x0[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x0[step.f_slab:step.f_slab + nf].float()
    se0, _ = step.initial_scales()
    lin_args = (xf, xe, step.cam, step.mask, step.dat, se0, True)

    def cmp_dict(got, want):
        return [rel_err(got[k], want[k]) for k in want]

    def cmp_all(got, want):
        return [rel_err(a, b) for a, b in zip(got, want)]
    added = []
    added.append(check_kernel(
        f"K1 lin (nf {nf})", lambda: lin(*lin_args, plan=step.plan),
        lambda: lin_plain(*lin_args[:4], step.dat[..., 0],
                          step.dat[..., 1], *lin_args[5:]),
        cmp_dict, F32_LIMIT, "ceres_tpu_torch/csrc/lin.cu",
        "ceres_tpu/ops/pallas_lin.py:66", lin_args, 516 * nobs,
        F32_FLOP_PER_S))
    art = step.linearize(x0, *step.initial_scales(), True)
    elim_args = (art.A, art.etes, art.gse, art.diag_e, RADIUS)
    print(f"FUSED_LARGE_M: A {tuple(art.A.shape)}, "
          f"{art.A.numel() * 4 / 1e9:.3f} GB", flush=True)

    def own_limits(name, kernel, plain, args):
        """Each output's limit: F32_LIMIT, or twice the plain version's
        own distance from its f64 run on these inputs where that is
        larger (points seen by two or three cameras have near-singular
        E^T E blocks, whose f32 inverses the plain version itself holds
        only to ~1e-5 here); both distances printed. The kernel is held
        to the f64 run within these limits too, so that a kernel farther
        from f64 than the plain version fails."""
        want32 = plain(*args)
        want64 = plain(*[a.double() if torch.is_tensor(a) else a
                         for a in args])
        got = kernel(*args)
        own = [rel_err(w, w64)[0] for w, w64 in zip(want32, want64)]
        mine = [rel_err(g, w64)[0] for g, w64 in zip(got, want64)]
        print(f"{name}: the plain version (f32) from its f64 run "
              f"{', '.join(f'{e:.3e}' for e in own)}; the kernel from the "
              f"f64 run {', '.join(f'{e:.3e}' for e in mine)}", flush=True)
        limits = [max(F32_LIMIT, 2.0 * e) for e in own]
        if not all(e <= lim for e, lim in zip(mine, limits)):
            raise SystemExit(f"{name}: the kernel is off the f64 run")
        return limits
    k2_limit = own_limits(f"K2 elim (nf {nf})", elim, elim_plain, elim_args)
    added.append(check_kernel(
        f"K2 elim (nf {nf})", lambda: elim(*elim_args),
        lambda: elim_plain(*elim_args), cmp_all, k2_limit,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:424",
        elim_args[:4], scorr_flops(ne, nf) + INV_Z_FLOPS[3] * ne,
        F32_FLOP_PER_S,
        reference=scorr_gemm(art.A, elim_plain(*elim_args)[2])))
    rad = torch.tensor(RADIUS, dtype=torch.float32, device=device)
    inv, z = it_step.point_inverse(art, rad)
    k6_limit = own_limits(f"K6 elim_v1 (nf {nf})", elim_v1, elim_v1_plain,
                          (art.A, inv, z))
    added.append(check_kernel(
        f"K6 elim_v1 (nf {nf})", lambda: elim_v1(art.A, inv, z),
        lambda: elim_v1_plain(art.A, inv, z), cmp_all, k6_limit,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:387",
        (art.A, inv, z), scorr_flops(ne, nf), F32_FLOP_PER_S,
        reference=scorr_gemm(art.A, inv)))
    k4 = step.k4
    added.append(check_kernel(
        f"K4 cost (nf {nf})", lambda: snavely_sq(x0, k4),
        lambda: snavely_sq_plain(x0, k4), lambda g, w: [rel_err(g, w)],
        F64_LIMIT, "ceres_tpu_torch/csrc/cost.cu",
        "ceres_tpu/ops/pallas_cost.py:147",
        (x0[k4.e_slab:k4.e_slab + 3 * k4.ne],
         x0[k4.f_slab:k4.f_slab + 9 * k4.kf], k4.pt_idx, k4.cam_idx,
         k4.obsx, k4.obsy), 60 * k4.n, F64_FLOP_PER_S))
    for rec, path in zip(added, ("FUSED_LARGE_M_DENSE",
                                 "FUSED_LARGE_M_DENSE",
                                 "FUSED_LARGE_M_ITERATIVE",
                                 "FUSED_LARGE_M_DENSE")):
        rec["counter"] = rec["name"].split(" (")[0]
        MAIN_PATH[rec["name"]] = path
    kernels.extend(added)
    # the reduced solves past MAX_M, at the first linearization
    S, rhs, _, _ = step.reduced_system(art, RADIUS)
    S_it, rhs_it, _, _ = it_step.reduced_system(art, RADIUS)
    minv = it_step.precond_inverse(art, S_it, rad)
    y = cholesky_solve(S, rhs)
    y_cg, n_cg = explicit_cg(S_it, rhs_it, minv, **it_step.pcg_args)
    chol_ms = median_ms(lambda: cholesky_solve(S, rhs))
    cg_ms = median_ms(lambda: explicit_cg(S_it, rhs_it, minv,
                                          **it_step.pcg_args))
    solve_ms = median_ms(lambda: torch.linalg.solve(S, rhs))
    # the Cholesky's backward error: its f64 residual against ||rhs||
    chol_rel = float(torch.linalg.vector_norm(
        S.double() @ y.double() - rhs.double())
        / torch.linalg.vector_norm(rhs.double()))
    # the card's reduced CG against the same CG in f64 on the CPU: as many
    # iterations (CG_LIMIT), and its stopping rule's own count within one
    # (the q-test compares a ratio with eta, which f32 moves by a step)
    n_cg = int(n_cg)
    cpu64 = [t.double().cpu() for t in (S_it, rhs_it, minv)]
    y64, _ = explicit_cg(*cpu64, max_iterations=n_cg,
                         min_iterations=n_cg)
    _, n64 = explicit_cg(*cpu64, **it_step.pcg_args)
    cg_rel = rel_err(y_cg.cpu(), y64)[0]
    del cpu64, y64
    print(f"FUSED_LARGE_M reduced solves at m {nf}: library Cholesky "
          f"(torch.linalg.cholesky_ex + cholesky_solve) {chol_ms:.4f} ms, "
          f"relative residual {chol_rel:.3e} (bound "
          f"{bound(8 * nf * nf + 8 * nf, nf ** 3 / 3 + 2 * nf * nf, F32_FLOP_PER_S)[0]:.5f} ms); "
          f"torch.linalg.solve {solve_ms:.4f} ms; reduced CG (solvers/cg.py"
          f", SCHUR_JACOBI) {cg_ms:.4f} ms for {int(n_cg)} iterations "
          f"({cg_ms / max(n_cg, 1):.4f} ms an iteration), from the f64 "
          f"CG on the CPU {cg_rel:.3e} (limit {CG_LIMIT:.0e}), whose own "
          f"stopping rule took {int(n64)}", flush=True)
    if not (chol_rel <= 1e-4 and cg_rel <= CG_LIMIT
            and abs(int(n64) - n_cg) <= 1):
        raise SystemExit("FUSED_LARGE_M: the reduced solves are off")
    del art, elim_args, inv, z, S, rhs, S_it, rhs_it, minv, y, y_cg

    # ---- the solves ----
    walls, fails = {}, []
    for label, cfg in FUSED_LARGE_M.items():
        seen, walls[label] = [], []
        for trial in range(cfg["trials"]):
            reset()
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            summary = ctt.solve(opts[label], problem)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            n_lm = summary.num_iterations
            ref = cfg["ref_cost"]
            rel = (abs(summary.final_cost - ref) / ref if ref else
                   float("nan"))
            kind = "warm-up" if trial == 0 else "timed"
            if trial:
                walls[label].append(wall)
            print(f"{label} {kind} solve: {n_lm} LM iterations "
                  f"({summary.num_successful_steps} accepted; JAX "
                  f"{cfg['ref_iterations']}), "
                  f"{summary.num_linear_solver_iterations} linear solver "
                  f"iterations, initial cost {summary.initial_cost!r}, final "
                  f"cost {summary.final_cost!r} ({rel:.3e} from JAX "
                  f"{ref!r}, limit {cfg['tol']}), {summary.termination_type}"
                  f", wall {wall:.4f} s, launches "
                  f"{ {n: c for n, c in launches.items() if c} }; "
                  f"{summary.message.split('Schur step: ')[-1]}",
                  flush=True)
            by_path[label] = launches
            route = ("CG on the explicit S" if cfg["solver"]
                     == "ITERATIVE_SCHUR" else "library Cholesky")
            short = [n for n in cfg["kernels"][1:] if launches[n] < n_lm]
            n1 = launches["K1 lin"]
            stray = [n for n, c in launches.items()
                     if c and n not in cfg["kernels"]]
            if (f"reduced solve: {route}" not in summary.message or short
                    or stray or not summary.num_successful_steps <= n1
                    <= n_lm + 1):
                raise SystemExit(f"{label}: route or launches off (short "
                                 f"{short}, stray {stray}, K1 {n1})")
            if ref is None or not (
                    str(summary.termination_type) == cfg["ref_termination"]
                    and rel <= cfg["tol"]
                    and (cfg["ref_iterations"] is None
                         or n_lm == cfg["ref_iterations"])):
                fails.append(f"{label} off the JAX package's run")
            seen.append((n_lm, summary.final_cost))
            if len(set(seen)) != 1:
                fails.append(f"{label}: solves differ: {seen}")
    print(f"FUSED_LARGE_M walls (s): {walls}", flush=True)
    del problem, program, step, it_step
    if fails:
        raise SystemExit(f"FUSED_LARGE_M: {fails}")
    return walls


def line_search_paths(counters, by_path, device="cuda"):
    """Slice 10's LINE_SEARCH_PATHS (LINE_SEARCH_REF), each with every
    kernel count from 0 and no kernel launched: the tutorial's Rosenbrock,
    the extended Rosenbrock in EXT_ROSENBROCK_N parameters, bundle_adjuster
    --line_search on BAL-16-22106 and a tiny_solve batch of TINY_BATCH
    problems (against the JAX package's iteration counts, converged flags
    and sum of the solutions, and problem by problem against the same
    batch run by the port on the CPU)."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import bundle_adjuster, tutorial
    ref = LINE_SEARCH_REF

    def zero():
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        return time.time()

    def done(label, t0):
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        by_path[label] = launches
        stray = [n for n, c in launches.items() if c]
        if stray:
            raise SystemExit(f"{label}: kernels launched: {stray}")
        return wall

    fails = []
    # the tutorial's Rosenbrock (GradientProblemSolver, L-BFGS)
    t0 = zero()
    x, s = tutorial.rosenbrock(device=device)
    wall = done("LS_ROSENBROCK", t0)
    n_it = len(s.iterations) - 1
    print(f"LS_ROSENBROCK: {n_it} iterations (JAX "
          f"{ref['rosenbrock_iterations']}), final cost {s.final_cost!r}, "
          f"x {x.tolist()}, {s.termination_type}, wall {wall:.4f} s",
          flush=True)
    if not (n_it == ref["rosenbrock_iterations"]
            and np.abs(x - 1.0).max() < 1e-6):
        fails.append("LS_ROSENBROCK")

    # the extended Rosenbrock function, EXT_ROSENBROCK_N parameters
    n = EXT_ROSENBROCK_N
    fn = ctt.AutoDiffFirstOrderFunction(extended_rosenbrock(torch), n)
    ext = ref["extended"]
    for trial in range(2):
        x = extended_rosenbrock_start(n)
        t0 = zero()
        s = ctt.solve_gradient_problem(ctt.SolverOptions(
            minimizer_type=ctt.MinimizerType.LINE_SEARCH,
            max_num_iterations=200, device=device),
            ctt.GradientProblem(fn), x)
        wall = done("LS_EXTENDED_ROSENBROCK", t0)
        n_it = len(s.iterations) - 1
        print(f"LS_EXTENDED_ROSENBROCK (n {n}, L-BFGS, Wolfe) "
              f"{'warm-up' if trial == 0 else 'timed'}: {n_it} iterations "
              f"(JAX {ext['iterations']}), {s.num_line_search_steps} probes,"
              f" initial cost {s.initial_cost!r}, final cost "
              f"{s.final_cost!r} (JAX {ext['final_cost']!r}), "
              f"{s.termination_type} ({s.message}), max |x - 1| "
              f"{np.abs(x - 1.0).max():.3e}, wall {wall:.3f} s", flush=True)
    if not (n_it == ext["iterations"]
            and str(s.termination_type) == ext["termination"]
            and s.final_cost <= max(10.0 * ext["final_cost"],
                                    1e-12 * s.initial_cost)):
        fails.append("LS_EXTENDED_ROSENBROCK")

    # bundle_adjuster --line_search on BAL-16-22106, f64
    ba = ref["ba_ls"]
    t0 = zero()
    s = bundle_adjuster.run(BA_LS_ARGS + ["--device", device])[0]
    wall = done("LS_BUNDLE_ADJUSTER", t0)
    n_it = len(s.iterations) - 1
    rel = (abs(s.final_cost - ba["final_cost"]) / ba["final_cost"]
           if ba["final_cost"] else float("nan"))
    print(f"LS_BUNDLE_ADJUSTER (bundle_adjuster {' '.join(BA_LS_ARGS)}): "
          f"{n_it} iterations (JAX {ba['iterations']}), "
          f"{s.num_line_search_steps} probes, initial cost "
          f"{s.initial_cost!r}, final cost {s.final_cost!r} ({rel:.3e} from "
          f"JAX {ba['final_cost']!r}, limit {ba['tol']}), "
          f"{s.termination_type}, solve {s.total_time_in_seconds:.3f} s, "
          f"run() {wall:.3f} s", flush=True)
    if not (str(s.termination_type) == ba["termination"]
            and rel <= ba["tol"]):
        fails.append("LS_BUNDLE_ADJUSTER")

    # tiny_solve on TINY_BATCH problems at once
    a, x0 = tiny_problems(TINY_BATCH)
    f = tiny_residual(torch)
    opts = ctt.TinySolverOptions(**TINY_OPTIONS)
    for trial in range(2):
        t0 = zero()
        got = ctt.tiny_solve(f, torch.tensor(x0, device=device), opts,
                             args=(torch.tensor(a, device=device),))
        wall = done("LS_TINY_SOLVER", t0)
        print(f"LS_TINY_SOLVER ({TINY_BATCH} problems) "
              f"{'warm-up' if trial == 0 else 'timed'}: wall {wall:.4f} s, "
              f"{int(got.iterations.max())} loop iterations", flush=True)
    t0 = time.time()
    cpu = ctt.tiny_solve(f, torch.tensor(x0), opts, args=(torch.tensor(a),))
    cpu_wall = time.time() - t0
    counts = got.iterations.cpu().numpy().astype(np.int32)
    cpu_counts = cpu.iterations.numpy()
    xs = got.x.cpu().numpy()
    digest = tiny_counts_digest(counts)
    tiny = ref["tiny"]
    exact = (counts <= TINY_EXACT_MAX) | (cpu_counts <= TINY_EXACT_MAX)
    moved = int((counts != cpu_counts).sum())
    x_cpu = float(np.abs(xs - cpu.x.numpy()).max())
    x_sum = float(xs.sum())
    sol = np.stack([a, a * a], axis=1)
    print(f"LS_TINY_SOLVER: {int(counts.sum())} iterations in all, at most "
          f"{int(counts.max())}; counts digest {digest} (JAX "
          f"{tiny['counts_digest']}), converged {int(got.converged.sum())} "
          f"(JAX {tiny['converged']}), sum of x {x_sum!r} (JAX "
          f"{tiny['x_sum']!r}); the port's CPU batch ({cpu_wall:.2f} s): "
          f"{moved} counts differ (none may at most {TINY_EXACT_MAX}), x "
          f"within {x_cpu:.3e}; max |x - (a, a^2)| "
          f"{float(np.abs(xs - sol).max()):.3e}", flush=True)
    if not (tuple(digest) == tuple(tiny["counts_digest"])
            and np.array_equal(counts[exact], cpu_counts[exact])
            and x_cpu <= 1e-10
            and int(got.converged.sum()) == tiny["converged"]
            and abs(x_sum - tiny["x_sum"]) <= 1e-12 * abs(tiny["x_sum"])):
        fails.append("LS_TINY_SOLVER")
    if fails:
        raise SystemExit(f"LINE_SEARCH_PATHS: off the JAX package: {fails}")


def problem_api_paths(counters, by_path, device="cuda"):
    """Slice 11's phase, each part with every kernel count from 0 before
    each solve and read after it:
    OUTLIER: the main path's problem with shift_observations' outliers,
    solved with bench.py's options (K1-K4 at least once an LM iteration,
    K1 once a linearization), evaluated on the card, every observation
    past OUTLIER_THRESHOLD removed with the points it leaves bare, solved
    again on the program the removal forces: the removed set, the counts
    after removal and both final costs against the JAX CPU run
    (OUTLIER_REF, costs within REF_REL_TOL);
    EVALUATE: Problem.evaluate at Trafalgar's shape on the card (the full
    call with a CSR Jacobian, twice; a subset; evaluate_residual_block on
    EVALUATE_BLOCKS blocks) against the same calls on the CPU (the CSR
    structure bit for bit, values within EVALUATE_TOL) and the JAX CPU
    run's cost and gradient norm (EVALUATE_REF);
    EXAMPLES: EXAMPLE_RUNS and every More-Garbow-Hillstrom problem,
    unconstrained and constrained, against EXAMPLE_REF and MGH_REF (no
    kernel may launch: f64 host-loop paths);
    GRADCHECK: GradientChecker.probe on GRADCHECK_BLOCKS Snavely blocks
    at their start (the flags and the sum of the largest errors against
    GRADCHECK_REF), check_gradients solves of circle_fit and
    robot_pose_mle that pass, and GRADCHECK_WRONG, which must end in
    FAILURE with the JAX message.
    Each call's wall is printed."""
    import hashlib
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import more_garbow_hillstrom as mgh
    from ceres_tpu_torch.io import bal as bal_io

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def zero():
        for fn in counters.values():
            fn.launches = 0
        sync()
        return time.time()

    def read(label, t0):
        sync()
        wall = time.time() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        by_path[label] = launches
        return wall, launches

    fails = []
    # ---- OUTLIER ----
    ref = OUTLIER_REF
    bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    shifted = shift_observations(bal.observations)
    problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
    rbs = problem.residual_blocks()
    # GRADCHECK probes these blocks at the start, as the JAX run does
    probe_at = [(rb.cost, [cams[bal.camera_index[rb.index]].copy(),
                           pts[bal.point_index[rb.index]].copy()])
                for rb in rbs[:GRADCHECK_BLOCKS]]
    opts = outlier_options(ctt, device=device)
    main_k = ("K1 lin", "K2 elim", "K3 chol_solve", "K4 cost")
    solves = []
    for label in ("OUTLIER_FIRST", "OUTLIER_SECOND"):
        if label == "OUTLIER_SECOND":
            t0 = time.time()
            _, r, _, _ = problem.evaluate(want_residuals=True, device=device)
            w_eval = time.time() - t0
            t0 = time.time()
            removed, emptied, err = remove_outliers(
                problem, rbs, pts, bal.point_index, r, OUTLIER_THRESHOLD)
            w_remove = time.time() - t0
            near = float(np.min(np.abs(err - OUTLIER_THRESHOLD))
                         / OUTLIER_THRESHOLD)
            digest = removed_digest(removed)
            print(f"OUTLIER: evaluate on the card {w_eval:.3f} s; "
                  f"{removed.size} blocks past {OUTLIER_THRESHOLD} px "
                  f"removed ({np.isin(shifted, removed).sum()} of the "
                  f"{shifted.size} shifted; digest {digest}; JAX "
                  f"{ref['removed']}, {ref['digest']}), {emptied.size} "
                  f"points left bare removed (JAX {ref['emptied']}), "
                  f"{w_remove:.3f} s; nearest error {near:.3e} of the "
                  f"threshold away (at least {OUTLIER_MARGIN:.0e}); "
                  f"{problem.num_residual_blocks()} "
                  f"residual blocks and {problem.num_parameters()} "
                  f"parameters left (JAX {ref['residual_blocks']}, "
                  f"{ref['parameters']})", flush=True)
            if not (removed.size == ref["removed"] and near >= OUTLIER_MARGIN
                    and digest == ref["digest"]
                    and emptied.size == ref["emptied"]
                    and problem.num_residual_blocks()
                    == ref["residual_blocks"]
                    and problem.num_parameters() == ref["parameters"]):
                fails.append("OUTLIER removal")
        t0 = zero()
        s = ctt.solve(opts, problem)
        wall, launches = read(label, t0)
        lm = lm_iterations(s)
        want = ref["first" if label == "OUTLIER_FIRST" else "second"]
        rel = abs(s.final_cost - want[1]) / want[1]
        short = [k for k in main_k[1:] if launches[k] < lm]
        n1 = launches["K1 lin"]
        stray = [k for k, c in launches.items() if c and k not in main_k
                 and not k.startswith("K3 chol_solve (")]
        print(f"{label}: {lm} LM iterations ({s.num_successful_steps} "
              f"accepted; JAX {want[0]}), final cost {s.final_cost!r} "
              f"({rel:.3e} from JAX {want[1]!r}), {s.termination_type}, "
              f"wall {wall:.4f} s, launches {launches}", flush=True)
        if (short or stray or rel > REF_REL_TOL
                or not s.num_successful_steps <= n1 <= lm + 1
                or str(s.termination_type) != want[2]):
            fails.append(label)
        solves.append(s)

    # ---- EVALUATE ----
    eref = EVALUATE_REF
    t0 = time.time()
    eproblem, ecams, epts = evaluate_problem(bal_io)
    print(f"EVALUATE: problem build {time.time() - t0:.1f} s", flush=True)
    kw = dict(want_residuals=True, want_gradient=True, want_jacobian=True,
              jacobian_format="csr")
    out = {}
    for dev in (device, device, "cpu"):
        t0 = time.time()
        got = eproblem.evaluate(device=dev, **kw)
        sync()
        wall = time.time() - t0
        again = " (its program cached)" if dev in out else ""
        print(f"EVALUATE full on {dev}{again}: {wall:.3f} s", flush=True)
        out[dev] = got
    sub_rbs = eproblem.residual_blocks()[:EVALUATE_SUBSET_ROWS]
    for dev in (device, "cpu"):
        t0 = time.time()
        out["sub " + dev] = eproblem.evaluate(
            residual_blocks=sub_rbs, parameter_blocks=ecams, device=dev, **kw)
        print(f"EVALUATE subset ({EVALUATE_SUBSET_ROWS} residual blocks x "
              f"{len(ecams)} camera blocks) on {dev}: "
              f"{time.time() - t0:.3f} s", flush=True)

    def same(a, b):
        """(structure equal, value distance) of two outputs."""
        ca, ra, ga, Ja = a
        cb, rb_, gb, Jb = b
        struct = (np.array_equal(Ja.indptr, Jb.indptr)
                  and np.array_equal(Ja.indices, Jb.indices))
        dist = max(abs(ca - cb) / abs(cb),
                   *(float(np.abs(x - y).max() / np.abs(y).max())
                     for x, y in ((ra, rb_), (ga, gb), (Ja.data, Jb.data))))
        return struct, dist

    for label, a, b in (("full", out[device], out["cpu"]),
                        ("subset", out["sub " + device], out["sub cpu"])):
        struct, dist = same(a, b)
        print(f"EVALUATE {label}: card vs CPU: CSR structure "
              f"{'bit-equal' if struct else 'DIFFERENT'} ({a[3].shape}, "
              f"{a[3].nnz} nonzeros), values within {dist:.3e} (limit "
              f"{EVALUATE_TOL:.0e})", flush=True)
        if not (struct and dist <= EVALUATE_TOL):
            fails.append(f"EVALUATE {label}")
    cost, res, grad, jac = out[device]
    gnorm = float(np.linalg.norm(grad))
    d_cost = abs(cost - eref["cost"]) / eref["cost"]
    d_grad = abs(gnorm - eref["gradient_norm"]) / eref["gradient_norm"]
    print(f"EVALUATE vs JAX on the CPU: cost {cost!r} ({d_cost:.3e} from "
          f"{eref['cost']!r}), gradient norm {gnorm!r} ({d_grad:.3e} from "
          f"{eref['gradient_norm']!r}), nonzeros {jac.nnz} (JAX "
          f"{eref['nnz']})", flush=True)
    if not (d_cost <= EVALUATE_TOL and d_grad <= EVALUATE_TOL
            and jac.nnz == eref["nnz"]):
        fails.append("EVALUATE vs JAX")
    offset, o = {}, 0
    for b in eproblem.parameter_blocks():
        offset[id(b)] = o
        o += eproblem.parameter_block_tangent_size(b)
    all_rbs = eproblem.residual_blocks()
    picks = np.linspace(0, len(all_rbs) - 1, EVALUATE_BLOCKS).astype(int)
    worst = 0.0
    t0 = time.time()
    for i in picks:
        rb = all_rbs[i]
        c_b, r_b, jacs = eproblem.evaluate_residual_block(rb, device=device)
        rows = jac[2 * i:2 * i + 2].toarray()
        worst = max(worst, float(np.abs(r_b - res[2 * i:2 * i + 2]).max()
                                 / np.abs(res[2 * i:2 * i + 2]).max()))
        for arr, J in zip(eproblem.get_parameter_blocks_for_residual_block(
                rb), jacs):
            off = offset[id(arr)]
            want = rows[:, off:off + J.shape[1]]
            worst = max(worst, float(np.abs(J - want).max()
                                     / np.abs(want).max()))
    w_blocks = time.time() - t0
    print(f"EVALUATE evaluate_residual_block on {EVALUATE_BLOCKS} blocks: "
          f"{w_blocks:.3f} s ({1e3 * w_blocks / EVALUATE_BLOCKS:.2f} ms a "
          f"block); rows and Jacobian blocks within {worst:.3e} of the full "
          f"call's", flush=True)
    if not worst <= EVALUATE_TOL:
        fails.append("EVALUATE residual blocks")
    del eproblem, ecams, epts, out, jac

    # ---- EXAMPLES ----
    def gate_run(label, s, want):
        """want: the EXAMPLE_REF or MGH_REF entry of `label`."""
        lm = lm_iterations(s)
        tol = max(EXAMPLE_COST_TOL * abs(want[1]), EXAMPLE_COST_FLOOR,
                  2.0 * want[3])
        ok = (abs(lm - want[0]) <= max(2 * want[2],
                                       LM_ROUNDING.get(label, 0))
              and abs(s.final_cost - want[1]) <= tol)
        return ok, lm, tol

    for name in EXAMPLE_RUNS:
        t0 = zero()
        s = run_example(ctt, name, device=device)[0]
        wall, launches = read(f"EXAMPLE_{name}", t0)
        want = EXAMPLE_REF[name]
        ok, lm, tol = gate_run(name, s, want)
        stray = [k for k, c in launches.items() if c]
        print(f"EXAMPLE {name}: {lm} LM (JAX {want[0]}, spread {want[2]}), "
              f"final cost {s.final_cost!r} (JAX {want[1]!r}, limit "
              f"{tol:.3e}), {s.termination_type}, wall {wall:.3f} s",
              flush=True)
        if not ok or stray:
            fails.append(f"EXAMPLE {name}{' kernels ' if stray else ''}"
                         f"{stray if stray else ''}")
    t_mgh = zero()
    n_mgh = 0
    for constrained in (False, True):
        for p in mgh.PROBLEMS:
            key = f"{p.number}{'C' if constrained else 'U'}"
            if key not in MGH_REF:
                continue
            lre, s, _ = mgh.solve_mgh(p, constrained=constrained,
                                      device=device)
            want = MGH_REF[key]
            ok, lm, tol = gate_run(key, s, want)
            ok = ok and (lre >= 4.0 or not want[4] >= 4.0)
            n_mgh += 1
            print(f"MGH {key} {p.name}: {lm} LM (JAX {want[0]}, spread "
                  f"{want[2]}, allowed "
                  f"{max(2 * want[2], LM_ROUNDING.get(key, 0))}), final cost "
                  f"{s.final_cost!r} (JAX "
                  f"{want[1]!r}, limit {tol:.3e}), LRE {lre:.2f} (JAX "
                  f"{want[4]:.2f}), {s.termination_type}", flush=True)
            if not ok:
                fails.append(f"MGH {key}")
    wall, launches = read("EXAMPLE_MGH", t_mgh)
    print(f"MGH: {n_mgh} solves in {wall:.2f} s", flush=True)
    if any(launches.values()):
        fails.append("MGH kernels")

    # ---- GRADCHECK ----
    gref = GRADCHECK_REF
    t0 = time.time()
    flags, worst = [], []
    for cost, params in probe_at:
        res = ctt.GradientChecker(cost, device=device).probe(
            params, GRADCHECK_PRECISION)
        flags.append(res.return_value)
        worst.append(res.maximum_relative_error)
    w_probe = time.time() - t0
    fdigest = hashlib.sha256(np.asarray(flags).tobytes()).hexdigest()[:16]
    d_sum = abs(sum(worst) - gref["error_sum"]) / gref["error_sum"]
    print(f"GRADCHECK probe on {GRADCHECK_BLOCKS} Snavely blocks at "
          f"{GRADCHECK_PRECISION:g}: {sum(flags)} pass (JAX "
          f"{gref['probe_pass']}, flags digest {fdigest}, JAX "
          f"{gref['probe_digest']}), largest relative error "
          f"{max(worst):.6e}, their sum {sum(worst)!r} ({d_sum:.3e} from "
          f"JAX's, limit {GRADCHECK_SUM_TOL:.0e}), {w_probe:.3f} s",
          flush=True)
    if not (sum(flags) == gref["probe_pass"]
            and fdigest == gref["probe_digest"]
            and d_sum <= GRADCHECK_SUM_TOL):
        fails.append("GRADCHECK probe")
    from ceres_tpu_torch.examples import circle_fit, robot_pose_mle
    pts_c = circle_fit.synthesize(num_points=60, outliers=4, cx=2.0, cy=3.0,
                                  r=5.0, seed=1)
    t0 = time.time()
    s = circle_fit.fit_circle(pts_c, pts_c[0, 0], pts_c[0, 1], 1.0,
                              robust_threshold=0.5, device=device,
                              check_gradients=True)[3]
    checked = [("circle_fit", s, time.time() - t0)]
    odo, rng_ = robot_pose_mle.simulate_robot()
    t0 = time.time()
    s = robot_pose_mle.solve_robot_pose_mle(
        odo, rng_, options=ctt.SolverOptions(max_num_iterations=500,
                                             check_gradients=True,
                                             device=device))[1]
    checked.append(("robot_pose_mle", s, time.time() - t0))
    for name, s, wall in checked:
        want = EXAMPLE_REF[name]
        ok, lm, tol = gate_run(name, s, want)
        print(f"GRADCHECK check_gradients solve of {name}: "
              f"{s.termination_type}, {lm} LM, final cost "
              f"{s.final_cost!r} (JAX {want[1]!r}), wall {wall:.3f} s",
              flush=True)
        if not (ok and s.is_solution_usable()):
            fails.append(f"GRADCHECK {name}")
    s = GRADCHECK_WRONG(ctt, torch, device=device)
    print(f"GRADCHECK wrong analytic cost: {s.termination_type}, "
          f"{s.message!r} (JAX {gref['message']!r})", flush=True)
    if not (str(s.termination_type) == "FAILURE"
            and s.message == gref["message"]):
        fails.append("GRADCHECK wrong cost")
    if fails:
        raise SystemExit(f"PROBLEM_API_PATHS: failed: {fails}")


# slice 12 (`solver_options_paths`): the rest of Solver::Options, each
# path driven with every kernel count set to 0 just before it and read
# just after. References: scripts/slice12_reference.py (the JAX package
# on the CPU; `cluster` on the card's machine, CPU only).
#
# FUSED_LS: the line-search minimizer with fused_iterations=True, which
# the port runs on its host loop and reports as the JAX package's
# device-resident loop reports (minimizers/line_search.py): the
# tutorial's Rosenbrock, the extended Rosenbrock in EXT_ROSENBROCK_N
# parameters (L-BFGS, Wolfe) and the BA line search of FUSED_LS_BA_ARGS
# (f64), each beside fused_iterations=False on the same problem. Gates:
# the fused run's x and final cost bit for bit the host run's, its
# counts the host run's, no per-iteration records; against the JAX fused
# loop, as the CPU tests hold it, the counts where they are at most 50
# (both Rosenbrocks end in fewer) and the BA run, cut at 3 iterations,
# on its count and cost (FUSED_LS_REF). No kernel may launch.
# The BA line search cut at 3 iterations (BA_LS_ARGS's problem and
# options). From this start it is chaotic from the first iterations: the
# JAX fused runs from starts scaled by 1 -+ 1e-12 end 3.1e-2 and 3.3e-2
# apart after 10 iterations (1 -+ 1e-9: 7.4e-1 and 5.2e-3), so only a
# short cut holds the port to the JAX loop.
FUSED_LS_BA_ARGS = BA_LS_ARGS[:-1] + ["3"]
# INNER: bundle_adjuster --inner_iterations on BAL-16-22106 under its
# defaults (f64, SPARSE_SCHUR + JACOBI, 5 iterations): the JAX package's
# LM count and inner-iteration steps, its cost within BA_F64_REL_TOL. No
# kernel may launch (the f64 generic step runs none).
INNER_ARGS = ["--synthetic_cameras", "16", "--synthetic_points", "22106",
              "--synthetic_observations", "83718", "--random_seed", "7",
              "--rotation_sigma", "0.1", "--translation_sigma", "1.0",
              "--point_sigma", "0.5", "--inner_iterations"]
# CLUSTER: bundle_adjuster at Trafalgar's shape (TRAFALGAR_ARGS), 5
# iterations, ITERATIVE_SCHUR with CLUSTER_JACOBI (canonical views) and
# CLUSTER_TRIDIAGONAL (single linkage: canonical views at this shape
# puts every camera in a handful of clusters whose forest is short), in
# f64 and mixed, beside SCHUR_JACOBI in f64 (its PCG iterations for the
# comparison). The mixed runs linearize through K11's Snavely spec
# (counted). The JAX package's mixed CLUSTER solve does not trace
# (ROADMAP.md section 3): every run is gated against its f64 solve.
CLUSTER_PATHS = {
    "CLUSTER_JACOBI": ["--preconditioner", "cluster_jacobi"],
    "CLUSTER_TRIDIAGONAL": ["--preconditioner", "cluster_tridiagonal",
                            "--visibility_clustering", "single_linkage"],
    "CLUSTER_JACOBI_MIXED": ["--preconditioner", "cluster_jacobi",
                             "--mixed_precision_solves"],
    "CLUSTER_TRIDIAGONAL_MIXED": ["--preconditioner", "cluster_tridiagonal",
                                  "--visibility_clustering",
                                  "single_linkage",
                                  "--mixed_precision_solves"],
    "CLUSTER_SCHUR_JACOBI": ["--preconditioner", "schur_jacobi"],
}
CLUSTER_COMMON = ["--linear_solver", "iterative_schur"]
# The mixed runs' preconditioner on their first damped system (S in
# f32, as the solve formed it): its pattern equal to the one this script
# builds from the clustering, the same factor picked (the forest's or
# the cluster-diagonal fallback) as cluster_factor picks for the same S
# in f64, and the f32 solve's normwise backward error
# ||M y - v|| / (||M||_F ||y|| + ||v||), M = L64 L64^T, within
# CLUSTER_F32_LIMIT. An f32 Cholesky solve of order nf keeps it below
# sqrt(nf) eps32 (~3e-6 at nf 2,313; 6.8e-9 for CLUSTER_TRIDIAGONAL on
# a 12-camera problem on the CPU); a wrong pattern or the other factor
# leaves the dropped blocks' share of S in it (6.3e-4 there with the
# fallback factor forced).
CLUSTER_F32_LIMIT = 1e-5
# DUMP: the SE2 1,000-pose graph under SolverOptions() (LM, DENSE_QR,
# f64, the host loop) with TEXTFILE dumps of the iterations in
# DUMP_ITERATIONS (iteration 0 is no step and writes none) and again
# with the CONSOLE line; each .npz array held against the port's own
# CPU run of the same solve within DUMP_TOL relative to its largest
# entry, the radius equal, the console lines' norms within DUMP_TOL.
DUMP_ITERATIONS = (0, 1, 2)
DUMP_TOL = 1e-9
# COV_SCHUR: Covariance SPARSE_QR (past SPARSE_QR_DENSE_CAP: the Schur
# branch) on the unperturbed BAL-16-22106 problem with cameras 0 and 1
# held constant; the blocks of COV_PAIRS against the JAX package's
# within COV_SCHUR_TOL relative to each block's largest entry.
COV_PAIRS = ((2, 2), (2, 9), (9, 9), (0, 9))
COV_SCHUR_TOL = 1e-8
# TE: BAL-16-sized problems (SHAPE, seed 7, TE_PERTURB) whose points are
# homogeneous (te 4: [X, Y, Z, 1] at the start) or confined to their own
# depth plane (te 2: (X, Y), Z fixed per observation), the Snavely
# camera, mixed DENSE_SCHUR and ITERATIVE_SCHUR + SCHUR_JACOBI on the
# fused step: K5, then K2 (te 2, DENSE_SCHUR) or K6, and K3 or K7.
# TE_PERTURB is milder than PERTURB: from PERTURB's start the
# homogeneous points wander along their scale directions and the JAX
# runs from starts scaled by 1 -+ 1e-7 end 29% apart after 50 LM
# iterations; from this one both point sizes converge to the main path's
# minimum.
TE_PERTURB = dict(rotation_sigma=0.01, translation_sigma=0.1,
                  point_sigma=0.05)
TE_PATHS = {"TE4_DENSE_SCHUR": (4, "DENSE_SCHUR"),
            "TE4_ITERATIVE_SCHUR": (4, "ITERATIVE_SCHUR"),
            "TE2_DENSE_SCHUR": (2, "DENSE_SCHUR"),
            "TE2_ITERATIVE_SCHUR": (2, "ITERATIVE_SCHUR")}


# The JAX package's references (scripts/slice12_reference.py --spread:
# fused_ls, inner, cov and te on the CPU here; cluster on the card's
# machine with CUDA_VISIBLE_DEVICES=).
FUSED_LS_REF = {
    # (iterations, probes, successful steps, message) of the JAX fused
    # loop; both end within 50 iterations, so their counts are gated
    "FUSED_LS_ROSENBROCK": dict(
        counts=(17, 30, 17, "Gradient tolerance reached.")),
    "FUSED_LS_EXTENDED_ROSENBROCK": dict(
        counts=(17, 30, 17, "Gradient tolerance reached.")),
    # cut at 3 iterations (33 probes); its Wolfe searches branch on the
    # last bits from the first iteration: the runs from the start scaled
    # by 1 -+ 1e-12 end 1.758e-7 and 4.411e-2 away with 28 and 33 probes
    # (1 -+ 1e-9: 6.2e-1 and 6.4e-4; the port on the CPU 1.6e-5 with 29):
    # the gate is twice the larger 1e-12 spread
    "FUSED_LS_BUNDLE_ADJUSTER": dict(iterations=3,
                                     final_cost=425832.4334201157,
                                     tol=8.82e-2),
}
INNER_REF = dict(iterations=4, inner_steps=4, final_cost=50287.72691043025)
# TE: the JAX fused step's runs; the spreads from the start scaled by
# 1 -+ 1e-7 are at most 9.2e-13 (DENSE_SCHUR) and 3.98e-7 (te 4
# ITERATIVE_SCHUR, 8-14 LM), below the f32 parting of the two packages:
# the gate is REF_REL_TOL, the main path's, on the cost, and the LM
# counts are reported
TE_REF = {
    "TE4_DENSE_SCHUR": dict(iterations=9, final_cost=50287.72691050271,
                            tol=REF_REL_TOL, termination="CONVERGENCE"),
    "TE4_ITERATIVE_SCHUR": dict(iterations=14,
                                final_cost=50287.74698251675,
                                tol=REF_REL_TOL, termination="CONVERGENCE"),
    "TE2_DENSE_SCHUR": dict(iterations=4, final_cost=236679.65161814087,
                            tol=REF_REL_TOL, termination="CONVERGENCE"),
    "TE2_ITERATIVE_SCHUR": dict(iterations=5, final_cost=236679.6516197831,
                                tol=REF_REL_TOL, termination="CONVERGENCE"),
}
# CLUSTER: the JAX package's f64 runs on the card's machine's CPU (5 LM,
# both stopping at the cap mid-descent): CLUSTER_JACOBI's canonical views
# put the 257 cameras in 86 clusters (no forest), CLUSTER_TRIDIAGONAL's
# single linkage leaves each camera its own cluster and chains them by
# a 256-edge forest. The runs from the start scaled by 1 -+ 1e-7 end
# 1.425e-8 / 1.424e-8 and 1.743e-8 / 1.750e-8 away with the same PCG
# counts: the f64 gates are twice the larger spread (SCHUR_JACOBI's,
# whose spread was not run, takes CLUSTER_TRIDIAGONAL's), with the PCG
# count. The mixed runs (the JAX package's do not trace) are gated on
# the f64 run at CLUSTER_MIXED_TOL: f32 PCG to eta 1e-2 stops at other
# counts (198 and 264 against 199 and 346 in a dev run on the card) and
# the trajectory, mid-descent at the cap, ends up to 5.2e-3 away.
CLUSTER_MIXED_TOL = 1e-2
CLUSTER_REF = {
    "CLUSTER_JACOBI": dict(iterations=5, pcg=199,
                           final_cost=126840.79531332356, tol=2.9e-8,
                           termination="NO_CONVERGENCE",
                           digest="3bc6aaf2a1f04bb5"),
    "CLUSTER_TRIDIAGONAL": dict(iterations=5, pcg=346,
                                final_cost=127525.29264516539, tol=3.5e-8,
                                termination="NO_CONVERGENCE",
                                digest="0b8023e9c2028623"),
    "CLUSTER_SCHUR_JACOBI": dict(iterations=5, pcg=311,
                                 final_cost=127866.71752428461, tol=3.5e-8,
                                 termination="NO_CONVERGENCE"),
}
CLUSTER_REF["CLUSTER_JACOBI_MIXED"] = dict(
    CLUSTER_REF["CLUSTER_JACOBI"], tol=CLUSTER_MIXED_TOL)
CLUSTER_REF["CLUSTER_TRIDIAGONAL_MIXED"] = dict(
    CLUSTER_REF["CLUSTER_TRIDIAGONAL"], tol=CLUSTER_MIXED_TOL)
# COV_PAIRS's blocks of the JAX package's Schur branch, row-major 9 x 9
COV_SCHUR_REF = [
    [8.730379430971101e-08, 8.52193870078295e-09, -1.0734988445690596e-08,
     -1.436651414604721e-09, 7.4048795918453835e-09, -1.2899698925188953e-07,
     6.889446254513712e-06, 3.5308399912693835e-08, 5.859479959011365e-08,
     8.521938700782955e-09, 1.9241516361451004e-07, -1.1561063673983703e-08,
     -1.7359408930790217e-08, 1.8084361220865225e-09, -4.023373495258783e-07,
     2.2656336267997362e-05, 3.148532278215731e-08, 7.25956444430689e-08,
     -1.0734988445690596e-08, -1.1561063673983703e-08, 7.22836972085693e-08,
     7.16019036617476e-10, -4.5844596402026635e-09, 3.050555903692207e-08,
     -1.5416113914305764e-06, -1.769281108774624e-08, -6.133773312597513e-08,
     -1.4366514146047214e-09, -1.7359408930790217e-08, 7.160190366174749e-10,
     3.549101331642566e-07, -4.080539394329152e-08, -1.5563724740798303e-07,
     3.1043536004516444e-06, 4.078430050234278e-08, -2.182816438012278e-07,
     7.404879591845384e-09, 1.8084361220865241e-09, -4.584459640202663e-09,
     -4.080539394329154e-08, 1.0157051618104385e-07, -3.4894025704090916e-08,
     3.0153200206237597e-06, 3.3131224241295026e-09, 1.787460697624868e-07,
     -1.2899698925188956e-07, -4.0233734952587835e-07, 3.050555903692203e-08,
     -1.556372474079832e-07, -3.489402570409096e-08, 0.00018454729636088613,
     -0.011086411645367836, -1.680377375156992e-05, -2.2744712914292536e-05,
     6.889446254513713e-06, 2.2656336267997342e-05, -1.541611391430575e-06,
     3.1043536004516487e-06, 3.015320020623761e-06, -0.011086411645367835,
     0.73768154534656, -0.0016739719274260591, 0.010874844877722995,
     3.530839991269377e-08, 3.148532278215739e-08, -1.769281108774624e-08,
     4.0784300502342736e-08, 3.313122424129519e-09, -1.6803773751569897e-05,
     -0.0016739719274260598, 0.00014243320601085515, -0.0005658920255721183,
     5.85947995901139e-08, 7.259564444306818e-08, -6.133773312597507e-08,
     -2.182816438012277e-07, 1.7874606976248663e-07, -2.2744712914292573e-05,
     0.010874844877722998, -0.0005658920255721183, 0.002668405149199714],
    [3.2465534644270903e-09, 3.030811175042144e-08, -3.0422455503450293e-08,
     1.5369058202510094e-09, 6.275315771238416e-10, 3.9998370460099586e-08,
     -1.6490254999408786e-06, -1.0765723061183142e-08, 3.428317468349851e-08,
     -1.579969350566347e-08, 9.877374057025624e-08, -9.032899246972053e-09,
     1.6844268718344735e-08, 4.055164048538017e-10, 4.5401533867749355e-07,
     -2.105817861283281e-05, -3.06791319835256e-08, 1.1272271258921355e-07,
     3.084679044984614e-08, -3.7129244874361384e-09, 1.2543265507978457e-08,
     -3.099822055623959e-09, -2.9645187805817983e-09, 1.4245629811002912e-08,
     -1.874398058821813e-06, -3.511702171870508e-09, 8.510069385096889e-09,
     -2.9134820336200376e-09, -1.086935015011002e-09, 2.8395868342334006e-09,
     -1.296578081795306e-07, 6.78702899588785e-08, -8.919588224822721e-07,
     1.5895491097087334e-06, 1.8600799714174583e-08, -3.473836046652135e-08,
     -3.2522744218665527e-09, 1.1885957482249923e-09, -2.257995447495322e-09,
     2.4591331610218127e-08, 1.5539787462700046e-08, 1.8473568051197098e-07,
     -4.939770177027517e-07, -1.5409624470203893e-09, 1.2843424444020257e-08,
     1.4720488121025988e-07, -9.970671254769452e-07, -3.582849069850447e-08,
     3.0004530701729336e-07, -3.720340878008389e-08, 3.675694382346498e-06,
     -0.00020051571423873048, 1.0880411248264154e-06, -3.772358902231207e-06,
     -6.040998338115988e-06, 5.3344577979966984e-05, 2.2030824070817395e-06,
     3.1487754589128978e-06, 1.2852823297719722e-06, -0.00018509518241305328,
     0.01970595795451252, -0.00018405024600302814, 0.0004625234260790016,
     -3.953410698506552e-08, 1.5790342490145535e-08, -7.680370913852604e-09,
     9.887092350207732e-08, -5.453883806186563e-09, 1.7554009787332234e-06,
     -0.00021946856389766167, 4.6814231783892775e-06,
     -1.0978119081978874e-05, 7.066680222572376e-08, 4.110059179370914e-07,
     -2.6239237347085617e-08, -4.947047035833655e-07, 7.092945623896693e-08,
     -4.275438982664841e-06, 0.00047723443994088656, -1.257502540033323e-05,
     3.8705477400679125e-05],
    [2.460844944396472e-07, -1.789195287337935e-08, 1.3670532809236905e-08,
     4.5053777696731485e-09, -2.594906018099537e-09, -1.4676187719941806e-07,
     1.061065610179009e-05, 9.353468335101968e-09, -7.603985526900276e-10,
     -1.789195287337939e-08, 8.357667628238178e-07, 2.326405387504637e-08,
     5.458384895772374e-09, 8.050248516340176e-09, 1.7679399899836667e-07,
     -9.442249939379611e-06, -9.773152113403355e-08, 1.8270955997230114e-07,
     1.367053280923687e-08, 2.3264053875046427e-08, 2.372711340786494e-07,
     -4.002987157928249e-09, 6.04281786485706e-09, -1.403701575601562e-07,
     6.965697218792233e-06, 3.913137067646726e-08, -5.1062591636967285e-08,
     4.50537776967314e-09, 5.458384895772339e-09, -4.00298715792826e-09,
     1.5622150410063403e-06, -1.3880763151186093e-08, 5.105922825023638e-07,
     -8.634376838103554e-06, 5.7963508896232245e-08, 3.094189162733578e-07,
     -2.5949060180995382e-09, 8.050248516340166e-09, 6.0428178648570586e-09,
     -1.3880763151186118e-08, 2.472257094825324e-07, -4.1600639558219246e-07,
     -2.1572755604791288e-06, -1.6406168804162114e-08,
     -8.894082627346196e-09, -1.467618771994187e-07, 1.7679399899836953e-07,
     -1.4037015756015582e-07, 5.105922825023609e-07, -4.160063955821918e-07,
     0.00020775677124110814, -0.012830172723710082, -1.90265235215219e-05,
     1.2806473951421875e-05, 1.0610656101790138e-05, -9.442249939379659e-06,
     6.965697218792215e-06, -8.634376838103476e-06, -2.1572755604791356e-06,
     -0.012830172723710087, 0.9216957053486585, -0.001649915308527814,
     0.007518330335557443, 9.353468335102134e-09, -9.773152113403395e-08,
     3.9131370676467154e-08, 5.7963508896231537e-08, -1.6406168804162038e-08,
     -1.9026523521521863e-05, -0.0016499153085278143, 0.0001270061498467986,
     -0.00043114574448228666, -7.603985526905482e-10, 1.8270955997230178e-07,
     -5.106259163696704e-08, 3.094189162733602e-07, -8.894082627346363e-09,
     1.2806473951421812e-05, 0.007518330335557441, -0.0004311457444822867,
     0.0018630792430335348],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]


def point_size_functor(T, rot, te):
    """The Snavely camera observing a point block of `te` columns, in
    array module T with rotation module `rot` (torch and the port's, or
    jax.numpy and the JAX package's): te 4 a homogeneous point
    [X, Y, Z, W] (p = R X + W t), te 2 a point (X, Y) on the plane of its
    depth z, a per-observation datum. T and rot are closed over, not
    attributes: the JAX package batches a functor's numeric attributes."""
    class PointSize:
        def __init__(self, observed_x, observed_y, z=0.0):
            self.observed_x, self.observed_y = observed_x, observed_y
            if te == 2:
                self.z = z

        def __call__(self, camera, point):
            if te == 4:
                p = (rot.angle_axis_rotate_point(camera[:3], point[:3])
                     + camera[3:6] * point[3])
            else:
                p = rot.angle_axis_rotate_point(
                    camera[:3], T.stack([point[0], point[1], self.z])
                ) + camera[3:6]
            xp = -p[0] / p[2]
            yp = -p[1] / p[2]
            r2 = xp * xp + yp * yp
            distortion = 1.0 + r2 * (camera[7] + camera[8] * r2)
            return T.stack([camera[6] * distortion * xp - self.observed_x,
                            camera[6] * distortion * yp - self.observed_y])
    return PointSize


def point_size_problem(mod, T, rot, te, bal, scale=1.0):
    """(problem, camera arrays, point arrays) of `bal` with point blocks of
    te 4 or 2 (point_size_functor), the start scaled by `scale`."""
    import numpy as np
    functor = point_size_functor(T, rot, te)
    cams = [np.asarray(c, dtype=np.float64) * scale for c in bal.cameras]
    pts = [(np.append(p, 1.0) if te == 4 else p[:2].copy()) * scale
           for p in bal.points]
    problem = mod.Problem()
    for k in range(bal.num_observations):
        c, p = int(bal.camera_index[k]), int(bal.point_index[k])
        ox, oy = (float(v) for v in bal.observations[k])
        f = (functor(ox, oy) if te == 4
             else functor(ox, oy, float(bal.points[p][2])))
        problem.add_residual_block(mod.AutoDiffCostFunction(f, 2, [9, te]),
                                   None, cams[c], pts[p])
    return problem, cams, pts


def te_options(mod, solver, **extra):
    """The TE paths' options: bench.py's (the main path's) with the
    solver named."""
    kw = dict(linear_solver_type=getattr(mod.LinearSolverType, solver),
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=50, function_tolerance=1e-6,
              max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def cluster_digest(membership, forest):
    """sha256 (16 hex digits) of a clustering: the int64 membership's bytes
    and the forest's edges."""
    import hashlib
    import numpy as np
    h = hashlib.sha256(np.asarray(membership, dtype=np.int64).tobytes())
    h.update(repr(sorted(forest or [])).encode())
    return h.hexdigest()[:16]


def cluster_f32_check(captured, col_cluster, forest):
    """(ok, text) of CLUSTER_F32_LIMIT's check on a mixed run's first
    cluster_factor call, `captured` = (S, mask, diag_mask, L, fell_back):
    the mask against the pattern built here from each f column's cluster
    and the forest's cluster pairs, the f64 factor of the same S, the f32
    solve's backward error and its distance from the f64 solve."""
    import torch
    from ceres_tpu_torch.solvers.schur import cluster_factor
    S, mask, diag_mask, L32, bad32 = captured
    cc = torch.as_tensor(col_cluster, device=S.device)
    own = cc[:, None] == cc[None, :]
    same_diag = torch.equal(diag_mask, own)
    for a, b in forest or ():
        own |= (((cc[:, None] == a) & (cc[None, :] == b))
                | ((cc[:, None] == b) & (cc[None, :] == a)))
    same_mask = torch.equal(mask, own)
    L64, bad64 = cluster_factor(S.double(), mask, diag_mask)
    gen = torch.Generator(device=S.device).manual_seed(7)
    v = torch.randn(S.shape[0], generator=gen, device=S.device,
                    dtype=torch.float64)
    y32 = torch.cholesky_solve(v.float()[:, None], L32)[:, 0].double()
    y64 = torch.cholesky_solve(v[:, None], L64)[:, 0]
    M = L64 @ L64.T
    backward = float(torch.linalg.vector_norm(M @ y32 - v) / (
        torch.linalg.matrix_norm(M) * torch.linalg.vector_norm(y32)
        + torch.linalg.vector_norm(v)))
    forward = float(torch.linalg.vector_norm(y32 - y64)
                    / torch.linalg.vector_norm(y64))
    ok = (same_mask and same_diag and bool(bad32) == bool(bad64)
          and backward <= CLUSTER_F32_LIMIT)
    return ok, (f"f32 preconditioner on the first damped system: pattern "
                f"{'equal' if same_mask and same_diag else 'DIFFERENT'} to "
                f"the clustering's, fallback factor f32 {bool(bad32)} / "
                f"f64 {bool(bad64)}, backward error {backward:.3e} (limit "
                f"{CLUSTER_F32_LIMIT}), {forward:.3e} from the f64 solve")


def fused_ls_problems(mod, T, make_rosenbrock, build_options, bal_io):
    """The FUSED_LS problems in package `mod` (array module T, the
    tutorial's make_rosenbrock, bundle_adjuster's build_options and the
    package's io.bal): [(label, run)], run(scale=1.0, **extra) -> (summary,
    x as numpy) solving one afresh, its start scaled by `scale`, with the
    options `extra` adds (fused_iterations, device)."""
    import dataclasses
    import numpy as np

    def rosenbrock(scale=1.0, **extra):
        x = np.array([-1.2, 1.0]) * scale
        s = mod.solve_gradient_problem(mod.SolverOptions(
            minimizer_type=mod.MinimizerType.LINE_SEARCH,
            max_num_iterations=200, **extra),
            mod.GradientProblem(make_rosenbrock()), x)
        return s, x

    def extended(scale=1.0, **extra):
        n = EXT_ROSENBROCK_N
        x = extended_rosenbrock_start(n) * scale
        s = mod.solve_gradient_problem(mod.SolverOptions(
            minimizer_type=mod.MinimizerType.LINE_SEARCH,
            max_num_iterations=200, **extra), mod.GradientProblem(
                mod.AutoDiffFirstOrderFunction(extended_rosenbrock(T), n)),
            x)
        return s, x

    def ba(scale=1.0, **extra):
        from ceres_tpu_torch.examples.bundle_adjuster import parse_args
        flags = parse_args(FUSED_LS_BA_ARGS)
        bal = bal_io.synthetic_bal_problem(
            flags.synthetic_cameras, flags.synthetic_points,
            flags.synthetic_observations, seed=flags.random_seed,
            pixel_noise=1.0)
        bal.normalize()
        bal.perturb(rotation_sigma=flags.rotation_sigma,
                    translation_sigma=flags.translation_sigma,
                    point_sigma=flags.point_sigma, seed=flags.random_seed)
        problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
        for a in cams + pts:
            a *= scale
        opts = build_options(mod, flags)
        if not hasattr(opts, "device"):
            extra.pop("device", None)
        opts = dataclasses.replace(opts, minimizer_progress_to_stdout=False,
                                   **extra)
        s = mod.solve(opts, problem)
        return s, np.concatenate([a.ravel() for a in cams + pts])

    return [("FUSED_LS_ROSENBROCK", rosenbrock),
            ("FUSED_LS_EXTENDED_ROSENBROCK", extended),
            ("FUSED_LS_BUNDLE_ADJUSTER", ba)]


def solver_options_paths(counters, by_path, kernels, smi, device="cuda"):
    """Slice 12's phase: FUSED_LS, INNER, CLUSTER, DUMP, COV_SCHUR and TE
    (their comments above), each path with every kernel count set to 0
    just before it and read just after. The TE paths' kernels (K5, K2 at
    te 2, K6 at te 2 and 4, K3, K7) are held to their plain versions at
    that te and added to `kernels`. Raises once every path has printed
    its numbers, if one was off its gate."""
    import contextlib
    import dataclasses
    import io
    import tempfile
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch import rotation as trot
    from ceres_tpu_torch.examples import bundle_adjuster, slam
    from ceres_tpu_torch.examples.tutorial import make_rosenbrock
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers import schur
    from ceres_tpu_torch.solvers.schur import (camera_clustering,
                                               detect_schur_structure)
    from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep
    fails = []

    def zero():
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        return time.time()

    def done(label, t0):
        torch.cuda.synchronize()
        wall = time.time() - t0
        by_path[label] = {n: fn.launches for n, fn in counters.items()}
        return wall, {n: c for n, c in by_path[label].items() if c}

    # ---- FUSED_LS: fused_iterations=True beside the host loop's run ----
    for label, run in fused_ls_problems(ctt, torch, make_rosenbrock,
                                        bundle_adjuster.build_options,
                                        bal_io):
        runs, want = {}, FUSED_LS_REF[label]
        for fused in (True, False):
            t0 = zero()
            s, x = run(fused_iterations=fused, device=device)
            wall, launched = done(label if fused else f"{label}_HOST", t0)
            runs[fused] = (s, x)
            n_it = s.num_iterations_fused if fused else s.num_iterations - 1
            print(f"{label} (fused_iterations={fused}): "
                  f"{n_it} iterations, {s.num_line_search_steps} probes, "
                  f"{s.num_successful_steps} successful, final cost "
                  f"{s.final_cost!r}, {s.termination_type} ({s.message}), "
                  f"wall {wall:.4f} s ({1e3 * wall / max(n_it, 1):.3f} ms "
                  f"an iteration), launches {launched}", flush=True)
            if launched:
                fails.append(f"{label}: kernels launched: {launched}")
        (s, x), (s_h, x_h) = runs[True], runs[False]
        n_it = s.num_iterations_fused
        same = (np.array_equal(x, x_h) and s.final_cost == s_h.final_cost
                and s.iterations == [] and n_it == len(s_h.iterations) - 1
                and (s.num_line_search_steps, s.num_successful_steps)
                == (s_h.num_line_search_steps, s_h.num_successful_steps))
        print(f"  {label}: the fused report is the host run's (x and cost "
              f"bit for bit, counts): {same}; the JAX fused loop {want}",
              flush=True)
        if not same:
            fails.append(f"{label}: the fused run is not the host run")
        if "counts" in want:
            ok = ((n_it, s.num_line_search_steps, s.num_successful_steps,
                   s.message) == want["counts"]
                  and float(np.abs(x - 1.0).max()) <= 1e-6)
        else:
            ok = (n_it == want["iterations"] and abs(
                s.final_cost - want["final_cost"])
                <= want["tol"] * want["final_cost"])
        if not ok:
            fails.append(f"{label}: off the JAX fused loop")

    # ---- INNER: bundle_adjuster --inner_iterations at BAL-16 ----
    want = INNER_REF
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = zero()
        s = bundle_adjuster.run(INNER_ARGS + ["--device", device])[0]
        wall, launched = done("INNER", t0)
    print(f"INNER (bundle_adjuster {' '.join(INNER_ARGS)}): "
          f"{lm_iterations(s)} LM iterations (JAX {want['iterations']}), "
          f"{s.num_inner_iteration_steps} inner-iteration steps (JAX "
          f"{want['inner_steps']}), {s.inner_iteration_time_in_seconds:.3f}"
          f" s in them, final cost {s.final_cost!r} (JAX "
          f"{want['final_cost']!r}), {s.termination_type}, wall {wall:.3f} "
          f"s, launches {launched}", flush=True)
    if launched or not (
            lm_iterations(s) == want["iterations"]
            and s.num_inner_iteration_steps == want["inner_steps"]
            and abs(s.final_cost - want["final_cost"])
            <= BA_F64_REL_TOL * want["final_cost"]):
        fails.append("INNER: off the JAX package's run")

    # ---- CLUSTER at Trafalgar's shape: one problem, each path's flags ----
    flags0 = bundle_adjuster.parse_args(TRAFALGAR_ARGS + ["--device",
                                                          device])
    t0 = time.time()
    _, problem, cams, pts = bundle_adjuster.make_problem(ctt, flags0)
    start = [a.copy() for a in cams + pts]
    print(f"CLUSTER: Trafalgar's problem built in {time.time() - t0:.1f} s",
          flush=True)
    for label, flags in CLUSTER_PATHS.items():
        for a, a0 in zip(cams + pts, start):
            a[:] = a0
        opts = bundle_adjuster.build_options(ctt, bundle_adjuster.parse_args(
            TRAFALGAR_ARGS + CLUSTER_COMMON + flags + ["--device", device]))
        mixed = "--mixed_precision_solves" in flags
        # a mixed solve's first preconditioner factor, for
        # cluster_f32_check
        factor, captured = schur.cluster_factor, []

        def capture(*args):
            out = factor(*args)
            if not captured:
                captured.extend((*args, *out))
            return out
        if mixed:
            schur.cluster_factor = capture
        try:
            with contextlib.redirect_stdout(io.StringIO()):  # its progress
                t0 = zero()
                s = ctt.solve(opts, problem)
                wall, launched = done(label, t0)
        finally:
            schur.cluster_factor = factor
        want = CLUSTER_REF[label]
        rel = abs(s.final_cost - want["final_cost"]) / want["final_cost"]
        line = (f"{label}: {lm_iterations(s)} LM iterations (JAX "
                f"{want['iterations']}), {s.num_linear_solver_iterations} "
                f"PCG iterations (JAX f64 {want['pcg']}), final cost "
                f"{s.final_cost!r} ({rel:.3e} from JAX f64 "
                f"{want['final_cost']!r}, limit {want['tol']}), "
                f"{s.termination_type}, preprocessor "
                f"{s.preprocessor_time_in_seconds:.3f} s, wall {wall:.3f} s,"
                f" launches {launched}")
        ok = (rel <= want["tol"] and lm_iterations(s) == want["iterations"]
              and str(s.termination_type) == want["termination"])
        if mixed:
            ok &= launched.get("K11 bucket_linearize", 0) >= lm_iterations(s)
        else:
            ok &= not launched and (s.num_linear_solver_iterations
                                    == want["pcg"])
        if "SCHUR_JACOBI" not in label:
            program = CompiledProgram.get_cached(problem, opts)
            membership, forest, col_cluster = camera_clustering(
                program, detect_schur_structure(program, opts),
                opts.preconditioner_type, opts.visibility_clustering_type)
            digest = cluster_digest(membership, forest)
            line += (f"; {int(membership.max()) + 1} clusters, "
                     f"{len(forest or [])} forest edges, digest "
                     f"{digest} (JAX {want['digest']})")
            ok &= digest == want["digest"]
            if mixed:
                f32_ok, text = cluster_f32_check(captured, col_cluster,
                                                 forest)
                line += "; " + text
                ok &= f32_ok
        print(line, flush=True)
        if not ok:
            fails.append(f"{label}: off the JAX package's f64 run")
    del problem, cams, pts, start, opts, s
    torch.cuda.empty_cache()

    # ---- DUMP: the SE2 graph's dumps on the card beside the CPU's ----
    poses, edges, _ = g2o.synthetic_pose_graph_2d(num_poses=1000, seed=1)
    dumps, lines = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in (device, "cpu"):
            problem = slam.build_pose_graph_2d_problem(poses, edges)[0]
            # the CPU solve stops after the last dumped iteration: the
            # same solve up to there (a DENSE_QR iteration of this graph
            # takes ~2.5 s of host)
            opts = ctt.SolverOptions(
                device=dev, trust_region_problem_dump_directory=os.path.join(
                    tmp, dev),
                trust_region_minimizer_iterations_to_dump=DUMP_ITERATIONS,
                **({} if dev == device
                   else {"max_num_iterations": max(DUMP_ITERATIONS)}))
            t0 = zero()
            s = ctt.solve(opts, problem)
            wall, launched = done(f"DUMP_TEXTFILE ({dev})", t0)
            files = sorted(os.listdir(os.path.join(tmp, dev)))
            dumps[dev] = {f: dict(np.load(os.path.join(tmp, dev, f)))
                          for f in files}
            problem = slam.build_pose_graph_2d_problem(poses, edges)[0]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                s2 = ctt.solve(dataclasses.replace(
                    opts, trust_region_problem_dump_directory=None,
                    trust_region_minimizer_iterations_to_dump=(),
                    trust_region_problem_dump_format_type=ctt.DumpFormatType
                    .CONSOLE), problem)
            lines[dev] = [ln for ln in out.getvalue().splitlines()
                          if ln.startswith("ceres_tpu iteration")]
            print(f"DUMP ({dev}): {lm_iterations(s)} LM iterations, final "
                  f"cost {s.final_cost!r}, files {files}, wall {wall:.3f} s"
                  f", launches {launched}; CONSOLE: {lm_iterations(s2)} LM "
                  f"iterations, {len(lines[dev])} lines, the first "
                  f"{lines[dev][0] if lines[dev] else None!r}", flush=True)
    errs = {}
    for f, arrays in dumps["cpu"].items():
        card = dumps[device].get(f, {})
        for key, a in arrays.items():
            b = card.get(key)
            errs[f"{f}:{key}"] = (float("inf") if b is None
                                  or b.shape != a.shape else float(
                                      np.abs(b - a).max()
                                      / max(np.abs(a).max(), 1e-300)))
    n_card, n_cpu = ([[float(v.split()[0]) for v in ln.split("=")[1:]]
                      for ln in lines[d]] for d in (device, "cpu"))
    n_err = (max(float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
                 for a, b in zip(n_card, n_cpu))
             if len(n_cpu) == max(DUMP_ITERATIONS) <= len(n_card)
             else float("inf"))
    names = [f"ceres_tpu_iteration_{i:03d}.npz" for i in DUMP_ITERATIONS
             if i > 0]
    print(f"DUMP: the card's arrays from the CPU's, max relative "
          f"{max(errs.values(), default=float('inf')):.3e} (limit "
          f"{DUMP_TOL:.0e}: {({k: f'{v:.2e}' for k, v in errs.items()})}); "
          f"the CONSOLE lines' norms {n_err:.3e}", flush=True)
    if not (sorted(dumps[device]) == sorted(dumps["cpu"]) == names
            and max(errs.values()) <= DUMP_TOL and n_err <= DUMP_TOL):
        fails.append("DUMP: the card's dumps are off the CPU's")

    # ---- COV_SCHUR: covariance blocks on the Schur branch ----
    bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    blocks = {}
    for dev in (device, "cpu"):
        problem, cams, _ = bal_io.build_bal_ceres_problem(bal)
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(cams[1])
        cov = ctt.Covariance(ctt.CovarianceOptions(
            algorithm_type=ctt.CovarianceAlgorithmType.SPARSE_QR,
            device=dev))
        pairs = [(cams[a], cams[b]) for a, b in COV_PAIRS]
        t0 = zero()
        ok = cov.compute(pairs, problem)
        wall, launched = done(f"COV_SCHUR ({dev})", t0)
        blocks[dev] = ([np.asarray(cov.get_covariance_block_in_tangent_space(
            a, b)) for a, b in pairs] if ok else None)
        print(f"COV_SCHUR ({dev}): ok {ok} {cov.message!r}, wall "
              f"{wall:.3f} s, launches {launched}", flush=True)
    if blocks[device] is None or blocks["cpu"] is None:
        fails.append("COV_SCHUR: Compute failed")
    else:
        def block_rel(a, b):
            return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        jax_err = [block_rel(g, np.asarray(w).reshape(g.shape))
                   for g, w in zip(blocks[device], COV_SCHUR_REF)]
        cpu_err = [block_rel(g, w)
                   for g, w in zip(blocks[device], blocks["cpu"])]
        print(f"COV_SCHUR: blocks {list(COV_PAIRS)} from the JAX package's "
              f"{[f'{e:.3e}' for e in jax_err]}, from the port's CPU run "
              f"{[f'{e:.3e}' for e in cpu_err]} (limit {COV_SCHUR_TOL:.0e})",
              flush=True)
        if max(jax_err + cpu_err) > COV_SCHUR_TOL:
            fails.append("COV_SCHUR: off the JAX package's blocks")

    # ---- TE: K5, K2 (te 2) or K6, and K3 or K7 at te != 3 ----
    bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**TE_PERTURB, seed=8)
    te_kernels = {"TE4_DENSE_SCHUR": ("K5 lin_auto", "K6 elim_v1",
                                      "K3 chol_solve"),
                  "TE4_ITERATIVE_SCHUR": ("K5 lin_auto", "K6 elim_v1",
                                          "K7 dense_pcg"),
                  "TE2_DENSE_SCHUR": ("K5 lin_auto", "K2 elim",
                                      "K3 chol_solve"),
                  "TE2_ITERATIVE_SCHUR": ("K5 lin_auto", "K6 elim_v1",
                                          "K7 dense_pcg")}
    built = {}
    for label, (te, solver) in TE_PATHS.items():
        opts = te_options(ctt, solver, device=device)
        if te not in built:
            problem, cams, pts = point_size_problem(ctt, torch, trot, te, bal)
            built[te] = (problem, cams, pts, [a.copy() for a in cams + pts])
            program = CompiledProgram.get_cached(problem, opts)
            meta = detect_schur_structure(program, opts)
            kernels.extend(te_kernel_checks(
                label, te, FusedSchurStep(program, opts, meta), program,
                meta, te_kernels, device))
        problem, cams, pts, start = built[te]
        program = CompiledProgram.get_cached(problem, opts)
        step = FusedSchurStep(program, opts,
                              detect_schur_structure(program, opts))
        want = TE_REF[label]
        for trial in range(2):
            for a, a0 in zip(cams + pts, start):
                a[:] = a0
            t0 = zero()
            s = ctt.solve(opts, problem)
            wall, launched = done(label, t0)
            rel = abs(s.final_cost - want["final_cost"]) / want["final_cost"]
            short = [k for k in te_kernels[label] if not launched.get(k)]
            stray = [k for k in launched if k not in te_kernels[label]
                     and not k.startswith("K3 chol_solve (")]
            print(f"{label} {'warm-up' if trial == 0 else 'timed'}: "
                  f"{lm_iterations(s)} LM iterations (JAX "
                  f"{want['iterations']}), final cost {s.final_cost!r} "
                  f"({rel:.3e} from JAX {want['final_cost']!r}, limit "
                  f"{want['tol']}), {s.termination_type}, wall {wall:.4f} s,"
                  f" launches {launched}; {step.mode}", flush=True)
            if short or stray or not (
                    rel <= want["tol"] and str(s.termination_type)
                    == want["termination"]):
                fails.append(f"{label}: off the JAX run or its kernels "
                             f"(short {short}, stray {stray})")
    del built, problem, program, step
    if fails:
        raise SystemExit(f"SOLVER_OPTIONS_PATHS: {fails}")


def te_kernel_checks(label, te, step, program, meta, te_kernels, device):
    """The TE paths' kernels at point size `te` on the first
    linearization of `step` (the DENSE_SCHUR step of `label`): K5, K2
    (te <= 3) and K6 at RADIUS, K3 on the DENSE_SCHUR reduced system and
    K7 on the ITERATIVE_SCHUR one, each against its plain version by
    check_kernel; their records, each read from the path of its kernel at
    this te."""
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.ops import lin_auto as k5
    from ceres_tpu_torch.ops.kernels import chol_solve, chol_solve_plain
    from ceres_tpu_torch.ops.lin import (elim, elim_plain, elim_v1,
                                         elim_v1_plain)
    from ceres_tpu_torch.ops.pcg import dense_pcg, dense_pcg_plain
    from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep
    ne, nf = step.ne, step.nf
    x0 = program.initial_state()
    xe = x0[step.e_slab:step.e_slab + te * ne].view(ne, te).float()
    xf = x0[step.f_slab:step.f_slab + nf].float()
    se0, sf0 = step.initial_scales()
    args = (step.k5, xf, xe, step.cam, step.mask, step.dat, se0, True, True,
            step.loss)
    # operations: the emitted chain (one a line) and the epilogue's
    # products per observation (E^T E, g_e, A, F^T F, g_f), as the
    # quaternion path's K5 check counts them
    chain_ops = sum(1 for ln in k5.chain_source(step.k5, None).splitlines()
                    if ln.lstrip().startswith("const "))
    epi_ops = 2 * 2 * (te * (te + 1) // 2 + te + te * 9 + 45 + 9)
    added = [check_kernel(
        f"K5 lin_auto (te {te})", lambda: k5.lin_auto(*args, plan=step.plan),
        lambda: k5.lin_auto_plain(*args),
        lambda g, w: [rel_err(g[k], w[k]) for k in w], F32_LIMIT,
        "ceres_tpu_torch/csrc/lin_auto.cuh",
        "ceres_tpu/ops/pallas_lin.py:272", args[1:7],
        (chain_ops + epi_ops) * SHAPE["num_observations"], F32_FLOP_PER_S)]
    art = step.linearize(x0, se0, sf0, True)
    rad = torch.tensor(RADIUS, dtype=torch.float32, device=device)
    inv, z = step.point_inverse(art, rad)

    def cmp_all(got, want):
        return [rel_err(a, b) for a, b in zip(got, want)]
    if te <= 3:
        e_args = (art.A, art.etes, art.gse, art.diag_e, RADIUS)
        added.append(check_kernel(
            f"K2 elim (te {te})", lambda: elim(*e_args),
            lambda: elim_plain(*e_args), cmp_all, F32_LIMIT,
            "ceres_tpu_torch/csrc/elim.cuh",
            "ceres_tpu/ops/pallas_lin.py:424", e_args[:4],
            scorr_flops(ne, nf, te) + INV_Z_FLOPS[te] * ne, F32_FLOP_PER_S,
            reference=scorr_gemm(art.A, inv)))
    added.append(check_kernel(
        f"K6 elim_v1 (te {te})", lambda: elim_v1(art.A, inv, z),
        lambda: elim_v1_plain(art.A, inv, z), cmp_all, F32_LIMIT,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:387",
        (art.A, inv, z), scorr_flops(ne, nf, te), F32_FLOP_PER_S,
        reference=scorr_gemm(art.A, inv)))
    S, rhs, _, _ = step.reduced_system(art, RADIUS)
    added.append(check_kernel(
        f"K3 chol_solve (te {te}, m {nf})", lambda: chol_solve(S, rhs),
        lambda: chol_solve_plain(S, rhs), lambda g, w: [rel_err(g, w)],
        K3_LIMIT, "ceres_tpu_torch/csrc/chol.cu",
        "ceres_tpu/ops/pallas_kernels.py:190", (S, rhs),
        nf ** 3 / 3 + 2 * nf * nf, F32_FLOP_PER_S,
        library=("torch.linalg.solve(S, rhs)",
                 lambda: torch.linalg.solve(S, rhs))))
    it_step = FusedSchurStep(program, te_options(
        ctt, "ITERATIVE_SCHUR", device=device), meta)
    S_i, rhs_i, _, rad_i = it_step.reduced_system(art, RADIUS)
    minv = it_step.precond_inverse(art, S_i, rad_i)
    pcg_kw = it_step.pcg_args

    def cmp_pcg(got, want):
        if int(got[1]) != int(want[1]):
            raise SystemExit(f"K7 (te {te}): CG iteration counts differ: "
                             f"{int(got[1])}, {int(want[1])}")
        return [rel_err(got[0], want[0])]
    added.append(check_kernel(
        f"K7 dense_pcg (te {te}, m {nf})",
        lambda: dense_pcg(S_i, rhs_i, minv, **pcg_kw),
        lambda: dense_pcg_plain(S_i, rhs_i, minv, **pcg_kw), cmp_pcg,
        PCG_LIMIT, "ceres_tpu_torch/csrc/pcg.cu",
        "ceres_tpu/ops/pallas_pcg.py:46", (S_i, rhs_i, minv),
        lambda got: pcg_flops(nf, 9, int(got[1]), 10), F32_FLOP_PER_S,
        reference=("torch.linalg.solve(S, rhs) (an exact solve: another "
                   "function, timed as a yardstick)",
                   lambda: torch.linalg.solve(S_i, rhs_i))))
    for rec in added:
        rec["counter"] = rec["name"].split(" (")[0]
        MAIN_PATH[rec["name"]] = next(
            p for p, ks in te_kernels.items()
            if rec["counter"] in ks and p.startswith(f"TE{te}_"))
    return added


# slice 13 (`slice13_paths`): solve_batched in both modes, the C API, the
# NIST / PGM / libmv readers and the last example families, each path
# driven with every kernel count set to 0 just before it and read just
# after. Every input is written by this script from a seed in the
# published formats (no NIST, FoE, PGM or libmv file ships with the
# repo). References: scripts/slice13_reference.py (the JAX package on the
# CPU).
#
# PIPELINE: four BAL-16-22106 problems (the main path's graph,
# perturbed by PERTURB with the seeds PIPELINE_SEEDS), solved by
# solve_batched(batch_mode="pipeline") with bench.py's options, each
# beside ctt.solve of the same problem: counts, final cost and the
# state's sha256 bit for bit; the final costs within REF_REL_TOL of the
# JAX package's f64 DENSE_SCHUR solves (PIPELINE_REF); K1-K4 at least
# once an LM iteration of every element. The four ctt.solve calls run
# twice: the first builds each program's step (pipeline mode binds the
# template's), the second reuses it.
PIPELINE_SEEDS = (1, 2, 3, 4)
# BATCH_RANSAC: examples/ransac_homography on RANSAC_N correspondences
# with RANSAC_OUTLIERS gross outliers (synthetic_correspondences, seed 4)
# and RANSAC_HYPOTHESES hypotheses (hypotheses(), seed 0) in batch mode:
# H within 1e-2 of the truth, no outlier admitted, 80% of the inliers
# found (tests/test_examples.py's ransac gates); every element
# converges to a final cost at EXAMPLE_COST_FLOOR, as JAX's do. The
# minimal samples' fits are exact to rounding, so their counts are the
# rounding's (JAX's own runs from hypotheses scaled by 1 -+ 1e-12 move
# them by up to 7; RANSAC_REF): they are printed beside JAX's, not gated.
# The same 1,024 refinements from starts moved by RANSAC_PROFILE_MOVE
# (`ransac_moved_starts`), where LM runs for real: each element's count
# the JAX batched run's (RANSAC_MOVED_REF, the counts' digest; JAX's runs
# from those starts scaled by 1 -+ 1e-12 keep every count), the final
# costs above RANSAC_MOVED_SMALL (the elements that end on the iteration
# cap) within BATCH_BA_TOL of JAX's and every other below it (they stop
# on function tolerance on the way to an exact fit, where the last step's
# rounding sets the cost: 2.4e-14 apart on the CPU). The launch check:
# torch.profiler's CUDA kernels of those refinements run for 1 and 3 LM
# iterations at each of RANSAC_PROFILE_BATCHES elements; an iteration's
# kernels (the difference, halved) and the whole 1-iteration solve's
# must be the same at both sizes. The example runs once on 64 hypotheses first (the first
# use of each kernel loads it).
RANSAC_N, RANSAC_OUTLIERS, RANSAC_HYPOTHESES = 2000, 600, 1024
RANSAC_PROFILE_BATCHES = (64, 1024)
RANSAC_PROFILE_MOVE = 1e-3
RANSAC_MOVED_SMALL = 1e-3


def ransac_moved_starts(hs):
    """The hypotheses moved by RANSAC_PROFILE_MOVE (relative, seeded)."""
    import numpy as np
    move = np.random.default_rng(9).standard_normal((len(hs), 9))
    return [h * (1.0 + RANSAC_PROFILE_MOVE * m) for h, m in zip(hs, move)]


def counts_digest(counts):
    import hashlib
    import numpy as np
    return hashlib.sha256(np.asarray(counts, np.int64).tobytes()
                          ).hexdigest()[:16]
# BATCH_BA: BATCH_BA_ELEMENTS multi-start elements of tests/test_batch.py's
# graph (BATCH_BA_SHAPE, seed 11, pixel noise 0.5), each perturbed by
# BATCH_BA_PERTURB with its own seed (1, 2, ...), f64 DENSE_SCHUR in batch
# mode: each element's LM count the JAX batched run's and its final cost
# within BATCH_BA_TOL (BATCH_BA_REF).
BATCH_BA_ELEMENTS = 64
BATCH_BA_SHAPE = dict(num_cameras=4, num_points=150, num_observations=600)
BATCH_BA_PERTURB = dict(rotation_sigma=0.05, translation_sigma=0.3,
                        point_sigma=0.2)
BATCH_BA_TOL = 1e-9
# C_API: the shim built by ceres_tpu_torch.capi.build(),
# examples/curve_fitting_c/curve_fitting.c compiled with gcc against it
# and run on the card: its OK line, and m and c within C_API_TOL of the
# JAX C API's Python-level run on the same data (C_API_REF).
C_API_TOL = 1e-10
# DENOISING: a DENOISE_SIZE^2 image (a smooth pattern with seeded noise,
# written by io/pgm.py write_pgm and read back) and DENOISE_FILTERS
# seeded DENOISE_FOE_SIZE^2 filters written in the .foe format; the
# example's f64 CGNR + JACOBI (tests/test_denoising.py's options) within
# DENOISE_TOL, or twice the spread of the JAX runs from scaled starts, of
# the JAX package's final cost (DENOISE_REF), its total variation below
# the input's; then mixed and fused (K8 on every CG application, K9 on
# every linearization, K11's launches counted), its final cost within
# DENOISE_MIXED_TOL, or that spread, of the f64 run's.
DENOISE_SIZE, DENOISE_FILTERS, DENOISE_FOE_SIZE = 128, 8, 3
DENOISE_TOL, DENOISE_MIXED_TOL = 1e-9, 1e-5
# LIBMV: a problem at problem_01.bin's published shape (LIBMV_SHAPE),
# written by io/libmv.py write_libmv_test_problem and read by the port's
# reader, solved with solve_libmv's defaults and with LIBMV_REFINE (focal
# length, principal point, k1 and k2): final costs within LIBMV_TOL, or
# twice the cost spread of the JAX runs from starts scaled by 1 -+ 1e-10,
# of the JAX package's; an LM count may move by twice their count spread
# (LIBMV_REF).
LIBMV_SHAPE = dict(num_cameras=333, num_tracks=26, num_markers=5421)
LIBMV_TOL = 1e-9
# NIST: three files in the StRD format, an exponential (Misra1a's model),
# a rational (Thurber's) and a sum of exponentials (Lanczos1's: as
# NIST's Lanczos1, data with no noise), data from NIST_SPECS' parameters
# with seeded noise, the certified values from a tight JAX f64 solve
# (NIST_CERTIFIED); examples/nist_runner.py run_suite must reach the JAX
# run's LRE within NIST_LRE_TOL at both starts and its final cost within
# NIST_COST_TOL (EXAMPLE_COST_FLOOR at Lanczos1's exact fit) (NIST_REF).
# Counts are not gated: these runs go on to tolerances of 1e-18, so
# their last steps follow the rounding (ROADMAP.md section 3). The noise
# is small enough that every LRE is the rounding's cap of 11 from starts
# scaled by 1 -+ 1e-10 in both packages on the CPU: with NIST-like noise
# (Thurber's sigma 10, Lanczos3's 1e-5) the LREs of both packages spread
# over 7.5-11 with the rounding of the last steps.
NIST_LRE_TOL, NIST_COST_TOL = 0.1, 1e-9
# name: (the parameters the data is made from, start 1, start 2, the
# predictor's values as numpy.linspace's (start, stop, num), the noise's
# sigma, its seed)
NIST_SPECS = {
    "Misra1a": ((238.94212918, 5.5015643181e-4), (500.0, 1e-4),
                (250.0, 5e-4), (77.6, 790.0, 14), 0.1, 1),
    "Thurber": ((1288.1396800, 1491.0792535, 583.23836877, 75.416644291,
                 0.96629502864, 0.39797285797, 0.049727297349),
                (1000.0, 1000.0, 400.0, 40.0, 0.7, 0.3, 0.03),
                (1300.0, 1500.0, 500.0, 75.0, 1.0, 0.4, 0.05),
                (-3.067, 2.2, 37), 0.01, 2),
    "Lanczos1": ((0.086816414977, 0.95498101505, 0.84400777463,
                  2.9515951832, 1.5825685901, 4.9863565084),
                 (1.2, 0.3, 5.6, 5.5, 6.5, 7.6),
                 (0.5, 0.7, 3.6, 4.2, 4.0, 6.3),
                 (0.0, 1.15, 24), 0.0, 3),
}


def nist_data(name):
    """(x [n], y [n]) of NIST_SPECS[name]: the model (io/nist.py's
    NIST_MODELS formula, in numpy) at its parameters plus seeded noise."""
    import numpy as np
    b, _, _, xs, sigma, seed = NIST_SPECS[name]
    b, x = np.asarray(b), np.linspace(*xs)
    if name == "Misra1a":
        y = b[0] * (1.0 - np.exp(-b[1] * x))
    elif name == "Thurber":
        y = ((b[0] + b[1] * x + b[2] * x ** 2 + b[3] * x ** 3)
             / (1.0 + b[4] * x + b[5] * x ** 2 + b[6] * x ** 3))
    else:
        y = (b[0] * np.exp(-b[1] * x) + b[2] * np.exp(-b[3] * x)
             + b[4] * np.exp(-b[5] * x))
    return x, y + sigma * np.random.default_rng(seed).standard_normal(
        x.size)


def write_nist_files(directory, certified):
    """Write NIST_SPECS' files into `directory` with the given certified
    {name: (parameters, residual sum of squares)}."""
    from ceres_tpu_torch.io.nist import write_nist_test_file
    for name, (_, s1, s2, _, _, _) in NIST_SPECS.items():
        x, y = nist_data(name)
        b, rss = certified[name]
        write_nist_test_file(os.path.join(directory, name + ".dat"), name,
                             x, y, (s1, s2), b, rss)


def denoise_inputs(directory, size=DENOISE_SIZE, filters=DENOISE_FILTERS,
                   foe_size=DENOISE_FOE_SIZE, seed=5):
    """Write the DENOISING image (a smooth pattern with seeded noise,
    sigma 20 grey levels, as PGM) and its FoE filters (zero-mean, seeded,
    alphas in [0.5, 2]) into `directory`; returns (pgm path, foe path)."""
    import numpy as np
    from ceres_tpu_torch.examples.denoising import write_foe
    from ceres_tpu_torch.io.pgm import write_pgm
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    clean = 128 + 60 * np.sin(6 * xx) * np.cos(4 * yy) + 40 * (xx - yy)
    img = np.clip(clean + 20.0 * rng.standard_normal(clean.shape), 0, 255)
    pgm = os.path.join(directory, f"noisy_{size}.pgm")
    write_pgm(pgm, img)
    fs = rng.standard_normal((filters, foe_size * foe_size))
    fs -= fs.mean(axis=1, keepdims=True)
    fs /= np.linalg.norm(fs, axis=1, keepdims=True)
    foe = os.path.join(directory, f"{foe_size}x{foe_size}.foe")
    write_foe(foe, foe_size, rng.uniform(0.5, 2.0, filters), fs)
    return pgm, foe


def denoise_options(mod, **extra):
    """tests/test_denoising.py's options (f64 CGNR + JACOBI)."""
    kw = dict(linear_solver_type=mod.LinearSolverType.CGNR,
              preconditioner_type=mod.PreconditionerType.JACOBI,
              max_num_iterations=20, max_linear_solver_iterations=50)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def c_api_data():
    """curve_fitting.c's samples: y = exp(0.3 x + 0.1) plus its LCG
    noise in [-0.05, 0.05], 30 samples over [0, 5] ([30, 2] f64)."""
    import numpy as np
    data, state = [], 12345
    for i in range(30):
        x = 5.0 * i / 29
        state = (state * 1664525 + 1013904223) % 2 ** 32
        noise = ((state >> 8) % 1000) / 10000.0 - 0.05
        data.append((x, np.exp(0.3 * x + 0.1) + noise))
    return np.ascontiguousarray(np.asarray(data, np.float64))


def batch_ba_problems(mod, bal_io, n=BATCH_BA_ELEMENTS):
    """BATCH_BA's elements in package `mod`: [(problem, arrays)]."""
    out = []
    for seed in range(1, n + 1):
        bal = bal_io.synthetic_bal_problem(**BATCH_BA_SHAPE, seed=11,
                                           pixel_noise=0.5)
        bal.perturb(**BATCH_BA_PERTURB, seed=seed)
        problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
        out.append((problem, cams + pts))
    return out


def batch_ba_options(mod, **extra):
    kw = dict(linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
              max_num_iterations=40, function_tolerance=1e-9,
              fused_iterations=True, batch_mode="batch")
    kw.update(extra)
    return mod.SolverOptions(**kw)


# the JAX package on the CPU (scripts/slice13_reference.py --spread):
# PIPELINE's f64 DENSE_SCHUR final costs by perturbation seed
PIPELINE_REF = {1: 50287.72692110798, 2: 50287.7269116191,
                3: 50287.72692054427, 4: 50287.726910469704}
# every element starts at its minimal sample's exact fit (initial costs
# 2.4e-23 at most), so its count is the rounding's: JAX's own runs from
# hypotheses scaled by 1 -+ 1e-12 move 1-3 counts by up to `spread`. Each
# element's count within `spread` of JAX's (`common` but for `others`),
# and every final cost at most EXAMPLE_COST_FLOOR where JAX's are.
RANSAC_REF = dict(common=1, others={190: 4, 434: 5}, spread=7,
                  max_final_cost=1.385259220816131e-24)
RANSAC_MOVED_REF = dict(
    digest='5e0edce973b53a69', small_max=3.803481210264238e-06,
    large={
        190: 0.19550951783881923,
        192: 0.08080239775112397,
        228: 0.1639216176642947,
        328: 0.16663279631414601,
        489: 0.9873760855660445,
        568: 0.5880507178202647,
        573: 0.3427082135592802,
        680: 0.038446163822308914,
        712: 0.22059272004461758,
        746: 1.1464187614892203,
        754: 0.23163920524669676,
        953: 0.20143711802218972})
BATCH_BA_REF = dict(
    iterations=[5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5,
                5, 6, 6, 9, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
                5, 5, 5, 5, 5, 5, 5, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 6, 5, 5,
                5, 5, 5, 5],
    costs=[
        91.84328743111479, 91.84328743112361, 91.84328743110552,
        91.8432874311001, 91.84328743109975, 91.84328743110032,
        91.84328743110089, 91.84328743111048, 91.84328743112589,
        91.84328743110899, 91.84328743110035, 91.84328743110163,
        91.84328743121509, 91.84328743110457, 91.84328743110045,
        91.84328743112414, 91.84328743111749, 91.84328743110672,
        91.8432874311061, 91.84328743110245, 91.84328743110066,
        91.84328743109985, 91.84328743110102, 91.84328743110014,
        91.84328743111962, 91.8432874311446, 91.84328743111358,
        91.84328743110224, 91.84328743117001, 91.84328743110333,
        91.84328743110638, 91.84328743110075, 91.84328743110532,
        91.84328743109987, 91.84328743110028, 91.84328743111128,
        91.84328743110014, 91.84328743110379, 91.84328743111226,
        91.84328743111227, 91.84328743111966, 91.84328743110471,
        91.8432874311, 91.84328743110336, 91.84328743110004,
        91.84328743110838, 91.84328743110116, 91.84328743110514,
        91.84328743109988, 91.84328743109982, 91.8432874311105,
        91.8432874311006, 91.84328743115647, 91.84328743110007,
        91.8432874311098, 91.8432874311009, 91.84328743110075,
        91.84328743110086, 91.84328743110335, 91.84328743109992,
        91.84328743110055, 91.8432874311033, 91.84328743110143,
        91.84328743111764,
    ])
C_API_REF = dict(m=0.2981654070033879, c=0.10890962412699288)
# the f64 run stops at its 20-iteration cap mid-descent, where CG's
# truncation decides the steps: JAX runs from starts scaled by 1 -+ 1e-10
# end `cost_spread` apart, so the gate is twice that (as FUSED_LARGE_M
# gates its capped runs)
DENOISE_REF = dict(final_cost=25283.62327777336,
                   cost_spread=4.7767482691671896e-05)
# iterations, final cost, and the spread of the JAX runs from starts
# scaled by 1 -+ 1e-10 in LM count and relative cost (the gates take
# twice a spread where it is wider than LIBMV_TOL, as MGH_REF gates the
# MGH runs)
LIBMV_REF = {
    "LIBMV": dict(iterations=5, final_cost=1089.3717397682724, spread=0,
                  cost_spread=3.756960097797992e-15),
    "LIBMV_REFINE": dict(iterations=15, final_cost=1088.9896302720283,
                         spread=0, cost_spread=5.407744968617057e-14)}
NIST_CERTIFIED = {
    'Misra1a': ([237.45158813885968, 0.0005543340065017676],
        0.048727660801120176),
    'Thurber': (
        [1288.1402424526996, 1491.0554969930429, 583.2223565410173,
         75.41357589311008, 0.9662792529727016, 0.3979664596906446,
         0.049721674463778204],
        0.0030079811961561884),
    'Lanczos1': (
        [0.08681641497699982, 0.9549810150500014, 0.8440077746300002,
         2.951595183199997, 1.5825685901, 4.986356508400002],
        6.548161810916602e-32),
}
# name: ((LRE at start 1, start 2), (final cost at start 1, start 2))
NIST_REF = {
    'Lanczos1': ((11.0, 11.0),
        (2.1690785998661244e-32, 4.085378894531424e-32)),
    'Misra1a': ((11.0, 11.0),
        (0.024363830400560314, 0.024363830400562225)),
    'Thurber': ((11.0, 11.0),
        (0.0015039905980583626, 0.00150399059807575)),
}


def slice13_paths(counters, by_path, device="cuda"):
    """Slice 13's phase: PIPELINE, BATCH_RANSAC (with the launch check),
    BATCH_BA, C_API, DENOISING, LIBMV and NIST (their comments above),
    each with every kernel count set to 0 just before it and read just
    after. Prints each part's wall; raises once every part has printed
    its numbers, if one was off its gate."""
    import hashlib
    import shutil
    import site
    import tempfile
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch import capi
    from ceres_tpu_torch.examples import denoising, nist_runner
    from ceres_tpu_torch.examples import libmv_bundle_adjuster as lba
    from ceres_tpu_torch.examples import ransac_homography as rh
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io.libmv import (BUNDLE_FOCAL_LENGTH,
                                          BUNDLE_PRINCIPAL_POINT,
                                          BUNDLE_RADIAL, read_libmv_problem,
                                          write_libmv_test_problem)
    from ceres_tpu_torch.io.pgm import read_pgm
    fails, walls = [], {}
    tmp = tempfile.mkdtemp(prefix="slice13_")
    t_phase = time.time()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def zero():
        for fn in counters.values():
            fn.launches = 0
        sync()
        return time.time()

    def read(label, t0):
        sync()
        walls[label] = time.time() - t0
        by_path[label] = {n: fn.launches for n, fn in counters.items()}
        return walls[label], {n: c for n, c in by_path[label].items() if c}

    def check(ok, msg):
        print(("  ok: " if ok else "  FAIL: ") + msg, flush=True)
        if not ok:
            fails.append(msg)

    def close(a, b, tol, floor=0.0):
        return abs(a - b) <= tol * abs(b) + floor

    def state_sha(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    # ---- PIPELINE ----
    elems = pipeline_problems(bal_io)
    starts = [[a.copy() for a in arrs] for _, arrs in elems]

    def reset(i):
        for a, a0 in zip(elems[i][1], starts[i]):
            a[:] = a0

    opts = huber_options(ctt, device=device, batch_mode="pipeline")
    for i in range(len(elems)):
        reset(i)
    ctt.solve_batched(opts, [p for p, _ in elems])        # warm-up
    for i in range(len(elems)):
        reset(i)
    t0 = zero()
    sums = ctt.solve_batched(opts, [p for p, _ in elems])
    wall, launched = read("PIPELINE", t0)
    piped = [state_sha(arrs) for _, arrs in elems]
    print(f"PIPELINE (solve_batched, pipeline mode, {len(elems)} BAL-16 "
          f"elements, bench.py's options): wall {wall:.4f} s, launches "
          f"{launched}", flush=True)
    for rnd in ("first", "second"):
        # the first ctt.solve of a program builds its step (the Schur
        # structure, the chunk layout, the camera plan), which pipeline
        # mode binds from the template's; the second reuses it
        singles, single_walls = [], []
        for i, (problem, arrs) in enumerate(elems):
            reset(i)
            t1 = zero()
            s = ctt.solve(opts, problem)
            w, _ = read(f"PIPELINE_SINGLE_{i}", t1)
            single_walls.append(w)
            singles.append((s, state_sha(arrs)))
        print(f"PIPELINE: the four ctt.solve calls, {rnd} round: "
              f"{sum(single_walls):.4f} s "
              f"({', '.join(f'{w:.4f}' for w in single_walls)})",
              flush=True)
    lm_total = 0
    for i, (sb, seed) in enumerate(zip(sums, PIPELINE_SEEDS)):
        s, sha = singles[i]
        lm_total += sb.num_iterations
        print(f"PIPELINE element {i} (perturbation seed {seed}): "
              f"{sb.num_iterations} LM ({sb.num_successful_steps} "
              f"accepted), final cost {sb.final_cost!r}, state {piped[i]}; "
              f"ctt.solve {s.num_iterations} LM, {s.final_cost!r}, "
              f"{sha}; JAX {PIPELINE_REF.get(seed)!r}", flush=True)
        check(sb.termination_type == ctt.TerminationType.CONVERGENCE
              and (sb.num_iterations, sb.num_successful_steps,
                   sb.num_linear_solver_iterations, sb.final_cost,
                   piped[i]) == (s.num_iterations, s.num_successful_steps,
                                 s.num_linear_solver_iterations,
                                 s.final_cost, sha),
              f"PIPELINE element {i} bit for bit ctt.solve's")
        check(seed in PIPELINE_REF and close(sb.final_cost,
                                             PIPELINE_REF[seed],
                                             REF_REL_TOL),
              f"PIPELINE element {i} within {REF_REL_TOL} of JAX")
    for k in ("K1 lin", "K2 elim", "K3 chol_solve", "K4 cost"):
        check(by_path["PIPELINE"][k] >= lm_total,
              f"PIPELINE {k}: {by_path['PIPELINE'][k]} launches for "
              f"{lm_total} LM iterations")
    del elems, starts

    # ---- BATCH_RANSAC ----
    x1, x2, H_true, out = rh.synthetic_correspondences(RANSAC_N,
                                                       RANSAC_OUTLIERS)
    rh.ransac_homography(x1, x2, num_hypotheses=64, device=device,
                         batch_mode="batch")                     # warm-up
    t0 = zero()
    H, mask, (rsums, polish) = rh.ransac_homography(
        x1, x2, num_hypotheses=RANSAC_HYPOTHESES, device=device,
        batch_mode="batch")
    wall, launched = read("BATCH_RANSAC", t0)
    H = H / H[2, 2]
    err = float(np.linalg.norm(H - H_true / H_true[2, 2]))
    true_in = np.ones(RANSAC_N, bool)
    true_in[out] = False
    counts = np.array([s.num_iterations for s in rsums])
    costs = np.array([s.final_cost for s in rsums])
    ref = RANSAC_REF
    want = np.full(len(counts), ref["common"])
    for i, c in ref["others"].items():
        want[i] = c
    print(f"BATCH_RANSAC ({RANSAC_HYPOTHESES} hypotheses, batch mode, "
          f"{RANSAC_N} correspondences, {RANSAC_OUTLIERS} outliers): wall "
          f"{wall:.4f} s (the refinement "
          f"{rsums[0].minimizer_time_in_seconds:.4f} s), ||H - H_true|| "
          f"{err:.3e}, inliers {int(mask.sum())} of {int(true_in.sum())}, "
          f"outliers admitted {int((mask & ~true_in).sum())}, counts "
          f"{dict(zip(*np.unique(counts, return_counts=True)))} (JAX "
          f"{dict(zip(*np.unique(want, return_counts=True)))}; "
          f"{int((counts != want).sum())} differ, by "
          f"{int(np.abs(counts - want).max())} at most), largest cost "
          f"{costs.max():.3e} (JAX {ref['max_final_cost']:.3e}), launches "
          f"{launched}", flush=True)
    check(err < 1e-2 and not (mask & ~true_in).any()
          and mask.sum() >= 0.8 * true_in.sum(),
          "BATCH_RANSAC recovers H")
    check(all(s.termination_type == ctt.TerminationType.CONVERGENCE
              for s in rsums) and costs.max() <= EXAMPLE_COST_FLOOR,
          "BATCH_RANSAC converges to the rounding floor, as JAX's runs")
    check(not any(launched.values()), "BATCH_RANSAC launches no kernel")

    # the refinements from moved starts, against JAX's counts
    samples, hs = rh.hypotheses(x1, x2, RANSAC_HYPOTHESES, 0)
    probs = [rh.build_refine_problem(x1[idx], x2[idx], h)
             for idx, h in zip(samples, hs)]
    h0 = ransac_moved_starts(hs)
    for h, hh in zip(hs, h0):
        h[:] = hh
    t0 = zero()
    msums = ctt.solve_batched(ctt.SolverOptions(
        max_num_iterations=20, function_tolerance=1e-10, device=device,
        batch_mode="batch"), probs)
    wall, launched = read("BATCH_RANSAC_MOVED", t0)
    mc = [s.num_iterations for s in msums]
    mf = np.array([s.final_cost for s in msums])
    large = RANSAC_MOVED_REF["large"]
    others = np.ones(len(mf), bool)
    others[list(large)] = False
    print(f"BATCH_RANSAC_MOVED (the refinements from starts moved by "
          f"{RANSAC_PROFILE_MOVE}): wall {wall:.4f} s (the refinement "
          f"{msums[0].minimizer_time_in_seconds:.4f} s), counts "
          f"{dict(zip(*np.unique(mc, return_counts=True)))} digest "
          f"{counts_digest(mc)} (JAX {RANSAC_MOVED_REF['digest']}), the "
          f"{len(large)} costs past {RANSAC_MOVED_SMALL} "
          f"{max(abs(mf[i] - c) / c for i, c in large.items()):.3e} from "
          f"JAX's at most, the others below {mf[others].max():.3e} (JAX "
          f"{RANSAC_MOVED_REF['small_max']:.3e})", flush=True)
    check(counts_digest(mc) == RANSAC_MOVED_REF["digest"],
          "BATCH_RANSAC_MOVED counts the JAX batched run's")
    check(all(close(mf[i], c, BATCH_BA_TOL) for i, c in large.items())
          and mf[others].max() <= RANSAC_MOVED_SMALL,
          "BATCH_RANSAC_MOVED costs against JAX's")

    # the launch check: CUDA kernels of 1 and 3 LM iterations (on the card
    # only: the profiler sees no CUDA kernel elsewhere)
    batches = RANSAC_PROFILE_BATCHES if torch.device(device).type == \
        "cuda" else ()
    kernels_of = {}
    for B in batches:
        for iters in (1, 3):
            o = ctt.SolverOptions(max_num_iterations=iters, device=device,
                                  batch_mode="batch",
                                  gradient_tolerance=1e-300,
                                  function_tolerance=1e-300,
                                  parameter_tolerance=1e-300)
            for h, hh in zip(hs[:B], h0[:B]):
                h[:] = hh
            ctt.solve_batched(o, probs[:B])                     # warm-up
            for h, hh in zip(hs[:B], h0[:B]):
                h[:] = hh
            sync()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                ss = ctt.solve_batched(o, probs[:B])
                sync()
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))]
            kernels_of[(B, iters)] = len(kern)
            check(all(s.num_iterations == iters for s in ss),
                  f"launch check B={B}: every element ran {iters} "
                  f"iterations")
    per_it = {B: (kernels_of[(B, 3)] - kernels_of[(B, 1)]) / 2
              for B in batches}
    print(f"BATCH_RANSAC launch check (torch.profiler, CUDA kernels): "
          + ", ".join(f"{B} elements: {kernels_of[(B, 1)]} for a "
                      f"1-iteration solve, {per_it[B]} an LM iteration"
                      for B in batches), flush=True)
    check(not batches or (len(set(per_it.values())) == 1
                          and len({kernels_of[(B, 1)] for B in batches})
                          == 1 and per_it[batches[0]] > 0),
          "BATCH_RANSAC kernels an iteration independent of the batch")
    del probs

    # ---- BATCH_BA ----
    elems = batch_ba_problems(ctt, bal_io)
    opts = batch_ba_options(ctt, device=device)
    t0 = zero()
    bsums = ctt.solve_batched(opts, [p for p, _ in elems])
    wall, launched = read("BATCH_BA", t0)
    counts = [s.num_iterations for s in bsums]
    costs = np.array([s.final_cost for s in bsums])
    ref = BATCH_BA_REF
    print(f"BATCH_BA ({len(elems)} elements, f64 DENSE_SCHUR, batch "
          f"mode): wall {wall:.4f} s, counts "
          f"{dict(zip(*np.unique(counts, return_counts=True)))}, costs "
          f"{costs.min():.10e} .. {costs.max():.10e}, largest distance "
          f"to JAX "
          f"{np.max(np.abs(costs - ref.get('costs', costs)) / costs):.3e}"
          f", launches {launched}", flush=True)
    check(all(s.termination_type == ctt.TerminationType.CONVERGENCE
              for s in bsums) and counts == ref.get("iterations"),
          "BATCH_BA counts the JAX batched run's")
    check(bool(np.all(np.abs(costs - np.asarray(ref.get("costs", 0)))
                      <= BATCH_BA_TOL * costs)),
          f"BATCH_BA costs within {BATCH_BA_TOL} of JAX")
    del elems

    # ---- C_API ----
    t0 = zero()
    lib = capi.build()
    exe = os.path.join(tmp, "curve_fitting_c")
    src = os.path.join(os.path.dirname(ctt.__file__), "examples",
                       "curve_fitting_c", "curve_fitting.c")
    subprocess.run(["gcc", "-O2", src, "-I" + str(capi.HEADER.parent),
                    "-L" + str(lib.parent), "-lceres_tpu_torch_c",
                    "-Wl,-rpath," + str(lib.parent), "-o", exe, "-lm"],
                   check=True, capture_output=True)
    build_wall = time.time() - t0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(ctt.__file__))]
        + site.getsitepackages()))
    env.pop("CERES_TPU_TORCH_DEVICE", None)       # the card, by default
    if torch.device(device).type != "cuda":
        env["CERES_TPU_TORCH_DEVICE"] = device
    t1 = time.time()
    run = subprocess.run([exe], env=env, capture_output=True, text=True,
                         timeout=600)
    wall, launched = read("C_API", t0)
    got = {}
    for line in run.stdout.splitlines():
        if line.startswith("Final m:"):
            m_s, c_s = line[len("Final m:"):].split(", c:")
            got = dict(m=float(m_s), c=float(c_s))
    print(f"C_API (curve_fitting.c through the shim, on the card): shim and "
          f"gcc {build_wall:.1f} s, run {time.time() - t1:.1f} s; "
          f"{run.stdout.strip()!r}; JAX {C_API_REF}", flush=True)
    if run.returncode != 0:
        print(run.stderr[-3000:], flush=True)
    check(run.returncode == 0 and "CURVE_FITTING_C_OK" in run.stdout
          and bool(got) and all(abs(got[k] - C_API_REF.get(k, np.inf))
                                <= C_API_TOL for k in ("m", "c")),
          f"C_API m and c within {C_API_TOL} of JAX")

    # ---- DENOISING ----
    t0 = time.time()
    pgm, foe_path = denoise_inputs(tmp)
    img = read_pgm(pgm)
    foe = denoising.FieldsOfExperts(foe_path)
    built = {}
    for label in ("f64", "mixed"):
        built[label] = denoising.build_denoising_problem(img, foe)
    print(f"DENOISING: inputs and two {DENOISE_SIZE}^2 problems built in "
          f"{time.time() - t0:.1f} s", flush=True)
    results = {}
    for label, extra in (("f64", {}),
                         ("mixed", dict(use_mixed_precision_solves=True,
                                        fused_iterations=True))):
        problem, pixels = built[label]
        t0 = zero()
        s = ctt.solve(denoise_options(ctt, device=device, **extra), problem)
        path = "DENOISING" if label == "f64" else "DENOISING_MIXED"
        wall, launched = read(path, t0)
        out_img = denoising.pixels_to_image(pixels)
        results[label] = s
        print(f"{path} ({label}): {s.num_iterations} LM, "
              f"{s.num_linear_solver_iterations} CG, final cost "
              f"{s.final_cost!r} (JAX {DENOISE_REF.get('final_cost')!r}), "
              f"total variation {denoising.total_variation(img):.6g} -> "
              f"{denoising.total_variation(out_img):.6g}, wall {wall:.4f} "
              f"s, launches {launched}", flush=True)
        check(s.is_solution_usable() and denoising.total_variation(out_img)
              < denoising.total_variation(img), f"{path} smooths")
        spread = 2.0 * DENOISE_REF["cost_spread"]
        if label == "f64":
            tol = max(DENOISE_TOL, spread)
            check(close(s.final_cost, DENOISE_REF["final_cost"], tol),
                  f"{path} within {tol:.3e} of JAX")
            check(not any(launched.values()), f"{path} launches no kernel")
        else:
            tol = max(DENOISE_MIXED_TOL, spread)
            check(close(s.final_cost, results["f64"].final_cost, tol),
                  f"{path} within {tol:.3e} of the f64 run")
            check(launched.get("K8 bucket_jtjv", 0)
                  >= s.num_linear_solver_iterations
                  and launched.get("K9 group_gram_blocks", 0)
                  >= s.num_successful_steps + 1,
                  f"{path} K8 every CG application, K9 every "
                  f"linearization")
    del built

    # ---- LIBMV ----
    t0 = time.time()
    lp = lba.synthetic_libmv_problem(**LIBMV_SHAPE)
    path = os.path.join(tmp, "problem_shape_01.bin")
    write_libmv_test_problem(path, lp)
    back = read_libmv_problem(path)
    print(f"LIBMV: {len(back.cameras)} cameras, {len(back.points)} tracks, "
          f"{len(back.markers)} markers written and read in "
          f"{time.time() - t0:.1f} s", flush=True)
    check((len(back.cameras), len(back.points), len(back.markers))
          == tuple(LIBMV_SHAPE.values()), "LIBMV shape")
    for flags, label in ((0, "LIBMV"), (BUNDLE_FOCAL_LENGTH
                                         | BUNDLE_PRINCIPAL_POINT
                                         | BUNDLE_RADIAL, "LIBMV_REFINE")):
        t0 = zero()
        s, intr, _, _ = lba.solve_libmv(path, flags, device=device)
        wall, launched = read(label, t0)
        want = LIBMV_REF[label]
        print(f"{label} (refine_intrinsics {flags}): {s.num_iterations} LM "
              f"(JAX {want.get('iterations')} -+ {want.get('spread')}), "
              f"{s.num_inner_iteration_steps} inner steps, final cost "
              f"{s.final_cost!r} (JAX {want.get('final_cost')!r}), "
              f"intrinsics {np.round(intr[:5], 6).tolist()}, wall "
              f"{wall:.4f} s (preprocessor "
              f"{s.preprocessor_time_in_seconds:.3f} s), launches "
              f"{launched}", flush=True)
        tol = max(LIBMV_TOL, 2.0 * want["cost_spread"])
        check(close(s.final_cost, want["final_cost"], tol)
              and abs(s.num_iterations - want["iterations"])
              <= 2 * want["spread"], f"{label} within {tol:.3e} of JAX, "
              f"its count within {2 * want['spread']}")
        check(not any(launched.values()), f"{label} launches no kernel")

    # ---- NIST ----
    nist_dir = os.path.join(tmp, "nist")
    os.makedirs(nist_dir)
    write_nist_files(nist_dir, NIST_CERTIFIED)
    t0 = zero()
    lres, _, nsums = nist_runner.run_suite(nist_dir, verbose=False,
                                           device=device)
    wall, launched = read("NIST", t0)
    for name in sorted(NIST_SPECS):
        want_lre, want_cost = NIST_REF.get(name, ((None,) * 2, (None,) * 2))
        for k in range(2):
            s = nsums[name][k]
            print(f"NIST {name} start {k + 1}: LRE {lres[name][k]:.3f} (JAX "
                  f"{want_lre[k]}), {s.num_iterations} LM, final cost "
                  f"{s.final_cost!r} (JAX {want_cost[k]!r})", flush=True)
            check(want_lre[k] is not None
                  and abs(lres[name][k] - want_lre[k]) <= NIST_LRE_TOL
                  and close(s.final_cost, want_cost[k], NIST_COST_TOL,
                            EXAMPLE_COST_FLOOR),
                  f"NIST {name} start {k + 1} against JAX")
    print(f"NIST: wall {wall:.4f} s, launches {launched}", flush=True)
    check(not any(launched.values()), "NIST launches no kernel")

    shutil.rmtree(tmp, ignore_errors=True)
    print(f"slice13_paths: {time.time() - t_phase:.1f} s; walls "
          + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()),
          flush=True)
    if fails:
        raise SystemExit(f"slice13_paths: {len(fails)} checks failed: "
                         f"{fails}")


# slice 14 (`sharded_paths`): solves sharded over torch.distributed ranks
# (ceres_tpu_torch/parallel/), each rank a process spawned by
# parallel/launch.py run_ranks on the one card. NCCL refuses two ranks on
# one device, so world 1 runs NCCL and worlds 2 and 4 gloo, the ranks
# sharing the card (kernels on the card, collectives staged through host
# memory): these runs prove the sharded program and its kernels on the
# card, and their walls are not a measure of scaling. Paths:
#   SHARDED_NCCL_W1: bench.py's mixed DENSE_SCHUR at BAL-16-22106 (K1-K4);
#   SHARDED_DRYRUN_W4: parallel/dryrun.py's four parts (its f64 DENSE_SCHUR
#     solve within 1e-6 of the single-device solve in rank 0);
#   SHARDED_DENSE_W4, SHARDED_ITERATIVE_W4: bench.py's mixed DENSE_SCHUR
#     (K1-K4) and ITERATIVE_SCHUR + SCHUR_JACOBI (K1, K6, K7, K4);
#   SHARDED_IMPLICIT_W2: the large case (IMPLICIT_SHAPE) with
#     large_options, the implicit mode (K11, K10, K4);
#   SHARDED_CGNR_SE2_W2: the 1,000-pose SE2 graph, CGNR in f64 on the
#     sharded CGNR host loop (no kernel: f64, as in the JAX package).
# Gates: CONVERGENCE; the BAL-16 paths within REF_REL_TOL of the main
# path's cost and, with the f64 dry run, of the JAX package's sharded
# solve on SHARDED_WORLD virtual CPU devices (SHARDED_REF, from
# scripts/slice14_reference.py on the card's machine's CPU: f64 its LM
# count and 1e-9, mixed 1e-5); the implicit path within
# IMPLICIT_REF_REL_TOL of IMPLICIT_REF_COST; the SE2 path in an LM count
# that a JAX sharded run reached (its CG, truncated at eta 0.1, takes the
# trajectory to 17 or 14 LM on rounding alone: ROADMAP.md section 3) and
# its final cost within SHARDED_F64_TOL of JAX's run of that count (the
# unscaled run for 17; for another count the run from the smallest scaled
# start that reached it, within the larger of SHARDED_F64_TOL and twice
# the spread of JAX's runs of that count), and its first LM step at the
# start within SHARDED_STEP_TOL of JAX's (model cost change and step
# norm), which the f32 control, the single-device mixed CGNR step (K8,
# K9) at the same start, must miss: the final cost of an f32 CGNR lands
# within 1e-9 of JAX's f64 solve on this graph, so the step tells f32
# from f64, not the cost; every rank's x the same bits; each
# kernel of a path launched in every rank at least once per LM iteration
# (the linearizing kernels, K1 and K11, at least once per accepted step:
# a rejected step keeps its linearization) and no other kernel.
SHARDED_WORLD = 4
SHARDED_CGNR_WORLD = 2
# the scaled starts of scripts/slice14_reference.py --spread
SPREAD_SCALES = (1e-9, 3e-9, 1e-8, 3e-8, 1e-7, 3e-7, 1e-6)
SHARDED_F64_TOL = 1e-9
SHARDED_STEP_TOL = 1e-9
SHARDED_TIMEOUT_S = 600.0
# the JAX package's sharded solves (scripts/slice14_reference.py on the
# CPU of the H100's host): LM iterations and final cost
SHARDED_REF = {
    "f64_dense": dict(ref_cost=50287.7269104353, ref_iterations=6),
    "dense": dict(ref_cost=50287.726910436075, ref_iterations=6),
    "iterative": dict(ref_cost=50287.727273822005, ref_iterations=8),
    # with --spread: the runs from starts scaled by 1 -+ SPREAD_SCALES by
    # LM count ("branches": the unscaled start and eleven scaled ones end
    # 17 LM in, within 7.7e-10 of each other; the starts scaled by 1 +
    # 1e-8, 3e-8 and 1e-7 end 14 LM in, within 5.4e-9 of the first);
    # first_step: make_sharded_lm_step at the start
    "cgnr_se2": dict(ref_cost=98.97160671510446, ref_iterations=17,
                     branches={
                         17: dict(ref_cost=98.97160671510446, scale=0.0,
                                  runs=12, spread=7.714417517581856e-10),
                         14: dict(ref_cost=98.9716289149105, scale=1e-08,
                                  runs=3, spread=5.430940030160809e-09)},
                     first_step=dict(model_cost_change=1311.168399317959,
                                     step_norm=6.865585026182902,
                                     lin_iters=16)),
}
SHARDED_KERNELS = {
    "dense": (("K1 lin",), ("K2 elim", "K3 chol_solve", "K4 cost")),
    "iterative": (("K1 lin",), ("K6 elim_v1", "K7 dense_pcg", "K4 cost")),
    "implicit": (("K11 bucket_linearize",), ("K10 implicit_apply",
                                             "K4 cost")),
    "cgnr_se2": ((), ()),
}


def sharded_options(mod, path, **extra):
    """The options of a BAL-16 sharded path ("f64_dense": the dry run's,
    "dense" / "iterative": bench.py's) in package `mod`."""
    if path == "f64_dense":
        kw = dict(linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
                  max_num_iterations=50, function_tolerance=1e-6)
    else:
        kw = dict(linear_solver_type=getattr(
            mod.LinearSolverType, {"dense": "DENSE_SCHUR",
                                   "iterative": "ITERATIVE_SCHUR"}[path]),
            preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=50, function_tolerance=1e-6,
            max_linear_solver_iterations=100,
            use_mixed_precision_solves=True, fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def sharded_rank(paths):
    """A spawned rank's part of `sharded_paths`: each path in turn, its
    kernel counts and the group's collective counts set to 0 just before
    its solve and read just after. Returns per path the summary's
    numbers, the wall, the state's sha256 and the counts."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.parallel.dryrun import dryrun_rank
    from ceres_tpu_torch.parallel.group import as_group
    from ceres_tpu_torch.program import CompiledProgram
    world = dist.get_world_size()
    group = as_group(world)
    counters = kernel_counters()
    out = {}
    for path in paths:
        t0 = time.time()
        if path == "dryrun":
            out[path] = dryrun_rank("cuda")
            out[path]["build_s"] = 0.0
            continue
        if path == "implicit":
            bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7,
                                        pixel_noise=1.0)
            bal.perturb(**IMPLICIT_PERTURB, seed=8)
            problem, cams, pts = build_bal_ceres_problem(bal)
            arrays = cams + pts
            options = large_options(ctt, mesh=world, device="cuda")
        elif path == "cgnr_se2":
            from ceres_tpu_torch.examples import slam
            from ceres_tpu_torch.io import g2o
            cfg = POSE_GRAPHS["2d"]
            poses, edges, _ = getattr(g2o, cfg["generator"])(**cfg["args"])
            problem, positions, yaws = getattr(slam, cfg["build"])(poses,
                                                                   edges)
            arrays = list(positions.values()) + list(yaws.values())
            options = pose_graph_options(ctt, use_mixed_precision_solves=False,
                                         mesh=world, device="cuda")
        else:
            bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
            bal.perturb(**PERTURB, seed=8)
            problem, cams, pts = build_bal_ceres_problem(bal)
            arrays = cams + pts
            options = sharded_options(ctt, path, mesh=world, device="cuda")
        start = [np.array(a, copy=True) for a in arrays]
        # the program built outside the timed solve, as it is for the
        # single-device solves printed beside it
        CompiledProgram.get_cached(problem, options)
        build_s = time.time() - t0
        # BAL-16's paths: a warm-up solve, then the timed one
        for trial in range(1 if path in ("implicit", "cgnr_se2") else 2):
            for a, a0 in zip(arrays, start):
                a[:] = a0
            for fn in counters.values():
                fn.launches = 0
            group.reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            s = ctt.solve(options, problem)
            torch.cuda.synchronize()
            wall = time.time() - t0
        x = np.concatenate([np.ravel(a) for a in arrays])
        out[path] = dict(
            message=s.message, termination=str(s.termination_type),
            iterations=lm_iterations(s), accepted=s.num_successful_steps,
            cg=s.num_linear_solver_iterations,
            linearizations=getattr(s, "num_linearizations_fused", None),
            initial_cost=s.initial_cost, final_cost=s.final_cost,
            wall=wall, minimizer_s=s.minimizer_time_in_seconds,
            build_s=build_s,
            sha=hashlib.sha256(x.tobytes()).hexdigest(),
            launches={n: fn.launches for n, fn in counters.items()},
            calls=dict(group.calls), bytes=dict(group.bytes))
        if path == "cgnr_se2":
            out[path].update(se2_first_steps(problem, arrays, start,
                                             options, world))
    return out


def se2_first_steps(problem, arrays, start, options, world):
    """The first LM step at the SE2 graph's start and the initial radius:
    the sharded CGNR step in f64 (make_sharded_lm_step) and, in rank 0,
    its f32 control, the single-device mixed CGNR step (GenericLMStep:
    K11, K9, K8). Each as (model cost change, step norm, CG
    iterations)."""
    import torch.distributed as dist
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.parallel.sharded import make_sharded_lm_step
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solver import GenericLMStep

    def numbers(o):
        return (float(o["model_cost_change"]), float(o["step_norm"]),
                int(o["lin_iters"]))

    for a, a0 in zip(arrays, start):
        a[:] = a0
    radius = options.initial_trust_region_radius
    program = CompiledProgram.get_cached(problem, options)
    step, _ = make_sharded_lm_step(program, options, world)
    out = {"first_step": numbers(step(program.initial_state(), radius))}
    if dist.get_rank() == 0:
        opt32 = pose_graph_options(ctt, device="cuda")
        p32 = CompiledProgram.get_cached(problem, opt32)
        s32 = GenericLMStep(p32, opt32)
        out["first_step_f32"] = numbers(s32.solve(
            s32.linearize(p32.initial_state(), None, True), radius))
    return out


def sharded_paths(counters, by_path, smi, problem, reset_state, meta,
                  big_problem, reset_big, big_meta, device="cuda"):
    """Slice 14's phase (its comment block above): three spawns of ranks
    on the card, NCCL world 1, gloo world SHARDED_WORLD and gloo world
    SHARDED_CGNR_WORLD; the single-device solves of the same options in
    this process for the walls. Adds rank 0's launches to `by_path`;
    raises once every path has printed its numbers, if one was off its
    gate."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    import chip_smoke
    from ceres_tpu_torch.parallel.launch import run_ranks
    from ceres_tpu_torch.parallel.sharded_fused import collective_footprint
    fails = []
    t_phase = time.time()
    single = {}
    # the single-device walls of the same options (a warm-up, then timed)
    for path in ("dense", "iterative"):
        opts = sharded_options(ctt, path, device=device)
        for _ in range(2):
            reset_state()
            torch.cuda.synchronize()
            t0 = time.time()
            s_ = ctt.solve(opts, problem)
            torch.cuda.synchronize()
            single[path] = (time.time() - t0, lm_iterations(s_),
                            s_.minimizer_time_in_seconds)
    reset_big()
    torch.cuda.synchronize()
    t0 = time.time()
    s_ = ctt.solve(large_options(ctt, device=device), big_problem)
    torch.cuda.synchronize()
    single["implicit"] = (time.time() - t0, lm_iterations(s_),
                          s_.minimizer_time_in_seconds)
    reset_state()
    reset_big()
    for fn in counters.values():
        fn.launches = 0

    runs = [("SHARDED_NCCL_W1", 1, "nccl", ["dense"]),
            (f"SHARDED_W{SHARDED_WORLD}", SHARDED_WORLD, "gloo",
             ["dryrun", "dense", "iterative"]),
            (f"SHARDED_W{SHARDED_CGNR_WORLD}", SHARDED_CGNR_WORLD, "gloo",
             ["implicit", "cgnr_se2"])]
    for label, world, backend, paths in runs:
        t0 = time.time()
        res = run_ranks(chip_smoke.sharded_rank, world, backend, device,
                        SHARDED_TIMEOUT_S, args=(paths,))
        print(f"{label}: {world} rank(s), backend {backend}, ranks sharing "
              f"one card ({smi}); spawn and paths {time.time() - t0:.1f} s",
              flush=True)
        for path in paths:
            name = (f"SHARDED_{path.upper()}_W{world}" if world > 1
                    else "SHARDED_NCCL_W1")
            rs = [r[path] for r in res]
            r0 = rs[0]
            if len({r["sha"] for r in rs}) != 1:
                fails.append(f"{name}: the ranks' x differ")
            if path == "dryrun":
                ref = SHARDED_REF.get("f64_dense")
                print(f"{name} [{backend}]: sharded f64 DENSE_SCHUR "
                      f"{r0['sharded_iterations']} LM to "
                      f"{r0['sharded_cost']!r} in {r0['sharded_wall']:.3f} s "
                      f"(ranks sharing one card over {backend}, not "
                      f"scaling) beside the single-device solve "
                      f"{r0['single_iterations']} LM to "
                      f"{r0['single_cost']!r} in {r0['single_wall']:.3f} s "
                      f"(rel {r0['rel']:.2e}); cgnr {r0['cgnr']}, schur "
                      f"{r0['schur']}, implicit {r0['implicit'][:3]}; JAX's "
                      f"sharded solve on {SHARDED_WORLD} CPU devices: {ref}",
                      flush=True)
                if ref is not None and not (
                        r0["sharded_iterations"] == ref["ref_iterations"]
                        and abs(r0["sharded_cost"] - ref["ref_cost"])
                        <= SHARDED_F64_TOL * ref["ref_cost"]):
                    fails.append(f"{name}: off the JAX sharded solve")
                continue
            launches = r0["launches"]
            by_path[name] = launches
            its = max(r0["iterations"], 1)
            per_it = {k: round(v / its, 3) for k, v in r0["calls"].items()}
            bytes_it = {k: round(v / its, 1) for k, v in r0["bytes"].items()}
            extra = ""
            if path in ("dense", "iterative", "implicit"):
                m_ = big_meta if path == "implicit" else meta
                fp = collective_footprint(
                    m_, large_options(ctt) if path == "implicit" else
                    sharded_options(ctt, path), world,
                    cg_iterations=(r0["cg"] // its if path != "dense"
                                   else 0), dtype_bytes=4)
                extra = (f"; collective_footprint per LM iteration "
                         f"({world} devices, f32, "
                         f"{r0['cg'] // its} CG): {fp}")
                w1, lm1, m1 = single[path]
                extra += (f"; single-device solve of the same options "
                          f"{lm1} LM in {w1:.4f} s (minimizer {m1:.4f} s)")
            print(f"{name} [{backend}, {world} rank(s) on one card: not "
                  f"scaling]: {r0['termination']}, {r0['iterations']} LM "
                  f"({r0['accepted']} accepted), {r0['cg']} linear "
                  f"iterations, final cost {r0['final_cost']!r}, wall "
                  f"{r0['wall']:.4f} s (minimizer {r0['minimizer_s']:.4f} "
                  f"s; problem and program build {r0['build_s']:.1f} s); "
                  f"rank 0's launches { {k: v for k, v in launches.items() if v} }; "
                  f"collectives per LM iteration {per_it}, bytes a rank "
                  f"per LM iteration {bytes_it}{extra}; {r0['message']}",
                  flush=True)
            if r0["termination"] != "CONVERGENCE":
                fails.append(f"{name}: {r0['termination']}")
            if path == "implicit":
                ref_cost, tol = IMPLICIT_REF_COST, IMPLICIT_REF_REL_TOL
            elif path == "cgnr_se2":
                ref = SHARDED_REF["cgnr_se2"]
                branch = ref["branches"].get(r0["iterations"])
                if branch is None:
                    fails.append(f"{name}: {r0['iterations']} LM, JAX's "
                                 f"runs {sorted(ref['branches'])}")
                    branch = ref["branches"][ref["ref_iterations"]]
                ref_cost = branch["ref_cost"]
                tol = max(SHARDED_F64_TOL, 2.0 * branch["spread"])
                print(f"  {name}: {r0['iterations']} LM, "
                      f"{abs(r0['final_cost'] - ref_cost) / ref_cost:.3e} "
                      f"from JAX's run of that count ({branch}; limit "
                      f"{tol:.3e}); JAX's runs by LM count "
                      f"{ {k: v['runs'] for k, v in ref['branches'].items()} }",
                      flush=True)
                want = ref["first_step"]
                wn = (want["model_cost_change"], want["step_norm"])
                errs = {}
                for key in ("first_step", "first_step_f32"):
                    got = r0[key]
                    errs[key] = max(abs(g - w) / abs(w)
                                    for g, w in zip(got[:2], wn))
                    print(f"  {name} {key}: model cost change, step norm, "
                          f"CG {got} (JAX's sharded step "
                          f"{(*wn, want['lin_iters'])}), largest relative "
                          f"difference {errs[key]:.3e} (limit "
                          f"{SHARDED_STEP_TOL:g})", flush=True)
                if not errs["first_step"] <= SHARDED_STEP_TOL:
                    fails.append(f"{name}: the first step is off JAX's")
                if errs["first_step_f32"] <= SHARDED_STEP_TOL:
                    fails.append(f"{name}: the f32 control passes the step "
                                 "gate")
            else:
                ref_cost, tol = REF_FINAL_COST, REF_REL_TOL
                ref = SHARDED_REF.get(path) if world > 1 else None
                if ref is not None and abs(r0["final_cost"] - ref[
                        "ref_cost"]) > REF_REL_TOL * ref["ref_cost"]:
                    fails.append(f"{name}: {r0['final_cost']} is off the "
                                 f"JAX sharded solve's {ref['ref_cost']}")
            if abs(r0["final_cost"] - ref_cost) > tol * ref_cost:
                fails.append(f"{name}: final cost {r0['final_cost']} off "
                             f"{ref_cost} by more than {tol}")
            once_lin, once_it = SHARDED_KERNELS[path]
            for r in rs:
                ln = r["launches"]
                for k in once_lin:
                    if ln[k] < r["accepted"]:
                        fails.append(f"{name}: {k} {ln[k]} < "
                                     f"{r['accepted']} accepted steps")
                for k in once_it:
                    if ln[k] < r["iterations"]:
                        fails.append(f"{name}: {k} {ln[k]} < "
                                     f"{r['iterations']} LM iterations")
                stray = [k for k, v in ln.items() if v and k not in
                         once_lin + once_it and "(shared)" not in k]
                if stray:
                    fails.append(f"{name}: other kernels launched: {stray}")
    print(f"sharded_paths: {time.time() - t_phase:.1f} s", flush=True)
    if fails:
        raise SystemExit("sharded_paths: " + "; ".join(fails))


def pipeline_problems(bal_io, seeds=PIPELINE_SEEDS):
    """PIPELINE's elements: [(problem, arrays)]."""
    out = []
    for s in seeds:
        bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
        bal.perturb(**PERTURB, seed=s)
        problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
        out.append((problem, cams + pts))
    return out


# slice 15 (`slice15_paths`): the rest of batch mode. Each part solves
# its elements with solve_batched(batch_mode="batch"), and the first
# SLICE15_PIPELINE[kind] of them in pipeline mode (pipeline mode on all
# 16 SE2 graphs and 1,024 curve fits took 57-176 s a part on the card,
# over the phase's whole budget), the programs built before both
# timings, every kernel count set to 0 just before the batch run and read
# just after. Batch mode launches the kernels of SLICE15_KERNELS[part]
# and no other: the JAX package's vmapped solve turns its Pallas kernels
# off but two, K3 in its fused step's f32 dense solve and K8 in CGNR on
# f32 buckets, and batch mode launches their counterparts once for all
# elements (K3 once an LM iteration: its count is the batch's
# iterations); the first call of each is captured and its kernel held
# against its plain version on those inputs. Each kind's elements are
# built once and reset to their starts before every run. Elements:
#   ba: SLICE15_BA_ELEMENTS starts of one BA graph (SLICE15_BA_SHAPE,
#     graph seed 11, pixel noise 0.5), perturbed by SLICE15_BA_PERTURB
#     with seeds 1, 2, ...;
#   implicit: SLICE15_IMPLICIT_ELEMENTS starts of a graph past the
#     explicit cap (nf 4,608), perturbed so; at four observations a point
#     it is loosely tied (at half its size neither package converges in
#     100 LM iterations), so the part runs SLICE15_IMPLICIT_ITERATIONS
#     and stops at that cap in both packages, in f64 (mixed, the JAX
#     runs from moved starts spread by 1.9e-3 at that cap, and an H100's
#     run lay at 3.71e-3 of the 3.73e-3 gate); its costs at the cap are
#     held by spread, and its first step by the step gate: each element's
#     first batch-mode step at its start (model cost change, step norm)
#     within SLICE15_STEP_TOL of the JAX package's batched step, the CG
#     count equal, and the same step in mixed precision (the f32 control)
#     off that gate;
#   se2: SLICE15_SE2_ELEMENTS SE2 pose graphs of SLICE15_SE2_POSES poses
#     (io/g2o.py's generator, seeds 1, 2, ...: one structure, each its
#     own noise);
#   curve: SLICE15_CURVES fits of the tutorial's exponential to its 67
#     points, element e's y moved by SLICE15_CURVE_NOISE N(0, 1) from
#     numpy's default_rng(e), from m = c = 0.
# Gates (SLICE15_REF, scripts/slice15_reference.py: the JAX package's
# batched run on the CPU): "f64" parts take each element's LM and linear
# iteration counts of the JAX run, its final cost within SLICE15_F64_TOL
# of JAX's and of pipeline mode's; "spread" parts part by rounding (f32
# order; dogleg's ladder on BA; the SE2 graph's f64 CGNR at eta 0.1,
# ROADMAP.md section 3; the capped implicit runs): each final cost within
# twice the part's spread (the largest
# relative distance from JAX's batched run at the start of its runs from
# the starts moved by a -> a s + s - 1, s in SLICE15_MOVES, and of its
# pipeline run, whose single solves sum in another order), and at least
# within the part's function tolerance (an LM run that stops on it fixes
# its final cost to that relative resolution only), counts printed. Every
# element ends as JAX's does (CONVERGENCE; the implicit part at its
# cap). The launch check: torch.profiler's kernels (the host's launch
# records) of batch solves
# of 1 and 2 LM iterations at 3 CG iterations an LM iteration and of 1 at
# 6 (min = max linear solver iterations; a warm-up of each first, then two
# profiled runs, which must launch the same) on
# SLICE15_LAUNCH_BATCHES elements, mixed CGNR (K8 a bucket a CG
# iteration) on SE2 graphs of
# SLICE15_LAUNCH_POSES poses and mixed ITERATIVE_SCHUR + SCHUR_JACOBI on
# BATCH_BA_SHAPE: the kernels and the device-to-host copies (the host
# reads) of a CG iteration and of an LM iteration outside the CG loop are
# the same at every batch size.
SLICE15_BA_ELEMENTS = 16
SLICE15_BA_SHAPE = dict(num_cameras=16, num_points=2500,
                        num_observations=10000)
SLICE15_BA_PERTURB = dict(rotation_sigma=0.02, translation_sigma=0.1,
                          point_sigma=0.05)
SLICE15_IMPLICIT_ELEMENTS = 2
SLICE15_IMPLICIT_SHAPE = dict(num_cameras=512, num_points=20000,
                              num_observations=80000)
SLICE15_IMPLICIT_ITERATIONS = 10
SLICE15_PIPELINE = dict(ba=8, implicit=2, se2=2, curve=8)
SLICE15_SE2_ELEMENTS = 16
SLICE15_SE2_POSES = 1000
SLICE15_CURVES = 1024
SLICE15_CURVE_NOISE = 0.01
SLICE15_MOVES = (1.0 - 1e-7, 1.0 + 1e-7)
SLICE15_F64_TOL = 1e-9
SLICE15_STEP_TOL = 1e-9
SLICE15_FIRST_STEP_PARTS = ("IMPLICIT",)
SLICE15_LAUNCH_BATCHES = (8, 64)
SLICE15_LAUNCH_POSES = 100
_MIXED = dict(use_mixed_precision_solves=True)
# part: (elements, options, how it is gated)
SLICE15_PARTS = {
    "BA_IS_SCHUR_JACOBI_MIXED": ("ba", dict(
        _MIXED, linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_JACOBI"), "spread"),
    "BA_IS_CLUSTER_JACOBI": ("ba", dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="CLUSTER_JACOBI"), "f64"),
    "BA_SPARSE_SCHUR": ("ba", dict(linear_solver_type="SPARSE_SCHUR"),
                        "f64"),
    "BA_DENSE_SCHUR_MIXED": ("ba", dict(
        _MIXED, linear_solver_type="DENSE_SCHUR"), "spread"),
    "BA_DENSE_SCHUR_REFINED": ("ba", dict(
        _MIXED, linear_solver_type="DENSE_SCHUR",
        max_num_refinement_iterations=2), "spread"),
    "BA_DOGLEG_DENSE_SCHUR": ("ba", dict(
        linear_solver_type="DENSE_SCHUR",
        trust_region_strategy_type="DOGLEG"), "spread"),
    "IMPLICIT": ("implicit", dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_JACOBI",
        max_num_iterations=SLICE15_IMPLICIT_ITERATIONS), "spread"),
    "SE2_CGNR": ("se2", dict(linear_solver_type="CGNR",
                             preconditioner_type="JACOBI"), "spread"),
    "SE2_CGNR_MIXED": ("se2", dict(_MIXED, linear_solver_type="CGNR",
                                   preconditioner_type="JACOBI"), "spread"),
    "SE2_SPARSE_NORMAL_CHOLESKY": ("se2", dict(
        linear_solver_type="SPARSE_NORMAL_CHOLESKY"), "f64"),
    "CURVE_DOGLEG": ("curve", dict(linear_solver_type="DENSE_QR",
                                   trust_region_strategy_type="DOGLEG"),
                     "f64"),
    "CURVE_SUBSPACE_DOGLEG": ("curve", dict(
        linear_solver_type="DENSE_QR", trust_region_strategy_type="DOGLEG",
        dogleg_type="SUBSPACE_DOGLEG"), "f64"),
    "CURVE_DNC_REFINED": ("curve", dict(
        _MIXED, linear_solver_type="DENSE_NORMAL_CHOLESKY",
        max_num_refinement_iterations=3), "spread"),
}
# the kernels a part's batch run launches (every other count stays 0)
SLICE15_KERNELS = {
    "BA_DENSE_SCHUR_MIXED": ("K3 chol_solve", "K3 chol_solve (shared)"),
    "SE2_CGNR_MIXED": ("K8 bucket_jtjv",),
}
_ENUMS = {"linear_solver_type": "LinearSolverType",
          "preconditioner_type": "PreconditionerType",
          "trust_region_strategy_type": "TrustRegionStrategyType",
          "dogleg_type": "DoglegType"}


def slice15_elements(kind, pk, move=1.0, n=None, poses=None):
    """[(problem, [parameter arrays])] of a slice-15 part in the package
    whose modules `pk` holds (mod, bal_io, slam, g2o, tutorial); each
    start moved by a -> a move + move - 1."""
    import numpy as np
    out = []
    if kind in ("ba", "implicit"):
        shape, count = ((SLICE15_BA_SHAPE, SLICE15_BA_ELEMENTS)
                        if kind == "ba" else
                        (SLICE15_IMPLICIT_SHAPE, SLICE15_IMPLICIT_ELEMENTS))
        if n is not None:
            shape, count = BATCH_BA_SHAPE, n
        for seed in range(1, count + 1):
            bal = pk["bal_io"].synthetic_bal_problem(**shape, seed=11,
                                                     pixel_noise=0.5)
            bal.perturb(**SLICE15_BA_PERTURB, seed=seed)
            problem, cams, pts = pk["bal_io"].build_bal_ceres_problem(bal)
            out.append((problem, list(cams) + list(pts)))
    elif kind == "se2":
        for seed in range(1, (n or SLICE15_SE2_ELEMENTS) + 1):
            poses_, edges, _ = pk["g2o"].synthetic_pose_graph_2d(
                num_poses=poses or SLICE15_SE2_POSES, seed=seed)
            problem, pos, yaws = pk["slam"].build_pose_graph_2d_problem(
                poses_, edges)
            out.append((problem, [pos[i] for i in sorted(pos)]
                        + [yaws[i] for i in sorted(yaws)]))
    else:
        data = np.asarray(pk["tutorial"].CURVE_DATA)
        mod = pk["mod"]
        for e in range(n or SLICE15_CURVES):
            ys = data[:, 1] + SLICE15_CURVE_NOISE * np.random.default_rng(
                e).standard_normal(len(data))
            m, c = np.array([0.0]), np.array([0.0])
            problem = mod.Problem()
            for x, y in zip(data[:, 0], ys):
                problem.add_residual_block(mod.AutoDiffCostFunction(
                    pk["tutorial"].ExponentialResidual(float(x), float(y)),
                    1, [1, 1]), None, m, c)
            out.append((problem, [m, c]))
    if move != 1.0:
        for _, arrs in out:
            for a in arrs:
                a[...] = a * move + (move - 1.0)
    return out


def slice15_options(mod, kind, kw, **extra):
    """A part's SolverOptions in package `mod`."""
    o = dict(max_num_iterations=50, fused_iterations=True,
             function_tolerance=1e-12 if kind == "curve" else 1e-9)
    o.update({k: (getattr(mod, _ENUMS[k])[v] if k in _ENUMS else v)
              for k, v in kw.items()})
    o.update(extra)
    return mod.SolverOptions(**o)


# scripts/slice15_reference.py's output (the JAX package on the CPU of
# the H100 machine): per part each element's [LM, linear] iteration
# counts, final cost and termination, and the spread (None for the f64
# parts)
SLICE15_REF_FILE = os.path.join("scripts", "slice15_reference.json")


def slice15_reference():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SLICE15_REF_FILE)) as f:
        return json.load(f)


def batch_first_steps(options, problems):
    """The port's batch-mode step at each element's start and the
    initial radius (what batched_tr_solve's first iteration computes):
    per element (model cost change, step norm, linear iterations)."""
    import torch
    from ceres_tpu_torch import batch as batch_mod
    from ceres_tpu_torch.program import CompiledProgram
    programs = [CompiledProgram.get_cached(p, options) for p in problems]
    data = batch_mod._Batch(programs)
    step = batch_mod.make_batched_step(programs[0], options).bind(data)
    x0 = data.x0
    art = step.linearize(x0, None, first=True, cost=step.cost(x0))
    radius = torch.full((x0.shape[0],), options.initial_trust_region_radius,
                        dtype=torch.float64, device=x0.device)
    delta, mcc, its = step.solve(art, radius)
    return [(float(m), float(n), int(i)) for m, n, i in zip(
        mcc, torch.linalg.vector_norm(delta, dim=1), its)]


def slice15_kernel_checks(captured, check):
    """Hold each kernel a batch run launched against its plain version
    on the inputs of its first call there (slice15_paths' captures, which
    it empties): K3 on every element's reduced system at once, K8 on each
    bucket of the elements' stacked Jacobian."""
    import torch
    from ceres_tpu_torch.ops import kernels as kern
    runs = []
    if "K3" in captured:
        S, rhs = captured.pop("K3")
        nb, m = S.shape[0], S.shape[-1]
        runs.append((
            f"K3 chol_solve (batch mode: {nb} systems, m {m}, one launch)",
            lambda: kern.chol_solve(S, rhs),
            lambda: kern.chol_solve_plain(S, rhs), K3_LIMIT,
            "ceres_tpu_torch/csrc/chol.cu",
            "ceres_tpu/ops/pallas_kernels.py:190", (S, rhs),
            nb * (m ** 3 / 3 + 2 * m * m),
            ("torch.linalg.solve(S, rhs)",
             lambda: torch.linalg.solve(S, rhs))))
    if "K8" in captured:
        jac, v = captured.pop("K8")
        for bi, b in enumerate(jac.buckets):
            J, cols = b.J, b.cols32
            n, r, t = J.shape
            runs.append((
                f"K8 bucket_jtjv (batch mode: bucket {bi} of the stacked "
                f"Jacobian, [{n}, {r}, {t}])",
                lambda J=J, cols=cols: kern.bucket_jtjv(J, v, cols),
                lambda J=J, cols=cols: kern.bucket_jtjv_plain(J, v, cols),
                F32_LIMIT, "ceres_tpu_torch/csrc/jtjv.cu",
                "ceres_tpu/ops/pallas_kernels.py:111", (J, v, cols),
                4 * n * r * t, None))
    for (name, kernel, plain, limit, source, replaces, inputs, flops,
         library) in runs:
        try:
            check_kernel(name, kernel, plain, lambda g, w: [rel_err(g, w)],
                         limit, source, replaces, inputs, flops,
                         F32_FLOP_PER_S, library=library)
            ok = True
        except SystemExit:
            ok = False
        check(ok, f"{name}: kernel and plain version agree")


def slice15_step_gate(part, want, elems, starts, options, check):
    """The first batch-mode step at each element's start in f64 and in
    mixed precision (options: the two SolverOptions) against the JAX
    package's batched f64 step `want` ([model cost change, step norm, CG
    iterations] an element): the f64 step within SLICE15_STEP_TOL with
    JAX's CG count, the f32 control off the gate."""
    steps = []
    for o in options:
        for (_, arrs), st in zip(elems, starts):
            for a, a0 in zip(arrs, st):
                a[...] = a0
        steps.append(batch_first_steps(o, [p for p, _ in elems]))

    def err(got):
        return max(max(abs(g[0] - w[0]) / abs(w[0]),
                       abs(g[1] - w[1]) / abs(w[1]))
                   for g, w in zip(got, want))
    if not want:
        check(False, f"{part}: the reference holds the JAX first steps")
        return
    print(f"SLICE15 {part} first step at the start (model cost change, "
          f"step norm, CG): f64 {steps[0]}, f32 control {steps[1]}, JAX "
          f"{want}; largest relative distance to JAX: f64 "
          f"{err(steps[0]):.3e}, f32 {err(steps[1]):.3e} (gate "
          f"{SLICE15_STEP_TOL:.0e})", flush=True)
    check(err(steps[0]) <= SLICE15_STEP_TOL
          and [g[2] for g in steps[0]] == [w[2] for w in want],
          f"{part}: first f64 step within {SLICE15_STEP_TOL:.0e} of JAX's, "
          f"its CG count JAX's")
    check(err(steps[1]) > SLICE15_STEP_TOL,
          f"{part}: the f32 control is off the step gate")


def slice15_paths(counters, by_path, device="cuda"):
    """Slice 15's phase: each of SLICE15_PARTS in batch and pipeline mode
    with its gates, then the launch check (the comment above). Prints
    each part's walls and the phase's time; raises once every part has
    printed its numbers, if one was off its gate."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch import batch as batch_mod
    from ceres_tpu_torch.examples import slam, tutorial
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.ops import kernels as kern
    from ceres_tpu_torch.program import CompiledProgram
    pk = dict(mod=ctt, bal_io=bal_io, slam=slam, g2o=g2o, tutorial=tutorial)
    fails, t_phase = [], time.time()
    refs = slice15_reference()
    on_card = torch.device(device).type == "cuda"
    captured = {}

    def capturing(key, fn):
        """fn, with the inputs of its first call kept under `key`."""
        def call(*args):
            if key not in captured:
                captured[key] = tuple(a.clone() if isinstance(
                    a, torch.Tensor) else a for a in args)
            return fn(*args)
        return call

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def check(ok, msg):
        print(("  ok: " if ok else "  FAIL: ") + msg, flush=True)
        if not ok:
            fails.append(msg)

    walls, built = {}, {}
    for part, (kind, kw, how) in SLICE15_PARTS.items():
        if kind not in built:
            elems = slice15_elements(kind, pk)
            built.clear()           # one kind's elements alive at a time
            built[kind] = (elems, [[a.copy() for a in arrs]
                                   for _, arrs in elems])
        elems, starts = built[kind]
        npipe = SLICE15_PIPELINE[kind]
        probs = [p for p, _ in elems]
        opts = {mode: slice15_options(ctt, kind, kw, batch_mode=mode,
                                      device=device)
                for mode in ("batch", "pipeline")}
        for p in probs:
            CompiledProgram.get_cached(p, opts["batch"])
        out = {}
        for mode, subset in (("batch", probs), ("pipeline", probs[:npipe])):
            for (_, arrs), st in zip(elems, starts):
                for a, a0 in zip(arrs, st):
                    a[...] = a0
            if mode == "batch":
                batch_mod.chol_solve = capturing("K3", kern.chol_solve)
                batch_mod.jac_normal_matvec = capturing(
                    "K8", kern.jac_normal_matvec)
            for fn in counters.values():
                fn.launches = 0
            sync()
            t0 = time.time()
            try:
                ss = ctt.solve_batched(opts[mode], subset)
                sync()
            finally:
                batch_mod.chol_solve = kern.chol_solve
                batch_mod.jac_normal_matvec = kern.jac_normal_matvec
            out[mode] = (time.time() - t0, ss)
            if mode == "batch":
                by_path[f"SLICE15_{part}"] = {
                    n: fn.launches for n, fn in counters.items()}
        (wb, bs), (wp, ps) = out["batch"], out["pipeline"]
        walls[part] = (wb, len(bs), wp, len(ps))
        launched = {n: c for n, c in by_path[f"SLICE15_{part}"].items() if c}
        counts = [(s.num_iterations, s.num_linear_solver_iterations)
                  for s in bs]
        pcounts = [(s.num_iterations, s.num_linear_solver_iterations)
                   for s in ps]
        cb = np.array([s.final_cost for s in bs])
        cp = np.array([s.final_cost for s in ps])
        ref = refs[part]
        cj = np.asarray(ref.get("costs", cb))
        terms = [s.termination_type.name for s in bs]
        print(f"SLICE15 {part} ({len(bs)} {kind} elements, {how}): batch "
              f"wall {wb:.4f} s ({wb / len(bs):.5f} s an element), "
              f"pipeline wall {wp:.4f} s on the first {len(ps)} "
              f"({wp / len(ps):.5f} s an element); counts (LM, linear) "
              f"batch {counts}, pipeline {pcounts}, JAX {ref.get('counts')};"
              f" terminations {sorted(set(terms))}; largest relative cost "
              f"distance to JAX {np.max(np.abs(cb - cj) / cj):.3e}, to "
              f"pipeline {np.max(np.abs(cb[:len(cp)] - cp) / cp):.3e}; "
              f"launches {launched}", flush=True)
        check(terms == ref.get("terminations")
              and [s.termination_type.name for s in ps] == terms[:len(ps)]
              and all(s.is_solution_usable() for s in bs + ps),
              f"{part}: every element ends as JAX's does")
        want_k = SLICE15_KERNELS.get(part, ()) if on_card else ()
        check(set(launched) == set(want_k),
              f"{part}: batch mode launches {list(want_k) or 'no kernel'}"
              f" and no other")
        if "K3 chol_solve" in want_k:
            check(launched.get("K3 chol_solve") == max(
                s.num_iterations for s in bs),
                f"{part}: K3 once an LM iteration for all {len(bs)} "
                f"elements")
        if on_card:
            slice15_kernel_checks(captured, check)
        captured.clear()
        if part in SLICE15_FIRST_STEP_PARTS:
            slice15_step_gate(part, ref.get("first_steps"), elems, starts,
                              [slice15_options(
                                  ctt, kind, kw, batch_mode="batch",
                                  device=device,
                                  use_mixed_precision_solves=f32)
                               for f32 in (False, True)], check)
        check(all(f"[batch]" in s.message for s in bs)
              and all(f"[pipeline]" in s.message for s in ps),
              f"{part}: the modes asked for")
        if how == "f64":
            check([list(c) for c in counts] == ref.get("counts"),
                  f"{part}: counts the JAX batched run's")
            check(bool(np.all(np.abs(cb - cj) <= SLICE15_F64_TOL * cj)),
                  f"{part}: costs within {SLICE15_F64_TOL} of JAX's")
            check(bool(np.all(np.abs(cb[:len(cp)] - cp)
                              <= SLICE15_F64_TOL * cp)),
                  f"{part}: costs within {SLICE15_F64_TOL} of pipeline's")
        else:
            tol = max(2.0 * (ref.get("spread") or 0.0),
                      opts["batch"].function_tolerance)
            check(bool(np.all(np.abs(cb - cj) <= tol * cj)),
                  f"{part}: costs within twice JAX's spread or the "
                  f"function tolerance ({tol:.3e}) of JAX's")
        del out, bs, ps
    built.clear()
    t_parts = time.time() - t_phase

    # ---- the launch check ----
    batches = SLICE15_LAUNCH_BATCHES if torch.device(device).type == \
        "cuda" else ()
    for label, kind, kw in (
            ("CGNR", "se2", dict(_MIXED, linear_solver_type="CGNR",
                                 preconditioner_type="JACOBI")),
            ("ITERATIVE_SCHUR", "ba", dict(
                _MIXED, linear_solver_type="ITERATIVE_SCHUR",
                preconditioner_type="SCHUR_JACOBI"))):
        kernels, names = {}, {}
        for B in batches:
            elems = slice15_elements(kind, pk, n=B,
                                     poses=SLICE15_LAUNCH_POSES)
            starts = [[a.copy() for a in arrs] for _, arrs in elems]
            for iters, cg in ((1, 3), (1, 6), (2, 3)):
                o = slice15_options(
                    ctt, kind, kw, batch_mode="batch", device=device,
                    max_num_iterations=iters, gradient_tolerance=1e-300,
                    function_tolerance=1e-300, parameter_tolerance=1e-300,
                    min_linear_solver_iterations=cg,
                    max_linear_solver_iterations=cg)
                # a warm-up (a new configuration's first solve builds its
                # step and launches its set-up kernels), then two profiled
                # runs. Kernels are counted where the host launches them
                # (the profiler's cudaLaunchKernel / cudaLaunchKernelExC
                # records): the profiler now and then drops the device
                # records of the first kernels after it starts (on an
                # H100, 2 of 144 profiled runs lacked the 23 kernels of a
                # solve's first cost evaluation while their host records
                # and every CPU op were those of the other runs), so a
                # device count is printed, not gated
                runs = []
                for rep_ in range(3):
                    for (_, arrs), st in zip(elems, starts):
                        for a, a0 in zip(arrs, st):
                            a[...] = a0
                    sync()
                    if rep_ == 0:
                        ctt.solve_batched(o, [p for p, _ in elems])
                        continue
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        ss = ctt.solve_batched(o, [p for p, _ in elems])
                        sync()
                    ev = prof.events()
                    host = sum(1 for e in ev
                               if e.device_type == torch.autograd.DeviceType.CPU
                               and e.name.startswith(("cudaLaunchKernel",
                                                      "cuLaunchKernel")))
                    dev = [e.name for e in ev if e.device_type
                           == torch.autograd.DeviceType.CUDA]
                    kern = collections.Counter(
                        n for n in dev if not n.startswith(("Memcpy",
                                                            "Memset")))
                    runs.append((host, len([n for n in dev if n.startswith(
                        "Memcpy DtoH")]), sum(kern.values()), kern))
                if len({r[:3] for r in runs}) > 1:
                    print(f"  launch check {label} B={B} ({iters}, {cg}): "
                          f"(host launches, device-to-host copies, device "
                          f"kernel records) of the runs "
                          f"{[r[:3] for r in runs]}", flush=True)
                check(len({r[0] for r in runs}) == 1
                      and all(r[2] <= r[0] for r in runs),
                      f"launch check {label} B={B} ({iters}, {cg}): the "
                      f"profiled runs launch the same kernels")
                kernels[(B, iters, cg)] = (runs[0][0],
                                           max(r[1] for r in runs))
                names[(B, iters, cg)] = max(runs, key=lambda r: r[2])[3]
                check(all(s.num_iterations == iters
                          and s.num_linear_solver_iterations == iters * cg
                          for s in ss),
                      f"launch check {label} B={B}: {iters} LM and "
                      f"{iters * cg} CG iterations an element")
        # (kernels, device-to-host copies) a CG iteration and an LM
        # iteration outside the CG loop
        per = {B: tuple(
            ((k[(B, 1, 6)][i] - k[(B, 1, 3)][i]) / 3,
             k[(B, 2, 3)][i] - k[(B, 1, 3)][i]
             - (k[(B, 1, 6)][i] - k[(B, 1, 3)][i]))
            for i in (0, 1)) for B in batches for k in (kernels,)}
        print(f"SLICE15 launch check {label} (torch.profiler, kernels "
              f"launched by the host; device-to-host copies): " + ", ".join(
                  f"{B} elements: {kernels[(B, 1, 3)]} for a 1-iteration "
                  f"solve, {per[B][0][0]} kernels and {per[B][1][0]} "
                  f"copies a CG iteration, {per[B][0][1]} kernels and "
                  f"{per[B][1][1]} copies an LM iteration outside the CG "
                  f"loop" for B in batches), flush=True)
        same = not batches or (len(set(per.values())) == 1
                               and per[batches[0]][0][0] > 0)
        if not same:        # which kernels a batch size changes
            for a, b_ in (((1, 6), (1, 3)), ((2, 3), (1, 3))):
                d = {B: names[(B,) + a] - names[(B,) + b_]
                     for B in batches}
                print(f"  launch check {label}, kernels of {a} less "
                      f"{b_}, by batch size: "
                      + "; ".join(f"{B}: {sorted(d[B].items())}"
                                  for B in batches), flush=True)
        check(same, f"{label}: kernels and host copies a CG iteration and "
              "an LM iteration independent of the batch")
    took = time.time() - t_phase
    print(f"slice15_paths: {took:.1f} s (the parts {t_parts:.1f} s, the "
          f"launch check {took - t_parts:.1f} s; batch walls on B elements / "
          f"pipeline walls on the first n: " + ", ".join(
              f"{p} {b:.3f} s / {nb} : {q:.3f} s / {nq}"
              for p, (b, nb, q, nq) in walls.items()) + ")", flush=True)
    if fails:
        raise SystemExit(f"slice15_paths: {len(fails)} checks failed: "
                         + "; ".join(fails))


# slice 16 (`slice16_paths`): the last kernel limits on the card.
# OPENCV_IMPLICIT: the large case's shape and IMPLICIT_PERTURB with
# COLMAP's FULL_OPENCV camera (opencv_functor: angle-axis, translation,
# fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6; 18 parameters, so nf =
# 18,432 and K10 runs at (r, te, tf) = (2, 3, 18), past tier 0's tf <= 16),
# solved with large_options (ITERATIVE_SCHUR, SCHUR_JACOBI, mixed) in
# the implicit step. synthetic_bal_problem's cameras and observation
# structure at that shape, with its points drawn uniformly in a ball of
# OPENCV_CLOUD_RADIUS about the ring's centre, so that from the ring
# (radius 8) the observations fill a wide-angle image: normalized radius
# up to tan(asin(6 / 8)) = 1.13, a field of view of 97 degrees across,
# 567 px from the centre at the ring's focal length of 500. The
# intrinsics are those of a calibrated wide-angle lens under FULL_OPENCV
# (k1 -0.28, k2 0.09, k3 -0.012, k4 0.05, k5 0.015, k6 0.002, each varied
# a camera), over whose radii k1..k6 are identifiable
# (scripts/slice16_reference.py --conditioning prints the radial
# Jacobian's condition number). Observations are the model's projections
# at synthetic_bal_problem's pixel noise (opencv_data).
OPENCV_INTRINSICS_SEED = 16
OPENCV_PIXEL_NOISE = 1.0
OPENCV_CLOUD_RADIUS = 6.0
# LOSSES: the main path's problem under Ceres's documented weighting of a
# robust loss (ScaledLoss), and under per-observation scalars: a level in
# 0..7 a observation (numpy default_rng(LOSS_LEVEL_SEED)), ORB-SLAM2's
# octave scales (scaleFactor 1.2, nLevels 8)
LOSS_LEVEL_SEED = 16
LOSS_LEVEL_SCALE = 1.2
LOSS_LEVELS = 8
LOSS_PATHS = {
    # DENSE_SCHUR under ScaledLoss(HuberLoss(1.0), 0.5): K1 through its
    # generated loss unit, K2, K3, K4
    "SCALED_HUBER": dict(loss="scaled_huber", quaternions=False,
                         solver="DENSE_SCHUR"),
    # DENSE_SCHUR under HuberLoss(1.2 ** level): one bucket, K1 with the
    # lanes' own scalars
    "ROW_HUBER": dict(loss="row_huber", quaternions=False,
                      solver="DENSE_SCHUR"),
    # quaternion cameras (Euclidean quaternion blocks), ITERATIVE_SCHUR
    # under CauchyLoss(2 * 1.2 ** level): K5 with the lanes' own scalars,
    # K6, K7. The functor is Ceres's own (quaternion_functor, which
    # normalizes q); with the packages' SnavelyReprojectionErrorWith-
    # Quaternions, which does not, both packages stop in FAILURE here
    # (scripts/slice16_reference.py --parts CAUCHY_DIAGNOSIS; ROADMAP.md
    # section 3)
    "QUAT_ROW_CAUCHY": dict(loss="row_cauchy", quaternions=True,
                            solver="ITERATIVE_SCHUR", functor="ceres"),
}
# each path's final cost within LOSS_REL_TOL of the JAX package's run
# (scripts/slice16_reference.py), as Robust BAL-16's gate
LOSS_REL_TOL = 1e-5
SLICE16_REF_FILE = "scripts/slice16_reference.json"
# the LM cap of OPENCV_IMPLICIT: the JAX runs' largest count
# (scripts/slice16_reference.json) with a quarter of headroom
OPENCV_CAP_HEADROOM = 1.25


def quaternion_functor(T, rot):
    """Ceres's SnavelyReprojectionErrorWithQuaternions (examples/
    snavely_reprojection_error.h) in array module T with rotation module
    `rot`: camera [quaternion 4 (w first), translation 3, f, k1, k2],
    point [3]. It rotates with QuaternionRotatePoint, which divides q by
    its norm, since the bundle adjuster may optimize all four quaternion
    parameters with no manifold; the packages' functor of that name
    rotates with UnitQuaternionRotatePoint, so there |q| scales the view
    by |q|^2."""
    class SnavelyQuaternion:
        def __init__(self, observed_x, observed_y):
            self.observed_x, self.observed_y = observed_x, observed_y

        def __call__(self, camera, point):
            q = camera[:4]
            scale = 1.0 / T.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                                 + q[3] * q[3])
            p = rot.unit_quaternion_rotate_point(q * scale, point) \
                + camera[4:7]
            xp = -p[0] / p[2]
            yp = -p[1] / p[2]
            r2 = xp * xp + yp * yp
            distortion = 1.0 + r2 * (camera[8] + camera[9] * r2)
            return T.stack([camera[7] * distortion * xp - self.observed_x,
                            camera[7] * distortion * yp - self.observed_y])
    return SnavelyQuaternion


def opencv_functor(T, rot):
    """COLMAP's FULL_OPENCV camera model (colmap/src/colmap/sensor/
    models.h FullOpenCVCameraModel) on an angle-axis pose, in array module
    T with rotation module `rot` (torch and the port's, or jax.numpy and
    the JAX package's): camera [angle-axis 3, translation 3, fx, fy, cx,
    cy, k1, k2, p1, p2, k3, k4, k5, k6], point [3]; u = p_x / p_z,
    v = p_y / p_z (the geometry's cameras look down their -z axis, a
    reflection that the model absorbs), the rational radial and the
    tangential terms, then fx x + cx - observed_x, fy y + cy - observed_y.
    T and rot are closed over, not attributes (the JAX package batches a
    functor's numeric attributes)."""
    class FullOpenCV:
        def __init__(self, observed_x, observed_y):
            self.observed_x, self.observed_y = observed_x, observed_y

        def __call__(self, camera, point):
            p = rot.angle_axis_rotate_point(camera[:3], point) + camera[3:6]
            u = p[0] / p[2]
            v = p[1] / p[2]
            uu, vv, uv = u * u, v * v, u * v
            r2 = uu + vv
            radial = ((1.0 + r2 * (camera[10] + r2 * (camera[11]
                                                      + r2 * camera[14])))
                      / (1.0 + r2 * (camera[15] + r2 * (camera[16]
                                                        + r2 * camera[17]))))
            x = u * radial + 2.0 * camera[12] * uv + camera[13] * (
                r2 + 2.0 * uu)
            y = v * radial + 2.0 * camera[13] * uv + camera[12] * (
                r2 + 2.0 * vv)
            return T.stack([camera[6] * x + camera[8] - self.observed_x,
                            camera[7] * y + camera[9] - self.observed_y])
    return FullOpenCV


def opencv_project(cameras, points, cam_idx, pt_idx):
    """opencv_functor's prediction (x, y) of each observation, numpy f64."""
    import numpy as np
    c, X = cameras[cam_idx], points[pt_idx]
    aa = c[:, :3]
    theta = np.linalg.norm(aa, axis=1, keepdims=True)
    w = aa / np.where(theta > 0, theta, 1.0)
    ct, st = np.cos(theta), np.sin(theta)
    p = (X * ct + np.cross(w, X) * st
         + w * np.sum(w * X, axis=1, keepdims=True) * (1.0 - ct)) + c[:, 3:6]
    u, v = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
    r2 = u * u + v * v
    radial = ((1.0 + r2 * (c[:, 10] + r2 * (c[:, 11] + r2 * c[:, 14])))
              / (1.0 + r2 * (c[:, 15] + r2 * (c[:, 16] + r2 * c[:, 17]))))
    x = u * radial + 2.0 * c[:, 12] * u * v + c[:, 13] * (r2 + 2.0 * u * u)
    y = v * radial + 2.0 * c[:, 13] * u * v + c[:, 12] * (r2 + 2.0 * v * v)
    return np.stack([c[:, 6] * x + c[:, 8], c[:, 7] * y + c[:, 9]], axis=1)


def opencv_data(bal_io, shape=None, seed=7):
    """(cameras [nc, 18], points [np, 3], camera_index, point_index,
    observations [no, 2]) of OPENCV_IMPLICIT: synthetic_bal_problem's
    cameras and observation structure at `shape` (IMPLICIT_SHAPE), its
    points redrawn uniformly in a ball of OPENCV_CLOUD_RADIUS and the
    FULL_OPENCV intrinsics drawn from OPENCV_INTRINSICS_SEED (fx, fy the
    geometry's focal length, a principal point of a few pixels, a
    wide-angle lens's distortion), the model's projections plus
    OPENCV_PIXEL_NOISE pixels of Gaussian noise, then the cameras' pose
    and the points perturbed as BALProblem.perturb does with
    IMPLICIT_PERTURB and seed 8."""
    import numpy as np
    shape = IMPLICIT_SHAPE if shape is None else shape
    bal = bal_io.synthetic_bal_problem(**shape, seed=seed, pixel_noise=0.0)
    nc, npt = bal.num_cameras, bal.num_points
    rng = np.random.default_rng(OPENCV_INTRINSICS_SEED)
    d = rng.normal(size=(npt, 3))
    points = (OPENCV_CLOUD_RADIUS * d / np.linalg.norm(d, axis=1,
                                                      keepdims=True)
              * rng.random((npt, 1)) ** (1.0 / 3.0))
    cams = np.zeros((nc, 18))
    cams[:, :6] = bal.cameras[:, :6]
    cams[:, 6] = bal.cameras[:, 6]
    cams[:, 7] = bal.cameras[:, 6] * (1.0 + 0.01 * rng.normal(size=nc))
    cams[:, 8:10] = 3.0 * rng.normal(size=(nc, 2))
    for i, (mean, sd) in zip(range(10, 18), (
            (-0.28, 0.02), (0.09, 0.01), (0.0, 5e-4), (0.0, 5e-4),
            (-0.012, 0.002), (0.05, 0.01), (0.015, 0.003), (0.002, 5e-4))):
        cams[:, i] = mean + sd * rng.normal(size=nc)
    obs = opencv_project(cams, points, bal.camera_index, bal.point_index)
    obs += OPENCV_PIXEL_NOISE * rng.normal(size=obs.shape)
    prng = np.random.default_rng(8)        # BALProblem.perturb's order
    points += prng.normal(0, IMPLICIT_PERTURB["point_sigma"], points.shape)
    cams[:, 3:6] += prng.normal(0, IMPLICIT_PERTURB["translation_sigma"],
                                (nc, 3))
    cams[:, :3] += prng.normal(0, IMPLICIT_PERTURB["rotation_sigma"],
                               (nc, 3))
    return cams, points, bal.camera_index, bal.point_index, obs


def opencv_problem(mod, T, rot, data, scale=1.0):
    """(problem, camera arrays, point arrays) of opencv_data's `data` in
    package `mod`, the start scaled by `scale`."""
    import numpy as np
    cams, points, cam_idx, pt_idx, obs = data
    functor = opencv_functor(T, rot)
    cam_arrays = [np.array(c) * scale for c in cams]
    pt_arrays = [np.array(p) * scale for p in points]
    problem = mod.Problem()
    for i in range(obs.shape[0]):
        problem.add_residual_block(mod.AutoDiffCostFunction(
            functor(float(obs[i, 0]), float(obs[i, 1])), 2, [18, 3]), None,
            cam_arrays[cam_idx[i]], pt_arrays[pt_idx[i]])
    return problem, cam_arrays, pt_arrays


def loss_levels(n):
    """Each observation's octave level in 0..LOSS_LEVELS - 1."""
    import numpy as np
    return np.random.default_rng(LOSS_LEVEL_SEED).integers(0, LOSS_LEVELS, n)


def loss_path_problem(mod, bal_io, path, scale=1.0, cfg=None):
    """(problem, camera arrays, point arrays) of LOSS_PATHS[path] (or of
    `cfg`, a dict of its form) in package `mod` with its io.bal module:
    the main path's problem (or its quaternion form, Euclidean quaternion
    blocks) under the path's loss, one loss object for every block or one
    a block, the start scaled by `scale`; the package's Snavely functor,
    or quaternion_functor where the path's `functor` is "ceres"."""
    import numpy as np
    cfg = LOSS_PATHS[path] if cfg is None else cfg
    bal = (quaternion_bal(bal_io) if cfg["quaternions"] else
           bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0))
    if not cfg["quaternions"]:
        bal.perturb(**PERTURB, seed=8)
    bal.cameras *= scale
    bal.points *= scale
    if cfg["loss"] == "scaled_huber":
        return bal_io.build_bal_ceres_problem(
            bal, loss=mod.ScaledLoss(mod.HuberLoss(1.0), 0.5),
            use_manifolds=False)
    from importlib import import_module
    snav = import_module(mod.__name__ + ".examples.snavely")
    functor, csize = ((snav.SnavelyReprojectionErrorWithQuaternions, 10)
                      if cfg["quaternions"]
                      else (snav.SnavelyReprojectionError, 9))
    if cfg.get("functor") == "ceres":
        functor = quaternion_functor(
            import_module("torch" if mod.__name__.endswith("_torch")
                          else "jax.numpy"),
            import_module(mod.__name__ + ".rotation"))
    scales = LOSS_LEVEL_SCALE ** loss_levels(bal.num_observations)
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    problem = mod.Problem()
    for i in range(bal.num_observations):
        ox, oy = (float(v) for v in bal.observations[i])
        loss = (mod.HuberLoss(float(scales[i])) if cfg["loss"] == "row_huber"
                else mod.CauchyLoss(2.0 * float(scales[i])))
        problem.add_residual_block(
            mod.AutoDiffCostFunction(functor(ox, oy), 2, [csize, 3]), loss,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return problem, cams, pts


def loss_path_options(mod, path, cfg=None, **extra):
    """LOSS_PATHS[path]'s (or `cfg`'s) options in package `mod`: the main
    path's (bench.py's) with the path's solver, 100 LM iterations at
    most."""
    cfg = LOSS_PATHS[path] if cfg is None else cfg
    kw = dict(linear_solver_type=getattr(
        mod.LinearSolverType, cfg["solver"]),
        preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=100, function_tolerance=1e-6,
        max_linear_solver_iterations=100, use_mixed_precision_solves=True,
        fused_iterations=True)
    kw.update(extra)
    return mod.SolverOptions(**kw)


def slice16_reference():
    """scripts/slice16_reference.json (the JAX package's runs), or {}."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SLICE16_REF_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


# K10's launch counters by tier (ops/implicit.py TIER_COUNTERS): each
# tier's record in the kernels line reads its counter from the
# OPENCV_IMPLICIT run that took it (tier 1 is the path's own; the general
# tier 2 is held to the same solve with the register tiers left out)
K10_TIER_PATHS = {1: "OPENCV_IMPLICIT", 2: "OPENCV_IMPLICIT_GENERAL"}
# K10 on seeded inputs past each of tier 0's bounds (r 4, te 4, tf 16),
# each shape at ne points of k lanes on kf cameras
K10_SEEDED = dict(shapes=((6, 3, 9), (2, 6, 9), (6, 6, 24)), ne=50000,
                  k=5, kf=1024)
# DENOISING mixed with the loss scalars keyed by value (9 buckets): K8
# 7,470 for 741 CG iterations, K9 200 (CHANGES.md)
DENOISE_NINE_BUCKET_LAUNCHES = {"K8 bucket_jtjv": 7470, "K9 group_gram_blocks": 200}


def k10_seeded(ne, k, r, te, tf, kf, seed):
    """Seeded K10 inputs on the card: a fifth of the lanes masked (zero
    rows, lane 0 always real), an SPD-like inverse, v on kf cameras."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mask = (rng.random((ne, k)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    Je = rng.standard_normal((ne, k, r, te)).astype(np.float32) \
        * mask[..., None, None]
    Jf = rng.standard_normal((ne, k, r, tf)).astype(np.float32) \
        * mask[..., None, None]
    a = rng.standard_normal((ne, te, te))
    inv = (np.einsum("nij,nkj->nik", a, a) / te + np.eye(te)).astype(
        np.float32)
    fids = rng.integers(0, kf, (ne, k)).astype(np.int32)
    v = rng.standard_normal(kf * tf).astype(np.float32)
    return tuple(torch.as_tensor(x, device="cuda")
                 for x in (Je, Jf, inv, fids, v))


def k10_res_usage():
    """Registers, spills (local memory) and shared memory of each K10
    instance in the built library (cuobjdump -res-usage), by mangled
    kernel name."""
    from ceres_tpu_torch.ops import _cuda
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(_cuda.build())],
                         capture_output=True, text=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif line.startswith("REG:") and name and "implicit_apply" in name:
            usage[name] = line
    return usage


def slice16_paths(counters, by_path, kernels, smi):
    """Slice 16's phase: K10's tiers against their plain version (the
    comment above K10_SEEDED and OPENCV_IMPLICIT's first linearization),
    OPENCV_IMPLICIT through tier 1 and through the general tier, the
    LOSS_PATHS with their K1 or K5 check, and DENOISING's launches beside
    the 9-bucket grouping's. Adds the new K10, K1 and K5 instances to `kernels`; raises
    once every part has printed its numbers, if one was off its gate."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch import rotation as trot
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.ops import implicit as k10
    from ceres_tpu_torch.ops import lin as k1
    from ceres_tpu_torch.ops import lin_auto as k5
    from ceres_tpu_torch.ops.jet_compile import make_loss_spec
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers import schur_fused
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    fails, t_phase = [], time.time()
    refs = slice16_reference()

    def check(ok, msg):
        print(("  ok: " if ok else "  FAIL: ") + msg, flush=True)
        if not ok:
            fails.append(msg)

    def bits(got, want):
        same = torch.equal(got, want) and torch.equal(
            got.view(torch.int32), want.view(torch.int32))
        err = rel_err(got, want)
        return [(err[0] if same else max(err[0], 1e-30), err[1])]

    def k10_flops(ne, k, r, te, tf):
        # per lane w twice, u, w2, C; per point zz
        return ne * k * r * (6 * tf + 4 * te) + 2 * ne * te ** 2

    usage = k10_res_usage()
    print(f"K10 instances, cuobjdump -res-usage ({smi}):", flush=True)
    for name, line in sorted(usage.items()):
        print(f"  {name}: {line}", flush=True)

    @contextlib.contextmanager
    def k10_forced(tier, scratch_smem=None):
        # the wrapper's tier choice with the register tiers below `tier`
        # left out, and the general tier's scratch capped at scratch_smem
        # bytes of shared memory (0: in device memory)
        held = k10.TIERS, k10.SCRATCH_SMEM_BYTES
        k10.TIERS = {t: m for t, m in held[0].items() if t >= tier}
        k10.SCRATCH_SMEM_BYTES = scratch_smem
        try:
            yield
        finally:
            k10.TIERS, k10.SCRATCH_SMEM_BYTES = held

    def k10_launches(r, te, tf):
        # (tier, scratch_smem) of every launch that holds the shape
        return ([(t, None) for t, m in k10.TIERS.items()
                 if all(x <= y for x, y in zip((r, te, tf), m))]
                + [(k10.GENERAL_TIER, None), (k10.GENERAL_TIER, 0)])

    def check_k10(label, args, tier, scratch_smem, record=False):
        Je, Jf, inv, fids, v = args
        ne, k, r, te = Je.shape
        tf = Jf.shape[-1]
        where = "" if scratch_smem is None else ", scratch in device memory"
        with k10_forced(tier, scratch_smem):
            plan = k10.implicit_plan(ne, k, r, te, tf, v.numel() // tf)
            check(plan["tier"] == tier, f"K10 takes tier {tier} at "
                  f"{(r, te, tf)}{where}")
            rec = check_kernel(
                f"K10 implicit_apply (tier {tier}{where}, {label}, "
                f"(r, te, tf) = {(r, te, tf)})",
                lambda: k10.implicit_apply(*args),
                lambda: k10.implicit_apply_plain(*args), bits, K10_LIMIT,
                "ceres_tpu_torch/csrc/implicit.cu",
                "ceres_tpu/ops/pallas_implicit.py:49", args,
                k10_flops(ne, k, r, te, tf), F32_FLOP_PER_S)
        where = ("staged in shared memory" if plan["stage"]
                 else "read from device memory")
        print(f"  plan: {plan['threads']} threads a block, v {where}, "
              f"{plan['smem']} B of shared memory"
              + (f", scratch {plan['scratch_floats']} floats x "
                 f"{plan['scratch_blocks']} blocks in device memory"
                 if plan["scratch_floats"] else ""), flush=True)
        rec["plan"] = plan
        if record:
            rec["name"] = f"K10 implicit_apply (tier {tier})"
            rec["counter"] = f"K10 implicit_apply (tier {tier})"
            MAIN_PATH[rec["name"]] = K10_TIER_PATHS[tier]
            kernels.append(rec)
        return rec

    # ---- K10 on seeded inputs past each old bound ----
    for r, te, tf in K10_SEEDED["shapes"]:
        args = k10_seeded(K10_SEEDED["ne"], K10_SEEDED["k"], r, te, tf,
                          K10_SEEDED["kf"], seed=r * 100 + te * 10 + tf)
        for tier, scratch_smem in k10_launches(r, te, tf):
            check_k10("seeded", args, tier, scratch_smem)
        del args

    # ---- OPENCV_IMPLICIT ----
    t0 = time.time()
    data = opencv_data(bal_io)
    problem, cams, pts = opencv_problem(ctt, torch, trot, data)
    arrays = cams + pts
    start = [a.copy() for a in arrays]
    ref = refs.get("OPENCV_IMPLICIT", {})
    runs = ref.get("runs", [])
    cap = math.ceil(OPENCV_CAP_HEADROOM * max([r_["lm"] for r_ in runs]
                                              or [0]))
    options = large_options(ctt, device="cuda", max_num_iterations=cap)
    program = CompiledProgram.get_cached(problem, options)
    meta = detect_schur_structure(program, options)
    step = schur_fused.schur_step(program, options, meta)
    bk = program.buckets[0]
    print(f"OPENCV_IMPLICIT: data and problem {time.time() - t0:.1f} s; "
          f"ne={meta.ne} kf={step.kf} nf={step.nf} (r, te, tf) = "
          f"{(bk.r, step.te, step.tf)}; {step.mode}; K11 "
          f"{bk.spec.name if bk.spec is not None else 'none (jacfwd)'}",
          flush=True)
    check(isinstance(step, schur_fused.ImplicitSchurStep) and step.k10
          and (bk.r, step.te, step.tf) == (2, 3, 18),
          "OPENCV_IMPLICIT runs the implicit step with K10 at (2, 3, 18)")
    x0 = program.initial_state()
    art = step.linearize(x0, *step.initial_scales(), first=True,
                         known_cost=step.cost(x0))
    inv = step.damped_inverse(art, torch.tensor(
        RADIUS, dtype=torch.float32, device="cuda"))
    _, Je_s, Jf_s, plan0 = step.scaled_chunks(art)[0]
    args = (Je_s, Jf_s, inv, plan0.fids32, torch.as_tensor(
        np.random.default_rng(2).standard_normal(step.nf),
        dtype=torch.float32, device="cuda"))
    for tier, scratch_smem in k10_launches(bk.r, step.te, step.tf):
        check_k10("OPENCV_IMPLICIT's first linearization", args, tier,
                  scratch_smem, record=scratch_smem is None)
    del art, inv, Je_s, Jf_s, plan0, args

    apps = [0]
    cg = schur_fused.conjugate_gradients

    def counting_cg(apply_A, *a, **kw):
        def counted(v):
            apps[0] += 1
            return apply_A(v)
        return cg(counted, *a, **kw)

    costs = [r_["final_cost"] for r_ in runs]
    ref_cost = costs[0] if costs else None
    tol = (2.0 * (max(costs) - min(costs)) / ref_cost if costs else None)
    if costs:
        print(f"OPENCV_IMPLICIT: the JAX package on the CPU from starts x "
              f"{[r_['scale'] for r_ in runs]}: "
              f"{[(r_['lm'], r_['linear']) for r_ in runs]} LM / CG "
              f"iterations to {costs} ({[r_['termination'] for r_ in runs]}"
              f"); gate {tol:.3e} of {ref_cost!r}; LM cap {cap}", flush=True)
    else:
        check(False, "OPENCV_IMPLICIT has its JAX reference "
              f"({SLICE16_REF_FILE})")
    seen = {}
    schur_fused.conjugate_gradients = counting_cg
    try:
        for path, tier in (("OPENCV_IMPLICIT", 1),
                           ("OPENCV_IMPLICIT_GENERAL", k10.GENERAL_TIER)):
            for a, a0 in zip(arrays, start):
                a[:] = a0
            for fn in list(counters.values()) + k10.TIER_COUNTERS:
                fn.launches = 0
            apps[0] = 0
            torch.cuda.synchronize()
            t0 = time.time()
            with k10_forced(tier):
                s_ = ctt.solve(options, problem)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launched = {n: fn.launches for n, fn in counters.items()}
            for t, fn in enumerate(k10.TIER_COUNTERS):
                launched[f"K10 implicit_apply (tier {t})"] = fn.launches
            by_path[path] = launched
            print(f"{path}: {s_.termination_type}, {lm_iterations(s_)} LM "
                  f"({s_.num_successful_steps} accepted), "
                  f"{s_.num_linear_solver_iterations} CG iterations, "
                  f"{apps[0]} CG applications, initial cost "
                  f"{s_.initial_cost!r}, final cost {s_.final_cost!r}, wall "
                  f"{wall:.4f} s ({smi}), launches "
                  f"{ {n: c for n, c in launched.items() if c} }", flush=True)
            check(s_.is_solution_usable(), f"{path} usable")
            check(launched["K10 implicit_apply"] == apps[0] > 0 and
                  launched[f"K10 implicit_apply (tier {tier})"] == apps[0],
                  f"{path}: K10 (tier {tier}) once a CG application")
            if ref_cost is not None:
                check(abs(s_.final_cost - ref_cost) <= tol * ref_cost,
                      f"{path} final cost within {tol:.3e} of JAX")
            seen[path] = (s_.num_iterations, s_.num_linear_solver_iterations,
                          s_.final_cost)
    finally:
        schur_fused.conjugate_gradients = cg
    check(len(set(seen.values())) == 1,
          f"the general tier's solve repeats tier 1's counts and cost bits: "
          f"{seen}")
    del problem, program, step, data, arrays, start, cams, pts

    # ---- LOSSES ----
    for path, cfg in LOSS_PATHS.items():
        t0 = time.time()
        problem, cams, pts = loss_path_problem(ctt, bal_io, path)
        arrays = cams + pts
        start = [a.copy() for a in arrays]
        options = loss_path_options(ctt, path, device="cuda")
        program = CompiledProgram.get_cached(problem, options)
        meta = detect_schur_structure(program, options)
        step = schur_fused.schur_step(program, options, meta)
        bk = program.buckets[0]
        print(f"{path}: problem and step {time.time() - t0:.1f} s; "
              f"{len(program.buckets)} bucket(s), loss "
              f"{type(bk.loss_proto).__name__}, per-row scalars "
              f"{sorted(bk.loss_attrs) if bk.loss_attrs else None}; "
              f"{step.mode}", flush=True)
        per_row = cfg["loss"].startswith("row_")
        check(len(program.buckets) == 1 and (step.loss_rows is not None)
              == per_row, f"{path}: one bucket, per-row scalars {per_row}")
        # the linearize kernel at the start, against its plain version;
        # each output's limit F32_LIMIT or twice the plain version's own
        # distance from its f64 run, as K1's loss instances' check
        x0 = program.initial_state()
        ne = step.ne
        lin_in = (x0[step.f_slab:step.f_slab + step.nf].float(),
                  step.point_state(x0).float().contiguous(), step.cam,
                  step.mask, step.dat,
                  torch.ones(ne, step.te, device="cuda"))
        rows = step.loss_rows

        def as64(t):
            return None if t is None else t.double()
        if step.k5 is None:
            def kern(a=lin_in, lr=rows):
                return k1.lin(*a, True, True, step.loss, step.plan, lr)

            def plain(a=lin_in, lr=rows):
                return k1.lin_plain(*a[:4], a[4][..., 0], a[4][..., 1],
                                    a[5], True, True, step.loss, lr)
            how = "per-row scalars" if per_row else "generated loss unit"
            name, counter = f"K1 lin ({how}, {path})", "K1 lin"
            flops = (516 + 55) * program.num_residual_blocks
            source = "ceres_tpu_torch/csrc/lin_k1.cuh"
            replaces = "ceres_tpu/ops/pallas_lin.py:66"
        else:
            def kern(a=lin_in, lr=rows):
                return k5.lin_auto(step.k5, *a, True, True, step.loss,
                                   step.plan, lr)

            def plain(a=lin_in, lr=rows):
                return k5.lin_auto_plain(step.k5, *a, True, True, step.loss,
                                         lr)
            name, counter = f"K5 lin_auto (per-row scalars, {path})", \
                "K5 lin_auto"
            chain_ops = sum(1 for ln in k5.chain_source(
                step.k5, make_loss_spec(step.loss)).splitlines()
                if ln.lstrip().startswith("const "))
            flops = chain_ops * program.num_residual_blocks
            source = "ceres_tpu_torch/csrc/lin_auto.cuh"
            replaces = "ceres_tpu/ops/pallas_lin.py:272"
        lin64 = tuple(t.double() if t.is_floating_point() else t
                      for t in lin_in)
        want32 = plain()
        want64 = plain(lin64, as64(rows))
        own = [rel_err(want32[k], want64[k])[0] for k in want32]
        got = kern()
        mine = [rel_err(got[k], want64[k])[0] for k in want32]
        print(f"{name}: the plain version (f32) from its f64 run "
              f"{', '.join(f'{e:.3e}' for e in own)}; the kernel from the "
              f"f64 run {', '.join(f'{e:.3e}' for e in mine)}", flush=True)
        rec = check_kernel(
            name, kern, plain,
            lambda g_, w: [rel_err(g_[k], w[k]) for k in w],
            [max(F32_LIMIT, 2.0 * e) for e in own], source, replaces,
            lin_in + ((rows,) if rows is not None else ()), flops,
            F32_FLOP_PER_S)
        rec["counter"] = counter
        MAIN_PATH[name] = path
        kernels.append(rec)
        del want32, want64, got, lin64

        ref_run = refs.get(path, {}).get("runs", [{}])[0]
        want_cost, ref_lm = ref_run.get("final_cost"), ref_run.get("lm")
        lin_k = "K1 lin" if step.k5 is None else "K5 lin_auto"
        runs_k = ((lin_k, "K2 elim", "K3 chol_solve", "K4 cost")
                  if step.k5 is None else (lin_k, "K6 elim_v1",
                                           "K7 dense_pcg"))
        gen0 = k1.lin.generated_launches
        lins = [0]
        linearize = schur_fused.FusedSchurStep.linearize

        def counted(self, *a, **kw):
            lins[0] += 1
            return linearize(self, *a, **kw)

        def reset(a_=arrays, s0=start):
            for a, a0 in zip(a_, s0):
                a[:] = a0
            lins[0] = 0

        def gate(summary, launches, path=path, runs_k=runs_k, lin_k=lin_k):
            print(f"  {path}: the JAX package on the CPU {ref_lm} LM "
                  f"iterations to {want_cost!r}; here "
                  f"{lm_iterations(summary)}; {lins[0]} linearizations, "
                  f"{launches[lin_k]} {lin_k} launches", flush=True)
            short = [n for n in runs_k if launches[n] <= 0]
            if short:
                raise SystemExit(f"{path}: kernels not launched: {short}")
            if launches[lin_k] != lins[0]:
                raise SystemExit(f"{path}: {lin_k} launched "
                                 f"{launches[lin_k]} times for {lins[0]} "
                                 f"linearizations")
        if ref_run.get("termination") != "CONVERGENCE":
            check(False, f"{path} has a converged JAX reference "
                  f"({SLICE16_REF_FILE}: {ref_run.get('termination')})")
            continue
        schur_fused.FusedSchurStep.linearize = counted
        try:
            by_path[path] = drive(path, options, problem, reset, counters, 2,
                                  gate, ref_cost=want_cost,
                                  ref_tol=LOSS_REL_TOL)
        except SystemExit as e:
            check(False, str(e))
        finally:
            schur_fused.FusedSchurStep.linearize = linearize
        if cfg["loss"] == "scaled_huber":
            check(k1.lin.generated_launches > gen0,
                  f"{path}: K1 through its generated loss unit")
        del problem, program, step, arrays, start

    # ---- DENOISING ----
    den = by_path.get("DENOISING_MIXED", {})
    print(f"DENOISING mixed, the JAX package's bucket count: K8 "
          f"{den.get('K8 bucket_jtjv')} and K9 "
          f"{den.get('K9 group_gram_blocks')} launches (9 buckets: "
          f"{DENOISE_NINE_BUCKET_LAUNCHES['K8 bucket_jtjv']} and "
          f"{DENOISE_NINE_BUCKET_LAUNCHES['K9 group_gram_blocks']})", flush=True)
    print(f"slice16_paths: {time.time() - t_phase:.1f} s", flush=True)
    if fails:
        raise SystemExit(f"slice16_paths: {len(fails)} check(s) failed: "
                         f"{fails}")


def main():
    import numpy as np
    import torch
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.ops import _cuda
    from ceres_tpu_torch.ops.cost import snavely_sq, snavely_sq_plain
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.ops.kernels import (
        _chol_launch, bucket_gram_blocks,
        bucket_gram_blocks_plain, bucket_jtjv, bucket_jtjv_plain, chol_solve,
        chol_solve_plain, gram_sum, group_gram_blocks,
        group_gram_blocks_plain)
    from ceres_tpu_torch.ops.implicit import (implicit_apply,
                                              implicit_apply_plain)
    from ceres_tpu_torch.ops.linearize import (
        bucket_linearize, bucket_linearize_auto, bucket_linearize_auto_plain,
        bucket_linearize_plain, build_auto)
    from ceres_tpu_torch.ops.jet_compile import AutoSpec, row_chain_source
    from ceres_tpu_torch.ops.lin import (elim, elim_plain, elim_v1,
                                         elim_v1_plain, lin, lin_plain)
    from ceres_tpu_torch.ops import lin_auto as k5
    from ceres_tpu_torch.ops.jet_compile import make_loss_spec
    from ceres_tpu_torch.ops.pcg import dense_pcg, dense_pcg_plain
    from ceres_tpu_torch.minimizers.fused import run_fused
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers import schur_fused
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_fused import (FusedSchurStep,
                                                     ImplicitSchurStep,
                                                     schur_step)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {kind}", flush=True)

    t0 = time.time()
    _cuda.library()
    print(f"kernel build: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    from ceres_tpu_torch import native
    native.library()
    print(f"native library build (g++, csrc/ceres_native.cpp): "
          f"{time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    problem, cams, pts = build_bal_ceres_problem(bal)
    cam0 = [c.copy() for c in cams]
    pt0 = [p.copy() for p in pts]

    def reset_state():
        for c, c0 in zip(cams, cam0):
            c[:] = c0
        for p, p0 in zip(pts, pt0):
            p[:] = p0
    common = dict(
        preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50, function_tolerance=1e-6,
        max_linear_solver_iterations=100, use_mixed_precision_solves=True,
        fused_iterations=True, device="cuda")
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR, **common)
    it_options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR, **common)
    program = CompiledProgram.get_cached(problem, options)
    meta = detect_schur_structure(program, options)
    step = FusedSchurStep(program, options, meta)
    it_step = FusedSchurStep(program, it_options, meta)
    print(f"problem build: {time.time() - t0:.1f} s; ne={step.ne} "
          f"k={step.cam.shape[1]} kf={step.kf} nf={step.nf}", flush=True)

    # ---- kernels against their plain versions, at main-path shapes ----
    x0 = program.initial_state()
    ne, nf, kf = step.ne, step.nf, step.kf
    nobs = SHAPE["num_observations"]
    xe = x0[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x0[step.f_slab:step.f_slab + nf].float()
    se0, sf0 = step.initial_scales()

    def k1(args):        # K1 with the step's camera plan, as the step calls it
        return lambda: lin(*args, plan=step.plan)

    def k1_plain(args):  # lin_plain takes the observations apart
        return lambda: lin_plain(*args[:4], args[4][..., 0], args[4][..., 1],
                                 *args[5:])

    lin_first = (xf, xe, step.cam, step.mask, step.dat, se0, True)
    se1 = k1(lin_first)()["se"]
    lin_carry = lin_first[:5] + (se1, False)
    # K1 operations counted: the Gram, cross and gradient products per
    # observation (E^T E 36, g_e 12, A 108, F^T F 324, g_f 36); the
    # residual and Jacobian arithmetic is left out, so this is a floor
    lin_flops = 516 * nobs

    def cmp_lin(got, want):
        return [rel_err(got[k], want[k]) for k in want]

    def cmp_all(got, want):
        return [rel_err(a, b) for a, b in zip(got, want)]

    def check_k4(name, step_, x):
        """K4 on a step's bound inputs at state x: inputs the state's
        points and cameras, each row's indices and observations."""
        k4 = step_.k4
        return check_kernel(
            name, lambda: snavely_sq(x, k4), lambda: snavely_sq_plain(x, k4),
            lambda g, w: [rel_err(g, w)], F64_LIMIT,
            "ceres_tpu_torch/csrc/cost.cu",
            "ceres_tpu/ops/pallas_cost.py:147",
            (x[k4.e_slab:k4.e_slab + 3 * k4.ne],
             x[k4.f_slab:k4.f_slab + 9 * k4.kf], k4.pt_idx, k4.cam_idx,
             k4.obsx, k4.obsy),
            60 * k4.n, F64_FLOP_PER_S)     # rotation, projection, ||r||^2

    def check_k9_group(name, jac_s, grp):
        """K9's group kernel on one group of a scaled Jacobian against
        its plain form (the slots' einsums summed in the group's order)
        within F32_LIMIT; against the unfused CUDA route it replaced (the
        per-row form a slot, then a gather and CUB's segmented reduce in
        the same order) and the per-row outputs summed in the group's
        order on the host's terms (+0, then each contribution), reporting
        which entries differ; timed beside that route."""
        views = [jac_s.buckets[bi].slot_J(si)
                 for (bi, si, _) in grp.bucket_slots]
        gmap, goff = grp.gram_order(views[0].device)

        def unfused():
            return gram_sum([bucket_gram_blocks(J) for J in views], gmap,
                            goff)
        rows = [bucket_gram_blocks(J) for J in views]
        base = np.cumsum([0] + [R.shape[0] for R in rows])
        pos = torch.as_tensor(base, device=gmap.device)[gmap[:, 0].long()] \
            + gmap[:, 1]
        rows = torch.cat(rows)
        lengths = torch.diff(goff).long()
        in_order = torch.zeros(grp.num_blocks, grp.tangent_size,
                               grp.tangent_size, device=rows.device)
        starts = goff[:-1].long()
        for j in range(int(lengths.max())):
            take = (lengths > j)[:, None, None]
            at = pos[torch.clamp(starts + j, max=len(pos) - 1)]
            in_order = in_order + torch.where(take, rows[at], 0.0)
        got = group_gram_blocks(views, gmap, goff)
        torch.cuda.synchronize()
        for label, other in (("the unfused CUDA route", unfused()),
                             ("the per-row outputs summed in order",
                              in_order)):
            differ = int((got.view(torch.int32)
                          != other.view(torch.int32)).sum())
            print(f"{name} vs {label}: {differ} of {got.numel()} entries "
                  f"differ in their bits (max abs diff "
                  f"{float((got - other).abs().max()):.3e})", flush=True)
        n_rows = sum(J.shape[0] for J in views)
        rec = check_kernel(
            name, lambda: group_gram_blocks(views, gmap, goff),
            lambda: group_gram_blocks_plain(views, gmap, goff),
            lambda g_, w: [rel_err(g_, w)], F32_LIMIT,
            "ceres_tpu_torch/csrc/gram.cu",
            "ceres_tpu/ops/pallas_kernels.py:289", views,
            2 * sum(J.shape[0] * J.shape[1] for J in views)
            * grp.tangent_size ** 2 + n_rows * grp.tangent_size ** 2,
            F32_FLOP_PER_S,
            reference=("the per-slot route it replaced (per-row K9 a slot, "
                       "then a gather and a segmented reduce)", unfused))
        rec["interleaved"] = interleaved(
            f"{name} vs the per-slot route",
            lambda: group_gram_blocks(views, gmap, goff),
            unfused, label="per-slot")
        return rec

    kernels = []
    kernels.append(check_kernel(
        "K1 lin", k1(lin_first), k1_plain(lin_first), cmp_lin, F32_LIMIT,
        "ceres_tpu_torch/csrc/lin.cu", "ceres_tpu/ops/pallas_lin.py:66",
        lin_first, lin_flops, F32_FLOP_PER_S))
    check_kernel(      # the carried-scale branch of the same kernel
        "K1 lin (carried scale)", k1(lin_carry), k1_plain(lin_carry),
        cmp_lin, F32_LIMIT,
        "ceres_tpu_torch/csrc/lin.cu", "ceres_tpu/ops/pallas_lin.py:66",
        lin_carry, lin_flops, F32_FLOP_PER_S)
    # K1's loss instances on the same first linearization: the Triggs
    # corrector in the chain adds ~55 operations an observation (the loss,
    # r^T J over 12 channels, the corrected J and r), counted with the
    # rest. A loss weights the inliers' small residuals up against the
    # outliers, so an output's largest entry shrinks and f32 rounding
    # weighs more beside it: the plain version itself lies up to ~2e-5 of
    # its largest entry from the same plain version run in f64 on these
    # inputs (CPU run, PR 13). Each output's limit is F32_LIMIT, or twice
    # the plain version's own distance from its f64 run where that is
    # larger, measured here on these inputs; the kernel's distance from
    # the f64 run is printed too.
    lin64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
             else a for a in lin_first]
    for cfg in ROBUST_PATHS.values():
        loss = getattr(ctt, cfg["loss"])(cfg["a"])
        name = f"K1 lin ({cfg['loss']}({cfg['a']}))"
        lin_loss = lin_first + (True, loss)
        want32 = k1_plain(lin_loss)()
        want64 = k1_plain(tuple(lin64) + (True, loss))()
        got = k1(lin_loss)()
        own = [rel_err(want32[k], want64[k])[0] for k in want32]
        mine = [rel_err(got[k], want64[k])[0] for k in want32]
        print(f"{name}: the plain version (f32) from its f64 run "
              f"{', '.join(f'{e:.3e}' for e in own)}; the kernel from the "
              f"f64 run {', '.join(f'{e:.3e}' for e in mine)}", flush=True)
        kernels.append(check_kernel(
            name, k1(lin_loss), k1_plain(lin_loss), cmp_lin,
            [max(F32_LIMIT, 2.0 * e) for e in own],
            "ceres_tpu_torch/csrc/lin.cu", "ceres_tpu/ops/pallas_lin.py:66",
            lin_first, (516 + 55) * nobs, F32_FLOP_PER_S))
        kernels[-1]["counter"] = "K1 lin"
        del want32, want64, got

    cost0 = step.cost(x0)
    art = step.linearize(x0, se0, sf0, True, known_cost=cost0)
    elim_args = (art.A, art.etes, art.gse, art.diag_e, RADIUS)
    kernels.append(check_kernel(
        "K2 elim", lambda: elim(*elim_args), lambda: elim_plain(*elim_args),
        cmp_all, F32_LIMIT,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:424",
        elim_args[:4], scorr_flops(ne, nf) + INV_Z_FLOPS[3] * ne,
        F32_FLOP_PER_S,
        reference=scorr_gemm(art.A, elim_plain(*elim_args)[2])))
    kernels[-1]["interleaved"] = interleaved(
        "K2 elim vs its plain version", lambda: elim(*elim_args),
        lambda: elim_plain(*elim_args), label="plain")

    S, rhs, _, _ = step.reduced_system(art, RADIUS)
    kernels.append(check_kernel(
        "K3 chol_solve", lambda: chol_solve(S, rhs),
        lambda: chol_solve_plain(S, rhs), lambda g, w: [rel_err(g, w)],
        K3_LIMIT, "ceres_tpu_torch/csrc/chol.cu",
        "ceres_tpu/ops/pallas_kernels.py:190", (S, rhs),
        nf ** 3 / 3 + 2 * nf * nf, F32_FLOP_PER_S,
        library=("torch.linalg.solve(S, rhs)",
                 lambda: torch.linalg.solve(S, rhs))))
    kernels[-1]["interleaved"] = interleaved(
        "K3 chol_solve vs torch.linalg.solve", lambda: chol_solve(S, rhs),
        lambda: torch.linalg.solve(S, rhs))
    # the global-scratch variant, past the shared-memory edge
    gen = torch.Generator(device="cuda").manual_seed(K3_GLOBAL_M)
    Bg = torch.randn(K3_GLOBAL_M, K3_GLOBAL_M + 4, device="cuda",
                     generator=gen)
    k3g = (Bg @ Bg.T + K3_GLOBAL_M * torch.eye(K3_GLOBAL_M, device="cuda"),
           torch.randn(K3_GLOBAL_M, device="cuda", generator=gen))
    check_kernel(
        f"K3 chol_solve (global variant, seeded SPD m {K3_GLOBAL_M})",
        lambda: _chol_launch(*k3g, "global"),
        lambda: chol_solve_plain(*k3g),
        lambda g_, w: [rel_err(g_, w)], K3_LIMIT,
        "ceres_tpu_torch/csrc/chol.cu",
        "ceres_tpu/ops/pallas_kernels.py:190", k3g,
        K3_GLOBAL_M ** 3 / 3 + 2 * K3_GLOBAL_M ** 2, F32_FLOP_PER_S,
        library=("torch.linalg.solve(S, rhs)",
                 lambda: torch.linalg.solve(*k3g)))

    kernels.append(check_k4("K4 cost", step, x0))
    c_ref = program.cost_fn(x0)
    c_rel = abs(float(cost0) - float(c_ref)) / abs(float(c_ref))
    print(f"K4 total cost {float(cost0):.10e} vs program.cost_fn "
          f"{float(c_ref):.10e}: rel {c_rel:.3e} (limit {F64_LIMIT:.0e})")
    if not c_rel <= F64_LIMIT:
        raise SystemExit("K4 cost disagrees with program.cost_fn")

    # ---- slice 2: K6 and K7 on the ITERATIVE_SCHUR step's inputs ----
    rad = torch.tensor(RADIUS, dtype=torch.float32, device="cuda")
    inv, z = it_step.point_inverse(art, rad)
    kernels.append(check_kernel(
        "K6 elim_v1", lambda: elim_v1(art.A, inv, z),
        lambda: elim_v1_plain(art.A, inv, z), cmp_all, F32_LIMIT,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:387",
        (art.A, inv, z), scorr_flops(ne, nf), F32_FLOP_PER_S,
        reference=scorr_gemm(art.A, inv)))
    kernels[-1]["interleaved"] = interleaved(
        "K6 elim_v1 vs its plain version", lambda: elim_v1(art.A, inv, z),
        lambda: elim_v1_plain(art.A, inv, z), label="plain")

    S_it, rhs_it, _, _ = it_step.reduced_system(art, RADIUS)
    minv = it_step.precond_inverse(art, S_it, rad)
    pcg_kw = it_step.pcg_args
    reset = 10                          # dense_pcg's residual_reset_period

    def cmp_pcg(label):
        def cmp(got, want):
            print(f"{label}: CG iterations kernel {int(got[1])}, plain "
                  f"{int(want[1])}; final ||r|| kernel {float(got[2]):.4e},"
                  f" plain {float(want[2]):.4e}", flush=True)
            if int(got[1]) != int(want[1]):
                raise SystemExit(f"{label}: CG iteration counts differ")
            return [rel_err(got[0], want[0])]
        return cmp

    kernels.append(check_kernel(
        "K7 dense_pcg", lambda: dense_pcg(S_it, rhs_it, minv, **pcg_kw),
        lambda: dense_pcg_plain(S_it, rhs_it, minv, **pcg_kw),
        cmp_pcg("K7 dense_pcg"), PCG_LIMIT,
        "ceres_tpu_torch/csrc/pcg.cu", "ceres_tpu/ops/pallas_pcg.py:46",
        (S_it, rhs_it, minv),
        lambda got: pcg_flops(nf, 9, int(got[1]), reset), F32_FLOP_PER_S,
        reference=("torch.linalg.solve(S, rhs) (an exact solve: another "
                   "function, timed as a yardstick)",
                   lambda: torch.linalg.solve(S_it, rhs_it))))
    check_kernel(      # the IDENTITY preconditioner of the same kernel
        "K7 dense_pcg (IDENTITY)",
        lambda: dense_pcg(S_it, rhs_it, None, **pcg_kw),
        lambda: dense_pcg_plain(S_it, rhs_it, None, **pcg_kw),
        cmp_pcg("K7 dense_pcg (IDENTITY)"), PCG_LIMIT,
        "ceres_tpu_torch/csrc/pcg.cu", "ceres_tpu/ops/pallas_pcg.py:46",
        (S_it, rhs_it), lambda got: pcg_flops(nf, 0, int(got[1]), reset),
        F32_FLOP_PER_S)
    # a later system of the ITERATIVE_SCHUR solve, the first that runs past
    # the refresh at `reset` iterations: every K7 system of one solve,
    # captured at the step's call (then the arrays are set back)
    systems = []

    def capture(S, b, minv_blocks, **kw):
        out = dense_pcg(S, b, minv_blocks, **kw)
        systems.append((S.clone(), b.clone(), minv_blocks.clone(),
                        int(out[1])))
        return out
    schur_fused.dense_pcg = capture
    try:
        ctt.solve(it_options, problem)
    finally:
        schur_fused.dense_pcg = dense_pcg
    reset_state()
    k_late = next(k for k, s in enumerate(systems) if s[3] > reset)
    S_late, rhs_late, minv_late, _ = systems[k_late]
    check_kernel(
        f"K7 dense_pcg (ITERATIVE_SCHUR system {k_late} of {len(systems)}, "
        f"past the refresh)",
        lambda: dense_pcg(S_late, rhs_late, minv_late, **pcg_kw),
        lambda: dense_pcg_plain(S_late, rhs_late, minv_late, **pcg_kw),
        cmp_pcg(f"K7 dense_pcg (system {k_late})"), PCG_LIMIT,
        "ceres_tpu_torch/csrc/pcg.cu", "ceres_tpu/ops/pallas_pcg.py:46",
        (S_late, rhs_late, minv_late),
        lambda got: pcg_flops(nf, 9, int(got[1]), reset), F32_FLOP_PER_S)
    del systems, S_late, rhs_late, minv_late

    # ---- slice 3: K11 and K8 on the pose graphs' main buckets ----
    graphs = {}
    for key, spec in POSE_GRAPHS.items():
        t0 = time.time()
        poses, constraints, gt = getattr(g2o, spec["generator"])(
            **spec["args"])
        g_problem, positions, rotations = getattr(slam, spec["build"])(
            poses, constraints)
        g_options = pose_graph_options(ctt, device="cuda")
        g_program = CompiledProgram.get_cached(g_problem, g_options)
        main_bi = [i for i, bk in enumerate(g_program.buckets)
                   if bk.spec is not None]
        if len(main_bi) != 1:
            raise SystemExit(f"pose graph {key}: {len(main_bi)} buckets "
                             "take K11, expected 1")
        arrays = list(positions.values()) + list(rotations.values())
        graphs[key] = dict(
            problem=g_problem, options=g_options, program=g_program,
            bi=main_bi[0], positions=positions, rotations=rotations,
            gt=gt, arrays=arrays,
            start=[a.copy() for a in arrays],
            error0=position_error(positions, gt))
        print(f"pose graph {key}: {len(poses)} poses, {len(constraints)} "
              f"edges, bucket rows {[bk.n for bk in g_program.buckets]}, "
              f"{g_program.num_effective} tangent parameters; build "
              f"{time.time() - t0:.1f} s", flush=True)

    def k11_args(g, x):
        prog, bk = g["program"], g["program"].buckets[g["bi"]]
        xin = torch.cat([p.float() for p in prog._bucket_params(bk, x)],
                        dim=1).contiguous()
        return bk.spec, xin, bk.dat32

    def cmp_k11(got, want):
        return [rel_err(got[0], want[0]), rel_err(got[1], want[1])]

    k11_points = [("3d", "at the start", 0.0), ("3d", "perturbed", 0.05),
                  ("2d", "at the start", 0.0)]
    for key, where, sigma in k11_points:
        g = graphs[key]
        x = g["program"].initial_state()
        if sigma:
            x = x + sigma * torch.as_tensor(
                np.random.default_rng(0).standard_normal(x.shape[0]),
                device=x.device)
        args = k11_args(g, x)
        n = args[1].shape[0]
        rec = check_kernel(
            f"K11 bucket_linearize ({key.upper()}, {where})",
            lambda: bucket_linearize(*args),
            lambda: bucket_linearize_plain(*args), cmp_k11,
            [K11_R_LIMIT, K11_J_LIMIT], "ceres_tpu_torch/csrc/linearize.cu",
            "ceres_tpu/ops/pallas_linearize.py:324", args[1:],
            K11_FLOPS_PER_ROW[key] * n, F32_FLOP_PER_S)
        if (key, sigma) == ("3d", 0.0):
            rec["name"] = "K11 bucket_linearize"
            kernels.append(rec)

    for key in POSE_GRAPHS:
        g = graphs[key]
        _, _, jac, _ = g["program"].linearize_fn_mixed(
            g["program"].initial_state())
        jac_s = jac.scale_columns(
            1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
        J = jac_s.buckets[g["bi"]].J
        cols = jac_s.buckets[g["bi"]].cols32
        v = torch.as_tensor(np.random.default_rng(1).standard_normal(
            jac.num_cols), dtype=torch.float32, device=J.device)
        vb = jac_s.buckets[g["bi"]].gather_cols(v).contiguous()
        n, r, t = J.shape
        # no one PyTorch call gathers and multiplies, so K8 has no library
        # call; the einsum on the gathered vb is another function (it
        # leaves the gather out), timed as a yardstick
        rec = check_kernel(
            f"K8 bucket_jtjv ({key.upper()})",
            lambda: bucket_jtjv(J, v, cols),
            lambda: bucket_jtjv_plain(J, v, cols),
            lambda g_, w: [rel_err(g_, w)],
            F32_LIMIT, "ceres_tpu_torch/csrc/jtjv.cu",
            "ceres_tpu/ops/pallas_kernels.py:111", (J, v, cols),
            4 * n * r * t, F32_FLOP_PER_S,
            reference=("torch.einsum('nrt,nru,nu->nt', J, J, vb) on a "
                       "pre-gathered vb",
                       lambda: torch.einsum("nrt,nru,nu->nt", J, J, vb)))
        if key == "3d":
            rec["name"] = "K8 bucket_jtjv"
            kernels.append(rec)
            # per-row K9 on each slot view of the same scaled Jacobian,
            # read in place (the TPU kernel's contract)
            for si in range(len(jac_s.buckets[g["bi"]].cols)):
                Js = jac_s.buckets[g["bi"]].slot_J(si)
                ns, rs, ts = Js.shape
                check_kernel(
                    f"K9 bucket_gram_blocks (per row, SE3 slot {si})",
                    lambda: bucket_gram_blocks(Js),
                    lambda: bucket_gram_blocks_plain(Js),
                    lambda g_, w: [rel_err(g_, w)], F32_LIMIT,
                    "ceres_tpu_torch/csrc/gram.cu",
                    "ceres_tpu/ops/pallas_kernels.py:289", (Js,),
                    2 * ns * rs * ts * ts, F32_FLOP_PER_S,
                    library=("torch.einsum('nrt,nru->ntu', J, J)",
                             lambda: torch.einsum("nrt,nru->ntu", Js, Js)))
        if key == "3d":
            # slice 8: K9's per-row form on each whole bucket of the same
            # scaled Jacobian, as the mixed SPARSE_NORMAL_CHOLESKY step
            # forms its Grams (solvers/sparse_direct.py bucket_grams)
            for bi, bkj in enumerate(jac_s.buckets):
                Jb = bkj.J
                nb, rb, tb = Jb.shape
                rec = check_kernel(
                    f"K9 bucket_gram_blocks (per row, SE3 bucket {bi}, "
                    f"{nb} x {rb} x {tb})",
                    lambda: bucket_gram_blocks(Jb),
                    lambda: bucket_gram_blocks_plain(Jb),
                    lambda g_, w: [rel_err(g_, w)], F32_LIMIT,
                    "ceres_tpu_torch/csrc/gram.cu",
                    "ceres_tpu/ops/pallas_kernels.py:289", (Jb,),
                    2 * nb * rb * tb * tb, F32_FLOP_PER_S,
                    library=("torch.einsum('nrt,nru->ntu', J, J)",
                             lambda: torch.einsum("nrt,nru->ntu", Jb, Jb)))
                if bi == g["bi"]:
                    rec["name"] = "K9 bucket_gram_blocks (per row)"
                    rec["interleaved"] = interleaved(
                        "K9 bucket_gram_blocks (per row) vs its plain "
                        "version", lambda: bucket_gram_blocks(Jb),
                        lambda: bucket_gram_blocks_plain(Jb), label="plain")
                    kernels.append(rec)
        # K9's group kernel on each tangent-size group: block Jacobi's
        # blocks of the same scaled Jacobian, against the plain form and,
        # bit for bit, the unfused CUDA route
        for gi, grp in enumerate(g["program"].groups):
            rec = check_k9_group(f"K9 group_gram_blocks ({key.upper()} "
                                 f"group {gi}, t {grp.tangent_size})",
                                 jac_s, grp)
            if key == "3d" and gi == 0:
                rec["name"] = "K9 group_gram_blocks"
                kernels.append(rec)

    # ---- slice 4: K10 on the large case's first linearization ----
    t0 = time.time()
    big_bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7,
                                    pixel_noise=1.0)
    big_bal.perturb(**IMPLICIT_PERTURB, seed=8)
    big_problem, big_cams, big_pts = build_bal_ceres_problem(big_bal)
    big_arrays = big_cams + big_pts
    big_start = [a.copy() for a in big_arrays]
    t_build = time.time() - t0
    big_options = large_options(ctt, device="cuda")
    big_program = CompiledProgram.get_cached(big_problem, big_options)
    big_step = schur_step(big_program, big_options,
                          detect_schur_structure(big_program, big_options))
    if not (isinstance(big_step, ImplicitSchurStep) and big_step.k10):
        raise SystemExit(f"large case: step mode {big_step.mode}")
    k_big = big_step.plans[0].fids32.shape[1]
    print(f"large case: problem build {t_build:.1f} s, program and step "
          f"{time.time() - t0 - t_build:.1f} s; ne={big_step.ne} k={k_big} "
          f"kf={big_step.kf} nf={big_step.nf}; {big_step.mode}", flush=True)
    bx0 = big_program.initial_state()
    big_art = big_step.linearize(bx0, *big_step.initial_scales(), first=True,
                                 known_cost=big_step.cost(bx0))
    lin_ms = []
    for _ in range(3):        # the implicit linearize at 1M rows
        torch.cuda.synchronize()
        t0 = time.time()
        big_step.linearize(bx0, *big_art.scales, first=False,
                           known_cost=big_art.cost)
        torch.cuda.synchronize()
        lin_ms.append((time.time() - t0) * 1e3)
    print(f"large case: implicit linearize (K11, "
          f"{IMPLICIT_SHAPE['num_observations']} rows) "
          f"{statistics.median(lin_ms):.1f} ms (median of {lin_ms})",
          flush=True)
    big_inv = big_step.damped_inverse(big_art, rad)
    _, Je_s, Jf_s, plan0 = big_step.scaled_chunks(big_art)[0]
    k10_args = (Je_s, Jf_s, big_inv, plan0.fids32, torch.as_tensor(
        np.random.default_rng(2).standard_normal(big_step.nf),
        dtype=torch.float32, device="cuda"))
    r_big = Je_s.shape[2]
    kernels.append(check_kernel(
        "K10 implicit_apply", lambda: implicit_apply(*k10_args),
        lambda: implicit_apply_plain(*k10_args),
        lambda g_, w: [rel_err(g_, w)], K10_LIMIT,
        "ceres_tpu_torch/csrc/implicit.cu",
        "ceres_tpu/ops/pallas_implicit.py:49", k10_args,
        # per lane w twice, u, w2, C; per point zz
        big_step.ne * k_big * r_big * (6 * big_step.tf + 4 * big_step.te)
        + 2 * big_step.ne * big_step.te ** 2, F32_FLOP_PER_S))
    del big_art, big_inv, Je_s, Jf_s, plan0, k10_args
    if big_step.k4 is None:
        raise SystemExit("large case: the step prices no candidate by K4")
    check_k4(f"K4 cost (large case, {big_step.k4.n} rows, kf "
             f"{big_step.kf})", big_step, bx0)
    big_bk = big_program.buckets[0]
    if big_bk.spec is None or big_bk.spec.kernel_id != 2:
        raise SystemExit("large case: the Snavely bucket has no K11 spec")
    k11_big = (big_bk.spec, torch.cat(
        [p.float() for p in big_program._bucket_params(big_bk, bx0)],
        dim=1).contiguous(), big_bk.dat32)
    rec = check_kernel(
        "K11 bucket_linearize (Snavely)", lambda: bucket_linearize(*k11_big),
        lambda: bucket_linearize_plain(*k11_big), cmp_k11,
        # relative to the largest entry (projections minus observations
        # cancel), as tests/test_torch_linearize.py holds it
        [F32_LIMIT, F32_LIMIT], "ceres_tpu_torch/csrc/linearize.cu",
        "ceres_tpu/ops/pallas_linearize.py:324", k11_big[1:],
        K11_FLOPS_PER_ROW["snavely"] * big_bk.n, F32_FLOP_PER_S)
    rec["counter"] = "K11 bucket_linearize"
    kernels.append(rec)
    del k11_big

    # ---- slice 5: K5 on the quaternion problem's first linearization ----
    t0 = time.time()
    q_bal = quaternion_bal(bal_io)
    quat = {}            # problem, arrays and start of each loss
    for loss_name, loss in (("none", None), ("huber", ctt.HuberLoss(1.0))):
        q_problem, q_cams, q_pts = build_bal_ceres_problem(
            q_bal, loss=loss, use_quaternions=True, use_manifolds=False)
        quat[loss_name] = dict(problem=q_problem, loss=loss,
                               arrays=q_cams + q_pts,
                               start=[a.copy() for a in q_cams + q_pts])
    q_options = quaternion_options(ctt, "QUAT_DENSE_SCHUR", device="cuda")
    q_program = CompiledProgram.get_cached(quat["none"]["problem"], q_options)
    q_step = FusedSchurStep(q_program, q_options,
                            detect_schur_structure(q_program, q_options))
    if q_step.k5 is None or "K5" not in q_step.mode:
        raise SystemExit(f"quaternion problem: step mode {q_step.mode}")
    print(f"quaternion problem build: {time.time() - t0:.1f} s; "
          f"ne={q_step.ne} k={q_step.cam.shape[1]} kf={q_step.kf} "
          f"nf={q_step.nf} te={q_step.te} tf={q_step.tf}; {q_step.mode}",
          flush=True)
    qx0 = q_program.initial_state()
    q_se0, q_sf0 = q_step.initial_scales()
    q_te, q_tf, q_r = q_step.te, q_step.tf, q_step.k5.r
    for loss_name in ("none", "huber"):
        loss = quat[loss_name]["loss"]
        k5_args = (q_step.k5,
                   qx0[q_step.f_slab:q_step.f_slab + q_step.nf].float(),
                   qx0[q_step.e_slab:q_step.e_slab + q_te * q_step.ne].view(
                       q_step.ne, q_te).float(),
                   q_step.cam, q_step.mask, q_step.dat, q_se0, True, True,
                   loss)
        t0 = time.time()
        k5.build(q_step.k5, loss)
        print(f"K5 build ({loss_name}): {time.time() - t0:.1f} s", flush=True)
        # operations: the emitted chain (one operation a line) and the
        # epilogue's products per observation (E^T E, g_e, A, F^T F, g_f)
        chain_ops = sum(
            1 for ln in k5.chain_source(
                q_step.k5, None if loss is None else make_loss_spec(loss)
            ).splitlines() if ln.lstrip().startswith("const "))
        epi_ops = 2 * q_r * (q_te * (q_te + 1) // 2 + q_te + q_te * q_tf
                             + q_tf * (q_tf + 1) // 2 + q_tf)
        rec = check_kernel(
            "K5 lin_auto" + ("" if loss is None else " (HuberLoss(1.0))"),
            lambda: k5.lin_auto(*k5_args, plan=q_step.plan),
            lambda: k5.lin_auto_plain(*k5_args), cmp_lin, F32_LIMIT,
            "ceres_tpu_torch/csrc/lin_auto.cuh",
            "ceres_tpu/ops/pallas_lin.py:272", k5_args[1:7],
            (chain_ops + epi_ops) * nobs, F32_FLOP_PER_S)
        if loss is None:
            kernels.append(rec)
    # K2, K6 and K3 at the quaternion paths' shapes (nf 160), on K5's first
    # linearization at RADIUS
    q_art = q_step.linearize(qx0, q_se0, q_sf0, True)
    q_elim = (q_art.A, q_art.etes, q_art.gse, q_art.diag_e, RADIUS)
    q_ne, q_nf = q_step.ne, q_step.nf
    check_kernel(
        f"K2 elim (quaternion cameras, nf {q_nf})",
        lambda: elim(*q_elim), lambda: elim_plain(*q_elim), cmp_all,
        F32_LIMIT, "ceres_tpu_torch/csrc/elim.cuh",
        "ceres_tpu/ops/pallas_lin.py:424", q_elim[:4],
        scorr_flops(q_ne, q_nf) + INV_Z_FLOPS[3] * q_ne, F32_FLOP_PER_S)
    q_inv, q_z = q_step.point_inverse(q_art, rad)
    check_kernel(
        f"K6 elim_v1 (quaternion cameras, nf {q_nf})",
        lambda: elim_v1(q_art.A, q_inv, q_z),
        lambda: elim_v1_plain(q_art.A, q_inv, q_z), cmp_all, F32_LIMIT,
        "ceres_tpu_torch/csrc/elim.cuh", "ceres_tpu/ops/pallas_lin.py:387",
        (q_art.A, q_inv, q_z), scorr_flops(q_ne, q_nf), F32_FLOP_PER_S)
    q_S, q_rhs, _, _ = q_step.reduced_system(q_art, RADIUS)
    check_kernel(
        f"K3 chol_solve (quaternion cameras, m {q_nf})",
        lambda: chol_solve(q_S, q_rhs), lambda: chol_solve_plain(q_S, q_rhs),
        lambda g_, w: [rel_err(g_, w)], K3_LIMIT,
        "ceres_tpu_torch/csrc/chol.cu",
        "ceres_tpu/ops/pallas_kernels.py:190", (q_S, q_rhs),
        q_nf ** 3 / 3 + 2 * q_nf ** 2, F32_FLOP_PER_S,
        library=("torch.linalg.solve(S, rhs)",
                 lambda: torch.linalg.solve(q_S, q_rhs)))
    # K7 on the quaternion ITERATIVE_SCHUR step's first system (m 160)
    q_it_options = quaternion_options(ctt, "QUAT_ITERATIVE_SCHUR",
                                      device="cuda")
    q_it_step = FusedSchurStep(q_program, q_it_options,
                               detect_schur_structure(q_program,
                                                      q_it_options))
    q_Si, q_rhsi, _, _ = q_it_step.reduced_system(q_art, RADIUS)
    q_minv = q_it_step.precond_inverse(q_art, q_Si, rad)
    q_pcg_kw = q_it_step.pcg_args
    check_kernel(
        f"K7 dense_pcg (quaternion cameras, m {q_nf})",
        lambda: dense_pcg(q_Si, q_rhsi, q_minv, **q_pcg_kw),
        lambda: dense_pcg_plain(q_Si, q_rhsi, q_minv, **q_pcg_kw),
        cmp_pcg(f"K7 dense_pcg (m {q_nf})"), PCG_LIMIT,
        "ceres_tpu_torch/csrc/pcg.cu", "ceres_tpu/ops/pallas_pcg.py:46",
        (q_Si, q_rhsi, q_minv),
        lambda got: pcg_flops(q_nf, q_tf, int(got[1]), reset),
        F32_FLOP_PER_S)
    del q_art, q_elim, q_inv, q_z, q_S, q_rhs, q_Si, q_rhsi, q_minv

    # ---- slice 6: K11's auto spec on the quaternion large case ----
    t0 = time.time()
    qbig_bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7,
                                     pixel_noise=1.0).to_quaternions()
    qbig_bal.perturb(**IMPLICIT_PERTURB, seed=8)
    qbig_problem, qbig_cams, qbig_pts = build_bal_ceres_problem(
        qbig_bal, use_quaternions=True, use_manifolds=False)
    del qbig_bal
    qbig_arrays = qbig_cams + qbig_pts
    qbig_start = [a.copy() for a in qbig_arrays]
    t_build = time.time() - t0
    qbig_options = large_options(
        ctt, device="cuda", max_num_iterations=QUAT_IMPLICIT_MAX_ITERATIONS)
    qbig_program = CompiledProgram.get_cached(qbig_problem, qbig_options)
    qbig_step = schur_step(qbig_program, qbig_options,
                           detect_schur_structure(qbig_program, qbig_options))
    qbig_bk = qbig_program.buckets[0]
    if not (isinstance(qbig_step, ImplicitSchurStep) and qbig_step.k10
            and isinstance(qbig_bk.spec, AutoSpec)):
        raise SystemExit(f"quaternion large case: step mode "
                         f"{qbig_step.mode}, spec {qbig_bk.spec}")
    print(f"quaternion large case: problem build {t_build:.1f} s, program "
          f"and step {time.time() - t0 - t_build:.1f} s; ne={qbig_step.ne} "
          f"kf={qbig_step.kf} nf={qbig_step.nf} te={qbig_step.te} "
          f"tf={qbig_step.tf}; {qbig_step.mode}; K11 {qbig_bk.spec.name}",
          flush=True)
    t0 = time.time()
    build_auto(qbig_bk.spec)
    print(f"K11 auto-spec build: {time.time() - t0:.1f} s", flush=True)
    qx0 = qbig_program.initial_state()
    k11_auto = (qbig_bk.spec, torch.cat(
        [p.float() for p in qbig_program._bucket_params(qbig_bk, qx0)],
        dim=1).contiguous(), qbig_bk.dat32)
    # operations: the emitted row chain, one operation a line
    row_ops = sum(1 for ln in row_chain_source(qbig_bk.spec).splitlines()
                  if ln.lstrip().startswith("const "))
    rec = check_kernel(
        "K11 bucket_linearize (auto)",
        lambda: bucket_linearize_auto(*k11_auto),
        lambda: bucket_linearize_auto_plain(*k11_auto), cmp_k11,
        # relative to the largest entry, as for the Snavely spec
        [F32_LIMIT, F32_LIMIT], "ceres_tpu_torch/csrc/linearize_auto.cuh",
        "ceres_tpu/ops/pallas_linearize.py:324", k11_auto[1:],
        row_ops * qbig_bk.n, F32_FLOP_PER_S)
    kernels.append(rec)
    del k11_auto
    # K10 at the quaternion large case's shapes (tf 10), on its first
    # linearization at RADIUS and a seeded v, as at tf 9 above
    qbig_art = qbig_step.linearize(qx0, *qbig_step.initial_scales(),
                                   first=True)
    qbig_inv = qbig_step.damped_inverse(qbig_art, rad)
    _, qJe_s, qJf_s, qplan0 = qbig_step.scaled_chunks(qbig_art)[0]
    k10_q = (qJe_s, qJf_s, qbig_inv, qplan0.fids32, torch.as_tensor(
        np.random.default_rng(2).standard_normal(qbig_step.nf),
        dtype=torch.float32, device="cuda"))
    kq, rq = qplan0.fids32.shape[1], qJe_s.shape[2]
    check_kernel(
        "K10 implicit_apply (quaternion cameras, tf 10)",
        lambda: implicit_apply(*k10_q), lambda: implicit_apply_plain(*k10_q),
        lambda g_, w: [rel_err(g_, w)], K10_LIMIT,
        "ceres_tpu_torch/csrc/implicit.cu",
        "ceres_tpu/ops/pallas_implicit.py:49", k10_q,
        qbig_step.ne * kq * rq * (6 * qbig_step.tf + 4 * qbig_step.te)
        + 2 * qbig_step.ne * qbig_step.te ** 2, F32_FLOP_PER_S)
    del qbig_art, qbig_inv, qJe_s, qJf_s, qplan0, k10_q

    # ---- the paths: solves on the card ----
    counters = kernel_counters()

    def gate_path(label, runs, never):
        def gate(summary, launches):
            short = [n for n in runs
                     if launches[n] < lm_iterations(summary)]
            if short:
                raise SystemExit(f"{label}: kernels launched fewer times "
                                 f"than LM iterations: {short}")
            stray = [n for n in never if launches[n] != 0]
            if stray:
                raise SystemExit(f"{label}: kernels of another path "
                                 f"launched: {stray}")
        return gate

    def gate_iterative(summary, launches):
        gate_path("ITERATIVE_SCHUR", ("K1 lin", "K4 cost", "K6 elim_v1",
                                      "K7 dense_pcg"),
                  ("K2 elim", "K3 chol_solve",
                   "K10 implicit_apply"))(summary, launches)
        if not summary.num_linear_solver_iterations > summary.num_iterations:
            raise SystemExit("ITERATIVE_SCHUR: CG did not iterate")

    def gate_implicit(label, k11="K11 bucket_linearize",
                      runs=("K4 cost",)):
        """The implicit paths' gate: K11 (counter `k11`) once per
        linearization, K10 at least once per CG iteration, the kernels
        of `runs` once per LM iteration, no other kernel, and the same
        counts and cost in every solve."""
        seen = []

        def gate(summary, launches):
            gate_path(label, runs,
                      [n for n in counters
                       if n not in runs + ("K10 implicit_apply", k11)])(
                           summary, launches)
            if launches[k11] != summary.num_linearizations_fused or \
                    launches[k11] < summary.num_successful_steps:
                raise SystemExit(f"{label}: {k11} did not run once per "
                                 "linearization")
            if "K10" not in summary.message:
                raise SystemExit(f"{label}: not the K10 route: "
                                 f"{summary.message}")
            if launches["K10 implicit_apply"] < \
                    summary.num_linear_solver_iterations:
                raise SystemExit(f"{label}: K10 launched fewer times than "
                                 "CG iterated")
            if not summary.num_linear_solver_iterations > \
                    summary.num_iterations:
                raise SystemExit(f"{label}: CG did not iterate")
            seen.append((summary.num_iterations,
                         summary.num_linear_solver_iterations,
                         summary.final_cost))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: solves differ: {seen}")
        return gate

    forced_step = ImplicitSchurStep(program, it_options, meta)

    def forced_solve(options_, problem_):
        """ctt.solve's work with the implicit step forced on BAL-16."""
        summary = ctt.SolverSummary()
        program.write_back(run_fused(program, options_, summary,
                                     forced_step))
        summary.message += f" Schur step: {forced_step.mode}."
        return summary

    def reset_big():
        for a, a0 in zip(big_arrays, big_start):
            a[:] = a0

    def gate_pose(key):
        g = graphs[key]
        seen = []

        def gate(summary, launches):
            err = position_error(g["positions"], g["gt"])
            cut = POSE_GRAPHS[key]["error_cut"]
            print(f"  mean position error {g['error0']:.6f} -> {err:.6f} "
                  f"(limit {cut} of the start); linearizations "
                  f"{summary.num_linearizations_fused}", flush=True)
            if not err < cut * g["error0"]:
                raise SystemExit(f"pose graph {key}: position error not cut")
            if launches["K11 bucket_linearize"] != \
                    summary.num_linearizations_fused or \
                    launches["K11 bucket_linearize"] < \
                    summary.num_successful_steps:
                raise SystemExit(f"pose graph {key}: K11 did not run once "
                                 "per linearization")
            if launches["K8 bucket_jtjv"] < \
                    summary.num_linear_solver_iterations:
                raise SystemExit(f"pose graph {key}: K8 launched fewer "
                                 "times than CG iterated")
            n_groups = len(g["program"].groups)
            k9 = launches["K9 group_gram_blocks"]
            n_lin = summary.num_linearizations_fused
            print(f"  K9 launches {k9}: {k9 / max(1, n_lin):g} a "
                  f"linearization, {n_groups} tangent-size groups; "
                  f"per-row K9 launches "
                  f"{launches['K9 bucket_gram_blocks (per row)']}",
                  flush=True)
            if k9 < n_groups * n_lin:
                raise SystemExit(f"pose graph {key}: K9 launched fewer "
                                 "times than once a group a linearization")
            stray = [n for n, c in launches.items()
                     if c and n not in ("K8 bucket_jtjv",
                                        "K9 group_gram_blocks",
                                        "K11 bucket_linearize")]
            if stray:
                raise SystemExit(f"pose graph {key}: kernels of another "
                                 f"path launched: {stray}")
            seen.append((summary.num_iterations,
                         summary.num_linear_solver_iterations,
                         summary.final_cost))
            if len(set(seen)) != 1:
                raise SystemExit(f"pose graph {key}: solves differ: {seen}")
        return gate

    def reset_quat(loss_name):
        def reset():
            for a, a0 in zip(quat[loss_name]["arrays"],
                             quat[loss_name]["start"]):
                a[:] = a0
        return reset

    def gate_quat(label, runs, never):
        seen = []

        def gate(summary, launches):
            gate_path(label, runs, never + ("K1 lin", "K4 cost"))(
                summary, launches)
            n5 = launches["K5 lin_auto"]
            if not summary.num_successful_steps <= n5 <= \
                    summary.num_iterations + 1:
                raise SystemExit(f"{label}: K5 launched {n5} times for "
                                 f"{summary.num_successful_steps} accepted "
                                 f"steps of {summary.num_iterations}")
            if "K5" not in summary.message:
                raise SystemExit(f"{label}: not the K5 route: "
                                 f"{summary.message}")
            cfg = QUAT_PATHS[label]
            print(f"  JAX package on the CPU: {cfg['ref_iterations']} LM "
                  f"iterations, final cost {cfg['ref_cost']!r}; this solve "
                  f"{summary.num_iterations}, {summary.final_cost!r}",
                  flush=True)
            seen.append((summary.num_iterations,
                         summary.num_linear_solver_iterations,
                         summary.final_cost))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: solves differ: {seen}")
        return gate

    def reset_graph(key):
        def reset():
            for a, a0 in zip(graphs[key]["arrays"], graphs[key]["start"]):
                a[:] = a0
        return reset

    fused_w = []          # the DENSE_SCHUR timed solves' walls (s)
    by_path = {
        "DENSE_SCHUR": drive(
            "DENSE_SCHUR", options, problem, reset_state, counters, 4,
            gate_path("DENSE_SCHUR", ("K1 lin", "K2 elim", "K3 chol_solve",
                                      "K3 chol_solve (shared)", "K4 cost"),
                      ("K6 elim_v1", "K7 dense_pcg",
                       "K3 chol_solve (global)")), walls=fused_w),
        "ITERATIVE_SCHUR": drive(
            "ITERATIVE_SCHUR", it_options, problem, reset_state, counters,
            3, gate_iterative),
        "IMPLICIT_FORCED": drive(
            "IMPLICIT_SCHUR forced on BAL-16-22106", it_options, problem,
            reset_state, counters, 2,
            gate_implicit("IMPLICIT_SCHUR forced"), solve=forced_solve),
    }
    cgnr_walls = {key: [] for key in POSE_GRAPHS}
    for key in POSE_GRAPHS:
        g = graphs[key]
        by_path[f"POSE_GRAPH_{key.upper()}"] = drive(
            f"POSE_GRAPH_{key.upper()} (CGNR, JACOBI)", g["options"],
            g["problem"], reset_graph(key), counters, 2, gate_pose(key),
            ref_cost=POSE_GRAPHS[key]["ref_cost"], ref_tol=POSE_REF_REL_TOL,
            walls=cgnr_walls[key], summaries=g.setdefault("cgnr", []))
    by_path["IMPLICIT_SCHUR"] = drive(
        "IMPLICIT_SCHUR (1,024 cameras, 1M observations)", big_options,
        big_problem, reset_big, counters, 2,
        gate_implicit("IMPLICIT_SCHUR"), ref_cost=IMPLICIT_REF_COST,
        ref_tol=IMPLICIT_REF_REL_TOL)
    other = ("K8 bucket_jtjv", "K9 group_gram_blocks",
             "K9 bucket_gram_blocks (per row)", "K10 implicit_apply",
             "K11 bucket_linearize", "K11 bucket_linearize (auto)")
    quat_runs = {"DENSE_SCHUR": (("K2 elim", "K3 chol_solve",
                                  "K3 chol_solve (shared)"),
                                 ("K6 elim_v1", "K7 dense_pcg",
                                  "K3 chol_solve (global)") + other),
                 "ITERATIVE_SCHUR": (("K6 elim_v1", "K7 dense_pcg"),
                                     ("K2 elim", "K3 chol_solve") + other)}
    for path, cfg in QUAT_PATHS.items():
        loss_name = "none" if cfg["huber"] is None else "huber"
        by_path[path] = drive(
            path, quaternion_options(ctt, path, device="cuda"),
            quat[loss_name]["problem"], reset_quat(loss_name), counters,
            cfg["trials"], gate_quat(path, *quat_runs[cfg["solver"]]),
            ref_cost=cfg["ref_cost"], ref_tol=cfg["tol"])

    def reset_qbig():
        for a, a0 in zip(qbig_arrays, qbig_start):
            a[:] = a0

    ref_lm, ref_cg = QUAT_IMPLICIT_REF_ITERATIONS
    print(f"QUAT_IMPLICIT_SCHUR: the JAX package on the CPU takes {ref_lm} "
          f"LM / {ref_cg} CG iterations to {QUAT_IMPLICIT_REF_COST!r}",
          flush=True)
    by_path["QUAT_IMPLICIT_SCHUR"] = drive(
        "QUAT_IMPLICIT_SCHUR (1,024 quaternion cameras, 1M observations)",
        qbig_options, qbig_problem, reset_qbig, counters, 2,
        gate_implicit("QUAT_IMPLICIT_SCHUR",
                      k11="K11 bucket_linearize (auto)", runs=()),
        ref_cost=QUAT_IMPLICIT_REF_COST,
        ref_tol=QUAT_IMPLICIT_REF_REL_TOL)
    # ---- the default-Solve slice ----
    dense_runs = ("K1 lin", "K2 elim", "K3 chol_solve",
                  "K3 chol_solve (shared)", "K4 cost")
    dense_never = ("K6 elim_v1", "K7 dense_pcg", "K3 chol_solve (global)",
                   "K5 lin_auto") + other
    def gate_robust(label):
        """K2-K4 at least once per LM iteration; K1 once per
        linearization: at least once per accepted step and at most once
        per LM iteration plus one (rejected steps re-solve from the kept
        linearization)."""
        def gate(summary, launches):
            gate_path(label, dense_runs[1:], dense_never)(summary, launches)
            n1 = launches["K1 lin"]
            if not summary.num_successful_steps <= n1 <= \
                    lm_iterations(summary) + 1:
                raise SystemExit(f"{label}: K1 launched {n1} times for "
                                 f"{summary.num_successful_steps} accepted "
                                 f"steps of {lm_iterations(summary)}")
        return gate

    # BAL-16-22106 with a robust loss on every observation: K1's Huber and
    # Cauchy instances on the main path
    for path, cfg in ROBUST_PATHS.items():
        loss = getattr(ctt, cfg["loss"])(cfg["a"])
        r_problem, r_cams, r_pts = build_bal_ceres_problem(bal, loss=loss)
        r_arrays = r_cams + r_pts
        r_start = [a.copy() for a in r_arrays]

        def reset_robust(arrays=r_arrays, start=r_start):
            for a, a0 in zip(arrays, start):
                a[:] = a0
        print(f"{path}: the JAX package on the CPU takes "
              f"{cfg['ref_iterations']} LM iterations to "
              f"{cfg['ref_cost']!r}", flush=True)
        by_path[path] = drive(
            f"{path} ({cfg['loss']}({cfg['a']}))",
            huber_options(ctt, device="cuda"), r_problem, reset_robust,
            counters, 2, gate_robust(path), ref_cost=cfg["ref_cost"],
            ref_tol=ROBUST_REF_REL_TOL)
        del r_problem, r_arrays, r_start
    # the main path through the host-loop minimizer: an IterationCallback
    # recording each summary, the progress lines on stdout
    seen_its, host_w = [], []

    def record_iteration(it):
        seen_its.append((it.iteration, it.cost, it.step_is_successful))
        return ctt.CallbackReturnType.SOLVER_CONTINUE

    def gate_host(summary, launches):
        gate_path("DENSE_SCHUR_HOST_LOOP", dense_runs, dense_never)(
            summary, launches)
        lm = lm_iterations(summary)
        records = len(summary.iterations)
        print(f"  host loop: {lm} LM iterations, {records} iteration "
              f"summaries (iteration 0 included), the callback saw "
              f"{len(seen_its)}: {seen_its}", flush=True)
        if lm != HOST_LOOP_ITERATIONS:
            raise SystemExit(f"host loop: {lm} LM iterations, not "
                             f"{HOST_LOOP_ITERATIONS}")
        # the callbacks see iteration 0 and every iteration that does not
        # end the solve on a tolerance (as in the JAX package's loop)
        if len(seen_its) != records - 1 or seen_its[0][0] != 0:
            raise SystemExit("host loop: the callback did not see each "
                             "summary but the last")
        seen_its.clear()
    by_path["DENSE_SCHUR_HOST_LOOP"] = drive(
        "DENSE_SCHUR_HOST_LOOP (fused_iterations=False)",
        ctt.SolverOptions(**dict(common, fused_iterations=False,
                                 callbacks=[record_iteration],
                                 minimizer_progress_to_stdout=True),
                          linear_solver_type=ctt.LinearSolverType
                          .DENSE_SCHUR), problem, reset_state, counters, 3,
        gate_host, walls=host_w)
    print(f"DENSE_SCHUR at BAL-16-22106 on {smi}: host loop wall "
          f"{min(host_w):.4f}-{max(host_w):.4f} s (runs "
          f"{[round(w, 4) for w in host_w]}), fused loop wall "
          f"{min(fused_w):.4f}-{max(fused_w):.4f} s (runs "
          f"{[round(w, 4) for w in fused_w]})", flush=True)

    # the 1,000-pose SE2 graph under Ceres's defaults: the f64 generic
    # steps launch no kernel (the JAX package's f64 pass runs none)
    g2 = graphs["2d"]

    def gate_se2(label, cfg):
        seen = []

        def gate(summary, launches):
            err = position_error(g2["positions"], g2["gt"])
            cut = POSE_GRAPHS["2d"]["error_cut"]
            print(f"  {label}: {lm_iterations(summary)} LM iterations "
                  f"(JAX package on the CPU: {cfg['ref_iterations']}), "
                  f"final cost {summary.final_cost!r} (JAX "
                  f"{cfg['ref_cost']!r}); mean position error "
                  f"{g2['error0']:.6f} -> {err:.6f} (limit {cut} of the "
                  f"start); {summary.linear_solver_type_used}", flush=True)
            if not err < cut * g2["error0"]:
                raise SystemExit(f"{label}: position error not cut")
            stray = [n for n, c in launches.items() if c]
            if stray:
                raise SystemExit(f"{label}: kernels launched on the f64 "
                                 f"path: {stray}")
            seen.append((lm_iterations(summary), summary.final_cost))
            if len(set(seen)) != 1:
                raise SystemExit(f"{label}: solves differ: {seen}")
        return gate
    for path, cfg in SE2_DEFAULT_PATHS.items():
        by_path[path] = drive(
            f"{path} (SolverOptions() defaults{', ' if cfg['options'] else ''}"
            f"{', '.join(f'{k}={v}' for k, v in cfg['options'].items())})",
            default_options(ctt, cfg, device="cuda"), g2["problem"],
            reset_graph("2d"), counters, 2, gate_se2(path, cfg),
            ref_cost=cfg["ref_cost"], ref_tol=SE2_DEFAULT_REL_TOL)

    sparse_paths(graphs, counters, by_path, cgnr_walls)
    ba_paths(problem, cams + pts, reset_state, counters, by_path)
    fused_large_m_paths(counters, by_path, kernels)
    line_search_paths(counters, by_path)
    problem_api_paths(counters, by_path)
    solver_options_paths(counters, by_path, kernels, smi)
    slice13_paths(counters, by_path)
    sharded_paths(counters, by_path, smi, problem, reset_state, meta,
                  big_problem, reset_big,
                  detect_schur_structure(big_program, big_options))
    slice15_paths(counters, by_path)
    slice16_paths(counters, by_path, kernels, smi)

    # tests/test_solver_e2e.py's helloworld, Powell and bounded problems
    # on the card, at those tests' tolerances
    def small_solve(label, build, options, check):
        x = build()
        t0 = time.time()
        s_ = ctt.solve(options, x[0])
        torch.cuda.synchronize()
        print(f"{label}: {s_.termination_type}, {lm_iterations(s_)} LM "
              f"iterations, initial cost {s_.initial_cost!r}, final cost "
              f"{s_.final_cost!r}, x {[a.tolist() for a in x[1:]]}, wall "
              f"{time.time() - t0:.4f} s", flush=True)
        if not s_.is_solution_usable():
            raise SystemExit(f"{label}: no usable solution: {s_.message}")
        check(s_, x[1:])

    def helloworld():
        x = np.array([0.5])
        p_ = ctt.Problem()
        p_.add_residual_block(ctt.AutoDiffCostFunction(
            lambda v: 10.0 - v, 1, [1]), None, x)
        return p_, x

    def check_hello(s_, xs):
        if not (abs(s_.initial_cost - 45.125) <= 1e-12 * 45.125
                and s_.final_cost < 1e-12
                and abs(xs[0][0] - 10.0) <= 1e-6 * 10.0
                and s_.termination_type == ctt.TerminationType.CONVERGENCE):
            raise SystemExit("helloworld: off the tutorial's numbers")

    def powell():
        xs = [np.array([3.0]), np.array([-1.0]), np.array([0.0]),
              np.array([1.0])]
        p_ = ctt.Problem()
        for f, a, b in (
                (lambda x1, x2: x1 + 10.0 * x2, 0, 1),
                (lambda x3, x4: 5.0 ** 0.5 * (x3 - x4), 2, 3),
                (lambda x2, x3: (x2 - 2.0 * x3) ** 2, 1, 2),
                (lambda x1, x4: 10.0 ** 0.5 * (x1 - x4) ** 2, 0, 3)):
            p_.add_residual_block(ctt.AutoDiffCostFunction(f, 1, [1, 1]),
                                  None, xs[a], xs[b])
        return (p_, *xs)

    def check_powell(s_, xs):
        print(f"  Powell: {lm_iterations(s_)} LM iterations, "
              f"{s_.num_iterations} iteration summaries with iteration 0 "
              f"(Ceres's tutorial, DENSE_QR: 15)", flush=True)
        if not (abs(s_.initial_cost - 107.5) <= 1e-12 * 107.5
                and s_.final_cost < 1e-12
                and all(abs(x[0]) < 2e-3 for x in xs)):
            raise SystemExit("Powell: off the tutorial's numbers")

    def bounded():
        x = np.array([3.0, -2.0])
        p_ = ctt.Problem()
        p_.add_residual_block(ctt.AutoDiffCostFunction(
            lambda v: torch.stack([v[0] - 10.0, v[1] + 10.0]), 2, [2]),
            None, x)
        p_.set_parameter_upper_bound(x, 0, 5.0)
        p_.set_parameter_lower_bound(x, 1, -4.0)
        return p_, x

    def check_bounded(s_, xs):
        if not (np.abs(xs[0] - [5.0, -4.0]).max() <= 1e-6
                and s_.is_constrained):
            raise SystemExit("bounded problem: not clamped at its bounds")

    for fn in counters.values():
        fn.launches = 0
    small_solve("helloworld (SolverOptions(): LM, DENSE_QR, f64, host loop)",
                helloworld, ctt.SolverOptions(device="cuda"), check_hello)
    small_solve("Powell (DENSE_QR, gradient_tolerance 1e-10, 100 "
                "iterations)", powell, ctt.SolverOptions(
                    gradient_tolerance=1e-10, max_num_iterations=100,
                    device="cuda"), check_powell)
    small_solve("bounded problem (x0 <= 5, x1 >= -4)", bounded,
                ctt.SolverOptions(max_num_iterations=100, device="cuda"),
                check_bounded)
    stray = [n for n, fn in counters.items() if fn.launches]
    if stray:
        raise SystemExit(f"small problems: kernels launched: {stray}")

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 matmul is enabled")

    for rec in kernels:
        counter = rec.get("counter", rec["name"])
        rec["launches"] = by_path[MAIN_PATH[rec["name"]]][counter]
        rec["launches_by_path"] = {p: c.get(counter, 0)
                                   for p, c in by_path.items()}
        if rec["name"] == "K3 chol_solve":
            rec["variant_launches"] = {
                v: by_path[MAIN_PATH[rec["name"]]][f"K3 chol_solve ({v})"]
                for v in ("shared", "global")}
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [
        {k: rec[k] for k in ("name", "route", "source", "replaces",
                             "launches", "launches_by_path", "max_abs_err",
                             "max_rel_err", "limit", "ms", "loop_ms",
                             "plain_ms",
                             "bound_ms", "bound_by", "library_ms",
                             "library_call", "reference_ms",
                             "reference_call")}
        | {"interleaved": rec.get("interleaved"),
           "variant_launches": rec.get("variant_launches")}
        for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
