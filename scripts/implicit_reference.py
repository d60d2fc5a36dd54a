#!/usr/bin/env python3
"""The large bundle-adjustment solve of chip_smoke.py on the CPU, in both
packages.

    JAX_PLATFORMS=cpu python3 scripts/implicit_reference.py
        [--packages jax,torch] [--threads 1,4] [--scale 1.0]
        [--quaternions] [--start-scale 1.0]

Builds the JAX package's large-BA case
(benchmarks/ba_scaling_benchmark.py --large: synthetic_bal_problem(1024,
200000, 1000000, seed=7, pixel_noise=1.0), perturbed with
rotation_sigma=0.01, translation_sigma=0.1, point_sigma=0.05, seed=8) and
solves it with that benchmark's options (LM, ITERATIVE_SCHUR +
SCHUR_JACOBI, mixed precision, fused loop, function_tolerance 1e-6, 100
CG iterations, 45 LM iterations at most). nf = 9,216 camera columns is
past the explicit reduced-system cap, so both packages run the
matrix-free (implicit) Schur step: ceres_tpu on the CPU through its XLA
apply (no Pallas kernel runs on the CPU), ceres_tpu_torch on the CPU
through the plain PyTorch versions of its kernels, once for each
--threads count. Prints one line per solve: termination, LM iterations,
accepted steps, CG iterations, initial and final cost, the problem build
and solve times and the peak resident memory of the process so far. The
JAX package's final cost is chip_smoke.py's IMPLICIT reference.
--scale < 1 shrinks cameras, points and observations alike (sizing runs;
below ~0.45 the problem becomes explicit-viable and the run forces
nothing). --quaternions writes the cameras as w-first quaternions before
the perturbation (Ceres's bundle_adjuster -use_quaternions, Euclidean
quaternion blocks: SnavelyReprojectionErrorWithQuaternions, nf = 10,240
camera columns) and caps LM at QUAT_IMPLICIT_MAX_ITERATIONS; its JAX
final cost is chip_smoke.py's QUAT_IMPLICIT_SCHUR reference.
--start-scale multiplies every camera and point value of the perturbed
start by that factor (1.0000001: a witness of how far a trajectory
spreads from a change in the last bits of its start). The XLA thread
count of the JAX solve follows XLA_FLAGS (for one thread:
XLA_FLAGS="--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1"). Takes tens of minutes and a few GB at
the full size.
"""

import argparse
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--threads", default="1,4")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--quaternions", action="store_true")
    ap.add_argument("--start-scale", type=float, default=1.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import (IMPLICIT_PERTURB, IMPLICIT_SHAPE,
                            QUAT_IMPLICIT_MAX_ITERATIONS, large_options)

    shape = {k: max(1, int(round(v * args.scale)))
             for k, v in IMPLICIT_SHAPE.items()}
    runs = []
    if "jax" in args.packages.split(","):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import ceres_tpu as ct
        from ceres_tpu.io import bal as jbal
        runs.append(("ceres_tpu", ct, jbal, {}, None))
    if "torch" in args.packages.split(","):
        import torch
        import ceres_tpu_torch as ctt
        from ceres_tpu_torch.io import bal as tbal
        for n in (int(t) for t in args.threads.split(",")):
            runs.append((f"ceres_tpu_torch ({n} thread(s))", ctt, tbal,
                         {"device": "cpu"}, n))
    for name, mod, bal_mod, extra, threads in runs:
        if threads is not None:
            import torch
            torch.set_num_threads(threads)
        t0 = time.time()
        bal = bal_mod.synthetic_bal_problem(**shape, seed=7, pixel_noise=1.0)
        if args.quaternions:
            bal = bal.to_quaternions()
        bal.perturb(**IMPLICIT_PERTURB, seed=8)
        bal.cameras *= args.start_scale
        bal.points *= args.start_scale
        problem = bal_mod.build_bal_ceres_problem(
            bal, use_quaternions=args.quaternions, use_manifolds=False)[0]
        t_build = time.time() - t0
        t0 = time.time()
        if args.quaternions:
            extra = dict(extra,
                         max_num_iterations=QUAT_IMPLICIT_MAX_ITERATIONS)
        s = mod.solve(large_options(mod, **extra), problem)
        t_solve = time.time() - t0
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        kind = "quaternion " if args.quaternions else ""
        if args.start_scale != 1.0:
            kind += f"start x {args.start_scale!r} "
        print(f"{name} {kind}{shape}: {s.termination_type}, "
              f"{s.num_iterations} LM iterations "
              f"({s.num_successful_steps} accepted), "
              f"{s.num_linear_solver_iterations} CG iterations, initial "
              f"cost {s.initial_cost!r}, final cost {s.final_cost!r}; "
              f"build {t_build:.1f} s, solve {t_solve:.1f} s, peak RSS "
              f"{rss_gb:.2f} GB", flush=True)


if __name__ == "__main__":
    main()
