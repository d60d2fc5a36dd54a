#!/usr/bin/env python3
"""The references of chip_smoke.py's slice 10 phases, on the CPU, in
either package.

    JAX_PLATFORMS=cpu python3 scripts/slice10_reference.py
        [--packages jax,torch] [--paths large_m,rosenbrock,extended,ba_ls,tiny]
        [--spread] [--threads 1]

large_m: FUSED_LARGE_M, Trafalgar-126's shape (LARGE_M_SHAPE, seed 7,
PERTURB) under bench.py's options, mixed DENSE_SCHUR and ITERATIVE_SCHUR
+ SCHUR_JACOBI, the fused step (the JAX package's XLA cho_factor and CG
loop past 1,024 columns); with --spread again from the start scaled by
1 - 1e-7 and 1 + 1e-7. rosenbrock: the tutorial's Rosenbrock
(GradientProblemSolver, L-BFGS). extended: the extended Rosenbrock
function in EXT_ROSENBROCK_N parameters (AutoDiffFirstOrderFunction,
L-BFGS, Wolfe). ba_ls: the bundle_adjuster example with BA_LS_ARGS (f64,
--line_search, 50 iterations); with --spread again from the start scaled
by 1 -+ 1e-9. tiny: tiny_solve on TINY_BATCH seeded problems (jax.vmap in
the JAX package, the batch dimension in the port): tiny_counts_digest of
the iteration counts, the converged flags and the sum of the solutions.

Prints one line a run: iterations, final cost (repr), relative distance
to the unscaled run, wall. The JAX package's numbers are chip_smoke.py's
references. The large_m runs take a few GB and a few minutes each:
run them where the memory is (the card's machine, CPU only).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(pkg, label, summary, wall, ref=None, iterations=None):
    rel = ("" if ref is None else
           f", {abs(summary.final_cost - ref) / ref:.3e} from the unscaled")
    n = (iterations if iterations is not None else summary.num_iterations)
    print(f"{pkg} {label}: {summary.termination_type}, {n} iterations, "
          f"{summary.num_successful_steps} accepted, "
          f"{summary.num_linear_solver_iterations} linear iterations, "
          f"{summary.num_line_search_steps} line-search probes, final cost "
          f"{summary.final_cost!r}{rel}, wall {wall:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default="large_m,rosenbrock,extended,ba_ls,"
                                       "tiny")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    from chip_smoke import (BA_LS_ARGS, EXT_ROSENBROCK_N, FUSED_LARGE_M,
                            LARGE_M_SHAPE, PERTURB, TINY_BATCH, TINY_OPTIONS,
                            extended_rosenbrock, extended_rosenbrock_start,
                            large_m_options, tiny_counts_digest,
                            tiny_problems, tiny_residual)
    paths = args.paths.split(",")

    for pkg in args.packages.split(","):
        if pkg == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as T
            import ceres_tpu as mod
            from ceres_tpu.examples import bundle_adjuster as example
            from ceres_tpu.examples import tutorial
            from ceres_tpu.io import bal as bal_io
            extra = {}
        else:
            import torch as T
            T.set_num_threads(args.threads)
            import ceres_tpu_torch as mod
            from ceres_tpu_torch.examples import bundle_adjuster as example
            from ceres_tpu_torch.examples import tutorial
            from ceres_tpu_torch.io import bal as bal_io
            extra = {"device": "cpu"}

        if "large_m" in paths:
            bal = bal_io.synthetic_bal_problem(**LARGE_M_SHAPE, seed=7,
                                               pixel_noise=1.0)
            bal.perturb(**PERTURB, seed=8)
            scales = ((1.0, 1.0 - 1e-7, 1.0 + 1e-7) if args.spread
                      else (1.0,))
            for label, cfg in FUSED_LARGE_M.items():
                ref = None
                for scale in scales:
                    problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
                    for a in cams + pts:
                        a *= scale
                    t0 = time.time()
                    s = mod.solve(large_m_options(mod, cfg["solver"],
                                                  **extra), problem)
                    report(pkg, f"{label} (start x {scale!r})", s,
                           time.time() - t0, ref)
                    ref = s.final_cost if ref is None else ref

        if "rosenbrock" in paths:
            t0 = time.time()
            _, s = tutorial.rosenbrock(**extra)
            report(pkg, "LS_ROSENBROCK (examples/tutorial.py rosenbrock)", s,
                   time.time() - t0, iterations=len(s.iterations) - 1)

        if "extended" in paths:
            n = EXT_ROSENBROCK_N
            x = extended_rosenbrock_start(n)
            fn = mod.AutoDiffFirstOrderFunction(extended_rosenbrock(T), n)
            t0 = time.time()
            s = mod.solve_gradient_problem(mod.SolverOptions(
                minimizer_type=mod.MinimizerType.LINE_SEARCH,
                max_num_iterations=200, **extra), mod.GradientProblem(fn), x)
            report(pkg, f"LS_EXTENDED_ROSENBROCK (n {n})", s,
                   time.time() - t0, iterations=len(s.iterations) - 1)
            print(f"  {s.message}; max |x - 1| {np.abs(x - 1.0).max():.3e}",
                  flush=True)

        if "ba_ls" in paths:
            dev = [] if pkg == "jax" else ["--device", "cpu"]
            t0 = time.time()
            s = example.main(BA_LS_ARGS + dev)
            report(pkg, "LS_BUNDLE_ADJUSTER (example main)", s,
                   time.time() - t0, iterations=len(s.iterations) - 1)
            if args.spread:
                ref = s.final_cost
                from ceres_tpu_torch.examples.bundle_adjuster import \
                    parse_args
                flags = parse_args(BA_LS_ARGS + dev)
                if pkg == "jax":
                    del flags.device
                for scale in (1.0 - 1e-9, 1.0 + 1e-9):
                    # the example's problem, rebuilt, its start scaled
                    b = bal_io.synthetic_bal_problem(
                        flags.synthetic_cameras, flags.synthetic_points,
                        flags.synthetic_observations,
                        seed=flags.random_seed, pixel_noise=1.0)
                    b.normalize()
                    b.perturb(rotation_sigma=flags.rotation_sigma,
                              translation_sigma=flags.translation_sigma,
                              point_sigma=flags.point_sigma,
                              seed=flags.random_seed)
                    p, cams, pts = bal_io.build_bal_ceres_problem(b)
                    for a in cams + pts:
                        a *= scale
                    t0 = time.time()
                    s = mod.solve(example.build_options(mod, flags), p)
                    report(pkg, f"LS_BUNDLE_ADJUSTER (start x {scale!r})", s,
                           time.time() - t0, ref,
                           iterations=len(s.iterations) - 1)

        if "tiny" in paths:
            a, x0 = tiny_problems(TINY_BATCH)
            f = tiny_residual(T)
            t0 = time.time()
            if pkg == "jax":
                opts = mod.TinySolverOptions(**TINY_OPTIONS)
                res = jax.vmap(lambda x, aa: mod.tiny_solve(
                    lambda v: f(v, aa), x, opts))(T.asarray(x0),
                                                  T.asarray(a))
            else:
                res = mod.tiny_solve(f, T.tensor(x0),
                                     mod.TinySolverOptions(**TINY_OPTIONS),
                                     args=(T.tensor(a),))
            counts = np.asarray(res.iterations).astype(np.int32)
            xs = np.asarray(res.x)
            print(f"{pkg} LS_TINY_SOLVER ({TINY_BATCH} problems): counts "
                  f"digest {tiny_counts_digest(counts)}, "
                  f"{int(counts.sum())} iterations in all, at most "
                  f"{int(counts.max())}, converged "
                  f"{int(np.asarray(res.converged).sum())}, sum of x "
                  f"{float(xs.sum())!r}, wall {time.time() - t0:.1f} s",
                  flush=True)


if __name__ == "__main__":
    main()
