#!/usr/bin/env python3
"""The references of chip_smoke.py's slice 12 phase
(`solver_options_paths`), on the CPU, in either package.

    JAX_PLATFORMS=cpu python3 scripts/slice12_reference.py
        [--packages jax,torch] [--paths fused_ls,inner,cluster,cov,te]
        [--spread] [--threads 1]

fused_ls: the line-search minimizer with fused_iterations=True on the
tutorial's Rosenbrock, the extended Rosenbrock in EXT_ROSENBROCK_N
parameters and the BA line search of FUSED_LS_BA_ARGS (the JAX
package's device loop, make_fused_ls_solve); with --spread the BA run
again from its start scaled by 1 -+ 1e-12 and 1 -+ 1e-9. inner: bundle_adjuster INNER_ARGS (f64,
SPARSE_SCHUR + JACOBI, inner iterations). cluster: bundle_adjuster at
TRAFALGAR_ARGS with each of CLUSTER_PATHS in f64 (the JAX package's
mixed CLUSTER solve does not trace: its mixed runs are skipped), the
clustering's digest (cluster_digest); with --spread the f64 runs again
from the start scaled by 1 -+ 1e-7. cov: COV_PAIRS's covariance blocks
by SPARSE_QR's Schur branch on the unperturbed BAL-16-22106 problem with
cameras 0 and 1 constant. te: each of TE_PATHS on its point-size
problem (TE_PERTURB); with --spread again from the start scaled by
1 -+ 1e-7.

Prints one line a run (iterations, counts, final cost as repr, relative
distance to the unscaled run, wall); the JAX package's numbers are
chip_smoke.py's references. The cluster runs form Trafalgar's dense A
(65,132 x 3 x 2,313 in f64, 3.6 GB, twice): run them where the memory is
(the card's machine, CPU only, ~10 minutes).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(pkg, label, summary, wall, ref=None, extra=""):
    rel = ("" if ref is None else
           f", {abs(summary.final_cost - ref) / ref:.3e} from the unscaled")
    n = summary.num_iterations_fused or summary.num_iterations
    print(f"{pkg} {label}: {summary.termination_type} ({summary.message}), "
          f"{n} iterations, {summary.num_successful_steps} successful, "
          f"{summary.num_linear_solver_iterations} linear iterations, "
          f"{summary.num_line_search_steps} probes, "
          f"{summary.num_inner_iteration_steps} inner steps, final cost "
          f"{summary.final_cost!r}{rel}{extra}, wall {wall:.1f} s",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default="fused_ls,inner,cluster,cov,te")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import dataclasses
    import numpy as np
    from chip_smoke import (CLUSTER_COMMON, CLUSTER_PATHS,
                            COV_PAIRS, INNER_ARGS, SHAPE, TE_PERTURB,
                            TE_PATHS, TRAFALGAR_ARGS, cluster_digest,
                            fused_ls_problems, point_size_problem,
                            te_options)
    from ceres_tpu_torch.examples.bundle_adjuster import parse_args
    paths = args.paths.split(",")

    for pkg in args.packages.split(","):
        if pkg == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as T
            import ceres_tpu as mod
            from ceres_tpu import rotation as rot
            from ceres_tpu.examples import bundle_adjuster as example
            from ceres_tpu.examples.tutorial import make_rosenbrock
            from ceres_tpu.io import bal as bal_io
            from ceres_tpu.program import CompiledProgram
            from ceres_tpu.solvers import clustering
            from ceres_tpu.solvers.schur import detect_schur_structure
            extra = {}
        else:
            import torch as T
            T.set_num_threads(args.threads)
            import ceres_tpu_torch as mod
            from ceres_tpu_torch import rotation as rot
            from ceres_tpu_torch.examples import bundle_adjuster as example
            from ceres_tpu_torch.examples.tutorial import make_rosenbrock
            from ceres_tpu_torch.io import bal as bal_io
            from ceres_tpu_torch.program import CompiledProgram
            from ceres_tpu_torch.solvers import clustering
            from ceres_tpu_torch.solvers.schur import detect_schur_structure
            extra = {"device": "cpu"}

        def example_problem(argv, scale=1.0):
            """bundle_adjuster's problem and options of argv (no progress
            on stdout), its start scaled."""
            flags = parse_args(argv)
            bal = bal_io.synthetic_bal_problem(
                flags.synthetic_cameras, flags.synthetic_points,
                flags.synthetic_observations, seed=flags.random_seed,
                pixel_noise=1.0)
            bal.normalize()
            bal.perturb(rotation_sigma=flags.rotation_sigma,
                        translation_sigma=flags.translation_sigma,
                        point_sigma=flags.point_sigma,
                        seed=flags.random_seed)
            problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
            for a in cams + pts:
                a *= scale
            opts = example.build_options(mod, flags)
            opts = dataclasses.replace(opts,
                                       minimizer_progress_to_stdout=False,
                                       **extra)
            return problem, opts

        if "fused_ls" in paths:
            for label, run in fused_ls_problems(
                    mod, T, make_rosenbrock, example.build_options, bal_io):
                scales = ((1.0, 1.0 - 1e-12, 1.0 + 1e-12, 1.0 - 1e-9,
                           1.0 + 1e-9)
                          if args.spread and "BUNDLE" in label else (1.0,))
                ref = None
                for scale in scales:
                    t0 = time.time()
                    s, x = run(scale, fused_iterations=True, **extra)
                    report(pkg, f"{label} (start x {scale!r})", s,
                           time.time() - t0, ref,
                           f", max |x - 1| {np.abs(x - 1.0).max():.3e}"
                           if "ROSENBROCK" in label else "")
                    ref = s.final_cost if ref is None else ref

        if "inner" in paths:
            problem, opts = example_problem(INNER_ARGS)
            t0 = time.time()
            s = mod.solve(opts, problem)
            report(pkg, "INNER (bundle_adjuster INNER_ARGS)", s,
                   time.time() - t0)

        if "cluster" in paths:
            for label, flags in CLUSTER_PATHS.items():
                if pkg == "jax" and "--mixed_precision_solves" in flags:
                    continue
                argv = TRAFALGAR_ARGS + CLUSTER_COMMON + flags
                scales = ((1.0, 1.0 - 1e-7, 1.0 + 1e-7)
                          if args.spread and "SCHUR_JACOBI" not in label
                          else (1.0,))
                ref = None
                for scale in scales:
                    problem, opts = example_problem(argv, scale)
                    t0 = time.time()
                    s = mod.solve(opts, problem)
                    report(pkg, f"{label} (start x {scale!r})", s,
                           time.time() - t0, ref)
                    ref = s.final_cost if ref is None else ref
                    if scale == 1.0 and "CLUSTER_" in label and \
                            "SCHUR" not in label:
                        prog = CompiledProgram.get_cached(problem, opts)
                        meta = detect_schur_structure(prog, opts)
                        kind = ("CLUSTER_JACOBI" if "JACOBI" in label
                                else "CLUSTER_TRIDIAGONAL")
                        m, f = clustering.cluster_membership(
                            prog, meta, kind, clustering_type=str(
                                opts.visibility_clustering_type))
                        print(f"{pkg} {label}: {int(m.max()) + 1} clusters,"
                              f" {len(f or [])} forest edges, digest "
                              f"{cluster_digest(m, f)}", flush=True)

        if "cov" in paths:
            bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7,
                                               pixel_noise=1.0)
            problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
            problem.set_parameter_block_constant(cams[0])
            problem.set_parameter_block_constant(cams[1])
            cov = mod.Covariance(mod.CovarianceOptions(
                algorithm_type=mod.CovarianceAlgorithmType.SPARSE_QR,
                **extra))
            pairs = [(cams[a], cams[b]) for a, b in COV_PAIRS]
            t0 = time.time()
            ok = cov.compute(pairs, problem)
            print(f"{pkg} COV_SCHUR: ok {ok} ({cov.message}), wall "
                  f"{time.time() - t0:.1f} s", flush=True)
            for (a, b), (pa, pb) in zip(COV_PAIRS, pairs):
                block = np.asarray(
                    cov.get_covariance_block_in_tangent_space(pa, pb))
                print(f"{pkg} COV_SCHUR ({a}, {b}): "
                      f"{[float(v) for v in block.ravel()]!r}", flush=True)

        if "te" in paths:
            bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7,
                                               pixel_noise=1.0)
            bal.perturb(**TE_PERTURB, seed=8)
            for label, (te, solver) in TE_PATHS.items():
                scales = ((1.0, 1.0 - 1e-7, 1.0 + 1e-7) if args.spread
                          else (1.0,))
                ref = None
                for scale in scales:
                    problem = point_size_problem(mod, T, rot, te, bal,
                                                 scale)[0]
                    t0 = time.time()
                    s = mod.solve(te_options(mod, solver, **extra), problem)
                    report(pkg, f"{label} (start x {scale!r})", s,
                           time.time() - t0, ref)
                    ref = s.final_cost if ref is None else ref


if __name__ == "__main__":
    main()
