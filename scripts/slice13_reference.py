#!/usr/bin/env python3
"""The references of chip_smoke.py's slice 13 phase (`slice13_paths`), on
the CPU, in either package.

    JAX_PLATFORMS=cpu python3 scripts/slice13_reference.py
        [--packages jax,torch] [--parts nist,capi,ransac,batch_ba,denoise,
         libmv,pipeline] [--spread] [--threads 1]

nist: the certified values of NIST_SPECS' files (a tight f64 LM solve
from the generating parameters: DENSE_QR, tolerances 1e-18, 10,000
iterations; the JAX package's run is the certificate), then the files
written with them and examples/nist_runner.py's suite (its loop, with the
package's own solver) at both starts: LRE and final cost. capi: the
package's C API at the Python level (ctypes cost and Cauchy(0.5) loss,
curve_fitting.c's data) on the CPU: m and c. ransac: the RANSAC_HYPOTHESES
refinement problems of BATCH_RANSAC in batch mode: the counts (with
--spread their spread from hypotheses scaled by 1 -+ 1e-12), and the
same problems from chip_smoke.py's moved starts (the counts' digest). batch_ba: BATCH_BA's elements in batch mode: counts and
costs. denoise: DENOISING's f64 solve. libmv: LIBMV's two solves (with
--spread again from starts scaled by 1 -+ 1e-10). pipeline: PIPELINE's
four problems, f64 DENSE_SCHUR fused (the main path's reference
configuration).

Prints one line a run and, last, a JSON object of the references under
chip_smoke.py's names (the JAX package's are chip_smoke.py's constants;
the port's, on the CPU, show how far it is before the card runs it).
"""

import argparse
import ctypes
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--parts",
                    default="nist,capi,ransac,batch_ba,denoise,libmv,"
                            "pipeline")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    from ceres_tpu_torch.examples import libmv_bundle_adjuster as tlba
    from ceres_tpu_torch.examples import ransac_homography as trh
    from ceres_tpu_torch.io.libmv import write_libmv_test_problem
    parts = args.parts.split(",")
    tmp = tempfile.mkdtemp(prefix="slice13_ref_")
    out = {}

    for pkg in args.packages.split(","):
        refs = out.setdefault(pkg, {})
        if pkg == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import ceres_tpu as mod
            from ceres_tpu import c_api
            from ceres_tpu.examples import denoising, nist_runner
            from ceres_tpu.examples import libmv_bundle_adjuster as lba
            from ceres_tpu.examples.ransac_homography import \
                _build_refine_problem as build_refine
            from ceres_tpu.io import bal as bal_io
            from ceres_tpu.io import nist
            from ceres_tpu.io.libmv import read_libmv_problem
            from ceres_tpu.io.pgm import read_pgm
            extra = {}
        else:
            import torch
            torch.set_num_threads(args.threads)
            import ceres_tpu_torch as mod
            from ceres_tpu_torch import c_api
            from ceres_tpu_torch.examples import denoising, nist_runner
            from ceres_tpu_torch.examples import libmv_bundle_adjuster as lba
            from ceres_tpu_torch.io import bal as bal_io
            from ceres_tpu_torch.io import nist
            from ceres_tpu_torch.io.libmv import read_libmv_problem
            from ceres_tpu_torch.io.pgm import read_pgm
            build_refine = trh.build_refine_problem
            extra = {"device": "cpu"}

        def line(label, s, wall, more=""):
            print(f"{pkg} {label}: {s.termination_type}, {s.num_iterations} "
                  f"LM ({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} linear, final cost "
                  f"{s.final_cost!r}{more}, wall {wall:.1f} s", flush=True)

        if "nist" in parts:
            if pkg == "jax" or "jax" not in out:
                cert = {}
                for name, spec in cs.NIST_SPECS.items():
                    x, y = cs.nist_data(name)
                    nprob = nist.NISTProblem(
                        name, np.asarray([spec[0], spec[0]]),
                        np.asarray(spec[0]), None, x[:, None], y,
                        len(spec[0]))
                    problem, b = nist.build_nist_problem(nprob, 0)
                    t0 = time.time()
                    s = mod.solve(mod.SolverOptions(
                        max_num_iterations=10000, function_tolerance=1e-18,
                        gradient_tolerance=1e-18, parameter_tolerance=1e-18,
                        **extra), problem)
                    line(f"NIST certificate {name}", s, time.time() - t0)
                    cert[name] = ([float(v) for v in b],
                                  2.0 * s.final_cost)
                refs["NIST_CERTIFIED"] = cert
            cert = out.get("jax", refs).get("NIST_CERTIFIED")
            d = os.path.join(tmp, f"nist_{pkg}")
            os.makedirs(d, exist_ok=True)
            cs.write_nist_files(d, cert)
            nref = {}
            for nprob in nist.load_nist_suite(d):
                lres, costs = [], []
                for start in range(2):
                    s, b, retried = nist_suite_run(mod, nist, nist_runner,
                                                   nprob, start, extra)
                    lre = nist.compute_lre(b, nprob.certified)
                    print(f"{pkg} NIST {nprob.name} start {start + 1}: LRE "
                          f"{lre!r}, {s.num_iterations} LM{retried}, final "
                          f"cost {s.final_cost!r}", flush=True)
                    lres.append(lre)
                    costs.append(s.final_cost)
                nref[nprob.name] = (lres, costs)
            refs["NIST_REF"] = nref

        if "capi" in parts:
            data = cs.c_api_data()
            cost = c_api.CERES_COST_FUNC_T(_c_cost)
            loss = c_api.CERES_LOSS_FUNC_T(_c_cauchy)
            keep = (ctypes.c_double * 1)(0.5)
            pid = c_api.create_problem()
            m, c = np.array([0.0]), np.array([0.0])
            for i in range(len(data)):
                c_api.add_residual_block(
                    pid, ctypes.cast(cost, ctypes.c_void_p).value,
                    data[i].ctypes.data,
                    ctypes.cast(loss, ctypes.c_void_p).value,
                    ctypes.addressof(keep), 1, [1, 1],
                    [m.ctypes.data, c.ctypes.data])
            t0 = time.time()
            report = (c_api.solve(pid) if pkg == "jax"
                      else c_api.solve(pid, device="cpu"))
            print(f"{pkg} C_API: {report}; m {m[0]!r}, c {c[0]!r}, wall "
                  f"{time.time() - t0:.1f} s", flush=True)
            refs["C_API_REF"] = dict(m=float(m[0]), c=float(c[0]))
            c_api.free_problem(pid)

        if "ransac" in parts:
            x1, x2, _, _ = trh.synthetic_correspondences(
                cs.RANSAC_N, cs.RANSAC_OUTLIERS)
            samples, hs = trh.hypotheses(x1, x2, cs.RANSAC_HYPOTHESES, 0)
            t0 = time.time()
            probs = [build_refine(x1[idx], x2[idx], h)
                     for idx, h in zip(samples, hs)]
            opts = mod.SolverOptions(max_num_iterations=20,
                                     function_tolerance=1e-10,
                                     batch_mode="batch", **extra)
            ss = mod.solve_batched(opts, probs)
            counts = np.array([s.num_iterations for s in ss])
            costs = [s.final_cost for s in ss]
            print(f"{pkg} BATCH_RANSAC: {len(ss)} elements, counts "
                  f"{dict(zip(*np.unique(counts, return_counts=True)))}, "
                  f"largest initial cost "
                  f"{max(s.initial_cost for s in ss):.3e}, largest final "
                  f"cost {max(costs):.3e}, {ss[0].message}, wall "
                  f"{time.time() - t0:.1f} s", flush=True)
            spread = 0
            for scale in ((1 - 1e-12, 1 + 1e-12) if args.spread else ()):
                for h, h0 in zip(hs, trh.hypotheses(x1, x2, len(hs), 0)[1]):
                    h[:] = h0 * scale
                c2 = np.array([s.num_iterations
                               for s in mod.solve_batched(opts, probs)])
                print(f"{pkg} BATCH_RANSAC from h x {scale!r}: "
                      f"{int((c2 != counts).sum())} counts differ, by "
                      f"{int(np.abs(c2 - counts).max())} at most",
                      flush=True)
                spread = max(spread, int(np.abs(c2 - counts).max()))
            for h, hh in zip(hs, cs.ransac_moved_starts(
                    trh.hypotheses(x1, x2, len(hs), 0)[1])):
                h[:] = hh
            mss = mod.solve_batched(opts, probs)
            mc = [s.num_iterations for s in mss]
            print(f"{pkg} BATCH_RANSAC_MOVED: counts "
                  f"{dict(zip(*np.unique(mc, return_counts=True)))}, digest "
                  f"{cs.counts_digest(mc)}, largest final cost "
                  f"{max(s.final_cost for s in mss):.3e}", flush=True)
            mf = np.array([s.final_cost for s in mss])
            refs["RANSAC_MOVED_REF"] = dict(
                digest=cs.counts_digest(mc),
                large={int(i): float(mf[i]) for i in
                       np.nonzero(mf > cs.RANSAC_MOVED_SMALL)[0]},
                small_max=float(mf[mf <= cs.RANSAC_MOVED_SMALL].max()))
            for scale in ((1 - 1e-12, 1 + 1e-12) if args.spread else ()):
                for h, hh in zip(hs, cs.ransac_moved_starts(
                        trh.hypotheses(x1, x2, len(hs), 0)[1])):
                    h[:] = hh * scale
                c2 = np.array([s.num_iterations
                               for s in mod.solve_batched(opts, probs)])
                print(f"{pkg} BATCH_RANSAC_MOVED from x {scale!r}: "
                      f"{int((c2 != np.asarray(mc)).sum())} counts differ",
                      flush=True)
            ones = int(np.bincount(counts).argmax())
            refs["RANSAC_REF"] = dict(
                common=ones, others={int(i): int(counts[i]) for i in
                                     np.nonzero(counts != ones)[0]},
                max_final_cost=max(costs), spread=spread)

        if "batch_ba" in parts:
            elems = cs.batch_ba_problems(mod, bal_io)
            t0 = time.time()
            ss = mod.solve_batched(cs.batch_ba_options(mod, **extra),
                                   [p for p, _ in elems])
            counts = [s.num_iterations for s in ss]
            costs = [s.final_cost for s in ss]
            print(f"{pkg} BATCH_BA: counts "
                  f"{dict(zip(*np.unique(counts, return_counts=True)))}, "
                  f"costs {min(costs)!r} .. {max(costs)!r}, "
                  f"{ss[0].message}, wall {time.time() - t0:.1f} s",
                  flush=True)
            refs["BATCH_BA_REF"] = dict(iterations=counts, costs=costs)

        if "denoise" in parts:
            pgm, foe = cs.denoise_inputs(tmp)
            img = read_pgm(pgm)
            t0 = time.time()
            problem, pixels = denoising.build_denoising_problem(
                img, denoising.FieldsOfExperts(foe))
            tb = time.time() - t0
            start = [p.copy() for row in pixels for p in row]
            runs = {}
            for scale in ((1.0, 1 - 1e-10, 1 + 1e-10) if args.spread
                          else (1.0,)):
                for p, p0 in zip((p for row in pixels for p in row), start):
                    p[:] = p0 * scale
                t0 = time.time()
                s = mod.solve(cs.denoise_options(mod, **extra), problem)
                line(f"DENOISING (start x {scale!r})", s, time.time() - t0,
                     f", built in {tb:.1f} s")
                runs[scale] = s.final_cost
            refs["DENOISE_REF"] = dict(
                final_cost=runs[1.0], cost_spread=max(
                    abs(c - runs[1.0]) / runs[1.0] for c in runs.values()))

        if "libmv" in parts:
            path = os.path.join(tmp, "problem_shape_01.bin")
            if not os.path.exists(path):
                write_libmv_test_problem(path, tlba.synthetic_libmv_problem(
                    **cs.LIBMV_SHAPE))
            lref = {}
            for flags, label in ((0, "LIBMV"), (15, "LIBMV_REFINE")):
                runs = {}
                for scale in ((1.0, 1 - 1e-10, 1 + 1e-10) if args.spread
                              else (1.0,)):
                    problem, intr, cams, pts = lba.build_libmv_problem(
                        read_libmv_problem(path), flags)
                    for a in list(cams.values()) + list(pts.values()):
                        a *= scale
                    opts = mod.SolverOptions(
                        linear_solver_type=mod.LinearSolverType
                        .ITERATIVE_SCHUR,
                        preconditioner_type=mod.PreconditionerType
                        .SCHUR_JACOBI, use_inner_iterations=True,
                        max_num_iterations=100, **extra)
                    t0 = time.time()
                    s = mod.solve(opts, problem)
                    line(f"{label} (start x {scale!r})", s, time.time() - t0,
                         f", {s.num_inner_iteration_steps} inner steps, "
                         f"{s.message}")
                    runs[scale] = s
                s = runs[1.0]
                lref[label] = dict(
                    iterations=s.num_iterations, final_cost=s.final_cost,
                    spread=max(abs(r.num_iterations - s.num_iterations)
                               for r in runs.values()),
                    cost_spread=max(abs(r.final_cost - s.final_cost)
                                    / s.final_cost for r in runs.values()))
            refs["LIBMV_REF"] = lref

        if "pipeline" in parts:
            pref = {}
            for seed, (problem, _) in zip(cs.PIPELINE_SEEDS,
                                          cs.pipeline_problems(bal_io)):
                opts = cs.huber_options(mod, use_mixed_precision_solves=False,
                                        **extra)
                t0 = time.time()
                s = mod.solve(opts, problem)
                line(f"PIPELINE seed {seed} (f64 DENSE_SCHUR)", s,
                     time.time() - t0)
                pref[seed] = s.final_cost
            refs["PIPELINE_REF"] = pref
    print(json.dumps(out))


def nist_suite_run(mod, nist, nist_runner, nprob, start, extra):
    """One start of examples/nist_runner.py run_suite, with its retry, in
    package `mod`: (summary, parameters, retry note)."""
    def options(strategy):
        return mod.SolverOptions(
            linear_solver_type=mod.LinearSolverType.DENSE_QR,
            trust_region_strategy_type=strategy,
            dogleg_type=mod.DoglegType.TRADITIONAL_DOGLEG,
            max_num_iterations=10000, function_tolerance=1e-18,
            gradient_tolerance=1e-18, parameter_tolerance=1e-18,
            initial_trust_region_radius=1e4, **extra)

    problem, b = nist.build_nist_problem(nprob, start)
    s = mod.solve(options(mod.TrustRegionStrategyType.LEVENBERG_MARQUARDT),
                  problem)
    degenerate = (nist_runner._degenerate_column(problem, "cpu") if extra
                  else nist_runner._degenerate_column(problem))
    if s.termination_type != mod.TerminationType.CONVERGENCE or degenerate:
        problem2, b2 = nist.build_nist_problem(nprob, start)
        s2 = mod.solve(options(mod.TrustRegionStrategyType.DOGLEG),
                       problem2)
        if (s2.termination_type == mod.TerminationType.CONVERGENCE
                and s2.final_cost < s.final_cost):
            return s2, b2, " [dogleg retry]"
    return s, b, ""


def _c_cost(user_data, params, residuals, jacobians):
    """curve_fitting.c's exponential_residual."""
    row = ctypes.cast(user_data, ctypes.POINTER(ctypes.c_double))
    x, y = row[0], row[1]
    e = math.exp(params[0][0] * x + params[1][0])
    residuals[0] = y - e
    if jacobians:
        if jacobians[0]:
            jacobians[0][0] = -x * e
        if jacobians[1]:
            jacobians[1][0] = -e
    return 1


def _c_cauchy(user_data, s, out):
    """The C shim's stock Cauchy loss (ceres_stock_loss_function) with a
    = *user_data: b = a^2, rho = b log(1 + s/b), rho' = 1 / (1 + s/b),
    rho'' = -rho'^2 / b."""
    a = ctypes.cast(user_data, ctypes.POINTER(ctypes.c_double))[0]
    b = a * a
    total = 1.0 + s / b
    inv = 1.0 / total
    out[0] = b * math.log(total)
    out[1] = inv
    out[2] = -inv * inv / b


if __name__ == "__main__":
    main()
