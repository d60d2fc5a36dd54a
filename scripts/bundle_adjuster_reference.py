#!/usr/bin/env python3
"""The bundle_adjuster paths of chip_smoke.py (slice 9) on the CPU, in
both packages.

    JAX_PLATFORMS=cpu python3 scripts/bundle_adjuster_reference.py
        [--packages jax,torch] [--paths ba,quat,trafalgar] [--spread]
        [--fused] [--threads 1]

ba: BA_PATHS on the main path's problem (BAL-16-22106, seed 7,
PERTURB), f64, ba_options, the host loop. quat: QUAT_BA_PATHS on
quaternion_bal's problem on the quaternion x Euclidean(6) product
manifold. trafalgar: TRAFALGAR, the bundle_adjuster example's main on
TRAFALGAR_ARGS (Trafalgar's shape, its defaults: f64, SPARSE_SCHUR +
JACOBI, 5 iterations), and with --mixed_precision_solves.

The JAX package runs on the CPU on its generic Schur route
(CERES_TPU_NO_FUSED_SCHUR set, the route the port takes; at Trafalgar's
shape its SPARSE_SCHUR takes the block-sparse path by itself). --fused
also runs the ba and quat paths on the JAX package's fused route (its
f64 fused step, which the port does not have: ROADMAP.md section 3).
--spread runs the ITERATIVE path and the mixed paths again from the
start scaled by 1 - 1e-7 and 1 + 1e-7 (chip_smoke's gates are twice
that spread). The port runs on the CPU with --threads threads. Prints
one line per solve: LM iterations (the host loop's summary counts
iteration 0 too: its num_iterations is one more), linear solver
iterations, final cost (repr), relative distance to the unscaled run,
wall. The JAX package's numbers are chip_smoke.py's references. The
Trafalgar runs take a few minutes and a few GB.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lm(summary):
    return (len(summary.iterations) - 1 if summary.iterations
            else summary.num_iterations)


def report(pkg, label, summary, wall, ref=None):
    rel = ("" if ref is None else
           f", {abs(summary.final_cost - ref) / ref:.3e} from the unscaled")
    print(f"{pkg} {label}: {summary.termination_type}, {lm(summary)} LM, "
          f"{summary.num_linear_solver_iterations} linear iterations, final "
          f"cost {summary.final_cost!r}{rel}, wall {wall:.1f} s", flush=True)


def scaled(arrays, scale):
    for a in arrays:
        a *= scale


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default="ba,quat,trafalgar")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import (BA_PATHS, PERTURB, QUAT_BA_PATHS, SHAPE,
                            TRAFALGAR, TRAFALGAR_ARGS, ba_options,
                            quaternion_bal)
    paths = args.paths.split(",")
    packages = args.packages.split(",")
    scales = (1.0, 1.0 - 1e-7, 1.0 + 1e-7)

    for pkg in packages:
        if pkg == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import ceres_tpu as mod
            from ceres_tpu.examples import bundle_adjuster as example
            from ceres_tpu.io import bal as bal_io
            routes = ["generic"] + (["fused"] if args.fused else [])
        else:
            import torch
            torch.set_num_threads(args.threads)
            import ceres_tpu_torch as mod
            from ceres_tpu_torch.examples import bundle_adjuster as example
            from ceres_tpu_torch.io import bal as bal_io
            routes = ["port"]
        extra = {} if pkg == "jax" else {"device": "cpu"}

        def solve(label, cfg, make, spread):
            for route in routes:
                if route == "generic":
                    os.environ["CERES_TPU_NO_FUSED_SCHUR"] = "1"
                else:
                    os.environ.pop("CERES_TPU_NO_FUSED_SCHUR", None)
                ref = None
                for scale in (scales if spread else scales[:1]):
                    problem, arrays = make()
                    scaled(arrays, scale)
                    t0 = time.time()
                    s = mod.solve(ba_options(mod, cfg, **extra), problem)
                    report(pkg, f"{label} ({route}, start x {scale!r})", s,
                           time.time() - t0, ref)
                    ref = s.final_cost if ref is None else ref
            os.environ.pop("CERES_TPU_NO_FUSED_SCHUR", None)

        if "ba" in paths:
            bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7,
                                               pixel_noise=1.0)
            bal.perturb(**PERTURB, seed=8)

            def make_ba():
                p, cams, pts = bal_io.build_bal_ceres_problem(bal)
                return p, cams + pts
            for label, cfg in BA_PATHS.items():
                solve(label, cfg, make_ba, args.spread
                      and label == "BA_ITERATIVE_SCHUR")
        if "quat" in paths:
            qbal = quaternion_bal(bal_io)

            def make_quat():
                p, cams, pts = bal_io.build_bal_ceres_problem(
                    qbal, use_quaternions=True, use_manifolds=True)
                return p, cams + pts
            for label, cfg in QUAT_BA_PATHS.items():
                solve(label, cfg, make_quat, args.spread and "MIXED" in label)
        if "trafalgar" in paths:
            dev = [] if pkg == "jax" else ["--device", "cpu"]
            for label, cfg in TRAFALGAR.items():
                t0 = time.time()
                s = example.main(TRAFALGAR_ARGS + cfg["args"] + dev)
                report(pkg, f"{label} (example main)", s, time.time() - t0)
                if args.spread and cfg["args"]:
                    ref = s.final_cost
                    flags = example_flags(TRAFALGAR_ARGS + cfg["args"] + dev,
                                          pkg)
                    for scale in scales[1:]:
                        # the example's problem, rebuilt, its start scaled
                        bal = bal_io.synthetic_bal_problem(
                            257, 65132, 225911, seed=7, pixel_noise=1.0)
                        bal.normalize()
                        bal.perturb(**PERTURB, seed=7)
                        p, cams, pts = bal_io.build_bal_ceres_problem(bal)
                        scaled(cams + pts, scale)
                        t0 = time.time()
                        s = mod.solve(example.build_options(mod, flags), p)
                        report(pkg, f"{label} (start x {scale!r})", s,
                               time.time() - t0, ref)


def example_flags(argv, pkg):
    """The example's parsed flags (the JAX example parses them inside its
    main; its flags are the port's but --device)."""
    from ceres_tpu_torch.examples.bundle_adjuster import parse_args
    flags = parse_args(argv)
    if pkg == "jax":
        del flags.device
    return flags


if __name__ == "__main__":
    main()
