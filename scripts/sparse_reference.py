#!/usr/bin/env python3
"""The sparse paths of chip_smoke.py (slice 8) on the CPU, in both packages.

    JAX_PLATFORMS=cpu python3 scripts/sparse_reference.py
        [--packages jax,torch] [--paths se3_2500,se2_3500,mixed,subset,se2]
        [--threads 1]

se3_2500, se2_3500: SPARSE_GRAPHS (the 2,500-pose SE3 and 3,500-pose SE2
graphs) with sparse_options (SPARSE_NORMAL_CHOLESKY, f64, the host loop).
mixed: POSE_GRAPHS["3d"] (2,000 poses) with pose_graph_options and
SPARSE_NORMAL_CHOLESKY (mixed, fused). subset: POSE_GRAPHS["2d"] (1,000
poses) with CGNR + SUBSET on the first SUBSET_ROWS residual blocks, fused,
f64 in the JAX package (its mixed CGNR + SUBSET does not trace) and mixed
and f64 in the port. se2: POSE_GRAPHS["2d"] with sparse_options, static
and with dynamic_sparsity, then Covariance with SPARSE_QR on the pairs of
COVARIANCE_POSES at the static solve's end (printed as one JSON line).

The JAX package runs on the CPU (its XLA path: no Pallas kernel runs on
the CPU; the native LDL^T through its host callback); the port on the CPU
with --threads threads (the plain versions of its kernels, the same
native LDL^T). Prints one line per solve: termination, LM iterations
(the host loop's summary counts iteration 0 too: its num_iterations is
one more), accepted steps, linear solver iterations, initial and final
cost (repr), the mean position error before and after and their ratio,
wall. The JAX package's numbers are chip_smoke.py's references. Takes
several minutes and a few GB.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default="se3_2500,se2_3500,mixed,subset,se2")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import (POSE_GRAPHS, SPARSE_GRAPHS, covariance_pairs,
                            lm_iterations, pose_graph_options,
                            position_error, sparse_options, subset_options)

    mods = {}
    if "jax" in args.packages.split(","):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import ceres_tpu as ct
        from ceres_tpu.examples import slam
        from ceres_tpu.io import g2o
        mods["ceres_tpu"] = (ct, slam, g2o, {})
    if "torch" in args.packages.split(","):
        import torch
        torch.set_num_threads(args.threads)
        import ceres_tpu_torch as ctt
        from ceres_tpu_torch.examples import slam
        from ceres_tpu_torch.io import g2o
        mods[f"ceres_tpu_torch ({args.threads} thread(s))"] = (
            ctt, slam, g2o, {"device": "cpu"})
    paths = args.paths.split(",")

    for name, (mod, slam, g2o, extra) in mods.items():
        def build(spec):
            poses, edges, gt = getattr(g2o, spec["generator"])(
                **spec["args"])
            problem, positions, rotations = getattr(slam, spec["build"])(
                poses, edges)
            return problem, positions, rotations, gt

        def run(label, options, built):
            problem, positions, _, gt = built
            err0 = position_error(positions, gt)
            t0 = time.time()
            s = mod.solve(options, problem)
            wall = time.time() - t0
            err = position_error(positions, gt)
            print(f"{name} {label}: {s.termination_type}, "
                  f"{lm_iterations(s)} LM iterations "
                  f"({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} linear solver "
                  f"iterations, initial cost {s.initial_cost!r}, final cost "
                  f"{s.final_cost!r}, mean position error {err0!r} -> "
                  f"{err!r} (share {err / err0!r}), wall {wall:.1f} s",
                  flush=True)
            return s

        for key, tag in (("SE3_2500_SNC", "se3_2500"),
                         ("SE2_3500_SNC", "se2_3500")):
            if tag in paths:
                run(key, sparse_options(mod, **extra),
                    build(SPARSE_GRAPHS[key]))
        snc = mod.LinearSolverType.SPARSE_NORMAL_CHOLESKY
        if "mixed" in paths:
            run("SE3_2000_SNC_MIXED", pose_graph_options(
                mod, linear_solver_type=snc, **extra),
                build(POSE_GRAPHS["3d"]))
        if "subset" in paths:
            precisions = [False] if mod.__name__ == "ceres_tpu" else [True,
                                                                      False]
            for mixed in precisions:
                built = build(POSE_GRAPHS["2d"])
                run(f"SE2_1000_SUBSET ({'mixed' if mixed else 'f64'})",
                    subset_options(mod, built[0],
                                   use_mixed_precision_solves=mixed,
                                   **extra), built)
        if "se2" in paths:
            run("SE2_1000_DYNAMIC", sparse_options(
                mod, dynamic_sparsity=True, **extra),
                build(POSE_GRAPHS["2d"]))
            built = build(POSE_GRAPHS["2d"])
            run("SE2_1000_SNC (static)", sparse_options(mod, **extra), built)
            problem, positions, yaws, _ = built
            cov_kw = dict(algorithm_type=mod.CovarianceAlgorithmType
                          .SPARSE_QR)
            if "device" in extra:
                cov_kw["device"] = extra["device"]
            cov = mod.Covariance(mod.CovarianceOptions(**cov_kw))
            t0 = time.time()
            pairs = covariance_pairs(positions, yaws)
            if not cov.compute(pairs, problem):
                raise SystemExit(f"covariance failed: {cov.message}")
            blocks = [cov.get_covariance_block(a, b).tolist()
                      for a, b in pairs]
            print(f"{name} COVARIANCE_SE2_1000 (SPARSE_QR, "
                  f"{time.time() - t0:.1f} s): {json.dumps(blocks)}",
                  flush=True)


if __name__ == "__main__":
    main()
