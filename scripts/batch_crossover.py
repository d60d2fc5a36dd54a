#!/usr/bin/env python3
"""Walls of solve_batched's two modes on one card, the data that
batch.py's BATCH_CROSSOVER_RESIDUALS is read from.

    python3 scripts/batch_crossover.py [--batch 8] [--repeats 3]
        [--device cuda]

At three of benchmarks/batch_benchmark.py's sizes (cameras, points,
observations: (4, 125, 500), (8, 2,500, 10,000), (16, 11,000, 44,000)),
K seeded BA problems of one graph (seed 11, pixel noise 0.5, each
perturbed with its own seed as the benchmark perturbs them) are solved
by ceres_tpu_torch.solve_batched with the benchmark's options (mixed
DENSE_SCHUR, fused, 40 iterations, function tolerance 1e-6), in batch and
in pipeline mode: one warm-up call a mode, then `--repeats` timed calls
of each mode in turns (batch, pipeline, pipeline, batch, ...), each wall
CUDA-synchronised, the problems built before the clock starts and their
states reset between calls. Prints the card's name and power limit, one
line a call, and one JSON line a size (min and median walls a mode, the
faster mode, the LM counts of both); the last line names the largest
size, in residuals an element, at which batch mode was faster.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(4, 125, 500), (8, 2500, 10000), (16, 11000, 44000)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    best_batch = 0
    for nc, npts, nobs in SIZES:
        elems = []
        for seed in range(args.batch):
            bal = synthetic_bal_problem(num_cameras=nc, num_points=npts,
                                        num_observations=nobs, seed=11,
                                        pixel_noise=0.5)
            bal.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                        point_sigma=0.1, seed=seed)
            problem, cams, pts = build_bal_ceres_problem(bal)
            elems.append((problem, cams + pts,
                          [a.copy() for a in cams + pts]))

        def run(mode):
            for _, arrs, start in elems:
                for a, a0 in zip(arrs, start):
                    a[:] = a0
            opts = ctt.SolverOptions(
                linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                use_mixed_precision_solves=True, max_num_iterations=40,
                function_tolerance=1e-6, fused_iterations=True,
                batch_mode=mode, device=args.device)
            sync()
            t0 = time.time()
            sums = ctt.solve_batched(opts, [p for p, _, _ in elems])
            sync()
            return time.time() - t0, sums

        for mode in ("batch", "pipeline"):
            run(mode)                                   # warm-up
        walls = {"batch": [], "pipeline": []}
        counts = {}
        for r in range(args.repeats):
            order = (("batch", "pipeline") if r % 2 == 0
                     else ("pipeline", "batch"))
            for mode in order:
                wall, sums = run(mode)
                walls[mode].append(wall)
                counts[mode] = [s.num_iterations for s in sums]
                ok = all(s.termination_type
                         == ctt.TerminationType.CONVERGENCE for s in sums)
                print(f"{nc} cameras, {npts} points, {nobs} observations, "
                      f"K {args.batch}, {mode}: wall {wall:.4f} s, LM "
                      f"{counts[mode]}, converged {ok}", flush=True)
        row = {"cameras": nc, "points": npts, "observations": nobs,
               "residuals": 2 * nobs, "K": args.batch}
        for mode, ws in walls.items():
            row[f"{mode}_min_s"] = min(ws)
            row[f"{mode}_median_s"] = statistics.median(ws)
            row[f"{mode}_lm"] = counts[mode]
        row["faster"] = ("batch" if row["batch_median_s"]
                         <= row["pipeline_median_s"] else "pipeline")
        if row["faster"] == "batch":
            best_batch = max(best_batch, 2 * nobs)
        print(json.dumps(row), flush=True)
        del elems
    print(f"batch mode faster up to {best_batch} residuals an element "
          f"(sizes {SIZES}, K {args.batch})", flush=True)


if __name__ == "__main__":
    main()
