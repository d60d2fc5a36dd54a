#!/usr/bin/env python3
"""Pose-graph CGNR solves of chip_smoke.py on the CPU, in both packages.

    JAX_PLATFORMS=cpu python3 scripts/pose_graph_reference.py
        [--packages jax,torch] [--graphs 3d,2d] [--threads 1]
        [--num-poses N] [--loop-every L] [--max-iterations M]

Builds the two pose graphs of chip_smoke.py (io/g2o.py's synthetic
generators: 3D with 2,000 poses, loop_every=5, seed 2; 2D with 1,000
poses, loop_every=15, seed 1) and solves each with chip_smoke.py's
options (LM, CGNR + JACOBI, mixed precision, fused loop, 100
iterations) in ceres_tpu on the CPU (its XLA path: no Pallas kernel runs
on the CPU) and in ceres_tpu_torch on the CPU (the plain PyTorch versions
of its kernels, with --threads CPU threads). Prints one line per solve:
termination, LM iterations, accepted steps, CG iterations, initial and
final cost, and the mean position error against ground truth before and
after. The JAX package's final costs are chip_smoke.py's references.
--num-poses, --loop-every and --max-iterations change the graphs and the
LM iteration cap (the sizing runs of PERF.md). Takes a few minutes and
under 2 GB at the default sizes.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--graphs", default="3d,2d")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--num-poses", type=int, default=None)
    ap.add_argument("--loop-every", type=int, default=None)
    ap.add_argument("--max-iterations", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import POSE_GRAPHS, pose_graph_options, position_error

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
    for name, (mod, slam, g2o, extra) in mods.items():
        for graph in args.graphs.split(","):
            spec = POSE_GRAPHS[graph]
            gen_args = dict(spec["args"])
            if args.num_poses:
                gen_args["num_poses"] = args.num_poses
            if args.loop_every:
                gen_args["loop_every"] = args.loop_every
            if args.max_iterations:
                extra = dict(extra, max_num_iterations=args.max_iterations)
            poses, constraints, gt = getattr(
                g2o, spec["generator"])(**gen_args)
            problem, positions, _ = getattr(slam, spec["build"])(
                poses, constraints)
            err0 = position_error(positions, gt)
            t0 = time.time()
            s = mod.solve(pose_graph_options(mod, **extra), problem)
            print(f"{name} {graph} ({gen_args['num_poses']} poses, "
                  f"loop_every {gen_args['loop_every']}, "
                  f"{len(constraints)} edges): "
                  f"{s.termination_type}, "
                  f"{s.num_iterations} LM iterations "
                  f"({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} CG iterations, "
                  f"initial cost {s.initial_cost!r}, final cost "
                  f"{s.final_cost!r}, position error {err0:.6f} -> "
                  f"{position_error(positions, gt):.6f}, "
                  f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
