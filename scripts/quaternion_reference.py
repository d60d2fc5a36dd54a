#!/usr/bin/env python3
"""Quaternion-camera BA solves of chip_smoke.py on the CPU, in both packages.

    JAX_PLATFORMS=cpu python3 scripts/quaternion_reference.py
        [--packages jax,torch] [--paths QUAT_DENSE_SCHUR,...] [--threads 1]

Builds chip_smoke.py's quaternion problem (the BAL-16-22106 synthetic
problem of seed 7 with its cameras written as w-first quaternions, then
perturbed with PERTURB, seed 8; Euclidean quaternion blocks, as Ceres's
bundle_adjuster -use_quaternions runs by default) and solves it with the
options of each of chip_smoke.py's QUAT_PATHS (LM, mixed precision, fused
loop; DENSE_SCHUR, ITERATIVE_SCHUR + SCHUR_JACOBI, DENSE_SCHUR with
HuberLoss(1.0) and a cap of 100 iterations) in ceres_tpu on the CPU (its
generic jacfwd lin phase: no Pallas kernel runs on the CPU) and in
ceres_tpu_torch on the CPU (the plain PyTorch versions of its kernels,
with --threads CPU threads). Prints one line per solve: termination, LM
iterations, accepted steps, linear solver iterations, initial and final
cost, wall. The JAX package's LM counts and final costs are
chip_smoke.py's references. About 10-20 s per JAX solve and 1-2 GB.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default=None)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import QUAT_PATHS, quaternion_bal, quaternion_options

    mods = {}
    if "jax" in args.packages.split(","):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import ceres_tpu as ct
        from ceres_tpu.io import bal as bal_module
        mods["ceres_tpu"] = (ct, bal_module, {})
    if "torch" in args.packages.split(","):
        import torch
        torch.set_num_threads(args.threads)
        import ceres_tpu_torch as ctt
        from ceres_tpu_torch.io import bal as bal_module
        mods[f"ceres_tpu_torch ({args.threads} thread(s))"] = (
            ctt, bal_module, {"device": "cpu"})
    paths = args.paths.split(",") if args.paths else list(QUAT_PATHS)
    for name, (mod, bal_module, extra) in mods.items():
        for path in paths:
            huber = QUAT_PATHS[path]["huber"]
            loss = None if huber is None else mod.HuberLoss(huber)
            problem = bal_module.build_bal_ceres_problem(
                quaternion_bal(bal_module), loss=loss, use_quaternions=True,
                use_manifolds=False)[0]
            t0 = time.time()
            s = mod.solve(quaternion_options(mod, path, **extra), problem)
            print(f"{name} {path}: {s.termination_type}, "
                  f"{s.num_iterations} LM iterations "
                  f"({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} linear solver "
                  f"iterations, initial cost {s.initial_cost!r}, final cost "
                  f"{s.final_cost!r}, wall {time.time() - t0:.1f} s",
                  flush=True)


if __name__ == "__main__":
    main()
