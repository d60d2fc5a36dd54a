#!/usr/bin/env python3
"""Both packages on the CPU at the full BAL-16-22106 size.

    JAX_PLATFORMS=cpu python3 scripts/parity_full_size.py

Builds chip_smoke.py's problem (seed 7, PERTURB seed 8) into ceres_tpu
and ceres_tpu_torch and solves it with chip_smoke.py's options, with
DENSE_SCHUR and with ITERATIVE_SCHUR + SCHUR_JACOBI, in each package on
the CPU (ceres_tpu: its XLA lin phase and the Pallas PCG kernel in
interpret mode; ceres_tpu_torch: the plain PyTorch versions of its
kernels, once with 1 and once with 4 CPU threads, which sum in another
order). Prints one line per solve: termination, LM iterations, accepted
steps, linear solver iterations, initial and final cost. Like
the parity tests, it imports both packages; ceres_tpu_torch itself never
imports jax. Takes about a minute and a half and under 2 GB.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    import ceres_tpu as ct
    import ceres_tpu_torch as ctt
    from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
    from ceres_tpu.io.bal import synthetic_bal_problem
    from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build
    from chip_smoke import PERTURB, SHAPE

    bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    runs = [(ct, jax_build, {}, "")] + [
        (ctt, torch_build, {"device": "cpu"}, f", {n} thread(s)")
        for n in (1, 4)]
    for mod, build, extra, label in runs:
        if mod is ctt:
            torch.set_num_threads(int(label.split()[1]))
        for solver in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
            options = mod.SolverOptions(
                linear_solver_type=getattr(mod.LinearSolverType, solver),
                preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
                max_num_iterations=50, function_tolerance=1e-6,
                max_linear_solver_iterations=100,
                use_mixed_precision_solves=True, fused_iterations=True,
                **extra)
            t0 = time.time()
            s = mod.solve(options, build(bal)[0])
            print(f"{mod.__name__}{label} {solver}: {s.termination_type}, "
                  f"{s.num_iterations} LM iterations "
                  f"({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} linear solver "
                  f"iterations, initial cost {s.initial_cost!r}, final cost "
                  f"{s.final_cost!r} ({time.time() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
