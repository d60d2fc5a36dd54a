#!/usr/bin/env python3
"""The default-Solve paths of chip_smoke.py on the CPU, in both packages.

    JAX_PLATFORMS=cpu python3 scripts/default_solve_reference.py
        [--packages jax,torch] [--paths huber,cauchy,se2] [--threads 1]
        [--start-scale 1.0 ...]

huber, cauchy: the main path's problem (BAL-16-22106,
synthetic_bal_problem seed 7, PERTURB seed 8) with HuberLoss(1.0) or
CauchyLoss(2.0) on every observation (ROBUST_PATHS), solved with
chip_smoke.py's DENSE_SCHUR options (mixed, fused loop); --start-scale
scales the perturbed start by each factor (1 - 1e-7 and 1 + 1e-7 give
the spread of the final cost that the gate must allow).
se2: the 1,000-pose SE2 graph of POSE_GRAPHS["2d"] under Ceres's default
options (LM, DENSE_QR, f64, the host loop), then with
DENSE_NORMAL_CHOLESKY and with SUBSPACE_DOGLEG (SE2_DEFAULT_PATHS).

The JAX package runs on the CPU (its XLA path: no Pallas kernel runs on
the CPU); the port on the CPU with --threads threads (the plain versions
of its kernels). Prints one line per solve: termination, LM iterations
(the host loop's summary counts iteration 0 too: its num_iterations is
one more), accepted steps, initial and final cost (repr), wall. The JAX
package's final costs are chip_smoke.py's references. Takes a few
minutes and under 2 GB.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--paths", default="huber,cauchy,se2")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--start-scale", type=float, nargs="+", default=[1.0])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import (PERTURB, POSE_GRAPHS, ROBUST_PATHS,
                            SE2_DEFAULT_PATHS, SHAPE, default_options,
                            huber_options, lm_iterations)

    mods = {}
    if "jax" in args.packages.split(","):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import ceres_tpu as ct
        from ceres_tpu.examples import slam
        from ceres_tpu.io import bal, g2o
        mods["ceres_tpu"] = (ct, slam, g2o, bal, {})
    if "torch" in args.packages.split(","):
        import torch
        torch.set_num_threads(args.threads)
        import ceres_tpu_torch as ctt
        from ceres_tpu_torch.examples import slam
        from ceres_tpu_torch.io import bal, g2o
        mods[f"ceres_tpu_torch ({args.threads} thread(s))"] = (
            ctt, slam, g2o, bal, {"device": "cpu"})
    paths = args.paths.split(",")
    for name, (mod, slam, g2o, bal, extra) in mods.items():
        runs = []
        for loss_name in ("huber", "cauchy"):
            if loss_name not in paths:
                continue
            cfg = ROBUST_PATHS[f"DENSE_SCHUR_{loss_name.upper()}"]
            loss_cls = getattr(mod, cfg["loss"])
            for scale in args.start_scale:
                b = bal.synthetic_bal_problem(**SHAPE, seed=7,
                                              pixel_noise=1.0)
                b.perturb(**PERTURB, seed=8)
                problem, cams, pts = bal.build_bal_ceres_problem(
                    b, loss=loss_cls(cfg["a"]))
                for a in cams + pts:
                    a *= scale
                runs.append((f"BAL-16-22106 DENSE_SCHUR + "
                             f"{cfg['loss']}({cfg['a']}), start x {scale!r}",
                             huber_options(mod, **extra), problem))
        if "se2" in paths:
            spec = POSE_GRAPHS["2d"]
            for path, cfg in SE2_DEFAULT_PATHS.items():
                poses, edges, gt = getattr(g2o, spec["generator"])(
                    **spec["args"])
                problem = getattr(slam, spec["build"])(poses, edges)[0]
                runs.append((f"{path} ({len(poses)} poses)",
                             default_options(mod, cfg, **extra), problem))
        for label, options, problem in runs:
            t0 = time.time()
            s = mod.solve(options, problem)
            print(f"{name} {label}: {s.termination_type}, "
                  f"{lm_iterations(s)} LM iterations "
                  f"({s.num_successful_steps} accepted), "
                  f"{s.num_linear_solver_iterations} linear solver "
                  f"iterations, initial cost {s.initial_cost!r}, final cost "
                  f"{s.final_cost!r}, wall {time.time() - t0:.1f} s",
                  flush=True)


if __name__ == "__main__":
    main()
