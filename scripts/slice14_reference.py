#!/usr/bin/env python3
"""The JAX package's references of chip_smoke.py's slice 14 phase
(`sharded_paths`): its sharded solves on virtual CPU devices.

    JAX_PLATFORMS=cpu python3 scripts/slice14_reference.py [--paths
        f64_dense,dense,iterative,cgnr_se2] [--spread]

f64_dense, dense, iterative: the main path's problem (BAL-16-22106,
bench.py's seed and PERTURB) solved over a mesh of SHARDED_WORLD (4)
virtual CPU devices, f64 DENSE_SCHUR with the dry run's options
(parallel/dryrun.py), and bench.py's mixed DENSE_SCHUR and
ITERATIVE_SCHUR + SCHUR_JACOBI options; cgnr_se2: the 1,000-pose SE2
graph (POSE_GRAPHS["2d"]) with CGNR in f64 over SHARDED_CGNR_WORLD (2)
devices, the JAX package's sharded CGNR host loop, and its first LM
step at the start (make_sharded_lm_step at the initial radius: the
model cost change, the step norm and the CG iterations). With --spread
the graph is also solved from starts scaled by 1 -+ SPREAD_SCALES; the
runs are grouped by their LM count ("branches"), each branch's
reference being its run from the smallest scale and its "spread" the
largest relative distance of its other runs' final costs from that
run's. Each is a few minutes of one CPU; BAL-16 is a full-size problem,
so run it on a machine with the memory (the card's, with
CUDA_VISIBLE_DEVICES= ).

Prints one line a run and, last, a JSON object of the references under
chip_smoke.py's SHARDED_REF names.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="f64_dense,dense,iterative,cgnr_se2")
    ap.add_argument("--spread", action="store_true")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh
    import ceres_tpu as ct
    import chip_smoke as cs
    from ceres_tpu.io.bal import build_bal_ceres_problem, synthetic_bal_problem

    def mesh(n):
        return Mesh(np.array(jax.devices()[:n]), axis_names=("data",))

    out = {}
    bal = synthetic_bal_problem(**cs.SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**cs.PERTURB, seed=8)
    for path in args.paths.split(","):
        scales = (0.0,) + (tuple(f * s for s in cs.SPREAD_SCALES
                                 for f in (-1, 1))
                           if args.spread and path == "cgnr_se2" else ())
        runs = []
        for scale in scales:
            if path == "cgnr_se2":
                from ceres_tpu.examples import slam
                from ceres_tpu.io import g2o
                cfg = cs.POSE_GRAPHS["2d"]
                poses, edges, _ = getattr(g2o, cfg["generator"])(
                    **cfg["args"])
                problem, positions, yaws = getattr(slam, cfg["build"])(
                    poses, edges)
                for a in list(positions.values()) + list(yaws.values()):
                    a *= 1.0 + scale
                options = cs.pose_graph_options(
                    ct, use_mixed_precision_solves=False,
                    mesh=mesh(cs.SHARDED_CGNR_WORLD))
            else:
                problem = build_bal_ceres_problem(bal)[0]
                options = cs.sharded_options(ct, path,
                                             mesh=mesh(cs.SHARDED_WORLD))
            t0 = time.time()
            s = ct.solve(options, problem)
            wall = time.time() - t0
            iters = s.num_successful_steps + s.num_unsuccessful_steps
            print(f"{path} (start scaled by 1 + {scale:g}): "
                  f"{s.termination_type}, {iters} LM iterations "
                  f"({s.num_successful_steps} accepted), final cost "
                  f"{s.final_cost!r}, {s.message}, {wall:.1f} s",
                  flush=True)
            runs.append((iters, s.final_cost, s.num_successful_steps,
                         abs(scale)))
        iters, cost, ok, _ = runs[0]
        out[path] = dict(ref_cost=cost, ref_iterations=iters,
                         ref_successful=ok)
        if len(runs) > 1:
            branches = {}
            for it in sorted({r[0] for r in runs}):
                mine = sorted((r for r in runs if r[0] == it),
                              key=lambda r: r[3])
                c0 = mine[0][1]
                branches[it] = dict(
                    ref_cost=c0, scale=mine[0][3], runs=len(mine),
                    spread=max([abs(r[1] - c0) / c0 for r in mine[1:]],
                               default=0.0))
            out[path]["branches"] = branches
        if path == "cgnr_se2":
            out[path]["first_step"] = first_step(
                ct, cs, mesh(cs.SHARDED_CGNR_WORLD))
    print(json.dumps(out))


def first_step(ct, cs, mesh):
    """The JAX package's sharded CGNR step at the SE2 graph's start and
    the initial radius: model cost change, step norm, CG iterations."""
    import jax.numpy as jnp
    from ceres_tpu.examples import slam
    from ceres_tpu.io import g2o
    from ceres_tpu.parallel.sharded import make_sharded_lm_step
    from ceres_tpu.program import CompiledProgram
    cfg = cs.POSE_GRAPHS["2d"]
    poses, edges, _ = getattr(g2o, cfg["generator"])(**cfg["args"])
    problem = getattr(slam, cfg["build"])(poses, edges)[0]
    options = cs.pose_graph_options(ct, use_mixed_precision_solves=False)
    prog = CompiledProgram(problem)
    step, shards, place = make_sharded_lm_step(prog, options, mesh)
    o = step(prog.initial_state(), jnp.asarray(
        options.initial_trust_region_radius, prog.dtype), place(shards))
    return dict(model_cost_change=float(o["model_cost_change"]),
                step_norm=float(o["step_norm"]),
                lin_iters=int(o["lin_iters"]))


if __name__ == "__main__":
    main()
