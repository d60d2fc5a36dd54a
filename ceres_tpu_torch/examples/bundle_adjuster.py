"""Bundle adjustment from the command line (the reference's
examples/bundle_adjuster.cc:72-142): a BAL problem file, or a synthetic
problem, solved under the linear solver, preconditioner, trust-region
strategy, manifold, robust loss and precision that the flags name.

Counterpart of ceres_tpu/examples/bundle_adjuster.py, with its flags and
defaults (SPARSE_SCHUR, JACOBI, f64, 5 iterations, progress on stdout),
and --device (default cuda):

    python -m ceres_tpu_torch.examples.bundle_adjuster --input problem.txt
    python -m ceres_tpu_torch.examples.bundle_adjuster \\
        --synthetic_cameras 257 --synthetic_points 65132 \\
        --synthetic_observations 225911

With no --input, a synthetic BAL problem is generated
(--synthetic_cameras / _points / _observations, seeded by
--random_seed), since BAL data files are not in the repository.
--initial_ply / --final_ply write the cameras and points as a point
cloud (bundle_adjuster.cc WriteToPLYFile). --line_search runs the
line-search minimizer (L-BFGS with Wolfe searches, the defaults) instead
of the trust region; --inner_iterations refines each step by block
coordinate descent (minimizers/coordinate_descent.py); --preconditioner
cluster_jacobi / cluster_tridiagonal cluster the cameras by visibility
(solvers/clustering.py, --visibility_clustering canonical_views or
single_linkage). --num_devices N > 1 solves over N ranks
(SolverOptions.mesh = N): inside an initialized torch.distributed group
of world size N (torchrun) as that rank; run as a plain program, it
spawns its N ranks (parallel/launch.py run_ranks, --backend: gloo on the
CPU, nccl on the card by default) and rank 0 prints the report. Its
options print progress on stdout, a host-loop configuration, so each
rank runs the single-device route, as the JAX example does.
"""

from __future__ import annotations

import argparse
import sys
import time


def _enum(cls, name):
    return cls[name.upper()]


def build_options(ctt, args):
    from ..types import VisibilityClusteringType
    return ctt.SolverOptions(
        mesh=args.num_devices if args.num_devices > 1 else None,
        max_num_iterations=args.num_iterations,
        minimizer_type=(ctt.MinimizerType.LINE_SEARCH if args.line_search
                        else ctt.MinimizerType.TRUST_REGION),
        trust_region_strategy_type=_enum(ctt.TrustRegionStrategyType,
                                         args.trust_region_strategy),
        dogleg_type=_enum(ctt.DoglegType, args.dogleg),
        use_nonmonotonic_steps=args.nonmonotonic_steps,
        linear_solver_type=_enum(ctt.LinearSolverType, args.linear_solver),
        preconditioner_type=_enum(ctt.PreconditionerType,
                                  args.preconditioner),
        visibility_clustering_type=_enum(VisibilityClusteringType,
                                         args.visibility_clustering),
        use_explicit_schur_complement=args.explicit_schur_complement,
        use_spse_initialization=args.use_spse_initialization,
        spse_tolerance=args.spse_tolerance,
        max_num_spse_iterations=args.max_num_spse_iterations,
        eta=args.eta,
        max_linear_solver_iterations=args.max_linear_solver_iterations,
        use_inner_iterations=args.inner_iterations,
        use_mixed_precision_solves=args.mixed_precision_solves,
        max_num_refinement_iterations=args.max_num_refinement_iterations,
        max_solver_time_in_seconds=args.max_solver_time,
        minimizer_progress_to_stdout=True,
        device=args.device)


def write_ply(path, bal, cam_arrays, pt_arrays):
    """Point-cloud export (WriteToPLYFile: cameras green, points white)."""
    n = len(cam_arrays) + len(pt_arrays)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for c in cam_arrays:
            t = c[4:7] if bal.use_quaternions else c[3:6]
            f.write(f"{t[0]} {t[1]} {t[2]} 0 255 0\n")
        for p in pt_arrays:
            f.write(f"{p[0]} {p[1]} {p[2]} 255 255 255\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", default="")
    ap.add_argument("--trust_region_strategy", default="levenberg_marquardt")
    ap.add_argument("--dogleg", default="traditional_dogleg")
    ap.add_argument("--inner_iterations", action="store_true")
    ap.add_argument("--linear_solver", default="sparse_schur")
    ap.add_argument("--explicit_schur_complement", action="store_true")
    ap.add_argument("--preconditioner", default="jacobi")
    ap.add_argument("--visibility_clustering", default="canonical_views")
    ap.add_argument("--use_spse_initialization", action="store_true")
    ap.add_argument("--spse_tolerance", type=float, default=0.1)
    ap.add_argument("--max_num_spse_iterations", type=int, default=5)
    ap.add_argument("--use_quaternions", action="store_true")
    ap.add_argument("--use_manifolds", action="store_true")
    ap.add_argument("--robustify", action="store_true")
    ap.add_argument("--eta", type=float, default=1e-2)
    ap.add_argument("--num_iterations", type=int, default=5)
    ap.add_argument("--max_linear_solver_iterations", type=int, default=500)
    ap.add_argument("--max_solver_time", type=float, default=1e32)
    ap.add_argument("--nonmonotonic_steps", action="store_true")
    ap.add_argument("--line_search", action="store_true")
    ap.add_argument("--mixed_precision_solves", action="store_true")
    ap.add_argument("--num_devices", type=int, default=1,
                    help="shard the solve over this many ranks "
                         "(SolverOptions.mesh)")
    ap.add_argument("--backend", default="",
                    help="the spawned ranks' torch.distributed backend "
                         "(default: gloo on the CPU, nccl on the card)")
    ap.add_argument("--max_num_refinement_iterations", type=int, default=0)
    ap.add_argument("--rotation_sigma", type=float, default=0.0)
    ap.add_argument("--translation_sigma", type=float, default=0.0)
    ap.add_argument("--point_sigma", type=float, default=0.0)
    ap.add_argument("--random_seed", type=int, default=38401)
    ap.add_argument("--initial_ply", default="")
    ap.add_argument("--final_ply", default="")
    ap.add_argument("--synthetic_cameras", type=int, default=16)
    ap.add_argument("--synthetic_points", type=int, default=2000)
    ap.add_argument("--synthetic_observations", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="the solve's device: cuda (default) or cpu")
    return ap.parse_args(argv)


def make_problem(ctt, args):
    """(bal, problem, camera arrays, point arrays) of the flags: the BAL
    file or the synthetic problem, normalized, perturbed by the sigmas."""
    from ..io.bal import (BALProblem, build_bal_ceres_problem,
                          synthetic_bal_problem)
    if args.input:
        bal = BALProblem.from_file(args.input,
                                   use_quaternions=args.use_quaternions)
    else:
        bal = synthetic_bal_problem(args.synthetic_cameras,
                                    args.synthetic_points,
                                    args.synthetic_observations,
                                    seed=args.random_seed % (2 ** 31),
                                    pixel_noise=1.0)
        if args.use_quaternions:
            bal = bal.to_quaternions()
        bal.normalize()
    if args.rotation_sigma or args.translation_sigma or args.point_sigma:
        bal.perturb(rotation_sigma=args.rotation_sigma,
                    translation_sigma=args.translation_sigma,
                    point_sigma=args.point_sigma,
                    seed=args.random_seed % (2 ** 31))
    loss = ctt.HuberLoss(1.0) if args.robustify else None
    problem, cams, pts = build_bal_ceres_problem(
        bal, loss=loss, use_quaternions=args.use_quaternions,
        use_manifolds=args.use_manifolds or not args.use_quaternions)
    return bal, problem, cams, pts


def run(argv=None):
    """Solve the flags' problem; print the full report and the wall
    (on stderr). Returns (summary, problem, options, camera arrays,
    point arrays), the arrays holding the solution."""
    import torch.distributed as dist
    import ceres_tpu_torch as ctt
    args = parse_args(argv)
    if args.num_devices > 1 and not (dist.is_available()
                                     and dist.is_initialized()):
        return _spawn(ctt, args, argv)
    bal, problem, cams, pts = make_problem(ctt, args)
    if args.initial_ply:
        write_ply(args.initial_ply, bal, cams, pts)
    options = build_options(ctt, args)
    t0 = time.time()
    summary = ctt.solve(options, problem)
    print(summary.full_report())
    print(f"wall time: {time.time() - t0:.3f}s", file=sys.stderr)
    if args.final_ply:
        write_ply(args.final_ply, bal, cams, pts)
    return summary, problem, options, cams, pts


def _rank(argv):
    """One spawned rank: run(argv), the report printed by rank 0 only."""
    import contextlib
    import os
    import torch.distributed as dist
    if dist.get_rank() == 0:
        summary, _, _, cams, pts = run(argv)
    else:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            summary, _, _, cams, pts = run(argv)
    summary._pending_writeback = None
    return summary, cams, pts


def _spawn(ctt, args, argv):
    """run(argv) on args.num_devices spawned ranks; rank 0's summary and
    arrays (no problem: it stays in the ranks)."""
    import sys
    from ..parallel.launch import run_ranks
    # the ranks import the rank body by its module's name (not __main__)
    from . import bundle_adjuster
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    argv = sys.argv[1:] if argv is None else list(argv)
    results = run_ranks(bundle_adjuster._rank, args.num_devices, backend,
                        args.device, timeout=3600.0, args=(argv,))
    summary, cams, pts = results[0]
    return summary, None, build_options(ctt, args), cams, pts


def main(argv=None):
    """run(argv)'s summary."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
