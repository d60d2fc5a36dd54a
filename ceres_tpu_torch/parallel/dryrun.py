"""The multi-rank dry run (the JAX package's __graft_entry__.py
dryrun_multichip, :50-166) on torch.distributed.

    python -m ceres_tpu_torch.parallel.dryrun --ranks 4 --backend gloo

runs on the card (`--device cuda`, the default; four ranks share one card
over gloo, since NCCL refuses two ranks on one device); `--device cpu`
runs the ranks on the CPU.

dryrun_multichip(n, backend, device) spawns n ranks (launch.run_ranks)
and on each:
  1. solves the BAL-16-22106 problem (bench.py's seed and perturbation;
     `shape` smaller for a quick run) with f64 DENSE_SCHUR sharded over
     the ranks, and the same problem on one device in rank 0, the two
     final costs within 1e-6 relative;
  2. runs the sharded CGNR step on a toy problem (2 cameras, 8 points, 16
     observations; CG to its iteration cap) down a radius ladder until a
     step decreases the cost;
  3. runs one sharded Schur step (make_sharded_schur_step) there, which
     must decrease the cost;
  4. solves a small problem with ITERATIVE_SCHUR + SCHUR_JACOBI in the
     implicit mode, forced, which must decrease the cost.
Each rank returns its numbers; the ranks' final states must be the same
bits. Raises on any failure.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

BAL16 = dict(num_cameras=16, num_points=22106, num_observations=83718)


def _small_bal(ncam, npts, nobs, seed=0):
    from ..io.bal import build_bal_ceres_problem, synthetic_bal_problem
    bal = synthetic_bal_problem(ncam, npts, nobs, seed=seed, pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.05,
                point_sigma=0.05, seed=seed + 1)
    return build_bal_ceres_problem(bal)[0]


def dryrun_rank(device="cuda", shape=None):
    """The dry run's four parts on this rank of an initialized group."""
    import hashlib
    import torch
    import torch.distributed as dist
    import ceres_tpu_torch as ctt
    from ..io.bal import build_bal_ceres_problem, synthetic_bal_problem
    from ..program import CompiledProgram
    from ..solvers.schur import detect_schur_structure
    from .sharded import (make_sharded_cost_fn, make_sharded_lm_step,
                          make_sharded_schur_step)
    from .sharded_fused import make_sharded_fused_solve
    n = dist.get_world_size()
    out = {"rank": dist.get_rank(), "world": n}

    # 1. the full solve, sharded and on one device
    bal = synthetic_bal_problem(**(shape or BAL16), seed=7, pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5,
                seed=8)
    base = dict(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=50, function_tolerance=1e-6,
                device=device)
    problem, cams, pts = build_bal_ceres_problem(bal)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    s2 = ctt.solve(ctt.SolverOptions(mesh=n, **base), problem)
    if device != "cpu":
        torch.cuda.synchronize()
    out["sharded_wall"] = time.time() - t0
    x = np.concatenate(cams + pts)
    out["sha"] = hashlib.sha256(x.tobytes()).hexdigest()
    if "sharded fused" not in s2.message:
        raise RuntimeError(f"dry run: not the sharded path: {s2.message}")
    out.update(sharded_cost=s2.final_cost, sharded_iterations=(
        s2.num_successful_steps + s2.num_unsuccessful_steps),
        message=s2.message)
    if out["rank"] == 0:
        problem1 = build_bal_ceres_problem(bal)[0]
        t0 = time.time()
        s1 = ctt.solve(ctt.SolverOptions(**base), problem1)
        if device != "cpu":
            torch.cuda.synchronize()
        out["single_wall"] = time.time() - t0
        out.update(single_cost=s1.final_cost, single_iterations=(
            s1.num_successful_steps + s1.num_unsuccessful_steps))
        rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
        out["rel"] = rel
        if not rel < 1e-6:
            raise RuntimeError(f"dry run: sharded {s2.final_cost} vs single "
                               f"{s1.final_cost}, rel {rel:.2e}")

    # 2. the CGNR radius ladder on the toy problem
    toy = _small_bal(2, 8, 16)
    opt = ctt.SolverOptions(linear_solver_type=ctt.LinearSolverType.CGNR,
                            max_linear_solver_iterations=20, eta=1e-12,
                            device=device)
    prog = CompiledProgram.get_cached(toy, opt)
    step, shard = make_sharded_lm_step(prog, opt, n)
    cost_fn = make_sharded_cost_fn(prog, n, shard)
    x = prog.initial_state()
    radius, accepted = 1e4, False
    for _ in range(6):
        o = step(x, radius)
        new_cost = float(cost_fn(prog.plus(x, o["delta"])))
        if np.isfinite(new_cost) and new_cost < float(o["cost"]):
            accepted = True
            break
        radius /= 10.0
    if not accepted:
        raise RuntimeError("dry run: no sharded CGNR step in the radius "
                           "ladder decreased the cost")
    out["cgnr"] = (float(o["cost"]), new_cost, int(o["lin_iters"]), radius)

    # 3. one sharded Schur step
    opt_s = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR, device=device)
    sstep, _ = make_sharded_schur_step(prog, opt_s, n)
    so = sstep(x, 1e4)
    s_new = float(cost_fn(prog.plus(x, so["delta"])))
    if not s_new < float(so["cost"]):
        raise RuntimeError(f"dry run: the sharded Schur step did not "
                           f"decrease the cost: {float(so['cost'])} -> "
                           f"{s_new}")
    out["schur"] = (float(so["cost"]), s_new)

    # 4. the forced implicit ITERATIVE_SCHUR solve
    imp = _small_bal(3, 24, 60, seed=5)
    opt_i = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=20, function_tolerance=1e-9, mesh=n,
        device=device)
    prog_i = CompiledProgram.get_cached(imp, opt_i)
    run, istep = make_sharded_fused_solve(
        prog_i, opt_i, detect_schur_structure(prog_i, opt_i), n,
        force_implicit=True)
    r = run(prog_i.initial_state())
    if not r.cost < r.initial_cost:
        raise RuntimeError(f"dry run: the implicit solve did not decrease "
                           f"the cost: {r.initial_cost} -> {r.cost}")
    out["implicit"] = (r.initial_cost, r.cost, r.iterations, istep.mode)
    return out


def dryrun_multichip(n_ranks: int, backend: str = "gloo",
                     device: str = "cuda", shape=None, timeout=900.0):
    """The dry run on n_ranks ranks (see the module docstring); returns
    the ranks' results and prints one line a part."""
    from .launch import run_ranks
    # the ranks import the rank body by its module's name (not __main__)
    from . import dryrun
    res = run_ranks(dryrun.dryrun_rank, n_ranks, backend, device, timeout,
                    args=(device, shape))
    if len({r["sha"] for r in res}) != 1:
        raise RuntimeError("dry run: the ranks' final states differ")
    r0 = res[0]
    print(f"dryrun_multichip({n_ranks}, {backend}, {device}) full solve: "
          f"single {r0['single_cost']:.6e} ({r0['single_iterations']} it, "
          f"{r0['single_wall']:.1f} s) vs sharded {r0['sharded_cost']:.6e} "
          f"({r0['sharded_iterations']} it, {r0['sharded_wall']:.1f} s), "
          f"rel diff {r0['rel']:.2e}")
    c0, c1, it, rad = r0["cgnr"]
    print(f"dryrun_multichip({n_ranks}) cgnr: cost {c0:.6e} -> {c1:.6e}, "
          f"cg_iters={it}, radius={rad:g}")
    print(f"dryrun_multichip({n_ranks}) schur: cost {r0['schur'][0]:.6e} "
          f"-> {r0['schur'][1]:.6e}")
    i0, i1, its, _ = r0["implicit"]
    print(f"dryrun_multichip({n_ranks}) implicit iterative-schur: cost "
          f"{i0:.6e} -> {i1:.6e} ({its} it)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.backend, args.device)


if __name__ == "__main__":
    main()
