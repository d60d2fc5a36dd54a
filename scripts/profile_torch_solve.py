#!/usr/bin/env python3
"""Where the time goes in one ceres_tpu_torch solve on the card.

    python3 scripts/profile_torch_solve.py
        [--paths dense,iterative,pose3d,pose2d,implicit,quat-dense,
                 quat-iterative,quat-huber,quat-implicit] [--trace-dir DIR]
        [--compare-gram] [--tree DIR] [--repeat N] [--walls-only]

Builds chip_smoke.py's problems (BAL-16-22106 shape, generator seed 7,
PERTURB seed 8; the pose graphs of POSE_GRAPHS; the large-BA case of
IMPLICIT_SHAPE; the quaternion-camera problem of QUAT_PATHS; the large
case with quaternion cameras) and, for each path (DENSE_SCHUR;
ITERATIVE_SCHUR with SCHUR_JACOBI; CGNR with JACOBI on the SE3 and the
SE2 pose graph; ITERATIVE_SCHUR in the implicit mode on the large case;
the three quaternion paths through K5; the implicit mode on the
quaternion large case, through K11's auto spec and K10; each with
chip_smoke.py's options), solves
once as a warm-up, N times (--repeat, default 1) timed without the
profiler, and once under torch.profiler (CPU and CUDA activities).
--tree DIR imports ceres_tpu_torch and chip_smoke.py's problems from
the checkout at DIR (default: this one), so that two checkouts are
profiled alike: run it on each in turns (parent, change, change,
parent) in one call on one card. Prints the card's name and
power limit, then per path: the wall of the plain and the profiled
solve, LM and CG iterations; device time per kernel, grouped by the
ported kernel it belongs to (K1-K11; copies and every other kernel
are PyTorch glue, split by kind), and the PyTorch operators with the
most device time of their own; the device busy time (union of kernel
intervals), the device span (first kernel start to last kernel end), the
busy share of the span and of the plain wall; kernel launches and host
reads of a device scalar (aten::_local_scalar_dense) per solve and per
CG iteration. Prints one JSON line per path, and writes the chrome trace
to DIR/profile_<path>.json when --trace-dir is given. Needs a CUDA
device. The SE3 path records ~1.5M device kernels; its trace takes a
minute or two to collect.

--walls-only profiles nothing: per path it prints the walls of the N
timed solves, their LM and CG iterations and final cost, one JSON line a
path (the SE3 trace takes minutes to collect; its walls do not).

--compare-gram profiles nothing: for each path it solves once as a
warm-up on each route of block Jacobi's Gram blocks, then times the
solve in the order group, slot, slot, group ("group" is ops/kernels.py
group_gram_blocks, one K9 launch a tangent-size group; "slot" is the
route it replaced, ops/kernels.py bucket_gram_blocks a slot, then
gram_sum's gather and segmented reduce), and prints per solve the wall, LM and CG iterations,
the final cost, the K9 launches and, for a pose graph, the position
error, with one JSON line per solve.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# device kernel name -> the ported kernel it belongs to (first match);
# the kernels of elim.cu (scorr_kernel, scorr_reduce_kernel; in earlier
# checkouts elim_point_kernel, scorr_partial_kernel, rhs_partial_kernel
# and reduce_splits_kernel) serve K2 (DENSE_SCHUR) and K6
# (ITERATIVE_SCHUR); K3 is chol_solve_shared_kernel or, past m = 223,
# chol_solve_kernel; lin_auto.cuh's kernels serve K1 on the angle-axis
# paths and K5 on the quaternion ones (csrc/lin.cu instantiates them with
# its Snavely chain; in earlier checkouts K1 was lin_point_kernel and two
# ftf kernels of its own); linearize_auto.cuh's row kernel serves K11's
# hand specs (Pose3dRow, Pose2dRow, SnavelyRow: csrc/linearize.cu; in
# earlier checkouts linearize_*_kernel) and its auto specs
KERNEL_OF = {
    "Pose3dRow": "K11", "Pose2dRow": "K11", "SnavelyRow": "K11",
    "lin_auto::": "K1/K5", "lin_point_kernel": "K1",
    "ftf_partial_kernel": "K1",
    "ftf_final_kernel": "K1", "scorr_": "K2/K6", "elim_point_kernel": "K2/K6",
    "rhs_partial_kernel": "K2/K6", "reduce_splits_kernel": "K2/K6",
    "chol_solve_shared_kernel": "K3", "chol_solve_kernel": "K3",
    "cost_kernel": "K4", "pcg_kernel": "K7", "jtjv_kernel": "K8",
    "gram_kernel": "K9", "gram_group_kernel": "K9",
    "linearize_auto::": "K11 (auto)",
    "implicit_apply_": "K10",
    "linearize_pose3d_kernel": "K11", "linearize_pose2d_kernel": "K11",
    "linearize_snavely_kernel": "K11",
}
# the PyTorch glue by kind (first match), for the breakdown
GLUE_OF = [("segment_reduce", "glue: segment sums"),
           ("SegmentedReduce", "glue: segment sums"),
           ("DeviceScan", "glue: segment sums"),
           ("index", "glue: gathers"), ("reduce", "glue: reductions"),
           ("elementwise", "glue: elementwise"), ("Memcpy", "glue: copies"),
           ("Memset", "glue: copies"), ("CatArray", "glue: cat"),
           ("gemm", "glue: einsum products"), ("gemv", "glue: einsum products"),
           ("cutlass", "glue: einsum products")]


def owner(name, path):
    for key, k in KERNEL_OF.items():
        if key in name:
            if k == "K2/K6":
                return "K6" if "iterative" in path else "K2"
            if k == "K1/K5":
                return "K5" if path.startswith("quat") else "K1"
            return k
    for key, kind in GLUE_OF:
        if key in name:
            return kind
    return "glue: other"


def union_us(intervals):
    """Total length of the union of [start, end] intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="dense,iterative,pose2d,pose3d")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--compare-gram", action="store_true")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--walls-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_solve: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.io import bal as bal_io
    from chip_smoke import (IMPLICIT_PERTURB, IMPLICIT_SHAPE, PERTURB,
                            POSE_GRAPHS, QUAT_IMPLICIT_MAX_ITERATIONS,
                            QUAT_PATHS, SHAPE, large_options,
                            pose_graph_options, position_error,
                            quaternion_bal, quaternion_options)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(f"tree {os.path.abspath(args.tree)}", flush=True)

    def problem_of(path):
        """(problem, arrays to reset, options, (positions, ground truth)
        or None) of a path."""
        if path in ("implicit", "quat-implicit"):
            quat = path == "quat-implicit"
            bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7,
                                        pixel_noise=1.0)
            if quat:
                bal = bal.to_quaternions()
            bal.perturb(**IMPLICIT_PERTURB, seed=8)
            problem, cams, pts = build_bal_ceres_problem(
                bal, use_quaternions=quat, use_manifolds=False)
            cap = ({"max_num_iterations": QUAT_IMPLICIT_MAX_ITERATIONS}
                   if quat else {})
            return (problem, cams + pts,
                    large_options(ctt, device="cuda", **cap), None)
        if path.startswith("quat-"):
            name = "QUAT_" + {"dense": "DENSE_SCHUR",
                              "iterative": "ITERATIVE_SCHUR",
                              "huber": "DENSE_SCHUR_HUBER"}[path[5:]]
            huber = QUAT_PATHS[name]["huber"]
            problem, cams, pts = build_bal_ceres_problem(
                quaternion_bal(bal_io),
                loss=None if huber is None else ctt.HuberLoss(huber),
                use_quaternions=True, use_manifolds=False)
            return (problem, cams + pts,
                    quaternion_options(ctt, name, device="cuda"), None)
        if path in ("dense", "iterative"):
            bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
            bal.perturb(**PERTURB, seed=8)
            problem, cams, pts = build_bal_ceres_problem(bal)
            options = ctt.SolverOptions(
                linear_solver_type=(ctt.LinearSolverType.DENSE_SCHUR
                                    if path == "dense" else
                                    ctt.LinearSolverType.ITERATIVE_SCHUR),
                preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
                max_num_iterations=50, function_tolerance=1e-6,
                max_linear_solver_iterations=100,
                use_mixed_precision_solves=True, fused_iterations=True,
                device="cuda")
            return problem, cams + pts, options, None
        spec = POSE_GRAPHS[path[len("pose"):]]
        poses, constraints, gt = getattr(g2o, spec["generator"])(
            **spec["args"])
        problem, positions, rotations = getattr(slam, spec["build"])(
            poses, constraints)
        arrays = list(positions.values()) + list(rotations.values())
        return (problem, arrays, pose_graph_options(ctt, device="cuda"),
                (positions, gt))

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    for path in args.paths.split(","):
        problem, arrays, options, traj = problem_of(path)
        start = [a.copy() for a in arrays]

        def solve():
            for a, a0 in zip(arrays, start):
                a[:] = a0
            torch.cuda.synchronize()
            t0 = time.time()
            summary = ctt.solve(options, problem)
            torch.cuda.synchronize()
            return summary, time.time() - t0

        if args.compare_gram:
            compare_gram(path, solve, traj, position_error)
            continue
        solve()                                         # warm-up
        walls = []
        for _ in range(args.repeat):
            summary, wall = solve()
            walls.append(wall)
        wall = min(walls)
        if args.walls_only:
            print(json.dumps({
                "path": path, "wall_s": wall, "walls_s": walls,
                "lm_iterations": summary.num_iterations,
                "linear_iterations": summary.num_linear_solver_iterations,
                "final_cost": summary.final_cost}), flush=True)
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_prof = solve()
        t_collect = time.time()
        all_events = prof.events()
        events = [e for e in all_events
                  if e.device_type == DeviceType.CUDA]
        host_reads = sum(1 for e in all_events
                         if e.name == "aten::_local_scalar_dense")
        if not events:
            raise SystemExit(f"{path}: the trace holds no device time")
        per_name = defaultdict(lambda: [0.0, 0])
        per_kernel = defaultdict(float)
        spans = []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            per_name[e.name][0] += t - s
            per_name[e.name][1] += 1
            per_kernel[owner(e.name, path)] += t - s
        busy = union_us(spans)
        span = max(t for _, t in spans) - min(s for s, _ in spans)
        cg = max(summary.num_linear_solver_iterations, 1)
        print(f"{path}: wall {wall:.4f} s, the least of "
              f"{[round(w, 4) for w in walls]} (profiled {wall_prof:.4f} s), "
              f"{summary.num_iterations} LM iterations, "
              f"{summary.num_linear_solver_iterations} linear solver "
              f"iterations, {summary.termination_type}, final cost "
              f"{summary.final_cost:.6e}; trace collected in "
              f"{time.time() - t_collect:.1f} s", flush=True)
        if traj is not None:
            print(f"  mean position error {position_error(*traj):.6f}")
        print(f"  {len(events)} device kernels and copies, {host_reads} "
              f"host reads of a device scalar; per linear solver "
              f"iteration: {len(events) / cg:.1f} kernels, "
              f"{host_reads / cg:.2f} host reads, {1e3 * wall / cg:.4f} ms "
              f"of plain wall, {busy / 1e3 / cg:.4f} ms device busy",
              flush=True)
        for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
            print(f"  {us / 1e3:10.4f} ms  {k}")
        for name, (us, n) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:25]:
            print(f"  {us / 1e3:9.4f} ms  {n:7d}x  {owner(name, path):20s} "
                  f"{name[:80]}")
        ops = prof.key_averages()
        self_dev = ("self_device_time_total"
                    if hasattr(ops[0], "self_device_time_total")
                    else "self_cuda_time_total")
        print("  operators by device time of their own:")
        for e in sorted(ops, key=lambda e: -getattr(e, self_dev))[:12]:
            print(f"  {getattr(e, self_dev) / 1e3:9.4f} ms  {e.count:7d}x  "
                  f"{e.key[:60]}")
        print(f"  device busy {busy / 1e3:.4f} ms of a {span / 1e3:.4f} ms "
              f"device span ({100 * busy / span:.1f}%); "
              f"{100 * busy / 1e6 / wall:.1f}% of the plain wall", flush=True)
        if args.trace_dir:
            prof.export_chrome_trace(os.path.join(args.trace_dir,
                                                  f"profile_{path}.json"))
        print(json.dumps({
            "path": path, "wall_s": wall, "walls_s": walls,
            "wall_profiled_s": wall_prof,
            "lm_iterations": summary.num_iterations,
            "linear_iterations": summary.num_linear_solver_iterations,
            "final_cost": summary.final_cost,
            "device_ms_by_kernel": {k: v / 1e3
                                    for k, v in sorted(per_kernel.items())},
            "device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "device_kernels": len(events), "host_reads": host_reads,
            "minimizer_s": summary.minimizer_time_in_seconds,
            "postprocessor_s": summary.postprocessor_time_in_seconds}),
            flush=True)


def compare_gram(path, solve, traj, position_error):
    """The --compare-gram solves of one path (see the module
    docstring)."""
    from ceres_tpu_torch.ops import bsr, kernels

    def per_slot(views, gram_map, gram_off):
        return kernels.gram_sum([kernels.bucket_gram_blocks(J)
                                 for J in views], gram_map, gram_off)
    routes = {"group": kernels.group_gram_blocks, "slot": per_slot}
    counters = (kernels.group_gram_blocks, kernels.bucket_gram_blocks)
    try:
        for route in ("group", "slot"):                 # warm-ups
            bsr.group_gram_blocks = routes[route]
            solve()
        for route in ("group", "slot", "slot", "group"):
            bsr.group_gram_blocks = routes[route]
            for c in counters:
                c.launches = 0
            summary, wall = solve()
            launches = sum(c.launches for c in counters)
            err = position_error(*traj) if traj is not None else None
            print(f"{path} gram={route}: wall {wall:.4f} s, "
                  f"{summary.num_iterations} LM iterations, "
                  f"{summary.num_linear_solver_iterations} linear solver "
                  f"iterations, {summary.termination_type}, final cost "
                  f"{summary.final_cost!r}, K9 launches {launches}, "
                  f"position error {err!r}", flush=True)
            print(json.dumps({
                "path": path, "gram": route, "wall_s": wall,
                "lm_iterations": summary.num_iterations,
                "linear_iterations": summary.num_linear_solver_iterations,
                "final_cost": summary.final_cost,
                "k9_launches": launches,
                "position_error": err}), flush=True)
    finally:
        bsr.group_gram_blocks = routes["group"]


if __name__ == "__main__":
    main()
