#!/usr/bin/env python3
"""K2, K3, K6, K8 and K10 of one checkout of ceres_tpu_torch on the card,
at the main paths' shapes, with seeded inputs.

    python3 scripts/time_kernels.py [--tree DIR] [--only K3 K2 K8 K10]

Imports ceres_tpu_torch from DIR (default: this checkout), so that one
script times two checkouts alike: run it on each in turns (parent,
change, change, parent) in one call on one card. Inputs are made on the
card from fixed seeds, so both checkouts see the same bits:

- K3 (ops/kernels.py chol_solve) at the reduced camera systems of
  BAL-16-22106: m 144 (angle-axis cameras) and 160 (quaternion cameras),
  S = B B^T + m I; and on the DENSE_SCHUR path's own first reduced
  system (m 144), built by the checkout from chip_smoke.py's seeded
  problem; beside it one torch.linalg.solve on the same inputs.
- K2 (ops/lin.py elim) and K6 (elim_v1) at BAL-16-22106 (ne 22,106
  points, nf 144 or 160: 16 cameras of 9 or 10 columns), each point's A
  on 4 random camera blocks (BA's zero blocks elsewhere), SPD point
  Grams B B^T + 3 I (condition number ~10, as scaled Grams are), radius
  1e4; K6's inv and z from them as the ITERATIVE_SCHUR step
  forms them.
- K8 (ops/kernels.py bucket_jtjv) at the SE3 pose graph's main bucket
  (n 2,396 rows, r 6, t 12, 12,000 tangent columns; chip_smoke.py's
  POSE_GRAPHS "3d"): u = J^T (J v[cols]). Where the checkout's wrapper
  takes the gathered vector (bucket_jtjv(J, vb), before the gather moved
  into the kernel), each call gathers v[cols] and then launches, as that
  checkout's CG operator did.
- K10 (ops/implicit.py implicit_apply) at the 1M-observation shapes (ne
  200,000 points, k 5 lanes, r 2, te 3, 1,024 cameras; tf 9 with
  angle-axis cameras, tf 10 with quaternions), lanes past a random count
  per point masked.

For each it prints the card's name and power limit, then one JSON line:
the largest difference from the plain version (K3 and K10 must give the
same bits), the median of 20 single calls and the mean of 100
back-to-back calls by CUDA events (ms), and the device time per call by
torch.profiler (us: K2, K3 and K6 every kernel a call launches, K8 and
K10 their own kernel). Needs a CUDA device.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def events_ms(fn, calls=1, reps=20):
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls, per call (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_us(fn, calls=100):
    """Device time per call (us) of each kernel that fn() launches, by
    torch.profiler over `calls` calls: {kernel name: us per call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "device_time_total", None)
            out[e.key] = (e.cuda_time_total if t is None else t) / calls
    return out


def short_name(kernel):
    """A device kernel's name without its namespace and arguments."""
    head = kernel.split("(")[0] if "::" not in kernel else \
        kernel.split("::")[-1]
    return head.split("(")[0]


def device_us(fn, match=None, calls=100):
    """Device time per launch (us) of the kernels whose name holds
    `match` (per call when each call launches one), or with no `match`
    of every kernel per call."""
    by_kernel = kernel_us(fn, calls)
    return sum(t for k, t in by_kernel.items() if match is None or match in k)


def solve_system(tree):
    """(S, rhs) of the DENSE_SCHUR path's first reduced camera system on
    BAL-16-22106 (chip_smoke.py's SHAPE and PERTURB, seeds 7 and 8, at
    the initial radius 1e4; m 144), built by the checkout at `tree`."""
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep
    bal = synthetic_bal_problem(num_cameras=16, num_points=22106,
                                num_observations=83718, seed=7,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5,
                seed=8)
    problem, _, _ = build_bal_ceres_problem(bal)
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True, fused_iterations=True,
        device="cuda")
    program = CompiledProgram.get_cached(problem, options)
    step = FusedSchurStep(program, options,
                          detect_schur_structure(program, options))
    x0 = program.initial_state()
    se0, sf0 = step.initial_scales()
    art = step.linearize(x0, se0, sf0, True)
    S, rhs, _, _ = step.reduced_system(art, 1e4)
    torch.cuda.synchronize()
    return S.contiguous(), rhs.contiguous()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--only", nargs="*", choices=("K3", "K2", "K8", "K10"),
                    help="time only these (K2 stands for K2 and K6)")
    args = ap.parse_args()

    def want(name):
        return not args.only or name in args.only
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from ceres_tpu_torch.ops import implicit, kernels, lin
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(f"tree {os.path.abspath(args.tree)}; torch {torch.__version__}",
          flush=True)
    gen = torch.Generator(device="cuda")

    # K3 at the reduced camera systems, beside torch.linalg.solve
    systems = []
    if want("K3"):
        for m in (144, 160):
            gen.manual_seed(m)
            B = torch.randn(m, m + 4, device="cuda", generator=gen)
            systems.append(("seeded", B @ B.T + m * torch.eye(m, device="cuda"),
                            torch.randn(m, device="cuda", generator=gen)))
        systems.append(("solve",) + solve_system(args.tree))
    for source, S, b in systems:
        def k3():
            return kernels.chol_solve(S, b)

        def lib():
            return torch.linalg.solve(S, b)
        err = float(torch.max(torch.abs(
            k3() - kernels.chol_solve_plain(S, b))))
        print(json.dumps({"kernel": "K3 chol_solve", "shape": [S.shape[0]],
                          "system": source, "max_abs_err": err,
                          "ms": events_ms(k3),
                          "loop_ms": events_ms(k3, 100, 5),
                          "device_us": device_us(k3),
                          "library_ms": events_ms(lib),
                          "library_device_us": device_us(lib)}),
              flush=True)

    # K2 and K6 at BAL-16-22106, nf 144 and 160
    ne, kf, k = 22106, 16, 4
    for tf in ((9, 10) if want("K2") else ()):
        gen.manual_seed(100 + tf)
        nf = kf * tf
        cams = torch.randint(0, kf, (ne, k), device="cuda", generator=gen)
        touched = torch.nn.functional.one_hot(cams, kf).amax(1).float()
        A = (torch.randn(ne, 3, kf, tf, device="cuda", generator=gen)
             * touched[:, None, :, None]).reshape(ne, 3, nf).contiguous()
        Bp = torch.randn(ne, 3, 3, device="cuda", generator=gen)
        etes = (Bp @ Bp.transpose(1, 2) + 3 * torch.eye(3, device="cuda")
                ).reshape(ne, 9).contiguous()
        gse = torch.randn(ne, 3, device="cuda", generator=gen)
        diag = 0.5 + torch.rand(ne, 3, device="cuda", generator=gen)
        rad = torch.tensor(1e4, device="cuda")
        inv = lin.spd_inv3(etes.view(ne, 3, 3) + torch.diag_embed(
            diag / rad)).contiguous()
        z = torch.einsum("nij,nj->ni", inv, -gse).contiguous()
        for name, fn, plain in (
                ("K2 elim", lambda: lin.elim(A, etes, gse, diag, 1e4),
                 lambda: lin.elim_plain(A, etes, gse, diag, 1e4)),
                ("K6 elim_v1", lambda: lin.elim_v1(A, inv, z),
                 lambda: lin.elim_v1_plain(A, inv, z))):
            rel = max(float(torch.max(torch.abs(a - b_)) /
                            torch.max(torch.abs(b_)))
                      for a, b_ in zip(fn(), plain()))
            by_kernel = kernel_us(fn)
            print(json.dumps({"kernel": name, "shape": [ne, nf],
                              "max_rel_err": rel, "ms": events_ms(fn),
                              "loop_ms": events_ms(fn, 100, 5),
                              "device_us": sum(by_kernel.values()),
                              "device_us_by_kernel": {
                                  short_name(k): t
                                  for k, t in by_kernel.items()},
                              "plain_ms": events_ms(plain)}), flush=True)

    if not want("K8"):
        return
    # K8 at the SE3 main bucket
    gen.manual_seed(1)
    n, r, t, m = 2396, 6, 12, 12000
    J = torch.randn(n, r, t, device="cuda", generator=gen)
    v = torch.randn(m, device="cuda", generator=gen)
    cols = torch.randint(0, m, (n, t), device="cuda", generator=gen)
    cols32 = cols.to(torch.int32)
    if "cols" in inspect.signature(kernels.bucket_jtjv).parameters:
        def k8():
            return kernels.bucket_jtjv(J, v, cols32)
        want = kernels.bucket_jtjv_plain(J, v, cols32)
        route = "gather in the kernel"
    else:
        def k8():
            return kernels.bucket_jtjv(J, v[cols])
        want = kernels.bucket_jtjv_plain(J, v[cols])
        route = "gather, then the kernel"
    err = float(torch.max(torch.abs(k8() - want)))
    print(json.dumps({"kernel": "K8 bucket_jtjv", "shape": [n, r, t, m],
                      "route": route, "max_abs_err": err,
                      "ms": events_ms(k8), "loop_ms": events_ms(k8, 100, 5),
                      "device_us": device_us(k8, "jtjv_kernel")}),
          flush=True)

    if not want("K10"):
        return
    # K10 at the 1M shapes
    ne, k, r, te, kf = 200000, 5, 2, 3, 1024
    for tf in (9, 10):
        gen.manual_seed(tf)
        count = torch.randint(1, k + 1, (ne, 1), device="cuda",
                              generator=gen)
        lane = (torch.arange(k, device="cuda")[None, :] < count).float()
        Je = torch.randn(ne, k, r, te, device="cuda", generator=gen) \
            * lane[:, :, None, None]
        Jf = torch.randn(ne, k, r, tf, device="cuda", generator=gen) \
            * lane[:, :, None, None]
        B = torch.randn(ne, te, te, device="cuda", generator=gen)
        inv = torch.linalg.inv(B @ B.transpose(1, 2)
                               + te * torch.eye(te, device="cuda"))
        fids = (torch.randint(0, kf, (ne, k), device="cuda", generator=gen)
                * lane.long()).to(torch.int32)
        vf = torch.randn(kf * tf, device="cuda", generator=gen)
        a = (Je, Jf, inv.contiguous(), fids, vf)

        def k10():
            return implicit.implicit_apply(*a)
        err = float(torch.max(torch.abs(
            k10() - implicit.implicit_apply_plain(*a))))
        print(json.dumps({"kernel": "K10 implicit_apply",
                          "shape": [ne, k, r, te, tf, kf],
                          "max_abs_err": err, "ms": events_ms(k10),
                          "loop_ms": events_ms(k10, 100, 5),
                          "device_us": device_us(k10, "implicit_apply")}),
              flush=True)


if __name__ == "__main__":
    main()
