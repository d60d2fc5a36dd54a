#!/usr/bin/env python3
"""K1-K11 (K11's hand and auto specs) of one checkout of ceres_tpu_torch
on the card, at the main paths' shapes, with seeded inputs.

    python3 scripts/time_kernels.py [--tree DIR]
        [--only K1 K11hand K3 K2 K8 K10 K5 K11auto K4 K9 K7] [--dump DIR]
    python3 scripts/time_kernels.py --compare DIR DIR

Imports ceres_tpu_torch from DIR (default: this checkout), so that one
script times two checkouts alike: run it on each in turns (parent,
change, change, parent) in one call on one card. Inputs are made on the
card from fixed seeds, so both checkouts see the same bits:

- K1 (ops/lin.py lin) on the DENSE_SCHUR path's first linearization
  of BAL-16-22106 (chip_smoke.py's SHAPE and PERTURB, seeds 7 and 8:
  ne 22,106 points, 16 cameras, nf 144), built by the checkout as the
  step builds it, with the scale derived (first) and carried (the first
  call's), through the step's camera plan and lane data where the
  checkout's wrapper takes them; where the checkout's K1 has loss
  instances (ops/lin.py K1_ENTRIES), also first with HuberLoss(1.0) and
  with CauchyLoss(2.0).
- K11's hand specs (ops/linearize.py bucket_linearize): Snavely on the
  large case's bucket at its start (chip_smoke.py IMPLICIT_SHAPE: 1M
  rows, R 2, NT 12, P_IN 12, P_DAT 2; xin and dat made with numpy from
  the seeded BALProblem in the bucket's row order), SE3 and SE2 on the
  main buckets of chip_smoke.py's POSE_GRAPHS at their start (2,396 and
  1,063 rows), built by the checkout.
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
- K5 (ops/lin_auto.py lin_auto) on the quaternion BAL-16-22106
  problem's first linearization (chip_smoke.py quaternion_bal: ne 22,106
  points, k 4, 16 cameras of tf 10, te 3, r 2), with no loss and with
  HuberLoss(1.0), built by the checkout as chip_smoke.py builds it (the
  step's camera plan passed where the checkout's wrapper takes one).
- K11's auto spec (ops/linearize.py bucket_linearize_auto) on the
  quaternion large case's bucket at its start (chip_smoke.py
  IMPLICIT_SHAPE with quaternion cameras: 1M rows, R 2, NT 13, P_IN 13,
  P_DAT 2): xin and dat made with numpy from the seeded BALProblem in
  the bucket's row order, the spec traced from the quaternion
  BAL-16-22106 problem's bucket (the same functor, so the same graph).
- K4 (ops/cost.py snavely_sq) on the DENSE_SCHUR step at BAL-16-22106's
  start (83,718 rows, 16 cameras), and on the large case's rows at its
  start (IMPLICIT_SHAPE: 1M rows, 200,000 points, 1,024 cameras; the
  state and rows made with numpy from the seeded BALProblem), through
  the inputs bound once (SnavelyCost) where the checkout binds them.
- K9 on both pose graphs' first scaled Jacobians (SE3: one group of
  tangent size 3, six slot views; SE2: groups of tangent size 1 and 2,
  three views each): each group's block Jacobi blocks through
  ops/bsr.py block_diag_jtj (every kernel of the call: the group kernel,
  or in an earlier checkout the per-row kernel a slot and the group's
  ColumnSum), and the per-row form (ops/kernels.py bucket_gram_blocks:
  the group kernel on one view with the identity map, or in an earlier
  checkout its own kernel) on each slot view.
- K7 (ops/pcg.py dense_pcg) on every reduced camera system that a full
  ITERATIVE_SCHUR solve with SCHUR_JACOBI hands it (captured at the
  step's call): BAL-16-22106 (m 144, chip_smoke.py's ITERATIVE_SCHUR
  options) and its quaternion problem (m 160, QUAT_ITERATIVE_SCHUR);
  a line a system with its CG iterations and bound, then per problem
  the device time a call fitted against the CG iterations (the time a
  CG iteration, and at none); and seeded SPD systems at m 200, 201, 240,
  296 and 1024, past the register path (S in shared memory up to m 238,
  then in global memory).

For each it prints the card's name and power limit, then one JSON line:
the largest difference from the plain version (K3 and K10 must give the
same bits), the median of 20 single calls and the mean of 100
back-to-back calls by CUDA events (ms), and the device time per call by
torch.profiler (us: K1, K2, K3, K4, K5, K6, K7, K9's groups and K11's
hand specs every kernel a call launches, K8, K9's slots, K10 and K11
auto their own kernel; where it is every kernel, also the median span a
call, first kernel start to last kernel end, the time of a call whose
kernels overlap); for the runs of K1, K4, K5, K7, K9 and K11 also
the launches a call, the host time of a call in a loop without
synchronising (us) and the plain version's time, and the registers,
spills and shared memory (cuobjdump -res-usage) of each kernel of the
generated units and of K1's and K11's kernels in the checkout's
library. --dump DIR saves the outputs of K1 (its six, first and
carried), K4, K5, K7, K9 (each group and slot) and K11 (r and J of each
spec) (torch.save) under DIR; --compare DIR DIR prints, per output,
whether two dumps hold the same bits. Needs a CUDA device (not
--compare).
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


def host_us(fn, calls=100):
    """Host time a call (us): `calls` back-to-back calls timed on the
    host clock without a synchronisation (the card runs behind)."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


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


def device_span_us(fn, calls=100):
    """Median device span of a call (us): from the start of its first
    kernel to the end of its last, by torch.profiler over `calls` calls
    (each call launching the same number of kernels). Where a call's
    kernels overlap (a programmatic dependent launch) the span, not the
    sum of their times, is what the call costs the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    per = len(ranges) // calls
    if per == 0 or per * calls != len(ranges):
        return None
    return statistics.median(
        max(end for _, end in ranges[i:i + per]) - ranges[i][0]
        for i in range(0, len(ranges), per))


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


def dense_step():
    """(program, FusedSchurStep) of the DENSE_SCHUR path on BAL-16-22106
    (chip_smoke.py's SHAPE and PERTURB, seeds 7 and 8), built by the
    imported checkout."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep
    from chip_smoke import PERTURB, SHAPE
    bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    problem, _, _ = build_bal_ceres_problem(bal)
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True, fused_iterations=True,
        device="cuda")
    program = CompiledProgram.get_cached(problem, options)
    return program, FusedSchurStep(program, options,
                                   detect_schur_structure(program, options))


def solve_system():
    """(S, rhs) of the DENSE_SCHUR path's first reduced camera system on
    BAL-16-22106 at the initial radius 1e4 (m 144), built by the imported
    checkout."""
    import torch
    program, step = dense_step()
    x0 = program.initial_state()
    se0, sf0 = step.initial_scales()
    art = step.linearize(x0, se0, sf0, True)
    S, rhs, _, _ = step.reduced_system(art, 1e4)
    torch.cuda.synchronize()
    return S.contiguous(), rhs.contiguous()


def res_usage(lib):
    """{kernel: "REG:n STACK:n SHARED:n LOCAL:n ..."} of the shared library
    at `lib` (cuobjdump -res-usage; LOCAL is spill and stack memory)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True,
                         text=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif line.startswith("REG:") and name:
            usage[name] = line
    return usage


def quaternion_k5():
    """(LinAutoSpec, the K5 arguments of the first linearization, the
    step's camera plan or None, the quaternion program) on chip_smoke.py's
    quaternion BAL-16-22106 problem, built by the imported checkout."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io.bal import build_bal_ceres_problem
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.schur import detect_schur_structure
    from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep
    from chip_smoke import quaternion_bal, quaternion_options
    problem, _, _ = build_bal_ceres_problem(
        quaternion_bal(bal_io), use_quaternions=True, use_manifolds=False)
    options = quaternion_options(ctt, "QUAT_DENSE_SCHUR", device="cuda")
    program = CompiledProgram.get_cached(problem, options)
    step = FusedSchurStep(program, options,
                          detect_schur_structure(program, options))
    x0 = program.initial_state()
    se0, _ = step.initial_scales()
    ne, te, nf = step.ne, step.te, step.nf
    args = (step.k5, x0[step.f_slab:step.f_slab + nf].float(),
            x0[step.e_slab:step.e_slab + te * ne].view(ne, te).float(),
            step.cam, step.mask, step.dat, se0)
    return step.k5, args, getattr(step, "k5_plan", None), program


def quaternion_k11(program):
    """(AutoSpec, xin, dat) of K11's auto spec on the quaternion large
    case at its start: the spec of `program`'s quaternion bucket, xin
    and dat from chip_smoke.py's seeded quaternion large case in the
    order of its observations (the bucket's rows, camera then point)."""
    import numpy as np
    import torch
    from ceres_tpu_torch.io.bal import synthetic_bal_problem
    from ceres_tpu_torch.ops.jet_compile import make_auto_spec
    from chip_smoke import IMPLICIT_PERTURB, IMPLICIT_SHAPE
    spec = make_auto_spec(program, program.buckets[0])
    bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7,
                                pixel_noise=1.0).to_quaternions()
    bal.perturb(**IMPLICIT_PERTURB, seed=8)
    xin = np.concatenate([bal.cameras[bal.camera_index],
                          bal.points[bal.point_index]], axis=1)
    return (spec, torch.as_tensor(xin.astype(np.float32), device="cuda"),
            torch.as_tensor(bal.observations.astype(np.float32),
                            device="cuda"))


def k5_k11auto_runs(with_k5=True, with_k11=True):
    """The runs (see `measure`) of K5 (no loss, Huber) and K11's auto
    spec."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.ops import lin_auto as k5
    from ceres_tpu_torch.ops import linearize as k11
    spec, args, plan, program = quaternion_k5()
    takes_plan = "plan" in inspect.signature(k5.lin_auto).parameters
    extra = {"plan": plan} if takes_plan else {}
    runs = []
    for loss_name, loss in ((("none", None), ("huber", ctt.HuberLoss(1.0)))
                            if with_k5 else ()):
        runs.append(({"kernel": "K5 lin_auto", "loss": loss_name,
                      "shape": [spec.te, spec.tf, spec.r, *args[3].shape,
                                args[1].numel() // spec.tf],
                      "camera_plan": plan is not None and takes_plan},
                     lambda loss=loss: k5.lin_auto(*args, True, True, loss,
                                                   **extra),
                     lambda loss=loss: k5.lin_auto_plain(*args, True, True,
                                                         loss),
                     k5.lin_auto, None, f"K5 {loss_name}"))
    if with_k11:
        spec11, xin, dat = quaternion_k11(program)
        runs.append(({"kernel": "K11 bucket_linearize (auto)",
                      "shape": [xin.shape[0], spec11.r, spec11.nt,
                                xin.shape[1], dat.shape[1]]},
                     lambda: k11.bucket_linearize_auto(spec11, xin, dat),
                     lambda: k11.bucket_linearize_auto_plain(spec11, xin,
                                                             dat),
                     k11.bucket_linearize_auto, "linearize_auto",
                     "K11 auto"))
    return runs


def k1_runs():
    """The runs of K1 on the DENSE path's first linearization, the scale
    derived and then carried (the derived one)."""
    from ceres_tpu_torch.ops import lin
    program, step = dense_step()
    x0 = program.initial_state()
    ne, nf = step.ne, step.nf
    xf = x0[step.f_slab:step.f_slab + nf].float()
    xe = x0[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    se0, _ = step.initial_scales()
    new = "plan" in inspect.signature(lin.lin).parameters
    if new:                     # lane data [ne, k, 2] and the step's plan
        obsx, obsy = step.dat[..., 0], step.dat[..., 1]

        def call(se, first):
            return lin.lin(xf, xe, step.cam, step.mask, step.dat, se, first,
                           True, plan=step.plan)
    else:
        obsx, obsy = step.obsx, step.obsy

        def call(se, first):
            return lin.lin(xf, xe, step.cam, step.mask, obsx, obsy, se, first)
    se1 = call(se0, True)["se"].clone()
    runs = []
    for name, se, first in (("first", se0, True), ("carried", se1, False)):
        runs.append(({"kernel": "K1 lin", "scale": name,
                      "shape": [ne, step.cam.shape[1], step.kf, nf],
                      "lane_data_and_plan": new},
                     lambda se=se, first=first: call(se, first),
                     lambda se=se, first=first: lin.lin_plain(
                         xf, xe, step.cam, step.mask, obsx, obsy, se, first),
                     lin.lin, None, f"K1 {name}"))
    if hasattr(lin, "K1_ENTRIES"):      # the loss instances (csrc/lin.cu)
        import ceres_tpu_torch as ctt
        for loss in (ctt.HuberLoss(1.0), ctt.CauchyLoss(2.0)):
            name = f"first, {type(loss).__name__}"
            runs.append(({"kernel": "K1 lin", "scale": name,
                          "shape": [ne, step.cam.shape[1], step.kf, nf],
                          "lane_data_and_plan": new},
                         lambda loss=loss: lin.lin(
                             xf, xe, step.cam, step.mask, step.dat, se0,
                             True, True, loss, plan=step.plan),
                         lambda loss=loss: lin.lin_plain(
                             xf, xe, step.cam, step.mask, obsx, obsy, se0,
                             True, True, loss),
                         lin.lin, None, f"K1 {name}"))
    return runs


def k11_hand_cases():
    """(name, Spec, xin, dat) of K11's hand specs: Snavely on the large
    case's bucket, SE3 and SE2 on the pose graphs' main buckets, at their
    start."""
    import numpy as np
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.io.bal import synthetic_bal_problem
    from ceres_tpu_torch.ops import linearize as k11
    from ceres_tpu_torch.program import CompiledProgram
    from chip_smoke import IMPLICIT_PERTURB, IMPLICIT_SHAPE, POSE_GRAPHS
    cases = []
    bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**IMPLICIT_PERTURB, seed=8)
    xin = np.concatenate([bal.cameras[bal.camera_index],
                          bal.points[bal.point_index]], axis=1)
    cases.append(("Snavely", k11.SPECS[SnavelyReprojectionError],
                  torch.as_tensor(xin.astype(np.float32), device="cuda"),
                  torch.as_tensor(bal.observations.astype(np.float32),
                                  device="cuda")))
    for key in ("3d", "2d"):
        cfg = POSE_GRAPHS[key]
        poses, constraints = getattr(g2o, cfg["generator"])(
            **cfg["args"])[:2]
        problem = getattr(slam, cfg["build"])(poses, constraints)[0]
        program = CompiledProgram.get_cached(problem, ctt.SolverOptions(
            linear_solver_type=ctt.LinearSolverType.CGNR,
            use_mixed_precision_solves=True, fused_iterations=True,
            device="cuda"))
        bk = next(b for b in program.buckets if b.spec is not None)
        xin = torch.cat([p.float() for p in program._bucket_params(
            bk, program.initial_state())], dim=1).contiguous()
        cases.append(("SE" + key[0], bk.spec, xin, bk.dat32))
    return cases


def k11_hand_runs():
    """The runs of K11's hand specs (k11_hand_cases)."""
    from ceres_tpu_torch.ops import linearize as k11
    return [({"kernel": "K11 bucket_linearize (hand)", "spec": name,
              "shape": [xin.shape[0], spec.r, spec.nt, xin.shape[1],
                        dat.shape[1]]},
             lambda spec=spec, xin=xin, dat=dat: k11.bucket_linearize(
                 spec, xin, dat),
             lambda spec=spec, xin=xin, dat=dat: k11.bucket_linearize_plain(
                 spec, xin, dat),
             k11.bucket_linearize, None, f"K11 {name}")
            for name, spec, xin, dat in k11_hand_cases()]


def k4_cases(bound=True):
    """(name, x, the arguments after x) of K4 (ops/cost.py snavely_sq):
    the DENSE path's step at BAL-16-22106's start (its bound inputs, or
    with `bound` False the step's seven arguments, as checkouts before
    SnavelyCost took them), and the large case's rows at its start
    (chip_smoke.py IMPLICIT_SHAPE and IMPLICIT_PERTURB, seeds 7 and 8: the
    state [points | cameras], the observations in their order, made with
    numpy)."""
    import numpy as np
    import torch
    from ceres_tpu_torch.io.bal import synthetic_bal_problem
    from ceres_tpu_torch.ops import cost
    from chip_smoke import IMPLICIT_PERTURB, IMPLICIT_SHAPE
    program, step = dense_step()
    x0 = program.initial_state()
    if bound:
        cases = [("BAL-16-22106", x0, (step.k4,))]
    else:
        cases = [("BAL-16-22106", x0, (step.e_slab, step.f_slab,
                                       step.pt_idx, step.cam_idx,
                                       step.obsx64, step.obsy64))]
    bal = synthetic_bal_problem(**IMPLICIT_SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**IMPLICIT_PERTURB, seed=8)
    ne, kf = bal.points.shape[0], bal.cameras.shape[0]
    dev = torch.device("cuda")
    x = torch.as_tensor(np.concatenate([bal.points.ravel(),
                                        bal.cameras.ravel()]), device=dev)
    fixed = (torch.as_tensor(bal.point_index.astype(np.int32), device=dev),
             torch.as_tensor(bal.camera_index.astype(np.int32), device=dev),
             torch.as_tensor(bal.observations[:, 0].copy(), device=dev),
             torch.as_tensor(bal.observations[:, 1].copy(), device=dev))
    cases.append(("large case", x, (cost.SnavelyCost(0, 3 * ne, ne, kf,
                                                      *fixed),)
                  if bound else (0, 3 * ne) + fixed))
    return cases


def k4_runs():
    """The runs of K4 on k4_cases, through the inputs bound once where
    the checkout binds them."""
    from ceres_tpu_torch.ops import cost
    bound = hasattr(cost, "SnavelyCost")
    return [({"kernel": "K4 cost", "case": name,
              "shape": [int(x.numel()), int(args[0].n if bound
                                            else args[2].numel())],
              "inputs_bound_once": bound},
             lambda x=x, args=args: {"sq": cost.snavely_sq(x, *args)},
             lambda x=x, args=args: {"sq": cost.snavely_sq_plain(x, *args)},
             cost.snavely_sq, None, f"K4 {name}")
            for name, x, args in k4_cases(bound)]


def pose_graph_jacobians():
    """(name, program, scaled BlockJacobian) of chip_smoke.py's two pose
    graphs at their start, as the CGNR + JACOBI step's first
    linearization scales them, built by the imported checkout."""
    import torch
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o
    from ceres_tpu_torch.program import CompiledProgram
    from chip_smoke import POSE_GRAPHS, pose_graph_options
    out = []
    for key in ("3d", "2d"):
        cfg = POSE_GRAPHS[key]
        poses, constraints = getattr(g2o, cfg["generator"])(
            **cfg["args"])[:2]
        problem = getattr(slam, cfg["build"])(poses, constraints)[0]
        program = CompiledProgram.get_cached(
            problem, pose_graph_options(ctt, device="cuda"))
        _, _, jac, _ = program.linearize_fn_mixed(program.initial_state())
        jac_s = jac.scale_columns(
            1.0 / (1.0 + torch.sqrt(jac.squared_column_norms())))
        out.append(("SE" + key[0], program, jac_s))
    return out


def k9_runs():
    """The runs of K9 on both pose graphs (pose_graph_jacobians): each
    tangent-size group's block Jacobi blocks through the checkout's
    ops/bsr.py block_diag_jtj (one group kernel where the checkout has
    it, else the per-row kernel a slot and the group's ColumnSum: every
    kernel a call counts), and the per-row form on each slot view."""
    from ceres_tpu_torch.ops import bsr, kernels
    group_counter = getattr(kernels, "group_gram_blocks",
                            kernels.bucket_gram_blocks)

    def group_plain(g, views):
        if hasattr(g, "block_sum"):         # the group's ColumnSum
            return g.block_sum([kernels.bucket_gram_blocks_plain(J)
                                for J in views])
        return kernels.group_gram_blocks_plain(
            views, *g.gram_order(views[0].device))
    runs = []
    for name, program, jac in pose_graph_jacobians():
        for gi, g in enumerate(program.groups):
            views = [jac.buckets[bi].slot_J(si)
                     for (bi, si, _) in g.bucket_slots]
            runs.append((
                {"kernel": "K9 block_diag_jtj (a group)", "graph": name,
                 "group": gi, "t": g.tangent_size, "blocks": g.num_blocks,
                 "slots": len(views),
                 "rows": sum(J.shape[0] for J in views)},
                lambda jac=jac, g=g: {"G": bsr.block_diag_jtj(jac, [g])[0]},
                lambda g=g, views=views: {"G": group_plain(g, views)},
                group_counter, None, f"K9 {name} group {gi}"))
            for vi, J in enumerate(views):
                runs.append((
                    {"kernel": "K9 bucket_gram_blocks (a slot)",
                     "graph": name, "group": gi, "slot": vi,
                     "shape": list(J.shape)},
                    lambda J=J: {"G": kernels.bucket_gram_blocks(J)},
                    lambda J=J: {"G": kernels.bucket_gram_blocks_plain(J)},
                    kernels.bucket_gram_blocks, "gram_",
                    f"K9 {name} group {gi} slot {vi}"))
    return runs


def k7_systems():
    """Every K7 system of one full ITERATIVE_SCHUR solve of each problem,
    captured at dense_pcg's call in the explicit step: [(name, k, S, rhs,
    minv, pcg keyword arguments)] for BAL-16-22106 with angle-axis
    cameras (m 144; chip_smoke.py's ITERATIVE_SCHUR options) and with
    quaternion cameras (m 160; QUAT_ITERATIVE_SCHUR), built by the
    imported checkout from chip_smoke.py's seeded problems. Prints each
    solve's LM and CG counts and final cost."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io import bal as bal_io
    from ceres_tpu_torch.io.bal import (build_bal_ceres_problem,
                                        synthetic_bal_problem)
    from ceres_tpu_torch.solvers import schur_fused
    from chip_smoke import (PERTURB, SHAPE, quaternion_bal,
                            quaternion_options)
    bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    angle_axis = build_bal_ceres_problem(bal)[0]
    quaternion = build_bal_ceres_problem(
        quaternion_bal(bal_io), use_quaternions=True,
        use_manifolds=False)[0]
    systems = []
    kernel = schur_fused.dense_pcg
    for name, problem, options in (
            ("angle-axis", angle_axis, ctt.SolverOptions(
                linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
                max_num_iterations=50, function_tolerance=1e-6,
                max_linear_solver_iterations=100,
                use_mixed_precision_solves=True, fused_iterations=True,
                device="cuda")),
            ("quaternion", quaternion, quaternion_options(
                ctt, "QUAT_ITERATIVE_SCHUR", device="cuda"))):
        seen = []

        def capture(S, rhs, minv, **kw):
            seen.append((name, len(seen), S.clone(), rhs.clone(),
                         None if minv is None else minv.clone(), dict(kw)))
            return kernel(S, rhs, minv, **kw)
        schur_fused.dense_pcg = capture
        try:
            summary = ctt.solve(options, problem)
        finally:
            schur_fused.dense_pcg = kernel
        print(json.dumps({"k7_solve": name, "lm": summary.num_iterations,
                          "cg": summary.num_linear_solver_iterations,
                          "final_cost": summary.final_cost,
                          "systems": len(seen)}), flush=True)
        systems += seen
    return systems


def k7_seeded():
    """K7 past the register path: seeded SPD systems S = A A^T + m I at
    m 200 and 201 (S in shared memory, by one bulk copy and by the
    threads' loop), 240, 296 and 1024 (S in global memory), b normal, the
    inverted 8 x 8 diagonal blocks (3 x 3 at m 201), made with numpy
    (tests/test_torch_pcg.py's cases)."""
    import numpy as np
    import torch
    out = []
    for m in (200, 201, 240, 296, 1024):
        rng = np.random.default_rng(3)
        A = rng.standard_normal((m, m))
        S = (A @ A.T + m * np.eye(m)).astype(np.float32)
        b = rng.standard_normal(m).astype(np.float32)
        tf = 8 if m % 8 == 0 else 3
        inv = np.linalg.inv(np.stack([S[i:i + tf, i:i + tf]
                                      for i in range(0, m, tf)]))
        out.append((f"seeded m {m}", 0, torch.as_tensor(S, device="cuda"),
                    torch.as_tensor(b, device="cuda"),
                    torch.as_tensor(inv.astype(np.float32), device="cuda"),
                    dict(max_iterations=100, min_iterations=0,
                         q_tolerance=0.01, residual_reset_period=10)))
    return out


def k7_runs():
    """The runs of K7 (ops/pcg.py dense_pcg) on every system of
    `k7_systems`: y, the iteration count and ||r||, against the plain
    version; the line gives the system's CG iterations and its bound
    (chip_smoke.py pcg_flops for these iterations against the bytes)."""
    from ceres_tpu_torch.ops import pcg
    from chip_smoke import F32_FLOP_PER_S, bound, nbytes, pcg_flops
    runs = []
    for name, k, S, rhs, minv, kw in k7_systems() + k7_seeded():
        def call(S=S, rhs=rhs, minv=minv, kw=kw, fn=pcg.dense_pcg):
            y, it, norm = fn(S, rhs, minv, **kw)
            return {"y": y, "iterations": it.reshape(1),
                    "norm": norm.reshape(1)}
        got = call()
        iters = int(got["iterations"])
        m, tf = S.shape[0], 0 if minv is None else minv.shape[-1]
        bound_ms, bound_by = bound(
            nbytes(S, rhs, minv, got),
            pcg_flops(m, tf, iters, kw.get("residual_reset_period", 10)),
            F32_FLOP_PER_S)
        runs.append((
            {"kernel": "K7 dense_pcg", "cameras": name, "system": k,
             "shape": [m], "cg_iterations": iters, "bound_ms": bound_ms,
             "bound_by": bound_by},
            call, lambda call=call: call(fn=pcg.dense_pcg_plain),
            pcg.dense_pcg, None, f"K7 {name} {k}"))
    return runs


def line_fit(pts):
    """(value at 0, slope) of the least-squares line through (x, y)
    points; slope None when every x is the same."""
    n = len(pts)
    mx = sum(p[0] for p in pts) / n
    my = sum(p[1] for p in pts) / n
    sxx = sum((p[0] - mx) ** 2 for p in pts)
    if sxx == 0:
        return my, None
    slope = sum((p[0] - mx) * (p[1] - my) for p in pts) / sxx
    return my - slope * mx, slope


def k7_fit(runs):
    """Print, per problem, the least-squares line of K7's device time a
    call against its CG iterations over the problem's systems: the time
    at 0 iterations and the time a CG iteration (us)."""
    for name in ("angle-axis", "quaternion"):
        pts = [(r[0]["cg_iterations"], r[0]["device_us"]) for r in runs
               if r[0]["kernel"] == "K7 dense_pcg"
               and r[0]["cameras"] == name]
        if len(pts) < 2:
            continue
        at0, per_it = line_fit(pts)
        print(json.dumps({"kernel": "K7 fit", "cameras": name,
                          "systems": len(pts),
                          "cg_iterations": sum(p[0] for p in pts),
                          "device_us_at_0": at0,
                          "device_us_per_iteration": per_it,
                          "device_us_all_systems": sum(
                              p[1] for p in pts)}), flush=True)


def measure(runs, dump):
    """Each run is (JSON line, call, plain version, wrapper whose
    `launches` counts, kernel-name filter of the device time or None for
    every kernel of a call, dump prefix): the error against the plain
    version, every call's clocks first, then each under the profiler (a
    profiler session leaves the launch path slower); prints one line a
    run and saves the outputs under `dump` when given."""
    import torch
    dumped = {}
    for line, fn, plain, counter, _, prefix in runs:
        got, want = fn(), plain()
        if isinstance(got, tuple):
            got, want = dict(zip("rJ", got)), dict(zip("rJ", want))
        counter.launches = 0
        fn()
        dumped.update({f"{prefix} {k}": v.cpu() for k, v in got.items()})
        line.update({
            "launches_a_call": counter.launches,
            "max_rel_err": max(float(torch.max(torch.abs(got[k] - want[k]))
                                     / torch.max(torch.abs(want[k])))
                               for k in want),
            "ms": events_ms(fn), "loop_ms": events_ms(fn, 100, 5),
            "host_us": host_us(fn), "plain_ms": events_ms(plain)})
        del got, want
    for line, fn, _, _, match, _ in runs:
        by_kernel = kernel_us(fn)
        line["device_us"] = sum(t for k, t in by_kernel.items()
                                if match is None or match in k)
        if match is None:
            line["device_span_us"] = device_span_us(fn)
        if match is None:
            line["device_us_by_kernel"] = {short_name(k): t
                                           for k, t in by_kernel.items()}
        print(json.dumps(line), flush=True)
    if dump:
        os.makedirs(dump, exist_ok=True)
        torch.save(dumped, os.path.join(dump, "kernel_outputs.pt"))


# K1's and K11's hand kernels in the library (this tree's names and the
# parent's: lin_point_kernel, linearize_*_kernel)
_LIBRARY_KERNELS = ("SnavelyK1Chain", "Pose3dRow", "Pose2dRow", "SnavelyRow",
                    "lin_point_kernel", "ftf_partial_kernel",
                    "ftf_final_kernel", "linearize_pose3d_kernel",
                    "linearize_pose2d_kernel", "linearize_snavely_kernel")


def library_usage():
    """{kernel: resources} of K1's and K11's hand kernels in the imported
    checkout's kernel library (ops/_cuda.py build)."""
    from ceres_tpu_torch.ops import _cuda
    return {k: v for k, v in res_usage(str(_cuda.build())).items()
            if any(name in k for name in _LIBRARY_KERNELS)}


def generated_usage():
    """{library: {"unit": its first line, kernel: resources}} of every
    generated unit this process built (ops/_cuda.py build_generated)."""
    from ceres_tpu_torch.ops import _cuda
    out = {}
    for lib in sorted(_cuda._generated):
        src = os.path.join(os.path.dirname(lib),
                           os.path.basename(lib)[len("lib"):-len(".so")]
                           + ".cu")
        with open(src) as f:
            head = f.readline().strip()
        out[os.path.basename(lib)] = {"unit": head, **res_usage(lib)}
    return out


def compare(a, b):
    """Print, for each output of two --dump directories, whether its bits
    agree, and the count of entries that differ."""
    import torch
    da = torch.load(os.path.join(a, "kernel_outputs.pt"))
    db = torch.load(os.path.join(b, "kernel_outputs.pt"))
    for key in sorted(da):
        x, y = da[key], db.get(key)
        if y is None or x.shape != y.shape:
            print(json.dumps({"output": key, "same_bits": False,
                              "why": "missing or another shape"}))
            continue
        xb, yb = x.view(torch.int32), y.view(torch.int32)
        differ = int((xb != yb).sum())
        print(json.dumps({"output": key, "same_bits": differ == 0,
                          "entries_that_differ": differ,
                          "max_abs_diff": float(torch.max(torch.abs(
                              x - y))) if differ else 0.0}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--only", nargs="*",
                    choices=("K1", "K11hand", "K3", "K2", "K8", "K10", "K5",
                             "K11auto", "K4", "K9", "K7"),
                    help="time only these (K2 stands for K2 and K6)")
    ap.add_argument("--dump", default=None,
                    help="save the K1, K4, K5, K7, K9 and K11 outputs here")
    ap.add_argument("--compare", nargs=2, default=None,
                    help="compare the bits of two --dump directories")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return

    def want(name):
        return not args.only or name in args.only
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from ceres_tpu_torch.ops import kernels, lin
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(f"tree {os.path.abspath(args.tree)}; torch {torch.__version__}",
          flush=True)
    gen = torch.Generator(device="cuda")
    runs = []
    if want("K1"):
        runs += k1_runs()
    if want("K11hand"):
        runs += k11_hand_runs()
    if want("K5") or want("K11auto"):
        runs += k5_k11auto_runs(want("K5"), want("K11auto"))
    if want("K4"):
        runs += k4_runs()
    if want("K9"):
        runs += k9_runs()
    if want("K7"):
        runs += k7_runs()
    if runs:
        measure(runs, args.dump)
        k7_fit(runs)
    if want("K1") or want("K11hand"):
        print(json.dumps({"library": library_usage()}), flush=True)
    if want("K5") or want("K11auto"):
        print(json.dumps({"generated_units": generated_usage()}), flush=True)

    # K3 at the reduced camera systems, beside torch.linalg.solve
    systems = []
    if want("K3"):
        for m in (144, 160):
            gen.manual_seed(m)
            B = torch.randn(m, m + 4, device="cuda", generator=gen)
            systems.append(("seeded", B @ B.T + m * torch.eye(m, device="cuda"),
                            torch.randn(m, device="cuda", generator=gen)))
        systems.append(("solve",) + solve_system())
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

    if want("K8"):
        k8_line(gen)
    if want("K10"):
        k10_lines(gen)


def k8_line(gen):
    """K8 at the SE3 main bucket's shape, seeded."""
    import torch
    from ceres_tpu_torch.ops import kernels
    gen.manual_seed(1)
    n, r, t, m = 2396, 6, 12, 12000
    J = torch.randn(n, r, t, device="cuda", generator=gen)
    v = torch.randn(m, device="cuda", generator=gen)
    cols = torch.randint(0, m, (n, t), device="cuda", generator=gen)
    cols32 = cols.to(torch.int32)
    if "cols" in inspect.signature(kernels.bucket_jtjv).parameters:
        def k8():
            return kernels.bucket_jtjv(J, v, cols32)
        expected = kernels.bucket_jtjv_plain(J, v, cols32)
        route = "gather in the kernel"
    else:
        def k8():
            return kernels.bucket_jtjv(J, v[cols])
        expected = kernels.bucket_jtjv_plain(J, v[cols])
        route = "gather, then the kernel"
    err = float(torch.max(torch.abs(k8() - expected)))
    print(json.dumps({"kernel": "K8 bucket_jtjv", "shape": [n, r, t, m],
                      "route": route, "max_abs_err": err,
                      "ms": events_ms(k8), "loop_ms": events_ms(k8, 100, 5),
                      "device_us": device_us(k8, "jtjv_kernel")}),
          flush=True)


def k10_lines(gen):
    """K10 at the 1M shapes, seeded."""
    import torch
    from ceres_tpu_torch.ops import implicit
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
