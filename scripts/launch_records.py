#!/usr/bin/env python3
"""How far torch.profiler's kernel counts of a batch solve repeat: the
configurations of chip_smoke.py's slice-15 launch check (f64 and mixed
CGNR on SE2 graphs, mixed ITERATIVE_SCHUR on BA), each at 8 and 64
elements and at (LM, CG) iterations (1, 3), (1, 6) and (2, 3): a warm-up,
then 8 profiled solves (the last 4 with Python's garbage collector off).
Prints each run's (device kernel records, device-to-host copies, gc
off) and, for a run whose kernel count differs from the smallest, the
kernels and CPU ops (aten ops and CUDA runtime calls, the host's
launches among them) it has more or fewer.

    python3 scripts/launch_records.py      # on a machine with a card
"""
import collections
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ceres_tpu_torch as ctt  # noqa: E402
from ceres_tpu_torch.examples import slam, tutorial  # noqa: E402
from ceres_tpu_torch.io import bal as bal_io, g2o  # noqa: E402

pk = dict(mod=ctt, bal_io=bal_io, slam=slam, g2o=g2o, tutorial=tutorial)
torch.backends.cuda.matmul.allow_tf32 = False
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
t00 = time.time()


def short(n):
    return n[:100]


def diff(a, b):
    return sorted((short(k), v) for k, v in (a - b).items())


for label, kind, kw in (
        ("CGNR", "se2", dict(linear_solver_type="CGNR",
                             preconditioner_type="JACOBI")),
        ("CGNR_MIXED", "se2", dict(cs._MIXED, linear_solver_type="CGNR",
                                   preconditioner_type="JACOBI")),
        ("ITERATIVE_SCHUR", "ba", dict(
            cs._MIXED, linear_solver_type="ITERATIVE_SCHUR",
            preconditioner_type="SCHUR_JACOBI"))):
    for B in (8, 64):
        elems = cs.slice15_elements(kind, pk, n=B,
                                    poses=cs.SLICE15_LAUNCH_POSES)
        starts = [[a.copy() for a in arrs] for _, arrs in elems]
        probs = [p for p, _ in elems]
        for iters, cg in ((1, 3), (1, 6), (2, 3)):
            o = cs.slice15_options(
                ctt, kind, kw, batch_mode="batch", device="cuda",
                max_num_iterations=iters, gradient_tolerance=1e-300,
                function_tolerance=1e-300, parameter_tolerance=1e-300,
                min_linear_solver_iterations=cg,
                max_linear_solver_iterations=cg)
            runs = []
            for rep in range(9):
                for (_, arrs), st in zip(elems, starts):
                    for a, a0 in zip(arrs, st):
                        a[...] = a0
                torch.cuda.synchronize()
                if rep == 0:
                    ctt.solve_batched(o, probs)
                    continue
                nogc = rep >= 5
                if nogc:
                    gc.collect()
                    gc.disable()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    ctt.solve_batched(o, probs)
                    torch.cuda.synchronize()
                if nogc:
                    gc.enable()
                ev = prof.events()
                kern = collections.Counter(
                    e.name for e in ev if e.device_type == CUDA
                    and not e.name.startswith(("Memcpy", "Memset")))
                d2h = sum(1 for e in ev if e.device_type == CUDA
                          and e.name.startswith("Memcpy DtoH"))
                ops = collections.Counter(e.name for e in ev
                                          if e.device_type == CPU)
                runs.append((sum(kern.values()), d2h, nogc, kern, ops))
            print(f"{label} B={B} ({iters}, {cg}): (kernels, DtoH, gc off) "
                  f"{[r[:3] for r in runs]}", flush=True)
            lo = min(runs, key=lambda r: r[0])
            for r in runs:
                if r[0] != lo[0]:
                    print(f"   run {r[:3]}: kernels + {diff(r[3], lo[3])} "
                          f"- {diff(lo[3], r[3])}; CPU ops + "
                          f"{diff(r[4], lo[4])} - {diff(lo[4], r[4])}",
                          flush=True)
print(f"diag: {time.time() - t00:.1f} s", flush=True)
