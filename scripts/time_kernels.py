#!/usr/bin/env python3
"""K8 and K10 of one checkout of ceres_tpu_torch on the card, at the main
paths' shapes, with seeded inputs.

    python3 scripts/time_kernels.py [--tree DIR]

Imports ceres_tpu_torch from DIR (default: this checkout), so that one
script times two checkouts alike: run it on each in turns (parent,
change, change, parent) in one call on one card. Inputs are made on the
card from fixed seeds, so both checkouts see the same bits:

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
the largest difference from the plain version (K10 must give the same
bits), the median of 20 single calls and the mean of 100 back-to-back
calls by CUDA events (ms), and the device time per launch by
torch.profiler (us). Needs a CUDA device.
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


def device_us(fn, match, calls=100):
    """Device time per launch (us) of the kernels whose name holds
    `match`, by torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if match in e.key:
            total += getattr(e, "device_time_total", None) or \
                e.cuda_time_total
            count += e.count
    return total / max(count, 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from ceres_tpu_torch.ops import implicit, kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(f"tree {os.path.abspath(args.tree)}; torch {torch.__version__}",
          flush=True)
    gen = torch.Generator(device="cuda")

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
