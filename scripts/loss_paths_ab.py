#!/usr/bin/env python3
"""K1 and K5 under one set of loss scalars, and K1's hand loss instances
against generated ones, on the card, in one checkout of ceres_tpu_torch.

    python3 scripts/loss_paths_ab.py [--tree DIR] [--dump DIR] [--rounds 5]
    python3 scripts/loss_paths_ab.py --compare DIR DIR

K1 (ops/lin.py lin) on the DENSE_SCHUR path's first linearization of
BAL-16-22106 and K5 (ops/lin_auto.py lin_auto) on the quaternion
problem's (scripts/time_kernels.py dense_step and quaternion_k5, built by
the checkout from the same seeds, so every checkout sees the same bits),
under each stock scalar loss of loss.py (K1's hand instances) and, for
K5, under HuberLoss(1.0) and CauchyLoss(2.0), each through the
checkout's own way of passing the bucket's scalars (before this
script's PR by value as a kernel argument, since then in device memory
at row stride 0). Where the checkout has K1's generated loss units
(ops/lin.py k1_loss_unit), K1 also runs each stock loss through its
generated unit, and the script prints whether its bits equal the hand
instance's.

Imports ceres_tpu_torch from --tree (default: this checkout), so that
one script times two checkouts alike: run it on each in turns (parent,
change, change, parent) in one call on one card. Prints each call's
median CUDA-event time a call over `--rounds` rounds (10 x 10 calls a
round) with the card's name and power limit, and a JSON line last.
--dump DIR saves the outputs (torch.save, DIR/kernel_outputs.pt);
--compare DIR DIR prints, per output, whether two dumps have the same
bits (scripts/time_kernels.py compare).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from time_kernels import compare, events_ms
    if args.compare:
        compare(*args.compare)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("loss_paths_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.ops import lin, lin_auto
    from time_kernels import dense_step, quaternion_k5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; tree {os.path.abspath(args.tree)}", flush=True)
    generated = hasattr(lin, "k1_loss_unit")

    calls = {}
    program, step = dense_step()
    x0 = program.initial_state()
    ne, nf = step.ne, step.nf
    xf = x0[step.f_slab:step.f_slab + nf].float()
    xe = x0[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    se0, _ = step.initial_scales()
    for loss in (ctt.HuberLoss(1.0), ctt.SoftLOneLoss(1.0),
                 ctt.CauchyLoss(2.0), ctt.ArctanLoss(1.0),
                 ctt.TolerantLoss(1.0, 0.5), ctt.TukeyLoss(2.0)):
        name = type(loss).__name__

        def k1(loss=loss):
            return lin.lin(xf, xe, step.cam, step.mask, step.dat, se0, True,
                           True, loss, plan=step.plan)
        calls[f"K1 {name}"] = k1
        if generated:
            def k1_gen(k1=k1):
                held = lin.K1_ENTRIES
                lin.K1_ENTRIES = {None: held[None]}
                try:
                    return k1()
                finally:
                    lin.K1_ENTRIES = held
            calls[f"K1 {name} (generated unit)"] = k1_gen
    spec, kargs, _, _ = quaternion_k5()
    plan = lin_auto.camera_plan(kargs[3], kargs[4],
                                kargs[1].numel() // spec.tf)
    for loss in (ctt.HuberLoss(1.0), ctt.CauchyLoss(2.0)):
        calls[f"K5 {type(loss).__name__}"] = (
            lambda loss=loss: lin_auto.lin_auto(*kargs, True, True, loss,
                                                plan))

    outs = {name: {k: v.clone() for k, v in fn().items()}
            for name, fn in calls.items()}
    times = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            times[name].append(events_ms(fn, calls=10, reps=10))
    result = {"device": smi, "tree": os.path.abspath(args.tree), "ms": {},
              "generated_equals_hand": {}}
    for name in calls:
        ms = statistics.median(times[name])
        result["ms"][name] = ms
        line = f"{name}: {ms:.5f} ms (rounds {times[name]})"
        if name.endswith(" (generated unit)"):
            hand = outs[name[:-len(" (generated unit)")]]
            same = all(torch.equal(outs[name][k].view(torch.int32),
                                   hand[k].view(torch.int32)) for k in hand)
            result["generated_equals_hand"][name] = same
            line += f"; bits {'equal to' if same else 'differ from'} the " \
                    "hand instance's"
        print(line, flush=True)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        torch.save({f"{name} {k}": v.cpu() for name, o in outs.items()
                    for k, v in o.items()},
                   os.path.join(args.dump, "kernel_outputs.pt"))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
