#!/usr/bin/env python3
"""The references of chip_smoke.py's slice 11 phase (problem_api_paths),
on the CPU, in either package.

    JAX_PLATFORMS=cpu python3 scripts/problem_api_reference.py
        [--packages jax,torch] [--parts outlier,evaluate,examples,mgh,
        gradcheck] [--spread] [--threads 1] [--device cpu]
        [--shifts PX,...] [--threshold PX]

outlier: the main path's problem (SHAPE, seed 7, PERTURB) with
shift_observations' outliers (OUTLIER_SHIFT_PX, or each of --shifts),
solved with bench.py's options, evaluated, remove_outliers at
--threshold or else at the middle of the widest gap between the errors
in OUTLIER_WINDOW_PX (which gives OUTLIER_THRESHOLD), solved again:
that gap, the nearest error's margin from the threshold, the removed
count and digest, the counts after removal, both solves' LM counts and
final costs; with --spread also from the starts scaled by SCALES at the
same threshold, with the largest move of a block's error from the
unscaled run and whether the removed set stayed. evaluate: the problem of
Trafalgar's shape (EVALUATE_SHAPE, perturbed as TRAFALGAR_ARGS say) at
its start, f64: cost, gradient norm, the Jacobian's nonzeros. examples:
the seven examples at EXAMPLE_RUNS' settings (LM count, final cost,
settled iterations); with --spread also libmv_homography with its
second point set scaled by SCALES (its exact fit ends at the rounding).
mgh: every More-Garbow-Hillstrom problem, unconstrained (trial 0) and
constrained; with --spread also from the start scaled by SCALES (the
largest distance of those runs' LM counts and final costs from the
unscaled run: the runs go on to tolerances of 1e-18, so their last
iterations follow the rounding, and a start moved at the rounding's
level moves them as much as one moved by 1e-7). Each run also prints
how many of its LM iterations came after its cost settled within 1e-12
of its final value (`settle`). gradcheck: the check_gradients message of
a wrong analytic cost (GRADCHECK_WRONG) and the probe of the first
GRADCHECK_BLOCKS Snavely blocks of OUTLIER's problem at
GRADCHECK_PRECISION: the flags, their digest, each block's largest
relative error and the widest gaps between those errors.

Prints one line a run; the JAX package's numbers are chip_smoke.py's
constants. The outlier and evaluate parts are full size (a few GB, a few
minutes): run them on the card's machine with CUDA_VISIBLE_DEVICES=.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (1.0 - 1e-14, 1.0 + 1e-14, 1.0 - 1e-10, 1.0 + 1e-10, 1.0 - 1e-7,
          1.0 + 1e-7)


DEVICE = "cpu"


def load(pkg):
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as T
        import ceres_tpu as mod
        return mod, T, {}
    import torch as T
    import ceres_tpu_torch as mod
    return mod, T, {"device": DEVICE}


def widest_gap(err, lo, hi):
    """(threshold, error below, error above) of the widest gap, relative
    to its middle, between neighbouring sorted errors that overlaps
    [lo, hi] px; the threshold is the gap's middle, held to [lo, hi], to
    5 significant digits."""
    import numpy as np
    e = np.sort(err)
    a, b = e[:-1], e[1:]
    cand = np.nonzero((b >= lo) & (a <= hi))[0]
    j = cand[int(np.argmax(((b - a) / (b + a))[cand]))]
    t = min(max((a[j] + b[j]) / 2, lo), hi)
    return float(f"{t:.5g}"), float(a[j]), float(b[j])


def _outlier_run(mod, kw, scale, shift, threshold):
    """One OUTLIER run from the start scaled by `scale`, with the
    observations moved `shift` px; `threshold` None takes widest_gap of
    this run's errors in OUTLIER_WINDOW_PX."""
    import numpy as np
    from chip_smoke import (OUTLIER_WINDOW_PX, PERTURB, SHAPE,
                            outlier_options, remove_outliers,
                            removed_digest, shift_observations)
    bal_io = __import__(f"{mod.__name__}.io.bal", fromlist=["bal"])
    bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    shifted = shift_observations(bal.observations, shift=shift)
    problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
    for a in cams + pts:
        a *= scale
    rbs = problem.residual_blocks()
    t0 = time.time()
    s1 = mod.solve(outlier_options(mod, **kw), problem)
    w1 = time.time() - t0
    _, r, _, _ = problem.evaluate(want_residuals=True, **kw)
    gap = widest_gap(np.hypot(r[0::2], r[1::2]), *OUTLIER_WINDOW_PX)
    if threshold is None:
        threshold = gap[0]
    removed, emptied, err = remove_outliers(
        problem, rbs, pts, bal.point_index, r, threshold)
    t0 = time.time()
    s2 = mod.solve(outlier_options(mod, **kw), problem)
    return dict(s1=s1, s2=s2, w1=w1, w2=time.time() - t0, err=err,
                gap=gap, threshold=threshold, shifted=shifted,
                removed=removed, emptied=emptied,
                digest=removed_digest(removed),
                blocks=problem.num_residual_blocks(),
                parameters=problem.num_parameters())


def outlier(pkg, spread, shifts=None, threshold=None):
    import numpy as np
    from chip_smoke import OUTLIER_SHIFT_PX, OUTLIER_WINDOW_PX
    mod, _, kw = load(pkg)
    for shift in shifts or (OUTLIER_SHIFT_PX,):
        t = threshold
        runs = []
        for scale in (1.0,) + (SCALES if spread else ()):
            o = _outlier_run(mod, kw, scale, shift, t)
            t = o["threshold"]
            err = np.sort(o["err"])
            k = int(np.searchsorted(err, t))
            lo = err[k - 1] if k else 0.0
            hi = err[k] if k < err.size else float("inf")
            s1, s2 = o["s1"], o["s2"]
            rel = ""
            if runs:
                c1, c2 = runs[0]["s1"].final_cost, runs[0]["s2"].final_cost
                same = o["digest"] == runs[0]["digest"]
                e0 = runs[0]["err"]
                move = float(np.max(np.abs(o["err"] - e0)
                                    / np.maximum(e0, 1.0)))
                rel = (f"; from the unscaled "
                       f"{abs(s1.final_cost - c1) / c1:.3e}, "
                       f"{abs(s2.final_cost - c2) / c2:.3e}, errors moved "
                       f"by {move:.3e} at most, removed set "
                       f"{'the same' if same else 'DIFFERENT'}")
            g = o["gap"]
            print(f"{pkg} OUTLIER {shift} px (start x {scale!r}): first "
                  f"solve {s1.num_iterations} LM to {s1.final_cost!r} "
                  f"({s1.termination_type}, {o['w1']:.1f} s); widest gap "
                  f"in {OUTLIER_WINDOW_PX} px {g[1]!r} .. {g[2]!r} (middle "
                  f"{g[0]!r}); threshold {t!r} between {lo!r} and {hi!r} "
                  f"(margin {min(t - lo, hi - t) / t:.4e} of it); removed "
                  f"{o['removed'].size} blocks "
                  f"({int(np.isin(o['shifted'], o['removed']).sum())} of "
                  f"the {o['shifted'].size} shifted; digest {o['digest']}),"
                  f" {o['emptied'].size} points; {o['blocks']} residual "
                  f"blocks, {o['parameters']} parameters left; second solve "
                  f"{s2.num_iterations} LM to {s2.final_cost!r} "
                  f"({s2.termination_type}, {o['w2']:.1f} s){rel}",
                  flush=True)
            runs.append(o)


def evaluate(pkg, spread):
    import numpy as np
    from chip_smoke import EVALUATE_SHAPE, evaluate_problem
    mod, _, kw = load(pkg)
    bal_io = __import__(f"{mod.__name__}.io.bal", fromlist=["bal"])
    problem, cams, pts = evaluate_problem(bal_io)
    t0 = time.time()
    cost, r, g, J = problem.evaluate(want_residuals=True, want_gradient=True,
                                     want_jacobian=True,
                                     jacobian_format="csr", **kw)
    print(f"{pkg} EVALUATE ({EVALUATE_SHAPE}): cost {cost!r}, gradient norm "
          f"{float(np.linalg.norm(g))!r}, residual norm "
          f"{float(np.linalg.norm(r))!r}, Jacobian {J.shape} with {J.nnz} "
          f"nonzeros, {time.time() - t0:.1f} s", flush=True)


def settle(summary, rel=1e-12, floor=1e-20):
    """LM iterations run after the cost first came within `rel` (or
    `floor`) of its final value: iterations at the rounding's level,
    whose number follows the rounding."""
    final = summary.final_cost
    costs = [it.cost for it in summary.iterations]
    near = [i for i, c in enumerate(costs)
            if abs(c - final) <= max(rel * abs(final), floor)]
    return (len(costs) - 1 - near[0]) if near else 0


def examples(pkg, spread):
    from chip_smoke import EXAMPLE_RUNS, run_example
    mod, _, kw = load(pkg)
    for name in EXAMPLE_RUNS:
        t0 = time.time()
        s = run_example(mod, name, **kw)[0]
        print(f"{pkg} EXAMPLE {name}: {len(s.iterations) - 1} LM, "
              f"{s.termination_type}, final cost {s.final_cost!r}, "
              f"settled {settle(s)}, {time.time() - t0:.1f} s", flush=True)
    if spread:      # libmv_homography's exact fit ends at the rounding
        runs = [run_example(mod, "libmv_homography", scale=sc, **kw)[0]
                for sc in (1.0,) + SCALES]
        dn = max(abs(len(r.iterations) - len(runs[0].iterations))
                 for r in runs)
        dc = max(abs(r.final_cost - runs[0].final_cost) for r in runs)
        print(f"{pkg} EXAMPLE libmv_homography spread (second point set "
              f"scaled): {dn} LM, {dc!r}", flush=True)


def mgh(pkg, spread):
    import math
    import numpy as np
    mod, _, kw = load(pkg)
    ex = __import__(f"{mod.__name__}.examples.more_garbow_hillstrom",
                    fromlist=["x"])
    for constrained in (False, True):
        for p in ex.PROBLEMS:
            if constrained and math.isnan(p.constrained_optimal_cost):
                continue
            runs = []
            for scale in (1.0,) + (SCALES if spread else ()):
                q = ex.MGHProblem(**{**p.__dict__, "initial_x": list(
                    np.asarray(p.initial_x) * scale)})
                lre, s, _ = ex.solve_mgh(q, constrained=constrained, **kw)
                runs.append((len(s.iterations) - 1, s.final_cost, lre,
                             str(s.termination_type), settle(s)))
            n0, c0 = runs[0][0], runs[0][1]
            dn = max(abs(n - n0) for n, *_ in runs)
            dc = max(abs(c - c0) for _, c, *_ in runs)
            print(f"{pkg} MGH {p.number} {'C' if constrained else 'U'}: "
                  f"{n0} LM, final cost {c0!r}, LRE {runs[0][2]:.3f}, "
                  f"{runs[0][3]}, settled {runs[0][4]}; scaled starts "
                  f"{[r[0] for r in runs[1:]]} (spread {dn} LM, {dc!r})",
                  flush=True)


def gradcheck(pkg, spread):
    import hashlib
    import numpy as np
    from chip_smoke import (GRADCHECK_BLOCKS, GRADCHECK_PRECISION,
                            GRADCHECK_WRONG, PERTURB, SHAPE,
                            shift_observations)
    mod, T, kw = load(pkg)
    s = GRADCHECK_WRONG(mod, T, **kw)
    print(f"{pkg} GRADCHECK: {s.termination_type}: {s.message!r}",
          flush=True)
    bal_io = __import__(f"{mod.__name__}.io.bal", fromlist=["bal"])
    bal = bal_io.synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    shift_observations(bal.observations)
    problem, cams, pts = bal_io.build_bal_ceres_problem(bal)
    flags, worst = [], []
    for rb in problem.residual_blocks()[:GRADCHECK_BLOCKS]:
        res = mod.GradientChecker(rb.cost, **kw).probe(
            [cams[bal.camera_index[rb.index]],
             pts[bal.point_index[rb.index]]], GRADCHECK_PRECISION)
        flags.append(res.return_value)
        worst.append(res.maximum_relative_error)
    digest = hashlib.sha256(np.asarray(flags).tobytes()).hexdigest()[:16]
    w = np.sort(worst)
    ratios = w[1:] / w[:-1]
    print(f"{pkg} GRADCHECK probe at {GRADCHECK_PRECISION:g}: {sum(flags)} "
          f"of {len(flags)} pass, flags digest {digest}, largest relative "
          f"error {max(worst)!r}, their sum {float(np.sum(worst))!r}; the "
          f"widest gaps of the sorted errors: "
          + ", ".join(f"{w[j]:.3e} .. {w[j + 1]:.3e} (after {j + 1})"
                      for j in np.argsort(ratios)[::-1][:5]), flush=True)
    print(f"{pkg} GRADCHECK errors by block: "
          f"{[float(f'{x:.4e}') for x in worst]}", flush=True)


PARTS = dict(outlier=outlier, evaluate=evaluate, examples=examples,
             mgh=mgh, gradcheck=gradcheck)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--parts", default="outlier,evaluate,examples,mgh,"
                                       "gradcheck")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the JAX package runs on the "
                         "CPU)")
    ap.add_argument("--shifts", default=None,
                    help="outlier: comma-separated shifts in px (default "
                         "OUTLIER_SHIFT_PX)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="outlier: the threshold in px (default: the "
                         "middle of the widest gap in OUTLIER_WINDOW_PX)")
    args = ap.parse_args()
    global DEVICE
    DEVICE = args.device
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(args.threads)
    for pkg in args.packages.split(","):
        for part in args.parts.split(","):
            if part == "outlier":
                outlier(pkg, args.spread, shifts=[
                    float(x) for x in args.shifts.split(",")]
                    if args.shifts else None, threshold=args.threshold)
            else:
                PARTS[part](pkg, args.spread)


if __name__ == "__main__":
    main()
