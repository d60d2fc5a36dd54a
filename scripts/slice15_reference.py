#!/usr/bin/env python3
"""The JAX package's references of chip_smoke.py's slice 15 phase
(`slice15_paths`): its solve_batched(batch_mode="batch") on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/slice15_reference.py [--parts
        BA_SPARSE_SCHUR,...] [--small] [--out scripts/slice15_reference.json]
        [--first-steps-only]

Each part of chip_smoke.py's SLICE15_PARTS is solved on its elements
(chip_smoke.py slice15_elements, built with the JAX package's modules);
the "spread" parts also from the starts moved by
a -> a s + s - 1 for s in SLICE15_MOVES, and in pipeline mode (each
element through the single solve, which sums in another order than the
vmapped one: the rounding that parts the port's batch mode from JAX's);
their "spread" is the largest relative distance of those runs' final
costs from the batched run at the start, over the elements. --small solves 3 elements of each kind at small sizes
(a check of the script, not a reference). BA-16 elements at 10,000
observations and the 80,000-observation implicit elements are full size:
run it on a machine with the memory (the card's, with
CUDA_VISIBLE_DEVICES= ); the whole set takes several minutes of CPU.

Prints one line a run and, last, a JSON object of the references under
chip_smoke.py's part names: per part each element's [LM, linear]
iteration counts, its final cost and termination, the spread (None for
the f64 parts) and the wall of the run at the start. --out writes the
parts run into that file (chip_smoke.py's SLICE15_REF_FILE), beside the
parts it holds already. For the parts of chip_smoke.py's
SLICE15_FIRST_STEP_PARTS it also writes `first_steps`: per element the
batched step at the start (make_step_impl(..., batched=True), the step
solve_batched vmaps, at the element's Jacobi scale and the initial
radius) as [model cost change, step norm, linear iterations];
--first-steps-only computes those alone and keeps the part's other
fields from --out.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--first-steps-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ceres_tpu as ct
    import chip_smoke as cs
    from ceres_tpu.examples import slam, tutorial
    from ceres_tpu.io import bal as bal_io
    from ceres_tpu.io import g2o
    pk = dict(mod=ct, bal_io=bal_io, slam=slam, g2o=g2o, tutorial=tutorial)
    parts = (args.parts.split(",") if args.parts
             else list(cs.SLICE15_PARTS))
    small = dict(n=3, poses=70) if args.small else {}

    out = {}
    for part in parts:
        kind, kw, how = cs.SLICE15_PARTS[part]
        if part in cs.SLICE15_FIRST_STEP_PARTS:
            elems = cs.slice15_elements(kind, pk, **small)
            steps = first_steps(cs.slice15_options(ct, kind, kw),
                                [p for p, _ in elems])
            print(f"{part} first steps: {steps}", flush=True)
            out.setdefault(part, {})["first_steps"] = steps
        if args.first_steps_only:
            continue
        moves = (1.0,) + (cs.SLICE15_MOVES + ("pipeline",)
                          if how != "f64" else ())
        runs = {}
        for move in moves:
            mode = "pipeline" if move == "pipeline" else "batch"
            elems = cs.slice15_elements(
                kind, pk, move=1.0 if mode == "pipeline" else move, **small)
            opts = cs.slice15_options(ct, kind, kw, batch_mode=mode)
            t0 = time.time()
            ss = ct.solve_batched(opts, [p for p, _ in elems])
            wall = time.time() - t0
            runs[move] = ss
            print(f"{part} move {move!r}: wall {wall:.2f} s, counts "
                  f"{[(s.num_iterations, s.num_linear_solver_iterations) for s in ss]}"
                  f", costs {[s.final_cost for s in ss]}, terminations "
                  f"{sorted({s.termination_type.name for s in ss})}",
                  flush=True)
            if move == 1.0:
                out.setdefault(part, {}).update(dict(
                    counts=[[s.num_iterations,
                             s.num_linear_solver_iterations] for s in ss],
                    costs=[s.final_cost for s in ss], spread=None,
                    terminations=[s.termination_type.name for s in ss],
                    wall=wall))
        if how != "f64":
            base = [s.final_cost for s in runs[1.0]]
            out[part]["spread"] = max(
                abs(s.final_cost - c) / c
                for m in moves[1:] for s, c in zip(runs[m], base))
    print(json.dumps(out))
    if args.out:
        kept = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                kept = json.load(f)
        for k, v in out.items():
            kept.setdefault(k, {}).update(
                {f: v[f] for f in ("counts", "costs", "spread",
                                   "terminations", "first_steps")
                 if f in v})
        with open(args.out, "w") as f:
            f.write("{\n" + ",\n".join(
                f"{json.dumps(k)}:{json.dumps(v, separators=(',', ':'))}"
                for k, v in kept.items()) + "\n}\n")


def first_steps(options, problems):
    """The JAX package's batched step at each element's start: per
    element [model cost change, step norm, linear iterations]."""
    import jax
    import jax.numpy as jnp
    from ceres_tpu.program import CompiledProgram
    from ceres_tpu.solver import make_scale_impl, make_step_impl
    out = []
    for p in problems:
        prog = CompiledProgram.get_cached(p, options)
        step = make_step_impl(prog, options, batched=True)
        scale = make_scale_impl(prog, options)
        o = jax.jit(lambda x, r: step(x, r, scale(x)))(
            prog.initial_state(),
            jnp.asarray(options.initial_trust_region_radius, prog.dtype))
        out.append([float(o["model_cost_change"]), float(o["step_norm"]),
                    int(o["lin_iters"])])
    return out


if __name__ == "__main__":
    main()
