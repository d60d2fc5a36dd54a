"""Callback demos: the IterationCallback and the EvaluationCallback.

Counterpart of ceres_tpu/examples/callbacks_example.py (the reference's
examples/iteration_callback_example.cc and
evaluation_callback_example.cc), on `device` (default cuda):

1. IterationCallback: a record of every iteration, and early termination
   once the cost is tiny (SOLVER_TERMINATE_SUCCESSFULLY).
2. EvaluationCallback: prepare_for_evaluation() runs before each
   evaluation, so that user code can compute what many residual blocks
   share once a point (evaluation_callback.h:63); here it counts the
   points.

    python -m ceres_tpu_torch.examples.callbacks_example
        {iteration,evaluation} [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def iteration_callback_demo(device: str = "cuda"):
    """The curve fit y = exp(0.3 x + 0.1) with a callback recording
    (iteration, cost, radius); returns (trace, summary)."""
    import ceres_tpu_torch as ctt

    xs = np.linspace(0.0, 5.0, 40)
    ys = np.exp(0.3 * xs + 0.1)

    class Residual:
        def __init__(self, x, y):
            self.x = x
            self.y = y

        def __call__(self, m, c):
            return self.y - torch.exp(m[0] * self.x + c[0])

    m = np.array([0.0])
    c = np.array([0.0])
    problem = ctt.Problem()
    for x, y in zip(xs, ys):
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(Residual(float(x), float(y)), 1,
                                     [1, 1]), None, m, c)

    trace = []

    def record(it):
        trace.append((it.iteration, it.cost, it.trust_region_radius))
        if it.cost < 1e-12:
            return ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ctt.CallbackReturnType.SOLVER_CONTINUE

    options = ctt.SolverOptions(callbacks=[record], max_num_iterations=100,
                                device=device)
    summary = ctt.solve(options, problem)
    print(summary.brief_report())
    for (i, cost, radius) in trace:
        print(f"iter {i:3d}  cost {cost:.6e}  radius {radius:.1e}")
    return trace, summary


def evaluation_callback_demo(device: str = "cuda"):
    """A Rosenbrock-like fit with an EvaluationCallback counting new and
    repeated points; returns (calls, summary)."""
    import ceres_tpu_torch as ctt

    calls = {"new_point": 0, "same_point": 0}

    class MyEvaluationCallback:
        def prepare_for_evaluation(self, evaluate_jacobians,
                                   new_evaluation_point):
            if new_evaluation_point:
                calls["new_point"] += 1
            else:
                calls["same_point"] += 1

    def f(x):
        return torch.stack([x[0] - 3.0, 10.0 * (x[1] - x[0] * x[0])])

    x = np.array([0.0, 0.0])
    problem = ctt.Problem()
    problem.add_residual_block(ctt.AutoDiffCostFunction(f, 2, [2]), None, x)
    options = ctt.SolverOptions(
        evaluation_callback=MyEvaluationCallback(), max_num_iterations=100,
        device=device)
    summary = ctt.solve(options, problem)
    print(summary.brief_report())
    print(f"prepare_for_evaluation: {calls['new_point']} new-point, "
          f"{calls['same_point']} same-point calls")
    return calls, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="iteration",
                    choices=("iteration", "evaluation"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.which == "evaluation":
        evaluation_callback_demo(args.device)
    else:
        iteration_callback_demo(args.device)


if __name__ == "__main__":
    main()
