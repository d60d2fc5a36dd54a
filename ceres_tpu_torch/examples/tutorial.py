"""The tutorial's examples: helloworld, Powell, curve fitting, robust curve
fitting and Rosenbrock.

Counterpart of ceres_tpu/examples/tutorial.py (the reference's
examples/helloworld{,_numeric_diff,_analytic_diff}.cc, powell.cc,
curve_fitting.cc, robust_curve_fitting.cc and rosenbrock.cc; the
nnls_tutorial.rst workloads), on `device` (default cuda):

    python -m ceres_tpu_torch.examples.tutorial {helloworld,powell,curve,
        robust_curve,rosenbrock} [--diff {auto,numeric,analytic}]
        [--device cpu]

Each function returns what the JAX example returns (the solved arrays
and the summary).
"""

from __future__ import annotations

import sys

import numpy as np
import torch


# ---------------------------------------------------------------- helloworld
def helloworld(diff: str = "auto", device: str = "cuda"):
    """min 0.5 (10 - x)^2 from x = 0.5, with the residual's derivative by
    autodiff, numeric differences or by hand."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.cost import (AutoDiffCostFunction,
                                      NumericDiffCostFunction,
                                      SizedCostFunction)

    x = np.array([0.5])

    def functor(xv):
        return 10.0 - xv

    if diff == "auto":
        cost = AutoDiffCostFunction(functor, 1, [1])
    elif diff == "numeric":
        cost = NumericDiffCostFunction(functor, num_residuals=1,
                                       parameter_block_sizes=[1])
    else:  # analytic (helloworld_analytic_diff.cc QuadraticCostFunction)
        class QuadraticCostFunction(SizedCostFunction):
            def __init__(self):
                super().__init__(1, [1])

            def residuals(self, xv):
                return 10.0 - xv

            def jacobians(self, xv):
                return [torch.full((1, 1), -1.0, dtype=xv.dtype,
                                   device=xv.device)]

        cost = QuadraticCostFunction()

    problem = ctt.Problem()
    problem.add_residual_block(cost, None, x)
    summary = ctt.solve(ctt.SolverOptions(device=device), problem)
    print(summary.brief_report())
    print(f"x : 0.5 -> {x[0]:.6g}")
    return x, summary


# -------------------------------------------------------------------- powell
def powell_residuals():
    """The four residuals of Powell's function (examples/powell.cc F1-F4)."""

    def f1(x1, x2):
        return x1 + 10.0 * x2

    def f2(x3, x4):
        return 5.0 ** 0.5 * (x3 - x4)

    def f3(x2, x3):
        return (x2 - 2.0 * x3) ** 2

    def f4(x1, x4):
        return 10.0 ** 0.5 * (x1 - x4) ** 2

    return f1, f2, f3, f4


def powell(minimizer: str = "trust_region", device: str = "cuda"):
    """Powell's singular function: 4 parameters in 4 blocks, 4 residuals
    (the reference's tutorial: 15 iterations to a cost of ~1e-15)."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.cost import AutoDiffCostFunction

    x1 = np.array([3.0])
    x2 = np.array([-1.0])
    x3 = np.array([0.0])
    x4 = np.array([1.0])
    f1, f2, f3, f4 = powell_residuals()

    problem = ctt.Problem()
    problem.add_residual_block(AutoDiffCostFunction(f1, 1, [1, 1]),
                               None, x1, x2)
    problem.add_residual_block(AutoDiffCostFunction(f2, 1, [1, 1]),
                               None, x3, x4)
    problem.add_residual_block(AutoDiffCostFunction(f3, 1, [1, 1]),
                               None, x2, x3)
    problem.add_residual_block(AutoDiffCostFunction(f4, 1, [1, 1]),
                               None, x1, x4)

    options = ctt.SolverOptions(
        minimizer_type=ctt.MinimizerType[minimizer.upper()],
        linear_solver_type=ctt.LinearSolverType.DENSE_QR,
        max_num_iterations=100, device=device)
    summary = ctt.solve(options, problem)
    print(summary.brief_report())
    print(f"x = [{x1[0]:.3g}, {x2[0]:.3g}, {x3[0]:.3g}, {x4[0]:.3g}]")
    return summary


# ------------------------------------------------------------- curve fitting
# y = exp(0.3 x + 0.1) + N(0, 0.2^2) samples (nnls_tutorial.rst Curve
# Fitting data, examples/curve_fitting.cc:25-58).
CURVE_DATA = np.array([
    0.000000e+00, 1.133898e+00, 7.500000e-02, 1.334902e+00,
    1.500000e-01, 1.213546e+00, 2.250000e-01, 1.252016e+00,
    3.000000e-01, 1.392265e+00, 3.750000e-01, 1.314458e+00,
    4.500000e-01, 1.472541e+00, 5.250000e-01, 1.536218e+00,
    6.000000e-01, 1.355679e+00, 6.750000e-01, 1.463566e+00,
    7.500000e-01, 1.490201e+00, 8.250000e-01, 1.658699e+00,
    9.000000e-01, 1.067574e+00, 9.750000e-01, 1.464629e+00,
    1.050000e+00, 1.402653e+00, 1.125000e+00, 1.713141e+00,
    1.200000e+00, 1.527021e+00, 1.275000e+00, 1.702632e+00,
    1.350000e+00, 1.423899e+00, 1.425000e+00, 1.543078e+00,
    1.500000e+00, 1.664015e+00, 1.575000e+00, 1.732484e+00,
    1.650000e+00, 1.543296e+00, 1.725000e+00, 1.959523e+00,
    1.800000e+00, 1.685132e+00, 1.875000e+00, 1.951791e+00,
    1.950000e+00, 2.095346e+00, 2.025000e+00, 2.361460e+00,
    2.100000e+00, 2.169119e+00, 2.175000e+00, 2.061745e+00,
    2.250000e+00, 2.178641e+00, 2.325000e+00, 2.104346e+00,
    2.400000e+00, 2.584470e+00, 2.475000e+00, 1.914158e+00,
    2.550000e+00, 2.368375e+00, 2.625000e+00, 2.686125e+00,
    2.700000e+00, 2.712395e+00, 2.775000e+00, 2.499511e+00,
    2.850000e+00, 2.558897e+00, 2.925000e+00, 2.309154e+00,
    3.000000e+00, 2.869503e+00, 3.075000e+00, 3.116645e+00,
    3.150000e+00, 3.094907e+00, 3.225000e+00, 2.471759e+00,
    3.300000e+00, 3.017131e+00, 3.375000e+00, 3.232381e+00,
    3.450000e+00, 2.944596e+00, 3.525000e+00, 3.385343e+00,
    3.600000e+00, 3.199826e+00, 3.675000e+00, 3.423039e+00,
    3.750000e+00, 3.621552e+00, 3.825000e+00, 3.559255e+00,
    3.900000e+00, 3.530713e+00, 3.975000e+00, 3.561766e+00,
    4.050000e+00, 3.544574e+00, 4.125000e+00, 3.867945e+00,
    4.200000e+00, 4.049776e+00, 4.275000e+00, 3.885601e+00,
    4.350000e+00, 4.110505e+00, 4.425000e+00, 4.345320e+00,
    4.500000e+00, 4.161241e+00, 4.575000e+00, 4.363407e+00,
    4.650000e+00, 4.161576e+00, 4.725000e+00, 4.619728e+00,
    4.800000e+00, 4.737410e+00, 4.875000e+00, 4.727863e+00,
    4.950000e+00, 4.669206e+00]).reshape(-1, 2)


class ExponentialResidual:
    """r = y - exp(m x + c) (examples/curve_fitting.cc:124)."""

    def __init__(self, x, y):
        self.x = x
        self.y = y

    def __call__(self, m, c):
        return self.y - torch.exp(m[0:1] * self.x + c[0:1])


def curve_fitting(robust: bool = False, device: str = "cuda"):
    """Exponential curve fit, 67 points; the robust variant puts
    CauchyLoss(0.5) on every point (examples/robust_curve_fitting.cc)."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.cost import AutoDiffCostFunction

    m = np.array([0.0])
    c = np.array([0.0])
    problem = ctt.Problem()
    loss = ctt.CauchyLoss(0.5) if robust else None
    for x, y in CURVE_DATA:
        cost = AutoDiffCostFunction(ExponentialResidual(float(x), float(y)),
                                    1, [1, 1])
        problem.add_residual_block(cost, loss, m, c)

    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.DENSE_QR,
        max_num_iterations=50, device=device)
    summary = ctt.solve(options, problem)
    print(summary.brief_report())
    print(f"m: 0 -> {m[0]:.6g}  c: 0 -> {c[0]:.6g}")
    return m, c, summary


# ---------------------------------------------------------------- rosenbrock
def make_rosenbrock():
    """FirstOrderFunction for f(x, y) = (1 - x)^2 + 100 (y - x^2)^2
    (examples/rosenbrock.cc), its gradient by torch.func.grad."""
    from ceres_tpu_torch.gradient_problem import FirstOrderFunction

    class Rosenbrock(FirstOrderFunction):
        def __init__(self):
            super().__init__(2)

        def cost(self, p):
            x, y = p[0], p[1]
            return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2

    return Rosenbrock()


def rosenbrock(direction: str = "LBFGS", device: str = "cuda"):
    """General unconstrained minimization by GradientProblemSolver."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.gradient_problem import (GradientProblem,
                                                  solve_gradient_problem)

    x = np.array([-1.2, 1.0])
    problem = GradientProblem(make_rosenbrock())
    options = ctt.SolverOptions(
        minimizer_type=ctt.MinimizerType.LINE_SEARCH,
        line_search_direction_type=ctt.LineSearchDirectionType[direction],
        max_num_iterations=200, device=device)
    summary = solve_gradient_problem(options, problem, x)
    print(summary.brief_report())
    print(f"x -> [{x[0]:.6g}, {x[1]:.6g}]")
    return x, summary


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "helloworld"
    rest = argv[1:]
    device = rest[rest.index("--device") + 1] if "--device" in rest \
        else "cuda"
    if which == "helloworld":
        diff = rest[rest.index("--diff") + 1] if "--diff" in rest else "auto"
        return helloworld(diff, device=device)
    if which == "powell":
        return powell(device=device)
    if which in ("curve", "robust_curve"):
        return curve_fitting(robust=which == "robust_curve", device=device)
    if which == "rosenbrock":
        return rosenbrock(device=device)
    raise SystemExit(f"unknown example {which}")


if __name__ == "__main__":
    main()
