"""General unconstrained minimization: GradientProblem and its solver.

Counterpart of ceres_tpu/gradient_problem.py (the reference's
GradientProblem, gradient_problem.h:92; FirstOrderFunction,
first_order_function.h:40; GradientProblemSolver,
gradient_problem_solver.cc:103-167; GradientProblemEvaluator,
gradient_problem_evaluator.h:48). The cost is a torch function of the
parameter vector; its gradient comes from torch.func.grad (where the JAX
package takes jax.value_and_grad), from finite differences through
cost.py's NumericDiffCostFunction, or from the user's own
cost_and_gradient. The solve runs minimizers/line_search.py on
options.device and writes the result into the user's numpy array.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .cost import NumericDiffCostFunction, NumericDiffOptions
from .manifolds import Manifold
from .minimizers.line_search import minimize_line_search
from .types import (MinimizerType, NumericDiffMethodType, SolverOptions,
                    SolverSummary, TerminationType)


class FirstOrderFunction:
    """A scalar cost of num_parameters parameters: subclass with a torch
    `cost(x) -> scalar` (its gradient by torch.func.grad), or override
    `cost_and_gradient(x) -> (cost, gradient)` (the analytic path)."""

    def __init__(self, num_parameters: int):
        self._num_parameters = int(num_parameters)

    @property
    def num_parameters(self) -> int:
        return self._num_parameters

    def cost(self, x):
        raise NotImplementedError

    def cost_and_gradient(self, x):
        g, c = torch.func.grad_and_value(self.cost)(x)
        return c, g


class AutoDiffFirstOrderFunction(FirstOrderFunction):
    """A FirstOrderFunction from a scalar functor, its gradient by
    torch.func.grad (autodiff_first_order_function.h:105)."""

    def __init__(self, functor, num_parameters: int):
        super().__init__(num_parameters)
        self._functor = functor

    def cost(self, x):
        return torch.as_tensor(self._functor(x)).reshape(())


class NumericDiffFirstOrderFunction(FirstOrderFunction):
    """A FirstOrderFunction with a finite-difference gradient
    (numeric_diff_first_order_function.h): the functor as a one-residual
    NumericDiffCostFunction (FORWARD, CENTRAL or RIDDERS; all probes in one
    batched call), for functors torch.func cannot differentiate."""

    def __init__(self, functor, num_parameters: int, method=None,
                 options: Optional[NumericDiffOptions] = None):
        super().__init__(num_parameters)
        self._functor = functor
        fn = functor
        cost = NumericDiffCostFunction(
            lambda x: torch.as_tensor(fn(x)).reshape(1),
            method=method or NumericDiffMethodType.CENTRAL,
            num_residuals=1, parameter_block_sizes=[self.num_parameters],
            options=options)
        self._data = cost.block_data()
        self._jacobian = cost.jacobian_of(cost.make_residual_fn(), 0)

    def cost(self, x):
        return torch.as_tensor(self._functor(x)).reshape(())

    def cost_and_gradient(self, x):
        return self.cost(x), self._jacobian(self._data, (x,))[0]


class GradientProblem:
    """gradient_problem.h:92: a FirstOrderFunction and, optionally, a
    Manifold of its parameters."""

    def __init__(self, function: FirstOrderFunction,
                 manifold: Optional[Manifold] = None):
        self.function = function
        self.manifold = manifold
        if manifold is not None and \
                manifold.ambient_size != function.num_parameters:
            raise ValueError("manifold ambient size mismatch")

    @property
    def num_parameters(self):
        return self.function.num_parameters

    @property
    def num_tangent_parameters(self):
        return (self.manifold.tangent_size if self.manifold
                else self.function.num_parameters)


class _GradientProgram:
    """A GradientProblem with the program surface the line-search
    minimizer reads (gradient_problem_evaluator.h:48): the state on
    `device`, Plus through the manifold, the tangent gradient
    PlusJacobian(x)^T g."""

    def __init__(self, gp: GradientProblem, x0: np.ndarray, device):
        self.gp = gp
        self.device = torch.device(device)
        self._x0 = np.asarray(x0, dtype=np.float64)
        self.num_effective = gp.num_tangent_parameters
        self.has_bounds = False

    def initial_state(self):
        return torch.tensor(self._x0, dtype=torch.float64, device=self.device)

    def plus(self, x, delta):
        if self.gp.manifold is None:
            return x + delta
        return self.gp.manifold.plus(x, delta)

    def cost_and_gradient_fn(self, x):
        c, g = self.gp.function.cost_and_gradient(x)
        c = torch.as_tensor(c, dtype=x.dtype, device=x.device).reshape(())
        if self.gp.manifold is None:
            return c, g
        return c, self.gp.manifold.plus_jacobian(x).T @ g

    def write_back(self, x):
        """The minimizer's own write-backs; solve_gradient_problem writes
        the parameters once the solve is usable."""


def solve_gradient_problem(options: SolverOptions, problem: GradientProblem,
                           parameters: np.ndarray,
                           summary: Optional[SolverSummary] = None
                           ) -> SolverSummary:
    """GradientProblemSolver::Solve (gradient_problem_solver.cc:103) on
    options.device; `parameters` is updated in place."""
    if summary is None:
        summary = SolverSummary()
    t0 = time.time()
    err = options.validate()
    if err is not None:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {err}"
        return summary
    if torch.device(options.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("options.device is CUDA but no CUDA device is "
                           "available")
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.line_search_direction_type = options.line_search_direction_type
    summary.num_parameters = problem.num_parameters
    summary.num_effective_parameters = problem.num_tangent_parameters

    program = _GradientProgram(problem, parameters, options.device)
    x = minimize_line_search(program, options, summary)
    if summary.is_solution_usable():
        parameters[:] = x.cpu().numpy()
    summary.total_time_in_seconds = time.time() - t0
    return summary


class GradientProblemSolver:
    Options = SolverOptions
    Summary = SolverSummary

    def solve(self, options, problem, parameters, summary=None):
        return solve_gradient_problem(options, problem, parameters, summary)
