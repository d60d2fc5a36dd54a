"""Line-search minimizer: steepest descent, nonlinear conjugate gradients
(Fletcher-Reeves, Polak-Ribiere, Hestenes-Stiefel), L-BFGS and BFGS with
Armijo or Wolfe line searches.

Counterpart of ceres_tpu/minimizers/line_search.py (the reference's
LineSearchMinimizer, line_search_minimizer.cc:85; LineSearchDirection,
line_search_direction.cc; LowRankInverseHessian, the two-loop recursion
with Oren's eigenvalue scaling, low_rank_inverse_hessian.cc; the Armijo
and Wolfe searches with polynomial interpolation, line_search.cc:71 and
polynomial.cc). As there, the control flow is host scalars: each probe
of the line search is one cost-and-gradient evaluation and one host read
of (f, f'); the direction updates are O(n) vector arithmetic on the
device (options.device), with no hand kernel (the JAX package runs no
Pallas kernel here either). A least-squares program's cost and gradient
come from its f64 linearize (program.py linearize_fn); a gradient
problem's program (gradient_problem.py) gives them directly.

With fused_iterations=True, where the JAX package runs its
device-resident loop (ceres_tpu/minimizers/line_search_fused.py;
fused_line_search_ok), this loop runs and reports as that loop does: no
per-iteration records, num_iterations_fused, the device loop's messages.
The two take the same steps except in two corners: the device loop
probes once more where the zoom's bracket has shrunk below
min_line_search_step_size, and it runs the search of the iteration that
fails on too many restarts. PyTorch has no device-side loop, so a port
of that loop pays for a fixed run of masked probe slots an iteration
(on an H100 it took 3-19 times the host loop's wall, PERF.md); it
waits for CUDA-graph capture (ROADMAP.md item 48).
"""

from __future__ import annotations

import math
import time

import torch

from ..types import (CallbackReturnType, IterationSummary,
                     LineSearchDirectionType, LineSearchInterpolationType,
                     LineSearchType, NonlinearConjugateGradientType,
                     SolverSummary, TerminationType)


# ----------------------------------------------------------------------
# polynomial interpolation (the reference's polynomial.cc)

def _min_cubic(a_x, a_f, a_g, b_x, b_f, b_g, lo, hi):
    """The minimizer of the cubic through (x, f, f') at two points,
    clamped to [lo, hi]; the midpoint when the cubic degenerates."""
    d1 = a_g + b_g - 3 * (a_f - b_f) / (a_x - b_x)
    disc = d1 * d1 - a_g * b_g
    if disc < 0 or a_x == b_x:
        return 0.5 * (lo + hi)
    d2 = math.copysign(math.sqrt(disc), b_x - a_x)
    denom = b_g - a_g + 2 * d2
    if denom == 0:
        return 0.5 * (lo + hi)
    t = b_x - (b_x - a_x) * (b_g + d2 - d1) / denom
    if not math.isfinite(t):
        return 0.5 * (lo + hi)
    return min(max(t, lo), hi)


def _min_quadratic(a_x, a_f, a_g, b_x, b_f, lo, hi):
    """The minimizer of the quadratic through (a_x, a_f, a_g) and
    (b_x, b_f), clamped to [lo, hi]; the midpoint when it degenerates."""
    denom = 2.0 * (b_f - a_f - a_g * (b_x - a_x))
    if denom <= 0 or a_x == b_x:
        return 0.5 * (lo + hi)
    t = a_x - a_g * (b_x - a_x) ** 2 / denom
    if not math.isfinite(t):
        return 0.5 * (lo + hi)
    return min(max(t, lo), hi)


# ----------------------------------------------------------------------
# quasi-Newton models

class _LBFGS:
    """The two-loop recursion over the last max_rank correction pairs
    (low_rank_inverse_hessian.cc), with Oren's s'y / y'y scaling of the
    initial Hessian when use_eigenvalue_scaling. One host read an update
    (s'y); the recursion stays on the device."""

    def __init__(self, max_rank: int, use_eigenvalue_scaling: bool):
        self.max_rank = max_rank
        self.use_scaling = use_eigenvalue_scaling
        self.reset()

    def update(self, s, y):
        sy = float(torch.dot(s, y))
        if sy <= 1e-14:
            return False
        if len(self.s_list) == self.max_rank:
            self.s_list.pop(0)
            self.y_list.pop(0)
            self.rho_list.pop(0)
        self.s_list.append(s)
        self.y_list.append(y)
        self.rho_list.append(1.0 / sy)
        return True

    def apply(self, g):
        if not self.s_list:
            return g
        S, Y = self.s_list, self.y_list
        q = g
        alphas = []
        for i in range(len(S) - 1, -1, -1):
            a = self.rho_list[i] * torch.dot(S[i], q)
            alphas.append(a)
            q = q - a * Y[i]
        if self.use_scaling:
            q = (torch.dot(S[-1], Y[-1]) / torch.dot(Y[-1], Y[-1])) * q
        for i, a in zip(range(len(S)), reversed(alphas)):
            b = self.rho_list[i] * torch.dot(Y[i], q)
            q = q + (a - b) * S[i]
        return q

    def reset(self):
        self.s_list, self.y_list, self.rho_list = [], [], []


class _BFGS:
    """The dense inverse-Hessian update (line_search_direction.cc BFGS)."""

    def __init__(self, n: int, use_eigenvalue_scaling: bool, device):
        self.n, self.device = n, device
        self.use_scaling = use_eigenvalue_scaling
        self.reset()

    def update(self, s, y):
        sy = float(torch.dot(s, y))
        if sy <= 1e-14:
            return False
        if self.first and self.use_scaling:
            self.H = self.H * (sy / float(torch.dot(y, y)))
        self.first = False
        rho = 1.0 / sy
        eye = torch.eye(self.n, dtype=self.H.dtype, device=self.device)
        V = eye - rho * torch.outer(s, y)
        self.H = V @ self.H @ V.T + rho * torch.outer(s, s)
        return True

    def apply(self, g):
        return self.H @ g

    def reset(self):
        self.H = torch.eye(self.n, dtype=torch.float64, device=self.device)
        self.first = True


# ----------------------------------------------------------------------
# the line searches

def _line_search(phi, phi0: float, dphi0: float, step0: float, options,
                 want_wolfe: bool):
    """Armijo backtracking or the Wolfe bracketing and zoom search
    (line_search.cc ArmijoLineSearch, WolfeLineSearch; Nocedal and Wright
    algorithms 3.5 and 3.6). phi(a) -> (f, f') along the direction, as
    host floats. Returns (step, f, evaluations), or (None, None,
    evaluations) when no step is found."""
    c1 = options.line_search_sufficient_function_decrease
    c2 = options.line_search_sufficient_curvature_decrease
    max_iters = options.max_num_line_search_step_size_iterations
    min_step = options.min_line_search_step_size
    interp = options.line_search_interpolation_type
    max_expand = options.max_line_search_step_expansion
    evals = 0

    def probe(a):
        nonlocal evals
        evals += 1
        return phi(a)

    if not want_wolfe:
        a = step0
        a_prev, f_prev, g_prev = 0.0, phi0, dphi0
        for _ in range(max_iters):
            f, df = probe(a)
            if math.isfinite(f) and f <= phi0 + c1 * a * dphi0:
                return a, f, evals
            lo = a * options.max_line_search_step_contraction
            hi = a * options.min_line_search_step_contraction
            if interp == LineSearchInterpolationType.CUBIC and \
                    math.isfinite(f) and math.isfinite(df):
                a_new = _min_cubic(a_prev, f_prev, g_prev, a, f, df, lo, hi)
            elif interp != LineSearchInterpolationType.BISECTION and \
                    math.isfinite(f):
                a_new = _min_quadratic(0.0, phi0, dphi0, a, f, lo, hi)
            else:
                a_new = 0.5 * (lo + hi)
            a_prev, f_prev, g_prev = a, f, df
            a = a_new
            if a < min_step:
                return None, None, evals
        return None, None, evals

    # Wolfe: the bracketing phase, expanding by max_line_search_step_
    # expansion (line_search.cc:641), then the zoom
    a_prev, f_prev, g_prev = 0.0, phi0, dphi0
    a = step0
    bracket = None
    for _ in range(max_iters):
        f, df = probe(a)
        if (not math.isfinite(f)) or f > phi0 + c1 * a * dphi0 or \
                (a_prev > 0 and f >= f_prev):
            bracket = (a_prev, f_prev, g_prev, a, f, df)
            break
        if abs(df) <= c2 * abs(dphi0):
            return a, f, evals
        if df >= 0:
            bracket = (a, f, df, a_prev, f_prev, g_prev)
            break
        a_prev, f_prev, g_prev = a, f, df
        a = a * max_expand
    if bracket is None:
        # out of expansions: the last point that met the Armijo condition
        if f_prev <= phi0 + c1 * a_prev * dphi0 and a_prev > 0:
            return a_prev, f_prev, evals
        return None, None, evals

    lo_x, lo_f, lo_g, hi_x, hi_f, hi_g = bracket
    for _ in range(max_iters):
        if abs(hi_x - lo_x) < min_step:
            break
        mid_lo, mid_hi = min(lo_x, hi_x), max(lo_x, hi_x)
        width = mid_hi - mid_lo
        a = _min_cubic(lo_x, lo_f, lo_g, hi_x, hi_f,
                       hi_g if math.isfinite(hi_g) else 0.0,
                       mid_lo + 0.1 * width, mid_hi - 0.1 * width) \
            if interp == LineSearchInterpolationType.CUBIC else \
            0.5 * (lo_x + hi_x)
        f, df = probe(a)
        if (not math.isfinite(f)) or f > phi0 + c1 * a * dphi0 or f >= lo_f:
            hi_x, hi_f, hi_g = a, f, df
        else:
            if abs(df) <= c2 * abs(dphi0):
                return a, f, evals
            if df * (hi_x - lo_x) >= 0:
                hi_x, hi_f, hi_g = lo_x, lo_f, lo_g
            lo_x, lo_f, lo_g = a, f, df
    if lo_x > 0 and lo_f < phi0:
        return lo_x, lo_f, evals
    return None, None, evals


def _log_line(it: IterationSummary):
    """One line of minimizer_progress_to_stdout, in the reference's
    line-search format (line_search_minimizer.cc)."""
    print(f"{it.iteration:4d}: f:{it.cost: 8e} d:{it.cost_change: 3.2e} "
          f"g:{it.gradient_max_norm: 3.2e} h:{it.step_norm: 3.2e} "
          f"s:{it.step_size: 3.2e} "
          f"e:{it.line_search_function_evaluations: 3d} "
          f"it:{it.iteration_time_in_seconds: 3.2e} "
          f"tt:{it.cumulative_time_in_seconds: 3.2e}", flush=True)


def _cost_and_gradient_fn(program):
    """x -> (f64 cost, gradient) of the program: a gradient problem's own,
    else the least-squares linearize's cost and J^T r."""
    if hasattr(program, "cost_and_gradient_fn"):
        return program.cost_and_gradient_fn

    def cost_and_grad(x):
        c, g, _, _ = program.linearize_fn(x)
        return c, g
    return cost_and_grad


def fused_line_search_ok(program, options) -> bool:
    """The configurations the JAX package's device-resident loop serves
    (ceres_tpu line_search_fused.py:495-503); the rest need the host."""
    return (not options.callbacks
            and not options.minimizer_progress_to_stdout
            and options.evaluation_callback is None
            and not options.update_state_every_iteration
            and options.max_solver_time_in_seconds >= 1e9
            and not getattr(program, "has_bounds", False))


# the host loop's messages that the device loop words otherwise
# (ceres_tpu line_search_fused.py _MESSAGES), by their first words
_FUSED_MESSAGES = (
    ("Gradient tolerance reached", "Gradient tolerance reached."),
    ("Line search failed", "Line search failed to find a valid step."))


def _report_as_fused(summary: SolverSummary):
    """The summary as the JAX package's run_fused_line_search fills it
    (:506-531): no per-iteration records; num_iterations_fused counts the
    successful iterations and the one that failed, if any."""
    summary.num_iterations_fused = summary.num_successful_steps + int(
        summary.termination_type == TerminationType.FAILURE)
    summary.iterations = []
    for prefix, message in _FUSED_MESSAGES:
        if summary.message.startswith(prefix):
            summary.message = message


def minimize_line_search(program, options, summary: SolverSummary, x0=None):
    """The outer loop (line_search_minimizer.cc:85) from x0 (the program's
    initial state unless given): fills the summary (iteration 0 and one
    IterationSummary an iteration) and returns the final x. With
    fused_iterations=True, where the JAX package runs its device loop
    (ceres_tpu line_search.py:257-263), the summary is reported as that
    loop's (_report_as_fused)."""
    x = _minimize(program, options, summary, x0)
    if options.fused_iterations and x0 is None and \
            fused_line_search_ok(program, options):
        _report_as_fused(summary)
    return x


def _minimize(program, options, summary: SolverSummary, x0):
    t_start = time.time()
    cost_and_grad = _cost_and_gradient_fn(program)
    x = program.initial_state() if x0 is None else x0
    dir_type = options.line_search_direction_type
    log = options.minimizer_progress_to_stdout

    if dir_type == LineSearchDirectionType.LBFGS:
        model = _LBFGS(options.max_lbfgs_rank,
                       options.use_approximate_eigenvalue_bfgs_scaling)
    elif dir_type == LineSearchDirectionType.BFGS:
        model = _BFGS(program.num_effective,
                      options.use_approximate_eigenvalue_bfgs_scaling,
                      x.device)
    else:
        model = None

    def evaluate(xa):
        """(cost, gradient, [cost, |g|_inf, |g|^2] on the host)."""
        c, g = cost_and_grad(xa)
        host = torch.stack([c.reshape(()).to(g.dtype), g.abs().max(),
                            torch.dot(g, g)]).tolist()
        return c, g, host

    _, grad, (cost, grad_max, grad_norm_sq) = evaluate(x)
    summary.num_residual_evaluations += 1
    summary.num_jacobian_evaluations += 1
    summary.initial_cost = cost
    it0 = IterationSummary(iteration=0, cost=cost,
                           gradient_max_norm=grad_max,
                           gradient_norm=math.sqrt(grad_norm_sq),
                           cumulative_time_in_seconds=time.time() - t_start)
    summary.iterations.append(it0)
    if log:
        _log_line(it0)

    if grad_max <= options.gradient_tolerance:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Gradient tolerance reached (initial point)."
        summary.final_cost = cost
        program.write_back(x)
        return x

    direction = -grad
    num_restarts = 0
    iteration = 0
    prev_cost = cost
    want_wolfe = options.line_search_type == LineSearchType.WOLFE

    while True:
        iteration += 1
        it_t0 = time.time()
        if iteration > options.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."
            break
        if time.time() - t_start > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            break

        dphi0 = float(torch.dot(grad, direction))
        if dphi0 >= 0:
            # not a descent direction: restart from steepest descent
            num_restarts += 1
            if num_restarts > options.max_num_line_search_direction_restarts:
                summary.termination_type = TerminationType.FAILURE
                summary.message = ("Line search direction failure: too many "
                                   "restarts.")
                break
            if model is not None:
                model.reset()
            direction = -grad
            dphi0 = -grad_norm_sq

        # the initial step size (line_search_minimizer.cc:200-230)
        if iteration == 1:
            step0 = min(1.0, 1.0 / math.sqrt(max(grad_max, 1e-300)))
        elif dir_type in (LineSearchDirectionType.STEEPEST_DESCENT,
                          LineSearchDirectionType
                          .NONLINEAR_CONJUGATE_GRADIENT):
            step0 = min(1.0, 2.0 * (cost - prev_cost) / dphi0) \
                if dphi0 != 0 and cost != prev_cost else 1.0
            if step0 <= 0 or not math.isfinite(step0):
                step0 = 1.0
        else:
            step0 = 1.0

        def phi(a, x=x, direction=direction):
            c, g = cost_and_grad(program.plus(x, a * direction))
            f, df = torch.stack([c.reshape(()).to(g.dtype),
                                 torch.dot(g, direction)]).tolist()
            return f, df

        t_ls = time.time()
        step, _, evals = _line_search(phi, cost, dphi0, step0, options,
                                      want_wolfe)
        # each probe is one cost-and-gradient evaluation: its time goes to
        # the cost evaluations, as in the JAX package
        summary.line_search_total_time_in_seconds += time.time() - t_ls
        summary.line_search_cost_evaluation_time_in_seconds += \
            time.time() - t_ls
        summary.num_line_search_steps += evals
        summary.num_residual_evaluations += evals
        summary.num_jacobian_evaluations += evals
        if step is None:
            summary.termination_type = TerminationType.FAILURE
            summary.message = ("Line search failed to find a valid step "
                               f"at iteration {iteration}.")
            break

        delta = step * direction
        x_new = program.plus(x, delta)
        _, new_grad, (new_cost, new_grad_max, new_grad_norm_sq) = \
            evaluate(x_new)
        summary.num_residual_evaluations += 1
        summary.num_jacobian_evaluations += 1
        x_norm = (program.state_norm(x_new) if hasattr(program, "state_norm")
                  else torch.linalg.vector_norm(x_new))
        step_norm, x_norm = torch.stack([torch.linalg.vector_norm(delta),
                                         x_norm]).tolist()
        cost_change = cost - new_cost

        if dir_type == LineSearchDirectionType.STEEPEST_DESCENT:
            new_direction = -new_grad
        elif dir_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
            kind = options.nonlinear_conjugate_gradient_type
            if kind == NonlinearConjugateGradientType.FLETCHER_REEVES:
                beta = new_grad_norm_sq / grad_norm_sq
            elif kind == NonlinearConjugateGradientType.POLAK_RIBIERE:
                beta = max(float(torch.dot(new_grad, new_grad - grad))
                           / grad_norm_sq, 0.0)
            else:                                   # HESTENES_STIEFEL
                dy = new_grad - grad
                denom = float(torch.dot(direction, dy))
                beta = (float(torch.dot(new_grad, dy)) / denom
                        if denom != 0 else 0.0)
            new_direction = -new_grad + beta * direction
        else:                                       # LBFGS, BFGS
            model.update(delta, new_grad - grad)
            new_direction = -model.apply(new_grad)

        prev_cost = cost
        x, cost, grad = x_new, new_cost, new_grad
        grad_norm_sq, grad_max = new_grad_norm_sq, new_grad_max
        direction = new_direction
        summary.num_successful_steps += 1

        it = IterationSummary(
            iteration=iteration, cost=cost, cost_change=cost_change,
            gradient_max_norm=grad_max, gradient_norm=math.sqrt(grad_norm_sq),
            step_norm=step_norm, step_size=step,
            line_search_function_evaluations=evals,
            step_is_valid=True, step_is_successful=True,
            iteration_time_in_seconds=time.time() - it_t0,
            cumulative_time_in_seconds=time.time() - t_start)
        summary.iterations.append(it)
        if log:
            _log_line(it)

        for cb in options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                summary.termination_type = TerminationType.USER_FAILURE
                summary.message = "Terminated by callback (abort)."
                summary.final_cost = cost
                return x
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                summary.termination_type = TerminationType.USER_SUCCESS
                summary.message = "Terminated by callback."
                summary.final_cost = cost
                program.write_back(x)
                return x

        if grad_max <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached: {grad_max:e} <= "
                f"{options.gradient_tolerance:e}")
            break
        if abs(cost_change) <= options.function_tolerance * abs(prev_cost):
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Function tolerance reached."
            break
        if step_norm <= options.parameter_tolerance * (
                x_norm + options.parameter_tolerance):
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Parameter tolerance reached."
            break

    summary.final_cost = cost
    summary.minimizer_time_in_seconds = time.time() - t_start
    return x
