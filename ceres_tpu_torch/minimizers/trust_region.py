"""Trust-region minimizer with a host loop: LM or dogleg, per-iteration
summaries, callbacks, nonmonotonic steps and bounds.

Counterpart of ceres_tpu/minimizers/trust_region.py (the reference's
TrustRegionMinimizer, trust_region_minimizer.cc:66-135;
LevenbergMarquardtStrategy, levenberg_marquardt_strategy.cc:68; the
dogleg radius rules of dogleg_strategy.cc; TrustRegionStepEvaluator,
trust_region_step_evaluator.h:78). The loop runs in Python; the step is
any step of the port's protocol (`initial_scales()`, `linearize(x,
*scales, first, known_cost)`, `solve(art, radius)`, `cost(x)`;
minimizers/fused.py), so the Schur steps and the generic steps serve both
loops. As the fused loop, it relinearizes only after an accepted step: a
rejected trial re-solves from the kept linearization (the JAX loop
relinearizes at the same x; the trajectory is the same). Per iteration
the loop reads the step's scalars, the candidate's cost and its norm in
one host read; with bounds the projected gradient norm joins that read,
and the projected line search reads each probe's cost.

The termination tests, their order and the messages are the JAX
package's. With use_inner_iterations each valid candidate is refined by
one pass of block coordinate descent (minimizers/coordinate_descent.py;
ceres_tpu trust_region.py:475-489, trust_region_minimizer.cc:506
DoInnerIterationsIfNeeded), kept only where it lowers the cost. The
trust-region problem dumps (solver.h:706-734; ceres_tpu
trust_region.py:205-225, :375-400) write, for each iteration that
trust_region_minimizer_iterations_to_dump names (every one when it is
empty), the f64 dense Jacobian at x, the residuals, the gradient, x, the
step and the radius: one `ceres_tpu_iteration_NNN.npz` in
trust_region_problem_dump_directory (TEXTFILE), or one line of their
norms on stdout (CONSOLE). SPSE initialization is the generic Schur
step's (solvers/schur.py SchurLinearSolver).
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..types import (CallbackReturnType, DumpFormatType, IterationSummary,
                     SolverSummary, TerminationType, TrustRegionStrategyType)
from .coordinate_descent import make_inner_iteration_fn


class TrustRegionStepEvaluator:
    """Nonmonotonic step acceptance (trust_region_step_evaluator.h:78);
    with max_consecutive_nonmonotonic_steps = 0 it is monotone."""

    def __init__(self, initial_cost: float,
                 max_consecutive_nonmonotonic_steps: int):
        self.max_consecutive_nonmonotonic_steps = (
            max_consecutive_nonmonotonic_steps)
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (
            (self.reference_cost - cost)
            / (self.accumulated_reference_model_cost_change
               + model_cost_change))
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float):
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if (self.num_consecutive_nonmonotonic_steps
                == self.max_consecutive_nonmonotonic_steps):
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change)


class LevenbergMarquardtStrategy:
    """Radius bookkeeping (levenberg_marquardt_strategy.cc:68)."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.decrease_factor = 2.0

    def step_accepted(self, step_quality: float):
        self.radius = self.radius / max(
            1.0 / 3.0, 1.0 - (2.0 * step_quality - 1.0) ** 3)
        self.radius = min(self.max_radius, self.radius)
        self.decrease_factor = 2.0

    def step_rejected(self):
        self.radius = self.radius / self.decrease_factor
        self.decrease_factor *= 2.0


class DoglegRadiusStrategy:
    """Dogleg radius bookkeeping (dogleg_strategy.cc): halve on rejection,
    triple on a step of quality above 0.75."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius

    def step_accepted(self, step_quality: float):
        if step_quality > 0.75:
            self.radius = min(self.max_radius, 3.0 * self.radius)

    def step_rejected(self):
        self.radius *= 0.5


def make_projected_line_search_fn(program, options):
    """Projected Armijo line search along the trust-region step
    (trust_region_minimizer.cc:101-106, DoLineSearch :587; ceres_tpu
    trust_region.py:114-162): phi(s) = cost(Plus(x, s delta)), Plus
    projecting onto the bound box; backtracking by quadratic
    interpolation clipped to [max_contraction s, min_contraction s].
    One host read a probe. Returns (x_new, new_cost, s_used, n_evals,
    state_norm(x_new)), the costs and norm as floats; on failure the full
    step is kept."""
    suff = options.line_search_sufficient_function_decrease
    max_iters = options.max_num_line_search_step_size_iterations
    min_step = options.min_line_search_step_size
    max_contract = options.max_line_search_step_contraction
    min_contract = options.min_line_search_step_contraction

    def ls(x, delta, cost0: float, gradient):
        dphi0 = float(torch.dot(gradient, delta))
        s, it, success = 1.0, 0, False
        while it < max_iters:
            f_s = float(program.cost_fn(program.plus(x, s * delta)))
            it += 1
            if f_s <= cost0 + suff * s * dphi0:
                success = True
                break
            denom = 2.0 * (f_s - cost0 - dphi0 * s)
            s_quad = -dphi0 * s * s / denom if denom > 0.0 else 0.5 * s
            s = min(max(s_quad, max_contract * s), min_contract * s)
            if s < min_step:
                break
        s_used = s if success else 1.0
        x_new = program.plus(x, s_used * delta)
        new_cost, x_norm = torch.stack([
            program.cost_fn(x_new), program.state_norm(x_new)]).tolist()
        return x_new, new_cost, s_used, it, x_norm

    return ls


def _log_line(it: IterationSummary):
    """One line of minimizer_progress_to_stdout (the JAX loop's format)."""
    if it.iteration == 0:
        print("iter      cost      cost_change  |gradient|   |step|  "
              "  tr_ratio  tr_radius  ls_iter  iter_time  total_time")
    print(f"{it.iteration:4d} {it.cost: 8.6e} "
          f"{it.cost_change: 8.2e} {it.gradient_max_norm:8.2e} "
          f"{it.step_norm:8.2e} {it.relative_decrease: 8.2e} "
          f"{it.trust_region_radius:8.2e} "
          f"{it.linear_solver_iterations:7d} "
          f"{it.iteration_time_in_seconds:9.2e} "
          f"{it.cumulative_time_in_seconds:10.2e}")


def make_dump_fn(program, options):
    """dump(iteration, x, delta, radius) of the trust-region problem
    dumps, or None when no dump is asked for (ceres_tpu
    trust_region.py:205-225, :375-400)."""
    dump_dir = options.trust_region_problem_dump_directory
    console = (options.trust_region_problem_dump_format_type
               == DumpFormatType.CONSOLE)
    if not dump_dir and not console:
        return None
    if dump_dir and not console:
        os.makedirs(dump_dir, exist_ok=True)
    which = options.trust_region_minimizer_iterations_to_dump

    def dump(iteration, x, delta, radius):
        if which and iteration not in which:
            return
        _, grad, jac, res = program.linearize_fn(x)
        J = jac.to_dense().cpu().numpy()
        r = res.flatten().cpu().numpy()
        g = grad.cpu().numpy()
        if console:
            print(f"ceres_tpu iteration {iteration}: J {J.shape} "
                  f"|J|_F={np.linalg.norm(J):.6e} "
                  f"|r|={np.linalg.norm(r):.6e} "
                  f"|g|={np.linalg.norm(g):.6e} "
                  f"radius={radius:.6e}")
        else:
            np.savez(os.path.join(dump_dir,
                                  f"ceres_tpu_iteration_{iteration:03d}.npz"),
                     J=J, residuals=r, gradient=g, x=x.cpu().numpy(),
                     delta=delta.cpu().numpy(), radius=radius)

    return dump


def minimize_trust_region(program, options, step, summary: SolverSummary,
                          x0=None):
    """Run the trust-region loop with `step` from x0 (the program's
    initial state unless given); fills the summary (iteration 0 and one
    IterationSummary per iteration, the counts and times) and returns the
    final x."""
    t_start = time.time()
    x = program.initial_state() if x0 is None else x0
    strategy = (LevenbergMarquardtStrategy(options)
                if options.trust_region_strategy_type
                == TrustRegionStrategyType.LEVENBERG_MARQUARDT
                else DoglegRadiusStrategy(options))
    eval_cb = options.evaluation_callback
    bounds = program.has_bounds
    proj_ls = (make_projected_line_search_fn(program, options)
               if bounds and options.max_num_line_search_step_size_iterations
               > 0 else None)
    inner = (make_inner_iteration_fn(program, options)
             if options.use_inner_iterations else None)
    dump = make_dump_fn(program, options)
    total_cost_time = total_jacobian_time = total_solver_time = 0.0

    def finish(xx, cost):
        summary.final_cost = cost
        summary.linear_solver_time_in_seconds = total_solver_time
        summary.residual_evaluation_time_in_seconds = total_cost_time
        summary.jacobian_evaluation_time_in_seconds = total_jacobian_time
        summary.minimizer_time_in_seconds = time.time() - t_start
        return xx

    def record(it: IterationSummary, it_start: float):
        it.iteration_time_in_seconds = time.time() - it_start
        it.cumulative_time_in_seconds = time.time() - t_start
        summary.iterations.append(it)
        if options.minimizer_progress_to_stdout:
            _log_line(it)

    def run_callbacks(it: IterationSummary) -> Optional[TerminationType]:
        for cb in options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                summary.message = "Terminated by callback (abort)."
                return TerminationType.USER_FAILURE
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                summary.message = "Terminated by callback."
                return TerminationType.USER_SUCCESS
        return None

    # iteration 0: the cost at the start (IterationZero)
    t0 = time.time()
    if eval_cb is not None:
        eval_cb.prepare_for_evaluation(evaluate_jacobians=False,
                                       new_evaluation_point=True)
    cost_t = step.cost(x)
    cost, x_norm = torch.stack([cost_t.to(torch.float64),
                                program.state_norm(x)]).tolist()
    total_cost_time += time.time() - t0
    summary.num_residual_evaluations += 1
    if not math.isfinite(cost):
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Initial cost is not finite."
        return finish(x, cost)
    summary.initial_cost = cost
    step_evaluator = TrustRegionStepEvaluator(
        cost, options.max_consecutive_nonmonotonic_steps
        if options.use_nonmonotonic_steps else 0)
    record(IterationSummary(iteration=0, cost=cost, step_is_valid=True,
                            step_is_successful=True,
                            trust_region_radius=strategy.radius), t_start)
    term = run_callbacks(summary.iterations[0])
    if term is not None:
        summary.termination_type = term
        return finish(x, cost)

    scales = step.initial_scales()
    art = None
    first = True
    num_consecutive_invalid_steps = 0
    iteration = 0
    while True:
        iteration += 1
        it_start = time.time()
        if iteration > options.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."
            break
        if time.time() - t_start > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            break

        # linearize (after an accepted step only) and solve the
        # trust-region subproblem
        t0 = time.time()
        if art is None:
            if eval_cb is not None:
                eval_cb.prepare_for_evaluation(evaluate_jacobians=True,
                                               new_evaluation_point=True)
            art = step.linearize(x, *scales, first=first, known_cost=cost_t)
            scales = art.scales
            first = False
            summary.num_jacobian_evaluations += 1
            summary.num_residual_evaluations += 1
            total_jacobian_time += time.time() - t0
        t1 = time.time()
        out = step.solve(art, float(strategy.radius))
        # with bounds, the projected gradient's max norm
        # ||Plus(x, -g) - x||_inf (trust_region_minimizer.cc:101)
        grad_max_t = (torch.max(torch.abs(
            program.plus(x, -out["gradient_full"]) - x)) if bounds
            else out["gradient_max_norm"])
        # the candidate, evaluated before the host read so that one read
        # serves the iteration (the projected line search evaluates its
        # own)
        if proj_ls is None:
            if eval_cb is not None:
                eval_cb.prepare_for_evaluation(evaluate_jacobians=False,
                                               new_evaluation_point=True)
            x_new = program.plus(x, out["delta"])
            cand = [step.cost(x_new).to(torch.float64),
                    program.state_norm(x_new)]
        else:
            cand = []
        host = torch.stack([
            out["model_cost_change"].to(torch.float64),
            out["step_norm"].to(torch.float64),
            grad_max_t.to(torch.float64),
            out["gradient_norm"].to(torch.float64),
            out["lin_iters"].to(torch.float64)] + cand).tolist()
        mcc, step_norm, grad_max, grad_norm, lin_iters = host[:5]
        lin_iters = int(lin_iters)
        t_solve = time.time() - t1
        total_solver_time += t_solve
        summary.num_linear_solves += 1
        summary.num_linear_solver_iterations += lin_iters

        it = IterationSummary(
            iteration=iteration, cost=cost, gradient_max_norm=grad_max,
            gradient_norm=grad_norm, trust_region_radius=strategy.radius,
            linear_solver_iterations=lin_iters,
            step_solver_time_in_seconds=t_solve)
        if dump is not None:
            dump(iteration, x, out["delta"], strategy.radius)

        # gradient convergence, on the fresh linearization
        if grad_max <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm: "
                f"{grad_max:e} <= {options.gradient_tolerance:e}")
            break

        step_is_valid = (math.isfinite(mcc) and mcc > 0.0
                         and math.isfinite(step_norm))
        if step_is_valid:
            num_consecutive_invalid_steps = 0
        else:
            # HandleInvalidStep (trust_region_minimizer.cc:464)
            if (math.isfinite(mcc)
                    and abs(mcc) <= options.function_tolerance * cost):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    "Function tolerance reached. Model cost change "
                    f"{mcc:e} is negligible relative to the cost.")
                break
            num_consecutive_invalid_steps += 1
            if (num_consecutive_invalid_steps
                    >= options.max_num_consecutive_invalid_steps):
                summary.termination_type = TerminationType.FAILURE
                summary.message = (
                    f"Number of consecutive invalid steps more than "
                    f"{options.max_num_consecutive_invalid_steps}")
                break
            strategy.step_rejected()
            if strategy.radius < options.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Minimum trust region radius reached."
                break
            it.step_is_valid = False
            it.step_is_successful = False
            summary.num_unsuccessful_steps += 1
            record(it, it_start)
            continue

        # the candidate
        t0 = time.time()
        if proj_ls is not None:
            if eval_cb is not None:
                eval_cb.prepare_for_evaluation(evaluate_jacobians=False,
                                               new_evaluation_point=True)
            x_new, new_cost, s_used, n_evals, new_x_norm = proj_ls(
                x, out["delta"], cost, out["gradient_full"])
            new_cost_t = None
            it.step_size = s_used
            it.line_search_function_evaluations = n_evals + 1
            step_norm = step_norm * s_used
            summary.num_residual_evaluations += n_evals + 1
        else:
            new_cost, new_x_norm = host[5], host[6]
            new_cost_t = cand[0]
            summary.num_residual_evaluations += 1
        if inner is not None and math.isfinite(new_cost):
            # refine the candidate; keep the refined x only if its cost
            # is lower (ceres_tpu trust_region.py:475-489)
            t_in = time.time()
            x_ref = inner(x_new)
            ref_cost_t = step.cost(x_ref).to(torch.float64)
            ref_cost, ref_norm = torch.stack(
                [ref_cost_t, program.state_norm(x_ref)]).tolist()
            summary.num_residual_evaluations += 1
            if math.isfinite(ref_cost) and ref_cost < new_cost:
                x_new, new_cost, new_x_norm = x_ref, ref_cost, ref_norm
                new_cost_t = ref_cost_t
            summary.num_inner_iteration_steps += 1
            summary.inner_iteration_time_in_seconds += time.time() - t_in
        total_cost_time += time.time() - t0

        relative_decrease = (step_evaluator.step_quality(new_cost, mcc)
                             if math.isfinite(new_cost) else -1.0)
        it.step_norm = step_norm
        it.relative_decrease = relative_decrease
        it.cost_change = cost - new_cost
        it.step_is_valid = True

        # tolerances on the candidate, before accepting or rejecting it
        # (trust_region_minimizer.cc:110-116)
        if math.isfinite(new_cost):
            if (summary.num_successful_steps > 0
                    and step_norm <= options.parameter_tolerance
                    * (x_norm + options.parameter_tolerance)):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                record(it, it_start)
                break
            would_accept = relative_decrease > options.min_relative_decrease
            if (abs(cost - new_cost) <= options.function_tolerance * cost
                    and (would_accept
                         or abs(mcc) <= options.function_tolerance * cost)):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost - new_cost) / max(cost, 1e-300):e} <= "
                    f"{options.function_tolerance:e}")
                if new_cost < cost:     # keep an improving candidate
                    x, cost = x_new, new_cost
                    it.cost = cost
                    it.step_is_successful = True
                    summary.num_successful_steps += 1
                record(it, it_start)
                break

        if relative_decrease > options.min_relative_decrease:
            it.step_is_successful = True
            it.step_is_nonmonotonic = new_cost > step_evaluator.minimum_cost
            strategy.step_accepted(relative_decrease)
            step_evaluator.step_accepted(new_cost, mcc)
            summary.num_successful_steps += 1
            cost_change = cost - new_cost
            prev_cost = cost
            x, cost, x_norm = x_new, new_cost, new_x_norm
            cost_t = (new_cost_t if new_cost_t is not None
                      else torch.tensor(new_cost, dtype=torch.float64,
                                        device=x.device))
            art = None                  # relinearize at the new x
            it.cost = cost
            if options.update_state_every_iteration:
                # solver.h:785: callbacks see the current state
                program.write_back(x)
            if abs(cost_change) <= options.function_tolerance * prev_cost:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost_change) / max(prev_cost, 1e-300):e} <= "
                    f"{options.function_tolerance:e}")
                record(it, it_start)
                break
            if step_norm <= options.parameter_tolerance * (
                    x_norm + options.parameter_tolerance):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                record(it, it_start)
                break
        else:
            it.step_is_successful = False
            strategy.step_rejected()
            summary.num_unsuccessful_steps += 1
            if strategy.radius < options.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Minimum trust region radius reached."
                record(it, it_start)
                break

        it.trust_region_radius = strategy.radius
        record(it, it_start)
        term = run_callbacks(it)
        if term is not None:
            summary.termination_type = term
            break

    return finish(x, cost)
