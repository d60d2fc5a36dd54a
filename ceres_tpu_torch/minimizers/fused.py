"""Fused Levenberg-Marquardt loop over device tensors.

Counterpart of ceres_tpu/minimizers/fused.py (make_fused_tr_solve,
run_fused). The JAX package runs the loop as one lax.while_loop; here it
is a Python loop whose tensors stay on the device, with one host read of
the step's scalars per iteration (the linear solver's iteration count
among them; the CGNR step's CG loop reads one more flag per CG
iteration). The acceptance test, the radius update (LM, or the dogleg
rules: x3 on a step of quality above 0.75, /2 on a rejection) and the
termination codes (in the same priority order, :206-227) are the JAX
package's:

  0 running, 1 gradient tol, 2 function tol, 3 parameter tol,
  4 min trust-region radius, 5 max iterations, 6 too many invalid steps.

The loop relinearizes only after an accepted step; a rejected step reuses
the linearization and re-solves at the smaller radius (the reference's
reuse_diagonal_). The JAX package relinearizes at the unchanged x instead;
the trajectory is the same either way.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..types import TerminationType, TrustRegionStrategyType

TERMINATION_BY_CODE = {
    1: (TerminationType.CONVERGENCE, "Gradient tolerance reached."),
    2: (TerminationType.CONVERGENCE, "Function tolerance reached."),
    3: (TerminationType.CONVERGENCE, "Parameter tolerance reached."),
    4: (TerminationType.CONVERGENCE, "Minimum trust region radius reached."),
    5: (TerminationType.NO_CONVERGENCE,
        "Maximum number of iterations reached."),
    6: (TerminationType.FAILURE,
        "Number of consecutive invalid steps exceeded the maximum."),
}


class FusedResult(NamedTuple):
    x: torch.Tensor
    cost: float
    initial_cost: float
    iterations: int
    successful_steps: int
    unsuccessful_steps: int
    termination_code: int
    gradient_max_norm: float
    total_linear_iterations: int
    linearizations: int


def fused_tr_solve(program, options, step, x0) -> FusedResult:
    """Run the LM loop from x0 with `step`: a FusedSchurStep, an
    ImplicitSchurStep, a GenericLMStep or a DoglegStep (solver.py),
    anything with `initial_scales()` (a tuple of scales),
    `linearize(x, *scales, first, known_cost)` (an artifact with
    `.scales`), `solve(art, radius)` (the step's output dict) and
    `cost(x)`."""
    f64 = np.float64
    gtol, ftol = options.gradient_tolerance, options.function_tolerance
    ptol = options.parameter_tolerance
    min_rel_decrease = options.min_relative_decrease
    max_iters = options.max_num_iterations
    min_radius = options.min_trust_region_radius
    max_radius = options.max_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    lm = (options.trust_region_strategy_type
          == TrustRegionStrategyType.LEVENBERG_MARQUARDT)

    cost0 = step.cost(x0)
    x, cost_t = x0, cost0
    radius = f64(options.initial_trust_region_radius)
    decrease_factor = f64(2.0)
    it = invalid = ok_steps = bad_steps = lin_iters = lins = 0
    code = 0 if max_iters > 0 else 5
    grad_max = f64(np.inf)
    scales = step.initial_scales()
    art = None
    relin = True
    while code == 0:
        if relin:
            art = step.linearize(x, *scales, first=(it == 0),
                                 known_cost=cost_t)
            scales = art.scales
            lins += 1
        out = step.solve(art, float(radius))
        x_new = program.plus(x, out["delta"])
        new_cost_t = step.cost(x_new)
        # one host read for the iteration's scalars
        (cost, grad_max, mcc, step_norm, new_cost, x_norm,
         step_lin_iters) = torch.stack([
             out["cost"], out["gradient_max_norm"], out["model_cost_change"],
             out["step_norm"], new_cost_t, program.state_norm(x),
             out["lin_iters"].double()]).cpu().numpy()
        with np.errstate(all="ignore"):
            step_valid = bool(np.isfinite(mcc) and mcc > 0.0
                              and np.isfinite(step_norm))
            rel_dec = (cost - new_cost) / (mcc if mcc != 0 else f64(1.0))
            accept = (step_valid and bool(np.isfinite(new_cost))
                      and bool(rel_dec > min_rel_decrease))
            if not lm:
                if accept and rel_dec > 0.75:
                    radius = np.minimum(3.0 * radius, f64(max_radius))
                elif not accept:
                    radius = 0.5 * radius
            elif accept:
                grow = radius / np.maximum(
                    f64(1.0 / 3.0), 1.0 - (2.0 * rel_dec - 1.0) ** 3)
                radius = np.minimum(grow, f64(max_radius))
                decrease_factor = f64(2.0)
            else:
                radius = radius / decrease_factor
                decrease_factor = 2.0 * decrease_factor
        invalid = 0 if step_valid else invalid + 1
        it += 1
        candidate_ok = step_valid and bool(np.isfinite(new_cost))
        had_success = ok_steps > 0 or accept

        # tolerances are tested on the candidate, before accept/reject
        # (trust_region_minimizer.cc:110-116)
        if grad_max <= gtol:
            code = 1
        elif (candidate_ok and abs(cost - new_cost) <= ftol * cost
              and (accept or abs(mcc) <= ftol * cost)):
            code = 2
        elif (not step_valid and np.isfinite(mcc)
              and abs(mcc) <= ftol * cost):
            code = 2        # negligible model change: converged
        elif (candidate_ok and had_success
              and step_norm <= ptol * (x_norm + ptol)):
            code = 3
        elif radius < min_radius:
            code = 4
        elif it >= max_iters:
            code = 5
        elif invalid >= max_invalid:
            code = 6

        # keep the candidate when accepted, or when stopping on function
        # tolerance with an improving candidate
        take = accept or (code == 2 and candidate_ok and new_cost < cost)
        if take:
            x, cost_t = x_new, new_cost_t
        ok_steps += int(accept)
        bad_steps += int(not accept)
        lin_iters += int(step_lin_iters)
        relin = accept
    return FusedResult(x=x, cost=float(cost_t), initial_cost=float(cost0),
                       iterations=it, successful_steps=ok_steps,
                       unsuccessful_steps=bad_steps, termination_code=code,
                       gradient_max_norm=float(grad_max),
                       total_linear_iterations=lin_iters,
                       linearizations=lins)


def run_fused(program, options, summary, step):
    """Run the fused solve and fill the summary. Returns the final x."""
    t0 = time.time()
    result = fused_tr_solve(program, options, step, program.initial_state())
    summary.minimizer_time_in_seconds = time.time() - t0
    summary.initial_cost = result.initial_cost
    summary.final_cost = result.cost
    summary.num_successful_steps = result.successful_steps
    summary.num_unsuccessful_steps = result.unsuccessful_steps
    summary.num_linear_solves = result.iterations
    summary.num_linear_solver_iterations = result.total_linear_iterations
    summary.num_iterations_fused = result.iterations
    summary.num_linearizations_fused = result.linearizations
    summary.num_jacobian_evaluations = result.successful_steps + 1
    summary.num_residual_evaluations = result.iterations + 1
    term, msg = TERMINATION_BY_CODE.get(
        result.termination_code,
        (TerminationType.FAILURE, f"unknown code {result.termination_code}"))
    summary.termination_type = term
    summary.message = msg + " (fused mode: per-iteration summaries disabled)"
    return result.x
