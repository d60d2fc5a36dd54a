"""Solver::Solve for the ported slice.

Counterpart of the main-path part of ceres_tpu/solver.py (solve, :444;
the fused-Schur dispatch of make_step_impl, :154): validate, build the
program on `options.device`, detect the Schur structure, run the fused LM
loop with the DENSE_SCHUR or ITERATIVE_SCHUR step, write back.
Configurations outside the slices raise NotImplementedError naming the
ROADMAP.md item that ports them; none runs another path quietly.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .minimizers.fused import run_fused
from .program import CompiledProgram
from .solvers.schur import detect_schur_structure
from .solvers.schur_fused import FusedSchurStep
from .types import (DumpFormatType, MinimizerType, SolverOptions,
                    SolverSummary, TerminationType, TrustRegionStrategyType)


def _check_slice(options):
    """Raise NotImplementedError for an option outside the slice."""
    if options.minimizer_type != MinimizerType.TRUST_REGION:
        raise NotImplementedError(
            "line search is not ported yet (ROADMAP.md item 25, "
            "minimizers/line_search.py)")
    if (options.trust_region_strategy_type
            != TrustRegionStrategyType.LEVENBERG_MARQUARDT):
        raise NotImplementedError(
            "dogleg is not ported yet (ROADMAP.md item 14, the host-loop "
            "trust-region minimizer)")
    host_loop = (not options.fused_iterations or options.callbacks
                 or options.use_nonmonotonic_steps
                 or options.minimizer_progress_to_stdout
                 or options.use_inner_iterations
                 or options.trust_region_problem_dump_directory
                 or options.trust_region_problem_dump_format_type
                 == DumpFormatType.CONSOLE
                 or options.evaluation_callback is not None
                 or options.update_state_every_iteration
                 or options.max_solver_time_in_seconds < 1e9
                 or options.dynamic_sparsity)
    if host_loop:
        raise NotImplementedError(
            "these options need the host-loop minimizer, which is not "
            "ported yet (ROADMAP.md item 14, minimizers/trust_region.py); "
            "the slice runs fused_iterations=True only")


def solve(options: SolverOptions, problem,
          summary: Optional[SolverSummary] = None) -> SolverSummary:
    """ceres::Solve (solver.cc:710-830) on options.device. Returns the
    summary; the solved values are written back into the user's numpy
    parameter arrays unless defer_parameter_writeback is set."""
    if summary is None:
        summary = SolverSummary()
    t_start = time.time()
    err = options.validate()
    if err is not None:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {err}"
        return summary
    _check_slice(options)
    device = torch.device(options.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("options.device is CUDA but no CUDA device "
                               "is available")
        # full f32 products: TF32 changed the LM trajectory on the TPU's
        # reduced-precision passes before
        torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    program = CompiledProgram.get_cached(problem, options)
    summary.fixed_cost = program.fixed_cost
    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals_total
    summary.num_parameter_blocks_reduced = (
        program.num_parameter_blocks_reduced)
    summary.num_parameters_reduced = program.num_parameters_reduced
    summary.num_effective_parameters_reduced = (
        program.num_effective_parameters_reduced)
    summary.num_residual_blocks_reduced = program.num_residual_blocks_reduced
    summary.num_residuals_reduced = program.num_residuals_reduced
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.line_search_direction_type = options.line_search_direction_type
    summary.is_constrained = program.has_bounds
    summary.num_threads_given = options.num_threads
    summary.num_threads_used = 1
    summary.mixed_precision_solves_used = bool(
        options.use_mixed_precision_solves)
    summary.dense_linear_algebra_library_type = (
        options.dense_linear_algebra_library_type)
    summary.sparse_linear_algebra_library_type = (
        options.sparse_linear_algebra_library_type)

    if program.num_effective == 0:
        summary.initial_cost = summary.final_cost = program.fixed_cost
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = ("The problem has no variable parameter blocks; "
                           "nothing to optimize.")
        return summary

    meta = detect_schur_structure(program, options)
    if meta is not None:
        rs = {bk.r for bk in program.buckets}
        fs = {g["t"] for g in meta.f_groups}

        def _dim(vals):
            return str(next(iter(vals))) if len(vals) == 1 else "d"

        summary.schur_structure_given = summary.schur_structure_used = (
            f"{_dim(rs)},{meta.te},{_dim(fs)}")
    steps = program.__dict__.setdefault("_fused_steps", {})
    key = options.cache_key()
    if key not in steps:
        steps[key] = FusedSchurStep(program, options, meta)
    step = steps[key]
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.preprocessor_time_in_seconds = time.time() - t0

    x = run_fused(program, options, summary, step)

    t0 = time.time()
    if summary.is_solution_usable():
        if options.defer_parameter_writeback:
            summary._pending_writeback = (program, x)
        else:
            program.write_back(x)
    summary.postprocessor_time_in_seconds = time.time() - t0
    summary.total_time_in_seconds = time.time() - t_start
    return summary


class Solver:
    """Object-style API: Solver().solve(options, problem)."""

    Options = SolverOptions
    Summary = SolverSummary

    def solve(self, options, problem, summary=None):
        return solve(options, problem, summary)
