"""Solver::Solve for the ported slices.

Counterpart of ceres_tpu/solver.py (solve, :444; make_step_impl, :154;
_make_linear_solver, :34; make_scale_impl, :94; _maybe_downgrade_options,
:612): validate, build the program on `options.device`, downgrade a Schur
solver on a problem without Schur structure, then run the fused LM loop
with the step of the configuration: the fused Schur step (DENSE_SCHUR,
ITERATIVE_SCHUR on an explicit S, or ITERATIVE_SCHUR in the implicit mode
past the explicit cap; the summary's message names the mode) or the
generic LM step (CGNR). Write back.
Configurations outside the slices raise NotImplementedError naming the
ROADMAP.md item that ports them; none runs another path quietly.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .minimizers.fused import run_fused
from .ops.bsr import BlockJacobian, RVec, block_diag_jtj
from .program import CompiledProgram
from .solvers.cg import solve_cgnr
from .solvers.preconditioners import make_block_jacobi_preconditioner
from .solvers.schur import detect_schur_structure
from .solvers.schur_fused import SchurStep, schur_step
from .types import (DumpFormatType, LinearSolverType, MinimizerType,
                    PreconditionerType, SolverOptions, SolverSummary,
                    TerminationType, TrustRegionStrategyType)

_SCHUR_SOLVERS = (LinearSolverType.DENSE_SCHUR,
                  LinearSolverType.SPARSE_SCHUR,
                  LinearSolverType.ITERATIVE_SCHUR)
# ROADMAP.md items that port each non-Schur linear solver outside the slice
_GENERIC_SOLVER_ITEMS = {
    LinearSolverType.DENSE_QR: "item 15, solvers/dense.py",
    LinearSolverType.DENSE_NORMAL_CHOLESKY: "item 15, solvers/dense.py",
    LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        "item 20, solvers/sparse_direct.py on native/",
}


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


def generic_unsupported_reason(program, options) -> Optional[str]:
    """Why the generic LM step cannot run this configuration (naming the
    ROADMAP.md item that ports it), or None."""
    lst = options.linear_solver_type
    if lst in _GENERIC_SOLVER_ITEMS:
        return f"{lst} (ROADMAP.md {_GENERIC_SOLVER_ITEMS[lst]})"
    if lst != LinearSolverType.CGNR:
        return f"{lst} on the generic LM step"
    if not options.use_mixed_precision_solves:
        return ("the f64 (non-mixed) CGNR step (ROADMAP.md item 16, the "
                "rest of solve_cgnr)")
    if options.max_num_refinement_iterations > 0:
        return ("mixed-precision refinement (ROADMAP.md item 15, "
                "solvers/dense.py)")
    if options.preconditioner_type == PreconditionerType.SUBSET:
        return ("the SUBSET preconditioner (ROADMAP.md item 20, native/ "
                "and solvers/sparse_direct.py)")
    if program.has_bounds:
        return ("bounds (ROADMAP.md item 14, the host-loop minimizer's "
                "projected steps)")
    return None


@dataclass
class GenericLinearization:
    """Radius-independent artifacts of one linearization of the generic
    LM step (f32 unless noted)."""
    cost: torch.Tensor          # f64 total cost at x
    jac_s: BlockJacobian        # column-scaled Jacobian
    res: RVec                   # residuals
    grad_s: torch.Tensor        # scaled gradient J_s^T r
    diag: torch.Tensor          # clipped squared column norms of J_s
    jtj_blocks: Optional[list]  # block-Jacobi J_s^T J_s blocks, per group
    scale: torch.Tensor         # Jacobi column scale
    grad_max: torch.Tensor      # f64 max |gradient|
    grad_norm: torch.Tensor     # f64 ||gradient||

    @property
    def scales(self):
        return (self.scale,)


class GenericLMStep:
    """The generic (non-Schur) LM step of ceres_tpu's make_step_impl, the
    `mixed and refine_iters == 0` branch (:200-276), with the CGNR linear
    solver (_make_linear_solver, :63-86), split into `linearize` (once per
    accepted step) and `solve` (once per damped trial):

      linearize: linearize_fn_mixed (K11 for the buckets with a hand
        spec, jacfwd for the others; the f64 residual pass gives the
        cost); at the first linearization the Jacobi scale
        1 / (1 + ||J_j||) (make_scale_impl, mixed branch); J_s = J S,
        g_s = S g, the clipped diagonal of J_s^T J_s and, for JACOBI, its
        per-block J_s^T J_s blocks.
      solve: D = sqrt(diag / radius); CGNR on (J_s^T J_s + D^2) d = -g_s
        (K8 once per bucket per CG application); the model cost change
        -(d.g_s + 1/2 ||J_s d||^2); the step S d in f64.
      cost: the program's f64 cost.

    Every preconditioner but IDENTITY and SUBSET is block Jacobi here, as
    in the JAX package's CGNR branch."""

    def __init__(self, program, options):
        reason = generic_unsupported_reason(program, options)
        if reason is not None:
            raise NotImplementedError(f"not in the ported slice: {reason}")
        self.program = program
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.jacobi = (options.preconditioner_type
                       != PreconditionerType.IDENTITY)
        self.cg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)

    def initial_scales(self):
        """No scale yet: the first linearization derives it."""
        return (None,)

    def cost(self, x):
        return self.program.cost_fn(x)

    def linearize(self, x, scale, first: bool,
                  known_cost=None) -> GenericLinearization:
        """Linearize at x. first=True derives the Jacobi scale from this
        linearization's column norms; otherwise `scale` is used."""
        cost, grad, jac, res = self.program.linearize_fn_mixed(x)
        if first:
            scale = (1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
                     if self.use_scaling else torch.ones_like(grad))
        jac_s = jac.scale_columns(scale)
        return GenericLinearization(
            cost=cost if known_cost is None else known_cost,
            jac_s=jac_s, res=res, grad_s=grad * scale,
            diag=torch.clamp(jac_s.squared_column_norms(), self.min_diag,
                             self.max_diag),
            jtj_blocks=(block_diag_jtj(jac_s, self.program.groups)
                        if self.jacobi else None),
            scale=scale, grad_max=grad.abs().max().double(),
            grad_norm=torch.linalg.vector_norm(grad).double())

    def solve(self, art: GenericLinearization, radius: float) -> dict:
        """Damped solve at `radius`: the LM step and its model cost
        change (the JAX step's output dict)."""
        rad = torch.tensor(radius, dtype=torch.float32,
                           device=self.program.device)
        D = torch.sqrt(art.diag / rad)
        precond = (make_block_jacobi_preconditioner(
            art.jtj_blocks, D, self.program.groups) if self.jacobi
            else None)
        d, lin_iters = solve_cgnr(art.jac_s, art.res, D, precond,
                                  **self.cg_args)
        Jd = art.jac_s.matvec(d)
        mcc = -(torch.dot(d, art.grad_s) + 0.5 * Jd.squared_norm())
        delta = (art.scale * d).double()
        return {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.double(),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": lin_iters,
        }


def _maybe_downgrade_options(options, program, summary):
    """Option rewriting of trust_region_preprocessor.cc:75-107 (ceres_tpu
    solver.py:612): a Schur solver on a problem with no elimination
    structure becomes DENSE_QR, SPARSE_NORMAL_CHOLESKY or CGNR + JACOBI.
    Sets the summary's Schur structure string."""
    t = options.linear_solver_type
    if t not in _SCHUR_SOLVERS:
        return options
    structure = detect_schur_structure(program, options)
    if structure is None:
        new_t = {LinearSolverType.DENSE_SCHUR: LinearSolverType.DENSE_QR,
                 LinearSolverType.SPARSE_SCHUR:
                     LinearSolverType.SPARSE_NORMAL_CHOLESKY,
                 LinearSolverType.ITERATIVE_SCHUR:
                     LinearSolverType.CGNR}[t]
        summary.message = f"No Schur structure detected; using {new_t}. "
        return dataclasses.replace(
            options, linear_solver_type=new_t,
            preconditioner_type=PreconditionerType.JACOBI)
    # the reference's SchurStructureToString, 'd' = ragged
    rs = {bk.r for bk in program.buckets}
    fs = {g["t"] for g in structure.f_groups}

    def _dim(vals):
        return str(next(iter(vals))) if len(vals) == 1 else "d"

    summary.schur_structure_given = summary.schur_structure_used = (
        f"{_dim(rs)},{structure.te},{_dim(fs)}")
    if t == LinearSolverType.SPARSE_SCHUR and structure.nf > 4096:
        # the JAX package routes this to its block-sparse LDL^T or to
        # ITERATIVE_SCHUR (_sparse_schur_ok)
        raise NotImplementedError(
            "SPARSE_SCHUR past 4096 camera columns (ROADMAP.md item 19, "
            "solvers/schur_sparse.py)")
    return options


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

    options = _maybe_downgrade_options(options, program, summary)
    steps = program.__dict__.setdefault("_fused_steps", {})
    key = options.cache_key()
    if key not in steps:
        if options.linear_solver_type in _SCHUR_SOLVERS:
            steps[key] = schur_step(
                program, options, detect_schur_structure(program, options))
        else:
            steps[key] = GenericLMStep(program, options)
    step = steps[key]
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.preprocessor_time_in_seconds = time.time() - t0

    x = run_fused(program, options, summary, step)
    if isinstance(step, SchurStep):
        summary.message += f" Schur step: {step.mode}."

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
