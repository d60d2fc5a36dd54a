"""SolverOptions.mesh's consumer: the whole solve over the ranks of a
torch.distributed group.

Counterpart of ceres_tpu/parallel/solve_sharded.py. solver.solve calls
try_solve_sharded when options.mesh is set and the configuration runs the
device loop (solver.needs_host_loop false): the sharded fused Schur solve
(parallel/sharded_fused.py) where the problem has the structure, the
sharded CGNR host loop (parallel/sharded.py) for CGNR; None where no
sharded path applies (the caller then runs the single-device route on
each rank, as the JAX package does). Every rank of the group calls it
with the same problem and options.
"""

from __future__ import annotations

import time

from ..types import LinearSolverType, TerminationType
from .group import as_group

_SCHUR = (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR,
          LinearSolverType.ITERATIVE_SCHUR)


def try_solve_sharded(program, options, summary):
    """Run the solve over options.mesh; the final x, or None if no sharded
    path serves this (problem, options) pair."""
    group = as_group(options.mesh)
    if options.linear_solver_type in _SCHUR:
        from ..solvers.schur import detect_schur_structure
        from .sharded_fused import (make_sharded_fused_solve,
                                    sharded_fused_supported)
        meta = detect_schur_structure(program, options)
        if meta is not None and sharded_fused_supported(
                program, options, meta, group.size):
            # keyed on the group's object, which lives as long as the
            # process group (parallel/group.py _GROUPS)
            cache = program.__dict__.setdefault("_sharded", {})
            key = ("sharded_fused", options.cache_key(), id(group))
            if key not in cache:
                cache[key] = make_sharded_fused_solve(program, options,
                                                      meta, group)
            run, step = cache[key]
            t0 = time.time()
            result = run(program.initial_state())
            summary.minimizer_time_in_seconds = time.time() - t0
            _fill(summary, result)
            summary.message += f" Schur step: {step.mode}."
            return result.x
    if options.linear_solver_type == LinearSolverType.CGNR:
        return _solve_sharded_cgnr_host_loop(program, options, summary,
                                             group)
    return None


def _fill(summary, result):
    from ..minimizers.fused import TERMINATION_BY_CODE
    summary.initial_cost = float(result.initial_cost)
    summary.final_cost = float(result.cost)
    summary.num_successful_steps = int(result.successful_steps)
    summary.num_unsuccessful_steps = int(result.unsuccessful_steps)
    summary.num_linear_solves = int(result.iterations)
    summary.num_linear_solver_iterations = int(
        result.total_linear_iterations)
    summary.num_iterations_fused = int(result.iterations)
    summary.num_linearizations_fused = int(result.linearizations)
    code = int(result.termination_code)
    term, msg = TERMINATION_BY_CODE.get(
        code, (TerminationType.FAILURE, f"unknown code {code}"))
    summary.termination_type = term
    summary.message = msg + " (sharded fused mode)"


class _ShardedCGNRStep:
    """make_sharded_lm_step and make_sharded_cost_fn in the step protocol
    of minimizers/trust_region.py: the sharded step linearizes and
    solves in one call, so `linearize` keeps x and `solve` runs the step
    there at the radius (a rejected trial relinearizes at the same x, as
    the JAX package's loop does)."""

    def __init__(self, step_fn, cost_fn):
        self.step_fn, self.cost = step_fn, cost_fn

    @staticmethod
    def initial_scales():
        return ()

    @staticmethod
    def linearize(x, first: bool, known_cost=None):
        return _At(x)

    def solve(self, art, radius: float) -> dict:
        return self.step_fn(art.x, radius)


class _At:
    """The point a _ShardedCGNRStep linearizes at (no scales)."""
    scales = ()

    def __init__(self, x):
        self.x = x


def _solve_sharded_cgnr_host_loop(program, options, summary, group):
    """The sharded CGNR step (CGNR + block Jacobi, parallel/sharded.py)
    under the port's host trust-region loop (minimizers/trust_region.py;
    the JAX package's own loop, :107-191, has the same radius rules):
    problems without Schur structure (SLAM graphs, denoising) over a
    group."""
    from ..minimizers.trust_region import minimize_trust_region
    from .sharded import make_sharded_cost_fn, make_sharded_lm_step
    cache = program.__dict__.setdefault("_sharded", {})
    key = ("sharded_cgnr", options.cache_key(), id(group))
    if key not in cache:
        step_fn, shards = make_sharded_lm_step(program, options, group)
        cache[key] = _ShardedCGNRStep(
            step_fn, make_sharded_cost_fn(program, group, shards))
    x = minimize_trust_region(program, options, cache[key], summary)
    summary.message += " (sharded CGNR host loop)"
    return x
