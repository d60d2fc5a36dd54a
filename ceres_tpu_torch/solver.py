"""Solver::Solve for the ported slices.

Counterpart of ceres_tpu/solver.py (solve, :444; make_step_impl, :154;
_make_linear_solver, :34; make_scale_impl, :94; _maybe_downgrade_options,
:612): validate, build the program on `options.device`, downgrade a Schur
solver on a problem without Schur structure, build the step of the
configuration, run it in the fused LM loop (minimizers/fused.py) or in
the host-loop trust-region minimizer (minimizers/trust_region.py) as the
JAX package decides (:547-590), or run the line-search minimizer
(minimizers/line_search.py, :591-593), and write back. The steps:
  - the fused Schur step (DENSE_SCHUR, ITERATIVE_SCHUR on an explicit S,
    or ITERATIVE_SCHUR in the implicit mode past the explicit cap; the
    summary's message names the mode),
    where the JAX package's make_step_impl takes its fused step (LM, no
    refinement in mixed mode, a Schur structure, not the block-sparse
    SPARSE_SCHUR) and `schur_fused.unsupported_reason` accepts it, or
    refuses it for a port kernel's limit (a `KernelLimit`, which the
    fused step raises);
  - the generic LM step (`GenericLMStep`) with DENSE_QR,
    DENSE_NORMAL_CHOLESKY, SPARSE_NORMAL_CHOLESKY (the native host LDL^T
    of solvers/sparse_direct.py from 200 effective parameters; below,
    a dense factorization, as the JAX package decides), CGNR (block
    Jacobi or SUBSET) or the Schur family (solvers/schur.py
    SchurLinearSolver: every Schur configuration the fused step does
    not take, the f64 one among them), in f64, mixed (f32 linearize and
    solve), or mixed with refinement (f64 linearize, f32 solve; the
    Schur solvers refine outside the solve, with its solve_b);
  - the dogleg step (`DoglegStep`), TRADITIONAL_DOGLEG or
    SUBSPACE_DOGLEG, on the same linear solvers.
Inner iterations and the trust-region problem dumps run the host loop,
as in the JAX package. With `options.mesh` (a torch.distributed group's
ranks) a device-loop configuration runs sharded over the ranks where a
sharded path serves it (parallel/solve_sharded.py, :564-585 there). Configurations outside the slices raise
NotImplementedError naming the ROADMAP.md item that ports them; none runs
another path quietly.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .minimizers.coordinate_descent import is_ordering_valid
from .minimizers.fused import run_fused
from .minimizers.line_search import minimize_line_search
from .minimizers.trust_region import minimize_trust_region
from .ops.bsr import BlockJacobian, RVec, block_diag_jtj
from .gradient_checker import check_problem_gradients
from .program import CompiledProgram
from .solvers.cg import solve_cgnr
from .solvers.dense import solve_dense_normal_cholesky, solve_dense_qr
from .solvers.preconditioners import (SubsetPreconditioner,
                                      make_block_jacobi_preconditioner)
from .solvers import schur_fused
from .solvers.schur import SchurLinearSolver, detect_schur_structure
from .solvers.schur_fused import SchurStep, schur_step
from .solvers.schur_sparse import sparse_schur_supported, use_sparse_schur
from .solvers.sparse_direct import SparseNormalCholeskySolver
from .types import (DoglegType, DumpFormatType, LinearSolverType,
                    MinimizerType, PreconditionerType, SolverOptions,
                    SolverSummary, TerminationType, TrustRegionStrategyType)

_SCHUR_SOLVERS = (LinearSolverType.DENSE_SCHUR,
                  LinearSolverType.SPARSE_SCHUR,
                  LinearSolverType.ITERATIVE_SCHUR)
_DIRECT_SOLVERS = (LinearSolverType.DENSE_QR,
                   LinearSolverType.DENSE_NORMAL_CHOLESKY,
                   LinearSolverType.SPARSE_NORMAL_CHOLESKY)
# SPARSE_NORMAL_CHOLESKY factorizes densely below this many effective
# parameters (ceres_tpu solver.py:54); from it on, the native sparse LDL^T
SPARSE_DENSE_CAP = 200


def needs_host_loop(options, program) -> bool:
    """The configurations that the fused loop cannot serve (ceres_tpu
    solver.py:547-562): callbacks, nonmonotonic steps, per-iteration
    logging, inner iterations, the trust-region problem dumps, evaluation
    callbacks, update_state_every_iteration, a finite wall-clock budget,
    dynamic sparsity and bounds."""
    return bool(options.callbacks or options.use_nonmonotonic_steps
                or options.minimizer_progress_to_stdout
                or options.use_inner_iterations
                or options.trust_region_problem_dump_directory
                or options.trust_region_problem_dump_format_type
                == DumpFormatType.CONSOLE
                or options.evaluation_callback is not None
                or options.update_state_every_iteration
                or options.max_solver_time_in_seconds < 1e9
                or options.dynamic_sparsity
                or program.has_bounds)


def generic_unsupported_reason(program, options) -> Optional[str]:
    """Why the generic steps (LM or dogleg) cannot run this configuration
    (naming the ROADMAP.md item that ports it), or None."""
    lst = options.linear_solver_type
    if lst not in _DIRECT_SOLVERS + _SCHUR_SOLVERS and \
            lst != LinearSolverType.CGNR:
        return f"{lst} on the generic step"
    return None


class LinearSolver:
    """The generic step's linear solver (ceres_tpu _make_linear_solver,
    :34-92): `solver(jac_s, res, D, blocks) -> (d, iterations)` minimizes
    ||J_s d + r||^2 + ||diag(D) d||^2, where `blocks(jac_s, res)` forms
    the radius-free part once per linearization. DENSE_QR: QR of
    [J; diag(D)]; DENSE_NORMAL_CHOLESKY (and SPARSE_NORMAL_CHOLESKY below
    SPARSE_DENSE_CAP): Cholesky of J^T J + D^2, f32 with refinement when
    mixed; SPARSE_NORMAL_CHOLESKY from SPARSE_DENSE_CAP on: the native
    LDL^T of J^T J + D^2 on the host (blocks: J^T J and -J^T r there),
    an f64 step; CGNR: CG on the normal equations with SUBSET (blocks:
    the subset rows' J^T J on the host) or block Jacobi (every other
    preconditioner but IDENTITY; blocks: the J^T J blocks); the Schur
    family: solvers/schur.py SchurLinearSolver (blocks: its SchurSystem,
    the sub-Jacobians and E^T E), whose solve_b the mixed refinement of
    GenericLMStep calls."""

    def __init__(self, program, options):
        self.kind = options.linear_solver_type
        self.groups = program.groups
        self.schur = (SchurLinearSolver(program, options)
                      if self.kind in _SCHUR_SOLVERS else None)
        self.mixed = bool(options.use_mixed_precision_solves)
        self.refine = options.max_num_refinement_iterations
        self.sparse = (SparseNormalCholeskySolver(program, options)
                       if self.kind == LinearSolverType.SPARSE_NORMAL_CHOLESKY
                       and program.num_effective >= SPARSE_DENSE_CAP
                       else None)
        cgnr = self.kind == LinearSolverType.CGNR
        self.subset = (SubsetPreconditioner(program, options)
                       if cgnr and options.preconditioner_type
                       == PreconditionerType.SUBSET else None)
        self.jacobi = (cgnr and self.subset is None
                       and options.preconditioner_type
                       != PreconditionerType.IDENTITY)
        self.cg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)

    def blocks(self, jac_s, res):
        if self.schur is not None:
            return self.schur.system(jac_s)
        if self.sparse is not None:
            return self.sparse.system(jac_s, res)
        if self.subset is not None:
            return self.subset.system(jac_s)
        return block_diag_jtj(jac_s, self.groups) if self.jacobi else None

    def __call__(self, jac_s, res, D, blocks):
        if self.schur is not None:
            return self.schur(blocks, res, D)
        if self.kind == LinearSolverType.DENSE_QR:
            return solve_dense_qr(jac_s, res, D)
        if self.sparse is not None:
            return (self.sparse.solve(blocks, D),
                    torch.zeros((), dtype=torch.int32, device=D.device))
        if self.kind != LinearSolverType.CGNR:
            return solve_dense_normal_cholesky(
                jac_s, res, D, mixed_precision=self.mixed,
                refinement_iterations=self.refine)
        if self.subset is not None:
            precond = self.subset.make(blocks, D)
        elif self.jacobi:
            precond = make_block_jacobi_preconditioner(blocks, D, self.groups)
        else:
            precond = None
        return solve_cgnr(jac_s, res, D, precond, **self.cg_args)


@dataclass
class GenericLinearization:
    """Radius-independent artifacts of one linearization of the generic
    steps, in the step's precision (f32 when mixed) unless noted."""
    cost: torch.Tensor          # f64 total cost at x
    jac_s: BlockJacobian        # column-scaled Jacobian
    res: RVec                   # residuals
    grad_s: torch.Tensor        # scaled gradient J_s^T r
    diag: Optional[torch.Tensor]  # clipped squared column norms of J_s
    blocks: object              # the linear solver's radius-free part
    scale: torch.Tensor         # Jacobi column scale
    grad_max: torch.Tensor      # f64 max |gradient|
    grad_norm: torch.Tensor     # f64 ||gradient||
    grad_full: Optional[torch.Tensor]   # f64 gradient, with bounds only
    dogleg: Optional[dict] = None       # DoglegStep's radius-free parts
    refine: Optional[tuple] = None      # (J_s f64, -J_s^T r f64): refinement

    @property
    def scales(self):
        return (self.scale,)


class GenericLMStep:
    """The generic (non-Schur) LM step of ceres_tpu's make_step_impl
    (lm_step, :200-276), split into `linearize` (once per accepted step)
    and `solve` (once per damped trial), with the LinearSolver of the
    configuration, in the branch of its precision:

      f64 (use_mixed_precision_solves False): the f64 linearize
        (program.linearize_fn), the Jacobi scale from its column norms.
      mixed: linearize_fn_mixed (K11 for the buckets with a spec, the
        f64 residual pass gives the cost), solve in f32.
      mixed with refinement (max_num_refinement_iterations > 0): the f64
        linearize, its J and r cast to f32 for the solve, the f64
        gradient for the convergence norms. The dense normal Cholesky
        refines inside its solve; a Schur solver's f32 step is refined
        here (lm_step, :238-252): per refinement iteration the f64
        residual b - (J_s^T J_s + D^2) d of the damped normal equations
        drives an f32 correction solve (its solve_b). The other solvers
        do not refine, as in the JAX package (no solve_b).
      In both mixed branches the scale comes from the f32 pass, once.

    linearize: J_s = J S with S = 1 / (1 + ||J_j||) fixed at the first
      linearization (make_scale_impl, :94-120), g_s = S g, the clipped
      diagonal of J_s^T J_s and, for CGNR + JACOBI, its blocks.
    solve: D = sqrt(diag / radius), the linear solve, the model cost
      change -(d.g_s + 1/2 ||J_s d||^2) (mixed direct solvers: from d.b
      and ||D d||, :195-199), the step S d in f64."""

    def __init__(self, program, options):
        reason = generic_unsupported_reason(program, options)
        if reason is not None:
            raise NotImplementedError(f"not in the ported slice: {reason}")
        self.program = program
        self.mixed = bool(options.use_mixed_precision_solves)
        self.refine = (options.max_num_refinement_iterations
                       if self.mixed else 0)
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.linear = LinearSolver(program, options)
        self.exact_solver = (self.mixed and options.linear_solver_type
                             in _DIRECT_SOLVERS + (
                                 LinearSolverType.DENSE_SCHUR,
                                 LinearSolverType.SPARSE_SCHUR))
        self.refine_outer = self.refine > 0 and self.linear.schur is not None

    def initial_scales(self):
        """No scale yet: the first linearization derives it."""
        return (None,)

    def bind(self, program):
        """This step on another program of the same structure (every
        integer layout bitwise equal; batch.py checks it). The step reads
        every value through the program, and its linear solver holds the
        structure alone."""
        step = copy.copy(self)
        step.program = program
        return step

    def cost(self, x):
        return self.program.cost_fn(x)

    def _linearize(self, x):
        """(cost, gradient, J, r in the solve's precision, the f64
        gradient when the branch has one apart, the f64 J when the
        branch refines outside the solve)."""
        prog = self.program
        if self.mixed and self.refine == 0:
            return (*prog.linearize_fn_mixed(x), None, None)
        cost, grad, jac, res = prog.linearize_fn(x)
        if not self.mixed:
            return cost, grad, jac, res, None, None
        f32 = torch.float32
        jac32 = BlockJacobian([b.with_J(b.J.to(f32)) for b in jac.buckets],
                              jac.num_cols, jac.col_sum)
        res32 = RVec([p.to(f32) for p in res.parts])
        return (cost, jac32.rmatvec(res32), jac32, res32, grad,
                jac if self.refine_outer else None)

    def _scale(self, x, jac):
        """The Jacobi column scale of the first linearization, from the
        f32 pass when mixed (make_scale_impl)."""
        if not self.use_scaling:
            return torch.ones(jac.num_cols, dtype=jac.buckets[0].J.dtype,
                              device=self.program.device)
        if self.mixed and self.refine > 0:
            jac = self.program.linearize_fn_mixed(x)[2]
        return 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))

    def _base(self, x, scale, first, known_cost, with_diag=True):
        cost, grad, jac, res, grad64, jac64 = self._linearize(x)
        if first:
            scale = self._scale(x, jac)
        jac_s = jac.scale_columns(scale)
        g_norms = grad64 if grad64 is not None else grad
        refine = None
        if jac64 is not None:
            scale64 = scale.double()
            refine = (jac64.scale_columns(scale64), -(grad64 * scale64))
        return GenericLinearization(
            cost=cost if known_cost is None else known_cost,
            jac_s=jac_s, res=res, grad_s=grad * scale,
            diag=(torch.clamp(jac_s.squared_column_norms(), self.min_diag,
                              self.max_diag) if with_diag else None),
            blocks=self.linear.blocks(jac_s, res), scale=scale,
            grad_max=g_norms.abs().max().double(),
            grad_norm=torch.linalg.vector_norm(g_norms).double(),
            grad_full=grad.double() if self.program.has_bounds else None,
            refine=refine)

    def linearize(self, x, scale, first: bool,
                  known_cost=None) -> GenericLinearization:
        """Linearize at x. first=True derives the Jacobi scale from this
        linearization's column norms; otherwise `scale` is used."""
        return self._base(x, scale, first, known_cost)

    def _out(self, art, d, mcc, lin_iters) -> dict:
        delta = (art.scale * d).double()
        out = {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.double(),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": lin_iters,
        }
        if art.grad_full is not None:
            out["gradient_full"] = art.grad_full
        return out

    def solve(self, art: GenericLinearization, radius: float) -> dict:
        """Damped solve at `radius`: the LM step and its model cost
        change (the JAX step's output dict)."""
        rad = torch.tensor(radius, dtype=art.diag.dtype,
                           device=self.program.device)
        D = torch.sqrt(art.diag / rad)
        d, lin_iters = self.linear(art.jac_s, art.res, D, art.blocks)
        if art.refine is not None:
            d, lin_iters = self._refine(art, D, d, lin_iters)
        if self.exact_solver:
            # (J^T J + D^2) d = -g_s exactly: ||J_s d||^2 = -d.g_s - ||D d||^2
            # (the sparse solver's step is f64 in every precision)
            Dd = D.to(d.dtype) * d
            dg = torch.dot(d, art.grad_s.to(d.dtype))
            mcc = -(dg + 0.5 * (-dg - torch.dot(Dd, Dd)))
        else:
            Jd = art.jac_s.matvec(d)
            mcc = -(torch.dot(d, art.grad_s) + 0.5 * Jd.squared_norm())
        return self._out(art, d, mcc, lin_iters)


    def _refine(self, art, D, d, lin_iters):
        """Mixed-precision iterative refinement of a Schur step
        (solver.h:572-589, iterative_refiner.h; ceres_tpu lm_step,
        :238-252): d += solve_b(b - (J_s^T J_s + D^2) d), the residual in
        f64, the correction in f32; returns the f64 step."""
        jac64_s, b64 = art.refine
        D64 = D.double()
        d64 = d.double()
        for _ in range(self.refine):
            Hd = jac64_s.rmatvec(jac64_s.matvec(d64)) + (D64 * D64) * d64
            dc, it = self.linear.schur.solve_b(art.blocks, D, b64 - Hd)
            d64 = d64 + dc.double()
            lin_iters = lin_iters + it
        return d64, lin_iters


def subspace_model(g, gn, jmv, jdot, dot, mv) -> dict:
    """The radius-free part of SUBSPACE_DOGLEG (ceres_tpu _subspace_solve,
    :278-331) for one step (g, gn [n]) or a batch of them ([B, n]): the
    basis (b1, b2) of span{g, gn} by Gram-Schmidt, B = basis^T J^T J
    basis, gr = basis^T g, the unconstrained minimum y_unc, eigh(B) and
    gh = Q^T gr. jmv(v) is J_s v, jdot the dot of two of its results, dot
    the dot over the last axis and mv(M, v) the matrix-vector product:
    the single step's scalar reductions, or batch mode's per element."""
    dt = g.dtype
    b1 = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1),
                         min=1e-300)[..., None]
    v = gn - dot(b1, gn)[..., None] * b1
    v_norm = torch.linalg.vector_norm(v, dim=-1)
    degenerate = v_norm < 1e-12
    b2 = torch.where(degenerate[..., None], b1,
                     v / torch.where(v_norm == 0, 1.0, v_norm)[..., None])
    Jb1, Jb2 = jmv(b1), jmv(b2)
    B01 = jdot(Jb1, Jb2)
    B = torch.stack([torch.stack([jdot(Jb1, Jb1), B01], -1),
                     torch.stack([B01, jdot(Jb2, Jb2)], -1)], -2).to(dt)
    gr = torch.stack([dot(b1, g), dot(b2, g)], -1)
    eye = torch.eye(2, dtype=dt, device=g.device)
    y_unc = -torch.linalg.solve(B + 1e-30 * eye, gr)
    evals, Q = torch.linalg.eigh(B)
    return dict(b1=b1, b2=b2, degenerate=degenerate, y_unc=y_unc,
                evals=evals, Q=Q, gh=mv(Q.transpose(-2, -1), gr))


def subspace_solve(dl, radius, dot, mv):
    """The subspace model's minimum within `radius` (one radius, or one an
    element): y_unc inside, else the secular equation sum gh_i^2 / (d_i +
    lam)^2 = radius^2 by a fixed 64-step bisection; (d_sub, degenerate).
    dot and mv as in subspace_model."""
    d, gh = dl["evals"], dl["gh"]
    inside = torch.linalg.vector_norm(dl["y_unc"], dim=-1) <= radius
    lam_lo = torch.clamp(-d[..., 0], min=0.0) + 1e-12
    lam_hi = (lam_lo + torch.linalg.vector_norm(gh, dim=-1)
              / torch.clamp(radius, min=1e-300) + d.abs().amax(dim=-1)
              + 1.0)
    r_sq = radius * radius
    lo, hi = lam_lo, lam_hi
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        y = gh / (d + mid[..., None])
        too_big = dot(y, y) > r_sq
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    y = torch.where(inside[..., None], dl["y_unc"],
                    mv(dl["Q"], -gh / (d + lam[..., None])))
    return y[..., :1] * dl["b1"] + y[..., 1:] * dl["b2"], dl["degenerate"]


class DoglegStep(GenericLMStep):
    """The dogleg step of ceres_tpu's make_step_impl (dogleg_step,
    :333-437; the reference's dogleg_strategy.cc:130-265), in the
    Jacobi-scaled space, mixed (linearize_fn_mixed) or f64. Everything
    but the radius's part is formed once per linearization:

      the Cauchy point -alpha g, alpha = |g|^2 / |J g|^2;
      the Gauss-Newton point, solved with damping D = 1e-12 raised x100
        while the solve is not valid (not finite, or a model decrease
        below -eps max(cost, 1) at a step longer than eps (1 + |g|)): at
        most 8 solves, the JAX package's while loop, which reads one flag
        on the host per solve; the Cauchy point if all fail;
      SUBSPACE_DOGLEG: the orthonormal basis of span{g, GN}, the 2 x 2
        model, its unconstrained minimum and its eigendecomposition
        (_subspace_solve, :278-331).

    solve: GN when inside the radius; else TRADITIONAL_DOGLEG the
    truncated gradient (Cauchy point outside) or the segment's boundary
    point, SUBSPACE_DOGLEG the subspace model's boundary minimum (64-step
    bisection of the secular equation; the segment when the subspace
    degenerates); then the model cost change and the step."""

    def __init__(self, program, options):
        super().__init__(program, options)
        self.refine = 0
        self.subspace = options.dogleg_type == DoglegType.SUBSPACE_DOGLEG

    def _linearize(self, x):
        prog = self.program
        if self.mixed:
            return (*prog.linearize_fn_mixed(x), None, None)
        return (*prog.linearize_fn(x), None, None)

    def linearize(self, x, scale, first: bool,
                  known_cost=None) -> GenericLinearization:
        art = self._base(x, scale, first, known_cost, with_diag=False)
        jac_s, g, res = art.jac_s, art.grad_s, art.res
        dt = g.dtype
        g_sq = torch.dot(g, g)
        alpha = g_sq / torch.clamp(jac_s.matvec(g).squared_norm(),
                                   min=1e-300)
        eps_v = 1e-6 if dt == torch.float32 else 1e-12
        cost = self.program.cost_fn(x) if known_cost is None else known_cost
        g_norm = torch.linalg.vector_norm(g)

        def valid(gn_try):
            Jgn = jac_s.matvec(gn_try)
            mcc_gn = -(torch.dot(gn_try, g) + 0.5 * Jgn.squared_norm())
            ok_decrease = mcc_gn > -eps_v * torch.clamp(cost, min=1.0)
            tiny = torch.linalg.vector_norm(gn_try) <= eps_v * (1.0 + g_norm)
            return bool(torch.isfinite(gn_try).all() & (ok_decrease | tiny))

        ftype = np.float32 if dt == torch.float32 else np.float64
        dval = ftype(1e-12)
        gn, lin_iters = self.linear(jac_s, res, torch.full_like(g, dval),
                                    art.blocks)
        gn = gn.to(dt)
        while dval < ftype(1e2) and not valid(gn):
            dval = dval * ftype(1e2)
            gn, it = self.linear(jac_s, res, torch.full_like(g, dval),
                                 art.blocks)
            gn = gn.to(dt)
            lin_iters = lin_iters + it
        cauchy = -alpha * g
        gn = torch.where(torch.isfinite(gn).all(), gn, cauchy)
        dl = dict(g_sq=g_sq, cauchy=cauchy, gn=gn, lin_iters=lin_iters,
                  cauchy_norm=torch.linalg.vector_norm(cauchy),
                  gn_norm=torch.linalg.vector_norm(gn))
        if self.subspace:
            dl.update(subspace_model(g, gn, jac_s.matvec,
                                     lambda a, b: a.dot(b), torch.dot,
                                     torch.mv))
        art.dogleg = dl
        return art

    def solve(self, art: GenericLinearization, radius: float) -> dict:
        dl, g = art.dogleg, art.grad_s
        r = torch.tensor(radius, dtype=g.dtype, device=g.device)
        cauchy, gn = dl["cauchy"], dl["gn"]
        diff = gn - cauchy
        a2 = torch.dot(diff, diff)
        b2 = 2.0 * torch.dot(cauchy, diff)
        c2 = torch.dot(cauchy, cauchy) - r * r
        disc = torch.sqrt(torch.clamp(b2 * b2 - 4.0 * a2 * c2, min=0.0))
        beta = torch.where(a2 > 0, (-b2 + disc)
                           / (2.0 * torch.where(a2 == 0, 1.0, a2)), 0.0)
        seg = cauchy + beta * diff
        inside = dl["gn_norm"] <= r
        d = torch.where(inside, gn, torch.where(
            dl["cauchy_norm"] >= r,
            -(r / torch.sqrt(torch.clamp(dl["g_sq"], min=1e-300))) * g, seg))
        if self.subspace:
            d_sub, degenerate = subspace_solve(dl, r, torch.dot, torch.mv)
            d = torch.where(inside, gn, torch.where(degenerate, d, d_sub))
        Jd = art.jac_s.matvec(d)
        mcc = -(torch.dot(d, g) + 0.5 * Jd.squared_norm())
        return self._out(art, d, mcc, dl["lin_iters"])


def takes_fused_schur_step(program, options) -> bool:
    """Does the configuration take the fused Schur step? Where the JAX
    package's make_step_impl takes its fused step (:165-184: LM, a Schur
    solver, no refinement in mixed mode, a Schur structure, not the
    block-sparse SPARSE_SCHUR) and schur_fused.unsupported_reason
    accepts it or refuses it for a port kernel's limit (a KernelLimit,
    which the fused step raises: the route is the same on every device,
    and the generic step does not stand in for a kernel). Every other
    Schur configuration runs the generic step over SchurLinearSolver; the
    f64 one among them, which the JAX package serves with its fused f64
    step (ROADMAP.md section 3)."""
    if (options.trust_region_strategy_type
            != TrustRegionStrategyType.LEVENBERG_MARQUARDT
            or options.linear_solver_type not in _SCHUR_SOLVERS
            or (options.use_mixed_precision_solves
                and options.max_num_refinement_iterations > 0)):
        return False
    meta = detect_schur_structure(program, options)
    if meta is None or use_sparse_schur(meta, options):
        return False
    reason = schur_fused.unsupported_reason(program, options, meta)
    return reason is None or isinstance(reason, schur_fused.KernelLimit)


def make_step(program, options):
    """The step of the configuration (ceres_tpu make_step_impl): the
    fused Schur step where `takes_fused_schur_step`, else DoglegStep or
    GenericLMStep (over SchurLinearSolver for a Schur solver)."""
    if takes_fused_schur_step(program, options):
        return schur_step(program, options,
                          detect_schur_structure(program, options))
    dogleg = (options.trust_region_strategy_type
              == TrustRegionStrategyType.DOGLEG)
    return (DoglegStep if dogleg else GenericLMStep)(program, options)


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
    if (t == LinearSolverType.SPARSE_SCHUR and structure.nf > 4096
            and not sparse_schur_supported(structure)):
        # past a few thousand cameras a dense S loses; a structure the
        # block-sparse path cannot serve takes PCG on the implicit
        # complement (ceres_tpu solver.py:648-667)
        options = dataclasses.replace(
            options, linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=(
                options.preconditioner_type
                if options.preconditioner_type
                != PreconditionerType.IDENTITY
                else PreconditionerType.SCHUR_JACOBI))
        summary.message = (
            f"SPARSE_SCHUR with {structure.nf} camera-space columns: "
            "routing the reduced solve to ITERATIVE_SCHUR (dense S "
            "uneconomical past ~4096 columns). ")
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
    prob_cb = problem.options.evaluation_callback
    if prob_cb is not None and options.evaluation_callback is None:
        # Problem::Options::evaluation_callback (problem.h:179)
        options = dataclasses.replace(options, evaluation_callback=prob_cb)
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
    summary.inner_iterations_given = bool(options.use_inner_iterations)
    summary.inner_iterations_used = bool(options.use_inner_iterations)
    if (options.use_inner_iterations
            and options.inner_iteration_ordering is not None
            and not is_ordering_valid(program,
                                      options.inner_iteration_ordering)):
        # solver.cc rejects an inner ordering whose groups are not
        # independent sets up front (coordinate_descent_minimizer.h:76)
        summary.termination_type = TerminationType.FAILURE
        summary.message = (
            "Invalid inner_iteration_ordering: each group must be an "
            "independent set (no two blocks of a group may share a "
            "residual block).")
        return summary
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

    if options.check_gradients:
        # solver.h check_gradients (gradient_checking_cost_function.cc):
        # every residual block's Jacobian probed once at the start
        # (ceres_tpu solver.py:522-530)
        err = check_problem_gradients(
            problem, options.gradient_check_relative_precision,
            device=device)
        if err is not None:
            summary.termination_type = TerminationType.FAILURE
            summary.message = err
            return summary

    options = _maybe_downgrade_options(options, program, summary)
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type
    x = None
    if options.minimizer_type == MinimizerType.LINE_SEARCH:
        summary.preprocessor_time_in_seconds = time.time() - t0
        x = minimize_line_search(program, options, summary)
    elif options.mesh is not None and not needs_host_loop(options, program):
        # the sharded solve over options.mesh's ranks (ceres_tpu
        # solver.py:564-585); a problem no sharded path takes runs the
        # single-device route below on each rank, as there, and so do
        # the host-loop configurations (bounds, callbacks, ...)
        from .parallel.solve_sharded import try_solve_sharded
        summary.preprocessor_time_in_seconds = time.time() - t0
        x = try_solve_sharded(program, options, summary)
    if x is None and options.minimizer_type != MinimizerType.LINE_SEARCH:
        steps = program.__dict__.setdefault("_fused_steps", {})
        key = options.cache_key()
        if key not in steps:
            steps[key] = make_step(program, options)
        step = steps[key]
        summary.preprocessor_time_in_seconds = time.time() - t0
        if options.fused_iterations and not needs_host_loop(options,
                                                            program):
            x = run_fused(program, options, summary, step)
        else:
            x = minimize_trust_region(program, options, step, summary)
        if isinstance(step, SchurStep):
            summary.message += f" Schur step: {step.mode}."
        elif getattr(step.linear, "schur", None) is not None:
            summary.message += f" Schur step: {step.linear.schur.mode}."
        if options.mesh is not None:
            summary.message += (
                " options.mesh: each rank ran the single-device route ("
                + ("a host-loop configuration" if needs_host_loop(
                    options, program) else "no sharded path serves this "
                   "problem") + ").")

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
