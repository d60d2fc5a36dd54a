"""SPARSE_SCHUR's block-sparse reduced system in ceres_tpu_torch
(solvers/schur_sparse.py on the native LDL^T) against the dense S and
against ceres_tpu on the CPU.

The module constant SPARSE_SCHUR_DENSE_NF is lowered to 0 to reach the
block-sparse path at small sizes, as the JAX package's
CERES_TPU_FORCE_SPARSE_SCHUR does there. On
torch_parity_kit.schur_problem without its heavily observed point (the
block-sparse path needs the chunk layout on every bucket with e and f
slots), with the camera prior (an f-only bucket), the constant camera
and the duplicate (camera, point) rows across two buckets: the
block-sparse S equals the dense S (1e-12); the SPARSE step equals the
DENSE step (1e-10); whole solves match the JAX package's block-sparse
route (f64: the same LM count, the final cost within 1e-9; mixed: within
1e-5, the counts reported), serve every damped solve from the native
LDL^T and form no dense S; a factorization that breaks down gives a NaN
step; past 4,096 camera columns SPARSE_SCHUR routes as the JAX package
does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, enum_options, jax_generic_schur, rel,
                              schur_bal, schur_problem)

from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu_torch import solver as torch_solver
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import schur_sparse
from ceres_tpu_torch.solvers.schur import (SchurLinearSolver, SchurOps,
                                           SchurSystem,
                                           detect_schur_structure)
from ceres_tpu_torch.solvers.schur_sparse import (SparseSchurContext,
                                                  get_sparse_schur_context,
                                                  sparse_schur_supported,
                                                  use_sparse_schur)
from ceres_tpu_torch.types import SolverSummary


@pytest.fixture
def sparse_everywhere(monkeypatch):
    monkeypatch.setattr(schur_sparse, "SPARSE_SCHUR_DENSE_NF", 0)


def _problem(mod, bal, **kw):
    return schur_problem(mod, bal, heavy_point=False, **kw)


@pytest.fixture(scope="module")
def system():
    """(program, residuals, meta, SchurSystem) of the problem's Jacobian
    at its start, column-scaled as the LM step scales it."""
    prog = TorchProgram(_problem(ctt, schur_bal())[0], device="cpu")
    opts = enum_options(ctt, linear_solver_type="SPARSE_SCHUR")
    meta = detect_schur_structure(prog, opts)
    assert sparse_schur_supported(meta)
    _, _, jac, res = prog.linearize_fn(prog.initial_state())
    scale = 1.0 / (1.0 + torch.sqrt(jac.squared_column_norms()))
    return prog, res, meta, SchurSystem(meta, jac.scale_columns(scale))


def _D(prog, seed=5):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.5 + rng.random(prog.num_effective))


def test_block_sparse_S_equals_dense_S(system):
    """The pair blocks scattered into a dense matrix, with D_f^2 on the
    diagonal, equal the explicit S in the group-local order."""
    prog, _, meta, sys_ = system
    ctx = SparseSchurContext(meta, "cpu")
    ops = SchurOps(sys_, _D(prog))
    vals = ctx.block_values(ops).numpy()
    n = ctx.n_sc
    dense = np.zeros(n * n)
    flat = np.zeros(ctx.csc_of_block.size)
    flat[ctx.csc_of_block] = vals.reshape(-1)
    cols = np.repeat(np.arange(n), np.diff(ctx.Ap))
    dense[cols * n + ctx.Ai] = flat
    dense = dense.reshape(n, n)
    perm = ctx.cols_flat.numpy()
    d_sq = (ops.D_f * ops.D_f).numpy()[perm]
    dense[np.arange(n), np.arange(n)] += d_sq
    S = ops.explicit_S().numpy()[np.ix_(perm, perm)]
    assert rel(dense, S) <= 1e-12
    # the pattern holds every nonzero block of S and the diagonal
    assert np.all(S[dense == 0] == 0)


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_sparse_step_equals_dense_step(system, sparse_everywhere, mixed):
    """SchurLinearSolver's step through the block-sparse S equals the
    dense S's step (f64 1e-10; mixed, f32 S both, 1e-4)."""
    prog, res, meta, sys_ = system
    D = _D(prog)
    steps = []
    for kind in ("SPARSE_SCHUR", "DENSE_SCHUR"):
        opts = enum_options(ctt, linear_solver_type=kind,
                            use_mixed_precision_solves=mixed)
        solver = SchurLinearSolver(prog, opts, meta)
        assert (solver.sparse is not None) == (kind == "SPARSE_SCHUR")
        steps.append(solver(solver.system(sys_.jac), res, D)[0]
                     .double().numpy())
    assert rel(steps[0], steps[1]) <= (1e-4 if mixed else 1e-10)


def test_factorization_failure_gives_nan(system):
    """An indefinite reduced system breaks the LDL^T down: the step is NaN
    (the trust-region loop's invalid step), not a dense fallback."""
    meta = system[2]
    ctx = SparseSchurContext(meta, "cpu")
    vals = -np.ones(ctx.csc_of_block.size)
    y = ctx.host_solve(vals, np.zeros(ctx.n_sc), np.ones(ctx.n_sc))
    assert np.isnan(y).all()


def _solve_pair(monkeypatch, **kw):
    """The JAX package's and the port's solves, and the port's sparse
    context; forming a dense S in the port's solve raises."""
    bal = schur_bal()
    with jax_generic_schur(sparse=True):
        s_j = ct.solve(enum_options(ct, linear_solver_type="SPARSE_SCHUR",
                                    max_num_iterations=50, **kw),
                       _problem(ct, bal)[0])

    def no_dense_S(self):
        raise AssertionError("a dense S was formed")
    monkeypatch.setattr(SchurOps, "_assemble_S", no_dense_S)
    problem = _problem(ctt, bal)[0]
    opts = enum_options(ctt, linear_solver_type="SPARSE_SCHUR",
                        max_num_iterations=50, **kw)
    s_t = ctt.solve(opts, problem)
    prog = TorchProgram.get_cached(problem, opts)
    ctx = get_sparse_schur_context(detect_schur_structure(prog, opts), prog,
                                   opts)
    return s_j, s_t, ctx


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_solve_matches_jax(sparse_everywhere, mixed, monkeypatch):
    """Whole solves against the JAX package's block-sparse route; every
    damped solve on the native LDL^T and no dense S formed."""
    s_j, s_t, ctx = _solve_pair(monkeypatch, use_mixed_precision_solves=mixed)
    assert "block-sparse S on the native LDL^T" in s_t.message
    assert ctx.solves == s_t.num_linear_solves > 0
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    print(f"LM {s_t.num_iterations} (JAX {s_j.num_iterations}), final cost "
          f"{s_t.final_cost!r} (JAX {s_j.final_cost!r})")
    if not mixed:
        assert s_t.num_iterations == s_j.num_iterations
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
    else:
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost


def test_dense_below_the_cap():
    """Below SPARSE_SCHUR_DENSE_NF, SPARSE_SCHUR forms the dense S (in the
    fused step when it serves the configuration, as in the JAX package)."""
    prog = TorchProgram(_problem(ctt, schur_bal())[0], device="cpu")
    opts = enum_options(ctt, linear_solver_type="SPARSE_SCHUR")
    meta = detect_schur_structure(prog, opts)
    assert meta.nf <= schur_sparse.SPARSE_SCHUR_DENSE_NF
    assert not use_sparse_schur(meta, opts)
    assert SchurLinearSolver(prog, opts, meta).sparse is None


def _wide(num_cameras, two_groups=False):
    """Three observations a point, 9-parameter cameras (nf = 9
    num_cameras); two_groups holds one camera's last parameter fixed
    (SubsetManifold): a camera of tangent size 8 makes a second f group,
    which the block-sparse path does not take."""
    from ceres_tpu_torch.io.bal import build_bal_ceres_problem
    bal = synthetic_bal_problem(num_cameras=num_cameras,
                                num_points=10 * num_cameras,
                                num_observations=30 * num_cameras, seed=3)
    problem, cams, pts = build_bal_ceres_problem(bal)
    if two_groups:
        problem.set_manifold(cams[0], ctt.SubsetManifold(9, [8]))
    return problem


@pytest.mark.parametrize("case", ["supported", "unsupported"])
def test_routing_past_4096_columns(case):
    """SPARSE_SCHUR past 4,096 camera columns (ceres_tpu solver.py:648-667):
    a structure the block-sparse path serves stays SPARSE_SCHUR there; one
    it cannot (two f groups) runs ITERATIVE_SCHUR with SCHUR_JACOBI in
    place of IDENTITY."""
    problem = _wide(460, two_groups=case == "unsupported")
    opts = enum_options(ctt, linear_solver_type="SPARSE_SCHUR",
                        preconditioner_type="IDENTITY")
    prog = TorchProgram(problem, device="cpu")
    meta = detect_schur_structure(prog, opts)
    assert meta.nf > 4096
    summary = SolverSummary()
    new = torch_solver._maybe_downgrade_options(opts, prog, summary)
    if case == "supported":
        assert new is opts and use_sparse_schur(meta, new)
        assert isinstance(get_sparse_schur_context(meta, prog, new),
                          SparseSchurContext)
    else:
        assert not sparse_schur_supported(meta)
        assert new.linear_solver_type == ctt.LinearSolverType.ITERATIVE_SCHUR
        assert new.preconditioner_type == \
            ctt.PreconditionerType.SCHUR_JACOBI
        assert "routing the reduced solve to ITERATIVE_SCHUR" in \
            summary.message
        assert dataclasses.replace(new, linear_solver_type=opts
                                   .linear_solver_type,
                                   preconditioner_type=opts
                                   .preconditioner_type) == opts
