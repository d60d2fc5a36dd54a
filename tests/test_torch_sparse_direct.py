"""SPARSE_NORMAL_CHOLESKY, SUBSET and dynamic sparsity of ceres_tpu_torch
(solvers/sparse_direct.py, solvers/preconditioners.py SubsetPreconditioner
on the port's native LDL^T) against ceres_tpu on the CPU.

The symbolic context on tests/test_native.py's 80-pose dynamic case (the
same CSC pattern and maps as the JAX package's, the solve against the
dense assembly at 1e-8); whole solves on pose graphs (test_slam.py's
40-pose SE2 and 30-pose SE3, which sit below the 200-parameter cap and
factor densely in both packages, and test_native.py's 120-pose SE2 and
300-pose SE3, which take the native path) with the JAX package's LM count
and its final cost within 1e-10 relative (f64); dynamic sparsity against
the static path at 1e-8; the ordering knob; CGNR + SUBSET on
test_native.py's 60-pose graph within 1e-8 of the JAX final cost (f64);
a mixed solve within 1e-5 of the JAX mixed cost. The sparse paths on the
card: tests/test_torch_sparse_cuda.py.
"""

import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.sparse_direct import \
    SparseNormalCholeskyContext as JaxContext
from ceres_tpu_torch import native
from ceres_tpu_torch import solver as torch_solver
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops.kernels import (_identity_order, bucket_gram_blocks,
                                         bucket_gram_blocks_plain,
                                         group_gram_blocks_plain)
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers.sparse_direct import (
    SparseNormalCholeskyContext, SparseNormalCholeskySolver,
    SparseNormalSystem, _native_ordering, bucket_grams)
from chip_smoke import pose_graph_options

torch.set_num_threads(1)

GRAPHS = {
    "2d-40": ("2d", dict(num_poses=40, seed=1)),
    "3d-30": ("3d", dict(num_poses=30, seed=2, loop_every=5)),
    "2d-120": ("2d", dict(num_poses=120, seed=4)),
    "3d-300": ("3d", dict(num_poses=300, seed=2)),
    "2d-80": ("2d", dict(num_poses=80, seed=6)),
    "2d-60": ("2d", dict(num_poses=60, seed=4)),
}


def _graph(mod, name):
    dim, kw = GRAPHS[name]
    pkg_slam, pkg_g2o = (jax_slam, jax_g2o) if mod is ct else (slam, g2o)
    poses, constraints, gt = getattr(
        pkg_g2o, f"synthetic_pose_graph_{dim}")(**kw)
    return getattr(pkg_slam, f"build_pose_graph_{dim}_problem")(
        poses, constraints)


def _options(mod, **kw):
    for k in ("linear_solver_type", "preconditioner_type",
              "trust_region_strategy_type", "linear_solver_ordering_type"):
        if isinstance(kw.get(k), str):
            kw[k] = getattr(getattr(mod, {
                "linear_solver_type": "LinearSolverType",
                "preconditioner_type": "PreconditionerType",
                "trust_region_strategy_type": "TrustRegionStrategyType",
                "linear_solver_ordering_type": "OrderingType"}[k]), kw[k])
    if mod is ctt:
        kw["device"] = "cpu"
    return mod.SolverOptions(**kw)


def _solve_both(name, **kw):
    """(JAX summary, port summary, port problem arrays) of one solve."""
    s_j = ct.solve(_options(ct, **kw), _graph(ct, name)[0])
    problem, positions, rotations = _graph(ctt, name)
    s_t = ctt.solve(_options(ctt, **kw), problem)
    return s_j, s_t, (problem, positions, rotations)


def _hold(s_j, s_t, rtol):
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.final_cost - s_j.final_cost) <= rtol * s_j.final_cost


def _step(problem, options):
    return torch_solver.make_step(TorchProgram.get_cached(problem, options),
                                  options)


def test_context_pattern_and_solve_match_jax_and_dense():
    """tests/test_native.py's dynamic case: Grams with every other row's
    block zeroed shrink the numerical pattern; the context has the JAX
    package's CSC pattern and maps, its solve the JAX context's bits and
    the dense assembly's x at 1e-8; the next factorization, with no zero
    block, goes back to the full pattern."""
    opts = ct.SolverOptions()
    jp = JaxProgram.get_cached(_graph(ct, "2d-80")[0], opts)
    tp = TorchProgram(_graph(ctt, "2d-80")[0], device="cpu")
    ctx = SparseNormalCholeskyContext(tp, dynamic=True)
    jctx = JaxContext(jp, dynamic=True)
    n = ctx.n
    assert n == jctx.n and ctx.nnz == jctx.nnz
    for a, b in ((ctx.Ap, jctx.Ap), (ctx.Ai, jctx.Ai),
                 (ctx.diag_pos, jctx.diag_pos)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(ctx.maps, jctx.maps))

    rng = np.random.default_rng(3)
    grams = []
    for ac in ctx.bucket_cols:
        nb, t = ac.shape
        B = rng.normal(size=(nb, t, 2 * t))
        G = np.einsum("ntr,nur->ntu", B, B)
        G[::2] = 0.0
        grams.append(G)
    D_sq = np.full(n, 1e-2)
    assert ctx.factor_values(ctx.assemble(grams), D_sq)
    assert ctx.chol._Ai.size < ctx.nnz
    A = np.zeros((n, n))
    for G, ac in zip(grams, ctx.bucket_cols):
        for blk, cols in zip(G, ac):
            A[np.ix_(cols, cols)] += blk
    A[np.diag_indices(n)] += D_sq
    b = rng.normal(size=n)
    x = ctx.host_apply(b)
    np.testing.assert_allclose(A @ x, b, atol=1e-8)
    assert np.array_equal(x, jctx.host_solve(D_sq, b, *grams))

    grams2 = [np.einsum("ntr,nur->ntu", g, g) for g in
              (rng.normal(size=G.shape) for G in grams)]
    assert ctx.factor_values(ctx.assemble(grams2), D_sq)
    assert ctx.chol._Ai.size == ctx.nnz


def test_breakdown_gives_a_nan_step():
    """A factorization that breaks down (here J^T J = 0 and D = 0) gives
    a NaN step, which the trust-region loop rejects; a later damped solve
    factors again."""
    problem = _graph(ctt, "2d-80")[0]
    opts = _options(ctt, linear_solver_type="SPARSE_NORMAL_CHOLESKY")
    solver = SparseNormalCholeskySolver(TorchProgram(problem, device="cpu"),
                                        opts)
    n = solver.ctx.n
    system = SparseNormalSystem(np.zeros(solver.ctx.nnz), np.ones(n))
    d = solver.solve(system, torch.zeros(n, dtype=torch.float64))
    assert d.dtype == torch.float64 and torch.isnan(d).all()
    d = solver.solve(system, torch.full((n,), 2.0, dtype=torch.float64))
    assert torch.equal(d, torch.full((n,), 0.25, dtype=torch.float64))


@pytest.mark.parametrize("name", ["2d-40", "3d-30", "2d-120", "3d-300"])
def test_sparse_normal_cholesky_solve_matches_jax(name):
    """SPARSE_NORMAL_CHOLESKY under the default options (f64, the host
    loop), test_slam.py's configuration: the JAX package's LM count and
    final cost within 1e-10; past 200 effective parameters the step runs
    the native LDL^T."""
    kw = dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
              max_num_iterations=100)
    s_j, s_t, (problem, _, _) = _solve_both(name, **kw)
    _hold(s_j, s_t, 1e-10)
    step = _step(problem, _options(ctt, **kw))
    native_path = s_t.num_effective_parameters_reduced >= 200
    assert (step.linear.sparse is not None) == native_path
    assert native_path == (name in ("2d-120", "3d-300"))


@pytest.mark.parametrize("strategy", ["LEVENBERG_MARQUARDT", "DOGLEG"])
def test_past_the_cap_runs_native_never_dense(strategy, monkeypatch):
    """An 80-pose SE2 graph (240 effective parameters) with LM and with
    dogleg: the native path, never the dense factorization, and the JAX
    package's LM count and final cost."""
    def no_dense(*args, **kwargs):
        raise AssertionError("dense factorization on the sparse path")

    monkeypatch.setattr(torch_solver, "solve_dense_normal_cholesky",
                        no_dense)
    assert torch_solver.generic_unsupported_reason(
        TorchProgram(_graph(ctt, "2d-80")[0], device="cpu"),
        _options(ctt, linear_solver_type="SPARSE_NORMAL_CHOLESKY")) is None
    s_j, s_t, _ = _solve_both(
        "2d-80", linear_solver_type="SPARSE_NORMAL_CHOLESKY",
        trust_region_strategy_type=strategy, max_num_iterations=50)
    _hold(s_j, s_t, 1e-10)


def test_dynamic_sparsity_matches_static():
    """tests/test_native.py's 120-pose case: dynamic_sparsity (the host
    loop) ends at the static path's cost within 1e-8, and at the JAX
    package's dynamic solve's within 1e-10."""
    kw = dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
              max_num_iterations=50)
    static = ctt.solve(_options(ctt, **kw), _graph(ctt, "2d-120")[0])
    s_j, s_t, _ = _solve_both("2d-120", dynamic_sparsity=True, **kw)
    _hold(s_j, s_t, 1e-10)
    assert abs(s_t.final_cost - static.final_cost) <= \
        1e-8 * static.final_cost


def _chain(mod, n=120):
    """A chain of n 2-D points (2 (n - 1) effective parameters, past the
    cap), the first held constant: tests/test_native.py's ordering case
    at a size that takes the native path."""
    rng = np.random.default_rng(3)
    xs = [np.array([float(i), 0.0]) for i in range(n)]
    problem = mod.Problem()
    stack = np.stack if mod is ct else torch.stack
    for i in range(n - 1):
        obs = float(i) + rng.normal(0, 0.01)

        def rel(a, b, o=obs):
            return stack([(b[0] - a[0]) - o, (b[1] - a[1]) - o])

        problem.add_residual_block(mod.AutoDiffCostFunction(rel, 2, [2, 2]),
                                   None, xs[i], xs[i + 1])
    problem.set_parameter_block_constant(xs[0])
    return problem, xs


def test_ordering_knob():
    """linear_solver_ordering_type: NATURAL the identity, AMD and NESDIS
    the native AUTO ordering; NATURAL and AMD give the same x at 1e-10."""
    for ot, want in (("NATURAL", native.SparseCholesky.ORDER_NATURAL),
                     ("AMD", native.SparseCholesky.ORDER_AUTO),
                     ("NESDIS", native.SparseCholesky.ORDER_AUTO)):
        assert _native_ordering(_options(
            ctt, linear_solver_ordering_type=ot)) == want
    results = []
    for ot in ("NATURAL", "AMD"):
        problem, xs = _chain(ctt)
        opts = _options(ctt, linear_solver_type="SPARSE_NORMAL_CHOLESKY",
                        linear_solver_ordering_type=ot,
                        max_num_iterations=20)
        s = ctt.solve(opts, problem)
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert _step(problem, opts).linear.sparse is not None
        results.append(np.concatenate(xs))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-10)


def test_subset_preconditioner_matches_jax():
    """CGNR + SUBSET with the odometry rows (the first 59 residual blocks)
    on tests/test_native.py's 60-pose graph, f64: the JAX package's LM
    count and final cost within 1e-8."""
    pj = _graph(ct, "2d-60")[0]
    problem = _graph(ctt, "2d-60")[0]
    kw = dict(linear_solver_type="CGNR", preconditioner_type="SUBSET",
              max_num_iterations=60)
    s_j = ct.solve(_options(
        ct, residual_blocks_for_subset_preconditioner=pj.residual_blocks()
        [:59], **kw), pj)
    opts = _options(
        ctt, residual_blocks_for_subset_preconditioner=problem
        .residual_blocks()[:59], **kw)
    s_t = ctt.solve(opts, problem)
    _hold(s_j, s_t, 1e-8)
    assert _step(problem, opts).linear.subset is not None


@pytest.mark.parametrize("strategy", ["LEVENBERG_MARQUARDT", "DOGLEG"])
def test_subset_without_rows_raises(strategy):
    with pytest.raises(ValueError, match="residual_blocks_for_subset"):
        ctt.solve(_options(ctt, linear_solver_type="CGNR",
                           preconditioner_type="SUBSET",
                           trust_region_strategy_type=strategy),
                  _graph(ctt, "2d-40")[0])


def test_mixed_sparse_normal_cholesky_matches_jax():
    """The mixed fused configuration (chip_smoke.py's pose-graph options
    with SPARSE_NORMAL_CHOLESKY) on the 300-pose SE3 graph: the Grams from
    K9's per-row form (its plain version here), within 1e-5 of the JAX
    package's mixed cost."""
    s_j = ct.solve(pose_graph_options(
        ct, linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY),
        _graph(ct, "3d-300")[0])
    s_t = ctt.solve(pose_graph_options(
        ctt, linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        device="cpu"), _graph(ctt, "3d-300")[0])
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost


def test_grams_per_row_and_block_diag_f64_bits():
    """bucket_grams: K9's per-row form on an f32 Jacobian (its plain
    version here), row_grams' einsum on an f64 one; the f64 block
    diagonal of J^T J is group_grams, K9's plain group form, on every
    device."""
    problem = _graph(ctt, "3d-30")[0]
    tp = TorchProgram(problem, device="cpu")
    x = tp.initial_state()
    jac32 = tp.linearize_fn_mixed(x)[2]
    for G, b in zip(bucket_grams(jac32), jac32.buckets):
        assert torch.equal(G, bucket_gram_blocks_plain(b.J))
        assert torch.equal(G, bucket_gram_blocks(b.J))
    jac64 = tp.linearize_fn(x)[2]
    lanes = [np.arange(0, b.J.shape[0], 2) for b in jac64.buckets]
    for G, b, ln in zip(bucket_grams(jac64, lanes), jac64.buckets, lanes):
        assert G.dtype == torch.float64
        assert torch.equal(G, torch.einsum("nrt,nru->ntu", b.J[ln], b.J[ln]))
    for g, got in zip(tp.groups, bsr.block_diag_jtj(jac64, tp.groups)):
        views = [jac64.buckets[bi].slot_J(si)
                 for (bi, si, _) in g.bucket_slots]
        want = group_gram_blocks_plain(views, *g.gram_order(x.device))
        assert torch.equal(got, want)


def test_identity_order_is_made_once():
    """The per-row form's order (block n = row n of one view) is made once
    per row count and device, and each later call reuses it."""
    cpu = torch.device("cpu")
    gram_map, gram_off = _identity_order(5, cpu)
    assert torch.equal(gram_map, torch.tensor([[0, n] for n in range(5)],
                                              dtype=torch.int32))
    assert torch.equal(gram_off, torch.arange(6, dtype=torch.int32))
    again = _identity_order(5, cpu)
    assert again[0] is gram_map and again[1] is gram_off
