"""Batch mode of the port's solve_batched (ceres_tpu_torch/batch.py) on
the generic route: the dense solvers in mixed precision and with
refinement, CGNR (block Jacobi, SUBSET), SPARSE_NORMAL_CHOLESKY past
SPARSE_DENSE_CAP on the native LDL^T, and TRADITIONAL and SUBSPACE
dogleg over DENSE_QR and CGNR, on tests/test_torch_batch.py's BA graph
and curve fits and a 70-pose SE2 graph (tests/torch_batch_kit.py). Each
configuration is held to the JAX package's solve_batched(batch_mode=
"batch") on the same elements and to the port's pipeline mode; and the
batched CG (solvers/cg.py conjugate_gradients_batched) to the single
loop run per element."""

import numpy as np
import pytest
import torch

import torch_batch_kit as kit
from ceres_tpu_torch import batch as batch_mod
from ceres_tpu_torch.solvers.cg import (conjugate_gradients,
                                        conjugate_gradients_batched)

# f64 elements: the JAX batched run's counts and termination, the final
# cost within 1e-9 relative and the parameters within 1e-8 (the curve
# fits stop at function tolerance 1e-12 in a flat valley, where batch
# mode's Householder QR and the JAX package's LAPACK leave them 1e-9
# apart); the same against the port's pipeline mode.
F64_COST, F64_X = 1e-9, 1e-8
# mixed elements part by f32 rounding (an LM or CG count may move by
# one): the final cost within twice the function tolerance (1e-9) of the
# other run's, every one at CONVERGENCE; the parameters are not held
# (the BA gauge leaves f32 steps free along it).
MIXED_COST = 2e-9

DL = dict(trust_region_strategy_type="DOGLEG")
SUB = dict(trust_region_strategy_type="DOGLEG",
           dogleg_type="SUBSPACE_DOGLEG")
MIXED = dict(use_mixed_precision_solves=True)

# name: (elements, options, f64)
CASES = {
    "curve_dogleg_qr": ("curve", dict(DL, linear_solver_type="DENSE_QR"),
                        True),
    "curve_subspace_qr": ("curve", dict(SUB, linear_solver_type="DENSE_QR"),
                          True),
    "curve_dogleg_cgnr": ("curve", dict(DL, linear_solver_type="CGNR"), True),
    "curve_subspace_cgnr": ("curve", dict(SUB, linear_solver_type="CGNR"),
                            True),
    "curve_dnc_refined": ("curve", dict(
        MIXED, linear_solver_type="DENSE_NORMAL_CHOLESKY",
        max_num_refinement_iterations=3), False),
    "se2_cgnr_jacobi": ("se2", dict(linear_solver_type="CGNR",
                                    preconditioner_type="JACOBI"), True),
    "se2_cgnr_mixed": ("se2", dict(MIXED, linear_solver_type="CGNR",
                                   preconditioner_type="JACOBI"), False),
    "se2_cgnr_subset": ("se2", dict(linear_solver_type="CGNR",
                                    preconditioner_type="SUBSET",
                                    subset=kit.SE2_POSES - 1), True),
    "se2_sparse_normal_cholesky": ("se2", dict(
        linear_solver_type="SPARSE_NORMAL_CHOLESKY"), True),
    "ba_cgnr_jacobi": ("ba", dict(linear_solver_type="CGNR",
                                  preconditioner_type="JACOBI"), True),
    "ba_sparse_normal_cholesky": ("ba", dict(
        linear_solver_type="SPARSE_NORMAL_CHOLESKY"), True),
    "ba_dense_qr_mixed": ("ba", dict(MIXED, linear_solver_type="DENSE_QR"),
                          False),
    "ba_dnc_refined": ("ba", dict(MIXED,
                                  linear_solver_type="DENSE_NORMAL_CHOLESKY",
                                  max_num_refinement_iterations=3), False),
}


# The JAX package's batched SUBSET applies the last element's factor to
# every element (ROADMAP.md section 3): its own single solves are the
# reference there.
JAX_SINGLE = {"se2_cgnr_subset"}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's batched run of every case (its single solves for
    JAX_SINGLE), built once."""
    return {name: (kit.jax_single_run if name in JAX_SINGLE
                   else kit.jax_run)(kind, **dict(kw))
            for name, (kind, kw, _) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_batch_mode_matches_jax_and_pipeline(name, jax_refs):
    kind, kw, f64 = CASES[name]
    ours = kit.run(kit.ctt, kind, "batch", **dict(kw))
    pipe = kit.run(kit.ctt, kind, "pipeline", **dict(kw))
    assert all(e[2] == "CONVERGENCE" for e in ours)
    if f64:
        kit.held(ours, jax_refs[name], True, F64_COST, F64_X, "jax")
        kit.held(ours, pipe, True, F64_COST, F64_X, "pipeline")
    else:
        kit.held(ours, jax_refs[name], False, MIXED_COST, None, "jax")
        kit.held(ours, pipe, False, MIXED_COST, None, "pipeline")


def test_sparse_normal_cholesky_takes_the_native_factorization():
    """SE2 at 70 poses has 207 effective parameters: batch mode's step is
    the stacked one over the native LDL^T, one factorization an element
    in element order, and its linear iteration count is the JAX
    package's 0."""
    elems = kit.elements("se2", kit.ctt)
    opts = kit.options(kit.ctt, "se2", batch_mode="batch",
                       linear_solver_type="SPARSE_NORMAL_CHOLESKY")
    from ceres_tpu_torch.program import CompiledProgram
    prog = CompiledProgram.get_cached(elems[0][0], opts)
    assert prog.num_effective >= 200
    step = batch_mod.make_batched_step(prog, opts)
    assert isinstance(step, batch_mod.BatchedBlockStep)
    assert step.linear.sparse is not None


def _spd_batch(B, n, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for b in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats.append(Q @ np.diag(np.logspace(0, 0.2 + 0.3 * b, n)) @ Q.T)
    return (torch.tensor(np.stack(mats)),
            torch.tensor(rng.standard_normal((B, n))))


def test_batched_cg_matches_per_element_and_freezes_stopped_elements():
    """Elements that stop at different iterations (past the residual
    refresh at 10): the per-element counts of the single loop, x within
    1e-12 of it; a stopped element's p (as the operator sees it) keeps
    its bits in every later iteration, and its x and ||r|| are the bits
    of a run cut at its own stop."""
    A, b = _spd_batch(4, 40, 0)
    seen = []

    def apply_A(v):
        seen.append(v.clone())
        return torch.bmm(A, v[:, :, None])[..., 0]

    args = dict(max_iterations=80, q_tolerance=1e-8)
    res = conjugate_gradients_batched(apply_A, b, torch.zeros_like(b),
                                      **args)
    singles = [conjugate_gradients(lambda v, e=e: A[e] @ v, b[e],
                                   torch.zeros_like(b[e]), **args)
               for e in range(4)]
    counts = [int(s.num_iterations) for s in singles]
    assert len(set(counts)) == 4 and max(counts) > 10
    assert res.num_iterations.tolist() == counts
    for e in range(4):
        np.testing.assert_allclose(res.x[e].numpy(), singles[e].x.numpy(),
                                   rtol=0, atol=1e-12)
    # the operator's inputs: A x0, then an iteration's p, and after every
    # tenth iteration's p the refresh's x; ps[i] is iteration i + 1's p
    ps, i, k = [], 0, 1
    while k < len(seen):
        ps.append(seen[k])
        i, k = i + 1, k + 1
        if i % 10 == 0:
            k += 1
    assert len(ps) == max(counts)
    for e, k in enumerate(counts):
        # an element that stopped at iteration k keeps its p_k, which every
        # later iteration feeds the operator
        assert all(torch.equal(p[e], ps[k][e]) for p in ps[k + 1:])
        cut = conjugate_gradients_batched(
            lambda v: torch.bmm(A, v[:, :, None])[..., 0], b,
            torch.zeros_like(b), **dict(args, max_iterations=k))
        assert torch.equal(cut.x[e], res.x[e])
        assert torch.equal(cut.final_norm[e], res.final_norm[e])
