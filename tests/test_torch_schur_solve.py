"""Whole solves through the generic Schur route of ceres_tpu_torch
(solver.py GenericLMStep / DoglegStep over solvers/schur.py
SchurLinearSolver) against ceres_tpu on the CPU.

The JAX package runs on its generic Schur route
(CERES_TPU_NO_FUSED_SCHUR, and CERES_TPU_FORCE_SPARSE_SCHUR where the
port lowers SPARSE_SCHUR_DENSE_NF): the route the port takes for every
case here. Cases: DENSE_SCHUR, SPARSE_SCHUR (block-sparse), and
ITERATIVE_SCHUR with IDENTITY, JACOBI, SCHUR_JACOBI and
SCHUR_POWER_SERIES_EXPANSION, in f64; bounds that bind; quaternion
cameras on the quaternion x Euclidean(6) product manifold (f64 and
mixed); two buckets (HuberLoss and plain) with DENSE and ITERATIVE;
TRADITIONAL and SUBSPACE dogleg; mixed refinement; the SPSE warm start;
use_explicit_schur_complement; the fused loop over the generic step.
Gates: f64 and mixed refinement (its steps are of f64 quality), the same
LM count and the final cost within 1e-9 relative; mixed, the final cost
within 1e-5 (the counts printed). The refinement is also held on its own
steps: each refinement iteration lowers the f64 residual of the damped
normal equations, to 1e-12 of the right-hand side after two.
"""

import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, enum_options, jax_build,
                              jax_generic_schur, schur_bal, schur_problem,
                              synthetic_bal_problem, torch_build)

from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import GenericLMStep
from ceres_tpu_torch.solvers import schur_sparse


def _plain(mod, bal):
    build = jax_build if mod is ct else torch_build
    return build(bal)


def _quaternion_bal():
    bal = synthetic_bal_problem(num_cameras=6, num_points=80,
                                num_observations=400, seed=3,
                                pixel_noise=1.0).to_quaternions()
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


def _quaternion(mod, bal):
    build = jax_build if mod is ct else torch_build
    return build(bal, use_quaternions=True, use_manifolds=True)


def _two_buckets(mod, bal):
    return schur_problem(mod, bal, prior=False, constant_camera=False,
                         heavy_point=False)


BOX = 2e-3


def _bounded(mod, bal):
    """Each point's x within BOX of its start: the perturbation (0.05)
    moves the optimum past most of these bounds."""
    problem, cams, pts = _plain(mod, bal)
    for p in pts:
        problem.set_parameter_lower_bound(p, 0, p[0] - BOX)
        problem.set_parameter_upper_bound(p, 0, p[0] + BOX)
    return problem, cams, pts


CASES = {
    "dense": (_plain, dict(linear_solver_type="DENSE_SCHUR")),
    "sparse": (_plain, dict(linear_solver_type="SPARSE_SCHUR")),
    "iterative_identity": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="IDENTITY")),
    "iterative_jacobi": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="JACOBI")),
    "iterative_schur_jacobi": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_JACOBI")),
    "iterative_power_series": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_POWER_SERIES_EXPANSION")),
    "bounds": (_bounded, dict(linear_solver_type="DENSE_SCHUR")),
    "quaternion_manifold": (_quaternion, dict(
        linear_solver_type="DENSE_SCHUR")),
    "quaternion_manifold_mixed": (_quaternion, dict(
        linear_solver_type="DENSE_SCHUR", use_mixed_precision_solves=True)),
    "two_buckets_dense": (_two_buckets, dict(
        linear_solver_type="DENSE_SCHUR")),
    "two_buckets_iterative": (_two_buckets, dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_JACOBI")),
    "traditional_dogleg": (_plain, dict(
        linear_solver_type="DENSE_SCHUR",
        trust_region_strategy_type="DOGLEG")),
    "subspace_dogleg": (_plain, dict(
        linear_solver_type="DENSE_SCHUR",
        trust_region_strategy_type="DOGLEG", dogleg_type="SUBSPACE_DOGLEG")),
    "mixed_refinement": (_plain, dict(
        linear_solver_type="DENSE_SCHUR", use_mixed_precision_solves=True,
        max_num_refinement_iterations=2)),
    "spse": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR",
        preconditioner_type="SCHUR_JACOBI", use_spse_initialization=True)),
    "explicit_schur_complement": (_plain, dict(
        linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="JACOBI",
        use_explicit_schur_complement=True)),
    "fused_loop": (_plain, dict(linear_solver_type="DENSE_SCHUR",
                                fused_iterations=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generic_schur_solve_matches_jax(case, monkeypatch):
    build, kw = CASES[case]
    kw = dict(kw, max_num_iterations=50)
    sparse = kw["linear_solver_type"] == "SPARSE_SCHUR"
    if sparse:
        monkeypatch.setattr(schur_sparse, "SPARSE_SCHUR_DENSE_NF", 0)
    bal = _quaternion_bal() if build is _quaternion else schur_bal()
    with jax_generic_schur(sparse=sparse):
        s_j = ct.solve(enum_options(ct, **kw), build(ct, bal)[0])
    problem, cams, pts = build(ctt, bal)
    s_t = ctt.solve(enum_options(ctt, **kw), problem)
    print(f"{case}: LM {s_t.num_iterations} (JAX {s_j.num_iterations}), "
          f"linear {s_t.num_linear_solver_iterations} (JAX "
          f"{s_j.num_linear_solver_iterations}), final cost "
          f"{s_t.final_cost!r} (JAX {s_j.final_cost!r})")
    assert "Schur step: generic" in s_t.message
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    if (kw.get("use_mixed_precision_solves")
            and not kw.get("max_num_refinement_iterations")):
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost
    else:
        assert s_t.num_iterations == s_j.num_iterations
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
    if build is _bounded:
        x = np.array([p[0] for p in pts])
        x0 = np.array([p[0] for p in _plain(ctt, bal)[2]])
        assert s_t.is_constrained
        assert np.all(np.abs(x - x0) <= BOX + 1e-12)
        assert np.sum(np.abs(np.abs(x - x0) - BOX) < 1e-12) >= 10


@pytest.mark.parametrize("radius", [1e4, 1e1])
def test_refinement_lowers_the_f64_residual(radius):
    """GenericLMStep._refine on a mixed DENSE_SCHUR step: the f64
    residual ||b - (J_s^T J_s + D^2) d|| / ||b|| of the f32 step (about
    2e-7 here) falls with each refinement iteration, below 1e-12 after
    two."""
    problem = torch_build(schur_bal())[0]
    opts = enum_options(ctt, linear_solver_type="DENSE_SCHUR",
                        use_mixed_precision_solves=True,
                        max_num_refinement_iterations=1)
    program = TorchProgram(problem, device="cpu")
    step = GenericLMStep(program, opts)
    art = step.linearize(program.initial_state(), None, True)
    jac64, b64 = art.refine
    D = torch.sqrt(art.diag / radius)
    d32 = step.linear(art.jac_s, art.res, D, art.blocks)[0]
    assert d32.dtype == torch.float32
    residuals = []
    for refine in range(3):
        step.refine = refine
        d = (step._refine(art, D, d32, 0)[0] if refine else d32).double()
        D64 = D.double()
        r = b64 - jac64.rmatvec(jac64.matvec(d)) - D64 * D64 * d
        residuals.append(float(torch.linalg.vector_norm(r)
                               / torch.linalg.vector_norm(b64)))
    print(f"radius {radius}: relative residuals {residuals}")
    assert residuals[0] > 1e-9
    assert residuals[0] > residuals[1] > residuals[2]
    assert residuals[2] <= 1e-12
