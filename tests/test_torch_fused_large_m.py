"""The fused explicit Schur step past m = 1,024 camera columns (bench.py's
options on Trafalgar-, Ladybug- and Dubrovnik-class problems) against the
JAX package's fused step on the CPU, which takes XLA's cho_factor and its
XLA CG loop there (ceres_tpu/solvers/schur_fused.py:221-234, :868-881).

The problem: torch_parity_kit.large_m_bal, 130 cameras (nf = 1,170),
1,000 points seen by twelve cameras each, perturbed. DENSE_SCHUR keeps
the JAX package's LM count and its final cost within 1e-5 relative;
ITERATIVE_SCHUR with IDENTITY its final cost within 1e-5, its counts
reported (they move with f32 summation order, ROADMAP.md section 3).
SCHUR_JACOBI is
tests/test_torch_iterative.py::test_out_of_slice_raises[m_over_1024].
"""

import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, large_m_bal,
                              main_path_options, torch_problem)

from ceres_tpu_torch.ops.kernels import MAX_M, chol_solve
from ceres_tpu_torch.ops.pcg import dense_pcg
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import takes_fused_schur_step
from ceres_tpu_torch.solvers.dense import cholesky_solve
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

REL_TOL = 1e-5


def large_m_options(mod, solver, preconditioner="SCHUR_JACOBI"):
    """bench.py's options with `solver` and `preconditioner` by name."""
    return main_path_options(
        mod, linear_solver_type=getattr(mod.LinearSolverType, solver),
        preconditioner_type=getattr(mod.PreconditionerType, preconditioner))


CASES = [("DENSE_SCHUR", "SCHUR_JACOBI"), ("ITERATIVE_SCHUR", "IDENTITY")]


@pytest.mark.parametrize("solver, preconditioner", CASES)
def test_solve_matches_jax_fused_step(solver, preconditioner):
    """ctt.solve at nf 1,170 on the fused route, its reduced solve the
    library Cholesky or solvers/cg.py (named in the message, no K3 or K7
    launch), against ct.solve's fused step."""
    s_j = ct.solve(large_m_options(ct, solver, preconditioner),
                   jax_problem(large_m_bal()))
    problem = torch_problem(large_m_bal())
    opts = large_m_options(ctt, solver, preconditioner)
    assert takes_fused_schur_step(TorchProgram(problem, device="cpu"), opts)
    chol_solve.launches = dense_pcg.launches = 0
    s_t = ctt.solve(opts, problem)
    assert chol_solve.launches == dense_pcg.launches == 0
    route = ("CG on the explicit S" if solver == "ITERATIVE_SCHUR"
             else "library Cholesky")
    assert f"reduced solve: {route}" in s_t.message
    assert "m = 1170" in s_t.message
    print(f"{solver} + {preconditioner}: JAX {s_j.num_iterations} LM / "
          f"{s_j.num_linear_solver_iterations} linear, port "
          f"{s_t.num_iterations} / {s_t.num_linear_solver_iterations}")
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_j.termination_type) == "CONVERGENCE"
    if solver == "DENSE_SCHUR":
        assert s_t.num_iterations == s_j.num_iterations
        assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= REL_TOL * s_j.final_cost


@pytest.fixture(scope="module")
def steps():
    """The port's fused steps at nf 1,170 and at nf 1,017 (<= MAX_M),
    DENSE and ITERATIVE, with the large problem's first linearization."""
    out = {}
    for cams in (130, 113):
        problem = torch_problem(large_m_bal(cams))
        program = TorchProgram(problem, device="cpu")
        for solver in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
            opts = large_m_options(ctt, solver)
            out[cams, solver] = FusedSchurStep(
                program, opts, detect_schur_structure(program, opts))
    return out


@pytest.mark.parametrize("cams, solver, route", [
    (130, "DENSE_SCHUR", "library Cholesky (torch.linalg.cholesky_ex)"),
    (130, "ITERATIVE_SCHUR", "CG on the explicit S (solvers/cg.py)"),
    (113, "DENSE_SCHUR", "K3 chol_solve"),
    (113, "ITERATIVE_SCHUR", "K7 dense_pcg")])
def test_route_is_chosen_from_m_at_step_build(steps, cams, solver, route):
    """The reduced solve is fixed when the step is built, from nf alone:
    the one-block kernels up to MAX_M, the library routes past it."""
    step = steps[cams, solver]
    assert step.library == (step.nf > MAX_M)
    assert step.mode.endswith(f"reduced solve: {route}, m = {step.nf}")


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_indefinite_reduced_system_gives_nan_step(steps, solver):
    """A negative radius makes S indefinite past MAX_M: the library
    Cholesky's step is NaN (the LM loop's invalid-step retry relies on it,
    as on K3's), and CG stops on its indefiniteness guard. At a positive
    radius both steps are finite and agree with an f64 solve of the same
    reduced system."""
    step = steps[130, solver]
    x0 = step.program.initial_state()
    s_e, s_f = step.initial_scales()
    art = step.linearize(x0, s_e, s_f, first=True)
    bad = step.solve(art, -1e-3)
    if solver == "DENSE_SCHUR":
        assert torch.isnan(bad["delta"][-step.nf:]).all()
    else:
        assert int(bad["lin_iters"]) == 1
    good = step.solve(art, 1e4)
    assert torch.isfinite(good["delta"]).all()
    S, rhs, _, _ = step.reduced_system(art, 1e4)
    y64 = torch.linalg.solve(S.double(), rhs.double())
    y = cholesky_solve(S, rhs)
    assert float((y.double() - y64).abs().max() / y64.abs().max()) < 1e-3


def test_cholesky_solve_nan_on_indefinite():
    rng = np.random.default_rng(5)
    G = rng.standard_normal((40, 60))
    S = torch.as_tensor((G @ G.T).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(40).astype(np.float32))
    y = cholesky_solve(S, b)
    assert float((S.double() @ y.double() - b.double()).abs().max()) < 1e-3
    assert torch.isnan(cholesky_solve(-S, b)).all()
