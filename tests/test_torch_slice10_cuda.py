"""Slice 10 on the card (cuda-marked; skipped without one), with no JAX
import: the fused explicit Schur step past m = 1,024 keeps K3 and K7 out
(they still refuse m > 1,024) and runs K1, K2 or K6 and K4; a gradient
problem and a tiny_solve batch on the card against the same runs on the
CPU. The CPU parity tests with the JAX package are
tests/test_torch_fused_large_m.py, tests/test_torch_gradient_problem.py
and tests/test_torch_tiny_solver.py.
"""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.io.bal import build_bal_ceres_problem, \
    synthetic_bal_problem
from ceres_tpu_torch.ops.kernels import chol_solve
from ceres_tpu_torch.ops.lin import elim, elim_v1
from ceres_tpu_torch.ops.pcg import dense_pcg


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _large_m_problem():
    """tests/torch_parity_kit.py's large_m_bal (130 cameras, nf 1,170)."""
    bal = synthetic_bal_problem(num_cameras=130, num_points=1000,
                                num_observations=12000, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return build_bal_ceres_problem(bal)[0]


@pytest.mark.cuda
def test_cuda_kernels_refuse_m_past_1024_and_the_step_routes_around():
    """K3 and K7 still raise past MAX_M, and the fused step at nf 1,170
    runs the library routes: no K3 or K7 launch, K2 or K6 at least once
    an LM iteration."""
    _cuda_or_skip()
    S = torch.eye(1170, device="cuda")
    b = torch.ones(1170, device="cuda")
    with pytest.raises(ValueError, match="outside 1..1024"):
        chol_solve(S, b)
    with pytest.raises(ValueError, match="outside 1..1024"):
        dense_pcg(S, b, None, max_iterations=10)
    for solver, kernel in (("DENSE_SCHUR", elim),
                           ("ITERATIVE_SCHUR", elim_v1)):
        opts = ctt.SolverOptions(
            linear_solver_type=getattr(ctt.LinearSolverType, solver),
            preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=50, function_tolerance=1e-6,
            max_linear_solver_iterations=100,
            use_mixed_precision_solves=True, fused_iterations=True,
            device="cuda")
        chol_solve.launches = dense_pcg.launches = kernel.launches = 0
        s = ctt.solve(opts, _large_m_problem())
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert "m = 1170" in s.message
        assert chol_solve.launches == dense_pcg.launches == 0
        assert kernel.launches >= s.num_iterations


@pytest.mark.cuda
@pytest.mark.parametrize("solver,preconditioner", [
    ("DENSE_SCHUR", "SCHUR_JACOBI"), ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
    ("ITERATIVE_SCHUR", "IDENTITY")])
def test_cuda_large_m_solve_matches_the_cpu(solver, preconditioner):
    """The card's library Cholesky and reduced CG past MAX_M against the
    CPU's on the same problem at nf 1,170: both converge, to final costs
    within 1e-5 relative (the CPU's parity limit with the JAX package in
    tests/test_torch_fused_large_m.py)."""
    _cuda_or_skip()
    runs = []
    for device in ("cpu", "cuda"):
        opts = ctt.SolverOptions(
            linear_solver_type=getattr(ctt.LinearSolverType, solver),
            preconditioner_type=getattr(ctt.PreconditionerType,
                                        preconditioner),
            max_num_iterations=50, function_tolerance=1e-6,
            max_linear_solver_iterations=100,
            use_mixed_precision_solves=True, fused_iterations=True,
            device=device)
        runs.append(ctt.solve(opts, _large_m_problem()))
    cpu, gpu = runs
    assert cpu.termination_type == gpu.termination_type == \
        ctt.TerminationType.CONVERGENCE
    assert abs(gpu.final_cost - cpu.final_cost) <= 1e-5 * cpu.final_cost


@pytest.mark.cuda
def test_cuda_tiny_solve_takes_numpy_to_the_card():
    """A numpy x0 under the default options runs on the card, to the CPU
    run's iteration count and x within 1e-10."""
    _cuda_or_skip()
    x0 = np.array([[-1.2, 1.0], [0.5, -0.3]])

    def f(x):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])
    opts = ctt.TinySolverOptions(max_num_iterations=200)
    gpu = ctt.tiny_solve(f, x0, opts)
    cpu = ctt.tiny_solve(f, x0, opts._replace(device="cpu"))
    assert gpu.x.device.type == "cuda" and cpu.x.device.type == "cpu"
    assert torch.equal(gpu.iterations.cpu(), cpu.iterations)
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-10


class _Rosenbrock(ctt.FirstOrderFunction):
    def cost(self, x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


@pytest.mark.cuda
def test_cuda_gradient_problem_runs_on_the_card():
    """The tutorial's Rosenbrock on the card: the CPU run's counts."""
    _cuda_or_skip()
    xs = []
    runs = []
    for device in ("cpu", "cuda"):
        x = np.array([-1.2, 1.0])
        runs.append(ctt.solve_gradient_problem(ctt.SolverOptions(
            minimizer_type=ctt.MinimizerType.LINE_SEARCH,
            max_num_iterations=200, device=device),
            ctt.GradientProblem(_Rosenbrock(2)), x))
        xs.append(x)
    assert len(runs[1].iterations) == len(runs[0].iterations)
    assert np.abs(xs[1] - xs[0]).max() <= 1e-8


@pytest.mark.cuda
def test_cuda_batch_matches_the_cpu():
    """A tiny_solve batch of 4,096 seeded Rosenbrock problems on the card:
    every problem converges, to the CPU's x within 1e-10, in the CPU's
    iteration count where either takes at most 50. (The few problems
    that take more creep along the valley with a shrinking radius, and
    the card's last bits move their counts, as XLA's move the JAX
    package's: 161 of 65,536 in chip_smoke.py's batch, none of them at
    50 or fewer.)"""
    _cuda_or_skip()
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 2.0, 4096)
    x0 = np.array([-1.2, 1.0]) + 0.5 * rng.standard_normal((4096, 2))

    def f(x, a_):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), a_ - x[0]])
    opts = ctt.TinySolverOptions(max_num_iterations=200)
    cpu = ctt.tiny_solve(f, torch.tensor(x0), opts, args=(torch.tensor(a),))
    gpu = ctt.tiny_solve(f, torch.tensor(x0).cuda(), opts,
                         args=(torch.tensor(a).cuda(),))
    n_gpu, n_cpu = gpu.iterations.cpu(), cpu.iterations
    exact = (n_gpu <= 50) | (n_cpu <= 50)
    assert exact.float().mean() > 0.9
    assert torch.equal(n_gpu[exact], n_cpu[exact])
    assert bool(gpu.converged.all()) and bool(cpu.converged.all())
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-10
