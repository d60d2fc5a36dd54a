"""The sparse paths of ceres_tpu_torch on the card (cuda-marked; they skip
without one): the mixed SPARSE_NORMAL_CHOLESKY solve of a 300-pose SE3
graph launches K11 once per linearization and K9's per-row form at least
once, ends where the CPU run (the plain versions) ends within 1e-5, and
repeats its bits; CGNR + SUBSET on a 60-pose SE2 graph ends at the CPU
run's cost within 1e-5. Run on a machine with a card:
python -m pytest tests/test_torch_sparse_cuda.py -m cuda. This file
imports no JAX.
"""

import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops.kernels import bucket_gram_blocks
from ceres_tpu_torch.ops.linearize import bucket_linearize
from chip_smoke import pose_graph_options

SNC = dict(linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY)


def _se3_300():
    return slam.build_pose_graph_3d_problem(
        *g2o.synthetic_pose_graph_3d(num_poses=300, seed=2)[:2])[0]


def _se2_60():
    return slam.build_pose_graph_2d_problem(
        *g2o.synthetic_pose_graph_2d(num_poses=60, seed=4)[:2])[0]


@pytest.mark.cuda
def test_mixed_sparse_normal_cholesky_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s_cpu = ctt.solve(pose_graph_options(ctt, device="cpu", **SNC),
                      _se3_300())
    runs = []
    for _ in range(2):
        bucket_gram_blocks.launches = bucket_linearize.launches = 0
        s = ctt.solve(pose_graph_options(ctt, device="cuda", **SNC),
                      _se3_300())
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert bucket_linearize.launches == s.num_linearizations_fused
        assert bucket_gram_blocks.launches >= s.num_linearizations_fused
        runs.append((s.num_iterations, s.final_cost))
    assert runs[0] == runs[1]
    assert abs(s.final_cost - s_cpu.final_cost) <= 1e-5 * s_cpu.final_cost


@pytest.mark.cuda
def test_subset_preconditioner_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    costs = []
    for device in ("cpu", "cuda"):
        problem = _se2_60()
        s = ctt.solve(pose_graph_options(
            ctt, device=device,
            preconditioner_type=ctt.PreconditionerType.SUBSET,
            residual_blocks_for_subset_preconditioner=problem
            .residual_blocks()[:59]), problem)
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        costs.append(s.final_cost)
    assert abs(costs[1] - costs[0]) <= 1e-5 * costs[0]
