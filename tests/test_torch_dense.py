"""The dense linear solvers of ceres_tpu_torch (solvers/dense.py) and the
dense forms of the bucketed Jacobian (ops/bsr.py to_dense, jtj_dense)
against ceres_tpu's, on the f64 linearization of one seeded problem built
in both packages (a 2-D pose graph of 30 poses: two buckets, the angle
manifold) at its start, with a seeded damping D.

Tolerances: to_dense, jtj_dense and the f64 solves 1e-12 relative to the
largest entry (the two packages' f64 Jacobians differ in their last bits,
jacfwd of the same functor by two libraries; the factorizations are
different libraries' too); the mixed dense normal Cholesky
(an f32 factor, f64 refinement) 1e-9 after three refinements, 1e-5 after
one, each well above the f32 factor's own spread and below what one
refinement leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, rel

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.ops.bsr import RVec as JaxRVec
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import dense as jax_dense
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import dense

GRAPH = dict(num_poses=30, seed=6)


@pytest.fixture(scope="module")
def lin():
    """Both packages' f64 linearizations at the start and a seeded D."""
    out = {}
    for mod, pkg_slam, pkg_g2o in ((ct, jax_slam, jax_g2o),
                                   (ctt, slam, g2o)):
        poses, edges, _ = pkg_g2o.synthetic_pose_graph_2d(**GRAPH)
        problem = pkg_slam.build_pose_graph_2d_problem(poses, edges)[0]
        if mod is ct:
            prog = JaxProgram(problem)
            out["jax"] = prog.linearize_fn(prog.initial_state())
        else:
            prog = TorchProgram(problem, device="cpu")
            out["torch"] = prog.linearize_fn(prog.initial_state())
    n = out["torch"][2].num_cols
    out["D"] = np.random.default_rng(5).uniform(0.1, 2.0, n)
    return out


def test_to_dense_and_jtj_dense_match_jax(lin):
    jac_j, jac_t = lin["jax"][2], lin["torch"][2]
    A_j = np.asarray(jac_j.to_dense())
    A_t = jac_t.to_dense().numpy()
    assert len(jac_t.buckets) == 2
    assert A_t.shape == A_j.shape and np.array_equal(A_t == 0, A_j == 0)
    assert rel(A_t, A_j) <= 1e-12
    assert rel(jac_t.jtj_dense().numpy(), np.asarray(jac_j.jtj_dense())) \
        <= 1e-12
    assert np.array_equal(lin["torch"][3].flatten().numpy(),
                          np.asarray(JaxRVec(lin["jax"][3].parts).flatten()))


def test_dense_qr_matches_jax(lin):
    D = lin["D"]
    d_j, _ = jax_dense.solve_dense_qr(lin["jax"][2], lin["jax"][3],
                                      jnp.asarray(D))
    d_t, it = dense.solve_dense_qr(lin["torch"][2], lin["torch"][3],
                                   torch.as_tensor(D))
    assert int(it) == 1 and d_t.dtype == torch.float64
    assert rel(d_t.numpy(), np.asarray(d_j)) <= 1e-12


@pytest.mark.parametrize("mixed,refine,tol", [
    (False, 0, 1e-12), (True, 1, 1e-5), (True, 3, 1e-9)],
    ids=["f64", "mixed-refine-1", "mixed-refine-3"])
def test_dense_normal_cholesky_matches_jax(lin, mixed, refine, tol):
    D = lin["D"]
    d_j, _ = jax_dense.solve_dense_normal_cholesky(
        lin["jax"][2], lin["jax"][3], jnp.asarray(D),
        mixed_precision=mixed, refinement_iterations=refine)
    d_t, _ = dense.solve_dense_normal_cholesky(
        lin["torch"][2], lin["torch"][3], torch.as_tensor(D),
        mixed_precision=mixed, refinement_iterations=refine)
    assert d_t.dtype == torch.float64
    assert rel(d_t.numpy(), np.asarray(d_j)) <= tol
    # and it solves the damped normal equations to that accuracy
    A = lin["torch"][2].to_dense().numpy()
    r = lin["torch"][3].flatten().numpy()
    exact = np.linalg.solve(A.T @ A + np.diag(D * D), -A.T @ r)
    assert rel(d_t.numpy(), exact) <= tol


def test_not_positive_definite_gives_nan():
    """A factorization that fails gives NaN (the step is then invalid), as
    the JAX package's does; nothing raises."""
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    L = dense._cholesky(H)
    assert torch.isnan(L).all()
