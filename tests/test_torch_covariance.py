"""Covariance of ceres_tpu_torch (covariance.py) against ceres_tpu's on
the CPU: the cases of tests/test_aux_components.py (the linear Gaussian
problem, the rank-deficiency policies, a quaternion block's tangent and
ambient covariance, null_space_rank, constant blocks) and of
tests/test_fused_schur.py (the BA problem's DENSE_SVD blocks, the batch
API), with the JAX package's blocks at 1e-10; the scalable SPARSE_QR path
(native LDL^T) on a pose graph past 2,000 effective parameters against
the JAX package's and against DENSE_SVD, and its rank policy on the graph
with its gauge freed; apply_loss_function. The Schur-structure branch of
the scalable path (SchurOps) is not ported: it raises naming ROADMAP.md
item 18.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt

from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_bal_problem
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_bal_problem

torch.set_num_threads(1)

ALGORITHMS = ["DENSE_SVD", "SPARSE_QR"]


def _xp(mod):
    return jnp if mod is ct else torch


def _arr(mod, a):
    a = np.asarray(a, dtype=np.float64)
    return jnp.asarray(a) if mod is ct else torch.as_tensor(a)


def _cov(mod, algorithm="DENSE_SVD", **kw):
    kw["algorithm_type"] = getattr(mod.CovarianceAlgorithmType, algorithm)
    if mod is ctt:
        kw["device"] = "cpu"
    return mod.Covariance(mod.CovarianceOptions(**kw))


def _blocks_match(cj, c_t, pairs_j, pairs_t, ambient=True, rtol=1e-10):
    for (aj, bj), (at, bt) in zip(pairs_j, pairs_t):
        for get in (["get_covariance_block"] if ambient else []) + [
                "get_covariance_block_in_tangent_space"]:
            want = np.asarray(getattr(cj, get)(aj, bj))
            got = getattr(c_t, get)(at, bt)
            assert got.shape == want.shape
            scale = max(np.abs(want).max(), 1e-300)
            assert np.abs(got - want).max() <= rtol * scale, get


def linear_gaussian_problem(mod):
    """r_i = A_i x - b_i (tests/test_aux_components.py:15)."""
    rng = np.random.default_rng(5)
    x = np.zeros(3)
    problem = mod.Problem()
    As = []

    class Lin:
        def __init__(self, A, b):
            self.A, self.b = _arr(mod, A), _arr(mod, b)

        def __call__(self, x):
            return self.A @ x - self.b

    for _ in range(10):
        A, b = rng.normal(size=(2, 3)), rng.normal(size=2)
        As.append(A)
        problem.add_residual_block(mod.AutoDiffCostFunction(Lin(A, b), 2,
                                                            [3]), None, x)
    J = np.concatenate(As, axis=0)
    return problem, x, np.linalg.inv(J.T @ J)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_covariance_linear(algorithm):
    pj, xj, expected = linear_gaussian_problem(ct)
    pt, xt, _ = linear_gaussian_problem(ctt)
    cj, c_t = _cov(ct, algorithm), _cov(ctt, algorithm)
    assert cj.compute([(xj, xj)], pj) and c_t.compute([(xt, xt)], pt)
    np.testing.assert_allclose(c_t.get_covariance_block(xt, xt), expected,
                               rtol=1e-8)
    _blocks_match(cj, c_t, [(xj, xj)], [(xt, xt)])


def _rank1(mod, size, rows):
    """A rank-1 Jacobian: rows multiples of the sum of the block."""
    x = np.zeros(size)
    xp = _xp(mod)

    def f(v):
        s = sum(v[i] for i in range(size))
        return xp.stack([float(k + 1) * s for k in range(rows)])

    problem = mod.Problem()
    problem.add_residual_block(mod.AutoDiffCostFunction(f, rows, [size]),
                               None, x)
    return problem, x


@pytest.mark.parametrize("null_space_rank,ok", [(0, False), (-1, True),
                                                (1, True), (99, True)])
def test_rank_deficient_policy(null_space_rank, ok):
    """tests/test_aux_components.py:52 and :260 on the 2 x 2 rank-1
    Jacobian: the strict policy fails, automatic truncation (-1) and
    dropping the null direction (1) succeed with the JAX package's
    pseudo-inverse, dropping everything (99) gives zeros."""
    pj, xj = _rank1(ct, 2, 2)
    pt, xt = _rank1(ctt, 2, 2)
    cj = _cov(ct, null_space_rank=null_space_rank)
    c_t = _cov(ctt, null_space_rank=null_space_rank)
    assert cj.compute([(xj, xj)], pj) == ok
    assert c_t.compute([(xt, xt)], pt) == ok
    if not ok:
        assert "Rank deficient" in c_t.message
        return
    _blocks_match(cj, c_t, [(xj, xj)], [(xt, xt)])
    if null_space_rank == 99:
        np.testing.assert_allclose(c_t.get_covariance_block(xt, xt), 0.0)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_kept_value_below_threshold_fails(algorithm):
    """tests/test_aux_components.py:283: a 4 x 3 rank-1 Jacobian with
    null_space_rank 1 keeps a value below the threshold and fails; QR
    fails on any rank deficiency."""
    pt, xt = _rank1(ctt, 3, 4)
    c_t = _cov(ctt, algorithm, null_space_rank=1)
    assert not c_t.compute([(xt, xt)], pt)
    assert "Rank deficient" in c_t.message


def _quaternion_problem(mod):
    """tests/test_aux_components.py:73: two observed directions give a
    full-rank 3-column tangent Jacobian."""
    q = np.array([1.0, 0.0, 0.0, 0.0])
    xp = _xp(mod)
    rot = mod.rotation

    def f(qq):
        r1 = rot.unit_quaternion_rotate_point(
            qq, _arr(mod, [1.0, 0.0, 0.0])) - _arr(mod, [0.0, 1.0, 0.0])
        r2 = rot.unit_quaternion_rotate_point(
            qq, _arr(mod, [0.0, 1.0, 0.0])) - _arr(mod, [0.0, 0.0, 1.0])
        return xp.concatenate([r1, r2])

    problem = mod.Problem()
    problem.add_residual_block(mod.AutoDiffCostFunction(f, 6, [4]), None, q)
    problem.set_manifold(q, mod.QuaternionManifold())
    return problem, q


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_covariance_with_manifold_tangent_space(algorithm):
    pj, qj = _quaternion_problem(ct)
    pt, qt = _quaternion_problem(ctt)
    cj, c_t = _cov(ct, algorithm), _cov(ctt, algorithm)
    assert cj.compute([(qj, qj)], pj) and c_t.compute([(qt, qt)], pt)
    assert c_t.get_covariance_block_in_tangent_space(qt, qt).shape == (3, 3)
    assert c_t.get_covariance_block(qt, qt).shape == (4, 4)
    _blocks_match(cj, c_t, [(qj, qj)], [(qt, qt)])


def test_constant_block_is_zero():
    """tests/test_aux_components.py:311: pairs touching a constant block
    are zero blocks of full shape."""
    out = []
    for mod in (ct, ctt):
        problem, x, _ = linear_gaussian_problem(mod)
        z = np.array([1.0, 2.0])
        xp = _xp(mod)

        def h(a, b):
            return xp.stack([a[0] - b[0], a[1] - b[1] + b[2]])

        problem.add_residual_block(mod.AutoDiffCostFunction(h, 2, [2, 3]),
                                   None, z, x)
        problem.set_parameter_block_constant(z)
        cov = _cov(mod)
        assert cov.compute([(x, x), (z, x), (z, z)], problem), cov.message
        out.append((cov, x, z))
    (cj, xj, zj), (c_t, xt, zt) = out
    np.testing.assert_allclose(c_t.get_covariance_block(zt, xt), 0.0)
    assert c_t.get_covariance_block(zt, zt).shape == (2, 2)
    np.testing.assert_allclose(c_t.get_covariance_block(zt, zt), 0.0)
    _blocks_match(cj, c_t, [(xj, xj)], [(xt, xt)])


def test_covariance_matrix_batch_api():
    """tests/test_fused_schur.py:323: GetCovarianceMatrix and
    GetCovarianceMatrixInTangentSpace (covariance.h:441, :458)."""
    out = []
    for mod in (ct, ctt):
        rng = np.random.default_rng(0)
        a, b = rng.standard_normal(2), rng.standard_normal(3)
        xp = _xp(mod)

        def r(a, b):
            return xp.concatenate([a * 2.0 - b[:2], b * 1.5]) \
                + 0.1 * xp.concatenate([a, b]) ** 2

        problem = mod.Problem()
        problem.add_residual_block(mod.AutoDiffCostFunction(r, 5, [2, 3]),
                                   None, a, b)
        cov = _cov(mod)
        assert cov.compute([(a, a), (a, b), (b, b)], problem), cov.message
        out.append((cov.get_covariance_matrix_in_tangent_space([a, b]),
                    cov.get_covariance_matrix([a, b])))
    for want, got in zip(*out):
        assert got.shape == (5, 5)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(out[1][0], out[1][0].T, atol=1e-12)


def _bal(mod, gauge, **shape):
    shape = shape or dict(num_cameras=6, num_points=800,
                          num_observations=4000)
    bal = synthetic_bal_problem(**shape, seed=11, pixel_noise=0.5)
    problem, cams, pts = (jax_bal_problem if mod is ct
                          else torch_bal_problem)(bal)
    if gauge:
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(pts[0])
    return problem, cams, pts


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_bundle_adjustment_blocks(algorithm):
    """tests/test_fused_schur.py:287, its non-Schur part (the DENSE_SVD
    ground truth), on a smaller gauge-fixed BA problem (6 cameras, 300
    points; 942 effective parameters, so SPARSE_QR is the dense QR): the
    JAX package's blocks at 1e-10."""
    shape = dict(num_cameras=6, num_points=300, num_observations=1500)
    pj, cj_, pj_ = _bal(ct, True, **shape)
    pt, ct_, pt_ = _bal(ctt, True, **shape)
    pairs_j = [(cj_[1], cj_[1]), (cj_[1], cj_[2]), (pj_[5], pj_[5]),
               (cj_[3], pj_[7])]
    pairs_t = [(ct_[1], ct_[1]), (ct_[1], ct_[2]), (pt_[5], pt_[5]),
               (ct_[3], pt_[7])]
    cj, c_t = _cov(ct, algorithm), _cov(ctt, algorithm)
    assert cj.compute(pairs_j, pj) and c_t.compute(pairs_t, pt)
    _blocks_match(cj, c_t, pairs_j, pairs_t, ambient=False)


@pytest.mark.parametrize("gauge", [True, False])
def test_schur_branch_raises(gauge):
    """tests/test_fused_schur.py:287 (gauge fixed) and :854 (free gauge):
    on BA past 2,000 effective parameters SPARSE_QR takes the Schur
    branch of the scalable path, which raised naming item 18 until this
    slice (the cases keep their ids). With the gauge held, camera and
    point blocks, the camera-point cross block and a pair with the
    constant camera match the JAX package's Schur branch within 1e-8
    relative to each block's largest entry (both f64; S's Cholesky and
    the batched solves differ in summation order); with the gauge free,
    both fail on the rank policy with the JAX package's message."""
    pj, cj_, pj_ = _bal(ct, gauge)
    pt, ct_, pt_ = _bal(ctt, gauge)
    pairs_j = [(cj_[1], cj_[1]), (cj_[1], cj_[2]), (cj_[3], pj_[7]),
               (pj_[5], pj_[5]), (cj_[0], cj_[4])]
    pairs_t = [(ct_[1], ct_[1]), (ct_[1], ct_[2]), (ct_[3], pt_[7]),
               (pt_[5], pt_[5]), (ct_[0], ct_[4])]
    cj, c_t = _cov(ct, "SPARSE_QR"), _cov(ctt, "SPARSE_QR")
    ok_j, ok_t = cj.compute(pairs_j, pj), c_t.compute(pairs_t, pt)
    assert ok_t == ok_j == gauge
    if not gauge:
        assert c_t.message == cj.message
        assert "Schur covariance path" in c_t.message
        return
    _blocks_match(cj, c_t, pairs_j, pairs_t, ambient=False, rtol=1e-8)
    assert np.abs(c_t.get_covariance_block_in_tangent_space(
        ct_[0], ct_[4])).max() == 0.0


def _pose_graph(mod, free_gauge=False):
    """A 720-pose SE2 graph: 2,157 effective parameters, past the dense
    QR cap, no Schur structure."""
    pkg_slam, pkg_g2o = (jax_slam, jax_g2o) if mod is ct else (slam, g2o)
    poses, constraints, _ = pkg_g2o.synthetic_pose_graph_2d(num_poses=720,
                                                            seed=1)
    problem, pos, yaw = pkg_slam.build_pose_graph_2d_problem(poses,
                                                             constraints)
    if free_gauge:
        problem.set_parameter_block_variable(pos[0])
        problem.set_parameter_block_variable(yaw[0])
    pairs = [(pos[k], pos[k]) for k in (5, 300)] + [
        (yaw[5], yaw[5]), (pos[5], yaw[5]), (pos[0], pos[5])]
    return problem, pairs


def test_sparse_qr_native_path_on_a_pose_graph():
    """The scalable SPARSE_QR path: the native LDL^T of J^T J, one
    backsolve per requested column; the JAX package's blocks at 1e-10,
    DENSE_SVD's at 1e-10; the constant first pose gives a zero block."""
    pj, pairs_j = _pose_graph(ct)
    pt, pairs_t = _pose_graph(ctt)
    cj, c_t = _cov(ct, "SPARSE_QR"), _cov(ctt, "SPARSE_QR")
    assert cj.compute(pairs_j, pj) and c_t.compute(pairs_t, pt)
    assert c_t._block_cov is not None and c_t._tangent_cov is None
    _blocks_match(cj, c_t, pairs_j, pairs_t)
    np.testing.assert_allclose(c_t.get_covariance_block(*pairs_t[-1]), 0.0)
    dense = _cov(ctt, "DENSE_SVD")
    assert dense.compute(pairs_t, pt)
    _blocks_match(dense, c_t, pairs_t, pairs_t)


def test_sparse_qr_rank_policy_free_gauge():
    """The pose graph with its first pose freed has a 3-dimensional null
    space: the scalable path returns False, as the JAX package's does."""
    pj, pairs_j = _pose_graph(ct, free_gauge=True)
    pt, pairs_t = _pose_graph(ctt, free_gauge=True)
    cj, c_t = _cov(ct, "SPARSE_QR"), _cov(ctt, "SPARSE_QR")
    assert not cj.compute(pairs_j[:1], pj)
    assert not c_t.compute(pairs_t[:1], pt)
    assert "Rank deficient" in c_t.message


@pytest.mark.parametrize("apply_loss", [True, False])
def test_apply_loss_function(apply_loss):
    """apply_loss_function: the covariance of the robustified or of the
    plain problem, as the JAX package's."""
    out = []
    for mod in (ct, ctt):
        problem, x, _ = linear_gaussian_problem(mod)
        rb = problem.residual_blocks()
        xp = _xp(mod)
        y = np.array([0.3, -0.2, 0.5])
        problem.add_residual_block(mod.AutoDiffCostFunction(
            lambda v, c=y: 3.0 * (v - _arr(mod, c)) + xp.stack(
                [v[0] * v[1], v[1] * v[2], v[2] * v[0]]), 3, [3]),
            mod.CauchyLoss(0.5), x)
        assert len(problem.residual_blocks()) == len(rb) + 1
        cov = _cov(mod, apply_loss_function=apply_loss)
        assert cov.compute([(x, x)], problem), cov.message
        out.append((cov, x))
    (cj, xj), (c_t, xt) = out
    _blocks_match(cj, c_t, [(xj, xj)], [(xt, xt)])
