"""ceres_tpu_torch's Problem API against the JAX package's on the CPU:
ProblemOptions, the accessors, remove_residual_block and
remove_parameter_block, Problem.evaluate (full and in subsets, dense and
CSR, with and without the loss, with constant and all-constant blocks:
every number within 1e-12 relative, the CSR structure bit for bit),
evaluate_residual_block and the EvaluationCallback's new_point, the
revision bump that rebuilds the program, the subset cache, a freed
array's id given to a new one, and chip_smoke.py's outlier workflow
(solve, evaluate, remove, solve) at a small size through the plain
K1-K4: the same removed set as the JAX package and costs within 1e-6.
The same numpy inputs go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from chip_smoke import remove_outliers, removed_digest, shift_observations
from torch_parity_kit import ct, ctt, main_path_options, rel
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build
from ceres_tpu_torch.program import CompiledProgram

TOL = 1e-12
DEV = {"device": "cpu"}


class Tilt:
    """w * q[1:] * p - 0.5 on a quaternion q and a point p (arithmetic
    only, so one class serves both packages)."""

    def __init__(self, w):
        self.w = w

    def __call__(self, q, p):
        return self.w * q[1:] * p - 0.5


def _bal():
    bal = synthetic_bal_problem(num_cameras=4, num_points=40,
                                num_observations=160, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


def _mixed(mod, bal):
    """Snavely blocks under HuberLoss(1.0), camera 0 constant, a residual
    on a quaternion block (QuaternionManifold) and a point, a NormalPrior
    on point 1, and a residual block on the constant camera alone."""
    build = jax_build if mod is ct else torch_build
    problem, cams, pts = build(bal, loss=mod.HuberLoss(1.0))
    problem.set_parameter_block_constant(cams[0])
    q = np.array([0.9, 0.1, -0.2, 0.3])
    extra = [problem.add_residual_block(
        mod.AutoDiffCostFunction(Tilt(1.5), 3, [4, 3]), None, q, pts[0])]
    problem.set_manifold(q, mod.QuaternionManifold())
    extra.append(problem.add_residual_block(
        mod.NormalPrior(np.array([[2.0, 0.0, 1.0], [0.0, 3.0, 0.0]]),
                        np.array([0.1, -0.2, 0.3])), None, pts[1]))
    extra.append(problem.add_residual_block(
        mod.AutoDiffCostFunction(lambda c: 2.0 * c[:3], 3, [9]), None,
        cams[0]))
    return problem, cams, pts, q, extra


@pytest.fixture(scope="module")
def pair():
    bal = _bal()
    return _mixed(ct, bal), _mixed(ctt, bal)


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if sp.issparse(b):
        assert sp.issparse(a), what
        a, b = a.tocsr(), b.tocsr()
        assert np.array_equal(a.indptr, b.indptr), what
        assert np.array_equal(a.indices, b.indices), what
        a, b = a.data, b.data
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    if a.size:
        assert rel(a, b) <= TOL, (what, rel(a, b))


def _evaluate_both(pair, jargs, targs, **kw):
    (pj, *_), (pt, *_) = pair
    got_j = pj.evaluate(**jargs(pair[0]), **kw)
    got_t = pt.evaluate(**targs(pair[1]), **kw, **DEV)
    assert abs(got_t[0] - got_j[0]) <= TOL * abs(got_j[0])
    for name, a, b in zip(("residuals", "gradient", "jacobian"),
                          got_t[1:], got_j[1:]):
        _same(a, b, name)
    return got_j, got_t


SUBSETS = {
    "full": lambda s: {},
    "rows": lambda s: dict(residual_blocks=[
        s[0].residual_blocks()[7], s[4][0], s[0].residual_blocks()[2],
        s[4][2]]),
    "columns": lambda s: dict(parameter_blocks=[s[2][3], s[1][1], s[3],
                                                s[1][0]]),
    "both": lambda s: dict(residual_blocks=[s[4][2], s[0].residual_blocks()[
        5]], parameter_blocks=[s[2][9], s[1][0], s[1][2], s[3]]),
}


@pytest.mark.parametrize("fmt", ["dense", "csr"])
@pytest.mark.parametrize("loss", [True, False])
@pytest.mark.parametrize("subset", list(SUBSETS))
def test_evaluate_matches_jax(pair, subset, loss, fmt):
    """Residuals, gradient and Jacobian of the whole problem or a subset
    of its rows and columns (a listed block untouched by the rows gives
    zero columns, a constant one none), loss applied or not."""
    _evaluate_both(pair, SUBSETS[subset], SUBSETS[subset],
                   apply_loss_function=loss, want_gradient=True,
                   want_jacobian=True, jacobian_format=fmt)


def test_evaluate_residuals_only_matches_jax(pair):
    got_j, got_t = _evaluate_both(pair, SUBSETS["full"], SUBSETS["full"])
    assert got_t[2] is None and got_t[3] is None
    # the residual-only branch and the Jacobian branch agree
    full = pair[1][0].evaluate(want_jacobian=True, **DEV)
    assert rel(got_t[1], full[1]) <= TOL


def test_evaluate_all_constant_problem_matches_jax():
    """Every block constant: residuals over every block, no columns."""
    got = []
    for mod, kw in ((ct, {}), (ctt, DEV)):
        problem, cams, pts, q, _ = _mixed(mod, _bal())
        for b in problem.parameter_blocks():
            problem.set_parameter_block_constant(b)
        got.append(problem.evaluate(want_gradient=True, want_jacobian=True,
                                    **kw))
    (cj, rj, gj, jj), (c_t, r_t, g_t, j_t) = got
    assert abs(c_t - cj) <= TOL * cj and rel(r_t, rj) <= TOL
    assert g_t.shape == gj.shape == (0,) and j_t.shape == jj.shape


def test_evaluate_residual_block_matches_jax(pair):
    (pj, cj, _, qj, ej), (pt, c_t, _, qt, et) = pair
    for a, b in ((pj.residual_blocks()[11], pt.residual_blocks()[11]),
                 (ej[0], et[0]), (ej[2], et[2])):
        for want in (True, False):
            got_j = pj.evaluate_residual_block(a, want_jacobians=want)
            got_t = pt.evaluate_residual_block(b, want_jacobians=want, **DEV)
            assert abs(got_t[0] - got_j[0]) <= TOL * abs(got_j[0])
            assert rel(got_t[1], got_j[1]) <= TOL
            if not want:
                assert got_t[2] is None and got_j[2] is None
                continue
            for x, y in zip(got_t[2], got_j[2]):
                _same(x, y, "block jacobian")
    # the quaternion block gives its 3 tangent columns
    assert pt.evaluate_residual_block(et[0], **DEV)[2][0].shape == (3, 3)


def test_evaluation_callback_new_point():
    calls = []

    class CB(ctt.EvaluationCallback):
        def prepare_for_evaluation(self, evaluate_jacobians,
                                   new_evaluation_point):
            calls.append((evaluate_jacobians, new_evaluation_point))

    a = np.array([3.0])
    problem = ctt.Problem(ctt.ProblemOptions(evaluation_callback=CB()))
    rb = problem.add_residual_block(
        ctt.AutoDiffCostFunction(lambda a_: a_ - 1.0, 1, [1]), None, a)
    problem.evaluate(want_jacobian=True, **DEV)
    assert calls[-1] == (True, True)
    problem.evaluate_residual_block(rb, want_jacobians=False, **DEV)
    assert calls[-1] == (False, True)
    problem.evaluate_residual_block_assuming_parameters_unchanged(
        rb, want_jacobians=False, **DEV)
    assert calls[-1] == (False, False)
    n_before = len(calls)
    s = ctt.solve(ctt.SolverOptions(max_num_iterations=5, **DEV), problem)
    assert s.is_solution_usable() and len(calls) > n_before
    np.testing.assert_allclose(a, [1.0], atol=1e-10)


def _line(mod, fast=False):
    """tests/test_problem_mutation.py's problem: y = 2x + 1 at six x."""
    xs = np.linspace(0.0, 2.0, 6)

    class R:
        def __init__(self, x, y):
            self.x = x
            self.y = y

        def __call__(self, m, c):
            return self.y - (m[0] * self.x + c[0])

    m, c = np.array([0.0]), np.array([0.0])
    problem = mod.Problem(mod.ProblemOptions(enable_fast_removal=fast))
    rbs = [problem.add_residual_block(
        mod.AutoDiffCostFunction(R(float(x), float(2.0 * x + 1.0)), 1,
                                 [1, 1]), None, m, c) for x in xs]
    return problem, m, c, rbs


def _accessors(mod, problem, m, c, rbs, extra):
    out = [problem.num_parameter_blocks(), problem.num_parameters(),
           problem.num_residual_blocks(), problem.num_residuals(),
           len(problem.parameter_blocks()), len(problem.residual_blocks()),
           problem.has_parameter_block(m), problem.has_parameter_block(extra),
           problem.has_parameter_block(np.array([1.0])),
           problem.has_parameter_block("not an array"),
           len(problem.get_residual_blocks_for_parameter_block(m)),
           sum(b is m or b is c for b in
               problem.get_parameter_blocks_for_residual_block(rbs[0])),
           problem.get_cost_function_for_residual_block(rbs[1])
           is rbs[1].cost,
           problem.get_loss_function_for_residual_block(rbs[1]) is None,
           problem.parameter_block_size(m),
           problem.parameter_block_tangent_size(m),
           problem.has_manifold(m), problem.get_manifold(m) is None,
           problem.get_parameter_lower_bound(m, 0),
           problem.get_parameter_upper_bound(c, 0),
           problem.is_parameter_block_constant(c)]
    return out


@pytest.mark.parametrize("fast", [False, True])
def test_accessors_and_removal_match_jax(fast):
    got = []
    for mod, kw in ((ct, {}), (ctt, DEV)):
        problem, m, c, rbs = _line(mod, fast)
        extra = np.array([5.0])
        rb_extra = problem.add_residual_block(
            mod.AutoDiffCostFunction(lambda e, mm: e - mm, 1, [1, 1]),
            None, extra, m)
        problem.set_parameter_lower_bound(m, 0, -10.0)
        problem.set_parameter_upper_bound(c, 0, 10.0)
        seen = [_accessors(mod, problem, m, c, rbs, extra)]
        rev = problem._revision
        problem.remove_residual_block(rbs[2])
        problem.remove_residual_block(rbs[4])
        assert problem._revision > rev
        with pytest.raises(KeyError):
            problem.remove_residual_block(rbs[2])
        seen.append(_accessors(mod, problem, m, c, rbs, extra))
        rev = problem._revision
        problem.remove_parameter_block(extra)
        assert problem._revision > rev
        assert rb_extra not in problem.residual_blocks()
        seen.append(_accessors(mod, problem, m, c, rbs, extra))
        # the holes keep the other blocks' rows in insertion order
        r = problem.evaluate(**kw)[1]
        seen.append(list(r))
        s = mod.solve(mod.SolverOptions(**kw), problem)
        assert s.is_solution_usable()
        assert s.num_residuals == 4
        np.testing.assert_allclose([m[0], c[0]], [2.0, 1.0], atol=1e-10)
        got.append(seen)
    for a, b in zip(got[1], got[0]):
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=TOL, atol=1e-300)


def test_revision_bump_rebuilds_the_program():
    """A structural edit bumps the revision: the next solve and evaluate
    build a new program; values alone do not."""
    problem, m, c, rbs = _line(ctt)
    s1 = ctt.solve(ctt.SolverOptions(**DEV), problem)
    solve_prog = CompiledProgram.get_cached(problem, ctt.SolverOptions(
        **DEV))
    eval_prog = CompiledProgram.get_cached(
        problem, device="cpu", include_fixed_blocks=True)
    assert eval_prog is not solve_prog       # keyed apart
    problem.evaluate(**DEV)
    assert CompiledProgram.get_cached(
        problem, device="cpu", include_fixed_blocks=True) is eval_prog
    m[0] = c[0] = 0.0                        # values only
    assert CompiledProgram.get_cached(problem, ctt.SolverOptions(
        **DEV)) is solve_prog
    problem.remove_residual_block(rbs[0])
    assert CompiledProgram.get_cached(problem, ctt.SolverOptions(
        **DEV)) is not solve_prog
    s2 = ctt.solve(ctt.SolverOptions(**DEV), problem)
    assert s2.num_residuals == s1.num_residuals - 1
    np.testing.assert_allclose([m[0], c[0]], [2.0, 1.0], atol=1e-10)
    # the evaluate program with losses off is another key
    assert CompiledProgram.get_cached(
        problem, device="cpu", apply_loss=False,
        include_fixed_blocks=True) is not CompiledProgram.get_cached(
        problem, device="cpu", include_fixed_blocks=True)


def test_subset_cache_reused():
    problem, m, c, rbs = _line(ctt)
    c1 = problem.evaluate(residual_blocks=[rbs[0]], **DEV)[0]
    c2 = problem.evaluate(residual_blocks=[rbs[0]], **DEV)[0]
    assert c1 == c2 and len(problem._subset_eval_cache) == 1
    problem.evaluate(residual_blocks=[rbs[1]], **DEV)
    assert len(problem._subset_eval_cache) == 2
    for _ in range(2):           # (rows and columns: a signature a block)
        for rb in rbs:
            problem.evaluate_residual_block(rb, **DEV)
        assert len(problem._subset_eval_cache) == 2 + len(rbs)
    problem.set_parameter_block_constant(c)      # a new revision
    problem.evaluate(residual_blocks=[rbs[0]], **DEV)
    assert len(problem._subset_eval_cache) == 1


def test_freed_array_id_reused_after_removal():
    """Blocks are keyed by id(array): an array removed and freed may give
    its id to a new array, which must then enter as a new block of its
    own size and values."""
    problem = ctt.Problem()
    m = np.array([1.0])
    keep = np.array([2.0, 3.0])
    problem.add_residual_block(
        ctt.AutoDiffCostFunction(lambda a, b: a * b[:1] - 1.0, 1, [1, 2]),
        None, m, keep)
    problem.evaluate(want_jacobian=True, **DEV)
    reuses = 0
    for _ in range(5):
        old = np.array([4.0])
        old_id = id(old)
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(lambda a: a - 1.0, 1, [1]), None, old)
        problem.evaluate(**DEV)
        problem.remove_parameter_block(old)
        problem.evaluate(**DEV)       # drops the program that held `old`
        del old
        new = np.array([7.0, 8.0, 9.0])
        reuses += id(new) == old_id
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(lambda a: a - 1.0, 3, [3]), None, new)
        cost, r, g, J = problem.evaluate(want_gradient=True,
                                         want_jacobian=True, **DEV)
        assert J.shape == (4, 6)
        np.testing.assert_allclose(r, [1.0, 6.0, 7.0, 8.0])
        assert problem.parameter_block_size(new) == 3
        problem.remove_parameter_block(new)
    assert reuses          # CPython hands the freed id straight out again


def test_outlier_workflow_matches_jax():
    """chip_smoke.py's OUTLIER at a small size: solve (bench.py's
    options, the plain K1-K4 on the CPU), evaluate, remove every
    observation past a threshold in a gap of the JAX run's errors and
    every point left without one, solve again."""
    bal = synthetic_bal_problem(num_cameras=4, num_points=200,
                                num_observations=800, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    shifted = shift_observations(bal.observations)
    assert shifted.size == 8
    runs = {}
    for name, mod, build, kw in (("jax", ct, jax_build, {}),
                                 ("torch", ctt, torch_build, DEV)):
        problem, cams, pts = build(bal)
        rbs = problem.residual_blocks()
        s1 = mod.solve(main_path_options(mod), problem)
        _, r, _, _ = problem.evaluate(want_residuals=True, **kw)
        if name == "jax":        # the widest gap in the upper half
            e = np.sort(np.hypot(r[0::2], r[1::2]))
            k = e.size // 2 + int(np.argmax(e[e.size // 2 + 1:]
                                            / e[e.size // 2:-1]))
            threshold = float(np.sqrt(e[k] * e[k + 1]))
        removed, emptied, _ = remove_outliers(
            problem, rbs, pts, bal.point_index, r, threshold)
        s2 = mod.solve(main_path_options(mod), problem)
        assert s1.is_solution_usable() and s2.is_solution_usable()
        runs[name] = (removed_digest(removed), list(emptied),
                      problem.num_residual_blocks(),
                      problem.num_parameters(), s1, s2)
    j, t = runs["jax"], runs["torch"]
    assert t[:4] == j[:4]
    assert j[2] < 800 and j[1]
    for a, b in zip(t[4:], j[4:]):
        assert abs(a.final_cost - b.final_cost) <= 1e-6 * b.final_cost


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_evaluate_on_the_card_matches_the_cpu():
    bal = _bal()
    problem, *_ = _mixed(ctt, bal)
    for fmt in ("dense", "csr"):
        gpu = problem.evaluate(want_gradient=True, want_jacobian=True,
                               jacobian_format=fmt, device="cuda")
        cpu = problem.evaluate(want_gradient=True, want_jacobian=True,
                               jacobian_format=fmt, **DEV)
        assert abs(gpu[0] - cpu[0]) <= TOL * cpu[0]
        for a, b in zip(gpu[1:], cpu[1:]):
            _same(a, b, fmt)
