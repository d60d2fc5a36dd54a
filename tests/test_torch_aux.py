"""ceres_tpu_torch's interpolation, gradient checking, checkpoint and
timing helpers against the JAX package's on the CPU: the cubic and
bicubic interpolators' values and derivatives (jacfwd under vmap) within
1e-12, the declared-range clamping; GradientChecker passing a right
Jacobian and catching a wrong one with the JAX message; the bucket-wise
check_problem_gradients against a block-at-a-time loop of the probe and
against the JAX package's (the same first failing block and message);
a check_gradients solve; a checkpoint round trip and CheckpointCallback;
the trust-region dump of one linearization; the timers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, rel
from ceres_tpu import gradient_checker as jgc
from ceres_tpu import interpolation as jint
from ceres_tpu_torch import gradient_checker as tgc
from ceres_tpu_torch import interpolation as tint

DEV = {"device": "cpu"}


# ---------------- interpolation ----------------

def _grid1(mod, values, **kw):
    return mod.CubicInterpolator(mod.Grid1D(values, **kw))


@pytest.mark.parametrize("kw", [{}, dict(begin=-3), dict(begin=0, end=5)])
def test_cubic_interpolator_matches_jax(kw):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(10, 2))
    xs = np.concatenate([rng.uniform(-4.0, 12.0, size=20),
                         [0.0, 1.0, 4.0, 4.5, 8.99, 9.0, -3.0]])
    fj = _grid1(jint, values, **kw).evaluate
    ft = _grid1(tint, values, **kw).evaluate
    vj = np.asarray(jax.vmap(fj)(jnp.asarray(xs)))
    vt = torch.func.vmap(ft)(torch.tensor(xs)).numpy()
    assert rel(vt, vj) <= 1e-12
    dj = np.asarray(jax.vmap(jax.jacfwd(fj))(jnp.asarray(xs)))
    dt = torch.func.vmap(torch.func.jacfwd(ft))(torch.tensor(xs)).numpy()
    assert rel(dt, dj) <= 1e-12


@pytest.mark.parametrize("kw", [{}, dict(row_begin=-2, col_begin=3),
                                dict(row_end=4, col_end=5)])
def test_bicubic_interpolator_matches_jax(kw):
    rng = np.random.default_rng(4)
    data = rng.normal(size=(8, 9))
    rc = rng.uniform(-3.0, 12.0, size=(25, 2))
    fj = jint.BiCubicInterpolator(jint.Grid2D(data, **kw))
    ft = tint.BiCubicInterpolator(tint.Grid2D(data, **kw))
    vj = np.asarray(jax.vmap(lambda p: fj(p[0], p[1]))(jnp.asarray(rc)))
    vt = torch.func.vmap(lambda p: ft(p[0], p[1]))(torch.tensor(rc))
    assert rel(vt.numpy(), vj) <= 1e-12
    dj = jax.vmap(jax.jacfwd(lambda p: fj(p[0], p[1])))(jnp.asarray(rc))
    dt = torch.func.vmap(torch.func.jacfwd(lambda p: ft(p[0], p[1])))(
        torch.tensor(rc))
    assert rel(dt.numpy(), np.asarray(dj)) <= 1e-12


def test_interpolators_reproduce_polynomials_and_clamp():
    xs = np.arange(10.0)
    poly = np.polynomial.Polynomial([1.0, 0.3, -0.2])
    interp = tint.CubicInterpolator(tint.Grid1D(poly(xs)))
    for x in np.linspace(1.0, 8.0, 9):
        np.testing.assert_allclose(float(interp(x)), poly(x), rtol=1e-10)
    r, c = np.meshgrid(np.arange(8.0), np.arange(9.0), indexing="ij")
    bi = tint.BiCubicInterpolator(tint.Grid2D(2.0 * r - 3.0 * c
                                              + 0.5 * r * c))
    np.testing.assert_allclose(float(bi(2.5, 3.5)),
                               2.0 * 2.5 - 3.0 * 3.5 + 0.5 * 2.5 * 3.5,
                               rtol=1e-10)
    g = tint.Grid1D(np.arange(10.0), begin=0, end=5)
    assert float(g(7)[0]) == 4.0
    assert float(tint.CubicInterpolator(g).evaluate(3.5)) <= 4.0 + 1e-9
    data2 = np.arange(36.0).reshape(6, 6)
    g2 = tint.Grid2D(data2, row_begin=0, row_end=3, col_begin=0, col_end=3)
    assert float(g2(5, 5)[0]) == data2[2, 2]


# ---------------- gradient checking ----------------

def _pair_cost(mod, T, wrong):
    class Pair(mod.SizedCostFunction):
        def residuals(self, x):
            return T.stack([x[0] * x[1], x[0] + x[1]])

        def jacobians(self, x):
            return [T.stack([T.stack([x[1], x[0]]),
                             T.stack([x[0] * 0.0 + 1.0,
                                      x[0] * 0.0 + (2.0 if wrong
                                                    else 1.0)])])]
    return Pair(2, [2])


@pytest.mark.parametrize("wrong", [False, True])
def test_gradient_checker_matches_jax(wrong):
    p = [np.array([1.5, -2.0])]
    rj = ct.GradientChecker(_pair_cost(ct, jnp, wrong)).probe(p, 1e-8)
    rt = ctt.GradientChecker(_pair_cost(ctt, torch, wrong),
                             **DEV).probe(p, 1e-8)
    assert rt.return_value == rj.return_value == (not wrong)
    assert rt.error_log == rj.error_log
    assert abs(rt.maximum_relative_error - rj.maximum_relative_error) <= \
        1e-9 * max(rj.maximum_relative_error, 1e-12)
    assert rel(rt.residuals, rj.residuals) <= 1e-12
    for a, b in zip(rt.jacobians + rt.numeric_jacobians,
                    rj.jacobians + rj.numeric_jacobians):
        assert rel(a, b) <= 1e-9


class Flagged:
    """An analytic cost whose Jacobian is off by `err` (per-block data)
    in its second parameter block; a quaternion on the first."""

    @staticmethod
    def make(mod, T):
        class Cost(mod.SizedCostFunction):
            def __init__(self, err):
                super().__init__(3, [4, 3])
                self.err = err

            def residuals(self, q, p):
                return q[1:] * p + q[0]

            def jacobians(self, q, p):
                z = p * 0.0
                Jq = T.stack([T.stack([z[0] + 1.0, p[0], z[0], z[0]]),
                              T.stack([z[0] + 1.0, z[0], p[1], z[0]]),
                              T.stack([z[0] + 1.0, z[0], z[0], p[2]])])
                Jp = T.stack([T.stack([q[1] + self.err, z[0], z[0]]),
                              T.stack([z[0], q[2], z[0]]),
                              T.stack([z[0], z[0], q[3]])])
                return [Jq, Jp]
        return Cost


def _flagged_problem(mod, T, errs_a, errs_b):
    """Two buckets of Flagged costs (their blocks interleaved in
    insertion order) and an autodiff bucket, every q on the quaternion
    manifold."""
    rng = np.random.default_rng(9)
    Cost = Flagged.make(mod, T)
    problem = mod.Problem()
    arrays = []
    for ea, eb in zip(errs_a, errs_b):
        q = _unit4(rng)
        p = rng.normal(size=3)
        problem.add_residual_block(Cost(ea), None, q, p)
        problem.add_residual_block(
            mod.AutoDiffCostFunction(lambda p_: p_ * p_ - 1.0, 3, [3]),
            None, p)
        q2, p2 = _unit4(rng), rng.normal(size=3)
        problem.add_residual_block(Cost(eb), mod.HuberLoss(1.0), q2, p2)
        for qq in (q, q2):
            problem.set_manifold(qq, mod.QuaternionManifold())
        arrays += [q, p, q2, p2]
    return problem


def _unit4(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _per_block(problem, precision):
    """The block-at-a-time loop (the JAX package's) on the port's probe."""
    for rb in problem._residual_records():
        manifolds = [problem._blocks[k].manifold for k in rb.param_keys]
        res = ctt.GradientChecker(rb.cost, manifolds, **DEV).probe(
            [problem._blocks[k].array for k in rb.param_keys], precision)
        if not res.return_value:
            return (f"Gradient check failed for residual block "
                    f"{rb.index}:\n{res.error_log}")
    return None


@pytest.mark.parametrize("errs", [
    ([0.0] * 6, [0.0] * 6),                        # passes
    ([0.0, 0.0, 0.3, 0.0, 0.5, 0.0], [0.0] * 6),   # first bucket
    ([0.0, 0.0, 0.0, 0.2, 0.0, 0.0],               # the other bucket's
     [0.0, 0.4, 0.0, 0.0, 0.0, 1e-3]),             # block comes first
])
def test_bucketwise_check_matches_per_block_loop_and_jax(errs):
    problem_t = _flagged_problem(ctt, torch, *errs)
    problem_j = _flagged_problem(ct, jnp, *errs)
    got = tgc.check_problem_gradients(problem_t, 1e-8, **DEV)
    assert got == _per_block(problem_t, 1e-8)
    assert got == jgc.check_problem_gradients(problem_j, 1e-8)
    assert (got is None) == (not any(errs[0] + errs[1]))


def test_check_gradients_solve_matches_jax():
    got = []
    for mod, T, kw in ((ct, jnp, {}), (ctt, torch, DEV)):
        class Bad(mod.SizedCostFunction):
            def residuals(self, x):
                return x * 2.0

            def jacobians(self, x):
                return [T.ones((1, 1)) * 3.0]

        x = np.array([1.0])
        problem = mod.Problem()
        problem.add_residual_block(Bad(1, [1]), None, x)
        s = mod.solve(mod.SolverOptions(check_gradients=True, **kw), problem)
        got.append((str(s.termination_type), s.message))
    assert got[1] == got[0]
    assert got[0][0] == "FAILURE" and "Gradient check failed" in got[0][1]


def test_check_gradients_solve_passes():
    from ceres_tpu_torch.examples import circle_fit
    pts = circle_fit.synthesize(num_points=30, seed=2)
    plain = circle_fit.fit_circle(pts, pts[0, 0], pts[0, 1], 1.0, **DEV)
    checked = circle_fit.fit_circle(pts, pts[0, 0], pts[0, 1], 1.0,
                                    check_gradients=True, **DEV)
    assert checked[3].is_solution_usable(), checked[3].message
    assert checked[3].final_cost == plain[3].final_cost


# ---------------- checkpoints and timing ----------------

def _quad(mod):
    x = np.array([5.0])
    problem = mod.Problem()
    problem.add_residual_block(
        mod.AutoDiffCostFunction(lambda v: v - 3.0, 1, [1]), None, x)
    return problem, x


def test_checkpoint_round_trip_matches_jax(tmp_path):
    from ceres_tpu.checkpoint import load_state as jload
    from ceres_tpu_torch.checkpoint import load_state, save_state
    problem, x = _quad(ctt)
    save_state(str(tmp_path / "s.npz"), problem, iteration=7,
               trust_region_radius=123.0, extra={"tag": [1.0, 2.0]})
    x[0] = -100.0
    state = load_state(str(tmp_path / "s.npz"), problem)
    assert x[0] == 5.0
    assert state["iteration"] == 7 and state["trust_region_radius"] == 123.0
    # the JAX package reads the same file into its own problem
    pj, xj = _quad(ct)
    xj[0] = 0.0
    sj = jload(str(tmp_path / "s.npz"), pj)
    assert xj[0] == 5.0 and sj["iteration"] == 7
    np.testing.assert_array_equal(sj["tag"], state["tag"])


def test_checkpoint_callback_and_update_state(tmp_path):
    from ceres_tpu_torch.checkpoint import CheckpointCallback, load_state
    problem, x = _quad(ctt)
    cb = CheckpointCallback(problem, str(tmp_path), every_k_iterations=1)
    s = ctt.solve(ctt.SolverOptions(callbacks=[cb],
                                    update_state_every_iteration=True,
                                    **DEV), problem)
    assert s.is_solution_usable()
    files = sorted(os.listdir(tmp_path))
    assert files
    x[0] = 99.0
    load_state(str(tmp_path / files[-1]), problem)
    assert abs(x[0] - 3.0) < 1.0


def test_dump_linear_problem(tmp_path):
    from ceres_tpu_torch.checkpoint import dump_linear_problem
    from ceres_tpu_torch.program import CompiledProgram
    problem, x = _quad(ctt)
    prog = CompiledProgram(problem, "cpu")
    x0 = prog.initial_state()
    _, _, jac, res = prog.linearize_fn(x0)
    dump_linear_problem(str(tmp_path / "lsqp.npz"), jac, res,
                        torch.ones(1), x0)
    data = np.load(tmp_path / "lsqp.npz")
    assert data["jacobian"].shape == (1, 1)
    np.testing.assert_allclose(data["rhs"], [2.0])
    np.testing.assert_allclose(data["x"], [5.0])


def test_timers():
    from ceres_tpu_torch.utils.timing import EventLogger, ExecutionSummary
    es = ExecutionSummary()
    for _ in range(3):
        with es.scoped_timer("matmul", block_on={"out": torch.ones(2)}):
            torch.ones(8, 8) @ torch.ones(8, 8)
    st = es.statistics()["matmul"]
    assert st.calls == 3 and st.time >= 0.0
    assert "matmul" in es.report()
    lines = []
    log = EventLogger("solve", sink=lines.append)
    log.add_event("build")
    log.add_event("run")
    assert [e[0] for e in log.events] == ["build", "run"]
    assert len(lines) == 2 and log.total() >= log.events[-1][2]
