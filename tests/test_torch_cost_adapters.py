"""ceres_tpu_torch's dynamic and adapter costs against the JAX package's
on the CPU: DynamicAutoDiffCostFunction, DynamicNumericDiffCostFunction,
CostFunctionToFunctor, DynamicCostFunctionToFunctor,
ConditionedCostFunction and NormalPrior. Each one's residuals and
Jacobians (through Problem.evaluate, tangent space) within 1e-12
relative of the JAX package's on the same numpy inputs (numeric
differences within 1e-9), and tests/test_cost_adapters.py's solves with
the JAX solve's iteration count and cost within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, rel

TOL = 1e-12
MODS = {"jax": (ct, jnp), "torch": (ctt, torch)}


class Weighted:
    """sum over the blocks: w_i * p_i[:2] (a dynamic functor's list
    argument; arithmetic only)."""

    def __init__(self, w):
        self.w = w

    def __call__(self, params):
        out = self.w * params[0][:2] * params[0][:2]
        for p in params[1:]:
            out = out + p[:2] * params[0][1:]
        return out


def _blocks():
    return (np.array([0.3, -1.2, 0.7]), np.array([2.0, 0.5, -0.1]),
            np.array([1.1, 0.4]))


def _dynamic(mod, T, kind):
    cls = {"auto": mod.DynamicAutoDiffCostFunction,
           "numeric": mod.DynamicNumericDiffCostFunction}[kind]
    cost = cls(Weighted(1.5))
    for s in (3, 3):
        cost.add_parameter_block(s)
    cost.set_num_residuals(2)
    return cost


def _analytic_cls(mod, T):
    class Analytic(mod.SizedCostFunction):
        def __init__(self):
            super().__init__(2, [3])

        def residuals(self, x):
            return T.stack([3.0 * x[0] - 6.0, x[1] * x[2]])

        def jacobians(self, x):
            z = x[0] * 0.0
            return [T.stack([T.stack([z + 3.0, z, z]),
                             T.stack([z, x[2], x[1]])])]
    return Analytic


def _to_functor(mod, T):
    inner = mod.CostFunctionToFunctor(_analytic_cls(mod, T)())

    def outer(x, y):
        r = inner(x)
        return T.stack([r[0] * r[1] + y[0], r[1] - x[0] * y[1]])
    return mod.AutoDiffCostFunction(outer, 2, [3, 3])


def _dynamic_to_functor(mod, T):
    inner = mod.DynamicAutoDiffCostFunction(
        lambda params: params[0][:2] * 2.0 - params[1][:2])
    inner.add_parameter_block(3)
    inner.add_parameter_block(3)
    inner.set_num_residuals(2)
    wrapped = mod.DynamicCostFunctionToFunctor(inner)

    def outer(params):
        return wrapped([params[0] + 1.0, params[1] * params[0]])
    cost = mod.DynamicAutoDiffCostFunction(outer)
    cost.add_parameter_block(3)
    cost.add_parameter_block(3)
    cost.set_num_residuals(2)
    return cost


def _conditioned(mod, T):
    base = mod.AutoDiffCostFunction(
        lambda x, y: T.stack([x[0] * y[1] - 1.0, x[2] - 3.0 * y[0]]), 2,
        [3, 3])
    prior = mod.NormalPrior(np.array([[2.0]]), np.array([1.0]))
    return mod.ConditionedCostFunction(base, [lambda r: 2.0 * r * r, prior])


def _prior(mod, T):
    return mod.NormalPrior(np.array([[2.0, 0.0, 1.0], [0.5, 3.0, 0.0]]),
                           np.array([0.1, -0.2, 0.3]))


COSTS = {
    "DynamicAutoDiffCostFunction": (lambda m, T: _dynamic(m, T, "auto"), 2),
    "DynamicNumericDiffCostFunction": (
        lambda m, T: _dynamic(m, T, "numeric"), 2),
    "CostFunctionToFunctor": (_to_functor, 2),
    "DynamicCostFunctionToFunctor": (_dynamic_to_functor, 2),
    "ConditionedCostFunction": (_conditioned, 2),
    "NormalPrior": (_prior, 1),
}


@pytest.mark.parametrize("name", list(COSTS))
def test_residuals_and_jacobians_match_jax(name):
    make, nblocks = COSTS[name]
    got = {}
    for key, (mod, T) in MODS.items():
        x, y, _ = _blocks()
        problem = mod.Problem()
        problem.add_residual_block(make(mod, T), None, *(x, y)[:nblocks])
        # a second block of the same cost object shares its bucket
        x2, y2 = x + 0.25, y - 0.5
        problem.add_residual_block(make(mod, T), None,
                                   *(x2, y2)[:nblocks])
        kw = {"device": "cpu"} if mod is ctt else {}
        got[key] = problem.evaluate(want_gradient=True, want_jacobian=True,
                                    **kw)
    (cj, rj, gj, jj), (c_t, r_t, g_t, j_t) = got["jax"], got["torch"]
    tol = 1e-9 if "Numeric" in name else TOL
    assert abs(c_t - cj) <= TOL * abs(cj)
    assert rel(r_t, rj) <= TOL
    assert rel(j_t, jj) <= tol and rel(g_t, gj) <= tol
    assert np.abs(jj).max() > 0


def _normal_prior_solve(mod, T):
    A = np.array([[2.0, 0.0], [0.0, 3.0]])
    b = np.array([1.0, -2.0])
    x = np.array([5.0, 5.0])
    problem = mod.Problem()
    problem.add_residual_block(mod.NormalPrior(A, b), None, x)
    return problem, x


def _prior_and_data_solve(mod, T):
    x = np.array([4.0])
    problem = mod.Problem()
    problem.add_residual_block(
        mod.NormalPrior(np.eye(1) * 10.0, np.zeros(1)), None, x)
    problem.add_residual_block(
        mod.AutoDiffCostFunction(lambda xv: xv - 2.0, 1, [1]), None, x)
    return problem, x


def _conditioned_solve(mod, T):
    wrapped = mod.ConditionedCostFunction(
        mod.AutoDiffCostFunction(
            lambda xv: T.stack([xv[0] - 1.0, xv[0] - 3.0]), 2, [1]),
        [lambda r: 2.0 * r, lambda r: r + 1.0])
    x = np.array([0.0])
    problem = mod.Problem()
    problem.add_residual_block(wrapped, None, x)
    return problem, x


def _to_functor_solve(mod, T):
    class Analytic(mod.SizedCostFunction):
        def __init__(self):
            super().__init__(1, [1])

        def residuals(self, xv):
            return 3.0 * xv - 6.0

        def jacobians(self, xv):
            return [T.ones((1, 1)) * 3.0]

    inner = mod.CostFunctionToFunctor(Analytic())

    def outer(xv):
        r = inner(xv)
        return r * r + xv - 2.0

    x = np.array([0.0])
    problem = mod.Problem()
    problem.add_residual_block(mod.AutoDiffCostFunction(outer, 1, [1]),
                               None, x)
    return problem, x


def _dynamic_to_functor_solve(mod, T):
    inner = mod.DynamicAutoDiffCostFunction(
        lambda params: params[0] * 2.0 - params[1])
    inner.add_parameter_block(2)
    inner.add_parameter_block(2)
    inner.set_num_residuals(2)
    wrapped = mod.DynamicCostFunctionToFunctor(inner)
    cost = mod.DynamicAutoDiffCostFunction(
        lambda params: wrapped([params[0] + 1.0, params[1]]))
    cost.add_parameter_block(2)
    cost.add_parameter_block(2)
    cost.set_num_residuals(2)
    a, b = np.array([0.0, 0.0]), np.array([0.5, -0.5])
    problem = mod.Problem()
    problem.add_residual_block(cost, None, a, b)
    problem.set_parameter_block_constant(b)
    return problem, a


SOLVES = {"normal_prior": (_normal_prior_solve, [1.0, -2.0]),
          "prior_and_data": (_prior_and_data_solve, [2.0 / 101.0]),
          "conditioned": (_conditioned_solve, [1.2]),
          "cost_to_functor": (_to_functor_solve, None),
          "dynamic_to_functor": (_dynamic_to_functor_solve, [-0.75, -1.25])}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solves_match_jax(case):
    build, want = SOLVES[case]
    out = {}
    for key, (mod, T) in MODS.items():
        problem, x = build(mod, T)
        kw = {"device": "cpu"} if mod is ctt else {}
        s = mod.solve(mod.SolverOptions(max_num_iterations=200, **kw),
                      problem)
        assert s.is_solution_usable(), s.message
        out[key] = (s, x)
    (sj, xj), (s_t, xt) = out["jax"], out["torch"]
    assert len(s_t.iterations) == len(sj.iterations)
    assert abs(s_t.final_cost - sj.final_cost) <= \
        1e-10 * abs(sj.final_cost) + 1e-20
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    if want is not None:
        np.testing.assert_allclose(xt, want, rtol=1e-8, atol=1e-10)
    else:
        assert abs((3.0 * xt[0] - 6.0) ** 2 + xt[0] - 2.0) < 1e-6
