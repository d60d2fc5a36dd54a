"""ceres_tpu_torch's GradientProblem (gradient_problem.py) against the JAX
package's on the CPU, in f64, through the line-search minimizer's host
loop: the tutorial's Rosenbrock by subclass, by AutoDiffFirstOrderFunction,
by an analytic cost_and_gradient and by NumericDiffFirstOrderFunction
(FORWARD, CENTRAL, RIDDERS), through both solver entry points; and a
problem on a manifold (the sphere, its tangent gradient PlusJacobian^T
g). Each solve keeps the JAX package's iteration and probe counts, and x
within 1e-10 (L-BFGS with Wolfe searches, which the last-bit differences
of XLA's fused multiply-adds do not move: tests/test_torch_line_search.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt

X_TOL = 1e-10
SPHERE_A = [0.3, -1.2, 0.5, 2.0]


def rosenbrock_value(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def function(mod, kind):
    """The FirstOrderFunction of `kind` in package `mod` and its x0."""
    T = jnp if mod is ct else torch
    if kind == "subclass":
        class Rosenbrock(mod.FirstOrderFunction):
            def cost(self, x):
                return rosenbrock_value(x)
        return Rosenbrock(2), [-1.2, 1.0]
    if kind == "autodiff":
        return mod.AutoDiffFirstOrderFunction(rosenbrock_value, 2), \
            [-1.2, 1.0]
    if kind == "analytic":
        class Analytic(mod.FirstOrderFunction):
            def cost_and_gradient(self, x):
                g = T.stack([-2.0 * (1.0 - x[0])
                             - 400.0 * x[0] * (x[1] - x[0] ** 2),
                             200.0 * (x[1] - x[0] ** 2)])
                return rosenbrock_value(x), g
        return Analytic(2), [-1.2, 1.0]
    if kind.startswith("numeric"):
        method = getattr(mod.NumericDiffMethodType, kind.split("_")[1])
        return mod.NumericDiffFirstOrderFunction(
            rosenbrock_value, 2, method=method), [-1.2, 1.0]
    raise ValueError(kind)


def solve(mod, fn, x0, manifold=None, entry="function", **kw):
    """Solve with L-BFGS (the defaults) by solve_gradient_problem or the
    GradientProblemSolver object; (summary, x)."""
    opts = dict(minimizer_type=mod.MinimizerType.LINE_SEARCH,
                max_num_iterations=200, **kw)
    if mod is ctt:
        opts["device"] = "cpu"
    x = np.array(x0)
    problem = mod.GradientProblem(fn, manifold)
    if entry == "function":
        s = mod.solve_gradient_problem(mod.SolverOptions(**opts), problem, x)
    else:
        s = mod.GradientProblemSolver().solve(mod.SolverOptions(**opts),
                                              problem, x)
    return s, x


def assert_same(a, b, x_tol=X_TOL):
    (s_j, x_j), (s_t, x_t) = a, b
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert len(s_t.iterations) == len(s_j.iterations)
    assert s_t.num_line_search_steps == s_j.num_line_search_steps
    assert np.abs(x_t - x_j).max() <= x_tol
    assert abs(s_t.final_cost - s_j.final_cost) <= \
        x_tol * max(abs(s_j.final_cost), 1.0)
    assert s_t.num_parameters == s_j.num_parameters
    assert s_t.num_effective_parameters == s_j.num_effective_parameters
    assert str(s_t.minimizer_type) == "LINE_SEARCH"


@pytest.mark.parametrize("kind, entry", [
    ("subclass", "function"), ("autodiff", "object"),
    ("analytic", "function"), ("numeric_FORWARD", "function"),
    ("numeric_CENTRAL", "function"), ("numeric_RIDDERS", "object")])
def test_first_order_functions_match_jax(kind, entry):
    """Finite differences leave the gradient off by ~1e-7 (central,
    Ridders) and ~1e-3 (forward, h f''/2 in Rosenbrock's valley): those
    solves stop at a gradient tolerance of 1e-6 and 1e-3, above which the
    line search still finds steps in both packages; the forward one takes
    Armijo searches (with Wolfe's curvature test on its gradient both
    packages stop at iteration 14, "Line search failed"). A forward
    difference divides the two objectives' last-bit difference (XLA's
    fused multiply-adds) by h = 1e-6, so its gradients lie ~1e-9 apart
    and its x is held within 1e-8."""
    kw = {}
    if kind.startswith("numeric"):
        kw["gradient_tolerance"] = 1e-3 if kind.endswith("FORWARD") else 1e-6
    if kind.endswith("FORWARD"):
        kw["line_search_type"] = "ARMIJO"
    runs = []
    for mod in (ct, ctt):
        kw_mod = {k: (mod.LineSearchType[v] if k == "line_search_type"
                      else v) for k, v in kw.items()}
        runs.append(solve(mod, *function(mod, kind), entry=entry, **kw_mod))
    assert_same(*runs, x_tol=1e-8 if kind.endswith("FORWARD") else X_TOL)
    assert str(runs[1][0].termination_type) == "CONVERGENCE"
    assert np.abs(runs[1][1] - 1.0).max() < (
        1e-2 if kind.endswith("FORWARD") else 1e-4)


@pytest.mark.parametrize("kind", ["FORWARD", "CENTRAL", "RIDDERS"])
def test_numeric_gradient_matches_jax(kind):
    """NumericDiffFirstOrderFunction's gradient at a point against the JAX
    package's stencil (the same steps), and against the exact gradient."""
    x = [0.7, -0.4]
    got = function(ctt, f"numeric_{kind}")[0].cost_and_gradient(
        torch.tensor(x, dtype=torch.float64))[1].numpy()
    want = np.asarray(function(ct, f"numeric_{kind}")[0].cost_and_gradient(
        jnp.asarray(x))[1])
    exact = function(ctt, "analytic")[0].cost_and_gradient(
        torch.tensor(x, dtype=torch.float64))[1].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(got - exact).max() <= \
        (1e-4 if kind == "FORWARD" else 1e-7) * np.abs(exact).max()


def test_manifold_problem_matches_jax():
    """Minimize a . x on the unit sphere in R^4 (SphereManifold: the
    tangent gradient PlusJacobian(x)^T g, Plus the sphere's retraction):
    the JAX package's counts and x within 1e-10, at -a / |a|."""
    runs = []
    for mod in (ct, ctt):
        T = jnp if mod is ct else torch

        def lin(x, T=T):
            return T.sum(x * T.asarray(SPHERE_A) if T is jnp
                         else x * torch.tensor(SPHERE_A, dtype=x.dtype))
        x0 = np.array([1.0, 1.0, 1.0, 1.0]) / 2.0
        runs.append(solve(mod, mod.AutoDiffFirstOrderFunction(lin, 4), x0,
                          manifold=mod.SphereManifold(4),
                          gradient_tolerance=1e-12))
    assert_same(*runs)
    a = np.array(SPHERE_A)
    assert np.abs(runs[1][1] + a / np.linalg.norm(a)).max() < 1e-6
    assert runs[1][0].num_effective_parameters == 3


def test_manifold_size_mismatch_and_invalid_options():
    fn, _ = function(ctt, "subclass")
    with pytest.raises(ValueError, match="ambient size"):
        ctt.GradientProblem(fn, ctt.SphereManifold(3))
    x = np.array([-1.2, 1.0])
    s = ctt.solve_gradient_problem(
        ctt.SolverOptions(minimizer_type=ctt.MinimizerType.LINE_SEARCH,
                          max_lbfgs_rank=0, device="cpu"),
        ctt.GradientProblem(fn), x)
    assert str(s.termination_type) == "FAILURE"
    assert "Invalid options" in s.message
    assert x.tolist() == [-1.2, 1.0]
