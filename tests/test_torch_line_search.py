"""The line-search minimizer of ceres_tpu_torch (minimizers/line_search.py)
against the JAX package's host loop, in f64 on the CPU: every direction
with both line searches on the quadratic of
tests/test_aux_components.py's direction test and on Rosenbrock, the
three nonlinear CG betas, L-BFGS with and without eigenvalue scaling,
LINE_SEARCH through ctt.solve on a least-squares curve fit, and the
fused_iterations=True (reported as the JAX package's device loop reports).

Each solve keeps the JAX package's iteration count, its line-search
probe counts and x within 1e-10. The two packages' objectives differ in
the last bit: XLA compiles the JAX objective with fused multiply-adds
(x1 - x0^2 is one FMA in Rosenbrock's jitted cost), PyTorch's eager CPU
ops round each product. The quasi-Newton runs shrug that off and are
compared to convergence. Steepest descent on the quadratic (condition
number 100) and nonlinear CG on Rosenbrock amplify it about tenfold every
two or three iterations (x 1e-14 apart after 10 iterations, 1e-9 after
30, 1e-5 after 60; the probe counts move after 28 to 69), so those runs
are compared over their first 10 iterations, and
test_long_runs_reach_the_same_minimum runs two of them on to
convergence, the counts printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt

DIRECTIONS = ["STEEPEST_DESCENT", "NONLINEAR_CONJUGATE_GRADIENT", "LBFGS",
              "BFGS"]
SEARCHES = ["ARMIJO", "WOLFE"]
X_TOL = 1e-10
CHAOTIC_CUT = 10
CENTER, WEIGHTS = [1.0, -2.0, 3.0], [1.0, 10.0, 100.0]


def objective(mod, name):
    """(FirstOrderFunction, x0) of package `mod`: the weighted quadratic
    or Rosenbrock's function."""
    if name == "quadratic":
        if mod is ct:
            def cost(x):
                return jnp.sum((x - jnp.asarray(CENTER)) ** 2
                               * jnp.asarray(WEIGHTS))
        else:
            def cost(x):
                return torch.sum((x - torch.tensor(CENTER, dtype=x.dtype))
                                 ** 2 * torch.tensor(WEIGHTS, dtype=x.dtype))
        return mod.AutoDiffFirstOrderFunction(cost, 3), [0.0, 0.0, 0.0]

    class Rosenbrock(mod.FirstOrderFunction):
        def cost(self, x):
            return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
    return Rosenbrock(2), [-1.2, 1.0]


def options(mod, name, **kw):
    """LINE_SEARCH options: the quadratic's those of the JAX package's
    direction test, Rosenbrock's the defaults with 200 iterations; enum
    values by name."""
    base = (dict(max_num_iterations=500, function_tolerance=1e-14,
                 gradient_tolerance=1e-12) if name == "quadratic"
            else dict(max_num_iterations=200))
    base.update(kw)
    enums = {"line_search_direction_type": "LineSearchDirectionType",
             "line_search_type": "LineSearchType",
             "nonlinear_conjugate_gradient_type":
                 "NonlinearConjugateGradientType"}
    base = {k: getattr(getattr(mod, enums[k]), v) if k in enums else v
            for k, v in base.items()}
    if mod is ctt:
        base.setdefault("device", "cpu")
    return mod.SolverOptions(minimizer_type=mod.MinimizerType.LINE_SEARCH,
                             **base)


def solve_both(name, **kw):
    """The gradient problem solved by both packages: [(summary, x)]."""
    out = []
    for mod in (ct, ctt):
        fn, x0 = objective(mod, name)
        x = np.array(x0)
        s = mod.solve_gradient_problem(options(mod, name, **kw),
                                       mod.GradientProblem(fn), x)
        out.append((s, x))
    return out


def assert_same_run(runs):
    (s_j, x_j), (s_t, x_t) = runs
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert len(s_t.iterations) == len(s_j.iterations)
    assert s_t.num_line_search_steps == s_j.num_line_search_steps
    assert [it.line_search_function_evaluations for it in s_t.iterations] \
        == [it.line_search_function_evaluations for it in s_j.iterations]
    assert np.abs(x_t - x_j).max() <= X_TOL
    assert abs(s_t.final_cost - s_j.final_cost) <= \
        X_TOL * max(abs(s_j.final_cost), 1.0)


@pytest.mark.parametrize("name", ["quadratic", "rosenbrock"])
@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_direction_and_search_match_jax(direction, search, name):
    """Steepest descent and nonlinear CG over their first CHAOTIC_CUT
    iterations (the module docstring), L-BFGS and BFGS to the end."""
    cut = ({} if direction in ("LBFGS", "BFGS")
           else dict(max_num_iterations=CHAOTIC_CUT))
    runs = solve_both(name, line_search_direction_type=direction,
                      line_search_type=search, **cut)
    assert_same_run(runs)
    if not cut:
        assert str(runs[1][0].termination_type) == "CONVERGENCE"


@pytest.mark.parametrize("beta", ["FLETCHER_REEVES", "POLAK_RIBIERE",
                                  "HESTENES_STIEFEL"])
def test_nonlinear_cg_betas_match_jax(beta):
    """Each beta on Rosenbrock, with the restart budget of the JAX
    package's test_fused_nlcg_betas, over the first CHAOTIC_CUT
    iterations."""
    assert_same_run(solve_both(
        "rosenbrock",
        line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
        nonlinear_conjugate_gradient_type=beta,
        max_num_line_search_direction_restarts=20,
        max_num_iterations=CHAOTIC_CUT))


@pytest.mark.parametrize("scaling", [False, True])
def test_lbfgs_eigenvalue_scaling_matches_jax(scaling):
    """L-BFGS on Rosenbrock run to convergence, with and without Oren's
    scaling of the initial inverse Hessian."""
    runs = solve_both("rosenbrock",
                      use_approximate_eigenvalue_bfgs_scaling=scaling)
    assert_same_run(runs)
    assert str(runs[1][0].termination_type) == "CONVERGENCE"
    assert np.abs(runs[1][1] - 1.0).max() < 1e-5


@pytest.mark.parametrize("name, direction, search", [
    ("quadratic", "STEEPEST_DESCENT", "WOLFE"),
    ("rosenbrock", "NONLINEAR_CONJUGATE_GRADIENT", "WOLFE")])
def test_long_runs_reach_the_same_minimum(name, direction, search):
    """The two runs whose probe counts move (see the module docstring),
    uncut: both converge (on the parameter tolerance), to the minimum
    within 1e-4 (the tolerance of the JAX package's direction test); the
    counts are printed."""
    runs = solve_both(name, line_search_direction_type=direction,
                      line_search_type=search)
    want = np.array(CENTER if name == "quadratic" else [1.0, 1.0])
    for pkg, (s, x) in zip(("JAX", "port"), runs):
        print(f"{name} {direction} {search}: {pkg} {len(s.iterations) - 1} "
              f"iterations, {s.num_line_search_steps} probes, {s.message}")
        assert str(s.termination_type) == "CONVERGENCE"
        assert np.abs(x - want).max() < 1e-4


def curve_fit(mod):
    """tests/test_fused_line_search.py's exponential curve fit (40
    points, seed 11) in package `mod`: (problem, [m, c])."""
    T = jnp if mod is ct else torch
    rng = np.random.default_rng(11)
    xd = np.linspace(0, 5, 40)
    yd = np.exp(0.3 * xd + 0.1) + 0.01 * rng.standard_normal(40)
    prob = mod.Problem()
    mc = np.zeros(2)

    class R:
        def __init__(self, x, y):
            self.x, self.y = x, y

        def __call__(self, mc):
            return self.y - T.exp(mc[0:1] * self.x + mc[1:2])

    for x, y in zip(xd, yd):
        prob.add_residual_block(mod.AutoDiffCostFunction(R(x, y), 1, [2]),
                                None, mc)
    return prob, mc


@pytest.fixture(scope="module")
def jax_curve_fit():
    """The JAX package's host-loop LINE_SEARCH solve of the curve fit."""
    prob, mc = curve_fit(ct)
    s = ct.solve(ct.SolverOptions(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                                  max_num_iterations=300), prob)
    return s, mc


def test_least_squares_problem_through_solve(jax_curve_fit):
    """LINE_SEARCH (L-BFGS, Wolfe) through ctt.solve on a Problem: the
    cost and gradient from program.py's f64 linearize, the JAX host
    loop's counts, its cost within 1e-10, the result written back."""
    s_j, mc_j = jax_curve_fit
    prob, mc = curve_fit(ctt)
    s_t = ctt.solve(ctt.SolverOptions(
        minimizer_type=ctt.MinimizerType.LINE_SEARCH, max_num_iterations=300,
        device="cpu"), prob)
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert len(s_t.iterations) == len(s_j.iterations)
    assert s_t.num_line_search_steps == s_j.num_line_search_steps
    assert s_t.num_residual_evaluations == s_j.num_residual_evaluations
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-10 * s_j.final_cost
    assert np.abs(mc - mc_j).max() <= 1e-8
    assert str(s_t.minimizer_type) == "LINE_SEARCH"


def test_fused_iterations_raise_naming_item_47():
    """fused_iterations=True where the JAX package runs its
    device-resident loop raised, naming item 47, until the port ran it
    (its host loop, reported as the fused loop reports; the test keeps its
    name): through solve_gradient_problem and ctt.solve it now keeps the
    JAX fused loop's
    iteration, probe and successful-step counts and its x within 1e-10,
    reports no per-iteration records, and writes the result back.
    tests/test_torch_fused_line_search.py holds every direction and
    search."""
    runs = []
    for mod in (ct, ctt):
        fn, x0 = objective(mod, "rosenbrock")
        x = np.array(x0)
        s = mod.solve_gradient_problem(
            options(mod, "rosenbrock", fused_iterations=True),
            mod.GradientProblem(fn), x)
        prob, mc = curve_fit(mod)
        s2 = mod.solve(options(mod, "rosenbrock", fused_iterations=True),
                       prob)
        runs.append((s, x, s2, mc))
    (s_j, x_j, s2_j, mc_j), (s_t, x_t, s2_t, mc_t) = runs
    for a, b in ((s_t, s_j), (s2_t, s2_j)):
        assert a.is_solution_usable(), a.message
        assert a.iterations == [] and a.num_iterations_fused > 0
        assert (a.num_iterations_fused, a.num_line_search_steps,
                a.num_successful_steps, a.message) == (
            b.num_iterations_fused, b.num_line_search_steps,
            b.num_successful_steps, b.message)
    assert np.abs(x_t - x_j).max() <= X_TOL
    assert np.abs(mc_t - mc_j).max() <= X_TOL
    assert np.abs(x_t - 1.0).max() < 1e-6


def test_fused_iterations_with_a_callback_run_the_host_loop(capsys):
    """With a callback (or progress on stdout) the JAX package's
    fused_iterations=True runs its host loop, and so does the port: the
    JAX host loop's run, each iteration passed to the callback, one
    progress line an iteration."""
    seen = {ct: [], ctt: []}
    runs = []
    for mod in (ct, ctt):
        def cb(it, mod=mod):
            seen[mod].append(it.iteration)
            return mod.CallbackReturnType.SOLVER_CONTINUE
        fn, x0 = objective(mod, "rosenbrock")
        x = np.array(x0)
        s = mod.solve_gradient_problem(
            options(mod, "rosenbrock", fused_iterations=True, callbacks=[cb],
                    minimizer_progress_to_stdout=mod is ctt),
            mod.GradientProblem(fn), x)
        runs.append((s, x))
    assert_same_run(runs)
    n = len(runs[1][0].iterations)
    assert seen[ctt] == seen[ct] == list(range(1, n))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ": f:" in ln]
    assert len(lines) == len(runs[1][0].iterations)
