"""The line-search minimizer of ceres_tpu_torch with fused_iterations=True
against the JAX package's fused loop (ceres_tpu/minimizers/
line_search_fused.py, make_fused_ls_solve), in f64 on the CPU. The port
runs its host loop there and reports it as the JAX fused loop reports
(minimizers/line_search.py _report_as_fused).

The problems and options of tests/test_fused_line_search.py: the
weighted quadratic under its six direction and search pairs, Rosenbrock
under the three nonlinear CG betas (20 restarts) and L-BFGS with Oren's
scaling, and the exponential curve fit through ctt.solve. XLA compiles
the JAX objectives with fused multiply-adds, and steepest descent on the
quadratic and nonlinear CG on Rosenbrock amplify that last-bit
difference about tenfold every two or three iterations
(tests/test_torch_line_search.py), so each run is compared as follows:
cut at max_num_iterations=10, the same iteration, probe and
successful-step counts and x within 1e-10; uncut, runs that end within
50 iterations keep the JAX run's counts and message, and every uncut run
ends usable at the minimum within the JAX package's own test tolerance
(1e-4 on the quadratic, 5e-3 on Rosenbrock). The long runs (steepest
descent on the quadratic, Fletcher-Reeves) part from the JAX run: one
steepest-descent run converges in 485 iterations in JAX and stops at 500
in the port, both at the minimum. Polak-Ribiere and Hestenes-Stiefel keep
the counts while x parts by ~3e-9.

Then the fused report itself: the host loop's x and counts bit for bit,
no per-iteration records, and the JAX fused loop's counts and messages
where it stops at the start or its first search fails.
"""

import numpy as np
import pytest

from torch_parity_kit import ct, ctt
from test_torch_line_search import curve_fit, objective, options

X_TOL = 1e-10
EXACT_MAX = 50
QUADRATIC_PAIRS = [("STEEPEST_DESCENT", "ARMIJO"),
                   ("STEEPEST_DESCENT", "WOLFE"),
                   ("NONLINEAR_CONJUGATE_GRADIENT", "WOLFE"),
                   ("BFGS", "WOLFE"), ("LBFGS", "ARMIJO"),
                   ("LBFGS", "WOLFE")]
ROSENBROCK = {"FLETCHER_REEVES": dict(
    line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
    nonlinear_conjugate_gradient_type="FLETCHER_REEVES",
    max_num_line_search_direction_restarts=20),
    "POLAK_RIBIERE": dict(
    line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
    nonlinear_conjugate_gradient_type="POLAK_RIBIERE",
    max_num_line_search_direction_restarts=20),
    "HESTENES_STIEFEL": dict(
    line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
    nonlinear_conjugate_gradient_type="HESTENES_STIEFEL",
    max_num_line_search_direction_restarts=20),
    "LBFGS_SCALED": dict(use_approximate_eigenvalue_bfgs_scaling=True)}
MINIMA = {"quadratic": [1.0, -2.0, 3.0], "rosenbrock": [1.0, 1.0]}
# the JAX package's own tolerance on each long run's minimum
# (test_fused_directions_on_quadratic, test_fused_nlcg_betas)
LONG_TOL = {"quadratic": 1e-4, "rosenbrock": 5e-3}


def fused_both(name, **kw):
    """The gradient problem solved by both fused loops: [(summary, x)]."""
    out = []
    for mod in (ct, ctt):
        fn, x0 = objective(mod, name)
        x = np.array(x0)
        s = mod.solve_gradient_problem(
            options(mod, name, fused_iterations=True, **kw),
            mod.GradientProblem(fn), x)
        out.append((s, x))
    return out


def counts(s):
    return (s.num_iterations_fused, s.num_line_search_steps,
            s.num_successful_steps, str(s.termination_type), s.message)


def assert_fused_match(name, runs, cut):
    (s_j, x_j), (s_t, x_t) = runs
    assert s_t.iterations == []
    if cut:
        assert counts(s_t) == counts(s_j)
        assert np.abs(x_t - x_j).max() <= X_TOL
        assert abs(s_t.final_cost - s_j.final_cost) <= \
            X_TOL * max(abs(s_j.final_cost), 1.0)
        return
    if s_j.num_iterations_fused <= EXACT_MAX:
        assert counts(s_t) == counts(s_j)
    assert s_t.is_solution_usable() and s_j.is_solution_usable()
    for x in (x_j, x_t):
        assert np.abs(x - np.array(MINIMA[name])).max() < LONG_TOL[name]


@pytest.mark.parametrize("cut", [True, False], ids=["cut10", "full"])
@pytest.mark.parametrize("direction, search", QUADRATIC_PAIRS)
def test_quadratic_directions_match_jax_fused(direction, search, cut):
    kw = dict(line_search_direction_type=direction, line_search_type=search)
    if cut:
        kw["max_num_iterations"] = 10
    runs = fused_both("quadratic", **kw)
    assert_fused_match("quadratic", runs, cut)
    if not cut:
        assert runs[1][0].is_solution_usable()


@pytest.mark.parametrize("cut", [True, False], ids=["cut10", "full"])
@pytest.mark.parametrize("case", list(ROSENBROCK))
def test_rosenbrock_match_jax_fused(case, cut):
    kw = dict(ROSENBROCK[case])
    if cut:
        kw["max_num_iterations"] = 10
    assert_fused_match("rosenbrock", fused_both("rosenbrock", **kw), cut)


@pytest.fixture(scope="module")
def jax_fused_curve_fit():
    prob, mc = curve_fit(ct)
    s = ct.solve(options(ct, "rosenbrock", fused_iterations=True,
                         max_num_iterations=300), prob)
    return s, mc


def test_least_squares_problem_matches_jax_fused(jax_fused_curve_fit):
    """LINE_SEARCH (L-BFGS, Wolfe) with fused_iterations through ctt.solve
    on the curve fit: the program's f64 linearize gives cost and
    gradient; the JAX fused loop's counts, its x within 1e-10, the result
    written back."""
    s_j, mc_j = jax_fused_curve_fit
    prob, mc = curve_fit(ctt)
    s_t = ctt.solve(options(ctt, "rosenbrock", fused_iterations=True,
                            max_num_iterations=300), prob)
    assert counts(s_t) == counts(s_j)
    assert np.abs(mc - mc_j).max() <= X_TOL
    assert abs(s_t.final_cost - s_j.final_cost) <= X_TOL * s_j.final_cost


def solve_port(name, **kw):
    """(summary, x) of the port's gradient-problem solve."""
    fn, start = objective(ctt, name)
    x = np.array(start)
    s = ctt.solve_gradient_problem(options(ctt, name, **kw),
                                   ctt.GradientProblem(fn), x)
    return s, x


@pytest.mark.parametrize("case", ["LBFGS_SCALED", "POLAK_RIBIERE"])
def test_fused_report_is_the_host_loops_run(case):
    """fused_iterations=True takes the host loop's steps: its x bit for
    bit, its probe and successful-step counts, one fused iteration per
    host iteration record past iteration 0, and no records of its own."""
    s_f, x_f = solve_port("rosenbrock", fused_iterations=True,
                          **ROSENBROCK[case])
    s_h, x_h = solve_port("rosenbrock", **ROSENBROCK[case])
    assert np.array_equal(x_f, x_h)
    assert s_f.final_cost == s_h.final_cost
    assert s_f.iterations == [] and len(s_h.iterations) > 1
    assert s_f.num_iterations_fused == len(s_h.iterations) - 1
    assert (s_f.num_line_search_steps, s_f.num_successful_steps,
            str(s_f.termination_type)) == (
        s_h.num_line_search_steps, s_h.num_successful_steps,
        str(s_h.termination_type))


# a start where the gradient tolerance already holds, and a Wolfe search
# of one bracketing and one zoom probe, which fails at the first
# iteration
EDGES = {"start_at_minimum": dict(x0=MINIMA["rosenbrock"]),
         "first_search_fails": dict(
             max_num_line_search_step_size_iterations=1)}


@pytest.mark.parametrize("edge", list(EDGES))
def test_fused_edge_terminations_match_jax_fused(edge):
    """The JAX fused loop's counts and message where it stops at the
    start (0 iterations, "Gradient tolerance reached.") and where its
    first search fails (the failed iteration counted, no successful
    step), x left at the start."""
    kw = dict(EDGES[edge])
    x0 = kw.pop("x0", None)
    runs = []
    for mod in (ct, ctt):
        fn, start = objective(mod, "rosenbrock")
        x = np.array(start if x0 is None else x0, dtype=float)
        s = mod.solve_gradient_problem(
            options(mod, "rosenbrock", fused_iterations=True, **kw),
            mod.GradientProblem(fn), x)
        runs.append((s, x))
    (s_j, x_j), (s_t, x_t) = runs
    assert counts(s_t) == counts(s_j)
    assert s_t.iterations == []
    assert np.array_equal(x_t, x_j)
