"""Ceres's default Solve in ceres_tpu_torch (the host-loop trust-region
minimizer, LM and dogleg, DENSE_QR / DENSE_NORMAL_CHOLESKY / CGNR, f64,
bounds and callbacks) against ceres_tpu on the CPU.

The problems are tests/test_solver_e2e.py's (helloworld, Powell, curve
fitting, robust curve fitting, bounds, constant blocks, numeric
differences, the quaternion manifold) and a few more that reach the
loop's options, each built in both packages from the same numbers and
solved with the same options (the port on device="cpu"). Both run in
f64, so the trajectories agree: the same LM count and termination, the
final cost within 1e-9 relative (plus 1e-20 absolute, for costs that
converge to rounding level, as Powell's do) and the parameters within
1e-7. The small BAL problem through the host loop repeats the port's own
fused trajectory (counts equal, cost within 1e-12) and the JAX host
loop's counts.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, main_path_options,
                              small_bal, torch_problem)

from ceres_tpu import rotation as jrot
from ceres_tpu_torch import rotation as trot

COST_RTOL, COST_ATOL, X_TOL = 1e-9, 1e-20, 1e-7
CURVE = np.array([
    0.000000e+00, 1.133898e+00, 7.500000e-02, 1.334902e+00,
    1.500000e-01, 1.213546e+00, 2.250000e-01, 1.252016e+00,
    3.000000e-01, 1.392265e+00, 3.750000e-01, 1.314458e+00,
    4.500000e-01, 1.472541e+00, 5.250000e-01, 1.536218e+00,
    6.000000e-01, 1.355679e+00, 6.750000e-01, 1.463566e+00,
    7.500000e-01, 1.490201e+00, 8.250000e-01, 1.658699e+00,
    9.000000e-01, 1.067574e+00, 9.750000e-01, 1.464629e+00,
    1.050000e+00, 1.402653e+00, 1.125000e+00, 1.713141e+00,
    1.200000e+00, 1.527021e+00, 1.275000e+00, 1.702632e+00,
    1.350000e+00, 1.423899e+00, 1.425000e+00, 1.543078e+00,
    1.500000e+00, 1.664015e+00, 1.575000e+00, 1.732484e+00,
    1.650000e+00, 1.543296e+00, 1.725000e+00, 1.959523e+00,
    1.800000e+00, 1.685132e+00, 1.875000e+00, 1.951791e+00,
    1.950000e+00, 2.095346e+00, 2.025000e+00, 2.361460e+00,
    2.100000e+00, 2.169119e+00, 2.175000e+00, 2.061745e+00,
    2.250000e+00, 2.178641e+00, 2.325000e+00, 2.104346e+00,
    2.400000e+00, 2.584470e+00, 2.475000e+00, 1.914158e+00,
    2.550000e+00, 2.368375e+00, 2.625000e+00, 2.686125e+00,
    2.700000e+00, 2.712395e+00, 2.775000e+00, 2.499511e+00,
    2.850000e+00, 2.558897e+00, 2.925000e+00, 2.309154e+00,
    3.000000e+00, 2.869503e+00]).reshape(-1, 2)


def _options(mod, **kw):
    if mod is ctt:
        kw["device"] = "cpu"
    enums = {"linear_solver_type": mod.LinearSolverType,
             "trust_region_strategy_type": mod.TrustRegionStrategyType,
             "dogleg_type": mod.DoglegType}
    kw = {k: getattr(enums[k], v) if k in enums else v
          for k, v in kw.items()}
    return mod.SolverOptions(**kw)


# ---- the problems, built in package `mod` (returns problem, arrays) ----

def helloworld(mod):
    x = np.array([0.5])
    p = mod.Problem()
    p.add_residual_block(mod.AutoDiffCostFunction(lambda v: 10.0 - v, 1, [1]),
                         None, x)
    return p, [x]


class PowellF1:
    def __call__(self, x1, x2):
        return x1 + 10.0 * x2


class PowellF2:
    def __call__(self, x3, x4):
        return math.sqrt(5.0) * (x3 - x4)


class PowellF3:
    def __call__(self, x2, x3):
        return (x2 - 2.0 * x3) ** 2


class PowellF4:
    def __call__(self, x1, x4):
        return math.sqrt(10.0) * (x1 - x4) ** 2


def powell(mod):
    xs = [np.array([3.0]), np.array([-1.0]), np.array([0.0]), np.array([1.0])]
    x1, x2, x3, x4 = xs
    p = mod.Problem()
    for f, a, b in ((PowellF1(), x1, x2), (PowellF2(), x3, x4),
                    (PowellF3(), x2, x3), (PowellF4(), x1, x4)):
        p.add_residual_block(mod.AutoDiffCostFunction(f, 1, [1, 1]), None,
                             a, b)
    return p, xs


class JaxExp:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __call__(self, m, c):
        return self.y - jnp.exp(m[0] * self.x + c[0])


class TorchExp:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __call__(self, m, c):
        return self.y - torch.exp(m[0] * self.x + c[0])


def curve(mod, loss=None):
    m, c = np.array([0.0]), np.array([0.0])
    p = mod.Problem()
    functor = JaxExp if mod is ct else TorchExp
    for x, y in CURVE:
        p.add_residual_block(mod.AutoDiffCostFunction(functor(x, y), 1,
                                                      [1, 1]), loss, m, c)
    return p, [m, c]


def robust_curve(mod):
    return curve(mod, mod.CauchyLoss(0.5))


def bounds(mod):
    x = np.array([3.0, -2.0])
    stack = jnp.stack if mod is ct else torch.stack
    p = mod.Problem()
    p.add_residual_block(mod.AutoDiffCostFunction(
        lambda v: stack([v[0] - 10.0, v[1] + 10.0]), 2, [2]), None, x)
    p.set_parameter_upper_bound(x, 0, 5.0)
    p.set_parameter_lower_bound(x, 1, -4.0)
    return p, [x]


def constant_blocks(mod):
    x, y = np.array([1.0]), np.array([2.0])
    p = mod.Problem()
    p.add_residual_block(mod.AutoDiffCostFunction(lambda a, b: a + b, 1,
                                                  [1, 1]), None, x, y)
    p.add_residual_block(mod.AutoDiffCostFunction(lambda a: a - 5.0, 1, [1]),
                         None, y)
    p.set_parameter_block_constant(y)
    return p, [x, y]


def _numeric(method):
    def build(mod):
        x = np.array([0.5, -1.5])
        exp = jnp.exp if mod is ct else torch.exp
        p = mod.Problem()
        stack = jnp.stack if mod is ct else torch.stack
        p.add_residual_block(mod.NumericDiffCostFunction(
            lambda v: exp(0.3 * v) - 2.0 + stack([v[1], v[0]]) ** 2,
            getattr(mod.NumericDiffMethodType, method), 2, [2]), None, x)
        return p, [x]
    return build


def _analytic_cost(mod):
    asarray = jnp.asarray if mod is ct else torch.as_tensor
    exp = jnp.exp if mod is ct else torch.exp

    class Exp(mod.SizedCostFunction):
        """y - exp(m x + c) with hand Jacobians."""

        def __init__(self, x, y):
            super().__init__(1, [1, 1])
            self.x, self.y = x, y

        def residuals(self, m, c):
            return self.y - exp(m[0] * self.x + c[0])

        def jacobians(self, m, c):
            e = exp(m[0] * self.x + c[0])
            return [asarray(-self.x * e).reshape(1, 1), (-e).reshape(1, 1)]
    return Exp


def analytic(mod):
    m, c = np.array([0.0]), np.array([0.0])
    cls = _analytic_cost(mod)
    p = mod.Problem()
    for x, y in CURVE:
        p.add_residual_block(cls(x, y), None, m, c)
    return p, [m, c]


def quaternion(mod):
    q = np.array([1.0, 0.0, 0.0, 0.0])
    if mod is ct:
        def f(qq):
            return (jrot.unit_quaternion_rotate_point(
                qq, jnp.asarray([1.0, 0.0, 0.0]))
                - jnp.asarray([0.0, 1.0, 0.0]))
    else:
        def f(qq):
            return (trot.unit_quaternion_rotate_point(
                qq, torch.tensor([1.0, 0.0, 0.0], dtype=qq.dtype))
                - torch.tensor([0.0, 1.0, 0.0], dtype=qq.dtype))
    p = mod.Problem()
    p.add_residual_block(mod.AutoDiffCostFunction(f, 3, [4]), None, q)
    p.set_manifold(q, mod.QuaternionManifold())
    return p, [q]


CASES = {
    "helloworld": (helloworld, {}),
    "powell-dense-qr": (powell, dict(max_num_iterations=100)),
    "powell-dense-normal-cholesky": (powell, dict(
        linear_solver_type="DENSE_NORMAL_CHOLESKY", max_num_iterations=100)),
    "powell-cgnr-f64": (powell, dict(linear_solver_type="CGNR",
                                     max_num_iterations=100)),
    "powell-traditional-dogleg": (powell, dict(
        trust_region_strategy_type="DOGLEG",
        linear_solver_type="DENSE_NORMAL_CHOLESKY", max_num_iterations=100)),
    "powell-subspace-dogleg": (powell, dict(
        trust_region_strategy_type="DOGLEG", dogleg_type="SUBSPACE_DOGLEG",
        max_num_iterations=100)),
    "curve-subspace-dogleg-cgnr": (curve, dict(
        trust_region_strategy_type="DOGLEG", dogleg_type="SUBSPACE_DOGLEG",
        linear_solver_type="CGNR")),
    "curve-fitting": (curve, {}),
    "robust-curve-fitting": (robust_curve, {}),
    "bounds": (bounds, dict(max_num_iterations=100)),
    "constant-blocks": (constant_blocks, {}),
    "numeric-forward": (_numeric("FORWARD"), {}),
    "numeric-central": (_numeric("CENTRAL"), {}),
    "numeric-ridders": (_numeric("RIDDERS"), {}),
    "analytic": (analytic, {}),
    "quaternion-manifold": (quaternion, dict(max_num_iterations=100)),
    "nonmonotonic": (curve, dict(use_nonmonotonic_steps=True,
                                 initial_trust_region_radius=1e8)),
    "downgrade-dense-schur-to-dense-qr": (quaternion, dict(
        linear_solver_type="DENSE_SCHUR", max_num_iterations=100)),
    "downgrade-sparse-schur-to-sparse-normal-cholesky": (quaternion, dict(
        linear_solver_type="SPARSE_SCHUR", max_num_iterations=100)),
    "mixed-dnc-refinement": (curve, dict(
        linear_solver_type="DENSE_NORMAL_CHOLESKY",
        use_mixed_precision_solves=True, max_num_refinement_iterations=3)),
}


def _solve_both(build, **kw):
    pj, xj = build(ct)
    pt, xt = build(ctt)
    s_j = ct.solve(_options(ct, **kw), pj)
    s_t = ctt.solve(_options(ctt, **kw), pt)
    return s_j, s_t, xj, xt


def _hold(s_j, s_t, xj, xt):
    assert str(s_t.termination_type) == str(s_j.termination_type), \
        (s_t.message, s_j.message)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        COST_RTOL * abs(s_j.initial_cost)
    assert abs(s_t.final_cost - s_j.final_cost) <= \
        COST_RTOL * abs(s_j.final_cost) + COST_ATOL
    for a, b in zip(xt, xj):
        np.testing.assert_allclose(a, b, rtol=0, atol=X_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(name):
    build, kw = CASES[name]
    s_j, s_t, xj, xt = _solve_both(build, **kw)
    assert s_t.is_solution_usable(), s_t.message
    _hold(s_j, s_t, xj, xt)
    assert len(s_t.iterations) == s_t.num_iterations     # the host loop
    assert str(s_t.linear_solver_type_used) == str(s_j.linear_solver_type_used)


def test_helloworld_default_options():
    """SolverOptions() is LM, DENSE_QR, f64 and the host loop; the e2e
    test's numbers (nnls_tutorial.rst:141-145)."""
    p, (x,) = helloworld(ctt)
    s = ctt.solve(ctt.SolverOptions(device="cpu"), p)
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert s.linear_solver_type_used == ctt.LinearSolverType.DENSE_QR
    np.testing.assert_allclose(s.initial_cost, 45.125, rtol=1e-12)
    assert s.final_cost < 1e-12
    np.testing.assert_allclose(x[0], 10.0, rtol=1e-6)


def test_skill_curve_fitting_default_options_matches_jax():
    """The verify skill's curve fit (30 exact points of exp(0.3 x + 0.1))
    under SolverOptions() in both packages: CONVERGENCE, (m, c) within
    1e-8 of the JAX package's."""
    out = []
    for mod in (ct, ctt):
        functor = JaxExp if mod is ct else TorchExp
        m, c = np.array([0.0]), np.array([0.0])
        p = mod.Problem()
        for x in np.linspace(0, 5, 30):
            p.add_residual_block(mod.AutoDiffCostFunction(
                functor(x, float(np.exp(0.3 * x + 0.1))), 1, [1, 1]), None,
                m, c)
        s = mod.solve(_options(mod), p)
        assert str(s.termination_type) == "CONVERGENCE"
        out.append(np.concatenate([m, c]))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(out[1], [0.3, 0.1], atol=1e-6)


def test_powell_tutorial_numbers():
    p, xs = powell(ctt)
    s = ctt.solve(_options(ctt, max_num_iterations=100), p)
    np.testing.assert_allclose(s.initial_cost, 107.5, rtol=1e-12)
    assert s.final_cost < 1e-12
    assert all(abs(x[0]) < 2e-3 for x in xs)


def test_bounds_clamp_and_projected_gradient():
    p, (x,) = bounds(ctt)
    s = ctt.solve(_options(ctt, max_num_iterations=100), p)
    assert s.is_constrained and s.is_solution_usable()
    np.testing.assert_allclose(x, [5.0, -4.0], atol=1e-6)


def _record(seen, stop_at=None, mod=ctt):
    def cb(it):
        seen.append((it.iteration, it.cost, it.step_is_successful,
                     it.trust_region_radius))
        if stop_at is not None and it.iteration >= stop_at:
            return mod.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return mod.CallbackReturnType.SOLVER_CONTINUE
    return cb


@pytest.mark.parametrize("stop_at", [None, 3], ids=["all", "stop-at-3"])
def test_iteration_callback_matches_jax(stop_at):
    """The callbacks see equal sequences of (iteration, cost, success,
    radius): iteration 0 and every iteration that does not end the solve
    on a tolerance (that one is recorded, and the loop stops before the
    callbacks, as the JAX loop does); SOLVER_TERMINATE_SUCCESSFULLY ends
    both solves at the same iteration with USER_SUCCESS."""
    seen_j, seen_t = [], []
    pj, xj = curve(ct)
    pt, xt = curve(ctt)
    s_j = ct.solve(_options(ct, callbacks=[_record(seen_j, stop_at, ct)]),
                   pj)
    s_t = ctt.solve(_options(ctt, callbacks=[_record(seen_t, stop_at)]), pt)
    _hold(s_j, s_t, xj, xt)
    assert len(seen_t) == len(seen_j) == len(s_t.iterations) - (
        stop_at is None)
    for a, b in zip(seen_t, seen_j):
        assert a[0] == b[0] and a[2] == b[2]
        assert abs(a[1] - b[1]) <= COST_RTOL * abs(b[1])
        assert a[3] == pytest.approx(b[3], rel=1e-12)
    if stop_at is not None:
        assert s_t.termination_type == ctt.TerminationType.USER_SUCCESS
        assert seen_t[-1][0] == stop_at


def test_evaluation_callback_and_update_state():
    """An evaluation callback is told before every evaluation (a
    linearization with Jacobians, each cost without); with
    update_state_every_iteration the callbacks see the accepted state in
    the user's arrays. The solve matches JAX's with the same options."""
    class EvalCb:
        def __init__(self):
            self.calls = []

        def prepare_for_evaluation(self, evaluate_jacobians,
                                   new_evaluation_point):
            self.calls.append(bool(evaluate_jacobians))

    states = []
    pt, xt = curve(ctt)
    ecb = EvalCb()
    s_t = ctt.solve(_options(
        ctt, evaluation_callback=ecb, update_state_every_iteration=True,
        callbacks=[lambda it: states.append((it.step_is_successful,
                                             xt[0].copy()))]), pt)
    pj, xj = curve(ct)
    s_j = ct.solve(_options(ct, evaluation_callback=EvalCb(),
                            update_state_every_iteration=True), pj)
    _hold(s_j, s_t, xj, xt)
    assert ecb.calls.count(True) == s_t.num_jacobian_evaluations
    assert ecb.calls.count(False) == s_t.num_residual_evaluations - \
        s_t.num_jacobian_evaluations
    assert states[0][1] == 0.0
    for (_, prev), (ok, now) in zip(states, states[1:]):
        assert (now != prev) == ok         # moved exactly when accepted


def test_minimizer_progress_to_stdout(capsys):
    p, _ = helloworld(ctt)
    s = ctt.solve(_options(ctt, minimizer_progress_to_stdout=True), p)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("iter      cost")
    assert len(lines) == 1 + len(s.iterations)


def test_solver_time_budget():
    p, _ = powell(ctt)
    s = ctt.solve(_options(ctt, max_solver_time_in_seconds=0.0), p)
    assert s.termination_type == ctt.TerminationType.NO_CONVERGENCE
    assert s.message == "Maximum solver time reached."


def test_fused_loop_runs_the_generic_f64_steps():
    """fused_iterations=True with DENSE_QR or SUBSPACE_DOGLEG in f64 runs
    the same steps in the fused loop: the same LM count and cost as the
    host loop (the fused summary counts no iteration 0)."""
    for kw in (dict(), dict(trust_region_strategy_type="DOGLEG",
                            dogleg_type="SUBSPACE_DOGLEG")):
        p1, _ = curve(ctt)
        p2, _ = curve(ctt)
        host = ctt.solve(_options(ctt, **kw), p1)
        fused = ctt.solve(_options(ctt, fused_iterations=True, **kw), p2)
        assert fused.num_iterations == host.num_iterations - 1
        assert abs(fused.final_cost - host.final_cost) <= \
            1e-12 * host.final_cost


def test_small_bal_host_loop_repeats_fused():
    """DENSE_SCHUR (mixed) through the host loop: the port's fused
    trajectory (counts equal, cost within 1e-12) and the JAX host loop's
    counts."""
    bal = small_bal()
    fused = ctt.solve(main_path_options(ctt), torch_problem(bal))
    host = ctt.solve(main_path_options(ctt, fused_iterations=False),
                     torch_problem(bal))
    jax_host = ct.solve(main_path_options(ct, fused_iterations=False),
                        jax_problem(bal))
    assert host.termination_type == ctt.TerminationType.CONVERGENCE
    assert len(host.iterations) - 1 == fused.num_iterations
    assert host.num_successful_steps == fused.num_successful_steps
    assert abs(host.final_cost - fused.final_cost) <= \
        1e-12 * fused.final_cost
    assert host.num_iterations == jax_host.num_iterations
    assert host.num_successful_steps == jax_host.num_successful_steps
    assert "Schur step" in host.message
