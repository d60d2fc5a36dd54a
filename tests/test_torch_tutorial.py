"""ceres_tpu_torch's tutorial examples (examples/tutorial.py) against the
JAX package's (ceres_tpu/examples/tutorial.py) on the CPU: helloworld
with autodiff, numeric and analytic derivatives, Powell's function, the
curve fit and its robust variant (Ceres's default Solve: LM, DENSE_QR,
f64, the host loop) and Rosenbrock (GradientProblemSolver, L-BFGS). Each
keeps the JAX example's termination and iteration count; costs agree
within 1e-10 relative (1e-20 absolute for costs at zero) and the solved
parameters within 1e-8.
"""

import numpy as np
import pytest

from ceres_tpu.examples import tutorial as jax_tutorial
from ceres_tpu_torch.examples import tutorial

CASES = {
    "helloworld_auto": lambda m, **d: m.helloworld("auto", **d),
    "helloworld_numeric": lambda m, **d: m.helloworld("numeric", **d),
    "helloworld_analytic": lambda m, **d: m.helloworld("analytic", **d),
    "powell": lambda m, **d: (m.powell(**d),),
    "curve": lambda m, **d: m.curve_fitting(False, **d),
    "robust_curve": lambda m, **d: m.curve_fitting(True, **d),
    "rosenbrock": lambda m, **d: m.rosenbrock(**d),
}


@pytest.mark.parametrize("case", list(CASES))
def test_example_matches_jax(case):
    *x_j, s_j = CASES[case](jax_tutorial)
    *x_t, s_t = CASES[case](tutorial, device="cpu")
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert len(s_t.iterations) == len(s_j.iterations) > 1
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.final_cost - s_j.final_cost) <= \
        1e-10 * abs(s_j.final_cost) + 1e-20
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * abs(s_j.initial_cost)
    for a, b in zip(x_t, x_j):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-8
