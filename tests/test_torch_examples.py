"""ceres_tpu_torch's examples against the JAX package's on the CPU, at
tests/test_examples.py's sizes: callbacks_example (iteration and
evaluation callbacks), circle_fit (CauchyLoss), ellipse_approximation
(CGNR), libmv_homography (SubsetManifold, a callback ending the solve),
robot_pose_mle (the dynamic autodiff cost), sampled_function (the cubic
and bicubic interpolators) and more_garbow_hillstrom (problems 1, 5, 13
and 15; constrained 3, 4, 5 and 9). Each keeps the JAX run's termination
and LM count, and its final cost within 1e-9 (1e-20 absolute at zero).
An MGH run's LM count may move by twice the spread of the JAX runs from
scaled starts (chip_smoke.py MGH_REF): those runs go on to tolerances of
1e-18, where the rounding steers the last steps (ROADMAP.md section 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LM_ROUNDING, MGH_REF
from torch_parity_kit import ct, ctt

DEV = {"device": "cpu"}


def same_run(s_t, s_j, spread=(0, 0.0), key=None):
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    lm_t, lm_j = len(s_t.iterations) - 1, len(s_j.iterations) - 1
    assert abs(lm_t - lm_j) <= max(2 * spread[0],
                                   LM_ROUNDING.get(key, 0)), (lm_t, lm_j)
    tol = max(1e-9 * abs(s_j.final_cost), 1e-20, 2.0 * spread[1])
    assert abs(s_t.final_cost - s_j.final_cost) <= tol, \
        (s_t.final_cost, s_j.final_cost)


def _mods():
    from ceres_tpu.examples import (callbacks_example, circle_fit,
                                    ellipse_approximation, libmv_homography,
                                    more_garbow_hillstrom, robot_pose_mle,
                                    sampled_function)
    jax_ex = dict(callbacks_example=callbacks_example, circle_fit=circle_fit,
                  ellipse_approximation=ellipse_approximation,
                  libmv_homography=libmv_homography,
                  more_garbow_hillstrom=more_garbow_hillstrom,
                  robot_pose_mle=robot_pose_mle,
                  sampled_function=sampled_function)
    import importlib
    torch_ex = {k: importlib.import_module(f"ceres_tpu_torch.examples.{k}")
                for k in jax_ex}
    return jax_ex, torch_ex


JAX_EX, TORCH_EX = _mods()


def test_iteration_callback():
    tj, sj = JAX_EX["callbacks_example"].iteration_callback_demo()
    tt, s_t = TORCH_EX["callbacks_example"].iteration_callback_demo(**DEV)
    same_run(s_t, sj)
    assert [t[0] for t in tt] == [t[0] for t in tj]
    np.testing.assert_allclose([t[1] for t in tt], [t[1] for t in tj],
                               rtol=1e-9, atol=1e-20)


def test_evaluation_callback():
    cj, sj = JAX_EX["callbacks_example"].evaluation_callback_demo()
    c_t, s_t = TORCH_EX["callbacks_example"].evaluation_callback_demo(**DEV)
    same_run(s_t, sj)
    # told before each evaluation (the host loop's departure, ROADMAP.md
    # section 3): at least once an iteration
    assert c_t["new_point"] >= len(s_t.iterations) - 1


def test_circle_fit_robust():
    m_j, m_t = JAX_EX["circle_fit"], TORCH_EX["circle_fit"]
    pts = m_j.synthesize(num_points=60, outliers=4, cx=2.0, cy=3.0, r=5.0,
                         seed=1)
    *xj, sj = m_j.fit_circle(pts, pts[0, 0], pts[0, 1], 1.0,
                             robust_threshold=0.5)
    *xt, s_t = m_t.fit_circle(pts, pts[0, 0], pts[0, 1], 1.0,
                              robust_threshold=0.5, **DEV)
    same_run(s_t, sj)
    np.testing.assert_allclose(xt, xj, rtol=1e-9)
    assert abs(xt[0] - 2.0) < 0.1 and abs(xt[2] - 5.0) < 0.1


def test_ellipse_approximation_small():
    m_j, m_t = JAX_EX["ellipse_approximation"], \
        TORCH_EX["ellipse_approximation"]
    pts = m_j.synthesize_ellipse_points(n=40, seed=5)
    Xj, _, sj = m_j.solve_ellipse(pts, num_segments=24, max_iterations=40)
    Xt, _, s_t = m_t.solve_ellipse(pts, num_segments=24, max_iterations=40,
                                   **DEV)
    same_run(s_t, sj)
    assert s_t.num_linear_solver_iterations == \
        sj.num_linear_solver_iterations
    np.testing.assert_allclose(Xt, Xj, atol=1e-8)


def test_libmv_homography():
    Hj, H_true = JAX_EX["libmv_homography"].main()
    Ht, H_true_t, s_t = TORCH_EX["libmv_homography"].main(["--device",
                                                           "cpu"])
    np.testing.assert_allclose(Ht / Ht[2, 2], H_true, atol=1e-5)
    np.testing.assert_allclose(Ht, Hj, rtol=1e-9, atol=1e-12)


def test_robot_pose_mle():
    m_j, m_t = JAX_EX["robot_pose_mle"], TORCH_EX["robot_pose_mle"]
    odo, rng = m_j.simulate_robot(corridor_length=5.0, pose_separation=0.5,
                                  seed=2)
    bj, sj = m_j.solve_robot_pose_mle(odo, rng, corridor_length=5.0)
    bt, s_t = m_t.solve_robot_pose_mle(odo, rng, corridor_length=5.0, **DEV)
    same_run(s_t, sj)
    np.testing.assert_allclose(np.concatenate(bt), np.concatenate(bj),
                               rtol=1e-9)
    assert abs(sum(float(b[0]) for b in bt) - 5.0) < 0.05


@pytest.mark.parametrize("which", ["sampled_function_1d", "bicubic_2d"])
def test_sampled_function(which):
    xj, sj = getattr(JAX_EX["sampled_function"], which)()
    xt, s_t = getattr(TORCH_EX["sampled_function"], which)(**DEV)
    same_run(s_t, sj)
    np.testing.assert_allclose(xt, xj, rtol=1e-8)


@pytest.mark.parametrize("key", ["1U", "5U", "13U", "15U", "3C", "4C", "5C",
                                 "9C"])
def test_more_garbow_hillstrom(key):
    number, constrained = int(key[:-1]), key[-1] == "C"
    m_j, m_t = JAX_EX["more_garbow_hillstrom"], \
        TORCH_EX["more_garbow_hillstrom"]
    lj, sj, xj = m_j.solve_mgh(m_j.BY_NUMBER[number],
                               constrained=constrained)
    lt, s_t, xt = m_t.solve_mgh(m_t.BY_NUMBER[number],
                                constrained=constrained, **DEV)
    ref = MGH_REF[key]
    same_run(s_t, sj, spread=(ref[2], ref[3]), key=key)
    assert lt >= 4.0 and lj >= 4.0
    if constrained:
        p = m_t.BY_NUMBER[number]
        assert np.all(xt >= np.asarray(p.lower_bounds) - 1e-12)
        assert np.all(xt <= np.asarray(p.upper_bounds) + 1e-12)
