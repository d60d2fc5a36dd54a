"""Sampled-function and bicubic-interpolation costs.

Counterpart of ceres_tpu/examples/sampled_function.py (the reference's
examples/sampled_function.cc and bicubic_interpolation.cc), on `device`
(default cuda). 1D: minimize a CubicInterpolator over samples of
f(x) = (x - 4.5)^2, the interpolator inside an autodiff cost. 2D:
recover the shift that aligns four samples of f(x, y) = x^2 - yx + y^2
through a BiCubicInterpolator on a grid with negative index offsets.

    python -m ceres_tpu_torch.examples.sampled_function [1d|2d]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def sampled_function_1d(device: str = "cuda"):
    """Returns (x, summary); x goes from 1.0 to about 4.5."""
    import ceres_tpu_torch as ctt

    values = np.array([(i - 4.5) ** 2 for i in range(10)])
    interpolator = ctt.CubicInterpolator(ctt.Grid1D(values))

    class InterpolatedCost:
        def __call__(self, x):
            return torch.reshape(interpolator(x[0]), (1,))

    x = np.array([1.0])
    problem = ctt.Problem()
    problem.add_residual_block(
        ctt.AutoDiffCostFunction(InterpolatedCost(), 1, [1]), None, x)
    summary = ctt.solve(ctt.SolverOptions(max_num_iterations=100,
                                          device=device), problem)
    print(summary.brief_report())
    print(f"x: 1.0 -> {x[0]:.6g} (expected 4.5)")
    return float(x[0]), summary


def bicubic_2d(device: str = "cuda"):
    """Returns (shift, summary); the shift found is (1.234, 2.345)."""
    import ceres_tpu_torch as ctt

    def f(x, y):
        return x * x - y * x + y * y

    rows_half, cols_half = 9, 11
    yy, xx = np.meshgrid(np.arange(-rows_half, rows_half + 1),
                         np.arange(-cols_half, cols_half + 1),
                         indexing="ij")
    data = f(xx.astype(float), yy.astype(float))
    interp = ctt.BiCubicInterpolator(ctt.Grid2D(
        data, row_begin=-rows_half, row_end=rows_half + 1,
        col_begin=-cols_half, col_end=cols_half + 1))

    true_shift = np.array([1.234, 2.345])
    points = np.array([[-2.0, -3.0], [-2.0, 3.0], [2.0, 3.0], [2.0, -3.0]])

    class BiCubicCost:
        def __init__(self, px, py, value):
            self.px = px
            self.py = py
            self.value = value

        def __call__(self, s):
            v = interp(self.py + s[1], self.px + s[0])
            return torch.reshape(v - self.value, (1,))

    shift = np.array([3.1415, 1.337])
    problem = ctt.Problem()
    for p in points:
        sx, sy = p + true_shift
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(
                BiCubicCost(float(p[0]), float(p[1]), float(f(sx, sy))),
                1, [2]), None, shift)
    summary = ctt.solve(ctt.SolverOptions(max_num_iterations=100,
                                          device=device), problem)
    print(summary.brief_report())
    print(f"shift found: ({shift[0]:.4g}, {shift[1]:.4g}) "
          f"(expected {tuple(true_shift)})")
    return shift, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="1d", choices=("1d", "2d"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.which == "2d":
        return bicubic_2d(args.device)
    return sampled_function_1d(args.device)


if __name__ == "__main__":
    main()
