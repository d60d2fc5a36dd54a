"""Circle fitting with an optional robust loss.

Counterpart of ceres_tpu/examples/circle_fit.py (the reference's
examples/circle_fit.cc), on `device` (default cuda): fits (x, y, r) to 2D
samples with r = m^2 (so that it stays positive) and the algebraic cost
r^2 - |p - c|^2 (circle_fit.cc:63-76), under CauchyLoss(T) when
--robust_threshold T is given.

    python -m ceres_tpu_torch.examples.circle_fit [--robust_threshold T]
        [--num_points N] [--outliers K] [--stdin] [--device cpu]

With --stdin it reads "x y r" and then the points' rows, as the
reference's main does; otherwise it synthesizes noisy samples.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


class DistanceFromCircleCost:
    def __init__(self, xx: float, yy: float):
        self.xx = xx
        self.yy = yy

    def __call__(self, x, y, m):
        r = m[0] * m[0]
        xp = self.xx - x[0]
        yp = self.yy - y[0]
        return torch.reshape(r * r - xp * xp - yp * yp, (1,))


def fit_circle(points: np.ndarray, x0: float, y0: float, r0: float,
               robust_threshold: float = 0.0, device: str = "cuda",
               check_gradients: bool = False):
    """Returns (x, y, r, summary)."""
    import ceres_tpu_torch as ctt

    x = np.array([x0])
    y = np.array([y0])
    m = np.array([np.sqrt(max(r0, 1e-12))])
    loss = (ctt.CauchyLoss(robust_threshold)
            if robust_threshold > 0.0 else None)
    problem = ctt.Problem()
    for xx, yy in points:
        cost = ctt.AutoDiffCostFunction(
            DistanceFromCircleCost(float(xx), float(yy)), 1, [1, 1, 1])
        problem.add_residual_block(cost, loss, x, y, m)
    options = ctt.SolverOptions(
        max_num_iterations=500,
        linear_solver_type=ctt.LinearSolverType.DENSE_QR,
        check_gradients=check_gradients, device=device)
    summary = ctt.solve(options, problem)
    return float(x[0]), float(y[0]), float(m[0] ** 2), summary


def synthesize(num_points=80, outliers=0, cx=2.0, cy=3.0, r=5.0,
               noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2 * np.pi, size=num_points)
    rr = r + rng.normal(0.0, noise, size=num_points)
    pts = np.stack([cx + rr * np.cos(theta), cy + rr * np.sin(theta)],
                   axis=1)
    if outliers:
        pts[:outliers] += rng.uniform(-3 * r, 3 * r, size=(outliers, 2))
    return pts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robust_threshold", type=float, default=0.0)
    ap.add_argument("--num_points", type=int, default=80)
    ap.add_argument("--outliers", type=int, default=0)
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.stdin:
        data = np.loadtxt(sys.stdin).reshape(-1)
        x0, y0, r0 = data[0], data[1], data[2]
        points = data[3:].reshape(-1, 2)
    else:
        points = synthesize(args.num_points, args.outliers)
        x0, y0, r0 = points[0, 0], points[0, 1], 1.0
    x, y, r, summary = fit_circle(points, x0, y0, r0, args.robust_threshold,
                                  device=args.device)
    print(summary.brief_report())
    print(f"circle: x={x:.6g} y={y:.6g} r={r:.6g}")


if __name__ == "__main__":
    main()
