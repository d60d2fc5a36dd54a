"""Ellipse approximation by a closed piecewise-linear contour.

Counterpart of ceres_tpu/examples/ellipse_approximation.py (the
reference's examples/ellipse_approximation.cc, its dynamic_sparsity
demo), on `device` (default cuda). Each data point y_i has a preimage
t_i on the contour; its residual y_i - ((1 - u) X[i0] + u X[i1]) names
the whole contour X (one parameter block) but depends on two of its
control points, which the cost gathers with index tensors (under vmap).
Solved with CGNR; dynamic_sparsity=True is passed as the JAX example
does.

    python -m ceres_tpu_torch.examples.ellipse_approximation
        [--num_segments N] [--num_points N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _rows(X2, idx):
    """X2[idx] for a 0-d (possibly batched) index tensor."""
    return torch.index_select(X2, 0, idx.reshape(1))[0]


class PointToContourCost:
    """residuals (2,): the data point minus its linear interpolation on
    the closed contour; params t (1,) and the contour X (num_segments * 2,)
    flattened, whose size fixes the segment count."""

    def __init__(self, y0: float, y1: float):
        self.y0 = y0
        self.y1 = y1

    def __call__(self, t, X):
        X2 = X.reshape(-1, 2)
        n = X2.shape[0]
        tm = t[0] - n * torch.floor(t[0] / n)      # modulo n, in [0, n)
        i0 = torch.floor(tm).long()
        i1 = torch.remainder(i0 + 1, n)
        u = tm - i0
        p = (1.0 - u) * _rows(X2, i0) + u * _rows(X2, i1)
        return torch.stack([torch.as_tensor(self.y0).to(X),
                            torch.as_tensor(self.y1).to(X)]) - p


class EuclideanDistanceCost:
    """sqrt_weight (X[i] - X[j]), the contour's smoothness term
    (EuclideanDistanceFunctor); i and j are per-block data."""

    def __init__(self, i: int, j: int, sqrt_weight: float):
        self.i = i
        self.j = j
        self.sqrt_weight = sqrt_weight

    def __call__(self, X):
        X2 = X.reshape(-1, 2)
        i = torch.as_tensor(self.i, device=X.device)
        j = torch.as_tensor(self.j, device=X.device)
        return self.sqrt_weight * (_rows(X2, i) - _rows(X2, j))


def synthesize_ellipse_points(n=212, a=4.0, b=1.4, noise=0.02, seed=3):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=n)
    pts = np.stack([a * np.cos(theta), b * np.sin(theta)], axis=1)
    return pts + rng.normal(0.0, noise, size=pts.shape)


def solve_ellipse(points: np.ndarray, num_segments: int = 151,
                  regularization_weight: float = 1e-2,
                  dynamic_sparsity: bool = True, max_iterations: int = 100,
                  device: str = "cuda"):
    """Returns (X [num_segments, 2], t blocks, summary)."""
    import ceres_tpu_torch as ctt

    # the contour starts on the unit circle (the reference's main)
    w = np.linspace(0.0, 2.0 * np.pi, num_segments + 1)[:-1]
    X = np.stack([np.cos(w), np.sin(w)], axis=1).reshape(-1)
    # each point's preimage starts at its nearest contour vertex
    X2 = X.reshape(num_segments, 2)
    d = ((points[:, None, :] - X2[None, :, :]) ** 2).sum(-1)
    t_init = np.argmin(d, axis=1).astype(np.float64)

    problem = ctt.Problem()
    t_blocks = [np.array([ti]) for ti in t_init]
    for i, (y0, y1) in enumerate(points):
        cost = ctt.AutoDiffCostFunction(
            PointToContourCost(float(y0), float(y1)), 2,
            [1, num_segments * 2])
        problem.add_residual_block(cost, None, t_blocks[i], X)
    sw = float(np.sqrt(regularization_weight))
    for i in range(num_segments):
        cost = ctt.AutoDiffCostFunction(
            EuclideanDistanceCost(i, (i + 1) % num_segments, sw), 2,
            [num_segments * 2])
        problem.add_residual_block(cost, None, X)

    options = ctt.SolverOptions(
        max_num_iterations=max_iterations,
        linear_solver_type=ctt.LinearSolverType.CGNR,
        dynamic_sparsity=dynamic_sparsity, function_tolerance=1e-10,
        device=device)
    summary = ctt.solve(options, problem)
    return X.reshape(num_segments, 2), t_blocks, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_segments", type=int, default=151)
    ap.add_argument("--num_points", type=int, default=212)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    points = synthesize_ellipse_points(args.num_points)
    X, t, summary = solve_ellipse(points, args.num_segments,
                                  device=args.device)
    print(summary.brief_report())
    d = np.sqrt(((points[:, None, :] - X[None, :, :]) ** 2).sum(-1)
                ).min(axis=1)
    print(f"mean point-to-contour-vertex distance: {d.mean():.4f}")
    return X, t, summary


if __name__ == "__main__":
    main()
