"""Homography estimation with a callback that ends the solve.

Counterpart of ceres_tpu/examples/libmv_homography.py (the reference's
examples/libmv_homography.cc), on `device` (default cuda): minimizes the
symmetric geometric transfer error of a 3x3 homography between two point
sets, h22 pinned to 1 by a SubsetManifold (8 free parameters), and stops
through an IterationCallback once the largest symmetric distance falls
below the expected one.

    python -m ceres_tpu_torch.examples.libmv_homography [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _adjugate3(H):
    """The adjugate of a 3x3 matrix (H^-1 = adj(H) / det(H))."""
    rows = []
    for i in range(3):
        rows.append(torch.stack([
            H[(j + 1) % 3, (i + 1) % 3] * H[(j + 2) % 3, (i + 2) % 3]
            - H[(j + 1) % 3, (i + 2) % 3] * H[(j + 2) % 3, (i + 1) % 3]
            for j in range(3)]))
    return torch.stack(rows)


def symmetric_geometric_distance_terms(H, x1, x2):
    """Forward and backward transfer errors (libmv_homography.cc:27-46);
    H [3, 3], x1 and x2 [2]. Returns ([2], [2]). H^-1 y is taken as
    adj(H) y, its scale dropping out of the dehomogenization:
    torch.linalg.solve's forward derivative under vmap gives NaN past the
    first batch entry (PyTorch 2.13, ROADMAP.md section 3)."""
    one = torch.ones(1, dtype=x1.dtype, device=x1.device)
    x = torch.cat([x1, one])
    y = torch.cat([x2, one])
    Hx = H @ x
    fwd = Hx[:2] / Hx[2] - x2
    Hinv_y = _adjugate3(H) @ y
    bwd = Hinv_y[:2] / Hinv_y[2] - x1
    return fwd, bwd


def symmetric_geometric_distance(H, x1, x2):
    fwd, bwd = symmetric_geometric_distance_terms(H, x1, x2)
    return float(torch.sum(fwd * fwd) + torch.sum(bwd * bwd))


class HomographySymmetricGeometricCost:
    """Four residuals over H as a row-major 9-vector."""

    def __init__(self, x1, y1, x2, y2):
        self.x1 = x1
        self.y1 = y1
        self.x2 = x2
        self.y2 = y2

    def __call__(self, h):
        H = h.reshape(3, 3)
        p1 = torch.stack([torch.as_tensor(self.x1).to(h),
                          torch.as_tensor(self.y1).to(h)])
        p2 = torch.stack([torch.as_tensor(self.x2).to(h),
                          torch.as_tensor(self.y2).to(h)])
        fwd, bwd = symmetric_geometric_distance_terms(H, p1, p2)
        return torch.cat([fwd, bwd])


class TerminationCheckingCallback:
    """Stops once the largest symmetric distance over the correspondences
    is at most the expected average (libmv_homography.cc:140-170); reads
    the live H, so the solve sets update_state_every_iteration."""

    def __init__(self, x1, x2, h, expected_average_symmetric_distance):
        self.x1 = x1
        self.x2 = x2
        self.h = h
        self.expected = expected_average_symmetric_distance

    def __call__(self, summary):
        import ceres_tpu_torch as ctt
        if not summary.step_is_successful:
            return ctt.CallbackReturnType.SOLVER_CONTINUE
        H = torch.as_tensor(self.h.reshape(3, 3))
        worst = max(symmetric_geometric_distance(
            H, torch.as_tensor(self.x1[i]), torch.as_tensor(self.x2[i]))
            for i in range(len(self.x1)))
        if worst <= self.expected:
            return ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ctt.CallbackReturnType.SOLVER_CONTINUE


def estimate_homography(x1: np.ndarray, x2: np.ndarray,
                        expected_average_symmetric_distance: float = 1e-16,
                        max_num_iterations: int = 50, device: str = "cuda"):
    """Returns (H [3, 3], summary); x1 and x2 are [n, 2] correspondences.
    The start is the identity (the reference seeds from a 4-point DLT)."""
    import ceres_tpu_torch as ctt

    h = np.eye(3).reshape(-1)
    problem = ctt.Problem()
    for i in range(len(x1)):
        cost = ctt.AutoDiffCostFunction(
            HomographySymmetricGeometricCost(
                float(x1[i, 0]), float(x1[i, 1]),
                float(x2[i, 0]), float(x2[i, 1])), 4, [9])
        problem.add_residual_block(cost, None, h)
    problem.set_manifold(h, ctt.SubsetManifold(9, [8]))   # h22 = 1

    callback = TerminationCheckingCallback(
        x1, x2, h, expected_average_symmetric_distance)
    options = ctt.SolverOptions(
        max_num_iterations=max_num_iterations,
        update_state_every_iteration=True, callbacks=[callback],
        device=device)
    summary = ctt.solve(options, problem)
    return h.reshape(3, 3), summary


def reference_correspondences():
    """The reference demo's quad, mapped by a known homography:
    (H_true, x1, x2)."""
    H_true = np.array([[1.243715, -0.461057, -111.964454],
                       [0.0, 0.617589, -192.379252],
                       [0.0, -0.000983, 1.0]])
    x1 = np.array([[0.0, 0.0], [320.0, 0.0], [320.0, 240.0], [0.0, 240.0],
                   [160.0, 120.0], [80.0, 60.0]])
    x2 = []
    for p in x1:
        v = H_true @ np.array([p[0], p[1], 1.0])
        x2.append(v[:2] / v[2])
    return H_true, x1, np.asarray(x2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    H_true, x1, x2 = reference_correspondences()
    H, summary = estimate_homography(x1, x2, device=args.device)
    print(summary.brief_report())
    print("H estimated (scaled):")
    print(H / H[2, 2])
    print("H true:")
    print(H_true)
    return H, H_true, summary


if __name__ == "__main__":
    main()
