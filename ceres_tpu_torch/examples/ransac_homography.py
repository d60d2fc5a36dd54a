"""RANSAC homography with batched hypothesis refinement.

Counterpart of ceres_tpu/examples/ransac_homography.py (no reference
analog; the demo of solve_batched): classic RANSAC refines each
minimal-sample hypothesis with its own small nonlinear solve. Here all K
refinements run through `solve_batched`: the same structure (four
correspondences, an 8-DoF H with h22 pinned by a SubsetManifold),
different data per hypothesis. In batch mode every LM iteration of the K
refinements is one set of batched tensor operations. The refined
hypotheses are then scored by inlier count under a symmetric transfer
error threshold (all hypotheses against all points in one array
operation) and the winner is polished on all its inliers.

The cost is examples/libmv_homography.py's (the reference's
examples/libmv_homography.cc:27-46).

    python -m ceres_tpu_torch.examples.ransac_homography [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .libmv_homography import HomographySymmetricGeometricCost


def build_refine_problem(x1, x2, h):
    """One hypothesis-refinement problem over the given correspondences
    (h: the 9-vector being refined, H[2,2] pinned by SubsetManifold)."""
    import ceres_tpu_torch as ctt
    problem = ctt.Problem()
    for i in range(len(x1)):
        cost = ctt.AutoDiffCostFunction(
            HomographySymmetricGeometricCost(
                float(x1[i, 0]), float(x1[i, 1]),
                float(x2[i, 0]), float(x2[i, 1])), 4, [9])
        problem.add_residual_block(cost, None, h)
    problem.set_manifold(h, ctt.SubsetManifold(9, [8]))
    return problem


def dlt_homography(x1, x2):
    """Direct linear transform from >= 4 correspondences (the minimal
    sample's initializer). Returns the 9-vector with H[2,2] = 1, or None
    when the sample is degenerate."""
    A = []
    for (u, v), (up, vp) in zip(x1, x2):
        A.append([u, v, 1, 0, 0, 0, -up * u, -up * v, -up])
        A.append([0, 0, 0, u, v, 1, -vp * u, -vp * v, -vp])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    h = Vt[-1]
    if abs(h[8]) < 1e-12:
        return None
    return h / h[8]


def hypotheses(x1, x2, num_hypotheses, seed):
    """The minimal samples and their DLT initializations, drawn as the JAX
    example draws them: (sample indices [K, 4], h [K][9])."""
    rng = np.random.default_rng(seed)
    n = len(x1)
    samples, hs = [], []
    while len(hs) < num_hypotheses:
        idx = rng.choice(n, size=4, replace=False)
        h0 = dlt_homography(x1[idx], x2[idx])
        if h0 is None:
            continue
        samples.append(idx)
        hs.append(np.asarray(h0, dtype=np.float64))
    return np.asarray(samples), hs


def symmetric_distances(hs, x1, x2):
    """Symmetric transfer error [K, n] of each hypothesis (hs [K, 9]) at
    each correspondence, in f64 numpy (H^-1 y taken as adj(H) y)."""
    H = np.asarray(hs, np.float64).reshape(-1, 3, 3)
    x = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    y = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    Hx = np.einsum("kij,nj->kni", H, x)
    adj = np.stack([np.cross(H[:, :, (i + 1) % 3], H[:, :, (i + 2) % 3])
                    for i in range(3)], axis=1)
    Hy = np.einsum("kij,nj->kni", adj, y)
    fwd = Hx[..., :2] / Hx[..., 2:] - x2[None]
    bwd = Hy[..., :2] / Hy[..., 2:] - x1[None]
    return np.sum(fwd * fwd, axis=-1) + np.sum(bwd * bwd, axis=-1)


def ransac_homography(x1: np.ndarray, x2: np.ndarray,
                      num_hypotheses: int = 16,
                      inlier_threshold: float = 1e-2, seed: int = 0,
                      device: str = "cuda", batch_mode: str = "auto"):
    """Returns (H [3,3], inlier_mask, (summaries, polish summary)).
    x1, x2: [n, 2]."""
    import ceres_tpu_torch as ctt

    options = ctt.SolverOptions(max_num_iterations=20,
                                function_tolerance=1e-10, device=device,
                                batch_mode=batch_mode)
    samples, hs = hypotheses(x1, x2, num_hypotheses, seed)
    problems = [build_refine_problem(x1[idx], x2[idx], h)
                for idx, h in zip(samples, hs)]
    summaries = ctt.solve_batched(options, problems)

    # score every refined hypothesis by inlier count (the first best wins)
    masks = symmetric_distances(np.stack(hs), x1, x2) < inlier_threshold
    counts = masks.sum(axis=1)
    best = int(np.argmax(counts))
    if counts[best] < 4:
        raise RuntimeError("RANSAC found no viable hypothesis")
    best_mask = masks[best]

    # polish the winner on all inliers
    h = hs[best].copy()
    polish = build_refine_problem(x1[best_mask], x2[best_mask], h)
    s = ctt.solve(options, polish)
    return h.reshape(3, 3), best_mask, (summaries, s)


def synthetic_correspondences(n, n_out, seed=4):
    """n correspondences under the example's H, 1e-4 inlier noise and
    n_out gross outliers moved by 0.3-1.0: (x1, x2, H_true, outliers)."""
    rng = np.random.default_rng(seed)
    H_true = np.array([[1.02, 0.01, 0.3],
                       [-0.02, 0.98, -0.2],
                       [1e-4, -2e-4, 1.0]])
    x1 = rng.uniform(-1, 1, (n, 2))
    x1h = np.concatenate([x1, np.ones((n, 1))], axis=1)
    x2h = x1h @ H_true.T
    x2 = x2h[:, :2] / x2h[:, 2:]
    x2 += 1e-4 * rng.standard_normal(x2.shape)          # inlier noise
    out = rng.choice(n, size=n_out, replace=False)      # gross outliers
    x2[out] += rng.uniform(0.3, 1.0, (n_out, 2))
    return x1, x2, H_true, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch_mode", default="auto")
    args = ap.parse_args(argv)
    n, n_out = 60, 15
    x1, x2, H_true, out = synthetic_correspondences(n, n_out)
    H, mask, (summaries, s_polish) = ransac_homography(
        x1, x2, device=args.device, batch_mode=args.batch_mode)
    H = H / H[2, 2]
    err = np.linalg.norm(H - H_true / H_true[2, 2])
    true_inliers = np.ones(n, bool)
    true_inliers[out] = False
    print(f"hypotheses refined (batched): {len(summaries)}")
    print(f"inliers found: {int(mask.sum())}/{n - n_out} true inliers, "
          f"outliers admitted: {int((mask & ~true_inliers).sum())}")
    print(f"||H - H_true||_F = {err:.2e}")
    print(f"polish: {s_polish.brief_report()}")
    assert err < 1e-2, err
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
