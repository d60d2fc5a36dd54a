"""Blender/libmv production bundle adjuster.

Counterpart of ceres_tpu/examples/libmv_bundle_adjuster.py (the
reference's examples/libmv_bundle_adjuster.cc): refine camera motion
(angle-axis + translation 6-vectors), 3D tracks and optionally a shared
8-parameter OpenCV intrinsics block (f, cx, cy, k1, k2, k3, p1, p2: radial
and tangential distortion) against 2D markers read from the binary problem
files (io/libmv.py). The intrinsics refinement flags are the reference's
BUNDLE_* bitmask; the components not refined are pinned with a
SubsetManifold (libmv_bundle_adjuster.cc:744-770). Defaults:
ITERATIVE_SCHUR with SCHUR_JACOBI, inner iterations, f64 (the host loop
over the generic Schur step; no kernel).

    python -m ceres_tpu_torch.examples.libmv_bundle_adjuster
        --input problem.bin [--refine_intrinsics BITMASK] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import rotation as rot
from ..io.libmv import (BUNDLE_FOCAL_LENGTH, BUNDLE_NO_INTRINSICS,
                        BUNDLE_PRINCIPAL_POINT, BUNDLE_RADIAL_K1,
                        BUNDLE_RADIAL_K2, BUNDLE_TANGENTIAL_P1,
                        BUNDLE_TANGENTIAL_P2, LibmvProblem,
                        read_libmv_problem)


class OpenCVReprojectionError:
    """intrinsics [8], R_t [6] (angle-axis + t), X [3]
    (libmv_bundle_adjuster.cc OpenCVReprojectionError)."""

    def __init__(self, observed_x: float, observed_y: float):
        self.observed_x = observed_x
        self.observed_y = observed_y

    def __call__(self, intrinsics, R_t, X):
        focal = intrinsics[0]
        cx, cy = intrinsics[1], intrinsics[2]
        k1, k2, k3 = intrinsics[3], intrinsics[4], intrinsics[5]
        p1, p2 = intrinsics[6], intrinsics[7]

        x = rot.angle_axis_rotate_point(R_t[:3], X) + R_t[3:6]
        xn = x[0] / x[2]
        yn = x[1] / x[2]
        r2 = xn * xn + yn * yn
        r_coeff = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = xn * r_coeff + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        yd = yn * r_coeff + 2.0 * p2 * xn * yn + p1 * (r2 + 2.0 * yn * yn)
        predicted_x = focal * xd + cx
        predicted_y = focal * yd + cy
        return torch.stack([predicted_x - self.observed_x,
                            predicted_y - self.observed_y])


def intrinsics_manifold_constants(bundle_intrinsics: int):
    """The intrinsics components a BUNDLE_* mask leaves constant (K3 is
    never refined, the reference's :762)."""
    constant = []
    if not bundle_intrinsics & BUNDLE_FOCAL_LENGTH:
        constant.append(0)
    if not bundle_intrinsics & BUNDLE_PRINCIPAL_POINT:
        constant += [1, 2]
    if not bundle_intrinsics & BUNDLE_RADIAL_K1:
        constant.append(3)
    if not bundle_intrinsics & BUNDLE_RADIAL_K2:
        constant.append(4)
    constant.append(5)
    if not bundle_intrinsics & BUNDLE_TANGENTIAL_P1:
        constant.append(6)
    if not bundle_intrinsics & BUNDLE_TANGENTIAL_P2:
        constant.append(7)
    return constant


def build_libmv_problem(lp: LibmvProblem,
                        bundle_intrinsics: int = BUNDLE_NO_INTRINSICS):
    """Returns (problem, intrinsics array, camera R_t dict, point dict)."""
    import ceres_tpu_torch as ctt

    if not lp.is_image_space:
        raise ValueError("normalized-space markers need BUNDLE_INTRINSICS "
                         "(libmv_bundle_adjuster.cc:833)")
    intrinsics = lp.intrinsics.copy()
    cam_rt = {}
    for image, (R, t) in lp.cameras.items():
        aa = rot.rotation_matrix_to_angle_axis(
            torch.as_tensor(R, dtype=torch.float64)).numpy()
        cam_rt[image] = np.concatenate([aa, t])
    pts = {track: X.copy() for track, X in lp.points.items()}

    problem = ctt.Problem()
    num_residuals = 0
    for (image, track, x, y) in lp.markers:
        if image not in cam_rt or track not in pts:
            continue
        cost = ctt.AutoDiffCostFunction(
            OpenCVReprojectionError(float(x), float(y)), 2, [8, 6, 3])
        problem.add_residual_block(cost, None, intrinsics, cam_rt[image],
                                   pts[track])
        num_residuals += 1
    if num_residuals == 0:
        raise ValueError("no usable markers")
    if bundle_intrinsics == BUNDLE_NO_INTRINSICS:
        problem.set_parameter_block_constant(intrinsics)
    else:
        problem.set_manifold(intrinsics, ctt.SubsetManifold(
            8, intrinsics_manifold_constants(bundle_intrinsics)))
    return problem, intrinsics, cam_rt, pts


def solve_libmv(path: str, bundle_intrinsics: int = BUNDLE_NO_INTRINSICS,
                max_iterations: int = 100, options=None,
                device: str = "cuda"):
    import ceres_tpu_torch as ctt
    lp = read_libmv_problem(path)
    problem, intrinsics, cam_rt, pts = build_libmv_problem(
        lp, bundle_intrinsics)
    if options is None:
        options = ctt.SolverOptions(
            linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
            use_inner_iterations=True, max_num_iterations=max_iterations,
            device=device)
    summary = ctt.solve(options, problem)
    return summary, intrinsics, cam_rt, pts


def synthetic_libmv_problem(num_cameras=333, num_tracks=26,
                            num_markers=5421, seed=0, pixel_noise=0.5,
                            perturb=(0.002, 0.02, 0.05)):
    """A seeded LibmvProblem at a published file's shape (the default:
    data/libmv-ba-problems/problem_01.bin's 333 cameras, 26 tracks and
    5,421 image-space markers): cameras on a 6 m dolly past a 6 m cloud of
    tracks 8-14 m away, turning by -+0.4 rad, OpenCV intrinsics with
    radial and tangential distortion, markers projected with
    `pixel_noise`, then the cameras (rotation and translation sigmas) and
    tracks (point sigma) perturbed by `perturb`. For tests and smoke runs,
    which have no published files."""
    rng = np.random.default_rng(seed)
    intr = np.array([1100.0, 960.0, 540.0, -0.05, 0.01, 0.0, 1e-4, -1e-4])
    center = np.array([0.0, 0.0, 11.0])
    pts = {t: center + np.array([rng.uniform(-3, 3), rng.uniform(-2, 2),
                                 rng.uniform(-3, 3)])
           for t in range(num_tracks)}
    cams = {}
    for i in range(num_cameras):
        s = 2.0 * i / max(1, num_cameras - 1) - 1.0          # -1 .. 1
        aa = np.array([0.03 * np.sin(2.5 * s), -0.4 * s,
                       0.02 * np.cos(2.0 * s)])
        R = rot.angle_axis_to_rotation_matrix(torch.as_tensor(aa)).numpy()
        pos = np.array([3.0 * s, 0.5 * np.sin(1.5 * s + 1.5), 0.0])
        cams[i] = (R, -R @ pos)
    pairs = [(i, t) for i in range(num_cameras) for t in range(num_tracks)]
    pick = rng.choice(len(pairs), size=num_markers, replace=False)
    cost = OpenCVReprojectionError(0.0, 0.0)
    intr_t = torch.as_tensor(intr)
    markers = []
    for k in sorted(pick):
        i, t = pairs[k]
        R, tt = cams[i]
        aa = rot.rotation_matrix_to_angle_axis(torch.as_tensor(R)).numpy()
        uv = cost(intr_t, torch.as_tensor(np.concatenate([aa, tt])),
                  torch.as_tensor(pts[t])).numpy()
        uv = uv + pixel_noise * rng.standard_normal(2)
        markers.append((i, t, float(uv[0]), float(uv[1])))
    rs, ts, ps = perturb
    cams_p = {}
    for i, (R, t) in cams.items():
        dR = rot.angle_axis_to_rotation_matrix(
            torch.as_tensor(rs * rng.standard_normal(3))).numpy()
        cams_p[i] = (dR @ R, t + ts * rng.standard_normal(3))
    pts_p = {t: X + ps * rng.standard_normal(3) for t, X in pts.items()}
    return LibmvProblem(True, intr, cams_p, pts_p, markers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--refine_intrinsics", type=int,
                    default=BUNDLE_NO_INTRINSICS)
    ap.add_argument("--max_iterations", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary, intrinsics, cam_rt, pts = solve_libmv(
        args.input, args.refine_intrinsics, args.max_iterations,
        device=args.device)
    print(summary.full_report())
    print(f"intrinsics: f={intrinsics[0]:.4f} cx={intrinsics[1]:.4f} "
          f"cy={intrinsics[2]:.4f} k1={intrinsics[3]:.6f} "
          f"k2={intrinsics[4]:.6f}")


if __name__ == "__main__":
    main()
