#!/usr/bin/env python3
"""The JAX package's references of chip_smoke.py's slice 16 phase
(`slice16_paths`) on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/slice16_reference.py [--parts
        OPENCV_IMPLICIT,SCALED_HUBER,ROW_HUBER,QUAT_ROW_CAUCHY,
        CAUCHY_DIAGNOSIS] [--small] [--conditioning]
        [--out scripts/slice16_reference.json]

OPENCV_IMPLICIT: chip_smoke.py's FULL_OPENCV problem (opencv_data at
IMPLICIT_SHAPE, opencv_functor built on jax.numpy) solved with
large_options and max_num_iterations OPENCV_REF_CAP from the perturbed
start and from it scaled by 1 - 1e-7 and 1 + 1e-7, so that the gate on
the port's final cost can be twice these runs' spread; the rest are the
LOSS_PATHS of chip_smoke.py, each solved once with loss_path_options.
CAUCHY_DIAGNOSIS is QUAT_ROW_CAUCHY with the package's own
SnavelyReprojectionErrorWithQuaternions in place of chip_smoke.py's
quaternion_functor (ITERATIVE_SCHUR, the path's options): its solve,
the state after its first LM iteration (each camera's quaternion norm;
the observation of largest residual, its camera, point and depth p_z in
the camera's frame), and the same problem under DENSE_SCHUR. Each run prints one line; the last line is a JSON object of
the references: per part the runs' [LM, CG] counts, final costs,
termination and walls, and the program's bucket count. --out writes the
parts run into that file (chip_smoke.py's SLICE16_REF_FILE) beside the
parts it holds already, and drops parts this script no longer makes.
--small solves OPENCV_IMPLICIT at a hundredth of its shape (a check of
the script, not a reference). --conditioning prints the condition number
of the FULL_OPENCV radial term's Jacobian in (k1..k6) at the mean
intrinsics of opencv_data, over the observations' normalized radii and
over r^2 <= 0.1. The full-size part takes several GB and minutes of CPU:
run it on a machine with the memory (the card's, with
CUDA_VISIBLE_DEVICES= ).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPENCV_REF_CAP = 200
OPENCV_SCALES = (1.0, 1.0 - 1e-7, 1.0 + 1e-7)
PARTS = ("OPENCV_IMPLICIT", "SCALED_HUBER", "ROW_HUBER", "QUAT_ROW_CAUCHY",
         "CAUCHY_DIAGNOSIS")
KEYS = PARTS + ("conditioning",)
CAUCHY = dict(loss="row_cauchy", quaternions=True, solver="ITERATIVE_SCHUR")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--conditioning", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import ceres_tpu as ct
    import chip_smoke as cs
    from ceres_tpu import rotation as jrot
    from ceres_tpu.io import bal as jbal
    from ceres_tpu.program import CompiledProgram
    parts = args.parts.split(",") if args.parts else list(PARTS)
    out = {}
    if args.conditioning:
        out["conditioning"] = conditioning(cs, jbal)
    for part in parts:
        runs = []
        if part == "CAUCHY_DIAGNOSIS":
            out[part] = cauchy_diagnosis(ct, cs, jbal, CompiledProgram)
            continue
        if part == "OPENCV_IMPLICIT":
            shape = ({k: max(1, v // 100) for k, v in
                      cs.IMPLICIT_SHAPE.items()} if args.small else None)
            t0 = time.time()
            data = cs.opencv_data(jbal, shape)
            print(f"{part}: data {time.time() - t0:.1f} s", flush=True)
            for scale in OPENCV_SCALES:
                t0 = time.time()
                problem = cs.opencv_problem(ct, jnp, jrot, data, scale)[0]
                t_build = time.time() - t0
                options = cs.large_options(ct,
                                           max_num_iterations=OPENCV_REF_CAP)
                runs.append(solve(ct, part, scale, options, problem,
                                  t_build, CompiledProgram))
        else:
            t0 = time.time()
            problem = cs.loss_path_problem(ct, jbal, part)[0]
            t_build = time.time() - t0
            runs.append(solve(ct, part, 1.0, cs.loss_path_options(ct, part),
                              problem, t_build, CompiledProgram))
        out[part] = dict(runs=runs, buckets=runs[0]["buckets"],
                         small=bool(args.small and part == "OPENCV_IMPLICIT"))
    if args.out:
        path = os.path.join(ROOT, args.out) if not os.path.isabs(
            args.out) else args.out
        held = {}
        if os.path.exists(path):
            with open(path) as fh:
                held = {k: v for k, v in json.load(fh).items()
                        if k in KEYS}
        held.update(out)
        with open(path, "w") as fh:
            json.dump(held, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(json.dumps(out))


def conditioning(cs, bal_io):
    """The condition number of d(radial term * r) / d(k1..k6) (the
    FULL_OPENCV model's distortion, opencv_functor) at opencv_data's mean
    intrinsics, over the normalized radii of its observations at the
    start (a hundredth of its shape) and over r^2 <= 0.1."""
    import numpy as np
    cams, points, cam_idx, pt_idx, _ = cs.opencv_data(
        bal_io, {k: max(1, v // 100) for k, v in cs.IMPLICIT_SHAPE.items()})
    k = cams[:, 10:18].mean(axis=0)
    k1, k2, k3, k4, k5, k6 = k[0], k[1], k[4], k[5], k[6], k[7]
    c = cams[cam_idx]
    aa = c[:, :3]
    th = np.linalg.norm(aa, axis=1, keepdims=True)
    w = aa / np.where(th > 0, th, 1.0)
    X = points[pt_idx]
    p = (X * np.cos(th) + np.cross(w, X) * np.sin(th)
         + w * np.sum(w * X, axis=1, keepdims=True) * (1.0 - np.cos(th))
         + c[:, 3:6])
    r2_obs = (p[:, 0] ** 2 + p[:, 1] ** 2) / p[:, 2] ** 2

    def cond(r2):
        r2 = np.sort(r2)
        num = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        den = 1 + r2 * (k4 + r2 * (k5 + r2 * k6))
        J = np.stack([r2 / den, r2 ** 2 / den, r2 ** 3 / den,
                      -num * r2 / den ** 2, -num * r2 ** 2 / den ** 2,
                      -num * r2 ** 3 / den ** 2], 1) * np.sqrt(r2)[:, None]
        sv = np.linalg.svd(J, compute_uv=False)
        return float(sv[0] / sv[-1])
    out = dict(mean_k=[float(x) for x in (k1, k2, k3, k4, k5, k6)],
               r2_max=float(r2_obs.max()),
               r2_median=float(np.median(r2_obs)),
               cond_observed=cond(r2_obs),
               cond_r2_le_0_1=cond(np.linspace(1e-4, 0.1, 2000)))
    print(f"conditioning: {out}", flush=True)
    return out


def cauchy_diagnosis(ct, cs, bal_io, program_cls):
    """CAUCHY_DIAGNOSIS (see the module docstring)."""
    import numpy as np
    runs = []
    t0 = time.time()
    problem = cs.loss_path_problem(ct, bal_io, None, cfg=CAUCHY)[0]
    runs.append(solve(ct, "CAUCHY_DIAGNOSIS", 1.0, cs.loss_path_options(
        ct, None, cfg=CAUCHY), problem, time.time() - t0, program_cls))
    problem, cams, pts = cs.loss_path_problem(ct, bal_io, None, cfg=CAUCHY)
    s = ct.solve(cs.loss_path_options(ct, None, cfg=CAUCHY,
                                      max_num_iterations=1), problem)
    bal = cs.quaternion_bal(bal_io)
    c = np.stack(cams)[bal.camera_index]
    X = np.stack(pts)[bal.point_index]
    q = c[:, :4]                       # UnitQuaternionRotatePoint
    uv = 2.0 * np.cross(q[:, 1:], X)
    p = X + q[:, :1] * uv + np.cross(q[:, 1:], uv) + c[:, 4:7]
    xp, yp = -p[:, 0] / p[:, 2], -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    d = 1.0 + r2 * (c[:, 8] + c[:, 9] * r2)
    res = np.stack([c[:, 7] * d * xp, c[:, 7] * d * yp], 1) \
        - bal.observations
    i = int(np.argmax(np.linalg.norm(res, axis=1)))
    first = dict(
        lm=int(s.num_iterations), accepted=int(s.num_successful_steps),
        final_cost=float(s.final_cost),
        quaternion_norms=[float(x) for x in
                          np.linalg.norm(np.stack(cams)[:, :4], axis=1)],
        worst_observation=i, camera=int(bal.camera_index[i]),
        point=int(bal.point_index[i]),
        residual=[float(x) for x in res[i]], depth=float(p[i, 2]),
        median_residual=float(np.median(np.linalg.norm(res, axis=1))))
    print(f"CAUCHY_DIAGNOSIS after one LM iteration: {first}", flush=True)
    dense = dict(CAUCHY, solver="DENSE_SCHUR")
    t0 = time.time()
    problem = cs.loss_path_problem(ct, bal_io, None, cfg=dense)[0]
    runs.append(solve(ct, "CAUCHY_DIAGNOSIS DENSE_SCHUR", 1.0,
                      cs.loss_path_options(ct, None, cfg=dense), problem,
                      time.time() - t0, program_cls))
    return dict(runs=runs, buckets=runs[0]["buckets"], small=False,
                after_one_iteration=first)


def solve(ct, part, scale, options, problem, t_build, program_cls):
    """One JAX solve: its counts, cost, termination, wall and buckets."""
    t0 = time.time()
    s = ct.solve(options, problem)
    wall = time.time() - t0
    buckets = len(program_cls.get_cached(problem, options).buckets) \
        if hasattr(program_cls, "get_cached") else None
    print(f"{part} start x {scale!r}: {s.termination_type}, "
          f"{s.num_iterations} LM ({s.num_successful_steps} accepted), "
          f"{s.num_linear_solver_iterations} linear iterations, initial "
          f"cost {s.initial_cost!r}, final cost {s.final_cost!r}; build "
          f"{t_build:.1f} s, solve {wall:.1f} s, buckets {buckets}",
          flush=True)
    return dict(scale=scale, lm=int(s.num_iterations),
                linear=int(s.num_linear_solver_iterations),
                final_cost=float(s.final_cost),
                initial_cost=float(s.initial_cost),
                termination=str(s.termination_type), wall=wall,
                buckets=buckets)


if __name__ == "__main__":
    main()
