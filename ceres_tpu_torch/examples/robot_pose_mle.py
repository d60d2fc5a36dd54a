"""Robot pose MLE: the DynamicAutoDiffCostFunction demo.

Counterpart of ceres_tpu/examples/robot_pose_mle.py (the reference's
examples/robot_pose_mle.cc), on `device` (default cuda). A robot drives
down a corridor, reading noisy odometry and a noisy range to the
corridor's end. Each relative pose is one 1-D parameter block; an
OdometryConstraint names one, the RangeConstraint at pose i names poses
0..i: a parameter count chosen at run time, so each range constraint is
a bucket of its own.

    python -m ceres_tpu_torch.examples.robot_pose_mle
        [--corridor_length L] [--pose_separation D]
        [--odometry_stddev S] [--range_stddev S] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


class OdometryConstraint:
    def __init__(self, odometry_mean: float, odometry_stddev: float):
        self.odometry_mean = odometry_mean
        self.odometry_stddev = odometry_stddev

    def __call__(self, odometry):
        return (odometry - self.odometry_mean) / self.odometry_stddev


class RangeConstraint:
    def __init__(self, range_reading: float, range_stddev: float,
                 corridor_length: float):
        self.range_reading = range_reading
        self.range_stddev = range_stddev
        self.corridor_length = corridor_length

    def __call__(self, relative_poses):
        global_pose = torch.sum(torch.cat(
            [torch.reshape(p, (1,)) for p in relative_poses]))
        return torch.reshape(
            (global_pose + self.range_reading - self.corridor_length)
            / self.range_stddev, (1,))


def simulate_robot(corridor_length=30.0, pose_separation=0.5,
                   odometry_stddev=0.1, range_stddev=0.01, seed=0):
    rng = np.random.default_rng(seed)
    num_steps = int(np.ceil(corridor_length / pose_separation))
    odometry_values, range_readings = [], []
    location = 0.0
    for _ in range(num_steps):
        actual_odometry = min(pose_separation, corridor_length - location)
        location += actual_odometry
        odometry_values.append(actual_odometry
                               + rng.normal(0.0, odometry_stddev))
        range_readings.append((corridor_length - location)
                              + rng.normal(0.0, range_stddev))
    return odometry_values, range_readings


def solve_robot_pose_mle(odometry_values, range_readings,
                         corridor_length=30.0, odometry_stddev=0.1,
                         range_stddev=0.01, options=None,
                         device: str = "cuda"):
    """Returns (the corrected odometry as 1-arrays, summary)."""
    import ceres_tpu_torch as ctt

    blocks = [np.array([v]) for v in odometry_values]
    problem = ctt.Problem()
    for i, (odo, rng_read) in enumerate(zip(odometry_values,
                                            range_readings)):
        problem.add_residual_block(
            ctt.AutoDiffCostFunction(
                OdometryConstraint(float(odo), odometry_stddev), 1, [1]),
            None, blocks[i])
        range_cost = ctt.DynamicAutoDiffCostFunction(
            RangeConstraint(float(rng_read), range_stddev, corridor_length))
        for _ in range(i + 1):
            range_cost.add_parameter_block(1)
        range_cost.set_num_residuals(1)
        problem.add_residual_block(range_cost, None, *blocks[:i + 1])

    if options is None:
        options = ctt.SolverOptions(max_num_iterations=500, device=device)
    summary = ctt.solve(options, problem)
    return blocks, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corridor_length", type=float, default=30.0)
    ap.add_argument("--pose_separation", type=float, default=0.5)
    ap.add_argument("--odometry_stddev", type=float, default=0.1)
    ap.add_argument("--range_stddev", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    odometry, ranges = simulate_robot(
        args.corridor_length, args.pose_separation,
        args.odometry_stddev, args.range_stddev)
    blocks, summary = solve_robot_pose_mle(
        odometry, ranges, args.corridor_length, args.odometry_stddev,
        args.range_stddev, device=args.device)
    print(summary.brief_report())
    loc = sum(float(b[0]) for b in blocks)
    print(f"final estimated location: {loc:.4f} "
          f"(corridor length {args.corridor_length})")
    return blocks, summary


if __name__ == "__main__":
    main()
