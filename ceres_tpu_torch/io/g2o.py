"""g2o pose-graph file IO + synthetic pose-graph generators (numpy).

A copy of ceres_tpu/io/g2o.py (the port imports nothing of the JAX
package): the same generators give bitwise the same graphs. Capability
parity with the reference's examples/slam/common/read_g2o.h
(templated VERTEX/EDGE reader used by pose_graph_2d and pose_graph_3d) plus
the output writers. Since no g2o files ship with the reference, synthetic
generators produce standard loop-closure graphs (a noisy circle trajectory
with odometry + loop closures) for tests and benchmarks.

2D types: VERTEX_SE2 id x y yaw / EDGE_SE2 i j dx dy dyaw info(6 upper tri)
3D types: VERTEX_SE3:QUAT id x y z qx qy qz qw /
          EDGE_SE3:QUAT i j t(3) q(4, xyzw) info(21 upper tri)
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np


class Pose2d(NamedTuple):
    x: float
    y: float
    yaw: float


class Constraint2d(NamedTuple):
    id_begin: int
    id_end: int
    x: float
    y: float
    yaw: float
    information: np.ndarray  # [3,3]


class Pose3d(NamedTuple):
    p: np.ndarray            # [3]
    q: np.ndarray            # [4] (x,y,z,w) Eigen order


class Constraint3d(NamedTuple):
    id_begin: int
    id_end: int
    t: np.ndarray            # [3]
    q: np.ndarray            # [4] (x,y,z,w)
    information: np.ndarray  # [6,6]


def _sym_from_upper(vals, n):
    m = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i, n):
            m[i, j] = m[j, i] = vals[k]
            k += 1
    return m


def read_g2o_2d(path: str):
    poses: Dict[int, Pose2d] = {}
    constraints: List[Constraint2d] = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE2":
                i = int(tok[1])
                poses[i] = Pose2d(float(tok[2]), float(tok[3]),
                                  float(tok[4]))
            elif tok[0] == "EDGE_SE2":
                a, b = int(tok[1]), int(tok[2])
                dx, dy, dyaw = map(float, tok[3:6])
                info = _sym_from_upper([float(v) for v in tok[6:12]], 3)
                constraints.append(Constraint2d(a, b, dx, dy, dyaw, info))
    return poses, constraints


def write_g2o_2d(path: str, poses: Dict[int, Pose2d]):
    with open(path, "w") as f:
        for i in sorted(poses):
            p = poses[i]
            f.write(f"VERTEX_SE2 {i} {p.x} {p.y} {p.yaw}\n")


def read_g2o_3d(path: str):
    poses: Dict[int, Pose3d] = {}
    constraints: List[Constraint3d] = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                i = int(tok[1])
                vals = [float(v) for v in tok[2:9]]
                poses[i] = Pose3d(np.asarray(vals[:3]),
                                  np.asarray(vals[3:7]))
            elif tok[0] == "EDGE_SE3:QUAT":
                a, b = int(tok[1]), int(tok[2])
                vals = [float(v) for v in tok[3:]]
                info = _sym_from_upper(vals[7:28], 6)
                constraints.append(Constraint3d(
                    a, b, np.asarray(vals[:3]), np.asarray(vals[3:7]),
                    info))
    return poses, constraints


def _normalize_angle(a):
    return np.arctan2(np.sin(a), np.cos(a))


def synthetic_pose_graph_2d(num_poses=60, noise_t=0.05, noise_yaw=0.02,
                            loop_every=15, seed=0):
    """Noisy circle with odometry + loop closures; returns (poses,
    constraints) with poses initialized by noisy odometry integration."""
    rng = np.random.default_rng(seed)
    step_yaw = 2 * np.pi / num_poses
    step_len = 2 * np.pi * 5.0 / num_poses  # radius-5 circle

    # ground truth
    gt = []
    x = y = yaw = 0.0
    for i in range(num_poses):
        gt.append(Pose2d(x, y, yaw))
        x += step_len * np.cos(yaw)
        y += step_len * np.sin(yaw)
        yaw = _normalize_angle(yaw + step_yaw)

    def relative(a: Pose2d, b: Pose2d):
        c, s = np.cos(a.yaw), np.sin(a.yaw)
        dx, dy = b.x - a.x, b.y - a.y
        return (c * dx + s * dy, -s * dx + c * dy,
                _normalize_angle(b.yaw - a.yaw))

    info_t = 1.0 / noise_t ** 2
    info_y = 1.0 / noise_yaw ** 2
    info = np.diag([info_t, info_t, info_y])
    constraints = []
    for i in range(num_poses - 1):
        dx, dy, dyaw = relative(gt[i], gt[i + 1])
        constraints.append(Constraint2d(
            i, i + 1, dx + noise_t * rng.normal(),
            dy + noise_t * rng.normal(),
            _normalize_angle(dyaw + noise_yaw * rng.normal()), info))
    for i in range(0, num_poses - loop_every, loop_every):
        j = i + loop_every
        dx, dy, dyaw = relative(gt[i], gt[j])
        constraints.append(Constraint2d(
            i, j, dx + noise_t * rng.normal(), dy + noise_t * rng.normal(),
            _normalize_angle(dyaw + noise_yaw * rng.normal()), info))

    # initial estimates: integrate the odometry chain
    poses = {0: gt[0]}
    for k in range(num_poses - 1):
        c = constraints[k]
        a = poses[c.id_begin]
        ca, sa = np.cos(a.yaw), np.sin(a.yaw)
        poses[c.id_end] = Pose2d(a.x + ca * c.x - sa * c.y,
                                 a.y + sa * c.x + ca * c.y,
                                 _normalize_angle(a.yaw + c.yaw))
    return poses, constraints, gt


def synthetic_pose_graph_3d(num_poses=40, noise_t=0.05, noise_r=0.01,
                            loop_every=10, seed=0):
    """3D analog: helix trajectory, quaternions in Eigen (x,y,z,w) order."""
    from .bal import _np_angle_axis_to_quaternion
    rng = np.random.default_rng(seed)

    def q_eigen(aa):
        q = _np_angle_axis_to_quaternion(aa[None])[0]  # w,x,y,z
        return np.asarray([q[1], q[2], q[3], q[0]])

    def q_mul(q1, q2):
        # Hamilton product in (x,y,z,w) storage
        x1, y1, z1, w1 = q1
        x2, y2, z2, w2 = q2
        return np.asarray([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])

    def q_conj(q):
        return np.asarray([-q[0], -q[1], -q[2], q[3]])

    def q_rot(q, v):
        qv = np.asarray([v[0], v[1], v[2], 0.0])
        return q_mul(q_mul(q, qv), q_conj(q))[:3]

    step_yaw = 2 * np.pi / num_poses
    step = np.asarray([2 * np.pi * 5.0 / num_poses, 0.0, 0.1])
    gt = []
    p = np.zeros(3)
    q = np.asarray([0.0, 0.0, 0.0, 1.0])
    for i in range(num_poses):
        gt.append(Pose3d(p.copy(), q.copy()))
        p = p + q_rot(q, step)
        q = q_mul(q, q_eigen(np.asarray([0.0, 0.0, step_yaw])))
        q = q / np.linalg.norm(q)

    def relative(a: Pose3d, b: Pose3d):
        qa_inv = q_conj(a.q)
        t = q_rot(qa_inv, b.p - a.p)
        dq = q_mul(qa_inv, b.q)
        return t, dq / np.linalg.norm(dq)

    info = np.diag([1.0 / noise_t ** 2] * 3 + [1.0 / noise_r ** 2] * 3)
    constraints = []

    def noisy(t, dq):
        tn = t + noise_t * rng.normal(size=3)
        qn = q_mul(dq, q_eigen(noise_r * rng.normal(size=3)))
        return tn, qn / np.linalg.norm(qn)

    for i in range(num_poses - 1):
        t, dq = relative(gt[i], gt[i + 1])
        tn, qn = noisy(t, dq)
        constraints.append(Constraint3d(i, i + 1, tn, qn, info))
    for i in range(0, num_poses - loop_every, loop_every):
        j = i + loop_every
        t, dq = relative(gt[i], gt[j])
        tn, qn = noisy(t, dq)
        constraints.append(Constraint3d(i, j, tn, qn, info))

    poses = {0: gt[0]}
    for k in range(num_poses - 1):
        c = constraints[k]
        a = poses[c.id_begin]
        poses[c.id_end] = Pose3d(a.p + q_rot(a.q, c.t),
                                 q_mul(a.q, c.q))
    return poses, constraints, gt
