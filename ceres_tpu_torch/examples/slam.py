"""2D/3D pose-graph SLAM (reference examples/slam/pose_graph_{2d,3d}).

Counterpart of ceres_tpu/examples/slam.py on torch tensors:
PoseGraph2dErrorTerm (pose_graph_2d_error_term.h:60), the angle manifold
(angle_manifold.h:41), PoseGraph3dErrorTerm (pose_graph_3d_error_term.h:71)
with EigenQuaternionManifold, and the problem construction of
pose_graph_2d.cc / pose_graph_3d.cc BuildOptimizationProblem. The class
names are the JAX package's: the bucket-linearize kernel K11
(ops/linearize.py) is keyed by them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cost import AutoDiffCostFunction
from ..manifolds import AutoDiffManifold, EigenQuaternionManifold
from ..problem import Problem


def normalize_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _angle_plus(x, d):
    return normalize_angle(x + d)


def _angle_minus(y, x):
    return normalize_angle(y - x)


def angle_manifold() -> AutoDiffManifold:
    """SO(2) by 2-pi wrapping (reference angle_manifold.h:41). Its plus and
    minus are module functions, so that the graphs of two calls share
    their buckets' keys (a batched solve needs one structure)."""
    return AutoDiffManifold(plus_fn=_angle_plus, minus_fn=_angle_minus,
                            ambient_size=1, tangent_size=1)


class PoseGraph2dErrorTerm:
    """residual = sqrt_info * [R_a^T (p_b - p_a) - t_ab;
                               normalize(yaw_b - yaw_a - yaw_ab)]."""

    def __init__(self, x_ab, y_ab, yaw_ab, sqrt_information):
        self.t_ab = np.asarray([x_ab, y_ab])
        self.yaw_ab = yaw_ab
        self.sqrt_information = np.asarray(sqrt_information)

    def __call__(self, p_a, yaw_a, p_b, yaw_b):
        c = torch.cos(yaw_a)
        s = torch.sin(yaw_a)
        d = p_b - p_a
        local = torch.cat([c * d[0:1] + s * d[1:2],
                           -s * d[0:1] + c * d[1:2]])
        r = torch.cat([local - self.t_ab,
                       normalize_angle(yaw_b - yaw_a - self.yaw_ab)])
        return self.sqrt_information @ r


class PoseGraph3dErrorTerm:
    """Eigen-order (x, y, z, w) quaternions (pose_graph_3d_error_term.h:71):
    residual = sqrt_info * [R(q_a)^T (p_b - p_a) - t_ab;
                            2 * vec(q_ab^-1 * (q_a^-1 q_b))]."""

    def __init__(self, t_ab, q_ab, sqrt_information):
        self.t_ab = np.asarray(t_ab)
        self.q_ab = np.asarray(q_ab)          # (x, y, z, w)
        self.sqrt_information = np.asarray(sqrt_information)

    @staticmethod
    def _q_mul(q1, q2):
        x1, y1, z1, w1 = q1[0], q1[1], q1[2], q1[3]
        x2, y2, z2, w2 = q2[0], q2[1], q2[2], q2[3]
        return torch.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])

    @staticmethod
    def _q_conj(q):
        return torch.cat([-q[:3], q[3:]])

    @classmethod
    def _q_rot(cls, q, v):
        qv = torch.cat([v, torch.zeros_like(v[:1])])
        return cls._q_mul(cls._q_mul(q, qv), cls._q_conj(q))[:3]

    def __call__(self, p_a, q_a, p_b, q_b):
        qa_inv = self._q_conj(q_a)
        p_ab_est = self._q_rot(qa_inv, p_b - p_a)
        q_ab_est = self._q_mul(qa_inv, q_b)
        dq = self._q_mul(self._q_conj(self.q_ab), q_ab_est)
        r = torch.cat([p_ab_est - self.t_ab, 2.0 * dq[:3]])
        return self.sqrt_information @ r


def build_pose_graph_2d_problem(poses, constraints, loss=None):
    """pose_graph_2d.cc BuildOptimizationProblem: the first pose is held
    constant (the gauge). Returns (problem, positions {id: array[2]},
    yaws {id: array[1]})."""
    positions = {i: np.asarray([p.x, p.y]) for i, p in poses.items()}
    yaws = {i: np.asarray([p.yaw]) for i, p in poses.items()}
    problem = Problem()
    a_manifold = angle_manifold()
    for c in constraints:
        sqrt_info = np.linalg.cholesky(c.information).T
        cost = AutoDiffCostFunction(
            PoseGraph2dErrorTerm(c.x, c.y, c.yaw, sqrt_info), 3,
            [2, 1, 2, 1])
        problem.add_residual_block(cost, loss,
                                   positions[c.id_begin], yaws[c.id_begin],
                                   positions[c.id_end], yaws[c.id_end])
        problem.set_manifold(yaws[c.id_begin], a_manifold)
        problem.set_manifold(yaws[c.id_end], a_manifold)
    first = min(poses)
    problem.set_parameter_block_constant(positions[first])
    problem.set_parameter_block_constant(yaws[first])
    return problem, positions, yaws


def build_pose_graph_3d_problem(poses, constraints, loss=None):
    """pose_graph_3d.cc: EigenQuaternionManifold on the rotations, the
    first pose held constant. Returns (problem, positions, quaternions)."""
    positions = {i: p.p.copy() for i, p in poses.items()}
    quats = {i: p.q.copy() for i, p in poses.items()}
    problem = Problem()
    q_manifold = EigenQuaternionManifold()
    for c in constraints:
        sqrt_info = np.linalg.cholesky(c.information).T
        cost = AutoDiffCostFunction(
            PoseGraph3dErrorTerm(c.t, c.q, sqrt_info), 6, [3, 4, 3, 4])
        problem.add_residual_block(cost, loss,
                                   positions[c.id_begin], quats[c.id_begin],
                                   positions[c.id_end], quats[c.id_end])
        problem.set_manifold(quats[c.id_begin], q_manifold)
        problem.set_manifold(quats[c.id_end], q_manifold)
    first = min(poses)
    problem.set_parameter_block_constant(positions[first])
    problem.set_parameter_block_constant(quats[first])
    return problem, positions, quats
