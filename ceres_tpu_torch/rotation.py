"""Angle-axis point rotation on torch tensors.

Counterpart of ceres_tpu/rotation.py, as far as the ported slices need
it: `angle_axis_rotate_point` (the reference's rotation.h:288) with the
same small-angle threshold per dtype, since the candidate-cost kernel
(ops/cost.py) takes the same branch, the w-first quaternion product
and conjugate of the quaternion manifolds, and the quaternion point
rotations of the quaternion BAL cameras. Both branches are evaluated on
safe operands and selected with `torch.where`, so forward-mode
derivatives stay finite.
"""

from __future__ import annotations

import torch

_EPS_BY_DTYPE = {torch.float32: 1e-6, torch.float64: 1e-12}


def _small(theta_sq):
    return theta_sq < _EPS_BY_DTYPE.get(theta_sq.dtype, 1e-12)


def angle_axis_rotate_point(angle_axis, pt):
    """Rodrigues rotation of pt [..., 3] by angle_axis [..., 3]."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1, keepdim=True)
    small = _small(theta_sq)
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    w = angle_axis * (1.0 / theta)
    w_cross_pt = torch.linalg.cross(w, pt)
    w_dot_pt = torch.sum(w * pt, dim=-1, keepdim=True)
    large = pt * cos_t + w_cross_pt * sin_t + w * w_dot_pt * (1.0 - cos_t)
    # near zero: R(aa) pt ~= pt + aa x pt  (rotation.h:306)
    small_res = pt + torch.linalg.cross(angle_axis, pt)
    return torch.where(small, small_res, large)


def quaternion_product(z, w):
    """rotation.h:270 zw = z * w (Hamilton product, w-first), over the
    last dimension."""
    z0, z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    w0, w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    return torch.stack([
        z0 * w0 - z1 * w1 - z2 * w2 - z3 * w3,
        z0 * w1 + z1 * w0 + z2 * w3 - z3 * w2,
        z0 * w2 - z1 * w3 + z2 * w0 + z3 * w1,
        z0 * w3 + z1 * w2 - z2 * w1 + z3 * w0,
    ], dim=-1)


def quaternion_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def unit_quaternion_rotate_point(q, pt):
    """rotation.h:254 UnitQuaternionRotatePoint (assumes |q| = 1): with
    uv = 2 q_vec x pt, pt + q_w uv + q_vec x uv."""
    qvec = q[..., 1:]
    uv = 2.0 * torch.linalg.cross(qvec, pt)
    return pt + q[..., :1] * uv + torch.linalg.cross(qvec, uv)


def quaternion_rotate_point(q, pt):
    """rotation.h QuaternionRotatePoint: normalizes q first."""
    scale = 1.0 / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return unit_quaternion_rotate_point(q * scale, pt)
