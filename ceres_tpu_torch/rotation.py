"""Differentiable rotation conversions on torch tensors.

Counterpart of ceres_tpu/rotation.py (the reference's
include/ceres/rotation.h): angle-axis, quaternion and rotation-matrix
conversions (:89, :98, :104, :114, :121, :236), the Euler angles of
rotation.h:134 and the 24 EulerSystem conventions (:497-628), the
quaternion product (:270), point rotations (:254, :288), cross and dot
products (:278, :281). Quaternions are w-first (Ceres's order). Every
function works over leading batch dimensions and under torch.func.vmap
and jacfwd: a branch on a tensor's value is a torch.where between two
results computed on safe operands (the untaken side's inputs replaced by
harmless values), so the derivatives of both sides stay finite, as the
reference's Jet code takes both branches. The small-angle threshold
follows the dtype (1e-6 in f32, 1e-12 in f64), the same as the
candidate-cost kernel's (ops/cost.py).
"""

from __future__ import annotations

import math

import torch

_EPS_BY_DTYPE = {torch.float32: 1e-6, torch.float64: 1e-12}


def _small(theta_sq):
    return theta_sq < _EPS_BY_DTYPE.get(theta_sq.dtype, 1e-12)


def _one_where(cond, x):
    """x where cond is false, else 1: a safe operand for the branch that
    cond does not take."""
    return torch.where(cond, torch.ones_like(x), x)


def cross_product(a, b):
    """rotation.h:278."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def dot_product(a, b):
    """rotation.h:281."""
    return torch.sum(a * b, dim=-1)


def angle_axis_to_quaternion(angle_axis):
    """rotation.h:89: angle_axis [..., 3] -> quaternion [..., 4]."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1, keepdim=True)
    small = _small(theta_sq)
    safe_theta = torch.sqrt(_one_where(small, theta_sq))
    half = 0.5 * safe_theta
    k = torch.where(small, 0.5 - theta_sq / 48.0,      # sin(t/2)/t, Taylor
                    torch.sin(half) / safe_theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, angle_axis * k], dim=-1)


def quaternion_to_angle_axis(quaternion):
    """rotation.h:98: quaternion [..., 4] -> angle_axis [..., 3], the
    angle taken in (-pi, pi] (the cos < 0 hemisphere mirrored)."""
    q = quaternion
    sin_sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    small = _small(sin_sq)
    sin_theta = torch.sqrt(_one_where(small, sin_sq))
    cos_theta = q[..., :1]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0, torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta))
    k = torch.where(small, 2.0 / _one_where(cos_theta == 0.0, cos_theta),
                    two_theta / sin_theta)
    return q[..., 1:] * k


def quaternion_to_scaled_rotation(q):
    """rotation.h:104: the rotation matrix scaled by |q|^2."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, ab, ac, ad = a * a, a * b, a * c, a * d
    bb, bc, bd = b * b, b * c, b * d
    cc, cd = c * c, c * d
    dd = d * d
    return torch.stack([
        torch.stack([aa + bb - cc - dd, 2 * (bc - ad), 2 * (ac + bd)],
                    dim=-1),
        torch.stack([2 * (ad + bc), aa - bb + cc - dd, 2 * (cd - ab)],
                    dim=-1),
        torch.stack([2 * (bd - ac), 2 * (ab + cd), aa - bb - cc + dd],
                    dim=-1),
    ], dim=-2)


def quaternion_to_rotation_matrix(q):
    """rotation.h QuaternionToRotation: normalizes first."""
    norm_sq = torch.sum(q * q, dim=-1, keepdim=True)
    return quaternion_to_scaled_rotation(q) / norm_sq[..., None]


def rotation_matrix_to_quaternion(R):
    """rotation.h:236 RotationMatrixToQuaternion: the four cases (trace
    positive, else the largest diagonal entry) each formed on a clamped
    square root and selected with torch.where; w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    sw = safe_sqrt(tr + 1.0) * 2.0
    qw = torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                      (m10 - m01) / sw], dim=-1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    qx = torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                      (m02 + m20) / sx], dim=-1)
    sy = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    qy = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                      (m12 + m21) / sy], dim=-1)
    sz = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    qz = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                      0.25 * sz], dim=-1)
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, qw,
                    torch.where(cond_x, qx, torch.where(cond_y, qy, qz)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def angle_axis_to_rotation_matrix(angle_axis):
    """rotation.h:121 (Rodrigues); near zero R = I + skew(aa) (:150)."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1)
    small = _small(theta_sq)
    theta = torch.sqrt(_one_where(small, theta_sq))
    w = angle_axis / theta[..., None]
    c, s = torch.cos(theta), torch.sin(theta)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    one_c = 1.0 - c
    R_large = torch.stack([
        torch.stack([c + wx * wx * one_c, wx * wy * one_c - wz * s,
                     wx * wz * one_c + wy * s], dim=-1),
        torch.stack([wy * wx * one_c + wz * s, c + wy * wy * one_c,
                     wy * wz * one_c - wx * s], dim=-1),
        torch.stack([wz * wx * one_c - wy * s, wz * wy * one_c + wx * s,
                     c + wz * wz * one_c], dim=-1),
    ], dim=-2)
    ax, ay, az = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    one = torch.ones_like(ax)
    R_small = torch.stack([
        torch.stack([one, -az, ay], dim=-1),
        torch.stack([az, one, -ax], dim=-1),
        torch.stack([-ay, ax, one], dim=-1),
    ], dim=-2)
    return torch.where(small[..., None, None], R_small, R_large)


def rotation_matrix_to_angle_axis(R):
    """rotation.h:114, through the quaternion as the reference does."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


def euler_angles_to_rotation_matrix(euler_deg):
    """rotation.h:134 EulerAnglesToRotationMatrix: (pitch, roll, yaw) in
    degrees about the fixed X, Y and Z axes, R = R_z R_y R_x."""
    rad = euler_deg * (math.pi / 180.0)
    c1, c2, c3 = (torch.cos(rad[..., 0]), torch.cos(rad[..., 1]),
                  torch.cos(rad[..., 2]))
    s1, s2, s3 = (torch.sin(rad[..., 0]), torch.sin(rad[..., 1]),
                  torch.sin(rad[..., 2]))
    return torch.stack([
        torch.stack([c2 * c3, -s3 * c1 + s1 * s2 * c3,
                     s1 * s3 + c1 * s2 * c3], dim=-1),
        torch.stack([c2 * s3, c1 * c3 + s1 * s2 * s3,
                     -s1 * c3 + c1 * s2 * s3], dim=-1),
        torch.stack([-s2, s1 * c2, c1 * c2], dim=-1),
    ], dim=-2)


class EulerSystem:
    """One of the 24 Euler-angle conventions in Shoemake's terms (the
    reference's internal/euler_angles.h:84-93): the inner axis, the
    permutation's parity, proper Euler or Tait-Bryan, extrinsic or
    intrinsic. Use the named instances (rotation.ExtrinsicXYZ,
    rotation.IntrinsicZYX, ...) with euler_angles_to_rotation and
    rotation_matrix_to_euler_angles."""

    def __init__(self, name, inner_axis, parity_odd, proper, intrinsic):
        self.name = name
        self.inner_axis = inner_axis
        self.parity_odd = parity_odd
        self.proper = proper
        self.intrinsic = intrinsic

    @property
    def axes(self):
        i = self.inner_axis
        return (i, (i + 1 + int(self.parity_odd)) % 3,
                (i + 2 - int(self.parity_odd)) % 3)

    def __repr__(self):
        return f"EulerSystem({self.name})"


def _make_euler_systems():
    ax = {"X": 0, "Y": 1, "Z": 2}
    systems = {}
    for frame in ("Extrinsic", "Intrinsic"):
        for a in "XYZ":
            for b in "XYZ":
                if b == a:
                    continue
                for c in "XYZ":
                    if c == b:
                        continue
                    seq = a + b + c
                    # an intrinsic name is the extrinsic sequence reversed
                    eff = seq if frame == "Extrinsic" else seq[::-1]
                    inner = ax[eff[0]]
                    systems[frame + seq] = EulerSystem(
                        frame + seq, inner, ax[eff[1]] != (inner + 1) % 3,
                        eff[2] == eff[0], frame == "Intrinsic")
    return systems


EULER_SYSTEMS = _make_euler_systems()
globals().update(EULER_SYSTEMS)


def euler_angles_to_rotation(euler, system: EulerSystem):
    """Euler angles in radians [..., 3] -> rotation matrix
    (rotation.h:497-551 EulerAnglesToRotation)."""
    i, j, k = system.axes
    ea1 = euler[..., 1]
    if system.intrinsic:
        ea0, ea2 = euler[..., 2], euler[..., 0]
    else:
        ea0, ea2 = euler[..., 0], euler[..., 2]
    if system.parity_odd:
        ea0, ea1, ea2 = -ea0, -ea1, -ea2
    ci, cj, ch = torch.cos(ea0), torch.cos(ea1), torch.cos(ea2)
    si, sj, sh = torch.sin(ea0), torch.sin(ea1), torch.sin(ea2)
    cc, cs, sc, ss = ci * ch, ci * sh, si * ch, si * sh
    R = [[None] * 3 for _ in range(3)]
    if system.proper:
        R[i][i], R[i][j], R[i][k] = cj, sj * si, sj * ci
        R[j][i], R[j][j], R[j][k] = sj * sh, -cj * ss + cc, -cj * cs - sc
        R[k][i], R[k][j], R[k][k] = -sj * ch, cj * sc + cs, cj * cc - ss
    else:
        R[i][i], R[i][j], R[i][k] = cj * ch, sj * sc - cs, sj * cc + ss
        R[j][i], R[j][j], R[j][k] = cj * sh, sj * ss + cc, sj * cs - sc
        R[k][i], R[k][j], R[k][k] = -sj, cj * si, cj * ci
    return torch.stack([torch.stack(R[r], dim=-1) for r in range(3)],
                       dim=-2)


def rotation_matrix_to_euler_angles(R, system: EulerSystem):
    """Rotation matrix -> Euler angles in radians (rotation.h:558-628
    RotationMatrixToEulerAngles); the gimbal-lock branch by torch.where."""
    i, j, k = system.axes
    if system.proper:
        sy = torch.hypot(R[..., i, j], R[..., i, k])
        degenerate = sy == 0.0
        ea0 = torch.where(degenerate,
                          torch.atan2(-R[..., j, k], R[..., j, j]),
                          torch.atan2(R[..., i, j], R[..., i, k]))
        ea1 = torch.atan2(sy, R[..., i, i])
        ea2 = torch.where(degenerate, torch.zeros_like(sy),
                          torch.atan2(R[..., j, i], -R[..., k, i]))
    else:
        cy = torch.hypot(R[..., i, i], R[..., j, i])
        degenerate = cy == 0.0
        ea0 = torch.where(degenerate,
                          torch.atan2(-R[..., j, k], R[..., j, j]),
                          torch.atan2(R[..., k, j], R[..., k, k]))
        ea1 = torch.atan2(-R[..., k, i], cy)
        ea2 = torch.where(degenerate, torch.zeros_like(cy),
                          torch.atan2(R[..., j, i], R[..., i, i]))
    if system.parity_odd:
        ea0, ea1, ea2 = -ea0, -ea1, -ea2
    e1 = ea1
    e0, e2 = (ea2, ea0) if system.intrinsic else (ea0, ea2)
    if system.proper:
        # into [-pi, pi) x [0, pi/2) x [-pi, pi)
        flip = e1 < 0.0
        e0 = torch.where(flip, e0 + math.pi, e0)
        e1 = torch.where(flip, -e1, e1)
        e2 = torch.where(flip, e2 - math.pi, e2)

        def wrap(a):
            a = torch.where(a < -math.pi, a + 2.0 * math.pi, a)
            return torch.where(a > math.pi, a - 2.0 * math.pi, a)

        e0, e1, e2 = wrap(e0), wrap(e1), wrap(e2)
    return torch.stack([e0, e1, e2], dim=-1)


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


def angle_axis_rotate_point(angle_axis, pt):
    """Rodrigues rotation of pt [..., 3] by angle_axis [..., 3]
    (rotation.h:288); near zero pt + aa x pt (:306)."""
    theta_sq = torch.sum(angle_axis * angle_axis, dim=-1, keepdim=True)
    small = _small(theta_sq)
    theta = torch.sqrt(_one_where(small, theta_sq))
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    w = angle_axis * (1.0 / theta)
    w_cross_pt = torch.linalg.cross(w, pt)
    w_dot_pt = torch.sum(w * pt, dim=-1, keepdim=True)
    large = pt * cos_t + w_cross_pt * sin_t + w * w_dot_pt * (1.0 - cos_t)
    small_res = pt + torch.linalg.cross(angle_axis, pt)
    return torch.where(small, small_res, large)
