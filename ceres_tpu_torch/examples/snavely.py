"""Snavely reprojection error for BAL bundle adjustment, on torch tensors.

Counterpart of ceres_tpu/examples/snavely.py (the reference's
examples/snavely_reprojection_error.h:53): 9-parameter camera and
3-parameter point, and the quaternion variant (:102), a 10-parameter
camera. The evaluator maps the functor over all observations
with torch.func.vmap.
"""

from __future__ import annotations

import torch

from .. import rotation as rot


class SnavelyReprojectionError:
    """camera: [angle_axis(3), translation(3), f, k1, k2]; point: [3].

    Residual: predicted minus observed (x, y), BAL convention of a camera
    looking down its negative z axis."""

    def __init__(self, observed_x: float, observed_y: float):
        self.observed_x = observed_x
        self.observed_y = observed_y

    def __call__(self, camera, point):
        p = rot.angle_axis_rotate_point(camera[:3], point)
        p = p + camera[3:6]
        xp = -p[0] / p[2]
        yp = -p[1] / p[2]
        r2 = xp * xp + yp * yp
        distortion = 1.0 + r2 * (camera[7] + camera[8] * r2)
        focal = camera[6]
        return torch.stack([focal * distortion * xp - self.observed_x,
                            focal * distortion * yp - self.observed_y])


class SnavelyReprojectionErrorWithQuaternions:
    """camera: [quaternion(4, w-first), translation(3), f, k1, k2]; point:
    [3] (snavely_reprojection_error.h:102)."""

    def __init__(self, observed_x: float, observed_y: float):
        self.observed_x = observed_x
        self.observed_y = observed_y

    def __call__(self, camera, point):
        p = rot.unit_quaternion_rotate_point(camera[:4], point)
        p = p + camera[4:7]
        xp = -p[0] / p[2]
        yp = -p[1] / p[2]
        r2 = xp * xp + yp * yp
        distortion = 1.0 + r2 * (camera[8] + camera[9] * r2)
        focal = camera[7]
        return torch.stack([focal * distortion * xp - self.observed_x,
                            focal * distortion * yp - self.observed_y])
