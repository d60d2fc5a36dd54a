"""ceres_tpu_torch.rotation against ceres_tpu.rotation on the CPU: every
function and its forward-mode Jacobian (torch.func.vmap of jacfwd beside
jax.vmap of jax.jacfwd), on the same numpy inputs: random ones, angles
near 0 (below the small-angle threshold and at zero) and near pi (each
branch of rotation_matrix_to_quaternion), and every one of the 24 Euler
systems both ways. Values within 1e-12 and Jacobians within 1e-9 of the
JAX package's, relative to their largest entry; every Jacobian finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import rel
from ceres_tpu import rotation as jrot
from ceres_tpu_torch import rotation as trot

VAL_TOL, JAC_TOL = 1e-12, 1e-9


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _angle_axes(rng):
    axis = _unit(rng.normal(size=(6, 3)))
    angle = rng.uniform(-0.9 * np.pi, 0.9 * np.pi, size=(6, 1))
    near_pi = _unit(rng.normal(size=(3, 3))) * (np.pi - 1e-7)
    small = np.array([[1e-7, -2e-8, 3e-8], [0.0, 0.0, 0.0],
                      [3e-4, 1e-4, -2e-4]])
    return np.concatenate([axis * angle, near_pi, small])


def _quaternions(rng):
    q = _unit(rng.normal(size=(6, 4)))
    q[:3] *= np.where(q[:3, :1] < 0, -1.0, 1.0)          # w >= 0 and < 0
    special = np.array([[1.0, 1e-8, -2e-8, 1e-8],        # near identity
                        [0.0, 0.6, 0.0, 0.8],            # 180 degrees
                        [-0.2, 0.5, -0.5, 0.5], [1.0, 0.0, 0.0, 0.0]])
    return np.concatenate([q * 1.3, _unit(special)])     # scaled ones too


def _matrices(rng):
    aa = _angle_axes(rng)
    R = np.asarray(jrot.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    # trace < 0 with the largest diagonal entry at x, y and z
    flips = np.stack([np.diag(d) for d in ([1.0, -1.0, -1.0],
                                           [-1.0, 1.0, -1.0],
                                           [-1.0, -1.0, 1.0])])
    tilt = np.asarray(jrot.angle_axis_to_rotation_matrix(
        jnp.asarray([0.01, -0.02, 0.015])))
    return np.concatenate([R, flips @ tilt])


def _points(rng, n):
    return rng.normal(size=(n, 3))


CASES = {
    "angle_axis_to_quaternion": (lambda r: (_angle_axes(r),)),
    "quaternion_to_angle_axis": (lambda r: (_quaternions(r),)),
    "quaternion_to_scaled_rotation": (lambda r: (_quaternions(r),)),
    "quaternion_to_rotation_matrix": (lambda r: (_quaternions(r),)),
    "rotation_matrix_to_quaternion": (lambda r: (_matrices(r),)),
    "angle_axis_to_rotation_matrix": (lambda r: (_angle_axes(r),)),
    "rotation_matrix_to_angle_axis": (lambda r: (_matrices(r),)),
    "euler_angles_to_rotation_matrix": (
        lambda r: (r.uniform(-170.0, 170.0, size=(8, 3)),)),
    "quaternion_product": (lambda r: (_quaternions(r), _quaternions(r))),
    "quaternion_conjugate": (lambda r: (_quaternions(r),)),
    "unit_quaternion_rotate_point": (
        lambda r: (_unit(_quaternions(r)), _points(r, 10))),
    "quaternion_rotate_point": (lambda r: (_quaternions(r),
                                           _points(r, 10))),
    "angle_axis_rotate_point": (lambda r: (_angle_axes(r),
                                           _points(r, 12))),
    "cross_product": (lambda r: (_points(r, 5), _points(r, 5))),
    "dot_product": (lambda r: (_points(r, 5), _points(r, 5))),
}


def _compare(fj, ft, args):
    """Values and Jacobians (with respect to every argument) of the two
    packages' functions, mapped over the first dimension."""
    n_args = tuple(range(len(args)))
    vj = np.asarray(jax.vmap(fj)(*[jnp.asarray(a) for a in args]))
    targs = [torch.tensor(a) for a in args]
    vt = torch.func.vmap(ft)(*targs).numpy()
    assert vt.shape == vj.shape
    assert rel(vt, vj) <= VAL_TOL, rel(vt, vj)
    Jj = jax.vmap(jax.jacfwd(fj, argnums=n_args))(
        *[jnp.asarray(a) for a in args])
    Jt = torch.func.vmap(torch.func.jacfwd(ft, argnums=n_args))(*targs)
    for a, b in zip(Jt, Jj):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all()
        assert rel(a, b) <= JAC_TOL, rel(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_function_and_jacobian_match_jax(name):
    args = CASES[name](np.random.default_rng(5))
    _compare(getattr(jrot, name), getattr(trot, name), args)


@pytest.mark.parametrize("name", sorted(trot.EULER_SYSTEMS))
def test_euler_system_matches_jax(name):
    rng = np.random.default_rng(7)
    js, ts = jrot.EULER_SYSTEMS[name], trot.EULER_SYSTEMS[name]
    assert (ts.axes, ts.parity_odd, ts.proper, ts.intrinsic) == \
        (js.axes, js.parity_odd, js.proper, js.intrinsic)
    assert getattr(trot, name) is ts
    e = rng.uniform(-1.2, 1.2, size=(6, 3))
    if ts.proper:
        e[:, 1] = rng.uniform(0.05, 1.4, size=6)
    _compare(lambda x: jrot.euler_angles_to_rotation(x, js),
             lambda x: trot.euler_angles_to_rotation(x, ts), (e,))
    R = np.asarray(jrot.euler_angles_to_rotation(jnp.asarray(e), js))
    _compare(lambda x: jrot.rotation_matrix_to_euler_angles(x, js),
             lambda x: trot.rotation_matrix_to_euler_angles(x, ts), (R,))


def test_small_angle_and_gimbal_lock_values():
    aa = torch.tensor([[1e-12, -2e-13, 3e-12], [0.0, 0.0, 0.0]],
                      dtype=torch.float64)
    q = trot.angle_axis_to_quaternion(aa)
    np.testing.assert_allclose(q[:, 0].numpy(), 1.0, atol=1e-15)
    np.testing.assert_allclose(trot.quaternion_to_angle_axis(q).numpy(),
                               aa.numpy(), atol=1e-15)
    assert torch.isfinite(torch.func.jacfwd(trot.angle_axis_to_quaternion)(
        torch.zeros(3, dtype=torch.float64))).all()
    s = trot.ExtrinsicXYZ
    e = torch.tensor([0.3, np.pi / 2.0, 0.2], dtype=torch.float64)
    R = trot.euler_angles_to_rotation(e, s)
    e2 = trot.rotation_matrix_to_euler_angles(R, s)
    assert torch.isfinite(e2).all()
    np.testing.assert_allclose(trot.euler_angles_to_rotation(e2, s).numpy(),
                               R.numpy(), atol=1e-9)


def test_float32_threshold():
    """The small-angle branch follows the dtype (1e-6 in f32), as the
    candidate-cost kernel's does."""
    aa = torch.tensor([5e-4, 0.0, 0.0], dtype=torch.float32)
    q = trot.angle_axis_to_quaternion(aa)
    assert q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), [1.0 - 2.5e-7 / 8.0, 2.5e-4, 0.0,
                                           0.0], rtol=1e-6)
