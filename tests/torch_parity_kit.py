"""Shared set-up of the ceres_tpu_torch parity tests (tests/test_torch_*.py).

One small seeded BAL problem (6 cameras, 300 points, 1,500 observations,
the `small_bal` of test_fused_schur.py) built into both packages from the
same numpy arrays, with the main path's solver options.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.examples.snavely import \
    SnavelyReprojectionError as JaxSnavely
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.rotation import angle_axis_rotate_point as jax_rotate
from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build
from ceres_tpu_torch.rotation import angle_axis_rotate_point

torch.set_num_threads(1)      # the suite runs several workers


def small_bal():
    bal = synthetic_bal_problem(num_cameras=6, num_points=300,
                                num_observations=1500, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


def large_m_bal(num_cameras=130):
    """num_cameras cameras (nf = 9 num_cameras; 130 is past the one-block
    K3 and K7), 1,000 points, twelve observations a point, perturbed as
    small_bal is. With three observations a point the synthetic ring of
    cameras is too loosely tied to converge in 50 LM iterations in
    either package."""
    bal = synthetic_bal_problem(num_cameras=num_cameras, num_points=1000,
                                num_observations=12000, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


def quaternion_bal():
    """tests/test_autolin.py's problem (6 cameras, 150 points, 600
    observations) with its cameras written as w-first quaternions before
    the perturbation, as chip_smoke.py's quaternion problem is made."""
    bal = synthetic_bal_problem(num_cameras=6, num_points=150,
                                num_observations=600, seed=3,
                                pixel_noise=0.5).to_quaternions()
    bal.perturb(rotation_sigma=0.05, translation_sigma=0.3,
                point_sigma=0.2, seed=5)
    return bal


def quaternion_solve_bal():
    """A quaternion problem whose LM solves converge in both packages:
    8 cameras, 500 points, 4,000 observations, chip_smoke.py's seeds and
    perturbation. (With Euclidean quaternions, the 600-observation problem
    creeps on for more than 50 iterations without converging.)"""
    bal = synthetic_bal_problem(num_cameras=8, num_points=500,
                                num_observations=4000, seed=7,
                                pixel_noise=1.0).to_quaternions()
    bal.perturb(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5,
                seed=8)
    return bal


def jax_quaternion_problem(bal, loss=None):
    """Euclidean quaternion blocks (bundle_adjuster -use_quaternions)."""
    return jax_build(bal, loss=loss, use_quaternions=True,
                     use_manifolds=False)[0]


def torch_quaternion_problem(bal, loss=None):
    return torch_build(bal, loss=loss, use_quaternions=True,
                       use_manifolds=False)[0]


def main_path_options(mod, **extra):
    """The main path's options (bench.py's DENSE_SCHUR configuration) in
    package `mod` (ceres_tpu or ceres_tpu_torch)."""
    kw = dict(linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
              preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
              max_num_iterations=50, function_tolerance=1e-6,
              max_linear_solver_iterations=100,
              use_mixed_precision_solves=True, fused_iterations=True)
    if mod is ctt:
        kw["device"] = "cpu"
    kw.update(extra)
    return mod.SolverOptions(**kw)


class JaxDoubled(JaxSnavely):
    """A subclass of the Snavely functor with twice its residual."""

    def __call__(self, camera, point):
        return 2.0 * super().__call__(camera, point)


class TorchDoubled(SnavelyReprojectionError):
    """A subclass of the Snavely functor with twice its residual."""

    def __call__(self, camera, point):
        return 2.0 * super().__call__(camera, point)


def functor_problem(mod, functor_cls, bal):
    """bal's observations as blocks of functor_cls(ox, oy) on [9, 3]
    (angle-axis cameras) in package `mod`."""
    prob = mod.Problem()
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        prob.add_residual_block(mod.AutoDiffCostFunction(
            functor_cls(ox, oy), 2, [9, 3]), None,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return prob


def jax_problem(bal, loss=None):
    return jax_build(bal, loss=loss)[0]


def torch_problem(bal, loss=None):
    return torch_build(bal, loss=loss)[0]


def rel(a, b):
    """max |a - b| / max |b| over two arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas kernels in interpret mode, as its own
    tests do (test_fused_schur.py)."""
    os.environ["CERES_TPU_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        del os.environ["CERES_TPU_PALLAS_INTERPRET"]



# ---- the generic Schur route (solvers/schur.py, schur_sparse.py) ----

class JaxCameraPrior:
    """A prior pulling a camera toward zero: residual w * camera [9]."""

    def __init__(self, w):
        self.w = w

    def __call__(self, camera):
        return self.w * camera


class TorchCameraPrior(JaxCameraPrior):
    pass


def schur_bal():
    """6 cameras, 80 points, 400 observations (five a point), perturbed."""
    bal = synthetic_bal_problem(num_cameras=6, num_points=80,
                                num_observations=400, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


def schur_problem(mod, bal, prior=True, constant_camera=True,
                  duplicates=True, heavy_point=True, loss=None):
    """bal's Snavely blocks in package `mod`, and, each optional: a prior
    on cameras 0-4 (an f-only bucket), camera 5 constant (its
    observations an e-only bucket), a HuberLoss(1.0) bucket that observes
    every fourth (camera, point) pair of bal again (duplicate rows across
    two buckets) and, with heavy_point, point 0's observations eight
    times more (one point of 40-odd rows in that bucket: past the JAX
    package's padding guard, so that bucket keeps observation order
    there). Returns (problem, camera arrays, point arrays)."""
    build = jax_build if mod is ct else torch_build
    snav = JaxSnavely if mod is ct else SnavelyReprojectionError
    problem, cams, pts = build(bal, loss=loss)
    if duplicates:
        rows = list(range(0, bal.num_observations, 4))
        if heavy_point:
            rows += [i for i in range(bal.num_observations)
                     if bal.point_index[i] == 0] * 8
        for i in rows:
            ox, oy = bal.observations[i]
            problem.add_residual_block(
                mod.AutoDiffCostFunction(snav(ox, oy), 2, [9, 3]),
                mod.HuberLoss(1.0), cams[bal.camera_index[i]],
                pts[bal.point_index[i]])
    if prior:
        prior_cls = JaxCameraPrior if mod is ct else TorchCameraPrior
        for c in cams[:5]:
            problem.add_residual_block(
                mod.AutoDiffCostFunction(prior_cls(0.1), 9, [9]), None, c)
    if constant_camera:
        problem.set_parameter_block_constant(cams[5])
    return problem, cams, pts


def enum_options(mod, **kw):
    """SolverOptions of package `mod` from keyword options whose enum
    values may be given by name (device="cpu" for the port)."""
    enums = {"linear_solver_type": "LinearSolverType",
             "preconditioner_type": "PreconditionerType",
             "trust_region_strategy_type": "TrustRegionStrategyType",
             "dogleg_type": "DoglegType"}
    kw = {k: (getattr(getattr(mod, enums[k]), v)
              if k in enums and isinstance(v, str) else v)
          for k, v in kw.items()}
    if mod is ctt:
        kw.setdefault("device", "cpu")
    return mod.SolverOptions(**kw)


@contextlib.contextmanager
def jax_generic_schur(sparse=False):
    """The JAX package on its generic Schur route (CERES_TPU_NO_FUSED_SCHUR,
    the route the port takes for the f64 step), and with sparse on its
    block-sparse SPARSE_SCHUR at any size (CERES_TPU_FORCE_SPARSE_SCHUR)."""
    keys = ["CERES_TPU_NO_FUSED_SCHUR"] + (
        ["CERES_TPU_FORCE_SPARSE_SCHUR"] if sparse else [])
    for k in keys:
        os.environ[k] = "1"
    try:
        yield
    finally:
        for k in keys:
            del os.environ[k]


# ---- point blocks of te != 3 (the explicit step's K2 at te <= 3, K6) ----

def point_functor(port, te):
    """A 6-parameter camera (angle-axis, translation) observing a point
    block of te 1 (the depth z of a point (x, y, z) whose x and y are
    data), 2 (inverse-plane: the point (u, v, 1) in its own frame), 4
    (homogeneous, [X, Y, Z, W]) or 5 (homogeneous and a depth offset b,
    p_z + 0.1 b), in either package. The package and te are closed over:
    the JAX package batches a functor's numeric attributes as data."""
    T, rot = ((torch, angle_axis_rotate_point) if port
              else (jnp, jax_rotate))

    class Point:
        def __init__(self, ox, oy, x=0.0, y=0.0):
            self.ox, self.oy = float(ox), float(oy)
            if te == 1:
                self.x, self.y = float(x), float(y)

        def __call__(self, cam, pt):
            if te == 1:
                p = rot(cam[0:3], T.stack([self.x, self.y, pt[0]])) \
                    + cam[3:6]
            elif te == 2:
                p = rot(cam[0:3], T.stack([pt[0], pt[1],
                                           T.ones_like(pt[0])])) + cam[3:6]
            else:
                p = rot(cam[0:3], pt[0:3]) + cam[3:6] * pt[3]
            z = p[2] + 0.1 * pt[4] if te == 5 else p[2]
            return T.stack([p[0] / z - self.ox, p[1] / z - self.oy])
    return Point


def point_problem(mod, te, seed=0, cameras=4, points=30):
    """test_torch_autolin.py's te-4 problem (4 cameras, 30 points, each
    seen by every camera, seeded offsets), or its counterpart at te 1, 2
    or 5."""
    rng = np.random.default_rng(seed)
    cams = [np.concatenate([0.05 * rng.standard_normal(3),
                            [0.1 * c, -0.1, 4.0]]) for c in range(cameras)]
    xyz = [0.5 * rng.standard_normal(3) for _ in range(points)]
    pts = [np.append(q, [1.0, 0.0])[:te] if te != 1 else q[2:3].copy()
           for q in xyz]
    prob = mod.Problem()
    functor = point_functor(mod is ctt, te)
    for q, p in zip(xyz, pts):
        for c in range(cameras):
            prob.add_residual_block(mod.AutoDiffCostFunction(
                functor(*(0.1 * rng.standard_normal(2)), q[0], q[1]), 2,
                [6, te]), None, cams[c], p)
    return prob
