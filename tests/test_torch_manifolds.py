"""The manifolds of ceres_tpu_torch against ceres_tpu's
(tests/test_manifolds.py and manifold_test_kit.py): the quaternion,
AutoDiff and angle manifolds the pose graphs use, and Subset, Sphere,
Line and Product; the manifold invariants of the
reference's manifold_test_utils.h at random points, the values of plus,
minus and their Jacobians against the JAX package (f64, 1e-12), the
batched plus against one block at a time, and the rotation identities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu import rotation as jrot
from ceres_tpu_torch.examples.slam import angle_manifold


def normalize(v):
    return v / np.linalg.norm(v)


def _quat(rng):
    return normalize(rng.normal(size=4))


def _jax_autodiff_quat():
    m = ct.QuaternionManifold()
    return ct.AutoDiffManifold(plus_fn=m.plus, minus_fn=m.minus,
                               ambient_size=4, tangent_size=3)


def _torch_autodiff_quat():
    m = ctt.QuaternionManifold()
    return ctt.AutoDiffManifold(plus_fn=m.plus, minus_fn=m.minus,
                                ambient_size=4, tangent_size=3)


def _jax_angle():
    from ceres_tpu.examples.slam import angle_manifold as jax_angle
    return jax_angle()


# (name, torch manifold, JAX manifold, point maker, tangent scale)
CASES = [
    ("quaternion", ctt.QuaternionManifold(), ct.QuaternionManifold(),
     _quat, 0.5),
    ("eigen_quaternion", ctt.EigenQuaternionManifold(),
     ct.EigenQuaternionManifold(), _quat, 0.5),
    ("autodiff_quat", _torch_autodiff_quat(), _jax_autodiff_quat(), _quat,
     0.5),
    ("angle", angle_manifold(), _jax_angle(),
     lambda rng: rng.uniform(-3.0, 3.0, size=1), 0.1),
    # the rest of the stock manifolds (tests/test_manifolds.py's cases)
    ("subset4", ctt.SubsetManifold(4, [1, 3]), ct.SubsetManifold(4, [1, 3]),
     lambda rng: rng.normal(size=4), 0.5),
    ("subset_none_const", ctt.SubsetManifold(3, []),
     ct.SubsetManifold(3, []), lambda rng: rng.normal(size=3), 0.5),
    ("sphere3", ctt.SphereManifold(3), ct.SphereManifold(3),
     lambda rng: normalize(rng.normal(size=3)) * 2.0, 0.5),
    ("sphere5", ctt.SphereManifold(5), ct.SphereManifold(5),
     lambda rng: normalize(rng.normal(size=5)), 0.5),
    ("line3", ctt.LineManifold(3), ct.LineManifold(3),
     lambda rng: np.concatenate([rng.normal(size=3),
                                 normalize(rng.normal(size=3))]), 0.2),
    ("product", ctt.ProductManifold(ctt.EuclideanManifold(2),
                                    ctt.QuaternionManifold(),
                                    ctt.SphereManifold(3)),
     ct.ProductManifold(ct.EuclideanManifold(2), ct.QuaternionManifold(),
                        ct.SphereManifold(3)),
     lambda rng: np.concatenate([rng.normal(size=2),
                                 normalize(rng.normal(size=4)),
                                 normalize(rng.normal(size=3))]), 0.5),
]
IDS = [c[0] for c in CASES]


def check_manifold_invariants(manifold, x, delta, atol=1e-9):
    """manifold_test_kit.check_manifold_invariants on torch tensors (the
    reference's EXPECT_THAT_MANIFOLD_INVARIANTS_HOLD)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    delta = torch.as_tensor(delta, dtype=torch.float64)
    zero = torch.zeros_like(delta)
    np.testing.assert_allclose(manifold.plus(x, zero).numpy(), x.numpy(),
                               atol=atol, err_msg="XPlusZeroIsXAt")
    np.testing.assert_allclose(manifold.minus(x, x).numpy(), zero.numpy(),
                               atol=atol, err_msg="XMinusXIsZeroAt")
    y = manifold.plus(x, delta)
    np.testing.assert_allclose(manifold.minus(y, x).numpy(), delta.numpy(),
                               atol=atol, err_msg="MinusPlusIsIdentityAt")
    np.testing.assert_allclose(
        manifold.plus(x, manifold.minus(y, x)).numpy(), y.numpy(),
        atol=atol, err_msg="PlusMinusIsIdentityAt")
    Jp = manifold.plus_jacobian(x).numpy()
    assert Jp.shape == (manifold.ambient_size, manifold.tangent_size)
    eps = 1e-7
    for i in range(manifold.tangent_size):
        e = torch.zeros(manifold.tangent_size, dtype=torch.float64)
        e[i] = eps
        fd = (manifold.plus(x, e) - manifold.plus(x, -e)).numpy() / (2 * eps)
        np.testing.assert_allclose(Jp[:, i], fd, atol=1e-6,
                                   err_msg="HasCorrectPlusJacobianAt")
    Jm = manifold.minus_jacobian(x).numpy()
    assert Jm.shape == (manifold.tangent_size, manifold.ambient_size)
    np.testing.assert_allclose(Jm @ Jp, np.eye(manifold.tangent_size),
                               atol=1e-7, err_msg="MinusPlusJacobianIdentity")


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("trial", range(3))
def test_manifold_invariants(case, trial):
    _, m, _, make_x, scale = case
    rng = np.random.default_rng(100 + trial)
    x = make_x(rng)
    check_manifold_invariants(m, x, scale * rng.normal(size=m.tangent_size))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_manifold_matches_jax(case):
    """plus, minus, plus_jacobian and minus_jacobian against the JAX
    package's manifold at the same points (f64)."""
    _, mt, mj, make_x, scale = case
    # jitted once: eager JAX traces the Jacobians anew at every point
    plus, minus, plus_jac, minus_jac = (jax.jit(f) for f in (
        mj.plus, mj.minus, mj.plus_jacobian, mj.minus_jacobian))
    rng = np.random.default_rng(7)
    for _ in range(4):
        x = make_x(rng)
        d = scale * rng.normal(size=mt.tangent_size)
        y = np.array(plus(jnp.asarray(x), jnp.asarray(d)))
        xt, dt = torch.as_tensor(x), torch.as_tensor(d)
        pairs = [
            (mt.plus(xt, dt), y),
            (mt.minus(torch.as_tensor(y), xt),
             minus(jnp.asarray(y), jnp.asarray(x))),
            (mt.plus_jacobian(xt), plus_jac(jnp.asarray(x))),
            (mt.minus_jacobian(xt), minus_jac(jnp.asarray(x))),
        ]
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plus_batch_matches_one_block_at_a_time(case):
    """The program's batched Plus over a slab of blocks."""
    _, m, _, make_x, scale = case
    rng = np.random.default_rng(3)
    X = torch.as_tensor(np.stack([make_x(rng) for _ in range(9)]))
    D = torch.as_tensor(scale * rng.normal(size=(9, m.tangent_size)))
    got = m.plus_batch(X, D)
    want = torch.stack([m.plus(X[i], D[i]) for i in range(9)])
    assert torch.equal(got, want)


def test_quaternion_plus_matches_rotation_composition():
    """QuaternionManifold Plus composes rotations (manifold_test.cc):
    rotating by Plus(q, delta) is rotating by q, then by the angle-axis
    2 delta (the half-angle convention)."""
    rng = np.random.default_rng(7)
    q = normalize(rng.normal(size=4))
    delta = 0.3 * rng.normal(size=3)
    y = ctt.QuaternionManifold().plus(torch.as_tensor(q),
                                      torch.as_tensor(delta))
    np.testing.assert_allclose(float(torch.linalg.vector_norm(y)), 1.0,
                               atol=1e-12)
    pt = rng.normal(size=3)
    p1 = np.asarray(jrot.unit_quaternion_rotate_point(jnp.asarray(y.numpy()),
                                                      jnp.asarray(pt)))
    p_q = np.asarray(jrot.unit_quaternion_rotate_point(jnp.asarray(q),
                                                       jnp.asarray(pt)))
    p2 = ctt.rotation.angle_axis_rotate_point(
        torch.as_tensor(2.0 * delta), torch.as_tensor(p_q)).numpy()
    np.testing.assert_allclose(p1, p2, atol=1e-12)


def test_quaternion_minus_plus_identity_beyond_half_pi():
    """Minus(Plus(x, d), x) = d for |d| up to pi: the log keeps the
    quaternion double cover apart (manifold.cc:105, no sign flip)."""
    m = ctt.QuaternionManifold()
    x = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    for d in ([2.0, 0.0, 0.0], [0.0, 1.9, 0.0], [1.2, 1.2, 1.2],
              [2.9, 0.4, 0.0]):
        d = torch.tensor(d, dtype=torch.float64)
        np.testing.assert_allclose(m.minus(m.plus(x, d), x).numpy(),
                                   d.numpy(), atol=1e-12)
    me = ctt.EigenQuaternionManifold()
    xe = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    d = torch.tensor([2.0, 0.3, -0.4], dtype=torch.float64)
    np.testing.assert_allclose(me.minus(me.plus(xe, d), xe).numpy(),
                               d.numpy(), atol=1e-12)


def test_quaternion_product_matches_jax():
    rng = np.random.default_rng(11)
    z, w = rng.normal(size=(5, 4)), rng.normal(size=(5, 4))
    got = ctt.rotation.quaternion_product(torch.as_tensor(z),
                                          torch.as_tensor(w)).numpy()
    want = np.asarray(jrot.quaternion_product(jnp.asarray(z),
                                              jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(
        ctt.rotation.quaternion_conjugate(torch.as_tensor(z)).numpy(),
        np.asarray(jrot.quaternion_conjugate(jnp.asarray(z))))


def test_subset_manifold_holds_constants():
    m = ctt.SubsetManifold(4, [0, 2])
    y = m.plus(torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64),
               torch.tensor([0.5, -0.5], dtype=torch.float64))
    np.testing.assert_allclose(y.numpy(), [1.0, 2.5, 3.0, 3.5])


def test_subset_manifold_accepts_numpy():
    m = ctt.SubsetManifold(4, [1, 3])
    out = m.plus(np.array([1.0, 2.0, 3.0, 4.0]), np.array([0.1, 0.2]))
    np.testing.assert_allclose(out.numpy(), [1.1, 2.0, 3.2, 4.0])


def test_sphere_norm_preserved():
    rng = np.random.default_rng(3)
    x = rng.normal(size=4) * 3.0
    y = ctt.SphereManifold(4).plus(torch.as_tensor(x),
                                   torch.as_tensor(rng.normal(size=3) * 0.4))
    np.testing.assert_allclose(float(torch.linalg.vector_norm(y)),
                               np.linalg.norm(x), rtol=1e-12)


def test_line_manifold_origin_tangent_scale():
    """The origin moves by exactly |delta_o| (line_manifold.h:212, no
    half factor), and minus inverts plus."""
    m = ctt.LineManifold(3)
    x = torch.tensor([1.0, 2.0, 3.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    delta = torch.tensor([0.3, -0.7, 0.0, 0.0], dtype=torch.float64)
    y = m.plus(x, delta)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(y[:3] - x[:3])),
                               float(torch.linalg.vector_norm(delta[:2])),
                               rtol=1e-12)
    np.testing.assert_allclose(m.minus(y, x).numpy(), delta.numpy(),
                               atol=1e-12)


@pytest.mark.parametrize("sigma_zero", [False, True])
def test_householder_vector_matches_jax(sigma_zero):
    """householder_vector and _apply_householder against the JAX
    package's, including the sigma = 0 branch (x on the last axis)."""
    from ceres_tpu.manifolds import (_apply_householder as jax_apply,
                                     householder_vector as jax_hv)
    from ceres_tpu_torch.manifolds import (_apply_householder,
                                           householder_vector)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6, 4))
    if sigma_zero:
        X[:, :-1] = 0.0
        X[::2, -1] *= -1.0
    Y = rng.normal(size=(6, 4))
    v, beta = householder_vector(torch.as_tensor(X))
    vj, bj = jax_hv(jnp.asarray(X))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(beta.numpy(), np.asarray(bj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        _apply_householder(v, beta, torch.as_tensor(Y)).numpy(),
        np.asarray(jax_apply(vj, bj, jnp.asarray(Y))), rtol=1e-12,
        atol=1e-12)
