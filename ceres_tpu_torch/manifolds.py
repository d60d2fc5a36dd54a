"""Manifolds of parameter blocks, on torch tensors.

Counterpart of ceres_tpu/manifolds.py: the Manifold base (the
reference's manifold.h:148), EuclideanManifold (:241), SubsetManifold
(:317), QuaternionManifold (:366), EigenQuaternionManifold (:390),
SphereManifold (sphere_manifold.h:86), LineManifold (line_manifold.h:76),
ProductManifold (product_manifold.h:85), AutoDiffManifold
(autodiff_manifold.h:148) and the Householder machinery
(internal/householder_vector.h).

`plus(x, delta)` and `minus(y, x)` act on one block; `plus_batch` on a
[k, ambient] slab of blocks with [k, tangent] deltas, as the program's
Plus does once per (manifold, size) group. The stock manifolds here are
written over the last dimension and batch directly; a user's
AutoDiffManifold is mapped with `torch.func.vmap`. `plus_jacobian` and
`minus_jacobian` default to `torch.func.jacfwd` of plus and minus.
"""

from __future__ import annotations

import torch

from . import rotation as rot


class Manifold:
    """Base manifold (manifold.h:148)."""

    @property
    def ambient_size(self) -> int:
        raise NotImplementedError

    @property
    def tangent_size(self) -> int:
        raise NotImplementedError

    def plus(self, x, delta):
        raise NotImplementedError

    def minus(self, y, x):
        raise NotImplementedError

    def plus_batch(self, x, delta):
        """plus over a [k, ambient] slab with [k, tangent] deltas."""
        return torch.func.vmap(self.plus)(x, delta)

    def plus_jacobian(self, x):
        """d/d delta plus(x, delta) at delta = 0: [ambient, tangent]."""
        zero = torch.zeros(self.tangent_size, dtype=x.dtype, device=x.device)
        return torch.func.jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x):
        """d/dy minus(y, x) at y = x: [tangent, ambient]."""
        return torch.func.jacfwd(lambda y: self.minus(y, x))(x)

    def bucket_key(self):
        return (type(self).__name__, self.ambient_size, self.tangent_size)


class EuclideanManifold(Manifold):
    """Plus = +, Minus = - (manifold.h:241)."""

    def __init__(self, size: int):
        self._size = int(size)

    @property
    def ambient_size(self):
        return self._size

    @property
    def tangent_size(self):
        return self._size

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    plus_batch = plus

    def plus_jacobian(self, x):
        return torch.eye(self._size, dtype=x.dtype, device=x.device)

    def minus_jacobian(self, x):
        return torch.eye(self._size, dtype=x.dtype, device=x.device)


class SubsetManifold(Manifold):
    """Euclidean on a subset of the coordinates; the others are held
    constant (manifold.h:317)."""

    def __init__(self, size: int, constant_indices):
        self._size = int(size)
        const = sorted(set(int(i) for i in constant_indices))
        for i in const:
            if not 0 <= i < size:
                raise ValueError(f"constant index {i} out of range "
                                 f"[0,{size})")
        self._constant = const
        self._free = [i for i in range(size) if i not in set(const)]

    @property
    def ambient_size(self):
        return self._size

    @property
    def tangent_size(self):
        return len(self._free)

    def plus(self, x, delta):
        x = torch.as_tensor(x)
        if not self._free:
            return x
        return x.index_add(-1, torch.as_tensor(self._free, device=x.device),
                           torch.as_tensor(delta, dtype=x.dtype,
                                           device=x.device))

    def minus(self, y, x):
        y, x = torch.as_tensor(y), torch.as_tensor(x)
        return (y - x)[..., self._free]

    plus_batch = plus

    def bucket_key(self):
        return ("SubsetManifold", self._size, tuple(self._constant))


class QuaternionManifold(Manifold):
    """Unit quaternion, Ceres [w, x, y, z] order (manifold.h:366).

    Plus(x, delta) = exp(delta) * x, where |delta| is the half rotation
    angle (manifold.cc QuaternionPlusImpl)."""

    @property
    def ambient_size(self):
        return 4

    @property
    def tangent_size(self):
        return 3

    @staticmethod
    def _exp(delta):
        # [cos|d|, sin|d|/|d| d], with the Taylor branch near zero
        sq = torch.sum(delta * delta, dim=-1, keepdim=True)
        small = sq < 1e-12
        nd = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
        k = torch.where(small, 1.0 - sq / 6.0, torch.sin(nd) / nd)
        w = torch.where(small, 1.0 - sq / 2.0, torch.cos(nd))
        return torch.cat([w, delta * k], dim=-1)

    @staticmethod
    def _log(q):
        # inverse of _exp: theta = atan2(|u|, w) with no sign flip
        # (manifold.cc:105 QuaternionMinusImpl), so Minus(Plus(x, d), x)
        # = d holds for |d| up to pi
        sq = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
        small = sq < 1e-12
        sn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
        w = q[..., :1]
        atan = torch.atan2(sn, w)
        k = torch.where(small,
                        1.0 / torch.where(w == 0, torch.ones_like(w), w),
                        atan / sn)
        return q[..., 1:] * k

    def plus(self, x, delta):
        return rot.quaternion_product(self._exp(delta), x)

    def minus(self, y, x):
        return self._log(rot.quaternion_product(
            y, rot.quaternion_conjugate(x)))

    plus_batch = plus


class EigenQuaternionManifold(QuaternionManifold):
    """The same manifold in Eigen's storage order [x, y, z, w]
    (manifold.h:390)."""

    _TO_WFIRST = [3, 0, 1, 2]
    _TO_EIGEN = [1, 2, 3, 0]

    def plus(self, x, delta):
        xw = x[..., self._TO_WFIRST]
        return super().plus(xw, delta)[..., self._TO_EIGEN]

    def minus(self, y, x):
        return super().minus(y[..., self._TO_WFIRST],
                             x[..., self._TO_WFIRST])

    plus_batch = plus


def householder_vector(x):
    """The Householder vector v (v[-1] = 1) and beta with
    (I - beta v v^T) x = |x| e_last, over the last dimension (the
    reference's householder_vector.h)."""
    one = torch.ones_like(x[..., -1])
    sigma = torch.sum(x[..., :-1] * x[..., :-1], dim=-1)
    xn = x[..., -1]
    zero_sigma = sigma < 1e-30
    mu = torch.sqrt(xn * xn + sigma)
    v_last = torch.where(xn <= 0.0, xn - mu,
                         -sigma / torch.where(zero_sigma, one, xn + mu))
    safe_v_last = torch.where(zero_sigma, one, v_last)
    beta = torch.where(
        zero_sigma, torch.where(xn < 0.0, 2.0 * one, 0.0 * one),
        2.0 * safe_v_last * safe_v_last
        / (sigma + safe_v_last * safe_v_last))
    v = torch.cat([x[..., :-1] / safe_v_last[..., None], one[..., None]],
                  dim=-1)
    e_last = torch.cat([torch.zeros_like(x[..., :-1]), one[..., None]],
                       dim=-1)
    return torch.where(zero_sigma[..., None], e_last, v), beta


def _apply_householder(v, beta, y):
    """(I - beta v v^T) y."""
    return y - beta[..., None] * v * torch.sum(v * y, dim=-1, keepdim=True)


class SphereManifold(Manifold):
    """The sphere of radius |x| in R^n, tangent size n - 1
    (sphere_manifold.h:86, sphere_manifold_functions.h)."""

    def __init__(self, size: int):
        if size < 2:
            raise ValueError("SphereManifold needs ambient size >= 2")
        self._size = int(size)

    @property
    def ambient_size(self):
        return self._size

    @property
    def tangent_size(self):
        return self._size - 1

    def bucket_key(self):
        return ("SphereManifold", self._size)

    def plus(self, x, delta):
        x = torch.as_tensor(x)
        delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)
        v, beta = householder_vector(x)
        norm_x = torch.linalg.vector_norm(x, dim=-1)
        sq = torch.sum(delta * delta, dim=-1)
        small = sq < 1e-28
        nd = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
        sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(nd) / nd)
        y = torch.cat([sinc[..., None] * delta,
                       torch.where(small, 1.0 - sq / 2.0,
                                   torch.cos(nd))[..., None]], dim=-1)
        return norm_x[..., None] * _apply_householder(v, beta, y)

    def minus(self, y, x):
        y, x = torch.as_tensor(y), torch.as_tensor(x)
        v, beta = householder_vector(x)
        hy = _apply_householder(v, beta, y)
        ny = torch.linalg.vector_norm(y, dim=-1)
        hy = hy / torch.where(ny == 0, torch.ones_like(ny), ny)[..., None]
        head, last = hy[..., :-1], hy[..., -1]
        sq = torch.sum(head * head, dim=-1)
        small = sq < 1e-28
        sn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
        k = torch.where(small, torch.ones_like(sq),
                        torch.atan2(sn, last) / sn)
        return head * k[..., None]

    plus_batch = plus


class LineManifold(Manifold):
    """A line in R^n as (origin, direction): ambient 2n, tangent 2(n - 1)
    (line_manifold.h:76). The direction moves on the sphere, the origin
    in the hyperplane orthogonal to the direction."""

    def __init__(self, ambient_space_dim: int):
        if ambient_space_dim < 2:
            raise ValueError("LineManifold needs spatial dim >= 2")
        self._dim = int(ambient_space_dim)
        self._sphere = SphereManifold(self._dim)

    @property
    def ambient_size(self):
        return 2 * self._dim

    @property
    def tangent_size(self):
        return 2 * (self._dim - 1)

    def bucket_key(self):
        return ("LineManifold", self._dim)

    def plus(self, x, delta):
        x = torch.as_tensor(x)
        delta = torch.as_tensor(delta, dtype=x.dtype, device=x.device)
        n = self._dim
        origin, direction = x[..., :n], x[..., n:]
        do, dd = delta[..., :n - 1], delta[..., n - 1:]
        # the origin's step is H [delta_o, 0] in the direction's
        # Householder frame, with no half factor (line_manifold.h:212)
        v, beta = householder_vector(direction)
        y = torch.cat([do, torch.zeros_like(do[..., :1])], dim=-1)
        return torch.cat([origin + _apply_householder(v, beta, y),
                          self._sphere.plus(direction, dd)], dim=-1)

    def minus(self, y, x):
        y, x = torch.as_tensor(y), torch.as_tensor(x)
        n = self._dim
        v, beta = householder_vector(x[..., n:])
        # the head of H (y_o - x_o), no doubling (line_manifold.h:265-267)
        h = _apply_householder(v, beta, y[..., :n] - x[..., :n])
        return torch.cat([h[..., :n - 1],
                          self._sphere.minus(y[..., n:], x[..., n:])],
                         dim=-1)

    plus_batch = plus


class ProductManifold(Manifold):
    """The Cartesian product of manifolds (product_manifold.h:85)."""

    def __init__(self, *manifolds):
        if not manifolds:
            raise ValueError("ProductManifold needs >= 1 manifold")
        self._manifolds = list(manifolds)
        self._amb = [0]
        self._tan = [0]
        for m in manifolds:
            self._amb.append(self._amb[-1] + m.ambient_size)
            self._tan.append(self._tan[-1] + m.tangent_size)

    @property
    def ambient_size(self):
        return self._amb[-1]

    @property
    def tangent_size(self):
        return self._tan[-1]

    def bucket_key(self):
        return ("ProductManifold",
                tuple(m.bucket_key() for m in self._manifolds))

    def _each(self, fn, a, b, b_tangent):
        """cat over the factors of fn(m)(a's part, b's part)."""
        a = torch.as_tensor(a)
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        ob = self._tan if b_tangent else self._amb
        return torch.cat([
            fn(m)(a[..., self._amb[i]:self._amb[i + 1]],
                  b[..., ob[i]:ob[i + 1]])
            for i, m in enumerate(self._manifolds)], dim=-1)

    def plus(self, x, delta):
        return self._each(lambda m: m.plus, x, delta, True)

    def plus_batch(self, x, delta):
        return self._each(lambda m: m.plus_batch, x, delta, True)

    def minus(self, y, x):
        return self._each(lambda m: m.minus, y, x, False)


class AutoDiffManifold(Manifold):
    """A manifold from the user's Plus and Minus functors, written with
    torch operations on one block; Jacobians by torch.func.jacfwd
    (autodiff_manifold.h:148)."""

    def __init__(self, plus_fn, minus_fn, ambient_size: int,
                 tangent_size: int):
        self._plus = plus_fn
        self._minus = minus_fn
        self._ambient = int(ambient_size)
        self._tangent = int(tangent_size)

    @property
    def ambient_size(self):
        return self._ambient

    @property
    def tangent_size(self):
        return self._tangent

    def bucket_key(self):
        return ("AutoDiffManifold", id(self._plus), id(self._minus),
                self._ambient, self._tangent)

    def plus(self, x, delta):
        return self._plus(x, delta)

    def minus(self, y, x):
        return self._minus(y, x)
