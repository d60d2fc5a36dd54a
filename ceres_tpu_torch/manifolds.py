"""Manifolds of parameter blocks, on torch tensors.

Counterpart of ceres_tpu/manifolds.py for the slices the port runs: the
Manifold base (the reference's manifold.h:148), EuclideanManifold
(:241), QuaternionManifold (:366), EigenQuaternionManifold (:390) and
AutoDiffManifold (autodiff_manifold.h:148). The other manifolds are
later work (ROADMAP.md, module list item 26).

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
