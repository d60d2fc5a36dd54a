"""Cubic Hermite interpolation of sampled functions, differentiable.

Counterpart of ceres_tpu/interpolation.py (the reference's
cubic_interpolation.h: CubicInterpolator :124 over Grid1D :184,
BiCubicInterpolator :252 over Grid2D :381). The reference evaluates the
value and its derivative by hand so that Jets flow through; here the
interpolant is torch code, so torch.func.jacfwd differentiates it exactly
(the interpolant's own derivative) inside a cost functor, and
torch.func.vmap maps it over a bucket: a grid is indexed with index
tensors, which may be batched.

Catmull-Rom (cubic_interpolation.h:63 CubicHermiteSpline), with indices
clamped to the grid's declared range first and to its array after.
A grid keeps its samples as numpy and hands them out as a tensor on the
device and in the dtype of the values that index it (made once per
device and dtype).
"""

from __future__ import annotations

import numpy as np
import torch


def _hermite(p0, p1, p2, p3, x):
    """Catmull-Rom cubic on [0, 1] through four control points (value
    dimensions last), at x."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    return p1 + x * (c + x * (b + x * a))


class _Samples:
    """The samples as numpy and, per (device, dtype), as a tensor."""

    def __init__(self, data, ndim):
        self.array = np.asarray(data, dtype=np.float64)
        if self.array.ndim == ndim:
            self.array = self.array[..., None]
        self._tensors = {}

    def like(self, x):
        key = (x.device, x.dtype if x.is_floating_point() else
               torch.float64)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(self.array, dtype=key[1],
                                                 device=key[0])
        return self._tensors[key]


def _take(table, idx):
    """table[idx] over its first dimension for an integer tensor idx of
    any shape (a 0-d one too), under vmap as well."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def _clip(x, lo, hi):
    """min(max(x, lo), hi), whose derivative at a tie is 1/2 (as the JAX
    package's jnp.clip gives it; torch.clamp's is 1)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float64)


class Grid1D:
    """cubic_interpolation.h:184: samples on [begin, end), clamped outside
    (data [n] or [n, dim])."""

    def __init__(self, data, begin: int = 0, end: int = None):
        self._samples = _Samples(data, 1)
        self.data = self._samples.array
        self.begin = begin
        self.end = end if end is not None else begin + self.data.shape[0]

    def __call__(self, n, like=None):
        """The samples at integer n (a tensor or an int), [..., dim]; on
        the device and in the dtype of `like` (default n's device, f64)."""
        n = _as_tensor(n).long()
        # the declared range first (end may be tighter than the array),
        # then the array
        n = torch.clamp(n, self.begin, self.end - 1)
        idx = torch.clamp(n - self.begin, 0, self.data.shape[0] - 1)
        return _take(self._samples.like(n if like is None else like), idx)


class CubicInterpolator:
    """cubic_interpolation.h:124: evaluate(x) -> [dim], or a 0-d tensor
    for a one-dimensional grid."""

    def __init__(self, grid: Grid1D):
        self.grid = grid if isinstance(grid, Grid1D) else Grid1D(grid)

    def evaluate(self, x):
        g = self.grid
        x = _as_tensor(x)
        xc = _clip(x, g.begin, g.end - 1)
        n = torch.clamp(torch.floor(xc).long(), g.begin, g.end - 2)
        t = (xc - n)[..., None]
        out = _hermite(g(n - 1, x), g(n, x), g(n + 1, x), g(n + 2, x), t)
        return out[..., 0] if out.shape[-1] == 1 else out

    def __call__(self, x):
        return self.evaluate(x)


class Grid2D:
    """cubic_interpolation.h:381: samples [rows, cols] or [rows, cols,
    dim] on [row_begin, row_end) x [col_begin, col_end), clamped."""

    def __init__(self, data, row_begin: int = 0, row_end: int = None,
                 col_begin: int = 0, col_end: int = None):
        self._samples = _Samples(data, 2)
        self.data = self._samples.array
        self.row_begin = row_begin
        self.row_end = (row_end if row_end is not None
                        else row_begin + self.data.shape[0])
        self.col_begin = col_begin
        self.col_end = (col_end if col_end is not None
                        else col_begin + self.data.shape[1])

    def __call__(self, r, c, like=None):
        r, c = _as_tensor(r).long(), _as_tensor(c).long()
        r = torch.clamp(r, self.row_begin, self.row_end - 1)
        c = torch.clamp(c, self.col_begin, self.col_end - 1)
        ri = torch.clamp(r - self.row_begin, 0, self.data.shape[0] - 1)
        ci = torch.clamp(c - self.col_begin, 0, self.data.shape[1] - 1)
        table = self._samples.like(r if like is None else like)
        return _take(table.reshape(-1, table.shape[-1]),
                     ri * self.data.shape[1] + ci)


class BiCubicInterpolator:
    """cubic_interpolation.h:252: separable bicubic (rows, then columns)."""

    def __init__(self, grid: Grid2D):
        self.grid = grid if isinstance(grid, Grid2D) else Grid2D(grid)

    def evaluate(self, r, c):
        g = self.grid
        r, c = _as_tensor(r), _as_tensor(c)
        rc = _clip(r, g.row_begin, g.row_end - 1)
        cc = _clip(c, g.col_begin, g.col_end - 1)
        rn = torch.clamp(torch.floor(rc).long(), g.row_begin, g.row_end - 2)
        cn = torch.clamp(torch.floor(cc).long(), g.col_begin, g.col_end - 2)
        tr = (rc - rn)[..., None]
        tc = (cc - cn)[..., None]
        rows = []
        for dr in (-1, 0, 1, 2):
            p = [g(rn + dr, cn + dc, rc) for dc in (-1, 0, 1, 2)]
            rows.append(_hermite(p[0], p[1], p[2], p[3], tc))
        out = _hermite(rows[0], rows[1], rows[2], rows[3], tr)
        return out[..., 0] if out.shape[-1] == 1 else out

    def __call__(self, r, c):
        return self.evaluate(r, c)
