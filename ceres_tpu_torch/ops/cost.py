"""K4: Snavely squared residual norms in f64, for the candidate cost.

Counterpart of ceres_tpu/ops/pallas_cost.py (_cost_kernel,
make_pallas_cost). The TPU kernel carried double-single f32 pairs because
the TPU has no f64; the port computes in straight f64 and is held to
program.cost_fn. A step binds the kernel's fixed inputs once
(`SnavelyCost`, checked there); `snavely_sq(x, cost)` then checks x
alone and launches csrc/cost.cu for a CUDA x, and runs
`snavely_sq_plain` for a CPU x.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..rotation import angle_axis_rotate_point

_F64, _I32 = torch.float64, torch.int32


class SnavelyCost:
    """K4's fixed inputs: the point of row i is x[e_slab + 3 p :][:3]
    with p = pt_idx[i] < ne, its camera x[f_slab + 9 c :][:9] with c =
    cam_idx[i] < kf (int32 [n] each); obsx/obsy [n] f64. On the card the
    inputs are checked here, once."""

    def __init__(self, e_slab: int, f_slab: int, ne: int, kf: int, pt_idx,
                 cam_idx, obsx, obsy):
        self.e_slab, self.f_slab = int(e_slab), int(f_slab)
        self.ne, self.kf = int(ne), int(kf)
        self.pt_idx, self.cam_idx, self.obsx, self.obsy = (
            pt_idx, cam_idx, obsx, obsy)
        self.n = pt_idx.numel()
        # the state entries the rows read
        self.size = max(self.e_slab + 3 * self.ne, self.f_slab + 9 * self.kf)
        if pt_idx.is_cuda:
            n = self.n
            _cuda.check(pt_idx, (n,), _I32, "SnavelyCost: pt_idx")
            _cuda.check(cam_idx, (n,), _I32, "SnavelyCost: cam_idx")
            _cuda.check(obsx, (n,), _F64, "SnavelyCost: obsx")
            _cuda.check(obsy, (n,), _F64, "SnavelyCost: obsy")
            if self.kf < 1 or min(self.e_slab, self.f_slab) < 0:
                raise ValueError(f"SnavelyCost: kf {self.kf}, slabs "
                                 f"{self.e_slab}, {self.f_slab}")


def snavely_sq_plain(x, cost: SnavelyCost):
    """Plain PyTorch K4: ||r||^2 [n] (f64) of the Snavely residual of each
    observation at the f64 state x (see SnavelyCost)."""
    pts = x[cost.e_slab + 3 * cost.pt_idx.long()[:, None]
            + torch.arange(3, device=x.device)]
    cams = x[cost.f_slab + 9 * cost.cam_idx.long()[:, None]
             + torch.arange(9, device=x.device)]
    p = angle_axis_rotate_point(cams[:, :3], pts) + cams[:, 3:6]
    xp = -p[:, 0] / p[:, 2]
    yp = -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2)
    rx = cams[:, 6] * distortion * xp - cost.obsx
    ry = cams[:, 6] * distortion * yp - cost.obsy
    return rx * rx + ry * ry


def snavely_sq(x, cost: SnavelyCost):
    """K4: see snavely_sq_plain for the contract. On the card x must be
    a contiguous f64 CUDA vector holding every entry the rows read, on
    the inputs' device."""
    if not x.is_cuda:
        return snavely_sq_plain(x, cost)
    if not (x.dtype is _F64 and x.dim() == 1 and x.is_contiguous()
            and x.numel() >= cost.size and x.device == cost.pt_idx.device):
        raise ValueError(f"snavely_sq: expected a contiguous f64 CUDA "
                         f"vector of at least {cost.size} entries on the "
                         f"inputs' device, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    sq = torch.empty(cost.n, dtype=_F64, device=x.device)
    _cuda.launch("ceres_cost", x, cost.e_slab, cost.f_slab, cost.pt_idx,
                 cost.cam_idx, cost.obsx, cost.obsy, cost.n, sq)
    snavely_sq.launches += 1
    return sq


snavely_sq.launches = 0
