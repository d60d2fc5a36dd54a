"""K7: the whole block-preconditioned CG solve of the reduced camera system.

Counterpart of ceres_tpu/ops/pallas_pcg.py (dense_pcg, _pcg_kernel).
`dense_pcg` launches csrc/pcg.cu for CUDA tensors and runs
`dense_pcg_plain` (solvers/cg.py conjugate_gradients on the dense S) for
CPU tensors. The preconditioner comes as its inverted [kf, tf, tf]
diagonal blocks, or None for IDENTITY; the TPU kernel's dense padded
[P, P] inverse is a TPU layout. y0 = 0, as in the fused solve.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..solvers.cg import conjugate_gradients

MAX_M = 1024


def _block_apply(minv_blocks, m):
    """v -> blockdiag(minv_blocks) v, or None for IDENTITY."""
    if minv_blocks is None:
        return None
    kf, tf, _ = minv_blocks.shape

    def apply(v):
        return torch.sum(minv_blocks * v.view(kf, 1, tf), dim=-1).view(m)
    return apply


def dense_pcg_plain(S, b, minv_blocks, *, max_iterations: int,
                    min_iterations: int = 0, q_tolerance: float = 0.0,
                    residual_reset_period: int = 10):
    """Plain PyTorch K7: S SPD [m, m] f32, b [m], minv_blocks [kf, tf, tf]
    (kf * tf = m) or None. Returns (y [m], iterations int32, final ||r||)
    with solvers/cg.py semantics from y0 = 0."""
    m = S.shape[0]
    res = conjugate_gradients(
        lambda v: torch.mv(S, v), b, None,
        apply_preconditioner=_block_apply(minv_blocks, m),
        max_iterations=max_iterations, min_iterations=min_iterations,
        q_tolerance=q_tolerance,
        residual_reset_period=residual_reset_period)
    return res.x, res.num_iterations, res.final_norm


def dense_pcg(S, b, minv_blocks, *, max_iterations: int,
              min_iterations: int = 0, q_tolerance: float = 0.0,
              residual_reset_period: int = 10):
    """K7: see dense_pcg_plain; m <= 1024 on the card. The iteration
    count and the norm stay on the device."""
    if not S.is_cuda:
        return dense_pcg_plain(
            S, b, minv_blocks, max_iterations=max_iterations,
            min_iterations=min_iterations, q_tolerance=q_tolerance,
            residual_reset_period=residual_reset_period)
    m = S.shape[0]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"dense_pcg: m = {m} outside 1..{MAX_M}")
    if residual_reset_period < 1 or max_iterations < 0:
        raise ValueError("dense_pcg: needs residual_reset_period >= 1 and "
                         "max_iterations >= 0")
    f32 = torch.float32
    _cuda.check(S, (m, m), f32, "dense_pcg: S")
    _cuda.check(b, (m,), f32, "dense_pcg: b")
    tf = 1
    if minv_blocks is not None:
        kf, tf = minv_blocks.shape[0], minv_blocks.shape[-1]
        if kf * tf != m:
            raise ValueError(f"dense_pcg: blocks {tuple(minv_blocks.shape)} "
                             f"do not tile m = {m}")
        _cuda.check(minv_blocks, (kf, tf, tf), f32, "dense_pcg: minv_blocks")
    y = torch.empty_like(b)
    iters = torch.empty((), dtype=torch.int32, device=S.device)
    norm = torch.empty((), dtype=f32, device=S.device)
    _cuda.launch("ceres_pcg", S, b, minv_blocks, m, tf, int(max_iterations),
                 int(min_iterations), float(q_tolerance),
                 int(residual_reset_period), y, iters, norm)
    dense_pcg.launches += 1
    return y, iters, norm


dense_pcg.launches = 0
