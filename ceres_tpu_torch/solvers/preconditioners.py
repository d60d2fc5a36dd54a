"""Block-Jacobi preconditioning of the CGNR normal equations.

Counterpart of ceres_tpu/solvers/preconditioners.py
make_block_jacobi_preconditioner (the reference's
block_jacobi_preconditioner.h:55): M = blockdiag(J^T J + D^T D) per
parameter block, grouped by tangent size, each group's [k, t, t] blocks
inverted in one batched Cholesky; a CG application is then one batched
multiply per group. The J^T J blocks do not depend on the trust-region
radius, so the generic LM step forms them once per linearization
(ops/bsr.py block_diag_jtj) and inverts M once per damped solve. The
other preconditioners are ROADMAP.md item 36 (SUBSET: item 20).
"""

from __future__ import annotations

import torch


def spd_inv_small(M):
    """[k, t, t] SPD -> inverse by Cholesky and two triangular solves
    (ceres_tpu's _spd_inv_small and the block-Jacobi inverse). A block
    that is not positive definite gives NaN, as the JAX package's Cholesky
    does; nothing is read on the host."""
    t = M.shape[-1]
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    eye = torch.eye(t, dtype=M.dtype, device=M.device).expand(M.shape)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def make_block_jacobi_preconditioner(jtj_blocks, D, groups):
    """apply(v) = M^-1 v with M = blockdiag(J^T J + D^T D): `jtj_blocks`
    are the groups' [k, t, t] J^T J blocks, `groups` the program's
    GroupMeta list (each group one contiguous tangent slab)."""
    factors = []
    for g, M in zip(groups, jtj_blocks):
        k, t = g.num_blocks, g.tangent_size
        d = D[g.tan_start:g.tan_start + k * t].view(k, t)
        factors.append(spd_inv_small(M + torch.diag_embed(d * d)))

    def apply(v):
        return torch.cat([
            torch.sum(inv * v[g.tan_start:g.tan_start + g.num_blocks
                              * g.tangent_size].view(g.num_blocks, 1,
                                                     g.tangent_size),
                      dim=-1).reshape(-1)
            for g, inv in zip(groups, factors)])

    return apply
