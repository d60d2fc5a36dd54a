"""Block-Jacobi preconditioning of the CGNR normal equations.

Counterpart of ceres_tpu/solvers/preconditioners.py
make_block_jacobi_preconditioner (the reference's
block_jacobi_preconditioner.h:55): M = blockdiag(J^T J + D^T D) per
parameter block, grouped by tangent size, each group's [k, t, t] blocks
inverted in one batched Cholesky; a CG application is then one batched
multiply per group. The J^T J blocks do not depend on the trust-region
radius, so the generic LM step forms them once per linearization
(ops/bsr.py block_diag_jtj) and inverts M once per damped solve.

And the SUBSET preconditioner (`SubsetPreconditioner`, ceres_tpu
make_subset_preconditioner_factory, :58-148; the reference's
subset_preconditioner.h:70) on the native LDL^T of
solvers/sparse_direct.py. The other preconditioners are ROADMAP.md item
36.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ops.kernels import row_grams
from .sparse_direct import SparseNormalCholeskyContext, bucket_grams, to_host


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


class SubsetPreconditioner:
    """SUBSET for CGNR: M = Q^T Q + D^2, Q the rows of J of the residual
    blocks in options.residual_blocks_for_subset_preconditioner. The
    device forms the subset rows' Grams (K9's per-row form in f32, an
    einsum in f64) and the host assembles them once per linearization
    (`system`); each damped solve factors M with the native LDL^T
    (`make`), and each CG application is one copy of v to the host, one
    backsolve and one copy back, through pinned buffers allocated once per
    linearization. A breakdown makes the preconditioner the identity, as
    in the JAX package. (The JAX package's device-dense variant, for TPU
    backends without host callbacks, is not ported: ROADMAP.md.)"""

    def __init__(self, program, options):
        subset = options.residual_blocks_for_subset_preconditioner
        if not subset:
            raise ValueError(
                "SUBSET preconditioner requires "
                "residual_blocks_for_subset_preconditioner (solver.h)")
        subset_idx = np.asarray(sorted({rb.index for rb in subset}),
                                dtype=np.int64)
        self.lanes = [np.nonzero(np.isin(bk.orig_indices, subset_idx))[0]
                      for bk in program.buckets]
        self.ctx = SparseNormalCholeskyContext(program,
                                               lanes_per_bucket=self.lanes)
        self.device = program.device

    def system(self, jac):
        """The subset rows' J^T J as CSC values on the host, with the
        pinned buffers of this linearization's CG applications."""
        values = self.ctx.assemble(to_host(*bucket_grams(jac, self.lanes)))
        n = self.ctx.n
        pin = self.device.type == "cuda"
        bufs = (torch.empty(n, dtype=torch.float64, pin_memory=pin),
                torch.empty(n, dtype=torch.float64, pin_memory=pin))
        return values, bufs

    def make(self, system, D):
        """apply(v) = M^-1 v for the damping D."""
        values, (v_h, x_h) = system
        (d_sq,) = to_host(D * D)
        self.ctx.factor_values(values, d_sq)
        v_np, x_np = v_h.numpy(), x_h.numpy()

        def apply(v):
            v_h.copy_(v)
            self.ctx.host_apply(v_np, out=x_np)
            # a copy: the next application overwrites x_h
            return x_h.to(self.device, dtype=v.dtype, copy=True)

        return apply


def batched_block_jacobi(jtj_blocks, D, groups):
    """make_block_jacobi_preconditioner on the element axis: `jtj_blocks`
    the stacked groups' [B * k, t, t] J^T J blocks (element after
    element), D [B, n], `groups` the template program's GroupMeta list;
    apply(v) maps [B, n] to [B, n]."""
    B = D.shape[0]
    factors = []
    for g, M in zip(groups, jtj_blocks):
        k, t = g.num_blocks, g.tangent_size
        d = D[:, g.tan_start:g.tan_start + k * t].reshape(B * k, t)
        factors.append(spd_inv_small(M + torch.diag_embed(d * d)))

    def apply(v):
        return torch.cat([
            torch.sum(inv * v[:, g.tan_start:g.tan_start + g.num_blocks
                              * g.tangent_size].reshape(
                                  B * g.num_blocks, 1, g.tangent_size),
                      dim=-1).reshape(B, -1)
            for g, inv in zip(groups, factors)], dim=1)

    return apply


class BatchedSubset:
    """SUBSET on the element axis (the JAX package's sequential host
    callback under vmap): the subset rows' Grams of every element formed
    on the device from the stacked Jacobian (row_grams, one einsum: the
    JAX package's vmapped route calls no Gram kernel) and copied to the
    host once a linearization; each damped
    solve factors each element's M = Q^T Q + D^2 on its own native LDL^T
    (one instance an element, the template's pattern), in element order;
    each CG application copies every element's v to the host once,
    backsolves the elements in order and copies them back once. A
    breakdown makes that element's preconditioner the identity."""

    def __init__(self, subset: "SubsetPreconditioner", stack):
        ctx = subset.ctx
        self.ctx, self.B, self.device = ctx, stack.B, subset.device
        self.lanes = stack.lanes(subset.lanes)
        self.chols = [native.SparseCholesky(ctx.n, ctx.Ap, ctx.Ai,
                                            ordering=ctx._ordering)
                      for _ in range(stack.B)]

    def system(self, jac):
        B, n = self.B, self.ctx.n
        grams = []
        for b, ln in zip(jac.buckets, self.lanes):
            J = b.J[torch.as_tensor(ln, device=b.J.device)]
            grams.append(row_grams(J) if J.shape[0] and J.shape[2]
                         else J.new_zeros((J.shape[0], J.shape[2],
                                           J.shape[2])))
        flats = to_host(*grams)
        values = [self.ctx.assemble([f.reshape(B, -1)[e] for f in flats])
                  for e in range(B)]
        pin = self.device.type == "cuda"
        bufs = (torch.empty(B, n, dtype=torch.float64, pin_memory=pin),
                torch.empty(B, n, dtype=torch.float64, pin_memory=pin))
        return values, bufs

    def make(self, system, D):
        """apply(v) = M^-1 v for v [B, n] at the damping D [B * n]."""
        values, (v_h, x_h) = system
        (d_sq,) = to_host(D * D)
        d_sq = d_sq.reshape(self.B, -1)
        ok = []
        for e, chol in enumerate(self.chols):
            vals = values[e].copy()
            vals[self.ctx.diag_pos] += d_sq[e]
            ok.append(chol.factor(vals) == 0)
        v_np, x_np = v_h.numpy(), x_h.numpy()

        def apply(v):
            v_h.copy_(v)
            for e, chol in enumerate(self.chols):
                if ok[e]:
                    chol.solve(v_np[e], out=x_np[e])
                else:
                    x_np[e] = v_np[e]
            return x_h.to(self.device, dtype=v.dtype, copy=True)

        return apply
