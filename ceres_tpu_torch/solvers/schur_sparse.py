"""SPARSE_SCHUR with a block-sparse reduced camera system.

Counterpart of ceres_tpu/solvers/schur_sparse.py (the reference's
SchurComplementSolver::SolveReducedLinearSystem for SPARSE_SCHUR,
schur_complement_solver.cc:291): the Schur complement S = F^T F -
F^T E (E^T E + D_e^2)^-1 E^T F assembled as a block-sparse matrix over
the camera co-visibility pattern and factored by the port's native host
LDL^T (native.py SparseCholesky, the CHOLMOD role), as
SPARSE_NORMAL_CHOLESKY does (solvers/sparse_direct.py):

  device: per (point, lane pair) block products over the chunk layout,
    summed into the unique co-visibility pair blocks in a fixed order
    (ops/bsr.py ColumnSum: no float atomics); the F^T F part and the
    lanes' cross blocks A = E^T F once per linearization, the correction
    once per damped solve; one [npairs, t, t] tensor, with the damping's
    D_f^2 and the rhs, crosses to the host per damped solve;
  host: the pair blocks scattered into a scalar CSC pattern analyzed once
    (symbolic analysis with the ordering of
    options.linear_solver_ordering_type), an LDL^T refactor and a solve.

Memory is O(co-visibility pairs t^2), not O(nf^2): no dense S is formed.
SPARSE_SCHUR takes this path past SPARSE_SCHUR_DENSE_NF camera-space
columns when the structure is supported (`use_sparse_schur`); the tests
lower the module constant to reach it at small sizes (the JAX package's
CERES_TPU_FORCE_SPARSE_SCHUR). A failed factorization gives a NaN step,
the invalid step that the trust-region loop rejects; nothing falls back
to a dense solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import native
from ..ops.bsr import ColumnSum
from ..ops.kernels import row_grams
from ..types import LinearSolverType
from .sparse_direct import _native_ordering, to_host

# Up to this many camera-space tangent columns SPARSE_SCHUR forms the
# dense S; past it, the block-sparse pattern on the host LDL^T.
SPARSE_SCHUR_DENSE_NF = 1024

# Pattern-size cap: the [ne, K, K] pair-id tensor must stay materializable.
_MAX_PAIR_IDS = int(2e8)


def _grouped_e_slots(meta):
    """[(bi, si, local)] of the single f group's slots in buckets with an
    e slot, and of those in f-only buckets."""
    e_slots, f_only = [], []
    for (bi, si, local) in meta.f_groups[0]["slots"]:
        (e_slots if meta.buckets[bi].e_slot is not None
         else f_only).append((bi, si, local))
    return e_slots, f_only


def sparse_schur_supported(meta) -> bool:
    """Structure the block-sparse assembly serves: one f group (uniform
    camera tangent size), one f slot per bucket and the chunk layout on
    every bucket with e and f slots."""
    if meta is None or len(meta.f_groups) != 1:
        return False
    per_bucket = {}
    for (bi, si, local) in meta.f_groups[0]["slots"]:
        per_bucket[bi] = per_bucket.get(bi, 0) + 1
    K = 0
    for bi, bs in enumerate(meta.buckets):
        if bs.f_cols is None:
            continue
        if per_bucket.get(bi, 0) != 1 or len(bs.f_slots) != 1:
            return False
        if bs.e_slot is not None:
            if bs.chunk_rows is None:
                return False
            K += bs.chunk_rows.shape[1]
    return meta.ne * K * K <= _MAX_PAIR_IDS


def use_sparse_schur(meta, options) -> bool:
    """Does SPARSE_SCHUR take the block-sparse host factorization (past
    SPARSE_SCHUR_DENSE_NF camera-space columns, on a supported
    structure) instead of the dense S?"""
    return (options.linear_solver_type == LinearSolverType.SPARSE_SCHUR
            and meta is not None and meta.nf > SPARSE_SCHUR_DENSE_NF
            and sparse_schur_supported(meta))


class SparseSchurContext:
    """The block-sparse S of one Schur structure: the co-visibility pair
    set, the pair-id maps and their fixed-order sums on the device, the
    scalar CSC expansion and the native LDL^T. `solves` counts the damped
    solves that this context served."""

    def __init__(self, meta, device, ordering: Optional[int] = None,
                 with_host: bool = True):
        """with_host=False builds the device side only (the pair blocks'
        sums; StackedSparseSchur factors on its template's context)."""
        self.meta, self.device = meta, torch.device(device)
        self.solves = 0
        grp = meta.f_groups[0]
        self.kf, self.t = kf, t = int(grp["kf"]), int(grp["t"])
        e_slots, f_only = _grouped_e_slots(meta)
        self.e_slots, self.f_only = e_slots, f_only

        # ---- co-visibility block-pair pattern ----
        # Lanes: per point, every bucket's chunk lanes side by side;
        # loc_cat[n, i] = the local camera of lane i (0 for padded lanes,
        # which go to the trash slot npairs)
        locs, masks = [], []
        for (bi, si, local) in e_slots:
            bs = meta.buckets[bi]
            locs.append(local[bs.chunk_rows].astype(np.int64))
            masks.append(bs.chunk_mask > 0.5)
        loc_cat = (np.concatenate(locs, axis=1) if locs
                   else np.zeros((meta.ne, 0), dtype=np.int64))
        mask_cat = (np.concatenate(masks, axis=1) if masks
                    else np.zeros((meta.ne, 0), dtype=bool))
        self.K = K = loc_cat.shape[1]
        keys = loc_cat[:, :, None] * kf + loc_cat[:, None, :]    # [ne,K,K]
        valid = mask_cat[:, :, None] & mask_cat[:, None, :]
        # the whole block diagonal: D^2 keeps S definite on cameras that no
        # residual touches
        diag_keys = np.arange(kf, dtype=np.int64) * (kf + 1)
        pair_keys = np.unique(np.concatenate([keys[valid].reshape(-1),
                                              diag_keys]))
        self.npairs = npairs = int(pair_keys.size)
        pid = np.where(valid, np.searchsorted(pair_keys, keys), npairs)

        # fixed-order sums into the npairs + 1 blocks: the F^T F part (each
        # e bucket's lanes, then each f-only bucket's rows), and per lane i
        # the correction blocks of lane i against every lane j
        columns, off = [], 0
        for (bi, si, local) in e_slots:
            k = meta.buckets[bi].chunk_rows.shape[1]
            columns.append(np.where(
                mask_cat[:, off:off + k],
                np.searchsorted(pair_keys, loc_cat[:, off:off + k] * (kf + 1)),
                npairs).reshape(-1))
            off += k
        for (bi, si, local) in f_only:
            columns.append(np.searchsorted(
                pair_keys, local.astype(np.int64) * (kf + 1)))
        columns = (np.concatenate(columns) if columns
                   else np.zeros(0, np.int64))
        self.ftf_sum = ColumnSum(np.arange(columns.size), columns,
                                 npairs + 1, self.device)
        self.corr_sums = [ColumnSum(np.arange(meta.ne * K),
                                    pid[:, i, :].reshape(-1), npairs + 1,
                                    self.device) for i in range(K)]
        self.chunks = [(bi, si,
                        torch.as_tensor(meta.buckets[bi].chunk_rows.astype(
                            np.int64), device=self.device),
                        torch.as_tensor(meta.buckets[bi].chunk_mask,
                                        device=self.device))
                       for (bi, si, local) in e_slots]
        self.cols_flat = torch.as_tensor(
            grp["cols"].reshape(-1).astype(np.int64), device=self.device)
        if not with_host:
            return

        # ---- scalar CSC expansion (group-local order, n = kf t) ----
        bi_of, bj_of = pair_keys // kf, pair_keys % kf
        a = np.arange(t, dtype=np.int64)
        rows = np.broadcast_to(bi_of[:, None, None] * t + a[None, :, None],
                               (npairs, t, t)).reshape(-1)
        cols = np.broadcast_to(bj_of[:, None, None] * t + a[None, None, :],
                               (npairs, t, t)).reshape(-1)
        self.n_sc = n_sc = kf * t
        order = np.lexsort((rows, cols))                 # CSC: column-major
        counts = np.zeros(n_sc + 1, dtype=np.int64)
        np.add.at(counts, cols + 1, 1)
        self.Ap = np.cumsum(counts)
        self.Ai = rows[order].astype(np.int32)
        self.csc_of_block = np.empty(order.size, dtype=np.int64)
        self.csc_of_block[order] = np.arange(order.size, dtype=np.int64)
        diag_p = np.searchsorted(pair_keys, diag_keys)
        self.diag_pos = self.csc_of_block[
            (diag_p[:, None] * t * t + a[None, :] * (t + 1)).reshape(-1)]
        self.chol = native.SparseCholesky(n_sc, self.Ap, self.Ai,
                                          ordering=ordering)

    def lanes(self, system):
        """(A [ne, K, te, t], the F^T F pair blocks [npairs + 1, t, t]) of
        one linearization, formed once (they do not depend on D)."""
        key = ("sparse_schur", id(self))
        if key not in system.cache:
            jac, t = system.jac, self.t
            A_parts, ftf_parts = [], []
            for (bi, si, rows, mask) in self.chunks:
                bj = jac.buckets[bi]
                m = mask.to(system.dtype)[..., None, None]
                Je_g = system.Je[bi][rows] * m
                Jf_g = bj.slot_J(si)[rows] * m
                ftf_parts.append(torch.einsum("nkrt,nkru->nktu", Jf_g,
                                              Jf_g).reshape(-1, t, t))
                A_parts.append(torch.einsum("nkre,nkrt->nket", Je_g, Jf_g))
            for (bi, si, local) in self.f_only:
                ftf_parts.append(row_grams(jac.buckets[bi].slot_J(si)))
            A = (torch.cat(A_parts, dim=1) if A_parts else None)
            P = (self.ftf_sum.sum_flat(torch.cat(ftf_parts)) if ftf_parts
                 else torch.zeros((self.npairs + 1, t, t), dtype=system.dtype,
                                  device=system.device))
            system.cache[key] = (A, P)
        return system.cache[key]

    def block_values(self, ops):
        """The pair blocks of S without damping, [npairs, t, t]: the F^T F
        blocks minus, lane after lane, the correction A_i^T (E^T E +
        D_e^2)^-1 A_j of each point's lane pairs, each a fixed-order sum."""
        A, vals = self.lanes(ops.system)
        if A is not None:
            Y = torch.einsum("neu,nkut->nket", ops.inv_ete, A)
            t = self.t
            for i in range(self.K):
                Bi = torch.einsum("net,nkeu->nktu", A[:, i], Y)
                vals = vals - self.corr_sums[i].sum_flat(Bi.reshape(-1, t, t))
        return vals[:self.npairs]

    def host_solve(self, vals: np.ndarray, d_sq_g: np.ndarray,
                   rhs_g: np.ndarray) -> np.ndarray:
        """vals: the pair blocks, flat; d_sq_g / rhs_g in group-local
        scalar order [kf t]. y, or NaNs on a factorization breakdown."""
        self.solves += 1
        values = np.empty(self.csc_of_block.size, dtype=np.float64)
        values[self.csc_of_block] = vals
        values[self.diag_pos] += d_sq_g
        if self.chol.factor(values) != 0:
            return np.full(self.n_sc, np.nan)
        return self.chol.solve(rhs_g)

    def reduced_solve(self, ops, rhs):
        """y = S^-1 rhs; rhs and the result in [nf] order, in rhs's
        precision. One copy to the host (the blocks, D_f^2, rhs) and one
        back."""
        vals = self.block_values(ops)
        d_sq_g = (ops.D_f * ops.D_f)[self.cols_flat]
        vals_h, d_sq_h, rhs_h = to_host(vals, d_sq_g, rhs[self.cols_flat])
        y_g = self.host_solve(vals_h, d_sq_h, rhs_h)
        y = torch.zeros_like(rhs)
        y[self.cols_flat] = torch.from_numpy(y_g).to(device=rhs.device,
                                                     dtype=rhs.dtype)
        return y


def get_sparse_schur_context(meta, program, options) -> SparseSchurContext:
    """The context of a Schur structure on the program's device, cached on
    the meta, keyed by the native ordering."""
    ordering = _native_ordering(options)
    key = (ordering, str(program.device))
    if meta._sparse_ctx is None or meta._sparse_ctx[0] != key:
        meta._sparse_ctx = (key, SparseSchurContext(meta, program.device,
                                                    ordering=ordering))
    return meta._sparse_ctx[1]


class StackedSparseSchur:
    """SPARSE_SCHUR past the dense cap on the element axis (the JAX
    package's sequential host callback under vmap): the pair blocks of
    every element's S formed on the device over a stacked meta
    (solvers/schur.py stack_meta; its pair keys sort element after
    element, each element's in the template's order), one copy of all
    elements' blocks, D_f^2 and rhs to the host, the template context's
    native LDL^T refactored and solved an element in element order, one
    copy back."""

    def __init__(self, template: SparseSchurContext, meta_s, device):
        self.host, self.B = template, meta_s.elements
        self.stacked = SparseSchurContext(meta_s, device, with_host=False)

    def reduced_solve(self, ops, rhs):
        """y [B nf] = S^-1 rhs of every element, in rhs's precision."""
        B, host = self.B, self.host
        vals = self.stacked.block_values(ops)
        nf = rhs.numel() // B
        c = host.cols_flat
        d_sq = (ops.D_f * ops.D_f).view(B, nf)[:, c]
        vals_h, d_sq_h, rhs_h = to_host(vals, d_sq, rhs.view(B, nf)[:, c])
        vals_h, d_sq_h, rhs_h = (a.reshape(B, -1)
                                 for a in (vals_h, d_sq_h, rhs_h))
        y_g = np.stack([host.host_solve(vals_h[e], d_sq_h[e], rhs_h[e])
                        for e in range(B)])
        y = torch.zeros((B, nf), dtype=rhs.dtype, device=rhs.device)
        y[:, c] = torch.from_numpy(y_g).to(device=rhs.device,
                                           dtype=rhs.dtype)
        return y.reshape(-1)
