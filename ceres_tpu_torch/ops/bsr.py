"""Bucketed block-sparse Jacobian.

Counterpart of ceres_tpu/ops/bsr.py (BucketJacobian, RVec, BlockJacobian,
block_diag_jtj; the reference's BlockSparseMatrix). Residual blocks are
grouped into shape-uniform buckets; a bucket's Jacobian is one dense
tensor [n, r, t_total] in tangent space, and each variable slot s holds
its global tangent columns cols[s] [n, t_s]. Residual vectors are carried
as per-bucket [n, r] tensors (RVec).

The transpose-side sums (J^T w, the squared column norms, the per-block
J^T J diagonal, the dense J^T J of the dense normal Cholesky) add many
rows into one column or block. The JAX package
scatter-adds them (with one-hot MXU products for few, heavy blocks, a TPU
limit the port leaves out). Here they are deterministic gathers: at
program build, `ColumnSum` sorts the contributions by column, stably, so
that each column keeps the JAX package's scatter order (bucket, slot,
row); a sum gathers the contributions in that order and reduces each
column's run with torch.segment_reduce: in order on the CPU (the same
bits as the JAX package's scatter), by CUB's segmented reduce on the
card. The block diagonal of J^T J (`block_diag_jtj`) keeps the same
order (`GroupMeta.gram_order`); on the card K9's group kernel forms and
sums it in one launch a group (per 8 slot views): one thread per block
entry adds the rows' Grams one after another in that order, from +0.
None uses float atomics, so a run gives the same bits every time.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .kernels import group_gram_blocks, group_grams


def sorted_segments(targets: Sequence[np.ndarray], device):
    """(perm, lengths, index) of a fixed-order sum of contributions into a
    flat output: `targets` lists each part's output places (int64, in the
    parts' scatter order, the parts concatenated); perm sorts the
    contributions stably by place, `index` holds the distinct places and
    `lengths` their counts, so that torch.segment_reduce(flat[perm], "sum",
    lengths=lengths) gives out[index] in the scatter order."""
    tgt = (np.concatenate(targets) if len(targets)
           else np.zeros(0, np.int64))
    order = np.argsort(tgt, kind="stable")
    index, counts = np.unique(tgt[order], return_counts=True)
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(counts, device=device),
            torch.as_tensor(index, device=device))


class ColumnSum:
    """Fixed-order segment sum: out[c] = the sum of the units at the
    positions listed for c, added in list order."""

    def __init__(self, positions: np.ndarray, columns: np.ndarray,
                 num_out: int, device, unit=()):
        """positions/columns: the contributions in scatter order (position
        in the concatenated inputs, output index). A unit is one element
        (unit=()) or one trailing block of shape `unit`."""
        order = np.argsort(columns, kind="stable")
        self.perm = torch.as_tensor(positions[order], device=device)
        self.lengths = torch.as_tensor(
            np.bincount(columns, minlength=num_out), device=device)
        self.unit = tuple(unit)

    def __call__(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum the units of the concatenated parts into [num_out, *unit]."""
        return self.sum_flat(torch.cat([p.reshape((-1,) + self.unit)
                                        for p in parts]))

    def sum_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum the units of parts already concatenated into `flat`."""
        return torch.segment_reduce(flat[self.perm], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)

    def gram_order(self):
        """(perm, lengths, index) of the dense J^T J (`jtj_dense`), built
        at the first call from the buckets' column maps: every entry
        (c_i, c_j) of a row's Gram [t_total, t_total], in the JAX
        package's scatter order (bucket, row, i, j), sorted stably by its
        place c_i * num_cols + c_j in H; `index` the distinct places and
        `lengths` their counts."""
        if getattr(self, "_gram", None) is None:
            targets = []
            for slots in self.bucket_cols:
                if not slots:
                    continue
                c = np.concatenate([np.asarray(s, dtype=np.int64)
                                    for s in slots], axis=1)
                targets.append((c[:, :, None] * self.num_cols
                                + c[:, None, :]).reshape(-1))
            self._gram = sorted_segments(targets, self.perm.device)
        return self._gram


def column_sum_for(bucket_cols: Sequence[Sequence[np.ndarray]],
                   num_cols: int, device) -> ColumnSum:
    """The ColumnSum of J^T-side products over buckets whose per-row
    contributions are [n, t_total] (slots concatenated): bucket_cols[b]
    is the list of the bucket's slot column maps [n, t_s]."""
    positions, columns, base = [], [], 0
    for slots in bucket_cols:
        if not slots:               # an all-constant bucket adds nothing
            continue
        n = slots[0].shape[0]
        t_total = sum(c.shape[1] for c in slots)
        off = 0
        for c in slots:
            t_s = c.shape[1]
            pos = (np.arange(n)[:, None] * t_total + off
                   + np.arange(t_s)[None, :])
            positions.append(base + pos.reshape(-1))
            columns.append(np.asarray(c, dtype=np.int64).reshape(-1))
            off += t_s
        base += n * t_total
    if not positions:               # no variable slot anywhere
        positions = columns = [np.zeros(0, dtype=np.int64)]
    out = ColumnSum(np.concatenate(positions), np.concatenate(columns),
                    num_cols, device)
    out.bucket_cols = [list(slots) for slots in bucket_cols]
    out.num_cols = num_cols
    return out


class BucketJacobian:
    """Jacobian of one bucket: J [n, r, t_total] (tangent space,
    loss-corrected), the slots' column maps cols [n, t_s] (int64), and
    all_cols [n, t_total], the slots' maps side by side, also as int32
    (cols32, K8's index type), converted once here."""

    def __init__(self, J, cols: Sequence[torch.Tensor], all_cols=None,
                 cols32=None):
        self.J = J
        self.cols = tuple(cols)
        if all_cols is None:        # none: an all-constant bucket
            all_cols = (torch.cat(self.cols, dim=1) if self.cols else
                        torch.zeros(J.shape[0], 0, dtype=torch.int64,
                                    device=J.device))
        self.all_cols = all_cols
        self.cols32 = (self.all_cols.to(torch.int32) if cols32 is None
                       else cols32)

    def slot_J(self, s: int):
        """[n, r, t_s] slice of J for variable slot s."""
        off = sum(c.shape[1] for c in self.cols[:s])
        return self.J[:, :, off:off + self.cols[s].shape[1]]

    def gather_cols(self, v):
        """v[all_cols]: [n, t_total]."""
        return v[self.all_cols]

    def with_J(self, J) -> "BucketJacobian":
        return BucketJacobian(J, self.cols, self.all_cols, self.cols32)


class RVec:
    """Per-bucket residual-space vector (logical length num_rows)."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)            # each [n_k, r_k]

    def squared_norm(self):
        return sum(torch.sum(p * p) for p in self.parts)

    def dot(self, other: "RVec"):
        return sum(torch.sum(a * b) for a, b in zip(self.parts, other.parts))

    def flatten(self):
        """The logical residual vector [num_rows], bucket after bucket."""
        return torch.cat([p.reshape(-1) for p in self.parts])


class BlockJacobian:
    """The whole Jacobian as BucketJacobians, with the SparseMatrix
    interface of the reference (sparse_matrix.h: RightMultiply,
    LeftMultiply, SquaredColumnNorm, ScaleColumns). `col_sum` is the
    program's ColumnSum over all buckets' [n, t_total] contributions."""

    def __init__(self, buckets: Sequence[BucketJacobian], num_cols: int,
                 col_sum: ColumnSum):
        self.buckets = tuple(buckets)
        self.num_cols = int(num_cols)
        self.col_sum = col_sum

    def matvec(self, v) -> RVec:
        """J v: tangent [num_cols] -> residual space."""
        return RVec([torch.einsum("nrt,nt->nr", b.J, b.gather_cols(v))
                     for b in self.buckets])

    def rmatvec(self, w: RVec):
        """J^T w: residual space -> tangent [num_cols]."""
        return self.col_sum([torch.einsum("nrt,nr->nt", b.J, wp)
                             for b, wp in zip(self.buckets, w.parts)])

    def squared_column_norms(self):
        """diag(J^T J) (block_sparse_matrix.h SquaredColumnNorm)."""
        return self.col_sum([torch.sum(b.J * b.J, dim=1)
                             for b in self.buckets])

    def scale_columns(self, scale) -> "BlockJacobian":
        """J <- J diag(scale) (ScaleColumns)."""
        return BlockJacobian(
            [b.with_J(b.J * b.gather_cols(scale)[:, None, :])
             for b in self.buckets],
            self.num_cols, self.col_sum)

    def to_dense(self):
        """[num_rows, num_cols] dense matrix (ToDenseMatrix), rows bucket
        after bucket. A residual block names each parameter block once
        (Problem refuses duplicates), so every (row, column) of a bucket
        is written once."""
        J0 = self.buckets[0].J
        num_rows = sum(b.J.shape[0] * b.J.shape[1] for b in self.buckets)
        A = torch.zeros(num_rows, self.num_cols, dtype=J0.dtype,
                        device=J0.device)
        row = 0
        for b in self.buckets:
            n, r, t = b.J.shape
            rows = (row + torch.arange(n * r, device=A.device)).view(
                n, r, 1).expand(n, r, t)
            A[rows, b.all_cols[:, None, :].expand(n, r, t)] = b.J
            row += n * r
        return A

    def jtj_dense(self):
        """Dense J^T J [num_cols, num_cols] from the rows' Gram blocks
        without forming J (ceres_tpu bsr.py jtj_dense; the reference's
        InnerProductComputer), each entry summed in a fixed order
        (ColumnSum.gram_order): no float atomics, the same bits every
        run."""
        perm, lengths, index = self.col_sum.gram_order()
        flat = torch.cat([torch.einsum("nrt,nru->ntu", b.J, b.J).reshape(-1)
                          for b in self.buckets])
        vals = torch.segment_reduce(flat[perm], "sum", lengths=lengths,
                                    axis=0, unsafe=True)
        n = self.num_cols
        H = torch.zeros(n * n, dtype=flat.dtype, device=flat.device)
        H[index] = vals
        return H.view(n, n)


class GroupMeta:
    """Variable parameter blocks of one tangent size: `tan_start` of
    their contiguous tangent slab, and `bucket_slots`, the (bucket,
    variable slot, [n] local block ids) that touch them, with the fixed
    order of K9's sums over those slots' rows (`gram_order`)."""

    def __init__(self, tangent_size, num_blocks, tan_start):
        self.tangent_size = tangent_size
        self.num_blocks = num_blocks
        self.tan_start = tan_start
        self.bucket_slots: List = []
        self._gram_order = None

    def gram_order(self, device):
        """(gram_map, gram_off), built at the first call: the group's
        contributions (slot view index into bucket_slots, row), int32
        [p, 2], sorted stably by block, so that each block keeps the JAX
        package's (bucket, slot, row) scatter order; block k's are
        gram_map[gram_off[k] : gram_off[k + 1]] (int32 [num_blocks + 1])."""
        if self._gram_order is None:
            blocks = np.concatenate([np.asarray(ids, dtype=np.int64)
                                     for (_, _, ids) in self.bucket_slots])
            views = np.concatenate([np.full(ids.size, v) for v, (_, _, ids)
                                    in enumerate(self.bucket_slots)])
            rows = np.concatenate([np.arange(ids.size)
                                   for (_, _, ids) in self.bucket_slots])
            order = np.argsort(blocks, kind="stable")
            off = np.cumsum(np.bincount(blocks, minlength=self.num_blocks))
            self._gram_order = (
                torch.as_tensor(np.stack([views[order], rows[order]], axis=1)
                                .astype(np.int32), device=device),
                torch.as_tensor(np.concatenate([[0], off]).astype(np.int32),
                                device=device))
        return self._gram_order


def block_diag_jtj(jac: BlockJacobian, groups) -> List[torch.Tensor]:
    """Block diagonal of J^T J per parameter block, one [k, t, t] tensor
    per tangent-size group (block_jacobi_preconditioner.h:55): K9 on the
    group's slot views, read in place, summed in the group's fixed order
    (gram_order); on the card one launch a group (per 8 slot views) forms
    and sums the blocks, on the CPU the per-row Grams of each slot are
    gathered and reduced in that order. An f64 Jacobian (the f64 CGNR
    step) takes group_grams (an einsum a slot and the same ordered
    segment sum) on every device: the JAX package forms these blocks
    with einsums and a scatter, and its Gram kernel (K9) serves the f32
    pass only."""
    out = []
    for g in groups:
        views = [jac.buckets[bi].slot_J(si) for (bi, si, _) in g.bucket_slots]
        order = g.gram_order(views[0].device)
        if views[0].dtype == torch.float32:
            out.append(group_gram_blocks(views, *order))
        else:
            out.append(group_grams(views, *order))
    return out
