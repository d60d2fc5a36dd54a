"""SPARSE_NORMAL_CHOLESKY on the port's native host LDL^T.

Counterpart of ceres_tpu/solvers/sparse_direct.py (the reference's
SparseNormalCholeskySolver: sparse_normal_cholesky_solver.cc,
inner_product_computer.cc, suitesparse.cc). The device forms each
bucket's per-row Gram blocks G_n = J_n^T J_n and the rhs -J^T r; one copy
takes them to the host, where the native library (native.py) scatters
them into a CSC pattern of J^T J analyzed once per program (the
InnerProductComputer role) and runs a simplicial LDL^T refactor and
solve (the CHOLMOD role). A breakdown gives a NaN step, which the
trust-region loop rejects (LinearSolverTerminationType::FAILURE,
linear_solver.h:57).

The Grams and the rhs do not depend on the trust-region radius, so the
generic step forms them, copies them and scatters them once per
linearization (`SparseNormalSystem`); each damped solve copies D^2 to the
host, adds it to the diagonal and refactors. The values are the JAX
package's, added in its order: the buckets' Grams into zeros, bucket
after bucket, then D^2.

The Grams on the card: an f32 Jacobian (use_mixed_precision_solves)
takes K9's per-row form (ops/kernels.py bucket_gram_blocks); an f64 one
an einsum, as the JAX package forms it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..ops.kernels import bucket_gram_blocks, row_grams
from ..types import OrderingType


def bucket_grams(jac, lanes=None) -> List[torch.Tensor]:
    """Each bucket's per-row Grams [n, t, t] of a BlockJacobian, in its
    precision: K9's per-row form for f32 (one launch a bucket on the
    card), row_grams' einsum for f64. `lanes` (one index array a bucket,
    or None) keeps the listed rows only; a bucket with no rows or columns
    gives an empty tensor and launches nothing."""
    out = []
    for bi, b in enumerate(jac.buckets):
        J = b.J
        if lanes is not None:
            J = J[torch.as_tensor(lanes[bi], device=J.device)]
        if J.shape[0] == 0 or J.shape[2] == 0:
            out.append(J.new_zeros((J.shape[0], J.shape[2], J.shape[2])))
        elif J.dtype == torch.float32:
            out.append(bucket_gram_blocks(J))
        else:
            out.append(row_grams(J))
    return out


def to_host(*tensors) -> List[np.ndarray]:
    """The tensors as f64 numpy arrays, flattened, through one copy to the
    host (in a pinned buffer on the card)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
    else:
        host = flat
    arr = host.numpy().astype(np.float64)
    out, off = [], 0
    for t in tensors:
        out.append(arr[off:off + t.numel()])
        off += t.numel()
    return out


class SparseNormalCholeskyContext:
    """Host-side symbolic state: the CSC pattern of J^T J (upper and lower
    entries), each bucket's map from its flattened Grams into the CSC
    values, the diagonal positions and the native factorization."""

    def __init__(self, program,
                 lanes_per_bucket: Optional[List[np.ndarray]] = None,
                 dynamic: bool = False, ordering: Optional[int] = None):
        """lanes_per_bucket: per-bucket arrays of the rows to keep (the
        SUBSET preconditioner's rows, subset_preconditioner.h:70); None
        keeps every row.

        dynamic: re-analyze the pattern at every factorization from the
        numerical nonzeros of its Grams (dynamic_sparsity, the reference's
        DynamicSparseNormalCholeskySolver): entries whose assembled value
        is exactly zero are dropped before a new symbolic analysis.

        ordering: a SparseCholesky ORDER_* constant, or None for AUTO."""
        n = program.num_effective
        self.n = n
        bucket_cols: List[np.ndarray] = []
        for bi, bk in enumerate(program.buckets):
            cols = [sl.cols for sl in bk.slots if sl.variable]
            ac = (np.concatenate(cols, axis=1) if cols
                  else np.zeros((bk.n, 0), dtype=np.int32))
            if lanes_per_bucket is not None:
                ac = ac[lanes_per_bucket[bi]]
            bucket_cols.append(ac)
        self.bucket_cols = bucket_cols

        # the key of every Gram entry, col * n + row: CSC order
        key_parts = []
        for ac in bucket_cols:
            rows = ac[:, :, None].astype(np.int64)
            cols = ac[:, None, :].astype(np.int64)
            key_parts.append((cols * n + rows).reshape(-1))
        # the diagonal is always in the pattern, so that D^2 keeps the
        # factor definite on columns the (subset) rows never touch
        diag = np.arange(n, dtype=np.int64) * (n + 1)
        uniq = np.unique(np.concatenate(key_parts + [diag]))
        self.nnz = uniq.size
        col_of = uniq // n
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, col_of + 1, 1)
        self.Ap = np.cumsum(indptr)
        self.Ai = (uniq % n).astype(np.int32)
        self.maps = [np.searchsorted(uniq, k).astype(np.int64)
                     for k in key_parts]
        self.diag_pos = np.searchsorted(uniq, diag).astype(np.int64)

        self.dynamic = bool(dynamic)
        self._ordering = ordering
        self._col_of = col_of
        self._ok = False
        self.chol = native.SparseCholesky(n, self.Ap, self.Ai,
                                          ordering=ordering)

    def assemble(self, gram_flats) -> np.ndarray:
        """The CSC values of sum_n G_n, each bucket's flattened Grams
        (f64) scattered in order into zeros."""
        values = np.zeros(self.nnz, dtype=np.float64)
        for flat, idx in zip(gram_flats, self.maps):
            native.scatter_add(values, idx, np.asarray(
                flat, dtype=np.float64).reshape(-1))
        return values

    def factor_values(self, values: np.ndarray, D_sq: np.ndarray) -> bool:
        """Add D_sq to the diagonal of a copy of `values` and refactor
        (with a new analysis first when dynamic); True on success."""
        values = values.copy()
        values[self.diag_pos] += np.asarray(D_sq, dtype=np.float64)
        if self.dynamic:
            keep = values != 0.0
            keep[self.diag_pos] = True
            # one AMD pass a factorization: AUTO's two orderings and two
            # symbolic fills would triple the host's work when repeated
            order = (native.SparseCholesky.ORDER_NATURAL
                     if self._ordering == native.SparseCholesky.ORDER_NATURAL
                     else native.SparseCholesky.ORDER_AMD)
            if not keep.all():
                counts = np.zeros(self.n + 1, dtype=np.int64)
                np.add.at(counts, self._col_of[keep] + 1, 1)
                self.chol = native.SparseCholesky(
                    self.n, np.cumsum(counts), self.Ai[keep],
                    ordering=order)
                values = values[keep]
            elif self.chol._Ai.size != self.nnz:
                self.chol = native.SparseCholesky(self.n, self.Ap, self.Ai,
                                                  ordering=order)
        self._ok = self.chol.factor(values) == 0
        return self._ok

    def host_apply(self, b: np.ndarray, out: np.ndarray = None) -> np.ndarray:
        """Backsolve with the last factor; the identity when it broke
        down (the preconditioner's update-failure fallback)."""
        b = np.asarray(b, dtype=np.float64)
        if self._ok:
            return self.chol.solve(b, out)
        if out is None:
            return b
        out[:] = b
        return out


def _native_ordering(options) -> Optional[int]:
    """The native ordering of options.linear_solver_ordering_type
    (ceres_tpu sparse_direct.py _native_ordering): NATURAL the identity;
    AMD and NESDIS both ORDER_AUTO, which evaluates RCM and the
    quotient-graph minimum degree symbolically and keeps the lesser fill
    (there is no METIS backend)."""
    ot = getattr(options, "linear_solver_ordering_type", None)
    if ot == OrderingType.NATURAL:
        return native.SparseCholesky.ORDER_NATURAL
    if ot in (OrderingType.AMD, OrderingType.NESDIS):
        return native.SparseCholesky.ORDER_AUTO
    return None


class SparseNormalSystem(NamedTuple):
    """One linearization's normal equations on the host: the CSC values
    of J^T J and the rhs -J^T r (f64 numpy)."""
    values: np.ndarray
    rhs: np.ndarray


class SparseNormalCholeskySolver:
    """The generic step's SPARSE_NORMAL_CHOLESKY (ceres_tpu
    make_sparse_normal_cholesky_solver, :162): `system(jac_s, res)` once
    per linearization, `solve(system, D)` once per damped solve, which
    returns the f64 step (NaN on a breakdown) on the program's device."""

    def __init__(self, program, options):
        self.device = program.device
        self.ctx = SparseNormalCholeskyContext(
            program, dynamic=bool(options.dynamic_sparsity),
            ordering=_native_ordering(options))

    def system(self, jac, res) -> SparseNormalSystem:
        grams = bucket_grams(jac)
        rhs = -jac.rmatvec(res)
        *flats, rhs_h = to_host(*grams, rhs)
        return SparseNormalSystem(self.ctx.assemble(flats), rhs_h)

    def solve(self, system: SparseNormalSystem, D):
        (d_sq,) = to_host(D * D)
        if self.ctx.factor_values(system.values, d_sq):
            x = self.ctx.host_apply(system.rhs)
        else:
            x = np.full(self.ctx.n, np.nan)
        return torch.from_numpy(x).to(self.device)


class BatchedSparseNormalCholesky:
    """SPARSE_NORMAL_CHOLESKY on the element axis (the JAX package's
    sequential host callback under vmap): `system(jac, res)` forms every
    element's per-row Grams (row_grams, one einsum: the JAX package's
    vmapped route calls no Gram kernel) and
    -J^T r on the device from the stacked Jacobian, copies them to the
    host once and assembles each element's CSC values on the template's
    pattern; `solve(system, D)` copies D^2 once, refactors and solves the
    elements one after another on the template's native LDL^T (NaN for an
    element that breaks down) and copies the steps back once: the f64
    step [B * n]."""

    def __init__(self, ctx: SparseNormalCholeskyContext, B: int):
        self.ctx, self.B = ctx, B

    def system(self, jac, res):
        B = self.B
        grams = [row_grams(b.J) for b in jac.buckets]
        rhs = -jac.rmatvec(res)
        *flats, rhs_h = to_host(*grams, rhs)
        values = [self.ctx.assemble([f.reshape(B, -1)[e] for f in flats])
                  for e in range(B)]
        return SparseNormalSystem(values, rhs_h.reshape(B, -1))

    def solve(self, system: SparseNormalSystem, D):
        (d_sq,) = to_host(D * D)
        d_sq = d_sq.reshape(self.B, -1)
        out = np.full((self.B, self.ctx.n), np.nan)
        for e in range(self.B):
            if self.ctx.factor_values(system.values[e], d_sq[e]):
                out[e] = self.ctx.host_apply(system.rhs[e])
        return torch.from_numpy(out.reshape(-1)).to(D.device)
