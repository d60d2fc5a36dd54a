"""Covariance of the solved parameters.

Counterpart of ceres_tpu/covariance.py (the reference's Covariance,
include/ceres/covariance.h:202, internal/ceres/covariance_impl.cc):
blocks of inverse(J^T J) at the current parameter values, by DENSE_SVD
or SPARSE_QR (types.h:465-468), with the rank-deficiency policy
(min_reciprocal_condition_number, null_space_rank, covariance.h:281-329).

DENSE_SVD takes the SVD of the dense Jacobian; SPARSE_QR up to
SPARSE_QR_DENSE_CAP effective parameters the R factor of its QR. Past
that cap SPARSE_QR computes the requested blocks only: the undamped
normal equations factored once by the native LDL^T of
solvers/sparse_direct.py, one backsolve per requested column, the rank
policy read from the factor's inertia and pivot ratio; on a problem with
Schur structure (the JAX package's branch, ceres_tpu covariance.py
:180-237) the reduced camera matrix S of solvers/schur.py's SchurOps
instead, its Cholesky, and per requested column the reduced rhs, the
solve and the back-substitution, 256 columns a batch. The SVD, the QR,
the Cholesky and the triangular
solves are torch.linalg calls on options.device (cuSOLVER on the card),
as the JAX package computes them with jnp.linalg outside any Pallas
kernel.

Blocks come back in ambient coordinates, J_plus(a) C J_plus(b)^T
(GetCovarianceBlock), or in tangent coordinates
(GetCovarianceBlockInTangentSpace), as numpy arrays.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .program import CompiledProgram
from .solvers.schur import SchurOps, SchurSystem, detect_schur_structure
from .solvers.sparse_direct import (SparseNormalCholeskyContext,
                                    bucket_grams, to_host)
from .types import CovarianceAlgorithmType

# SPARSE_QR takes the dense QR of J up to this many effective parameters
# (ceres_tpu covariance.py:123), the native LDL^T past it
SPARSE_QR_DENSE_CAP = 2000
# unit columns solved together on the Schur branch (ceres_tpu
# covariance.py:222)
COVARIANCE_BATCH = 256


class CovarianceOptions:
    """covariance.h:247-331; `device` (a port extension) is the torch
    device of the factorizations, "cuda" unless asked."""

    def __init__(self,
                 algorithm_type=CovarianceAlgorithmType.DENSE_SVD,
                 min_reciprocal_condition_number: float = 1e-14,
                 null_space_rank: int = 0,
                 apply_loss_function: bool = True,
                 num_threads: int = 1,
                 device: str = "cuda"):
        self.algorithm_type = algorithm_type
        self.min_reciprocal_condition_number = (
            min_reciprocal_condition_number)
        self.null_space_rank = null_space_rank
        self.apply_loss_function = apply_loss_function
        self.num_threads = num_threads
        self.device = device


class Covariance:
    Options = CovarianceOptions

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._tangent_cov = None
        self._block_cov = None
        self._program = None
        self._message = ""

    @property
    def message(self):
        return self._message

    def compute(self, covariance_blocks: List[Tuple], problem) -> bool:
        """covariance_impl.cc:101; covariance_blocks is a list of (block_a,
        block_b) numpy-array pairs. False (with `message`) when the
        Jacobian fails the rank policy."""
        opts = self.options
        prog = CompiledProgram(problem, opts.device,
                               apply_loss=opts.apply_loss_function)
        self._program = prog
        self._block_cov = None
        for a, b in covariance_blocks:
            problem._get(a)
            problem._get(b)
        n = prog.num_effective
        if (opts.algorithm_type == CovarianceAlgorithmType.SPARSE_QR
                and n > SPARSE_QR_DENSE_CAP):
            return self._compute_sparse(covariance_blocks, prog)

        _, _, jac, _ = prog.linearize_fn(prog.initial_state())
        J = jac.to_dense()
        if opts.algorithm_type == CovarianceAlgorithmType.DENSE_SVD:
            # J = U S V^T, inverse(J^T J) = V S^-2 V^T
            # (covariance_impl.cc:704 ComputeDenseSVDCovariance)
            _, s_t, vt = torch.linalg.svd(J, full_matrices=False)
            s = s_t.cpu().numpy()
            max_s = s[0] if s.size else 0.0
            eps = opts.min_reciprocal_condition_number
            if opts.null_space_rank < 0:
                # drop every value failing the ratio test
                # (covariance_impl.cc:739 automatic truncation)
                keep = (s / max_s) ** 2 >= eps
            else:
                # drop the null_space_rank smallest; a kept value failing
                # the ratio test fails Compute (covariance_impl.cc:744-767)
                keep = np.zeros_like(s, dtype=bool)
                keep[:max(len(s) - opts.null_space_rank, 0)] = True
                bad = keep & ((s / max_s) ** 2 < eps)
                if bad.any():
                    rcn = float((s[bad][0] / max_s) ** 2)
                    self._message = (
                        f"Rank deficient Jacobian: reciprocal condition "
                        f"number {rcn:e} < {eps:e}; increase "
                        f"null_space_rank to allow a pseudo-inverse.")
                    return False
            inv_s2 = torch.as_tensor(
                np.where(keep, 1.0 / np.maximum(s, 1e-300) ** 2, 0.0),
                device=J.device)
            V = vt.T
            self._tangent_cov = ((V * inv_s2[None, :]) @ V.T).cpu().numpy()
        else:
            # SPARSE_QR below the cap: the R factor of J
            R = torch.linalg.qr(J, mode="r").R
            diag = np.abs(np.diag(R.cpu().numpy()))
            if diag.min() <= 0 or (diag.min() / diag.max()) < np.sqrt(
                    opts.min_reciprocal_condition_number):
                self._message = ("Rank deficient Jacobian in QR "
                                 "factorization; use DENSE_SVD with "
                                 "null_space_rank.")
                return False
            Rinv = torch.linalg.solve_triangular(
                R, torch.eye(n, dtype=R.dtype, device=R.device), upper=True)
            self._tangent_cov = (Rinv @ Rinv.T).cpu().numpy()
        return True

    def _compute_sparse(self, covariance_blocks, prog) -> bool:
        """The requested blocks only (ceres_tpu covariance.py
        _compute_sparse, :139-285): the undamped J^T J factored once by
        the native LDL^T, then one backsolve per column of the requested
        second blocks; Cov(a, b) is rows a of those columns. A pair with a
        constant block is a zero block, with no solve
        (covariance_impl.cc:139-158). Never forms J or the whole
        covariance."""
        n = prog.num_effective
        opts = self.options
        b_blocks = {}
        var_pairs, zero_pairs = [], []
        for a, b in covariance_blocks:
            oa, ta, _ = self._tangent_slice(a)
            ob, tb, _ = self._tangent_slice(b)
            if oa is None or ob is None:
                zero_pairs.append((a, ta, b, tb))
                continue
            var_pairs.append((a, b))
            b_blocks.setdefault(id(b), (ob, tb))
        self._block_cov = {(id(a), id(b)): np.zeros((ta, tb))
                           for a, ta, b, tb in zero_pairs}
        if not b_blocks:
            return True
        cols = np.concatenate([np.arange(off, off + tb)
                               for off, tb in b_blocks.values()])
        col_of_block, pos = {}, 0
        for key, (_, tb) in b_blocks.items():
            col_of_block[key] = (pos, tb)
            pos += tb

        meta = detect_schur_structure(prog, None)
        X = (self._schur_columns(prog, meta, cols) if meta is not None
             else self._native_columns(prog, cols))
        if X is None:
            return False
        if not np.all(np.isfinite(X)):
            self._message = "Non-finite covariance back-solve."
            return False
        for a, b in var_pairs:
            oa, ta, _ = self._tangent_slice(a)
            p0, tb = col_of_block[id(b)]
            self._block_cov[(id(a), id(b))] = X[p0:p0 + tb, oa:oa + ta].T
        return True

    def _schur_columns(self, prog, meta, cols):
        """Columns `cols` of inverse(J^T J) as rows of an [m, n] array, by
        Schur elimination (ceres_tpu covariance.py:180-237): S of the
        undamped system, its Cholesky (a NaN or a reciprocal condition
        estimate (min / max of its diagonal)^2 below the options' minimum
        fails, with the JAX package's messages), then per batch of 256
        unit columns b: z = (E^T E)^-1 b_e, the reduced rhs b_f - A^T z
        with A = E^T F, y = S^-1 rhs and d_e = (E^T E)^-1 (b_e - A y).
        None on failure."""
        n = prog.num_effective
        _, _, jac, _ = prog.linearize_fn(prog.initial_state())
        system = SchurSystem(meta, jac)
        ops = SchurOps(system, torch.zeros(n, dtype=system.dtype,
                                           device=system.device))
        L, info = torch.linalg.cholesky_ex(ops.explicit_S())
        if int(info) != 0 or bool(torch.isnan(L).any()):
            self._message = ("Rank deficient normal equations in the "
                             "Schur covariance path (gauge freedom?); "
                             "hold a gauge or use DENSE_SVD.")
            return None
        cd = torch.diagonal(L).abs().cpu().numpy()
        rcn = float((cd.min() / cd.max()) ** 2) if cd.size else 0.0
        eps = self.options.min_reciprocal_condition_number
        if rcn < eps:
            self._message = (
                f"Rank deficient normal equations: reciprocal condition "
                f"number estimate {rcn:e} < {eps:e} (Schur covariance "
                f"path). Hold a gauge, or use DENSE_SVD with "
                f"null_space_rank.")
            return None
        _, A = system.ftf_and_a()
        e_cols, f_global = system.plan.e_cols, system.plan.f_global
        X = np.zeros((len(cols), n))
        for s0 in range(0, len(cols), COVARIANCE_BATCH):
            c = torch.as_tensor(cols[s0:s0 + COVARIANCE_BATCH],
                                device=system.device)
            B = c.numel()
            b = torch.zeros((B, n), dtype=system.dtype, device=system.device)
            b[torch.arange(B, device=system.device), c] = 1.0
            b_e, b_f = b[:, e_cols], b[:, f_global]
            z = torch.einsum("nij,bnj->bni", ops.inv_ete, b_e)
            rhs = b_f - torch.einsum("itf,bit->bf", A, z)
            y = torch.cholesky_solve(rhs.T, L).T
            d_e = torch.einsum("nij,bnj->bni", ops.inv_ete,
                               b_e - torch.einsum("itf,bf->bit", A, y))
            out = torch.zeros_like(b)
            out[:, f_global] = y
            out[:, e_cols.reshape(-1)] = d_e.reshape(B, -1)
            X[s0:s0 + B] = out.cpu().numpy()
        return X

    def _native_columns(self, prog, cols):
        """Columns `cols` of inverse(J^T J) as rows of an [m, n] array, by
        the native LDL^T of the undamped normal equations; None on
        failure."""
        n = prog.num_effective
        opts = self.options
        ctx = SparseNormalCholeskyContext(prog)
        _, _, jac, _ = prog.linearize_fn(prog.initial_state())
        grams = to_host(*bucket_grams(jac))
        if not ctx.factor_values(ctx.assemble(grams), np.zeros(n)):
            self._message = ("Rank deficient normal equations in the "
                             "sparse covariance path.")
            return None
        # the rank policy from the LDL^T inertia (covariance.h:281-329):
        # J^T J is positive semidefinite, so a negative pivot or a tiny
        # pivot ratio is numerical rank deficiency
        dmin, dmax, nneg = ctx.chol.diag_stats()
        rcn = dmin / dmax if dmax > 0 else 0.0
        if nneg > 0 or rcn < opts.min_reciprocal_condition_number:
            self._message = (
                f"Rank deficient normal equations: LDL^T inertia ({nneg} "
                f"negative pivots), reciprocal condition number estimate "
                f"{rcn:e} < {opts.min_reciprocal_condition_number:e}. Use "
                f"DENSE_SVD with null_space_rank.")
            return None
        X = np.zeros((len(cols), n))
        e = np.zeros(n)
        for i, col in enumerate(cols):
            e[col] = 1.0
            ctx.host_apply(e, out=X[i])
            e[col] = 0.0
        return X

    def _tangent_slice(self, values):
        """(tangent offset, tangent size, block); the offset is None for a
        constant block, whose covariance is zero
        (covariance_impl.cc:139-158)."""
        prog = self._program
        key = id(values)
        if key not in prog.problem._blocks:
            raise KeyError("parameter block is not in the problem")
        blk = prog.problem._blocks[key]
        # the tangent size as if variable: a constant block's zero
        # covariance keeps its full shape
        tsz = blk.manifold.tangent_size if blk.manifold else blk.size
        if key not in prog.tan_offset:
            return None, tsz, blk
        return prog.tan_offset[key], tsz, blk

    def get_covariance_block_in_tangent_space(self, a, b) -> np.ndarray:
        """covariance.h GetCovarianceBlockInTangentSpace."""
        if self._block_cov is not None:
            C = self._block_cov.get((id(a), id(b)))
            if C is None:
                Ct = self._block_cov.get((id(b), id(a)))
                if Ct is None:
                    raise KeyError(
                        "block pair was not requested in compute() (the "
                        "sparse covariance computes the requested pairs "
                        "only, covariance.h GetCovarianceBlock contract)")
                C = Ct.T
            return C
        oa, ta, _ = self._tangent_slice(a)
        ob, tb, _ = self._tangent_slice(b)
        if oa is None or ob is None:
            return np.zeros((ta, tb))
        return self._tangent_cov[oa:oa + ta, ob:ob + tb]

    def get_covariance_matrix_in_tangent_space(self, blocks) -> np.ndarray:
        """The covariance of `blocks` as one dense tangent-space matrix
        (covariance.h:458); on the sparse path every pair of `blocks` must
        have been requested."""
        sizes = [self._tangent_slice(b)[1] for b in blocks]
        return self._assemble(blocks, sizes,
                              self.get_covariance_block_in_tangent_space)

    def get_covariance_matrix(self, blocks) -> np.ndarray:
        """The covariance of `blocks` as one dense ambient-space matrix
        (covariance.h:441)."""
        sizes = [self._tangent_slice(b)[2].size for b in blocks]
        return self._assemble(blocks, sizes, self.get_covariance_block)

    @staticmethod
    def _assemble(blocks, sizes, block_fn):
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        out = np.zeros((offs[-1], offs[-1]))
        for i, a in enumerate(blocks):
            for j, b in enumerate(blocks):
                out[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = block_fn(a, b)
        return out

    def get_covariance_block(self, a, b) -> np.ndarray:
        """The ambient-space block J_plus(a) C J_plus(b)^T
        (covariance.h GetCovarianceBlock)."""
        _, ta, blk_a = self._tangent_slice(a)
        _, tb, blk_b = self._tangent_slice(b)
        C = self.get_covariance_block_in_tangent_space(a, b)

        def plus_jacobian(blk, values, t):
            if blk.manifold is None:
                return np.eye(t)
            return blk.manifold.plus_jacobian(
                torch.as_tensor(np.asarray(values, dtype=np.float64))
            ).numpy()

        return plus_jacobian(blk_a, a, ta) @ C @ plus_jacobian(blk_b, b, tb).T
