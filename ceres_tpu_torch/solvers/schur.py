"""Schur-complement solvers: DENSE_SCHUR, SPARSE_SCHUR, ITERATIVE_SCHUR.

Counterpart of ceres_tpu/solvers/schur.py: the structure of a program
(detect_schur_structure, :176; the chunk layout chunk_rows/chunk_mask,
:319-343; f_groups; bk_slot_keys), numpy, computed once per program;
and the runtime Schur operations over one linearization's Jacobian
(SchurOps, :407-940; make_schur_solver, :953-1107, here the
`SchurLinearSolver` of the generic steps):

  esolve, F/Ft/E/Et_apply, the matrix-free apply_S
    (implicit_schur_complement.h:52-91), rhs, back_substitute, the
    explicit S (schur_complement_solver.cc) and its rhs;
  the preconditioners IDENTITY, JACOBI (block diagonal of F^T F + D_f^2),
    SCHUR_JACOBI (block diagonal of S), SCHUR_POWER_SERIES_EXPANSION
    (a truncated Neumann series around SCHUR_JACOBI) and CLUSTER_JACOBI /
    CLUSTER_TRIDIAGONAL (S on the camera clusters' pattern of
    solvers/clustering.py, factored densely; cluster_masks);
  DENSE_SCHUR and SPARSE_SCHUR up to solvers/schur_sparse.py's
    SPARSE_SCHUR_DENSE_NF: the explicit S and a dense Cholesky in the
    solve's precision; past it SPARSE_SCHUR factors the block-sparse S
    on the native host LDL^T (schur_sparse.py); ITERATIVE_SCHUR: CG
    (solvers/cg.py) on the explicit S (use_explicit_schur_complement, or
    nf <= 2048 and ne te nf <= 1e8) or on apply_S, optionally from the
    SPSE warm start; mixed precision casts J, D and b to f32.

The JAX package multiplies by [n, kf] one-hots over its chunk layout
(the TPU's scatter-free form); the port computes the same outputs in
observation order: every sum of many rows into one point, camera or
matrix entry (E^T E, E^T w, F^T w, F^T F, A = E^T F, the preconditioner
blocks) is a fixed-order segment sum (ops/bsr.py ColumnSum): the
contributions sorted stably by their target in (bucket, row) order, then
torch.segment_reduce, in order on the CPU and by CUB's segmented reduce
on the card. No float atomics, so a run gives the same bits every time.
No hand kernel runs here: the JAX package's generic Schur route runs
none either (jsl.cho_factor, a lax CG and einsums).
"""

from __future__ import annotations

import copy
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from ..ops.bsr import (BlockJacobian, ColumnSum, RVec, column_sum_for,
                       sorted_segments)
from ..ops.kernels import row_grams
from ..types import LinearSolverType, PreconditionerType
from .cg import conjugate_gradients, conjugate_gradients_batched
from .clustering import cluster_membership
from .dense import cholesky_solve
from .preconditioners import spd_inv_small


class _BucketSchur:
    __slots__ = ("e_slot", "e_ids", "f_cols", "f_slots",
                 "chunk_rows", "chunk_mask")


class SchurMeta:
    """Static E/F partition of the bucketed Jacobian."""

    def __init__(self):
        self.e_keys = set()
        self.ne = 0
        self.te = 0
        self.nf = 0
        self.f_global_cols = None    # np [nf] int32
        self.e_cols = None           # np [ne, te] int32
        self.buckets: List[_BucketSchur] = []
        self.f_groups = []           # [{t, kf, cols [kf, t], slots}]
        self._plans = {}             # device -> _Plan
        self._sparse_ctx = None      # (ordering, SparseSchurContext)
        # a stacked meta (stack_meta): B elements as one block-diagonal
        # structure, and each element's ne, nf and tangent size
        self.elements = None
        self.ne_el = self.nf_el = self.n_el = None

    def plan(self, device) -> "_Plan":
        """The meta's index tensors and fixed-order sums on `device`
        (built at the first call)."""
        key = str(torch.device(device))
        if key not in self._plans:
            self._plans[key] = _Plan(self, torch.device(device))
        return self._plans[key]


def _ordering_cache_key(options):
    """Content key of a user elimination ordering."""
    o = getattr(options, "linear_solver_ordering", None)
    if o is None:
        return None
    return tuple(sorted((g, tuple(sorted(d.keys())))
                        for g, d in o._groups.items()))


def detect_schur_structure(program, options) -> Optional[SchurMeta]:
    """Partition variable blocks into e-blocks (eliminated, group 0) and
    f-blocks. None when no usable structure exists. Cached on the program
    per elimination ordering."""
    okey = _ordering_cache_key(options)
    cache = program.__dict__.setdefault("_schur_meta", {})
    if okey not in cache:
        cache[okey] = _detect_schur_structure(program, options)
    return cache[okey]


def _detect_schur_structure(program, options):
    from ..ordering import compute_schur_ordering

    problem = program.problem
    var_keys = {id(b.array) for b in program.variable_blocks}

    ordering = getattr(options, "linear_solver_ordering", None)
    if ordering is not None and ordering.num_groups > 1:
        g0 = ordering.min_non_zero_group()
        e_set = {k for k in ordering.group_element_keys(g0)
                 if k in var_keys}
        # Validity: no residual block may touch two e-blocks
        # (schur_eliminator.h structure requirement).
        for rb in problem._residual_records():
            if sum(1 for k in rb.param_keys if k in e_set) > 1:
                return None
    else:
        e_set = set(compute_schur_ordering(program))

    if not e_set:
        return None

    block_of = {id(b.array): b for b in program.variable_blocks}

    # Uniform e tangent size: keep the dominant size (detect_structure.cc
    # collapses ragged sizes to Eigen::Dynamic; here ragged e-sizes would
    # break batching, so minority sizes move to the f side).
    sizes = Counter(block_of[k].tangent_size for k in e_set)
    te = sizes.most_common(1)[0][0]
    e_set = {k for k in e_set if block_of[k].tangent_size == te}

    # Per-bucket slot purity: every (bucket, slot) must be all-e or
    # all-f; AND a bucket may not have two pure-e slots (two e-blocks per
    # residual, schur_eliminator.h). A demotion under either rule can
    # break the other in a different bucket, so BOTH run inside one
    # fixpoint — a post-hoc demotion pass would leave mixed slots behind.
    changed = True
    while changed and e_set:
        changed = False
        for bk in program.buckets:
            for si, sl in enumerate(bk.slots):
                if not sl.variable:
                    continue
                # recover the block keys of this slot across bucket rows
                flags = [rb_key in e_set
                         for rb_key in bk_slot_keys(program, bk, si)]
                if any(flags) and not all(flags):
                    for rb_key, f in zip(bk_slot_keys(program, bk, si),
                                         flags):
                        if f:
                            e_set.discard(rb_key)
                    changed = True
        for bk in program.buckets:
            e_slots = []
            for si, sl in enumerate(bk.slots):
                if sl.variable:
                    keys = bk_slot_keys(program, bk, si)
                    if keys and keys[0] in e_set:
                        e_slots.append(si)
            if len(e_slots) > 1:
                # demote all but the first e slot
                for si in e_slots[1:]:
                    for k in bk_slot_keys(program, bk, si):
                        if k in e_set:
                            e_set.discard(k)
                            changed = True
    if not e_set:
        return None

    meta = SchurMeta()
    meta.e_keys = e_set
    meta.te = te

    # e-block local indexing
    e_list = [k for k in (id(b.array) for b in program.variable_blocks)
              if k in e_set]
    e_index = {k: i for i, k in enumerate(e_list)}
    meta.ne = len(e_list)
    e_offs = np.fromiter((program.tan_offset[k] for k in e_list),
                         dtype=np.int32, count=meta.ne)
    meta.e_cols = e_offs[:, None] + np.arange(te, dtype=np.int32)[None, :]

    # f columns: every tangent column not in an e-block
    is_e = np.zeros(program.num_effective, dtype=bool)
    is_e[meta.e_cols.reshape(-1)] = True
    f_global = np.nonzero(~is_e)[0].astype(np.int32)
    meta.nf = int(f_global.size)
    if meta.nf == 0:
        return None
    meta.f_global_cols = f_global
    g2f = -np.ones(program.num_effective, dtype=np.int32)
    g2f[f_global] = np.arange(meta.nf, dtype=np.int32)

    # per-bucket partition, indexed over VARIABLE slots (jac.cols order)
    for bk in program.buckets:
        bs = _BucketSchur()
        bs.e_slot = None
        bs.e_ids = None
        bs.f_slots = []
        f_col_parts = []
        var_si = -1
        for si, sl in enumerate(bk.slots):
            if not sl.variable:
                continue
            var_si += 1
            keys = bk_slot_keys(program, bk, si)
            if keys and keys[0] in e_set:
                bs.e_slot = var_si
                bs.e_ids = np.asarray([e_index[k] for k in keys],
                                      dtype=np.int32)
            else:
                bs.f_slots.append(var_si)
                f_col_parts.append(g2f[sl.cols])
        bs.f_cols = (np.concatenate(f_col_parts, axis=1)
                     if f_col_parts else None)
        # Chunk grouping: rows of this bucket sorted into per-e-block
        # chunks, padded to the max chunk size (the reference's
        # schur_eliminator chunk layout, schur_eliminator_impl.h:195): one
        # kernel thread owns one e-block and loops over its lanes.
        bs.chunk_rows = None
        bs.chunk_mask = None
        if bs.e_slot is not None:
            e_ids = bs.e_ids
            n = e_ids.shape[0]
            order = np.argsort(e_ids, kind="stable")
            counts = np.bincount(e_ids, minlength=meta.ne)
            kmax = max(1, int(counts.max()))
            # Guard against pathological padding: one landmark seen by
            # thousands of cameras would inflate every [ne, kmax, ...]
            # chunk tensor by kmax/mean(k); fall back to the
            # observation-order path when padding exceeds ~4x.
            if meta.ne * kmax > 4 * n + 1024:
                bs.chunk_rows = None
                bs.chunk_mask = None
            else:
                starts = np.zeros(meta.ne, dtype=np.int64)
                starts[1:] = np.cumsum(counts)[:-1]
                sorted_e = e_ids[order]
                rank = np.arange(n, dtype=np.int64) - starts[sorted_e]
                chunk_rows = np.zeros((meta.ne, kmax), dtype=np.int32)
                chunk_mask = np.zeros((meta.ne, kmax), dtype=np.float32)
                chunk_rows[sorted_e, rank] = order.astype(np.int32)
                chunk_mask[sorted_e, rank] = 1.0
                bs.chunk_rows = chunk_rows
                bs.chunk_mask = chunk_mask
        meta.buckets.append(bs)

    # f-block groups (for SCHUR_JACOBI / JACOBI preconditioners)
    f_blocks = [b for b in program.variable_blocks
                if id(b.array) not in e_set]
    size_groups = {}
    for b in f_blocks:
        size_groups.setdefault(b.tangent_size, []).append(b)
    f_block_index = {}
    meta.f_groups = []
    for gi, (t, blks) in enumerate(sorted(size_groups.items())):
        cols = np.zeros((len(blks), t), dtype=np.int32)
        for li, b in enumerate(blks):
            to = program.tan_offset[id(b.array)]
            cols[li] = g2f[np.arange(to, to + t)]
            f_block_index[id(b.array)] = (gi, li)
        meta.f_groups.append({"t": t, "kf": len(blks), "cols": cols,
                              "slots": []})
    for bi, bk in enumerate(program.buckets):
        var_si = -1
        for si, sl in enumerate(bk.slots):
            if not sl.variable:
                continue
            var_si += 1
            keys = bk_slot_keys(program, bk, si)
            if keys and keys[0] in e_set:
                continue
            gi, _ = f_block_index[keys[0]]
            local = np.asarray([f_block_index[k][1] for k in keys],
                               dtype=np.int32)
            meta.f_groups[gi]["slots"].append((bi, var_si, local))
    return meta


def bk_slot_keys(program, bk, si):
    """Block keys (id(array)) at slot si for every row of bucket bk."""
    cache = getattr(bk, "_slot_keys", None)
    if cache is None:
        cache = {}
        bk._slot_keys = cache
    if si not in cache:
        residuals = program.problem._residual_records()
        by_index = {rb.index: rb for rb in residuals}
        cache[si] = [by_index[int(i)].param_keys[si]
                     for i in bk.orig_indices]
    return cache[si]


def stack_meta(meta: SchurMeta, B: int, n_eff: int,
               bucket_n) -> SchurMeta:
    """The SchurMeta of B elements of `meta`'s structure as one
    block-diagonal structure (batch.py ElementStack's layout: bucket rows
    element after element, element b's tangent column c at b n_eff + c):
    element b's point k is point b ne + k, its f column j is b nf + j, its
    camera k of an f group is b kf + k. Every single-solve sum over the
    stack is then the elements' sums side by side; `elements` marks the
    meta, so that SchurOps forms the explicit S as [B, nf, nf] and
    SchurLinearSolver runs the batched CG."""
    out = SchurMeta()
    out.elements, out.ne_el, out.nf_el, out.n_el = B, meta.ne, meta.nf, n_eff
    b = np.arange(B, dtype=np.int64)
    out.ne, out.te, out.nf = B * meta.ne, meta.te, B * meta.nf

    def shift(a, step):
        a = np.asarray(a, np.int64)
        return (a[None] + step * b.reshape((B,) + (1,) * a.ndim)).reshape(
            (B * a.shape[0],) + a.shape[1:])

    out.e_cols = shift(meta.e_cols, n_eff)
    out.f_global_cols = shift(meta.f_global_cols, n_eff)
    for bs, n in zip(meta.buckets, bucket_n):
        q = _BucketSchur()
        q.e_slot, q.f_slots = bs.e_slot, bs.f_slots
        q.e_ids = None if bs.e_ids is None else shift(bs.e_ids, meta.ne)
        q.f_cols = None if bs.f_cols is None else shift(bs.f_cols, meta.nf)
        q.chunk_rows = (None if bs.chunk_rows is None
                        else shift(bs.chunk_rows, n))
        q.chunk_mask = (None if bs.chunk_mask is None
                        else np.tile(bs.chunk_mask, (B, 1)))
        out.buckets.append(q)
    for g in meta.f_groups:
        out.f_groups.append({
            "t": g["t"], "kf": B * g["kf"], "cols": shift(g["cols"], meta.nf),
            "slots": [(bi, si, shift(local, g["kf"]))
                      for (bi, si, local) in g["slots"]]})
    return out


# ----------------------------------------------------------------------
# runtime Schur operations


def _row_sum(buckets, ids, num_out, device) -> ColumnSum:
    """Fixed-order sum of per-row units of `buckets` (concatenated in
    bucket order) into num_out targets; ids(bi) gives each row's target."""
    positions, columns, base = [], [], 0
    for bi in buckets:
        t = np.asarray(ids(bi), dtype=np.int64)
        positions.append(base + np.arange(t.size))
        columns.append(t)
        base += t.size
    if not positions:
        positions, columns = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    return ColumnSum(np.concatenate(positions), np.concatenate(columns),
                     num_out, device)


class _Plan:
    """A SchurMeta's index tensors on one device and its fixed-order sums:
    over the rows of the buckets with an e slot (e_sum: E^T E, E^T w),
    of those with both an e and an f slot (ef_sum), and the f columns of
    the buckets with f slots (ft_sum: F^T w); the dense F^T F and A =
    E^T F orders and the preconditioners' block sums, at first use."""

    def __init__(self, meta, device):
        self.meta, self.device = meta, device
        bks = meta.buckets
        self.e_buckets = [bi for bi, bs in enumerate(bks)
                          if bs.e_slot is not None]
        self.f_buckets = [bi for bi, bs in enumerate(bks)
                          if bs.f_cols is not None]
        self.ef_buckets = [bi for bi in self.e_buckets
                           if bks[bi].f_cols is not None]
        self.e_ids = {bi: torch.as_tensor(bks[bi].e_ids.astype(np.int64),
                                          device=device)
                      for bi in self.e_buckets}
        self.f_cols = {bi: torch.as_tensor(bks[bi].f_cols.astype(np.int64),
                                           device=device)
                       for bi in self.f_buckets}
        self.e_cols = torch.as_tensor(meta.e_cols.astype(np.int64),
                                      device=device)
        self.f_global = torch.as_tensor(
            meta.f_global_cols.astype(np.int64), device=device)
        self.e_sum = _row_sum(self.e_buckets, lambda bi: bks[bi].e_ids,
                              meta.ne, device)
        self.ef_sum = (self.e_sum if self.ef_buckets == self.e_buckets
                       else _row_sum(self.ef_buckets,
                                     lambda bi: bks[bi].e_ids, meta.ne,
                                     device))
        self.ft_sum = column_sum_for([[bks[bi].f_cols]
                                      for bi in self.f_buckets],
                                     meta.nf, device)
        self.group_cols = [torch.as_tensor(g["cols"].astype(np.int64),
                                           device=device)
                           for g in meta.f_groups]
        self._a_order = self._ftf_order = None
        self._block_sums = {}

    def ftf_order(self):
        """(perm, lengths, index) of the dense F^T F over the f buckets'
        per-row Grams [n, tf, tf] (ColumnSum.gram_order's order): entry
        (i, j) of element b at b nf^2 + i nf + j, a stacked meta's F^T F
        being [B, nf, nf] (one element: [nf, nf])."""
        if self._ftf_order is None:
            nf = self.meta.nf_el or self.meta.nf
            targets = []
            for bi in self.f_buckets:
                c = self.meta.buckets[bi].f_cols.astype(np.int64)
                e, loc = c // nf, c % nf
                targets.append((e[:, :, None] * nf * nf + loc[:, :, None]
                                * nf + loc[:, None, :]).reshape(-1))
            self._ftf_order = sorted_segments(targets, self.device)
        return self._ftf_order

    def a_order(self):
        """(perm, lengths, index) of the dense A = E^T F [ne, te, nf]: each
        row's cross Gram [te, tf] entry (i, j) to e_id te nf + i nf +
        f_col j, sorted stably; rows in (bucket, row) order."""
        if self._a_order is None:
            meta, te, nf = self.meta, self.meta.te, self.meta.nf
            if meta.elements is not None:    # [B ne, te, nf_el]
                nf = meta.nf_el
            targets = []
            for bi in self.ef_buckets:
                bs = meta.buckets[bi]
                e = bs.e_ids.astype(np.int64)[:, None, None]
                f = bs.f_cols.astype(np.int64)[:, None, :] % nf
                i = np.arange(te, dtype=np.int64)[None, :, None]
                targets.append((e * te * nf + i * nf + f).reshape(-1))
            self._a_order = sorted_segments(targets, self.device)
        return self._a_order

    def block_sum(self, gi) -> ColumnSum:
        """The fixed-order sum of f group gi's per-row diagonal blocks
        over its slots (bucket, variable slot, local ids) into [kf, t, t]."""
        if gi not in self._block_sums:
            grp = self.meta.f_groups[gi]
            locals_ = [local for (_, _, local) in grp["slots"]]
            self._block_sums[gi] = _row_sum(
                range(len(locals_)), lambda k: locals_[k], grp["kf"],
                self.device)
        return self._block_sums[gi]


def _f_part(bj, bs):
    """Concatenated F-slot sub-Jacobian [n, r, tf_bucket]."""
    parts = [bj.slot_J(s) for s in bs.f_slots]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


class SchurSystem:
    """The radius-free part of one linearization's Schur solves: the
    buckets' e and f sub-Jacobians, E^T E without damping, and at first
    use the dense F^T F and A = E^T F, the JACOBI blocks and the sparse
    path's lane tensors (all independent of D)."""

    def __init__(self, meta, jac, out_dtype=None):
        """out_dtype: the precision of the steps solved from it (the
        Jacobian's before a mixed cast; its own by default)."""
        self.meta, self.jac = meta, jac
        J0 = jac.buckets[0].J
        self.dtype, self.device = J0.dtype, J0.device
        self.out_dtype = out_dtype or self.dtype
        self.plan = meta.plan(self.device)
        self.Je = {bi: jac.buckets[bi].slot_J(meta.buckets[bi].e_slot)
                   for bi in self.plan.e_buckets}
        self.Jf = {bi: _f_part(jac.buckets[bi], meta.buckets[bi])
                   for bi in self.plan.f_buckets}
        self.ete = self._e_sum(
            self.plan.e_sum,
            [row_grams(self.Je[bi]) for bi in self.plan.e_buckets],
            (meta.te, meta.te))
        self.cache = {}

    def _e_sum(self, col_sum, parts, unit):
        if not parts:
            return torch.zeros((self.meta.ne,) + unit, dtype=self.dtype,
                               device=self.device)
        return col_sum.sum_flat(torch.cat([p.reshape((-1,) + unit)
                                           for p in parts]))

    def ftf_and_a(self):
        """(F^T F [nf, nf], A [ne, te, nf]) without damping, each entry a
        fixed-order sum of the rows' Grams."""
        if "ftf_a" not in self.cache:
            meta, plan = self.meta, self.plan
            nf, te = meta.nf, meta.te
            shape = (nf, nf)
            if meta.elements is not None:    # [B, nf, nf], [B ne, te, nf]
                nf = meta.nf_el
                shape = (meta.elements, nf, nf)
            FtF = torch.zeros(int(np.prod(shape)), dtype=self.dtype,
                              device=self.device)
            if plan.f_buckets:
                perm, lengths, index = plan.ftf_order()
                flat = torch.cat([row_grams(self.Jf[bi]).reshape(-1)
                                  for bi in plan.f_buckets])
                FtF[index] = torch.segment_reduce(
                    flat[perm], "sum", lengths=lengths, axis=0, unsafe=True)
            A = torch.zeros(meta.ne * te * nf, dtype=self.dtype,
                            device=self.device)
            if plan.ef_buckets:
                perm, lengths, index = plan.a_order()
                flat = torch.cat([torch.einsum("nrt,nru->ntu", self.Je[bi],
                                               self.Jf[bi]).reshape(-1)
                                  for bi in plan.ef_buckets])
                A[index] = torch.segment_reduce(
                    flat[perm], "sum", lengths=lengths, axis=0, unsafe=True)
            self.cache["ftf_a"] = (FtF.view(shape), A.view(meta.ne, te, nf))
        return self.cache["ftf_a"]


class SchurOps:
    """The Schur operations of one damped system (ceres_tpu SchurOps):
    a SchurSystem and the damping D [num_effective], with (E^T E +
    D_e^2)^-1 formed once (NaN blocks where it is not positive
    definite, so that the step is invalid, as the JAX package's
    Cholesky gives)."""

    def __init__(self, system: SchurSystem, D):
        self.system = system
        self.meta, self.jac, self.plan = system.meta, system.jac, system.plan
        meta = self.meta
        d_e = D[self.plan.e_cols]                           # [ne, te]
        self.inv_ete = spd_inv_small(system.ete + torch.diag_embed(d_e * d_e))
        self.D_f = D[self.plan.f_global]
        self.dtype, self.device = system.dtype, system.device
        self._ne, self._te, self._nf = meta.ne, meta.te, meta.nf
        self._S = None

    def esolve(self, u):
        return torch.einsum("nij,nj->ni", self.inv_ete, u)

    def _zeros_rvec(self, bi):
        bj = self.jac.buckets[bi]
        return bj.J.new_zeros((bj.J.shape[0], bj.J.shape[1]))

    def F_apply(self, v) -> RVec:
        """F v: [nf] -> residual space."""
        return RVec([torch.einsum("nrt,nt->nr", self.system.Jf[bi],
                                  v[self.plan.f_cols[bi]])
                     if bi in self.system.Jf else self._zeros_rvec(bi)
                     for bi in range(len(self.jac.buckets))])

    def E_apply(self, z) -> RVec:
        """E z: [ne, te] -> residual space."""
        return RVec([torch.einsum("nrt,nt->nr", self.system.Je[bi],
                                  z[self.plan.e_ids[bi]])
                     if bi in self.system.Je else self._zeros_rvec(bi)
                     for bi in range(len(self.jac.buckets))])

    def _et(self, col_sum, buckets, parts):
        """E^T of per-bucket residual-space parts over `buckets`."""
        return self.system._e_sum(
            col_sum, [torch.einsum("nrt,nr->nt", self.system.Je[bi], parts[bi])
                      for bi in buckets], (self._te,))

    def Et_apply(self, w: RVec):
        """E^T w: residual space -> [ne, te]."""
        return self._et(self.plan.e_sum, self.plan.e_buckets, w.parts)

    def _ft(self, parts):
        """F^T of per-bucket parts over the f buckets: [nf]."""
        if not self.plan.f_buckets:
            return torch.zeros(self._nf, dtype=self.dtype, device=self.device)
        return self.plan.ft_sum([torch.einsum("nrt,nr->nt",
                                              self.system.Jf[bi], parts[bi])
                                 for bi in self.plan.f_buckets])

    def Ft_apply(self, w: RVec):
        """F^T w: residual space -> [nf]."""
        return self._ft(w.parts)

    def _Fv(self, v):
        return {bi: torch.einsum("nrt,nt->nr", self.system.Jf[bi],
                                 v[self.plan.f_cols[bi]])
                for bi in self.plan.f_buckets}

    def _Ez(self, z, buckets):
        return {bi: torch.einsum("nrt,nt->nr", self.system.Je[bi],
                                 z[self.plan.e_ids[bi]]) for bi in buckets}

    def apply_S(self, v):
        """S v = F^T F v + D_f^2 v - F^T E (E^T E + D_e^2)^-1 E^T F v
        (implicit_schur_complement.h:52-91), matrix-free."""
        plan = self.plan
        w = self._Fv(v)
        z = self.esolve(self._et(plan.ef_sum, plan.ef_buckets, w))
        Ez = self._Ez(z, plan.ef_buckets)
        for bi, ez in Ez.items():
            w[bi] = w[bi] - ez
        return self._ft(w) + (self.D_f * self.D_f) * v

    def rhs(self, b_e, b_f):
        """Reduced rhs: b_f - F^T E (E^T E + D_e^2)^-1 b_e."""
        Ez = self._Ez(self.esolve(b_e), self.plan.ef_buckets)
        return b_f - self._ft({bi: Ez[bi] if bi in Ez else
                               self._zeros_rvec(bi)
                               for bi in self.plan.f_buckets})

    def back_substitute(self, b_e, y):
        """d_e = (E^T E + D_e^2)^-1 (b_e - E^T F y)
        (implicit_schur_complement.cc:208)."""
        w = self._Fv(y)
        u = self._et(self.plan.ef_sum, self.plan.ef_buckets, w)
        return self.esolve(b_e - u)

    # ---- explicit S (DENSE_SCHUR / SPARSE_SCHUR, schur_complement_solver.cc)

    def _assemble_S(self):
        """S = F^T F + D_f^2 - A^T (E^T E + D_e^2)^-1 A, with A = E^T F
        [ne, te, nf]; the correction one [nf, ne te] x [ne te, nf]
        product."""
        FtF, A = self.system.ftf_and_a()
        Y = torch.einsum("nuv,nvf->nuf", self.inv_ete, A)
        B = self.meta.elements
        if B is not None:                   # a stacked meta: [B, nf, nf]
            nf = self.meta.nf_el
            S_corr = torch.bmm(A.reshape(B, -1, nf).transpose(1, 2),
                               Y.reshape(B, -1, nf))
            D_f = self.D_f.view(B, nf)
            return FtF + torch.diag_embed(D_f * D_f) - S_corr, A
        nf = self._nf
        S_corr = A.reshape(-1, nf).T @ Y.reshape(-1, nf)
        return FtF + torch.diag(self.D_f * self.D_f) - S_corr, A

    def explicit_S(self):
        """The dense reduced camera matrix S [nf, nf], formed once per
        damped system (the CLUSTER preconditioners and the explicit CG
        share it)."""
        if self._S is None:
            self._S = self._assemble_S()[0]
        return self._S

    def explicit_S_and_rhs(self, b_e, b_f):
        S, A = self._assemble_S()
        B = self.meta.elements
        if B is not None:
            ne, nf = self.meta.ne_el, self.meta.nf_el
            return S, b_f.view(B, nf) - torch.einsum(
                "bitf,bit->bf", A.view(B, ne, self._te, nf),
                self.esolve(b_e).view(B, ne, self._te))
        return S, b_f - torch.einsum("itf,it->f", A, self.esolve(b_e))

    # ---- preconditioners

    def make_preconditioner(self, kind: PreconditionerType, masks=None):
        """apply(v) = M^-1 v for the ITERATIVE_SCHUR preconditioner;
        `masks` (cluster_masks) for the CLUSTER kinds."""
        if kind == PreconditionerType.IDENTITY:
            return None
        if kind == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION:
            return self._make_power_series_preconditioner()
        if kind in (PreconditionerType.CLUSTER_JACOBI,
                    PreconditionerType.CLUSTER_TRIDIAGONAL):
            return self._make_cluster_preconditioner(*masks)
        if kind not in (PreconditionerType.JACOBI,
                        PreconditionerType.SCHUR_JACOBI):
            raise ValueError(f"{kind} is not an ITERATIVE_SCHUR "
                             "preconditioner")
        return self._make_block_diag_preconditioner(
            kind == PreconditionerType.SCHUR_JACOBI)

    def block_diag_S(self, subtract_cross: bool):
        """[(cols [kf, t], blocks [kf, t, t])] per f group: the diagonal
        blocks of S (subtract_cross) or of F^T F (JACOBI), + D_f^2. Each
        row's terms are its own (schur_jacobi semantics: cross terms
        within one (point, camera) pair, per row); the rows of a block
        are summed in (slot, row) order."""
        meta, plan, sys_ = self.meta, self.plan, self.system
        key = "jacobi_blocks"
        out = []
        for gi, grp in enumerate(meta.f_groups):
            if subtract_cross or key not in sys_.cache:
                parts = []
                for (bi, var_si, _) in grp["slots"]:
                    Jf = self.jac.buckets[bi].slot_J(var_si)
                    G = row_grams(Jf)
                    if subtract_cross and bi in sys_.Je:
                        Gc = torch.einsum("nrt,nru->ntu", sys_.Je[bi], Jf)
                        MG = torch.einsum(
                            "nij,njv->niv",
                            self.inv_ete[plan.e_ids[bi]], Gc)
                        G = G - torch.einsum("ntu,ntv->nuv", Gc, MG)
                    parts.append(G)
                t = grp["t"]
                acc = plan.block_sum(gi).sum_flat(
                    torch.cat([p.reshape(-1, t, t) for p in parts]))
                if not subtract_cross:
                    sys_.cache.setdefault(key, {})[gi] = acc
            else:
                acc = sys_.cache[key][gi]
            cols = plan.group_cols[gi]
            d = self.D_f[cols]
            out.append((cols, acc + torch.diag_embed(d * d)))
        return out

    def _make_block_diag_preconditioner(self, subtract_cross: bool):
        inverses = [(cols, spd_inv_small(acc))
                    for cols, acc in self.block_diag_S(subtract_cross)]

        def apply(v):
            out = torch.zeros_like(v)
            for cols, inv in inverses:
                out[cols] = torch.einsum("ntu,nu->nt", inv, v[cols])
            return out

        return apply

    def _make_cluster_preconditioner(self, mask, diag_mask):
        """CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL
        (visibility_based_preconditioner.h:127; ceres_tpu SchurOps.
        _make_cluster_preconditioner): the solve with cluster_factor's L
        of S."""
        L, _ = cluster_factor(self.explicit_S(), mask, diag_mask)

        def apply(v):
            y = torch.linalg.solve_triangular(
                L, v.reshape(L.shape[:-1] + (1,)), upper=False)
            return torch.linalg.solve_triangular(
                L.transpose(-1, -2), y, upper=True).reshape(v.shape)

        return apply

    def _make_power_series_preconditioner(self, num_terms: int = 4):
        """Truncated Neumann series around the block-diagonal splitting
        S = P - U: M^-1 v = sum_{k=0..K} (I - P^-1 S)^k P^-1 v, by
        y_{k+1} = y_k - P^-1 (S y_k)
        (power_series_expansion_preconditioner.h:44)."""
        p_apply = self._make_block_diag_preconditioner(subtract_cross=True)

        def apply(v):
            y = p_apply(v)
            acc = y
            for _ in range(num_terms):
                y = y - p_apply(self.apply_S(y))
                acc = acc + y
            return acc

        return apply


def cluster_factor(S, mask, diag_mask):
    """(L, fell_back): the lower Cholesky factor of S restricted to a
    CLUSTER preconditioner's pattern (cluster_masks: the clusters'
    diagonal blocks, plus the spanning forest's blocks for TRIDIAGONAL)
    with a 1e-12 diagonal jitter. The forest's pattern can be indefinite;
    then the cluster-diagonal pattern, a principal submatrix of S and so
    positive definite, is factored instead, picked on the device with no
    host read (fell_back, a 0-d bool tensor)."""
    jitter = torch.diag_embed(1e-12 * torch.diagonal(S, dim1=-2, dim2=-1))
    L1, info1 = torch.linalg.cholesky_ex(S * mask.to(S.dtype) + jitter)
    L2, _ = torch.linalg.cholesky_ex(S * diag_mask.to(S.dtype) + jitter)
    bad = (info1 != 0) | torch.isnan(L1).flatten(-2).any(-1)
    return torch.where(bad[..., None, None], L2, L1), bad


def camera_clustering(program, meta, kind, clustering_type):
    """(membership, forest, col_cluster) of a CLUSTER preconditioner
    (solvers/clustering.py cluster_membership): each camera's cluster,
    the spanning forest's cluster pairs (None for CLUSTER_JACOBI) and
    each f column's cluster. Computed on the host once per Schur
    structure, kind and clustering type (cached on the meta)."""
    key = (str(kind), str(clustering_type))
    cache = meta.__dict__.setdefault("_clusterings", {})
    if key not in cache:
        membership, forest = cluster_membership(
            program, meta, PreconditionerType(kind).name,
            clustering_type=clustering_type)
        col_cluster = np.zeros(meta.nf, dtype=np.int64)
        flat = 0
        for grp in meta.f_groups:
            for li in range(grp["kf"]):
                col_cluster[grp["cols"][li]] = membership[flat]
                flat += 1
        cache[key] = (membership, forest, col_cluster)
    return cache[key]


def cluster_masks(program, meta, kind, clustering_type, device):
    """(mask, diag_mask) [nf, nf] bool tensors on `device` of a CLUSTER
    preconditioner (ceres_tpu make_schur_solver, :965-990): True where
    the f columns' cameras share a cluster (diag_mask) or, for
    CLUSTER_TRIDIAGONAL, lie in two clusters joined by the spanning
    forest (mask). Built on the host from camera_clustering: the
    clusters' adjacency (each cluster with itself and its forest edges,
    both ways), indexed by the columns' clusters."""
    membership, forest, col_cluster = camera_clustering(
        program, meta, kind, clustering_type)
    adjacency = np.eye(int(membership.max()) + 1, dtype=bool)
    for a, b in forest or ():
        adjacency[a, b] = adjacency[b, a] = True
    mask = adjacency[col_cluster[:, None], col_cluster[None, :]]
    diag_mask = col_cluster[:, None] == col_cluster[None, :]
    return (torch.as_tensor(mask, device=device),
            torch.as_tensor(diag_mask, device=device))


class SchurLinearSolver:
    """The Schur family as a linear solver of the generic steps
    (ceres_tpu make_schur_solver): `system(jac_s)` once per
    linearization, `solve_b(system, D, b)` the damped solve of
    (J^T J + D^2) d = b by Schur elimination, `(system, res, D)` the
    step with b = -J^T r. Returns (d, linear iterations as an int32
    tensor); d in the Jacobian's precision, NaN where a factorization
    broke down (an invalid step, which the trust-region loop rejects)."""

    def __init__(self, program, options, meta=None):
        from .schur_sparse import get_sparse_schur_context, use_sparse_schur
        meta = meta if meta is not None else detect_schur_structure(
            program, options)
        if meta is None:
            raise ValueError("Schur solver selected but no Schur structure; "
                             "the solve should have downgraded it")
        self.meta, self.program = meta, program
        self.kind = options.linear_solver_type
        self.precond_kind = options.preconditioner_type
        self.iterative = self.kind == LinearSolverType.ITERATIVE_SCHUR
        self.masks = (cluster_masks(program, meta, self.precond_kind,
                                    options.visibility_clustering_type,
                                    program.device)
                      if self.iterative and self.precond_kind in (
                          PreconditionerType.CLUSTER_JACOBI,
                          PreconditionerType.CLUSTER_TRIDIAGONAL) else None)
        self.mixed = bool(options.use_mixed_precision_solves)
        self.cg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            q_tolerance=options.eta,
            min_iterations=options.min_linear_solver_iterations)
        self.use_explicit = (options.use_explicit_schur_complement
                             or (meta.nf <= 2048
                                 and meta.ne * meta.te * meta.nf <= 1e8))
        self.spse = (options.max_num_spse_iterations, options.spse_tolerance
                     ) if options.use_spse_initialization else None
        self.sparse = (get_sparse_schur_context(meta, program, options)
                       if use_sparse_schur(meta, options) else None)
        if not self.iterative:
            self.mode = (f"{self.kind}, block-sparse S on the native LDL^T"
                         if self.sparse is not None else
                         f"{self.kind}, dense S")
        else:
            self.mode = (f"ITERATIVE_SCHUR + {self.precond_kind}, CG on the "
                         + ("explicit S" if self.use_explicit
                            else "implicit S"))
        self.mode = "generic " + self.mode + (
            ", mixed" if self.mixed else ", f64")

    def stacked(self, meta_s: SchurMeta) -> "SchurLinearSolver":
        """This solver on a stacked meta (stack_meta) of B elements of its
        structure: the same maths on the stack, the explicit S [B, nf, nf],
        the batched CG (solvers/cg.py conjugate_gradients_batched), the
        block-sparse S formed on the stack and factored an element
        (schur_sparse.py StackedSparseSchur); solve_b then returns
        (d [B n], iterations [B])."""
        from .schur_sparse import StackedSparseSchur
        lin = copy.copy(self)
        lin.meta = meta_s
        if self.sparse is not None:
            lin.sparse = StackedSparseSchur(self.sparse, meta_s,
                                            self.program.device)
        return lin

    def system(self, jac) -> SchurSystem:
        """The radius-free part of a linearization's solves; mixed, its
        Jacobian cast to f32 (make_schur_solver, :1009-1023)."""
        out_dtype = jac.buckets[0].J.dtype
        if self.mixed and out_dtype != torch.float32:
            jac = BlockJacobian([b.with_J(b.J.to(torch.float32))
                                 for b in jac.buckets],
                                jac.num_cols, jac.col_sum)
        return SchurSystem(self.meta, jac, out_dtype)

    def __call__(self, system: SchurSystem, res, D):
        res = RVec([p.to(system.dtype) for p in res.parts])
        return self.solve_b(system, D, -system.jac.rmatvec(res))

    def solve_b(self, system: SchurSystem, D, b):
        """(J^T J + D^2) d = b by Schur elimination (make_schur_solver's
        solve_b; the LM step's b = -J^T r and the refinement's
        corrections); mixed, D and b are cast to f32."""
        if self.mixed:
            D, b = D.to(torch.float32), b.to(torch.float32)
        meta, plan = self.meta, system.plan
        B = meta.elements
        ops = SchurOps(system, D)
        b_e = b[plan.e_cols]                           # [ne, te]
        b_f = b[plan.f_global]                         # [nf]
        iters = torch.ones((), dtype=torch.int32, device=b.device)
        if B is not None:
            iters = torch.ones(B, dtype=torch.int64, device=b.device)
        if not self.iterative:
            if self.sparse is not None:
                y = self.sparse.reduced_solve(ops, ops.rhs(b_e, b_f))
            else:
                y = cholesky_solve(*ops.explicit_S_and_rhs(b_e, b_f))
                y = y.reshape(-1)
        else:
            rhs = ops.rhs(b_e, b_f)
            precond = ops.make_preconditioner(self.precond_kind, self.masks)
            if self.use_explicit:
                S = ops.explicit_S()

                def apply_S(v):
                    if B is not None:
                        return torch.bmm(S, v.view(B, -1, 1)).reshape(-1)
                    return S @ v
            else:
                apply_S = ops.apply_S
            x0 = torch.zeros_like(rhs)
            if self.spse is not None:
                x0 = self._spse(ops, apply_S, rhs)
            if B is None:
                result = conjugate_gradients(apply_S, rhs, x0,
                                             apply_preconditioner=precond,
                                             **self.cg_args)
                y, iters = result.x, result.num_iterations
            else:
                def flat(fn):
                    return None if fn is None else (
                        lambda v: fn(v.reshape(-1)).view(B, -1))
                result = conjugate_gradients_batched(
                    flat(apply_S), rhs.view(B, -1), x0.view(B, -1),
                    apply_preconditioner=flat(precond), **self.cg_args)
                y, iters = result.x.reshape(-1), result.num_iterations
        d_e = ops.back_substitute(b_e, y)
        n = self.program.num_effective * (1 if B is None else B)
        d = torch.zeros(n, dtype=y.dtype, device=y.device)
        d[plan.f_global] = y
        d[plan.e_cols.reshape(-1)] = d_e.reshape(-1)
        return d.to(system.out_dtype), iters

    def _spse(self, ops, apply_S, rhs):
        """SPSE warm start (iterative_schur_complement_solver.cc:99-111): a
        truncated power-series estimate of S^-1 rhs around the
        SCHUR_JACOBI splitting, x += P^-1 (rhs - S x) while the correction
        is above spse_tolerance of x, at most max_num_spse_iterations
        terms (one host read a term)."""
        spse_max, spse_tol = self.spse
        p_apply = ops._make_block_diag_preconditioner(True)
        x = dx = p_apply(rhs)
        i = 1
        B = self.meta.elements
        if B is not None:
            # each element its own loop: a stopped element keeps its x
            def norm(v):
                return torch.linalg.vector_norm(v.view(B, -1), dim=1)
            going = norm(dx) > spse_tol * norm(x)
            while i < spse_max and bool(going.any()):
                dx_new = p_apply(rhs - apply_S(x))
                keep = going.repeat_interleave(rhs.numel() // B)
                x = torch.where(keep, x + dx_new, x)
                dx = torch.where(keep, dx_new, dx)
                i += 1
                going = going & (norm(dx) > spse_tol * norm(x))
            return x
        while i < spse_max and bool(torch.linalg.vector_norm(dx) > spse_tol
                                    * torch.linalg.vector_norm(x)):
            dx = p_apply(rhs - apply_S(x))
            x = x + dx
            i += 1
        return x
