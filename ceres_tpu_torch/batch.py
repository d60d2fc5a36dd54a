"""Batched solves: N structurally identical problems solved together.

Counterpart of ceres_tpu/batch.py (solve_batched). Ceres solves one
problem a Solve() call; here a batch of small or medium solves (RANSAC
hypotheses, multi-start bundle adjustment, per-frame refinement) runs in
one of two modes, SolverOptions.batch_mode:

  "batch": every LM iteration runs every element's linearize, damped
    solve and acceptance as one set of batched tensor operations with a
    leading element axis (`batched_tr_solve` over the step of
    `make_batched_step`, on the JAX package's route under vmap:
    `BatchedSchurStep` for the fused Schur step's configurations,
    `BatchedImplicitStep` past the explicit cap, else `BatchedGenericStep`
    on a dense Jacobian or `BatchedBlockStep` on the elements' bucketed
    Jacobians stacked into one block-diagonal system (`ElementStack`),
    under `BatchedDoglegStep` for dogleg). Each element keeps its own
    radius, cost, counts and termination code as tensors; a finished
    element is frozen (its state stays as it was, the JAX fused loop's
    freeze_done), and so is an element whose CG has stopped
    (solvers/cg.py conjugate_gradients_batched); the host reads one
    packed vector of termination codes an iteration and one flag a CG
    iteration or dogleg rung. The kernels launched an iteration do not
    depend on the number of elements; the host factorizations
    (SPARSE_NORMAL_CHOLESKY, SPARSE_SCHUR past its dense cap, SUBSET) run
    an element at a time on the native LDL^T, as the JAX package's
    sequential callbacks do. The JAX package turns most of its Pallas
    kernels off under vmap (allow_pallas=not batched); two stay on its
    vmapped route, and batch mode launches their counterparts once for
    all elements: K3 (ops/kernels.py chol_solve, a batch of systems, one
    block each) for the f32 reduced solve of BatchedSchurStep, where the
    fused step calls chol_solve_small, and K8 (jac_normal_matvec on the
    stacked Jacobian, one launch a bucket) for CGNR's operator on an f32
    Jacobian, where solve_cgnr calls jac_normal_matvec. Everything else
    is plain tensor code.
  "pipeline": the step is built once from the template's structure and
    bound to each element's data (`step.bind(program)`), and each element
    runs through the single-solve fused loop (minimizers/fused.py
    fused_tr_solve) back to back, with the kernels the single solve
    takes. An element's result is the one `solve` gives its problem.
  "auto": "batch" up to BATCH_CROSSOVER_RESIDUALS residuals an element,
    else "pipeline".

Contract (as in the JAX package): all problems share the same structure:
block sizes, residual counts, cost and loss classes (and loss scalars,
which the port keys its buckets by) and sparsity, i.e. the same
construction code with different numeric data. The per-problem constant
sets (`program_constants`) must agree in name, shape and dtype, and every
integer constant (the index layouts) must be bitwise equal; float data may
differ. A configuration the fused loop cannot serve (bounds, callbacks,
inner iterations, ...) runs `solve` on each problem in turn.

Usage:
    summaries = ctt.solve_batched(options, [p1, p2, ...])
Results are written back into each problem's parameter arrays, as by
`solve`.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from .loss import correct_residuals_and_jacobian
from .minimizers.fused import TERMINATION_BY_CODE, fused_tr_solve
from .ops.bsr import (BlockJacobian, BucketJacobian, GroupMeta, RVec,
                      column_sum_for)
from .ops.kernels import MAX_M, chol_solve, group_grams, jac_normal_matvec
from .program import CompiledProgram, _loss_key
from .solver import subspace_model, subspace_solve
from .solvers import schur_fused
from .solvers.cg import _edot, conjugate_gradients_batched
from .solvers.preconditioners import (BatchedSubset, SubsetPreconditioner,
                                      batched_block_jacobi, spd_inv_small)
from .solvers.schur import (SchurLinearSolver, detect_schur_structure,
                            stack_meta)
from .solvers.schur_fused import (ImplicitSchurStep, SchurStep,
                                  detect_cross_bucket_dups)
from .solvers.schur_sparse import use_sparse_schur
from .solvers.sparse_direct import (BatchedSparseNormalCholesky,
                                    SparseNormalCholeskySolver)
from .types import (DoglegType, LinearSolverType, MinimizerType,
                    PreconditionerType, SolverSummary, TerminationType,
                    TrustRegionStrategyType)

# The residual count of one element up to which "auto" takes batch mode,
# read from scripts/batch_crossover.py on an NVIDIA H100 80GB HBM3 at
# 700 W (K 8, mixed DENSE_SCHUR BA, medians of 3 calls): batch mode was
# faster at 20,000 residuals (0.115 s against 0.127), pipeline mode at
# 88,000 (0.247 s against 0.275); at 1,000 the two lay within each
# other's spread (PERF.md section 5).
BATCH_CROSSOVER_RESIDUALS = 20000

# Structural template registry: a built step depends only on the
# problems' structure, not on their data. In serving, every request builds
# fresh Problem objects; an entry keeps the template program and its built
# step (pipeline: the single-solve step, bound to each element; batch: the
# batched step), reused for a later batch whose structure and integer
# constants are the template's. Bounded LRU.
_TEMPLATE_REGISTRY: "list[dict]" = []
_TEMPLATE_REGISTRY_CAP = 8

def _fused_capable(program, options) -> bool:
    """The configurations the fused loop serves (ceres_tpu batch.py:110,
    whose list is solver.py needs_host_loop's, and no mesh: a sharded
    solve runs each element through solve; options.fused_iterations is
    ignored: the batched solve is the fused loop)."""
    from .solver import needs_host_loop
    return (options.minimizer_type == MinimizerType.TRUST_REGION
            and not needs_host_loop(options, program)
            and options.mesh is None)


# ---------------------------------------------------------------- structure

def _signature(program):
    """What a batch shares besides its constants: the sizes, the layout of
    the state and the key of every bucket (cost and loss class, loss
    scalars, slots)."""
    buckets = tuple(
        (bk.cost.bucket_key(), _loss_key(bk.loss), bk.n, bk.r, bk.jac_mode,
         tuple((sl.variable, sl.amb_size, sl.tangent_size,
                sl.manifold.bucket_key() if sl.manifold is not None
                else None, sl.amb_gid) for sl in bk.slots))
        for bk in program.buckets)
    groups = tuple((g.tangent_size, g.num_blocks, g.tan_start)
                   for g in program.groups)
    return (program.num_ambient, program.num_effective,
            tuple(program.amb_slabs), groups, buckets)


def program_constants(program) -> dict:
    """The per-problem constants of a program, by name, as numpy: each
    bucket's data fields (float: data; integer: structure), its rows'
    residual-block indices and each slot's block and column maps."""
    out = {}
    for i, bk in enumerate(program.buckets):
        for name, v in bk.data.items():
            out[f"b{i}.data.{name}"] = v.detach().cpu().numpy()
        out[f"b{i}.rows"] = bk.orig_indices
        for j, sl in enumerate(bk.slots):
            out[f"b{i}.s{j}.blocks"] = sl.amb_local.cpu().numpy()
            if sl.variable:
                out[f"b{i}.s{j}.cols"] = sl.cols
    return out


def _constants(program) -> dict:
    consts = program.__dict__.get("_batch_constants")
    if consts is None:
        consts = program._batch_constants = program_constants(program)
    return consts


def _is_integer(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.integer) or \
        np.asarray(a).dtype == np.bool_


def _differing_integer_constant(a, b, names=None):
    """The first integer constant of `names` (default: all of a's) that
    is not bitwise equal in the constant dicts a and b, else None; float
    data may differ."""
    for nm in (a if names is None else names):
        if _is_integer(a[nm]) and not np.array_equal(a[nm], b[nm]):
            return nm
    return None


def _validate_same_structure(programs) -> str:
    """None when all programs share the template's structure (signature,
    constant names, shapes and dtypes, fixed cost), else a readable
    difference (ceres_tpu batch.py:331)."""
    t = programs[0]
    ts, tc = _signature(t), _constants(t)
    for i, pr in enumerate(programs[1:], start=1):
        if pr.num_ambient != t.num_ambient:
            return (f"problem {i}: {pr.num_ambient} ambient parameters "
                    f"vs {t.num_ambient}")
        if pr.num_effective != t.num_effective:
            return (f"problem {i}: {pr.num_effective} effective "
                    f"parameters vs {t.num_effective}")
        if len(pr.buckets) != len(t.buckets):
            return (f"problem {i}: {len(pr.buckets)} cost buckets vs "
                    f"{len(t.buckets)}")
        if pr.fixed_cost != t.fixed_cost:
            return (f"problem {i}: fixed cost {pr.fixed_cost} vs "
                    f"{t.fixed_cost} (constant-block residuals are "
                    f"folded on the host and must agree)")
        if _signature(pr) != ts:
            return f"problem {i}: bucket layout differs"
        pc = _constants(pr)
        if set(pc) != set(tc):
            extra = set(pc) ^ set(tc)
            return f"problem {i}: constant set differs ({sorted(extra)[:4]})"
        for nm, v in tc.items():
            if (pc[nm].shape, pc[nm].dtype) != (v.shape, v.dtype):
                return (f"problem {i}: constant {nm!r} shape/dtype "
                        f"{(pc[nm].shape, pc[nm].dtype)} vs "
                        f"{(v.shape, v.dtype)}")
    return None


def _check_integer_constants(programs):
    """Integer (structural) constants must not vary: the index layouts
    are baked into the built step (ceres_tpu batch.py:214-222)."""
    tc = _constants(programs[0])
    for pr in programs[1:]:
        nm = _differing_integer_constant(tc, _constants(pr))
        if nm is not None:
            raise ValueError(
                f"solve_batched: structural (integer) constant {nm!r} "
                f"differs across problems: the sparsity/ordering must be "
                f"identical for a batched solve")


def _registry_lookup(key, template):
    for entry in _TEMPLATE_REGISTRY:
        if entry["key"] != key:
            continue
        if _validate_same_structure([entry["template"], template]) \
                is not None:
            continue
        # shape equality is not enough: the built step holds layouts
        # derived from the integer constants' values (the chunk rows, the
        # camera plans, the Schur partition), so it serves only a graph
        # whose integer constants are the template's bit for bit
        if _differing_integer_constant(_constants(entry["template"]),
                                       _constants(template)) is not None:
            continue
        _TEMPLATE_REGISTRY.remove(entry)
        _TEMPLATE_REGISTRY.append(entry)        # LRU bump
        return entry
    return None


def _registry_store(key, template, step):
    _TEMPLATE_REGISTRY.append(dict(key=key, template=template, step=step))
    while len(_TEMPLATE_REGISTRY) > _TEMPLATE_REGISTRY_CAP:
        _TEMPLATE_REGISTRY.pop(0)


# ------------------------------------------------------------ batch mode

_SCHUR = (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR,
          LinearSolverType.ITERATIVE_SCHUR)
# the preconditioners the fused Schur step assembles exactly (ceres_tpu
# schur_fused.py iterative_options_ok, :135-144)
_FUSED_PRECONDITIONERS = (PreconditionerType.IDENTITY,
                          PreconditionerType.JACOBI,
                          PreconditionerType.SCHUR_JACOBI)


class _Batch:
    """The elements' data, stacked along a leading axis: per bucket each
    data field [B * n, ...] (rows of element 0 first), stacked on the host
    from the constants the structure check read and copied to the device
    once a field, so binding launches no kernel a element; and the
    initial states [B, num_ambient], one copy."""

    def __init__(self, programs):
        t = programs[0]
        self.data = []
        for i, bk in enumerate(t.buckets):
            self.data.append({
                name: torch.as_tensor(np.concatenate(
                    [_constants(pr)[f"b{i}.data.{name}"] for pr in programs]),
                    device=t.device)
                for name in bk.data})
        self.x0 = torch.as_tensor(np.stack(
            [pr.initial_state_numpy() for pr in programs]), device=t.device)


class ElementStack:
    """B elements of one structure as one block-diagonal system: each
    bucket's rows element after element ([B * n] rows, as _Batch stacks
    the data) and element b's tangent column c at b * num_effective + c,
    so that a tangent vector [B * num_effective] is the elements' vectors
    [B, num_effective] one after another. The BlockJacobian of the stack
    (`jacobian`) serves every single-solve product (J v, J^T w, the column
    norms, the block diagonal of J^T J over the stacked groups) on all
    elements at once, each column's sum in the single solve's order; the
    element axis comes back by a view."""

    def __init__(self, program, B: int):
        self.B, self.n = B, program.num_effective
        dev = program.device
        off = np.arange(B, dtype=np.int64)
        self.cols, self.bucket_n = [], []
        for bk in program.buckets:
            self.bucket_n.append(bk.n)
            self.cols.append([
                (sl.cols.astype(np.int64)[None] + self.n * off[:, None, None]
                 ).reshape(B * bk.n, -1)
                for sl in bk.slots if sl.variable])
        self.col_sum = column_sum_for(self.cols, B * self.n, dev)
        self.cols_t = [[torch.as_tensor(c, device=dev) for c in cs]
                       for cs in self.cols]
        self.all_cols = [torch.cat(cs, dim=1) if cs else
                         torch.zeros(B * n, 0, dtype=torch.int64, device=dev)
                         for cs, n in zip(self.cols_t, self.bucket_n)]
        self.cols32 = [c.to(torch.int32) for c in self.all_cols]
        # the Jacobi groups of the stack: group g's block k of element b is
        # block b * k_g + k (its tangent slab stays per element: tan_start)
        self.groups = []
        for g in program.groups:
            cg = GroupMeta(g.tangent_size, B * g.num_blocks, g.tan_start)
            for (bi, si, ids) in g.bucket_slots:
                cg.bucket_slots.append((bi, si, (
                    np.asarray(ids, np.int64)[None]
                    + g.num_blocks * off[:, None]).reshape(-1)))
            self.groups.append(cg)
        self._metas = {}

    def jacobian(self, Js) -> BlockJacobian:
        """The stack's BlockJacobian of per-bucket J [B, n, r, t]."""
        return BlockJacobian(
            [BucketJacobian(J.reshape((-1,) + tuple(J.shape[2:])), cs, ac,
                            c32)
             for J, cs, ac, c32 in zip(Js, self.cols_t, self.all_cols,
                                       self.cols32)],
            self.B * self.n, self.col_sum)

    def lanes(self, lanes_per_bucket):
        """Per-bucket row lists of one element as rows of the stack."""
        return [(np.asarray(ln, np.int64)[None]
                 + n * np.arange(self.B, dtype=np.int64)[:, None]).reshape(-1)
                for ln, n in zip(lanes_per_bucket, self.bucket_n)]

    def schur_meta(self, meta):
        """The stacked SchurMeta of `meta` (solvers/schur.py stack_meta),
        built once a stack."""
        if id(meta) not in self._metas:
            self._metas[id(meta)] = (meta, stack_meta(meta, self.B, self.n,
                                                      self.bucket_n))
        return self._metas[id(meta)][1]


def _esum(v, B):
    """Per-element sums [B] of a stacked tensor (any shape, element-major
    leading axis)."""
    return v.reshape(B, -1).sum(dim=1)


def _emv(M, v):
    """Per-element products [B, i] of M [B, i, j] and v [B, j]."""
    return torch.einsum("bij,bj->bi", M, v)


def _rvec_sq(w: RVec, B):
    """Per-element ||w||^2 [B] of a stacked residual vector."""
    return sum(_esum(p * p, B) for p in w.parts)


def _rvec_rows(w: RVec, B):
    """A stacked residual vector as [B, m], buckets side by side."""
    return torch.cat([p.reshape(B, -1) for p in w.parts], dim=1)


class _BatchedBase:
    """What the batched steps share: the element axis over the template
    program's layout. Rows of every element of a bucket are evaluated by
    one vmapped call over B * n rows (CompiledProgram.rows_linearize)."""

    def __init__(self, program, options):
        self.program = program
        self.mixed = bool(options.use_mixed_precision_solves)
        self.dtype = torch.float32 if self.mixed else torch.float64
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.var_mask = program._var_mask
        self.all_variable = program._all_variable
        self.n = program.num_effective
        self._stack = None

    def bind(self, batch: _Batch):
        """This step on a batch's data. The ElementStack of the last batch
        size is kept (the template registry holds the step, so a stack a
        batch size would grow with every new size a caller sends)."""
        step = copy.copy(self)
        step.batch = batch
        B = batch.x0.shape[0]
        if self._stack is None or self._stack.B != B:
            self._stack = ElementStack(self.program, B)
        step.stack = self._stack
        return step

    def params(self, bk, x):
        """Per-slot parameters [B * n, size] of bucket bk at states x
        [B, num_ambient]."""
        B = x.shape[0]
        out = []
        for sl in bk.slots:
            start, k, size = self.program.amb_slabs[sl.amb_gid]
            p = x[:, start:start + k * size].reshape(B, k, size)
            out.append(p[:, sl.amb_local].reshape(B * bk.n, size))
        return out

    def cost(self, x):
        """f64 total cost [B] at states x [B, num_ambient]."""
        B = x.shape[0]
        total = torch.full((B,), self.program.fixed_cost,
                           dtype=torch.float64, device=x.device)
        for bk, data in zip(self.program.buckets, self.batch.data):
            r = CompiledProgram.rows_residuals(bk, self.params(bk, x), data)
            c, _, _ = correct_residuals_and_jacobian(bk.loss, r, None)
            total = total + c.reshape(B, bk.n).sum(dim=1)
        return total

    def linearize_rows(self, x, f32: bool = None):
        """Per bucket (corrected residuals [B, n, r], corrected tangent
        Jacobian [B, n, r, t]): the f64 pass, or with f32 (default: the
        step's mixed flag) the residuals of the f64 pass and the Jacobian
        of the f32 pass, corrected in f32 (as
        CompiledProgram.linearize_fn_mixed)."""
        f32 = self.mixed if f32 is None else f32
        B, out = x.shape[0], []
        for bk, data in zip(self.program.buckets, self.batch.data):
            ps = self.params(bk, x)
            if f32:
                r64 = CompiledProgram.rows_residuals(bk, ps, data)
                J = CompiledProgram.rows_linearize(
                    bk, [p.float() for p in ps], data, torch.float32)[1]
                _, rc, Jc = correct_residuals_and_jacobian(
                    bk.loss, r64.float(), J.float())
                rc, Jc = rc.float(), Jc.float()
            else:
                r, J = CompiledProgram.rows_linearize(bk, ps, data,
                                                      torch.float64)
                _, rc, Jc = correct_residuals_and_jacobian(bk.loss, r, J)
            out.append((rc.reshape(B, bk.n, bk.r),
                        Jc.reshape(B, bk.n, bk.r, -1)))
        return out

    def plus(self, x, delta):
        """Plus of every element (CompiledProgram.plus along the element
        axis; fused-capable programs have no bounds)."""
        prog = self.program
        if prog.tangent_is_ambient:
            return x + delta
        B = x.shape[0]
        out = x.clone()
        for manifold, k, amb, t, a_ix, t_ix in prog.plus_groups:
            xs = x[:, a_ix].reshape(B * k, amb)
            ds = delta[:, t_ix].reshape(B * k, t)
            new = xs + ds if manifold is None else manifold.plus_batch(xs,
                                                                       ds)
            out[:, a_ix] = new.reshape(B, k * amb)
        return out

    def state_norm(self, x):
        if self.all_variable:
            return torch.linalg.vector_norm(x, dim=-1)
        return torch.linalg.vector_norm(x * self.var_mask, dim=-1)


def _householder_solve(A, b):
    """Least-squares solution d [B, n] of A d = b for A [B, M, n] (M >= n,
    full column rank) and b [B, M], by Householder QR written in tensor
    operations: a fixed number of launches for any B (a library QR of a
    batch runs its Q formation once a matrix on the card)."""
    A, b = A.clone(), b.clone()
    n = A.shape[2]
    for j in range(n):
        x = A[:, j:, j]
        norm = torch.linalg.vector_norm(x, dim=1)
        alpha = torch.where(x[:, 0] >= 0, -norm, norm)
        v = x.clone()
        v[:, 0] = v[:, 0] - alpha
        vv = torch.sum(v * v, dim=1)
        beta = torch.where(vv > 0, 2.0 / torch.where(vv > 0, vv, 1.0), 0.0)
        w = torch.sum(v[:, :, None] * A[:, j:, j:], dim=1)       # [B, n-j]
        A[:, j:, j:] -= beta[:, None, None] * v[:, :, None] * w[:, None, :]
        b[:, j:] -= (beta * torch.sum(v * b[:, j:], dim=1))[:, None] * v
    return _back_substitute(A[:, :n, :n], b[:, :n])


def _back_substitute(R, c):
    """d with R d = c for upper triangular R [B, n, n]."""
    n = R.shape[-1]
    d = torch.zeros_like(c)
    for i in range(n - 1, -1, -1):
        s = c[:, i] - torch.sum(R[:, i, i + 1:] * d[:, i + 1:], dim=1)
        d[:, i] = s / R[:, i, i]
    return d


def _cholesky_factor(H):
    """Lower Cholesky factor L [B, n, n] of SPD H [B, n, n] in tensor
    operations (a fixed number of launches for any B); NaN for an element
    whose H is not positive definite."""
    n = H.shape[-1]
    L = torch.zeros_like(H)
    for j in range(n):
        s = H[:, j, j] - torch.sum(L[:, j, :j] * L[:, j, :j], dim=1)
        ljj = torch.sqrt(torch.where(s > 0, s, torch.nan))
        L[:, j, j] = ljj
        if j + 1 < n:
            t = H[:, j + 1:, j] - torch.sum(
                L[:, j + 1:, :j] * L[:, j, None, :j], dim=2)
            L[:, j + 1:, j] = t / ljj[:, None]
    return L


def _cholesky_apply(L, g):
    """d with L L^T d = g."""
    n = L.shape[-1]
    y = torch.zeros_like(g)
    for i in range(n):
        y[:, i] = (g[:, i] - torch.sum(L[:, i, :i] * y[:, :i], dim=1)) \
            / L[:, i, i]
    return _back_substitute(L.transpose(1, 2), y)


class BatchedGenericStep(_BatchedBase):
    """The generic LM step (solver.py GenericLMStep) along the element
    axis with a dense Jacobian [B, m, n]: DENSE_QR (Householder QR of
    [J_s; diag(D)]) and DENSE_NORMAL_CHOLESKY (Cholesky of J_s^T J_s +
    D^2; SPARSE_NORMAL_CHOLESKY below solver.py's SPARSE_DENSE_CAP), in
    f64, mixed (the f32 pass; the normal Cholesky refined at least once in
    f32, solvers/dense.py) or mixed with refinement (the f64 pass cast to
    f32 for the solve, the f64 gradient for the convergence norms, the
    refinement count of the normal Cholesky). The dense Jacobian is
    assembled from the buckets by one index copy; every product is an
    elementwise product and a sum, so the launches of an iteration do
    not depend on B."""

    def __init__(self, program, options, refine_outer: bool = True):
        super().__init__(program, options)
        self.qr = options.linear_solver_type == LinearSolverType.DENSE_QR
        self.refine = options.max_num_refinement_iterations \
            if self.mixed else 0
        # the f64 pass cast to f32 (mixed with refinement, LM only)
        self.cast = self.refine > 0 and refine_outer
        self.exact = self.mixed
        self.m = program.num_rows
        n = self.n
        idx, off = [], 0
        for bk in program.buckets:
            cols = [sl.cols for sl in bk.slots if sl.variable]
            cols = (np.concatenate(cols, axis=1) if cols
                    else np.zeros((bk.n, 0), np.int64))
            rows = off + np.arange(bk.n * bk.r).reshape(bk.n, bk.r)
            idx.append((rows[:, :, None] * n + cols[:, None, :]).reshape(-1))
            off += bk.n * bk.r
        self.flat = torch.as_tensor(np.concatenate(idx).astype(np.int64),
                                    device=program.device)

    def _dense(self, parts):
        B = parts[0][0].shape[0]
        r = torch.cat([rc.reshape(B, -1) for rc, _ in parts], dim=1)
        J = torch.zeros(B, self.m * self.n, dtype=r.dtype, device=r.device)
        J.index_copy_(1, self.flat, torch.cat(
            [Jc.reshape(B, -1) for _, Jc in parts], dim=1))
        return J.view(B, self.m, self.n), r

    def linearize(self, x, scale, first: bool, cost=None, with_diag=True):
        J, r = self._dense(self.linearize_rows(x, f32=self.mixed
                                               and not self.cast))
        grad64 = None
        if self.cast:
            grad64 = torch.sum(J * r[:, :, None], dim=1)
            J, r = J.float(), r.float()
        grad = torch.sum(J * r[:, :, None], dim=1)
        if first:
            if not self.use_scaling:
                scale = torch.ones_like(grad)
            else:
                Jn = J if not self.cast else self._dense(
                    self.linearize_rows(x, f32=True))[0]
                scale = 1.0 / (1.0 + torch.sqrt(torch.sum(Jn * Jn, dim=1)))
        J_s = J * scale[:, None, :]
        g_norms = grad64 if grad64 is not None else grad
        art = dict(J_s=J_s, r=r, scale=scale, g_s=grad * scale,
                   grad_max=g_norms.abs().amax(dim=1).double())
        if with_diag:
            art["diag"] = torch.clamp(torch.sum(J_s * J_s, dim=1),
                                      self.min_diag, self.max_diag)
        return art

    def jmv(self, art, d):
        """J_s d [B, m]."""
        return torch.sum(art["J_s"] * d[:, None, :], dim=2)

    def lin_solve(self, art, D):
        """The damped solve at D [B, n]: (d [B, n], iterations [B])."""
        J_s, g_s = art["J_s"], art["g_s"]
        if self.qr:
            A = torch.cat([J_s, torch.diag_embed(D)], dim=1)
            b = torch.cat([-art["r"], torch.zeros_like(D)], dim=1)
            d = _householder_solve(A, b)
        else:
            H = torch.sum(J_s[:, :, :, None] * J_s[:, :, None, :], dim=1) \
                + torch.diag_embed(D * D)
            L = _cholesky_factor(H)
            d = _cholesky_apply(L, -g_s)
            if self.mixed:          # solvers/dense.py's f32 refinement
                for _ in range(max(1, self.refine)):
                    d = d + _cholesky_apply(L, -g_s - torch.sum(
                        H * d[:, None, :], dim=2))
        return d, torch.ones(d.shape[0], dtype=torch.int64, device=d.device)

    def solve(self, art, radius):
        D = torch.sqrt(art["diag"] / radius.to(art["diag"].dtype)[:, None])
        d, its = self.lin_solve(art, D)
        g_s = art["g_s"]
        if self.exact:
            # (J^T J + D^2) d = -g_s exactly: ||J_s d||^2 = -d.g_s - ||D d||^2
            dg = torch.sum(d * g_s, dim=1)
            Dd = D * d
            mcc = -(dg + 0.5 * (-dg - torch.sum(Dd * Dd, dim=1)))
        else:
            Jd = self.jmv(art, d)
            mcc = -(torch.sum(d * g_s, dim=1) + 0.5 * torch.sum(Jd * Jd,
                                                                dim=1))
        return (art["scale"] * d).double(), mcc.double(), its


class BatchedBlockStep(_BatchedBase):
    """The generic LM step (solver.py GenericLMStep) along the element axis
    on the stacked bucketed Jacobian (ElementStack: [B * n, r, t] a bucket
    with the column maps, never a dense [B, m, n]), over
    BatchedLinearSolver: CGNR, SPARSE_NORMAL_CHOLESKY from
    SPARSE_DENSE_CAP on, and the Schur family on the generic route. In
    f64, mixed, or mixed with refinement (the f64 pass cast to f32, the
    Schur step refined outside the solve with its solve_b, as
    GenericLMStep._refine). The per-column maths (scale, diagonal,
    damping) is the single step's on the stack; every per-element scalar
    is a sum over the element's view."""

    def __init__(self, program, options, refine_outer: bool = True):
        super().__init__(program, options)
        self.linear = BatchedLinearSolver(program, options)
        self.refine = (options.max_num_refinement_iterations
                       if self.mixed and refine_outer else 0)
        self.exact = self.mixed and options.linear_solver_type in (
            LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR)
        self.refine_outer = self.refine > 0 and self.linear.schur is not None

    def bind(self, batch):
        step = super().bind(batch)
        step.linear = self.linear.bind(step.stack)
        return step

    def linearize(self, x, scale, first: bool, cost=None, with_diag=True):
        B, st = x.shape[0], self.stack
        cast = self.mixed and self.refine > 0
        parts = self.linearize_rows(x, f32=self.mixed and not cast)
        jac = st.jacobian([J for _, J in parts])
        res = RVec([r.reshape(-1, r.shape[-1]) for r, _ in parts])
        grad = jac.rmatvec(res)
        grad64 = jac64 = None
        if cast:
            jac64, grad64 = jac, grad
            jac = BlockJacobian([b.with_J(b.J.float()) for b in jac.buckets],
                                jac.num_cols, jac.col_sum)
            res = RVec([p.float() for p in res.parts])
            grad = jac.rmatvec(res)
        if first:
            if not self.use_scaling:
                scale = torch.ones_like(grad)
            else:
                jn = jac if not cast else st.jacobian(
                    [J for _, J in self.linearize_rows(x, f32=True)])
                scale = 1.0 / (1.0 + torch.sqrt(jn.squared_column_norms()))
        jac_s = jac.scale_columns(scale)
        g_norms = grad64 if grad64 is not None else grad
        art = dict(jac_s=jac_s, res=res, scale=scale, g_s=grad * scale,
                   blocks=self.linear.blocks(jac_s, res),
                   grad_max=g_norms.view(B, -1).abs().amax(dim=1).double())
        if with_diag:
            art["diag"] = torch.clamp(jac_s.squared_column_norms(),
                                      self.min_diag, self.max_diag)
        if jac64 is not None and self.refine_outer:
            s64 = scale.double()
            art["refine"] = (jac64.scale_columns(s64), -(grad64 * s64))
        return art

    def jmv(self, art, d):
        """J_s d [B, m] for d [B, n]."""
        return _rvec_rows(art["jac_s"].matvec(d.reshape(-1)), d.shape[0])

    def lin_solve(self, art, D):
        """The damped solve at D [B, n]: (d [B, n], iterations [B])."""
        B = D.shape[0]
        d, its = self.linear(art["jac_s"], art["res"], D.reshape(-1),
                             art["blocks"])
        return d.view(B, -1), its

    def solve(self, art, radius):
        B = radius.shape[0]
        dt = art["diag"].dtype
        D = torch.sqrt(art["diag"].view(B, -1) / radius.to(dt)[:, None])
        d, its = self.lin_solve(art, D)
        if "refine" in art:
            d, its = self._refine(art, D, d, its)
        g_s = art["g_s"].view(B, -1)
        if self.exact:
            Dd = D.to(d.dtype) * d
            dg = torch.sum(d * g_s.to(d.dtype), dim=1)
            mcc = -(dg + 0.5 * (-dg - torch.sum(Dd * Dd, dim=1)))
        else:
            Jd = art["jac_s"].matvec(d.reshape(-1))
            mcc = -(torch.sum(d * g_s, dim=1) + 0.5 * _rvec_sq(Jd, B))
        return ((art["scale"].view(B, -1) * d).double(), mcc.double(), its)

    def _refine(self, art, D, d, its):
        """GenericLMStep._refine on the element axis: d += solve_b(b -
        (J_s^T J_s + D^2) d), the residual in f64, the correction f32."""
        jac64_s, b64 = art["refine"]
        D64 = D.double().reshape(-1)
        d64 = d.double().reshape(-1)
        for _ in range(self.refine):
            Hd = jac64_s.rmatvec(jac64_s.matvec(d64)) + (D64 * D64) * d64
            dc, it = self.linear.schur.solve_b(art["blocks"], D.reshape(-1),
                                               b64 - Hd)
            d64 = d64 + dc.double()
            its = its + it
        return d64.view(d.shape), its


class BatchedLinearSolver:
    """solver.py LinearSolver on the stacked Jacobian (ElementStack):
    `blocks(jac_s, res)` once a linearization, `(jac_s, res, D, blocks)`
    the damped solve of every element, (d [B * n], iterations [B]).

      CGNR: solvers/cg.py conjugate_gradients_batched over J^T (J v) +
        D^2 v (on an f32 Jacobian K8, jac_normal_matvec on the stack: one
        launch a bucket for every element, as solve_cgnr), with block
        Jacobi (the stacked groups' Grams, group_grams), IDENTITY or
        SUBSET (solvers/preconditioners.py BatchedSubset: one copy of
        every element's v to the host and one back a CG iteration);
      SPARSE_NORMAL_CHOLESKY: solvers/sparse_direct.py
        BatchedSparseNormalCholesky, the native LDL^T an element;
      the Schur family: solvers/schur.py SchurLinearSolver over the
        stacked SchurMeta (its explicit S [B, nf, nf], the batched CG,
        the block-sparse S factored an element)."""

    def __init__(self, program, options):
        from .solver import SPARSE_DENSE_CAP
        self.kind = kind = options.linear_solver_type
        self.groups = program.groups
        self.n = program.num_effective
        self.schur = (SchurLinearSolver(program, options)
                      if kind in _SCHUR else None)
        self.sparse = (SparseNormalCholeskySolver(program, options)
                       if kind == LinearSolverType.SPARSE_NORMAL_CHOLESKY
                       and program.num_effective >= SPARSE_DENSE_CAP
                       else None)
        cgnr = kind == LinearSolverType.CGNR
        self.subset = (SubsetPreconditioner(program, options)
                       if cgnr and options.preconditioner_type
                       == PreconditionerType.SUBSET else None)
        self.jacobi = (cgnr and self.subset is None
                       and options.preconditioner_type
                       != PreconditionerType.IDENTITY)
        self.cg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)
        self._bound = None

    def bind(self, stack):
        """This solver on an ElementStack (the last stack's kept)."""
        if self._bound is None or self._bound.stack is not stack:
            lin = copy.copy(self)
            lin.stack = stack
            if self.schur is not None:
                lin.schur = self.schur.stacked(stack.schur_meta(
                    self.schur.meta))
            if self.sparse is not None:
                lin.sparse = BatchedSparseNormalCholesky(self.sparse.ctx,
                                                         stack.B)
            if self.subset is not None:
                lin.subset = BatchedSubset(self.subset, stack)
            self._bound = lin
        return self._bound

    def blocks(self, jac_s, res):
        if self.schur is not None:
            return self.schur.system(jac_s)
        if self.sparse is not None:
            return self.sparse.system(jac_s, res)
        if self.subset is not None:
            return self.subset.system(jac_s)
        if not self.jacobi:
            return None
        return [group_grams([jac_s.buckets[bi].slot_J(si)
                             for (bi, si, _) in g.bucket_slots],
                            *g.gram_order(jac_s.buckets[0].J.device))
                for g in self.stack.groups]

    def __call__(self, jac_s, res, D, blocks):
        B = self.stack.B
        if self.schur is not None:
            return self.schur(blocks, res, D)
        if self.sparse is not None:
            return (self.sparse.solve(blocks, D),
                    torch.zeros(B, dtype=torch.int64, device=D.device))
        if self.subset is not None:
            precond = self.subset.make(blocks, D)
        elif self.jacobi:
            precond = batched_block_jacobi(blocks, D.view(B, -1),
                                           self.groups)
        else:
            precond = None
        DD = D * D
        if jac_s.buckets[0].J.dtype == torch.float32:
            def apply_A(v):
                vf = v.reshape(-1)
                return (jac_normal_matvec(jac_s, vf) + DD * vf).view(B, -1)
        else:
            def apply_A(v):
                vf = v.reshape(-1)
                return (jac_s.rmatvec(jac_s.matvec(vf))
                        + DD * vf).view(B, -1)

        b = -jac_s.rmatvec(res).view(B, -1)
        out = conjugate_gradients_batched(
            apply_A, b, torch.zeros_like(b), apply_preconditioner=precond,
            **self.cg_args)
        return out.x.reshape(-1), out.num_iterations


class BatchedSchurStep(_BatchedBase):
    """The fused Schur LM step of the JAX package's batched solve
    (ceres_tpu schur_fused.py make_fused_schur_lm_step with batched=True:
    DENSE_SCHUR, SPARSE_SCHUR below the dense cap and ITERATIVE_SCHUR on
    the explicit S, f64 or mixed) along the element axis, on any Schur
    structure in the chunk layout: the e blocks' Grams E^T E and
    gradients by sums over each block's chunk lanes, the f side dense
    ([B, m, nf] rows): F^T F, g_f and each e block's coupling A = E^T F
    [B, ne, te, nf]; the Jacobi scales of the first linearization, the
    damped e inverses (closed form for te <= 3), S = F^T F_s + D_f^2 -
    A_s^T inv A_s, and the
    reduced solve: its Cholesky (f32 up to MAX_M: K3 on every element's
    system in one launch, where the JAX package's vmapped step calls its
    K3; else torch.linalg.cholesky_ex), or
    ITERATIVE_SCHUR's CG on S from y = 0 (conjugate_gradients_batched,
    with IDENTITY, JACOBI: the diagonal blocks of F^T F_s + D_f^2, or
    SCHUR_JACOBI: those of S), then the back-substitution and the model
    cost change (DENSE: the exact solve's identity; ITERATIVE: the Gram
    identity, an inexact step breaking the other)."""

    def __init__(self, program, options, meta):
        super().__init__(program, options)
        dev = program.device
        self.meta = meta
        self.ne, self.te, self.nf = meta.ne, meta.te, meta.nf
        self.m = program.num_rows
        self.iterative = (options.linear_solver_type
                          == LinearSolverType.ITERATIVE_SCHUR)
        self.preconditioner = options.preconditioner_type
        self.cg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)
        grp = meta.f_groups[0]
        self.kf, self.tf = grp["kf"], grp["t"]
        self.gcols = torch.as_tensor(grp["cols"].astype(np.int64),
                                     device=dev)             # [kf, tf]
        self.e_cols = torch.as_tensor(meta.e_cols.reshape(-1).astype(
            np.int64), device=dev)
        self.f_cols = torch.as_tensor(meta.f_global_cols.astype(np.int64),
                                      device=dev)
        self.plans, off = [], 0
        for bk, bs in zip(program.buckets, meta.buckets):
            var = [sl for sl in bk.slots if sl.variable]
            offs = np.cumsum([0] + [sl.tangent_size for sl in var])
            p = {"r": bk.r, "n": bk.n, "eo": None, "rows": None}
            if bs.e_slot is not None:
                p["eo"] = int(offs[bs.e_slot])
                p["rows"] = torch.as_tensor(bs.chunk_rows.astype(np.int64),
                                            device=dev)
                p["mask"] = torch.as_tensor(bs.chunk_mask, dtype=self.dtype,
                                            device=dev)
            fcols = [np.arange(offs[i], offs[i + 1]) for i in bs.f_slots]
            p["fsel"] = (torch.as_tensor(np.concatenate(fcols).astype(
                np.int64), device=dev) if fcols else None)
            if bs.f_cols is not None:
                rows = off + np.arange(bk.n * bk.r).reshape(bk.n, bk.r)
                p["flat"] = torch.as_tensor(
                    (rows[:, :, None] * self.nf
                     + bs.f_cols[:, None, :]).reshape(-1).astype(np.int64),
                    device=dev)
            p["row0"] = off
            off += bk.n * bk.r
            self.plans.append(p)

    def linearize(self, x, scales, first: bool, cost=None):
        B, ne, te, nf = x.shape[0], self.ne, self.te, self.nf
        dt, dev = self.dtype, x.device
        parts = self.linearize_rows(x)
        r_all = torch.cat([rc.reshape(B, -1) for rc, _ in parts], dim=1)
        Jf = torch.zeros(B, self.m * nf, dtype=dt, device=dev)
        EtE = torch.zeros(B, ne, te, te, dtype=dt, device=dev)
        g_e = torch.zeros(B, ne, te, dtype=dt, device=dev)
        for p, (rc, Jc) in zip(self.plans, parts):
            if p["fsel"] is not None:
                Jf.index_copy_(1, p["flat"], Jc[..., p["fsel"]].reshape(
                    B, -1))
        Jf = Jf.view(B, self.m, nf)
        A = torch.zeros(B, ne, te, nf, dtype=dt, device=dev)
        for p, (rc, Jc) in zip(self.plans, parts):
            if p["eo"] is None:
                continue
            rows, mask = p["rows"], p["mask"]                 # [ne, k]
            Je = Jc[..., p["eo"]:p["eo"] + te][:, rows] \
                * mask[None, :, :, None, None]              # [B,ne,k,r,te]
            rk = rc[:, rows] * mask[None, :, :, None]         # [B,ne,k,r]
            EtE = EtE + torch.einsum("bnkri,bnkrj->bnij", Je, Je)
            g_e = g_e + torch.einsum("bnkri,bnkr->bni", Je, rk)
            fr = Jf[:, p["row0"]:p["row0"] + p["n"] * p["r"]].reshape(
                B, p["n"], p["r"], nf)[:, rows]               # [B,ne,k,r,nf]
            A = A + torch.einsum("bnkri,bnkrf->bnif", Je, fr)
        FtF = torch.bmm(Jf.transpose(1, 2), Jf)
        g_f = torch.bmm(Jf.transpose(1, 2), r_all[:, :, None])[..., 0]
        cn_e = torch.diagonal(EtE, dim1=-2, dim2=-1)
        cn_f = torch.diagonal(FtF, dim1=-2, dim2=-1)
        if first:
            if self.use_scaling:
                s_e = 1.0 / (1.0 + torch.sqrt(cn_e))
                s_f = 1.0 / (1.0 + torch.sqrt(cn_f))
            else:
                s_e, s_f = torch.ones_like(cn_e), torch.ones_like(cn_f)
        else:
            s_e, s_f = scales
        grad_max = torch.maximum(g_e.abs().reshape(B, -1).amax(dim=1),
                                 g_f.abs().amax(dim=1))
        return dict(
            scales=(s_e, s_f),
            etes=EtE * (s_e[..., :, None] * s_e[..., None, :]),
            gse=g_e * s_e, A_s=s_e[..., None] * A * s_f[:, None, None, :],
            FtF_s=FtF * (s_f[:, :, None] * s_f[:, None, :]), gsf=g_f * s_f,
            diag_e=torch.clamp(s_e * s_e * cn_e, self.min_diag,
                               self.max_diag),
            diag_f=torch.clamp(s_f * s_f * cn_f, self.min_diag,
                               self.max_diag),
            grad_max=grad_max.double(), s_e=s_e, s_f=s_f)

    def _diag_blocks(self, M):
        """The [B, kf, tf, tf] diagonal blocks of M [B, nf, nf] on the f
        group's blocks."""
        c = self.gcols
        return M[:, c[:, :, None], c[:, None, :]]

    def _reduced_cg(self, art, S, rhs, rad):
        """ITERATIVE_SCHUR's CG on the explicit S [B, nf, nf] from y = 0
        (ceres_tpu schur_fused.py :866-881 under vmap)."""
        B, kf, tf = S.shape[0], self.kf, self.tf
        kind = self.preconditioner
        precond = None
        if kind != PreconditionerType.IDENTITY:
            if kind == PreconditionerType.SCHUR_JACOBI:
                blocks = self._diag_blocks(S)
            else:
                blocks = self._diag_blocks(
                    art["FtF_s"] + torch.diag_embed(art["diag_f"]
                                                    / rad[:, None]))
            inv = spd_inv_small(blocks.reshape(B * kf, tf, tf)).view(
                B, kf, tf, tf)
            c = self.gcols.reshape(-1)

            def precond(v):
                out = torch.zeros_like(v)
                out[:, c] = torch.einsum("bktu,bku->bkt", inv,
                                         v[:, self.gcols]).reshape(B, -1)
                return out

        out = conjugate_gradients_batched(
            lambda v: torch.bmm(S, v[:, :, None])[..., 0], rhs,
            torch.zeros_like(rhs), apply_preconditioner=precond,
            **self.cg_args)
        return out.x, out.num_iterations

    def solve(self, art, radius):
        B, ne, te, nf = radius.shape[0], self.ne, self.te, self.nf
        rad = radius.to(self.dtype)
        P = art["etes"] + torch.diag_embed(art["diag_e"]
                                           / rad[:, None, None])
        # the damped point inverses as the fused step forms them (closed
        # form for te <= 3, ceres_tpu's _spd_inv_small)
        inv = schur_fused._spd_inv_e(P.reshape(-1, te, te)).view(P.shape)
        A_s, gse = art["A_s"], art["gse"]
        Y = inv @ A_s                                        # [B,ne,te,nf]
        S = art["FtF_s"] + torch.diag_embed(art["diag_f"] / rad[:, None]) \
            - torch.bmm(A_s.reshape(B, ne * te, nf).transpose(1, 2),
                        Y.reshape(B, ne * te, nf))
        z = torch.einsum("bnij,bnj->bni", inv, gse)
        rhs = -art["gsf"] + torch.einsum("bnif,bni->bf", A_s, z)
        if self.iterative:
            y, its = self._reduced_cg(art, S, rhs, rad)
        elif self.dtype == torch.float32 and nf <= MAX_M:
            y = chol_solve(S.contiguous(), rhs.contiguous())
            its = torch.ones(B, dtype=torch.int64, device=y.device)
        else:
            Ls, info_s = torch.linalg.cholesky_ex(S)
            y = torch.cholesky_solve(rhs[..., None], Ls)[..., 0]
            y = torch.where((info_s == 0)[:, None], y, torch.nan)
            its = torch.ones(B, dtype=torch.int64, device=y.device)
        Ay = torch.einsum("bnif,bf->bni", A_s, y)
        d_e = torch.einsum("bnij,bnj->bni", inv, -gse - Ay)
        d_dot_g = torch.sum(d_e * gse, dim=(1, 2)) + torch.sum(
            y * art["gsf"], dim=1)
        Jd_sq = (torch.sum(d_e * torch.einsum("bnij,bnj->bni", art["etes"],
                                              d_e), dim=(1, 2))
                 + 2.0 * torch.sum(d_e * Ay, dim=(1, 2))
                 + torch.sum(y * torch.einsum("bfg,bg->bf", art["FtF_s"], y),
                             dim=1))
        mcc = -(d_dot_g + 0.5 * Jd_sq)
        delta = torch.zeros(B, self.program.num_effective,
                            dtype=torch.float64, device=radius.device)
        delta.index_copy_(1, self.e_cols,
                          (art["s_e"] * d_e).double().reshape(B, -1))
        delta.index_copy_(1, self.f_cols, (art["s_f"] * y).double())
        return delta, mcc.double(), its


class BatchedDoglegStep:
    """The dogleg step (solver.py DoglegStep; ceres_tpu dogleg_step,
    :333-437), TRADITIONAL_DOGLEG or SUBSPACE_DOGLEG, along the element
    axis over a batched generic step `base` (BatchedGenericStep or
    BatchedBlockStep, with any of their linear solvers), in f64 or mixed
    (the f32 pass; no outer refinement, as there). linearize: the Cauchy
    point; the Gauss-Newton point with damping D = 1e-12 raised x100 per
    element while that element's solve is not valid (at most 8 solves),
    each rung solving every element and keeping the new point of those
    still climbing, with one host read a rung (is any element climbing);
    the Cauchy point where the whole ladder failed; SUBSPACE_DOGLEG's
    2 x 2 model, batched. solve: the single step's selection per
    element."""

    def __init__(self, base, options):
        self.base = base
        self.subspace = options.dogleg_type == DoglegType.SUBSPACE_DOGLEG

    def bind(self, batch):
        step = copy.copy(self)
        step.base = self.base.bind(batch)
        return step

    def cost(self, x):
        return self.base.cost(x)

    def plus(self, x, delta):
        return self.base.plus(x, delta)

    def state_norm(self, x):
        return self.base.state_norm(x)

    def linearize(self, x, scale, first: bool, cost=None):
        base = self.base
        art = base.linearize(x, scale, first, with_diag=False)
        B = x.shape[0]
        g = art["g_s"].view(B, -1)
        dt = g.dtype
        g_sq = torch.sum(g * g, dim=1)
        Jg = base.jmv(art, g)
        alpha = g_sq / torch.clamp(torch.sum(Jg * Jg, dim=1), min=1e-300)
        eps_v = 1e-6 if dt == torch.float32 else 1e-12
        g_norm = torch.linalg.vector_norm(g, dim=1)
        cost = base.cost(x) if cost is None else cost

        def valid(gn):
            Jgn = base.jmv(art, gn)
            mcc_gn = -(torch.sum(gn * g, dim=1)
                       + 0.5 * torch.sum(Jgn * Jgn, dim=1))
            ok = mcc_gn > -eps_v * torch.clamp(cost, min=1.0)
            tiny = torch.linalg.vector_norm(gn, dim=1) <= eps_v * (
                1.0 + g_norm)
            return torch.isfinite(gn).all(dim=1) & (ok | tiny)

        dval = torch.full((B,), 1e-12, dtype=dt, device=g.device)
        gn, its = base.lin_solve(art, dval[:, None].expand_as(g))
        gn = gn.to(dt)
        climbing = (dval < 1e2) & ~valid(gn)
        while bool(climbing.any()):                 # one host read a rung
            dval = torch.where(climbing, dval * 1e2, dval)
            gn_try, it = base.lin_solve(art, dval[:, None].expand_as(g))
            gn = torch.where(climbing[:, None], gn_try.to(dt), gn)
            its = its + torch.where(climbing, it, 0)
            climbing = climbing & (dval < 1e2) & ~valid(gn)
        cauchy = -alpha[:, None] * g
        gn = torch.where(torch.isfinite(gn).all(dim=1)[:, None], gn, cauchy)
        dl = dict(g=g, g_sq=g_sq, cauchy=cauchy, gn=gn, its=its,
                  cauchy_norm=torch.linalg.vector_norm(cauchy, dim=1),
                  gn_norm=torch.linalg.vector_norm(gn, dim=1))
        if self.subspace:
            dl.update(subspace_model(g, gn, lambda v: base.jmv(art, v),
                                     _edot, _edot, _emv))
        art["dogleg"] = dl
        return art

    def solve(self, art, radius):
        dl = art["dogleg"]
        g = dl["g"]
        r = radius.to(g.dtype)
        cauchy, gn = dl["cauchy"], dl["gn"]
        diff = gn - cauchy
        a2 = torch.sum(diff * diff, dim=1)
        b2 = 2.0 * torch.sum(cauchy * diff, dim=1)
        c2 = torch.sum(cauchy * cauchy, dim=1) - r * r
        disc = torch.sqrt(torch.clamp(b2 * b2 - 4.0 * a2 * c2, min=0.0))
        beta = torch.where(a2 > 0, (-b2 + disc)
                           / (2.0 * torch.where(a2 == 0, 1.0, a2)), 0.0)
        seg = cauchy + beta[:, None] * diff
        inside = (dl["gn_norm"] <= r)[:, None]
        d = torch.where(inside, gn, torch.where(
            (dl["cauchy_norm"] >= r)[:, None],
            -(r / torch.sqrt(torch.clamp(dl["g_sq"], min=1e-300)))[:, None]
            * g, seg))
        if self.subspace:
            d_sub, degenerate = subspace_solve(dl, r, _edot, _emv)
            d = torch.where(inside, gn, torch.where(degenerate[:, None], d,
                                                    d_sub))
        Jd = self.base.jmv(art, d)
        mcc = -(torch.sum(d * g, dim=1) + 0.5 * torch.sum(Jd * Jd, dim=1))
        B = d.shape[0]
        return ((art["scale"].view(B, -1) * d).double(), mcc.double(),
                dl["its"])


class BatchedImplicitStep(ImplicitSchurStep):
    """ITERATIVE_SCHUR in the implicit (matrix-free) mode along the
    element axis (ceres_tpu schur_fused.py's implicit branches under vmap,
    K10 off as allow_pallas is there): ImplicitSchurStep's maths on the
    stacked structure (solvers/schur.py stack_meta: B ne points, B kf
    cameras, its plans and camera-chunk layouts built once a batch size),
    the same `linearization`, `reduced_system` (operator, rhs, the
    IDENTITY, JACOBI or SCHUR_JACOBI blocks) and `step_from`, with the
    scalar reductions per element, the rows of every element from one
    vmapped call a bucket (batch mode's plain linearize, no K11), CG by
    conjugate_gradients_batched, in f64 or mixed."""

    def __init__(self, program, options, meta):
        SchurStep.__init__(self, program, options, meta)
        self.rows = _BatchedBase(program, options)
        self.work = self.rows.dtype
        self.k10 = False
        self.ne1, self.kf1, self.nf1 = self.ne, self.kf, self.nf
        dev = program.device
        self.e_pos = torch.as_tensor(meta.e_cols.reshape(-1).astype(
            np.int64), device=dev)
        self.f_pos = torch.as_tensor(meta.f_global_cols[
            meta.f_groups[0]["cols"]].reshape(-1).astype(np.int64),
            device=dev)
        self.mode = "batched implicit (matrix-free) Schur complement"
        self._plans_of = None       # (B, plans, cross pairs): the last B's

    def bind(self, batch):
        step = copy.copy(self)
        step.rows = self.rows.bind(batch)
        B = step.B = batch.x0.shape[0]
        if self._plans_of is None or self._plans_of[0] != B:
            meta_s = step.rows.stack.schur_meta(self.meta)
            plans, e_entries = self._build_plans(self.program, meta_s,
                                                 B * self.kf1)
            self._plans_of = (B, plans, detect_cross_bucket_dups(e_entries))
        _, step.plans, step.cross_pairs = self._plans_of
        step.ne, step.kf, step.nf = B * self.ne1, B * self.kf1, B * self.nf1
        return step

    def cost(self, x):
        return self.rows.cost(x)

    def plus(self, x, delta):
        return self.rows.plus(x, delta)

    def state_norm(self, x):
        return self.rows.state_norm(x)

    def _rmax(self, t):
        return t.reshape(self.B, -1).amax(dim=1)

    def _rdot(self, a, b):
        return _esum(a * b, self.B)

    def _rsum(self, t):
        return _esum(t, self.B)

    def step_delta(self, d_e, d_f):
        delta = torch.zeros(self.B, self.program.num_effective,
                            dtype=torch.float64, device=d_e.device)
        delta.index_copy_(1, self.e_pos, d_e.double().reshape(self.B, -1))
        delta.index_copy_(1, self.f_pos, d_f.double().reshape(self.B, -1))
        return delta

    def linearize(self, x, scales, first: bool, cost=None):
        rows = [(rc.reshape((-1,) + rc.shape[2:]),
                 Jc.reshape((-1,) + Jc.shape[2:]))
                for rc, Jc in self.rows.linearize_rows(x)]
        s_e, s_f = scales if scales is not None else (None, None)
        art = self.linearization(rows, cost, s_e, s_f, first)
        return dict(art=art, scales=(art.s_e, art.s_f),
                    grad_max=art.grad_max)

    def solve(self, art_d, radius):
        art, B = art_d["art"], self.B
        rad = radius.to(self.work)
        sys_ = self.reduced_system(art, rad.repeat_interleave(self.ne1)[:,
                                                                        None],
                                   rad.repeat_interleave(self.kf1)[:, None])
        precond = sys_["precond"]
        out = conjugate_gradients_batched(
            lambda v: sys_["apply_S"](v.reshape(-1)).view(B, -1),
            sys_["rhs"].view(B, -1), torch.zeros_like(sys_["rhs"]).view(
                B, -1),
            apply_preconditioner=None if precond is None else (
                lambda v: precond(v.reshape(-1)).view(B, -1)),
            **self.pcg_args)
        delta, mcc = self.step_from(art, sys_, out.x.reshape(-1))
        return delta, mcc.double(), out.num_iterations


def _fused_schur_structure(meta, options) -> bool:
    """The JAX package's fused Schur step serves the structure (ceres_tpu
    schur_fused.py fused_structure_ok, :100, and iterative_options_ok,
    :135): one f group, the chunk layout on every e bucket, one f slot a
    bucket; ITERATIVE_SCHUR with IDENTITY, JACOBI or SCHUR_JACOBI and no
    SPSE warm start."""
    if meta is None or len(meta.f_groups) != 1:
        return False
    per_bucket = {}
    for (bi, _, _) in meta.f_groups[0]["slots"]:
        per_bucket[bi] = per_bucket.get(bi, 0) + 1
    for bi, bs in enumerate(meta.buckets):
        if bs.e_slot is not None and bs.chunk_rows is None:
            return False
        if bs.f_cols is not None and per_bucket.get(bi, 0) != 1:
            return False
    if options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR:
        return (options.preconditioner_type in _FUSED_PRECONDITIONERS
                and not options.use_spse_initialization)
    return True


def make_batched_step(program, options):
    """The batched step of the configuration, on the JAX package's route
    (ceres_tpu solver.py make_step_impl, :154-177, under vmap): LM with a
    Schur solver, not mixed with refinement, on a structure the fused step
    takes (_fused_schur_structure; SPARSE_SCHUR at or below
    SPARSE_SCHUR_DENSE_NF) runs BatchedSchurStep, or for ITERATIVE_SCHUR
    past the explicit cap BatchedImplicitStep; everything else the
    generic step: BatchedGenericStep for the dense solvers
    (SPARSE_NORMAL_CHOLESKY below SPARSE_DENSE_CAP among them),
    BatchedBlockStep for the rest, under BatchedDoglegStep for DOGLEG."""
    from .solver import SPARSE_DENSE_CAP
    lst = options.linear_solver_type
    mixed = bool(options.use_mixed_precision_solves)
    lm = (options.trust_region_strategy_type
          == TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    meta = detect_schur_structure(program, options) if lst in _SCHUR \
        else None
    if (lm and meta is not None
            and not (mixed and options.max_num_refinement_iterations > 0)
            and not use_sparse_schur(meta, options)
            and _fused_schur_structure(meta, options)):
        if (lst == LinearSolverType.ITERATIVE_SCHUR
                and not schur_fused._explicit_viable(meta)):
            return BatchedImplicitStep(program, options, meta)
        return BatchedSchurStep(program, options, meta)
    dense = lst in (LinearSolverType.DENSE_QR,
                    LinearSolverType.DENSE_NORMAL_CHOLESKY) or (
        lst == LinearSolverType.SPARSE_NORMAL_CHOLESKY
        and program.num_effective < SPARSE_DENSE_CAP)
    cls = BatchedGenericStep if dense else BatchedBlockStep
    if lm:
        return cls(program, options)
    return BatchedDoglegStep(cls(program, options, refine_outer=False),
                             options)


@dataclasses.dataclass
class BatchedResult:
    """Per element [B] (the fused loop's FusedResult along the element
    axis), and `loop_iterations`, the iterations the batch ran."""
    x: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor        # one linear solve an iteration
    successful_steps: torch.Tensor
    unsuccessful_steps: torch.Tensor
    termination_code: torch.Tensor
    linearizations: torch.Tensor
    linear_iterations: torch.Tensor
    loop_iterations: int


def batched_tr_solve(options, step, x0) -> BatchedResult:
    """The fused trust-region loop (minimizers/fused.py fused_tr_solve)
    along the element axis: the same acceptance test, radius update (LM,
    or the dogleg rules: x3 on a step of quality above 0.75, /2 on a
    rejection) and termination codes in the same priority, each element's
    state frozen once its code is set, its linear iterations added while
    it runs. One host read an iteration (the codes)."""
    f64 = torch.float64
    gtol, ftol = options.gradient_tolerance, options.function_tolerance
    ptol = options.parameter_tolerance
    min_rel = options.min_relative_decrease
    max_iters = options.max_num_iterations
    min_radius = options.min_trust_region_radius
    max_radius = options.max_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    lm = (options.trust_region_strategy_type
          == TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    B, dev = x0.shape[0], x0.device
    i64 = dict(dtype=torch.int64, device=dev)

    cost0 = step.cost(x0)
    x, cost_t = x0, cost0
    radius = torch.full((B,), options.initial_trust_region_radius,
                        dtype=f64, device=dev)
    decrease = torch.full((B,), 2.0, dtype=f64, device=dev)
    it, invalid, ok, bad, lins, lin_its = (torch.zeros(B, **i64)
                                           for _ in range(6))
    code = torch.full((B,), 0 if max_iters > 0 else 5, **i64)
    scales, loops = None, 0
    moved = torch.ones(B, dtype=torch.bool, device=dev)
    done = max_iters <= 0
    while not done:
        active = code == 0
        # every iteration linearizes every element, as the JAX package's
        # vmapped loop does (a rejected element's x is unchanged, so its
        # linearization is the same); the count is the single loop's
        art = step.linearize(x, scales, first=(loops == 0), cost=cost_t)
        scales = art.get("scales", art.get("scale"))
        lins = lins + (active & moved).long()
        delta, mcc, its = step.solve(art, radius)
        x_new = step.plus(x, delta)
        new_cost = step.cost(x_new)
        cost = cost_t
        g_max = art["grad_max"].double()
        step_norm = torch.linalg.vector_norm(delta, dim=1)
        x_norm = step.state_norm(x)
        step_valid = torch.isfinite(mcc) & (mcc > 0.0) & torch.isfinite(
            step_norm)
        rel_dec = (cost - new_cost) / torch.where(mcc != 0, mcc, 1.0)
        accept = step_valid & torch.isfinite(new_cost) & (rel_dec > min_rel)
        if lm:
            grow = radius / torch.clamp(1.0 - (2.0 * rel_dec - 1.0) ** 3,
                                        min=1.0 / 3.0)
            new_radius = torch.where(accept, torch.clamp(grow,
                                                         max=max_radius),
                                     radius / decrease)
            new_decrease = torch.where(accept, 2.0, 2.0 * decrease)
        else:
            new_radius = torch.where(accept, torch.where(
                rel_dec > 0.75, torch.clamp(3.0 * radius, max=max_radius),
                radius), 0.5 * radius)
            new_decrease = decrease
        new_invalid = torch.where(step_valid, 0, invalid + 1)
        new_it = it + 1
        cand_ok = step_valid & torch.isfinite(new_cost)
        had_success = (ok > 0) | accept
        f_conv = (cand_ok & ((cost - new_cost).abs() <= ftol * cost)
                  & (accept | (mcc.abs() <= ftol * cost))) | (
            ~step_valid & torch.isfinite(mcc) & (mcc.abs() <= ftol * cost))
        p_conv = cand_ok & had_success & (
            step_norm <= ptol * (x_norm + ptol))
        new_code = torch.where(
            g_max <= gtol, 1, torch.where(
                f_conv, 2, torch.where(
                    p_conv, 3, torch.where(
                        new_radius < min_radius, 4, torch.where(
                            new_it >= max_iters, 5, torch.where(
                                new_invalid >= max_invalid, 6, 0))))))
        take = active & (accept | ((new_code == 2) & cand_ok
                                   & (new_cost < cost)))
        x = torch.where(take[:, None], x_new, x)
        cost_t = torch.where(take, new_cost, cost_t)
        radius = torch.where(active, new_radius, radius)
        decrease = torch.where(active, new_decrease, decrease)
        invalid = torch.where(active, new_invalid, invalid)
        ok = ok + (active & accept).long()
        bad = bad + (active & ~accept).long()
        it = torch.where(active, new_it, it)
        lin_its = lin_its + torch.where(active, its.to(torch.int64), 0)
        code = torch.where(active, new_code, code)
        moved = accept
        loops += 1
        done = bool((code != 0).all())              # the one host read
    return BatchedResult(
        x=x, cost=cost_t, initial_cost=cost0, iterations=it,
        successful_steps=ok, unsuccessful_steps=bad, termination_code=code,
        linearizations=lins, linear_iterations=lin_its,
        loop_iterations=loops)


# ---------------------------------------------------------------- entry

def solve_batched(options, problems: Sequence) -> List[SolverSummary]:
    """Solve N structurally identical problems in batch or pipeline mode
    (SolverOptions.batch_mode). Returns one SolverSummary per problem;
    the parameters are written back into each problem's arrays."""
    from .solver import _maybe_downgrade_options, make_step, solve

    problems = list(problems)
    if not problems:
        return []
    if len(problems) == 1:
        return [solve(options, problems[0])]
    err = options.validate()
    if err is not None:
        out = []
        for _ in problems:
            s = SolverSummary()
            s.termination_type = TerminationType.FAILURE
            s.message = f"Invalid options: {err}"
            out.append(s)
        return out
    if torch.device(options.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("options.device is CUDA but no CUDA device "
                               "is available")
        torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.time()
    programs = [CompiledProgram.get_cached(p, options) for p in problems]
    template = programs[0]
    if not _fused_capable(template, options) or template.num_effective == 0:
        return [solve(options, p) for p in problems]

    mode = options.batch_mode
    if mode == "auto":
        mode = ("batch" if template.num_residuals_total
                <= BATCH_CROSSOVER_RESIDUALS else "pipeline")

    err = _validate_same_structure(programs)
    if err is not None:
        raise ValueError(f"solve_batched: problems differ in structure "
                         f"({err}); batched solving requires identical "
                         f"graphs (same construction code, different "
                         f"numeric data)")
    _check_integer_constants(programs)
    used = _maybe_downgrade_options(options, template, SolverSummary())

    key = (options.cache_key(), mode)
    entry = _registry_lookup(key, template)
    if entry is None:
        step = (make_batched_step(template, used) if mode == "batch"
                else make_step(template, used))
        _registry_store(key, template, step)
    else:
        step = entry["step"]

    t0 = time.time()
    if mode == "batch":
        batch = _Batch(programs)
        res = batched_tr_solve(used, step.bind(batch), batch.x0)
        stats = torch.stack([res.cost, res.initial_cost] + [
            t.double() for t in (
                res.iterations, res.successful_steps, res.unsuccessful_steps,
                res.termination_code, res.linear_iterations,
                res.linearizations)], dim=1).cpu().numpy()
        xs = list(res.x)
    else:
        rows, xs = [], []
        for pr in programs:
            r = fused_tr_solve(pr, used, step.bind(pr), pr.initial_state())
            rows.append([r.cost, r.initial_cost,
                         r.iterations, r.successful_steps,
                         r.unsuccessful_steps, r.termination_code,
                         r.total_linear_iterations, r.linearizations])
            xs.append(r.x)
        stats = np.asarray(rows, dtype=np.float64)
    minimizer_time = time.time() - t0

    summaries = []
    for i, pr in enumerate(programs):
        cost, cost0, iters, oks, bads, code, lin_iters, lins = stats[i]
        s = SolverSummary()
        s.minimizer_type = options.minimizer_type
        s.trust_region_strategy_type = options.trust_region_strategy_type
        s.linear_solver_type_given = options.linear_solver_type
        s.linear_solver_type_used = used.linear_solver_type
        s.preconditioner_type_given = options.preconditioner_type
        s.preconditioner_type_used = used.preconditioner_type
        s.mixed_precision_solves_used = bool(
            options.use_mixed_precision_solves)
        s.num_parameter_blocks = pr.num_parameter_blocks
        s.num_parameters = pr.num_parameters
        s.num_effective_parameters = pr.num_effective_parameters
        s.num_residual_blocks = pr.num_residual_blocks
        s.num_residuals = pr.num_residuals_total
        s.fixed_cost = pr.fixed_cost
        s.initial_cost = float(cost0)
        s.final_cost = float(cost)
        s.num_successful_steps = int(oks)
        s.num_unsuccessful_steps = int(bads)
        s.num_linear_solves = int(iters)
        s.num_linear_solver_iterations = int(lin_iters)
        s.num_iterations_fused = int(iters)
        s.num_linearizations_fused = int(lins)
        s.num_jacobian_evaluations = int(oks) + 1
        s.num_residual_evaluations = int(iters) + 1
        term, msg = TERMINATION_BY_CODE.get(
            int(code), (TerminationType.FAILURE, f"unknown code {code}"))
        s.termination_type = term
        s.message = msg + f" (batched fused mode [{mode}], element {i})"
        s.minimizer_time_in_seconds = minimizer_time
        s.total_time_in_seconds = time.time() - t_start
        if s.is_solution_usable():
            pr.write_back(xs[i])
        summaries.append(s)
    return summaries
