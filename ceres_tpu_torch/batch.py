"""Batched solves: N structurally identical problems solved together.

Counterpart of ceres_tpu/batch.py (solve_batched). Ceres solves one
problem a Solve() call; here a batch of small or medium solves (RANSAC
hypotheses, multi-start bundle adjustment, per-frame refinement) runs in
one of two modes, SolverOptions.batch_mode:

  "batch": every LM iteration runs every element's linearize, damped
    solve and acceptance as one set of batched tensor operations with a
    leading element axis (`BatchedGenericStep`, `BatchedSchurStep`,
    `batched_tr_solve`). Each element keeps its own radius, cost, counts
    and termination code as tensors; a finished element is frozen (its
    state stays as it was, the JAX fused loop's freeze_done); the host
    reads one packed vector of termination codes an iteration. The
    kernels launched an iteration do not depend on the number of
    elements. As the JAX package turns its Pallas kernels off under vmap
    (allow_pallas=not batched), batch mode runs plain tensor code.
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

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from .loss import correct_residuals_and_jacobian
from .minimizers.fused import TERMINATION_BY_CODE, fused_tr_solve
from .program import CompiledProgram, _loss_key
from .types import (LinearSolverType, MinimizerType, SolverSummary,
                    TerminationType, TrustRegionStrategyType)

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

ITEM_49 = "ROADMAP.md item 49 (the rest of batch mode)"


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

def _unsupported_in_batch_mode(options, meta) -> str:
    """Why batch mode cannot serve the configuration, or None. It serves
    LM with DENSE_QR or DENSE_NORMAL_CHOLESKY in f64, and DENSE_SCHUR on
    a Schur structure in f64 or mixed (no refinement)."""
    lst = options.linear_solver_type
    if (options.trust_region_strategy_type
            != TrustRegionStrategyType.LEVENBERG_MARQUARDT):
        return f"{options.trust_region_strategy_type} in batch mode"
    mixed = bool(options.use_mixed_precision_solves)
    if lst in (LinearSolverType.DENSE_QR,
               LinearSolverType.DENSE_NORMAL_CHOLESKY):
        return f"mixed {lst} in batch mode" if mixed else None
    if lst == LinearSolverType.DENSE_SCHUR:
        if mixed and options.max_num_refinement_iterations > 0:
            return "DENSE_SCHUR with refinement in batch mode"
        if meta is None or any(
                bs.e_slot is not None and bs.chunk_rows is None
                for bs in meta.buckets):
            return "DENSE_SCHUR without the chunk layout in batch mode"
        return None
    return f"{lst} in batch mode"


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

    def bind(self, batch: _Batch):
        self.batch = batch
        return self

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

    def linearize_rows(self, x):
        """Per bucket (corrected residuals [B, n, r], corrected tangent
        Jacobian [B, n, r, t]) in the step's precision: f64, or mixed
        (the residuals of the f64 pass, the Jacobian of the f32 pass, as
        CompiledProgram.linearize_fn_mixed)."""
        B, out = x.shape[0], []
        for bk, data in zip(self.program.buckets, self.batch.data):
            ps = self.params(bk, x)
            if self.mixed:
                r64 = CompiledProgram.rows_residuals(bk, ps, data)
                J = CompiledProgram.rows_linearize(
                    bk, [p.float() for p in ps], data, torch.float32)[1]
                _, rc, Jc = correct_residuals_and_jacobian(
                    bk.loss, r64.float(), J.float())
            else:
                r, J = CompiledProgram.rows_linearize(bk, ps, data,
                                                      torch.float64)
                _, rc, Jc = correct_residuals_and_jacobian(bk.loss, r, J)
            out.append((rc.to(self.dtype).reshape(B, bk.n, bk.r),
                        Jc.to(self.dtype).reshape(B, bk.n, bk.r, -1)))
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


def _cholesky_solve(H, g):
    """d with H d = g for SPD H [B, n, n], by a Cholesky factorization in
    tensor operations (a fixed number of launches for any B); NaN for an
    element whose H is not positive definite."""
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
    y = torch.zeros_like(g)
    for i in range(n):
        y[:, i] = (g[:, i] - torch.sum(L[:, i, :i] * y[:, :i], dim=1)) \
            / L[:, i, i]
    return _back_substitute(L.transpose(1, 2), y)


class BatchedGenericStep(_BatchedBase):
    """The generic LM step (solver.py GenericLMStep, f64) along the
    element axis, with DENSE_QR (Householder QR of [J_s; diag(D)]) or
    DENSE_NORMAL_CHOLESKY (Cholesky of J_s^T J_s + D^2). The dense
    Jacobian [B, m, n] is assembled from the buckets by one index copy;
    every product is an elementwise product and a sum, so the launches of
    an iteration do not depend on B."""

    def __init__(self, program, options):
        super().__init__(program, options)
        self.qr = options.linear_solver_type == LinearSolverType.DENSE_QR
        self.m = program.num_rows
        n = self.n = program.num_effective
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

    def linearize(self, x, scale, first: bool):
        B = x.shape[0]
        parts = self.linearize_rows(x)
        r = torch.cat([rc.reshape(B, -1) for rc, _ in parts], dim=1)
        J = torch.zeros(B, self.m * self.n, dtype=self.dtype,
                        device=x.device)
        J.index_copy_(1, self.flat, torch.cat(
            [Jc.reshape(B, -1) for _, Jc in parts], dim=1))
        J = J.view(B, self.m, self.n)
        grad = torch.sum(J * r[:, :, None], dim=1)
        if first:
            scale = (1.0 / (1.0 + torch.sqrt(torch.sum(J * J, dim=1)))
                     if self.use_scaling else torch.ones_like(grad))
        J_s = J * scale[:, None, :]
        return dict(J_s=J_s, r=r, scale=scale, g_s=grad * scale,
                    diag=torch.clamp(torch.sum(J_s * J_s, dim=1),
                                     self.min_diag, self.max_diag),
                    grad_max=grad.abs().amax(dim=1))

    def solve(self, art, radius):
        J_s, g_s = art["J_s"], art["g_s"]
        D = torch.sqrt(art["diag"] / radius[:, None])
        if self.qr:
            A = torch.cat([J_s, torch.diag_embed(D)], dim=1)
            b = torch.cat([-art["r"], torch.zeros_like(D)], dim=1)
            d = _householder_solve(A, b)
        else:
            H = torch.sum(J_s[:, :, :, None] * J_s[:, :, None, :], dim=1) \
                + torch.diag_embed(D * D)
            d = _cholesky_solve(H, -g_s)
        Jd = torch.sum(J_s * d[:, None, :], dim=2)
        mcc = -(torch.sum(d * g_s, dim=1) + 0.5 * torch.sum(Jd * Jd, dim=1))
        return art["scale"] * d, mcc


class BatchedSchurStep(_BatchedBase):
    """DENSE_SCHUR (the explicit Schur LM step of
    solvers/schur_fused.py FusedSchurStep, f64 or mixed) along the element
    axis, on any Schur structure in the chunk layout: the e blocks' Grams
    E^T E and gradients by sums over each block's chunk lanes, the f side
    dense ([B, m, nf] rows): F^T F, g_f and each e block's coupling A =
    E^T F [B, ne, te, nf]; the Jacobi scales of the first linearization,
    the damped e inverses, S = F^T F_s + D_f^2 - A_s^T inv A_s, its
    Cholesky solve (torch.linalg.cholesky_ex), the back-substitution and
    the model cost change by the Gram identity."""

    def __init__(self, program, options, meta):
        super().__init__(program, options)
        dev = program.device
        self.meta = meta
        self.ne, self.te, self.nf = meta.ne, meta.te, meta.nf
        self.m = program.num_rows
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

    def linearize(self, x, scales, first: bool):
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

    def solve(self, art, radius):
        B, ne, te, nf = radius.shape[0], self.ne, self.te, self.nf
        rad = radius.to(self.dtype)
        P = art["etes"] + torch.diag_embed(art["diag_e"]
                                           / rad[:, None, None])
        L, info = torch.linalg.cholesky_ex(P)
        inv = torch.cholesky_inverse(L)
        inv = torch.where((info == 0)[..., None, None], inv, torch.nan)
        A_s, gse = art["A_s"], art["gse"]
        Y = inv @ A_s                                        # [B,ne,te,nf]
        S = art["FtF_s"] + torch.diag_embed(art["diag_f"] / rad[:, None]) \
            - torch.bmm(A_s.reshape(B, ne * te, nf).transpose(1, 2),
                        Y.reshape(B, ne * te, nf))
        z = torch.einsum("bnij,bnj->bni", inv, gse)
        rhs = -art["gsf"] + torch.einsum("bnif,bni->bf", A_s, z)
        Ls, info_s = torch.linalg.cholesky_ex(S)
        y = torch.cholesky_solve(rhs[..., None], Ls)[..., 0]
        y = torch.where((info_s == 0)[:, None], y, torch.nan)
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
        return delta, mcc.double()


def make_batched_step(program, options):
    """The batched step of the configuration, or NotImplementedError
    naming ROADMAP.md item 49."""
    from .solvers.schur import detect_schur_structure
    meta = (detect_schur_structure(program, options)
            if options.linear_solver_type == LinearSolverType.DENSE_SCHUR
            else None)
    reason = _unsupported_in_batch_mode(options, meta)
    if reason is not None:
        raise NotImplementedError(f"solve_batched: {reason} is not ported "
                                  f"yet: {ITEM_49}")
    if meta is not None:
        return BatchedSchurStep(program, options, meta)
    return BatchedGenericStep(program, options)


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
    loop_iterations: int


def batched_tr_solve(options, step, x0) -> BatchedResult:
    """The fused LM loop (minimizers/fused.py fused_tr_solve) along the
    element axis: the same acceptance test, LM radius update and
    termination codes in the same priority, each element's state frozen
    once its code is set. One host read an iteration (the codes)."""
    f64 = torch.float64
    gtol, ftol = options.gradient_tolerance, options.function_tolerance
    ptol = options.parameter_tolerance
    min_rel = options.min_relative_decrease
    max_iters = options.max_num_iterations
    min_radius = options.min_trust_region_radius
    max_radius = options.max_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    B, dev = x0.shape[0], x0.device
    i64 = dict(dtype=torch.int64, device=dev)

    cost0 = step.cost(x0)
    x, cost_t = x0, cost0
    radius = torch.full((B,), options.initial_trust_region_radius,
                        dtype=f64, device=dev)
    decrease = torch.full((B,), 2.0, dtype=f64, device=dev)
    it, invalid, ok, bad, lins = (torch.zeros(B, **i64) for _ in range(5))
    code = torch.full((B,), 0 if max_iters > 0 else 5, **i64)
    relin = torch.ones(B, dtype=torch.bool, device=dev)
    scales, loops = None, 0
    done = max_iters <= 0
    while not done:
        active = code == 0
        art = step.linearize(x, scales, first=(loops == 0))
        scales = art.get("scales", art.get("scale"))
        lins = lins + (active & relin).long()
        delta, mcc = step.solve(art, radius)
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
        grow = radius / torch.clamp(1.0 - (2.0 * rel_dec - 1.0) ** 3,
                                    min=1.0 / 3.0)
        new_radius = torch.where(accept, torch.clamp(grow, max=max_radius),
                                 radius / decrease)
        new_decrease = torch.where(accept, 2.0, 2.0 * decrease)
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
        relin = accept
        code = torch.where(active, new_code, code)
        loops += 1
        done = bool((code != 0).all())              # the one host read
    return BatchedResult(
        x=x, cost=cost_t, initial_cost=cost0, iterations=it,
        successful_steps=ok, unsuccessful_steps=bad, termination_code=code,
        linearizations=lins, loop_iterations=loops)


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
                res.termination_code, res.iterations, res.linearizations)],
            dim=1).cpu().numpy()
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
