"""Residual-row data parallelism over a torch.distributed group: one LM
step at a time.

Counterpart of ceres_tpu/parallel/sharded.py. Each bucket's rows split
into P contiguous ranges (padded to a multiple of P with copies of row 0
under mask 0, build_row_shards; a rank evaluates its range's real rows);
the state and the tangent vectors are replicated; the gradient, the
column norms, the block-Jacobi Grams, each J^T J v of CG and the model
cost change's |J d|^2 are summed over the ranks (parallel/group.py), so
CG (solvers/cg.py) takes the same decisions on every rank. A rank's sums
over its rows run in a fixed order (ops/bsr.py ColumnSum, no atomics), so
a run repeats its bits on the card. In the
program's dtype (f64), as in the JAX package, whose J^T J v and Gram
kernels take f32 only, so no kernel runs here (K8 and K9 stay on the
single-device CGNR step).

make_sharded_lm_step: CGNR with block Jacobi, the step of the sharded
CGNR host loop (parallel/solve_sharded.py). make_sharded_cost_fn: the
sharded cost. make_sharded_schur_step: one DENSE_SCHUR step over
shard-local partial Grams (E^T E, F^T F and A = E^T F summed over the
ranks, the reduced system solved replicated), which the dry run and the
tests use; the production Schur path is parallel/sharded_fused.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..loss import correct_residuals_and_jacobian
from ..ops.bsr import ColumnSum, column_sum_for
from ..solvers.cg import conjugate_gradients
from ..solvers.dense import cholesky_solve
from ..solvers.preconditioners import spd_inv_small
from .group import as_group
from .sharded_fused import _amb_idx, _pad_rows, bucket_rows


def _slot_local_ids(program, bi, var_si):
    """Each row's block index within its Jacobi group, for variable slot
    var_si of bucket bi."""
    for g in program.groups:
        for (b, s, ids) in g.bucket_slots:
            if (b, s) == (bi, var_si):
                return np.asarray(ids)
    raise KeyError((bi, var_si))


def build_row_shards(program, num_shards: int):
    """Per-bucket padded row arrays (ceres_tpu's build_row_shards, whose
    arrays these equal): "data", "amb", "cols", "slot_cols", "local_ids",
    "mask", the leading axis shardable. A bucket of the port has one loss,
    so no "loss_attrs" (ROADMAP.md item 9)."""
    shards = []
    for bi, bk in enumerate(program.buckets):
        n_pad = int(math.ceil(bk.n / num_shards) * num_shards)
        entry = {}
        entry["data"] = ({k: _pad_rows(v.cpu().numpy(), n_pad)
                          for k, v in bk.data.items()} if bk.data else ())
        entry["amb"] = tuple(_pad_rows(_amb_idx(program, sl), n_pad)
                             for sl in bk.slots)
        var_slots = [sl for sl in bk.slots if sl.variable]
        entry["cols"] = _pad_rows(
            np.concatenate([sl.cols for sl in var_slots], axis=1), n_pad)
        entry["slot_cols"] = tuple(_pad_rows(sl.cols, n_pad)
                                   for sl in var_slots)
        entry["local_ids"] = tuple(
            _pad_rows(_slot_local_ids(program, bi, vi), n_pad)
            for vi in range(len(var_slots)))
        mask = np.zeros(n_pad)
        mask[:bk.n] = 1.0
        entry["mask"] = mask
        shards.append(entry)
    return shards


def _segment_sum(targets, num_out, device, unit=()):
    """The ColumnSum of contributions concatenated in list order, each
    part's units going to `targets` (numpy, one array a part)."""
    columns = (np.concatenate([np.asarray(t, np.int64).reshape(-1)
                               for t in targets]) if targets
               else np.zeros(0, np.int64))
    return ColumnSum(np.arange(columns.size), columns, num_out, device,
                     unit)


class _RowShard:
    """This rank's range of each bucket's rows, its real rows only (a
    view of the bucket at them, or None when the range holds none), with
    their tangent columns, and the fixed-order sums over them: `col_sum`
    of the J^T-side products [n, t_total] (the buckets' parts in order),
    `gram_sums[g]` of group g's per-row Gram blocks (its slots' parts in
    the group's order)."""

    def __init__(self, program, group):
        self.views, self.cols, self.rows = [], [], []
        dev = program.device
        for bk in program.buckets:
            per = int(math.ceil(bk.n / group.size))
            rows = np.arange(group.rank * per, min((group.rank + 1) * per,
                                                   bk.n))
            var = [sl for sl in bk.slots if sl.variable]
            self.rows.append(rows)
            self.views.append(bucket_rows(bk, rows) if rows.size else None)
            self.cols.append(torch.as_tensor(np.concatenate(
                [sl.cols[rows] for sl in var], axis=1).astype(np.int64),
                device=dev))
        self.col_sum = column_sum_for(
            [[sl.cols[rows] for sl in bk.slots if sl.variable]
             if rows.size else [] for bk, rows in zip(program.buckets,
                                                     self.rows)],
            program.num_effective, dev)
        self.gram_sums = [_segment_sum(
            [np.asarray(ids)[self.rows[bi]]
             for (bi, _, ids) in gm.bucket_slots if self.rows[bi].size],
            gm.num_blocks, dev, (gm.tangent_size, gm.tangent_size))
            for gm in program.groups]


def _local_linearize(program, x, shard):
    """This rank's cost (f64 sum) and loss-corrected (r, J) per bucket
    (None where the rank holds no row of the bucket)."""
    cost_local = torch.zeros((), dtype=program.dtype, device=x.device)
    outs = []
    for view in shard.views:
        if view is None:
            outs.append(None)
            continue
        r, J = program._bucket_linearize(view, x, program.dtype)
        cost, rc, Jc = correct_residuals_and_jacobian(view.loss, r, J)
        cost_local = cost_local + torch.sum(cost)
        outs.append((rc, Jc))
    return cost_local, outs


def _slot_offsets(bk):
    offs, off = [], 0
    for sl in bk.slots:
        if sl.variable:
            offs.append(off)
            off += sl.tangent_size
    return offs


def _grad_and_norms(program, outs, shard, n_eff):
    """This rank's J^T r and squared column norms [n_eff]."""
    live = [o for o in outs if o is not None]
    return (shard.col_sum([torch.einsum("nrt,nr->nt", Jc, rc)
                           for rc, Jc in live]),
            shard.col_sum([torch.sum(Jc * Jc, dim=1) for _, Jc in live]))


def make_sharded_lm_step(program, options, mesh):
    """(step_fn, shard): step_fn(x, radius) runs one LM linearize and
    solve (CGNR with block Jacobi) on this rank's rows, summing over the
    group of `mesh`; it returns the step's dict (cost, gradient norms,
    delta, model_cost_change, step_norm, lin_iters). Every rank calls
    it."""
    group = as_group(mesh)
    shard = _RowShard(program, group)
    n_eff = program.num_effective
    use_scaling = options.jacobi_scaling
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    offsets = [_slot_offsets(bk) for bk in program.buckets]

    def local_matvec(outs, v):
        """J^T J v summed over the ranks (one sum)."""
        parts = [torch.einsum("nrt,nr->nt", out[1], torch.einsum(
            "nrt,nt->nr", out[1], v[cols]))
            for out, cols in zip(outs, shard.cols) if out is not None]
        return group.sum(shard.col_sum(parts))[0]

    def step(x, radius):
        dev = x.device
        cost_local, outs = _local_linearize(program, x, shard)
        g_loc, cn_loc = _grad_and_norms(program, outs, shard, n_eff)
        cost, grad, col_norms = group.sum(cost_local, g_loc, cn_loc)
        cost = cost + program.fixed_cost
        scale = (1.0 / (1.0 + torch.sqrt(col_norms)) if use_scaling
                 else torch.ones_like(grad))
        diag = torch.clamp(col_norms * scale * scale, min_diag, max_diag)
        D2 = diag / radius
        b = -(grad * scale)

        # block Jacobi of J_s^T J_s + D^2: the groups' Gram blocks summed
        # over the ranks in one sum, inverted replicated
        grams = []
        for gm, gram_sum in zip(program.groups, shard.gram_sums):
            t = gm.tangent_size
            parts = []
            for (bi, var_si, _) in gm.bucket_slots:
                if outs[bi] is None:
                    continue
                Jc = outs[bi][1]
                off = offsets[bi][var_si]
                slot_cols = shard.cols[bi][:, off:off + t]
                Js = Jc[:, :, off:off + t] * scale[slot_cols][:, None, :]
                parts.append(torch.einsum("nrt,nru->ntu", Js, Js))
            grams.append(gram_sum(parts) if parts else torch.zeros(
                gm.num_blocks, t, t, dtype=program.dtype, device=dev))
        grams = group.sum(*grams)
        invs = []
        for gm, acc in zip(program.groups, grams):
            k, t = gm.num_blocks, gm.tangent_size
            d2 = D2[gm.tan_start:gm.tan_start + k * t].view(k, t)
            invs.append(spd_inv_small(acc + torch.diag_embed(d2)))

        def precond(v):
            return torch.cat([
                torch.einsum("ktu,ku->kt", inv, v[gm.tan_start:gm.tan_start
                                                  + gm.num_blocks
                                                  * gm.tangent_size].view(
                    gm.num_blocks, gm.tangent_size)).reshape(-1)
                for gm, inv in zip(program.groups, invs)])

        def apply_A(v):
            return local_matvec(outs, scale * v) * scale + D2 * v

        result = conjugate_gradients(
            apply_A, b, torch.zeros_like(b), apply_preconditioner=precond,
            max_iterations=options.max_linear_solver_iterations,
            q_tolerance=options.eta,
            min_iterations=options.min_linear_solver_iterations)
        d = result.x
        Jd_sq = torch.dot(d, local_matvec(outs, scale * d) * scale)
        mcc = -(torch.dot(d, -b) + 0.5 * Jd_sq)
        delta = scale * d
        return {
            "cost": cost,
            "gradient_max_norm": torch.max(torch.abs(grad)),
            "gradient_norm": torch.linalg.vector_norm(grad),
            "delta": delta,
            "model_cost_change": mcc,
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": result.num_iterations,
        }

    return step, shard


def make_sharded_cost_fn(program, mesh, shard):
    """cost(x): the total cost, this rank's rows summed over the group."""
    group = as_group(mesh)

    def cost(x):
        total = torch.zeros((), dtype=program.dtype, device=x.device)
        for view in shard.views:
            if view is None:
                continue
            r = program._bucket_residuals(view, x)
            c, _, _ = correct_residuals_and_jacobian(view.loss, r, None)
            total = total + torch.sum(c)
        return group.sum(total)[0] + program.fixed_cost

    return cost


def make_sharded_schur_step(program, options, mesh):
    """(step_fn, shard): one sharded DENSE_SCHUR LM step (ceres_tpu's
    make_sharded_schur_step): this rank's rows eliminated into partial
    E^T E, F^T F and A = E^T F (dense [ne, te, nf]) and the gradient, each
    summed over the group, the reduced camera system solved replicated
    (the library Cholesky), |J_s d|^2 summed. The step-level reference
    of the dry run and the tests."""
    from ..solvers.schur import detect_schur_structure
    meta = detect_schur_structure(program, options)
    if meta is None:
        raise ValueError("no Schur structure for sharded Schur step")
    group = as_group(mesh)
    shard = _RowShard(program, group)
    dev = program.device
    f64 = program.dtype
    n_eff = program.num_effective
    ne, te, nf = meta.ne, meta.te, meta.nf
    e_cols = torch.as_tensor(meta.e_cols.astype(np.int64), device=dev)
    f_global = torch.as_tensor(meta.f_global_cols.astype(np.int64),
                               device=dev)
    use_scaling = options.jacobi_scaling
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    offsets = [_slot_offsets(bk) for bk in program.buckets]
    # the fixed-order sums of E^T E blocks, F^T F entries and A entries
    # over this rank's rows, the buckets' parts in order
    e_t, f_t, a_t = [], [], []
    f_parts = []
    for bi, (bk, bs, rows) in enumerate(zip(program.buckets, meta.buckets,
                                            shard.rows)):
        f_parts.append([(offsets[bi][vs],
                         bk.slots[_abs_slot_of(bk, vs)].tangent_size)
                        for vs in bs.f_slots])
        if not rows.size:
            continue
        e_ids = bs.e_ids[rows].astype(np.int64) if bs.e_slot is not None \
            else None
        f_cols = bs.f_cols[rows].astype(np.int64) if bs.f_cols is not None \
            else None
        if e_ids is not None:
            e_t.append(e_ids)
        if f_cols is not None:
            f_t.append(f_cols[:, :, None] * nf + f_cols[:, None, :])
            if e_ids is not None:
                a_t.append((e_ids[:, None, None] * te
                            + np.arange(te)[None, :, None]) * nf
                           + f_cols[:, None, :])
    ete_sum = _segment_sum(e_t, ne, dev, (te, te))
    ftf_sum = _segment_sum(f_t, nf * nf, dev)
    a_sum = _segment_sum(a_t, ne * te * nf, dev)

    def step(x, radius):
        cost_local, outs = _local_linearize(program, x, shard)
        g_loc, cn_loc = _grad_and_norms(program, outs, shard, n_eff)
        cost, grad, col_norms = group.sum(cost_local, g_loc, cn_loc)
        cost = cost + program.fixed_cost
        scale = (1.0 / (1.0 + torch.sqrt(col_norms)) if use_scaling
                 else torch.ones_like(grad))
        diag = torch.clamp(col_norms * scale * scale, min_diag, max_diag)
        D2 = diag / radius
        b = -(grad * scale)
        b_e, b_f = b[e_cols], b[f_global]

        e_parts, f_gram, a_parts = [], [], []
        for bi, (out, cols, bs) in enumerate(zip(outs, shard.cols,
                                                 meta.buckets)):
            if out is None:
                continue
            Js = out[1] * scale[cols][:, None, :]
            Je = None
            if bs.e_slot is not None:
                off = offsets[bi][bs.e_slot]
                Je = Js[:, :, off:off + te]
                e_parts.append(torch.einsum("nrt,nru->ntu", Je, Je))
            if bs.f_cols is not None:
                Jf = torch.cat([Js[:, :, o:o + t] for o, t in f_parts[bi]],
                               dim=2)
                f_gram.append(torch.einsum("nrt,nru->ntu", Jf, Jf))
                if Je is not None:
                    a_parts.append(torch.einsum("nrt,nru->ntu", Je, Jf))
        zero = torch.zeros((), dtype=f64, device=dev)
        ete, FtF, A = group.sum(
            ete_sum(e_parts) if e_parts else zero.expand(ne, te, te),
            (ftf_sum(f_gram) if f_gram else zero.expand(nf * nf)).view(
                nf, nf),
            (a_sum(a_parts) if a_parts else zero.expand(ne * te * nf)).view(
                ne, te, nf))

        # the replicated reduced solve
        inv_ete = spd_inv_small(ete + torch.diag_embed(D2[e_cols]))
        B = torch.einsum("iuv,ivg->iug", inv_ete, A)
        S = FtF + torch.diag(D2[f_global]) - torch.einsum("itf,itg->fg", A,
                                                           B)
        rhs = b_f - torch.einsum("itf,it->f", A, torch.einsum(
            "iuv,iv->iu", inv_ete, b_e))
        y = cholesky_solve(S, rhs)
        d_e = torch.einsum("iuv,iv->iu", inv_ete,
                           b_e - torch.einsum("iuf,f->iu", A, y))
        d = torch.zeros(n_eff, dtype=f64, device=dev)
        d[f_global] = y
        d[e_cols.reshape(-1)] = d_e.reshape(-1)

        Jd_sq = torch.zeros((), dtype=f64, device=dev)
        for out, cols in zip(outs, shard.cols):
            if out is None:
                continue
            Js = out[1] * scale[cols][:, None, :]
            Jv = torch.einsum("nrt,nt->nr", Js, d[cols])
            Jd_sq = Jd_sq + torch.sum(Jv * Jv)
        Jd_sq = group.sum(Jd_sq)[0]
        mcc = -(torch.dot(d, -b) + 0.5 * Jd_sq)
        delta = scale * d
        return {
            "cost": cost,
            "gradient_max_norm": torch.max(torch.abs(grad)),
            "gradient_norm": torch.linalg.vector_norm(grad),
            "delta": delta,
            "model_cost_change": mcc,
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": torch.ones((), dtype=torch.int32, device=dev),
        }

    return step, shard


def _abs_slot_of(bk, var_si):
    """Absolute slot index of the var_si-th variable slot."""
    v = -1
    for si, sl in enumerate(bk.slots):
        if sl.variable:
            v += 1
            if v == var_si:
                return si
    raise IndexError(var_si)
