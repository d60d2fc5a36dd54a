"""The sharded fused Schur LM solve over a torch.distributed group.

Counterpart of ceres_tpu/parallel/sharded_fused.py. Residual rows shard
by e-block (point): rank r holds the chunks of points r * nloc ..
(r + 1) * nloc - 1, nloc = ne_pad / P, ne padded to a multiple of the
world size P with copies of point 0 under mask 0 (build_chunk_shards),
so every tensor indexed by points (the chunk Jacobians, E^T E, its
inverse, A = E^T F, g_e, the back-substitution) is shard-local; rows of
a bucket with no e slot shard in contiguous ranges. Every rank runs the
port's LM loop (minimizers/fused.py fused_tr_solve) unchanged, on a step
whose linearize, solve and cost reduce at the JAX package's exchange
points (parallel/group.py Group):
  psum #1 (linearize): F^T F, g_f and |g_e|^2 summed, max |g_e| by a max
          reduce; only then s_f and diag_f from the summed F^T F;
  psum #2 (solve): S_corr and the rhs part (explicit); in the implicit
          mode one [kf, tf] sum per CG application, the reduced rhs and
          SCHUR_JACOBI's correction instead;
  the norms: d.g, and |D d|^2 or |J d|^2 (or the Gram identity's terms);
  the e-part of the step, gathered in rank order;
  the cost of every candidate (and of x0).
The reduced camera solve runs replicated on every rank on the same bits
of S, so every LM and CG decision is the same on all of them.

Three steps, the one chosen from the configuration:
  ShardedExplicitStep: mixed, one bucket that the explicit fused step
    takes (solvers/schur_fused.py FusedSchurStep): K1 (Snavely) or K5 on
    the shard's chunks with its own camera plan, K2 (DENSE_SCHUR, te <= 3)
    or K6 and the replicated K7 (ITERATIVE_SCHUR), K3, and K4 for the
    shard's cost;
  ShardedImplicitStep: the implicit mode (ImplicitSchurStep, its work
    dtype f32 when mixed, the program's f64 otherwise): mixed, K11 on
    the shard's rows where a spec matches, K10 as the shard's CG
    operator for one e+f bucket and K4 for one Snavely bucket's cost;
    several buckets of kinds e, e0 and f, and f64, on the plain operator;
  ShardedGenericStep: the explicit mode where ShardedExplicitStep's
    kernels do not take the configuration (f64, several buckets, any
    functor, manifolds): the JAX package's shard-local pieces
    (lm_pieces, solve_body) in PyTorch on program.py's rows_linearize /
    rows_residuals with one-hot sums, K11 on an f32 bucket pass where a
    spec matches, K3 / K7 for an f32 reduced solve.
The JAX package forces the implicit mode with CERES_TPU_FORCE_IMPLICIT;
here `make_sharded_fused_solve(..., force_implicit=True)` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..loss import correct_residuals_and_jacobian
from ..minimizers.fused import FusedResult, fused_tr_solve
from ..ops.kernels import MAX_M, chol_solve
from ..ops.pcg import dense_pcg
from ..ops.cost import snavely_sq
from ..program import rows_loss
from ..solvers.dense import cholesky_solve
from ..solvers.preconditioners import spd_inv_small
from ..solvers.schur_fused import (
    FusedSchurStep, ImplicitSchurStep, KernelLimit, SchurStep, _BucketPlan,
    _FUSED_PRECONDITIONERS, _k10_bucket, _outer_rt, _spd_inv_e,
    cam_chunk_layout, chunk_has_dup_cams, detect_cross_bucket_dups,
    explicit_cg, precond_blocks, rvec_rt, unsupported_reason)
from ..types import LinearSolverType
from .group import Group, as_group


def _structure_ok(meta) -> bool:
    """ceres_tpu's fused_structure_ok(meta, require_onehots=False): one f
    group, the chunk layout on every e-bucket, one f slot per bucket with
    an f side."""
    if meta is None or len(meta.f_groups) != 1:
        return False
    grp = meta.f_groups[0]
    for bi, bs in enumerate(meta.buckets):
        if bs.e_slot is not None and bs.chunk_rows is None:
            return False
        if bs.f_cols is not None and \
                len([s for s in grp["slots"] if s[0] == bi]) != 1:
            return False
    return True


def sharded_fused_supported(program, options, meta, num_shards: int) -> bool:
    """Does the sharded fused solve serve this configuration? The
    structure (one f group, chunk layouts, one f slot a bucket), and
    ITERATIVE_SCHUR with IDENTITY, JACOBI or SCHUR_JACOBI and no SPSE
    (the explicit mode where it fits, the implicit one past it), or
    DENSE_SCHUR / SPARSE_SCHUR where the shard-local A and the
    replicated S fit."""
    if not _structure_ok(meta):
        return False
    lst = options.linear_solver_type
    if lst == LinearSolverType.ITERATIVE_SCHUR:
        return (options.preconditioner_type in _FUSED_PRECONDITIONERS
                and not options.use_spse_initialization)
    if lst in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR):
        return _sharded_explicit_viable(meta, num_shards)
    return False


def _sharded_explicit_viable(meta, num_shards: int) -> bool:
    """Shard-local A [ne/P, te, nf] and the replicated dense S
    affordable?"""
    return (meta.nf <= 4096
            and meta.ne * meta.te * meta.nf <= 1.5e8 * max(num_shards, 1))


def collective_footprint(meta, options, n_devices: int,
                         cg_iterations: int = 0,
                         dtype_bytes: int = 4) -> dict:
    """The JAX package's per-LM-iteration collective volume of the
    sharded fused solve, from the structure (a copy of ceres_tpu's
    collective_footprint): explicit mode psum #1 (cost, F^T F block
    diagonal, g_f, two e-gradient stats), psum #2 (S correction and rhs),
    the norms (3), the candidate cost (1) and the gather of the e-part
    [ne, te]; the implicit mode one [kf, tf] psum per CG application and
    the reduced rhs instead of psum #2. Bytes are the logical payload a
    device a collective. One f group only."""
    assert len(meta.f_groups) == 1, (
        "collective_footprint is exact only for the single-f-group "
        "structure the sharded fused path supports")
    grp = meta.f_groups[0]
    kf, tf, ne, te = grp["kf"], grp["t"], meta.ne, meta.te
    nf = kf * tf
    iterative = (options is not None and options.linear_solver_type
                 == LinearSolverType.ITERATIVE_SCHUR)
    psum1 = (1 + kf * tf * tf + kf * tf + 2) * dtype_bytes
    norms = 3 * dtype_bytes
    cand = 1 * dtype_bytes
    gather = ne * te * dtype_bytes
    out = {"n_devices": int(n_devices), "ne": ne, "nf": nf}
    if iterative and cg_iterations:
        per_cg = kf * tf * dtype_bytes
        out.update(psum_count=3 + 1 + cg_iterations,
                   psum_bytes=psum1 + norms + cand
                   + (1 + cg_iterations) * per_cg,
                   allgather_count=1, allgather_bytes=gather)
    else:
        psum2 = (nf * nf + nf) * dtype_bytes
        out.update(psum_count=4, psum_bytes=psum1 + psum2 + norms + cand,
                   allgather_count=1, allgather_bytes=gather)
    out["total_bytes"] = out["psum_bytes"] + out["allgather_bytes"]
    return out


# ----------------------------------------------------------------------
# shard layouts (numpy, once a program; ceres_tpu's build_chunk_shards)

def _cam_chunks_per_shard(fids, mask, kf: int, num_shards: int):
    """The camera-chunk layout of each shard's rows: (rows, cmask)
    [num_shards * kf, kc], rank s's [kf, kc] block holding positions into
    its own rows (flattened), kc the most rows of one camera on any
    shard; padded lanes point at 0 under mask 0."""
    fids = np.asarray(fids)
    mask = np.asarray(mask)
    nloc = fids.shape[0] // num_shards
    per = []
    kc = 1
    for s in range(num_shards):
        f = fids[s * nloc:(s + 1) * nloc].reshape(-1)
        m = mask[s * nloc:(s + 1) * nloc].reshape(-1) > 0
        idx = np.nonzero(m)[0]
        cams = f[idx].astype(np.int64)
        if cams.size:
            kc = max(kc, int(np.bincount(cams, minlength=kf).max()))
        per.append((idx, cams))
    rows = np.zeros((num_shards, kf, kc), np.int32)
    cmask = np.zeros((num_shards, kf, kc), np.float32)
    for s, (idx, cams) in enumerate(per):
        r, m = cam_chunk_layout(cams, idx, kf)
        rows[s, :, :r.shape[1]], cmask[s, :, :m.shape[1]] = r, m
    return (rows.reshape(num_shards * kf, kc),
            cmask.reshape(num_shards * kf, kc))


def _pad_rows(a, n_pad):
    """a [n, ...] with copies of a[0] appended to n_pad rows."""
    if a.shape[0] == n_pad:
        return a
    return np.concatenate([a, np.repeat(a[:1], n_pad - a.shape[0], axis=0)])


def shard_rows(program, meta, num_shards: int):
    """The row layout of build_chunk_shards: per bucket a dict with
    "kind" ("e", "e0", "f"), "rows" (the bucket row of each lane: [ne_pad,
    k] for e-buckets, [n_pad] otherwise), "mask" and, with an f side,
    "f_ids" (each lane's f block), and ne_pad."""
    ne_pad = int(math.ceil(max(meta.ne, 1) / num_shards) * num_shards)
    grp = meta.f_groups[0]
    out = []
    for bi, (bk, bs) in enumerate(zip(program.buckets, meta.buckets)):
        local = [s[2] for s in grp["slots"] if s[0] == bi]
        if bs.e_slot is not None:
            entry = {"kind": "e" if bs.f_cols is not None else "e0",
                     "rows": _pad_rows(bs.chunk_rows, ne_pad),
                     "mask": np.concatenate([bs.chunk_mask, np.zeros(
                         (ne_pad - meta.ne, bs.chunk_mask.shape[1]),
                         bs.chunk_mask.dtype)])}
        else:
            n_pad = int(math.ceil(max(bk.n, 1) / num_shards) * num_shards)
            mask = np.zeros(n_pad)
            mask[:bk.n] = 1.0
            entry = {"kind": "f",
                     "rows": _pad_rows(np.arange(bk.n, dtype=np.int32),
                                      n_pad),
                     "mask": mask}
        if bs.f_cols is not None:
            if len(local) != 1:
                raise ValueError(f"sharded fused path: bucket {bi} must "
                                 f"have exactly one f slot (got "
                                 f"{len(local)})")
            entry["f_ids"] = np.asarray(local[0])[entry["rows"]].astype(
                np.int32)
        out.append(entry)
    return out, ne_pad


def _amb_idx(program, sl):
    """The ambient indices [n, size] of a slot's blocks (ceres_tpu's
    sl.amb_idx)."""
    start, _, size = program.amb_slabs[sl.amb_gid]
    local = sl.amb_local.cpu().numpy()
    return (start + local[:, None] * size
            + np.arange(size)[None, :]).astype(np.int32)


def build_chunk_shards(program, meta, num_shards: int,
                       cam_chunks: bool = False):
    """Per-bucket row data in chunk order, padded so the e-block axis
    divides the shard count (ceres_tpu's build_chunk_shards, whose arrays
    these equal): a list of dicts of numpy arrays whose leading axis
    shards ("data", "amb", "mask", "f_ids"; with cam_chunks the implicit
    mode's "cam_rows" / "cam_mask" [num_shards * kf, kc]; "loss_attrs"
    where the bucket has per-row loss scalars), and ne_pad."""
    layout, ne_pad = shard_rows(program, meta, num_shards)
    kf = meta.f_groups[0]["kf"]
    shards = []
    for bk, lay in zip(program.buckets, layout):
        rows = lay["rows"]
        entry = {"kind": lay["kind"]}
        entry["data"] = ({k: v.cpu().numpy()[rows]
                          for k, v in bk.data.items()} if bk.data else ())
        entry["amb"] = tuple(_amb_idx(program, sl)[rows] for sl in bk.slots)
        entry["mask"] = lay["mask"]
        if bk.loss_attrs is not None:
            entry["loss_attrs"] = {k: v[rows]
                                   for k, v in bk.loss_attrs.items()}
        if "f_ids" in lay:
            entry["f_ids"] = lay["f_ids"]
            if cam_chunks:
                entry["cam_rows"], entry["cam_mask"] = \
                    _cam_chunks_per_shard(lay["f_ids"], lay["mask"], kf,
                                          num_shards)
        shards.append(entry)
    return shards, ne_pad


# the result of a sharded solve: the fused loop's (x, cost, initial_cost,
# iterations, successful_steps, unsuccessful_steps, termination_code,
# gradient_max_norm, total_linear_iterations, linearizations)
ShardedFusedResult = FusedResult


# ----------------------------------------------------------------------
# a rank's rows

def bucket_rows(bk, rows: np.ndarray):
    """Bucket `bk` restricted to `rows` (in that order), as a bucket that
    CompiledProgram's evaluation reads: its slots' block indices, its
    data, its per-row loss scalars and K11's data matrix taken at the
    rows."""
    out = object.__new__(type(bk))
    for name in type(bk).__slots__:
        if hasattr(bk, name):
            setattr(out, name, getattr(bk, name))
    idx = torch.as_tensor(np.asarray(rows, np.int64),
                          device=bk.slots[0].amb_local.device)
    out.n = int(idx.numel())
    out.data = {k: v[idx] for k, v in bk.data.items()}
    out.dat32 = None if bk.dat32 is None else bk.dat32[idx].contiguous()
    out.orig_indices = bk.orig_indices[np.asarray(rows, np.int64)]
    if bk.loss_attrs is not None:
        out.loss_attrs = {k: v[np.asarray(rows, np.int64)]
                          for k, v in bk.loss_attrs.items()}
        out.loss = rows_loss(bk.loss_proto, out.loss_attrs,
                             device=idx.device)
    slots = []
    for sl in bk.slots:
        s2 = object.__new__(type(sl))
        for name in type(sl).__slots__:
            if hasattr(sl, name):
                setattr(s2, name, getattr(sl, name))
        s2.amb_local = sl.amb_local[idx]
        if sl.cols is not None:
            s2.cols = sl.cols[np.asarray(rows, np.int64)]
            s2.cols_t = sl.cols_t[idx]
        slots.append(s2)
    out.slots = slots
    return out


class _Shard:
    """This rank's part of the layout: points lo .. lo + nloc - 1 of the
    padded point axis, and per bucket its rows: the chunk lanes [nloc, k]
    of an e-bucket, the valid rows of its range of an f-only bucket (the
    padded rows trail the last ranges and are left out)."""

    def __init__(self, program, meta, group: Group, cam_chunks: bool):
        self.P, self.rank = group.size, group.rank
        self.layout, self.ne_pad = shard_rows(program, meta, self.P)
        self.nloc = self.ne_pad // self.P
        self.lo = self.rank * self.nloc
        kf = meta.f_groups[0]["kf"]
        self.buckets = []
        for bk, lay in zip(program.buckets, self.layout):
            n_all = lay["rows"].shape[0]
            per = n_all // self.P
            sl = slice(self.rank * per, (self.rank + 1) * per)
            rows, mask = lay["rows"][sl], lay["mask"][sl]
            if lay["kind"] == "f":
                keep = mask > 0
                rows, mask = rows[keep], mask[keep]
            entry = {"kind": lay["kind"], "rows": rows,
                     "mask": np.asarray(mask, np.float32)}
            if "f_ids" in lay:
                entry["f_ids"] = lay["f_ids"][sl][:rows.shape[0]]
                if cam_chunks:
                    camr, camm = _cam_chunks_per_shard(
                        lay["f_ids"], lay["mask"], kf, self.P)
                    entry["camr"] = camr[self.rank * kf:(self.rank + 1) * kf]
                    entry["camm"] = camm[self.rank * kf:(self.rank + 1) * kf]
            entry["view"] = bucket_rows(bk, rows.reshape(-1))
            self.buckets.append(entry)
        # the state entries of this rank's points (padded points read
        # point 0, as their chunks copy point 0's rows)
        pts = np.arange(self.lo, self.lo + self.nloc)
        self.points = np.where(pts < meta.ne, pts, 0)

    def valid_rows(self, bi):
        """The bucket rows of this rank that are real (unpadded)."""
        b = self.buckets[bi]
        return b["rows"].reshape(-1)[b["mask"].reshape(-1) > 0]


def _views_cost(program, shard, x):
    """This rank's part of the cost: each bucket's real rows, in f64."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for b in shard.buckets:
        r = program._bucket_residuals(b["view"], x)
        m = torch.as_tensor(b["mask"].reshape(-1), device=x.device)
        cost, _, _ = correct_residuals_and_jacobian(
            b["view"].loss, r * m.to(r.dtype)[:, None], None)
        total = total + torch.sum(cost)
    return total


def _shard_plans(program, meta, shard):
    """One ImplicitSchurStep plan a bucket on this rank's view: its kind,
    slot offsets, identity chunk rows and mask (e-kinds), f block of each
    lane, camera-chunk layout (where the shard has one) and, over every
    rank's chunks as in the JAX package, whether a chunk sees a camera
    twice; and the e-buckets' (f ids, valid) for detect_cross_bucket_dups."""
    dev = program.device

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    plans, e_entries = [], []
    for bk, bs, b, lay in zip(program.buckets, meta.buckets, shard.buckets,
                              shard.layout):
        var = [s for s in bk.slots if s.variable]
        offs = np.cumsum([0] + [s.tangent_size for s in var])
        p = _BucketPlan()
        p.bk, p.kind = b["view"], b["kind"]
        p.eo = int(offs[bs.e_slot]) if bs.e_slot is not None else None
        p.fo = int(offs[bs.f_slots[0]]) if bs.f_slots else None
        p.rows = p.mask = p.fids = p.fids32 = p.camr = p.camm = None
        p.dup = False
        if "camr" in b:
            p.camr, p.camm = on_dev(b["camr"], torch.long), on_dev(b["camm"])
        if p.kind != "f":
            k = b["rows"].shape[1]
            p.rows = torch.arange(shard.nloc * k, device=dev).view(
                shard.nloc, k)
            p.mask = on_dev(b["mask"], torch.float32)
        if "f_ids" in b:
            p.fids = on_dev(b["f_ids"], torch.long)
            p.fids32 = on_dev(b["f_ids"], torch.int32)
        if p.kind == "e":
            p.dup = chunk_has_dup_cams(lay["f_ids"], lay["mask"])
            e_entries.append((lay["f_ids"], lay["mask"] > 0))
        plans.append(p)
    return plans, e_entries


class ShardedExplicitStep(FusedSchurStep):
    """FusedSchurStep on this rank's points: K1 or K5 on the shard's
    chunks (its own camera plan), K2 or K6 on its A, K3 or K7 on the
    summed S, K4 on its rows; `red` the group."""

    def __init__(self, program, options, meta, group: Group):
        self.shard = _Shard(program, meta, group, cam_chunks=False)
        self.red = group
        self._viable = _sharded_explicit_viable(meta, group.size)
        super().__init__(program, options, meta)
        sh = self.shard
        self.ne = sh.nloc
        te = self.te
        self.e_index = torch.as_tensor(
            (self.e_slab + te * sh.points[:, None]
             + np.arange(te)[None, :]).reshape(-1), device=program.device)
        self.mode += (f"; sharded over {group.size} ranks "
                      f"({group.backend}), {sh.nloc} points a rank")

    def _unsupported(self, program, options, meta):
        return unsupported_reason(program, options, meta, implicit=False,
                                  viable=self._viable)

    def _chunks(self):
        b = self.shard.buckets[0]
        return b["rows"], b["mask"]

    def _k4_rows(self):
        return self.shard.valid_rows(0)

    def point_state(self, x):
        return x[self.e_index].view(self.ne, self.te)

    def linearize(self, x, s_e, s_f, first: bool, known_cost=None):
        if known_cost is None:
            known_cost = self.cost(x)
        return super().linearize(x, s_e, s_f, first, known_cost=known_cost)

    def cost(self, x):
        if self.k4 is None:
            local = _views_cost(self.program, self.shard, x)
        else:
            sq = snavely_sq(x, self.k4)
            rho = sq if self.k4_loss is None else self.k4_loss.evaluate(
                sq)[0]
            local = 0.5 * torch.sum(rho)
        return self.program.fixed_cost + self.red.sum(local)[0]


def _placed_delta(program, e_cols, fpos, d_e, d_f):
    """The f64 step [num_effective]: the points' part [ne, te] at their
    columns e_cols, the cameras' [nf] at fpos (any state layout)."""
    delta = torch.zeros(program.num_effective, dtype=torch.float64,
                        device=program.device)
    delta[e_cols.reshape(-1)] = d_e.double().reshape(-1)
    delta[fpos] = d_f.double().reshape(-1)
    return delta


def _layout_columns(program, meta):
    """(e_cols, fpos): the state columns of the points and the cameras."""
    grp = meta.f_groups[0]
    return (torch.as_tensor(meta.e_cols.astype(np.int64),
                            device=program.device),
            torch.as_tensor(meta.f_global_cols[grp["cols"]].reshape(-1)
                            .astype(np.int64), device=program.device))


class ShardedImplicitStep(ImplicitSchurStep):
    """ImplicitSchurStep on this rank's rows: each bucket's plan on its
    shard view, the rank's camera-chunk layouts; `red` the group. Mixed,
    K11 on the shard's rows where a spec matches, K10 on its chunks for
    one e+f bucket and K4 on its rows of one Snavely bucket in the
    [points | cameras] layout; f64 (`work` the program's dtype), the
    plain operator and the program's cost. The step lands in any state
    layout (constant blocks, manifolds)."""

    def __init__(self, program, options, meta, group: Group):
        reason = unsupported_reason(program, options, meta, implicit=True)
        if isinstance(reason, KernelLimit):
            raise NotImplementedError(f"not in the ported slice: {reason}")
        self.shard = sh = _Shard(program, meta, group, cam_chunks=True)
        self.red = group
        SchurStep.__init__(self, program, options, meta)
        if not options.use_mixed_precision_solves:
            self.work = program.dtype
        self.ne = sh.nloc
        self.plans, e_entries = _shard_plans(program, meta, sh)
        self.k10 = (_k10_bucket(program, meta)
                    and self.work == torch.float32)
        self.cross_pairs = detect_cross_bucket_dups(e_entries)
        self.e_cols, self.fpos = _layout_columns(program, meta)
        self.mode = ("implicit (matrix-free) Schur complement, CG operator "
                     + ("K10" if self.k10 else "in plain PyTorch over "
                        f"{len(self.plans)} buckets")
                     + ("" if self.work == torch.float32 else ", f64")
                     + f"; sharded over {group.size} ranks "
                     f"({group.backend}), {sh.nloc} points a rank")
        SchurStep._bind_data(self, program)
        if reason is not None:
            self.k4 = None   # K4: a mixed step in [points | cameras] only

    def _k4_rows(self):
        return self.shard.valid_rows(0)

    def step_delta(self, d_e, d_f):
        d_e = self.red.gather_rows(d_e.double())[:self.meta.ne]
        return _placed_delta(self.program, self.e_cols, self.fpos, d_e, d_f)

    def linearize(self, x, s_e_in, s_f_in, first: bool, known_cost=None):
        if known_cost is None:
            known_cost = self.cost(x)
        return super().linearize(x, s_e_in, s_f_in, first,
                                 known_cost=known_cost)

    cost = ShardedExplicitStep.cost


class _GenericLin(NamedTuple):
    """Radius-independent artifacts of ShardedGenericStep.linearize."""
    cost: torch.Tensor
    EtE_s: torch.Tensor         # [nloc, te, te] scaled point Grams
    FtF_s: torch.Tensor         # [kf, tf, tf] scaled camera Grams (summed)
    g_se: torch.Tensor          # [nloc, te]
    g_sf: torch.Tensor          # [nf]
    diag_e: torch.Tensor
    diag_f: torch.Tensor
    s_e: torch.Tensor
    s_f: torch.Tensor
    A_s: torch.Tensor           # [nloc, te, nf] scaled cross tensor
    store: list                 # (kind, Je or None, Jf or None, one-hot)
    #                             unscaled
    grad_max: torch.Tensor
    grad_norm: torch.Tensor

    @property
    def scales(self):
        return (self.s_e, self.s_f)


class ShardedGenericStep:
    """The explicit mode of the JAX package's sharded fused step
    (lm_pieces and solve_body, ceres_tpu/parallel/sharded_fused.py
    :400-771) in PyTorch where ShardedExplicitStep's kernels do not take
    the configuration (f64, several buckets, any functor, any state
    layout): the shard's A by one-hot sums, the replicated S, in the
    program's dtype (f64) or mixed (f32 Jacobians, Grams and solve).
    With fused_tr_solve's step protocol."""

    def __init__(self, program, options, meta, group: Group):
        self.program, self.meta, self.red = program, meta, group
        self.shard = sh = _Shard(program, meta, group, cam_chunks=False)
        self.iterative = (options.linear_solver_type
                          == LinearSolverType.ITERATIVE_SCHUR)
        self.mixed = bool(options.use_mixed_precision_solves)
        self.work = torch.float32 if self.mixed else program.dtype
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.preconditioner = options.preconditioner_type
        self.pcg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)
        grp = meta.f_groups[0]
        self.ne, self.te, self.kf, self.tf = meta.ne, meta.te, grp["kf"], \
            grp["t"]
        self.nf = self.kf * self.tf
        self.nloc = sh.nloc
        self.device = program.device
        self.e_cols, self.fpos = _layout_columns(program, meta)
        self.plans, _ = _shard_plans(program, meta, sh)
        self.library = self.nf > MAX_M
        solve = ("CG on the explicit S (solvers/cg.py)"
                 if self.iterative and (self.library or not self.mixed)
                 else "K7 dense_pcg" if self.iterative else
                 "library Cholesky (torch.linalg.cholesky_ex)"
                 if self.library or not self.mixed else "K3 chol_solve")
        nb = len(self.plans)
        self.mode = (f"explicit reduced camera matrix, shard-local A, "
                     f"reduced solve: {solve}, m = {self.nf}; {'mixed' if self.mixed else 'f64'}, "
                      f"{nb} bucket{'s' if nb != 1 else ''}, sharded over "
                      f"{group.size} ranks ({group.backend}), {sh.nloc} "
                      f"points a rank")

    def initial_scales(self):
        return (torch.ones(self.nloc, self.te, dtype=self.work,
                           device=self.device),
                torch.ones(self.kf, self.tf, dtype=self.work,
                           device=self.device))

    def cost(self, x):
        local = _views_cost(self.program, self.shard, x)
        return self.program.fixed_cost + self.red.sum(local)[0]

    def _pieces(self, x):
        """lm_pieces: the shard's E^T E, g_e, partial F^T F, g_f, A and
        the chunk tensors (pad lanes masked to zero)."""
        program, work, dev = self.program, self.work, self.device
        nloc, te, kf, tf = self.nloc, self.te, self.kf, self.tf
        EtE = torch.zeros(nloc, te, te, dtype=work, device=dev)
        g_e = torch.zeros(nloc, te, dtype=work, device=dev)
        FtF = torch.zeros(kf, tf, tf, dtype=work, device=dev)
        g_f = torch.zeros(kf, tf, dtype=work, device=dev)
        A = torch.zeros(nloc, te, kf * tf, dtype=work, device=dev)
        store = []
        for p in self.plans:
            bk = p.bk
            if p.kind in ("e", "e0"):
                nl, k = p.mask.shape
                rmask = p.mask.reshape(-1).to(program.dtype)
                if self.mixed:
                    r64 = program._bucket_residuals(bk, x) * rmask[:, None]
                    J32 = program._bucket_linearize(bk, x, torch.float32)[1]
                    _, rc, Jc = correct_residuals_and_jacobian(
                        bk.loss, r64.to(work),
                        J32.to(torch.float32)
                        * rmask.to(torch.float32)[:, None, None])
                else:
                    r, J = program._bucket_linearize(bk, x, program.dtype)
                    _, rc, Jc = correct_residuals_and_jacobian(
                        bk.loss, r * rmask[:, None],
                        J * rmask[:, None, None])
                rr = Jc.shape[1]
                Jg = Jc.reshape(nl, k, rr, -1).to(work)
                rg = rc.reshape(nl, k, rr).to(work)
                Je = Jg[..., p.eo:p.eo + te]
                EtE = EtE + torch.sum(_outer_rt(Je, Je), dim=1)
                g_e = g_e + torch.sum(rvec_rt(Je, rg), dim=1)
                if p.kind == "e0":
                    store.append(("e0", Je, None, None))
                    continue
                Jf = Jg[..., p.fo:p.fo + tf]
                oh = torch.nn.functional.one_hot(p.fids, kf).to(work) \
                    * p.mask[..., None].to(work)
                FtF = FtF + torch.einsum("nkc,nktu->ctu", oh,
                                         _outer_rt(Jf, Jf))
                g_f = g_f + torch.einsum("nkc,nkt->ct", oh, rvec_rt(Jf, rg))
                A = A + torch.einsum("nkc,nkut->nuct", oh,
                                     _outer_rt(Je, Jf)).reshape(
                                         nl, te, kf * tf)
                store.append(("e", Je, Jf, oh))
            else:
                r, J = program._bucket_linearize(bk, x, program.dtype)
                _, rc, Jc = correct_residuals_and_jacobian(bk.loss, r, J)
                rc, Jc = rc.to(work), Jc.to(work)
                Jf = Jc[..., p.fo:p.fo + tf]
                oh = torch.nn.functional.one_hot(p.fids, kf).to(work)
                FtF = FtF + torch.einsum("nc,ntu->ctu", oh, _outer_rt(Jf, Jf))
                g_f = g_f + torch.einsum("nc,nt->ct", oh, rvec_rt(Jf, rc))
                store.append(("f", None, Jf, oh))
        return EtE, g_e, FtF, g_f, A, store

    def linearize(self, x, s_e_in, s_f_in, first: bool, known_cost=None):
        """lm_pieces, psum #1 and the radius-free half of solve_body."""
        if known_cost is None:
            known_cost = self.cost(x)
        EtE, g_e, FtF, g_f, A, store = self._pieces(x)
        ge_max = g_e.abs().max()
        ge_sq = torch.dot(g_e.reshape(-1), g_e.reshape(-1))
        FtF, g_f, ge_sq = self.red.sum(FtF, g_f, ge_sq)      # psum #1
        ge_max = self.red.max(ge_max)
        cn_e = torch.diagonal(EtE, dim1=-2, dim2=-1)
        cn_f = torch.diagonal(FtF, dim1=-2, dim2=-1)
        s_e, s_f = s_e_in, s_f_in
        if self.use_scaling and first:
            s_e = 1.0 / (1.0 + torch.sqrt(cn_e))
            s_f = 1.0 / (1.0 + torch.sqrt(cn_f))
        sA = s_f.reshape(-1)
        gf_flat = g_f.reshape(-1)
        return _GenericLin(
            cost=known_cost,
            EtE_s=EtE * (s_e[:, :, None] * s_e[:, None, :]),
            FtF_s=FtF * (s_f[:, :, None] * s_f[:, None, :]),
            g_se=g_e * s_e, g_sf=(g_f * s_f).reshape(-1),
            diag_e=torch.clamp(s_e * s_e * cn_e, self.min_diag,
                               self.max_diag),
            diag_f=torch.clamp(s_f * s_f * cn_f, self.min_diag,
                               self.max_diag),
            s_e=s_e, s_f=s_f,
            A_s=A * s_e[:, :, None] * sA[None, None, :], store=store,
            grad_max=torch.maximum(ge_max, gf_flat.abs().max()).to(
                self.program.dtype),
            grad_norm=torch.sqrt(ge_sq + torch.dot(gf_flat, gf_flat)).to(
                self.program.dtype))

    def _reduced_solve(self, S, rhs, P_blocks):
        """y with S y = rhs, replicated: the direct solve (K3 up to MAX_M
        in f32, else the library Cholesky) or the explicit CG (K7 up to
        MAX_M in f32, else solvers/cg.py); (y, iterations)."""
        f32 = self.work == torch.float32 and not self.library
        if not self.iterative:
            y = chol_solve(S, rhs) if f32 else cholesky_solve(S, rhs)
            return y, torch.ones((), dtype=torch.int32, device=self.device)
        blocks = precond_blocks(P_blocks, S, self.kf, self.tf,
                                self.preconditioner)
        minv = None if blocks is None else spd_inv_small(blocks).contiguous()
        if f32:
            y, it, _ = dense_pcg(S.contiguous(), rhs.contiguous(), minv,
                                 **self.pcg_args)
            return y, it
        return explicit_cg(S, rhs, minv, **self.pcg_args)

    def solve(self, art: _GenericLin, radius: float) -> dict:
        """solve_body's radius-dependent half."""
        work, dev = self.work, self.device
        kf, tf, nf = self.kf, self.tf, self.nf
        rad = torch.tensor(radius, dtype=self.program.dtype).to(work).to(dev)
        D2_e, D2_f = art.diag_e / rad, art.diag_f / rad
        inv = _spd_inv_e(art.EtE_s + torch.diag_embed(D2_e))
        b_e, b_f = -art.g_se, -art.g_sf
        z = torch.einsum("nij,nj->ni", inv, b_e)
        A_s = art.A_s
        rhs_corr = torch.einsum("nuf,nu->f", A_s, z)
        Y = torch.einsum("nuv,nvf->nuf", inv, A_s)
        S_corr = torch.einsum("nuf,nug->fg", A_s, Y)
        S_corr, rhs_corr = self.red.sum(S_corr, rhs_corr)      # psum #2
        rhs = b_f - rhs_corr
        S = (-S_corr).view(kf, tf, kf, tf)
        ii = torch.arange(kf, device=dev)
        P_blocks = art.FtF_s + torch.diag_embed(D2_f)
        S[ii, :, ii, :] += P_blocks
        S = S.view(nf, nf)
        y, lin_iters = self._reduced_solve(S, rhs, P_blocks)
        d_e = torch.einsum("nij,nj->ni", inv,
                           b_e - torch.einsum("nuf,f->nu", A_s, y))

        d_dot_g_loc = torch.dot(d_e.reshape(-1), art.g_se.reshape(-1))
        if self.mixed and not self.iterative:
            # the exact direct solve: ||J_s d||^2 = -d.g - ||D d||^2
            d_dot_g_e, Dd_sq_e = self.red.sum(
                d_dot_g_loc, torch.sum(D2_e * d_e * d_e))
            d_dot_g = d_dot_g_e + torch.dot(y, art.g_sf)
            Jd_sq = -d_dot_g - (Dd_sq_e + torch.sum(D2_f.reshape(nf) * y * y))
        else:
            # ||J_s d||^2 from the shard's unscaled chunk tensors
            dw_e = art.s_e * d_e
            dw_fb = (art.s_f.reshape(nf) * y).view(kf, tf)
            Jd_sq_loc = torch.zeros((), dtype=work, device=dev)
            for kind, Ja, Jb, oh in art.store:
                if kind == "e":
                    Jd = torch.einsum("nkrt,nt->nkr", Ja, dw_e) \
                        + torch.einsum("nkrt,nkt->nkr", Jb, torch.einsum(
                            "nkc,ct->nkt", oh, dw_fb))
                elif kind == "e0":
                    Jd = torch.einsum("nkrt,nt->nkr", Ja, dw_e)
                else:
                    Jd = torch.einsum("nrt,nt->nr", Jb, torch.einsum(
                        "nc,ct->nt", oh, dw_fb))
                Jd_sq_loc = Jd_sq_loc + torch.sum(Jd * Jd)
            d_dot_g_e, Jd_sq = self.red.sum(d_dot_g_loc, Jd_sq_loc)
            d_dot_g = d_dot_g_e + torch.dot(y, art.g_sf)
        mcc = -(d_dot_g + 0.5 * Jd_sq)

        # the global step: the e-part gathered in rank order
        f64 = self.program.dtype
        delta_e = self.red.gather_rows((art.s_e * d_e).to(f64))[:self.ne]
        delta = _placed_delta(self.program, self.e_cols, self.fpos, delta_e,
                              art.s_f.reshape(nf) * y)
        return {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.to(f64),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": lin_iters,
        }


def sharded_step(program, options, meta, group: Group,
                 force_implicit: bool = False):
    """The rank's step of the sharded fused solve (see the module
    docstring): ShardedImplicitStep in the implicit mode; in the
    explicit one ShardedExplicitStep where the single-device fused
    step's kernels take the configuration, else ShardedGenericStep. A
    configuration that only a port kernel's limit keeps from its kernel
    raises, as on one device."""
    iterative = options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR
    viable = _sharded_explicit_viable(meta, group.size)
    if iterative and (force_implicit or not viable):
        return ShardedImplicitStep(program, options, meta, group)
    reason = unsupported_reason(program, options, meta, implicit=False,
                                viable=viable)
    if isinstance(reason, KernelLimit):
        raise NotImplementedError(f"not in the ported slice: {reason}")
    if reason is None:
        return ShardedExplicitStep(program, options, meta, group)
    return ShardedGenericStep(program, options, meta, group)


def make_sharded_fused_solve(program, options, meta, mesh,
                             force_implicit: bool = False):
    """(run, step): run(x0) -> ShardedFusedResult runs the whole LM loop
    of this rank over the group of `mesh` (SolverOptions.mesh's forms);
    step is the rank's step (its `mode` names the route). Every rank of
    the group calls it with the same arguments. force_implicit runs
    ITERATIVE_SCHUR in the implicit mode where the explicit one fits
    (the JAX package's CERES_TPU_FORCE_IMPLICIT)."""
    group = as_group(mesh)
    step = sharded_step(program, options, meta, group, force_implicit)

    def run(x0) -> ShardedFusedResult:
        return fused_tr_solve(program, options, step, x0)

    return run, step
