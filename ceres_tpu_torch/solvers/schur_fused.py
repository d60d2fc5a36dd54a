"""Fused Schur LM steps for bundle adjustment (mixed precision):
FusedSchurStep, DENSE_SCHUR (and SPARSE_SCHUR below
solvers/schur_sparse.py's dense cap) and ITERATIVE_SCHUR on an explicit
reduced camera matrix S, for one bucket of two slots (the Snavely
functor through K1, any functor that the jet compiler traces through
K5); ImplicitSchurStep,
ITERATIVE_SCHUR in the implicit (matrix-free) mode for any functor with
the [points | cameras] layout; `schur_step` picks one of them.

Counterpart of ceres_tpu/solvers/schur_fused.py (make_fused_schur_lm_step
with the Pallas lin phase, :386-416; _lin_phase_pallas, :477-554; the
plane-mode DENSE solve, _solve_phase_planes, :1121-1175; the explicit
iterative branch of _solve_phase, :797-886 and :1040-1116;
_spd_solve_dense, :221; _spd_inv_small, :180; the preconditioner blocks,
:1340-1374). The state is f64; the linearization, the Grams, the
elimination and the reduced solve run in f32 and cast back at the same
places as the JAX package:

  linearize (radius-independent, once per accepted step):
    K1 (Snavely) or K5 (any other traced functor, ops/lin_auto.py) ->
    E^T E, g_e, s_e, A = (s_e E)^T F, F^T F, g_f;
    the scaled point Grams, the clipped diagonal, the scaled camera Grams.
  solve (once per damped trial), DENSE_SCHUR:
    K2 -> S_corr, rhs part, inv, z;  S = blockdiag(F^T F_s + D_f^2) - S_corr;
    K3 -> y (m = nf <= MAX_M; past it the library Cholesky, where the
    JAX package takes XLA's cho_factor; NaN for an indefinite S either
    way);  back-substitution d_e = inv (b_e - A y);  the model cost
    change from the exact direct solve, ||J_s d||^2 = d.b - ||D d||^2.
  solve, ITERATIVE_SCHUR:
    inv = (E^T E_s + D_e^2)^-1, z = inv b_e in PyTorch;
    K6 -> S_corr, rhs part from inv and z;  S as above;
    the preconditioner's inverted diagonal blocks (IDENTITY, JACOBI or
    SCHUR_JACOBI); K7 -> y and the CG iteration count (m <= MAX_M;
    past it `explicit_cg`, solvers/cg.py on the dense S);  the same
    back-substitution; ||J_s d||^2 from the Gram identity
    d_e^T E^T E_s d_e + 2 d_e.(A y) + y^T blockdiag(F^T F_s) y, since
    an inexact CG step breaks the direct solve's identity.
  cost (every candidate): K4 -> f64 ||r||^2 per observation; rho and the
    sum in f64 (Snavely); the program's f64 residual pass otherwise, as
    the JAX package prices candidates (pallas_cost.py:229-233).

The implicit mode (ceres_tpu's _lin_phase_generic implicit branches,
:556-795, and _solve_phase's implicit branch, :887-1038, :1059-1092)
runs where S and A = E^T F are too large to form (_explicit_viable):
  linearize: per bucket the f64 residual pass, the f32 Jacobian (K11
    where a hand or auto spec matches, Snavely's hand spec and the
    quaternion functor's auto spec among them; else jacfwd), the
    loss correction and the chunk gather; E^T E, g_e, and F^T F, g_f
    by camera-chunk gather and sum; the scales and scaled Grams as above;
    the unscaled chunk tensors Je [ne, k, r, te], Jf [ne, k, r, tf] kept.
  solve: inv, z, the scaled chunks, the reduced rhs, the preconditioner
    blocks (SCHUR_JACOBI exactly, with the within-chunk and cross-bucket
    duplicate-camera terms); CG from y = 0 whose operator S v is one K10
    launch, a camera-chunk reduce and + D_f^2 v when the program has one
    bucket with e and f slots, plain PyTorch over the buckets otherwise
    (as in the JAX package); the back-substitution; ||J_s d||^2 from the
    chunk tensors.
  cost: K4 for a single Snavely bucket, else the program's f64 pass.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..loss import correct_residuals_and_jacobian
from ..ops import lin_auto as k5
from ..ops.cost import SnavelyCost, snavely_sq
from ..ops.implicit import implicit_apply
from ..ops.jet_compile import make_auto_spec, make_loss_spec
from ..ops.kernels import MAX_M, chol_solve
from ..ops.linearize import is_snavely_bucket
from ..ops.lin import (K1_ENTRIES, K2_MAX_TE, elim, elim_v1, lin,
                      spd_inv_closed)
from ..ops.pcg import _block_apply, dense_pcg
from ..program import rows_loss
from ..types import LinearSolverType, PreconditionerType
from .cg import conjugate_gradients
from .dense import cholesky_solve
from .preconditioners import spd_inv_small
from .schur_sparse import use_sparse_schur

TF, TE = 9, 3                   # the Snavely shape of K1
# ITERATIVE_SCHUR preconditioners assembled exactly from the step's
# tensors (ceres_tpu's iterative_options_ok; SPSE is refused apart)
_FUSED_PRECONDITIONERS = (PreconditionerType.IDENTITY,
                          PreconditionerType.JACOBI,
                          PreconditionerType.SCHUR_JACOBI)


class KernelLimit(str):
    """A refusal of a configuration that the JAX package's fused step
    runs but a kernel of the port cannot take: since items 39 and 9
    closed, only a robust loss that the jet compiler does not trace (an
    attribute other than numbers, bools, strings and nested losses, or a
    torch op outside its rules; ROADMAP.md item 9), which K1 on the card
    and K5 cannot run. The configuration keeps the fused step's route
    (solver.py takes_fused_schur_step), whose constructor raises it: the
    generic Schur step does not stand in for a kernel. Every other
    refusal names a configuration that the generic step serves."""


def _slab_of(cols: np.ndarray) -> Optional[int]:
    """If cols.reshape(-1) == arange(s, s + size), return s."""
    flat = cols.reshape(-1)
    if flat.size == 0:
        return None
    s = int(flat[0])
    if np.array_equal(flat, np.arange(s, s + flat.size, dtype=flat.dtype)):
        return s
    return None


def _explicit_viable(meta) -> bool:
    """Dense S and the materialized A = E^T F affordable? Past these caps
    ITERATIVE_SCHUR runs the matrix-free implicit mode."""
    return meta.nf <= 4096 and meta.ne * meta.te * meta.nf <= 4.2e8


def implicit_mode(options, meta) -> bool:
    """Does ITERATIVE_SCHUR run the implicit (matrix-free) step? Exactly
    when the explicit S is not viable (ceres_tpu schur_fused.py:263;
    building ImplicitSchurStep directly forces the mode, as
    CERES_TPU_FORCE_IMPLICIT does there)."""
    return (options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR
            and meta is not None and not _explicit_viable(meta))


def _k10_bucket(program, meta) -> bool:
    """One bucket with both an e and an f slot: the CG operator is K10
    (the JAX package's gate, schur_fused.py:344-347)."""
    return (len(program.buckets) == 1 and meta.buckets[0].e_slot is not None
            and meta.buckets[0].f_cols is not None)


def _implicit_unsupported(program, options, meta) -> Optional[str]:
    """unsupported_reason's checks of the implicit step: ITERATIVE_SCHUR,
    every e-bucket in the chunk layout, one f slot per bucket (ceres_tpu's
    fused_structure_ok without one-hots) and the [points | cameras] state
    layout. K10 takes any (r, te, tf) (ops/implicit.py TIERS)."""
    if options.linear_solver_type != LinearSolverType.ITERATIVE_SCHUR:
        return (f"{options.linear_solver_type} in the implicit mode, which "
                "serves ITERATIVE_SCHUR only (as in the JAX package)")
    for bs in meta.buckets:
        if bs.e_slot is not None and bs.chunk_rows is None:
            return ("a bucket with no chunk layout, which the generic "
                    "Schur step serves (solvers/schur.py)")
        if bs.f_cols is not None and len(bs.f_slots) != 1:
            return ("a residual block on two f blocks, which the generic "
                    "Schur step serves (solvers/schur.py)")
    grp = meta.f_groups[0]
    if not program.tangent_is_ambient or _slab_of(meta.e_cols) != 0 or \
            _slab_of(meta.f_global_cols[grp["cols"]]) != meta.ne * meta.te:
        return ("constant blocks or another state layout than [points | "
                "cameras] (ROADMAP.md item 11, the rest of "
                "solvers/schur_fused.py)")
    return None


def _common_unsupported(program, options, meta) -> Optional[str]:
    """unsupported_reason's checks of both Schur steps."""
    lst = options.linear_solver_type
    iterative = lst == LinearSolverType.ITERATIVE_SCHUR
    if lst == LinearSolverType.SPARSE_SCHUR and use_sparse_schur(meta,
                                                                 options):
        return (f"{lst} on the block-sparse S, which the generic Schur "
                "step serves (solvers/schur_sparse.py)")
    if not iterative and lst not in (LinearSolverType.DENSE_SCHUR,
                                     LinearSolverType.SPARSE_SCHUR):
        return f"{lst}, which is not a Schur solver (solver.py GenericLMStep)"
    if iterative and options.preconditioner_type not in \
            _FUSED_PRECONDITIONERS:
        return (f"ITERATIVE_SCHUR with {options.preconditioner_type}, which "
                "the generic Schur step serves (solvers/schur.py, the "
                "CLUSTER_* preconditioners on solvers/clustering.py)")
    if iterative and options.use_spse_initialization:
        return ("use_spse_initialization, which the generic Schur step "
                "serves (solvers/schur.py SchurLinearSolver)")
    if not options.use_mixed_precision_solves:
        return ("the f64 (non-mixed) fused step (ROADMAP.md item 11, the "
                "rest of solvers/schur_fused.py)")
    if options.max_num_refinement_iterations > 0:
        return ("mixed-precision refinement, which the generic Schur step "
                "serves (solver.py GenericLMStep)")
    if program.has_bounds:
        return ("bounds (ROADMAP.md item 11, the rest of "
                "solvers/schur_fused.py)")
    if program.has_manifolds:
        return ("non-Euclidean manifolds in the fused Schur step "
                "(ROADMAP.md item 11, the rest of solvers/schur_fused.py)")
    if meta is None or len(meta.f_groups) != 1:
        return ("no single-group Schur structure, which the generic Schur "
                "step serves (solvers/schur.py)")
    return None


def _k5_unsupported(program, options, meta) -> Optional[str]:
    """The JAX package's gate of K5 (pallas_lin.py:525-567) for a bucket
    that is not Snavely's: two variable slots with no manifold, te <= 6,
    tf <= 12, r <= 8 (its kf <= 64 is a TPU cost cap, not kept), a
    functor the jet compiler traces, and a loss it traces (its scalars by
    value, or per lane when they differ by row, any number of them).
    Every bucket of the port is differentiated by autodiff (its jac_mode
    "ad"). K2 takes te <= 3 and K6 te <= 6, K5's own bound."""
    bk, grp = program.buckets[0], meta.f_groups[0]
    if len(bk.slots) != 2 or any(not sl.variable or sl.manifold is not None
                                 for sl in bk.slots):
        return ("a functor of other than two slots, or with a manifold, in "
                "the explicit step (ROADMAP.md item 11, the generic fused "
                "lin phase)")
    if meta.te > k5.MAX_TE or grp["t"] > k5.MAX_TF or bk.r > k5.MAX_R:
        return (f"K5 past te <= {k5.MAX_TE}, tf <= {k5.MAX_TF}, r <= "
                f"{k5.MAX_R} (ROADMAP.md item 11, the generic fused lin "
                "phase)")
    if make_auto_spec(program, bk) is None:
        return ("a functor that the jet compiler does not trace "
                "(ROADMAP.md item 11, the generic fused lin phase)")
    return _loss_untraced(bk)


def _loss_untraced(bk) -> Optional[str]:
    """The KernelLimit of a bucket loss that the jet compiler does not
    trace (K5's, and K1's on the card for a loss with no hand instance)."""
    if bk.loss_proto is not None and make_loss_spec(bk.loss_proto) is None:
        return KernelLimit(
            f"{type(bk.loss_proto).__name__}, a robust loss that does not "
            "trace to scalar code: an attribute other than numbers, bools, "
            "strings and nested losses, or a torch op outside the jet "
            "compiler's rules (ROADMAP.md item 9)")
    return None


def _explicit_unsupported(program, options, meta,
                          viable: Optional[bool] = None) -> Optional[str]:
    """unsupported_reason's checks of the explicit step (K1 on one
    Snavely bucket, K5 on one bucket of any other traced functor; S formed
    densely). `viable` overrides _explicit_viable (a sharded step holds A
    a shard at a time, parallel/sharded_fused.py)."""
    if len(program.buckets) != 1 or len(meta.buckets) != 1:
        return ("more than one residual-block bucket (ROADMAP.md item 11, "
                "the generic fused lin phase)")
    bk, bs = program.buckets[0], meta.buckets[0]
    grp = meta.f_groups[0]
    if is_snavely_bucket(bk) and (meta.te != TE or grp["t"] != TF
                                  or bk.r != 2):
        return ("a Schur shape other than Snavely's (2, 3, 9) (ROADMAP.md "
                "item 11, the generic fused lin phase)")
    if bs.e_slot is None or bs.f_cols is None or bs.chunk_rows is None:
        return ("no chunk layout for the bucket, which the generic Schur "
                "step serves (solvers/schur.py)")
    if not program.tangent_is_ambient or _slab_of(meta.e_cols) != 0 or \
            _slab_of(meta.f_global_cols[grp["cols"]]) != meta.ne * meta.te:
        return ("constant blocks or another state layout than [points | "
                "cameras] (ROADMAP.md item 11, the rest of "
                "solvers/schur_fused.py)")
    if not is_snavely_bucket(bk):
        reason = _k5_unsupported(program, options, meta)
    elif torch.device(options.device).type == "cuda" and \
            type(bk.loss_proto) not in K1_ENTRIES:
        reason = _loss_untraced(bk)       # K1's generated loss units
    else:
        reason = None
    if reason is not None:
        return reason
    if not (_explicit_viable(meta) if viable is None else viable):
        return (f"{options.linear_solver_type} on a reduced camera system "
                "too large to form densely in the fused step (the generic "
                "Schur step serves it; ITERATIVE_SCHUR runs ImplicitSchurStep "
                "there)")
    return None


def unsupported_reason(program, options, meta,
                       implicit: Optional[bool] = None,
                       viable: Optional[bool] = None) -> Optional[str]:
    """Why the fused step does not serve this configuration (naming the
    ROADMAP.md item or the step that does), or None: for the implicit
    step (implicit=True), the explicit one (False), or the one
    `schur_step` picks (None). A KernelLimit where a port kernel is the
    cause. `viable` overrides the explicit step's size cap."""
    reason = _common_unsupported(program, options, meta)
    if reason is not None:
        return reason
    if implicit is None:
        implicit = implicit_mode(options, meta)
    if implicit:
        return _implicit_unsupported(program, options, meta)
    return _explicit_unsupported(program, options, meta, viable)


def schur_step(program, options, meta):
    """The Schur step of the configuration: ImplicitSchurStep exactly
    when implicit_mode holds, else FusedSchurStep. Both raise
    NotImplementedError outside the ported slices."""
    cls = ImplicitSchurStep if implicit_mode(options, meta) else \
        FusedSchurStep
    return cls(program, options, meta)


def explicit_cg(S, b, minv_blocks, *, max_iterations: int,
                min_iterations: int = 0, q_tolerance: float = 0.0):
    """The reduced CG past MAX_M (the JAX fused step's XLA CG loop,
    ceres_tpu schur_fused.py:868-881): solvers/cg.py over torch.mv(S, .)
    from y0 = 0, the [kf, tf, tf] inverted blocks applied as K7 applies
    them (None for IDENTITY), K7's stopping rule. Returns (y, iterations
    as a device int32)."""
    res = conjugate_gradients(
        lambda v: torch.mv(S, v), b, torch.zeros_like(b),
        apply_preconditioner=_block_apply(minv_blocks, S.shape[0]),
        max_iterations=max_iterations, min_iterations=min_iterations,
        q_tolerance=q_tolerance)
    return res.x, res.num_iterations


def precond_blocks(P_blocks, S, kf, tf, kind):
    """[kf, tf, tf] preconditioner blocks for the reduced CG, or None for
    IDENTITY. JACOBI: the block diagonal of F^T F_s + D_f^2; SCHUR_JACOBI:
    the block diagonal of S itself (exact, since S is formed)."""
    if kind == PreconditionerType.IDENTITY:
        return None
    if kind == PreconditionerType.SCHUR_JACOBI:
        ii = torch.arange(kf, device=S.device)
        return S.view(kf, tf, kf, tf)[ii, :, ii, :]
    return P_blocks


# ----------------------------------------------------------------------
# camera-chunk layouts of the implicit mode (numpy, once per program)

def cam_chunk_layout(cams, positions, kf: int):
    """Group `positions` (row ids) by f-block id `cams` into a dense
    [kf, kc] index layout with a validity mask, kc the most rows of one
    f block: the camera-chunk form the implicit reductions gather over
    (ceres_tpu's cam_chunk_layout)."""
    cams = np.asarray(cams, dtype=np.int64)
    positions = np.asarray(positions)
    counts = np.bincount(cams, minlength=kf)
    kc = max(1, int(counts.max()) if counts.size else 1)
    order = np.argsort(cams, kind="stable")
    starts = np.zeros(kf, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(cams), dtype=np.int64) - starts[cams[order]]
    rows = np.zeros((kf, kc), dtype=np.int32)
    mask = np.zeros((kf, kc), dtype=np.float32)
    rows[cams[order], rank] = positions[order].astype(np.int32)
    mask[cams[order], rank] = 1.0
    return rows, mask


def chunk_has_dup_cams(fids, mask) -> bool:
    """Does any chunk row observe the same f block through more than one
    valid lane? Then the implicit SCHUR_JACOBI assembly needs the
    within-chunk cross terms."""
    fs = np.sort(np.where(np.asarray(mask) > 0, np.asarray(fids), -1),
                 axis=1)
    return bool(np.any((fs[:, 1:] == fs[:, :-1]) & (fs[:, 1:] >= 0)))


def build_cam_chunks(local, chunk_rows, chunk_mask, kf):
    """Camera-chunk layout of one bucket (ceres_tpu's _build_cam_chunks,
    which registers the same arrays as program constants): (rows [kf, kc]
    int32, mask [kf, kc] f32) of flat positions into the point-chunk
    layout, or into observation order when chunk_rows is None; padded
    lanes are masked and point at position 0."""
    n = local.shape[0]
    if chunk_rows is not None:
        flat_rows = chunk_rows.reshape(-1)
        flat_valid = chunk_mask.reshape(-1) > 0
        pos_of_row = np.zeros(n, dtype=np.int64)
        pos_of_row[flat_rows[flat_valid]] = np.nonzero(flat_valid)[0]
    else:
        pos_of_row = np.arange(n, dtype=np.int64)
    return cam_chunk_layout(local, pos_of_row, kf)


def detect_cross_bucket_dups(e_entries):
    """Which ordered pairs (i < j) of e-buckets share a (point, camera)
    observation? e_entries: list of (fids [ne, k], valid [ne, k] bool)."""
    stride = 1 + max((int(np.asarray(f).max(initial=0))
                      for f, _ in e_entries), default=0)
    keys = []
    for fids, valid in e_entries:
        fids = np.asarray(fids, dtype=np.int64)
        valid = np.asarray(valid, dtype=bool)
        n_idx = np.broadcast_to(
            np.arange(fids.shape[0], dtype=np.int64)[:, None], fids.shape)
        keys.append(np.unique(n_idx[valid] * stride + fids[valid]))
    return [(i, j)
            for i in range(len(keys)) for j in range(i + 1, len(keys))
            if np.intersect1d(keys[i], keys[j], assume_unique=True).size]


# ----------------------------------------------------------------------
# implicit-mode tensor helpers (ceres_tpu schur_fused.py :62-82, :1258-1374)

def _chunk_gather(T, rows, mask):
    """T [n, ...] -> T[rows] * mask for rows, mask [ne, k]."""
    return T[rows] * mask.view(mask.shape + (1,) * (T.dim() - 1))


def _outer_rt(Ja, Jb):
    """sum_r Ja[..., r, :] (x) Jb[..., r, :] -> [..., ta, tb]."""
    return torch.einsum("...ra,...rb->...ab", Ja, Jb)


def mv(J, v):
    """[..., r, t] x [..., t] -> [..., r]."""
    return torch.einsum("...rt,...t->...r", J, v)


def rvec_rt(J, w):
    """sum_r J[..., r, :] * w[..., r] -> [..., t]."""
    return torch.einsum("...rt,...r->...t", J, w)


def cam_reduce(contrib, camr, camm):
    """[rows..., w] -> [kf, w] by camera-chunk gather and a sum over each
    chunk in lane order (camr [kf, kc] positions into the flattened
    rows)."""
    flat = contrib.reshape(-1, contrib.shape[-1])
    return torch.sum(flat[camr] * camm[..., None], dim=1)


def _spd_inv_e(M):
    """[n, t, t] SPD -> inverse: in closed form for t <= 3, as ceres_tpu's
    _spd_inv_small; by Cholesky otherwise."""
    return spd_inv_closed(M) if M.shape[-1] <= 3 else spd_inv_small(M)


def sj_chunk_blocks(Ge_s, M, fids, dup: bool):
    """Per-lane contributions [ne, k, tf, tf] to the block diagonal of S
    (ceres_tpu's _sj_chunk_blocks, which returns them transposed as
    [tf*tf, k, ne] for the TPU's tiling): Ge^T inv Ge per lane with
    M = inv Ge; with dup=True (a camera sees a point through several
    lanes) the cross terms between same-camera lanes too, so the
    SCHUR_JACOBI blocks stay the exact diagonal of S."""
    if not dup:
        return torch.einsum("nkut,nkuv->nktv", Ge_s, M)
    out = None
    for k2 in range(Ge_s.shape[1]):
        eq = (fids == fids[:, k2:k2 + 1]).to(Ge_s.dtype)        # [ne, k]
        C = torch.einsum("nkut,nuv->nktv", Ge_s, M[:, k2]) \
            * eq[:, :, None, None]
        out = C if out is None else out + C
    return out


def sj_cross_pair_blocks(Ge1_s, Ge2_s, inv_ete, fids1, fids2):
    """Cross-bucket correction [ne, k1, tf, tf] of the implicit
    SCHUR_JACOBI blocks where the same (camera, point) pair has rows in
    two buckets (ceres_tpu's _sj_cross_pair_blocks): C + C^T with
    C[n, k1] = sum over k2 with fids2[n, k2] == fids1[n, k1] of
    Ge1[n, k1]^T inv[n] Ge2[n, k2], reduced with bucket 1's layout."""
    MG2 = torch.einsum("nuv,nlvt->nlut", inv_ete, Ge2_s)
    eq = (fids1[:, :, None] == fids2[:, None, :]).to(Ge1_s.dtype)
    C = torch.einsum("nkut,nlum,nkl->nktm", Ge1_s, MG2, eq)
    return C + C.transpose(-1, -2)


def precond_from_blocks(blocks):
    """Block-diagonal preconditioner apply from [kf, tf, tf] SPD blocks,
    inverted once (ceres_tpu's _precond_from_blocks)."""
    kf, tf, _ = blocks.shape
    inv = spd_inv_small(blocks)

    def apply(v):
        return torch.sum(inv * v.view(kf, 1, tf), dim=-1).reshape(kf * tf)

    return apply


@dataclass
class Linearization:
    """Radius-independent artifacts of one linearization (f32 unless
    noted). s_e/s_f are the Jacobi scales carried to the next one."""
    cost: torch.Tensor          # f64 total cost at x
    A: torch.Tensor             # [ne, te, nf] e-scaled cross tensor
    etes: torch.Tensor          # [ne, te*te] scaled point Grams
    gse: torch.Tensor           # [ne, te] scaled e gradient
    diag_e: torch.Tensor        # [ne, te] clipped scaled diagonal
    s_e: torch.Tensor           # [ne, te]
    s_f: torch.Tensor           # [kf, tf]
    FtF_s: torch.Tensor         # [kf, tf, tf] scaled camera Grams
    g_sf: torch.Tensor          # [nf] scaled f gradient
    diag_f: torch.Tensor        # [kf, tf] clipped scaled diagonal
    grad_max: torch.Tensor      # f64 max |gradient|
    grad_norm: torch.Tensor     # f64 ||gradient||

    @property
    def scales(self):
        return (self.s_e, self.s_f)


@dataclass
class ImplicitLinearization:
    """Radius-independent artifacts of one linearization in the implicit
    mode (f32 unless noted), with the unscaled chunk tensors the damped
    solves read (ceres_tpu's keep_chunks)."""
    cost: torch.Tensor          # f64 total cost at x
    EtE_s: torch.Tensor         # [ne, te, te] scaled point Grams
    FtF_s: torch.Tensor         # [kf, tf, tf] scaled camera Grams
    g_se: torch.Tensor          # [ne, te] scaled e gradient
    g_sf: torch.Tensor          # [nf] scaled f gradient
    diag_e: torch.Tensor        # [ne, te] clipped scaled diagonal
    diag_f: torch.Tensor        # [kf, tf] clipped scaled diagonal
    s_e: torch.Tensor           # [ne, te]
    s_f: torch.Tensor           # [kf, tf]
    grad_max: torch.Tensor      # f64 max |gradient|
    grad_norm: torch.Tensor     # f64 ||gradient||
    chunks: list                # (kind, Je, Jf, plan) per bucket

    @property
    def scales(self):
        return (self.s_e, self.s_f)


class _BucketPlan:
    """One bucket of the implicit mode: its kind ("e": e and f slots in
    the chunk layout, "e0": e slot only, "f": f slot only), the offsets
    of its slots in the bucket Jacobian and its layouts on the device."""
    __slots__ = ("bk", "kind", "eo", "fo", "rows", "mask", "fids",
                 "fids32", "camr", "camm", "dup")


class LocalReduce:
    """The reductions of a Schur step on one device: the identity. A
    sharded step's reducer (parallel/group.py Group) sums, maxes and
    gathers over its ranks at the same places."""

    @staticmethod
    def sum(*tensors):
        return list(tensors)

    @staticmethod
    def max(t):
        return t

    @staticmethod
    def gather_rows(t):
        return t


class SchurStep:
    """What the explicit and the implicit Schur steps share: the options,
    the shape of the single f group, the zero initial scales and the
    candidate cost (K4 for a single Snavely bucket). Holds the layout
    constants on the program's device. `red` reduces the shard-local
    parts over the ranks of a sharded solve (the identity here); `work`
    is the dtype of the Jacobians, Grams and the reduced solve (f32: the
    mixed solve; a sharded f64 implicit step sets the program's)."""

    red = LocalReduce
    work = torch.float32

    def __init__(self, program, options, meta):
        self.program = program
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.preconditioner = options.preconditioner_type
        self.pcg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)
        bk, bs = program.buckets[0], meta.buckets[0]
        grp = meta.f_groups[0]
        self.ne, self.kf = meta.ne, grp["kf"]
        self.te, self.tf = meta.te, grp["t"]
        self.nf = self.kf * self.tf
        self.e_slab = _slab_of(meta.e_cols)
        self.f_slab = _slab_of(meta.f_global_cols[grp["cols"]])
        self.meta = meta
        self.k4 = None

    def _bind_data(self, program):
        """The fields a step takes from the program's data rather than its
        structure: the loss and K4's inputs (K4 prices the candidates of a
        single Snavely bucket; its inputs in bucket row order, checked
        once here). Each subclass's constructor calls it last."""
        meta = self.meta
        bk, bs = program.buckets[0], meta.buckets[0]
        grp = meta.f_groups[0]
        self.program = program
        self.loss = bk.loss_proto         # its class and uniform scalars
        self.k4_loss = None               # the loss over K4's rows
        if (len(program.buckets) == 1 and is_snavely_bucket(bk)
                and bs.e_slot is not None and bs.f_cols is not None
                and (self.te, self.tf, bk.r) == (TE, TF, 2)):
            dev = program.device
            local = next(s[2] for s in grp["slots"] if s[0] == 0)
            rows = self._k4_rows()
            self.k4_loss = rows_loss(bk.loss_proto, bk.loss_attrs, rows, dev)
            sel = slice(None) if rows is None else rows
            tsel = (slice(None) if rows is None
                    else torch.as_tensor(rows, device=dev))
            self.k4 = SnavelyCost(
                self.e_slab, self.f_slab, meta.ne, self.kf,
                torch.as_tensor(bs.e_ids[sel].astype(np.int32), device=dev),
                torch.as_tensor(np.asarray(local, np.int32)[sel],
                                device=dev),
                bk.data["observed_x"][tsel].contiguous(),
                bk.data["observed_y"][tsel].contiguous())

    def _k4_rows(self):
        """The bucket rows K4 prices (None: all; a shard's own rows)."""
        return None

    def bind(self, program):
        """This step on another program of the same structure (every
        integer layout bitwise equal; batch.py checks it): the layouts,
        plans and kernel choices are shared, the data fields taken from
        `program`. Solves the same as a step built on `program`."""
        step = copy.copy(self)
        step._bind_data(program)
        return step

    def initial_scales(self):
        """Zero scales for the first linearization (which derives them)."""
        dev = self.program.device
        return (torch.zeros(self.ne, self.te, dtype=self.work, device=dev),
                torch.zeros(self.kf, self.tf, dtype=self.work, device=dev))

    def step_delta(self, d_e, d_f):
        """The f64 step from the points' part [ne, te] (this rank's, the
        ranks' gathered in order) and the cameras' [nf]: the state layout
        is [points | cameras] (unsupported_reason)."""
        d_e = self.red.gather_rows(d_e.double())[:self.meta.ne]
        return torch.cat([d_e.reshape(-1), d_f.double().reshape(-1)])

    def cost(self, x):
        """f64 total cost at x: K4 for a single Snavely bucket, else the
        program's f64 residual pass."""
        if self.k4 is None:
            return self.program.cost_fn(x)
        sq = snavely_sq(x, self.k4)
        rho = sq if self.k4_loss is None else self.k4_loss.evaluate(sq)[0]
        return self.program.fixed_cost + 0.5 * torch.sum(rho)


class FusedSchurStep(SchurStep):
    """The explicit Schur LM step: `linearize`, `solve` and `cost` for
    DENSE_SCHUR, or ITERATIVE_SCHUR on an explicit S, over one bucket:
    the Snavely bucket through K1, any other traced functor through K5
    (chosen once, here, from the functor, as the JAX package chooses)."""

    def __init__(self, program, options, meta):
        reason = self._unsupported(program, options, meta)
        if reason is not None:
            raise NotImplementedError(f"not in the ported slice: {reason}")
        super().__init__(program, options, meta)
        self.iterative = (options.linear_solver_type
                          == LinearSolverType.ITERATIVE_SCHUR)
        bk, bs = program.buckets[0], meta.buckets[0]
        dev = program.device
        local = np.asarray(
            next(s[2] for s in meta.f_groups[0]["slots"] if s[0] == 0))
        rows, cmask = self._chunks()                     # [ne, k]
        self.mask = torch.as_tensor(np.ascontiguousarray(cmask, np.float32),
                                    device=dev)
        self._auto = self._safe = None
        if is_snavely_bucket(bk):
            # K1 inputs, chunk layout (masked lanes: camera 0, obs 0)
            self.k5 = None
            self.cam = torch.as_tensor(
                np.ascontiguousarray(local[rows] * cmask).astype(np.int32),
                device=dev)
        else:
            # K5 inputs, chunk layout; a masked lane carries its point's
            # first valid lane's camera and data (ops/lin_auto.py)
            self._auto = make_auto_spec(program, bk)
            var = [i for i, sl in enumerate(bk.slots) if sl.variable]
            self.k5 = k5.lin_auto_spec(self._auto, var[bs.e_slot])
            self._safe = torch.as_tensor(
                k5.safe_rows(rows, cmask).astype(np.int64), device=dev)
            self.cam = torch.as_tensor(local.astype(np.int32),
                                       device=dev)[self._safe].contiguous()
        # the camera-sorted rows of K1's or K5's camera-side sums
        self.plan = k5.camera_plan(self.cam, self.mask, self.kf)
        self._bind_data(program)
        # the reduced solve, from m alone, the same on every device: the
        # one-block K3 or K7 up to MAX_M, past it the library Cholesky or
        # CG (where the JAX package takes XLA's cho_factor and CG loop)
        self.library = self.nf > MAX_M
        solve = (("CG on the explicit S (solvers/cg.py)" if self.library
                  else "K7 dense_pcg") if self.iterative else
                 ("library Cholesky (torch.linalg.cholesky_ex)"
                  if self.library else "K3 chol_solve"))
        self.mode = ("explicit reduced camera matrix, linearize "
                     + ("K1" if self.k5 is None else "K5")
                     + ", eliminate " + ("K6" if self.iterative
                                         or self.te > K2_MAX_TE else "K2")
                     + f", reduced solve: {solve}, m = {self.nf}")
        # a direct solve is one linear iteration (kept on the device)
        self.one = torch.ones((), dtype=torch.int32, device=dev)

    @staticmethod
    def _unsupported(program, options, meta):
        return unsupported_reason(program, options, meta, implicit=False)

    def _chunks(self):
        """The chunk layout's rows and mask [ne, k] (numpy) of the
        points this step linearizes."""
        bs = self.meta.buckets[0]
        return bs.chunk_rows, bs.chunk_mask

    def point_state(self, x):
        """The points' f64 state [ne, te]."""
        return x[self.e_slab:self.e_slab + self.ne * self.te].view(
            self.ne, self.te)

    def _bind_data(self, program):
        """SchurStep's data fields, the observations of K1 or K5 in the
        chunk layout (K1: masked lanes carry observation 0), and the
        lanes' loss scalars where they differ by row (masked lanes: their
        point's first valid lane's)."""
        super()._bind_data(program)
        bk = program.buckets[0]
        rows, cmask = self._chunks()
        self.loss_rows = k5.chunk_loss_rows(bk, k5.safe_rows(rows, cmask),
                                            program.device)
        if self.k5 is None:
            obs = np.stack([bk.data[f].cpu().numpy().astype(np.float32)
                            for f in ("observed_x", "observed_y")], axis=1)
            self.dat = torch.as_tensor(np.ascontiguousarray(
                obs[rows] * cmask[..., None]).astype(np.float32),
                device=program.device)
        else:
            self.dat = self._auto.data_matrix(bk)[self._safe].contiguous()

    def linearize(self, x, s_e, s_f, first: bool, known_cost=None):
        """Linearize at x. first=True derives the Jacobi scales from this
        linearization's Gram diagonals; otherwise s_e/s_f are used."""
        if known_cost is None:
            known_cost = self.program.cost_fn(x)
        ne, kf, nf, te = self.ne, self.kf, self.nf, self.te
        xe = self.point_state(x).float()
        xf = x[self.f_slab:self.f_slab + nf].float()
        if self.k5 is None:
            out = lin(xf, xe, self.cam, self.mask, self.dat, s_e.contiguous(),
                      first, self.use_scaling, self.loss, self.plan,
                      self.loss_rows)
        else:
            out = k5.lin_auto(self.k5, xf, xe, self.cam, self.mask,
                              self.dat, s_e.contiguous(), first,
                              self.use_scaling, self.loss, self.plan,
                              self.loss_rows)
        ete, ge, se = out["ete"], out["ge"], out["se"]
        ge_max = ge.abs().max()
        ge_sq = torch.dot(ge.reshape(-1), ge.reshape(-1))
        FtF, g_f, ge_sq = self.red.sum(out["ftf"], out["gf"], ge_sq)
        ge_max = self.red.max(ge_max)
        cn_f = torch.diagonal(FtF, dim1=-2, dim2=-1)
        if not self.use_scaling:
            s_f = torch.ones_like(cn_f)
        elif first:
            s_f = 1.0 / (1.0 + torch.sqrt(cn_f))
        se_outer = (se[:, :, None] * se[:, None, :]).reshape(ne, te * te)
        cn_e = ete[:, ::te + 1]
        g_f_flat = g_f.reshape(nf)
        grad_max = torch.maximum(ge_max, g_f_flat.abs().max())
        grad_norm = torch.sqrt(ge_sq + torch.dot(g_f_flat, g_f_flat))
        return Linearization(
            cost=known_cost, A=out["A"], etes=ete * se_outer, gse=ge * se,
            diag_e=torch.clamp(se * se * cn_e, self.min_diag, self.max_diag),
            s_e=se, s_f=s_f,
            FtF_s=FtF * (s_f[:, :, None] * s_f[:, None, :]),
            g_sf=(g_f * s_f).reshape(nf),
            diag_f=torch.clamp(s_f * s_f * cn_f, self.min_diag,
                               self.max_diag),
            grad_max=grad_max.double(), grad_norm=grad_norm.double())

    def point_inverse(self, art: Linearization, rad):
        """inv = (E^T E_s + D_e^2)^-1 [ne, te, te] and z = inv (-g_se)
        [ne, te] at the f32 radius tensor `rad` (K6's inputs)."""
        inv = _spd_inv_e(art.etes.view(self.ne, self.te, self.te)
                         + torch.diag_embed(art.diag_e / rad)).contiguous()
        return inv, torch.einsum("nij,nj->ni", inv, -art.gse)

    def reduced_system(self, art: Linearization, radius: float):
        """The elimination (K2 for DENSE_SCHUR with te <= 3; inv, z and K6
        for ITERATIVE_SCHUR and past te = 3, as the JAX package's step
        runs its _elim_kernel where have_elim2 is false) and the assembly
        of the reduced camera system at `radius`: returns (S [nf, nf],
        rhs [nf], inv [ne, te, te], rad f32 tensor)."""
        kf, nf, tf = self.kf, self.nf, self.tf
        rad = torch.tensor(radius, dtype=torch.float32,
                           device=self.program.device)
        sA = art.s_f.reshape(nf)
        if self.iterative or self.te > K2_MAX_TE:
            inv, z = self.point_inverse(art, rad)
            S_corr_u, rhsa_u = elim_v1(art.A, inv, z)
        else:
            S_corr_u, rhsa_u, inv, _ = elim(art.A, art.etes, art.gse,
                                            art.diag_e,
                                            float(np.float32(radius)))
        S_corr_u, rhsa_u = self.red.sum(S_corr_u, rhsa_u)
        rhs = -art.g_sf - sA * rhsa_u
        S = -(S_corr_u * (sA[:, None] * sA[None, :]))
        S = S.view(kf, tf, kf, tf)
        ii = torch.arange(kf, device=S.device)
        S[ii, :, ii, :] += art.FtF_s + torch.diag_embed(art.diag_f / rad)
        return S.view(nf, nf).contiguous(), rhs.contiguous(), inv, rad

    def precond_inverse(self, art: Linearization, S, rad):
        """The inverted [kf, tf, tf] preconditioner blocks of the reduced
        CG, or None for IDENTITY."""
        blocks = precond_blocks(
            art.FtF_s + torch.diag_embed(art.diag_f / rad), S, self.kf,
            self.tf,
            self.preconditioner)
        return None if blocks is None else spd_inv_small(blocks).contiguous()

    def solve(self, art: Linearization, radius: float) -> dict:
        """Damped solve at `radius`: the LM step and its model cost
        change (same contract as the JAX step's output dict)."""
        kf, nf = self.kf, self.nf
        S, rhs, inv, rad = self.reduced_system(art, radius)
        if self.iterative:
            minv = self.precond_inverse(art, S, rad)
            if self.library:
                y, lin_iters = explicit_cg(S, rhs, minv, **self.pcg_args)
            else:
                y, lin_iters, _ = dense_pcg(S, rhs, minv, **self.pcg_args)
        else:
            y = cholesky_solve(S, rhs) if self.library else chol_solve(S,
                                                                       rhs)
            lin_iters = self.one
        sA = art.s_f.reshape(nf)

        # back-substitution: d_e = inv (b_e - A y)
        Ay = torch.einsum("nuf,f->nu", art.A, sA * y)
        d_e = torch.einsum("nij,nj->ni", inv, -art.gse - Ay)
        e_dot = torch.sum(d_e * art.gse)
        if self.iterative:
            # the Gram identity: J^T J = [[EtE, A], [A^T, blockdiag(FtF)]]
            # for the BA structure, with Ay reused from the back-substitution
            yb = y.view(kf, self.tf)
            e_gram, e_cross = (
                torch.sum(d_e * torch.einsum(
                    "nuv,nv->nu", art.etes.view(-1, self.te, self.te), d_e)),
                torch.sum(d_e * Ay))
            e_dot, e_gram, e_cross = self.red.sum(e_dot, e_gram, e_cross)
            d_dot_g = e_dot + torch.dot(y, art.g_sf)
            Jd_sq = (e_gram + 2.0 * e_cross
                     + torch.sum(yb * torch.einsum("ctu,cu->ct", art.FtF_s,
                                                   yb)))
        else:
            e_dot, Dd_e = self.red.sum(
                e_dot, torch.sum((art.diag_e / rad) * d_e * d_e))
            d_dot_g = e_dot + torch.dot(y, art.g_sf)
            Dd_sq = Dd_e + torch.sum((art.diag_f / rad).reshape(nf) * y * y)
            Jd_sq = -d_dot_g - Dd_sq          # exact direct solve
        mcc = -(d_dot_g + 0.5 * Jd_sq)
        delta = self.step_delta(art.s_e * d_e, sA * y)
        return {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.double(),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": lin_iters,
        }


class ImplicitSchurStep(SchurStep):
    """The implicit (matrix-free) ITERATIVE_SCHUR LM step, with the same
    linearize/solve/cost/initial_scales protocol as FusedSchurStep, for
    any functor with the [points | cameras] layout (its Jacobian by K11
    where a hand or auto spec matches, else by jacfwd) and any number of
    buckets (ceres_tpu schur_fused.py _lin_phase_generic's implicit
    branches, :556-795; _solve_phase's implicit branch, :887-1038, and
    its model cost change, :1059-1092). `schur_step` picks it exactly
    when the explicit S is not viable; building it directly forces the
    mode, as ceres_tpu's CERES_TPU_FORCE_IMPLICIT does (for the tests).
    Holds the per-bucket plans and layouts (ceres_tpu schur_fused.py
    :275-331): chunk rows and masks, the camera of each lane, the
    camera-chunk layouts, duplicate cameras within a chunk and
    cross-bucket duplicate (camera, point) pairs."""

    def __init__(self, program, options, meta):
        reason = unsupported_reason(program, options, meta, implicit=True)
        if reason is not None:
            raise NotImplementedError(f"not in the ported slice: {reason}")
        super().__init__(program, options, meta)
        self.plans, e_entries = self._build_plans(program, meta, self.kf)
        self.k10 = _k10_bucket(program, meta)
        self.cross_pairs = detect_cross_bucket_dups(e_entries)
        self.mode = ("implicit (matrix-free) Schur complement, CG operator "
                     + ("K10" if self.k10 else "in plain PyTorch over "
                        f"{len(self.plans)} buckets"))
        self._bind_data(program)

    @staticmethod
    def _build_plans(program, meta, kf):
        """The per-bucket plans (_BucketPlan) of `meta` with kf cameras in
        its f group, on the program's device, and the e entries of the
        cross-bucket duplicate check."""
        grp = meta.f_groups[0]
        dev = program.device

        def on_dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        plans, e_entries = [], []
        for bi, (bk, bs) in enumerate(zip(program.buckets, meta.buckets)):
            var = [sl for sl in bk.slots if sl.variable]
            offs = np.cumsum([0] + [sl.tangent_size for sl in var])
            p = _BucketPlan()
            p.bk = bk
            p.kind = ("e" if bs.f_cols is not None else "e0") \
                if bs.e_slot is not None else "f"
            p.eo = int(offs[bs.e_slot]) if bs.e_slot is not None else None
            p.fo = int(offs[bs.f_slots[0]]) if bs.f_slots else None
            p.rows = p.mask = p.fids = p.fids32 = p.camr = p.camm = None
            p.dup = False
            local = None
            if bs.f_cols is not None:
                local = [s for s in grp["slots"] if s[0] == bi][0][2]
                chunked = p.kind == "e"
                camr, camm = build_cam_chunks(
                    local, bs.chunk_rows if chunked else None,
                    bs.chunk_mask if chunked else None, kf)
                p.camr, p.camm = on_dev(camr, torch.long), on_dev(camm)
            if bs.e_slot is not None:
                p.rows = on_dev(bs.chunk_rows, torch.long)
                p.mask = on_dev(bs.chunk_mask, torch.float32)
            if p.kind == "e":
                fids = np.asarray(local)[bs.chunk_rows]         # [ne, k]
                p.fids = on_dev(fids, torch.long)
                p.fids32 = on_dev(fids, torch.int32)
                p.dup = chunk_has_dup_cams(fids, bs.chunk_mask)
                e_entries.append((fids, bs.chunk_mask > 0))
            elif p.kind == "f":
                p.fids = on_dev(local, torch.long)
            plans.append(p)
        return plans, e_entries

    def _bind_data(self, program):
        """SchurStep's data fields, and each plan on its bucket of
        `program` (the plans read their bucket's data and K11 inputs)."""
        super()._bind_data(program)
        plans = []
        for p, bk in zip(self.plans, program.buckets):
            q = copy.copy(p)
            q.bk = bk
            plans.append(q)
        self.plans = plans

    def linearize(self, x, s_e_in, s_f_in, first: bool,
                  known_cost=None):
        """Per bucket: the f64 residual pass (the cost, unless the loop
        carries it), the Jacobian in `work` (in f32 K11 where a hand or
        auto spec matches, else jacfwd), the robust-loss correction, the
        chunk gather, and the bucket's part of E^T E, g_e, F^T F and g_f
        (the camera parts by camera-chunk gather and sum). Then the Jacobi
        scales, the scaled Grams and the clipped diagonals."""
        program = self.program
        work, dev = self.work, program.device
        total = torch.tensor(program.fixed_cost, dtype=torch.float64,
                             device=dev)
        rows = []
        for p in self.plans:
            r64 = program._bucket_residuals(p.bk, x)
            if known_cost is None:
                cost, _, _ = correct_residuals_and_jacobian(p.bk.loss, r64,
                                                            None)
                total = total + torch.sum(cost)
            _, J = program._bucket_linearize(p.bk, x, work)
            _, rc, Jc = correct_residuals_and_jacobian(
                p.bk.loss, r64.to(work), J.to(work))
            rows.append((rc.to(work), Jc.to(work)))
        if known_cost is not None:
            total = known_cost
        return self.linearization(rows, total, s_e_in, s_f_in, first)

    def linearization(self, rows, total, s_e_in, s_f_in, first: bool):
        """The linearization from each plan's corrected (residuals [n, r],
        Jacobian [n, r, t]) in `work` and the cost `total`."""
        ne, te, kf, tf = self.ne, self.te, self.kf, self.tf
        work, dev = self.work, self.program.device
        EtE = torch.zeros(ne, te, te, dtype=work, device=dev)
        g_e = torch.zeros(ne, te, dtype=work, device=dev)
        FtF = torch.zeros(kf, tf, tf, dtype=work, device=dev)
        g_f = torch.zeros(kf, tf, dtype=work, device=dev)
        chunks = []
        for p, (rc, Jc) in zip(self.plans, rows):
            Je = Jf = None
            if p.kind == "f":
                Jf = Jc[..., p.fo:p.fo + tf]                    # [n, r, tf]
                FtF = FtF + cam_reduce(
                    _outer_rt(Jf, Jf).reshape(-1, tf * tf), p.camr,
                    p.camm).view(kf, tf, tf)
                g_f = g_f + cam_reduce(rvec_rt(Jf, rc), p.camr, p.camm)
            else:
                Jg = _chunk_gather(Jc, p.rows, p.mask)          # [ne,k,r,t]
                rg = _chunk_gather(rc, p.rows, p.mask)          # [ne,k,r]
                Je = Jg[..., p.eo:p.eo + te]
                EtE = EtE + torch.sum(_outer_rt(Je, Je), dim=1)
                g_e = g_e + torch.sum(rvec_rt(Je, rg), dim=1)
                if p.kind == "e":
                    Jf = Jg[..., p.fo:p.fo + tf]
                    FtF = FtF + cam_reduce(
                        _outer_rt(Jf, Jf).reshape(-1, tf * tf), p.camr,
                        p.camm).view(kf, tf, tf)
                    g_f = g_f + cam_reduce(rvec_rt(Jf, rg), p.camr,
                                           p.camm)
            chunks.append((p.kind, Je, Jf, p))

        ge_max = self._rmax(g_e.abs())
        ge_sq = self._rdot(g_e, g_e)
        FtF, g_f, ge_sq = self.red.sum(FtF, g_f, ge_sq)
        ge_max = self.red.max(ge_max)
        cn_e = torch.diagonal(EtE, dim1=-2, dim2=-1)            # [ne, te]
        cn_f = torch.diagonal(FtF, dim1=-2, dim2=-1)            # [kf, tf]
        if not self.use_scaling:
            s_e, s_f = torch.ones_like(cn_e), torch.ones_like(cn_f)
        elif first:
            s_e = 1.0 / (1.0 + torch.sqrt(cn_e))
            s_f = 1.0 / (1.0 + torch.sqrt(cn_f))
        else:
            s_e, s_f = s_e_in, s_f_in
        g_f_flat = g_f.reshape(-1)
        return ImplicitLinearization(
            cost=total,
            EtE_s=EtE * (s_e[:, :, None] * s_e[:, None, :]),
            FtF_s=FtF * (s_f[:, :, None] * s_f[:, None, :]),
            g_se=g_e * s_e, g_sf=(g_f * s_f).reshape(-1),
            diag_e=torch.clamp(s_e * s_e * cn_e, self.min_diag,
                               self.max_diag),
            diag_f=torch.clamp(s_f * s_f * cn_f, self.min_diag,
                               self.max_diag),
            s_e=s_e, s_f=s_f,
            grad_max=torch.maximum(ge_max,
                                   self._rmax(g_f_flat.abs())).double(),
            grad_norm=torch.sqrt(ge_sq + self._rdot(g_f_flat, g_f_flat)
                                 ).double(),
            chunks=chunks)

    # the reductions to a step's scalars: over everything here; over each
    # element's part in the batched step (batch.py BatchedImplicitStep)
    @staticmethod
    def _rmax(t):
        return t.max()

    @staticmethod
    def _rdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    @staticmethod
    def _rsum(t):
        return torch.sum(t)

    def damped_inverse(self, art: ImplicitLinearization, rad):
        """inv = (E^T E_s + D_e^2)^-1 [ne, te, te] at the radius tensor
        `rad` (in `work`)."""
        return _spd_inv_e(art.EtE_s + torch.diag_embed(art.diag_e / rad))

    def scaled_chunks(self, art: ImplicitLinearization):
        """The scaled chunk tensors of the e and f buckets: (kind, Je_s,
        Jf_s, plan), contiguous (K10's inputs for the "e" kind)."""
        out = []
        for kind, Je, Jf, p in art.chunks:
            if kind == "e0":
                continue          # no F part: enters only through E^T E
            sfrow = art.s_f[p.fids]                 # [ne, k, tf] or [n, tf]
            if kind == "e":
                out.append((kind,
                            (Je * art.s_e[:, None, None, :]).contiguous(),
                            (Jf * sfrow[:, :, None, :]).contiguous(), p))
            else:
                out.append((kind, None,
                            (Jf * sfrow[:, None, :]).contiguous(), p))
        return out

    def solve(self, art: ImplicitLinearization, radius: float) -> dict:
        """The matrix-free damped solve: inv and z, the scaled chunks,
        the reduced rhs, the preconditioner blocks, CG from y = 0 with
        the operator S v (K10 for a single e+f bucket), the
        back-substitution, and the model cost change from the stored
        chunk tensors (an inexact CG step breaks the direct solve's
        identity)."""
        rad = torch.tensor(radius, dtype=self.work,
                           device=self.program.device)
        sys_ = self.reduced_system(art, rad, rad)
        result = conjugate_gradients(sys_["apply_S"], sys_["rhs"],
                                     torch.zeros_like(sys_["rhs"]),
                                     apply_preconditioner=sys_["precond"],
                                     **self.pcg_args)
        delta, mcc = self.step_from(art, sys_, result.x)
        return {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.double(),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": result.num_iterations,
        }

    def reduced_system(self, art: ImplicitLinearization, rad_e, rad_f):
        """The damped system at the radius (rad_e for the points' damping,
        rad_f for the cameras'; both the radius tensor here): inv, b_e, the
        scaled chunks, the operator S v, the reduced rhs and the
        preconditioner apply (None for IDENTITY)."""
        ne, te, kf, tf, nf = self.ne, self.te, self.kf, self.tf, self.nf
        work, dev = self.work, self.program.device
        D2_f = art.diag_f / rad_f                               # [kf, tf]
        inv = self.damped_inverse(art, rad_e)
        b_e, b_f = -art.g_se, -art.g_sf
        z = torch.einsum("nij,nj->ni", inv, b_e)
        sstore = self.scaled_chunks(art)
        es = [c for c in sstore if c[0] == "e"]

        if self.k10:
            _, Je_s0, Jf_s0, p0 = sstore[0]

            def apply_S(v):
                C = implicit_apply(Je_s0, Jf_s0, inv, p0.fids32, v)
                return (self.red.sum(cam_reduce(C, p0.camr, p0.camm))[0]
                        + D2_f * v.view(kf, tf)).reshape(nf)
        else:
            def apply_S(v):
                vb = v.view(kf, tf)
                u = torch.zeros(ne, te, dtype=work, device=dev)
                ws = []
                for kind, Je_s, Jf_s, p in sstore:
                    w = mv(Jf_s, vb[p.fids])
                    if kind == "e":
                        u = u + torch.sum(rvec_rt(Je_s, w), dim=1)
                    ws.append(w)
                zz = torch.sum(inv * u[:, None, :], dim=-1)
                out = torch.zeros(kf, tf, dtype=work, device=dev)
                for (kind, Je_s, Jf_s, p), w in zip(sstore, ws):
                    if kind == "e":
                        w = w - mv(Je_s, zz[:, None, :])
                    out = out + cam_reduce(rvec_rt(Jf_s, w), p.camr,
                                           p.camm)
                return (self.red.sum(out)[0] + D2_f * vb).reshape(nf)

        # reduced rhs: b_f - F_s^T E_s z
        acc = torch.zeros(kf, tf, dtype=work, device=dev)
        for _, Je_s, Jf_s, p in es:
            acc = acc + cam_reduce(rvec_rt(Jf_s, mv(Je_s, z[:, None, :])),
                                   p.camr, p.camm)
        rhs = b_f - self.red.sum(acc)[0].reshape(nf)

        precond = None
        if self.preconditioner != PreconditionerType.IDENTITY:
            blocks = art.FtF_s + torch.diag_embed(D2_f)
            if self.preconditioner == PreconditionerType.SCHUR_JACOBI:
                Ges = [_outer_rt(Je_s, Jf_s) for _, Je_s, Jf_s, _ in es]
                for Ge_s, (_, _, _, p) in zip(Ges, es):
                    M = torch.einsum("nij,nkjt->nkit", inv, Ge_s)
                    blocks = blocks - self.red.sum(cam_reduce(
                        sj_chunk_blocks(Ge_s, M, p.fids, p.dup).reshape(
                            ne, -1, tf * tf), p.camr, p.camm).view(kf, tf,
                                                                   tf))[0]
                for i1, i2 in self.cross_pairs:
                    p1, p2 = es[i1][3], es[i2][3]
                    blocks = blocks - self.red.sum(cam_reduce(
                        sj_cross_pair_blocks(Ges[i1], Ges[i2], inv,
                                             p1.fids, p2.fids).reshape(
                            ne, -1, tf * tf), p1.camr, p1.camm).view(
                                kf, tf, tf))[0]
            precond = precond_from_blocks(blocks)
        return dict(inv=inv, b_e=b_e, es=es, apply_S=apply_S, rhs=rhs,
                    precond=precond)

    def step_from(self, art: ImplicitLinearization, sys_, y):
        """(the f64 step, the model cost change) from the reduced solution
        y: the back-substitution d_e = inv (b_e - E_s^T F_s y) and
        ||J_s d||^2 from the unscaled chunks and the scaled step."""
        ne, te, kf, tf = self.ne, self.te, self.kf, self.tf
        work, dev = self.work, self.program.device
        inv, b_e = sys_["inv"], sys_["b_e"]
        yb = y.view(kf, tf)
        u2 = torch.zeros(ne, te, dtype=work, device=dev)
        for _, Je_s, Jf_s, p in sys_["es"]:
            u2 = u2 + torch.sum(rvec_rt(Je_s, mv(Jf_s, yb[p.fids])), dim=1)
        d_e = torch.sum(inv * (b_e - u2)[:, None, :], dim=-1)

        e_dot = self._rdot(d_e, art.g_se)
        dw_e = art.s_e * d_e
        dw_fb = (art.s_f.reshape(-1) * y).view(kf, tf)
        Jd_sq = torch.zeros((), dtype=work, device=dev)
        for kind, Je, Jf, p in art.chunks:
            if kind == "f":
                Jd = mv(Jf, dw_fb[p.fids])
            else:
                Jd = torch.einsum("nkrt,nt->nkr", Je, dw_e)
                if kind == "e":
                    Jd = Jd + mv(Jf, dw_fb[p.fids])
            Jd_sq = Jd_sq + self._rsum(Jd * Jd)
        e_dot, Jd_sq = self.red.sum(e_dot, Jd_sq)
        d_dot_g = e_dot + self._rdot(y, art.g_sf)
        mcc = -(d_dot_g + 0.5 * Jd_sq)
        return self.step_delta(dw_e, dw_fb), mcc
