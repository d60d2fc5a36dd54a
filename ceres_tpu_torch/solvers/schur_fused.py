"""Fused Schur LM step for Snavely bundle adjustment (mixed precision):
DENSE_SCHUR, and ITERATIVE_SCHUR on an explicit reduced camera matrix S.

Counterpart of ceres_tpu/solvers/schur_fused.py (make_fused_schur_lm_step
with the Pallas lin phase, :386-416; _lin_phase_pallas, :477-554; the
plane-mode DENSE solve, _solve_phase_planes, :1121-1175; the explicit
iterative branch of _solve_phase, :797-886 and :1040-1116;
_spd_solve_dense, :221; _spd_inv_small, :180; the preconditioner blocks,
:1340-1374). The state is f64; the linearization, the Grams, the
elimination and the reduced solve run in f32 and cast back at the same
places as the JAX package:

  linearize (radius-independent, once per accepted step):
    K1 -> E^T E, g_e, s_e, A = (s_e E)^T F, F^T F, g_f;
    the scaled point Grams, the clipped diagonal, the scaled camera Grams.
  solve (once per damped trial), DENSE_SCHUR:
    K2 -> S_corr, rhs part, inv, z;  S = blockdiag(F^T F_s + D_f^2) - S_corr;
    K3 -> y;  back-substitution d_e = inv (b_e - A y);  the model cost
    change from the exact direct solve, ||J_s d||^2 = d.b - ||D d||^2.
  solve, ITERATIVE_SCHUR:
    inv = (E^T E_s + D_e^2)^-1, z = inv b_e in PyTorch;
    K6 -> S_corr, rhs part from inv and z;  S as above;
    the preconditioner's inverted diagonal blocks (IDENTITY, JACOBI or
    SCHUR_JACOBI); K7 -> y and the CG iteration count;  the same
    back-substitution; ||J_s d||^2 from the Gram identity
    d_e^T E^T E_s d_e + 2 d_e.(A y) + y^T blockdiag(F^T F_s) y, since
    an inexact CG step breaks the direct solve's identity.
  cost (every candidate): K4 -> f64 ||r||^2 per observation; rho and the
    sum in f64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..examples.snavely import SnavelyReprojectionError
from ..ops.cost import snavely_sq
from ..ops.kernels import MAX_M, chol_solve
from ..ops.lin import elim, elim_v1, lin, spd_inv3
from ..ops.pcg import dense_pcg
from ..types import LinearSolverType, PreconditionerType
from .preconditioners import spd_inv_small

TF, TE = 9, 3
# ITERATIVE_SCHUR preconditioners assembled exactly from the step's
# tensors (ceres_tpu's iterative_options_ok; SPSE is refused apart)
_FUSED_PRECONDITIONERS = (PreconditionerType.IDENTITY,
                          PreconditionerType.JACOBI,
                          PreconditionerType.SCHUR_JACOBI)


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
    the JAX package runs the matrix-free implicit mode."""
    return meta.nf <= 4096 and meta.ne * meta.te * meta.nf <= 4.2e8


def unsupported_reason(program, options, meta) -> Optional[str]:
    """Why this configuration is outside the ported slice (naming the
    ROADMAP.md item that ports it), or None."""
    lst = options.linear_solver_type
    iterative = lst == LinearSolverType.ITERATIVE_SCHUR
    if lst == LinearSolverType.SPARSE_SCHUR:
        return f"{lst} (ROADMAP.md item 19, solvers/schur_sparse.py)"
    if not iterative and lst != LinearSolverType.DENSE_SCHUR:
        return f"{lst}, which is not a Schur solver (solver.py GenericLMStep)"
    if iterative and options.preconditioner_type not in \
            _FUSED_PRECONDITIONERS:
        return (f"ITERATIVE_SCHUR with {options.preconditioner_type} "
                "(ROADMAP.md item 36, solvers/preconditioners.py)")
    if iterative and options.use_spse_initialization:
        return ("use_spse_initialization (ROADMAP.md item 14, the "
                "host-loop minimizer)")
    if not options.use_mixed_precision_solves:
        return ("the f64 (non-mixed) fused step (ROADMAP.md item 11, the "
                "rest of solvers/schur_fused.py)")
    if options.max_num_refinement_iterations > 0:
        return ("mixed-precision refinement (ROADMAP.md item 15, "
                "solvers/dense.py)")
    if program.has_bounds:
        return ("bounds (ROADMAP.md item 11, the rest of "
                "solvers/schur_fused.py)")
    if program.has_manifolds:
        return ("non-Euclidean manifolds in the fused Schur step "
                "(ROADMAP.md item 11, the rest of solvers/schur_fused.py)")
    if meta is None or len(meta.f_groups) != 1:
        return ("no single-group Schur structure (ROADMAP.md item 18, the "
                "rest of solvers/schur.py)")
    if len(program.buckets) != 1 or len(meta.buckets) != 1:
        return ("more than one residual-block bucket (ROADMAP.md item 11, "
                "the generic fused lin phase)")
    bk, bs = program.buckets[0], meta.buckets[0]
    if not isinstance(getattr(bk.cost, "functor", None),
                      SnavelyReprojectionError):
        return ("a functor other than SnavelyReprojectionError (ROADMAP.md "
                "item 11, the generic fused lin phase; item 35, K5)")
    grp = meta.f_groups[0]
    if meta.te != TE or grp["t"] != TF or bk.r != 2:
        return ("a Schur shape other than Snavely's (2, 3, 9) (ROADMAP.md "
                "item 11, the generic fused lin phase)")
    if bs.e_slot is None or bs.f_cols is None or bs.chunk_rows is None:
        return ("no chunk layout for the bucket (ROADMAP.md item 18, the "
                "rest of solvers/schur.py)")
    if not program.tangent_is_ambient or _slab_of(meta.e_cols) != 0 or \
            _slab_of(meta.f_global_cols[grp["cols"]]) != meta.ne * TE:
        return ("constant blocks or another state layout than [points | "
                "cameras] (ROADMAP.md item 11, the rest of "
                "solvers/schur_fused.py)")
    if bk.loss is not None and torch.device(options.device).type == "cuda":
        return ("a robust loss on the CUDA path (ROADMAP.md item 9, "
                "robust-loss K1)")
    if not _explicit_viable(meta):
        if iterative:
            return ("the implicit (matrix-free) ITERATIVE_SCHUR regime, "
                    "where S and A are too large to form (ROADMAP.md item "
                    "23, slice 4)")
        return ("a reduced camera system too large to form densely "
                "(ROADMAP.md item 18, the rest of solvers/schur.py)")
    if meta.nf > MAX_M:
        return (f"a reduced camera system of m = {meta.nf} > {MAX_M}, past "
                "the one-block K3 and K7 (ROADMAP.md item 37, K7 and K3 "
                "beyond m = 1024)")
    return None


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


@dataclass
class Linearization:
    """Radius-independent artifacts of one linearization (f32 unless
    noted). s_e/s_f are the Jacobi scales carried to the next one."""
    cost: torch.Tensor          # f64 total cost at x
    A: torch.Tensor             # [ne, 3, nf] e-scaled cross tensor
    etes: torch.Tensor          # [ne, 9] scaled point Grams
    gse: torch.Tensor           # [ne, 3] scaled e gradient
    diag_e: torch.Tensor        # [ne, 3] clipped scaled diagonal
    s_e: torch.Tensor           # [ne, 3]
    s_f: torch.Tensor           # [kf, 9]
    FtF_s: torch.Tensor         # [kf, 9, 9] scaled camera Grams
    g_sf: torch.Tensor          # [nf] scaled f gradient
    diag_f: torch.Tensor        # [kf, 9] clipped scaled diagonal
    grad_max: torch.Tensor      # f64 max |gradient|
    grad_norm: torch.Tensor     # f64 ||gradient||

    @property
    def scales(self):
        return (self.s_e, self.s_f)


class FusedSchurStep:
    """The slice's LM step: `linearize`, `solve` and `cost` over the
    tensors of one program, for DENSE_SCHUR or ITERATIVE_SCHUR. Holds the
    chunk-layout constants on the program's device."""

    def __init__(self, program, options, meta):
        reason = unsupported_reason(program, options, meta)
        if reason is not None:
            raise NotImplementedError(f"not in the ported slice: {reason}")
        self.program = program
        self.use_scaling = bool(options.jacobi_scaling)
        self.min_diag = options.min_lm_diagonal
        self.max_diag = options.max_lm_diagonal
        self.loss = program.buckets[0].loss
        self.iterative = (options.linear_solver_type
                          == LinearSolverType.ITERATIVE_SCHUR)
        self.preconditioner = options.preconditioner_type
        self.pcg_args = dict(
            max_iterations=options.max_linear_solver_iterations,
            min_iterations=options.min_linear_solver_iterations,
            q_tolerance=options.eta)
        bk, bs = program.buckets[0], meta.buckets[0]
        grp = meta.f_groups[0]
        self.ne, self.kf = meta.ne, grp["kf"]
        self.nf = self.kf * TF
        self.e_slab = _slab_of(meta.e_cols)
        self.f_slab = _slab_of(meta.f_global_cols[grp["cols"]])
        dev = program.device
        (_, _, local) = [s for s in grp["slots"] if s[0] == 0][0]
        rows, cmask = bs.chunk_rows, bs.chunk_mask       # [ne, k]
        obs_x = bk.data["observed_x"].cpu().numpy()
        obs_y = bk.data["observed_y"].cpu().numpy()

        def chunk(a, dtype):
            return torch.as_tensor(
                np.ascontiguousarray(a[rows] * cmask).astype(dtype),
                device=dev)

        # K1 inputs, chunk layout (masked lanes: camera 0, obs 0, mask 0)
        self.cam = chunk(np.asarray(local), np.int32)
        self.mask = torch.as_tensor(np.ascontiguousarray(cmask, np.float32),
                                    device=dev)
        self.obsx = chunk(obs_x.astype(np.float32), np.float32)
        self.obsy = chunk(obs_y.astype(np.float32), np.float32)
        # K4 inputs, bucket row order
        self.pt_idx = torch.as_tensor(bs.e_ids.astype(np.int32),
                                      device=dev)
        self.cam_idx = torch.as_tensor(np.asarray(local, np.int32),
                                       device=dev)
        self.obsx64 = bk.data["observed_x"].contiguous()
        self.obsy64 = bk.data["observed_y"].contiguous()
        # a direct solve is one linear iteration (kept on the device)
        self.one = torch.ones((), dtype=torch.int32, device=dev)

    def initial_scales(self):
        """Zero scales for the first linearization (which derives them)."""
        dev = self.program.device
        return (torch.zeros(self.ne, TE, dtype=torch.float32, device=dev),
                torch.zeros(self.kf, TF, dtype=torch.float32, device=dev))

    def cost(self, x):
        """f64 total cost at x through K4."""
        sq = snavely_sq(x, self.e_slab, self.f_slab, self.pt_idx,
                        self.cam_idx, self.obsx64, self.obsy64)
        rho = sq if self.loss is None else self.loss.evaluate(sq)[0]
        return self.program.fixed_cost + 0.5 * torch.sum(rho)

    def linearize(self, x, s_e, s_f, first: bool,
                  known_cost=None) -> Linearization:
        """Linearize at x. first=True derives the Jacobi scales from this
        linearization's Gram diagonals; otherwise s_e/s_f are used."""
        if known_cost is None:
            known_cost = self.program.cost_fn(x)
        ne, kf, nf = self.ne, self.kf, self.nf
        xe = x[self.e_slab:self.e_slab + ne * TE].view(ne, TE).float()
        xf = x[self.f_slab:self.f_slab + nf].float()
        out = lin(xf, xe, self.cam, self.mask, self.obsx, self.obsy,
                  s_e.contiguous(), first, self.use_scaling, self.loss)
        ete, ge, se = out["ete"], out["ge"], out["se"]
        FtF, g_f = out["ftf"], out["gf"]
        cn_f = torch.diagonal(FtF, dim1=-2, dim2=-1)
        if not self.use_scaling:
            s_f = torch.ones_like(cn_f)
        elif first:
            s_f = 1.0 / (1.0 + torch.sqrt(cn_f))
        se_outer = (se[:, :, None] * se[:, None, :]).reshape(ne, TE * TE)
        cn_e = ete[:, ::TE + 1]
        g_f_flat = g_f.reshape(nf)
        grad_max = torch.maximum(ge.abs().max(), g_f_flat.abs().max())
        grad_norm = torch.sqrt(torch.dot(ge.reshape(-1), ge.reshape(-1))
                               + torch.dot(g_f_flat, g_f_flat))
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
        """inv = (E^T E_s + D_e^2)^-1 [ne, 3, 3] and z = inv (-g_se)
        [ne, 3] at the f32 radius tensor `rad` (K6's inputs)."""
        inv = spd_inv3(art.etes.view(self.ne, TE, TE)
                       + torch.diag_embed(art.diag_e / rad))
        return inv, torch.einsum("nij,nj->ni", inv, -art.gse)

    def reduced_system(self, art: Linearization, radius: float):
        """The elimination (K2 for DENSE_SCHUR; inv, z and K6 for
        ITERATIVE_SCHUR) and the assembly of the reduced camera system at
        `radius`: returns (S [nf, nf], rhs [nf], inv [ne, 3, 3], rad f32
        tensor)."""
        kf, nf = self.kf, self.nf
        rad = torch.tensor(radius, dtype=torch.float32,
                           device=self.program.device)
        sA = art.s_f.reshape(nf)
        if self.iterative:
            inv, z = self.point_inverse(art, rad)
            S_corr_u, rhsa_u = elim_v1(art.A, inv, z)
        else:
            S_corr_u, rhsa_u, inv, _ = elim(art.A, art.etes, art.gse,
                                            art.diag_e,
                                            float(np.float32(radius)))
        rhs = -art.g_sf - sA * rhsa_u
        S = -(S_corr_u * (sA[:, None] * sA[None, :]))
        S = S.view(kf, TF, kf, TF)
        ii = torch.arange(kf, device=S.device)
        S[ii, :, ii, :] += art.FtF_s + torch.diag_embed(art.diag_f / rad)
        return S.view(nf, nf).contiguous(), rhs.contiguous(), inv, rad

    def precond_inverse(self, art: Linearization, S, rad):
        """The inverted [kf, 9, 9] preconditioner blocks of the reduced
        CG, or None for IDENTITY."""
        blocks = precond_blocks(
            art.FtF_s + torch.diag_embed(art.diag_f / rad), S, self.kf, TF,
            self.preconditioner)
        return None if blocks is None else spd_inv_small(blocks).contiguous()

    def solve(self, art: Linearization, radius: float) -> dict:
        """Damped solve at `radius`: the LM step and its model cost
        change (same contract as the JAX step's output dict)."""
        kf, nf = self.kf, self.nf
        S, rhs, inv, rad = self.reduced_system(art, radius)
        if self.iterative:
            y, lin_iters, _ = dense_pcg(S, rhs,
                                        self.precond_inverse(art, S, rad),
                                        **self.pcg_args)
        else:
            y, lin_iters = chol_solve(S, rhs), self.one
        sA = art.s_f.reshape(nf)

        # back-substitution: d_e = inv (b_e - A y)
        Ay = torch.einsum("nuf,f->nu", art.A, sA * y)
        d_e = torch.einsum("nij,nj->ni", inv, -art.gse - Ay)
        d_dot_g = torch.sum(d_e * art.gse) + torch.dot(y, art.g_sf)
        if self.iterative:
            # the Gram identity: J^T J = [[EtE, A], [A^T, blockdiag(FtF)]]
            # for the BA structure, with Ay reused from the back-substitution
            yb = y.view(kf, TF)
            Jd_sq = (torch.sum(d_e * torch.einsum(
                         "nuv,nv->nu", art.etes.view(-1, TE, TE), d_e))
                     + 2.0 * torch.sum(d_e * Ay)
                     + torch.sum(yb * torch.einsum("ctu,cu->ct", art.FtF_s,
                                                   yb)))
        else:
            Dd_sq = (torch.sum((art.diag_e / rad) * d_e * d_e)
                     + torch.sum((art.diag_f / rad).reshape(nf) * y * y))
            Jd_sq = -d_dot_g - Dd_sq          # exact direct solve
        mcc = -(d_dot_g + 0.5 * Jd_sq)
        # the state layout is [points | cameras] (unsupported_reason)
        delta = torch.cat([(art.s_e * d_e).double().reshape(-1),
                           (sA * y).double()])
        return {
            "cost": art.cost,
            "gradient_max_norm": art.grad_max,
            "gradient_norm": art.grad_norm,
            "delta": delta,
            "model_cost_change": mcc.double(),
            "step_norm": torch.linalg.vector_norm(delta),
            "lin_iters": lin_iters,
        }
