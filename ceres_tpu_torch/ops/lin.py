"""K1 linearize, K2 damped elimination and K6 elimination from a given
inverse, for the Snavely Schur step.

Counterpart of ceres_tpu/ops/pallas_lin.py (_lin_kernel, _elim2_kernel,
_elim_kernel). Each function takes tensors in the chunk layout of the
Schur structure: the observations of point n are lanes j < k of row n,
with an int32 camera map cam [ne, k] and a mask [ne, k] (1 on real
lanes).

`lin`, `elim` and `elim_v1` launch the CUDA kernels of csrc/lin.cu and
csrc/elim.cuh for CUDA tensors and run their plain PyTorch versions
(`lin_plain`, `elim_plain`, `elim_v1_plain`) for CPU tensors. Each
wrapper counts its launches in its `launches` attribute. `lin` takes the
lanes' observations as one dat [ne, k, 2] tensor and the camera plan of
the chunk layout (ops/lin_auto.py `camera_plan(cam, mask, kf)`: the
explicit Schur step makes both once; a call on the card without a plan
makes one on the host); K1 is K5's kernel (csrc/lin_auto.cuh) with a
hand-written Snavely chain, launched as K5 is (ops/lin_auto.py
`lane_launch`: K5's block choice, outputs and scratch in one
allocation; the kernel writes every entry of A itself).
A robust loss runs inside K1 (the Triggs corrector after the Snavely
chain, csrc/lin_k1.cuh): one instance of the chain per stock scalar loss
class in csrc/lin.cu, picked by the loss's exact class (`K1_ENTRIES`);
any other loss that the jet compiler traces (ScaledLoss, ComposedLoss,
LossFunctionWrapper, TrivialLoss, nestings, a user's loss) a generated
unit: its rho' and rho'' emitted from make_loss_spec's trace as the loss
struct of the same chain (`k1_loss_unit`), built into _build/ at first
use, one unit a loss structure. The loss's scalars are passed as K5's
are: one set at a row stride of 0, or each lane's (`loss_rows` [ne, k,
nlp], the bucket's per-row scalars in the chunk layout).
`elim_plan` sizes K2's and K6's split-K product (tiles, point ranges,
shared memory, partial sums) in Python, so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _cuda
from . import jetlib as jl
from .jet_compile import eval_loss, loss_structure
from .lin_auto import CameraPlan, lane_launch, lane_loss, loss_spec_of
from ..loss import (ArctanLoss, CauchyLoss, HuberLoss, SoftLOneLoss,
                    TolerantLoss, TukeyLoss, correct_residuals_and_jacobian)
from ..rotation import angle_axis_rotate_point

TF, TE = 9, 3                     # camera and point tangent sizes
# K1's entry point of each loss class (csrc/lin.cu, one chain instance a
# class; exact classes only: a subclass may evaluate another rho)
K1_ENTRIES = {None: "ceres_lin", HuberLoss: "ceres_lin_huber",
              SoftLOneLoss: "ceres_lin_soft_l_one",
              CauchyLoss: "ceres_lin_cauchy", ArctanLoss: "ceres_lin_arctan",
              TolerantLoss: "ceres_lin_tolerant", TukeyLoss: "ceres_lin_tukey"}
# elim.cuh: threads a block, points a stage (one warp each), the widest
# single tile (16 x 10) and the tile past it (16 x 8)
_ELIM_THREADS, _ELIM_GROUP = 256, 8
_ELIM_MAX_R, _ELIM_TILE_R = 10, 8
_ELIM_BLOCKS_PER_SM = 2
# the point sizes of K2 (its closed-form inverses, as the JAX package's
# have_elim2) and of K6 (elim.cuh's instances)
K2_MAX_TE, K6_MAX_TE = 3, 6


def _elim_pw(te):
    """elim.cuh pw: staged words a point, padded to whole 16 B."""
    return (te * te + 2 * te + 3) & ~3


def _elim_qw(te):
    """elim.cuh qw: K2's z words a point."""
    return (te + 3) & ~3


def _snavely_lane(cam, pt, ox, oy, valid):
    """Residual of one observation lane; an inactive lane divides by 1 so
    it stays finite (the TPU kernel's masked-lane guard). Scalars are kept
    as 1-element slices: forward-mode AD of a 0-d tensor combined with a
    Python float promotes the tangent to f64."""
    p = angle_axis_rotate_point(cam[:3], pt) + cam[3:6]
    z = torch.where(valid, p[2:3], torch.ones_like(p[2:3]))
    xp = -(p[0:1] / z)
    yp = -(p[1:2] / z)
    r2 = xp * xp + yp * yp
    fd = cam[6:7] * (r2 * (cam[7:8] + cam[8:9] * r2) + 1.0)
    r = torch.cat([fd * xp - ox, fd * yp - oy])
    return r, r


def lin_plain(xf, xe, cam, mask, obsx, obsy, se_in, first: bool,
              use_scaling: bool = True, loss=None, loss_rows=None):
    """Plain PyTorch K1. Inputs (f32 unless noted): xf [kf*9] cameras,
    xe [ne, 3] points, cam [ne, k] int32, mask/obsx/obsy [ne, k],
    se_in [ne, 3] carried scale, loss_rows [ne, k, nlp] the lanes' own
    loss scalars (or None). Returns a dict:
      ete [ne, 9], ge [ne, 3], se [ne, 3], A [ne, 3, kf*9] (e-scaled),
      ftf [kf, 9, 9], gf [kf, 9]; all unscaled but A's e factor."""
    ne, k = cam.shape
    kf = xf.numel() // TF
    valid = mask > 0.5
    # masked lanes see an all-zero camera, like the TPU kernel's one-hot
    C = xf.view(kf, TF)[cam.long()] * valid[..., None]
    P = xe[:, None, :].expand(ne, k, TE)
    jac = torch.func.vmap(torch.func.jacfwd(_snavely_lane, argnums=(0, 1),
                                            has_aux=True))
    (Jc, Jp), r = jac(C.reshape(-1, TF), P.reshape(-1, TE),
                      obsx.reshape(-1), obsy.reshape(-1), valid.reshape(-1))
    m = mask[..., None]
    r = r.view(ne, k, 2) * m
    J = torch.cat([Jc, Jp], dim=-1).view(ne, k, 2, TF + TE) * m[..., None]
    if loss is not None:
        _, r, J = correct_residuals_and_jacobian(lane_loss(loss, loss_rows),
                                                 r, J)
    Jf, Je = J[..., :TF], J[..., TF:]
    ge = torch.einsum("nkra,nkr->na", Je, r)
    ete = torch.einsum("nkra,nkrb->nab", Je, Je)
    cn = torch.diagonal(ete, dim1=-2, dim2=-1)
    if not use_scaling:
        se = torch.ones_like(cn)
    elif first:
        se = 1.0 / (1.0 + torch.sqrt(cn))
    else:
        se = se_in
    oh = torch.nn.functional.one_hot(cam.long(), kf).to(xf.dtype) * m
    G = torch.einsum("nkra,nkrt->nkat", Je, Jf)
    A = torch.einsum("nkc,nkat->nact", oh, G).reshape(ne, TE, kf * TF)
    return {
        "ete": ete.reshape(ne, TE * TE), "ge": ge, "se": se.contiguous(),
        "A": A * se[:, :, None],
        "ftf": torch.einsum("nkc,nkrt,nkru->ctu", oh, Jf, Jf),
        "gf": torch.einsum("nkc,nkrt,nkr->ct", oh, Jf, r),
    }


def lin(xf, xe, cam, mask, dat, se_in, first: bool,
        use_scaling: bool = True, loss=None,
        plan: Optional[CameraPlan] = None, loss_rows=None):
    """K1: lin_plain's contract, with the observations as dat [ne, k, 2]
    f32 (observed_x, observed_y) and `plan` camera_plan(cam, mask, kf),
    made here when not given (the CPU takes neither)."""
    if not xf.is_cuda:
        return lin_plain(xf, xe, cam, mask, dat[..., 0], dat[..., 1], se_in,
                         first, use_scaling, loss, loss_rows)
    entry, lp = k1_entry(loss)
    launch = (functools.partial(_cuda.launch, entry) if isinstance(entry, str)
              else functools.partial(_cuda.call, entry, "ceres_lin_gen"))
    out = lane_launch(launch, "lin", TE, TF, 2, xf, xe, cam, mask, dat, lp,
                      se_in, first, use_scaling, plan, loss_rows)
    lin.launches += 1
    if not isinstance(entry, str):
        lin.generated_launches += 1
    return out


lin.launches = 0
lin.generated_launches = 0       # of them, through a generated loss unit


def k1_loss_unit(loss) -> str:
    """The CUDA unit of K1 for a loss with no hand instance: the loss
    struct of csrc/lin_k1.cuh's chain (rho' and rho'' of s, as loss.py
    evaluates them in f32, emitted from make_loss_spec's trace with the
    loss's scalars as lp.p[i]) and the entry point ceres_lin_gen."""
    spec = loss_spec_of(loss)
    em = jl.Emitter()
    _, rho1, rho2 = eval_loss(spec, em.input("s"),
                              [em.input(f"lp.p[{i}]")
                               for i in range(spec.n_params)])
    body = "\n".join("    " + ln for ln in em.lines + [
        f"rho1 = {jl.operand(rho1)};", f"rho2 = {jl.operand(rho2)};"])
    return f"""// K1 for loss {spec.key[0]} (graph {spec.digest}), generated by
// ceres_tpu_torch/ops/lin.py; the kernel is csrc/lin_k1.cuh's.
#include "lin_k1.cuh"

namespace {{
struct GeneratedLoss {{
  static constexpr bool kCorrect = true;
  template <class LP>
  static __device__ __forceinline__ void eval(float s, const LP& lp,
                                              float& rho1, float& rho2) {{
{body}
  }}
}};
}}  // namespace

CERES_LIN_ENTRY(ceres_lin_gen, GeneratedLoss)
"""


_GENERATED: dict = {}             # loss structure -> ceres_lin_gen


def k1_entry(loss):
    """(K1's entry point for `loss`, the loss's scalars in loss_structure
    order): the name of a hand instance of csrc/lin.cu for no loss and the
    stock scalar losses (by exact class), else the ceres_lin_gen of the
    loss structure's generated unit (built at first use). Raises
    NotImplementedError for a loss that does not trace."""
    entry = K1_ENTRIES.get(None if loss is None else type(loss))
    if loss is None:
        return entry, []
    key, lp = loss_structure(loss)
    if entry is None:
        entry = _GENERATED.get(key)
        if entry is None:
            lib = _cuda.build_generated("lin_k1", k1_loss_unit(loss))
            entry = lib.ceres_lin_gen
            entry.argtypes = _cuda._SIGNATURES["ceres_lin"]
            entry.restype = ctypes.c_int
            _GENERATED[key] = entry
    return entry, lp


def spd_inv3(M):
    """[..., 3, 3] SPD -> inverse by cofactors (the closed form of
    ceres_tpu/solvers/schur_fused.py::_spd_inv_small for t = 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    inv_det = 1.0 / (a * co00 + b * co01 + c * co02)
    rows = [torch.stack(r, dim=-1) for r in ((co00, co01, co02),
                                             (co01, co11, co12),
                                             (co02, co12, co22))]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def spd_inv_closed(M):
    """[..., t, t] SPD -> inverse in closed form for t = 1, 2 and 3, from
    the upper triangle (the JAX package's _elim2_kernel and
    _spd_inv_small forms, which K2 computes)."""
    t = M.shape[-1]
    if t == 1:
        return 1.0 / M
    if t == 2:
        a, b, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
        inv_det = 1.0 / (a * d - b * b)
        return torch.stack([torch.stack([d, -b], dim=-1),
                            torch.stack([-b, a], dim=-1)],
                           dim=-2) * inv_det[..., None, None]
    if t == 3:
        return spd_inv3(M)
    raise ValueError(f"no closed-form inverse of a {t} x {t} block")


def elim_plain(A, etes, gse, diag, rad):
    """Plain PyTorch K2. A [ne, te, nf] e-scaled cross tensor (te <= 3),
    etes [ne, te^2] scaled point Grams, gse [ne, te] scaled e gradient,
    diag [ne, te] clipped scaled diagonal, rad the trust-region radius (a
    float, used in f32). Returns
    (S_corr [nf, nf], rhs [nf], inv [ne, te, te], z [ne, te]) with
    inv = (etes + diag/rad)^-1 (spd_inv_closed), z = inv (-gse),
    S_corr = sum A^T inv A, rhs = sum A^T z."""
    ne, te = A.shape[0], A.shape[1]
    rad = torch.tensor(rad, dtype=A.dtype, device=A.device)
    M = etes.view(ne, te, te) + torch.diag_embed(diag / rad)
    inv = spd_inv_closed(M)
    z = torch.einsum("nij,nj->ni", inv, -gse)
    S_corr, rhs = elim_v1_plain(A, inv, z)
    return S_corr, rhs, inv, z


@functools.lru_cache(maxsize=64)
def elim_plan(ne, nf, sms, te=TE):
    """K2's and K6's launch plan on a card with `sms` SMs for point blocks
    of `te` columns (csrc/elim.cuh):
    R (a block's output tile is 16 R x 16 R, each of its 256 threads an
    R x R strided part: one tile at nf <= 160, its upper triangle only;
    else tiles of 128 over the nt (nt + 1) / 2 upper tile pairs), the
    point ranges (split s of `splits` takes points [s pts, min(ne,
    (s + 1) pts)): contiguous, in order, covering [0, ne)), the dynamic
    shared memory in
    bytes (elim.cuh smem_floats) and the shapes of the call's `buffers`:
    S_corr, rhs, the partial sums of S_corr and of rhs, inv, z.
    Cached: the LM loop calls K2 or K6 once an iteration at one shape."""
    if ne < 1 or nf < 1:
        raise ValueError(f"elim: ne = {ne}, nf = {nf}; both must be >= 1")
    if nf <= 16 * _ELIM_MAX_R:
        R, nt, tri, ld = -(-nf // 16), 1, True, nf
    else:
        R, tri = _ELIM_TILE_R, False
        nt, ld = -(-nf // (16 * R)), 16 * R
    pairs = nt * (nt + 1) // 2
    nacc = R * (R + 1) // 2 if tri else R * R
    target = max(1, _ELIM_BLOCKS_PER_SM * sms // pairs)
    pts = -(-ne // min(target, ne))
    splits = -(-ne // pts)
    buf = _ELIM_GROUP * te * ld
    tile = _ELIM_GROUP * te * 16 * ((R + 1) & ~1)
    floats = (2 * buf * (2 if nt > 1 else 1) + 2 * tile
              + 2 * _ELIM_GROUP * _elim_pw(te) + _ELIM_GROUP * _elim_qw(te))
    return dict(R=R, nt=nt, tri=tri, pairs=pairs, splits=splits, pts=pts,
                smem=4 * floats,
                buffers=((nf, nf), (nf,), (splits, pairs, nacc, _ELIM_THREADS),
                         (splits, nf), (ne, te, te), (ne, te)))


def _elim_buffers(A, with_point):
    """The plan of one K2/K6 call on A, and its outputs and scratch as
    views of one allocation (one call into the caching allocator, not
    six): S_corr, rhs, the partial sums and, with_point, inv and z."""
    ne, te, nf = A.shape
    plan = elim_plan(ne, nf, _cuda.sm_count(A.device), te)
    shapes = plan["buffers"] if with_point else plan["buffers"][:4]
    flat = torch.empty(sum(math.prod(sh) for sh in shapes),
                       dtype=torch.float32, device=A.device)
    parts = flat.split([math.prod(sh) for sh in shapes])
    return plan, [t.view(sh) for t, sh in zip(parts, shapes)]


def elim(A, etes, gse, diag, rad):
    """K2: see elim_plain for the contract."""
    if not A.is_cuda:
        return elim_plain(A, etes, gse, diag, rad)
    ne, te, nf = A.shape
    if not 1 <= te <= K2_MAX_TE:
        raise ValueError(f"elim: te = {te}; K2 takes 1 to {K2_MAX_TE}")
    f32 = torch.float32
    _cuda.check(A, (ne, te, nf), f32, "elim: A")
    _cuda.check(etes, (ne, te * te), f32, "elim: etes")
    _cuda.check(gse, (ne, te), f32, "elim: gse")
    _cuda.check(diag, (ne, te), f32, "elim: diag")
    plan, (S_corr, rhs, part, rpart, inv, z) = _elim_buffers(A, True)
    _cuda.launch("ceres_elim", A, etes, gse, diag, float(rad), te, ne, nf,
                 plan["R"], plan["nt"], plan["splits"], plan["pts"],
                 plan["smem"], S_corr, rhs, inv, z, part, rpart)
    elim.launches += 1
    return S_corr, rhs, inv, z


elim.launches = 0


def elim_v1_plain(A, inv, z):
    """Plain PyTorch K6. A [ne, te, nf], inv [ne, te, te], z [ne, te]
    (f32). Returns (S_corr [nf, nf], rhs [nf]) with S_corr = sum A^T inv
    A, rhs = sum A^T z."""
    Y = torch.einsum("nuv,nvf->nuf", inv, A)
    S_corr = torch.einsum("nui,nuj->ij", A, Y)
    rhs = torch.einsum("nui,nu->i", A, z)
    return S_corr, rhs


def elim_v1(A, inv, z):
    """K6: see elim_v1_plain for the contract."""
    if not A.is_cuda:
        return elim_v1_plain(A, inv, z)
    ne, te, nf = A.shape
    if not 1 <= te <= K6_MAX_TE:
        raise ValueError(f"elim_v1: te = {te}; K6 takes 1 to {K6_MAX_TE}")
    f32 = torch.float32
    _cuda.check(A, (ne, te, nf), f32, "elim_v1: A")
    _cuda.check(inv, (ne, te, te), f32, "elim_v1: inv")
    _cuda.check(z, (ne, te), f32, "elim_v1: z")
    plan, (S_corr, rhs, part, rpart) = _elim_buffers(A, False)
    _cuda.launch("ceres_elim_v1", A, inv, z, te, ne, nf, plan["R"],
                 plan["nt"], plan["splits"], plan["pts"], plan["smem"],
                 S_corr, rhs, part, rpart)
    elim_v1.launches += 1
    return S_corr, rhs


elim_v1.launches = 0
