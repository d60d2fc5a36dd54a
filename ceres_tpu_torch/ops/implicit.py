"""K10, the matrix-free Schur operator of the implicit ITERATIVE_SCHUR
step, per point and lane of the chunk layout.

Counterpart of ceres_tpu/ops/pallas_implicit.py (_apply_kernel with the
v-row gather of make_pallas_implicit_apply's caller folded in). For the
e-scaled point chunks Je_s [ne, k, r, te], the f-scaled camera chunks
Jf_s [ne, k, r, tf], the damped point inverses inv [ne, te, te], the
camera of each lane fids [ne, k] (int32) and v [kf * tf]:

    w = Jf_s v[fids],  u = sum_k Je_s^T w,  zz = inv u,
    C = Jf_s^T (w - Je_s zz)              -> C [ne, k, tf]

The camera-chunk reduce of C and the + D_f^2 v term stay with the caller
(solvers/schur_fused.py), as in the JAX package. `implicit_apply`
launches csrc/implicit.cu for CUDA tensors, at any (r, te, tf): the
kernel's smallest tier that holds the shape (TIERS: two instances with
compile-time maxima, then the general one, which walks the shape at run
time), and runs `implicit_apply_plain` for CPU tensors. It counts its
launches in `implicit_apply.launches`, and each tier's in
`TIER_COUNTERS[tier].launches`. `implicit_plan` gives a launch's plan
(threads, whether v is staged in shared memory, shared memory, the
general tier's scratch in device memory).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# csrc/implicit.cu's tiers 0 and 1 with their (r, te, tf) maxima; any
# other shape takes tier 2, the general kernel. The wrapper picks the
# first tier of TIERS that holds the shape; a check that holds a larger
# tier at a smaller shape leaves the smaller ones out of TIERS for its run.
TIERS = {0: (4, 4, 16), 1: (4, 4, 32)}
GENERAL_TIER = 2
# the most shared memory (bytes) the general kernel's scratch may take
# before it goes to device memory; None: the card's opt-in. A check of the
# device-memory path sets it to 0.
SCRATCH_SMEM_BYTES = None


class _Counter:
    """The launches of one tier of K10."""

    def __init__(self):
        self.launches = 0


TIER_COUNTERS = [_Counter() for _ in range(GENERAL_TIER + 1)]


def implicit_tier(r: int, te: int, tf: int) -> int:
    """The tier of csrc/implicit.cu that a launch at (r, te, tf) takes."""
    for tier, (mr, mte, mtf) in TIERS.items():
        if r <= mr and te <= mte and tf <= mtf:
            return tier
    return GENERAL_TIER


def _scratch_smem() -> int:
    return -1 if SCRATCH_SMEM_BYTES is None else int(SCRATCH_SMEM_BYTES)


def implicit_plan(ne, k, r, te, tf, kf) -> dict:
    """The plan of a K10 launch at this shape on the current card
    (csrc/implicit.cu ceres_implicit_plan): its tier, threads a block,
    whether v is staged in shared memory ("stage"), the dynamic shared
    memory in bytes, and the general tier's scratch in device memory
    (floats a block and blocks; 0 when it fits in shared memory)."""
    tier = implicit_tier(r, te, tf)
    out = (ctypes.c_int * 6)()
    _cuda.library()
    err = _cuda._ENTRY["ceres_implicit_plan"](ne, k, r, te, tf, kf, tier,
                                              _scratch_smem(), out)
    if err:
        raise ValueError(f"implicit_plan: no plan at (ne, k, r, te, tf, kf)"
                         f" = {(ne, k, r, te, tf, kf)}")
    return dict(tier=out[0], threads=out[1], stage=bool(out[2]),
                smem=out[3], scratch_floats=out[4], scratch_blocks=out[5])


def _sum_in_order(terms):
    """terms[0] + terms[1] + ..., each addition rounded on its own."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def implicit_apply_plain(Je_s, Jf_s, inv, fids, v):
    """Plain PyTorch K10: the JAX package's XLA apply for one bucket,
    with every sum taken term by term in the kernel's order (products
    and sums rounded apart), so that it equals the kernel bit for bit."""
    _, k, r, te = Je_s.shape
    tf = Jf_s.shape[-1]
    vrow = v.view(-1, tf)[fids.long()]                     # [ne, k, tf]
    w = [_sum_in_order([Jf_s[:, :, q, t] * vrow[:, :, t]
                        for t in range(tf)]) for q in range(r)]
    lane_u = [_sum_in_order([Je_s[:, :, q, a] * w[q] for q in range(r)])
              for a in range(te)]                          # [ne, k] each
    u = [_sum_in_order([x[:, j] for j in range(k)]) for x in lane_u]
    zz = [_sum_in_order([inv[:, a, b] * u[b] for b in range(te)])[:, None]
          for a in range(te)]                              # [ne, 1] each
    w2 = []
    for q in range(r):
        acc = w[q]
        for a in range(te):
            acc = acc - Je_s[:, :, q, a] * zz[a]
        w2.append(acc)
    return torch.stack([_sum_in_order([Jf_s[:, :, q, t] * w2[q]
                                       for q in range(r)])
                        for t in range(tf)], dim=-1)


def implicit_apply(Je_s, Jf_s, inv, fids, v):
    """K10: see implicit_apply_plain for the contract."""
    if not Je_s.is_cuda:
        return implicit_apply_plain(Je_s, Jf_s, inv, fids, v)
    ne, k, r, te = Je_s.shape
    tf = Jf_s.shape[-1]
    if v.numel() % tf:
        raise ValueError("implicit_apply: v is not a whole number of f "
                         "blocks")
    kf = v.numel() // tf
    f32 = torch.float32
    _cuda.check(Je_s, (ne, k, r, te), f32, "implicit_apply: Je_s")
    _cuda.check(Jf_s, (ne, k, r, tf), f32, "implicit_apply: Jf_s")
    _cuda.check(inv, (ne, te, te), f32, "implicit_apply: inv")
    _cuda.check(fids, (ne, k), torch.int32, "implicit_apply: fids")
    _cuda.check(v, (kf * tf,), f32, "implicit_apply: v")
    tier = implicit_tier(r, te, tf)
    C = torch.empty(ne, k, tf, dtype=f32, device=Je_s.device)
    scratch = None
    if tier == GENERAL_TIER:
        plan = implicit_plan(ne, k, r, te, tf, kf)
        if plan["scratch_floats"]:
            scratch = torch.empty(plan["scratch_floats"]
                                  * plan["scratch_blocks"], dtype=f32,
                                  device=Je_s.device)
    _cuda.launch("ceres_implicit_apply", Je_s, Jf_s, inv, fids, v, ne, k, r,
                 te, tf, kf, tier, _scratch_smem(),
                 0 if scratch is None else scratch, C)
    implicit_apply.launches += 1
    TIER_COUNTERS[tier].launches += 1
    return C


implicit_apply.launches = 0
