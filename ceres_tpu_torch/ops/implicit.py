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
launches csrc/implicit.cu for CUDA tensors (te <= 4, tf <= 16, r <= 4)
and runs `implicit_apply_plain` for CPU tensors; it counts its launches
in `implicit_apply.launches`.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_TE, MAX_TF, MAX_R = 4, 16, 4


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
    if not (1 <= te <= MAX_TE and 1 <= tf <= MAX_TF and 1 <= r <= MAX_R):
        raise ValueError(f"implicit_apply: (r, te, tf) = {(r, te, tf)} past "
                         f"the kernel's ({MAX_R}, {MAX_TE}, {MAX_TF})")
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
    C = torch.empty(ne, k, tf, dtype=f32, device=Je_s.device)
    _cuda.launch("ceres_implicit_apply", Je_s, Jf_s, inv, fids, v, ne, k, r,
                 te, tf, kf, C)
    implicit_apply.launches += 1
    return C


implicit_apply.launches = 0
