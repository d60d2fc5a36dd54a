"""K3, dense SPD solve of the small reduced camera system; K8, the CGNR
operator J^T (J v) of one bucket; K9, the per-row Gram blocks J^T J of
one bucket's slot.

Counterpart of ceres_tpu/ops/pallas_kernels.py (chol_solve_small,
bucket_jtjv, jac_normal_matvec, bucket_gram_blocks). `chol_solve`
launches one of csrc/chol.cu's two variants for CUDA tensors (picked by
`chol_variant` from m: U in shared memory up to the edge
`chol_smem_bytes` sets, else in a global scratch) and runs
`chol_solve_plain` for CPU tensors; all three factor S = U^T U right-
looking (the shared variant in panels of 16 rows), with the same
roundings in the same order, and give NaN for an indefinite S (the LM
loop's invalid-step retry relies on it).
`bucket_jtjv` launches csrc/jtjv.cu and
`bucket_gram_blocks` csrc/gram.cu for CUDA tensors, and run
`bucket_jtjv_plain` and `bucket_gram_blocks_plain` for CPU tensors. Each
wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import _cuda

MAX_M = 1024
# shared memory one block may opt in to on the H100 (227 KB)
SMEM_OPTIN = 232448
_F32, _I32 = torch.float32, torch.int32


def chol_solve_plain(S, b):
    """Plain PyTorch K3: y with S y = b, S SPD [m, m] (f32), b [m]."""
    m = S.shape[0]
    U = S.clone()
    nan = torch.tensor(float("nan"), dtype=S.dtype, device=S.device)
    for j in range(m):
        piv = U[j, j]
        d = torch.where(piv > 0, torch.sqrt(torch.clamp(piv, min=0)), nan)
        U[j, j + 1:] = U[j, j + 1:] / d
        U[j, j] = d
        urow = U[j, j + 1:]
        U[j + 1:, j + 1:] -= torch.triu(urow[:, None] * urow[None, :])
    acc = b.clone()
    z = torch.empty_like(b)
    for j in range(m):
        z[j] = acc[j] / U[j, j]
        acc[j + 1:] -= z[j] * U[j, j + 1:]
    acc = z.clone()
    y = torch.empty_like(b)
    for j in range(m - 1, -1, -1):
        y[j] = acc[j] / U[j, j]
        acc[:j] -= U[:j, j] * y[j]
    return y


def chol_smem_bytes(m):
    """Shared memory of the shared-memory variant at m (csrc/chol.cu
    shared_bytes): S with b as its column m, padded to 32 T rows of
    32 T + 4 floats for T = ceil((m + 1) / 32) tiles of 32 columns."""
    t = (m + 32) // 32
    return 4 * 32 * t * (32 * t + 4)


def chol_variant(m):
    """The K3 variant for an [m, m] system: "shared" while S and b fit in
    SMEM_OPTIN bytes of shared memory (m <= 223), else "global" (m <=
    MAX_M). Raises past MAX_M."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"chol_solve: m = {m} outside 1..{MAX_M}")
    return "shared" if chol_smem_bytes(m) <= SMEM_OPTIN else "global"


def _chol_launch(S, b, variant):
    """Launch K3's `variant` ("shared" or "global", csrc/chol.cu) on the
    card and count it in chol_solve.launches and CHOL_VARIANTS[variant].
    The tests and chip_smoke.py call it to hold each variant against the
    plain version; an m the variant cannot take is refused by its entry
    point, and the refusal raises."""
    m = S.shape[0]
    _cuda.check(S, (m, m), _F32, "chol_solve: S")
    _cuda.check(b, (m,), _F32, "chol_solve: b")
    y = torch.empty_like(b)
    if variant == "shared":
        _cuda.launch("ceres_chol_solve_shared", S, b, m, y)
    elif variant == "global":
        _cuda.launch("ceres_chol_solve", S, b, m, torch.empty_like(S), y)
    else:
        raise ValueError(f"chol_solve: no variant {variant!r}")
    chol_solve.launches += 1
    CHOL_VARIANTS[variant].launches += 1
    return y


def chol_solve(S, b):
    """K3: see chol_solve_plain; m <= MAX_M on the card, the variant from
    chol_variant(m)."""
    if not S.is_cuda:
        return chol_solve_plain(S, b)
    return _chol_launch(S, b, chol_variant(S.shape[0]))


chol_solve.launches = 0
# launches of each K3 variant (each also counts in chol_solve.launches)
CHOL_VARIANTS = {v: SimpleNamespace(launches=0) for v in ("shared", "global")}


def bucket_jtjv_plain(J, v, cols):
    """Plain PyTorch K8: u [n, t] = J_n^T (J_n v[cols_n]) for J [n, r, t],
    the tangent vector v [m] and the rows' columns cols [n, t] (int32):
    the gather, then ceres_tpu's two einsums."""
    vb = v[cols]
    w = torch.einsum("nrt,nt->nr", J, vb)
    return torch.einsum("nrt,nr->nt", J, w)


def bucket_jtjv(J, v, cols, out=None):
    """K8: see bucket_jtjv_plain; f32, r <= 32 on the card, the gather of
    v done in the kernel. Writes u into `out` ([n, t], contiguous) when
    given, else into a new tensor, and returns it. The CG loop calls it
    tens of thousands of times a solve, so the checks are one boolean
    chain, and the messages are built only when it fails."""
    if not J.is_cuda:
        u = bucket_jtjv_plain(J, v, cols)
        return u if out is None else out.copy_(u)
    n, r, t = J.shape
    if not (J.dtype is _F32 and v.dtype is _F32 and cols.dtype is _I32
            and v.is_cuda and cols.is_cuda and v.dim() == 1
            and cols.shape == (n, t) and 1 <= r <= 32
            and J.is_contiguous() and v.is_contiguous()
            and cols.is_contiguous()):
        if not 1 <= r <= 32:
            raise ValueError(f"bucket_jtjv: r = {r} outside 1..32")
        _cuda.check(J, (n, r, t), _F32, "bucket_jtjv: J")
        _cuda.check(v, (v.numel(),), _F32, "bucket_jtjv: v")
        _cuda.check(cols, (n, t), _I32, "bucket_jtjv: cols")
    if out is None:
        out = J.new_empty((n, t))
    else:
        _cuda.check(out, (n, t), _F32, "bucket_jtjv: out")
    _cuda.launch("ceres_jtjv", J, v, cols, n, r, t, out)
    bucket_jtjv.launches += 1
    return out


bucket_jtjv.launches = 0


def jac_normal_matvec(jac, v):
    """(J^T J) v over a BlockJacobian, one K8 launch per bucket, which
    gathers v itself and writes its rows' products into its part of one
    buffer, in the buckets' order; the fixed-order column sum of that
    buffer stays outside the kernel (ceres_tpu's jac_normal_matvec)."""
    shapes = [(b.J.shape[0], b.J.shape[2]) for b in jac.buckets]
    flat = v.new_empty(sum(n * t for n, t in shapes))
    off = 0
    for b, (n, t) in zip(jac.buckets, shapes):
        bucket_jtjv(b.J, v, b.cols32, out=flat[off:off + n * t].view(n, t))
        off += n * t
    return jac.col_sum.sum_flat(flat)


def bucket_gram_blocks_plain(J):
    """Plain PyTorch K9: G [n, t, t] = J_n^T J_n for J [n, r, t]."""
    return torch.einsum("nrt,nru->ntu", J, J)


def bucket_gram_blocks(J):
    """K9: see bucket_gram_blocks_plain; f32 on the card, J a view whose
    last dimension is contiguous (a slot's columns of a bucket's
    Jacobian, read in place)."""
    if not J.is_cuda:
        return bucket_gram_blocks_plain(J)
    n, r, t = J.shape
    if J.dtype != torch.float32 or (t > 1 and J.stride(2) != 1):
        raise ValueError(f"bucket_gram_blocks: expected f32 with unit "
                         f"column stride, got {J.dtype}, strides "
                         f"{J.stride()}")
    G = torch.empty(n, t, t, dtype=torch.float32, device=J.device)
    _cuda.launch("ceres_gram", J, n, r, t, J.stride(0), J.stride(1), G)
    bucket_gram_blocks.launches += 1
    return G


bucket_gram_blocks.launches = 0
