"""K3, dense SPD solve of the small reduced camera system; K8, the CGNR
operator J^T (J v) of one bucket; K9, the block-Jacobi Grams J^T J: a
tangent-size group's block diagonal in one launch, and the per-row Gram
blocks of one bucket's slot (the same kernel on one view).

Counterpart of ceres_tpu/ops/pallas_kernels.py (chol_solve_small,
bucket_jtjv, jac_normal_matvec, bucket_gram_blocks). `chol_solve`
launches one of csrc/chol.cu's two variants for CUDA tensors (picked by
`chol_variant` from m: U in shared memory up to the edge
`chol_smem_bytes` sets, else in a global scratch) and runs
`chol_solve_plain` for CPU tensors; all three factor S = U^T U right-
looking (the shared variant in panels of 16 rows), with the same
roundings in the same order, and give NaN for an indefinite S (the LM
loop's invalid-step retry relies on it).
`bucket_jtjv` launches csrc/jtjv.cu, and `group_gram_blocks` and
`bucket_gram_blocks` csrc/gram.cu, for CUDA tensors, and run
`bucket_jtjv_plain`, `group_gram_blocks_plain` and
`bucket_gram_blocks_plain` for CPU tensors. Each wrapper counts its
launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from . import _cuda

MAX_M = 1024
# shared memory one block may opt in to on the H100 (227 KB)
SMEM_OPTIN = 232448
_F32, _I32 = torch.float32, torch.int32


def chol_solve_plain(S, b):
    """Plain PyTorch K3: y with S y = b, S SPD [..., m, m] (f32), b
    [..., m]: one system, or a batch of them along the leading axes."""
    m = S.shape[-1]
    U = S.clone()
    nan = torch.tensor(float("nan"), dtype=S.dtype, device=S.device)
    for j in range(m):
        piv = U[..., j, j]
        d = torch.where(piv > 0, torch.sqrt(torch.clamp(piv, min=0)), nan)
        U[..., j, j + 1:] = U[..., j, j + 1:] / d[..., None]
        U[..., j, j] = d
        urow = U[..., j, j + 1:]
        U[..., j + 1:, j + 1:] -= torch.triu(urow[..., :, None]
                                             * urow[..., None, :])
    acc = b.clone()
    z = torch.empty_like(b)
    for j in range(m):
        z[..., j] = acc[..., j] / U[..., j, j]
        acc[..., j + 1:] -= z[..., j, None] * U[..., j, j + 1:]
    acc = z.clone()
    y = torch.empty_like(b)
    for j in range(m - 1, -1, -1):
        y[..., j] = acc[..., j] / U[..., j, j]
        acc[..., :j] -= U[..., :j, j] * y[..., j, None]
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
    card, on one system (S [m, m], b [m]) or a batch of them (S [B, m, m],
    b [B, m]: one block a system, one launch), and count it in
    chol_solve.launches and CHOL_VARIANTS[variant].
    The tests and chip_smoke.py call it to hold each variant against the
    plain version; an m the variant cannot take is refused by its entry
    point, and the refusal raises."""
    m = S.shape[-1]
    lead = tuple(S.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"chol_solve: S {tuple(S.shape)}: one batch axis "
                         f"at most")
    nb = lead[0] if lead else 1
    _cuda.check(S, lead + (m, m), _F32, "chol_solve: S")
    _cuda.check(b, lead + (m,), _F32, "chol_solve: b")
    y = torch.empty_like(b)
    if nb == 0:
        return y
    if variant == "shared":
        _cuda.launch("ceres_chol_solve_shared", S, b, m, nb, y)
    elif variant == "global":
        _cuda.launch("ceres_chol_solve", S, b, m, nb, torch.empty_like(S), y)
    else:
        raise ValueError(f"chol_solve: no variant {variant!r}")
    chol_solve.launches += 1
    CHOL_VARIANTS[variant].launches += 1
    return y


def chol_solve(S, b):
    """K3: see chol_solve_plain; one system or a batch ([B, m, m], [B, m])
    in one launch; m <= MAX_M on the card, the variant from
    chol_variant(m)."""
    if not S.is_cuda:
        return chol_solve_plain(S, b)
    return _chol_launch(S, b, chol_variant(S.shape[-1]))


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


def row_grams(J):
    """G [n, t, t] = J_n^T J_n for J [n, r, t], one einsum: K9's per-row
    contract, and the f64 Grams, which the JAX package forms so, outside
    any Pallas kernel."""
    return torch.einsum("nrt,nru->ntu", J, J)


# plain PyTorch K9 per row
bucket_gram_blocks_plain = row_grams


@functools.lru_cache(maxsize=64)
def _identity_order(n, device):
    """(gram_map, gram_off) of block k = row k of one view, made once per
    row count and device."""
    rows = torch.arange(n + 1, dtype=_I32, device=device)
    return torch.stack([torch.zeros_like(rows[:n]), rows[:n]], dim=1), rows


def bucket_gram_blocks(J):
    """K9 per row: see row_grams (the TPU kernel's contract); f32 on the
    card, J a view whose last dimension is contiguous (a slot's columns
    of a bucket's Jacobian, read in place). The card runs the group
    kernel on the one view with the identity order (block n = row n)."""
    if not J.is_cuda:
        return bucket_gram_blocks_plain(J)
    G = _gram_launch([J], *_identity_order(J.shape[0], J.device),
                     "bucket_gram_blocks")
    bucket_gram_blocks.launches += 1
    return G


bucket_gram_blocks.launches = 0

# slot views one launch of csrc/gram.cu's kernel takes; a group of more
# takes one launch per GRAM_VIEWS
GRAM_VIEWS = 8


def gram_sum(grams, gram_map, gram_off):
    """A group's per-row Grams summed per block in its fixed order:
    grams[v] [n_v, t, t] the rows of slot view v; block k is the sum, in
    order, of the rows gram_map[gram_off[k] : gram_off[k + 1]] ((view,
    row) pairs, int32). A gather and torch.segment_reduce: in order on
    the CPU (the JAX package's scatter bits), by CUB's segmented reduce
    on the card."""
    sizes = torch.tensor([0] + [G.shape[0] for G in grams[:-1]],
                         device=gram_map.device)
    idx = torch.cumsum(sizes, 0)[gram_map[:, 0].long()] + gram_map[:, 1]
    return torch.segment_reduce(torch.cat(grams)[idx], "sum",
                                lengths=torch.diff(gram_off).long(),
                                axis=0, unsafe=True)


def group_grams(views, gram_map, gram_off):
    """One tangent-size group's Grams out [k, t, t]: block k the sum of
    row_grams over the rows of the slot views [n_v, r_v, t] that touch
    it, in the group's fixed order (gram_sum). K9's group contract, and
    the f64 block-Jacobi blocks."""
    return gram_sum([row_grams(J) for J in views], gram_map, gram_off)


# plain PyTorch K9 for one group
group_gram_blocks_plain = group_grams


def group_gram_blocks(views, gram_map, gram_off):
    """K9: see group_gram_blocks_plain; on the card one launch per
    GRAM_VIEWS views forms the group's blocks, walking block k's
    contributions gram_map[gram_off[k] : gram_off[k + 1]] and adding each
    row's Gram to a sum that starts at +0 (the same order as
    group_gram_blocks_plain's). The views are f32 with a contiguous last
    dimension and are read in place."""
    if not views[0].is_cuda:
        return group_gram_blocks_plain(views, gram_map, gram_off)
    out = _gram_launch(views, gram_map, gram_off, "group_gram_blocks")
    group_gram_blocks.launches += -(-len(views) // GRAM_VIEWS)
    return out


group_gram_blocks.launches = 0


def _gram_launch(views, gram_map, gram_off, name):
    """Check the slot views and the order, then launch csrc/gram.cu's
    kernel (one launch per GRAM_VIEWS views); returns out [k, t, t]."""
    t = views[0].shape[2]
    num_blocks = gram_off.shape[0] - 1
    fields = []
    for J in views:
        if not (J.is_cuda and J.dtype is _F32 and J.dim() == 3
                and J.shape[2] == t and (t == 1 or J.stride(2) == 1)):
            raise ValueError(f"{name}: expected f32 CUDA views [n, r, {t}] "
                             f"with unit column stride, got {J.dtype} "
                             f"{tuple(J.shape)}, strides {J.stride()}")
        fields += [J.data_ptr(), J.stride(0), J.stride(1), J.shape[1]]
    _cuda.check(gram_map, (gram_map.shape[0], 2), _I32, f"{name}: gram_map")
    _cuda.check(gram_off, (num_blocks + 1,), _I32, f"{name}: gram_off")
    out = torch.empty(num_blocks, t, t, dtype=_F32, device=views[0].device)
    _cuda.launch("ceres_gram_group", (ctypes.c_long * len(fields))(*fields),
                 len(views), gram_map, gram_off, num_blocks, t, out)
    return out
