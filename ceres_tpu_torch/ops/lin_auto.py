"""K5: the linearize of any two-slot functor, with K1's epilogue.

Counterpart of ceres_tpu/ops/pallas_lin.py _lin_kernel_auto (and its
host-side inputs, make_pallas_lin :735-779). The explicit fused Schur
step takes it for a bucket whose functor is not SnavelyReprojectionError
(which keeps K1): the bucket's per-row program is traced once
(ops/jet_compile.py make_auto_spec), its residual jet chain is emitted as
C++ (`chain_source`) into a generated unit around csrc/lin_auto.cuh,
built at first use by `_cuda.build_generated` (one build per functor and
loss class), and launched by `lin_auto`.

The contract is K1's (ops/lin.py), at general te, tf and r, in the Schur
chunk layout [ne, k]: xf [kf*tf] cameras, xe [ne, te] points, cam [ne, k]
int32, mask [ne, k], dat [ne, k, p_dat] the bucket's data fields, se_in
[ne, te] the carried scale. Masked lanes carry their point's first valid
lane's camera and data (`safe_rows`), so a generic chain stays finite
there. Returns ete [ne, te*te], ge [ne, te], se [ne, te], A [ne, te, nf]
(e-scaled), ftf [kf, tf, tf], gf [kf, tf], all unscaled but A's e factor.

The loss's scalars reach the kernel in device memory: one set for the
bucket (`loss`'s, at a row stride of 0, `loss_pointer`), or each lane's
own, `loss_rows` [ne, k, nlp] f32 (a bucket whose rows carry differing
scalars of one flat loss class: the program's `loss_attrs` gathered into
the chunk layout once, `chunk_loss_rows`), which the plain version
broadcasts over the lanes (`lane_loss`).

`lin_auto` launches the kernel for CUDA tensors through `lane_launch`
(shared with K1, ops/lin.py `lin`, whose hand chain runs the same
kernel) and counts its launches in `lin_auto.launches`; for CPU tensors
it runs `lin_auto_plain`: vmap of jacfwd of the per-row program on each
lane, the loss correction
(loss.py correct_residuals_and_jacobian), then K1's plain epilogue.
The kernel sums the camera-side terms over a camera-sorted order of the
rows of each 1,024-row chunk, `camera_plan`, made once on the host from
the constant cam and mask (the step keeps it; `lin_auto` makes it when
it is not given), and takes `lane_block(k, te, tf)` points a block.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda
from . import jetlib as jl
from .jet_compile import (AutoSpec, LossSpec, chain_body, eval_loss,
                          loss_structure, make_loss_spec)
from ..loss import correct_residuals_and_jacobian, stacked_loss

# the JAX package's caps of its gate (pallas_lin.py:563): the unrolled
# channel loops and the registers of one lane's jets
MAX_TE, MAX_TF, MAX_R = 6, 12, 8
_ROWS_PER_CHUNK = 1024            # lanes per camera-Gram partial
_THREADS = 128                    # csrc/lin_auto.cuh lin_auto::THREADS
_ABUF = 2048                      # and lin_auto::ABUF, its A tile
_MAX_SMEM = 232448                # a block's shared memory on the H100


class LinAutoSpec(NamedTuple):
    """K5's view of a bucket: its traced program and which slot is the
    point (e) and which the camera (f)."""
    auto: AutoSpec
    slot_kinds: tuple             # "e" or "f", per slot of the bucket
    te: int
    tf: int
    r: int
    eo: int                       # first channel of the e tangent
    fo: int                       # first channel of the f tangent


def lin_auto_spec(auto: AutoSpec, e_slot: int) -> LinAutoSpec:
    """The spec of a two-slot bucket whose slot `e_slot` is the point."""
    kinds = tuple("e" if i == e_slot else "f"
                  for i in range(len(auto.slot_sizes)))
    offs = np.cumsum((0,) + auto.tan_sizes)
    ei = auto.var_slots.index(e_slot)
    fi = 1 - ei
    return LinAutoSpec(auto, kinds, auto.tan_sizes[ei], auto.tan_sizes[fi],
                       auto.r, int(offs[ei]), int(offs[fi]))


def safe_rows(rows: np.ndarray, cmask: np.ndarray) -> np.ndarray:
    """The chunk layout's rows [ne, k] with each masked lane pointing at
    its point's first valid lane (pallas_lin.py chunk_safe / loc_safe)."""
    first = np.argmax(cmask > 0, axis=1)
    fill = rows[np.arange(rows.shape[0]), first]
    return np.where(cmask > 0, rows, fill[:, None]).astype(rows.dtype)


class CameraPlan(NamedTuple):
    """The camera-sorted order of K5's rows (lanes, n * k + j): the valid
    rows of each chunk of 1,024 rows sorted by camera, stably, chunk
    after chunk."""
    pos: torch.Tensor             # int32 [ne*k]: a row's place, -1 masked
    off: torch.Tensor             # int32 [nchunks*kf + 1]: segment starts
    nchunks: int
    nvalid: int


def camera_plan(cam: torch.Tensor, mask: torch.Tensor, kf: int
                ) -> CameraPlan:
    """K5's camera plan of the chunk layout's cam [ne, k] and mask [ne, k],
    on their device: segment s = chunk * kf + c holds the sorted places
    off[s] .. off[s + 1] - 1, the chunk's valid rows on camera c in row
    order."""
    cam_np = cam.cpu().numpy().reshape(-1).astype(np.int64)
    valid = mask.cpu().numpy().reshape(-1) > 0.5
    rows = cam_np.size
    if valid.any() and not (0 <= cam_np[valid].min()
                            and cam_np[valid].max() < kf):
        raise ValueError(f"camera_plan: a valid lane's camera is outside "
                         f"[0, {kf})")
    nchunks = -(-rows // _ROWS_PER_CHUNK)
    key = np.arange(rows) // _ROWS_PER_CHUNK * kf + cam_np
    idx = np.flatnonzero(valid)
    order = idx[np.argsort(key[idx], kind="stable")]
    pos = np.full(rows, -1, np.int32)
    pos[order] = np.arange(order.size, dtype=np.int32)
    off = np.searchsorted(key[order], np.arange(nchunks * kf + 1))
    return CameraPlan(torch.as_tensor(pos, device=cam.device),
                      torch.as_tensor(off.astype(np.int32),
                                      device=cam.device),
                      nchunks, int(order.size))


def lane_block(k: int, te: int, tf: int):
    """(points a block, shared-memory bytes a block) of K5's lane kernel
    at k lanes a point (csrc/lin_auto.cuh smem_bytes): 128 // k points,
    one when k > 128; the F-side stage (64 lanes) and the cross terms
    share their place when the block's lanes take one pass."""
    pb = max(1, _THREADS // k)
    cap = pb * k
    stage, cross = (_THREADS // 2) * ((tf * (tf + 1) // 2 + tf) | 1), \
        cap * ((te * tf) | 1)
    stage = max(stage, cross) if cap <= _THREADS else stage + cross
    ne_t = te * (te + 1) // 2 + te
    return pb, 4 * (_ABUF + stage + cap * ((ne_t | 1) + 2) + _THREADS
                    + pb * te)


# ----------------------------------------------------------------------
# the generated unit

def chain_source(spec: LinAutoSpec, loss_spec: Optional[LossSpec] = None,
                 name: str = "Chain") -> str:
    """The C++ struct of one lane's residual jet chain (csrc/lin_auto.cuh
    states its interface): the traced program over emitter scalars, the
    robust-loss corrector after it when loss_spec is given. Only the
    structurally nonzero channels are computed; the others are 0."""
    auto = spec.auto
    em = jl.Emitter()
    src = {"e": "xe_n", "f": "xf_c"}
    jets = auto.jets(
        [[em.input(f"{src[kind]}[{a}]") for a in range(size)]
         for kind, size in zip(spec.slot_kinds, auto.slot_sizes)],
        [em.input(f"d[{i}]") for i in range(auto.p_dat)])
    if loss_spec is not None:
        lp = [em.input(f"lp.p[{i}]") for i in range(loss_spec.n_params)]
        jets = jl.correct_jets(
            jets, lambda sq: eval_loss(loss_spec, sq, lp),
            em.input("valid", "b"))
    return f"""struct {name} {{
  static constexpr int TE = {spec.te}, TF = {spec.tf}, R = {spec.r};
  static constexpr int NT = {auto.nt}, EO = {spec.eo}, FO = {spec.fo};
  static constexpr int ND = {auto.p_dat};
  template <class LP>
  static __device__ __forceinline__ void run(
      const float* __restrict__ xf_c, const float* __restrict__ xe_n,
      const float* __restrict__ d, const LP& lp, bool valid,
      float (&rv)[R], float (&J)[R][NT]) {{
{chain_body(em, jets, auto.nt)}
  }}
}};
"""


def generated_unit(spec: LinAutoSpec, loss_spec: Optional[LossSpec]) -> str:
    """The whole CUDA unit of K5 for this functor and loss class."""
    what = spec.auto.name + (f", loss {loss_spec.key[0]}"
                             if loss_spec is not None else "")
    return f"""// K5 for {what} (graph {spec.auto.digest}), generated by
// ceres_tpu_torch/ops/lin_auto.py; the kernel is csrc/lin_auto.cuh.
#include "lin_auto.cuh"

{chain_source(spec, loss_spec)}
extern "C" int ceres_lin_auto(
    const float* xf, const float* xe, const int* cam, const float* mask,
    const float* dat, int nlp, const float* lrows, int lstride,
    const float* se_in, int first, int use_scaling, int ne,
    int k, int kf, int pb, const int* pos, const int* off, int nchunks,
    float* ete, float* ge, float* se_out, float* A, float* q,
    float* partial, float* ftf, float* gf, cudaStream_t stream) {{
  return lin_auto_launch<Chain>(xf, xe, cam, mask, dat, nlp, lrows, lstride,
                                se_in, first, use_scaling, ne, k,
                                kf, pb, pos, off, nchunks, ete, ge, se_out, A,
                                q, partial, ftf, gf, stream);
}}
"""


_ARGTYPES = _cuda._SIGNATURES["ceres_lin"]     # K1's entry takes K5's


def loss_spec_of(loss):
    """The traced loss of `loss` (None for no loss); raises
    NotImplementedError for a loss that does not trace."""
    if loss is None:
        return None
    spec = make_loss_spec(loss)
    if spec is None:
        raise NotImplementedError(
            f"a robust loss ({type(loss).__name__}) that does not trace to "
            "scalar code: an attribute other than numbers, bools, strings "
            "and nested losses, or a torch op outside the jet compiler's "
            "rules (ROADMAP.md item 9)")
    return spec


_ENTRIES: dict = {}


def build(spec: LinAutoSpec, loss=None):
    """The ceres_lin_auto entry point of this functor and loss class
    (built into ceres_tpu_torch/_build/ at first use)."""
    loss_spec = loss_spec_of(loss)
    key = (spec.auto.digest, spec[1:],
           None if loss_spec is None else loss_spec.digest)
    if key not in _ENTRIES:
        lib = _cuda.build_generated("lin_auto",
                                    generated_unit(spec, loss_spec))
        fn = lib.ceres_lin_auto
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return _ENTRIES[key]


_CALLS: dict = {}                 # (id(spec), loss structure) -> entry
_SCALARS: dict = {}               # (scalars, device) -> their f32 tensor


def _entry(spec: LinAutoSpec, loss):
    """(entry point, the loss's scalars) of a call: the loss walked once,
    the entry found by the spec's identity (the spec held in the cache,
    so its id stays its own)."""
    try:
        lkey, lp = (None, []) if loss is None else loss_structure(loss)
    except TypeError:           # a loss that does not trace: build says so
        return build(spec, loss), []
    hit = _CALLS.get((id(spec), lkey))
    if hit is None or hit[0] is not spec:
        hit = _CALLS[(id(spec), lkey)] = (spec, build(spec, loss))
    return hit[1], lp


# ----------------------------------------------------------------------
# per-row loss scalars

def chunk_loss_rows(bk, rows: np.ndarray, device) -> Optional[torch.Tensor]:
    """A bucket's per-row loss scalars (program.py `loss_attrs`) in the
    chunk layout: [ne, k, nlp] f32 on `device`, in loss_structure order,
    gathered from the chunk layout's `rows` [ne, k] (each masked lane
    carrying a valid lane's row, as `safe_rows` gives them, so that its
    scalars keep its terms finite); None for a bucket with one set."""
    attrs = getattr(bk, "loss_attrs", None)
    if attrs is None:
        return None
    table = np.stack([np.asarray(attrs[k], np.float64)
                      for k in loss_attr_names(bk.loss_proto)], axis=1)
    return torch.as_tensor(table[rows].astype(np.float32), device=device)


def loss_attr_names(loss) -> list:
    """The scalar attributes of a flat loss in loss_structure order."""
    return [k for k, v in vars(loss).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]


def lane_loss(loss, loss_rows):
    """The loss that the plain versions apply over [ne, k] lanes: `loss`
    itself, or with loss_rows [ne, k, nlp] its scalars lane by lane."""
    if loss_rows is None:
        return loss
    return stacked_loss(loss, {k: loss_rows[..., i] for i, k in
                               enumerate(loss_attr_names(loss))})


def loss_pointer(lp, loss_rows, device):
    """(lrows, lstride) of a kernel call: the lanes' scalars, the
    bucket's one set in device memory at row stride 0 (made once for each
    set and device), or (None, 0) for no loss."""
    if loss_rows is not None:
        return loss_rows, loss_rows.shape[-1]
    if not lp:
        return None, 0
    key = (tuple(lp), str(device))
    if key not in _SCALARS:
        _SCALARS[key] = torch.tensor(lp, dtype=torch.float32, device=device)
    return _SCALARS[key], 0


# ----------------------------------------------------------------------
# the wrappers

def _epilogue(r, J, cam, mask, se_in, first, use_scaling, kf, spec):
    """K1's plain epilogue (ops/lin.py lin_plain) at general te and tf,
    from the masked, corrected r [ne, k, R] and J [ne, k, R, nt]."""
    ne = r.shape[0]
    te, tf = spec.te, spec.tf
    Je = J[..., spec.eo:spec.eo + te]
    Jf = J[..., spec.fo:spec.fo + tf]
    ge = torch.einsum("nkra,nkr->na", Je, r)
    ete = torch.einsum("nkra,nkrb->nab", Je, Je)
    cn = torch.diagonal(ete, dim1=-2, dim2=-1)
    if not use_scaling:
        se = torch.ones_like(cn)
    elif first:
        se = 1.0 / (1.0 + torch.sqrt(cn))
    else:
        se = se_in
    oh = torch.nn.functional.one_hot(cam.long(), kf).to(r.dtype) \
        * mask[..., None]
    G = torch.einsum("nkra,nkrt->nkat", Je, Jf)
    A = torch.einsum("nkc,nkat->nact", oh, G).reshape(ne, te, kf * tf)
    return {
        "ete": ete.reshape(ne, te * te), "ge": ge, "se": se.contiguous(),
        "A": A * se[:, :, None],
        "ftf": torch.einsum("nkc,nkrt,nkru->ctu", oh, Jf, Jf),
        "gf": torch.einsum("nkc,nkrt,nkr->ct", oh, Jf, r),
    }


def lin_auto_plain(spec: LinAutoSpec, xf, xe, cam, mask, dat, se_in,
                   first: bool, use_scaling: bool = True, loss=None,
                   loss_rows=None):
    """Plain PyTorch K5: see the module docstring for the contract."""
    ne, k = cam.shape
    te, tf, R, auto = spec.te, spec.tf, spec.r, spec.auto
    kf = xf.numel() // tf
    f32 = torch.float32
    C = xf.view(kf, tf)[cam.long()]          # masked lanes: a real camera
    P = xe[:, None, :].expand(ne, k, te)

    def lane(c, p, d):
        return auto.row_jacobian(
            [c if kind == "f" else p for kind in spec.slot_kinds], d)

    r, J = torch.func.vmap(lane)(C.reshape(-1, tf), P.reshape(-1, te),
                                 dat.reshape(ne * k, -1))
    m = mask[..., None]
    r = r.to(f32).view(ne, k, R) * m
    J = J.to(f32).view(ne, k, R, auto.nt) * m[..., None]
    if loss is not None:
        _, r, J = correct_residuals_and_jacobian(lane_loss(loss, loss_rows),
                                                 r, J)
    return _epilogue(r, J, cam, mask, se_in, first, use_scaling, kf, spec)


def lane_launch(launch, name: str, te: int, tf: int, p_dat: int, xf, xe,
                cam, mask, dat, lp, se_in, first: bool, use_scaling: bool,
                plan: Optional[CameraPlan], loss_rows=None):
    """One call of csrc/lin_auto.cuh's kernels, K5's or K1's (whose
    C entry points take the same arguments): checks the CUDA inputs,
    makes the camera plan when not given, allocates the outputs and the
    scratch (one allocation) and calls launch(*arguments of the entry);
    returns the outputs. `lp` holds the loss's scalars, `loss_rows`
    [ne, k, nlp] each lane's own (or None)."""
    ne, k = cam.shape
    kf = xf.numel() // tf
    f32 = torch.float32
    _cuda.check(xf, (kf * tf,), f32, f"{name}: xf")
    _cuda.check(xe, (ne, te), f32, f"{name}: xe")
    _cuda.check(cam, (ne, k), torch.int32, f"{name}: cam")
    _cuda.check(mask, (ne, k), f32, f"{name}: mask")
    _cuda.check(dat, (ne, k, p_dat), f32, f"{name}: dat")
    _cuda.check(se_in, (ne, te), f32, f"{name}: se_in")
    if loss_rows is not None:
        _cuda.check(loss_rows, (ne, k, len(lp)), f32, f"{name}: loss_rows")
    pb, smem = lane_block(k, te, tf)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: {k} lanes a point need {smem} B of "
                         f"shared memory a block, past the card's "
                         f"{_MAX_SMEM}")
    if plan is None:
        plan = camera_plan(cam, mask, kf)
    _cuda.check(plan.pos, (ne * k,), torch.int32, f"{name}: plan.pos")
    _cuda.check(plan.off, (plan.nchunks * kf + 1,), torch.int32,
                f"{name}: plan.off")
    lrows, lstride = loss_pointer(lp, loss_rows, xf.device)
    dev = xf.device
    out = {
        "ete": torch.empty(ne, te * te, dtype=f32, device=dev),
        "ge": torch.empty(ne, te, dtype=f32, device=dev),
        "se": torch.empty(ne, te, dtype=f32, device=dev),
        "A": torch.empty(ne, te, kf * tf, dtype=f32, device=dev),
        "ftf": torch.empty(kf, tf, tf, dtype=f32, device=dev),
        "gf": torch.empty(kf, tf, dtype=f32, device=dev),
    }
    # scratch: the sorted F-side rows [nvalid, nq], then the chunk
    # partials [nchunks, kf * nq]
    nq = tf * (tf + 1) // 2 + tf
    scratch = torch.empty((plan.nvalid + plan.nchunks * kf) * nq, dtype=f32,
                          device=dev)
    q = scratch.data_ptr()
    launch(xf, xe, cam, mask, dat, len(lp), 0 if lrows is None else lrows,
           lstride, se_in,
           int(bool(first)), int(bool(use_scaling)), ne, k, kf, pb, plan.pos,
           plan.off, plan.nchunks, out["ete"], out["ge"], out["se"],
           out["A"], q, q + 4 * plan.nvalid * nq, out["ftf"], out["gf"])
    return out


def lin_auto(spec: LinAutoSpec, xf, xe, cam, mask, dat, se_in, first: bool,
             use_scaling: bool = True, loss=None,
             plan: Optional[CameraPlan] = None, loss_rows=None):
    """K5: see the module docstring for the contract. `plan` is
    camera_plan(cam, mask, kf), made here when not given; `loss_rows`
    [ne, k, nlp] f32 the lanes' own loss scalars (`chunk_loss_rows`)."""
    if not xf.is_cuda:
        return lin_auto_plain(spec, xf, xe, cam, mask, dat, se_in, first,
                              use_scaling, loss, loss_rows)
    fn, lp = _entry(spec, loss)
    out = lane_launch(lambda *a: _cuda.call(fn, "ceres_lin_auto", *a),
                      "lin_auto", spec.te, spec.tf, spec.auto.p_dat, xf, xe,
                      cam, mask, dat, lp, se_in, first, use_scaling, plan,
                      loss_rows)
    lin_auto.launches += 1
    return out


lin_auto.launches = 0
