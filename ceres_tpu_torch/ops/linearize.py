"""K11: bucket linearize, through hand specs and auto specs.

Counterpart of ceres_tpu/ops/pallas_linearize.py: a registry of hand
specs keyed by the port's own functor classes and matched by exact type
(a subclass, or another class of the same name, gets no hand spec: each
spec hard-codes its residual), a structural gate, and kernels that
give a bucket's residuals r [n, R] and tangent-space Jacobian J
[n, R, nt] in one pass, the manifold's Plus seeded into the jets.
Registered, the pose graphs as in the JAX package:

  PoseGraph3dErrorTerm (SE3): r = 6, slots [3, 4 (EigenQuaternion), 3,
    4 (EigenQuaternion)], nt = 12; a quaternion slot is seeded through
    Plus(q, d) = exp(d) * q at d = 0.
  PoseGraph2dErrorTerm (SE2): r = 3, slots [2, 1 (angle), 2, 1 (angle)],
    nt = 6; the angle manifold's Plus has derivative 1, so its slots seed
    like Euclidean ones, and the residual wraps the angle in the
    branchless form v - 2 pi round(v / 2 pi) (derivative 1), which agrees
    with the functor's atan2(sin, cos) except at odd multiples of pi.
  SnavelyReprojectionError, with data fields observed_x and observed_y:
    r = 2, slots [9 (camera), 3 (point)], both Euclidean, nt = 12. The
    JAX package runs this bucket through its auto spec; here the spec is
    written by hand (K1's jet chain, csrc/snavely.cuh).

Both kinds run one row kernel, csrc/linearize_auto.cuh's `row_kernel`:
a persistent grid that copies tiles of rows into shared memory by
cp.async while the previous tile's rows run their jet chains, a thread a
row, and streams the outputs out with 16-byte stores. The hand specs'
chains are written in csrc/linearize.cu (Pose3dRow, Pose2dRow,
SnavelyRow, 128 rows a tile, behind the entry point ceres_linearize and
its spec ids, `Spec.kernel_id`) and built with the kernel library. Any
other bucket gets an auto spec (pallas_linearize.py _spec_for
:271-302): the per-row program that ops/jet_compile.py traces
(`make_auto_spec`), emitted as a row chain (`row_chain_source`) into a
generated unit around csrc/linearize_auto.cuh, built at first use by
`_cuda.build_generated` (tag "linearize_auto", one build per traced
program, its tile from `auto_tile`).

`linearize_spec(program, bk)` is the gate, decided once at build: the
hand spec of a bucket whose functor is of a registered class, whose
every slot is variable and whose shape, manifolds and data fields
match; else an AutoSpec when every slot is
variable, the bucket has at least MIN_AUTO_ROWS rows and MIN_AUTO_TANGENT
tangent columns (the JAX package's floors on its hardware, kept on both
devices so that the CPU takes the card's route), the functor traces,
its chain is within MAX_AUTO_OUTPUTS and `auto_tile` finds the kernel
a row tile; else None, and the program takes its jacfwd path.

`bucket_linearize(spec, xin, dat)` (hand specs) and
`bucket_linearize_auto(spec, xin, dat)` (auto specs) launch their
kernels for CUDA tensors and run `bucket_linearize_plain` and
`bucket_linearize_auto_plain` (torch.func.jacfwd of the same seeded
residual) for CPU tensors; each counts its own launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _cuda
from .jet_compile import AutoSpec, make_auto_spec, row_chain_source
from ..examples.slam import PoseGraph2dErrorTerm, PoseGraph3dErrorTerm
from ..examples.snavely import SnavelyReprojectionError
from ..manifolds import AutoDiffManifold, EigenQuaternionManifold
from ..rotation import quaternion_product


class Spec(NamedTuple):
    kernel_id: int                 # ceres_linearize's spec argument
    r: int
    nt: int
    p_in: int                      # parameter floats per row
    data_fields: tuple             # ((name, width), ...)
    residual: object               # (delta [nt], x [p_in], dat) -> r [R]
    slot_sizes: list               # ambient size of each slot
    slot_manifolds: tuple          # manifold -> bool, for each slot

    @property
    def p_dat(self):
        return sum(w for _, w in self.data_fields)

    def data_matrix(self, bk) -> torch.Tensor:
        """The bucket's data fields as one f32 [n, P_dat] tensor, in the
        spec's field order (built once per program)."""
        return torch.cat([bk.data[name].reshape(bk.n, w)
                          for name, w in self.data_fields],
                         dim=1).to(torch.float32).contiguous()


def _mat_vec(m_flat, v, k):
    """[k*k] row-major matrix times [k] vector, one row at a time."""
    return torch.cat([torch.sum(m_flat[i * k:(i + 1) * k] * v, dim=0,
                                keepdim=True) for i in range(k)])


def _q_mul(a, b):
    """Hamilton product in Eigen's (x, y, z, w) storage."""
    x1, y1, z1, w1 = a[0:1], a[1:2], a[2:3], a[3:4]
    x2, y2, z2, w2 = b[0:1], b[1:2], b[2:3], b[3:4]
    return torch.cat([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _q_conj(q):
    return torch.cat([-q[:3], q[3:]])


def _seed_quaternion(q, d):
    """exp(d) * q to first order, [1, d] * q in w-first order, returned in
    (x, y, z, w): the value q and the PlusJacobian of
    EigenQuaternionManifold at d = 0."""
    e = torch.cat([torch.ones_like(d[:1]), d])
    qw = torch.cat([q[3:], q[:3]])
    p = quaternion_product(e, qw)
    return torch.cat([p[1:], p[:1]])


def _pose3d_residual(d, x, dat):
    """PoseGraph3dErrorTerm on seeded slots (pallas_linearize.py
    _pose3d_emit): x = [p_a, q_a, p_b, q_b], d the 12 tangent seeds."""
    p_a, p_b = x[0:3] + d[0:3], x[7:10] + d[6:9]
    q_a = _seed_quaternion(x[3:7], d[3:6])
    q_b = _seed_quaternion(x[10:14], d[9:12])
    t_ab, q_ab, sqrt_info = dat[0:3], dat[3:7], dat[7:43]
    qa_inv = _q_conj(q_a)
    v = torch.cat([p_b - p_a, torch.zeros_like(p_a[:1])])
    p_ab_est = _q_mul(_q_mul(qa_inv, v), _q_conj(qa_inv))[:3]
    dq = _q_mul(_q_conj(q_ab), _q_mul(qa_inv, q_b))
    r6 = torch.cat([p_ab_est - t_ab, 2.0 * dq[:3]])
    return _mat_vec(sqrt_info, r6, 6)


def _pose2d_residual(d, x, dat):
    """PoseGraph2dErrorTerm on seeded slots (pallas_linearize.py
    _pose2d_emit): x = [p_a, yaw_a, p_b, yaw_b]."""
    xs = x + d
    p_a, yaw_a, p_b, yaw_b = xs[0:2], xs[2:3], xs[3:5], xs[5:6]
    t_ab, yaw_ab, sqrt_info = dat[0:2], dat[2:3], dat[3:12]
    s, c = torch.sin(yaw_a), torch.cos(yaw_a)
    dp = p_b - p_a
    dyaw = yaw_b - yaw_a - yaw_ab
    two_pi = 2.0 * math.pi
    # the round term has derivative 0, so the partials are dyaw's
    wrapped = dyaw - two_pi * torch.round(dyaw / two_pi)
    r3 = torch.cat([c * dp[0:1] + s * dp[1:2] - t_ab[0:1],
                    c * dp[1:2] - s * dp[0:1] - t_ab[1:2], wrapped])
    return _mat_vec(sqrt_info, r3, 3)


def _snavely_residual(d, x, dat):
    """SnavelyReprojectionError on seeded slots: x = [camera, point],
    dat = [observed_x, observed_y]; the functor itself, so the plain
    version is the jacfwd path's arithmetic."""
    xs = x + d
    return SnavelyReprojectionError(dat[0], dat[1])(xs[:9], xs[9:])


def _is_euclidean(m) -> bool:
    return m is None


def _is_eigen_quaternion(m) -> bool:
    return type(m) is EigenQuaternionManifold


def _is_angle_manifold(m) -> bool:
    """A behavioural probe, as the JAX package's: an AutoDiffManifold of
    size 1 whose plus wraps x + d to (-pi, pi] (circular distance, on
    f64 CPU samples)."""
    if type(m) is not AutoDiffManifold or m.ambient_size != 1 \
            or m.tangent_size != 1:
        return False
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = rng.uniform(-10, 10, size=1)
        d = rng.uniform(-10, 10, size=1)
        got = m.plus(torch.as_tensor(x), torch.as_tensor(d)).numpy()
        want = np.arctan2(np.sin(x + d), np.cos(x + d))
        diff = got - want
        diff = diff - 2.0 * np.pi * np.round(diff / (2.0 * np.pi))
        if not np.allclose(diff, 0.0, atol=1e-4):
            return False
    return True


SPECS = {
    PoseGraph3dErrorTerm: Spec(
        0, 6, 12, 14, (("t_ab", 3), ("q_ab", 4), ("sqrt_information", 36)),
        _pose3d_residual, [3, 4, 3, 4],
        (_is_euclidean, _is_eigen_quaternion) * 2),
    PoseGraph2dErrorTerm: Spec(
        1, 3, 6, 6, (("t_ab", 2), ("yaw_ab", 1), ("sqrt_information", 9)),
        _pose2d_residual, [2, 1, 2, 1],
        (_is_euclidean, _is_angle_manifold) * 2),
    SnavelyReprojectionError: Spec(
        2, 2, 12, 12, (("observed_x", 1), ("observed_y", 1)),
        _snavely_residual, [9, 3], (_is_euclidean, _is_euclidean)),
}


def is_snavely_bucket(bk) -> bool:
    """The port's own SnavelyReprojectionError, by exact type, with its
    two data fields (the JAX package's gate, pallas_lin.py:555-557,
    :575): K1, K4 and the hand spec hard-code its residual, so a
    subclass, or another class of the same name, takes the generic
    routes (K5, the auto spec)."""
    return (type(getattr(bk.cost, "functor", None))
            is SnavelyReprojectionError
            and set(bk.data.keys()) == {"observed_x", "observed_y"})


def _hand_spec(bk) -> Optional[Spec]:
    spec = SPECS.get(type(getattr(bk.cost, "functor", None)))
    if spec is None or bk.r != spec.r:
        return None
    if set(bk.data.keys()) != {name for name, _ in spec.data_fields}:
        return None
    if [sl.amb_size for sl in bk.slots] != spec.slot_sizes:
        return None
    for sl, manifold_ok in zip(bk.slots, spec.slot_manifolds):
        if not sl.variable:
            return None         # the gauge bucket: constant slots
        if not manifold_ok(sl.manifold):
            return None
    return spec


# the auto spec's floors (pallas_linearize.py:285-301: below them the
# launch costs more than the kernel saves on the JAX package's hardware)
MIN_AUTO_ROWS, MIN_AUTO_TANGENT = 64, 6
# csrc/linearize_auto.cuh keeps a row's J [R][NT] in registers (255 a
# thread at most, beside the chain's temporaries); past this the build
# refuses and the gate never picks the auto spec
MAX_AUTO_OUTPUTS = 128
# the larger of a row tile's inputs and outputs is held to 48 KB (the
# kernel's two input tiles and one output tile then to 144 KB)
_AUTO_TILES, _TILE_BYTES = (128, 64, 32), 48 * 1024


def auto_tile(r: int, nt: int, p_in: int, p_dat: int) -> Optional[int]:
    """Rows a block of csrc/linearize_auto.cuh: the largest of 128, 64
    and 32 at which the larger of a tile's inputs (P_IN and P_DAT floats
    a row) and its outputs (R and R * NT), at odd row strides, fits 48 KB;
    None when 32 rows do not fit."""
    inp = (p_in | 1) + ((p_dat | 1) if p_dat > 0 else 0)
    out = (r | 1) + ((r * nt) | 1)
    row_bytes = 4 * max(inp, out)
    return next((t for t in _AUTO_TILES if t * row_bytes <= _TILE_BYTES),
                None)


def linearize_spec(program, bk):
    """The hand Spec or the AutoSpec for bucket bk, or None (see the
    module docstring; nothing is compiled or launched)."""
    spec = _hand_spec(bk)
    if spec is not None:
        return spec
    if not all(sl.variable for sl in bk.slots) or bk.n < MIN_AUTO_ROWS \
            or sum(sl.tangent_size for sl in bk.slots) < MIN_AUTO_TANGENT:
        return None
    auto = make_auto_spec(program, bk)
    if auto is None or auto.r * auto.nt > MAX_AUTO_OUTPUTS or auto_tile(
            auto.r, auto.nt, sum(auto.slot_sizes), auto.p_dat) is None:
        return None
    return auto


def bucket_linearize_plain(spec: Spec, xin, dat):
    """Plain PyTorch K11: (r [n, R], J [n, R, nt]) by torch.func.jacfwd of
    the spec's seeded residual at zero tangent, in the dtype of xin."""
    def one(x, d_row):
        def f(delta):
            r = spec.residual(delta, x, d_row)
            return r, r
        zero = torch.zeros(spec.nt, dtype=x.dtype, device=x.device)
        J, r = torch.func.jacfwd(f, has_aux=True)(zero)
        return r, J

    return torch.func.vmap(one)(xin, dat)


def bucket_linearize(spec: Spec, xin, dat):
    """K11: see bucket_linearize_plain. xin [n, P_in] and dat [n, P_dat],
    f32, contiguous, on the card."""
    if not xin.is_cuda:
        return bucket_linearize_plain(spec, xin, dat)
    n = xin.shape[0]
    f32 = torch.float32
    _cuda.check(xin, (n, spec.p_in), f32, "bucket_linearize: xin")
    _cuda.check(dat, (n, spec.p_dat), f32, "bucket_linearize: dat")
    r = torch.empty(n, spec.r, dtype=f32, device=xin.device)
    J = torch.empty(n, spec.r, spec.nt, dtype=f32, device=xin.device)
    _cuda.launch("ceres_linearize", spec.kernel_id, xin, dat, n, r, J)
    bucket_linearize.launches += 1
    return r, J


bucket_linearize.launches = 0


# ----------------------------------------------------------------------
# auto specs

def generated_unit(spec: AutoSpec) -> str:
    """The whole CUDA unit of K11 for this traced program."""
    tile = auto_tile(spec.r, spec.nt, sum(spec.slot_sizes), spec.p_dat)
    return f"""// K11 for {spec.name} (graph {spec.digest}), generated by
// ceres_tpu_torch/ops/linearize.py; the kernel is
// csrc/linearize_auto.cuh.
#include "linearize_auto.cuh"

{row_chain_source(spec)}
extern "C" int ceres_linearize_auto(const float* xin, const float* dat,
                                    int n, float* r, float* J,
                                    cudaStream_t stream) {{
  return linearize_auto_launch<RowChain, {tile}>(xin, dat, n, r, J,
                                                stream);
}}
"""


_P, _I = ctypes.c_void_p, ctypes.c_int
_AUTO_ENTRIES: dict = {}


def build_auto(spec: AutoSpec):
    """The ceres_linearize_auto entry point of this traced program (built
    into ceres_tpu_torch/_build/ at first use)."""
    if spec.r * spec.nt > MAX_AUTO_OUTPUTS:
        raise ValueError(
            f"bucket_linearize_auto: {spec.name} has R * NT = "
            f"{spec.r} * {spec.nt} outputs a row, past the register cap "
            f"{MAX_AUTO_OUTPUTS} of csrc/linearize_auto.cuh")
    if auto_tile(spec.r, spec.nt, sum(spec.slot_sizes), spec.p_dat) is None:
        raise ValueError(
            f"bucket_linearize_auto: a 32-row tile of {spec.name} passes "
            f"the {_TILE_BYTES} B that auto_tile holds a row tile to")
    key = (spec.digest, spec.slot_sizes, spec.data_widths)
    if key not in _AUTO_ENTRIES:
        lib = _cuda.build_generated("linearize_auto", generated_unit(spec))
        fn = lib.ceres_linearize_auto
        fn.argtypes = [_P, _P, _I, _P, _P, _P]
        fn.restype = ctypes.c_int
        _AUTO_ENTRIES[key] = fn
    return _AUTO_ENTRIES[key]


_AUTO_CALLS: dict = {}          # id(spec) -> (spec, entry, P_in, P_dat)


def _auto_call(spec: AutoSpec):
    """build_auto's entry and the row widths of spec, found by the spec's
    identity (held in the cache, so its id stays its own): the widths are
    properties that cost microseconds, and the host path sets a single
    call's time."""
    hit = _AUTO_CALLS.get(id(spec))
    if hit is None or hit[0] is not spec:
        hit = _AUTO_CALLS[id(spec)] = (spec, build_auto(spec),
                                       sum(spec.slot_sizes), spec.p_dat)
    return hit[1:]


def _split_slots(spec: AutoSpec, x):
    offs = np.cumsum((0,) + spec.slot_sizes)
    return [x[int(a):int(b)] for a, b in zip(offs[:-1], offs[1:])]


def bucket_linearize_auto_plain(spec: AutoSpec, xin, dat):
    """Plain PyTorch K11 for an auto spec: (r [n, R], J [n, R, nt]) by
    vmap of jacfwd of the traced per_row at zero tangent, in the dtype of
    xin."""
    return torch.func.vmap(
        lambda x, d: spec.row_jacobian(_split_slots(spec, x), d))(xin, dat)


def bucket_linearize_auto(spec: AutoSpec, xin, dat):
    """K11 through an auto spec: see bucket_linearize_auto_plain. xin
    [n, P_in] and dat [n, P_dat] (spec.data_matrix), f32, contiguous, on
    the card."""
    if not xin.is_cuda:
        return bucket_linearize_auto_plain(spec, xin, dat)
    n = xin.shape[0]
    f32 = torch.float32
    fn, p_in, p_dat = _auto_call(spec)
    _cuda.check(xin, (n, p_in), f32, "bucket_linearize_auto: xin")
    _cuda.check(dat, (n, p_dat), f32, "bucket_linearize_auto: dat")
    r = torch.empty(n, spec.r, dtype=f32, device=xin.device)
    J = torch.empty(n, spec.r, spec.nt, dtype=f32, device=xin.device)
    _cuda.call(fn, "ceres_linearize_auto", xin, dat, n, r, J)
    bucket_linearize_auto.launches += 1
    return r, J


bucket_linearize_auto.launches = 0
