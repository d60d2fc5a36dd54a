// K11: bucket linearize of a registered functor: per row, the residual
// and its Jacobian in tangent space, the manifold's Plus seeded into the
// jets.
//
// Replaces ceres_tpu/ops/pallas_linearize.py::_lin_kernel with its two
// hand specs, _pose3d_emit (SE3: PoseGraph3dErrorTerm, quaternion slots
// seeded by _seed_eigen_quaternion) and _pose2d_emit (SE2:
// PoseGraph2dErrorTerm, the angle wrapped by _jnormangle), and with the
// auto spec that ops/jet_compile.py builds there for
// SnavelyReprojectionError, written here by hand (snavely.cuh, K1's jet
// chain). Same quantities, row-major layout instead of the TPU's
// rows-on-lanes planes:
//   xin [n, P_in]   the slots' parameters, concatenated (SE3 14, SE2 6,
//                   Snavely 12: camera 9, point 3)
//   dat [n, P_dat]  the functor's data fields, concatenated
//                   (SE3 t_ab 3, q_ab 4, sqrt_information 36;
//                    SE2 t_ab 2, yaw_ab 1, sqrt_information 9;
//                    Snavely observed_x 1, observed_y 1)
//   r   [n, R]      residuals (SE3 6, SE2 3, Snavely 2)
//   J   [n, R, nt]  tangent Jacobian, row-major (SE3 6x12, SE2 3x6,
//                   Snavely 2x12)
//
// Bound on the H100: bytes. Per SE3 row the kernel reads 57 floats and
// writes 78 (540 B), against ~5k flops of 13-wide jet arithmetic; per
// Snavely row 14 and 26 (160 B, 0.048 ms at 1M rows and 3.35 TB/s)
// against ~2k flops, ~30 us of issue at 1M rows: the chain's time is not
// small beside the bytes', so it has to overlap them.
// Design: each spec is a RowChain (the interface csrc/linearize_auto.cuh
// documents: R, NT, P_IN, P_DAT and run(x, d, rv, J), one row's jets in
// registers, their values and channels copied out) run by K11's row
// kernel, linearize_auto::row_kernel<Chain, 128>, the kernel of the auto
// specs: a persistent grid whose blocks copy each tile of 128 rows'
// xin and dat slices into shared memory by cp.async while the previous
// tile's chains run, one thread a row, and stream r and J out through a
// shared tile with 16-byte stores. This replaces a thread a row that
// loaded and stored its own row at the row's stride, 48 B to 312 B
// apart, so that none of a warp's accesses coalesced. The chains are the
// code of the kernels they replace, so r and J keep their bits. Tile 128
// is auto_tile's choice for all three (ops/linearize.py). Registers,
// the phases' times (scripts/k11_variants.py) and the times beside the
// bound: PERF.md section 6.

#include <cuda_runtime.h>

#include "linearize_auto.cuh"
#include "snavely.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;

// ---- SE3 ----------------------------------------------------------------

constexpr int N3 = 12;            // tangent channels: p_a, q_a, p_b, q_b
typedef Jet<N3> J3;

// Hamilton product in Eigen's (x, y, z, w) storage
// (PoseGraph3dErrorTerm._q_mul).
__device__ __forceinline__ void q_mul(const J3 a[4], const J3 b[4],
                                      J3 out[4]) {
  const J3 &x1 = a[0], &y1 = a[1], &z1 = a[2], &w1 = a[3];
  const J3 &x2 = b[0], &y2 = b[1], &z2 = b[2], &w2 = b[3];
  out[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  out[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  out[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  out[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

__device__ __forceinline__ void q_conj(const J3 q[4], J3 out[4]) {
  out[0] = -q[0];
  out[1] = -q[1];
  out[2] = -q[2];
  out[3] = q[3];
}

// EigenQuaternionManifold slot: Plus(q, d) = exp(d) * q (left Hamilton
// product in w-first order). exp(d) at d = 0 is the jet [w = 1, v = d],
// so the product carries exactly the PlusJacobian into channels
// ch0..ch0+2, and the value stays q. Returns (x, y, z, w).
__device__ __forceinline__ void seed_quaternion(const float* q, int ch0,
                                                J3 out[4]) {
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  out[0] = jconst<N3>(qx);
  out[1] = jconst<N3>(qy);
  out[2] = jconst<N3>(qz);
  out[3] = jconst<N3>(qw);
  // d/d(delta_0, delta_1, delta_2) of (x, y, z, w)
  const float dx[3] = {qw, qz, -qy};
  const float dy[3] = {-qz, qw, qx};
  const float dz[3] = {qy, -qx, qw};
  const float dw[3] = {-qx, -qy, -qz};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[0].d[ch0 + i] = dx[i];
    out[1].d[ch0 + i] = dy[i];
    out[2].d[ch0 + i] = dz[i];
    out[3].d[ch0 + i] = dw[i];
  }
}

__device__ __forceinline__ void pose3d_row(const float* x, const float* dat,
                                           J3 res[6]) {
  J3 pa[3], pb[3], qa[4], qb[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pa[i] = jvar<N3>(x[i], i);
    pb[i] = jvar<N3>(x[7 + i], 6 + i);
  }
  seed_quaternion(x + 3, 3, qa);
  seed_quaternion(x + 10, 9, qb);
  const float* t_ab = dat;
  const float* q_ab = dat + 3;
  const float* sqrt_info = dat + 7;

  J3 qa_inv[4];
  q_conj(qa, qa_inv);
  // p_ab_est = R(qa_inv) (p_b - p_a), as the quaternion sandwich
  J3 v[4] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2], jconst<N3>(0.f)};
  J3 t1[4], qa_inv_c[4], p_ab_est[4];
  q_mul(qa_inv, v, t1);
  q_conj(qa_inv, qa_inv_c);
  q_mul(t1, qa_inv_c, p_ab_est);
  J3 q_ab_est[4];
  q_mul(qa_inv, qb, q_ab_est);
  J3 q_ab_c[4] = {jconst<N3>(-q_ab[0]), jconst<N3>(-q_ab[1]),
                  jconst<N3>(-q_ab[2]), jconst<N3>(q_ab[3])};
  J3 dq[4];
  q_mul(q_ab_c, q_ab_est, dq);
  J3 r6[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r6[i] = jshift(p_ab_est[i], -t_ab[i]);
    r6[3 + i] = jconst<N3>(2.f) * dq[i];
  }
  // r = sqrt_information @ r6
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    J3 acc = jconst<N3>(sqrt_info[i * 6]) * r6[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = acc + jconst<N3>(sqrt_info[i * 6 + j]) * r6[j];
    res[i] = acc;
  }
}

// ---- SE2 ----------------------------------------------------------------

constexpr int N2 = 6;             // tangent channels: p_a, yaw_a, p_b, yaw_b
typedef Jet<N2> J2;

__device__ __forceinline__ void pose2d_row(const float* x, const float* dat,
                                           J2 res[3]) {
  // the angle manifold's Plus has derivative 1: its slots seed like
  // Euclidean ones
  J2 pa[2] = {jvar<N2>(x[0], 0), jvar<N2>(x[1], 1)};
  J2 yaw_a = jvar<N2>(x[2], 2);
  J2 pb[2] = {jvar<N2>(x[3], 3), jvar<N2>(x[4], 4)};
  J2 yaw_b = jvar<N2>(x[5], 5);
  const float* t_ab = dat;
  const float yaw_ab = dat[2];
  const float* sqrt_info = dat + 3;

  J2 s, c;
  jsincos(yaw_a, &s, &c);
  J2 d0 = pb[0] - pa[0], d1 = pb[1] - pa[1];
  J2 r3[3];
  r3[0] = jshift(c * d0 + s * d1, -t_ab[0]);
  r3[1] = jshift(c * d1 - s * d0, -t_ab[1]);
  // normalize_angle, branchless: v - 2 pi round(v / 2 pi), derivative 1
  // (rintf rounds half to even, as jnp.round and torch.round do)
  J2 dyaw = jshift(yaw_b - yaw_a, -yaw_ab);
  dyaw.v = dyaw.v - kTwoPi * rintf(dyaw.v / kTwoPi);
  r3[2] = dyaw;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    J2 acc = jconst<N2>(sqrt_info[i * 3]) * r3[0];
#pragma unroll
    for (int j = 1; j < 3; ++j) acc = acc + jconst<N2>(sqrt_info[i * 3 + j]) * r3[j];
    res[i] = acc;
  }
}

// ---- Snavely --------------------------------------------------------------

constexpr int NS = 12;            // tangent channels: camera 9, point 3
typedef Jet<NS> JS;

__device__ __forceinline__ void snavely_row(const float* x, const float* dat,
                                            JS res[2]) {
  JS cp[9], pt[3];
#pragma unroll
  for (int a = 0; a < 9; ++a) cp[a] = jvar<NS>(x[a], a);
#pragma unroll
  for (int a = 0; a < 3; ++a) pt[a] = jvar<NS>(x[9 + a], 9 + a);
  snavely_residual<NS>(cp, pt, true, dat[0], dat[1], res);
}

// a row's jets into the RowChain outputs: values and tangent channels
template <int R, int N>
__device__ __forceinline__ void unpack(const Jet<N> res[R], float (&rv)[R],
                                       float (&J)[R][N]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    rv[i] = res[i].v;
#pragma unroll
    for (int c = 0; c < N; ++c) J[i][c] = res[i].d[c];
  }
}

struct Pose3dRow {
  static constexpr int R = 6, NT = N3, P_IN = 14, P_DAT = 43;
  static __device__ __forceinline__ void run(const float* x, const float* d,
                                             float (&rv)[R],
                                             float (&J)[R][NT]) {
    J3 res[R];
    pose3d_row(x, d, res);
    unpack<R, NT>(res, rv, J);
  }
};

struct Pose2dRow {
  static constexpr int R = 3, NT = N2, P_IN = 6, P_DAT = 12;
  static __device__ __forceinline__ void run(const float* x, const float* d,
                                             float (&rv)[R],
                                             float (&J)[R][NT]) {
    J2 res[R];
    pose2d_row(x, d, res);
    unpack<R, NT>(res, rv, J);
  }
};

struct SnavelyRow {
  static constexpr int R = 2, NT = NS, P_IN = 12, P_DAT = 2;
  static __device__ __forceinline__ void run(const float* x, const float* d,
                                             float (&rv)[R],
                                             float (&J)[R][NT]) {
    JS res[R];
    snavely_row(x, d, res);
    unpack<R, NT>(res, rv, J);
  }
};

constexpr int TILE = 128;         // rows a block, every spec

}  // namespace

// spec 0: SE3 pose graph, spec 1: SE2 pose graph, spec 2: Snavely
// (ops/linearize.py SPECS)
extern "C" int ceres_linearize(int spec, const float* xin, const float* dat,
                               int n, float* r, float* J,
                               cudaStream_t stream) {
  if (spec == 0)
    return linearize_auto_launch<Pose3dRow, TILE>(xin, dat, n, r, J, stream);
  if (spec == 1)
    return linearize_auto_launch<Pose2dRow, TILE>(xin, dat, n, r, J, stream);
  if (spec == 2)
    return linearize_auto_launch<SnavelyRow, TILE>(xin, dat, n, r, J,
                                                   stream);
  return (int)cudaErrorInvalidValue;
}
