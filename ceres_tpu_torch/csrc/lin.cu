// K1: Snavely linearize with the point-side Grams, the e-scaled cross
// tensor and the camera-side block-diagonal Grams.
//
// Replaces ceres_tpu/ops/pallas_lin.py::_lin_kernel (with _fold_ftf_gf_mxu
// and the jet chain of ceres_tpu/ops/jetlib.py: _aa_rotate_jets,
// _snavely_residual_jets, _jet_planes). Same quantities, GPU layout:
//   ete [ne, 9]   E^T E per point, unscaled (row-major a*3+b)
//   ge  [ne, 3]   e gradient, unscaled
//   se  [ne, 3]   Jacobi scale: 1/(1+sqrt(diag E^T E)) when `first`,
//                 else the carried se_in (ones when scaling is off)
//   A   [ne, 3, nf]  e-scaled cross tensor (s_e E)^T F, nf = kf*9
//   ftf [kf, 81]  F^T F block diagonal, unscaled
//   gf  [kf, 9]   f gradient, unscaled
// Inputs in the Schur chunk layout [ne, k]: the camera of each lane as an
// int32 map (camera 0 on a masked lane), the mask, and the observations
// as dat [ne, k, 2] (observed_x, observed_y; 0 on a masked lane).
//
// Bound on the H100: bytes. A alone is ne*3*nf floats (38.2 MB at
// BAL-16-22106: 22,106 x 3 x 144 x 4 B), 0.0114 ms at 3.35 TB/s; the jet
// arithmetic and the epilogue (~2,500 operations a lane) are 0.003 ms at
// the f32 rate.
// Design: K1 is an instance of K5's kernel, csrc/lin_auto.cuh, with a
// hand-written chain (SnavelyK1Chain below: TE 3, TF 9, R 2, NT 12,
// cameras first, ND 2; snavely.cuh's jet chain) in place of a generated
// one, launched by lin_auto_launch behind ceres_lin: lane_kernel gives a
// thread to a lane and a block to 128 / k points, keeps each lane's terms
// in shared memory, sums the point-side terms in lane order from 0,
// writes each point's A rows once through a shared tile, zeros included
// (the wrapper does not zero A), with evict-first 16-byte stores, and
// streams the lanes' F-side terms to their rows in the camera-sorted
// order of ops/lin_auto.py camera_plan; ftf_partial_kernel and
// ftf_final_kernel sum them per 1,024-row chunk in row order, then the
// chunks in order. This replaces a thread a point that zeroed A, read and
// wrote it once a lane, rescaled it, and wrote each lane's F-side terms at
// the lane's stride for a reduction that scanned every row of a chunk for
// every output. A masked lane keeps K1's own rule, an all-zero camera
// (the TPU kernel's masked one-hot), not K5's fill from the point's first
// valid lane: the Snavely chain divides by 1 there, so its terms stay
// finite and the mask zeroes them. Every sum keeps the order of the
// kernel this replaces: point sums in lane order from +0, each A entry
// (0 + the lane's cross terms, in lane order) * se, the camera sums per
// chunk in row order (masked rows' +-0 terms, which the plan drops, move
// no bit of a sum that starts at +0), then the chunks in order. Shared
// memory, registers and times beside the bound: PERF.md section 6
// (scripts/time_kernels.py --only K1, cuobjdump -res-usage).
// Robust loss: the chain is a template on the loss class (NoLoss, and the
// stock scalar losses of loss.py below), one entry point an instance
// (ceres_lin, ceres_lin_huber, ...; ops/lin.py K1_ENTRIES picks it by
// the loss's class). After snavely_residual each lane's jets take the
// Triggs corrector (correct_jets: loss.py correct_residuals_and_jacobian
// on one lane, in its order of operations; the JAX kernel's
// _correct_jets, ceres_tpu/ops/pallas_lin.py:113-114), with sq = 0 on a
// masked lane, so its terms stay finite before the mask zeroes them. The
// loss's scalars come as LossParams in ops/jet_compile.py loss_structure
// order, as K5's generated chains take them.

#include <cuda_runtime.h>

#include "lin_auto.cuh"
#include "snavely.cuh"

namespace {

// The losses' (rho', rho'') at s = ||r||^2, as loss.py evaluates them in
// f32 (rho itself is not needed by the corrector). p holds the loss's
// scalar attributes in their order of definition.
struct NoLoss {
  static constexpr bool kCorrect = false;
  static __device__ __forceinline__ void eval(float, const LossParams&,
                                              float&, float&) {}
};

struct HuberK1 {                    // p: a, b = a^2
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float a = lp.p[0], b = lp.p[1];
    const float sb = fmaxf(s, b);
    const float r1 = a / sqrtf(sb);
    const bool inlier = s <= b;
    rho1 = inlier ? 1.f : r1;
    rho2 = inlier ? 0.f : -0.5f * r1 / sb;
  }
};

struct SoftLOneK1 {                 // p: b = a^2, c = 1 / b
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float c = lp.p[1];
    const float total = 1.f + s * c;
    const float tmp = sqrtf(total);
    rho1 = 1.f / tmp;
    rho2 = -c / (2.f * total * tmp);
  }
};

struct CauchyK1 {                   // p: b = a^2, c = 1 / b
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float c = lp.p[1];
    const float inv = 1.f / (1.f + s * c);
    rho1 = inv;
    rho2 = -c * inv * inv;
  }
};

struct ArctanK1 {                   // p: a, b = 1 / a^2
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float b = lp.p[1];
    const float inv = 1.f / (1.f + s * s * b);
    rho1 = inv;
    rho2 = -2.f * s * b * inv * inv;
  }
};

struct TolerantK1 {                 // p: a, b, c
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float a = lp.p[0], b = lp.p[1];
    const float x = (s - a) / b;
    float sig = x > 35.f ? 1.f : 1.f / (1.f + expf(-fminf(fabsf(x), 35.f)));
    if (x < 0.f) {
      const float e = expf(fmaxf(x, -35.f));
      sig = e / (1.f + e);
    }
    rho1 = sig;
    rho2 = sig * (1.f - sig) / b;
  }
};

struct TukeyK1 {                    // p: a2 = a^2
  static constexpr bool kCorrect = true;
  static __device__ __forceinline__ void eval(float s, const LossParams& lp,
                                              float& rho1, float& rho2) {
    const float a2 = lp.p[0];
    const float value = fmaxf(1.f - s / a2, 0.f);
    const bool inlier = s <= a2;
    rho1 = inlier ? 0.5f * value * value : 0.f;
    rho2 = inlier ? -value / a2 : 0.f;
  }
};

// Triggs correction of one lane's R residual jets (loss.py
// correct_residuals_and_jacobian): r~ = rs r, J~ = sqrt(rho') (J - asn r
// r^T J), sq = 0 on an invalid lane (the simple branch)
template <class Loss, int R, int NT>
__device__ __forceinline__ void correct_jets(const LossParams& lp,
                                             bool valid, float (&rv)[R],
                                             float (&J)[R][NT]) {
  float sq = rv[0] * rv[0];
#pragma unroll
  for (int s = 1; s < R; ++s) sq += rv[s] * rv[s];
  if (!valid) sq = 0.f;
  float rho1, rho2;
  Loss::eval(sq, lp, rho1, rho2);
  const float sqrt_rho1 = sqrtf(fmaxf(rho1, 0.f));
  const bool simple = sq == 0.f || rho2 <= 0.f;
  const float safe_sq = sq == 0.f ? 1.f : sq;
  const float safe_rho1 = rho1 == 0.f ? 1.f : rho1;
  const float D = 1.f + 2.f * sq * rho2 / safe_rho1;
  const float alpha = 1.f - sqrtf(fmaxf(D, 0.f));
  const float rs = simple ? sqrt_rho1 : sqrt_rho1 / (1.f - alpha);
  const float asn = simple ? 0.f : alpha / safe_sq;
  float rtj[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float acc = rv[0] * J[0][t];
#pragma unroll
    for (int s = 1; s < R; ++s) acc += rv[s] * J[s][t];
    rtj[t] = acc;
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const float ar = asn * rv[s];
#pragma unroll
    for (int t = 0; t < NT; ++t) J[s][t] = sqrt_rho1 * (J[s][t] - ar * rtj[t]);
    rv[s] *= rs;
  }
}

template <class Loss>
struct SnavelyK1Chain {
  static constexpr int TE = 3, TF = 9, R = 2, NT = TF + TE;
  static constexpr int EO = TF, FO = 0, ND = 2;
  static __device__ __forceinline__ void run(
      const float* __restrict__ xf_c, const float* __restrict__ xe_n,
      const float* __restrict__ d, const LossParams& lp, bool valid,
      float (&rv)[R], float (&J)[R][NT]) {
    // a masked lane sees an all-zero camera
    Jet<NT> cp[TF], pt[TE], r[R];
#pragma unroll
    for (int a = 0; a < TF; ++a) cp[a] = jvar<NT>(valid ? xf_c[a] : 0.f, a);
#pragma unroll
    for (int a = 0; a < TE; ++a) pt[a] = jvar<NT>(xe_n[a], TF + a);
    snavely_residual<NT>(cp, pt, valid, d[0], d[1], r);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      rv[s] = r[s].v;
#pragma unroll
      for (int t = 0; t < NT; ++t) J[s][t] = r[s].d[t];
    }
    if (Loss::kCorrect) correct_jets<Loss, R, NT>(lp, valid, rv, J);
  }
};

}  // namespace

// The three launches of K1 on `stream`, with ceres_lin_auto's arguments
// (a generated K5 unit's entry point): lp_host and nlp, the loss's
// scalars (unused by ceres_lin, which takes no loss), pb points a block
// (ops/lin_auto.py lane_block(k, 3, 9)), pos [ne*k] and off [nchunks*kf
// + 1] the camera plan, q [nvalid, 54] and partial [nchunks, kf*54]
// scratch. Each returns lin_auto_launch's code.
#define CERES_LIN_ENTRY(NAME, LOSS)                                          \
  extern "C" int NAME(const float* xf, const float* xe, const int* cam,      \
                      const float* mask, const float* dat,                   \
                      const float* lp_host, int nlp, const float* se_in,     \
                      int first, int use_scaling, int ne, int k, int kf,     \
                      int pb, const int* pos, const int* off, int nchunks,   \
                      float* ete, float* ge, float* se_out, float* A,        \
                      float* q, float* partial, float* ftf, float* gf,       \
                      cudaStream_t stream) {                                 \
    return lin_auto_launch<SnavelyK1Chain<LOSS>>(                            \
        xf, xe, cam, mask, dat, lp_host, nlp, se_in, first, use_scaling, ne, \
        k, kf, pb, pos, off, nchunks, ete, ge, se_out, A, q, partial, ftf,   \
        gf, stream);                                                         \
  }

CERES_LIN_ENTRY(ceres_lin, NoLoss)
CERES_LIN_ENTRY(ceres_lin_huber, HuberK1)
CERES_LIN_ENTRY(ceres_lin_soft_l_one, SoftLOneK1)
CERES_LIN_ENTRY(ceres_lin_cauchy, CauchyK1)
CERES_LIN_ENTRY(ceres_lin_arctan, ArctanK1)
CERES_LIN_ENTRY(ceres_lin_tolerant, TolerantK1)
CERES_LIN_ENTRY(ceres_lin_tukey, TukeyK1)
