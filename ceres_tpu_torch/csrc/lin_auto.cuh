// K5: the linearize of any two-slot functor, with K1's epilogue: the
// point-side Grams, the e-scaled cross tensor and the camera-side
// block-diagonal Grams.
//
// Replaces ceres_tpu/ops/pallas_lin.py::_lin_kernel_auto (with
// _fold_ftf_gf_mxu and ops/jetlib.py's _correct_jets and _jet_planes).
// The residual jet chain is not written here: ops/jet_compile.py traces
// the bucket's per-row program and ops/lin_auto.py emits it as a struct
//   struct Chain {
//     static constexpr int TE, TF, R, NT, EO, FO, ND;
//     static __device__ void run(const float* xf_c, const float* xe_n,
//                                const float* d, const LossParams& lp,
//                                bool valid, float (&rv)[R],
//                                float (&J)[R][NT]);
//   };
// (the residuals and their tangent Jacobian of one observation lane, the
// Triggs corrector of a robust loss applied, with sq = 0 on an invalid
// lane), into a generated unit that includes this file and instantiates
// lin_auto_launch<Chain> behind the C entry point ceres_lin_auto.
// Same outputs as K1 (csrc/lin.cu), at general TE, TF and R:
//   ete [ne, TE*TE], ge [ne, TE], se [ne, TE]  (se: 1/(1+sqrt(diag E^T E))
//     when `first`, else the carried se_in; ones when scaling is off),
//   A [ne, TE, nf] = (s_e E)^T F, nf = kf*TF (zeroed by the caller),
//   ftf [kf, TF*TF], gf [kf, TF]: F^T F block diagonal and f gradient.
// Inputs in the Schur chunk layout [ne, k]: the camera of each lane as an
// int32 map and the data fields [ne, k, ND]. A masked lane carries its
// point's first valid lane's camera and data (the JAX package's fill
// rule, pallas_lin.py:735-763): a generic chain cannot be guarded, and a
// zero camera could put a divisor at 0 and give Inf, which the mask
// (Inf * 0 = NaN) would not remove.
//
// Bound on the H100: bytes. A alone is ne*TE*nf floats (42.4 MB at the
// quaternion BAL-16-22106 shape: 22,106 x 3 x 160 x 4 B), about 0.013 ms
// at 3.35 TB/s; the jet arithmetic and the epilogue (~800 operations a
// lane for the quaternion functor) are 0.001 ms at the f32 rate. This
// version takes 0.79 ms there (H100 80GB HBM3 at 700 W, chip_smoke.py;
// PERF.md), near K1's 0.58-0.70 ms at its shape. It is simple: one
// thread owns one point and loops over its k lanes, as lin_point_kernel
// does, so every per-point output is written without atomics; the lane's
// jets live in registers (the generated code is straight-line f32). The
// camera-side sums cross points: each lane writes its TF(TF+1)/2 + TF
// F-side terms to scratch, and two kernels reduce them in a fixed order
// (chunk partials, then partials in chunk order), so a run gives the same
// bits every time.
// No float atomics (the recorded decision on deterministic reductions).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int LIN_AUTO_MAX_LOSS_PARAMS = 16;

// a robust loss's scalars (kernel arguments: one build per loss class)
struct LossParams {
  float p[LIN_AUTO_MAX_LOSS_PARAMS];
};

namespace lin_auto {

template <class C>
__global__ void point_kernel(const float* __restrict__ xf,
                             const float* __restrict__ xe,
                             const int* __restrict__ cam,
                             const float* __restrict__ mask,
                             const float* __restrict__ dat, LossParams lp,
                             const float* __restrict__ se_in, int first,
                             int use_scaling, int ne, int k, int nf,
                             float* __restrict__ ete, float* __restrict__ ge,
                             float* __restrict__ se_out,
                             float* __restrict__ A, float* __restrict__ q) {
  constexpr int TE = C::TE, TF = C::TF, R = C::R, NT = C::NT;
  constexpr int EO = C::EO, FO = C::FO, ND = C::ND;
  constexpr int NPAIR = TF * (TF + 1) / 2;
  constexpr int NQ = NPAIR + TF;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ne) return;

  float g[TE];
  float m[TE][TE];
#pragma unroll
  for (int a = 0; a < TE; ++a) {
    g[a] = 0.f;
#pragma unroll
    for (int b = 0; b < TE; ++b) m[a][b] = 0.f;
  }
  float* An = A + (size_t)n * TE * nf;
  const float* xe_n = xe + (size_t)n * TE;

  for (int j = 0; j < k; ++j) {
    const int row = n * k + j;
    const float mk = mask[row];
    const bool valid = mk > 0.5f;
    const int c = cam[row];
    float rv[R];
    float J[R][NT];
    C::run(xf + (size_t)c * TF, xe_n, dat + (size_t)row * ND, lp, valid, rv,
           J);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      rv[s] *= mk;
#pragma unroll
      for (int t = 0; t < NT; ++t) J[s][t] *= mk;
    }

    // point-side Gram and gradient
#pragma unroll
    for (int a = 0; a < TE; ++a) {
      float acc = J[0][EO + a] * rv[0];
#pragma unroll
      for (int s = 1; s < R; ++s) acc += J[s][EO + a] * rv[s];
      g[a] += acc;
#pragma unroll
      for (int b = a; b < TE; ++b) {
        float p = J[0][EO + a] * J[0][EO + b];
#pragma unroll
        for (int s = 1; s < R; ++s) p += J[s][EO + a] * J[s][EO + b];
        m[a][b] += p;
      }
    }
    // unscaled cross terms into this point's own row of A
    if (valid) {
#pragma unroll
      for (int a = 0; a < TE; ++a)
#pragma unroll
        for (int t = 0; t < TF; ++t) {
          float p = J[0][EO + a] * J[0][FO + t];
#pragma unroll
          for (int s = 1; s < R; ++s) p += J[s][EO + a] * J[s][FO + t];
          An[a * nf + c * TF + t] += p;
        }
    }
    // F-side terms of this lane (zero when masked)
    float* qr = q + (size_t)row * NQ;
    int idx = 0;
#pragma unroll
    for (int t = 0; t < TF; ++t)
#pragma unroll
      for (int u = t; u < TF; ++u) {
        float p = J[0][FO + t] * J[0][FO + u];
#pragma unroll
        for (int s = 1; s < R; ++s) p += J[s][FO + t] * J[s][FO + u];
        qr[idx++] = p;
      }
#pragma unroll
    for (int t = 0; t < TF; ++t) {
      float p = J[0][FO + t] * rv[0];
#pragma unroll
      for (int s = 1; s < R; ++s) p += J[s][FO + t] * rv[s];
      qr[NPAIR + t] = p;
    }
  }

  float se[TE];
#pragma unroll
  for (int a = 0; a < TE; ++a) {
    if (!use_scaling)
      se[a] = 1.f;
    else
      se[a] = first ? 1.f / (1.f + sqrtf(m[a][a])) : se_in[n * TE + a];
    se_out[n * TE + a] = se[a];
    ge[n * TE + a] = g[a];
#pragma unroll
    for (int b = 0; b < TE; ++b)
      ete[n * TE * TE + a * TE + b] = a <= b ? m[a][b] : m[b][a];
  }
  for (int a = 0; a < TE; ++a)
    for (int f = 0; f < nf; ++f) An[a * nf + f] *= se[a];
}

// One block per chunk of lanes: partial[chunk, c*NQ + e] sums, in lane
// order, the terms of the chunk's lanes that observe camera c.
template <int TF>
__global__ void ftf_partial_kernel(const float* __restrict__ q,
                                   const int* __restrict__ cam, int rows,
                                   int rows_per_chunk, int kf,
                                   float* __restrict__ partial) {
  constexpr int NQ = TF * (TF + 1) / 2 + TF;
  const int chunk = blockIdx.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  for (int o = threadIdx.x; o < kf * NQ; o += blockDim.x) {
    const int c = o / NQ, e = o % NQ;
    float acc = 0.f;
    for (int r = r0; r < r1; ++r)
      if (cam[r] == c) acc += q[(size_t)r * NQ + e];
    partial[(size_t)chunk * kf * NQ + o] = acc;
  }
}

// Sums the chunk partials in chunk order and expands the Gram pairs to
// full symmetric TF x TF blocks.
template <int TF>
__global__ void ftf_final_kernel(const float* __restrict__ partial,
                                 int nchunks, int kf, float* __restrict__ ftf,
                                 float* __restrict__ gf) {
  constexpr int NPAIR = TF * (TF + 1) / 2;
  constexpr int NQ = NPAIR + TF;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kf * NQ) return;
  float acc = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) acc += partial[(size_t)ch * kf * NQ + o];
  const int c = o / NQ, e = o % NQ;
  if (e >= NPAIR) {
    gf[c * TF + (e - NPAIR)] = acc;
    return;
  }
  // e indexes the upper-triangle pair (t, u), t <= u, row-major
  int t = 0, rem = e;
  while (rem >= TF - t) {
    rem -= TF - t;
    ++t;
  }
  const int u = t + rem;
  ftf[c * TF * TF + t * TF + u] = acc;
  ftf[c * TF * TF + u * TF + t] = acc;
}

}  // namespace lin_auto

// The three launches of K5 on `stream`; lp_host holds the loss's nlp
// scalars (host memory). Returns cudaGetLastError().
template <class C>
int lin_auto_launch(const float* xf, const float* xe, const int* cam,
                    const float* mask, const float* dat, const float* lp_host,
                    int nlp, const float* se_in, int first, int use_scaling,
                    int ne, int k, int kf, int rows_per_chunk, float* ete,
                    float* ge, float* se_out, float* A, float* q,
                    float* partial, float* ftf, float* gf,
                    cudaStream_t stream) {
  if (nlp < 0 || nlp > LIN_AUTO_MAX_LOSS_PARAMS || rows_per_chunk < 1)
    return (int)cudaErrorInvalidValue;
  LossParams lp;
  for (int i = 0; i < LIN_AUTO_MAX_LOSS_PARAMS; ++i)
    lp.p[i] = i < nlp ? lp_host[i] : 0.f;
  constexpr int NQ = C::TF * (C::TF + 1) / 2 + C::TF;
  const int nf = kf * C::TF;
  const int rows = ne * k;
  const int nchunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  if (ne > 0)
    lin_auto::point_kernel<C><<<(ne + 127) / 128, 128, 0, stream>>>(
        xf, xe, cam, mask, dat, lp, se_in, first, use_scaling, ne, k, nf,
        ete, ge, se_out, A, q);
  if (nchunks > 0)
    lin_auto::ftf_partial_kernel<C::TF><<<nchunks, 256, 0, stream>>>(
        q, cam, rows, rows_per_chunk, kf, partial);
  if (kf > 0)
    lin_auto::ftf_final_kernel<C::TF><<<(kf * NQ + 255) / 256, 256, 0,
                                        stream>>>(partial, nchunks, kf, ftf,
                                                  gf);
  return (int)cudaGetLastError();
}
