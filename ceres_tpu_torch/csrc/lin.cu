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
// The camera of each observation lane comes from an int32 [ne, k] map
// (the Schur chunk layout), not a one-hot.
//
// Bound on the H100: the kernel is bound by the jet arithmetic of one
// thread per point (12-channel duals, ~4 lanes each) and by the bytes of
// A (3*nf floats per point, 39 MB at BAL-16-22106), which is written by
// the memset, read-modify-written per lane and once more for the scale.
// Design: one thread owns one point, so every per-point output is written
// without atomics. The camera-side sums cross points; on the TPU they
// accumulate across sequential grid steps, here each lane writes its 54
// F-side terms (45 upper-triangle Gram pairs + 9 gradient terms) to a
// scratch buffer and two more kernels reduce it in a fixed order (chunk
// partials, then partials in chunk order), so a run gives the same bits
// every time.

#include <cuda_runtime.h>

#include "snavely.cuh"

namespace {

constexpr int TF = 9;                      // camera tangent
constexpr int TE = 3;                      // point tangent
constexpr int NT = TF + TE;                // jet channels: camera first
constexpr int NPAIR = TF * (TF + 1) / 2;   // 45
constexpr int NQ = NPAIR + TF;             // 54 F-side terms per lane
typedef Jet<NT> J;

__global__ void lin_point_kernel(
    const float* __restrict__ xf, const float* __restrict__ xe,
    const int* __restrict__ cam, const float* __restrict__ mask,
    const float* __restrict__ obsx, const float* __restrict__ obsy,
    const float* __restrict__ se_in, int first, int use_scaling, int ne,
    int k, int nf, float* __restrict__ ete, float* __restrict__ ge,
    float* __restrict__ se_out, float* __restrict__ A,
    float* __restrict__ q) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ne) return;

  float g[TE] = {0.f, 0.f, 0.f};
  float m[TE][TE] = {{0.f}};
  float* An = A + (size_t)n * TE * nf;

  for (int j = 0; j < k; ++j) {
    const int row = n * k + j;
    const float mk = mask[row];
    const bool valid = mk > 0.5f;
    const int c = cam[row];
    // masked lanes see an all-zero camera, as the TPU kernel's masked
    // one-hot gives them
    J cp[TF];
#pragma unroll
    for (int a = 0; a < TF; ++a)
      cp[a] = jvar<NT>(valid ? xf[c * TF + a] : 0.f, a);
    J pt[TE];
#pragma unroll
    for (int a = 0; a < TE; ++a) pt[a] = jvar<NT>(xe[n * TE + a], TF + a);

    J r[2];
    snavely_residual<NT>(cp, pt, valid, obsx[row], obsy[row], r);

    float rv[2], Jr[2][NT];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      rv[s] = r[s].v * mk;
#pragma unroll
      for (int t = 0; t < NT; ++t) Jr[s][t] = r[s].d[t] * mk;
    }

    // point-side Gram and gradient
#pragma unroll
    for (int a = 0; a < TE; ++a) {
      g[a] += Jr[0][TF + a] * rv[0] + Jr[1][TF + a] * rv[1];
#pragma unroll
      for (int b = a; b < TE; ++b)
        m[a][b] += Jr[0][TF + a] * Jr[0][TF + b] + Jr[1][TF + a] * Jr[1][TF + b];
    }
    // unscaled cross terms into this point's own row of A
    if (valid) {
#pragma unroll
      for (int a = 0; a < TE; ++a)
#pragma unroll
        for (int t = 0; t < TF; ++t)
          An[a * nf + c * TF + t] +=
              Jr[0][TF + a] * Jr[0][t] + Jr[1][TF + a] * Jr[1][t];
    }
    // F-side terms of this lane (zero when masked)
    float* qr = q + (size_t)row * NQ;
    int idx = 0;
#pragma unroll
    for (int t = 0; t < TF; ++t)
#pragma unroll
      for (int u = t; u < TF; ++u)
        qr[idx++] = Jr[0][t] * Jr[0][u] + Jr[1][t] * Jr[1][u];
#pragma unroll
    for (int t = 0; t < TF; ++t) qr[NPAIR + t] = Jr[0][t] * rv[0] + Jr[1][t] * rv[1];
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
__global__ void ftf_partial_kernel(const float* __restrict__ q,
                                   const int* __restrict__ cam, int rows,
                                   int rows_per_chunk, int kf,
                                   float* __restrict__ partial) {
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
// full symmetric 9x9 blocks.
__global__ void ftf_final_kernel(const float* __restrict__ partial,
                                 int nchunks, int kf, float* __restrict__ ftf,
                                 float* __restrict__ gf) {
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

}  // namespace

extern "C" int ceres_lin(const float* xf, const float* xe, const int* cam,
                         const float* mask, const float* obsx,
                         const float* obsy, const float* se_in, int first,
                         int use_scaling, int ne, int k, int kf,
                         int rows_per_chunk, float* ete, float* ge,
                         float* se_out, float* A, float* q, float* partial,
                         float* ftf, float* gf, cudaStream_t stream) {
  const int nf = kf * TF;
  const int rows = ne * k;
  const int nchunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  lin_point_kernel<<<(ne + 127) / 128, 128, 0, stream>>>(
      xf, xe, cam, mask, obsx, obsy, se_in, first, use_scaling, ne, k, nf,
      ete, ge, se_out, A, q);
  ftf_partial_kernel<<<nchunks, 256, 0, stream>>>(q, cam, rows,
                                                  rows_per_chunk, kf, partial);
  ftf_final_kernel<<<(kf * NQ + 255) / 256, 256, 0, stream>>>(
      partial, nchunks, kf, ftf, gf);
  return (int)cudaGetLastError();
}
