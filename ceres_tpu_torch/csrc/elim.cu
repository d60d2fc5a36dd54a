// K2: damped point elimination into the reduced camera system, and K6,
// the same elimination from a given inverse.
//
// K2 replaces ceres_tpu/ops/pallas_lin.py::_elim2_kernel. Per point n:
//   M_n   = EtE_s[n] + diag[n] / radius            (3x3 SPD)
//   inv_n = M_n^-1 (closed-form cofactor inverse)
//   z_n   = inv_n * (-g_se[n])
// and over all points
//   S_corr = sum_n A_n^T inv_n A_n   [nf, nf]
//   rhs    = sum_n A_n^T z_n         [nf]
// with A [ne, 3, nf] from the linearize kernel (lin.cu).
// K6 (ELIM v1) replaces ceres_tpu/ops/pallas_lin.py::_elim_kernel: the
// same S_corr and rhs from an inv [ne, 3, 3] and z [ne, 3] that the caller
// gives (the ITERATIVE_SCHUR step forms them in PyTorch). The two share
// the S_corr and rhs kernels below and differ only in the first one.
//
// Bound on the H100: S_corr is a product with a reduction depth of
// 3 * ne (66k at BAL-16-22106) over nf^2 = 20,736 outputs: 2.8 GFLOP when
// Y = inv A is formed first (2 * 3 * nf^2 per point), ~42 us at the f32
// rate, against 39 MB of A (~12 us of memory time): operations bound it.
// The kernels below do 21 flops per (point, i, j) (Y recomputed per
// output), with A read once per output tile and served mostly from the
// 50 MB L2. Design:
// a first kernel writes inv and z per point (K2 only; kept for the back
// substitution); the product runs as 16x16 output tiles with split-K over
// chunks of points into partial sums, and a last kernel adds the partials
// in chunk order. No atomics, so a run gives the same bits every time.
// Dense in the camera columns: a point touches at most k of the kf camera
// blocks, and exploiting that sparsity is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TE = 3;
constexpr int TILE = 16;

__global__ void elim_point_kernel(const float* __restrict__ etes,
                                  const float* __restrict__ gse,
                                  const float* __restrict__ diag, float rad,
                                  int ne, float* __restrict__ inv,
                                  float* __restrict__ z) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ne) return;
  const float* e = etes + n * 9;
  const float a = e[0] + diag[n * 3 + 0] / rad;
  const float b = e[1];
  const float c = e[2];
  const float d = e[4] + diag[n * 3 + 1] / rad;
  const float ee = e[5];
  const float f = e[8] + diag[n * 3 + 2] / rad;
  const float co00 = d * f - ee * ee;
  const float co01 = c * ee - b * f;
  const float co02 = b * ee - c * d;
  const float co11 = a * f - c * c;
  const float co12 = b * c - a * ee;
  const float co22 = a * d - b * b;
  const float det = a * co00 + b * co01 + c * co02;
  const float invdet = 1.f / det;
  const float iv[9] = {co00 * invdet, co01 * invdet, co02 * invdet,
                       co01 * invdet, co11 * invdet, co12 * invdet,
                       co02 * invdet, co12 * invdet, co22 * invdet};
#pragma unroll
  for (int i = 0; i < 9; ++i) inv[n * 9 + i] = iv[i];
  const float* g = gse + n * TE;
#pragma unroll
  for (int i = 0; i < TE; ++i) {
    float acc = iv[i * 3 + 0] * (-g[0]);
    acc = acc + iv[i * 3 + 1] * (-g[1]);
    acc = acc + iv[i * 3 + 2] * (-g[2]);
    z[n * TE + i] = acc;
  }
}

// grid (tiles_i * tiles_j, nsplit), block TILE x TILE: one output entry
// (i, j) per thread, summed over the split's points.
__global__ void scorr_partial_kernel(const float* __restrict__ A,
                                     const float* __restrict__ inv, int ne,
                                     int nf, int pts_per_split,
                                     float* __restrict__ partial) {
  const int tiles_j = (nf + TILE - 1) / TILE;
  const int ti = blockIdx.x / tiles_j, tj = blockIdx.x % tiles_j;
  const int i = ti * TILE + threadIdx.y;
  const int j = tj * TILE + threadIdx.x;
  const int split = blockIdx.y;
  const int n0 = split * pts_per_split;
  const int n1 = min(ne, n0 + pts_per_split);
  if (i >= nf || j >= nf) return;
  float acc = 0.f;
  for (int n = n0; n < n1; ++n) {
    const float* An = A + (size_t)n * TE * nf;
    const float* iv = inv + n * 9;
    const float a0 = An[i], a1 = An[nf + i], a2 = An[2 * nf + i];
    const float b0 = An[j], b1 = An[nf + j], b2 = An[2 * nf + j];
    const float y0 = iv[0] * b0 + iv[1] * b1 + iv[2] * b2;
    const float y1 = iv[3] * b0 + iv[4] * b1 + iv[5] * b2;
    const float y2 = iv[6] * b0 + iv[7] * b1 + iv[8] * b2;
    acc += a0 * y0 + a1 * y1 + a2 * y2;
  }
  partial[(size_t)split * nf * nf + (size_t)i * nf + j] = acc;
}

__global__ void rhs_partial_kernel(const float* __restrict__ A,
                                   const float* __restrict__ z, int ne, int nf,
                                   int pts_per_split,
                                   float* __restrict__ partial) {
  const int split = blockIdx.x;
  const int n0 = split * pts_per_split;
  const int n1 = min(ne, n0 + pts_per_split);
  for (int i = threadIdx.x; i < nf; i += blockDim.x) {
    float acc = 0.f;
    for (int n = n0; n < n1; ++n) {
      const float* An = A + (size_t)n * TE * nf;
      acc += An[i] * z[n * TE] + An[nf + i] * z[n * TE + 1] +
             An[2 * nf + i] * z[n * TE + 2];
    }
    partial[(size_t)split * nf + i] = acc;
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     int nsplit, int width,
                                     float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= width) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += partial[(size_t)s * width + o];
  out[o] = acc;
}

// S_corr and rhs from inv and z: split-K partials, then the fixed-order
// sum over the splits.
cudaError_t scorr_rhs(const float* A, const float* inv, const float* z,
                      int ne, int nf, int pts_per_split, float* scorr,
                      float* rhs, float* scorr_partial, float* rhs_partial,
                      cudaStream_t stream) {
  const int nsplit = (ne + pts_per_split - 1) / pts_per_split;
  const int tiles = (nf + TILE - 1) / TILE;
  scorr_partial_kernel<<<dim3(tiles * tiles, nsplit), dim3(TILE, TILE), 0,
                         stream>>>(A, inv, ne, nf, pts_per_split,
                                   scorr_partial);
  rhs_partial_kernel<<<nsplit, 256, 0, stream>>>(A, z, ne, nf, pts_per_split,
                                                 rhs_partial);
  reduce_splits_kernel<<<(nf * nf + 255) / 256, 256, 0, stream>>>(
      scorr_partial, nsplit, nf * nf, scorr);
  reduce_splits_kernel<<<(nf + 255) / 256, 256, 0, stream>>>(rhs_partial,
                                                             nsplit, nf, rhs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ceres_elim(const float* A, const float* etes, const float* gse,
                          const float* diag, float rad, int ne, int nf,
                          int pts_per_split, float* scorr, float* rhs,
                          float* inv, float* z, float* scorr_partial,
                          float* rhs_partial, cudaStream_t stream) {
  elim_point_kernel<<<(ne + 127) / 128, 128, 0, stream>>>(etes, gse, diag, rad,
                                                          ne, inv, z);
  return (int)scorr_rhs(A, inv, z, ne, nf, pts_per_split, scorr, rhs,
                        scorr_partial, rhs_partial, stream);
}

extern "C" int ceres_elim_v1(const float* A, const float* inv, const float* z,
                             int ne, int nf, int pts_per_split, float* scorr,
                             float* rhs, float* scorr_partial,
                             float* rhs_partial, cudaStream_t stream) {
  return (int)scorr_rhs(A, inv, z, ne, nf, pts_per_split, scorr, rhs,
                        scorr_partial, rhs_partial, stream);
}
