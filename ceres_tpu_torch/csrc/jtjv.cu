// K8: the CGNR normal-equations operator of one bucket,
// u_n = J_n^T (J_n v[cols_n]) per row n, with J read from device memory
// once and the gather of v folded in.
//
// Replaces ceres_tpu/ops/pallas_kernels.py::_jtjv_kernel (bucket_jtjv).
// The TPU kernel took the gathered v per row; here the kernel gathers v
// itself, as K10 does (csrc/implicit.cu), so the CG operator launches no
// separate gather per bucket. The scatter of u into the tangent vector
// (the fixed-order column sum, ops/bsr.py ColumnSum) stays outside:
//   J    [n, r, t]  f32 block Jacobians, row-major
//   v    [m]        f32 the tangent vector (m = the program's columns)
//   cols [n, t]     i32 each row's global columns, < m
//   u    [n, t]     f32 output
//
// Bound on the H100: bytes, (n r t + n t + n t) * 4 + m * 4 over
// 3.35 TB/s; it does 4 r t flops per row, ~1 flop per byte. At the pose
// graphs' sizes (a few thousand rows, under 1 MB) the launch and one
// chain of dependent loads (cols, then v) set the device time.
//
// Design: L lanes per row, L the power of two >= t (at most 32), so a warp
// holds 32 / L rows and lane c owns column c (c, c + L, ... past 32). A
// warp's load of row entry (q, c) reads L consecutive floats of each of
// its rows; the row's J comes from device memory once and stays in
// registers. w = J v: each lane forms its column's products, then the
// row's lanes sum them by an xor butterfly (every lane ends with the same
// bits, in one fixed order). u = J^T w: each lane sums its column over q
// in index order. No atomics: every application gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <int MAXR>
__global__ void jtjv_kernel(const float* __restrict__ J,
                            const float* __restrict__ v,
                            const int* __restrict__ cols, int n, int r,
                            int t, int log2l, float* __restrict__ u) {
  const int L = 1 << log2l;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid >> log2l;
  const int lane = gid & (L - 1);
  const bool live = row < n;       // uniform across a row's lanes
  const float* Jn = J + (size_t)(live ? row : 0) * r * t;
  const int* cn = cols + (size_t)(live ? row : 0) * t;

  // w = J v: this lane's columns, then the butterfly across the row
  float jc[MAXR];                  // J[:, lane] when t <= L
  float p[MAXR];
#pragma unroll
  for (int q = 0; q < MAXR; ++q) jc[q] = p[q] = 0.f;
  if (live) {
    for (int c = lane; c < t; c += L) {
      const float vc = v[cn[c]];
#pragma unroll
      for (int q = 0; q < MAXR; ++q) {
        if (q < r) {
          const float jq = Jn[q * t + c];
          jc[q] = jq;
          p[q] += jq * vc;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < MAXR; ++q) {
    if (q < r) {
      for (int off = L >> 1; off > 0; off >>= 1)
        p[q] += __shfl_xor_sync(0xffffffffu, p[q], off, L);
    }
  }
  if (!live) return;

  // u = J^T w: each lane its own columns, q in index order
  if (t <= L) {
    if (lane < t) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAXR; ++q)
        if (q < r) acc += jc[q] * p[q];
      u[(size_t)row * t + lane] = acc;
    }
  } else {
    for (int c = lane; c < t; c += L) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAXR; ++q)
        if (q < r) acc += Jn[q * t + c] * p[q];
      u[(size_t)row * t + c] = acc;
    }
  }
}

}  // namespace

extern "C" int ceres_jtjv(const float* J, const float* v, const int* cols,
                          int n, int r, int t, float* u,
                          cudaStream_t stream) {
  if (n <= 0 || t <= 0) return 0;
  if (r < 1 || r > 32) return (int)cudaErrorInvalidValue;
  int log2l = 0;
  while ((1 << log2l) < t && log2l < 5) ++log2l;
  const long threads_total = (long)n << log2l;
  const int blocks = (int)((threads_total + THREADS - 1) / THREADS);
  if (r <= 4) {
    jtjv_kernel<4><<<blocks, THREADS, 0, stream>>>(J, v, cols, n, r, t,
                                                   log2l, u);
  } else if (r <= 8) {
    jtjv_kernel<8><<<blocks, THREADS, 0, stream>>>(J, v, cols, n, r, t,
                                                   log2l, u);
  } else if (r <= 16) {
    jtjv_kernel<16><<<blocks, THREADS, 0, stream>>>(J, v, cols, n, r, t,
                                                    log2l, u);
  } else {
    jtjv_kernel<32><<<blocks, THREADS, 0, stream>>>(J, v, cols, n, r, t,
                                                    log2l, u);
  }
  return (int)cudaGetLastError();
}
