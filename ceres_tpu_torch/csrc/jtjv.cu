// K8: the CGNR normal-equations operator of one bucket,
// u_n = J_n^T (J_n v_n) per row n, with J read from device memory once.
//
// Replaces ceres_tpu/ops/pallas_kernels.py::_jtjv_kernel (bucket_jtjv).
// The same function boundary: the gather v_n = v[cols_n] and the scatter
// of u into the tangent vector stay outside (ops/kernels.py
// jac_normal_matvec), so the kernel, its plain version (two einsums) and
// the library yardstick compute the same thing:
//   J  [n, r, t]  f32 block Jacobians, row-major
//   vb [n, t]     f32 gathered v per row
//   u  [n, t]     f32 output
//
// Bound on the H100: bytes, (n r t + 2 n t) * 4 over 3.35 TB/s; it does
// 4 r t flops per row, ~1 flop per byte. Design: one thread per row; the
// row's r partial sums w = J v stay in registers (r <= 32, the loops
// unrolled to a compile-time bound), the second pass over the row's J
// hits L1. Same summation order as the TPU kernel: each w_r and each u_c
// adds its terms in index order. Nothing is reduced across threads.

#include <cuda_runtime.h>

namespace {

template <int MAXR>
__global__ void jtjv_kernel(const float* __restrict__ J,
                            const float* __restrict__ vb, int n, int r, int t,
                            float* __restrict__ u) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* Jn = J + (size_t)row * r * t;
  const float* v = vb + (size_t)row * t;
  float w[MAXR];
#pragma unroll
  for (int rr = 0; rr < MAXR; ++rr) {
    float acc = 0.f;
    if (rr < r) {
      for (int c = 0; c < t; ++c) acc += Jn[rr * t + c] * v[c];
    }
    w[rr] = acc;
  }
  float* un = u + (size_t)row * t;
  for (int c = 0; c < t; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int rr = 0; rr < MAXR; ++rr) {
      if (rr < r) acc += Jn[rr * t + c] * w[rr];
    }
    un[c] = acc;
  }
}

}  // namespace

extern "C" int ceres_jtjv(const float* J, const float* vb, int n, int r,
                          int t, float* u, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > 32 || t < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (r <= 4) {
    jtjv_kernel<4><<<blocks, threads, 0, stream>>>(J, vb, n, r, t, u);
  } else if (r <= 8) {
    jtjv_kernel<8><<<blocks, threads, 0, stream>>>(J, vb, n, r, t, u);
  } else if (r <= 16) {
    jtjv_kernel<16><<<blocks, threads, 0, stream>>>(J, vb, n, r, t, u);
  } else {
    jtjv_kernel<32><<<blocks, threads, 0, stream>>>(J, vb, n, r, t, u);
  }
  return (int)cudaGetLastError();
}
