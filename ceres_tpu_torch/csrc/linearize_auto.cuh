// K11 through an auto spec: the residuals and the tangent-space Jacobian
// of one bucket, for any functor that ops/jet_compile.py traces.
//
// Replaces ceres_tpu/ops/pallas_linearize.py::_lin_kernel on its auto
// specs (the "emit_raw" branch; _spec_for :271-302 ->
// ops/jet_compile.py make_auto_spec). The row's jet chain is not written
// here: ops/jet_compile.py traces the bucket's per-row program (the
// functor after every variable slot's Plus) and `row_chain_source` emits
// it as a struct
//   struct RowChain {
//     static constexpr int R, NT, P_IN, P_DAT;
//     static __device__ void run(const float* x, const float* d,
//                                float (&rv)[R], float (&J)[R][NT]);
//   };
// (one row's uncorrected residuals and their Jacobian in the variable
// slots' tangents, in slot order, 0 for structurally zero channels) into
// a generated unit that includes this file and instantiates
// linearize_auto_launch<RowChain> behind the C entry point
// ceres_linearize_auto (ops/linearize.py generated_unit).
//   xin [n, P_IN]   f32 slot-concatenated ambient values of each row
//   dat [n, P_DAT]  f32 data fields in sorted-name order
//   r   [n, R], J [n, R, NT]  f32 outputs
//
// Bound on the H100: bytes, (P_IN + P_DAT + R + R NT) * 4 a row over
// 3.35 TB/s (43 floats, 172 B a row for the quaternion Snavely functor:
// 0.051 ms at 1M rows); its chain is a few hundred f32 operations a row.
// The design is the simplest that is right: one thread per row, the
// row's inputs loaded into registers, the straight-line chain, and the
// outputs stored from registers. Each thread writes R + R NT contiguous
// floats, so a warp's stores stride by that many; staging the stores
// through shared memory is later work. ops/linearize.py refuses a chain
// with R * NT > MAX_AUTO_OUTPUTS (128) at build: J lives in registers.
// No reductions, no atomics.

#pragma once

#include <cuda_runtime.h>

namespace linearize_auto {

template <class C>
__global__ void row_kernel(const float* __restrict__ xin,
                           const float* __restrict__ dat, int n,
                           float* __restrict__ r, float* __restrict__ J) {
  constexpr int R = C::R, NT = C::NT, P_IN = C::P_IN, P_DAT = C::P_DAT;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float x[P_IN];
  float d[P_DAT > 0 ? P_DAT : 1];
  const float* xr = xin + (size_t)row * P_IN;
#pragma unroll
  for (int a = 0; a < P_IN; ++a) x[a] = xr[a];
  if (P_DAT > 0) {
    const float* dr = dat + (size_t)row * P_DAT;
#pragma unroll
    for (int a = 0; a < P_DAT; ++a) d[a] = dr[a];
  }
  float rv[R];
  float Jr[R][NT];
  C::run(x, d, rv, Jr);
  float* ro = r + (size_t)row * R;
  float* Jo = J + (size_t)row * R * NT;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    ro[s] = rv[s];
#pragma unroll
    for (int c = 0; c < NT; ++c) Jo[s * NT + c] = Jr[s][c];
  }
}

}  // namespace linearize_auto

template <class C>
int linearize_auto_launch(const float* xin, const float* dat, int n,
                          float* r, float* J, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  linearize_auto::row_kernel<C>
      <<<blocks, threads, 0, stream>>>(xin, dat, n, r, J);
  return (int)cudaGetLastError();
}
