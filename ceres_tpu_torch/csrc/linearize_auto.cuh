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
// linearize_auto_launch<RowChain, TILE> behind the C entry point
// ceres_linearize_auto (ops/linearize.py generated_unit, which picks
// TILE, the rows a block, with auto_tile).
//   xin [n, P_IN]   f32 slot-concatenated ambient values of each row
//   dat [n, P_DAT]  f32 data fields in sorted-name order
//   r   [n, R], J [n, R, NT]  f32 outputs
//
// Bound on the H100: bytes, (P_IN + P_DAT + R + R NT) * 4 a row over
// 3.35 TB/s (43 floats, 172 B a row for the quaternion Snavely functor:
// 0.051 ms at 1M rows); its chain is a few hundred f32 operations a row.
// Design: a block of TILE threads takes TILE rows. Their xin and dat
// slices are contiguous, so the block loads them with 16-byte loads
// (4-byte where a slice or its pointer is not 16-byte aligned) into
// shared memory at an odd row stride; each thread copies its row into
// registers and runs the straight-line chain; it leaves r and J in
// shared memory, in the same buffer, at odd strides; the block streams
// both tiles out contiguously with 16-byte stores. (A thread loading and
// storing its own row would stride a warp's accesses by the row's width,
// and none would coalesce.) Every output is the chain's own value, so the
// staging moves no bit. (cp.async would overlap a tile's loads with
// nothing here: a block loads once.)
// ops/linearize.py refuses a chain with R * NT > MAX_AUTO_OUTPUTS (128)
// (J lives in registers) or whose 32-row tile passes 48 KB.
// Registers of the quaternion unit for sm_90a (scripts/time_kernels.py,
// cuobjdump -res-usage): 48, no spill to local memory, 15 KB of static
// shared memory at 128 rows a tile (__launch_bounds__(TILE)). Its time on
// the H100 beside the bound: PERF.md section 6.
// No reductions, no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace linearize_auto {

// rows [r0, r0 + nr) of a [*, W] f32 array (src + r0 * W, w = nr * W
// floats) into shared rows at stride S, or back; 16-byte accesses when
// the global slice is aligned
template <int W, int S, bool LOAD>
__device__ __forceinline__ void stream(float* __restrict__ g, float* sm,
                                       int w, int tid, int nthreads) {
  const bool vec = (((uintptr_t)g) & 15) == 0;
  const int w4 = vec ? w / 4 : 0;
  for (int i = tid; i < w4; i += nthreads) {
    float v[4];
    if (LOAD) {
      const float4 t = reinterpret_cast<const float4*>(g)[i];
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = 4 * i + u, row = o / W;
      float& s = sm[row * S + (o - row * W)];
      if (LOAD)
        s = v[u];
      else
        v[u] = s;
    }
    if (!LOAD)
      reinterpret_cast<float4*>(g)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int o = 4 * w4 + tid; o < w; o += nthreads) {
    const int row = o / W;
    float& s = sm[row * S + (o - row * W)];
    if (LOAD)
      s = g[o];
    else
      g[o] = s;
  }
}

template <class C, int TILE>
__global__ void __launch_bounds__(TILE)
    row_kernel(const float* __restrict__ xin, const float* __restrict__ dat,
               int n, float* __restrict__ r, float* __restrict__ J) {
  constexpr int R = C::R, NT = C::NT, P_IN = C::P_IN, P_DAT = C::P_DAT;
  constexpr int RN = R * NT;
  constexpr int XS = P_IN | 1, DS = P_DAT | 1, RS = R | 1, JS = RN | 1;
  constexpr int IN = XS + (P_DAT > 0 ? DS : 0), OUT = RS + JS;
  __shared__ float buf[TILE * (IN > OUT ? IN : OUT)];
  float* sX = buf;                        // [TILE][XS], then
  float* sD = buf + TILE * XS;            // [TILE][DS]
  float* sR = buf;                        // [TILE][RS], then
  float* sJ = buf + TILE * RS;            // [TILE][JS]
  const int tid = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * TILE;
  const int nr = min(TILE, n - (int)r0);

  stream<P_IN, XS, true>(const_cast<float*>(xin) + r0 * P_IN, sX, nr * P_IN,
                         tid, TILE);
  if (P_DAT > 0)
    stream<P_DAT, DS, true>(const_cast<float*>(dat) + r0 * P_DAT, sD,
                            nr * P_DAT, tid, TILE);
  __syncthreads();
  float x[P_IN];
  float d[P_DAT > 0 ? P_DAT : 1];
  if (tid < nr) {
#pragma unroll
    for (int a = 0; a < P_IN; ++a) x[a] = sX[tid * XS + a];
#pragma unroll
    for (int a = 0; a < P_DAT; ++a) d[a] = sD[tid * DS + a];
  }
  __syncthreads();                        // the outputs reuse the buffer
  if (tid < nr) {
    float rv[R];
    float Jr[R][NT];
    C::run(x, d, rv, Jr);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      sR[tid * RS + s] = rv[s];
#pragma unroll
      for (int c = 0; c < NT; ++c) sJ[tid * JS + s * NT + c] = Jr[s][c];
    }
  }
  __syncthreads();
  stream<R, RS, false>(r + r0 * R, sR, nr * R, tid, TILE);
  stream<RN, JS, false>(J + r0 * RN, sJ, nr * RN, tid, TILE);
}

}  // namespace linearize_auto

template <class C, int TILE>
int linearize_auto_launch(const float* xin, const float* dat, int n,
                          float* r, float* J, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE - 1) / TILE;
  linearize_auto::row_kernel<C, TILE>
      <<<blocks, TILE, 0, stream>>>(xin, dat, n, r, J);
  return (int)cudaGetLastError();
}
