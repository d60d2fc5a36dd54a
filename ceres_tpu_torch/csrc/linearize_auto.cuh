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
// TILE, the rows a block, with auto_tile). K11's three hand specs
// (csrc/linearize.cu: Pose3dRow, Pose2dRow, SnavelyRow) are chains of
// the same form, written by hand and run by the same kernel at TILE 128.
//   xin [n, P_IN]   f32 slot-concatenated ambient values of each row
//   dat [n, P_DAT]  f32 data fields in sorted-name order
//   r   [n, R], J [n, R, NT]  f32 outputs
//
// Bound on the H100: bytes, (P_IN + P_DAT + R + R NT) * 4 a row over
// 3.35 TB/s (43 floats, 172 B a row for the quaternion Snavely functor:
// 0.051 ms at 1M rows; 40 floats, 160 B for the hand Snavely chain:
// 0.048 ms). Its chain is a few hundred f32 operations a row for a traced
// chain, ~2,000 for the hand chains' dense 12-channel jets: at 1M rows
// those are ~30 us of issue on their own, no longer small beside the
// bytes.
// Design: a persistent grid of as many blocks of TILE threads as the card
// holds at once; a block takes tiles of TILE rows, blockIdx.x,
// blockIdx.x + gridDim.x, ... A tile's xin and dat slices are contiguous,
// so the block copies them into shared memory as they lie, by cp.async
// (16-byte copies, 4-byte where a slice or its pointer is not 16-byte
// aligned), into one of two input buffers: the next tile's copies are in
// flight while this tile's chains run, so the memory does not idle while
// the SMs compute (with a block a tile, every block of a wave loaded,
// computed and stored in step, and the chain's time added to the bytes':
// scripts/k11_variants.py). Each thread runs its row's straight-line chain
// on its row in shared memory and leaves r and J in an output buffer at
// odd strides; the block streams both out contiguously with 16-byte
// stores. (A thread loading and storing its own row would stride a
// warp's accesses by the row's width, and none would coalesce.) Every
// output is the chain's own value, so the staging moves no bit.
// Shared memory a block (dynamic): two input tiles and one output tile,
// 4 (2 TILE (P_IN + P_DAT) + TILE (R|1 + (R NT)|1)) bytes, at most 3x the
// 48 KB that ops/linearize.py auto_tile holds the larger of a tile's
// inputs and outputs to (28 KB for the Snavely chains at 128 rows, 97 KB
// for SE3, which then takes two blocks a SM).
// ops/linearize.py refuses a chain with R * NT > MAX_AUTO_OUTPUTS (128)
// (J lives in registers) or whose 32-row tile passes 48 KB.
// Registers (scripts/time_kernels.py, cuobjdump -res-usage) and times
// beside the bound: PERF.md section 6.
// No reductions, no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace linearize_auto {

// rows [r0, r0 + nr) of a [*, W] f32 array (g = its row r0, w = nr * W
// floats) from shared rows at stride S, with 16-byte stores when g is
// aligned
template <int W, int S>
__device__ __forceinline__ void store_rows(float* __restrict__ g,
                                           const float* sm, int w, int tid,
                                           int nthreads) {
  const int w4 = (((uintptr_t)g) & 15) == 0 ? w / 4 : 0;
  for (int i = tid; i < w4; i += nthreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = 4 * i + u, row = o / W;
      v[u] = sm[row * S + (o - row * W)];
    }
    reinterpret_cast<float4*>(g)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int o = 4 * w4 + tid; o < w; o += nthreads) {
    const int row = o / W;
    g[o] = sm[row * S + (o - row * W)];
  }
}

// cp.async: one 16-byte or 4-byte copy from device to shared memory,
// issued without a register; commit closes a group of them, and
// wait_prior waits for every group but the newest (a plain copy, and
// nothing to wait for, in a host pass)
__device__ __forceinline__ void copy_async16(float* sm, const float* g) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(sm)),
               "l"(g));
#else
  for (int i = 0; i < 4; ++i) sm[i] = g[i];
#endif
}

__device__ __forceinline__ void copy_async4(float* sm, const float* g) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(sm)),
               "l"(g));
#else
  *sm = *g;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait_prior() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// w contiguous floats from g into sm (16-byte aligned), asynchronously;
// 16-byte copies when g is aligned too
__device__ __forceinline__ void load_async(float* sm, const float* g, int w,
                                           int tid, int nthreads) {
  const int w4 = (((uintptr_t)g) & 15) == 0 ? w / 4 : 0;
  for (int i = tid; i < w4; i += nthreads)
    copy_async16(sm + 4 * i, g + 4 * i);
  for (int o = 4 * w4 + tid; o < w; o += nthreads) copy_async4(sm + o, g + o);
}

// the row strides of a tile's outputs (odd, against bank conflicts), and
// a block's dynamic shared memory in floats: two input tiles [TILE][P_IN]
// then [TILE][P_DAT], as the rows lie in device memory, and one output
// tile [TILE][RS] then [TILE][JS]
template <class C, int TILE>
struct RowTile {
  static constexpr int RS = C::R | 1, JS = (C::R * C::NT) | 1;
  static constexpr int IN = TILE * (C::P_IN + C::P_DAT);
  static constexpr int FLOATS = 2 * IN + TILE * (RS + JS);
};

template <class C, int TILE>
__global__ void __launch_bounds__(TILE)
    row_kernel(const float* __restrict__ xin, const float* __restrict__ dat,
               int n, float* __restrict__ r, float* __restrict__ J) {
  constexpr int R = C::R, NT = C::NT, P_IN = C::P_IN, P_DAT = C::P_DAT;
  constexpr int RN = R * NT;
  using T = RowTile<C, TILE>;
  constexpr int RS = T::RS, JS = T::JS, IN = T::IN;
  static_assert(TILE % 4 == 0, "a tile's slices start 16-byte aligned");
  extern __shared__ float4 smem4[];
  float* const sIn = reinterpret_cast<float*>(smem4);  // [2][IN]
  float* const sR = sIn + 2 * IN;                       // [TILE][RS], then
  float* const sJ = sR + TILE * RS;                     // [TILE][JS]
  const int tid = threadIdx.x;
  const int ntiles = (n + TILE - 1) / TILE;

  // tile t's xin and dat slices into input buffer b
  auto load = [&](int t, int b) {
    const size_t r0 = (size_t)t * TILE;
    const int nr = min(TILE, n - (int)r0);
    load_async(sIn + b * IN, xin + r0 * P_IN, nr * P_IN, tid, TILE);
    if (P_DAT > 0)
      load_async(sIn + b * IN + TILE * P_IN, dat + r0 * P_DAT, nr * P_DAT,
                 tid, TILE);
  };
  int t = blockIdx.x;
  if (t < ntiles) load(t, 0);
  copy_commit();
  for (int b = 0; t < ntiles; t += gridDim.x, b ^= 1) {
    // the next tile's loads fly while this tile's chains run
    if (t + (int)gridDim.x < ntiles) load(t + gridDim.x, b ^ 1);
    copy_commit();
    copy_wait_prior();
    __syncthreads();            // tile t in; the last tile's outputs out
    const size_t r0 = (size_t)t * TILE;
    const int nr = min(TILE, n - (int)r0);
    if (tid < nr) {
      const float* x = sIn + b * IN + tid * P_IN;
      const float* d = sIn + b * IN + TILE * P_IN + tid * P_DAT;
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
    __syncthreads();            // tile t's outputs in; buffer b read
    store_rows<R, RS>(r + r0 * R, sR, nr * R, tid, TILE);
    store_rows<RN, JS>(J + r0 * RN, sJ, nr * RN, tid, TILE);
  }
}

}  // namespace linearize_auto

// Launches row_kernel<C, TILE> on `stream`: a persistent grid of as many
// blocks as fit the card at once (found on the first call), each taking
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
template <class C, int TILE>
int linearize_auto_launch(const float* xin, const float* dat, int n,
                          float* r, float* J, cudaStream_t stream) {
  if (n <= 0) return 0;
  using T = linearize_auto::RowTile<C, TILE>;
  constexpr size_t smem = 4 * (size_t)T::FLOATS;
  static_assert(smem <= 232448, "a row tile passes a block's shared memory");
  static int resident = 0;      // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(linearize_auto::row_kernel<C, TILE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, linearize_auto::row_kernel<C, TILE>, TILE, smem);
    if (sms * per_sm <= 0) {
      const int err = (int)cudaGetLastError();
      return err ? err : (int)cudaErrorInvalidConfiguration;
    }
    resident = sms * per_sm;
  }
  const int tiles = (n + TILE - 1) / TILE;
  linearize_auto::row_kernel<C, TILE>
      <<<tiles < resident ? tiles : resident, TILE, smem, stream>>>(
          xin, dat, n, r, J);
  return (int)cudaGetLastError();
}
