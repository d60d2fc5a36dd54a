// K10: the matrix-free Schur operator of the implicit ITERATIVE_SCHUR
// step, per point n and lane j of its chunk:
//   w_j  = Jf_j v[fid_j]                      (r values)
//   u    = sum_j Je_j^T w_j                   (te values)
//   zz   = inv_n u
//   C_j  = Jf_j^T (w_j - Je_j zz)             (tf values)
// The camera-chunk reduce of C into [kf, tf] and the + D_f^2 v term stay
// outside (solvers/schur_fused.py), as the JAX package reduces outside its
// kernel.
//
// Replaces ceres_tpu/ops/pallas_implicit.py::_apply_kernel. The TPU kernel
// took transposed [t, k, ne_pad] planes and a v expanded to rows by 2 tf
// one-dimensional gathers outside it; on the TPU those gathers made it 9x
// slower than the XLA chain it replaced. Here the kernel takes the port's
// layouts as they are and gathers v itself:
//   Je   [ne, k, r, te] f32  e-scaled point Jacobian chunks (masked lanes 0)
//   Jf   [ne, k, r, tf] f32  f-scaled camera Jacobian chunks
//   inv  [ne, te, te]   f32  (E_s^T E_s + D_e^2)^-1
//   fids [ne, k]        i32  camera (f block) of each lane, < kf
//   v    [kf * tf]      f32
//   C    [ne, k, tf]    f32  output
//
// Bound on the H100: bytes. Each application reads Je, Jf, inv and fids
// once and writes C once (~143 MB at 1,024 cameras / 1M observations,
// ~0.043 ms at 3.35 TB/s) for ~4 r (te + tf) flops a lane.
//
// Design (k <= 32, implicit_apply_warp): one thread per (point, lane),
// lanes fastest, floor(32 / k) whole points per warp. A warp's points are
// contiguous in Je, Jf and C, so the warp copies its tile's Je and Jf
// spans into its own slice of shared memory with coalesced 16-byte loads
// (4-byte loads where a span is not 16-byte aligned), each byte read from
// device memory once; each thread then reads its lane's rows from there,
// twice (w, then C), and writes C_j into a shared tile that the warp
// stores coalesced. u sums the point's lanes by shuffles in j order; every
// lane of the point forms the same sum and the same zz. A persistent grid
// (as many blocks as fit on the card) stages v (kf * tf floats, 36 KB at
// 1,024 cameras) in shared memory once per block when it fits in 48 KB
// and reads it from device memory otherwise, so the gather of v by camera
// costs no device-memory traffic. Wider chunks (k > 32,
// implicit_apply_wide): a block per point, lanes over threads, u summed
// through shared memory by one thread in j order, the second pass reading
// its rows again from device memory (L1/L2).
//
// Loops run to compile-time maxima (te <= 4, tf <= 16, r <= 4). No
// atomics: every sum has one order, so every application repeats its
// bits. Every product and sum rounds on its own (__fmul_rn, __fadd_rn: no
// fused multiply-add), in the order of ops/implicit.py
// implicit_apply_plain, so the kernel and its plain version agree bit for
// bit: w2 = w - Je zz cancels most of w, and amplifies any difference of
// rounding between them, such as a fused multiply-add's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float msub(float acc, float a, float b) {
  return __fsub_rn(acc, __fmul_rn(a, b));
}

constexpr int MAXTE = 4;
constexpr int MAXTF = 16;
constexpr int MAXR = 4;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_BYTES = 48 * 1024;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// w_q = sum_t jf[q, t] v[t], t in order
__device__ __forceinline__ void lane_w(const float* jf, const float* vrow,
                                       int r, int tf, float* w) {
#pragma unroll
  for (int q = 0; q < MAXR; ++q) {
    float acc = 0.f;
    if (q < r) {
      acc = __fmul_rn(jf[q * tf], vrow[0]);
#pragma unroll
      for (int t = 1; t < MAXTF; ++t)
        if (t < tf) acc = madd(acc, jf[q * tf + t], vrow[t]);
    }
    w[q] = acc;
  }
}

// term_a = sum_q je[q, a] w_q, q in order
__device__ __forceinline__ void lane_term(const float* je, const float* w,
                                          int r, int te, float* term) {
#pragma unroll
  for (int a = 0; a < MAXTE; ++a) {
    float acc = 0.f;
    if (a < te) {
      acc = __fmul_rn(je[a], w[0]);
#pragma unroll
      for (int q = 1; q < MAXR; ++q)
        if (q < r) acc = madd(acc, je[q * te + a], w[q]);
    }
    term[a] = acc;
  }
}

// zz_a = sum_b inv[a, b] u_b, b in order
__device__ __forceinline__ void point_zz(const float* in, const float* u,
                                         int te, float* zz) {
#pragma unroll
  for (int a = 0; a < MAXTE; ++a) {
    float acc = 0.f;
    if (a < te) {
      acc = __fmul_rn(in[a * te], u[0]);
#pragma unroll
      for (int b = 1; b < MAXTE; ++b)
        if (b < te) acc = madd(acc, in[a * te + b], u[b]);
    }
    zz[a] = acc;
  }
}

// c_t = sum_q jf[q, t] (w_q - sum_a je[q, a] zz_a), every sum in order
__device__ __forceinline__ void lane_c(const float* je, const float* jf,
                                       const float* w, const float* zz,
                                       int r, int te, int tf, float* c) {
  float w2[MAXR];
#pragma unroll
  for (int q = 0; q < MAXR; ++q) {
    float acc = w[q];
#pragma unroll
    for (int a = 0; a < MAXTE; ++a)
      if (q < r && a < te) acc = msub(acc, je[q * te + a], zz[a]);
    w2[q] = acc;
  }
  for (int t = 0; t < tf; ++t) {
    float acc = __fmul_rn(jf[t], w2[0]);
#pragma unroll
    for (int q = 1; q < MAXR; ++q)
      if (q < r) acc = madd(acc, jf[q * tf + t], w2[q]);
    c[t] = acc;
  }
}

// dst[0:cnt] = src[0:cnt] by the 32 lanes of a warp, coalesced
__device__ __forceinline__ void warp_copy_in(float* dst,
                                             const float* __restrict__ src,
                                             int cnt, int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = cnt >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) d4[i] = __ldcs(s4 + i);
    done = n4 << 2;
  }
#pragma unroll 4
  for (int i = done + lane; i < cnt; i += 32) dst[i] = __ldcs(src + i);
}

__device__ __forceinline__ void warp_copy_out(float* __restrict__ dst,
                                              const float* src, int cnt,
                                              int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = cnt >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = lane; i < n4; i += 32) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + lane; i < cnt; i += 32) dst[i] = src[i];
}

// shared memory: [v staged (round4(nv) floats, STAGE only)] then per warp
// [Je tile | Jf tile | C tile], each rounded to 4 floats
__host__ __device__ __forceinline__ int warp_slice_floats(int lanes, int r,
                                                          int te, int tf) {
  return round4(lanes * r * te) + round4(lanes * r * tf) +
         round4(lanes * tf);
}

template <bool STAGE>
__global__ void __launch_bounds__(THREADS)
    implicit_apply_warp(const float* __restrict__ Je,
                        const float* __restrict__ Jf,
                        const float* __restrict__ inv,
                        const int* __restrict__ fids,
                        const float* __restrict__ v, int ne, int k, int r,
                        int te, int tf, int nv, int ppw,
                        float* __restrict__ C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lanes = ppw * k;            // lanes of a full tile, <= 32
  const int rte = r * te, rtf = r * tf;
  float* sje = smem + (STAGE ? round4(nv) : 0) +
               wid * warp_slice_floats(lanes, r, te, tf);
  float* sjf = sje + round4(lanes * rte);
  float* sc = sjf + round4(lanes * rtf);
  const float* vv = v;
  if (STAGE) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) smem[i] = v[i];
    __syncthreads();
    vv = smem;
  }
  const int pt = lane / k;              // the lane's point in the tile
  const int base = pt * k;              // the point's first lane
  const int ntiles = (ne + ppw - 1) / ppw;
  for (int tile = blockIdx.x * WARPS + wid; tile < ntiles;
       tile += gridDim.x * WARPS) {
    const int p0 = tile * ppw;
    const int nl = min(ppw, ne - p0) * k;     // live lanes in this tile
    const size_t l0 = (size_t)p0 * k;         // the tile's first lane
    warp_copy_in(sje, Je + l0 * rte, nl * rte, lane);
    warp_copy_in(sjf, Jf + l0 * rtf, nl * rtf, lane);
    __syncwarp();
    const bool live = lane < nl;
    const float* je = sje + lane * rte;
    const float* jf = sjf + lane * rtf;
    float w[MAXR], term[MAXTE];
    if (live) {
      lane_w(jf, vv + (size_t)fids[l0 + lane] * tf, r, tf, w);
      lane_term(je, w, r, te, term);
    } else {
#pragma unroll
      for (int a = 0; a < MAXTE; ++a) term[a] = 0.f;
    }
    // u = term_0 + term_1 + ... over the point's lanes, in j order
    float u[MAXTE];
#pragma unroll
    for (int a = 0; a < MAXTE; ++a)
      u[a] = a < te ? __shfl_sync(0xffffffffu, term[a], base) : 0.f;
    for (int j = 1; j < k; ++j) {
#pragma unroll
      for (int a = 0; a < MAXTE; ++a)
        if (a < te)
          u[a] = __fadd_rn(u[a], __shfl_sync(0xffffffffu, term[a], base + j));
    }
    if (live) {
      float zz[MAXTE];
      point_zz(inv + (size_t)(p0 + pt) * te * te, u, te, zz);
      lane_c(je, jf, w, zz, r, te, tf, sc + lane * tf);
    }
    __syncwarp();
    warp_copy_out(C + l0 * tf, sc, nl * tf, lane);
    __syncwarp();           // the tile's slices are free for the next one
  }
}

template <bool STAGE>
__global__ void __launch_bounds__(THREADS)
    implicit_apply_wide(const float* __restrict__ Je,
                        const float* __restrict__ Jf,
                        const float* __restrict__ inv,
                        const int* __restrict__ fids,
                        const float* __restrict__ v, int ne, int k, int r,
                        int te, int tf, int nv, float* __restrict__ C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_zz[MAXTE];
  float* s_term = smem + (STAGE ? round4(nv) : 0);   // [THREADS, te]
  const float* vv = v;
  if (STAGE) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) smem[i] = v[i];
    __syncthreads();
    vv = smem;
  }
  const int rte = r * te, rtf = r * tf;
  for (int n = blockIdx.x; n < ne; n += gridDim.x) {
    const size_t l0 = (size_t)n * k;
    float u[MAXTE];                     // thread 0's running sum
    for (int c0 = 0; c0 < k; c0 += blockDim.x) {
      const int j = c0 + threadIdx.x;
      if (j < k) {
        float w[MAXR], term[MAXTE];
        lane_w(Jf + (l0 + j) * rtf, vv + (size_t)fids[l0 + j] * tf, r, tf,
               w);
        lane_term(Je + (l0 + j) * rte, w, r, te, term);
        for (int a = 0; a < te; ++a) s_term[threadIdx.x * te + a] = term[a];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const int cnt = min((int)blockDim.x, k - c0);
        for (int i = 0; i < cnt; ++i) {
#pragma unroll
          for (int a = 0; a < MAXTE; ++a)
            if (a < te)
              u[a] = (c0 == 0 && i == 0)
                         ? s_term[a]
                         : __fadd_rn(u[a], s_term[i * te + a]);
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      float zz[MAXTE];
      point_zz(inv + (size_t)n * te * te, u, te, zz);
      for (int a = 0; a < te; ++a) s_zz[a] = zz[a];
    }
    __syncthreads();
    float zz[MAXTE];
#pragma unroll
    for (int a = 0; a < MAXTE; ++a) zz[a] = a < te ? s_zz[a] : 0.f;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const float* je = Je + (l0 + j) * rte;
      const float* jf = Jf + (l0 + j) * rtf;
      float w[MAXR];
      lane_w(jf, vv + (size_t)fids[l0 + j] * tf, r, tf, w);
      lane_c(je, jf, w, zz, r, te, tf, C + (l0 + j) * tf);
    }
    __syncthreads();        // s_term and s_zz are free for the next point
  }
}

// as many blocks as fit on the card at once, at most `want`
template <typename Kernel>
int persistent_grid(Kernel kernel, size_t bytes, int want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (bytes > STAGE_BYTES)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                bytes);
  const int most = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return want < most ? want : most;
}

template <bool STAGE>
int launch(const float* Je, const float* Jf, const float* inv,
           const int* fids, const float* v, int ne, int k, int r, int te,
           int tf, int nv, float* C, cudaStream_t stream) {
  const size_t v_bytes = STAGE ? (size_t)round4(nv) * sizeof(float) : 0;
  if (k <= 32) {
    const int ppw = 32 / k;
    const size_t bytes =
        v_bytes + (size_t)WARPS * warp_slice_floats(ppw * k, r, te, tf) *
                      sizeof(float);
    const int ntiles = (ne + ppw - 1) / ppw;
    const int grid = persistent_grid(implicit_apply_warp<STAGE>, bytes,
                                     (ntiles + WARPS - 1) / WARPS);
    implicit_apply_warp<STAGE><<<grid, THREADS, bytes, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, ppw, C);
  } else {
    const size_t bytes = v_bytes + (size_t)THREADS * te * sizeof(float);
    const int grid = persistent_grid(implicit_apply_wide<STAGE>, bytes, ne);
    implicit_apply_wide<STAGE><<<grid, THREADS, bytes, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ceres_implicit_apply(const float* Je, const float* Jf,
                                    const float* inv, const int* fids,
                                    const float* v, int ne, int k, int r,
                                    int te, int tf, int kf, float* C,
                                    cudaStream_t stream) {
  if (ne <= 0 || k <= 0) return 0;
  if (r < 1 || r > MAXR || te < 1 || te > MAXTE || tf < 1 || tf > MAXTF ||
      kf < 1)
    return (int)cudaErrorInvalidValue;
  const int nv = kf * tf;
  if ((size_t)round4(nv) * sizeof(float) <= STAGE_BYTES)
    return launch<true>(Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C,
                        stream);
  return launch<false>(Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C,
                       stream);
}
