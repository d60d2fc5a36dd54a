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
// Shapes. The JAX implicit step takes any (r, te, tf), and so does this
// kernel, in three tiers picked by shape at launch (ops/implicit.py
// TIERS, the smallest tier that holds the shape):
//   tier 0: r <= 4, te <= 4, tf <= 16  (angle-axis and quaternion BA)
//   tier 1: r <= 4, te <= 4, tf <= 32  (COLMAP's FULL_OPENCV camera, 18)
//   tier 2: any shape (implicit_apply_any)
// Tiers 0 and 1 are one template on their compile-time maxima: each lane's
// w, u, zz and w2 are register arrays of those sizes, loops unrolled to
// them. Tier 2 walks r, te and tf at run time and keeps each lane's w
// (then w2) and terms, and each point's u and zz, in shared memory (in
// device memory where they pass `scratch_smem` bytes, by default the
// card's opt-in; the wrapper then allocates it: `ceres_implicit_plan`).
//
// Design, tiers 0 and 1 (k <= 32, implicit_apply_warp): one thread per
// (point, lane), lanes fastest, floor(32 / k) whole points per warp. A
// warp's points are contiguous in Je, Jf and C, so the warp copies its
// tile's Je and Jf spans into its own slice of shared memory with
// coalesced 16-byte loads (4-byte loads where a span is not 16-byte
// aligned), each byte read from device memory once; each thread then
// reads its lane's rows from there, twice (w, then C), and writes C_j
// into a shared tile that the warp stores coalesced. u sums the point's
// lanes by shuffles in j order; every lane of the point forms the same sum
// and the same zz. A block holds up to 16 warps, fewer where their slices
// pass the card's opt-in shared memory (227 KB on the H100). A persistent
// grid (as many blocks as fit on the card) stages v (kf * tf floats: 36 KB
// at 1,024 cameras and tf 9, 73.7 KB at tf 18) in shared memory once per
// block when v and the warps' slices fit in the opt-in together (taken
// with cudaFuncSetAttribute, as K7 does), and reads v from device memory
// otherwise; the plan says which (`ceres_implicit_plan`). Wider chunks
// (k > 32, implicit_apply_wide): a block per point, lanes over threads, u
// summed through shared memory by one thread in j order, the second pass
// reading its rows again from device memory (L1/L2).
// Tier 2 (implicit_apply_any): a block per point (persistent), lanes over
// threads in passes of blockDim.x, each lane's rows read from device
// memory; per pass each lane leaves its terms in shared memory and te
// threads add them to u in j order; the second pass reuses the lanes' w
// when the point's lanes take one pass and recomputes them otherwise.
//
// No atomics: every sum has one order, so every application repeats its
// bits. Every product and sum rounds on its own (__fmul_rn, __fadd_rn: no
// fused multiply-add), in the order of ops/implicit.py
// implicit_apply_plain, so every tier and its plain version agree bit for
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

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ANY_THREADS = 256;        // tier 2's most threads a block
constexpr int NTIERS = 3;

// the compile-time maxima of tiers 0 and 1 (ops/implicit.py TIERS)
template <int R_, int TE_, int TF_>
struct Tier {
  static constexpr int R = R_, TE = TE_, TF = TF_;
};
using Tier0 = Tier<4, 4, 16>;
using Tier1 = Tier<4, 4, 32>;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__host__ __forceinline__ bool tier_holds(int tier, int r, int te, int tf) {
  switch (tier) {
    case 0: return r <= Tier0::R && te <= Tier0::TE && tf <= Tier0::TF;
    case 1: return r <= Tier1::R && te <= Tier1::TE && tf <= Tier1::TF;
    default: return tier == 2;
  }
}

// w_q = sum_t jf[q, t] v[t], t in order
template <class T>
__device__ __forceinline__ void lane_w(const float* jf, const float* vrow,
                                       int r, int tf, float* w) {
#pragma unroll
  for (int q = 0; q < T::R; ++q) {
    float acc = 0.f;
    if (q < r) {
      acc = __fmul_rn(jf[q * tf], vrow[0]);
#pragma unroll
      for (int t = 1; t < T::TF; ++t)
        if (t < tf) acc = madd(acc, jf[q * tf + t], vrow[t]);
    }
    w[q] = acc;
  }
}

// term_a = sum_q je[q, a] w_q, q in order
template <class T>
__device__ __forceinline__ void lane_term(const float* je, const float* w,
                                          int r, int te, float* term) {
#pragma unroll
  for (int a = 0; a < T::TE; ++a) {
    float acc = 0.f;
    if (a < te) {
      acc = __fmul_rn(je[a], w[0]);
#pragma unroll
      for (int q = 1; q < T::R; ++q)
        if (q < r) acc = madd(acc, je[q * te + a], w[q]);
    }
    term[a] = acc;
  }
}

// zz_a = sum_b inv[a, b] u_b, b in order
template <class T>
__device__ __forceinline__ void point_zz(const float* in, const float* u,
                                         int te, float* zz) {
#pragma unroll
  for (int a = 0; a < T::TE; ++a) {
    float acc = 0.f;
    if (a < te) {
      acc = __fmul_rn(in[a * te], u[0]);
#pragma unroll
      for (int b = 1; b < T::TE; ++b)
        if (b < te) acc = madd(acc, in[a * te + b], u[b]);
    }
    zz[a] = acc;
  }
}

// c_t = sum_q jf[q, t] (w_q - sum_a je[q, a] zz_a), every sum in order
template <class T>
__device__ __forceinline__ void lane_c(const float* je, const float* jf,
                                       const float* w, const float* zz,
                                       int r, int te, int tf, float* c) {
  float w2[T::R];
#pragma unroll
  for (int q = 0; q < T::R; ++q) {
    float acc = w[q];
#pragma unroll
    for (int a = 0; a < T::TE; ++a)
      if (q < r && a < te) acc = msub(acc, je[q * te + a], zz[a]);
    w2[q] = acc;
  }
  for (int t = 0; t < tf; ++t) {
    float acc = __fmul_rn(jf[t], w2[0]);
#pragma unroll
    for (int q = 1; q < T::R; ++q)
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

template <class T, bool STAGE>
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
  const int warps = blockDim.x >> 5;
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
  for (int tile = blockIdx.x * warps + wid; tile < ntiles;
       tile += gridDim.x * warps) {
    const int p0 = tile * ppw;
    const int nl = min(ppw, ne - p0) * k;     // live lanes in this tile
    const size_t l0 = (size_t)p0 * k;         // the tile's first lane
    warp_copy_in(sje, Je + l0 * rte, nl * rte, lane);
    warp_copy_in(sjf, Jf + l0 * rtf, nl * rtf, lane);
    __syncwarp();
    const bool live = lane < nl;
    const float* je = sje + lane * rte;
    const float* jf = sjf + lane * rtf;
    float w[T::R], term[T::TE];
    if (live) {
      lane_w<T>(jf, vv + (size_t)fids[l0 + lane] * tf, r, tf, w);
      lane_term<T>(je, w, r, te, term);
    } else {
#pragma unroll
      for (int a = 0; a < T::TE; ++a) term[a] = 0.f;
    }
    // u = term_0 + term_1 + ... over the point's lanes, in j order
    float u[T::TE];
#pragma unroll
    for (int a = 0; a < T::TE; ++a)
      u[a] = a < te ? __shfl_sync(0xffffffffu, term[a], base) : 0.f;
    for (int j = 1; j < k; ++j) {
#pragma unroll
      for (int a = 0; a < T::TE; ++a)
        if (a < te)
          u[a] = __fadd_rn(u[a], __shfl_sync(0xffffffffu, term[a], base + j));
    }
    if (live) {
      float zz[T::TE];
      point_zz<T>(inv + (size_t)(p0 + pt) * te * te, u, te, zz);
      lane_c<T>(je, jf, w, zz, r, te, tf, sc + lane * tf);
    }
    __syncwarp();
    warp_copy_out(C + l0 * tf, sc, nl * tf, lane);
    __syncwarp();           // the tile's slices are free for the next one
  }
}

template <class T, bool STAGE>
__global__ void __launch_bounds__(THREADS)
    implicit_apply_wide(const float* __restrict__ Je,
                        const float* __restrict__ Jf,
                        const float* __restrict__ inv,
                        const int* __restrict__ fids,
                        const float* __restrict__ v, int ne, int k, int r,
                        int te, int tf, int nv, float* __restrict__ C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_zz[T::TE];
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
    float u[T::TE];                     // thread 0's running sum
    for (int c0 = 0; c0 < k; c0 += blockDim.x) {
      const int j = c0 + threadIdx.x;
      if (j < k) {
        float w[T::R], term[T::TE];
        lane_w<T>(Jf + (l0 + j) * rtf, vv + (size_t)fids[l0 + j] * tf, r,
                  tf, w);
        lane_term<T>(Je + (l0 + j) * rte, w, r, te, term);
        for (int a = 0; a < te; ++a) s_term[threadIdx.x * te + a] = term[a];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        const int cnt = min((int)blockDim.x, k - c0);
        for (int i = 0; i < cnt; ++i) {
#pragma unroll
          for (int a = 0; a < T::TE; ++a)
            if (a < te)
              u[a] = (c0 == 0 && i == 0)
                         ? s_term[a]
                         : __fadd_rn(u[a], s_term[i * te + a]);
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      float zz[T::TE];
      point_zz<T>(inv + (size_t)n * te * te, u, te, zz);
      for (int a = 0; a < te; ++a) s_zz[a] = zz[a];
    }
    __syncthreads();
    float zz[T::TE];
#pragma unroll
    for (int a = 0; a < T::TE; ++a) zz[a] = a < te ? s_zz[a] : 0.f;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const float* je = Je + (l0 + j) * rte;
      const float* jf = Jf + (l0 + j) * rtf;
      float w[T::R];
      lane_w<T>(jf, vv + (size_t)fids[l0 + j] * tf, r, tf, w);
      lane_c<T>(je, jf, w, zz, r, te, tf, C + (l0 + j) * tf);
    }
    __syncthreads();        // s_term and s_zz are free for the next point
  }
}

// tier 2's scratch a block, floats: u [te] | zz [te] | terms [threads, te]
// | w [threads, r], each rounded to 4 floats
__host__ __device__ __forceinline__ int any_scratch_floats(int threads,
                                                           int r, int te) {
  return 2 * round4(te) + round4(threads * te) + round4(threads * r);
}

template <bool STAGE>
__global__ void __launch_bounds__(ANY_THREADS)
    implicit_apply_any(const float* __restrict__ Je,
                       const float* __restrict__ Jf,
                       const float* __restrict__ inv,
                       const int* __restrict__ fids,
                       const float* __restrict__ v, int ne, int k, int r,
                       int te, int tf, int nv, float* __restrict__ scratch,
                       float* __restrict__ C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nt = blockDim.x, tid = threadIdx.x;
  const float* vv = v;
  if (STAGE) {
    for (int i = tid; i < nv; i += nt) smem[i] = v[i];
    __syncthreads();
    vv = smem;
  }
  float* s_u = scratch != nullptr
                   ? scratch + (size_t)blockIdx.x *
                                   any_scratch_floats(nt, r, te)
                   : smem + (STAGE ? round4(nv) : 0);
  float* s_zz = s_u + round4(te);
  float* s_term = s_zz + round4(te);
  float* w = s_term + round4(nt * te) + tid * r;   // this lane's w, then w2
  float* term = s_term + tid * te;
  const int rte = r * te, rtf = r * tf;
  for (int n = blockIdx.x; n < ne; n += gridDim.x) {
    const size_t l0 = (size_t)n * k;
    for (int c0 = 0; c0 < k; c0 += nt) {
      const int j = c0 + tid;
      if (j < k) {
        const float* je = Je + (l0 + j) * rte;
        const float* jf = Jf + (l0 + j) * rtf;
        const float* vrow = vv + (size_t)fids[l0 + j] * tf;
        for (int q = 0; q < r; ++q) {
          float acc = __fmul_rn(jf[q * tf], vrow[0]);
          for (int t = 1; t < tf; ++t)
            acc = madd(acc, jf[q * tf + t], vrow[t]);
          w[q] = acc;
        }
        for (int a = 0; a < te; ++a) {
          float acc = __fmul_rn(je[a], w[0]);
          for (int q = 1; q < r; ++q) acc = madd(acc, je[q * te + a], w[q]);
          term[a] = acc;
        }
      }
      __syncthreads();
      const int cnt = min(nt, k - c0);
      for (int a = tid; a < te; a += nt) {
        float acc = c0 == 0 ? s_term[a] : __fadd_rn(s_u[a], s_term[a]);
        for (int i = 1; i < cnt; ++i) acc = __fadd_rn(acc, s_term[i * te + a]);
        s_u[a] = acc;
      }
      __syncthreads();
    }
    const float* in = inv + (size_t)n * te * te;
    for (int a = tid; a < te; a += nt) {
      float acc = __fmul_rn(in[a * te], s_u[0]);
      for (int b = 1; b < te; ++b) acc = madd(acc, in[a * te + b], s_u[b]);
      s_zz[a] = acc;
    }
    __syncthreads();
    for (int c0 = 0; c0 < k; c0 += nt) {
      const int j = c0 + tid;
      if (j >= k) continue;
      const float* je = Je + (l0 + j) * rte;
      const float* jf = Jf + (l0 + j) * rtf;
      if (k > nt) {                     // w was overwritten: form it again
        const float* vrow = vv + (size_t)fids[l0 + j] * tf;
        for (int q = 0; q < r; ++q) {
          float acc = __fmul_rn(jf[q * tf], vrow[0]);
          for (int t = 1; t < tf; ++t)
            acc = madd(acc, jf[q * tf + t], vrow[t]);
          w[q] = acc;
        }
      }
      for (int q = 0; q < r; ++q) {
        float acc = w[q];
        for (int a = 0; a < te; ++a) acc = msub(acc, je[q * te + a], s_zz[a]);
        w[q] = acc;
      }
      float* c = C + (l0 + j) * tf;
      for (int t = 0; t < tf; ++t) {
        float acc = __fmul_rn(jf[t], w[0]);
        for (int q = 1; q < r; ++q) acc = madd(acc, jf[q * tf + t], w[q]);
        c[t] = acc;
      }
    }
    __syncthreads();        // u, zz and the terms are free for the next point
  }
}

int optin_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin > 0 ? optin : 48 * 1024;
}

// as many blocks of `threads` as fit on the card at once, at most `want`
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t bytes, int want) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                bytes);
  const int most = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return want < most ? want : most;
}

// A launch's plan: the tier, its threads a block, whether v is staged in
// shared memory, the dynamic shared memory, and for tier 2 its scratch in
// device memory (floats a block, 0 when it fits in `scratch_smem` bytes of
// shared memory; scratch_smem < 0: the opt-in)
struct Plan {
  int tier, threads, stage, smem, scratch_floats;
};

Plan make_plan(int k, int r, int te, int tf, int nv, int tier,
               int scratch_smem) {
  // the opt-in less a margin for the kernels' static shared memory
  const int optin = optin_bytes() - 1024;
  const int v_bytes = round4(nv) * 4;
  Plan p{tier, THREADS, 0, 0, 0};
  if (tier < 2 && k <= 32) {
    const int slice = warp_slice_floats((32 / k) * k, r, te, tf) * 4;
    int warps = optin / slice;
    warps = warps < 1 ? 1 : (warps > WARPS ? WARPS : warps);
    p.threads = 32 * warps;
    p.stage = v_bytes + warps * slice <= optin;
    p.smem = (p.stage ? v_bytes : 0) + warps * slice;
  } else if (tier < 2) {
    const int terms = THREADS * te * 4;
    p.stage = v_bytes + terms <= optin;
    p.smem = (p.stage ? v_bytes : 0) + terms;
  } else {
    int threads = (k + 31) & ~31;
    threads = threads > ANY_THREADS ? ANY_THREADS : threads;
    while (threads > 32 && any_scratch_floats(threads, r, te) * 4 > optin)
      threads -= 32;
    const int scratch = any_scratch_floats(threads, r, te) * 4;
    const int cap =
        scratch_smem < 0 || scratch_smem > optin ? optin : scratch_smem;
    p.threads = threads;
    if (scratch <= cap) {
      p.stage = v_bytes + scratch <= optin;
      p.smem = (p.stage ? v_bytes : 0) + scratch;
    } else {                            // u, zz, terms, w in device memory
      p.scratch_floats = scratch / 4;
      p.stage = v_bytes <= optin;
      p.smem = p.stage ? v_bytes : 0;
    }
  }
  return p;
}

// tier 2 with its scratch in device memory: at most this many blocks
constexpr int ANY_SCRATCH_BLOCKS = 1024;

template <class T, bool STAGE>
int launch_tier(const Plan& p, const float* Je, const float* Jf,
                const float* inv, const int* fids, const float* v, int ne,
                int k, int r, int te, int tf, int nv, float* C,
                cudaStream_t stream) {
  if (k <= 32) {
    const int ppw = 32 / k;
    const int warps = p.threads / 32;
    const int ntiles = (ne + ppw - 1) / ppw;
    const int grid = persistent_grid(implicit_apply_warp<T, STAGE>,
                                     p.threads, p.smem,
                                     (ntiles + warps - 1) / warps);
    implicit_apply_warp<T, STAGE><<<grid, p.threads, p.smem, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, ppw, C);
  } else {
    const int grid = persistent_grid(implicit_apply_wide<T, STAGE>,
                                     THREADS, p.smem, ne);
    implicit_apply_wide<T, STAGE><<<grid, THREADS, p.smem, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C);
  }
  return (int)cudaGetLastError();
}

template <bool STAGE>
int launch_any(const Plan& p, const float* Je, const float* Jf,
               const float* inv, const int* fids, const float* v, int ne,
               int k, int r, int te, int tf, int nv, float* scratch,
               float* C, cudaStream_t stream) {
  const int grid =
      p.scratch_floats > 0
          ? (ne < ANY_SCRATCH_BLOCKS ? ne : ANY_SCRATCH_BLOCKS)
          : persistent_grid(implicit_apply_any<STAGE>, p.threads, p.smem,
                            ne);
  if (p.scratch_floats > 0 && p.smem > 48 * 1024)
    cudaFuncSetAttribute(implicit_apply_any<STAGE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  implicit_apply_any<STAGE><<<grid, p.threads, p.smem, stream>>>(
      Je, Jf, inv, fids, v, ne, k, r, te, tf, nv,
      p.scratch_floats > 0 ? scratch : nullptr, C);
  return (int)cudaGetLastError();
}

template <class T>
int launch_staged(const Plan& p, const float* Je, const float* Jf,
                  const float* inv, const int* fids, const float* v, int ne,
                  int k, int r, int te, int tf, int nv, float* C,
                  cudaStream_t stream) {
  return p.stage ? launch_tier<T, true>(p, Je, Jf, inv, fids, v, ne, k, r,
                                        te, tf, nv, C, stream)
                 : launch_tier<T, false>(p, Je, Jf, inv, fids, v, ne, k, r,
                                         te, tf, nv, C, stream);
}

bool args_ok(int ne, int k, int r, int te, int tf, int kf, int tier) {
  return ne >= 0 && k >= 1 && r >= 1 && te >= 1 && tf >= 1 && kf >= 1 &&
         tier >= 0 && tier < NTIERS && tier_holds(tier, r, te, tf);
}

}  // namespace

// The plan of a launch at this shape and tier (ops/implicit.py
// implicit_plan): out[0..5] = tier, threads a block, v staged in shared
// memory (1) or read from device memory (0), dynamic shared memory
// (bytes), tier 2's device-memory scratch (floats, for as many blocks as
// out[5]; 0 when it fits in `scratch_smem` bytes of shared memory, < 0:
// the card's opt-in), that block count.
extern "C" int ceres_implicit_plan(int ne, int k, int r, int te, int tf,
                                   int kf, int tier, int scratch_smem,
                                   int* out) {
  if (!args_ok(ne, k, r, te, tf, kf, tier)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(k, r, te, tf, kf * tf, tier, scratch_smem);
  out[0] = p.tier;
  out[1] = p.threads;
  out[2] = p.stage;
  out[3] = p.smem;
  out[4] = p.scratch_floats;
  out[5] = p.scratch_floats > 0 ? (ne < ANY_SCRATCH_BLOCKS ? ne
                                                          : ANY_SCRATCH_BLOCKS)
                                : 0;
  return 0;
}

// C = K10(Je, Jf, inv, fids, v) with tier `tier` (which must hold (r, te,
// tf)); `scratch` is tier 2's device-memory scratch when its plan at
// `scratch_smem` asks for one (out[4] * out[5] floats), else unused.
extern "C" int ceres_implicit_apply(const float* Je, const float* Jf,
                                    const float* inv, const int* fids,
                                    const float* v, int ne, int k, int r,
                                    int te, int tf, int kf, int tier,
                                    int scratch_smem, float* scratch,
                                    float* C, cudaStream_t stream) {
  if (!args_ok(ne, k, r, te, tf, kf, tier)) return (int)cudaErrorInvalidValue;
  if (ne == 0) return 0;
  const int nv = kf * tf;
  const Plan p = make_plan(k, r, te, tf, nv, tier, scratch_smem);
  if (p.scratch_floats > 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (tier) {
    case 0:
      return launch_staged<Tier0>(p, Je, Jf, inv, fids, v, ne, k, r, te, tf,
                                  nv, C, stream);
    case 1:
      return launch_staged<Tier1>(p, Je, Jf, inv, fids, v, ne, k, r, te, tf,
                                  nv, C, stream);
    default:                            // tier 2
      return p.stage ? launch_any<true>(p, Je, Jf, inv, fids, v, ne, k, r, te,
                                        tf, nv, scratch, C, stream)
                     : launch_any<false>(p, Je, Jf, inv, fids, v, ne, k, r,
                                         te, tf, nv, scratch, C, stream);
  }
}
