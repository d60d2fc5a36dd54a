// K7: the whole block-preconditioned CG solve of S y = b in one kernel.
//
// Replaces ceres_tpu/ops/pallas_pcg.py::_pcg_kernel (dense_pcg). From
// y0 = 0 it runs the recurrence of solvers/cg.py conjugate_gradients:
// the indefiniteness guard (pAp <= 0 or not finite: alpha = 0 and stop),
// the refresh r = b - S y every reset_period iterations, and the Q
// forcing test i (Q_i - Q_{i-1}) / Q_i < q_tol after max(min_it, 1)
// iterations, with the Q_i == 0 and rho == 0 guards. It writes y, the
// iteration count and the final ||r|| on the device.
//
// Bound on the H100: a latency chain, not bytes. At m = 144 the solve
// reads ~90 KB (0.027 us at 3.35 TB/s) and an iteration is a 144 x 144
// matvec (41k flops); what costs is the chain of dependent steps in one
// block: loads, shuffles, block barriers, the sums of the warp partials
// and the divisions, iteration after iteration. The first design took
// 4.7-4.9 us an iteration (H100 80GB HBM3 at 700 W): its matvec walked a
// warp's rows one after another from shared memory (2.8-3.0 us), and
// seven barriers with the 16-partial sums took 1.5; the copy of S into
// shared memory by 4-byte loads another 2.3-2.6 us a call
// (scripts/k7_variants.py).
//
// Design: one block of 512 threads owns the solve, so no state leaves
// the SM between iterations. Thread i owns element i (and i + 512) of x,
// r, p and b, in registers. Warp w owns the rows w, w + 16, ... of S and
// lane l its columns l, l + 32, ...; each lane keeps its columns of the
// vector multiplied (p, or x on a refresh) in registers too, +0 past m.
// For m up to REG_CAP, S itself lives in registers (9 rows of 5 columns
// a thread up to m = 144, 10 rows past it: at m = 144 the 9-row
// instantiation is ~2% faster) and so does each thread's row of the
// preconditioner blocks [kf, tf, tf] (tf up to TF_MAX), loaded straight
// from global memory before the start phase, which the loads overlap. A
// warp's rows then run as independent fma chains with no branch, and
// their shuffle trees are taken all at once (transpose_sum: RU shuffles
// for RU rows, not 5 RU). Past REG_CAP S sits in shared memory, brought
// in by one bulk asynchronous copy (cp.async.bulk on an mbarrier) while
// the start phase runs (by the threads' loop where S's 4 m^2 bytes are
// no multiple of 16), up to m = 238 on the H100 (227 KB opt-in), where it
// is ~3x faster than reading S from L2 (m = 200: 21.6 us against 65.9,
// scripts/time_kernels.py --only K7); past that S is read from global
// memory (L2) in every product, m up to 1024, and the preconditioner rows
// from global memory too.
//
// Three block barriers an iteration (the first design had seven): (1) Ap
// complete, (2) the pAp partials, (3) z and the rz and x.(r + b)
// partials. The r update needs none: r is double-buffered in shared
// memory, and each thread makes its block's tf entries of r - alpha Ap
// itself, by the same arithmetic as their owners. The p update needs
// none: each lane makes its columns of z + beta p from z. A refresh adds
// two (x complete, then r). Every sum keeps the order of the first design,
// so the kernel gives its bits: a row's product is the same fma sequence
// over j from +0 and the same __shfl_down_sync tree (a + b and b + a are
// the same bits); a dot is thread i's terms, a __shfl_down_sync tree
// over 32 consecutive i, and the warp partials summed in warp order from
// +0 by every thread (so each thread holds the same value and the loop's
// control flow is uniform). A warp that owns no element holds a +0
// partial, and +0 moves no bit of a sum that starts from +0 (such a sum
// is never -0), so the sums stop at warp CL, the last that can own one.
// No atomics: a run gives the same bits every time. f32 throughout (the
// TPU kernel runs its products at HIGHEST precision for the same reason:
// a less exact recurrence changes the LM trajectory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_M = 1024;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
// S in registers up to m = REG_CAP (10 rows of 5 columns a thread: 12
// rows of 6 spill registers), in shared memory up to SMEM_M (15 rows of 8
// columns) where it fits: the opt-in size ends it at m = 238 on the H100
constexpr int REG_CAP = 160;
constexpr int SMEM_M = 240;

// S in registers: warp w's rows w + 16 r (r < RW), lane l's columns
// l + 32 c (c < CL). The loads are clamped into S, so that all of them
// issue at once, unpredicated; the columns past m are then set to +0 (and
// the rows past m are never stored).
template <int RW, int CL>
struct RegS {
  static constexpr bool kRegs = true;
  float s[RW][CL];
  __device__ __forceinline__ void load(const float* __restrict__ S, int m,
                                       int warp, int lane) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        const int row = min(warp + WARPS * r, m - 1), j = lane + 32 * c;
        const float sv = S[row * m + min(j, m - 1)];
        s[r][c] = j < m ? sv : 0.f;
      }
  }
  __device__ __forceinline__ float at(int r, int c, int, int, int) const {
    return s[r][c];
  }
};

// S in shared or global memory, read in every product
struct MemS {
  static constexpr bool kRegs = false;
  const float* S;
  __device__ __forceinline__ float at(int, int, int row, int j,
                                      int m) const {
    return S[row * m + j];
  }
};

// The __shfl_down_sync tree sums of RU values over the warp, all at once:
// at each offset o (16, 8, ..., 1) the values pair up, each lane keeping
// one of a pair and sending the other to lane l ^ o, so that a level
// takes half the shuffles of the last. Every sum adds the same two
// partials as the tree (a + b and b + a are the same bits), so lane l
// ends with the tree's sum of value rev5(l) (the 5-bit reversal of l);
// lanes whose rev5(l) >= RU hold nothing. RU shuffles in all, not 5 RU.
template <int RU>
__device__ __forceinline__ float transpose_sum(float (&a)[RU], int lane) {
  int n = RU;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < (RU + 1) / 2; ++q) {
      if (2 * q < n) {
        const float x = a[2 * q];
        const float y = 2 * q + 1 < n ? a[2 * q + 1] : 0.f;
        const bool hi = (lane & o) != 0;
        const float got = __shfl_xor_sync(FULL, hi ? x : y, o);
        a[q] = (hi ? y : x) + got;
      }
    }
    n = (n + 1) / 2;
  }
  return a[0];
}

// out[row] = (S v)[row], or sub[row] - (S v)[row] when sub is given, for
// the RU rows warp + 16 (r0 + u) of this warp; v holds the lane's columns,
// +0 past m. From registers every row runs every column, with no branch,
// so that the rows' fma chains interleave: past m, S and v are +0, and
// adding +0 * +0 to a sum that starts from +0 moves no bit (such a sum is
// never -0: an fma onto +0, or one that cancels exactly, rounds to +0).
// From memory the row and column bounds are tested, as S is read there.
template <int RU, int CL, class Src>
__device__ __forceinline__ void rows(const Src& src, int r0,
                                     const float (&v)[CL], const float* sub,
                                     float* out, int m, int warp, int lane) {
  float acc[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int row = warp + WARPS * (r0 + u);
    acc[u] = 0.f;
    if (Src::kRegs || row < m) {
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        const int j = lane + 32 * c;
        if (Src::kRegs || j < m)
          acc[u] += src.at(r0 + u, c, row, j, m) * v[c];
      }
    }
  }
  const float sum = transpose_sum<RU>(acc, lane);
  const int u = __brev(lane) >> 27;
  const int row = warp + WARPS * (r0 + u);
  if (u < RU && row < m) out[row] = sub ? sub[row] - sum : sum;
}

// the product over all of this warp's rows: at once from registers, four
// rows at a time from memory
template <int RW, int CL, class Src>
__device__ __forceinline__ void matvec(const Src& src, const float (&v)[CL],
                                       const float* sub, float* out, int m,
                                       int warp, int lane) {
  if constexpr (Src::kRegs) {
    rows<RW, CL>(src, 0, v, sub, out, m, warp, lane);
  } else {
#pragma unroll 1
    for (int r0 = 0; warp + WARPS * r0 < m; r0 += 4)
      rows<4, CL>(src, r0, v, sub, out, m, warp, lane);
  }
}

// lane 0's __shfl_down_sync tree sum of a over the warp
__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(FULL, a, off);
  return a;
}

// the partials of the first NP warps, in warp order from +0
template <int NP>
__device__ __forceinline__ float partial_sum(const float* red) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NP; ++w) s += red[w];
  return s;
}

// z_i = sum_j M[i][j] r[blk * tf + j] with M [m / tf, tf, tf]: the row
// M[i] given by `row` (in registers, or in memory), the block's entries of
// r by rk(k); unrolled for tf up to TF_MAX (BA's camera blocks; more would
// spill registers of the register tiers), else a loop over M[i] in memory
constexpr int TF_MAX = 10;

template <int TF, class Row, class R>
__device__ __forceinline__ float precond_n(const Row& row, int base, R rk) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < TF; ++j) acc += row[j] * rk(base + j);
  return acc;
}

template <class Row, class R>
__device__ __forceinline__ float precond(const Row& row,
                                         const float* __restrict__ M, int i,
                                         int tf, R rk) {
  switch (tf) {
#define PCG_TF(n) \
  case n:         \
    return precond_n<n>(row, i - i % n, rk);
    PCG_TF(1) PCG_TF(2) PCG_TF(3) PCG_TF(4) PCG_TF(5) PCG_TF(6) PCG_TF(7)
    PCG_TF(8) PCG_TF(9) PCG_TF(10)
#undef PCG_TF
    default: {
      const int base = i - i % tf;
      const float* Mi = M + (size_t)i * tf;
      float acc = 0.f;
      for (int j = 0; j < tf; ++j) acc += Mi[j] * rk(base + j);
      return acc;
    }
  }
}

#ifndef CUDA_HOST_EMU  // the host test shim has its own stand-ins
// one thread: an mbarrier at bar, armed for `bytes`, and one bulk copy of
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from src into
// shared memory at dst that completes on it
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// wait for the bulk copy on bar (its phase 0)
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
}
#endif

// Shared memory: the mbarrier (16 bytes), the warp partials (3 WARPS), z,
// r twice, Ap and x (m each), then S on the shared-memory path, 16-byte
// aligned.
__host__ __device__ inline size_t s_offset(int m) {
  return ((4 + 3 * (size_t)WARPS + 5 * (size_t)m) + 3) / 4 * 4;
}

// RW rows a warp and CL columns a lane at most, EPT elements a thread
// at most; Src: RegS<RW, CL> or MemS (then `s_smem` says where S is and
// `bulk` whether one bulk copy brings it into shared memory)
template <int RW, int CL, int EPT, class Src>
__global__ void __launch_bounds__(THREADS)
    pcg_kernel(const float* __restrict__ S_g, const float* __restrict__ b,
               const float* __restrict__ minv, int m, int tf, int max_it,
               int min_it, float q_tol, int reset, int s_smem, int bulk,
               float* __restrict__ y, int* __restrict__ iters,
               float* __restrict__ norm) {
  extern __shared__ float4 smem4[];
  // -- the kernel's body --
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warps whose partials are summed: every warp that owns an element
  // (m <= 32 CL), and past them warps of +0 partials, which move no bit
  // of a sum that starts from +0
  constexpr int NP = CL < WARPS ? CL : WARPS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* redA = smem + 4;                    // pAp, the final r.r
  float* redB = redA + WARPS;                // rho0, then rz and x.(r + b)
  float* z = redB + 2 * WARPS;
  float* rbuf = z + m;                       // r, twice
  float* Ap = rbuf + 2 * m;
  float* xs = Ap + m;

  Src src;
  if constexpr (Src::kRegs) {
    src.load(S_g, m, warp, lane);
  } else {
    src.S = S_g;
    if (s_smem) {
      float* Ss = smem + s_offset(m);
      if (bulk) {
        if (tid == 0)
          bulk_load(Ss, S_g, (unsigned)(sizeof(float) * m * m), bar);
      } else {
        for (int i = tid; i < m * m; i += THREADS) Ss[i] = S_g[i];
      }
      src.S = Ss;
    }
  }
  // the register path holds this thread's row of M in registers too
  float mr[TF_MAX];
  if constexpr (Src::kRegs) {
#pragma unroll
    for (int j = 0; j < TF_MAX; ++j)
      mr[j] = minv ? minv[min(tid, m - 1) * tf + min(j, tf - 1)] : 0.f;
  }
  const auto pre = [&](int i, auto rk) {
    if constexpr (Src::kRegs) return precond(mr, minv, i, tf, rk);
    else return precond(minv + (size_t)i * tf, minv, i, tf, rk);
  };
  // -- S loaded: the start phase --
  // y0 = 0: r0 = b, z0 = M b (read from b itself: no barrier), Q0 = 0
  float x[EPT], r[EPT], p[EPT], bv[EPT];
  float rho = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * THREADS;
    x[e] = r[e] = p[e] = bv[e] = 0.f;
    if (i < m) {
      bv[e] = b[i];
      r[e] = bv[e];
      rbuf[i] = r[e];
      const float zi =
          minv ? pre(i, [&](int k) { return b[k]; }) : r[e];
      z[i] = zi;
      p[e] = zi;
      rho += r[e] * zi;
    }
  }
  if (warp < NP) {
    rho = warp_sum(rho);
    if (lane == 0) redB[warp] = rho;
  }
  __syncthreads();
  rho = partial_sum<NP>(redB);
  float v[CL];  // this lane's columns of p
#pragma unroll
  for (int c = 0; c < CL; ++c) {
    const int j = lane + 32 * c;
    v[c] = j < m ? z[j] : 0.f;
  }
  if constexpr (!Src::kRegs) {
    if (s_smem && bulk) bulk_wait(bar);
  }
  float Q0 = 0.f;
  int it = 0, cur = 0, to_reset = reset;
  bool done = false;
  while (!done && it < max_it) {
    matvec<RW, CL>(src, v, nullptr, Ap, m, warp, lane);  // S p
    __syncthreads();  // (1) Ap complete
    float pAp = 0.f, api[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = tid + e * THREADS;
      api[e] = i < m ? Ap[i] : 0.f;
      if (i < m) pAp += p[e] * api[e];
    }
    if (warp < NP) {
      pAp = warp_sum(pAp);
      if (lane == 0) redA[warp] = pAp;
    }
    __syncthreads();  // (2) the pAp partials
    pAp = partial_sum<NP>(redA);
    const bool bad = (pAp <= 0.f) || !isfinite(pAp);
    const float alpha = bad ? 0.f : rho / (pAp == 0.f ? 1.f : pAp);
#pragma unroll
    for (int e = 0; e < EPT; ++e) x[e] = x[e] + alpha * p[e];
    ++it;
    const float* ro = rbuf + cur * m;  // r before this iteration
    float* rn = rbuf + (cur ^ 1) * m;  // and after
    const bool refresh = --to_reset == 0;  // it % reset == 0
    if (refresh) {  // r = b - S x
      to_reset = reset;
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        if (tid + e * THREADS < m) xs[tid + e * THREADS] = x[e];
      __syncthreads();  // x complete
      float xv[CL];
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        const int j = lane + 32 * c;
        xv[c] = j < m ? xs[j] : 0.f;
      }
      matvec<RW, CL>(src, xv, b, rn, m, warp, lane);  // b - S x
      __syncthreads();  // r complete
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        if (tid + e * THREADS < m) r[e] = rn[tid + e * THREADS];
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = tid + e * THREADS;
        if (i < m) {
          r[e] = r[e] - alpha * api[e];
          rn[i] = r[e];
        }
      }
    }
    float rz = 0.f, xrb = 0.f, zo[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = tid + e * THREADS;
      zo[e] = 0.f;
      if (i < m) {
        // z = M r, the block's entries of r made here as their owners
        // make them (or read after a refresh)
        zo[e] = !minv     ? r[e]
                : refresh ? pre(i, [&](int k) { return rn[k]; })
                          : pre(i, [&](int k) {
                              return ro[k] - alpha * Ap[k];
                            });
        z[i] = zo[e];
        rz += r[e] * zo[e];
        xrb += x[e] * (r[e] + bv[e]);
      }
    }
    if (warp < NP) {  // rz to lane 0, x.(r + b) to lane 16
      float two[2] = {rz, xrb};
      const float sum = transpose_sum<2>(two, lane);
      if ((lane & 15) == 0) redB[(lane >> 4) * WARPS + warp] = sum;
    }
    __syncthreads();  // (3) z complete, the rz and x.(r + b) partials
    rz = partial_sum<NP>(redB);
    xrb = partial_sum<NP>(redB + WARPS);
    const float beta = rz / (rho == 0.f ? 1.f : rho);
#pragma unroll
    for (int e = 0; e < EPT; ++e) p[e] = zo[e] + beta * p[e];
#pragma unroll
    for (int c = 0; c < CL; ++c) {
      const int j = lane + 32 * c;
      if (j < m) v[c] = z[j] + beta * v[c];
    }
    const float Q1 = 0.5f * xrb;
    const float zeta = (float)it * (Q1 - Q0) / (Q1 == 0.f ? 1.f : Q1);
    const bool q_done = q_tol > 0.f && it >= max(min_it, 1) && Q1 != 0.f &&
                        fabsf(zeta) < q_tol;
    done = bad || q_done;
    rho = rz;
    Q0 = Q1;
    cur ^= 1;
  }

  float rr = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * THREADS;
    if (i < m) {
      rr += r[e] * r[e];
      y[i] = x[e];
    }
  }
  if (warp < NP) {
    rr = warp_sum(rr);
    if (lane == 0) redA[warp] = rr;
  }
  __syncthreads();
  if (tid == 0) {
    *iters = it;
    *norm = sqrtf(partial_sum<NP>(redA));
  }
}

// the opt-in shared-memory size of each device, and the dynamic size each
// variant was last allowed there
int optin_bytes[MAX_DEVICES];
size_t allowed[MAX_DEVICES][4];

template <int VARIANT, int RW, int CL, int EPT, class Src>
cudaError_t launch(const float* S, const float* b, const float* minv, int m,
                   int tf, int max_it, int min_it, float q_tol, int reset,
                   int s_smem, int bulk, size_t smem, int dev, float* y,
                   int* iters, float* norm, cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > allowed[dev][VARIANT]) {
    const cudaError_t err = cudaFuncSetAttribute(
        pcg_kernel<RW, CL, EPT, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev][VARIANT] = smem;
  }
  pcg_kernel<RW, CL, EPT, Src><<<1, THREADS, smem, stream>>>(
      S, b, minv, m, tf, max_it, min_it, q_tol, reset, s_smem, bulk, y,
      iters, norm);
  return cudaGetLastError();
}

}  // namespace

// minv: the inverted preconditioner blocks [m / tf, tf, tf], or null for
// IDENTITY. Outputs: y [m], iters [1] (int32), norm [1].
extern "C" int ceres_pcg(const float* S, const float* b, const float* minv,
                         int m, int tf, int max_it, int min_it, float q_tol,
                         int reset, float* y, int* iters, float* norm,
                         cudaStream_t stream) {
  if (m < 1 || m > MAX_M || reset < 1 || max_it < 0 ||
      (minv != nullptr && (tf < 1 || m % tf != 0)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (optin_bytes[dev] == 0) {
    err = cudaDeviceGetAttribute(&optin_bytes[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (minv == nullptr) tf = 1;
  const size_t base = sizeof(float) * s_offset(m);
  const auto args = [&](auto launcher, int s_smem, int bulk, size_t smem) {
    return (int)launcher(S, b, minv, m, tf, max_it, min_it, q_tol, reset,
                         s_smem, bulk, smem, dev, y, iters, norm, stream);
  };
  if (m <= REG_CAP)
    return m <= 9 * WARPS ? args(launch<0, 9, 5, 1, RegS<9, 5>>, 0, 0, base)
                          : args(launch<1, 10, 5, 1, RegS<10, 5>>, 0, 0, base);
  const size_t sbytes = sizeof(float) * (size_t)m * m;
  if (m <= SMEM_M && base + sbytes <= (size_t)optin_bytes[dev]) {
    const int bulk = sbytes % 16 == 0 && ((uintptr_t)S & 15) == 0;
    return args(launch<2, 15, 8, 1, MemS>, 1, bulk, base + sbytes);
  }
  return args(launch<3, 64, 32, 2, MemS>, 0, 0, base);
}
