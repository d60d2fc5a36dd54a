// K2: damped point elimination into the reduced camera system, and K6,
// the same elimination from a given inverse, for point blocks of TE = 1
// to 6 columns.
//
// K2 replaces ceres_tpu/ops/pallas_lin.py::_elim2_kernel. Per point n:
//   M_n   = EtE_s[n] + diag[n] / radius            (TE x TE SPD)
//   inv_n = M_n^-1 (closed form: JAX's te = 1, 2 and 3 forms)
//   z_n   = inv_n * (-g_se[n])
// and over all points
//   S_corr = sum_n A_n^T inv_n A_n   [nf, nf]
//   rhs    = sum_n A_n^T z_n         [nf]
// with A [ne, TE, nf] from the linearize kernel (lin.cu, lin_auto.cuh).
// As the JAX package's, K2 takes TE <= 3 (pallas_lin.py:999 have_elim2);
// past it the explicit step forms inv and z in PyTorch and runs K6.
// K6 (ELIM v1) replaces ceres_tpu/ops/pallas_lin.py::_elim_kernel: the
// same S_corr and rhs from an inv [ne, TE, TE] and z [ne, TE] that the
// caller gives (the ITERATIVE_SCHUR step, and the DENSE step past TE = 3,
// form them in PyTorch). The two share the kernels below; K2 forms inv
// and z as it stages each point.
//
// Bound on the H100: operations. S_corr is a rank-TE update per point,
// 2 TE nf^2 flops with Y_n = inv_n A_n formed first, or 2 TE nf (nf + 1)
// / 2 for the upper triangle, which is all the kernel computes at
// nf <= 160: 1.46 GFLOP at BAL-16-22106 (ne 22,106, nf 144, TE 3), ~22 us
// at the f32 rate, against 38 MB of A (~11 us of memory time). In
// practice shared memory's bandwidth sets it: each thread reads 2 R
// values a rank-1 update.
//
// Design: a split-K product with register tiles, plain f32 FMAs on the
// CUDA cores (no tensor-core or TF32 pass).
// - Output tiles of 16 R x 16 R; at nf <= 160 one tile (R = ceil(nf/16))
//   holds all of S_corr, else tiles of 128 (R = 8) over the upper pairs
//   of tiles, the lower ones mirrored. Thread (tr, tc) of 256 owns rows
//   tr + 16 p and columns tc + 16 q of its tile: R x R accumulators, or
//   at nf <= 160 only q >= p (R (R + 1) / 2 of them: the upper triangle,
//   all threads busy).
// - Each block takes one tile pair and a contiguous, fixed range of
//   points (ops/lin.py elim_plan: two blocks per SM over the pairs). It
//   stages A_n's TE rows of its windows for 8 points at a time in shared
//   memory with cp.async (16 B where A's rows allow it), double-buffered,
//   so the next group's copy runs under this group's product; one warp per
//   point then forms Y_n = inv_n A_n once (K2: inv_n and z_n from the
//   staged EtE, g and diagonal first, written out for the back
//   substitution) and stores A_n and Y_n with each tile row transposed to
//   [16][R padded to 2], so that a thread's R values are contiguous and
//   load as 8 B words (free of bank conflicts); every thread then applies
//   the TE rank-1 updates to its tile. rhs is summed in the same pass: A
//   is read once per call. Every TE is its own instance, its loops over
//   the point's rows unrolled, with the TE = 3 kernel's summation order.
// - Deterministic sums: each block writes its tile's partial sums; a
//   second kernel adds them over the blocks in a fixed order (8 strided
//   runs, then the 8 runs in order) and mirrors. No atomics: two calls
//   give the same bits. Two launches a call.
// Dense in the camera columns: a point touches about 4 of 16 camera
// blocks at BAL-16, and skipping the zero blocks is later work.
//
// Units: this header holds the kernels; each point size's instances are
// compiled in a unit of their own (elim_te<N>.cu, launch_te<N>), so that
// nvcc builds the six in parallel; elim.cu holds the entry points.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = THREADS / 32;      // points per stage, one warp each
constexpr int MAX_TE = 6;            // the point sizes instantiated
constexpr int MAX_R = 10;            // one tile up to nf = 160
constexpr int TILE_R = 8;            // tiles of 128 past that

// Staged words a point: K2's EtE (TE^2), g and diagonal (TE each), K6's
// inv and z; padded to whole 16 B. K2's z a point, for rhs.
__host__ __device__ constexpr int pw(int te) {
  return (te * te + 2 * te + 3) & ~3;
}
__host__ __device__ constexpr int qw(int te) { return (te + 3) & ~3; }

#ifdef CUDA_HOST_EMU
// the host emulator (tests/cuda_host_emu.py) copies at once
inline void cp_async16(float* dst, const float* src) {
  memcpy(dst, src, 16);
}
inline void cp_async4(float* dst, const float* src) { *dst = *src; }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
#else
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
#endif

// Copy columns [c0, c0 + W) of A's rows (n, u) for points n .. n + cnt - 1
// into dst [cnt][TE][ld].
template <int TE>
__device__ __forceinline__ void stage_window(float* dst, int ld,
                                             const float* A, int n, int cnt,
                                             int nf, int c0, int W, bool vec,
                                             int tid) {
  if (c0 == 0 && W == nf && ld == nf) {          // one contiguous span
    const float* src = A + (size_t)n * TE * nf;
    const int total = cnt * TE * nf;
    if (vec) {
      for (int k = 4 * tid; k < total; k += 4 * THREADS)
        cp_async16(dst + k, src + k);
    } else {
      for (int k = tid; k < total; k += THREADS) cp_async4(dst + k, src + k);
    }
    return;
  }
  const int per = vec ? W / 4 : W;
  for (int k = tid; k < cnt * TE * per; k += THREADS) {
    const int row = k / per, ch = k - row * per;
    const float* src = A + ((size_t)n * TE + row) * nf + c0;
    if (vec)
      cp_async16(dst + row * ld + 4 * ch, src + 4 * ch);
    else
      cp_async4(dst + row * ld + ch, src + ch);
  }
}

// Copy the per-point words of points n .. n + cnt - 1 into dst [cnt][PW]:
// p0's TE^2 at 0, p1's TE at TE^2, p2's TE (if any) at TE^2 + TE.
template <int TE>
__device__ __forceinline__ void stage_words(float* dst, const float* p0,
                                            const float* p1, const float* p2,
                                            int n, int cnt, int tid) {
  constexpr int T2 = TE * TE, PW = pw(TE);
  const int total = cnt * (p2 ? T2 + 2 * TE : T2 + TE);
  for (int k = tid; k < total; k += THREADS) {
    if (k < T2 * cnt) {
      const int pt = k / T2, e = k - T2 * pt;
      cp_async4(dst + pt * PW + e, p0 + (size_t)(n + pt) * T2 + e);
    } else if (k < (T2 + TE) * cnt) {
      const int pt = (k - T2 * cnt) / TE, e = k - T2 * cnt - TE * pt;
      cp_async4(dst + pt * PW + T2 + e, p1 + (size_t)(n + pt) * TE + e);
    } else {
      const int pt = (k - (T2 + TE) * cnt) / TE;
      const int e = k - (T2 + TE) * cnt - TE * pt;
      cp_async4(dst + pt * PW + T2 + TE + e,
                p2 + (size_t)(n + pt) * TE + e);
    }
  }
}

// A thread's R values of a tile row, padded to whole 8 B loads.
__host__ __device__ constexpr int padded(int R) { return (R + 1) & ~1; }

// Shared memory in floats; ops/lin.py elim_plan mirrors it.
inline size_t smem_floats(int te, int R, int nt, int ld) {
  const size_t buf = (size_t)G * te * ld;
  const size_t tile = (size_t)G * te * 16 * padded(R);
  return 2 * buf * (nt > 1 ? 2 : 1) + 2 * tile + 2 * G * pw(te) +
         G * qw(te);
}

// K2's damped inverse of one point from its staged words P (EtE upper
// triangle at u TE + v, the diagonal at TE^2 + TE): the JAX kernel's
// closed forms for TE = 1, 2 and 3 (pallas_lin.py:459-481).
template <int TE>
__device__ __forceinline__ void damped_inverse(const float* P, float rad,
                                               float* iv) {
  static_assert(TE >= 1 && TE <= 3, "K2 takes point blocks of 1 to 3");
  constexpr int D = TE * TE + TE;
  if constexpr (TE == 1) {
    iv[0] = 1.f / (P[0] + P[D] / rad);
  } else if constexpr (TE == 2) {
    const float a = P[0] + P[D] / rad;
    const float b = P[1];
    const float d = P[3] + P[D + 1] / rad;
    const float invdet = 1.f / (a * d - b * b);
    iv[0] = d * invdet;
    iv[1] = -b * invdet;
    iv[2] = -b * invdet;
    iv[3] = a * invdet;
  } else {
    const float a = P[0] + P[D] / rad;
    const float b = P[1];
    const float c = P[2];
    const float d = P[4] + P[D + 1] / rad;
    const float ee = P[5];
    const float f = P[8] + P[D + 2] / rad;
    const float co00 = d * f - ee * ee;
    const float co01 = c * ee - b * f;
    const float co02 = b * ee - c * d;
    const float co11 = a * f - c * c;
    const float co12 = b * c - a * ee;
    const float co22 = a * d - b * b;
    const float invdet = 1.f / (a * co00 + b * co01 + c * co02);
    iv[0] = co00 * invdet; iv[1] = co01 * invdet; iv[2] = co02 * invdet;
    iv[3] = co01 * invdet; iv[4] = co11 * invdet; iv[5] = co12 * invdet;
    iv[6] = co02 * invdet; iv[7] = co12 * invdet; iv[8] = co22 * invdet;
  }
}

// grid (splits, pairs), THREADS threads: the partial S_corr of one tile
// pair over one range of points, and (diagonal pairs) its rows' rhs.
// K2: p0 = EtE_s [ne, TE^2], p1 = g_se [ne, TE], p2 = diag [ne, TE]; K6:
// p0 = inv [ne, TE^2], p1 = z [ne, TE], p2 = null.
template <int TE, int R, bool TRI, bool K2>
__global__ void __launch_bounds__(THREADS, 2)
    scorr_kernel(const float* __restrict__ A, const float* __restrict__ p0,
                 const float* __restrict__ p1, const float* __restrict__ p2,
                 float rad, int ne, int nf, int nt, int pts, int ld, int vec,
                 float* __restrict__ inv_out, float* __restrict__ z_out,
                 float* __restrict__ part, float* __restrict__ rpart) {
  constexpr int W16 = 16 * R;
  constexpr int RP = padded(R);
  constexpr int LD = 16 * RP;          // a tile row: [16][RP], see below
  constexpr int NACC = TRI ? R * (R + 1) / 2 : R * R;
  constexpr int T2 = TE * TE, PW = pw(TE), QW = qw(TE);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tr = tid >> 4, tc = tid & 15;
  const int split = blockIdx.x, pair = blockIdx.y;
  int ti = 0, rest = pair;             // pairs ti <= tj, row by row
  while (rest >= nt - ti) {
    rest -= nt - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;
  const int r0 = ti * W16, c0 = tj * W16;
  const int Wr = min(W16, nf - r0), Wc = min(W16, nf - c0);
  // Staged rows of A ([2][G][TE][ld], ld the window: nf at nt = 1, else
  // 128) and, at nt > 1, of the column window; then for the product the
  // group's A (row window) and Y = inv A (column window) with each tile
  // row stored as [16][RP]: column c at (c % 16) RP + c / 16, so that
  // thread (tr, tc)'s R values (columns tr + 16 p, tc + 16 q) are
  // contiguous and load as RP / 2 8-byte words.
  const int buf_words = G * TE * ld;
  float* sA = smem;
  float* sB = sA + 2 * buf_words;
  float* pA = sB + (nt > 1 ? 2 * buf_words : 0);    // [G][TE][LD]
  float* pY = pA + G * TE * LD;                     // [G][TE][LD]
  float* sP = pY + G * TE * LD;                     // [2][G][PW]
  float* sQ = sP + 2 * G * PW;                      // [G][QW]

  const int n_begin = split * pts, n_end = min(ne, n_begin + pts);
  const int ngroups = (n_end - n_begin + G - 1) / G;
  auto stage = [&](int g, int buf) {
    const int n = n_begin + g * G, cnt = min(G, n_end - n);
    stage_window<TE>(sA + buf * buf_words, ld, A, n, cnt, nf, r0, Wr, vec,
                     tid);
    if (!diag)
      stage_window<TE>(sB + buf * buf_words, ld, A, n, cnt, nf, c0, Wc, vec,
                       tid);
    stage_words<TE>(sP + buf * G * PW, p0, p1, p2, n, cnt, tid);
    cp_async_commit();
  };

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  float racc = 0.f;
  stage(0, 0);
  for (int g = 0; g < ngroups; ++g) {
    const int buf = g & 1;
    const int n = n_begin + g * G, cnt = min(G, n_end - n);
    cp_async_wait_all();
    __syncthreads();                  // group g staged; group g - 1 done

    // ---- Y = inv A for point `warp` of the group (K2: inv, z first) ----
    if (warp < cnt) {
      const float* P = sP + buf * G * PW + warp * PW;
      float iv[T2];
      if constexpr (K2) {
        damped_inverse<TE>(P, rad, iv);
        if (lane == 0) {
          float zz[TE];
#pragma unroll
          for (int u = 0; u < TE; ++u) {
            float s = iv[u * TE] * (-P[T2]);
#pragma unroll
            for (int v = 1; v < TE; ++v) s = s + iv[u * TE + v] * (-P[T2 + v]);
            zz[u] = s;
            sQ[warp * QW + u] = s;
          }
          if (pair == 0) {
#pragma unroll
            for (int k = 0; k < T2; ++k)
              inv_out[(size_t)(n + warp) * T2 + k] = iv[k];
#pragma unroll
            for (int u = 0; u < TE; ++u)
              z_out[(size_t)(n + warp) * TE + u] = zz[u];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < T2; ++k) iv[k] = P[k];
      }
      const float* Aw = sA + buf * buf_words + warp * TE * ld;
      const float* Bw = (diag ? sA : sB) + buf * buf_words + warp * TE * ld;
      float* pAw = pA + warp * TE * LD;
      float* pYw = pY + warp * TE * LD;
      for (int c = lane; c < Wc; c += 32) {
        const int pos = (c & 15) * RP + (c >> 4);
        float b[TE];
#pragma unroll
        for (int v = 0; v < TE; ++v) b[v] = Bw[v * ld + c];
#pragma unroll
        for (int u = 0; u < TE; ++u) {
          float y = iv[u * TE] * b[0];
#pragma unroll
          for (int v = 1; v < TE; ++v) y = y + iv[u * TE + v] * b[v];
          pYw[u * LD + pos] = y;
        }
        if (diag) {
#pragma unroll
          for (int v = 0; v < TE; ++v) pAw[v * LD + pos] = b[v];
        }
      }
      if (!diag) {
        for (int c = lane; c < Wr; c += 32) {
          const int pos = (c & 15) * RP + (c >> 4);
#pragma unroll
          for (int u = 0; u < TE; ++u) pAw[u * LD + pos] = Aw[u * ld + c];
        }
      }
    }
    __syncthreads();                  // Y and z of group g ready
    if (g + 1 < ngroups) stage(g + 1, buf ^ 1);

    // ---- the TE rank-1 updates of each point on this thread's tile ----
    const float* zsrc = K2 ? sQ : sP + buf * G * PW + T2;
    const int zstride = K2 ? QW : PW;
    for (int pt = 0; pt < cnt; ++pt) {
      const float* Ap = pA + pt * TE * LD;
      const float* Yp = pY + pt * TE * LD;
#pragma unroll
      for (int u = 0; u < TE; ++u) {
        float av[RP], yv[RP];
        const float2* a2 =
            reinterpret_cast<const float2*>(Ap + u * LD + tr * RP);
        const float2* y2 =
            reinterpret_cast<const float2*>(Yp + u * LD + tc * RP);
#pragma unroll
        for (int v = 0; v < RP / 2; ++v) {
          const float2 a = a2[v], y = y2[v];
          av[2 * v] = a.x; av[2 * v + 1] = a.y;
          yv[2 * v] = y.x; yv[2 * v + 1] = y.y;
        }
        int k = 0;
#pragma unroll
        for (int p = 0; p < R; ++p) {
#pragma unroll
          for (int q = TRI ? p : 0; q < R; ++q) {
            acc[k] = fmaf(av[p], yv[q], acc[k]);
            ++k;
          }
        }
      }
      if (diag && tc < R) {             // row tr + 16 tc
        const float* z = zsrc + pt * zstride;
        const int i = tr * RP + tc;
#pragma unroll
        for (int u = 0; u < TE; ++u) racc = fmaf(Ap[u * LD + i], z[u], racc);
      }
    }
  }

  float* out = part + ((size_t)split * gridDim.y + pair) * NACC * THREADS;
#pragma unroll
  for (int k = 0; k < NACC; ++k) out[k * THREADS + tid] = acc[k];
  if (diag && tc < R) {
    const int i = tr + 16 * tc;
    if (i < Wr) rpart[(size_t)split * nf + r0 + i] = racc;
  }
}

// The sum of the partials over the splits, in a fixed order: warp h of a
// block adds splits h, h + 8, ... for 32 outputs, then the 8 runs are
// added in order. Writes S_corr (mirrored from the upper entries) and rhs.
template <int R, bool TRI>
__global__ void __launch_bounds__(THREADS)
    scorr_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ rpart, int splits,
                        int pairs, int nt, int nf, float* __restrict__ S,
                        float* __restrict__ rhs) {
  constexpr int NACC = TRI ? R * (R + 1) / 2 : R * R;
  constexpr int RUNS = THREADS / 32;
  __shared__ float runs[RUNS][32];
  const size_t per_split = (size_t)pairs * NACC * THREADS;
  const size_t total = per_split + nf;
  const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
  const size_t k = (size_t)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (k < per_split) {
#pragma unroll 4
    for (int sp = h; sp < splits; sp += RUNS) s += part[sp * per_split + k];
  } else if (k < total) {
#pragma unroll 4
    for (int sp = h; sp < splits; sp += RUNS)
      s += rpart[(size_t)sp * nf + (k - per_split)];
  }
  runs[h][lane] = s;
  __syncthreads();
  if (h != 0 || k >= total) return;
  float sum = runs[0][lane];
#pragma unroll
  for (int r = 1; r < RUNS; ++r) sum += runs[r][lane];
  if (k >= per_split) {
    rhs[k - per_split] = sum;
    return;
  }
  const int pair = (int)(k / ((size_t)NACC * THREADS));
  const int rem = (int)(k - (size_t)pair * NACC * THREADS);
  int e = rem / THREADS;
  const int t = rem - e * THREADS, tr = t >> 4, tc = t & 15;
  int p = 0, q;
  if (TRI) {
    while (e >= R - p) {
      e -= R - p;
      ++p;
    }
    q = p + e;
    if (p == q && tr > tc) return;      // a lower entry: its mirror is kept
  } else {
    p = e / R;
    q = e - p * R;
  }
  int ti = 0, rest = pair;
  while (rest >= nt - ti) {
    rest -= nt - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const int i = ti * 16 * R + tr + 16 * p, j = tj * 16 * R + tc + 16 * q;
  if (i >= nf || j >= nf) return;
  S[(size_t)i * nf + j] = sum;
  if (i != j && (TRI || ti != tj)) S[(size_t)j * nf + i] = sum;
}

constexpr int MAX_DEVICES = 64;

template <int TE, int R, bool TRI, bool K2>
cudaError_t run(const float* A, const float* p0, const float* p1,
                const float* p2, float rad, int ne, int nf, int nt,
                int splits, int pts, int ld, size_t smem, float* inv,
                float* z, float* part, float* rpart, float* S, float* rhs,
                cudaStream_t stream) {
  // the dynamic shared memory each device has granted this kernel so far:
  // set the attribute once, not on every launch
  static size_t granted[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(scorr_kernel<TE, R, TRI, K2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    granted[dev] = smem;
  }
  const int pairs = nt * (nt + 1) / 2;
  const int vec = nf % 4 == 0 && ((uintptr_t)A & 15) == 0;
  scorr_kernel<TE, R, TRI, K2><<<dim3(splits, pairs), THREADS, smem,
                                 stream>>>(
      A, p0, p1, p2, rad, ne, nf, nt, pts, ld, vec, inv, z, part, rpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int NACC = TRI ? R * (R + 1) / 2 : R * R;
  const size_t total = (size_t)pairs * NACC * THREADS + nf;
  scorr_reduce_kernel<R, TRI><<<(unsigned)((total + 31) / 32), THREADS, 0,
                                stream>>>(part, rpart, splits, pairs, nt, nf,
                                          S, rhs);
  return cudaGetLastError();
}

// Validate the wrapper's plan (ops/lin.py elim_plan) and launch.
template <int TE, bool K2>
cudaError_t elim_launch(const float* A, const float* p0, const float* p1,
                        const float* p2, float rad, int ne, int nf, int R,
                        int nt, int splits, int pts, int smem, float* inv,
                        float* z, float* part, float* rpart, float* S,
                        float* rhs, cudaStream_t stream) {
  const bool one = nf <= 16 * MAX_R;
  if (ne < 1 || nf < 1 || splits < 1 || pts < 1 ||
      (size_t)splits * pts < (size_t)ne || (size_t)(splits - 1) * pts >= (size_t)ne ||
      R != (one ? (nf + 15) / 16 : TILE_R) ||
      nt != (one ? 1 : (nf + 16 * TILE_R - 1) / (16 * TILE_R)))
    return cudaErrorInvalidValue;
  const int ld = one ? nf : 16 * R;
  if ((size_t)smem < sizeof(float) * smem_floats(TE, R, nt, ld))
    return cudaErrorInvalidValue;
#define CERES_SCORR_R(r)                                                    \
  case r:                                                                   \
    return run<TE, r, true, K2>(A, p0, p1, p2, rad, ne, nf, nt, splits, pts, \
                                ld, smem, inv, z, part, rpart, S, rhs,      \
                                stream);
  if (!one)
    return run<TE, TILE_R, false, K2>(A, p0, p1, p2, rad, ne, nf, nt, splits,
                                      pts, ld, smem, inv, z, part, rpart, S,
                                      rhs, stream);
  switch (R) {
    CERES_SCORR_R(1)
    CERES_SCORR_R(2)
    CERES_SCORR_R(3)
    CERES_SCORR_R(4)
    CERES_SCORR_R(5)
    CERES_SCORR_R(6)
    CERES_SCORR_R(7)
    CERES_SCORR_R(8)
    CERES_SCORR_R(9)
    CERES_SCORR_R(10)
  }
#undef CERES_SCORR_R
  return cudaErrorInvalidValue;
}

}  // namespace

// The parameters of one point size's launch: K2 when k2 (TE <= 3), else
// K6 (p0 = inv, p1 = z, p2 = null).
#define CERES_ELIM_PARAMS                                                    \
  bool k2, const float *A, const float *p0, const float *p1,                \
      const float *p2, float rad, int ne, int nf, int R, int nt,            \
      int splits, int pts, int smem, float *inv, float *z, float *part,      \
      float *rpart, float *S, float *rhs, cudaStream_t stream
#define CERES_ELIM_ARGS                                                      \
  A, p0, p1, p2, rad, ne, nf, R, nt, splits, pts, smem, inv, z, part, rpart, \
      S, rhs, stream

namespace elim_units {
cudaError_t launch_te1(CERES_ELIM_PARAMS);
cudaError_t launch_te2(CERES_ELIM_PARAMS);
cudaError_t launch_te3(CERES_ELIM_PARAMS);
cudaError_t launch_te4(CERES_ELIM_PARAMS);
cudaError_t launch_te5(CERES_ELIM_PARAMS);
cudaError_t launch_te6(CERES_ELIM_PARAMS);
}  // namespace elim_units

