// K5: the linearize of any two-slot functor, with K1's epilogue: the
// point-side Grams, the e-scaled cross tensor and the camera-side
// block-diagonal Grams.
//
// Replaces ceres_tpu/ops/pallas_lin.py::_lin_kernel_auto (with
// _fold_ftf_gf_mxu and ops/jetlib.py's _correct_jets and _jet_planes).
// The residual jet chain is not written here: ops/jet_compile.py traces
// the bucket's per-row program and ops/lin_auto.py emits it as a struct
//   struct Chain {
//     static constexpr int TE, TF, R, NT, EO, FO, ND;
//     static __device__ void run(const float* xf_c, const float* xe_n,
//                                const float* d, const LossParams& lp,
//                                bool valid, float (&rv)[R],
//                                float (&J)[R][NT]);
//   };
// (the residuals and their tangent Jacobian of one observation lane, the
// Triggs corrector of a robust loss applied, with sq = 0 on an invalid
// lane), into a generated unit that includes this file and instantiates
// lin_auto_launch<Chain> behind the C entry point ceres_lin_auto. K1
// (csrc/lin.cu) is the same kernel with a chain written by hand,
// SnavelyK1Chain, behind ceres_lin.
// Same outputs as K1 (csrc/lin.cu), at general TE, TF and R:
//   ete [ne, TE*TE], ge [ne, TE], se [ne, TE]  (se: 1/(1+sqrt(diag E^T E))
//     when `first`, else the carried se_in; ones when scaling is off),
//   A [ne, TE, nf] = (s_e E)^T F, nf = kf*TF (every entry written here),
//   ftf [kf, TF*TF], gf [kf, TF]: F^T F block diagonal and f gradient.
// Inputs in the Schur chunk layout [ne, k]: the camera of each lane as an
// int32 map and the data fields [ne, k, ND]. A masked lane carries its
// point's first valid lane's camera and data (the JAX package's fill
// rule, pallas_lin.py:735-763): a generic chain cannot be guarded, and a
// zero camera could put a divisor at 0 and give Inf, which the mask
// (Inf * 0 = NaN) would not remove.
//
// Bound on the H100: bytes. A alone is ne*TE*nf floats (42.4 MB at the
// quaternion BAL-16-22106 shape: 22,106 x 3 x 160 x 4 B), about 0.013 ms
// at 3.35 TB/s; the jet arithmetic and the epilogue (~800 operations a
// lane for the quaternion functor) are 0.001 ms at the f32 rate.
//
// Design. lane_kernel gives one thread to one lane: a block of THREADS
// threads takes pb = THREADS / k whole points (one point, in passes of
// THREADS lanes, when k > THREADS) and runs each lane's chain in
// registers. Each lane leaves its terms in shared memory, at odd strides:
// its point-side terms (g_e and the E^T E upper triangle), its F-side
// terms and its TE x TF cross terms. Then
//   - the F-side terms stream out, half the block's lanes a stage, each
//     lane's row contiguous, to the lane's place in a camera-sorted order
//     (`pos`, a host plan of the constant cam and mask: ops/lin_auto.py
//     camera_plan), masked lanes dropped; the cross terms then take the
//     stage's place;
//   - one thread a point sums the point-side terms in lane order from 0
//     and forms se;
//   - the block writes its points' A rows, a contiguous region, once,
//     zeros included, through a tile of ABUF floats (4 points' rows at
//     the quaternion shape; one point's rows in column segments when
//     they are longer): the tile is filled with 0 * se; a thread an
//     entry of the lanes that are their point's first on their camera
//     (flags found once a lane) writes (0 + the lane's cross term + those
//     of the point's later lanes on the camera, in lane order) * se; a
//     warp a row streams the tile out with 16-byte stores (4-byte where
//     nf % 4 != 0), marked evict-first so that the F-side rows stay in L2
//     for the partial sums. A is never read, and the wrapper does not
//     zero it (scripts/k5_variants.py times the phases).
// ftf_partial_kernel sums each (1,024-row chunk, camera, term) over its
// contiguous run of the sorted rows, in row order, and ftf_final_kernel
// sums the chunks in chunk order: O(rows x NQ) instead of the scan of
// every chunk row by every output, O(rows x kf x NQ).
// Every sum keeps the order of the one-thread-a-point kernel that this
// replaces, so at R >= 2 the six outputs repeat its bits. (Masked lanes'
// terms are +-0, which leave a sum that starts at +0 unchanged, so
// dropping them moves no bit. At R = 1 that kernel's compiler fused the
// lane's one product into the running sum; here the product is rounded
// first.) Shared memory a block, floats: ABUF + max(HALF odd(NQ), pb k
// odd(TE TF)) (the two added when k > THREADS) + pb k (odd(NE_T) + 2) +
// THREADS + pb TE: 31 KB at the quaternion shape, so 7 blocks fit an SM,
// a wave for all 691. So every block runs its chains and F-side rows,
// then its A rows, about together, and the two phases add up rather than
// overlap (a persistent grid that could overlap them is slower:
// scripts/k5_variants.py). Past the card's 227 KB (a point on more than
// ~1,200 lanes at TE 3, TF 10) the launch is refused.
// Registers of the quaternion unit for sm_90a (scripts/time_kernels.py,
// cuobjdump -res-usage): lane_kernel 64 (72 with HuberLoss), 16 B of
// stack, no spill to local memory; ftf_partial_kernel 30; ftf_final_kernel
// 32. Its time on the H100 beside the bound: PERF.md section 6.
// No float atomics (the recorded decision on deterministic reductions).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int LIN_AUTO_MAX_LOSS_PARAMS = 16;

// a robust loss's scalars (kernel arguments: one build per loss class)
struct LossParams {
  float p[LIN_AUTO_MAX_LOSS_PARAMS];
};

namespace lin_auto {

constexpr int THREADS = 128;            // lanes a pass (ops/lin_auto.py)
constexpr int HALF = THREADS / 2;       // lanes a stage of F-side rows
constexpr int MAX_SMEM = 232448;        // a block's shared memory (H100)
constexpr int BATCH = 32;               // loads in flight a sum thread
constexpr int ABUF = 2048;              // floats of a block's A tile

// the shared-memory strides of one lane (floats, odd against bank
// conflicts)
template <class C>
struct Strides {
  static constexpr int NE_T = C::TE * (C::TE + 1) / 2 + C::TE;
  static constexpr int NQ = C::TF * (C::TF + 1) / 2 + C::TF;
  static constexpr int XS = (C::TE * C::TF) | 1;
  static constexpr int ES = NE_T | 1;
  static constexpr int QS = NQ | 1;
};

// floats before the point-side terms: the F-side stage, and the cross
// terms in the same place when the block's lanes take one pass
template <class C>
__host__ __device__ inline int stage_floats(int cap) {
  using S = Strides<C>;
  if (cap > THREADS) return HALF * S::QS + cap * S::XS;
  return HALF * S::QS > cap * S::XS ? HALF * S::QS : cap * S::XS;
}

// bytes of a block's shared memory at pb points of k lanes
template <class C>
inline size_t smem_bytes(int pb, int k) {
  using S = Strides<C>;
  const int cap = pb * k;
  return 4 * ((size_t)ABUF + stage_floats<C>(cap) +
              (size_t)cap * (S::ES + 2) + THREADS + (size_t)pb * C::TE);
}

template <class C>
__global__ void __launch_bounds__(THREADS)
    lane_kernel(const float* __restrict__ xf, const float* __restrict__ xe,
                const int* __restrict__ cam, const float* __restrict__ mask,
                const float* __restrict__ dat, LossParams lp,
                const float* __restrict__ se_in, int first, int use_scaling,
                int ne, int k, int nf, int pb, const int* __restrict__ pos,
                float* __restrict__ ete, float* __restrict__ ge,
                float* __restrict__ se_out, float* __restrict__ A,
                float* __restrict__ q) {
  constexpr int TE = C::TE, TF = C::TF, R = C::R, NT = C::NT;
  constexpr int EO = C::EO, FO = C::FO, ND = C::ND;
  using S = Strides<C>;
  constexpr int NPAIR = TF * (TF + 1) / 2;
  constexpr int NQ = S::NQ, XS = S::XS, ES = S::ES, QS = S::QS;
  extern __shared__ float4 smem4[];
  float* const sA = reinterpret_cast<float*>(smem4);  // [ABUF] A tiles
  float* const smem = sA + ABUF;
  const int cap = pb * k;
  float* sQ = smem;                       // [HALF][QS] F-side terms
  float* sX = cap <= THREADS ? smem       // [cap][XS] cross terms
                             : smem + HALF * QS;
  float* sE = smem + stage_floats<C>(cap);  // [cap][ES] g_e, E^T E pairs
  float* sS = sE + cap * ES;              // [pb][TE] se
  int* sC = (int*)(sS + pb * TE);         // [cap] camera, -1 when masked
  int* sP = sC + cap;                     // [THREADS] sorted place
  int* sF = sP + THREADS;                 // [cap] lane flags for A

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * pb;
  const int npts = min(pb, ne - n0);
  const int lanes = npts * k;
  const size_t r0 = (size_t)n0 * k;

  for (int base = 0; base < lanes; base += THREADS) {
    const int l = base + tid;
    const bool active = l < lanes;
    float rv[R];
    float J[R][NT];
    if (active) {
      const size_t row = r0 + l;
      const int n = n0 + l / k;
      const float mk = mask[row];
      const bool valid = mk > 0.5f;
      const int c = cam[row];
      C::run(xf + (size_t)c * TF, xe + (size_t)n * TE, dat + row * ND, lp,
             valid, rv, J);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        rv[s] *= mk;
#pragma unroll
        for (int t = 0; t < NT; ++t) J[s][t] *= mk;
      }
      // point-side terms: g_e, then the upper triangle of E^T E
      float* e = sE + l * ES;
      int idx = TE;
#pragma unroll
      for (int a = 0; a < TE; ++a) {
        float acc = J[0][EO + a] * rv[0];
#pragma unroll
        for (int s = 1; s < R; ++s) acc += J[s][EO + a] * rv[s];
        e[a] = acc;
#pragma unroll
        for (int b = a; b < TE; ++b) {
          float p = J[0][EO + a] * J[0][EO + b];
#pragma unroll
          for (int s = 1; s < R; ++s) p += J[s][EO + a] * J[s][EO + b];
          e[idx++] = p;
        }
      }
      sC[l] = valid ? c : -1;
      sP[tid] = pos[row];
    }
    // F-side terms (the F^T F pairs, then g_f), half the lanes a stage,
    // to their camera-sorted rows
    const int nl = min(THREADS, lanes - base);
    for (int h = 0; h < 2; ++h) {
      if (active && (tid >= HALF) == (h == 1)) {
        float* qr = sQ + (tid - h * HALF) * QS;
        int iq = 0;
#pragma unroll
        for (int t = 0; t < TF; ++t)
#pragma unroll
          for (int u = t; u < TF; ++u) {
            float p = J[0][FO + t] * J[0][FO + u];
#pragma unroll
            for (int s = 1; s < R; ++s) p += J[s][FO + t] * J[s][FO + u];
            qr[iq++] = p;
          }
#pragma unroll
        for (int t = 0; t < TF; ++t) {
          float p = J[0][FO + t] * rv[0];
#pragma unroll
          for (int s = 1; s < R; ++s) p += J[s][FO + t] * rv[s];
          qr[NPAIR + t] = p;
        }
      }
      __syncthreads();
      const int nh = min(HALF, nl - h * HALF);
      for (int i = tid; i < nh * NQ; i += THREADS) {
        const int ll = i / NQ, e = i - ll * NQ;
        const int p = sP[h * HALF + ll];
        if (p >= 0) q[(size_t)p * NQ + e] = sQ[ll * QS + e];
      }
      __syncthreads();
    }
    // unscaled cross terms (over the F-side stage when in one pass)
    if (active) {
      float* x = sX + l * XS;
#pragma unroll
      for (int a = 0; a < TE; ++a)
#pragma unroll
        for (int t = 0; t < TF; ++t) {
          float p = J[0][EO + a] * J[0][FO + t];
#pragma unroll
          for (int s = 1; s < R; ++s) p += J[s][EO + a] * J[s][FO + t];
          x[a * TF + t] = p;
        }
    }
  }

  // each lane's flags for A: 1 if it is valid and its point's first
  // lane on its camera, 2 if a later lane of the point shares the camera,
  // and its point (local) from bit 2
  for (int l = tid; l < lanes; l += THREADS) {
    const int c = sC[l], p = l / k;
    int f = c >= 0;
    for (int j = p * k; j < (p + 1) * k; ++j)
      if (sC[j] == c) {
        if (j < l) f = 0;
        if (j > l) f |= 2;
      }
    sF[l] = (f & 1) ? f | p << 2 : 0;
  }

  // point-side sums, from 0 in lane order, and the scale
  if (tid < npts) {
    const int n = n0 + tid;
    float g[TE];
    float m[TE][TE];
#pragma unroll
    for (int a = 0; a < TE; ++a) {
      g[a] = 0.f;
#pragma unroll
      for (int b = 0; b < TE; ++b) m[a][b] = 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const float* e = sE + (tid * k + j) * ES;
      int idx = TE;
#pragma unroll
      for (int a = 0; a < TE; ++a) {
        g[a] += e[a];
#pragma unroll
        for (int b = a; b < TE; ++b) m[a][b] += e[idx++];
      }
    }
#pragma unroll
    for (int a = 0; a < TE; ++a) {
      float se;
      if (!use_scaling)
        se = 1.f;
      else
        se = first ? 1.f / (1.f + sqrtf(m[a][a])) : se_in[n * TE + a];
      sS[tid * TE + a] = se;
      se_out[n * TE + a] = se;
      ge[n * TE + a] = g[a];
#pragma unroll
      for (int b = 0; b < TE; ++b)
        ete[n * TE * TE + a * TE + b] = a <= b ? m[a][b] : m[b][a];
    }
  }
  __syncthreads();

  // the block's A rows [npts][TE][nf], written once, in tiles of g
  // points x TE rows x w columns through sA: each row filled with 0 * se,
  // each valid lane that is its point's first on its camera writes its
  // camera's columns, (0 + its cross terms + those of the point's later
  // lanes on the camera, in lane order) * se, and the warps stream the
  // rows out, a warp a row
  const int warp = tid >> 5, wl = tid & 31;
  int g = ABUF / (TE * nf), w = nf;
  if (g == 0) g = 1, w = (ABUF / TE) & ~3;
  const bool vec = (nf & 3) == 0;         // then w % 4 == 0 too
  for (int g0 = 0; g0 < npts; g0 += g) {
    const int gn = min(g, npts - g0);
    for (int s0 = 0; s0 < nf; s0 += w) {
      const int wn = min(w, nf - s0);
      for (int r = warp; r < gn * TE; r += THREADS / 32) {
        const float z = 0.f * sS[g0 * TE + r];
        if (vec)
          for (int c4 = wl; c4 < wn / 4; c4 += 32)
            reinterpret_cast<float4*>(sA + r * wn)[c4] =
                make_float4(z, z, z, z);
        else
          for (int col = wl; col < wn; col += 32) sA[r * wn + col] = z;
      }
      __syncthreads();
      // a thread an entry of the group's lanes' cross terms, those of
      // lanes that are first on their camera, in this column segment
      for (int it = tid; it < gn * k * (TE * TF); it += THREADS) {
        const int l = g0 * k + it / (TE * TF), e = it % (TE * TF);
        const int f = sF[l];
        const int col = sC[l] * TF + e % TF - s0;
        if (!(f & 1) || col < 0 || col >= wn) continue;
        const int p = f >> 2, a = e / TF;
        float acc = 0.f;
        acc += sX[l * XS + e];
        if (f & 2)
          for (int j = l + 1; j < (p + 1) * k; ++j)
            if (sC[j] == sC[l]) acc += sX[j * XS + e];
        sA[((p - g0) * TE + a) * wn + col] = acc * sS[p * TE + a];
      }
      __syncthreads();
      for (int r = warp; r < gn * TE; r += THREADS / 32) {
        float* Ar = A + ((size_t)(n0 + g0) * TE + r) * nf + s0;
        if (vec)
          for (int c4 = wl; c4 < wn / 4; c4 += 32)
            __stcs(reinterpret_cast<float4*>(Ar) + c4,
                   reinterpret_cast<const float4*>(sA + r * wn)[c4]);
        else
          for (int col = wl; col < wn; col += 32)
            __stcs(Ar + col, sA[r * wn + col]);
      }
      __syncthreads();
    }
  }
}

// partial[s * NQ + e], s = chunk * kf + camera: the terms e of segment s
// of the camera-sorted rows, [off[s], off[s + 1]), summed from 0 in row
// order (0 for a camera that the chunk does not observe). Loads go out
// BATCH at a time ahead of the adds, the last batch filled with +0: a
// sum that starts at +0 is never -0, and x + +0 = x for every other x,
// so the padding moves no bit (ftf_final_kernel likewise).
template <int TF>
__global__ void ftf_partial_kernel(const float* __restrict__ q,
                                   const int* __restrict__ off, int nseg,
                                   float* __restrict__ partial) {
  constexpr int NQ = TF * (TF + 1) / 2 + TF;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= nseg * NQ) return;
  const int s = o / NQ, e = o - s * NQ;
  const int p1 = off[s + 1];
  float acc = 0.f;
  for (int p = off[s]; p < p1; p += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      v[u] = p + u < p1 ? q[(size_t)(p + u) * NQ + e] : 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) acc += v[u];
  }
  partial[o] = acc;
}

// Sums the chunk partials in chunk order and expands the Gram pairs to
// full symmetric TF x TF blocks.
template <int TF>
__global__ void ftf_final_kernel(const float* __restrict__ partial,
                                 int nchunks, int kf, float* __restrict__ ftf,
                                 float* __restrict__ gf) {
  constexpr int NPAIR = TF * (TF + 1) / 2;
  constexpr int NQ = NPAIR + TF;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kf * NQ) return;
  const size_t stride = (size_t)kf * NQ;
  float acc = 0.f;
  for (int ch = 0; ch < nchunks; ch += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      v[u] = ch + u < nchunks ? partial[(ch + u) * stride + o] : 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) acc += v[u];
  }
  const int c = o / NQ, e = o % NQ;
  if (e >= NPAIR) {
    gf[c * TF + (e - NPAIR)] = acc;
    return;
  }
  // e indexes the upper-triangle pair (t, u), t <= u, row-major
  int t = 0, rem = e;
  while (rem >= TF - t) {
    rem -= TF - t;
    ++t;
  }
  const int u = t + rem;
  ftf[c * TF * TF + t * TF + u] = acc;
  ftf[c * TF * TF + u * TF + t] = acc;
}

}  // namespace lin_auto

// The three launches of K5 on `stream`; lp_host holds the loss's nlp
// scalars (host memory); pos [ne*k] and off [nchunks*kf + 1] are the
// camera plan, q [rows, NQ] scratch in its order and partial [nchunks,
// kf*NQ] scratch. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments it refuses (shared memory past the card's, A unaligned).
template <class C>
int lin_auto_launch(const float* xf, const float* xe, const int* cam,
                    const float* mask, const float* dat, const float* lp_host,
                    int nlp, const float* se_in, int first, int use_scaling,
                    int ne, int k, int kf, int pb, const int* pos,
                    const int* off, int nchunks, float* ete, float* ge,
                    float* se_out, float* A, float* q, float* partial,
                    float* ftf, float* gf, cudaStream_t stream) {
  if (nlp < 0 || nlp > LIN_AUTO_MAX_LOSS_PARAMS || k < 1 || pb < 1 ||
      ((uintptr_t)A & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lin_auto::smem_bytes<C>(pb, k);
  if (smem > (size_t)lin_auto::MAX_SMEM) return (int)cudaErrorInvalidValue;
  LossParams lp;
  for (int i = 0; i < LIN_AUTO_MAX_LOSS_PARAMS; ++i)
    lp.p[i] = i < nlp ? lp_host[i] : 0.f;
  constexpr int NQ = C::TF * (C::TF + 1) / 2 + C::TF;
  const int nf = kf * C::TF;
  const int nseg = nchunks * kf;
  if (ne > 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(lin_auto::lane_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    lin_auto::lane_kernel<C><<<(ne + pb - 1) / pb, lin_auto::THREADS, smem,
                               stream>>>(xf, xe, cam, mask, dat, lp, se_in,
                                         first, use_scaling, ne, k, nf, pb,
                                         pos, ete, ge, se_out, A, q);
  }
  if (nseg > 0)
    lin_auto::ftf_partial_kernel<C::TF><<<(nseg * NQ + 255) / 256, 256, 0,
                                          stream>>>(q, off, nseg, partial);
  if (kf > 0)
    lin_auto::ftf_final_kernel<C::TF><<<(kf * NQ + 255) / 256, 256, 0,
                                        stream>>>(partial, nchunks, kf, ftf,
                                                  gf);
  return (int)cudaGetLastError();
}
