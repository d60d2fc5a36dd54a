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
// ~0.043 ms at 3.35 TB/s) for ~4 r (te + tf) flops a lane. Design: one
// thread per point; v (kf * tf floats, 36 KB at 1,024 cameras) is staged
// in shared memory when it fits in 48 KB and read from global memory
// otherwise, so the gather of v by camera costs no device-memory traffic.
// Two passes over the lanes (u from w, then w again for C) keep the
// registers independent of k; the second pass re-reads the point's Jf
// from L1/L2. Loops run to compile-time maxima (te <= 4, tf <= 16,
// r <= 4). No atomics: every sum is one thread's, in the TPU kernel's
// order, so every application repeats its bits. Every product and sum
// rounds on its own (__fmul_rn, __fadd_rn: no fused multiply-add), in
// the order of ops/implicit.py implicit_apply_plain, so the kernel and
// its plain version agree bit for bit: w2 = w - Je zz cancels most of w,
// and amplifies any difference of rounding between them, such as a
// fused multiply-add's.

#include <cuda_runtime.h>

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
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = 48 * 1024;

template <bool STAGE>
__global__ void implicit_apply_kernel(const float* __restrict__ Je,
                                      const float* __restrict__ Jf,
                                      const float* __restrict__ inv,
                                      const int* __restrict__ fids,
                                      const float* __restrict__ v, int ne,
                                      int k, int r, int te, int tf, int nv,
                                      float* __restrict__ C) {
  extern __shared__ float v_s[];
  const float* vv = v;
  if (STAGE) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) v_s[i] = v[i];
    __syncthreads();
    vv = v_s;
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ne) return;
  const float* je = Je + (size_t)n * k * r * te;
  const float* jf = Jf + (size_t)n * k * r * tf;
  const int* fid = fids + (size_t)n * k;

  // pass 1: u = sum_j Je_j^T (Jf_j v_j)
  float u[MAXTE];
#pragma unroll
  for (int a = 0; a < MAXTE; ++a) u[a] = 0.f;
  for (int j = 0; j < k; ++j) {
    const float* vrow = vv + (size_t)fid[j] * tf;
    float vr[MAXTF];
#pragma unroll
    for (int t = 0; t < MAXTF; ++t) vr[t] = t < tf ? vrow[t] : 0.f;
    float term[MAXTE];
#pragma unroll
    for (int a = 0; a < MAXTE; ++a) term[a] = 0.f;
    for (int rr = 0; rr < r; ++rr) {
      const float* jfr = jf + (size_t)(j * r + rr) * tf;
      const float* jer = je + (size_t)(j * r + rr) * te;
      float w = 0.f;
#pragma unroll
      for (int t = 0; t < MAXTF; ++t)
        if (t < tf) w = madd(w, jfr[t], vr[t]);
#pragma unroll
      for (int a = 0; a < MAXTE; ++a)
        if (a < te) term[a] = madd(term[a], jer[a], w);
    }
#pragma unroll
    for (int a = 0; a < MAXTE; ++a) u[a] = __fadd_rn(u[a], term[a]);
  }

  // zz = inv u
  const float* in = inv + (size_t)n * te * te;
  float zz[MAXTE];
#pragma unroll
  for (int a = 0; a < MAXTE; ++a) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < MAXTE; ++b)
      if (a < te && b < te) acc = madd(acc, in[a * te + b], u[b]);
    zz[a] = acc;
  }

  // pass 2: C_j = Jf_j^T (Jf_j v_j - Je_j zz)
  float* c = C + (size_t)n * k * tf;
  for (int j = 0; j < k; ++j) {
    const float* vrow = vv + (size_t)fid[j] * tf;
    float vr[MAXTF];
#pragma unroll
    for (int t = 0; t < MAXTF; ++t) vr[t] = t < tf ? vrow[t] : 0.f;
    float w2[MAXR];
#pragma unroll
    for (int rr = 0; rr < MAXR; ++rr) {
      float w = 0.f;
      if (rr < r) {
        const float* jfr = jf + (size_t)(j * r + rr) * tf;
        const float* jer = je + (size_t)(j * r + rr) * te;
#pragma unroll
        for (int t = 0; t < MAXTF; ++t)
          if (t < tf) w = madd(w, jfr[t], vr[t]);
#pragma unroll
        for (int a = 0; a < MAXTE; ++a)
          if (a < te) w = msub(w, jer[a], zz[a]);
      }
      w2[rr] = w;
    }
    const float* jfj = jf + (size_t)j * r * tf;
    for (int t = 0; t < tf; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int rr = 0; rr < MAXR; ++rr)
        if (rr < r) acc = madd(acc, jfj[rr * tf + t], w2[rr]);
      c[j * tf + t] = acc;
    }
  }
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
  const int blocks = (ne + THREADS - 1) / THREADS;
  const size_t bytes = (size_t)nv * sizeof(float);
  if (bytes <= STAGE_BYTES) {
    implicit_apply_kernel<true><<<blocks, THREADS, bytes, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C);
  } else {
    implicit_apply_kernel<false><<<blocks, THREADS, 0, stream>>>(
        Je, Jf, inv, fids, v, ne, k, r, te, tf, nv, C);
  }
  return (int)cudaGetLastError();
}
