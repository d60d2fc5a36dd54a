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
// Bound on the H100: latency. At m = 144 one iteration is a 144 x 144
// matvec (41k flops) and a few dots; the whole solve reads ~90 KB, under
// a microsecond of memory time. What costs is the serial chain of
// block-wide barriers in every iteration.
// Design: one block of 512 threads owns the solve, so no state leaves the
// SM between iterations. S (83 KB at m = 144) and the inverted
// preconditioner blocks [kf, tf, tf] sit in dynamic shared memory when
// they fit (above 48 KB after cudaFuncSetAttribute); a larger S (m up to
// 1024, 4 MB) is read from global memory, where it stays L2-resident. The
// matvec runs one row per warp with a shuffle reduction; the dots reduce
// per warp and then over the warps in a fixed order, and every thread
// sums the warp partials itself, so each thread holds the same bits and
// the loop's control flow is uniform without a broadcast. No atomics: a
// run gives the same bits every time. f32 throughout (the TPU kernel runs
// its products at HIGHEST precision for the same reason: a less exact
// recurrence changes the LM trajectory).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_M = 1024;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// out[row] = (S v)[row], or sub[row] - (S v)[row] when sub is given.
__device__ void matvec(const float* S, const float* v, const float* sub,
                       float* out, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < m; row += WARPS) {
    const float* Srow = S + (size_t)row * m;
    float acc = 0.f;
    for (int j = lane; j < m; j += 32) acc += Srow[j] * v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = sub ? sub[row] - acc : acc;
  }
}

// Sums a (and c) over the block; every thread returns the same value.
__device__ void block_sum2(float& a, float& c, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    red[warp] = a;
    red[WARPS + warp] = c;
  }
  __syncthreads();
  float sa = 0.f, sc = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    sa += red[w];
    sc += red[WARPS + w];
  }
  a = sa;
  c = sc;
  __syncthreads();  // red is free again
}

// z = blockdiag(M) r with M [m / tf, tf, tf]; z = r when M is null.
__device__ void precond(const float* M, const float* r, float* z, int m,
                        int tf) {
  for (int i = threadIdx.x; i < m; i += THREADS) {
    if (M == nullptr) {
      z[i] = r[i];
      continue;
    }
    const int blk = i / tf;
    const float* row = M + (size_t)i * tf;  // (blk * tf + i % tf) * tf
    const float* rb = r + blk * tf;
    float acc = 0.f;
    for (int j = 0; j < tf; ++j) acc += row[j] * rb[j];
    z[i] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
    pcg_kernel(const float* __restrict__ S_g, const float* __restrict__ b,
               const float* __restrict__ minv_g, int m, int tf, int max_it,
               int min_it, float q_tol, int reset, int minv_in_smem,
               int s_in_smem, float* __restrict__ y, int* __restrict__ iters,
               float* __restrict__ norm) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  float* red = smem;
  float* x = red + 2 * WARPS;
  float* r = x + m;
  float* z = r + m;
  float* p = z + m;
  float* Ap = p + m;
  float* bs = Ap + m;
  float* tail = bs + m;
  const float* M = minv_g;
  if (minv_g != nullptr && minv_in_smem) {
    for (int i = tid; i < m * tf; i += THREADS) tail[i] = minv_g[i];
    M = tail;
    tail += m * tf;
  }
  const float* S = S_g;
  if (s_in_smem) {
    for (int i = tid; i < m * m; i += THREADS) tail[i] = S_g[i];
    S = tail;
  }
  for (int i = tid; i < m; i += THREADS) {
    x[i] = 0.f;
    bs[i] = b[i];
    r[i] = b[i];
  }
  __syncthreads();

  // y0 = 0: r0 = b, Q0 = 0
  precond(M, r, z, m, tf);
  float rho = 0.f, unused = 0.f;
  for (int i = tid; i < m; i += THREADS) {
    rho += r[i] * z[i];
    p[i] = z[i];
  }
  block_sum2(rho, unused, red);
  float Q0 = 0.f;
  int it = 0;
  bool done = false;
  while (!done && it < max_it) {
    matvec(S, p, nullptr, Ap, m);
    __syncthreads();
    float pAp = 0.f;
    unused = 0.f;
    for (int i = tid; i < m; i += THREADS) pAp += p[i] * Ap[i];
    block_sum2(pAp, unused, red);
    const bool bad = (pAp <= 0.f) || !isfinite(pAp);
    const float alpha = bad ? 0.f : rho / (pAp == 0.f ? 1.f : pAp);
    for (int i = tid; i < m; i += THREADS) x[i] = x[i] + alpha * p[i];
    ++it;
    if (it % reset == 0) {  // refresh only when due: a branch is free here
      __syncthreads();
      matvec(S, x, bs, r, m);
    } else {
      for (int i = tid; i < m; i += THREADS) r[i] = r[i] - alpha * Ap[i];
    }
    __syncthreads();
    precond(M, r, z, m, tf);
    float rz = 0.f, xrb = 0.f;
    for (int i = tid; i < m; i += THREADS) {
      rz += r[i] * z[i];
      xrb += x[i] * (r[i] + bs[i]);
    }
    block_sum2(rz, xrb, red);
    const float beta = rz / (rho == 0.f ? 1.f : rho);
    for (int i = tid; i < m; i += THREADS) p[i] = z[i] + beta * p[i];
    const float Q1 = 0.5f * xrb;
    const float zeta = (float)it * (Q1 - Q0) / (Q1 == 0.f ? 1.f : Q1);
    const bool q_done = q_tol > 0.f && it >= max(min_it, 1) && Q1 != 0.f &&
                        fabsf(zeta) < q_tol;
    done = bad || q_done;
    rho = rz;
    Q0 = Q1;
    __syncthreads();  // p complete before the next matvec
  }

  float rr = 0.f;
  unused = 0.f;
  for (int i = tid; i < m; i += THREADS) {
    rr += r[i] * r[i];
    y[i] = x[i];
  }
  block_sum2(rr, unused, red);
  if (tid == 0) {
    *iters = it;
    *norm = sqrtf(rr);
  }
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
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t base = sizeof(float) * (2 * WARPS + 6 * (size_t)m);
  const size_t pre = minv ? sizeof(float) * (size_t)m * tf : 0;
  const size_t sbytes = sizeof(float) * (size_t)m * m;
  const int minv_in_smem = minv != nullptr && base + pre <= (size_t)optin;
  const size_t used = base + (minv_in_smem ? pre : 0);
  const int s_in_smem = used + sbytes <= (size_t)optin;
  const size_t smem = used + (s_in_smem ? sbytes : 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pcg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pcg_kernel<<<1, THREADS, smem, stream>>>(S, b, minv, m, minv ? tf : 1,
                                           max_it, min_it, q_tol, reset,
                                           minv_in_smem, s_in_smem, y, iters,
                                           norm);
  return (int)cudaGetLastError();
}
