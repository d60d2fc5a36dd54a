// K9: the per-row Gram blocks of one bucket's slot, G_n = J_n^T J_n.
//
// Replaces ceres_tpu/ops/pallas_kernels.py::_block_outer_kernel
// (bucket_gram_blocks). CGNR's block Jacobi preconditioner sums these
// blocks per parameter block (ops/bsr.py block_diag_jtj, in the fixed
// order of the group's block_sum, outside the kernel).
//   J [n, r, t]  f32, a strided view: element (i, s, a) at
//                J + i * row_stride + s * res_stride + a, so a slot's
//                columns of the bucket's [n, r, t_total] Jacobian
//                (BucketJacobian.slot_J) are read in place, no copy
//   G [n, t, t]  f32 output, contiguous
//
// Bound on the H100: bytes, (n r t + n t t) * 4 over 3.35 TB/s; it does
// 2 r t t operations a row, under one per byte. Design: one thread per
// output element (row i, entry a, b), so a warp's stores are contiguous;
// the thread sums J[i, s, a] J[i, s, b] over s in index order (the
// (a, b) and (b, a) entries are the same products in the same order, so
// G comes out exactly symmetric). The row's r t inputs are read by its
// t t threads, from L1. Each G entry has one writer: no atomics.

#include <cuda_runtime.h>

namespace {

__global__ void gram_kernel(const float* __restrict__ J, int n, int r, int t,
                            long row_stride, long res_stride,
                            float* __restrict__ G) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long tt = (long)t * t;
  if (idx >= (long)n * tt) return;
  const long row = idx / tt;
  const int ab = (int)(idx - row * tt);
  const int a = ab / t, b = ab - (ab / t) * t;
  const float* Jn = J + row * row_stride;
  float acc = 0.f;
  for (int s = 0; s < r; ++s) {
    const float* Js = Jn + s * res_stride;
    acc += Js[a] * Js[b];
  }
  G[idx] = acc;
}

}  // namespace

extern "C" int ceres_gram(const float* J, int n, int r, int t,
                          long row_stride, long res_stride, float* G,
                          cudaStream_t stream) {
  if (n <= 0 || t <= 0) return 0;
  if (r < 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long total = (long)n * t * t;
  const long blocks = (total + threads - 1) / threads;
  gram_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      J, n, r, t, row_stride, res_stride, G);
  return (int)cudaGetLastError();
}
