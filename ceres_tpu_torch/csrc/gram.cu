// K9: CGNR's block-Jacobi Grams, one tangent-size group's block diagonal
// (ops/kernels.py group_gram_blocks, called by ops/bsr.py
// block_diag_jtj): out[k] = sum of J_n^T J_n over the rows n of every
// slot view of the group that touch parameter block k, in the group's
// fixed order (ops/bsr.py GroupMeta.gram_order: a stable sort of the
// contributions by block, which keeps the JAX package's (bucket, slot,
// row) scatter order, so within a block the views come in index order).
//   views       the group's slot views: pointer, row stride, residual
//               stride, r. Element (i, s, a) of view v at
//               J[v] + i * row_stride + s * res_stride + a, so a slot's
//               columns of its bucket's [n, r, t_total] Jacobian
//               (BucketJacobian.slot_J) are read in place, no copy
//   map [p, 2]  i32 (view, row) of each contribution, sorted by block
//   off [k + 1] i32 block k's contributions are map[off[k] : off[k + 1]]
//   out [k, t, t] f32 output, contiguous
// With one view and the identity map (block k = row k) the output is the
// per-row Grams G_n = J_n^T J_n, the TPU kernel's contract
// (ops/kernels.py bucket_gram_blocks).
//
// Replaces ceres_tpu/ops/pallas_kernels.py::_block_outer_kernel
// (bucket_gram_blocks), whose per-row blocks the JAX package then
// scatter-adds per block.
//
// Bound on the H100: bytes, (n r t + k t t) * 4 over 3.35 TB/s; it does
// 2 r t t operations a row, under one per byte. At the pose graphs' sizes
// (a few thousand rows, under 1 MB) the launch sets the device time, so
// what counts is the number of launches: one a group, where a per-row
// kernel would take one a slot and the block sums three more operations
// (a cat, a gather, a segmented reduce).
//
// Design: one thread per output entry (block k, entry a, b), so a warp's
// stores are contiguous. A row's Gram entry sums J[i, s, a] J[i, s, b]
// over s in index order from +0 (row_gram; the (a, b) and (b, a) entries
// are the same products in the same order, so a block comes out exactly
// symmetric). The thread walks block k's contributions in map order and
// adds each row's entry to an accumulator that starts at +0: the per-row
// Grams summed in the group's order, bit for bit. A thread's time is its
// chains of dependent loads (the segment offsets, the map entries, the
// rows), so it fetches the map entries of CHUNK contributions at once,
// then their rows, whose first UNROLL residuals' loads issue together.
// Each output entry has one writer: no atomics, the same bits on every
// run. The slots' pointers change every linearization, so the views
// travel by value in the launch, MAX_VIEWS at a time: a group of more
// views takes one launch per MAX_VIEWS, each starting from the sums the
// last one stored and taking only its own views' contributions (a
// block's contributions are sorted by view), so the sums keep their
// order and their bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// contributions of a block the kernel fetches at a time
constexpr int CHUNK = 4;
// slot views one launch takes
constexpr int MAX_VIEWS = 8;

struct GramViews {
  const float* J[MAX_VIEWS];
  long row_stride[MAX_VIEWS];
  long res_stride[MAX_VIEWS];
  int r[MAX_VIEWS];
};

// a row's Gram entry (a, b): J[s, a] J[s, b] summed over s in order from
// +0; the first UNROLL residuals unrolled and predicated, so that their
// loads issue together
constexpr int UNROLL = 8;

__device__ __forceinline__ float row_gram(const float* Jn, int r,
                                          long res_stride, int a, int b) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < UNROLL; ++s) {
    if (s < r) {
      const float* Js = Jn + s * res_stride;
      acc += Js[a] * Js[b];
    }
  }
  for (int s = UNROLL; s < r; ++s) {
    const float* Js = Jn + s * res_stride;
    acc += Js[a] * Js[b];
  }
  return acc;
}

// views v_lo .. min(v_lo + MAX_VIEWS, nviews) - 1 of the group, as
// views.J[0 ...]
__global__ void gram_group_kernel(GramViews views, int v_lo, int nviews,
                                  const int2* __restrict__ map,
                                  const int* __restrict__ off,
                                  int num_blocks, int t,
                                  float* __restrict__ out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int tt = t * t;
  if (idx >= (long)num_blocks * tt) return;
  const int k = (int)(idx / tt);
  const int ab = (int)(idx - (long)k * tt);
  const int a = ab / t, b = ab - (ab / t) * t;
  int begin = off[k], end = off[k + 1];
  float acc = 0.f;
  if (v_lo > 0) {            // continue the earlier views' sums
    acc = out[idx];
    while (begin < end && map[begin].x < v_lo) ++begin;
  }
  if (v_lo + MAX_VIEWS < nviews) {   // later views are a later launch's
    while (end > begin && map[end - 1].x >= v_lo + MAX_VIEWS) --end;
  }
  // CHUNK contributions at a time: their map entries load together, then
  // their rows (a past-the-end entry repeats the last and is not added)
  for (int p0 = begin; p0 < end; p0 += CHUNK) {
    int2 vr[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) vr[j] = map[min(p0 + j, end - 1)];
    float g[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int v = vr[j].x - v_lo;
      g[j] = row_gram(views.J[v] + vr[j].y * views.row_stride[v],
                      views.r[v], views.res_stride[v], a, b);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (p0 + j < end) acc += g[j];
  }
  out[idx] = acc;
}

}  // namespace

// views: nviews entries of (pointer, row stride, residual stride, r) as
// host integers, copied MAX_VIEWS at a time into the kernel's by-value
// argument: one launch per MAX_VIEWS views, in order on `stream`
extern "C" int ceres_gram_group(const long* views, int nviews,
                                const int* map, const int* off,
                                int num_blocks, int t, float* out,
                                cudaStream_t stream) {
  if (num_blocks <= 0 || t <= 0) return 0;
  if (nviews < 1) return (int)cudaErrorInvalidValue;
  const long total = (long)num_blocks * t * t;
  const long blocks = (total + THREADS - 1) / THREADS;
  for (int v_lo = 0; v_lo < nviews; v_lo += MAX_VIEWS) {
    GramViews v = {};
    for (int i = 0; i < MAX_VIEWS && v_lo + i < nviews; ++i) {
      const long* w = views + 4 * (v_lo + i);
      v.J[i] = reinterpret_cast<const float*>(w[0]);
      v.row_stride[i] = w[1];
      v.res_stride[i] = w[2];
      v.r[i] = (int)w[3];
    }
    gram_group_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        v, v_lo, nviews, reinterpret_cast<const int2*>(map), off,
        num_blocks, t, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
