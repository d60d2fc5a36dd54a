// K4: Snavely squared residual norm per observation, in f64.
//
// Replaces ceres_tpu/ops/pallas_cost.py::_cost_kernel (make_pallas_cost).
// The TPU kernel carried each value as a pair of f32 numbers and took the
// per-camera trigonometry from outside because the TPU has no f64; Hopper
// has native f64, so this kernel is straight f64 and evaluates the same
// expression as ceres_tpu_torch.rotation.angle_axis_rotate_point and the
// Snavely functor, small-angle branch (theta^2 < 1e-12) included. The
// caller applies the loss and sums in f64.
//
//   x [*]         f64 state; point p at x + e_slab + 3 p, camera c at
//                 x + f_slab + 9 c (angle-axis, translation, f, k1, k2)
//   pt_idx, cam_idx [n] i32; obsx, obsy [n] f64
//   sq [n]        f64 output, ||r||^2 per observation
//
// Bound on the H100: bytes. A row moves 32 B (two indices, two
// observations, the output) and its point 24 B: at the 1M large case
// (1M rows, 200,000 points, 1,024 cameras) 36.9 MB, 11.0 us at 3.35 TB/s.
// Design: one thread per observation, parameters read straight from the
// state vector through the observation's point and camera indices. The
// camera's rotation (a square root, f64 cos and sin, 1 / theta) depends
// only on the camera, but per row it hides under the row's loads:
// scripts/k4_variants.py builds the form that takes it once per camera
// (a camera kernel writing a table the rows read) and variants of it,
// and none was faster than this one kernel at BAL-16 or at the 1M case.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void cost_kernel(const double* __restrict__ x, long e_slab,
                            long f_slab, const int* __restrict__ pt_idx,
                            const int* __restrict__ cam_idx,
                            const double* __restrict__ obsx,
                            const double* __restrict__ obsy, int n,
                            double* __restrict__ sq) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const double* c = x + f_slab + 9L * cam_idx[row];
  const double* q = x + e_slab + 3L * pt_idx[row];
  const double aa[3] = {c[0], c[1], c[2]};
  const double pt[3] = {q[0], q[1], q[2]};
  const double theta_sq = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  double p[3];
  if (theta_sq < 1e-12) {
    p[0] = pt[0] + (aa[1] * pt[2] - aa[2] * pt[1]);
    p[1] = pt[1] + (aa[2] * pt[0] - aa[0] * pt[2]);
    p[2] = pt[2] + (aa[0] * pt[1] - aa[1] * pt[0]);
  } else {
    const double theta = sqrt(theta_sq);
    const double cos_t = cos(theta), sin_t = sin(theta);
    const double inv_theta = 1.0 / theta;
    const double w[3] = {aa[0] * inv_theta, aa[1] * inv_theta,
                         aa[2] * inv_theta};
    const double wxp[3] = {w[1] * pt[2] - w[2] * pt[1],
                           w[2] * pt[0] - w[0] * pt[2],
                           w[0] * pt[1] - w[1] * pt[0]};
    const double wdp = w[0] * pt[0] + w[1] * pt[1] + w[2] * pt[2];
    for (int i = 0; i < 3; ++i)
      p[i] = pt[i] * cos_t + wxp[i] * sin_t + w[i] * wdp * (1.0 - cos_t);
  }
  for (int i = 0; i < 3; ++i) p[i] += c[3 + i];
  const double xp = -p[0] / p[2];
  const double yp = -p[1] / p[2];
  const double r2 = xp * xp + yp * yp;
  const double distortion = 1.0 + r2 * (c[7] + c[8] * r2);
  const double rx = c[6] * distortion * xp - obsx[row];
  const double ry = c[6] * distortion * yp - obsy[row];
  sq[row] = rx * rx + ry * ry;
}

}  // namespace

extern "C" int ceres_cost(const double* x, long e_slab, long f_slab,
                          const int* pt_idx, const int* cam_idx,
                          const double* obsx, const double* obsy, int n,
                          double* sq, cudaStream_t stream) {
  if (n <= 0) return 0;
  cost_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, e_slab, f_slab, pt_idx,
                                                   cam_idx, obsx, obsy, n, sq);
  return (int)cudaGetLastError();
}
