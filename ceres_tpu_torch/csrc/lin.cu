// K1: Snavely linearize with the point-side Grams, the e-scaled cross
// tensor and the camera-side block-diagonal Grams.
//
// Replaces ceres_tpu/ops/pallas_lin.py::_lin_kernel (with _fold_ftf_gf_mxu
// and the jet chain of ceres_tpu/ops/jetlib.py: _aa_rotate_jets,
// _snavely_residual_jets, _jet_planes). Same quantities, GPU layout:
//   ete [ne, 9]   E^T E per point, unscaled (row-major a*3+b)
//   ge  [ne, 3]   e gradient, unscaled
//   se  [ne, 3]   Jacobi scale: 1/(1+sqrt(diag E^T E)) when `first`,
//                 else the carried se_in (ones when scaling is off)
//   A   [ne, 3, nf]  e-scaled cross tensor (s_e E)^T F, nf = kf*9
//   ftf [kf, 81]  F^T F block diagonal, unscaled
//   gf  [kf, 9]   f gradient, unscaled
// Inputs in the Schur chunk layout [ne, k]: the camera of each lane as an
// int32 map (camera 0 on a masked lane), the mask, and the observations
// as dat [ne, k, 2] (observed_x, observed_y; 0 on a masked lane).
//
// Bound on the H100: bytes. A alone is ne*3*nf floats (38.2 MB at
// BAL-16-22106: 22,106 x 3 x 144 x 4 B), 0.0114 ms at 3.35 TB/s; the jet
// arithmetic and the epilogue (~2,500 operations a lane) are 0.003 ms at
// the f32 rate.
// Design: K1 is an instance of K5's kernel, csrc/lin_auto.cuh, with a
// hand-written chain (SnavelyK1Chain below: TE 3, TF 9, R 2, NT 12,
// cameras first, ND 2; snavely.cuh's jet chain) in place of a generated
// one, launched by lin_auto_launch behind ceres_lin: lane_kernel gives a
// thread to a lane and a block to 128 / k points, keeps each lane's terms
// in shared memory, sums the point-side terms in lane order from 0,
// writes each point's A rows once through a shared tile, zeros included
// (the wrapper does not zero A), with evict-first 16-byte stores, and
// streams the lanes' F-side terms to their rows in the camera-sorted
// order of ops/lin_auto.py camera_plan; ftf_partial_kernel and
// ftf_final_kernel sum them per 1,024-row chunk in row order, then the
// chunks in order. This replaces a thread a point that zeroed A, read and
// wrote it once a lane, rescaled it, and wrote each lane's F-side terms at
// the lane's stride for a reduction that scanned every row of a chunk for
// every output. A masked lane keeps K1's own rule, an all-zero camera
// (the TPU kernel's masked one-hot), not K5's fill from the point's first
// valid lane: the Snavely chain divides by 1 there, so its terms stay
// finite and the mask zeroes them. Every sum keeps the order of the
// kernel this replaces: point sums in lane order from +0, each A entry
// (0 + the lane's cross terms, in lane order) * se, the camera sums per
// chunk in row order (masked rows' +-0 terms, which the plan drops, move
// no bit of a sum that starts at +0), then the chunks in order. Shared
// memory, registers and times beside the bound: PERF.md section 6
// (scripts/time_kernels.py --only K1, cuobjdump -res-usage). No robust
// loss: ops/lin.py raises for one on the card (ROADMAP.md item 9).

#include <cuda_runtime.h>

#include "lin_auto.cuh"
#include "snavely.cuh"

namespace {

struct SnavelyK1Chain {
  static constexpr int TE = 3, TF = 9, R = 2, NT = TF + TE;
  static constexpr int EO = TF, FO = 0, ND = 2;
  static __device__ __forceinline__ void run(
      const float* __restrict__ xf_c, const float* __restrict__ xe_n,
      const float* __restrict__ d, const LossParams&, bool valid,
      float (&rv)[R], float (&J)[R][NT]) {
    // a masked lane sees an all-zero camera
    Jet<NT> cp[TF], pt[TE], r[R];
#pragma unroll
    for (int a = 0; a < TF; ++a) cp[a] = jvar<NT>(valid ? xf_c[a] : 0.f, a);
#pragma unroll
    for (int a = 0; a < TE; ++a) pt[a] = jvar<NT>(xe_n[a], TF + a);
    snavely_residual<NT>(cp, pt, valid, d[0], d[1], r);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      rv[s] = r[s].v;
#pragma unroll
      for (int t = 0; t < NT; ++t) J[s][t] = r[s].d[t];
    }
  }
};

}  // namespace

// The three launches of K1 on `stream`, with ceres_lin_auto's arguments
// (a generated K5 unit's entry point): lp_host and nlp, the loss's
// scalars, are passed on and unused (K1 takes no loss); pb points a block
// (ops/lin_auto.py lane_block(k, 3, 9)), pos [ne*k] and off [nchunks*kf
// + 1] the camera plan, q [nvalid, 54] and partial [nchunks, kf*54]
// scratch. Returns lin_auto_launch's code.
extern "C" int ceres_lin(const float* xf, const float* xe, const int* cam,
                         const float* mask, const float* dat,
                         const float* lp_host, int nlp, const float* se_in,
                         int first, int use_scaling, int ne, int k, int kf,
                         int pb, const int* pos, const int* off, int nchunks,
                         float* ete, float* ge, float* se_out, float* A,
                         float* q, float* partial, float* ftf, float* gf,
                         cudaStream_t stream) {
  return lin_auto_launch<SnavelyK1Chain>(
      xf, xe, cam, mask, dat, lp_host, nlp, se_in, first, use_scaling, ne, k,
      kf, pb, pos, off, nchunks, ete, ge, se_out, A, q, partial, ftf, gf,
      stream);
}
