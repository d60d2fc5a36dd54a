// K2 and K6 (csrc/elim.cuh): the entry points, which pick the unit of
// the call's point size (elim_te<N>.cu).

#include "elim.cuh"

namespace {

cudaError_t launch(int te, CERES_ELIM_PARAMS) {
  switch (te) {
    case 1: return elim_units::launch_te1(k2, CERES_ELIM_ARGS);
    case 2: return elim_units::launch_te2(k2, CERES_ELIM_ARGS);
    case 3: return elim_units::launch_te3(k2, CERES_ELIM_ARGS);
    case 4: return elim_units::launch_te4(k2, CERES_ELIM_ARGS);
    case 5: return elim_units::launch_te5(k2, CERES_ELIM_ARGS);
    case 6: return elim_units::launch_te6(k2, CERES_ELIM_ARGS);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// plan: R, nt, splits, pts and smem (bytes) from ops/lin.py elim_plan;
// scratch: part [splits, pairs, NACC, 256], rpart [splits, nf]. K2 takes
// te 1 to 3, K6 te 1 to MAX_TE.
extern "C" int ceres_elim(const float* A, const float* etes, const float* gse,
                          const float* diag, float rad, int te, int ne,
                          int nf, int R, int nt, int splits, int pts,
                          int smem, float* scorr, float* rhs, float* inv,
                          float* z, float* part, float* rpart,
                          cudaStream_t stream) {
  if (te < 1 || te > 3) return (int)cudaErrorInvalidValue;
  return (int)launch(te, true, A, etes, gse, diag, rad, ne, nf, R, nt, splits,
                     pts, smem, inv, z, part, rpart, scorr, rhs, stream);
}

extern "C" int ceres_elim_v1(const float* A, const float* inv, const float* z,
                             int te, int ne, int nf, int R, int nt,
                             int splits, int pts, int smem, float* scorr,
                             float* rhs, float* part, float* rpart,
                             cudaStream_t stream) {
  return (int)launch(te, false, A, inv, z, nullptr, 1.f, ne, nf, R, nt,
                     splits, pts, smem, nullptr, nullptr, part, rpart, scorr,
                     rhs, stream);
}
