// K2 and K6 at point blocks of 3 (csrc/elim.cuh): a unit of its own,
// so that nvcc builds the point sizes in parallel.

#include "elim.cuh"

cudaError_t elim_units::launch_te3(CERES_ELIM_PARAMS) {
  return k2 ? elim_launch<3, true>(CERES_ELIM_ARGS)
            : elim_launch<3, false>(CERES_ELIM_ARGS);
}
