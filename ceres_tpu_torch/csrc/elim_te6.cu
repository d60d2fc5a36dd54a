// K2 and K6 at point blocks of 6 (csrc/elim.cuh): a unit of its own,
// so that nvcc builds the point sizes in parallel.

#include "elim.cuh"

cudaError_t elim_units::launch_te6(CERES_ELIM_PARAMS) {
  return k2 ? cudaErrorInvalidValue  // K2 takes te <= 3
            : elim_launch<6, false>(CERES_ELIM_ARGS);
}
