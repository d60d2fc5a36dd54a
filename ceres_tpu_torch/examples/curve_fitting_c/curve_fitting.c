/* Exponential curve fitting through the C API of ceres_tpu_torch: the
 * reference's examples/curve_fitting.c workload (as
 * ceres_tpu/examples/curve_fitting_c/curve_fitting.c runs it): fit
 * y = exp(m x + c) to noisy samples with an analytic-derivative C cost
 * function and a Cauchy robust loss. Prints m and c to 17 digits.
 *
 * Build and run (from the repo root; LIB is the directory of the shim that
 * python3 -c "import ceres_tpu_torch.capi as c; print(c.build())" builds):
 *   gcc -O2 ceres_tpu_torch/examples/curve_fitting_c/curve_fitting.c \
 *       -Iceres_tpu_torch/capi -L$LIB -lceres_tpu_torch_c \
 *       -Wl,-rpath,$LIB -o curve_fitting_c -lm
 *   PYTHONPATH=$PWD ./curve_fitting_c          (on the CUDA card)
 *   CERES_TPU_TORCH_DEVICE=cpu PYTHONPATH=$PWD ./curve_fitting_c
 */
#include <math.h>
#include <stdio.h>

#include "ceres_tpu_torch_c.h"

/* y = exp(0.3 x + 0.1) + noise, 30 samples over [0, 5]. */
#define NUM_OBSERVATIONS 30
static double data[2 * NUM_OBSERVATIONS];

static void make_data(void) {
  int i;
  unsigned int state = 12345u;
  for (i = 0; i < NUM_OBSERVATIONS; ++i) {
    double x = 5.0 * i / (NUM_OBSERVATIONS - 1);
    /* cheap LCG noise in [-0.05, 0.05] */
    state = state * 1664525u + 1013904223u;
    double noise = ((state >> 8) % 1000) / 10000.0 - 0.05;
    data[2 * i] = x;
    data[2 * i + 1] = exp(0.3 * x + 0.1) + noise;
  }
}

static int exponential_residual(void* user_data, double** parameters,
                                double* residuals, double** jacobians) {
  const double* measurement = (const double*)user_data;
  const double x = measurement[0];
  const double y = measurement[1];
  const double m = parameters[0][0];
  const double c = parameters[1][0];
  const double e = exp(m * x + c);

  residuals[0] = y - e;
  if (jacobians == NULL) return 1;
  if (jacobians[0] != NULL) jacobians[0][0] = -x * e; /* dr/dm */
  if (jacobians[1] != NULL) jacobians[1][0] = -e;     /* dr/dc */
  return 1;
}

int main(void) {
  double m = 0.0;
  double c = 0.0;
  double* parameter_pointers[] = {&m, &c};
  int parameter_sizes[] = {1, 1};
  int i;
  ceres_problem_t* problem;
  void* cauchy = NULL;

  if (ceres_init() != 0) {
    fprintf(stderr, "ceres_init failed\n");
    return 1;
  }
  make_data();
  problem = ceres_create_problem();
  cauchy = ceres_create_cauchy_loss_function_data(0.5);
  for (i = 0; i < NUM_OBSERVATIONS; ++i) {
    ceres_problem_add_residual_block(
        problem, exponential_residual, &data[2 * i],
        ceres_stock_loss_function, cauchy,
        1, 2, parameter_sizes, parameter_pointers);
  }
  ceres_solve(problem);
  ceres_free_stock_loss_function_data(cauchy);
  ceres_free_problem(problem);

  printf("Final m: %.17g, c: %.17g\n", m, c);
  /* success criterion for the test harness */
  if (fabs(m - 0.3) < 0.02 && fabs(c - 0.1) < 0.05) {
    printf("CURVE_FITTING_C_OK\n");
    return 0;
  }
  return 2;
}
