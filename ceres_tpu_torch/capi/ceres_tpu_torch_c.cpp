// Embedded-interpreter shim implementing ceres_tpu_torch_c.h.
//
// The role of the reference's internal/ceres/c_api.cc (a thin C wrapper over
// the C++ library), re-targeted as ceres_tpu/capi/ceres_tpu_c.cpp is: the
// "library" here is the Python package ceres_tpu_torch, so the shim hosts a
// CPython interpreter and forwards every call to ceres_tpu_torch.c_api,
// passing raw pointers as integers. Stock loss functions are evaluated
// natively (no interpreter round trip). ceres_solve runs on the CUDA card,
// or on the CPU when CERES_TPU_TORCH_DEVICE is "cpu".
//
// Build (ceres_tpu_torch.capi.build() does this into ceres_tpu_torch/_build/):
//   g++ -O2 -shared -fPIC $(python3-config --includes) \
//       ceres_tpu_torch_c.cpp -o libceres_tpu_torch_c.so \
//       $(python3-config --embed --ldflags)

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>

#include "ceres_tpu_torch_c.h"

namespace {

PyObject* g_mod = nullptr;  // ceres_tpu_torch.c_api

bool EnsurePython() {
  if (g_mod) return true;
  if (!Py_IsInitialized()) {
    Py_Initialize();
    // Release the GIL the initializing thread implicitly holds:
    // otherwise any API call from a DIFFERENT thread deadlocks inside
    // PyGILState_Ensure (Py_Initialize leaves the caller owning it).
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  g_mod = PyImport_ImportModule("ceres_tpu_torch.c_api");
  if (!g_mod) PyErr_Print();
  PyGILState_Release(gil);
  return g_mod != nullptr;
}

// NOTE: `args` must be built while HOLDING the GIL. PyGILState_Ensure is
// reentrant, so wrappers take the GIL, build args, and call this.
long long CallLL(const char* fn, PyObject* args) {
  PyGILState_STATE gil = PyGILState_Ensure();
  long long out = -1;
  PyObject* f = PyObject_GetAttrString(g_mod, fn);
  if (f) {
    PyObject* r = PyObject_CallObject(f, args);
    if (r) {
      out = PyLong_AsLongLong(r);
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
    Py_DECREF(f);
  } else {
    // report and CLEAR the AttributeError: leaving an exception pending
    // poisons the next unrelated Python C-API call
    PyErr_Print();
  }
  Py_XDECREF(args);
  PyGILState_Release(gil);
  return out;
}

}  // namespace

extern "C" {

int ceres_init(void) { return EnsurePython() ? 0 : 1; }

ceres_problem_t* ceres_create_problem(void) {
  if (!EnsurePython()) return nullptr;
  // build the argument tuple under the GIL (argument expressions run
  // BEFORE the callee's PyGILState_Ensure)
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = PyTuple_New(0);
  long long pid = CallLL("create_problem", args);
  PyGILState_Release(gil);
  return reinterpret_cast<ceres_problem_t*>(static_cast<intptr_t>(pid));
}

void ceres_free_problem(ceres_problem_t* problem) {
  if (!EnsurePython()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_BuildValue("(L)", (long long)(intptr_t)problem);
  CallLL("free_problem", args);
  PyGILState_Release(gil);
}

ceres_residual_block_id_t* ceres_problem_add_residual_block(
    ceres_problem_t* problem, ceres_cost_function_t cost_function,
    void* cost_function_data, ceres_loss_function_t loss_function,
    void* loss_function_data, int num_residuals, int num_parameter_blocks,
    int* parameter_block_sizes, double** parameters) {
  if (!EnsurePython()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* sizes = PyList_New(num_parameter_blocks);
  PyObject* ptrs = PyList_New(num_parameter_blocks);
  for (int i = 0; i < num_parameter_blocks; ++i) {
    PyList_SetItem(sizes, i, PyLong_FromLong(parameter_block_sizes[i]));
    PyList_SetItem(
        ptrs, i, PyLong_FromLongLong((long long)(intptr_t)parameters[i]));
  }
  PyObject* args = Py_BuildValue(
      "(LLLLLiOO)", (long long)(intptr_t)problem,
      (long long)(intptr_t)cost_function,
      (long long)(intptr_t)cost_function_data,
      (long long)(intptr_t)loss_function,
      (long long)(intptr_t)loss_function_data, num_residuals, sizes, ptrs);
  Py_DECREF(sizes);
  Py_DECREF(ptrs);
  PyGILState_Release(gil);
  long long rb = CallLL("add_residual_block", args);
  return reinterpret_cast<ceres_residual_block_id_t*>(
      static_cast<intptr_t>(rb));
}

void ceres_solve(ceres_problem_t* problem) {
  if (!EnsurePython()) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* f = PyObject_GetAttrString(g_mod, "solve");
  if (f) {
    // the C counterpart of SolverOptions.device: the card unless asked
    const char* dev = std::getenv("CERES_TPU_TORCH_DEVICE");
    PyObject* r = PyObject_CallFunction(
        f, "Lis", (long long)(intptr_t)problem, 50,
        (dev != nullptr && dev[0] != '\0') ? dev : "cuda");
    if (r) {
      if (PyUnicode_Check(r)) printf("%s\n", PyUnicode_AsUTF8(r));
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
    Py_DECREF(f);
  }
  PyGILState_Release(gil);
}

// ------------------------------------------------------------- stock losses
// Evaluated natively (c_api.cc keeps these in C++ too). rho triples follow
// loss_function.cc.

enum StockLossType { kHuber, kSoftL1, kCauchy, kArctan, kTolerant };

struct StockLoss {
  StockLossType type;
  double a, b;
};

void* ceres_create_huber_loss_function_data(double a) {
  return new StockLoss{kHuber, a, a * a};
}
void* ceres_create_softl1_loss_function_data(double a) {
  return new StockLoss{kSoftL1, a, a * a};
}
void* ceres_create_cauchy_loss_function_data(double a) {
  return new StockLoss{kCauchy, a, a * a};
}
void* ceres_create_arctan_loss_function_data(double a) {
  return new StockLoss{kArctan, a, 1.0 / (a * a)};
}
void* ceres_create_tolerant_loss_function_data(double a, double b) {
  return new StockLoss{kTolerant, a, b};
}
void ceres_free_stock_loss_function_data(void* loss_function_data) {
  delete static_cast<StockLoss*>(loss_function_data);
}

void ceres_stock_loss_function(void* user_data, double s, double out[3]) {
  const StockLoss* l = static_cast<StockLoss*>(user_data);
  switch (l->type) {
    case kHuber:
      if (s > l->b) {
        const double r = std::sqrt(s);
        out[0] = 2.0 * l->a * r - l->b;
        out[1] = l->a / r;
        out[2] = -out[1] / (2.0 * s);
      } else {
        out[0] = s;
        out[1] = 1.0;
        out[2] = 0.0;
      }
      break;
    case kSoftL1: {
      const double sum = 1.0 + s / l->b;
      const double tmp = std::sqrt(sum);
      out[0] = 2.0 * l->b * (tmp - 1.0);
      out[1] = 1.0 / tmp;
      out[2] = -out[1] / (2.0 * sum * l->b);
      break;
    }
    case kCauchy: {
      const double sum = 1.0 + s / l->b;
      const double inv = 1.0 / sum;
      out[0] = l->b * std::log(sum);
      out[1] = inv;
      out[2] = -inv * inv / l->b;
      break;
    }
    case kArctan: {
      // rho(s) = a atan(s/a); b = 1/a^2.
      const double inv = 1.0 / (1.0 + s * s * l->b);
      out[0] = l->a * std::atan2(s, l->a);
      out[1] = inv;
      out[2] = -2.0 * s * l->b * inv * inv;
      break;
    }
    case kTolerant: {
      const double x = (s - l->a) / l->b;
      // log(1 + exp(x)) stabilized; c = b log(1 + exp(-a/b)) offset.
      const double c = l->b * std::log1p(std::exp(-l->a / l->b));
      double e;
      if (x > 30.0) {
        out[0] = l->b * x - c;
        out[1] = 1.0;
        out[2] = 0.0;
      } else {
        e = std::exp(x);
        out[0] = l->b * std::log1p(e) - c;
        out[1] = e / (1.0 + e);
        out[2] = out[1] * (1.0 - out[1]) / l->b;
      }
      break;
    }
  }
}

}  // extern "C"
