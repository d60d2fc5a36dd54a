#!/usr/bin/env python3
"""Variants of K4 on the card: whether the camera's rotation should be
taken once per camera, where such a camera table should live, and how
far the rows are from their loads and store.

    python3 scripts/k4_variants.py

Builds csrc/cost.cu as it ships ("shipped": one kernel, a thread a row,
each row taking its camera's square root, f64 cos and sin and 1 / theta
itself) and TWO_PHASE below, the form that takes them once per camera
("camera table": a camera kernel in blocks of 32 threads writes each
camera's theta^2, w, cos, sin, 1 - cos and other six parameters as one
112-byte row of a table in global memory, then the row kernel reads it
through L2 and L1; the same operations in the same order, so the same
bits), and variants of TWO_PHASE, each from its text with one change:
"programmatic launch" makes the row kernel a programmatic dependent
launch (Hopper), which starts while the camera kernel runs and waits for
the table only after its row loads are issued; "camera blocks of 128"
runs the camera kernel in blocks of 128 threads (on fewer SMs); the
others replace its row kernel and entry point: "table in shared memory"
copies the camera table into each block's shared memory before its rows
(a persistent grid of 512-thread blocks, as many as fit the card); "one
launch" lets every block of such a grid compute the whole camera table
into its shared memory itself (no camera kernel); "trigonometry per row"
takes each row's camera phase in the row itself through the table
form's code (no table); "loads and store only" sums each row's loads
(its point, its camera's table row, its observations) instead of
evaluating the residual, the floor of the row phase's memory traffic.
Each runs through its entry point ceres_cost on scripts/time_kernels.py's
K4 cases (BAL-16-22106: 83,718 rows, 16 cameras; the large case: 1M
rows, 1,024 cameras); prints one JSON line a variant and case: its
device time a call by kernel and the device span a call, first kernel
start to last kernel end (torch.profiler over 100 calls; with a
programmatic launch the kernels overlap, so the span, not the sum, is
the call's time), and whether sq holds the shipped kernel's bits (the
loads-only variant does not),
and one line of each variant's registers, stack and spills (cuobjdump
-res-usage). Needs a CUDA device.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K4 with the camera's rotation taken once per camera: a camera kernel
# writes a table of [kf, TAB] f64, the row kernel reads it
TWO_PHASE = r"""#include <cuda_runtime.h>
#include <math.h>

namespace {

// a camera's table row: w (aa in the small-angle branch), cos, sin,
// 1 - cos, translation, f, k1, k2, theta^2, 1 unused; 112 bytes, so
// that the rows of different cameras fall in different banks of L1
// (a row of 128 bytes put every camera's entry i in one bank, and a
// warp's gather of 32 cameras then took 32 passes)
constexpr int TAB = 14;

// camera phase: camera c's table row from its nine parameters
__device__ __forceinline__ void camera_row(const double* c, double* out) {
  const double aa[3] = {c[0], c[1], c[2]};
  const double theta_sq = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  double w[3] = {aa[0], aa[1], aa[2]};
  double cos_t = 0.0, sin_t = 0.0, omc = 0.0;
  if (!(theta_sq < 1e-12)) {
    const double theta = sqrt(theta_sq);
    cos_t = cos(theta);
    sin_t = sin(theta);
    const double inv_theta = 1.0 / theta;
    for (int i = 0; i < 3; ++i) w[i] = aa[i] * inv_theta;
    omc = 1.0 - cos_t;
  }
  for (int i = 0; i < 3; ++i) out[i] = w[i];
  out[3] = cos_t;
  out[4] = sin_t;
  out[5] = omc;
  for (int i = 0; i < 6; ++i) out[6 + i] = c[3 + i];
  out[12] = theta_sq;
  out[13] = 0.0;
}

// row phase: ||r||^2 of the observation (ox, oy) of point pt by the
// camera whose table row (16-byte aligned) is tab, read as seven 16-byte
// loads
__device__ __forceinline__ double row_sq(const double pt[3],
                                         const double* tab, double ox,
                                         double oy) {
  double c[TAB];
  const double2* tab2 = reinterpret_cast<const double2*>(tab);
  for (int i = 0; i < TAB / 2; ++i) {
    const double2 v = tab2[i];
    c[2 * i] = v.x;
    c[2 * i + 1] = v.y;
  }
  const double w[3] = {c[0], c[1], c[2]};
  double p[3];
  if (c[12] < 1e-12) {              // w holds aa
    p[0] = pt[0] + (w[1] * pt[2] - w[2] * pt[1]);
    p[1] = pt[1] + (w[2] * pt[0] - w[0] * pt[2]);
    p[2] = pt[2] + (w[0] * pt[1] - w[1] * pt[0]);
  } else {
    const double cos_t = c[3], sin_t = c[4], omc = c[5];
    const double wxp[3] = {w[1] * pt[2] - w[2] * pt[1],
                           w[2] * pt[0] - w[0] * pt[2],
                           w[0] * pt[1] - w[1] * pt[0]};
    const double wdp = w[0] * pt[0] + w[1] * pt[1] + w[2] * pt[2];
    for (int i = 0; i < 3; ++i)
      p[i] = pt[i] * cos_t + wxp[i] * sin_t + w[i] * wdp * omc;
  }
  for (int i = 0; i < 3; ++i) p[i] += c[6 + i];
  const double xp = -p[0] / p[2];
  const double yp = -p[1] / p[2];
  const double r2 = xp * xp + yp * yp;
  const double distortion = 1.0 + r2 * (c[10] + c[11] * r2);
  const double rx = c[9] * distortion * xp - ox;
  const double ry = c[9] * distortion * yp - oy;
  return rx * rx + ry * ry;
}

__global__ void cost_camera_kernel(const double* __restrict__ x,
                                   long f_slab, int kf,
                                   double* __restrict__ table) {
  const int cam = blockIdx.x * blockDim.x + threadIdx.x;
  if (cam >= kf) return;
  camera_row(x + f_slab + 9L * cam, table + (long)TAB * cam);
}

__global__ void cost_row_kernel(const double* __restrict__ x, long e_slab,
                                const double* __restrict__ table,
                                const int* __restrict__ pt_idx,
                                const int* __restrict__ cam_idx,
                                const double* __restrict__ obsx,
                                const double* __restrict__ obsy, int n,
                                double* __restrict__ sq) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const double* q = x + e_slab + 3L * pt_idx[row];
  const double pt[3] = {q[0], q[1], q[2]};
  const long cam = (long)TAB * cam_idx[row];
  sq[row] = row_sq(pt, table + cam, obsx[row], obsy[row]);
}

}  // namespace

extern "C" int ceres_cost(const double* x, long e_slab, long f_slab, int kf,
                          const int* pt_idx, const int* cam_idx,
                          const double* obsx, const double* obsy, int n,
                          double* table, double* sq, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (kf <= 0) return (int)cudaErrorInvalidValue;
  cost_camera_kernel<<<(kf + 31) / 32, 32, 0, stream>>>(x, f_slab, kf, table);
  cost_row_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      x, e_slab, table, pt_idx, cam_idx, obsx, obsy, n, sq);
  return (int)cudaGetLastError();
}
"""
_TWO_PHASE_SIGNATURE = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                        ctypes.c_int] + [ctypes.c_void_p] * 4 + [
                            ctypes.c_int] + [ctypes.c_void_p] * 3
# f64 entries of a camera's table row in TWO_PHASE
TAB = 14

_ARGS = ("const double* x, long e_slab, long f_slab, int kf, "
         "const int* pt_idx, const int* cam_idx, const double* obsx, "
         "const double* obsy, int n, double* table, double* sq, "
         "cudaStream_t stream")
_GRID = """  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(cost_row_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cost_row_kernel,
                                                512, smem);
  int grid = (n + 511) / 512;
  if (grid > sms * per_sm) grid = sms * per_sm;
"""
# the shared-memory row kernel: table rows from `table` or computed here
_SMEM_ROWS = """__global__ void cost_row_kernel(
    const double* __restrict__ x, long e_slab, long f_slab, int kf,
    const double* __restrict__ table, const int* __restrict__ pt_idx,
    const int* __restrict__ cam_idx, const double* __restrict__ obsx,
    const double* __restrict__ obsy, int n, double* __restrict__ sq) {
  extern __shared__ double2 stab2[];
  double* stab = reinterpret_cast<double*>(stab2);
  FILL
  __syncthreads();
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += gridDim.x * blockDim.x) {
    const double* q = x + e_slab + 3L * pt_idx[row];
    const double pt[3] = {q[0], q[1], q[2]};
    sq[row] = row_sq(pt, stab + TAB * cam_idx[row], obsx[row], obsy[row]);
  }
}

}  // namespace

extern "C" int ceres_cost(ARGS) {
  if (n <= 0) return 0;
  if (kf <= 0) return (int)cudaErrorInvalidValue;
  CAMERAS
  const int smem = kf * TAB * 8;
GRID  cost_row_kernel<<<grid, 512, smem, stream>>>(
      x, e_slab, f_slab, kf, table, pt_idx, cam_idx, obsx, obsy, n, sq);
  return (int)cudaGetLastError();
}
"""
_COPY = ("for (int i = threadIdx.x; i < kf * TAB; i += blockDim.x) "
         "stab[i] = table[i];")
_COMPUTE = ("for (int c = threadIdx.x; c < kf; c += blockDim.x) "
            "camera_row(x + f_slab + 9L * c, stab + TAB * c);")
_CAMERA_LAUNCH = ("cost_camera_kernel<<<(kf + 31) / 32, 32, 0, "
                  "stream>>>(x, f_slab, kf, table);")
_PER_ROW = """__global__ void cost_row_kernel(
    const double* __restrict__ x, long e_slab, long f_slab,
    const int* __restrict__ pt_idx, const int* __restrict__ cam_idx,
    const double* __restrict__ obsx, const double* __restrict__ obsy, int n,
    double* __restrict__ sq) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  alignas(16) double c[TAB];
  camera_row(x + f_slab + 9L * cam_idx[row], c);
  const double* q = x + e_slab + 3L * pt_idx[row];
  const double pt[3] = {q[0], q[1], q[2]};
  sq[row] = row_sq(pt, c, obsx[row], obsy[row]);
}

}  // namespace

extern "C" int ceres_cost(ARGS) {
  if (n <= 0) return 0;
  if (kf <= 0) return (int)cudaErrorInvalidValue;
  cost_row_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      x, e_slab, f_slab, pt_idx, cam_idx, obsx, obsy, n, sq);
  return (int)cudaGetLastError();
}
"""
_LOADS_ONLY = """__device__ __forceinline__ double loads_only(const double pt[3],
                                             const double* tab, double ox,
                                             double oy) {
  double s = pt[0] + pt[1] + pt[2] + ox + oy;
  const double2* tab2 = reinterpret_cast<const double2*>(tab);
  for (int i = 0; i < TAB / 2; ++i) s += tab2[i].x + tab2[i].y;
  return s;
}

__global__ void cost_row_kernel("""


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"k4_variants: the source no longer holds {old!r}")
    return text.replace(old, new)


def programmatic(src):
    """The row kernel as a programmatic dependent launch (Hopper): the
    camera kernel lets it start at once, and it waits for the table
    (griddepcontrol.wait) only after its row loads are issued."""
    v = replace_once(
        src, "  const int cam = blockIdx.x * blockDim.x + threadIdx.x;\n",
        "  asm volatile(\"griddepcontrol.launch_dependents;\");\n"
        "  const int cam = blockIdx.x * blockDim.x + threadIdx.x;\n")
    v = replace_once(
        v, "  sq[row] = row_sq(pt, table + cam, obsx[row], obsy[row]);",
        "  const double ox = obsx[row], oy = obsy[row];\n"
        "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
        "  sq[row] = row_sq(pt, table + cam, ox, oy);")
    return replace_once(
        v, """  cost_row_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      x, e_slab, table, pt_idx, cam_idx, obsx, obsy, n, sq);""",
        """  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cost_row_kernel, x, e_slab, (const double*)table, pt_idx,
      cam_idx, obsx, obsy, n, sq);
  if (err != cudaSuccess) return (int)err;""")


def variants(src):
    """(name, source text) of each variant of the two-phase form src."""
    tail = src[src.index("__global__ void cost_row_kernel("):]
    head = src[:len(src) - len(tail)]

    def smem(fill, cameras):
        return head + (_SMEM_ROWS.replace("FILL", fill)
                       .replace("CAMERAS", cameras).replace("ARGS", _ARGS)
                       .replace("GRID", _GRID))
    loads = replace_once(src, "__global__ void cost_row_kernel(", _LOADS_ONLY)
    loads = replace_once(loads, "sq[row] = row_sq(pt,",
                         "sq[row] = loads_only(pt,")
    return [("camera table", src),
            ("programmatic launch", programmatic(src)),
            ("camera blocks of 128", replace_once(
                src, "<<<(kf + 31) / 32, 32, 0, stream>>>",
                "<<<(kf + 127) / 128, 128, 0, stream>>>")),
            ("table in shared memory", smem(_COPY, _CAMERA_LAUNCH)),
            ("one launch", smem(_COMPUTE, "")),
            ("trigonometry per row", head + _PER_ROW.replace("ARGS", _ARGS)),
            ("loads and store only", loads)]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from time_kernels import (device_span_us, k4_cases, kernel_us,
                              res_usage, short_name)
    from ceres_tpu_torch.ops import _cuda
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    cases = k4_cases()
    shipped = {}
    for name, text in ([("shipped", (_cuda.CSRC / "cost.cu").read_text())]
                       + variants(TWO_PHASE)):
        lib = _cuda.build_generated("k4variant", text)
        fn = lib.ceres_cost
        fn.argtypes = (_cuda._SIGNATURES["ceres_cost"] if name == "shipped"
                       else _TWO_PHASE_SIGNATURE)
        fn.restype = ctypes.c_int
        for case, x, (cost,) in cases:
            table = torch.empty(cost.kf, TAB, dtype=torch.float64,
                                device="cuda")

            def call():
                sq = torch.empty(cost.n, dtype=torch.float64, device="cuda")
                if name == "shipped":
                    _cuda.call(fn, "ceres_cost", x, cost.e_slab,
                               cost.f_slab, cost.pt_idx, cost.cam_idx,
                               cost.obsx, cost.obsy, cost.n, sq)
                else:
                    _cuda.call(fn, "ceres_cost", x, cost.e_slab,
                               cost.f_slab, cost.kf, cost.pt_idx,
                               cost.cam_idx, cost.obsx, cost.obsy, cost.n,
                               table, sq)
                return sq
            got = call()
            torch.cuda.synchronize()
            ref = shipped.setdefault(case, got)
            by_kernel = kernel_us(call)
            print(json.dumps({
                "variant": name, "case": case,
                "device_us": sum(by_kernel.values()),
                "device_us_by_kernel": {short_name(k): t
                                        for k, t in by_kernel.items()},
                "device_span_us": device_span_us(call),
                "shipped_bits": torch.equal(got, ref)}), flush=True)
        path = next(p for p in _cuda._generated
                    if _cuda._generated[p] is lib)
        print(json.dumps({"variant": name, "registers": {
            short_name(k): v.split(" CONSTANT")[0]
            for k, v in res_usage(path).items()}}), flush=True)


if __name__ == "__main__":
    main()
