"""Run a kernel header of ceres_tpu_torch/csrc on the host CPU.

The CPU has no nvcc and no card, but the generated kernels' indexing,
shared-memory layout and barriers can still be exercised: this module
compiles a header with the host g++ under a shim that stands in for the
CUDA qualifiers and runtime calls, and emulates each launch one block at
a time, one std::thread per CUDA thread, with a std::barrier as
__syncthreads. A warp's __shfl_down_sync and __shfl_xor_sync go through
exchange slots between two barriers of its 32 threads (__shfl_sync
from any source lane too), __syncwarp meets a warp's threads, and a bulk
copy on an mbarrier
(`bulk_load` / `bulk_wait`, which a source defines for the card unless
CUDA_HOST_EMU is set) is a copy by the issuing thread that then
releases the waiters; a source's cp.async helpers copy at once under
CUDA_HOST_EMU. Grids may be two-dimensional (dim3). The arithmetic is the host's (no FMA
contraction), so results are held to the plain versions within a
tolerance, not to the card's bits.

    exe = build(tmp_path, header_text, body, extra_source)
    outputs = run(exe, tmp_path, inputs, outputs)

`inputs` maps file names to numpy arrays (written raw); `body` is the C++
of main() between reading them (`float* NAME` / `int* NAME` pointers,
16-byte aligned) and writing the `outputs` (name -> (dtype, count)).
A source that includes other headers of csrc (csrc/lin.cu,
csrc/linearize.cu) goes in as `source(path)`, its includes inlined.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

SHIM = r"""#define CUDA_HOST_EMU 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <math.h>
#include <memory>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
using std::max;
using std::min;
struct emu_dim3 { unsigned x, y, z; };
thread_local emu_dim3 threadIdx, blockIdx;
emu_dim3 blockDim, gridDim;
std::barrier<>* emu_bar;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
// a warp's shuffle: each thread posts its value, the warp meets, reads
// its source lane's slot, and meets again before the slots are reused
std::vector<std::unique_ptr<std::barrier<>>> emu_warp_bar;
std::vector<float> emu_shfl;
inline float __shfl_down_sync(unsigned, float v, int off) {
  const unsigned t = threadIdx.x, lane = t & 31;
  std::barrier<>& bar = *emu_warp_bar[t >> 5];
  emu_shfl[t] = v;
  bar.arrive_and_wait();
  const float out = lane + off < 32 ? emu_shfl[t + off] : v;
  bar.arrive_and_wait();
  return out;
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const unsigned t = threadIdx.x;
  std::barrier<>& bar = *emu_warp_bar[t >> 5];
  emu_shfl[t] = v;
  bar.arrive_and_wait();
  const float out = emu_shfl[t ^ mask];
  bar.arrive_and_wait();
  return out;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const unsigned t = threadIdx.x;
  std::barrier<>& bar = *emu_warp_bar[t >> 5];
  emu_shfl[t] = v;
  bar.arrive_and_wait();
  const float out = emu_shfl[(t & ~31u) + (unsigned)src];
  bar.arrive_and_wait();
  return out;
}
inline void __syncwarp() { emu_warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
// round-to-nearest products and sums (the host compiles them without
// fused multiply-adds)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T>
inline T __ldcs(const T* p) { return *p; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
// cp.async.bulk on an mbarrier: the issuing thread arms the barrier,
// copies and releases it; a waiter spins until then
inline void bulk_load(float* dst, const float* src, unsigned bytes,
                      uint64_t* bar) {
  std::atomic_ref<uint64_t>(*bar).store(0, std::memory_order_relaxed);
  memcpy(dst, src, bytes);
  std::atomic_ref<uint64_t>(*bar).store(1, std::memory_order_release);
}
inline void bulk_wait(uint64_t* bar) {
  while (std::atomic_ref<uint64_t>(*bar).load(std::memory_order_acquire)
         == 0)
    std::this_thread::yield();
}
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct int2 { int x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
template <class T>
inline void __stcs(T* p, T v) { *p = v; }
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
alignas(16) float emu_smem[1 << 16];
size_t emu_smem_used = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an emulated card of 2 SMs, each holding one block: a persistent grid
// of 2 blocks, so that blocks take several tiles; a block may use all
// of the shim's shared memory
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? (int)sizeof(emu_smem)
                                                    : 2;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, unsigned block, size_t smem,
                cudaStream_t, A... args) {
  if (smem > sizeof(emu_smem)) abort();
  emu_smem_used = std::max(emu_smem_used, smem);
  blockDim = {block, 1, 1};
  gridDim = {grid.x, grid.y, 1};
  emu_shfl.assign(block, 0.f);
  emu_warp_bar.clear();
  for (unsigned w = 0; w < block; w += 32)
    emu_warp_bar.emplace_back(
        std::make_unique<std::barrier<>>(std::min(32u, block - w)));
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned b = 0; b < grid.x; ++b) {
      std::barrier<> bar(block);
      emu_bar = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block; ++t)
        ts.emplace_back([=] {
          blockIdx = {b, by, 0};
          threadIdx = {t, 0, 0};
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
template <class T>
T* emu_read(const char* name, size_t count) {
  T* p = (T*)aligned_alloc(16, ((count * sizeof(T) + 15) / 16 + 1) * 16);
  FILE* f = fopen(name, "rb");
  if (!f || fread(p, sizeof(T), count, f) != count) abort();
  fclose(f);
  return p;
}
template <class T>
T* emu_alloc(size_t count) {
  T* p = (T*)aligned_alloc(16, ((count * sizeof(T) + 15) / 16 + 1) * 16);
  memset(p, 0xff, ((count * sizeof(T) + 15) / 16 + 1) * 16);  // NaN
  return p;
}
template <class T>
void emu_write(const char* name, const T* p, size_t count) {
  FILE* f = fopen(name, "wb");
  if (!f || fwrite(p, sizeof(T), count, f) != count) abort();
  fclose(f);
}
"""

_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def host_header(text: str) -> str:
    """A kernel header rewritten for the shim: each launch
    `k<<<g, b, s, st>>>(args)` becomes `emu_launch(k, g, b, s, st, args)`
    and dynamic shared memory is the shim's buffer."""
    text = text.replace("extern __shared__ float4 smem4[];",
                        "float4* smem4 = (float4*)emu_smem;")
    text = text.replace("#include <cuda_runtime.h>", "")
    return _LAUNCH.sub(lambda m: f"emu_launch({m.group(1)}, "
                       f"{' '.join(m.group(2).split())}, ", text)


_INCLUDE = re.compile(r'^#include "([\w.]+)"\s*$', re.M)


def source(path, seen=None) -> str:
    """The text of a csrc file with its `#include "..."` of files beside
    it inlined, each once (as #pragma once would)."""
    path = Path(path)
    seen = set() if seen is None else seen

    def inline(m):
        dep = path.parent / m.group(1)
        if dep in seen:
            return ""
        seen.add(dep)
        return source(dep, seen)
    return _INCLUDE.sub(inline, path.read_text())


def gxx():
    return shutil.which("g++")


def build(tmp_path, header: str, body: str, extra: str = ""):
    """Compile the shim, the rewritten header, `extra` (the generated
    chain struct) and main() around `body`."""
    src = tmp_path / "emu.cpp"
    src.write_text(SHIM + host_header(header) + "\n" + extra + "\n"
                   + "int main() {\n" + body + "\n  return 0;\n}\n")
    exe = tmp_path / "emu"
    subprocess.run([gxx(), "-O1", "-std=c++20", "-pthread", "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    return exe


def run(exe, tmp_path, inputs: dict, outputs: dict) -> dict:
    """Write `inputs`, run the program in tmp_path, read `outputs`."""
    for name, arr in inputs.items():
        np.ascontiguousarray(arr).tofile(tmp_path / name)
    proc = subprocess.run([str(exe)], cwd=tmp_path, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"emulated kernel failed ({proc.returncode}): "
                           f"{proc.stdout}{proc.stderr}")
    return {name: np.fromfile(tmp_path / name, dtype=dtype, count=count)
            for name, (dtype, count) in outputs.items()}
