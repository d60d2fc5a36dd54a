#!/usr/bin/env python3
"""Variants of K7 (csrc/pcg.cu, the whole PCG solve) on the card: where
its time goes, with no profiler of the kernel's inside.

    python3 scripts/k7_variants.py [--source PATH]

Builds a K7 source (default: this checkout's csrc/pcg.cu; the first
design, which copied S into shared memory and walked a warp's rows one
after another, `git show a21f075:ceres_tpu_torch/csrc/pcg.cu`, has its
own variants)
as it is and with one phase changed or left out, each through its entry
point ceres_pcg, on every K7 system of scripts/time_kernels.py
k7_systems (the 7 angle-axis and 18 quaternion systems of the
ITERATIVE_SCHUR solves). Every variant but "as built" runs each system
for exactly the iterations that the source as built takes on it (its
stop test then never ends the loop early), so that times compare:

- "as built": the source unchanged;
- "fixed count": only the loop's stop made a count (its y must keep
  the bits of "as built");
- "copy only": the start of the kernel up to the first barrier (the
  first design: S and the preconditioner blocks copied into shared
  memory; the shipped one: S and the preconditioner row loaded into
  registers, then summed so that no load is dead), then y written and
  nothing else;
- "no matvec": the products S p and S x replaced by copies of p and
  b - x (the first design) or by one store a row (the shipped one, whose
  loads of S then go dead too): the iteration's barriers, dots and
  updates alone;
- "matvec only": each iteration the product S p and its barrier alone
  (p then never changes, and the compiler may hoist part of the
  product out of the loop: a lower bound);
- "empty": the launch with the same shared memory, no work;
- (the first design) "S in global memory": S read from L2 in every
  product instead of copied first.

Prints the card's name and power limit, then one JSON line a variant
and problem: its device time a call on each system (torch.profiler over
100 calls), the time at 0 iterations and a CG iteration fitted over the
systems, and whether y holds the bits of "as built"; then each kernel's
registers, stack and spills (cuobjdump -res-usage) and, for the source
as built, `nvcc -Xptxas -v`'s lines. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"k7_variants: the source no longer holds {old!r}")
    return text.replace(old, new)


# the first design: the loop's stop, the copy, the products
FIRST_STOP = "    done = bad || q_done;"
FIRST_COPIED = "    r[i] = b[i];\n  }\n  __syncthreads();\n"
FIRST_MATVEC = "    matvec(S, p, nullptr, Ap, m);\n    __syncthreads();\n"
FIRST_REFRESH = "      matvec(S, x, bs, r, m);"
FIRST_BODY = "  extern __shared__ float smem[];\n  const int tid = threadIdx.x;\n"
FIRST_S_SMEM = "  const int s_in_smem = used + sbytes <= (size_t)optin;"

# the shipped design: the same phases, marked in the source
NEW_STOP = "    done = bad || q_done;"
NEW_LOADED = "  // -- S loaded: the start phase --\n"
NEW_MATVEC = ("    matvec<RW, CL>(src, v, nullptr, Ap, m, warp, lane);"
              "  // S p\n")
NEW_REFRESH = ("      matvec<RW, CL>(src, xv, b, rn, m, warp, lane);"
               "  // b - S x\n")
NEW_AFTER_MATVEC = "    __syncthreads();  // (1) Ap complete\n"
NEW_BODY = "  // -- the kernel's body --\n"

FIXED = "    done = (bad || q_done) && max_it < 0;"
EMPTY = ("  if (threadIdx.x == 0) {\n    *iters = 0;\n    *norm = 0.f;\n  }\n"
         "  return;\n")


def variants(src):
    """(name, source text) of each variant of `src`."""
    if FIRST_BODY in src:
        fixed = replace_once(src, FIRST_STOP, FIXED)
        return [
            ("as built", src),
            ("fixed count", fixed),
            ("copy only", replace_once(
                src, FIRST_COPIED, FIRST_COPIED
                + "  for (int i = tid; i < m; i += THREADS)\n"
                  "    y[i] = S[(size_t)i * m + i] + bs[i];\n" + EMPTY)),
            ("no matvec", replace_once(replace_once(
                fixed, FIRST_MATVEC,
                "    for (int i = tid; i < m; i += THREADS) Ap[i] = p[i];\n"
                "    __syncthreads();\n"), FIRST_REFRESH,
                "      for (int i = tid; i < m; i += THREADS)\n"
                "        r[i] = bs[i] - x[i];")),
            ("matvec only", replace_once(
                fixed, FIRST_MATVEC,
                FIRST_MATVEC + "    if (max_it >= 0) {\n      ++it;\n"
                "      continue;\n    }\n")),
            ("empty", replace_once(src, FIRST_BODY, FIRST_BODY + EMPTY)),
            ("S in global memory", replace_once(
                fixed, FIRST_S_SMEM, "  const int s_in_smem = 0;")),
        ]
    fixed = replace_once(src, NEW_STOP, FIXED)
    return [
        ("as built", src),
        ("fixed count", fixed),
        ("copy only", replace_once(
            src, NEW_LOADED, NEW_LOADED
            + "  float t = 0.f;\n#pragma unroll\n"
              "  for (int r = 0; r < RW; ++r)\n#pragma unroll\n"
              "    for (int c = 0; c < CL; ++c)\n"
              "      t += src.at(r, c, min(warp + WARPS * r, m - 1),\n"
              "                  min(lane + 32 * c, m - 1), m);\n"
              "  for (int j = 0; j < TF_MAX; ++j) t += mr[j];\n"
              "  if (tid < m) y[tid] = t;\n"
            + EMPTY)),
        ("no matvec", replace_once(replace_once(
            fixed, NEW_MATVEC,
            "    if (lane == 0)\n"
            "      for (int row = warp; row < m; row += WARPS)\n"
            "        Ap[row] = v[0] + row;\n"), NEW_REFRESH,
            "      if (lane == 0)\n"
            "        for (int row = warp; row < m; row += WARPS)\n"
            "          rn[row] = b[row] - v[0];\n")),
        ("matvec only", replace_once(
            fixed, NEW_MATVEC + NEW_AFTER_MATVEC,
            NEW_MATVEC + NEW_AFTER_MATVEC
            + "    if (max_it >= 0) {\n      ++it;\n      continue;\n    }\n")),
        ("empty", replace_once(src, NEW_BODY, NEW_BODY + EMPTY)),
    ]


def ptxas_lines(path):
    """`nvcc -Xptxas -v` on the source at `path` (registers, spills and
    shared memory of each kernel)."""
    from ceres_tpu_torch.ops import _cuda
    out = os.path.join(str(_cuda.BUILD_DIR), "k7_ptxas.o")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                           "-c", "-o", out, path], capture_output=True,
                          text=True)
    if os.path.exists(out):
        os.unlink(out)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "Compiling" in ln or "registers" in ln or "spill" in ln]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source",
                    default=os.path.join(ROOT, "ceres_tpu_torch", "csrc",
                                         "pcg.cu"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k7_variants: no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from time_kernels import k7_systems, kernel_us, line_fit, res_usage
    from ceres_tpu_torch.ops import _cuda
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    print(json.dumps({"source": args.source,
                      "ptxas": ptxas_lines(args.source)}), flush=True)
    with open(args.source) as f:
        src = f.read()
    systems = k7_systems()
    built = {}                  # (problem, k) -> (y, iterations)
    for name, text in variants(src):
        lib = _cuda.build_generated("k7variant", text)
        fn = lib.ceres_pcg
        fn.argtypes = list(_cuda._SIGNATURES["ceres_pcg"])
        fn.restype = ctypes.c_int
        times = {}
        same = True
        for problem, k, S, rhs, minv, kw in systems:
            m = S.shape[0]
            tf = 1 if minv is None else minv.shape[-1]
            max_it = kw["max_iterations"]
            if name != "as built":
                max_it = built[(problem, k)][1]

            def call():
                y = torch.empty_like(rhs)
                it = torch.empty((), dtype=torch.int32, device="cuda")
                norm = torch.empty((), device="cuda")
                _cuda.call(fn, "ceres_pcg", S, rhs, minv, m, tf, max_it,
                           kw["min_iterations"], float(kw["q_tolerance"]),
                           kw.get("residual_reset_period", 10), y, it, norm)
                return y, it
            y, it = call()
            torch.cuda.synchronize()
            if name == "as built":
                built[(problem, k)] = (y, int(it))
            elif name == "fixed count":
                same = same and torch.equal(y, built[(problem, k)][0]) \
                    and int(it) == built[(problem, k)][1]
            times.setdefault(problem, []).append(
                (built[(problem, k)][1], sum(kernel_us(call).values())))
        for problem, pts in times.items():
            at0, per_it = line_fit(pts)
            print(json.dumps({
                "variant": name, "cameras": problem,
                "device_us": [round(t, 3) for _, t in pts],
                "cg_iterations": [i for i, _ in pts],
                "device_us_at_0": at0, "device_us_per_iteration": per_it,
                "as_built_bits": same if name == "fixed count" else None}),
                flush=True)
        path = next(p for p in _cuda._generated if p.endswith(".so")
                    and _cuda._generated[p] is lib)
        print(json.dumps({"variant": name, "registers": {
            k: v.split(" CONSTANT")[0] for k, v in res_usage(path).items()
            if "pcg" in k}}), flush=True)


if __name__ == "__main__":
    main()
