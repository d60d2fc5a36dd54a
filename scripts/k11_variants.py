#!/usr/bin/env python3
"""Variants of K11's hand specs (csrc/linearize.cu on
csrc/linearize_auto.cuh's row kernel) on the card: where their time
goes, with no profiler of the kernel's inside.

    python3 scripts/k11_variants.py

Builds csrc/linearize.cu as it ships and variants of it, each from the
source text (its row-kernel header inlined) with one change: "a tile a
block" launches a block for every tile instead of the persistent grid
(no tile's loads then overlap another's chains); "tile T" takes T rows
a block instead of 128; "min blocks B" asks the compiler for B resident
blocks a SM (__launch_bounds__(TILE, B), so at most 65,536 / (TILE B)
registers a thread); "no chain" copies each row's inputs into its
outputs instead of running the chain (the copies and stores alone); "no
stores" leaves out the stores of r and J (the copies and the chain
alone). Each runs through the entry point ceres_linearize on
scripts/time_kernels.py's K11hand inputs (Snavely on the 1M-row bucket,
SE3 and SE2 on the pose graphs' main buckets); prints one JSON line a
variant and spec: its device time a call (torch.profiler over 100 calls)
and whether r and J hold the shipped kernel's bits (variants that leave
work out do not), and one line of each variant's registers, stack and
spills (cuobjdump -res-usage). Needs a CUDA device.
"""

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"k11_variants: the source no longer holds {old!r}")
    return text.replace(old, new)


def variants(src, hdr):
    """(name, source text) of each variant: linearize.cu with the row
    kernel's header inlined, then one change."""
    inlined = replace_once(src, '#include "linearize_auto.cuh"\n', hdr)
    tile = "constexpr int TILE = 128;"
    bounds = "__global__ void __launch_bounds__(TILE)"
    grid = "<<<tiles < resident ? tiles : resident, TILE, smem, stream>>>("
    run = "      C::run(x, d, rv, Jr);"
    stores = ("    store_rows<R, RS>(r + r0 * R, sR, nr * R, tid, TILE);\n"
              "    store_rows<RN, JS>(J + r0 * RN, sJ, nr * RN, tid, TILE);")
    out = [("shipped", inlined),
           ("a tile a block", replace_once(
               inlined, grid, "<<<tiles, TILE, smem, stream>>>("))]
    for t in (64, 32):
        out.append((f"tile {t}", replace_once(
            inlined, tile, f"constexpr int TILE = {t};")))
    for t, b in ((128, 8), (64, 16)):
        v = replace_once(inlined, tile, f"constexpr int TILE = {t};")
        out.append((f"tile {t}, min blocks {b}", replace_once(
            v, bounds, f"__global__ void __launch_bounds__(TILE, {b})")))
    out.append(("no chain", replace_once(
        inlined, run,
        "#pragma unroll\n      for (int s = 0; s < R; ++s) {\n"
        "        rv[s] = x[s % P_IN];\n#pragma unroll\n"
        "        for (int c = 0; c < NT; ++c) Jr[s][c] = x[(s + c) % P_IN];\n"
        "      }")))
    out.append(("no stores", replace_once(inlined, stores, "")))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k11_variants: no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from time_kernels import k11_hand_cases, kernel_us, res_usage
    from ceres_tpu_torch.ops import _cuda
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    cases = k11_hand_cases()
    src = (_cuda.CSRC / "linearize.cu").read_text()
    hdr = (_cuda.CSRC / "linearize_auto.cuh").read_text()
    shipped = {}
    for name, text in variants(src, hdr):
        lib = _cuda.build_generated("k11variant", text)
        fn = lib.ceres_linearize
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for spec_name, spec, xin, dat in cases:
            n = xin.shape[0]

            def call():
                r = torch.empty(n, spec.r, device="cuda")
                J = torch.empty(n, spec.r, spec.nt, device="cuda")
                _cuda.call(fn, "ceres_linearize", spec.kernel_id, xin, dat,
                           n, r, J)
                return r, J
            got = call()
            torch.cuda.synchronize()
            ref = shipped.setdefault(spec_name, got)
            by_kernel = kernel_us(call)
            print(json.dumps({
                "variant": name, "spec": spec_name,
                "device_us": sum(by_kernel.values()),
                "shipped_bits": all(torch.equal(a, b)
                                    for a, b in zip(got, ref))}),
                flush=True)
        path = next(p for p in _cuda._generated if p.endswith(".so")
                    and _cuda._generated[p] is lib)
        print(json.dumps({"variant": name, "registers": {
            chain: v.split(" CONSTANT")[0]
            for k, v in res_usage(path).items()
            for chain in ("Pose3dRow", "Pose2dRow", "SnavelyRow")
            if chain in k}}), flush=True)


if __name__ == "__main__":
    main()
