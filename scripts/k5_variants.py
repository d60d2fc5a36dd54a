#!/usr/bin/env python3
"""Variants of K5's lane kernel (csrc/lin_auto.cuh) on the card: where its
time goes, with no profiler of the kernel's inside.

    python3 scripts/k5_variants.py

Builds the shipped generated unit of the quaternion BAL-16-22106 problem
(scripts/time_kernels.py quaternion_k5) and variants of its header, each
from the header text with one change: "no A phase" returns before the A
rows (the chains and the F-side rows alone), "no A writes" fills and
streams the A tiles but leaves out the lanes' entries, "persistent N"
launches N blocks a SM that loop over the point tiles (so a block's A
rows could overlap another tile's chains). Each runs through
ops/lin_auto.py lin_auto with the step's camera plan; prints one JSON
line a variant: its device time a call by kernel (torch.profiler over
100 calls) and whether its outputs hold the shipped kernel's bits
(variants that leave work out do not). Needs a CUDA device.
"""

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"k5_variants: the header no longer holds {old!r}")
    return text.replace(old, new)


def variants(hdr, sms):
    """(name, header text) of each variant."""
    a_phase = "  const int warp = tid >> 5, wl = tid & 31;"
    scatter = ("      for (int it = tid; it < gn * k * (TE * TF); "
               "it += THREADS) {")
    out = [("shipped", hdr),
           ("no A phase", replace_once(hdr, a_phase,
                                       "  if (nf >= 0) return;\n" + a_phase)),
           ("no A writes", replace_once(hdr, scatter, scatter.replace(
               "it < gn * k * (TE * TF);", "it < gn * k * (TE * TF) && nf < 0;")))]
    for per_sm in (2, 3, 5):
        h = replace_once(
            hdr, "  const int tid = threadIdx.x;\n  const int n0 = blockIdx.x * pb;",
            "  const int tid = threadIdx.x;\n  for (int blk = blockIdx.x; "
            "blk < (ne + pb - 1) / pb; blk += gridDim.x) {\n"
            "  const int n0 = blk * pb;")
        h = replace_once(h, "      __syncthreads();\n    }\n  }\n}\n\n// partial",
                         "      __syncthreads();\n    }\n  }\n  }\n}\n\n// partial")
        h = replace_once(h, "lin_auto::lane_kernel<C><<<(ne + pb - 1) / pb,",
                         f"lin_auto::lane_kernel<C><<<min((ne + pb - 1) / pb, "
                         f"{per_sm * sms}),")
        out.append((f"persistent {per_sm} a SM", h))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k5_variants: no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from time_kernels import kernel_us, quaternion_k5
    from ceres_tpu_torch.ops import _cuda
    from ceres_tpu_torch.ops import lin_auto as k5
    spec, args, plan, _ = quaternion_k5()
    unit = k5.generated_unit(spec, None)
    hdr = (_cuda.CSRC / "lin_auto.cuh").read_text()
    key = (spec.auto.digest, spec[1:], None)
    shipped = None
    for name, text in variants(hdr, _cuda.sm_count(torch.device("cuda"))):
        lib = _cuda.build_generated(
            "k5variant", unit.replace('#include "lin_auto.cuh"', text))
        fn = lib.ceres_lin_auto
        fn.argtypes = k5._ARGTYPES
        fn.restype = ctypes.c_int
        k5._ENTRIES[key] = fn                   # lin_auto takes this entry
        k5._CALLS.clear()

        def call():
            return k5.lin_auto(*args, True, True, None, plan=plan)
        got = call()
        torch.cuda.synchronize()
        shipped = shipped or got
        by_kernel = kernel_us(call)
        print(json.dumps({
            "variant": name, "device_us": sum(by_kernel.values()),
            "device_us_by_kernel": {k.split("(")[0].split("::")[-1]: t
                                    for k, t in by_kernel.items()},
            "shipped_bits": all(torch.equal(got[k], shipped[k])
                                for k in shipped)}), flush=True)
    k5._ENTRIES.pop(key)
    k5._CALLS.clear()


if __name__ == "__main__":
    main()
