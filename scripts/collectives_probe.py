#!/usr/bin/env python3
"""Which collectives torch.distributed's backends take on CUDA tensors:
sum and max all_reduce and all_gather, on `--ranks` ranks sharing the
cards (gloo) or one a card (nccl), each call's result checked.

    python3 scripts/collectives_probe.py --backend gloo --ranks 2
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe_rank():
    import torch
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    for name in ("sum", "max", "all_gather"):
        try:
            t = torch.full((3,), float(r + 1), device="cuda")
            if name == "all_gather":
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t)
                ok = all(float(p[0]) == i + 1 for i, p in enumerate(parts))
            else:
                op = dist.ReduceOp.SUM if name == "sum" else dist.ReduceOp.MAX
                dist.all_reduce(t, op=op)
                want = n * (n + 1) / 2 if name == "sum" else n
                ok = float(t[0]) == want
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:        # the probe reports what fails
            out[name] = f"{type(e).__name__}: {e}"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from ceres_tpu_torch.parallel.launch import run_ranks
    import collectives_probe
    res = run_ranks(collectives_probe.probe_rank, args.ranks, args.backend,
                    "cuda", 300.0)
    for r, out in enumerate(res):
        print(f"{args.backend} rank {r}/{args.ranks}: {out}", flush=True)


if __name__ == "__main__":
    main()
