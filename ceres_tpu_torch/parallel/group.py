"""The process group of a sharded solve: the counterpart of the JAX
package's Mesh and its data axis (ceres_tpu/parallel/solve_sharded.py
_as_mesh, _data_axis).

A torch process drives one device, so a sharded solve runs one process a
rank. `SolverOptions.mesh` names the ranks: a
torch.distributed.ProcessGroup, or an int n, the default group, which must
already be initialized with world size n (launch with `torchrun
--nproc_per_node n`, or ceres_tpu_torch.parallel.launch.run_ranks). In the
JAX package an int means the first n local devices of one process.

`Group` is the rank's view of its group with the few collectives the
sharded steps take, each counted (calls and bytes, for chip_smoke.py's
lines and the collective-count test):
  sum(*tensors)   one sum all-reduce a dtype, the tensors flattened into
                  one buffer (psum #1, psum #2, the norms, the costs);
  max(t)          one max all-reduce (the e-side gradient max);
  gather_rows(t)  the rows of every rank in rank order (the e-part of the
                  step): all_gather, each rank's block of equal size
                  (gloo takes CUDA tensors for it as NCCL does:
                  scripts/collectives_probe.py on the card).
Every LM and CG decision is taken on the results, which are the same bits
on every rank.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

LAUNCH_HINT = ("launch one process a rank with `torchrun --nproc_per_node "
               "N` or ceres_tpu_torch.parallel.launch.run_ranks, and pass "
               "options.mesh = N or a torch.distributed.ProcessGroup")


class Group:
    """A rank of a torch.distributed process group (`pg` None: the default
    group) and its counted collectives."""

    def __init__(self, pg=None):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.size = dist.get_world_size(pg)
        self.backend = str(dist.get_backend(pg))
        self.calls = Counter()
        self.bytes = Counter()

    def reset_counts(self):
        self.calls.clear()
        self.bytes.clear()

    def _count(self, kind, t):
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def sum(self, *tensors):
        """The sum over ranks of each tensor, in one all-reduce a dtype
        (the tensors of one dtype flattened into one buffer)."""
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            self._count("sum", flat)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.pg)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view(tensors[i].shape)
                off += n
        return out

    def max(self, t):
        """The max over ranks of t."""
        t = t.clone()
        self._count("max", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return t

    def gather_rows(self, t):
        """[n, ...] on every rank -> [size * n, ...], rank r's rows at
        r * n."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._count("gather", t)
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts)


_GROUPS = {}


def as_group(mesh) -> Group:
    """SolverOptions.mesh as the rank's Group (one Group object a process
    group, so its counts accumulate)."""
    if isinstance(mesh, Group):
        return mesh
    if isinstance(mesh, bool) or not (
            isinstance(mesh, int) or isinstance(mesh, dist.ProcessGroup)):
        raise TypeError("options.mesh must be a torch.distributed."
                        f"ProcessGroup or an int, got {mesh!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"options.mesh = {mesh!r}, but no "
                           f"torch.distributed process group is "
                           f"initialized: {LAUNCH_HINT}")
    pg = None if isinstance(mesh, int) else mesh
    if isinstance(mesh, int) and dist.get_world_size() != mesh:
        raise ValueError(f"options.mesh = {mesh}, but the default process "
                         f"group has world size {dist.get_world_size()}: "
                         f"{LAUNCH_HINT}")
    if pg not in _GROUPS:
        _GROUPS[pg] = Group(pg)
    return _GROUPS[pg]
