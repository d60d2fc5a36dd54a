"""C API support: the Python half of the embedded-interpreter C bindings.

Counterpart of ceres_tpu/c_api.py (the reference's include/ceres/c_api.h:
123-138, internal/ceres/c_api.cc): create a problem, add residual blocks
whose cost (and optionally loss) are C function pointers, solve, with the
results written back into C-owned parameter memory.

The native shim (capi/ceres_tpu_torch_c.cpp) embeds CPython and calls the
functions here with raw pointer values. Parameter blocks become numpy
views over the C arrays (zero copy: the solve's write-back mutates the
caller's memory, as the C++ API does). Every other cost of the port is
evaluated by torch.func.vmap, which cannot call into C; a C cost is a
SizedCostFunction with a host route instead (`host_rows`, taken by
program.py for the bucket's "host" jac_mode): each evaluation copies the
bucket's parameters to the host once as f64 numpy, loops over the rows
through ctypes, and copies the residuals and Jacobians to the device
once. A C loss is evaluated the same way. A cost that returns 0 marks the
evaluation invalid (NaN residuals and Jacobians), which the minimizer
treats as a failed step.

`solve` runs on the card unless asked for the CPU (device="cpu"); the C
shim asks for it when the environment variable CERES_TPU_TORCH_DEVICE is
"cpu", the one device choice of the port that is not an option.

This module is importable directly (ctypes-level use from Python).
"""

from __future__ import annotations

import ctypes
import itertools
from ctypes import POINTER, c_double, c_int, c_void_p
from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

CERES_COST_FUNC_T = ctypes.CFUNCTYPE(c_int, c_void_p,
                                     POINTER(POINTER(c_double)),
                                     POINTER(c_double),
                                     POINTER(POINTER(c_double)))
CERES_LOSS_FUNC_T = ctypes.CFUNCTYPE(None, c_void_p, c_double,
                                     POINTER(c_double))

_problems: Dict[int, "_CProblem"] = {}
_ids = itertools.count(1)
_keepalive: Dict[int, object] = {}


class _CProblem:
    def __init__(self):
        import ceres_tpu_torch as ctt
        self.problem = ctt.Problem()
        self.views: List[np.ndarray] = []
        self.losses: Dict[tuple, object] = {}


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(POINTER(c_double))


@lru_cache(maxsize=None)
def _cost_class(cost_ptr: int, nr: int, sizes: tuple):
    """One SizedCostFunction subclass per distinct (C function, shape):
    one bucket per C cost function."""
    from .cost import SizedCostFunction

    cfn = CERES_COST_FUNC_T(cost_ptr)

    def call_rows(user_data, params, want_jac):
        """The C function on every row: user_data [n] int, params [n,
        size_i] f64 numpy each. Returns (residuals [n, nr], [J_i [n, nr,
        size_i]] or None), NaN on the rows whose call returned 0."""
        n = len(user_data)
        res = np.zeros((n, nr), dtype=np.float64)
        jacs = ([np.zeros((n, nr, s), dtype=np.float64) for s in sizes]
                if want_jac else None)
        no_jac = ctypes.cast(None, POINTER(POINTER(c_double)))
        for i in range(n):
            arr = (POINTER(c_double) * len(params))(
                *[_dptr(p[i]) for p in params])
            jarr = ((POINTER(c_double) * len(sizes))(
                *[_dptr(j[i]) for j in jacs]) if want_jac else no_jac)
            if not cfn(c_void_p(int(user_data[i])), arr, _dptr(res[i]),
                       jarr):
                res[i] = np.nan
                if want_jac:
                    for j in jacs:
                        j[i] = np.nan
        return res, jacs

    class CCostFunction(SizedCostFunction):
        def __init__(self, user_data: int):
            super().__init__(nr, list(sizes))
            self.user_data = int(user_data)

        def host_rows(self, params, data, want_jacobians: bool):
            """(residuals [n, nr], [J_i [n, nr, size_i]] or None) of the
            rows at params ([n, size_i] tensors each), in f64 on the
            params' device: one copy to the host a slot, one back an
            output."""
            dev = params[0].device
            ps = [np.ascontiguousarray(p.detach().to("cpu", torch.float64)
                                       .numpy()) for p in params]
            ud = data["user_data"].detach().cpu().numpy().reshape(-1)
            res, jacs = call_rows(ud, ps, want_jacobians)
            res = torch.from_numpy(res).to(dev)
            if jacs is not None:
                jacs = [torch.from_numpy(j).to(dev) for j in jacs]
            return res, jacs

        def residuals(self, *params):
            """One block (the fixed-cost fold and direct calls)."""
            ps = [torch.as_tensor(p, dtype=torch.float64).reshape(1, -1)
                  for p in params]
            ud = torch.tensor([self.user_data])
            return self.host_rows(ps, {"user_data": ud}, False)[0][0]

        def jacobians(self, *params):
            ps = [torch.as_tensor(p, dtype=torch.float64).reshape(1, -1)
                  for p in params]
            ud = torch.tensor([self.user_data])
            return [j[0] for j in self.host_rows(ps, {"user_data": ud},
                                                 True)[1]]

    CCostFunction.__name__ = f"CCostFunction_{cost_ptr:x}_{nr}"
    return CCostFunction


@lru_cache(maxsize=None)
def _loss_class(loss_ptr: int):
    from .loss import LossFunction

    lfn = CERES_LOSS_FUNC_T(loss_ptr)

    class CLossFunction(LossFunction):
        def __init__(self, user_data: int):
            self.user_data = int(user_data)

        def evaluate(self, s):
            """(rho, rho', rho'') of s, the C function on each entry on
            the host (one copy each way)."""
            s = torch.as_tensor(s)
            flat = s.detach().to("cpu", torch.float64).numpy().reshape(-1)
            out = np.zeros((flat.size, 3), dtype=np.float64)
            buf = (c_double * 3)()
            ud = c_void_p(self.user_data)
            for i, si in enumerate(flat):
                lfn(ud, float(si), buf)
                out[i] = buf[:]
            trip = torch.from_numpy(out).to(s.device, s.dtype)
            trip = trip.reshape(tuple(s.shape) + (3,))
            return trip[..., 0], trip[..., 1], trip[..., 2]

    CLossFunction.__name__ = f"CLossFunction_{loss_ptr:x}"
    return CLossFunction


# ---------------------------------------------------------------- public API
def create_problem() -> int:
    pid = next(_ids)
    _problems[pid] = _CProblem()
    return pid


def free_problem(pid: int) -> None:
    _problems.pop(pid, None)


def add_residual_block(pid: int, cost_ptr: int, cost_data: int,
                       loss_ptr: int, loss_data: int, num_residuals: int,
                       sizes: List[int], param_ptrs: List[int]) -> int:
    cp = _problems[pid]
    views = []
    for ptr, sz in zip(param_ptrs, sizes):
        existing = None
        for v in cp.views:
            if v.ctypes.data == ptr:
                existing = v
                break
        if existing is None:
            existing = np.ctypeslib.as_array(
                ctypes.cast(int(ptr), POINTER(c_double)), shape=(int(sz),))
            cp.views.append(existing)
        views.append(existing)

    cost = _cost_class(int(cost_ptr), int(num_residuals),
                       tuple(int(s) for s in sizes))(int(cost_data or 0))
    loss = None
    if loss_ptr:
        # one loss object per (function, data): blocks sharing a loss share
        # a bucket
        key = (int(loss_ptr), int(loss_data or 0))
        loss = cp.losses.get(key)
        if loss is None:
            loss = cp.losses[key] = _loss_class(key[0])(key[1])
    rb = cp.problem.add_residual_block(cost, loss, *views)
    _keepalive[id(rb)] = rb
    return id(rb)


def solve(pid: int, max_num_iterations: int = 50,
          device: str = "cuda") -> str:
    """Solve the problem with SolverOptions' defaults on `device`; returns
    the brief report. The solution is written into the C arrays."""
    import ceres_tpu_torch as ctt
    cp = _problems[pid]
    options = ctt.SolverOptions(max_num_iterations=int(max_num_iterations),
                                device=device)
    summary = ctt.solve(options, cp.problem)
    return summary.brief_report()
