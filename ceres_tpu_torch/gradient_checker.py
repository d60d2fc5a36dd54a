"""Gradient checking: a cost's Jacobians against numeric differences.

Counterpart of ceres_tpu/gradient_checker.py (the reference's
gradient_checker.h:68, gradient_checker.cc) and of the solver's
check_gradients mode (solver.h; gradient_checking_cost_function.cc).
The user side is the cost's own `jacobians` where a SizedCostFunction
gives them, else torch.func.jacfwd of its residual function (what the
solver uses); the numeric side is central differences
(NumericDiffCostFunction.jacobian_of). Both are compared in tangent space
through each manifold's plus_jacobian (gradient_checker.cc:176), entry by
entry, |J_user - J_numeric| / max(|J_user| + |J_numeric|, 1e-12).

The JAX package probes one residual block at a time in Python; here the
blocks that share a cost bucket and slot manifolds are probed together,
mapped over with torch.func.vmap, on an explicit device. The first
failing block and its message are those of the block-at-a-time loop.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .cost import (CostFunction, NumericDiffCostFunction,
                   NumericDiffOptions, SizedCostFunction)
from .manifolds import Manifold
from .types import NumericDiffMethodType


class ProbeResults(NamedTuple):
    return_value: bool
    residuals: np.ndarray
    jacobians: List[np.ndarray]           # tangent space, the user side
    numeric_jacobians: List[np.ndarray]   # tangent space, numeric
    local_jacobians: List[np.ndarray]     # the reference's name for jacobians
    maximum_relative_error: float
    error_log: str


def _user_jacobians(cost: CostFunction, rfn):
    """f(data, params) -> [J_i [r, size_i]]: the analytic Jacobians of a
    SizedCostFunction that overrides `jacobians`, else jacfwd's."""
    nr = cost.num_residuals
    sizes = cost.parameter_block_sizes
    if (isinstance(cost, SizedCostFunction)
            and type(cost).jacobians is not SizedCostFunction.jacobians):
        cls = type(cost)

        def analytic(data, params):
            obj = object.__new__(cls)
            object.__setattr__(obj, "__dict__", dict(data))
            Js = obj.jacobians(*params)
            return [torch.as_tensor(J).to(params[i]).reshape(nr, sizes[i])
                    for i, J in enumerate(Js)]
        return analytic

    def forward(data, params):
        Js = torch.func.jacfwd(lambda *ps: rfn(data, *ps),
                               argnums=tuple(range(len(params))))(*params)
        return [J.reshape(nr, sizes[i]) for i, J in enumerate(Js)]
    return forward


def _probe_rows(cost, manifolds, options, data, params):
    """Probe n blocks of one cost bucket at once: (residuals [n, r], user
    Jacobians [[n, r, t_i]], numeric Jacobians [[n, r, t_i]], each slot's
    largest relative error [n, slots]), all tangent space, f64."""
    rfn = cost.make_residual_fn()
    user = _user_jacobians(cost, rfn)
    nd = NumericDiffCostFunction(rfn, NumericDiffMethodType.CENTRAL,
                                 cost.num_residuals,
                                 cost.parameter_block_sizes, options=options)
    numeric = [nd.jacobian_of(rfn, i) for i in range(len(params))]

    def one(d, *ps):
        ps = list(ps)
        r = rfn(d, *ps)
        Ju = user(d, ps)
        Jn = [jfn(d, ps) for jfn in numeric]
        for i, m in enumerate(manifolds):
            if m is not None:
                P = m.plus_jacobian(ps[i])
                Ju[i], Jn[i] = Ju[i] @ P, Jn[i] @ P
        return r, Ju, Jn

    r, Ju, Jn = torch.func.vmap(one)(data, *params)
    worst = []
    for a, b in zip(Ju, Jn):
        rel = torch.abs(a - b) / torch.clamp(torch.abs(a) + torch.abs(b),
                                             min=1e-12)
        worst.append(torch.amax(rel, dim=(1, 2)) if rel[0].numel()
                     else rel.new_zeros(rel.shape[0]))
    return r, Ju, Jn, torch.stack(worst, dim=1)


def _error_log(worst, relative_precision) -> str:
    """The reference's lines for one block's slots (worst [slots])."""
    return "\n".join(
        f"Jacobian for parameter block {i} disagrees: max relative error "
        f"{w:e} > {relative_precision:e}"
        for i, w in enumerate(worst) if w > relative_precision)


def _stack_data(datas, device):
    """Per-block data dicts stacked into tensors on `device` (f64)."""
    out = {}
    for name in datas[0]:
        t = torch.as_tensor(np.stack([np.asarray(d[name]) for d in datas]),
                            device=device)
        out[name] = t.to(torch.float64) if t.is_floating_point() else t
    return out


class GradientChecker:
    """gradient_checker.h:68, on `device` (default "cuda")."""

    def __init__(self, cost_function,
                 manifolds: Optional[List[Optional[Manifold]]] = None,
                 numeric_diff_options: Optional[NumericDiffOptions] = None,
                 device="cuda"):
        self.cost = cost_function
        self.manifolds = manifolds or [None] * len(
            cost_function.parameter_block_sizes)
        self.options = numeric_diff_options or NumericDiffOptions()
        self.device = torch.device(device)

    def probe(self, parameters, relative_precision: float) -> ProbeResults:
        params = [torch.as_tensor(np.asarray(p, dtype=np.float64),
                                  device=self.device)[None]
                  for p in parameters]
        data = _stack_data([self.cost.block_data()], self.device)
        r, Ju, Jn, worst = _probe_rows(self.cost, self.manifolds,
                                       self.options, data, params)
        worst = worst[0].cpu().numpy()
        log = _error_log(worst, relative_precision)
        user = [J[0].cpu().numpy() for J in Ju]
        return ProbeResults(not log, r[0].cpu().numpy(), user,
                            [J[0].cpu().numpy() for J in Jn], user,
                            float(worst.max()) if worst.size else 0.0, log)


def check_problem_gradients(problem, relative_precision: float = 1e-8,
                            device="cuda",
                            numeric_diff_options=None) -> Optional[str]:
    """The solver's check_gradients mode: every residual block's
    Jacobians probed at the current values (once, before the solve, as
    the JAX package does: the Jacobian code does not change between
    iterations). The message of the first failing block in insertion
    order, or None."""
    device = torch.device(device)
    options = numeric_diff_options or NumericDiffOptions()
    groups = {}
    for rb in problem._residual_records():
        manifolds = tuple(problem._blocks[k].manifold for k in rb.param_keys)
        key = (rb.cost.bucket_key(),
               tuple(None if m is None else m.bucket_key()
                     for m in manifolds))
        groups.setdefault(key, (manifolds, []))[1].append(rb)
    first = None
    for manifolds, rbs in groups.values():
        cost = rbs[0].cost
        data = _stack_data([rb.cost.block_data() for rb in rbs], device)
        params = [torch.as_tensor(np.stack(
            [problem._blocks[rb.param_keys[i]].array for rb in rbs]),
            dtype=torch.float64, device=device)
            for i in range(len(cost.parameter_block_sizes))]
        worst = _probe_rows(cost, manifolds, options, data,
                            params)[3].cpu().numpy()
        failing = np.nonzero((worst > relative_precision).any(axis=1))[0]
        if failing.size:
            row = int(failing[0])       # rbs are in insertion order
            if first is None or rbs[row].index < first[0]:
                first = (rbs[row].index, worst[row])
    if first is None:
        return None
    return (f"Gradient check failed for residual block {first[0]}:\n"
            f"{_error_log(first[1], relative_precision)}")
