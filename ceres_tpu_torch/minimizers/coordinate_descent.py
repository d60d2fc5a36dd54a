"""Inner iterations: block coordinate descent over independent sets.

Counterpart of ceres_tpu/minimizers/coordinate_descent.py (the
reference's CoordinateDescentMinimizer, coordinate_descent_minimizer.h:59:
IsOrderingValid :76, CreateOrdering :84). After each valid trust-region
step the host loop (minimizers/trust_region.py) refines the candidate:
the variable parameter blocks are split into independent sets (no two
blocks of a set share a residual block), and each set takes one damped
Gauss-Newton step with the other blocks held fixed. Independence makes
the per-block steps of a set one batched solve: the blocks' J^T J
diagonal blocks (ops/bsr.py block_diag_jtj) plus 1e-9 I, factored by a
batched Cholesky, against the blocks' gradients, as the JAX package does
(the reference runs one small DENSE_QR solve per block on a thread pool).
One f64 linearization a set; no host read.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.bsr import block_diag_jtj

DAMPING = 1e-9


def create_ordering(program) -> List[List[int]]:
    """Greedy coloring of the parameter-block interaction graph into
    independent sets, most-connected blocks first
    (coordinate_descent_minimizer.cc CreateOrdering through
    parameter_block_ordering.cc). Returns lists of block keys."""
    var_keys = [id(b.array) for b in program.variable_blocks]
    var_set = set(var_keys)
    adj = {k: set() for k in var_keys}
    for rb in program.problem._residual_records():
        ks = [k for k in rb.param_keys if k in var_set]
        for i in range(len(ks)):
            for j in range(i + 1, len(ks)):
                adj[ks[i]].add(ks[j])
                adj[ks[j]].add(ks[i])
    color = {}
    for k in sorted(var_keys, key=lambda k: -len(adj[k])):
        used = {color[n] for n in adj[k] if n in color}
        c = 0
        while c in used:
            c += 1
        color[k] = c
    groups = [[] for _ in range(max(color.values()) + 1 if color else 0)]
    for k in var_keys:
        groups[color[k]].append(k)
    return groups


def is_ordering_valid(program, ordering) -> bool:
    """Is each group of `ordering` an independent set
    (coordinate_descent_minimizer.h:76)?"""
    records = list(program.problem._residual_records())
    for g in ordering.groups_sorted():
        keys = ordering.group_element_keys(g)
        for rb in records:
            if sum(1 for k in rb.param_keys if k in keys) > 1:
                return False
    return True


def _ordering_groups(program, options) -> List[List[int]]:
    ordering = options.inner_iteration_ordering
    if ordering is None:
        return create_ordering(program)
    if not is_ordering_valid(program, ordering):
        raise ValueError(
            "inner_iteration_ordering is invalid: each group must be an "
            "independent set (no two blocks of a group may share a "
            "residual block)")
    return [[e if isinstance(e, int) else program.problem._as_key(e)
             for e in ordering.group_elements(g)]
            for g in ordering.groups_sorted()]


def make_inner_iteration_fn(program, options):
    """inner(x) -> x': one pass of coordinate descent over every
    independent set, in order (ceres_tpu make_inner_iteration_fn). The
    sets' block selections per tangent-size group are built here, once,
    on the host."""
    groups = program.groups
    key_of = program._group_of_block         # block key -> (group, local)
    dev = program.device
    set_plans = []
    for keys in _ordering_groups(program, options):
        by_group = {}
        for k in keys:
            if k in key_of:
                gi, li = key_of[k]
                by_group.setdefault(gi, []).append(li)
        plan = []
        for gi in sorted(by_group):
            g = groups[gi]
            sel = np.asarray(sorted(by_group[gi]), dtype=np.int64)
            cols = (g.tan_start + sel[:, None] * g.tangent_size
                    + np.arange(g.tangent_size)[None, :])
            plan.append((gi, torch.as_tensor(sel, device=dev),
                         torch.as_tensor(cols, device=dev)))
        if plan:
            set_plans.append(plan)

    def inner(x):
        for plan in set_plans:
            _, grad, jac, _ = program.linearize_fn(x)
            blocks = block_diag_jtj(jac, groups)
            delta = torch.zeros_like(grad)
            for gi, sel, cols in plan:
                t = groups[gi].tangent_size
                H = blocks[gi][sel] + DAMPING * torch.eye(
                    t, dtype=grad.dtype, device=grad.device)
                L, info = torch.linalg.cholesky_ex(H)
                # a block that is not positive definite steps NaN, as the
                # JAX package's Cholesky gives; the caller keeps the
                # unrefined x then (the refined cost is not finite)
                L = torch.where((info == 0)[:, None, None], L,
                                torch.full_like(L, float("nan")))
                d = torch.cholesky_solve(-grad[cols][..., None], L)[..., 0]
                delta[cols] = d
            x = program.plus(x, delta)
        return x

    return inner
