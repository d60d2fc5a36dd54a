"""TinySolver: a self-contained dense Levenberg-Marquardt for small
problems, one or a batch of many.

Counterpart of ceres_tpu/tiny_solver.py (the reference's tiny_solver.h:133,
a dense LM over one parameter vector with no Problem; the Jacobian from
the residual functor as tiny_solver_autodiff_function.h does, here by
torch.func.jacfwd). Where the JAX package's solve is one lax.while_loop
that users vmap over many problems, this one takes a leading batch
dimension: x0 [B, n] and per-problem `args` [B, ...], residual_fn written
for one problem and mapped with torch.func.vmap. Each problem carries
its own radius, iteration count and done flag; a problem that is done
keeps its state, so its trajectory is the one it takes alone. The loop
reads one flag on the host an iteration and stops when every problem is
done or at max_num_iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class TinySolverOptions(NamedTuple):
    """tiny_solver.h Options."""
    max_num_iterations: int = 50
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    function_tolerance: float = 1e-6
    initial_trust_region_radius: float = 1e4
    device: str = "cuda"        # where an x0 that is not a tensor goes


class TinySolverResult(NamedTuple):
    x: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor        # int32
    converged: torch.Tensor         # bool


def tiny_solve(residual_fn: Callable, x0,
               options: TinySolverOptions = TinySolverOptions(),
               jacobian_fn: Callable = None, args=()) -> TinySolverResult:
    """Minimize 0.5 ||residual_fn(x, *args)||^2 by dense LM from x0 [n],
    or from x0 [B, n] for B problems with `args` each [B, ...]. The
    Jacobian is jacobian_fn(x, *args) [m, n], by default
    torch.func.jacfwd(residual_fn). A tensor x0 keeps its device; any
    other x0 (numpy, a list) goes to options.device, the card by
    default, and `args` follow x0. Returns the result of each problem
    (leading dimension B when batched)."""
    x0 = torch.as_tensor(x0, device=None if torch.is_tensor(x0)
                         else options.device)
    args = tuple(torch.as_tensor(a, device=x0.device) for a in args)
    single = x0.dim() == 1
    if single:
        x0 = x0[None]
        args = tuple(a[None] for a in args)
    if jacobian_fn is None:
        jacobian_fn = torch.func.jacfwd(residual_fn)
    residuals = torch.func.vmap(residual_fn)
    jacobians = torch.func.vmap(jacobian_fn)
    opts = options

    def cost_of(x):
        r = residuals(x, *args)
        return 0.5 * torch.sum(r * r, dim=-1)

    x = x0
    cost0 = cost = cost_of(x0)
    radius = torch.full_like(cost0, opts.initial_trust_region_radius)
    it = torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    done = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
    while True:
        active = ~done & (it < opts.max_num_iterations)
        if not bool(active.any()):                     # the one host read
            break
        r = residuals(x, *args)
        J = jacobians(x, *args)
        g = torch.einsum("bmn,bm->bn", J, r)
        g_max = g.abs().amax(dim=-1)
        grad_ok = g_max <= opts.gradient_tolerance
        JtJ = torch.einsum("bmi,bmj->bij", J, J)
        diag = torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-6,
                           1e32)
        H = JtJ + torch.diag_embed(diag) / radius[:, None, None]
        # Cholesky; a gradient step where it fails (not positive definite)
        L, info = torch.linalg.cholesky_ex(H)
        d = torch.cholesky_solve(-g[..., None], L)[..., 0]
        ok = (info == 0) & torch.isfinite(d).all(dim=-1)
        d = torch.where(ok[:, None], d,
                        -g / torch.clamp(g_max, min=1.0)[:, None])
        x_new = x + d
        new_cost = cost_of(x_new)
        mcc = -(torch.sum(d * g, dim=-1) + 0.5 * torch.sum(
            d * torch.einsum("bij,bj->bi", JtJ, d), dim=-1))
        rho = (cost - new_cost) / torch.where(mcc == 0, 1.0, mcc)
        accept = torch.isfinite(new_cost) & (rho > 1e-3) & (mcc > 0)
        new_radius = torch.where(
            accept,
            torch.clamp(radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                             min=1.0 / 3.0), max=1e16),
            radius * 0.5)
        step_ok = torch.linalg.vector_norm(d, dim=-1) <= \
            opts.parameter_tolerance * (torch.linalg.vector_norm(
                x_new, dim=-1) + opts.parameter_tolerance)
        f_ok = accept & (torch.abs(cost - new_cost)
                         <= opts.function_tolerance * cost)
        new_done = grad_ok | (accept & (step_ok | f_ok)) | \
            (new_radius < 1e-32)
        take = active & accept
        x = torch.where(take[:, None], x_new, x)
        cost = torch.where(take, new_cost, cost)
        radius = torch.where(active, new_radius, radius)
        done = torch.where(active, new_done, done)
        it = it + active.to(torch.int32)
    result = TinySolverResult(x=x, initial_cost=cost0, final_cost=cost,
                              iterations=it, converged=done)
    if single:
        result = TinySolverResult(*(t[0] for t in result))
    return result


class TinySolver:
    """The object API of tiny_solver.h."""

    Options = TinySolverOptions

    def __init__(self, options: TinySolverOptions = TinySolverOptions()):
        self.options = options

    def solve(self, residual_fn, x0, jacobian_fn=None,
              args=()) -> TinySolverResult:
        return tiny_solve(residual_fn, x0, self.options, jacobian_fn, args)
