"""Preconditioned conjugate gradients.

Counterpart of ceres_tpu/solvers/cg.py (conjugate_gradients; reference
conjugate_gradients_solver.h:109): the Q-based forcing-sequence stop
    i * (Q_i - Q_{i-1}) / Q_i < q_tolerance,   Q = 0.5 x^T (r + b),
the indefiniteness guard, an r-norm tolerance, max_iterations, and the
refresh r = b - A x every `residual_reset_period` iterations.

A Python loop whose tensors stay on the device and which reads one
flag, `done`, on the host per iteration: the plain version that K7
(ops/pcg.py dense_pcg) is held against, and the CG of `solve_cgnr`, the
CGNR solver of the generic LM step, whose operator launches K8 once per
bucket on the card (ops/kernels.py jac_normal_matvec).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.kernels import jac_normal_matvec


class CGResult(NamedTuple):
    x: torch.Tensor
    num_iterations: torch.Tensor     # int32 scalar
    final_norm: torch.Tensor


def conjugate_gradients(
        apply_A: Callable,
        b,
        x0,
        apply_preconditioner: Callable = None,
        max_iterations: int = 100,
        min_iterations: int = 0,
        q_tolerance: float = 0.0,
        r_tolerance: float = 0.0,
        residual_reset_period: int = 10) -> CGResult:
    """Solve A x = b, A SPD, matrix-free, from x0. x0=None starts from
    zero with r0 = b, skipping the product A 0 (as the whole-solve kernel
    K7 does: a NaN in A then stops the solve at y = 0)."""
    if apply_preconditioner is None:
        def apply_preconditioner(v):
            return v
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    tol_r = r_tolerance * torch.linalg.vector_norm(b)

    if x0 is None:
        x0, r = torch.zeros_like(b), b
    else:
        r = b - apply_A(x0)
    x = x0
    z = apply_preconditioner(r)
    rho = torch.dot(r, z)
    p = z
    # Q at the initial point (conjugate_gradients_solver.h:157-159)
    Q0 = 0.5 * torch.dot(x0, r + b)
    i = 0
    done = False
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    while not done and i < max_iterations:
        Ap = apply_A(p)
        pAp = torch.dot(p, Ap)
        # indefiniteness guard (conjugate_gradients_solver.h:159)
        bad = (pAp <= 0) | ~torch.isfinite(pAp)
        alpha = torch.where(bad, zero, rho / torch.where(pAp == 0, one, pAp))
        x = x + alpha * p
        i += 1
        if i % residual_reset_period == 0:
            r = b - apply_A(x)
        else:
            r = r - alpha * Ap
        z = apply_preconditioner(r)
        rho_new = torch.dot(r, z)
        beta = rho_new / torch.where(rho == 0, one, rho)
        p = z + beta * p
        Q1 = 0.5 * torch.dot(x, r + b)
        zeta = i * (Q1 - Q0) / torch.where(Q1 == 0, one, Q1)
        q_done = ((Q1 != 0) & (torch.abs(zeta) < q_tolerance)
                  if q_tolerance > 0 and i >= max(min_iterations, 1)
                  else false)
        r_done = (torch.linalg.vector_norm(r) <= tol_r if r_tolerance > 0
                  else false)
        done = bool(bad | q_done | r_done)          # the one host read
        rho, Q0 = rho_new, Q1
    return CGResult(x=x,
                    num_iterations=torch.tensor(i, dtype=torch.int32,
                                                device=b.device),
                    final_norm=torch.linalg.vector_norm(r))


class BatchedCGResult(NamedTuple):
    x: torch.Tensor                  # [B, n]
    num_iterations: torch.Tensor     # int64 [B]
    final_norm: torch.Tensor         # [B]


def _edot(a, b):
    """Per-element dot products [B] of [B, n] tensors."""
    return torch.sum(a * b, dim=1)


def conjugate_gradients_batched(
        apply_A: Callable,
        b,
        x0,
        apply_preconditioner: Callable = None,
        max_iterations: int = 100,
        min_iterations: int = 0,
        q_tolerance: float = 0.0,
        r_tolerance: float = 0.0,
        residual_reset_period: int = 10) -> BatchedCGResult:
    """`conjugate_gradients` on B independent systems at once: b and x0
    [B, n], apply_A and apply_preconditioner map [B, n] to [B, n]. Each
    element runs the single loop's rules (the Q-based stop, the
    indefiniteness guard, the r-norm tolerance, the residual refresh)
    under its own mask: once it stops, its x, r and p keep their bits
    and its count stays, as under the JAX package's vmapped while_loop.
    The elements still running share one iteration count, so the refresh
    falls on the same iteration for all of them. One host read an
    iteration: is any element still running."""
    if apply_preconditioner is None:
        def apply_preconditioner(v):
            return v
    B = b.shape[0]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    tol_r = r_tolerance * torch.linalg.vector_norm(b, dim=1)
    if x0 is None:
        x0, r = torch.zeros_like(b), b
    else:
        r = b - apply_A(x0)
    x = x0
    z = apply_preconditioner(r)
    rho = _edot(r, z)
    p = z
    Q0 = 0.5 * _edot(x0, r + b)
    its = torch.zeros(B, dtype=torch.int64, device=b.device)
    active = torch.ones(B, dtype=torch.bool, device=b.device)
    i = 0
    while i < max_iterations and bool(active.any()):   # the one host read
        Ap = apply_A(p)
        pAp = _edot(p, Ap)
        bad = (pAp <= 0) | ~torch.isfinite(pAp)
        alpha = torch.where(bad, zero, rho / torch.where(pAp == 0, one, pAp))
        x_new = x + alpha[:, None] * p
        i += 1
        if i % residual_reset_period == 0:
            r_new = b - apply_A(x_new)
        else:
            r_new = r - alpha[:, None] * Ap
        z_new = apply_preconditioner(r_new)
        rho_new = _edot(r_new, z_new)
        beta = rho_new / torch.where(rho == 0, one, rho)
        p_new = z_new + beta[:, None] * p
        Q1 = 0.5 * _edot(x_new, r_new + b)
        zeta = i * (Q1 - Q0) / torch.where(Q1 == 0, one, Q1)
        done = bad
        if q_tolerance > 0 and i >= max(min_iterations, 1):
            done = done | ((Q1 != 0) & (torch.abs(zeta) < q_tolerance))
        if r_tolerance > 0:
            done = done | (torch.linalg.vector_norm(r_new, dim=1) <= tol_r)
        keep = active[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        rho = torch.where(active, rho_new, rho)
        Q0 = torch.where(active, Q1, Q0)
        its = its + active.long()
        active = active & ~done
    return BatchedCGResult(x=x, num_iterations=its,
                           final_norm=torch.linalg.vector_norm(r, dim=1))


def solve_cgnr(jac, res, D, apply_preconditioner=None,
               max_iterations: int = 100, q_tolerance: float = 1e-1,
               r_tolerance: float = 0.0, min_iterations: int = 0):
    """CGNR (ceres_tpu solvers/cg.py solve_cgnr; the reference's
    cgnr_solver.cc): CG on the normal equations (J^T J + D^T D) d =
    -J^T r, matrix-free over the bucketed BlockJacobian. On an f32
    Jacobian the operator J^T (J v) is K8, one launch per bucket (plain
    PyTorch on the CPU); on an f64 one it is the two products J^T (J v),
    as in the JAX package, whose J^T J v kernel takes f32 buckets only.
    Starts from x0 = 0 with r0 = b - A 0, as the JAX package does.
    Returns (d, iterations as an int32 tensor)."""
    DD = D * D

    if jac.buckets[0].J.dtype == torch.float32:
        def apply_A(v):
            return jac_normal_matvec(jac, v) + DD * v
    else:
        def apply_A(v):
            return jac.rmatvec(jac.matvec(v)) + DD * v

    b = -jac.rmatvec(res)
    result = conjugate_gradients(
        apply_A, b, torch.zeros_like(b),
        apply_preconditioner=apply_preconditioner,
        max_iterations=max_iterations, min_iterations=min_iterations,
        q_tolerance=q_tolerance, r_tolerance=r_tolerance)
    return result.x, result.num_iterations
