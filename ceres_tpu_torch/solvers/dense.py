"""Dense linear solvers: DENSE_QR and DENSE_NORMAL_CHOLESKY.

Counterpart of ceres_tpu/solvers/dense.py (solve_dense_qr, :23;
solve_dense_normal_cholesky, :34; the reference's DenseQRSolver and
DenseNormalCholeskySolver). Both solve the damped least-squares step

    min_d ||J d + r||^2 + ||diag(D) d||^2

(the (J; D) augmented system of levenberg_marquardt_strategy.cc:68) with
PyTorch's factorizations (LAPACK on the CPU, cuSOLVER on the card). The
JAX package computes them with jnp.linalg outside any Pallas kernel, so
they are library products here too, not kernels to port. The normal
matrix comes from `BlockJacobian.jtj_dense`, summed in a fixed order.
"""

from __future__ import annotations

import torch

from ..ops.bsr import BlockJacobian, RVec


def _iters(device):
    return torch.ones((), dtype=torch.int32, device=device)


def solve_dense_qr(jac: BlockJacobian, res: RVec, D):
    """QR of the augmented matrix [J; diag(D)] (the reference's
    dense_qr.cc EigenDenseQR). Returns (d, 1 as an int32 tensor)."""
    J = jac.to_dense()
    n = J.shape[1]
    A = torch.cat([J, torch.diag(D)])
    b = torch.cat([-res.flatten(), J.new_zeros(n)])
    Q, R = torch.linalg.qr(A)
    d = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)
    return d[:, 0], _iters(J.device)


def _cholesky(H):
    """Lower Cholesky factor of H, all NaN when H is not positive definite
    (as the JAX package's factorization gives); nothing is read on the
    host."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _cho_solve(L, b):
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def cholesky_solve(S, b):
    """y with S y = b for a dense SPD S [m, m] (or a batch [B, m, m] with
    b [B, m]) by the library Cholesky
    (torch.linalg.cholesky_ex: cuSOLVER on the card, LAPACK on the CPU),
    all NaN when S is not positive definite; nothing is read on the
    host."""
    return _cho_solve(_cholesky(S), b)


def solve_dense_normal_cholesky(jac: BlockJacobian, res: RVec, D,
                                mixed_precision: bool = False,
                                refinement_iterations: int = 0):
    """Cholesky of J^T J + D^T D (dense_normal_cholesky_solver.cc).
    mixed_precision factorizes in f32 and refines the solution in the
    Jacobian's precision, at least once (the reference's
    RefinedDenseCholesky, iterative_refiner.cc). Returns (d, 1 as an
    int32 tensor)."""
    H = jac.jtj_dense() + torch.diag(D * D)
    g = -jac.rmatvec(res)
    if not mixed_precision:
        return _cho_solve(_cholesky(H), g), _iters(H.device)
    L = _cholesky(H.to(torch.float32))
    d = _cho_solve(L, g.to(torch.float32)).to(H.dtype)
    for _ in range(max(1, refinement_iterations)):
        corr = _cho_solve(L, (g - H @ d).to(torch.float32))
        d = d + corr.to(H.dtype)
    return d, _iters(H.device)
