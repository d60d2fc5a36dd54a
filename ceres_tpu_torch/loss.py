"""Robust loss functions rho(s) and the Triggs corrector, on torch tensors.

Counterpart of ceres_tpu/loss.py (the reference's loss_function.h:87-392
and corrector.cc). `evaluate(s) -> (rho, rho', rho'')` on the squared
residual norm s = ||r||^2, elementwise over a batch of residual blocks;
every branch is a `torch.where`, so one call covers the whole batch.
A loss's scalar attributes may also be tensors of s's shape, one value a
residual block (`stacked_loss`: the program's per-row loss parameters,
ceres_tpu program.py _bucket_loss); they broadcast against s, and the
result takes their dtype where it is wider, as the JAX package's does.
"""

from __future__ import annotations

import math

import torch


def _full(s, v):
    """v at every entry of s: a number in s's dtype, a per-row tensor
    broadcast to s's shape."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v, s.shape)
    return torch.full_like(s, v)


def stacked_loss(loss, attrs: dict):
    """A copy of the flat loss `loss` whose attributes named in `attrs`
    are replaced (by tensors of one value a residual block)."""
    obj = object.__new__(type(loss))
    object.__setattr__(obj, "__dict__", {**vars(loss), **attrs})
    return obj


class LossFunction:
    """Base class. Subclasses implement evaluate(s) -> (rho0, rho1, rho2)."""

    def evaluate(self, s):
        raise NotImplementedError

    def __call__(self, s):
        return self.evaluate(s)


class TrivialLoss(LossFunction):
    """rho(s) = s (loss_function.h:87)."""

    def evaluate(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


class HuberLoss(LossFunction):
    """Quadratic near zero, linear in the tails (loss_function.h:132)."""

    def __init__(self, a: float):
        self.a = float(a)
        self.b = self.a * self.a

    def evaluate(self, s):
        r = torch.sqrt(torch.clamp(s, min=self.b))
        out_rho0 = 2.0 * self.a * r - self.b
        out_rho1 = self.a / r
        out_rho2 = -0.5 * out_rho1 / torch.clamp(s, min=self.b)
        inlier = s <= self.b
        return (torch.where(inlier, s, out_rho0),
                torch.where(inlier, torch.ones_like(s), out_rho1),
                torch.where(inlier, torch.zeros_like(s), out_rho2))


class SoftLOneLoss(LossFunction):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1) (loss_function.h:175)."""

    def __init__(self, a: float):
        self.b = float(a) * float(a)
        self.c = 1.0 / self.b

    def evaluate(self, s):
        total = 1.0 + s * self.c
        tmp = torch.sqrt(total)
        return (2.0 * self.b * (tmp - 1.0), 1.0 / tmp,
                -self.c / (2.0 * total * tmp))


class CauchyLoss(LossFunction):
    """rho(s) = b log(1 + s/b) (loss_function.h:191)."""

    def __init__(self, a: float):
        self.b = float(a) * float(a)
        self.c = 1.0 / self.b

    def evaluate(self, s):
        total = 1.0 + s * self.c
        inv = 1.0 / total
        return self.b * torch.log(total), inv, -self.c * inv * inv


class ArctanLoss(LossFunction):
    """rho(s) = a atan(s/a) (loss_function.h:208)."""

    def __init__(self, a: float):
        self.a = float(a)
        self.b = 1.0 / (self.a * self.a)

    def evaluate(self, s):
        total = 1.0 + s * s * self.b
        inv = 1.0 / total
        return (self.a * torch.atan2(s, _full(s, self.a)), inv,
                -2.0 * s * self.b * inv * inv)


class TolerantLoss(LossFunction):
    """Flat near zero up to `a`, then linear (loss_function.h:229)."""

    def __init__(self, a: float, b: float):
        if not (a >= 0.0 and b > 0.0):
            raise ValueError("TolerantLoss needs a >= 0 and b > 0")
        self.a = float(a)
        self.b = float(b)
        self.c = self.b * math.log1p(math.exp(-self.a / self.b))

    def evaluate(self, s):
        x = (s - self.a) / self.b
        big = x > 35.0
        softplus = torch.where(big, x,
                               torch.log1p(torch.exp(torch.clamp(x, max=35.0))))
        sig = torch.where(big, torch.ones_like(x),
                          1.0 / (1.0 + torch.exp(
                              -torch.clamp(torch.abs(x), max=35.0))))
        e = torch.exp(torch.clamp(x, min=-35.0))
        sig = torch.where(x < 0, e / (1.0 + e), sig)
        return (self.b * softplus - self.c, sig,
                sig * (1.0 - sig) / self.b)


class TukeyLoss(LossFunction):
    """Tukey biweight (loss_function.h:268)."""

    def __init__(self, a: float):
        self.a2 = float(a) * float(a)

    def evaluate(self, s):
        value = torch.clamp(1.0 - s / self.a2, min=0.0)
        inlier = s <= self.a2
        return (torch.where(inlier, self.a2 / 6.0 * (1.0 - value ** 3),
                            _full(s, self.a2 / 6.0)),
                torch.where(inlier, 0.5 * value * value,
                            torch.zeros_like(s)),
                torch.where(inlier, -value / self.a2, torch.zeros_like(s)))


class ComposedLoss(LossFunction):
    """rho(s) = f(g(s)) (loss_function.h:287)."""

    def __init__(self, f: LossFunction, g: LossFunction):
        self.f = f
        self.g = g

    def evaluate(self, s):
        g0, g1, g2 = self.g.evaluate(s)
        f0, f1, f2 = self.f.evaluate(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


class ScaledLoss(LossFunction):
    """a * rho(s); None inner means a * s (loss_function.h:299)."""

    def __init__(self, rho, a: float):
        self.rho = rho if rho is not None else TrivialLoss()
        self.a = float(a)

    def evaluate(self, s):
        r0, r1, r2 = self.rho.evaluate(s)
        return self.a * r0, self.a * r1, self.a * r2


class LossFunctionWrapper(LossFunction):
    """Mutable holder for swapping the loss between solves
    (loss_function.h:330)."""

    def __init__(self, rho, ownership=None):
        self.rho = rho

    def reset(self, rho, ownership=None):
        self.rho = rho

    def evaluate(self, s):
        if self.rho is None:
            return TrivialLoss().evaluate(s)
        return self.rho.evaluate(s)


def correct_residuals_and_jacobian(loss, residuals, jacobian):
    """Triggs robust-loss correction of a batch of residual blocks
    (corrector.cc), vectorized over the leading axes.

    residuals [..., r]; jacobian [..., r, t] or None. Returns
    (cost_per_block [...], corrected residuals, corrected jacobian) with
    cost_per_block = 0.5 * rho(||r||^2)."""
    sq_norm = torch.sum(residuals * residuals, dim=-1)
    if loss is None:
        return 0.5 * sq_norm, residuals, jacobian

    rho0, rho1, rho2 = loss.evaluate(sq_norm)
    cost = 0.5 * rho0
    sqrt_rho1 = torch.sqrt(torch.clamp(rho1, min=0.0))
    # pure rescale when rho2 <= 0 or ||r|| == 0 (corrector.cc:60)
    simple = (sq_norm == 0.0) | (rho2 <= 0.0)
    safe_sq = torch.where(sq_norm == 0.0, torch.ones_like(sq_norm), sq_norm)
    safe_rho1 = torch.where(rho1 == 0.0, torch.ones_like(rho1), rho1)
    D = 1.0 + 2.0 * sq_norm * rho2 / safe_rho1
    alpha = 1.0 - torch.sqrt(torch.clamp(D, min=0.0))
    residual_scaling = torch.where(simple, sqrt_rho1,
                                   sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = torch.where(simple, torch.zeros_like(alpha),
                                alpha / safe_sq)
    corrected_residuals = residuals * residual_scaling[..., None]
    corrected_jacobian = None
    if jacobian is not None:
        # J <- sqrt(rho1) (I - alpha_sq_norm r r^T) J   (corrector.cc:110)
        rTJ = torch.einsum("...r,...rt->...t", residuals, jacobian)
        corrected_jacobian = sqrt_rho1[..., None, None] * (
            jacobian - alpha_sq_norm[..., None, None]
            * residuals[..., :, None] * rTJ[..., None, :])
    return cost, corrected_residuals, corrected_jacobian
