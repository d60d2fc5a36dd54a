"""Fields-of-Experts image denoising.

Counterpart of ceres_tpu/examples/denoising.py (the reference's
examples/denoising.cc and fields_of_experts.{h,cc}): minimize the data
terms (x_p - n_p) / sigma plus, for every filter i and every patch
position, the linear filter response F_i . X under the
FieldsOfExpertsLoss rho(s) = alpha_i log(1 + s/2): a large sparse grid
problem, the reference's CGNR workload. Each pixel is a 1-element
parameter block and all patch positions of one filter form one bucket,
as in the JAX package. With CGNR + JACOBI, mixed and fused, the solve runs
K8 (J^T J v) on every CG application and K9 (the block-Jacobi Grams) on
every linearization.

    python -m ceres_tpu_torch.examples.denoising --input noisy.pgm
        --foe filters.foe [--output out.pgm] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import ceres_tpu_torch as ctt


class FieldsOfExperts:
    """Loader for the .foe filter files (fields_of_experts.cc
    LoadFromFile). Format: 'size num_filters', x-coords, y-coords,
    alphas, then one row of size*size coefficients per filter."""

    def __init__(self, path: str):
        with open(path) as f:
            vals = f.read().split()
        it = iter(vals)
        self.size = int(next(it))
        self.num_filters = int(next(it))
        n = self.size * self.size
        self.x = [int(float(next(it))) for _ in range(n)]
        self.y = [int(float(next(it))) for _ in range(n)]
        self.alpha = [float(next(it)) for _ in range(self.num_filters)]
        self.filters = [
            np.asarray([float(next(it)) for _ in range(n)])
            for _ in range(self.num_filters)]

    @property
    def num_variables(self):
        return self.size * self.size


def write_foe(path: str, size: int, alphas, filters):
    """Write a .foe file (the format FieldsOfExperts reads; the patch
    offsets in row-major order)."""
    xs = [k % size for k in range(size * size)]
    ys = [k // size for k in range(size * size)]
    lines = [f"{size} {len(alphas)}", " ".join(map(str, xs)),
             " ".join(map(str, ys)), " ".join(repr(float(a)) for a in alphas)]
    lines += [" ".join(repr(float(c)) for c in np.asarray(f).ravel())
              for f in filters]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


class FoECost(ctt.SizedCostFunction):
    """Linear filter response over a patch of 1-pixel parameter blocks
    (fields_of_experts.h:60 FieldsOfExpertsCost), with its analytic
    Jacobian (the filter coefficients)."""

    def __init__(self, coefficients):
        coefficients = np.asarray(coefficients)
        super().__init__(1, [1] * coefficients.size)
        self.coefficients = coefficients

    def residuals(self, *pixels):
        patch = torch.stack([p[0] for p in pixels])
        return torch.dot(self.coefficients.to(patch), patch)[None]

    def jacobians(self, *pixels):
        return [torch.reshape(self.coefficients[k], (1, 1))
                for k in range(len(pixels))]


class FieldsOfExpertsLoss(ctt.LossFunction):
    """rho(s) = alpha log(1 + s/2) (fields_of_experts.h:75)."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def evaluate(self, s):
        half = 0.5 * s
        return (self.alpha * torch.log1p(half),
                self.alpha * 0.5 / (1.0 + half),
                self.alpha * (-0.25) / (1.0 + half) ** 2)


class QuadraticCostFunction:
    """a * (x - b) data term (denoising.cc QuadraticCostFunction)."""

    def __init__(self, a: float, b: float):
        self.a = a
        self.b = b

    def __call__(self, x):
        return self.a * (x - self.b)


def build_denoising_problem(noisy_image: np.ndarray, foe: FieldsOfExperts,
                            sigma: float = 20.0):
    """denoising.cc CreateProblem. Returns (problem, pixels [h][w] of
    1-element arrays)."""
    h, w = noisy_image.shape
    pixels = [[np.asarray([noisy_image[r, c]]) for c in range(w)]
              for r in range(h)]
    problem = ctt.Problem()
    a = 1.0 / sigma
    for r in range(h):
        for c in range(w):
            problem.add_residual_block(
                ctt.AutoDiffCostFunction(
                    QuadraticCostFunction(a, noisy_image[r, c]), 1, [1]),
                None, pixels[r][c])
    size = foe.size
    for i in range(foe.num_filters):
        cost_coeffs = foe.filters[i]
        loss = FieldsOfExpertsLoss(foe.alpha[i])
        for r in range(h - size + 1):
            for c in range(w - size + 1):
                blocks = [pixels[r + foe.y[k]][c + foe.x[k]]
                          for k in range(foe.num_variables)]
                problem.add_residual_block(FoECost(cost_coeffs), loss,
                                           *blocks)
    return problem, pixels


def pixels_to_image(pixels):
    return np.asarray([[p[0] for p in row] for row in pixels])


def total_variation(img):
    return (np.abs(np.diff(img, axis=0)).sum()
            + np.abs(np.diff(img, axis=1)).sum())


def main(argv=None):
    from ..io.pgm import read_pgm, write_pgm
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--foe", required=True)
    ap.add_argument("--output")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--max_iterations", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    img = read_pgm(args.input)
    problem, pixels = build_denoising_problem(img, FieldsOfExperts(args.foe),
                                              args.sigma)
    options = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.CGNR,
        preconditioner_type=ctt.PreconditionerType.JACOBI,
        max_num_iterations=args.max_iterations,
        max_linear_solver_iterations=50, device=args.device)
    summary = ctt.solve(options, problem)
    print(summary.full_report())
    out = pixels_to_image(pixels)
    print(f"total variation {total_variation(img):.6g} -> "
          f"{total_variation(out):.6g}")
    if args.output:
        write_pgm(args.output, out)


if __name__ == "__main__":
    main()
