"""Moré-Garbow-Hillstrom test problems, with bounds.

Counterpart of ceres_tpu/examples/more_garbow_hillstrom.py (the
reference's examples/more_garbow_hillstrom.cc: the 19 problems of Moré,
Garbow and Hillstrom, ACM TOMS 7(1) 1981, with bounds and constrained
optima from Gay 1984), on `device` (default cuda). Each problem is one
residual functor over one parameter block, written over the data
dimension with torch operations; jacfwd gives its Jacobian. A problem
is solved when the log relative error of the objective (f = 2 *
final_cost) against its known optimum is >= 4
(more_garbow_hillstrom.cc:572-576).

    python -m ceres_tpu_torch.examples.more_garbow_hillstrom
        [--problem N] [--constrained] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch


@dataclass
class MGHProblem:
    number: int
    name: str
    num_residuals: int
    residual_fn: Callable
    initial_x: List[float]
    lower_bounds: List[float]
    upper_bounds: List[float]
    constrained_optimal_cost: float  # sum of squares f*, NaN if no bounds
    unconstrained_optimal_cost: float


def _stack(values):
    return torch.stack(values)


def _arange(x, *args):
    """torch.arange in x's dtype and on its device."""
    return torch.arange(*args, dtype=x.dtype, device=x.device)


def _const(x, values):
    """A constant vector in x's dtype and on its device."""
    return torch.as_tensor(np.asarray(values, dtype=np.float64)).to(x)


INF = float("inf")


@dataclass
class MGHProblem:
    number: int
    name: str
    num_residuals: int
    residual_fn: Callable
    initial_x: List[float]
    lower_bounds: List[float]
    upper_bounds: List[float]
    constrained_optimal_cost: float  # sum of squares f*, NaN if no bounds
    unconstrained_optimal_cost: float


def _p1(x):  # Rosenbrock
    return _stack([10.0 * (x[1] - x[0] * x[0]), 1.0 - x[0]])


def _p2(x):  # Freudenstein and Roth
    x1, x2 = x[0], x[1]
    return _stack([
        -13.0 + x1 + ((5.0 - x2) * x2 - 2.0) * x2,
        -29.0 + x1 + ((x2 + 1.0) * x2 - 14.0) * x2,
    ])


def _p3(x):  # Powell badly scaled
    return _stack([1e4 * x[0] * x[1] - 1.0,
                      torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001])


def _p4(x):  # Brown badly scaled
    return _stack([x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2.0])


def _p5(x):  # Beale
    x1, x2 = x[0], x[1]
    return _stack([1.5 - x1 * (1.0 - x2),
                      2.25 - x1 * (1.0 - x2 * x2),
                      2.625 - x1 * (1.0 - x2 * x2 * x2)])


def _p6(x):  # Jennrich and Sampson
    i = _arange(x, 1.0, 11.0)
    return 2.0 + 2.0 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))


def _p7(x):  # Helical valley
    x1, x2, x3 = x[0], x[1], x[2]
    theta = (0.5 / math.pi) * torch.atan(x2 / x1) \
        + torch.where(x1 > 0.0, torch.zeros_like(x1),
                    torch.full_like(x1, 0.5))
    return _stack([10.0 * (x3 - 10.0 * theta),
                      10.0 * (torch.sqrt(x1 * x1 + x2 * x2) - 1.0),
                      x3])


_P8_Y = np.array([0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37,
                  0.58, 0.73, 0.96, 1.34, 2.10, 4.39])


def _p8(x):  # Bard
    i = _arange(x, 1.0, 16.0)
    u, v = i, 16.0 - i
    w = torch.minimum(u, v)
    return _const(x, _P8_Y) - (x[0] + u / (v * x[1] + w * x[2]))


_P9_Y = np.array([0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521,
                  0.3989, 0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044,
                  0.0009])


def _p9(x):  # Gaussian
    t = (8.0 - _arange(x, 15.0) - 1.0) / 2.0
    return x[0] * torch.exp(-x[1] * (t - x[2]) ** 2 / 2.0) - _const(x, _P9_Y)


_P10_Y = np.array([34780, 28610, 23650, 19630, 16370, 13720, 11540, 9744,
                   8261, 7030, 6005, 5147, 4427, 3820, 3307, 2872],
                  dtype=np.float64)


def _p10(x):  # Meyer
    t = 45.0 + 5.0 * _arange(x, 1.0, 17.0)
    return x[0] * torch.exp(x[1] / (t + x[2])) - _const(x, _P10_Y)


def _p11(x):  # Gulf research and development
    i = _arange(x, 1.0, 101.0)
    t = i / 100.0
    y = 25.0 + (-50.0 * torch.log(t)) ** (2.0 / 3.0)
    return torch.exp(-torch.abs(y * 100.0 * i * x[1]) ** x[2] / x[0]) - t


def _p12(x):  # Box three-dimensional
    t = _const(x, [0.1, 0.2, 0.3])
    return (torch.exp(-t * x[0]) - torch.exp(-t * x[1])
            - x[2] * (torch.exp(-t) - torch.exp(-10.0 * t)))


def _p13(x):  # Powell singular
    return _stack([
        x[0] + 10.0 * x[1],
        math.sqrt(5.0) * (x[2] - x[3]),
        (x[1] - 2.0 * x[2]) ** 2,
        math.sqrt(10.0) * (x[0] - x[3]) ** 2,
    ])


def _p14(x):  # Wood
    return _stack([
        10.0 * (x[1] - x[0] * x[0]),
        1.0 - x[0],
        math.sqrt(90.0) * (x[3] - x[2] * x[2]),
        1.0 - x[2],
        math.sqrt(10.0) * (x[1] + x[3] - 2.0),
        (x[1] - x[3]) / math.sqrt(10.0),
    ])


_P15_Y = np.array([0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456,
                   0.0342, 0.0323, 0.0235, 0.0246])
_P15_U = np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833,
                   0.0714, 0.0625])


def _p15(x):  # Kowalik and Osborne
    u = _const(x, _P15_U)
    return _const(x, _P15_Y) - x[0] * (u * u + u * x[1]) / (
        u * u + u * x[2] + x[3])


def _p16(x):  # Brown and Dennis
    t = _arange(x, 1.0, 21.0) / 5.0
    return ((x[0] + t * x[1] - torch.exp(t)) ** 2
            + (x[2] + x[3] * torch.sin(t) - torch.cos(t)) ** 2)


_P17_Y = np.array([0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850,
                   0.818, 0.784, 0.751, 0.718, 0.685, 0.658, 0.628, 0.603,
                   0.580, 0.558, 0.538, 0.522, 0.506, 0.490, 0.478, 0.467,
                   0.457, 0.448, 0.438, 0.431, 0.424, 0.420, 0.414, 0.411,
                   0.406])


def _p17(x):  # Osborne 1
    t = 10.0 * _arange(x, 33.0)
    return _const(x, _P17_Y) - (x[0] + x[1] * torch.exp(-t * x[3])
                     + x[2] * torch.exp(-t * x[4]))


def _p18(x):  # Biggs EXP6
    t = 0.1 * _arange(x, 1.0, 14.0)
    y = torch.exp(-t) - 5.0 * torch.exp(-10.0 * t) + 3.0 * torch.exp(-4.0 * t)
    return (x[2] * torch.exp(-t * x[0]) - x[3] * torch.exp(-t * x[1])
            + x[5] * torch.exp(-t * x[4]) - y)


_P19_Y = np.array([1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847,
                   0.786, 0.725, 0.746, 0.679, 0.608, 0.655, 0.616, 0.606,
                   0.602, 0.626, 0.651, 0.724, 0.649, 0.649, 0.694, 0.644,
                   0.624, 0.661, 0.612, 0.558, 0.533, 0.495, 0.500, 0.423,
                   0.395, 0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429,
                   0.523, 0.562, 0.607, 0.653, 0.672, 0.708, 0.633, 0.668,
                   0.645, 0.632, 0.591, 0.559, 0.597, 0.625, 0.739, 0.710,
                   0.729, 0.720, 0.636, 0.581, 0.428, 0.292, 0.162, 0.098,
                   0.054])


def _p19(x):  # Osborne 2
    t = _arange(x, 65.0) / 10.0
    return _const(x, _P19_Y) - (x[0] * torch.exp(-t * x[4])
                     + x[1] * torch.exp(-(t - x[8]) ** 2 * x[5])
                     + x[2] * torch.exp(-(t - x[9]) ** 2 * x[6])
                     + x[3] * torch.exp(-(t - x[10]) ** 2 * x[7]))


NAN = float("nan")

PROBLEMS = [
    MGHProblem(1, "Rosenbrock", 2, _p1, [-1.2, 1.0],
               [-INF, -INF], [INF, INF], NAN, 0.0),
    MGHProblem(2, "FreudensteinRoth", 2, _p2, [0.5, -2.0],
               [-INF, -INF], [INF, INF], NAN, 0.0),
    MGHProblem(3, "PowellBadlyScaled", 2, _p3, [0.0, 1.0],
               [0.0, 1.0], [1.0, 9.0], 0.15125900e-9, 0.0),
    MGHProblem(4, "BrownBadlyScaled", 3, _p4, [1.0, 1.0],
               [0.0, 0.00003], [1000000.0, 100.0], 0.78400000e3, 0.0),
    MGHProblem(5, "Beale", 3, _p5, [1.0, 1.0],
               [0.6, 0.5], [10.0, 100.0], 0.0, 0.0),
    MGHProblem(6, "JennrichSampson", 10, _p6, [1.0, 1.0],
               [-INF, -INF], [INF, INF], NAN, 124.362),
    MGHProblem(7, "HelicalValley", 3, _p7, [-1.0, 0.0, 0.0],
               [-100.0, -1.0, -1.0], [0.8, 1.0, 1.0], 0.99042212, 0.0),
    MGHProblem(8, "Bard", 15, _p8, [1.0, 1.0, 1.0],
               [-INF] * 3, [INF] * 3, NAN, 8.21487e-3),
    MGHProblem(9, "Gaussian", 15, _p9, [0.4, 1.0, 0.0],
               [0.398, 1.0, -0.5], [4.2, 2.0, 0.1],
               0.11279300e-7, 0.112793e-7),
    MGHProblem(10, "Meyer", 16, _p10, [0.02, 4000.0, 250.0],
               [-INF] * 3, [INF] * 3, NAN, 87.9458),
    MGHProblem(11, "Gulf", 100, _p11, [5.0, 2.5, 0.15],
               [1e-16, 0.0, 0.0], [10.0, 10.0, 10.0], 0.58281431e-4, 0.0),
    MGHProblem(12, "Box3D", 3, _p12, [0.0, 10.0, 20.0],
               [0.0, 5.0, 0.0], [2.0, 9.5, 20.0], 0.30998153e-5, 0.0),
    MGHProblem(13, "PowellSingular", 4, _p13, [3.0, -1.0, 0.0, 1.0],
               [-INF] * 4, [INF] * 4, NAN, 0.0),
    MGHProblem(14, "Wood", 6, _p14, [-3.0, -1.0, -3.0, -1.0],
               [-100.0] * 4, [0.0, 10.0, 100.0, 100.0], 0.15567008e1, 0.0),
    MGHProblem(15, "KowalikOsborne", 11, _p15, [0.25, 0.39, 0.415, 0.39],
               [-INF] * 4, [INF] * 4, NAN, 3.07505e-4),
    MGHProblem(16, "BrownDennis", 20, _p16, [25.0, 5.0, -5.0, -1.0],
               [-10.0, 0.0, -100.0, -20.0], [100.0, 15.0, 0.0, 0.2],
               0.88860479e5, 85822.2),
    MGHProblem(17, "Osborne1", 33, _p17, [0.5, 1.5, -1.0, 0.01, 0.02],
               [-INF] * 5, [INF] * 5, NAN, 5.46489e-5),
    MGHProblem(18, "BiggsEXP6", 13, _p18, [1.0, 2.0, 1.0, 1.0, 1.0, 1.0],
               [0.0, 0.0, 0.0, 1.0, 0.0, 0.0], [2.0, 8.0, 1.0, 7.0, 5.0, 5.0],
               0.53209865e-3, 0.0),
    MGHProblem(19, "Osborne2", 65, _p19,
               [1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5],
               [-INF] * 11, [INF] * 11, NAN, 4.01377e-2),
]

BY_NUMBER = {p.number: p for p in PROBLEMS}
BY_NAME = {p.name: p for p in PROBLEMS}


def solve_mgh(problem_def: MGHProblem, constrained: bool = False,
              trial: int = 0, options=None, device: str = "cuda"):
    """Solve one problem; returns (log relative error, summary, x).

    trial scales the start by 10**trial (the reference's trials 0..2,
    unconstrained); a constrained run starts at the nominal point clipped
    into the box. The LRE is of f = 2 * final_cost against the known
    optimum (more_garbow_hillstrom.cc:573-576)."""
    import ceres_tpu_torch as ctt

    n = len(problem_def.initial_x)
    x = np.asarray(problem_def.initial_x, dtype=np.float64) * (10.0 ** trial)
    if constrained:
        x = np.clip(np.asarray(problem_def.initial_x, dtype=np.float64),
                    problem_def.lower_bounds, problem_def.upper_bounds)

    problem = ctt.Problem()
    cost = ctt.AutoDiffCostFunction(problem_def.residual_fn,
                                    num_residuals=problem_def.num_residuals,
                                    parameter_block_sizes=[n])
    problem.add_residual_block(cost, None, x)
    optimal = problem_def.unconstrained_optimal_cost
    if constrained:
        for i in range(n):
            problem.set_parameter_lower_bound(x, i,
                                              problem_def.lower_bounds[i])
            problem.set_parameter_upper_bound(x, i,
                                              problem_def.upper_bounds[i])
        optimal = problem_def.constrained_optimal_cost

    if options is None:
        options = ctt.SolverOptions(
            parameter_tolerance=1e-18, function_tolerance=1e-18,
            gradient_tolerance=1e-18, max_num_iterations=1000,
            linear_solver_type=ctt.LinearSolverType.DENSE_QR, device=device)
    summary = ctt.solve(options, problem)

    f = 2.0 * summary.final_cost
    denom = optimal if optimal > 0.0 else 1.0
    if math.isnan(optimal):
        lre = float("nan")
    elif abs(f - optimal) == 0.0:
        lre = float("inf")
    else:
        lre = -math.log10(abs(f - optimal) / denom)
    return lre, summary, x


def run_all(constrained: bool = False, trials=(0, 1, 2), verbose=True,
            device: str = "cuda"):
    """{problem number: [LRE per trial]}; a constrained run takes one
    trial at the nominal start."""
    results = {}
    use_trials = (0,) if constrained else trials
    for p in PROBLEMS:
        if constrained and math.isnan(p.constrained_optimal_cost):
            continue
        lres = []
        for trial in use_trials:
            lre, summary, _ = solve_mgh(p, constrained=constrained,
                                        trial=trial, device=device)
            lres.append(lre)
            if verbose:
                tag = "C" if constrained else f"t{trial}"
                ok = "Yes" if lre >= 4.0 else "No "
                print(f"Problem {p.number:2d} {p.name:18s} {tag}: {ok} "
                      f"LRE {lre:6.2f} iters {summary.num_iterations}",
                      flush=True)
        results[p.number] = lres
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="all")
    ap.add_argument("--constrained", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.problem == "all":
        results = run_all(constrained=args.constrained, device=args.device)
        flat = [v for lres in results.values() for v in lres]
        print(f"solved {sum(1 for v in flat if v >= 4.0)}/{len(flat)}")
    else:
        p = BY_NUMBER[int(args.problem)]
        lre, summary, x = solve_mgh(p, constrained=args.constrained,
                                    device=args.device)
        print(f"{p.name}: LRE {lre:.2f}\n{summary.brief_report()}")


if __name__ == "__main__":
    main()
