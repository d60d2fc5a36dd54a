"""NIST StRD suite runner (the reference's examples/nist.cc CLI).

Counterpart of ceres_tpu/examples/nist_runner.py: for every NIST file in
a directory, both certified starting points, LM + DENSE_QR at tolerances
of 1e-18, with one retry by dogleg when LM lands on a degenerate Jacobian
column or fails; prints each problem's LRE and the average.

    python -m ceres_tpu_torch.examples.nist_runner DATA_DIR [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def _degenerate_column(problem, device="cuda") -> bool:
    """True when the Jacobian at the current state has a (near-)dead
    column: the model has become insensitive to a parameter (e.g.
    BoxBOD's constant-model plateau), found by Problem.evaluate from the
    solver's own state; no certified data involved."""
    _, _, _, jac = problem.evaluate(want_residuals=False,
                                    want_jacobian=True, device=device)
    cn = np.sqrt(np.sum(np.asarray(jac) ** 2, axis=0))
    return bool(cn.min() < 1e-10 * max(cn.max(), 1.0))


def run_suite(data_dir: str, verbose: bool = True,
              linear_solver: str = "DENSE_QR",
              dogleg_fallback: bool = True, device: str = "cuda"):
    """LM + DENSE_QR (the reference nist.cc configuration), with one
    retry: when LM lands on a state with a degenerate Jacobian column (or
    fails outright), solve again with TRADITIONAL_DOGLEG and keep the run
    with the lower final cost. The certified values enter the LRE only.
    Returns ({name: [LRE a start]}, average LRE, {name: [summary a
    start]})."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.io.nist import (build_nist_problem, compute_lre,
                                         load_nist_suite)

    def make_options(strategy):
        return ctt.SolverOptions(
            linear_solver_type=ctt.LinearSolverType[linear_solver],
            trust_region_strategy_type=strategy,
            dogleg_type=ctt.DoglegType.TRADITIONAL_DOGLEG,
            max_num_iterations=10000,
            function_tolerance=1e-18,
            gradient_tolerance=1e-18,
            parameter_tolerance=1e-18,
            initial_trust_region_radius=1e4, device=device)

    results, summaries = {}, {}
    for nist in load_nist_suite(data_dir):
        lres, sums = [], []
        for start in range(nist.starts.shape[0]):
            problem, b = build_nist_problem(nist, start)
            summary = ctt.solve(make_options(
                ctt.TrustRegionStrategyType.LEVENBERG_MARQUARDT), problem)
            retried = ""
            if dogleg_fallback and (
                    summary.termination_type
                    != ctt.TerminationType.CONVERGENCE
                    or _degenerate_column(problem, device)):
                problem2, b2 = build_nist_problem(nist, start)
                summary2 = ctt.solve(make_options(
                    ctt.TrustRegionStrategyType.DOGLEG), problem2)
                if (summary2.termination_type
                        == ctt.TerminationType.CONVERGENCE
                        and summary2.final_cost < summary.final_cost):
                    summary, b = summary2, b2
                    retried = " [dogleg retry]"
            lre = compute_lre(b, nist.certified)
            lres.append(lre)
            sums.append(summary)
            if verbose:
                print(f"{nist.name:10s} start{start + 1}: LRE {lre:5.2f}  "
                      f"cost {summary.final_cost:.10e} "
                      f"(certified {nist.certified_cost:.10e}) "
                      f"iters {summary.num_iterations}{retried}")
        results[nist.name] = lres
        summaries[nist.name] = sums
    all_lres = [v for lres in results.values() for v in lres]
    avg = float(np.mean(all_lres)) if all_lres else float("nan")
    if verbose:
        solved = sum(1 for v in all_lres if v >= 4.0)
        print(f"\naverage LRE: {avg:.2f} over {len(all_lres)} configs; "
              f"solved (LRE>=4): {solved}")
    return results, avg, summaries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_suite(args.data_dir, device=args.device)


if __name__ == "__main__":
    main()
