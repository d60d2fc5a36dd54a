"""Batch mode of the port's solve_batched (ceres_tpu_torch/batch.py) on
the Schur configurations, on tests/test_torch_batch.py's BA graph
(tests/torch_batch_kit.py): ITERATIVE_SCHUR on the explicit S (f64 and
mixed), in the implicit mode (forced as the JAX package's
CERES_TPU_FORCE_IMPLICIT forces it), with SCHUR_POWER_SERIES_EXPANSION,
CLUSTER_JACOBI, CLUSTER_TRIDIAGONAL and the SPSE warm start on the
generic route; SPARSE_SCHUR below the dense cap and past it
(SPARSE_SCHUR_DENSE_NF lowered to 0, the JAX package's
CERES_TPU_FORCE_SPARSE_SCHUR); mixed DENSE_SCHUR with refinement; and
dogleg over DENSE_SCHUR. Each is held to the JAX package's
solve_batched(batch_mode="batch") and to the port's pipeline mode."""

import pytest

import torch_batch_kit as kit
from ceres_tpu_torch import batch as batch_mod
from ceres_tpu_torch.solvers import schur_fused, schur_sparse

# f64: the JAX batched run's counts and termination, the final cost
# within 1e-9 relative and the parameters within 1e-8; the same against
# pipeline mode. Mixed: the final cost within twice the function
# tolerance (1e-9), counts free (f32 rounding moves a CG count by one).
# Dogleg on bundle adjustment parts by rounding from the first steps
# (ROADMAP.md section 3: one element takes 4 LM iterations in one run and
# 25 in the other) and stops anywhere within the function tolerance of
# the minimum it reaches: its final cost within 5e-9.
F64_COST, F64_X, MIXED_COST, DOGLEG_COST = 1e-9, 1e-8, 2e-9, 5e-9

IS = dict(linear_solver_type="ITERATIVE_SCHUR")
MIXED = dict(use_mixed_precision_solves=True)
IMPLICIT = {"CERES_TPU_FORCE_IMPLICIT": 1}
SPARSE = {"CERES_TPU_FORCE_SPARSE_SCHUR": 1}

# name: (options, JAX switches, how it is held, the batched step's class)
CASES = {
    "explicit_schur_jacobi_f64": (
        dict(IS, preconditioner_type="SCHUR_JACOBI"), {}, "f64",
        "BatchedSchurStep"),
    "explicit_jacobi_f64": (
        dict(IS, preconditioner_type="JACOBI"), {}, "f64",
        "BatchedSchurStep"),
    "explicit_schur_jacobi_mixed": (
        dict(IS, **MIXED, preconditioner_type="SCHUR_JACOBI"), {}, "mixed",
        "BatchedSchurStep"),
    "implicit_schur_jacobi_mixed": (
        dict(IS, **MIXED, preconditioner_type="SCHUR_JACOBI"), IMPLICIT,
        "mixed", "BatchedImplicitStep"),
    "implicit_schur_jacobi_f64": (
        dict(IS, preconditioner_type="SCHUR_JACOBI"), IMPLICIT, "f64",
        "BatchedImplicitStep"),
    "power_series": (
        dict(IS, preconditioner_type="SCHUR_POWER_SERIES_EXPANSION"), {},
        "f64", "BatchedBlockStep"),
    "cluster_jacobi": (
        dict(IS, preconditioner_type="CLUSTER_JACOBI"), {}, "f64",
        "BatchedBlockStep"),
    "cluster_tridiagonal": (
        dict(IS, preconditioner_type="CLUSTER_TRIDIAGONAL"), {}, "f64",
        "BatchedBlockStep"),
    "spse_warm_start": (
        dict(IS, preconditioner_type="SCHUR_JACOBI",
             use_spse_initialization=True), {}, "f64", "BatchedBlockStep"),
    "sparse_schur_dense_s": (
        dict(linear_solver_type="SPARSE_SCHUR"), {}, "f64",
        "BatchedSchurStep"),
    "sparse_schur_block_sparse_s": (
        dict(linear_solver_type="SPARSE_SCHUR"), SPARSE, "f64",
        "BatchedBlockStep"),
    "dense_schur_refined": (
        dict(MIXED, linear_solver_type="DENSE_SCHUR",
             max_num_refinement_iterations=2), {}, "mixed",
        "BatchedBlockStep"),
    "dogleg_dense_schur": (
        dict(linear_solver_type="DENSE_SCHUR",
             trust_region_strategy_type="DOGLEG"), {}, "dogleg",
        "BatchedDoglegStep"),
}


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's batched run of every case, built once."""
    return {name: kit.jax_run("ba", jenv, **dict(kw))
            for name, (kw, jenv, _, _) in CASES.items()}


def _force(monkeypatch, jenv):
    """The port's counterparts of the JAX switches, and an empty template
    registry (its key does not see them)."""
    batch_mod._TEMPLATE_REGISTRY.clear()
    monkeypatch.setattr(batch_mod, "_TEMPLATE_REGISTRY", [])
    if "CERES_TPU_FORCE_IMPLICIT" in jenv:
        monkeypatch.setattr(schur_fused, "_explicit_viable",
                            lambda meta: False)
    if "CERES_TPU_FORCE_SPARSE_SCHUR" in jenv:
        monkeypatch.setattr(schur_sparse, "SPARSE_SCHUR_DENSE_NF", 0)


@pytest.mark.parametrize("name", list(CASES))
def test_batch_mode_matches_jax_and_pipeline(name, jax_refs, monkeypatch):
    kw, jenv, how, cls = CASES[name]
    _force(monkeypatch, jenv)
    elems = kit.elements("ba", kit.ctt)
    from ceres_tpu_torch.program import CompiledProgram
    opts = kit.options(kit.ctt, "ba", **dict(kw))
    step = batch_mod.make_batched_step(
        CompiledProgram.get_cached(elems[0][0], opts), opts)
    assert type(step).__name__ == cls
    ours = kit.run(kit.ctt, "ba", "batch", **dict(kw))
    pipe = kit.run(kit.ctt, "ba", "pipeline", **dict(kw))
    assert all(e[2] == "CONVERGENCE" for e in ours)
    if how == "f64":
        kit.held(ours, jax_refs[name], True, F64_COST, F64_X, "jax")
        kit.held(ours, pipe, True, F64_COST, F64_X, "pipeline")
    else:
        tol = DOGLEG_COST if how == "dogleg" else MIXED_COST
        kit.held(ours, jax_refs[name], False, tol, None, "jax")
        kit.held(ours, pipe, False, tol, None, "pipeline")


# the first batch-mode step of the implicit mode, f64, against the JAX
# package's batched step: model cost change and step norm within
# STEP_RTOL relative, the CG count equal; the mixed step (f32) must miss
# STEP_RTOL, so that the gate tells the two apart (chip_smoke.py's
# IMPLICIT part holds its elements so).
STEP_RTOL = 1e-9


def test_implicit_first_step_matches_jax(monkeypatch):
    kw = dict(IS, preconditioner_type="SCHUR_JACOBI")
    with kit.env(**IMPLICIT):
        want = kit.jax_first_steps(kit.options(kit.ct, "ba", **kw),
                                   [p for p, _ in kit.elements("ba", kit.ct)])
    _force(monkeypatch, IMPLICIT)
    errs = {}
    for mixed in (False, True):
        opts = kit.options(kit.ctt, "ba", use_mixed_precision_solves=mixed,
                           **kw)
        got = kit.port_first_steps(opts, [p for p, _ in
                                          kit.elements("ba", kit.ctt)])
        errs[mixed] = max(max(abs(g[0] - w[0]) / abs(w[0]),
                              abs(g[1] - w[1]) / abs(w[1]))
                          for g, w in zip(got, want))
        if not mixed:
            assert [g[2] for g in got] == [w[2] for w in want]
    assert errs[False] <= STEP_RTOL, errs
    assert errs[True] > STEP_RTOL, errs
