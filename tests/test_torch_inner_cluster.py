"""Inner iterations (minimizers/coordinate_descent.py) and the
visibility-clustered Schur preconditioners (solvers/clustering.py,
solvers/schur.py's CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL) of
ceres_tpu_torch against the JAX package, in f64 on the CPU.

- create_ordering's independent sets and is_ordering_valid's verdicts
  equal the JAX package's, block for block.
- Bundle adjustment with use_inner_iterations (the automatic ordering,
  and a user ordering of points then cameras): the JAX host loop's LM
  count, successful steps and inner-iteration steps, the final cost
  within 1e-9; an ordering whose group is not an independent set fails
  the solve up front with the JAX package's message.
- Visibility, canonical-views and single-linkage memberships and the
  degree-2 spanning forest equal the JAX package's element for element,
  on a 30-camera problem, for both clustering types and both kinds.
- One ITERATIVE_SCHUR step with each CLUSTER preconditioner (PCG to
  eta 1e-14, no Jacobi scaling, as tests/test_schur.py:164-185): its
  model cost change within 1e-10 of the JAX step's, and within 1e-4 of
  DENSE_NORMAL_CHOLESKY's (the JAX test's tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, jax_problem, small_bal, torch_problem

from ceres_tpu import solver as jax_solver
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.minimizers import coordinate_descent as jax_cd
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import clustering as jax_clustering
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build
from ceres_tpu_torch.minimizers import coordinate_descent as cd
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import GenericLMStep
from ceres_tpu_torch.solvers import clustering
from ceres_tpu_torch.solvers.schur import detect_schur_structure

COST_TOL = 1e-9


def _bal(cameras=30, points=400, observations=2000, seed=5):
    bal = synthetic_bal_problem(cameras, points, observations, seed=seed,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=seed + 1)
    return bal


def _pair(bal):
    """(JAX program, port program, JAX block arrays, port block arrays),
    the blocks in the problems' common insertion order."""
    pj, cj, xj = jax_build(bal)
    pt, c_t, xt = torch_build(bal)
    return (JaxProgram(pj), TorchProgram(pt, device="cpu"),
            list(cj) + list(xj), list(c_t) + list(xt))


def _index(blocks):
    return {id(a): i for i, a in enumerate(blocks)}


def test_create_ordering_and_validity_match_jax():
    jp, tp, bj, bt = _pair(_bal(cameras=8, points=60, observations=300))
    ij, it = _index(bj), _index(bt)
    groups_j = [sorted(ij[k] for k in g) for g in jax_cd.create_ordering(jp)]
    groups_t = [sorted(it[k] for k in g) for g in cd.create_ordering(tp)]
    assert groups_t == groups_j and len(groups_t) >= 2
    cams, pts = range(8), range(8, len(bj))
    for layout in ([pts, cams], [[0, 8], list(range(1, 8)) + list(
            range(9, len(bj)))]):
        oj, ot = ct.ParameterBlockOrdering(), ctt.ParameterBlockOrdering()
        for g, members in enumerate(layout):
            for i in members:
                oj.add_element_to_group(bj[i], g)
                ot.add_element_to_group(bt[i], g)
        assert cd.is_ordering_valid(tp, ot) == \
            jax_cd.is_ordering_valid(jp, oj)
    assert cd.is_ordering_valid(tp, ot) is False


def _ordering(mod, problem_blocks, groups):
    o = mod.ParameterBlockOrdering()
    for g, blocks in enumerate(groups):
        for b in blocks:
            o.add_element_to_group(b, g)
    return o


@pytest.mark.parametrize("ordering", ["automatic", "points_first",
                                      "invalid"])
def test_inner_iteration_solve_matches_jax(ordering):
    """DENSE_SCHUR in f64 with inner iterations on the small BAL problem
    (the host loop around the generic Schur step)."""
    runs = []
    for mod, build in ((ct, jax_build), (ctt, torch_build)):
        problem, cams, pts = build(small_bal())
        kw = dict(device="cpu") if mod is ctt else {}
        if ordering == "points_first":
            kw["inner_iteration_ordering"] = _ordering(mod, None,
                                                       [pts, cams])
        elif ordering == "invalid":
            kw["inner_iteration_ordering"] = _ordering(
                mod, None, [[cams[0], pts[0]] + list(pts[1:]),
                            list(cams[1:])])
        opts = mod.SolverOptions(
            linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
            use_inner_iterations=True, max_num_iterations=20, **kw)
        runs.append(mod.solve(opts, problem))
    s_j, s_t = runs
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.inner_iterations_used == s_j.inner_iterations_used
    if ordering == "invalid":
        assert str(s_t.termination_type) == "FAILURE"
        assert s_t.message == s_j.message
        return
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert s_t.num_inner_iteration_steps == s_j.num_inner_iteration_steps > 0
    assert abs(s_t.final_cost - s_j.final_cost) <= COST_TOL * s_j.final_cost


@pytest.fixture(scope="module")
def cluster_pair():
    jp, tp, _, _ = _pair(_bal())
    opts_j = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR)
    opts_t = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
        device="cpu")
    return jp, jax_detect(jp, opts_j), tp, detect_schur_structure(tp, opts_t)


def test_visibility_and_graph_match_jax(cluster_pair):
    jp, jm, tp, tm = cluster_pair
    vis_t = clustering.compute_visibility(tp, tm)
    assert vis_t == jax_clustering.compute_visibility(jp, jm)
    assert clustering.covisibility_graph(vis_t) == \
        jax_clustering.covisibility_graph(vis_t)


@pytest.mark.parametrize("kind", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
@pytest.mark.parametrize("clustering_type", ["CANONICAL_VIEWS",
                                             "SINGLE_LINKAGE"])
def test_memberships_and_forests_equal_jax(cluster_pair, kind,
                                           clustering_type):
    jp, jm, tp, tm = cluster_pair
    m_j, f_j = jax_clustering.cluster_membership(
        jp, jm, kind, clustering_type=clustering_type)
    m_t, f_t = clustering.cluster_membership(
        tp, tm, kind, clustering_type=clustering_type)
    assert np.array_equal(m_t, m_j) and m_t.dtype == m_j.dtype
    assert f_t == f_j
    assert int(m_t.max()) >= 1
    if kind == "CLUSTER_TRIDIAGONAL":
        assert f_t


@pytest.mark.parametrize("kind", ["CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_cluster_step_model_cost_change_matches_jax(kind):
    """tests/test_schur.py:164-185 on a 12-camera problem."""
    bal = _bal(cameras=12, points=150, observations=700, seed=3)
    radius = 1e4
    step_opts = dict(jacobi_scaling=False, max_linear_solver_iterations=1000,
                     eta=1e-14)
    jp = JaxProgram(jax_build(bal)[0])
    x0 = jp.initial_state()

    def jax_mcc(**kw):
        out = jax_solver.make_step_fn(jp, ct.SolverOptions(**kw))(
            x0, jnp.asarray(radius))
        return float(out["model_cost_change"])

    want = jax_mcc(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                   preconditioner_type=getattr(ct.PreconditionerType, kind),
                   **step_opts)
    dense = jax_mcc(
        linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY,
        jacobi_scaling=False)
    tp = TorchProgram(torch_build(bal)[0], device="cpu")
    opts = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=getattr(ctt.PreconditionerType, kind),
        device="cpu", **step_opts)
    step = GenericLMStep(tp, opts)
    assert step.linear.schur.masks is not None
    art = step.linearize(tp.initial_state(), None, first=True)
    got = float(step.solve(art, radius)["model_cost_change"])
    assert abs(got - want) <= 1e-10 * abs(want)
    assert abs(got - dense) <= 1e-4 * abs(dense)
