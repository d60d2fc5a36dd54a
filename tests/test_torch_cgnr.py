"""Slice 3 of ceres_tpu_torch end to end against ceres_tpu: pose-graph
SLAM on the generic LM step with CGNR (mixed precision, fused loop), on
the graphs of tests/test_pallas_linearize.py (SE3: 25 poses; SE2: 40),
for JACOBI and IDENTITY: the state layout and the f64 cost with the
quaternion and angle manifolds; one LM step against the JAX step
(make_step_fn on the CPU, where every bucket takes jacfwd and CGNR the
two-einsum operator); whole solves against ceres_tpu.solve; the
ITERATIVE_SCHUR -> CGNR downgrade; the configurations that still raise.

Tolerances: the f64 cost to 1e-12; one step's gradient to 1e-5 and its
model cost change, step and step norm to 5e-4 (the f32 CG amplifies
rounding by the damped system's conditioning, as in
test_torch_iterative.py), with the same CG count; a whole solve with the
same termination, LM count and accepted steps and a final cost within
1e-6 relative. The total CG count is equal on the SE3 graph; on SE2 graphs
it moves with f32 rounding of J, by up to 1 per cent (ROADMAP.md section
3: on this SE2 graph with IDENTITY, JAX 221, the port 222, and the port
with jacfwd instead of K11's plain version 224, all in 6 LM iterations to
the same cost).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import ct, ctt, rel

from ceres_tpu import solver as jax_solver
from ceres_tpu.examples import slam as jax_slam
from ceres_tpu.io import g2o as jax_g2o
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu_torch.examples import slam
from ceres_tpu_torch.io import g2o
from ceres_tpu_torch.ops.kernels import bucket_jtjv
from ceres_tpu_torch.ops.linearize import bucket_linearize
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import GenericLMStep
from chip_smoke import pose_graph_options

torch.set_num_threads(1)

GRAPHS = {"3d": dict(num_poses=25, seed=4, loop_every=5),
          "2d": dict(num_poses=40, seed=6)}
PRECONDITIONERS = ["JACOBI", "IDENTITY"]
RADIUS = 1e4                       # the initial trust-region radius


def _problem(mod, dim):
    pkg_slam, pkg_g2o = (jax_slam, jax_g2o) if mod is ct else (slam, g2o)
    poses, constraints, gt = getattr(
        pkg_g2o, f"synthetic_pose_graph_{dim}")(**GRAPHS[dim])
    problem, positions, rotations = getattr(
        pkg_slam, f"build_pose_graph_{dim}_problem")(poses, constraints)
    return problem, positions, rotations


def _options(mod, preconditioner, **extra):
    if mod is ctt:
        extra.setdefault("device", "cpu")
    extra.setdefault("preconditioner_type",
                     getattr(mod.PreconditionerType, preconditioner))
    return pose_graph_options(mod, **extra)


@pytest.mark.parametrize("dim", list(GRAPHS))
def test_state_layout_plus_and_cost_match_jax(dim):
    """A JAX state drives the port bitwise (state_from_numpy); Plus with
    the quaternion and angle manifolds and the f64 cost agree to 1e-12."""
    jp = JaxProgram(_problem(ct, dim)[0])
    tp = TorchProgram(_problem(ctt, dim)[0], device="cpu")
    xj = np.asarray(jp.initial_state())
    assert np.array_equal(tp.state_to_numpy(tp.initial_state()), xj)
    assert (tp.num_effective, tp.num_rows) == (jp.num_effective, jp.num_rows)
    assert np.array_equal(tp.state_to_numpy(tp.state_from_numpy(xj)), xj)
    rng = np.random.default_rng(0)
    d = 0.3 * rng.standard_normal(jp.num_effective)
    pj = np.asarray(jp.plus(jnp.asarray(xj), jnp.asarray(d)))
    pt = tp.state_to_numpy(tp.plus(tp.state_from_numpy(xj),
                                   torch.as_tensor(d)))
    assert rel(pt, pj) <= 1e-12
    cj = float(jp.cost_fn(jnp.asarray(pj)))
    assert abs(float(tp.cost_fn(tp.state_from_numpy(pj))) - cj) <= \
        1e-12 * cj


@pytest.mark.parametrize("preconditioner", PRECONDITIONERS)
@pytest.mark.parametrize("dim", list(GRAPHS))
def test_one_lm_step_matches_jax(dim, preconditioner):
    jp = JaxProgram.get_cached(_problem(ct, dim)[0],
                               _options(ct, preconditioner))
    opts_j = _options(ct, preconditioner)
    x0 = jp.initial_state()
    a = jax_solver.make_step_fn(jp, opts_j)(
        x0, jnp.asarray(RADIUS, jp.dtype),
        jax_solver.make_scale_fn(jp, opts_j)(x0))
    opts_t = _options(ctt, preconditioner)
    tp = TorchProgram.get_cached(_problem(ctt, dim)[0], opts_t)
    step = GenericLMStep(tp, opts_t)
    art = step.linearize(tp.initial_state(), *step.initial_scales(),
                         first=True)
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    assert b["lin_iters"].dtype == torch.int32
    assert abs(float(b["cost"]) - float(a["cost"])) <= 1e-12 * float(
        a["cost"])
    for k in ["gradient_max_norm", "gradient_norm", "model_cost_change",
              "delta", "step_norm"]:
        tol = 1e-5 if k.startswith("gradient") else 5e-4
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


@pytest.mark.parametrize("preconditioner", PRECONDITIONERS)
@pytest.mark.parametrize("dim", list(GRAPHS))
def test_cgnr_solve_matches_jax(dim, preconditioner):
    s_j = ct.solve(_options(ct, preconditioner), _problem(ct, dim)[0])
    problem, _, rotations = _problem(ctt, dim)
    bucket_jtjv.launches = bucket_linearize.launches = 0
    s_t = ctt.solve(_options(ctt, preconditioner), problem)
    assert bucket_jtjv.launches == bucket_linearize.launches == 0
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    cg_t, cg_j = (s_t.num_linear_solver_iterations,
                  s_j.num_linear_solver_iterations)
    assert cg_j > s_j.num_iterations
    assert abs(cg_t - cg_j) <= (0 if dim == "3d" else 0.01 * cg_j)
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost
    assert str(s_t.linear_solver_type_used) == "CGNR"
    assert str(s_t.preconditioner_type_used) == preconditioner
    if dim == "3d":        # the manifold keeps the quaternions unit
        for q in rotations.values():
            np.testing.assert_allclose(np.linalg.norm(q), 1.0, rtol=1e-9)
    else:                  # and the angles wrapped
        assert all(-np.pi <= y[0] <= np.pi for y in rotations.values())


def _curve_fit(mod, lib):
    """One parameter block [m, c], y = exp(m x + c): no Schur structure."""
    mc = np.array([0.0, 0.0])
    problem = mod.Problem()

    class Residual:
        def __init__(self, x, y):
            self.x, self.y = x, y

        def __call__(self, mc):
            return self.y - lib.exp(mc[0:1] * self.x + mc[1:2])

    for x in np.linspace(0.0, 5.0, 30):
        problem.add_residual_block(mod.AutoDiffCostFunction(
            Residual(x, float(np.exp(0.3 * x + 0.1))), 1, [2]), None, mc)
    return problem, mc


def test_iterative_schur_without_structure_downgrades_to_cgnr():
    """ITERATIVE_SCHUR on a problem with no Schur structure runs CGNR +
    JACOBI, as ceres_tpu's _maybe_downgrade_options decides."""
    def opts(mod, **extra):
        return mod.SolverOptions(
            linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=mod.PreconditionerType.SCHUR_JACOBI,
            use_mixed_precision_solves=True, fused_iterations=True, **extra)

    pj, mj = _curve_fit(ct, jnp)
    pt, mt = _curve_fit(ctt, torch)
    s_j = ct.solve(opts(ct), pj)
    s_t = ctt.solve(opts(ctt, device="cpu"), pt)
    for s in (s_j, s_t):
        assert str(s.linear_solver_type_used) == "CGNR"
        assert str(s.preconditioner_type_used) == "JACOBI"
    assert (s_t.num_iterations, s_t.num_linear_solver_iterations) == \
        (s_j.num_iterations, s_j.num_linear_solver_iterations)
    np.testing.assert_allclose(mt, [0.3, 0.1], atol=1e-8)
    np.testing.assert_allclose(mt, mj, atol=1e-9)


@pytest.mark.parametrize("extra,item", [
    (dict(minimizer_type="LINE_SEARCH", max_num_iterations=10), "item 47"),
    (dict(use_inner_iterations=True), "item 22"),
    (dict(trust_region_problem_dump_directory="dumps",
          use_mixed_precision_solves=False), "item 14"),
    (dict(trust_region_problem_dump_format_type="CONSOLE",
          use_mixed_precision_solves=False), "item 14"),
    (dict(check_gradients=True, use_inner_iterations=True), "item 22"),
], ids=["extra0-item 25", "extra1-item 22", "extra2-item 14",
        "extra3-item 14", "extra4-item 28"])
def test_out_of_slice_raises(extra, item, tmp_path, capsys):
    """Configurations of the generic path that raised NotImplementedError
    naming their ROADMAP.md items until the port ran them; each case
    keeps its id and now holds the port to the JAX package on the SE2
    graph. The line-search minimizer with these options'
    fused_iterations=True (item 47, the device-resident loop), cut at 10
    iterations: the JAX fused loop's counts and x within 1e-10. Inner
    iterations (item 22; with check_gradients, item 28, the case's id):
    the JAX host loop's LM count, inner-iteration steps and successful
    steps, the final cost within 1e-6. The trust-region problem dumps
    (item 14), in f64: the same solve (LM count, cost within 1e-6) and,
    TEXTFILE, the same files, each array within 1e-8 of the JAX package's
    relative to its largest entry and the radius equal; CONSOLE, the same
    lines (the first one character for character, the norms of the
    others within 1e-6)."""
    enums = {"minimizer_type": ctt.MinimizerType,
             "trust_region_problem_dump_format_type": ctt.DumpFormatType}
    dump_dirs = {}
    runs = []
    for mod in (ct, ctt):
        kw = {k: (getattr(getattr(mod, enums[k].__name__), v)
                  if isinstance(v, str) and k in enums else v)
              for k, v in extra.items()}
        if "trust_region_problem_dump_directory" in kw:
            kw["trust_region_problem_dump_directory"] = dump_dirs[mod] = \
                str(tmp_path / mod.__name__)
        problem, positions, _ = _problem(mod, "2d")
        capsys.readouterr()
        s = mod.solve(_options(mod, "JACOBI", **kw), problem)
        out = capsys.readouterr().out
        runs.append((s, positions, [ln for ln in out.splitlines()
                                    if ln.startswith("ceres_tpu iteration")]))
    (s_j, pos_j, lines_j), (s_t, pos_t, lines_t) = runs
    assert s_t.is_solution_usable(), s_t.message
    assert str(s_t.termination_type) == str(s_j.termination_type)
    x_j = np.concatenate([pos_j[k] for k in sorted(pos_j)])
    x_t = np.concatenate([pos_t[k] for k in sorted(pos_t)])
    if "minimizer_type" in extra:
        assert s_t.num_iterations_fused == s_j.num_iterations_fused == 10
        assert s_t.num_line_search_steps == s_j.num_line_search_steps
        assert np.abs(x_t - x_j).max() <= 1e-10 * np.abs(x_j).max()
        return
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert s_t.num_inner_iteration_steps == s_j.num_inner_iteration_steps
    assert ("use_inner_iterations" in extra) == (
        s_t.num_inner_iteration_steps > 0)
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost
    assert len(lines_t) == len(lines_j)
    assert ("trust_region_problem_dump_format_type" in extra) == bool(lines_t)
    for lt, lj in zip(lines_t, lines_j):
        assert lt.split("=")[0] == lj.split("=")[0]
        nt = [float(v.split()[0]) for v in lt.split("=")[1:]]
        nj = [float(v.split()[0]) for v in lj.split("=")[1:]]
        assert np.allclose(nt, nj, rtol=1e-6, atol=0)
    if lines_t:
        assert lines_t[0] == lines_j[0]
    if dump_dirs:
        names_j = sorted(p.name for p in (tmp_path / "ceres_tpu").iterdir())
        names_t = sorted(p.name for p in
                         (tmp_path / "ceres_tpu_torch").iterdir())
        assert names_t == names_j and len(names_j) == s_j.num_iterations - 1
        for name in names_j:
            dj = np.load(tmp_path / "ceres_tpu" / name)
            dt = np.load(tmp_path / "ceres_tpu_torch" / name)
            assert sorted(dt.files) == sorted(dj.files)
            assert float(dt["radius"]) == float(dj["radius"])
            for key in ("J", "residuals", "gradient", "x", "delta"):
                assert dt[key].shape == dj[key].shape, key
                assert rel(dt[key], dj[key]) <= 1e-8, (name, key)
