"""solve_batched of the port (ceres_tpu_torch/batch.py), the counterparts
of tests/test_batch.py: batch mode (every element's LM iteration as one
set of batched tensor operations) and pipeline mode (the template's step
bound to each element, the single-solve fused loop) against the port's
single solves and the JAX package's batched runs, the structure checks,
the template registry and examples/ransac_homography.py."""

import numpy as np
import pytest
import torch

import torch_parity_kit  # noqa: F401  (one thread)
import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu.io.bal import build_bal_ceres_problem as jax_build
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu_torch import batch as batch_mod
from ceres_tpu_torch.io.bal import build_bal_ceres_problem as torch_build

TRUTHS = [(0.3, 0.1), (0.25, 0.4), (0.5, -0.2), (0.1, 0.8)]


class _JaxExp:
    def __init__(self, x, y):
        self.x, self.y = float(x), float(y)

    def __call__(self, m, c):
        import jax.numpy as jnp
        return self.y - jnp.exp(m[0] * self.x + c[0])


class _TorchExp:
    def __init__(self, x, y):
        self.x, self.y = float(x), float(y)

    def __call__(self, m, c):
        return self.y - torch.exp(m[0] * self.x + c[0])


def curve_problems(mod, seed=3, truths=TRUTHS):
    """tests/test_batch.py's curve fits: [(problem, m, c)]."""
    rng = np.random.default_rng(seed)
    functor = _JaxExp if mod is ct else _TorchExp
    out = []
    for mt, c_t in truths:
        m, c = np.array([0.0]), np.array([0.0])
        prob = mod.Problem()
        for x in np.linspace(0, 5, 25):
            y = float(np.exp(mt * x + c_t) + 0.01 * rng.standard_normal())
            prob.add_residual_block(
                mod.AutoDiffCostFunction(functor(x, y), 1, [1, 1]), None,
                m, c)
        out.append((prob, m, c))
    return out


def curve_options(mod, **kw):
    extra = {} if mod is ct else {"device": "cpu"}
    return mod.SolverOptions(max_num_iterations=40, function_tolerance=1e-12,
                             fused_iterations=True, **extra, **kw)


def ba_bal(seed, graph_seed=11, cameras=4, points=60, observations=240):
    bal = synthetic_bal_problem(num_cameras=cameras, num_points=points,
                                num_observations=observations,
                                seed=graph_seed, pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=seed)
    return bal


def ba_options(mod, mixed=False, **kw):
    extra = {} if mod is ct else {"device": "cpu"}
    return mod.SolverOptions(
        linear_solver_type=mod.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=mixed, max_num_iterations=40,
        function_tolerance=1e-9, fused_iterations=True, **extra, **kw)


@pytest.fixture(scope="module")
def jax_curve_batch():
    """The JAX package's batched curve fits, per linear solver."""
    out = {}
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        built = curve_problems(ct)
        ss = ct.solve_batched(curve_options(
            ct, linear_solver_type=ct.LinearSolverType[lst]),
            [b[0] for b in built])
        out[lst] = [(s.num_iterations, s.final_cost, m[0], c[0])
                    for s, (_, m, c) in zip(ss, built)]
    return out


@pytest.fixture(scope="module")
def jax_ba_batch():
    """The JAX package's batched BA multi-start, f64 and mixed."""
    out = {}
    for mixed in (False, True):
        ss = ct.solve_batched(ba_options(ct, mixed),
                              [jax_build(ba_bal(s))[0] for s in (1, 2, 3)])
        out[mixed] = [(s.num_iterations, s.final_cost) for s in ss]
    return out


@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
@pytest.mark.parametrize("mode", ["batch", "pipeline"])
def test_curve_fit_batch_matches_individual_and_jax(lst, mode,
                                                    jax_curve_batch):
    """Counts equal and costs within 1e-10 of the port's single solves
    and JAX's batch; parameters within 1e-7 (the LM stops at function
    tolerance 1e-12, which pins the cost but leaves the parameters free
    along the valley by far more than the rounding of batch mode's
    Householder QR against LAPACK's moves them: 1.3e-8 at most here).
    Pipeline mode repeats the single solve bit for bit."""
    opts = curve_options(ctt, linear_solver_type=ctt.LinearSolverType[lst],
                         batch_mode=mode)
    refs = []
    for prob, m, c in curve_problems(ctt):
        s = ctt.solve(opts, prob)
        refs.append((s, m[0], c[0]))
    built = curve_problems(ctt)
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    assert len(ss) == len(TRUTHS)
    for i, ((s_ref, m_ref, c_ref), s, (_, m, c), jx) in enumerate(
            zip(refs, ss, built, jax_curve_batch[lst])):
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert f"batched fused mode [{mode}], element {i}" in s.message
        assert s.num_iterations == s_ref.num_iterations == jx[0]
        np.testing.assert_allclose(s.final_cost, s_ref.final_cost,
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose([m[0], c[0]], [m_ref, c_ref], rtol=1e-7)
        np.testing.assert_allclose(s.final_cost, jx[1], rtol=1e-10)
        np.testing.assert_allclose([m[0], c[0]], jx[2:], rtol=1e-7)
        if mode == "pipeline":          # the single solve's bits
            assert (s.final_cost, m[0], c[0]) == (s_ref.final_cost, m_ref,
                                                  c_ref)


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_ba_multistart_dense_schur_batch(mixed, jax_ba_batch):
    """Same graph, different perturbations: the batched DENSE_SCHUR solve
    against per-problem port solves and the JAX batched run. f64: JAX's
    counts and costs within 1e-9; mixed (f32 sums in another order than
    the single solve's kernels' plain versions): costs within 1e-6."""
    opts = ba_options(ctt, mixed, batch_mode="batch")
    refs = [ctt.solve(opts, torch_build(ba_bal(s))[0]) for s in (1, 2, 3)]
    ss = ctt.solve_batched(opts, [torch_build(ba_bal(s))[0]
                                  for s in (1, 2, 3)])
    tol = 1e-6 if mixed else 1e-9
    for s_ref, s, jx in zip(refs, ss, jax_ba_batch[mixed]):
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s.final_cost, s_ref.final_cost, rtol=tol)
        np.testing.assert_allclose(s.final_cost, jx[1], rtol=tol)
        if not mixed:
            assert s.num_iterations == s_ref.num_iterations == jx[0]


def test_ba_pipeline_elements_equal_single_solves():
    """Pipeline mode binds the template's fused Schur step (K1-K4's plain
    versions here) to each element: every element is ctt.solve's, bit for
    bit, the state too."""
    opts = ba_options(ctt, True, batch_mode="pipeline")
    singles = []
    for s_ in (1, 2, 3):
        prob, cams, pts = torch_build(ba_bal(s_))
        singles.append((ctt.solve(opts, prob),
                        np.concatenate(cams + pts)))
    built = [torch_build(ba_bal(s_)) for s_ in (1, 2, 3)]
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    for (s_ref, x_ref), s, (_, cams, pts) in zip(singles, ss, built):
        assert "Schur" in s_ref.message
        assert (s.num_iterations, s.num_successful_steps, s.final_cost) == \
            (s_ref.num_iterations, s_ref.num_successful_steps,
             s_ref.final_cost)
        np.testing.assert_array_equal(np.concatenate(cams + pts), x_ref)


def test_rejects_different_structure():
    """Different observation graphs must be rejected loudly."""
    opts = ba_options(ctt, batch_mode="batch")

    def build(seed):
        return torch_build(synthetic_bal_problem(
            num_cameras=6, num_points=40, num_observations=120, seed=seed,
            pixel_noise=0.5))[0]

    with pytest.raises(ValueError, match="structure|constant"):
        ctt.solve_batched(opts, [build(1), build(2)])
    # a different size
    with pytest.raises(ValueError, match="structure"):
        ctt.solve_batched(curve_options(ctt), [
            curve_problems(ctt)[0][0],
            curve_problems(ctt, truths=TRUTHS[:1])[0][0]] + [
            torch_build(ba_bal(1))[0]])


def test_single_and_empty():
    assert ctt.solve_batched(ctt.SolverOptions(device="cpu"), []) == []
    (prob, m, c), = curve_problems(ctt, truths=TRUTHS[:1])
    (s,) = ctt.solve_batched(ctt.SolverOptions(device="cpu"), [prob])
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert "batched" not in s.message          # the single solve
    np.testing.assert_allclose([m[0], c[0]], TRUTHS[0], atol=0.02)


def test_not_fused_capable_runs_each_solve():
    opts = curve_options(ctt, minimizer_progress_to_stdout=False,
                         callbacks=[lambda s: ctt.CallbackReturnType
                                    .SOLVER_CONTINUE])
    built = curve_problems(ctt)
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    assert all("batched" not in s.message for s in ss)
    assert all(len(s.iterations) > 0 for s in ss)


def test_registry_reuses_step():
    """Serving: a second round of fresh problems of the same structure
    reuses the registry's step and gives each element its own solution."""
    batch_mod._TEMPLATE_REGISTRY.clear()
    opts = curve_options(ctt, batch_mode="batch")
    ctt.solve_batched(opts, [b[0] for b in curve_problems(ctt, seed=3)])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1
    step = batch_mod._TEMPLATE_REGISTRY[0]["step"]
    round2 = curve_problems(ctt, seed=7)
    ss = ctt.solve_batched(opts, [b[0] for b in round2])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1
    assert batch_mod._TEMPLATE_REGISTRY[0]["step"] is step
    for (prob, m_r, c_r), s, (_, m, c) in zip(curve_problems(ctt, seed=7),
                                              ss, round2):
        s_r = ctt.solve(opts, prob)
        np.testing.assert_allclose(s.final_cost, s_r.final_cost,
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose([m[0], c[0]], [m_r[0], c_r[0]],
                                   rtol=1e-7)


def test_registry_structural_const_guard_unit():
    """Integer (structural) constants must be bitwise equal for reuse;
    float data may differ."""
    a = {"idx": np.array([1, 2, 3], np.int32), "w": np.ones(3)}
    b = {"idx": np.array([1, 3, 2], np.int32), "w": np.zeros(3)}
    assert batch_mod._differing_integer_constant(a, a) is None
    assert batch_mod._differing_integer_constant(a, b, ["w"]) is None
    assert batch_mod._differing_integer_constant(a, b) == "idx"


@pytest.mark.parametrize("mode", ["batch", "pipeline"])
def test_registry_not_reused_across_graphs(mode):
    """Graphs with identical shapes but other integer wiring: a new
    registry entry, and every element its own solve's result."""
    from ceres_tpu_torch.program import CompiledProgram
    batch_mod._TEMPLATE_REGISTRY.clear()
    opts = ba_options(ctt, batch_mode=mode)

    def build(graph_seed, perturb_seed):
        return torch_build(ba_bal(perturb_seed, graph_seed=graph_seed,
                                  cameras=6, points=40,
                                  observations=120))[0]

    pa = CompiledProgram.get_cached(build(1, 1), opts)
    pb = CompiledProgram.get_cached(build(2, 1), opts)
    assert batch_mod._validate_same_structure([pa, pb]) is None
    assert batch_mod._differing_integer_constant(
        batch_mod.program_constants(pa),
        batch_mod.program_constants(pb)) is not None
    ctt.solve_batched(opts, [build(1, s) for s in (1, 2)])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1
    ss = ctt.solve_batched(opts, [build(2, s) for s in (1, 2)])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 2
    for s, seed in zip(ss, (1, 2)):
        ref = ctt.solve(opts, build(2, seed))
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s.final_cost, ref.final_cost, rtol=1e-9)


def test_out_of_slice_batch_configuration_raises():
    """The configurations that batch mode once refused (CGNR, DOGLEG and
    mixed DENSE_QR) now solve in batch mode: no element raises or falls
    back to pipeline mode, and each element's LM and linear iteration
    counts and termination are those of the JAX package's batched run,
    its final cost within 1e-9 relative of JAX's."""
    for kw in (dict(linear_solver_type=ctt.LinearSolverType.CGNR),
               dict(trust_region_strategy_type=ctt.TrustRegionStrategyType
                    .DOGLEG),
               dict(use_mixed_precision_solves=True)):
        opts = curve_options(ctt, batch_mode="batch", **kw)
        ss = ctt.solve_batched(opts, [b[0] for b in curve_problems(ctt)])
        jkw = {k: (getattr(ct, type(v).__name__)[v.name]
                   if hasattr(v, "name") else v) for k, v in kw.items()}
        js = ct.solve_batched(curve_options(ct, batch_mode="batch", **jkw),
                              [b[0] for b in curve_problems(ct)])
        for s, j in zip(ss, js):
            assert "batched fused mode [batch]" in s.message
            assert s.termination_type == ctt.TerminationType.CONVERGENCE
            assert (s.num_iterations, s.num_linear_solver_iterations,
                    s.termination_type.name) == (
                j.num_iterations, j.num_linear_solver_iterations,
                j.termination_type.name)
            np.testing.assert_allclose(s.final_cost, j.final_cost,
                                       rtol=1e-9)


def test_batch_mode_validated():
    opts = curve_options(ctt, batch_mode="lockstep")
    assert "batch_mode" in opts.validate()
    ss = ctt.solve_batched(opts, [b[0] for b in curve_problems(ctt)])
    assert all(s.termination_type == ctt.TerminationType.FAILURE
               for s in ss)
    assert ct.SolverOptions(batch_mode="lockstep").validate() == \
        opts.validate()


def test_auto_mode_picks_by_residuals(monkeypatch):
    built = curve_problems(ctt)
    ss = ctt.solve_batched(curve_options(ctt), [b[0] for b in built])
    assert "[batch]" in ss[0].message
    monkeypatch.setattr(batch_mod, "BATCH_CROSSOVER_RESIDUALS", 10)
    ss = ctt.solve_batched(curve_options(ctt), [b[0] for b in
                                               curve_problems(ctt)])
    assert "[pipeline]" in ss[0].message


def test_ransac_homography_batched():
    """examples/ransac_homography.py (tests/test_examples.py's case):
    recovers H against gross outliers, the SubsetManifold through batch
    mode, and each refinement is the JAX batched run's (counts; costs
    within 1e-9 or 1e-20 at the exact minimal-sample fits)."""
    from ceres_tpu.examples.ransac_homography import \
        _build_refine_problem as jax_refine
    from ceres_tpu_torch.examples import ransac_homography as rh
    x1, x2, H_true, out = rh.synthetic_correspondences(30, 7)
    H, mask, (summaries, s_polish) = rh.ransac_homography(
        x1, x2, num_hypotheses=6, seed=1, device="cpu", batch_mode="batch")
    assert len(summaries) == 6
    assert "batched fused mode [batch]" in summaries[0].message
    H = H / H[2, 2]
    assert np.linalg.norm(H - H_true / H_true[2, 2]) < 1e-2
    true_in = np.ones(30, bool)
    true_in[out] = False
    assert (mask & ~true_in).sum() == 0
    assert mask.sum() >= 0.8 * (30 - 7)
    assert s_polish.termination_type == ctt.TerminationType.CONVERGENCE
    samples, hs = rh.hypotheses(x1, x2, 6, 1)
    js = ct.solve_batched(
        ct.SolverOptions(max_num_iterations=20, function_tolerance=1e-10,
                         batch_mode="batch"),
        [jax_refine(x1[i], x2[i], h) for i, h in zip(samples, hs)])
    for s, j in zip(summaries, js):
        assert s.num_iterations == j.num_iterations
        assert abs(s.final_cost - j.final_cost) <= \
            1e-9 * abs(j.final_cost) + 1e-20


class _Prior:
    """A camera prior: 10 (c - t)."""

    def __init__(self, t):
        self.t = t

    def __call__(self, c):
        return 10.0 * (c - self.t)


def _ba_with_prior(seed, constant_camera=False):
    """ba_bal's problem with a camera prior (an f-only bucket) and, when
    asked, camera 0 constant, Huber on the observations. (A problem of a
    batch shares its cost classes with the others: the functor class is
    part of a bucket's key.)"""
    prob, cams, pts = torch_build(ba_bal(seed), loss=ctt.HuberLoss(1.0))
    prob.add_residual_block(
        ctt.AutoDiffCostFunction(_Prior(cams[1].copy()), 9, [9]), None,
        cams[1])
    if constant_camera:
        prob.set_parameter_block_constant(cams[0])
    return prob


@pytest.mark.parametrize("constant_camera", [False, True],
                         ids=["prior", "prior_constant_camera"])
def test_batch_schur_prior_bucket_and_constant_block(constant_camera):
    """Batch mode's Schur step with an f-only bucket (a camera prior), a
    robust loss and a constant block: each element within 1e-9 of its
    own f64 solve, in its LM count."""
    opts = ba_options(ctt, batch_mode="batch")
    refs = [ctt.solve(opts, _ba_with_prior(s, constant_camera))
            for s in (1, 2)]
    ss = ctt.solve_batched(opts, [_ba_with_prior(s, constant_camera)
                                  for s in (1, 2)])
    for r, s in zip(refs, ss):
        assert "[batch]" in s.message
        assert s.num_iterations == r.num_iterations
        np.testing.assert_allclose(s.final_cost, r.final_cost, rtol=1e-9)


def _pose_graph(seed):
    """A 30-pose SE3 graph (EigenQuaternionManifold, loop closures): its
    problem and state arrays. (The SE2 example builds an AutoDiffManifold
    a problem, whose functions are part of a bucket's key, so its graphs
    do not batch.)"""
    from ceres_tpu_torch.examples import slam
    from ceres_tpu_torch.io import g2o
    poses, constraints, _ = g2o.synthetic_pose_graph_3d(num_poses=30,
                                                        seed=seed)
    prob, positions, quats = slam.build_pose_graph_3d_problem(poses,
                                                              constraints)
    return prob, list(positions.values()) + list(quats.values())


def test_pipeline_cgnr_pose_graphs():
    """Pipeline mode on pose graphs with CGNR + JACOBI, mixed and fused
    (the generic step; K8's and K9's plain versions here): each element
    its ctt.solve, bit for bit."""
    opts = ctt.SolverOptions(
        linear_solver_type=ctt.LinearSolverType.CGNR,
        preconditioner_type=ctt.PreconditionerType.JACOBI,
        use_mixed_precision_solves=True, fused_iterations=True,
        max_num_iterations=30, device="cpu", batch_mode="pipeline")
    singles = []
    for seed in (1, 2):
        prob, arrs = _pose_graph(seed)
        singles.append((ctt.solve(opts, prob), np.concatenate(arrs)))
    built = [_pose_graph(seed) for seed in (1, 2)]
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    for (s_ref, x_ref), s, (_, arrs) in zip(singles, ss, built):
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert (s.num_iterations, s.num_linear_solver_iterations,
                s.final_cost) == (s_ref.num_iterations,
                                  s_ref.num_linear_solver_iterations,
                                  s_ref.final_cost)
        np.testing.assert_array_equal(np.concatenate(arrs), x_ref)


@pytest.mark.parametrize("config", [
    dict(linear_solver_type="ITERATIVE_SCHUR",
         preconditioner_type="SCHUR_JACOBI", use_mixed_precision_solves=True),
    dict(linear_solver_type="DENSE_SCHUR"),
    dict(linear_solver_type="SPARSE_SCHUR"),
    dict(linear_solver_type="DENSE_SCHUR",
         trust_region_strategy_type="DOGLEG")],
    ids=["iterative_mixed", "dense_f64", "sparse_schur", "dogleg"])
def test_pipeline_binds_every_step_kind(config):
    """Pipeline mode serves every fused-capable configuration, each
    element bit for bit its ctt.solve: the fused explicit step (K7's
    plain version), the generic Schur step (f64, SPARSE_SCHUR's dense
    route below its cap) and the dogleg step."""
    enums = {"linear_solver_type": ctt.LinearSolverType,
             "preconditioner_type": ctt.PreconditionerType,
             "trust_region_strategy_type": ctt.TrustRegionStrategyType}
    kw = {k: getattr(enums[k], v) if k in enums else v
          for k, v in config.items()}
    opts = ctt.SolverOptions(max_num_iterations=20, fused_iterations=True,
                             device="cpu", batch_mode="pipeline", **kw)
    singles = []
    for s_ in (1, 2):
        prob, cams, pts = torch_build(ba_bal(s_))
        singles.append((ctt.solve(opts, prob), np.concatenate(cams + pts)))
    built = [torch_build(ba_bal(s_)) for s_ in (1, 2)]
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    for (s_ref, x_ref), s, (_, cams, pts) in zip(singles, ss, built):
        assert "[pipeline]" in s.message
        assert (s.num_iterations, s.final_cost) == (s_ref.num_iterations,
                                                    s_ref.final_cost)
        np.testing.assert_array_equal(np.concatenate(cams + pts), x_ref)


def test_batch_constant_block_and_loss_generic():
    """The generic batched step with a constant block and a Cauchy loss:
    each element within 1e-10 of its single solve, in its count."""
    def build(seed):
        prob, m, c = curve_problems(ctt, seed=seed, truths=TRUTHS[:1])[0]
        c[0] = 0.1
        prob.set_parameter_block_constant(c)
        return prob, m

    opts = curve_options(ctt, batch_mode="batch")
    refs = [ctt.solve(opts, build(s)[0]) for s in (3, 4, 5)]
    built = [build(s) for s in (3, 4, 5)]
    ss = ctt.solve_batched(opts, [b[0] for b in built])
    for r, s in zip(refs, ss):
        assert s.num_iterations == r.num_iterations
        np.testing.assert_allclose(s.final_cost, r.final_cost, rtol=1e-10)
