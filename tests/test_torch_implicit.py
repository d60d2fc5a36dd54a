"""The implicit (matrix-free) ITERATIVE_SCHUR step of ceres_tpu_torch
against ceres_tpu: the camera-chunk layouts (bitwise), the plain K10
against the JAX package's Pallas _apply_kernel in interpret mode, the
SCHUR_JACOBI lane and cross-bucket blocks, one forced-implicit LM step
for each preconditioner against the JAX step under
CERES_TPU_FORCE_IMPLICIT (its XLA apply), whole solves (one bucket
through the K10 route, two buckets, cross-bucket duplicates, e-only and
f-only buckets) against ceres_tpu.solve, the mode selection, and on a
card the CUDA K10 against its plain version.

Tolerances: the plain K10 against the JAX kernel 1e-5 relative (f32 on
both sides, sums in another order; the CUDA kernel and its plain
version round alike and agree bit for bit); the step as tests/test_torch_iterative.py (1e-5, 5e-4 for the
step vector and its norm, where the f32 CG amplifies rounding by the
damped system's conditioning; the same CG count); a whole solve with the
JAX package's LM count and a final cost within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, main_path_options, rel,
                              small_bal, torch_problem)

from ceres_tpu import solver as jax_solver
from ceres_tpu.examples.snavely import \
    SnavelyReprojectionError as JaxSnavely
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.ops.pallas_implicit import make_pallas_implicit_apply
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import schur_fused as jax_sf
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.examples.snavely import SnavelyReprojectionError
from ceres_tpu_torch.minimizers.fused import run_fused
from ceres_tpu_torch.ops.implicit import implicit_apply, implicit_apply_plain
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur import detect_schur_structure

RADIUS = 1e4
PRECONDITIONERS = ["IDENTITY", "JACOBI", "SCHUR_JACOBI"]


def implicit_options(mod, preconditioner="SCHUR_JACOBI", **extra):
    """bench.py's ITERATIVE_SCHUR configuration in package `mod`;
    `extra` adds or overrides options."""
    kw = dict(linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
              preconditioner_type=getattr(mod.PreconditionerType,
                                          preconditioner))
    kw.update(extra)
    return main_path_options(mod, **kw)


def forced_step(problem, options):
    """The implicit step built directly, which forces the mode (the JAX
    package's CERES_TPU_FORCE_IMPLICIT)."""
    program = TorchProgram.get_cached(problem, options)
    return program, tsf.ImplicitSchurStep(
        program, options, detect_schur_structure(program, options))


def forced_solve(problem, options):
    """A forced-implicit solve through the step and run_fused."""
    program, step = forced_step(problem, options)
    summary = ctt.SolverSummary()
    program.write_back(run_fused(program, options, summary, step))
    return summary, step


# ---- problems built alike in both packages ----

class _PointPrior:
    def __init__(self, target):
        self.target = target

    def __call__(self, point):
        return 0.1 * (point - self.target)


class _CameraPrior:
    def __init__(self, target):
        self.target = target

    def __call__(self, camera):
        return 0.1 * (camera[3:6] - self.target)


def _bal_arrays(bal):
    return ([bal.cameras[i].copy() for i in range(bal.num_cameras)],
            [bal.points[i].copy() for i in range(bal.num_points)])


def two_bucket_problem(mod, snavely):
    """tests/test_fused_schur.py _two_bucket_bal_problem: half the
    observations robust (HuberLoss), half plain."""
    bal = synthetic_bal_problem(num_cameras=4, num_points=100,
                                num_observations=400, seed=2,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=3)
    cams, pts = _bal_arrays(bal)
    problem = mod.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        problem.add_residual_block(
            mod.AutoDiffCostFunction(snavely(ox, oy), 2, [9, 3]),
            mod.HuberLoss(2.0) if i % 2 == 0 else None,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return problem


def cross_dup_problem(mod, snavely):
    """tests/test_fused_schur.py _cross_dup_bal_problem: every
    observation twice, once robust and once plain."""
    bal = synthetic_bal_problem(num_cameras=3, num_points=100,
                                num_observations=200, seed=4,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=5)
    cams, pts = _bal_arrays(bal)
    problem = mod.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        for loss in (mod.HuberLoss(2.0), None):
            problem.add_residual_block(
                mod.AutoDiffCostFunction(snavely(ox, oy), 2, [9, 3]), loss,
                cams[bal.camera_index[i]], pts[bal.point_index[i]])
    return problem


def prior_problem(mod, snavely):
    """small_bal with a prior on every tenth point (an e-only bucket)
    and on every camera's translation (an f-only bucket)."""
    bal = small_bal()
    cams, pts = _bal_arrays(bal)
    problem = mod.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        problem.add_residual_block(
            mod.AutoDiffCostFunction(snavely(ox, oy), 2, [9, 3]), None,
            cams[bal.camera_index[i]], pts[bal.point_index[i]])
    for p in pts[::10]:
        problem.add_residual_block(mod.AutoDiffCostFunction(
            _PointPrior(p + 0.01), 3, [3]), None, p)
    for c in cams:
        problem.add_residual_block(mod.AutoDiffCostFunction(
            _CameraPrior(c[3:6] - 0.01), 3, [9]), None, c)
    return problem


PROBLEMS = {"two_bucket": two_bucket_problem,
            "cross_dup": cross_dup_problem, "priors": prior_problem}


# ---- layouts ----

@pytest.mark.parametrize("name", ["two_bucket", "priors"])
def test_cam_chunk_layouts_match_jax(monkeypatch, name):
    """The camera-chunk layouts equal the JAX package's program constants
    bit for bit, bucket by bucket."""
    monkeypatch.setenv("CERES_TPU_FORCE_IMPLICIT", "1")
    opts = implicit_options(ct)
    jp = JaxProgram.get_cached(PROBLEMS[name](ct, JaxSnavely), opts)
    jax_sf.make_fused_schur_lm_step(jp, opts, jax_detect(jp, opts))
    _, step = forced_step(PROBLEMS[name](ctt, SnavelyReprojectionError),
                          implicit_options(ctt))
    assert [bk.n for bk in jp.buckets] == \
        [p.bk.n for p in step.plans]
    checked = 0
    for bi, p in enumerate(step.plans):
        if p.camr is None:
            assert f"schur.fused.cam{bi}.rows" not in jp.consts_np
            continue
        rows = np.asarray(jp.consts_np[f"schur.fused.cam{bi}.rows"])
        mask = np.asarray(jp.consts_np[f"schur.fused.cam{bi}.mask"])
        assert np.array_equal(p.camr.numpy(), rows)
        assert np.array_equal(p.camm.numpy(), mask)
        checked += 1
    assert checked == 2


def test_dup_and_cross_bucket_detection_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        f1 = rng.integers(0, 4, size=(6, 3))
        m1 = rng.random((6, 3)) > 0.3
        f2 = rng.integers(0, 4, size=(6, 2))
        m2 = rng.random((6, 2)) > 0.3
        assert tsf.chunk_has_dup_cams(f1, m1) == \
            jax_sf.chunk_has_dup_cams(f1, m1)
        entries = [(f1, m1), (f2, m2), (f1[:, :1], m1[:, :1])]
        assert tsf.detect_cross_bucket_dups(entries) == \
            jax_sf.detect_cross_bucket_dups(entries)
    cams = rng.integers(0, 5, size=40)
    for a, b in zip(tsf.cam_chunk_layout(cams, np.arange(40), 5),
                    jax_sf.cam_chunk_layout(cams, np.arange(40), 5)):
        assert np.array_equal(a, b) and a.dtype == b.dtype


# ---- K10 ----

def _k10_inputs(ne, k, te, tf, kf, seed, r=2):
    """Seeded K10 inputs with a ragged chunk layout: lanes past each
    point's count are masked (zero J, camera 0)."""
    rng = np.random.default_rng(seed)
    count = rng.integers(1, k + 1, size=ne)
    lane = (np.arange(k)[None, :] < count[:, None]).astype(np.float32)
    Je = rng.standard_normal((ne, k, r, te)).astype(np.float32) \
        * lane[:, :, None, None]
    Jf = rng.standard_normal((ne, k, r, tf)).astype(np.float32) \
        * lane[:, :, None, None]
    B = rng.standard_normal((ne, te, te))
    inv = np.linalg.inv(B @ np.swapaxes(B, -1, -2) + te * np.eye(te)) \
        .astype(np.float32)
    fids = (rng.integers(0, kf, size=(ne, k)) * lane).astype(np.int32)
    v = rng.standard_normal(kf * tf).astype(np.float32)
    return Je, Jf, inv, fids, v


@pytest.mark.parametrize("ne,k,te,tf,kf", [(200, 5, 3, 9, 7),
                                           (77, 3, 2, 6, 4)])
def test_implicit_apply_plain_matches_jax_kernel(monkeypatch, ne, k, te, tf,
                                                 kf):
    """The plain K10 against the JAX package's Pallas kernel in interpret
    mode, its [tf, k, ne_pad] output mapped to [ne, k, tf]; ne is not a
    multiple of the kernel's tile."""
    Je, Jf, inv, fids, v = _k10_inputs(ne, k, te, tf, kf, ne)
    monkeypatch.setenv("CERES_TPU_PALLAS_INTERPRET", "1")
    pimp = make_pallas_implicit_apply(ne, k, te, tf, kf, "cpu")
    assert pimp.ne_pad > ne
    jeT, jfT, invT = pimp.to_planes(jnp.asarray(Je), jnp.asarray(Jf),
                                    jnp.asarray(inv))
    fids_t = jnp.asarray(np.pad(fids, ((0, pimp.ne_pad - ne), (0, 0))).T)
    vb = jnp.asarray(v.reshape(kf, tf))
    vrowT = jnp.stack([jnp.take(vb[:, t], fids_t) for t in range(tf)])
    want = np.asarray(pimp.apply(jeT, jfT, invT, vrowT))[:, :, :ne] \
        .transpose(2, 1, 0)
    implicit_apply.launches = 0
    got = implicit_apply(*map(torch.as_tensor, (Je, Jf, inv, fids, v)))
    assert implicit_apply.launches == 0         # plain on CPU tensors
    assert got.shape == (ne, k, tf) and got.dtype == torch.float32
    assert rel(got.numpy(), want) < 1e-5
    assert np.all(got.numpy()[np.broadcast_to(
        (Je == 0).all(axis=(2, 3))[..., None], got.shape)] == 0)


# ---- SCHUR_JACOBI blocks ----

def _sj_inputs(seed, ne, ks, te, tf, kf):
    rng = np.random.default_rng(seed)
    Ges = [rng.standard_normal((ne, k, te, tf)) for k in ks]
    fids = [rng.integers(0, kf, size=(ne, k)) for k in ks]
    B = rng.standard_normal((ne, te, te))
    inv = np.linalg.inv(B @ np.swapaxes(B, -1, -2) + 3.0 * np.eye(te))
    return Ges, fids, inv


def _untranspose(cT, k, ne, tf):
    """ceres_tpu's [tf*tf, k, ne] layout -> [ne, k, tf, tf]."""
    return np.asarray(cT).reshape(tf, tf, k, ne).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("dup", [True, False])
def test_sj_chunk_blocks_match_jax(dup):
    """Lane contributions to the S block diagonal on a problem where a
    camera sees a point through several lanes (k > kf)."""
    ne, k, te, tf, kf = 5, 4, 3, 9, 2
    (Ge,), (fids,), inv = _sj_inputs(5, ne, [k], te, tf, kf)
    assert tsf.chunk_has_dup_cams(fids, np.ones((ne, k)))
    M = np.einsum("nij,nkjt->nkit", inv, Ge)
    want = _untranspose(jax_sf._sj_chunk_blocks(
        jnp.asarray(Ge), jnp.asarray(M), jnp.asarray(fids), dup), k, ne, tf)
    got = tsf.sj_chunk_blocks(torch.as_tensor(Ge), torch.as_tensor(M),
                              torch.as_tensor(fids), dup)
    assert got.shape == (ne, k, tf, tf)
    assert rel(got.numpy(), want) < 1e-12


def test_sj_cross_pair_blocks_match_jax():
    ne, te, tf, kf = 5, 3, 9, 3
    (Ge1, Ge2), (f1, f2), inv = _sj_inputs(9, ne, [3, 2], te, tf, kf)
    want = _untranspose(jax_sf._sj_cross_pair_blocks(
        *map(jnp.asarray, (Ge1, Ge2, inv, f1, f2))), 3, ne, tf)
    got = tsf.sj_cross_pair_blocks(*map(torch.as_tensor,
                                        (Ge1, Ge2, inv, f1, f2)))
    assert rel(got.numpy(), want) < 1e-12


# ---- the step and the solves ----

@pytest.fixture(scope="module")
def jax_state():
    bal = small_bal()
    opts = implicit_options(ct)
    jp = JaxProgram.get_cached(jax_problem(bal), opts)
    x0 = jp.initial_state()
    return dict(bal=bal, scale=np.asarray(
        jax_solver.make_scale_fn(jp, opts)(x0)))


@pytest.mark.parametrize("preconditioner", PRECONDITIONERS)
def test_one_implicit_step_matches_jax(monkeypatch, jax_state,
                                       preconditioner):
    monkeypatch.setenv("CERES_TPU_FORCE_IMPLICIT", "1")
    opts_j = implicit_options(ct, preconditioner)
    jp = JaxProgram.get_cached(jax_problem(jax_state["bal"]), opts_j)
    ex = (jp.example_x(), jp.example_scalar(), jp.example_delta())
    a = jp.jit_with_consts(jax_solver.make_step_impl(jp, opts_j), ex)(
        jp.initial_state(), jnp.asarray(RADIUS, jp.dtype),
        jnp.asarray(jax_state["scale"]))
    tp, step = forced_step(torch_problem(jax_state["bal"]),
                           implicit_options(ctt, preconditioner))
    assert step.k10
    sc = torch.tensor(jax_state["scale"], dtype=torch.float32)
    s_e = sc[:3 * step.ne].view(step.ne, 3)
    s_f = sc[3 * step.ne:].view(step.kf, 9)
    art = step.linearize(tp.initial_state(), s_e, s_f, first=False)
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    for k in ["cost", "gradient_max_norm", "gradient_norm", "delta",
              "model_cost_change", "step_norm"]:
        tol = 5e-4 if k in ("delta", "step_norm") else 1e-5
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


def test_forced_implicit_solve_matches_jax(monkeypatch):
    """The whole forced-implicit solve (K10's route, plain on the CPU)
    against ceres_tpu.solve forced implicit, and the port's explicit
    ITERATIVE_SCHUR to the same final cost."""
    bal = small_bal()
    explicit = ctt.solve(implicit_options(ctt), torch_problem(bal))
    monkeypatch.setenv("CERES_TPU_FORCE_IMPLICIT", "1")
    s_j = ct.solve(implicit_options(ct), jax_problem(bal))
    implicit_apply.launches = 0
    s_t, step = forced_solve(torch_problem(bal), implicit_options(ctt))
    assert step.k10 and implicit_apply.launches == 0
    for s in (s_t, explicit):
        assert s.termination_type == ctt.TerminationType.CONVERGENCE
        assert abs(s.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_linear_solver_iterations \
        == s_j.num_linear_solver_iterations > s_t.num_iterations
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost


@pytest.mark.parametrize("name", ["two_bucket", "cross_dup", "priors"])
def test_multi_bucket_implicit_solve_matches_jax(monkeypatch, name):
    """Several buckets run the plain operator (K10 does not launch):
    Huber and plain halves, every observation in two buckets (the
    cross-bucket SCHUR_JACOBI terms), and e-only and f-only prior
    buckets. The JAX package's implicit solve unpacks an f-only bucket's
    chunk tensors in the wrong order (schur_fused.py :739 stores them
    as (Jf, None), :899 reads them as (Je, Jf)) and fails, so the
    priors problem is held to its explicit ITERATIVE_SCHUR solve."""
    if name != "priors":
        monkeypatch.setenv("CERES_TPU_FORCE_IMPLICIT", "1")
    kw = dict(function_tolerance=1e-9)
    s_j = ct.solve(implicit_options(ct, **kw),
                   PROBLEMS[name](ct, JaxSnavely))
    s_t, step = forced_solve(PROBLEMS[name](ctt, SnavelyReprojectionError),
                             implicit_options(ctt, **kw))
    assert not step.k10 and len(step.plans) > 1
    if name == "cross_dup":
        assert step.cross_pairs == [(0, 1)]
    if name == "priors":
        assert sorted(p.kind for p in step.plans) == ["e", "e0", "f"]
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost


def _large_bal():
    """nf = 4,500 > 4,096: past the explicit cap. Three observations per
    point, so that the points form the eliminated set."""
    return synthetic_bal_problem(num_cameras=500, num_points=5000,
                                 num_observations=15000, seed=3)


def _large_problem():
    return torch_problem(_large_bal())


def test_implicit_regime_is_in_the_slice():
    """ITERATIVE_SCHUR past the explicit cap selects the implicit step
    with the K10 operator instead of refusing it; on the card as well.
    The explicit step refuses that regime."""
    problem = _large_problem()
    for device in ("cpu", "cuda"):
        opts = implicit_options(ctt, device=device)
        program = TorchProgram(problem, device="cpu")
        meta = detect_schur_structure(program, opts)
        assert not tsf._explicit_viable(meta) and meta.nf == 4500
        assert tsf.implicit_mode(opts, meta)
        assert tsf.unsupported_reason(program, opts, meta) is None
    opts = implicit_options(ctt)
    step = tsf.schur_step(program, opts, meta)
    assert isinstance(step, tsf.ImplicitSchurStep)
    assert step.k10 and "K10" in step.mode
    with pytest.raises(NotImplementedError,
                       match="too large to form densely in the fused step"):
        tsf.FusedSchurStep(program, opts, meta)


@pytest.mark.parametrize("case,item", [("DENSE_SCHUR", "item 18"),
                                       ("f64", "item 11")])
def test_implicit_regime_refusals(case, item, monkeypatch):
    """Past the explicit cap the fused steps refuse DENSE_SCHUR (no dense
    S in the fused step) and the f64 step (ROADMAP.md item 11); both run
    on the generic Schur step since the refusals of their `item` were
    lifted (item 18's SchurOps): DENSE_SCHUR mixed on the dense S (its
    final cost after one LM iteration within 1e-5 of the JAX package's),
    f64 ITERATIVE_SCHUR on the matrix-free apply_S (nf > 2048; two LM
    iterations, the same counts and cost within 1e-9). The JAX package
    takes its generic route for both (CERES_TPU_NO_FUSED_SCHUR for the
    f64 one, which it would serve with its fused f64 step)."""
    extra = ({"linear_solver_type": ctt.LinearSolverType.DENSE_SCHUR,
              "max_num_iterations": 1}
             if case == "DENSE_SCHUR" else
             {"use_mixed_precision_solves": False, "max_num_iterations": 2})
    program = TorchProgram(_large_problem(), device="cpu")
    opts = implicit_options(ctt, **extra)
    meta = detect_schur_structure(program, opts)
    reason = tsf.unsupported_reason(program, opts, meta)
    assert reason is not None and (case == "DENSE_SCHUR" or item in reason)
    monkeypatch.setenv("CERES_TPU_NO_FUSED_SCHUR", "1")
    jextra = {k: (getattr(ct.LinearSolverType, v.name)
                  if k == "linear_solver_type" else v)
              for k, v in extra.items()}
    s_j = ct.solve(implicit_options(ct, **jextra), jax_problem(_large_bal()))
    s_t = ctt.solve(opts, _large_problem())
    assert "Schur step: generic" in s_t.message
    assert ("CG on the implicit S" in s_t.message) == (case == "f64")
    assert s_t.num_iterations == s_j.num_iterations
    tol = 1e-5 if case == "DENSE_SCHUR" else 1e-9
    assert abs(s_t.final_cost - s_j.final_cost) <= tol * s_j.final_cost
    if case == "f64":
        assert s_t.num_linear_solver_iterations == \
            s_j.num_linear_solver_iterations


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("ne", [1, 7, 513])
@pytest.mark.parametrize("k", [1, 5, 33])
@pytest.mark.parametrize("r,te,tf", [(2, 3, 9), (2, 3, 10), (1, 1, 1),
                                     (4, 4, 16), (3, 2, 9), (2, 4, 10),
                                     (1, 3, 16)])
@pytest.mark.parametrize("kf", [11, 13000])
def test_k10_kernel_matches_plain_on_the_card(ne, k, r, te, tf, kf):
    """The CUDA kernel against its plain version on the card: point counts
    that fill no warp or block, chunks of one lane, of five and past a
    warp (k = 33: a block per point), r, te and tf from 1 to the kernel's
    maxima, and v in shared memory (kf = 11) and past its 48 KB there
    (kf = 13,000: at least 52 KB). Equal, max abs err 0, since both round
    every product and sum apart in the same order. Run on a machine with a
    card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.as_tensor(a).cuda()
            for a in _k10_inputs(ne, k, te, tf, kf, ne + k, r=r)]
    implicit_apply.launches = 0
    got = implicit_apply(*args)
    want = implicit_apply_plain(*args)
    torch.cuda.synchronize()
    assert implicit_apply.launches == 1
    assert got.shape == (ne, k, tf)
    assert float(torch.max(torch.abs(got - want))) == 0.0
    assert torch.equal(got, want)
