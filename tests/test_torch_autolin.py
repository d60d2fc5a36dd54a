"""K5 of ceres_tpu_torch (ops/lin_auto.py, the auto-jet linearize) and the
quaternion-camera slice it serves, against the JAX package.

- The plain K5 against the JAX package's _lin_kernel_auto
  (ceres_tpu/ops/pallas_lin.py, make_pallas_lin(...).lin) in interpret
  mode on tests/test_autolin.py's problem with quaternion cameras, with no
  loss and with HuberLoss(1.0), the scale derived (first) and carried:
  every output within 1e-5 relative to its largest entry, as K1 is held
  (both f32, another summation order).
- The plain K5 on the angle-axis Snavely problem against the port's
  plain K1, which computes the same function by hand.
- One LM step against the JAX fused Schur step (K5 in interpret mode),
  with test_torch_solve.py's tolerances.
- Whole CPU solves (DENSE_SCHUR, ITERATIVE_SCHUR + SCHUR_JACOBI,
  DENSE_SCHUR + HuberLoss(1.0)) against ceres_tpu.solve on the CPU: the
  same LM iterations and the final cost within 1e-6 relative. These run a
  larger problem than the LIN checks: with Euclidean quaternion blocks the
  600-observation problem does not converge in 50 iterations in either
  package. The quaternion trajectories are sensitive to f32 rounding: a
  1e-7 relative change of the starting points moves the JAX package's own
  iteration count on such problems (PERF.md, PR 5), so the problem is one
  whose three solves agree at this seed.
- What the slice still refuses, and (on the card only) K5 against its
  plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, jax_quaternion_problem,
                              main_path_options, pallas_interpret,
                              quaternion_bal, quaternion_solve_bal, rel,
                              small_bal, torch_problem,
                              torch_quaternion_problem)

from ceres_tpu import solver as jax_solver
from ceres_tpu.ops.pallas_lin import make_pallas_lin
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import schur_fused as jax_schur_fused
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.io.bal import build_bal_ceres_problem
from ceres_tpu_torch.ops import lin_auto as k5
from ceres_tpu_torch.ops.jet_compile import make_auto_spec
from ceres_tpu_torch.ops.lin import lin_plain
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.rotation import angle_axis_rotate_point
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep

TOL = 1e-5
LOSSES = {"none": (None, None), "huber": (ct.HuberLoss(1.0),
                                          ctt.HuberLoss(1.0))}


def _torch_step(problem, **extra):
    opts = main_path_options(ctt, **extra)
    tp = TorchProgram.get_cached(problem, opts)
    return tp, FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))


def _k5_inputs(step, tp, s_e, first):
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    return (step.k5, x[step.f_slab:step.f_slab + nf].float(),
            x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float(),
            step.cam, step.mask, step.dat, torch.as_tensor(s_e), first,
            True, step.loss)


@pytest.fixture(scope="module")
def quat():
    """The port's steps on the quaternion problem (no loss, Huber) and a
    seeded carried scale; the JAX references are made per case, once."""
    bal = quaternion_bal()
    steps = {name: _torch_step(torch_quaternion_problem(bal, pair[1]))
             for name, pair in LOSSES.items()}
    ne = steps["none"][1].ne
    s_e = (0.5 + np.random.default_rng(11).random((ne, 3))).astype(
        np.float32)
    return dict(bal=bal, steps=steps, s_e=s_e, jax={})


def _jax_lin(quat, loss_name, first):
    key = (loss_name, first)
    if key not in quat["jax"]:
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            use_mixed_precision_solves=True)
        ne = quat["steps"][loss_name][1].ne
        with pallas_interpret():
            jp = JaxProgram.get_cached(jax_quaternion_problem(
                quat["bal"], LOSSES[loss_name][0]), opts)
            plin = make_pallas_lin(jp, opts, jax_detect(jp, opts))
            assert plin is not None          # the JAX gate takes K5 here
            s_e = np.ones((plin.ne_pad, 3), np.float32)
            s_e[:ne] = quat["s_e"]
            out = plin.lin(jp.initial_state(), jnp.asarray(s_e),
                           jnp.asarray(first))
        quat["jax"][key] = {k: np.asarray(v) for k, v in out.items()
                            if k != "ne_pad"}
    return quat["jax"][key]


@pytest.mark.parametrize("first", [True, False], ids=["first", "carried"])
@pytest.mark.parametrize("loss_name", list(LOSSES))
def test_k5_plain_matches_jax_auto_lin_kernel(quat, loss_name, first):
    tp, step = quat["steps"][loss_name]
    assert step.k5 is not None and step.k5.auto.name == \
        "auto:SnavelyReprojectionErrorWithQuaternions"
    assert (step.te, step.tf, step.k5.r) == (3, 10, 2)
    ne = step.ne
    j = _jax_lin(quat, loss_name, first)
    t = {k: v.numpy() for k, v in k5.lin_auto_plain(
        *_k5_inputs(step, tp, quat["s_e"], first)).items()}
    assert rel(t["ete"].reshape(ne, 3, 3), j["EtE"][:ne]) <= TOL
    assert rel(t["ge"], j["g_e"][:ne]) <= TOL
    assert rel(t["se"], j["s_e"][:ne]) <= TOL
    assert rel(t["A"], j["A_eT"][:, :, :ne].transpose(2, 0, 1)) <= TOL
    assert rel(t["ftf"], j["FtF"]) <= TOL
    assert rel(t["gf"], j["g_f"]) <= TOL
    if not first:
        assert np.array_equal(t["se"], quat["s_e"])


@pytest.mark.parametrize("loss", [None, ctt.HuberLoss(1.0)],
                         ids=["none", "huber"])
def test_k5_plain_matches_k1_plain_on_snavely(loss):
    """On the angle-axis Snavely bucket, K5's traced chain and epilogue
    give what K1's hand-written ones give (K1 takes masked lanes as camera
    0, K5 as the point's first valid lane: the mask removes both)."""
    tp, step = _torch_step(torch_problem(small_bal(), loss))
    assert step.k5 is None                     # Snavely keeps K1
    bk = tp.buckets[0]
    var = [i for i, sl in enumerate(bk.slots) if sl.variable]
    meta = detect_schur_structure(tp, main_path_options(ctt))
    spec = k5.lin_auto_spec(make_auto_spec(tp, bk),
                            var[meta.buckets[0].e_slot])
    rows, cmask = meta.buckets[0].chunk_rows, meta.buckets[0].chunk_mask
    safe = torch.as_tensor(k5.safe_rows(rows, cmask))
    local = np.asarray(next(s[2] for s in meta.f_groups[0]["slots"]
                            if s[0] == 0))
    cam = torch.as_tensor(local.astype(np.int32))[safe].contiguous()
    dat = spec.auto.data_matrix(bk)[safe].contiguous()
    x = tp.initial_state()
    ne, nf = step.ne, step.nf
    xe = x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x[step.f_slab:step.f_slab + nf].float()
    se = torch.ones(ne, 3)
    a = k5.lin_auto_plain(spec, xf, xe, cam, step.mask, dat, se, True,
                          True, loss)
    b = lin_plain(xf, xe, step.cam, step.mask, step.obsx, step.obsy, se,
                  True, loss=loss)
    assert set(a) == set(b)
    for key in b:
        assert rel(a[key], b[key]) <= TOL, key


def test_one_lm_step_matches_jax_k5_step(quat):
    """One LM step at the start against the JAX fused Schur step, whose
    lin phase is K5 in interpret mode."""
    radius = 1e4
    opts_j = main_path_options(ct)
    with pallas_interpret():
        jp = JaxProgram.get_cached(jax_quaternion_problem(quat["bal"]),
                                   opts_j)
        step_j = jax_schur_fused.make_fused_schur_lm_step(
            jp, opts_j, jax_detect(jp, opts_j))
        assert step_j.pallas_lin
        x0 = jp.initial_state()
        scale = jax_solver.make_scale_fn(jp, opts_j)(x0)
        ex = (jp.example_x(), jp.example_scalar(), jp.example_delta())
        a = jp.jit_with_consts(jax_solver.make_step_impl(jp, opts_j), ex)(
            x0, jnp.asarray(radius, jp.dtype), scale)
    tp, step = quat["steps"]["none"]
    sc = torch.tensor(np.array(scale), dtype=torch.float32)
    s_e = sc[step.e_slab:step.e_slab + 3 * step.ne].view(step.ne, 3)
    s_f = sc[step.f_slab:step.f_slab + step.nf].view(step.kf, 10)
    art = step.linearize(tp.initial_state(), s_e, s_f, first=False)
    b = step.solve(art, radius)
    for k in ["cost", "gradient_max_norm", "delta", "model_cost_change",
              "step_norm"]:
        tol = 5e-4 if k in ("delta", "step_norm") else 1e-5
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


SOLVES = {"dense": ("DENSE_SCHUR", None),
          "iterative": ("ITERATIVE_SCHUR", None),
          "dense-huber": ("DENSE_SCHUR", 1.0)}


@pytest.mark.parametrize("name", list(SOLVES))
def test_quaternion_solve_matches_jax(name):
    solver, huber = SOLVES[name]
    bal = quaternion_solve_bal()
    extra = dict(max_num_iterations=100 if huber else 50)

    def opts(mod):
        return main_path_options(mod, linear_solver_type=getattr(
            mod.LinearSolverType, solver), **extra)

    s_j = ct.solve(opts(ct), jax_quaternion_problem(
        bal, None if huber is None else ct.HuberLoss(huber)))
    problem = torch_quaternion_problem(
        bal, None if huber is None else ctt.HuberLoss(huber))
    s_t = ctt.solve(opts(ctt), problem)
    assert "K5" in s_t.message
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost


def test_quaternion_manifold_still_raises():
    with pytest.raises(NotImplementedError, match="item 26"):
        build_bal_ceres_problem(quaternion_bal(), use_quaternions=True,
                                use_manifolds=True)


class _HomogeneousPinhole:
    """A 6-parameter camera (angle-axis, translation) and a 4-parameter
    homogeneous point: te = 4."""

    def __init__(self, ox, oy):
        self.ox, self.oy = float(ox), float(oy)

    def __call__(self, cam, pt):
        p = angle_axis_rotate_point(cam[0:3], pt[0:3]) + cam[3:6] * pt[3]
        return torch.stack([p[0] / p[2] - self.ox, p[1] / p[2] - self.oy])


class _Branchy:
    """Control flow on the parameter values: does not trace."""

    def __init__(self, ox, oy):
        self.ox, self.oy = float(ox), float(oy)

    def __call__(self, cam, pt):
        p = angle_axis_rotate_point(cam[0:3], pt) + cam[3:6]
        if p[2] > 0:
            return torch.stack([p[0] / p[2] - self.ox, p[1] / p[2] - self.oy])
        return torch.stack([p[0] - self.ox, p[1] - self.oy])


@pytest.mark.parametrize("functor,point_size,match", [
    (_HomogeneousPinhole, 4, "item 40"), (_Branchy, 3, "item 11")],
    ids=["te4", "untraceable"])
def test_explicit_step_refuses(functor, point_size, match):
    """A point block of te != 3 (K2 and K6 take te = 3) and a functor the
    jet compiler cannot trace raise, naming their ROADMAP.md items."""
    rng = np.random.default_rng(0)
    cams = [np.concatenate([0.05 * rng.standard_normal(3),
                            [0.1 * c, -0.1, 4.0]]) for c in range(4)]
    pts = [np.concatenate([0.5 * rng.standard_normal(3), [1.0]])[
        :point_size] for _ in range(30)]
    prob = ctt.Problem()
    for p in pts:
        for c in range(4):
            prob.add_residual_block(ctt.AutoDiffCostFunction(
                functor(*(0.1 * rng.standard_normal(2))), 2,
                [6, point_size]), None, cams[c], p)
    with pytest.raises(NotImplementedError, match=match):
        ctt.solve(main_path_options(ctt), prob)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_name", list(LOSSES))
def test_cuda_k5_matches_plain(quat, loss_name):
    """On the card: the generated K5 against lin_auto_plain on the same
    inputs, within 1e-5. The CPU has no kernel to run (the CUDA build
    needs nvcc and a GPU): python -m pytest tests -m cuda on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bal = quat["bal"]
    opts = main_path_options(ctt, device="cuda")
    problem = torch_quaternion_problem(bal, LOSSES[loss_name][1])
    tp = TorchProgram.get_cached(problem, opts)
    step = FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    for first in (True, False):
        args = _k5_inputs(step, tp, quat["s_e"], first)
        args = args[:6] + (args[6].cuda(),) + args[7:]
        got = k5.lin_auto(*args)
        want = k5.lin_auto_plain(*args)
        for key in want:
            assert rel(got[key].cpu(), want[key].cpu()) <= TOL, key
