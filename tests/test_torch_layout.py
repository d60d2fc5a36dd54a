"""ceres_tpu_torch against ceres_tpu: state layout, structure, the f64
cost (K4's plain version), the modeling pieces, dispatch and the limits
of the ported slice. CPU only; no Pallas kernel is involved here.

Tolerances: f64 against f64 at 1e-12 relative (both sides evaluate the
same expressions; only the summation order differs).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, main_path_options,
                              rel, small_bal, torch_problem)

from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops.cost import snavely_sq
from ceres_tpu_torch.ops.kernels import chol_solve
from ceres_tpu_torch.ops.lin import elim, lin
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import takes_fused_schur_step
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep


@pytest.fixture(scope="module")
def programs():
    bal = small_bal()
    jp = JaxProgram.get_cached(jax_problem(bal), main_path_options(ct))
    tp = TorchProgram.get_cached(torch_problem(bal), main_path_options(ctt))
    return jp, tp


def test_import_does_not_load_jax():
    code = ("import sys, ceres_tpu_torch, ceres_tpu_torch.solver, "
            "ceres_tpu_torch.io.bal; "
            "sys.exit(1 if 'jax' in sys.modules or 'ceres_tpu' in "
            "sys.modules else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(__import__("pathlib").Path(
                           __file__).resolve().parent.parent))
    assert r.returncode == 0, r.stderr


def test_initial_state_is_bitwise_the_jax_state(programs):
    jp, tp = programs
    xj = np.asarray(jp.initial_state())
    xt = tp.state_to_numpy(tp.initial_state())
    assert xj.dtype == xt.dtype == np.float64
    assert np.array_equal(xj, xt)
    assert tp.num_effective == jp.num_effective
    assert tp.num_rows == jp.num_rows


def test_plus_and_cost_fn_match_jax(programs):
    jp, tp = programs
    rng = np.random.default_rng(0)
    x = np.asarray(jp.initial_state())
    d = 1e-3 * rng.standard_normal(jp.num_effective)
    pj = np.asarray(jp.plus(jnp.asarray(x), jnp.asarray(d)))
    pt = tp.state_to_numpy(tp.plus(tp.state_from_numpy(x),
                                   torch.as_tensor(d)))
    assert rel(pt, pj) <= 1e-12
    cj = float(jp.cost_fn(jnp.asarray(pj)))
    ct_ = float(tp.cost_fn(tp.state_from_numpy(pj)))
    assert abs(ct_ - cj) <= 1e-12 * abs(cj)


def test_schur_structure_matches_jax(programs):
    jp, tp = programs
    opts_j, opts_t = main_path_options(ct), main_path_options(ctt)
    mj, mt = jax_detect(jp, opts_j), detect_schur_structure(tp, opts_t)
    assert (mt.ne, mt.te, mt.nf) == (mj.ne, mj.te, mj.nf)
    assert np.array_equal(mt.e_cols, mj.e_cols)
    assert np.array_equal(mt.f_global_cols, mj.f_global_cols)
    for bt, bj in zip(mt.buckets, mj.buckets):
        assert np.array_equal(bt.chunk_rows, bj.chunk_rows)
        assert np.array_equal(bt.chunk_mask, bj.chunk_mask)
    assert mt.f_groups[0]["kf"] == mj.f_groups[0]["kf"]
    assert np.array_equal(mt.f_groups[0]["cols"], mj.f_groups[0]["cols"])


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_k4_plain_matches_cost_fn(programs, trial):
    """K4's plain version (f64) against the f64 cost of both packages at
    perturbed states."""
    jp, tp = programs
    opts = main_path_options(ctt)
    step = FusedSchurStep(tp, opts, detect_schur_structure(tp, opts))
    rng = np.random.default_rng(trial)
    x0 = np.asarray(jp.initial_state())
    x = x0 * (1.0 + 1e-3 * rng.standard_normal(x0.shape))
    xt = tp.state_from_numpy(x)
    c_k4 = float(step.cost(xt))
    c_torch = float(tp.cost_fn(xt))
    c_jax = float(jp.cost_fn(jnp.asarray(x)))
    assert abs(c_k4 - c_jax) <= 1e-12 * abs(c_jax)
    assert abs(c_torch - c_jax) <= 1e-12 * abs(c_jax)


def test_autodiff_jacobian_matches_jax(programs):
    """AutoDiffCostFunction (torch.func.jacfwd) against the JAX bucket
    Jacobian in f64."""
    jp, tp = programs
    x = jp.initial_state()
    rj, Jj = jp._bucket_linearize(jp.buckets[0], x)
    bk = tp.buckets[0]
    params = tp._bucket_params(bk, tp.initial_state())
    r, jacs = torch.func.vmap(bk.cost.make_linearize_fn())(bk.data, *params)
    Jt = torch.cat(jacs, dim=-1)
    assert rel(r.numpy(), np.asarray(rj)) <= 1e-12
    assert rel(Jt.numpy(), np.asarray(Jj)) <= 1e-12


LOSSES = [("TrivialLoss", ()), ("HuberLoss", (1.3,)),
          ("SoftLOneLoss", (0.7,)), ("CauchyLoss", (2.0,)),
          ("ArctanLoss", (1.5,)), ("TolerantLoss", (0.5, 2.0)),
          ("TukeyLoss", (1.8,))]


@pytest.mark.parametrize("name,args", LOSSES)
def test_loss_matches_jax(name, args):
    s = np.concatenate([np.linspace(0.0, 10.0, 41), [1e-8, 55.0, 300.0]])
    lj = getattr(ct, name)(*args)
    lt = getattr(ctt, name)(*args)
    for a, b in zip(lt.evaluate(torch.as_tensor(s)),
                    lj.evaluate(jnp.asarray(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("name,args", [("HuberLoss", (1.0,)),
                                       ("CauchyLoss", (0.5,))])
def test_corrector_matches_jax(name, args):
    """The Triggs corrector (corrector.cc) on the same residual blocks."""
    from ceres_tpu.loss import correct_residuals_and_jacobian as cj
    from ceres_tpu_torch.loss import correct_residuals_and_jacobian as cto
    rng = np.random.default_rng(5)
    r = 2.0 * rng.standard_normal((50, 2))
    J = rng.standard_normal((50, 2, 12))
    out_t = cto(getattr(ctt, name)(*args), torch.as_tensor(r),
                torch.as_tensor(J))
    out_j = cj(getattr(ct, name)(*args), jnp.asarray(r), jnp.asarray(J))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_rotation_matches_jax():
    from ceres_tpu.rotation import angle_axis_rotate_point as rj
    from ceres_tpu_torch.rotation import angle_axis_rotate_point as rt
    rng = np.random.default_rng(1)
    aa = rng.standard_normal((64, 3))
    aa[:8] *= 1e-8                   # small-angle branch
    pt = rng.standard_normal((64, 3))
    a = rt(torch.as_tensor(aa), torch.as_tensor(pt)).numpy()
    b = np.asarray(rj(jnp.asarray(aa), jnp.asarray(pt)))
    assert rel(a, b) <= 1e-14


def test_cpu_solve_launches_no_kernel():
    """On CPU tensors every wrapper takes its plain version."""
    for fn in (lin, elim, chol_solve, snavely_sq):
        fn.launches = 0
    s = ctt.solve(main_path_options(ctt), torch_problem(small_bal()))
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert [fn.launches for fn in (lin, elim, chol_solve, snavely_sq)] == \
        [0, 0, 0, 0]


@pytest.mark.parametrize("extra", [
    dict(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
         preconditioner_type=ctt.PreconditionerType.CLUSTER_JACOBI),
    dict(use_mixed_precision_solves=False),
    dict(use_inner_iterations=True),
    dict(trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG),
    dict(minimizer_type=ctt.MinimizerType.LINE_SEARCH),
])
def test_out_of_slice_options_raise(extra, monkeypatch):
    """Options that raised NotImplementedError until the port ran them;
    each case keeps its id and now holds the port to the JAX package on
    the main path's problem. CLUSTER_JACOBI (ROADMAP.md items 36 and 21)
    runs mixed on the generic Schur step and lands within 1e-9 of the JAX
    package's f64 solve (its mixed CLUSTER solve does not trace, section
    3), in as many LM iterations. Inner iterations (item 22) run the host
    loop around the fused step: the JAX package's LM count and inner
    steps, the final cost within 1e-9. The line search with the main
    path's fused_iterations=True (item 47) runs the device-resident loop:
    cut at five iterations, the JAX fused loop's counts and the final
    cost within 1e-10. The f64 step and dogleg with a Schur solver,
    which raised until the generic Schur step (ROADMAP.md item 18) took
    them, run there and match the JAX package's generic route: f64 with
    its LM count and final cost within 1e-9, mixed dogleg within 1e-5."""
    if "preconditioner_type" in extra or "use_inner_iterations" in extra \
            or "minimizer_type" in extra:
        cut = ({"max_num_iterations": 5} if "minimizer_type" in extra
               else {})
        jextra = {k: getattr(getattr(ct, type(v).__name__), v.name)
                  if hasattr(v, "name") else v for k, v in extra.items()}
        if "preconditioner_type" in extra:
            jextra["use_mixed_precision_solves"] = False
        s_j = ct.solve(main_path_options(ct, **jextra, **cut),
                       jax_problem(small_bal()))
        s_t = ctt.solve(main_path_options(ctt, **extra, **cut),
                        torch_problem(small_bal()))
        assert s_t.is_solution_usable(), s_t.message
        assert str(s_t.termination_type) == str(s_j.termination_type)
        assert s_t.num_iterations == s_j.num_iterations
        assert s_t.num_inner_iteration_steps == s_j.num_inner_iteration_steps
        tol = 1e-10 if cut else 1e-9
        assert abs(s_t.final_cost - s_j.final_cost) <= tol * s_j.final_cost
        if cut:
            assert s_t.num_iterations_fused == 5
            assert s_t.num_line_search_steps == s_j.num_line_search_steps
        return
    monkeypatch.setenv("CERES_TPU_NO_FUSED_SCHUR", "1")
    jextra = {k: (ct.TrustRegionStrategyType.DOGLEG
                  if k == "trust_region_strategy_type" else v)
              for k, v in extra.items()}
    s_j = ct.solve(main_path_options(ct, **jextra), jax_problem(small_bal()))
    s_t = ctt.solve(main_path_options(ctt, **extra),
                    torch_problem(small_bal()))
    assert "Schur step: generic DENSE_SCHUR" in s_t.message
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    if "use_mixed_precision_solves" in extra:
        assert s_t.num_iterations == s_j.num_iterations
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
    else:
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost


def test_robust_loss_on_cuda_raises_not_implemented():
    """The CUDA linearize kernel runs any loss that the jet compiler
    traces (a hand K1 instance for a stock scalar loss, a generated loss
    unit for any other, ScaledLoss among them); a loss that does not
    trace (an attribute other than numbers, bools, strings and nested
    losses) has none: the solve keeps the fused step's route (a port
    kernel's limit is not handed to the generic Schur step) and the step
    refuses it, naming ROADMAP.md item 9. A HuberLoss and a ScaledLoss
    pass the gate."""

    class Opaque(ctt.LossFunction):
        def __init__(self):
            self.table = np.ones(3)

        def evaluate(self, s):
            return s, torch.ones_like(s), torch.zeros_like(s)

    opts = main_path_options(ctt, device="cuda")
    for loss, refused in ((Opaque(), True),
                          (ctt.ScaledLoss(ctt.HuberLoss(1.0), 2.0), False),
                          (ctt.HuberLoss(1.0), False)):
        problem = torch_problem(small_bal(), loss=loss)
        program = TorchProgram(problem, device="cpu")
        meta = detect_schur_structure(program, opts)
        reason = tsf.unsupported_reason(program, opts, meta)
        if refused:
            assert "item 9" in reason
            assert takes_fused_schur_step(program, opts)
            with pytest.raises(NotImplementedError, match="item 9"):
                FusedSchurStep(program, opts, meta)
        else:
            assert reason is None


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.solve(main_path_options(ctt, device="cuda"),
                  torch_problem(small_bal()))
