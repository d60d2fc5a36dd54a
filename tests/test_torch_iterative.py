"""The ITERATIVE_SCHUR slice of ceres_tpu_torch end to end against
ceres_tpu: one LM step against the JAX fused step with its Pallas kernels
(LIN, ELIM v1, PCG) in interpret mode, for each preconditioner the fused
path serves; whole solves against ceres_tpu.solve on the CPU; and the
configurations that still raise.

Tolerances as test_torch_solve.py: the step to 1e-5 (5e-4 for delta and
step norm, where the f32 solve amplifies rounding by the damped system's
conditioning) with the same CG iteration count; a whole solve with the
same termination, LM iterations, accepted steps and total CG iterations,
and a final cost within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ct, ctt, jax_problem, large_m_bal,
                              main_path_options, pallas_interpret, rel,
                              small_bal, torch_problem)

from ceres_tpu import solver as jax_solver
from ceres_tpu.io.bal import synthetic_bal_problem
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import schur_fused as jax_schur_fused
from ceres_tpu.solvers.schur import detect_schur_structure as jax_detect
from ceres_tpu_torch.ops.lin import elim_v1
from ceres_tpu_torch.ops.pcg import dense_pcg
from ceres_tpu_torch.program import CompiledProgram as TorchProgram
from ceres_tpu_torch.solver import takes_fused_schur_step
from ceres_tpu_torch.solvers import schur_fused as tsf
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep, spd_inv_small

RADIUS = 1e4
PRECONDITIONERS = ["IDENTITY", "JACOBI", "SCHUR_JACOBI"]


def iterative_options(mod, preconditioner, **extra):
    """bench.py's ITERATIVE_SCHUR configuration in package `mod`."""
    return main_path_options(
        mod, linear_solver_type=mod.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=getattr(mod.PreconditionerType, preconditioner),
        **extra)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX fused steps (one per preconditioner) with their Pallas
    kernels in interpret mode, and one linearization at x0 that they
    share: the lin phase does not depend on the preconditioner, so the
    interpret-mode LIN kernel is traced once."""
    bal = small_bal()
    with pallas_interpret():
        steps = {}
        for pc in PRECONDITIONERS:
            opts = iterative_options(ct, pc)
            jp = JaxProgram.get_cached(jax_problem(bal), opts)
            step = jax_schur_fused.make_fused_schur_lm_step(
                jp, opts, jax_detect(jp, opts))
            assert step.pallas_lin and step.pallas_elim and step.pallas_pcg
            steps[pc] = step
        x0 = jp.initial_state()
        scale = jax_solver.make_scale_fn(jp, opts)(x0)
        art = jax.jit(steps["SCHUR_JACOBI"].linearize)(x0, scale)
    return dict(bal=bal, steps=steps, art=art, scale=np.asarray(scale),
                radius=jnp.asarray(RADIUS, jp.dtype))


@pytest.mark.parametrize("preconditioner", PRECONDITIONERS)
def test_one_lm_step_matches_jax_pallas_step(jax_steps, preconditioner):
    with pallas_interpret():
        a = jax.jit(jax_steps["steps"][preconditioner].solve_from)(
            jax_steps["art"], jax_steps["radius"])
    opts_t = iterative_options(ctt, preconditioner)
    tp = TorchProgram.get_cached(torch_problem(jax_steps["bal"]), opts_t)
    step = FusedSchurStep(tp, opts_t, detect_schur_structure(tp, opts_t))
    sc = torch.tensor(jax_steps["scale"], dtype=torch.float32)
    s_e = sc[step.e_slab:step.e_slab + 3 * step.ne].view(step.ne, 3)
    s_f = sc[step.f_slab:step.f_slab + step.nf].view(step.kf, 9)
    art = step.linearize(tp.initial_state(), s_e, s_f, first=False)
    b = step.solve(art, RADIUS)
    assert int(b["lin_iters"]) == int(a["lin_iters"]) > 1
    assert b["lin_iters"].dtype == torch.int32
    for k in ["cost", "gradient_max_norm", "delta", "model_cost_change",
              "step_norm"]:
        tol = 5e-4 if k in ("delta", "step_norm") else 1e-5
        assert rel(b[k].numpy(), np.asarray(a[k])) < tol, k


@pytest.mark.parametrize("preconditioner", PRECONDITIONERS)
def test_iterative_solve_matches_jax(preconditioner):
    """The whole solve against ct.solve on the CPU (its XLA lin phase,
    the Pallas PCG kernel in interpret mode), as
    test_fused_iterative_schur_with_pcg_kernel_matches holds the JAX
    kernel to the XLA CG loop."""
    bal = small_bal()
    s_j = ct.solve(iterative_options(ct, preconditioner), jax_problem(bal))
    elim_v1.launches = dense_pcg.launches = 0
    s_t = ctt.solve(iterative_options(ctt, preconditioner),
                    torch_problem(bal))
    assert elim_v1.launches == dense_pcg.launches == 0   # plain on the CPU
    assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
    assert str(s_t.termination_type) == str(s_j.termination_type)
    assert s_t.num_iterations == s_j.num_iterations
    assert s_t.num_successful_steps == s_j.num_successful_steps
    assert s_t.num_linear_solver_iterations \
        == s_j.num_linear_solver_iterations > s_t.num_iterations
    assert abs(s_t.initial_cost - s_j.initial_cost) <= \
        1e-12 * s_j.initial_cost
    assert abs(s_t.final_cost - s_j.final_cost) <= 1e-6 * s_j.final_cost
    assert str(s_t.linear_solver_type_used) == "ITERATIVE_SCHUR"
    assert str(s_t.preconditioner_type_used) == preconditioner


def test_spd_inv_small_inverts_and_flags_indefinite_blocks():
    """The preconditioner's block inverse: SPD 9x9 blocks against
    numpy's f64 inverse (f32, condition number ~10); a block that is not
    positive definite becomes NaN instead of raising or syncing."""
    rng = np.random.default_rng(9)
    G = rng.standard_normal((4, 9, 12))
    M = (G @ G.transpose(0, 2, 1) + 9 * np.eye(9)).astype(np.float32)
    M[3] = -M[3]
    inv = spd_inv_small(torch.as_tensor(M)).numpy()
    assert rel(inv[:3], np.linalg.inv(M[:3].astype(np.float64))) < 1e-5
    assert np.isnan(inv[3]).all() and np.isfinite(inv[:3]).all()


def _bal_problem(num_cameras, num_points):
    """Three observations per point, so that the points (and not a few
    cameras as well) form the independent set that is eliminated."""
    bal = synthetic_bal_problem(num_cameras=num_cameras,
                                num_points=num_points,
                                num_observations=3 * num_points, seed=3)
    return torch_problem(bal)


@pytest.mark.parametrize("case,item", [
    ("implicit", "item 11"), ("spse", "item 14"), ("m_over_1024", "item 37"),
    ("cluster_jacobi", "item 36")])
def test_out_of_slice_raises(case, item, monkeypatch):
    """What stays outside the fused steps raises NotImplementedError
    naming the ROADMAP.md item that ports it: the fused implicit step in
    f64 (nf > 4096; the mixed step there is slice 4,
    tests/test_torch_implicit.py) and, in the solve, a preconditioner
    that no Schur route served until this slice (CLUSTER_JACOBI: the
    case keeps its id, and its solve now runs on the generic Schur step,
    solvers/schur.py's cluster preconditioner, in f64: the JAX package's
    mixed CLUSTER solve does not trace, ROADMAP.md section 3; its LM
    count and final cost within 1e-9 of the JAX package's f64 solve). The
    solve runs the f64 implicit case on the generic Schur step. A reduced
    system past the
    one-block kernels (m > 1024), which raised here until item 37, runs
    on the fused step with the reduced CG of solvers/cg.py and matches the
    JAX package's fused step (its XLA CG loop) within 1e-5
    (tests/test_torch_fused_large_m.py holds DENSE_SCHUR and IDENTITY).
    The SPSE warm start, which the fused step refused until item 14 took
    it to the generic Schur step, runs there and matches the JAX
    package's mixed solve within 1e-5 (tests/test_torch_schur_solve.py
    holds it in f64)."""
    extra, problem = {}, None
    if case == "implicit":
        problem = _bal_problem(500, 5000)          # nf = 4,500
        extra["use_mixed_precision_solves"] = False
    elif case == "m_over_1024":
        problem = torch_problem(large_m_bal())     # nf = 1,170
    elif case == "spse":
        extra["use_spse_initialization"] = True
    if problem is None:
        problem = torch_problem(small_bal())
    pc = "CLUSTER_JACOBI" if case == "cluster_jacobi" else "SCHUR_JACOBI"
    opts = iterative_options(ctt, pc, **extra)
    if case == "cluster_jacobi":
        extra["use_mixed_precision_solves"] = False
        opts = iterative_options(ctt, pc, **extra)
        assert not takes_fused_schur_step(TorchProgram(problem, device="cpu"),
                                          opts)
        s_j = ct.solve(iterative_options(ct, pc, **extra),
                       jax_problem(small_bal()))
        s_t = ctt.solve(opts, problem)
        assert ("Schur step: generic ITERATIVE_SCHUR + CLUSTER_JACOBI"
                in s_t.message)
        assert s_t.num_iterations == s_j.num_iterations
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-9 * s_j.final_cost
    elif case == "spse":
        monkeypatch.setenv("CERES_TPU_NO_FUSED_SCHUR", "1")
        s_j = ct.solve(iterative_options(ct, pc, **extra),
                       jax_problem(small_bal()))
        s_t = ctt.solve(opts, problem)
        assert "Schur step: generic ITERATIVE_SCHUR" in s_t.message
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost
    elif case == "m_over_1024":
        program = TorchProgram(problem, device="cpu")
        assert takes_fused_schur_step(program, opts)
        s_j = ct.solve(iterative_options(ct, pc), jax_problem(large_m_bal()))
        s_t = ctt.solve(opts, problem)
        assert ("reduced solve: CG on the explicit S (solvers/cg.py), m = "
                "1170") in s_t.message
        assert s_t.termination_type == ctt.TerminationType.CONVERGENCE
        assert str(s_j.termination_type) == "CONVERGENCE"
        assert abs(s_t.final_cost - s_j.final_cost) <= 1e-5 * s_j.final_cost
    else:
        program = TorchProgram(problem, device="cpu")
        meta = detect_schur_structure(program, opts)
        with pytest.raises(NotImplementedError, match=item):
            tsf.ImplicitSchurStep(program, opts, meta)
        assert not takes_fused_schur_step(program, opts)
